"""Whole-slice checks of the PyTorch port: `sample_fn` against JAX, the full
checkpoint bridge, and the import guard.

`sample_fn` runs a tiny config in f32 on a JAX-collated fake batch (with
manipulation, compacted rows), on the same weights (JAX variables carried
over by convert/from_jax.py) and the same noise: the test draws it with the
key splits of sgdiff.py:349, ddpm.py:271-289 and ldm.py:103 and injects it
into the port.  Tolerance: 1e-4 on boxes and SDFs (f32; the only
differences are summation order in convolutions and matmuls).
"""
import functools
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_modules import _init_vars
from echoscene_torch.convert import from_jax
from echoscene_torch.core.graphbatch import GraphBatch, SceneBatch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4


def _jax_config(denoiser_gcn_layers):
    from echoscene_tpu.models.config import tiny_config

    cfg = tiny_config()
    cfg.sample_dtype = "float32"
    cfg.layout_denoiser.gconv_num_layers = denoiser_gcn_layers
    cfg.shape_branch.denoiser.gconv_num_layers = denoiser_gcn_layers
    return cfg


def _port_config(jcfg):
    """The same configuration as the port's dataclasses (copied module)."""
    import dataclasses
    from echoscene_torch.models import config as pc

    def conv(obj, cls):
        kw = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            kw[f.name] = (conv(v, getattr(pc, type(v).__name__))
                          if dataclasses.is_dataclass(v) else v)
        return cls(**kw)

    return conv(jcfg, pc.EchoSceneConfig)


def _params_and_stats(module, *args):
    """Perturbed JAX variables of `module`, as numpy trees."""
    v = jax.tree.map(np.asarray, _init_vars(module, *args))
    return v["params"], v.get("batch_stats", {})


def to_port_batch(b) -> SceneBatch:
    """An echoscene_tpu SceneBatch (numpy leaves) -> the port's."""
    def view(g):
        return GraphBatch(
            objs=torch.from_numpy(np.asarray(g.objs, np.int64)),
            triples=torch.from_numpy(np.asarray(g.triples, np.int64)),
            obj_mask=torch.from_numpy(np.asarray(g.obj_mask, np.float32)),
            triple_mask=torch.from_numpy(np.asarray(g.triple_mask,
                                                    np.float32)),
            text_feats=torch.from_numpy(np.asarray(g.text_feats, np.float32)),
            rel_feats=torch.from_numpy(np.asarray(g.rel_feats, np.float32)))

    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    i64 = lambda a: torch.from_numpy(np.asarray(a, np.int64))
    return SceneBatch(enc=view(b.enc), dec=view(b.dec),
                      objs_grained=i64(b.objs_grained),
                      obj_to_scene=i64(b.obj_to_scene),
                      triple_to_scene=i64(b.triple_to_scene),
                      boxes=f32(b.boxes), change_flags=f32(b.change_flags),
                      enc_obj_mask=f32(b.enc_obj_mask),
                      num_scenes=b.num_scenes)


@pytest.fixture(scope="module")
def fake_batch(tmp_path_factory):
    from echoscene_tpu.data.collate import CollateSpec, collate_scenes
    from echoscene_tpu.data.fake import make_fake_dataset
    from echoscene_tpu.data.sgfront import SGFrontDataset

    root = str(tmp_path_factory.mktemp("port_fake"))
    make_fake_dataset(root, num_scenes=4, min_objs=3, max_objs=4, sdf_res=16,
                      with_sdf=False)
    ds = SGFrontDataset(root, use_sdf=False, with_changes=True, seed=3,
                        sdf_res=16)
    cfg = _jax_config(2)
    spec = CollateSpec(max_nodes=cfg.max_nodes, max_triples=cfg.max_triples,
                       max_scenes=cfg.batch_scenes)
    batch = collate_scenes([ds[i] for i in range(3)], spec)
    assert float(np.asarray(batch.change_flags).sum()) > 0
    return batch, len(ds.classes), len(ds.pred_names)


def _jax_noise(rng, n, cfg, rows):
    """The draws JAX's sample_fn makes from `rng`, in its key order."""
    k_change, k_box, k_shape = jax.random.split(rng, 3)
    change = jax.random.normal(k_change, (n, cfg.embedding_dim))
    key, init_rng = jax.random.split(k_box)
    box_x_T = jax.random.normal(init_rng, (n, 8))
    steps = []
    for _ in range(cfg.layout_diffusion.time_num):
        key, nkey = jax.random.split(key)
        steps.append(jax.random.normal(nkey, (n, 8), jnp.float32))
    r = cfg.shape_branch.denoiser.image_size
    shape_x_T = jax.random.normal(
        k_shape, (1, r, r, r, cfg.shape_branch.vqvae.embed_dim))
    as_t = lambda a: torch.from_numpy(np.asarray(a))
    return {"change": as_t(change), "box_x_T": as_t(box_x_T),
            "box_steps": as_t(jnp.stack(steps)), "shape_x_T": as_t(shape_x_T)}


def test_sample_fn_matches_jax(fake_batch):
    from echoscene_tpu.models.sgdiff import SGDiff as JSGDiff
    from echoscene_tpu.models.sgdiff import shape_row_capacity
    from echoscene_torch.models.sgdiff import SGDiff as PSGDiff
    from echoscene_torch.models.sgdiff import (
        shape_row_capacity as port_capacity)

    batch, num_objs, num_preds = fake_batch
    cfg = _jax_config(2)
    jsg = JSGDiff(cfg, num_objs=num_objs, num_preds=num_preds)
    n = batch.num_nodes
    params, stats = _params_and_stats(jsg.module, batch,
                                      jnp.zeros((n, cfg.embedding_dim)))
    rows = shape_row_capacity(batch)
    pbatch = to_port_batch(batch)
    assert port_capacity(pbatch) == rows < n
    rng = jax.random.PRNGKey(4)
    want = jax.jit(functools.partial(
        jsg.sample_fn, gen_shape=True, with_manipulation=True,
        shape_rows=rows))(params, stats, batch, rng)

    psg = PSGDiff(_port_config(cfg), num_objs, num_preds, device="cpu")
    psg.module.load_state_dict(from_jax.to_state_dict(
        from_jax.checkpoint_to_module(
            from_jax.convert_echoscene_checkpoint(params, stats, cfg))),
        strict=True)
    got = psg.sample_fn(pbatch, with_manipulation=True, shape_rows=rows,
                        noise=_jax_noise(rng, n, cfg, rows))
    for k in ("sizes", "translations", "angles", "keep", "shapes"):
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, atol=ATOL, err_msg=k)
    assert np.abs(np.asarray(want["shapes"])).max() > 1e-2
    assert np.all(got["shapes"][rows:].numpy() == 0)


def _jax_fast_noise(rng, n, cfg):
    """The draws JAX's sample_fn makes from `rng` with a fast layout
    sampler (sgdiff.py:349, :393-395): x_T at n rows, then the shared grid;
    the chains draw nothing else at eta = 0."""
    k_change, k_box, k_shape = jax.random.split(rng, 3)
    change = jax.random.normal(k_change, (n, cfg.embedding_dim))
    _, k_init = jax.random.split(k_box)
    box_x_T = jax.random.normal(k_init, (n, cfg.layout_denoiser.in_channels))
    r = cfg.shape_branch.denoiser.image_size
    shape_x_T = jax.random.normal(
        k_shape, (1, r, r, r, cfg.shape_branch.vqvae.embed_dim))
    as_t = lambda a: torch.from_numpy(np.array(a))
    return {"change": as_t(change), "box_x_T": as_t(box_x_T),
            "shape_x_T": as_t(shape_x_T)}


@pytest.mark.parametrize("layout,shape", [
    ("ddim", "dpmpp"), ("dpmpp", "ddim"), ("dpmpp", "dpmpp")])
def test_sample_fn_fast_samplers_match_jax(fake_batch, layout, shape):
    """The tiny f32 sample_fn under the few-step samplers (DDIM / DPM++
    over sub-schedules, layout and shape), from JAX's draws: boxes and SDFs
    within 1e-4."""
    from echoscene_tpu.models.sgdiff import SGDiff as JSGDiff
    from echoscene_tpu.models.sgdiff import shape_row_capacity
    from echoscene_torch.models.sgdiff import SGDiff as PSGDiff

    batch, num_objs, num_preds = fake_batch
    cfg = _jax_config(2)
    cfg.layout_diffusion.sampler = layout
    cfg.layout_diffusion.sample_steps = 6
    cfg.shape_branch.sampler = shape
    cfg.shape_branch.ddim_steps = 3
    jsg = JSGDiff(cfg, num_objs=num_objs, num_preds=num_preds)
    n = batch.num_nodes
    params, stats = _params_and_stats(jsg.module, batch,
                                      jnp.zeros((n, cfg.embedding_dim)))
    rows = shape_row_capacity(batch)
    rng = jax.random.PRNGKey(5)
    want = jax.jit(functools.partial(
        jsg.sample_fn, gen_shape=True, with_manipulation=True,
        shape_rows=rows))(params, stats, batch, rng)

    psg = PSGDiff(_port_config(cfg), num_objs, num_preds, device="cpu")
    assert psg.ddim_tables.num_steps == jsg.ddim_tables.num_steps
    psg.module.load_state_dict(from_jax.to_state_dict(
        from_jax.checkpoint_to_module(
            from_jax.convert_echoscene_checkpoint(params, stats, cfg))),
        strict=True)
    got = psg.sample_fn(to_port_batch(batch), with_manipulation=True,
                        shape_rows=rows, noise=_jax_fast_noise(rng, n, cfg))
    for k in ("sizes", "translations", "angles", "keep", "shapes"):
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, atol=ATOL, err_msg=k)
    assert np.abs(np.asarray(want["shapes"])).max() > 1e-2


def test_fast_sampler_tables_match_jax():
    """The DDIM and lambda-uniform DPM++ sub-schedules of both branches, at
    the flagship schedules and the fast profile's step counts, equal JAX's
    (the same float32 tables)."""
    import dataclasses

    from echoscene_tpu.core import schedules as JS
    from echoscene_tpu.diffusion.ddpm import LayoutDiffusion as JLD
    from echoscene_tpu.diffusion.ldm import ShapeDiffusion as JSD
    from echoscene_tpu.models.config import load_config as jload
    from echoscene_torch.core import schedules as PS
    from echoscene_torch.diffusion.ddpm import LayoutDiffusion as PLD
    from echoscene_torch.diffusion.ldm import ShapeDiffusion as PSD

    cfg = jload(os.path.join(REPO, "configs", "full_mp.yaml"))
    lc, sd = cfg.layout_diffusion, cfg.shape_branch.denoiser
    betas = (lc.schedule_type, lc.beta_start, lc.beta_end, lc.time_num)
    shape_betas = (sd.linear_start, sd.linear_end, sd.timesteps)
    jl = JLD(JS.make_diffusion_tables(JS.get_betas(*betas)))
    pl = PLD(PS.make_diffusion_tables(PS.get_betas(*betas)))
    js = JSD(JS.make_diffusion_tables(JS.ldm_linear_betas(*shape_betas)))
    ps = PSD(PS.make_diffusion_tables(PS.ldm_linear_betas(*shape_betas)))
    pairs = [(jl.make_ddim_tables(50), pl.make_ddim_tables(50)),
             (jl.make_dpmpp_tables(50), pl.make_dpmpp_tables(50)),
             (js.make_ddim_tables(100, 0.3), ps.make_ddim_tables(100, 0.3)),
             (js.make_dpmpp_tables(20), ps.make_dpmpp_tables(20))]
    for want, got in pairs:
        for f in dataclasses.fields(want):
            w, g = getattr(want, f.name), getattr(got, f.name)
            assert np.asarray(g).dtype == np.asarray(w).dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
    assert pairs[1][1].num_steps == 50 and pairs[3][1].num_steps == 20


@pytest.mark.parametrize("method", ["ddim", "dpmpp"])
def test_chains_on_closed_form_denoiser_match_jax(method):
    """ddim_chain / dpmpp_chain with the optimal eps of a Gaussian data
    distribution (tests/test_samplers.py's closed form) on a 20-step
    lambda-uniform sub-schedule: the port within 1e-6 of the output's peak
    of JAX's chain.  (XLA's f32 log / log1p / expm1 differ from torch's by
    an ulp, and 20 steps carry that to ~2e-6 absolute at a peak of ~3.)"""
    from echoscene_tpu.core import schedules as JS
    from echoscene_tpu.diffusion import samplers as jsamp
    from echoscene_torch.diffusion import samplers as psamp

    mu, sigma = 1.7, 0.6
    tables = JS.make_diffusion_tables(JS.ddpm_linear_betas(1e-4, 0.02, 1000))
    sub = JS.ddim_tables(
        tables.alphas_cumprod,
        JS.lambda_uniform_timesteps(20, tables.alphas_cumprod), eta=0.0)
    ac = tables.alphas_cumprod

    def eps(x, t, xp):
        a = xp.asarray(ac)[t].reshape(-1, 1)
        return xp.sqrt(1 - a) * (x - xp.sqrt(a) * mu) / (a * sigma ** 2 + 1 - a)

    x_T = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
    want = getattr(jsamp, f"{method}_chain")(
        lambda x, t: eps(x, t, jnp), x_T.shape, jax.random.PRNGKey(1), sub,
        x_T=jnp.asarray(x_T))
    got = psamp.CHAINS[method](
        lambda x, t: eps(x, t, torch), x_T.shape, sub,
        x_T=torch.from_numpy(x_T), device="cpu")
    assert got.dtype == torch.float32
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_compacted_rows_match_full_width(fake_batch):
    """Port-only: the compacted chains reproduce the full-width chains on
    the real rows (noise drawn at full width and sliced, padded slots
    masked out of the echo GCN)."""
    from echoscene_torch.benchmarks import seeded_weights_
    from echoscene_torch.models.config import tiny_config
    from echoscene_torch.models.sgdiff import SGDiff, shape_row_capacity

    batch, num_objs, num_preds = fake_batch
    pbatch = to_port_batch(batch)
    cfg = tiny_config()
    cfg.sample_dtype = "float32"
    sg = SGDiff(cfg, num_objs, num_preds, device="cpu")
    seeded_weights_(sg.module, 0)
    rows = shape_row_capacity(pbatch)
    real = int(pbatch.dec.obj_mask.sum())
    outs = [sg.sample_fn(pbatch, torch.Generator().manual_seed(3),
                         shape_rows=r) for r in (None, rows)]
    for k in ("sizes", "translations", "angles", "shapes"):
        np.testing.assert_allclose(outs[0][k][:real].numpy(),
                                   outs[1][k][:real].numpy(), atol=1e-5)
        assert np.all(outs[1][k][rows:].numpy() == 0)


def test_checkpoint_round_trip_and_strict_load(fake_batch):
    """JAX variables of the whole model -> from_jax (reference checkpoint
    layout) -> torch_import gives back every leaf bit for bit, and the
    port's EchoSceneModule loads the same dict strictly."""
    from echoscene_tpu.convert import torch_import
    from echoscene_tpu.models.config import tiny_config
    from echoscene_tpu.models.echo_scene import EchoSceneModule
    from echoscene_torch.models.echo_scene import EchoSceneModule as PModule

    batch, num_objs, num_preds = fake_batch
    cfg = tiny_config()
    jm = EchoSceneModule(cfg, num_objs=num_objs, num_preds=num_preds)
    params, stats = _params_and_stats(
        jm, batch, jnp.zeros((batch.num_nodes, cfg.embedding_dim)))
    ckpt = from_jax.convert_echoscene_checkpoint(params, stats, cfg)
    p2, s2 = torch_import.convert_echoscene_checkpoint(
        dict(ckpt), cfg, gconv_num_layers=cfg.gconv_num_layers)
    for a, b in ((params, p2), (stats, s2)):
        fa, ta = jax.tree_util.tree_flatten_with_path(a)
        fb, tb = jax.tree_util.tree_flatten_with_path(b)
        assert ta == tb
        for (path, x), (_, y) in zip(fa, fb):
            assert np.array_equal(np.asarray(x), np.asarray(y)), path
    pm = PModule(_port_config(cfg), num_objs, num_preds)
    pm.load_state_dict(from_jax.to_state_dict(
        from_jax.checkpoint_to_module(ckpt)), strict=True)


def test_synthetic_batch_invariants():
    """The flagship batch keeps core/graphbatch.py's layout: scene-major
    real nodes, all padding at the tail, triples inside their scene."""
    from echoscene_torch.benchmarks import synthetic_batch

    b = synthetic_batch()
    mask = b.dec.obj_mask.numpy()
    real = int(mask.sum())
    assert mask[:real].all() and not mask[real:].any()
    o2s = b.obj_to_scene.numpy()
    assert np.all(np.diff(o2s[:real]) >= 0) and np.all(o2s[real:] == 8)
    tri = b.dec.triples.numpy()[b.dec.triple_mask.numpy() > 0]
    assert np.all(o2s[tri[:, 0]] == o2s[tri[:, 2]])
    assert b.num_nodes == 48 and b.dec.num_triples == 112


def test_port_imports_no_jax():
    """Every echoscene_torch module and chip_smoke.py import with jax,
    flax, optax and echoscene_tpu blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'echoscene_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import echoscene_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    echoscene_torch.__path__, 'echoscene_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and\n"
        "       m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',\n"
        "                           'echoscene_tpu')]\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 75, mods\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
