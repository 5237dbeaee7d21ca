"""CPU parity of the port's training pipeline against JAX: VQ-VAE training,
the latent cache, shape previews, background checkpoint saves and the
dataset checker.

The VQ-VAE runs at a tiny config (ch 8, ch_mult (1, 2), resolution 16, 64
codes): the port's module is drawn from a seed, perturbed, and carried into
JAX by echoscene_tpu/convert/torch_import.py `convert_vqvae`; the same
seeded analytic SDFs go through both.  Tolerances, f32:
  * `VQVAE.forward` against `VQVAE.__call__`: the reconstruction within
    1e-4 of its peak, the codebook loss within 1e-5 relative, codebook
    indices compared tie-aware;
  * `loss_fn` and its gradients against `jax.value_and_grad(VQVAETrainer.
    loss_fn)`: the loss within 1e-5 relative, each leaf within 1e-4 of
    max|g_jax|; one Adam step from the same gradients against optax.adam
    within 1e-6;
  * `voxel_iou` exact, `eval_iou`'s mean and std within 1e-6, `encode` and
    the latent cache within 1e-4 of the latents' peak;
  * the latent cache file read by JAX's and the port's lookups alike, and
    the joint loss from the cache equal to the port's own from SDFs
    through the frozen encoder (JAX's loss on a cache batch is held in
    test_torch_port_train.py, beside the other joint-loss cases);
  * previews rendered as JAX renders the same SDF, and training bit-equal
    with and without them; background saves; the dataset checker's
    reports, CLIP pickles and exit codes equal JAX's.
"""
import importlib.util
import json
import os
import pickle
import shutil
import types

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from echoscene_torch.benchmarks import analytic_sdf
from echoscene_torch.convert import from_jax
from test_torch_port_eval import TINY_DF, TINY_YAML

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VQ_KW = dict(n_embed=64, embed_dim=3, ch=8, ch_mult=(1, 2), resolution=16)
TINY_VQ8 = """
model:
  params:
    embed_dim: 3
    n_embed: 64
    ddconfig:
      ch: 8
      ch_mult: [1, 2]
      resolution: 16
"""
# the joint tiny model's VQ-VAE (test_torch_port_eval.TINY_VQ widths)
JOINT_VQ = """
model:
  params:
    embed_dim: 3
    n_embed: 16
    ddconfig:
      ch: 4
      ch_mult: [1, 2, 4]
      resolution: 16
"""


def _script(name):
    """A module of scripts/ loaded by path (the scripts are not a package)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sdfs(n, seed, res=16):
    r = np.random.default_rng(seed)
    return np.stack([np.clip(analytic_sdf(i % 3, res, r), -0.2, 0.2)[..., None]
                     for i in range(n)]).astype(np.float32)


def _jax_cfg():
    from echoscene_tpu.models.config import VQVAEConfig

    return VQVAEConfig(**VQ_KW)


@pytest.fixture(scope="module")
def vq():
    """The port's VQ trainer and state (perturbed weights) and JAX's
    trainer with the same weights."""
    from echoscene_tpu.convert import torch_import
    from echoscene_tpu.train.vqvae_trainer import VQVAETrainer as JT
    from echoscene_torch.models.config import VQVAEConfig
    from echoscene_torch.train.vqvae_trainer import VQVAETrainer

    pt = VQVAETrainer(VQVAEConfig(**VQ_KW), lr=1e-3, device="cpu")
    state = pt.init(torch.Generator().manual_seed(0))
    r = np.random.default_rng(3)
    with torch.no_grad():
        for p in state.module.parameters():
            p.add_(torch.from_numpy(r.normal(0.0, 0.05, p.shape).astype(
                np.float32)))
    sd = {k: v.numpy() for k, v in state.module.state_dict().items()}
    params = jax.tree.map(jnp.asarray, torch_import.convert_vqvae(
        sd, ch=8, ch_mult=(1, 2)))
    jt = JT(_jax_cfg(), lr=1e-3)
    return types.SimpleNamespace(pt=pt, state=state, jt=jt, params=params,
                                 x=_sdfs(4, 0))


def _to_port(tree):
    """A JAX VQ-VAE-shaped tree -> the port's state_dict keys (numpy)."""
    return {k: np.asarray(v) for k, v in from_jax.convert_vqvae(
        jax.tree.map(np.asarray, tree), ch_mult=(1, 2)).items()}


def _assert_indices_tie_aware(zj, zp, ij, ip, book):
    """Each side's index is a nearest code of its own latent (within 1e-6
    of the f64 minimum), and the two agree wherever the nearest code is
    unique by more than the latents' difference can move it."""
    book = np.asarray(book, np.float64)

    def dists(z):
        return ((z.reshape(-1, 1, 3).astype(np.float64) - book[None]) ** 2
                ).sum(-1)
    dj, dp = dists(zj), dists(zp)
    rows = np.arange(dj.shape[0])
    ij, ip = ij.reshape(-1), ip.reshape(-1)
    assert np.all(dj[rows, ij] - dj.min(1) <= 1e-6)
    assert np.all(dp[rows, ip] - dp.min(1) <= 1e-6)
    gap = np.sort(dj, 1)[:, 1] - dj.min(1)
    unique = gap > 1e-4
    assert unique.mean() > 0.9
    assert np.array_equal(ij[unique], ip[unique])


def test_vqvae_forward_matches_jax(vq):
    from echoscene_tpu.nn.vqvae import VQVAE as JV

    jm = vq.jt.model
    v = {"params": vq.params}
    dec_j, diff_j = jax.jit(jm.apply)(v, jnp.asarray(vq.x))
    zj_pre, (_, _, ij) = jax.jit(lambda v, x: (
        jm.apply(v, x, method=JV.encode_no_quant),
        jm.apply(v, x, method=JV.encode)))(v, jnp.asarray(vq.x))
    with torch.no_grad():
        x = torch.from_numpy(vq.x)
        dec_p, diff_p = vq.state.module(x)
        _, _, ip = vq.state.module.encode(x)
        zp_pre = vq.state.module.encode_no_quant(x)
    dec_j = np.asarray(dec_j)
    assert dec_p.shape == dec_j.shape == vq.x.shape
    err = np.abs(dec_p.numpy() - dec_j).max() / np.abs(dec_j).max()
    rel = abs(float(diff_p) - float(diff_j)) / abs(float(diff_j))
    print(f"reconstruction error / peak {err:.3g}, codebook loss rel "
          f"{rel:.3g}")
    assert err <= 1e-4
    np.testing.assert_allclose(float(diff_p), float(diff_j), rtol=1e-5)
    _assert_indices_tie_aware(np.asarray(zj_pre), zp_pre.numpy(),
                              np.asarray(ij), ip.numpy(),
                              vq.params["quantize"]["embedding"])


@pytest.fixture(scope="module")
def vq_grads(vq):
    (loss, logs), grads = jax.jit(jax.value_and_grad(
        vq.jt.loss_fn, has_aux=True))(vq.params, jnp.asarray(vq.x))
    module = vq.state.module
    module.zero_grad(set_to_none=True)
    ploss, plogs = vq.pt.loss_fn(module, torch.from_numpy(vq.x))
    ploss.backward()
    pgrads = {n: p.grad.clone() for n, p in module.named_parameters()}
    module.zero_grad(set_to_none=True)
    return dict(loss=float(loss), logs=jax.tree.map(float, logs),
                grads=grads, ploss=ploss.item(),
                plogs={k: v.item() for k, v in plogs.items()},
                pgrads=pgrads)


def test_vq_loss_and_gradients_match_jax(vq_grads):
    g = vq_grads
    np.testing.assert_allclose(g["ploss"], g["loss"], rtol=1e-5)
    assert g["plogs"].keys() == g["logs"].keys()
    for k, w in g["logs"].items():
        np.testing.assert_allclose(g["plogs"][k], w, rtol=1e-5, err_msg=k)
    want = _to_port(g["grads"])
    assert want.keys() == g["pgrads"].keys()
    worst = 0.0
    for n, w in want.items():
        err = np.abs(g["pgrads"][n].numpy() - w).max()
        # + 1e-9: a convolution bias ahead of a GroupNorm has a gradient
        # that cancels to rounding noise in both systems
        assert err <= 1e-4 * np.abs(w).max() + 1e-9, (n, err)
        if np.abs(w).max() > 1e-6:      # not a rounding-noise leaf
            worst = max(worst, err / np.abs(w).max())
    print(f"loss rel {abs(g['ploss'] - g['loss']) / g['loss']:.3g}, worst "
          f"gradient error / max|g_jax| {worst:.3g}")
    assert sum(np.abs(w).max() > 0 for w in want.values()) == len(want)


def test_vq_adam_step_matches_optax(vq, vq_grads):
    """One Adam step from JAX's gradients on both sides, then a second
    one: parameters within 1e-6 of optax.adam's."""
    from echoscene_torch.train.vqvae_trainer import VQVAETrainer

    pt = VQVAETrainer(vq.pt.cfg, lr=1e-3, device="cpu")
    state = pt.init(torch.Generator().manual_seed(0))
    state.module.load_state_dict(vq.state.module.state_dict())
    tx = optax.adam(1e-3)
    params, opt_state = vq.params, tx.init(vq.params)
    grads = vq_grads["grads"]
    @jax.jit
    def step(g, opt_state, params):
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state
    for scale in (1.0, -0.5):
        g = jax.tree.map(lambda a: a * scale, grads)
        params, opt_state = step(g, opt_state, params)
        pg = _to_port(g)
        for n, p in state.module.named_parameters():
            p.grad = torch.from_numpy(pg[n].copy())
        state.optimizer.step()
    want = _to_port(params)
    print("Adam max abs err", max(np.abs(p.detach().numpy() - want[n]).max()
                                  for n, p in state.module.named_parameters()))
    for n, p in state.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=1e-6,
                                   err_msg=n)


def test_voxel_iou_matches_jax():
    from echoscene_tpu.train.vqvae_trainer import voxel_iou as jiou
    from echoscene_torch.train.vqvae_trainer import voxel_iou

    gt = _sdfs(6, 1)
    rec = gt + np.random.default_rng(2).normal(0, 0.05, gt.shape).astype(
        np.float32)
    for thres in (0.0, 0.02):
        want = np.asarray(jiou(jnp.asarray(gt), jnp.asarray(rec), thres))
        got = voxel_iou(torch.from_numpy(gt), torch.from_numpy(rec),
                        thres).numpy()
        assert got.dtype == want.dtype
        assert np.array_equal(got, want)


def test_vq_eval_iou_and_encode_match_jax(vq):
    from echoscene_tpu.train.vqvae_trainer import VQTrainState

    jstate = VQTrainState(step=jnp.zeros((), jnp.int32), params=vq.params,
                          opt_state=vq.jt.tx.init(vq.params))
    batches = [vq.x[:2], vq.x[2:]]
    want = vq.jt.eval_iou(jstate, batches)
    got = vq.pt.eval_iou(vq.state, [torch.from_numpy(b) for b in batches])
    np.testing.assert_allclose(got, want, atol=1e-6)
    zj = np.asarray(vq.jt.encode(jstate, jnp.asarray(vq.x)))
    zp = vq.pt.encode(vq.state, torch.from_numpy(vq.x)).numpy()
    assert zp.shape == zj.shape == (4, 8, 8, 8, 3)
    print(f"eval_iou {got} vs {want}; encode error / peak "
          f"{np.abs(zp - zj).max() / np.abs(zj).max():.3g}")
    assert np.abs(zp - zj).max() <= 1e-4 * np.abs(zj).max()


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    from echoscene_torch.data.fake import make_fake_dataset

    return make_fake_dataset(str(tmp_path_factory.mktemp("pipeline_data")),
                             num_scenes=4, min_objs=3, max_objs=4,
                             sdf_res=16, with_sdf=True, seed=1)


def test_vqvae_cli_end_to_end(fake_root, tmp_path):
    from echoscene_torch.train import vqvae_cli
    from echoscene_torch.train.checkpoint import load_vqvae_params
    from echoscene_torch.train.vqvae_trainer import build_vqvae

    (tmp_path / "vq.yaml").write_text(TINY_VQ8)
    exp = tmp_path / "vq"
    state = vqvae_cli.main(["--dataset", fake_root, "--exp", str(exp),
                            "--batch", "2", "--steps", "3", "--eval_every",
                            "2", "--vq_cfg", str(tmp_path / "vq.yaml"),
                            "--device", "cpu"])
    assert state.step == 3
    for name in ("epoch-best", "final"):
        target = build_vqvae(vqvae_cli.load_vq_config(str(tmp_path /
                                                          "vq.yaml")))
        load_vqvae_params(str(exp / name), target)
        if name == "final":
            ref, got = state.module.state_dict(), target.state_dict()
            assert all(torch.equal(got[k], ref[k]) for k in ref)
    with pytest.raises(NotImplementedError):
        vqvae_cli.main(["--dataset", fake_root, "--exp", str(exp),
                        "--compute_dtype", "bfloat16", "--device", "cpu"])


def test_latents_match_jax_and_cache_interchanges(vq, fake_root, tmp_path):
    """precompute_latents against JAX's trainer.encode of the same grids;
    JAX's make_latent_lookup reads the port's file equal, the port's reads
    a file in JAX's layout; a missing path gives the zero grid's latent."""
    from echoscene_tpu.train.vqvae_trainer import VQTrainState
    from echoscene_torch.data.sgfront import SGFrontDataset
    from echoscene_torch.train import latents

    ds = SGFrontDataset(fake_root, use_sdf=True, with_changes=False,
                        shuffle_objs=False, sdf_res=16)
    paths = latents.dataset_sdf_paths(ds)
    assert len(paths) >= 4
    got = latents.precompute_latents(vq.state.module, paths, ds.load_sdf,
                                     batch=3, device="cpu")
    assert set(got) == set(paths) | {"__zero__"}
    jstate = VQTrainState(step=jnp.zeros((), jnp.int32), params=vq.params,
                          opt_state=None)
    keys = ["__zero__"] + paths
    grids = np.stack([ds.load_sdf(None)] + [ds.load_sdf(p) for p in paths])
    want = np.asarray(vq.jt.encode(jstate, jnp.asarray(grids)))
    peak = np.abs(want).max()
    for k, w in zip(keys, want):
        assert got[k].dtype == np.float32 and got[k].shape == (8, 8, 8, 3)
        assert np.abs(got[k] - w).max() <= 1e-4 * peak, k

    port_file = str(tmp_path / "port.npz")
    latents.write_latent_cache(port_file, got)
    jlookup = _script("precompute_latents").make_latent_lookup(port_file)
    plookup = latents.make_latent_lookup(port_file)
    for k in paths:
        assert np.array_equal(jlookup(k), got[k])
        assert np.array_equal(plookup(k), got[k])
    for lookup in (jlookup, plookup):
        assert np.array_equal(lookup("missing.h5"), got["__zero__"])
        assert np.array_equal(lookup(None), got["__zero__"])
    # a file as JAX's script writes it (savez_compressed of f32 arrays)
    jax_file = str(tmp_path / "jax.npz")
    np.savez_compressed(jax_file, **{k: w.astype(np.float32)
                                     for k, w in zip(keys, want)})
    plookup = latents.make_latent_lookup(jax_file)
    for k, w in zip(keys, want):
        assert np.array_equal(plookup(k), w)
    assert np.array_equal(plookup("missing.h5"), want[0])


# --- the port alone: cache vs SDFs, previews, background saves -----------
@pytest.fixture(scope="module")
def port_pipeline(tmp_path_factory, fake_root):
    from echoscene_torch.data.collate import CollateSpec
    from echoscene_torch.data.sgfront import SGFrontDataset
    from test_torch_port_train import _tiny_port_sg

    base = tmp_path_factory.mktemp("port_pipeline")
    root = fake_root
    ds = SGFrontDataset(root, use_sdf=True, with_changes=True, seed=3,
                        sdf_res=16)
    spec = CollateSpec(max_nodes=24, max_triples=64, max_scenes=2,
                       diffusion_bs=12, with_sdf=True, sdf_res=16,
                       latent_res=4, latent_ch=3)
    return types.SimpleNamespace(base=base, root=root, ds=ds, spec=spec,
                                 make_sg=_tiny_port_sg)


def test_cache_step_equals_sdf_step(port_pipeline):
    """One f32 joint training step from a batch collated from the latent
    cache against one from the same scenes' SDFs through the frozen
    encoder: latents within 1e-6 of their peak, the loss within 1e-5
    relative.  (Parameters after the step are not compared: AdamW's first
    step moves every weight by ~lr times the sign of its gradient, which
    rounding can flip on a leaf whose gradient nearly cancels.)"""
    from echoscene_torch.data.collate import collate_scenes
    from echoscene_torch.train import latents

    pp = port_pipeline
    ds, spec = pp.ds, pp.spec
    # drawn once: each ds[i] draws a fresh object order and change
    examples = [ds[0], ds[1]]
    runs = []
    for use_cache in (False, True):
        sg = pp.make_sg(ds)
        lookup = None
        if use_cache:
            lookup = latents.make_latent_lookup(_write_cache(
                sg, ds, str(pp.base / "cache.npz")))
        batch = collate_scenes(examples, spec, sdf_loader=ds.load_sdf,
                               latent_lookup=lookup)
        if not use_cache:
            with torch.no_grad():
                enc = sg.module.encode_sdf(batch.shapes.sdf)
        else:
            enc = batch.shapes.latent
        # the rows past num_valid are padding: zeros in the cache's batch,
        # the zero grid's latent through the encoder; the loss masks them
        enc = enc[:int(batch.shapes.num_valid)]
        state = sg.init_train_state()
        metrics = sg.train_step(state, batch, torch.Generator().manual_seed(5))
        runs.append((enc, metrics["loss"].item(), sg))
    (enc_s, loss_s, sg_s), (enc_c, loss_c, sg_c) = runs
    assert enc_c.shape == enc_s.shape and len(enc_s) > 4
    assert (enc_c - enc_s).abs().max() <= 1e-6 * enc_s.abs().max()
    np.testing.assert_allclose(loss_c, loss_s, rtol=1e-5)
    assert sg_c is not sg_s and loss_s > 0


def _write_cache(sg, ds, path):
    from echoscene_torch.train import latents

    out = latents.precompute_latents(sg.module.vqvae,
                                     latents.dataset_sdf_paths(ds),
                                     ds.load_sdf, batch=4, device="cpu")
    latents.write_latent_cache(path, out)
    return path


class RecordingWriter:
    """What a TensorBoard writer is given, kept in memory."""

    def __init__(self):
        self.images, self.scalars = [], []

    def add_image(self, tag, img, step):
        self.images.append((tag, np.array(img), step))

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))


def _preview_trainer(pp, tmp, writer):
    """A tiny model and a Trainer over a fresh reader of the fixture's
    dataset (a reader's draws advance with every example it gives)."""
    from echoscene_torch.data.sgfront import SGFrontDataset
    from echoscene_torch.train.trainer import Trainer

    ds = SGFrontDataset(pp.root, use_sdf=True, with_changes=True, seed=3,
                        sdf_res=16)
    sg = pp.make_sg(ds)
    sg.cfg.sample_dtype = "float32"   # the CPU samples in f32
    return sg, Trainer(sg, ds, pp.spec, tmp, batch_scenes=2, log_every=1,
                       seed=0, writer=writer)


def test_preview_images_match_jax_render(port_pipeline, tmp_path):
    """gen_shape_0 / gen_shape_1 are JAX's render_sdf_grid of the first two
    sampled SDFs (CHW, at the step counter), and the module's train / eval
    modes are restored."""
    from echoscene_tpu.eval.render import render_sdf_grid
    from echoscene_torch.data.collate import collate_scenes

    pp = port_pipeline
    writer = RecordingWriter()
    sg, tr = _preview_trainer(pp, str(tmp_path), writer)
    batch = collate_scenes([pp.ds[0], pp.ds[1]], pp.spec,
                           sdf_loader=pp.ds.load_sdf)
    sampled = []
    sample_fn = sg.sample_fn

    def recording(*args, **kwargs):
        out = sample_fn(*args, **kwargs)
        sampled.append(out["shapes"])
        return out
    sg.sample_fn = recording
    sg.module.train()
    sg.module.vqvae.eval()
    modes = [m.training for m in sg.module.modules()]
    tr.preview_shapes(batch, 7)
    assert [m.training for m in sg.module.modules()] == modes
    assert [(t, s) for t, _, s in writer.images] == [("gen_shape_0", 7),
                                                     ("gen_shape_1", 7)]
    for i, (_, img, _) in enumerate(writer.images):
        want = render_sdf_grid(sampled[0][i, ..., 0].numpy())
        assert img.shape == (3,) + want.shape[:2]
        assert np.array_equal(img, want.transpose(2, 0, 1))
    assert writer.images[0][1].min() < 255   # a shape was drawn


def test_previews_leave_training_bit_equal(port_pipeline, tmp_path):
    """Two steps through Trainer.train with a preview after each, against
    the same two steps without: parameters, buffers and the optimizer's
    state bit-equal."""
    pp = port_pipeline
    runs = []
    for every in (1, 0):
        writer = RecordingWriter()
        sg, tr = _preview_trainer(pp, str(tmp_path / f"p{every}"), writer)
        state = tr.train(sg.init_train_state(), epochs=1, max_steps=2,
                         preview_every=every, final_save=False)
        runs.append((sg, state, writer))
    (sg_a, st_a, w_a), (sg_b, st_b, w_b) = runs
    assert len(w_a.images) == 4 and not w_b.images
    sa, sb = sg_a.module.state_dict(), sg_b.module.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = st_a.optimizer.state_dict(), st_b.optimizer.state_dict()
    for i, st in oa["state"].items():
        for key, val in st.items():
            assert torch.equal(val, ob["state"][i][key]), (i, key)


@pytest.fixture
def ckpt_sg(port_pipeline):
    sg = port_pipeline.make_sg(port_pipeline.ds)
    return sg, sg.init_train_state()


def _file_params(path):
    from echoscene_torch.convert.from_jax import checkpoint_to_module

    return checkpoint_to_module(torch.load(path, weights_only=True))


def test_background_save_restores_equal(ckpt_sg, port_pipeline, tmp_path):
    from echoscene_torch.train.checkpoint import (restore_checkpoint,
                                                  save_checkpoint)

    sg, state = ckpt_sg
    state.step, state.epoch = 5, 2
    path = str(tmp_path / "model2")
    save_checkpoint(path, sg, state, wait=False)
    other = port_pipeline.make_sg(port_pipeline.ds, seed=1)
    st2 = restore_checkpoint(path, other, other.init_train_state())
    a, b = sg.module.state_dict(), other.module.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert (st2.step, st2.epoch) == (5, 2)
    assert not os.path.exists(path + ".tmp")


def test_background_save_ignores_later_mutation(ckpt_sg, tmp_path):
    from echoscene_torch.train.checkpoint import (save_checkpoint,
                                                  wait_for_checkpoints)

    sg, state = ckpt_sg
    before = {k: v.clone() for k, v in sg.module.state_dict().items()}
    path = str(tmp_path / "model0")
    save_checkpoint(path, sg, state, wait=False)
    with torch.no_grad():
        for p in sg.module.parameters():
            p.add_(1.0)
    wait_for_checkpoints()
    saved = _file_params(path)
    assert all(torch.equal(saved[k], v) for k, v in before.items())


def test_second_save_waits_for_the_first(ckpt_sg, tmp_path, monkeypatch):
    import threading
    import time as _time

    from echoscene_torch.train import checkpoint

    sg, state = ckpt_sg
    events, save = [], torch.save

    def slow_save(obj, path):
        events.append(("start", os.path.basename(path),
                       threading.current_thread().name))
        _time.sleep(0.3)
        save(obj, path)
        events.append(("end", os.path.basename(path)))
    monkeypatch.setattr(checkpoint.torch, "save", slow_save)
    checkpoint.save_checkpoint(str(tmp_path / "model0"), sg, state,
                               wait=False)
    checkpoint.save_checkpoint(str(tmp_path / "model1"), sg, state,
                               wait=False)
    checkpoint.wait_for_checkpoints()
    assert [e[:2] for e in events] == [
        ("start", "model0.tmp"), ("end", "model0.tmp"),
        ("start", "model1.tmp"), ("end", "model1.tmp")]
    assert events[0][2] == "checkpoint-writer"
    assert os.path.exists(tmp_path / "model1")


def test_failing_writer_raises_at_wait(ckpt_sg, tmp_path, monkeypatch):
    from echoscene_torch.train import checkpoint

    sg, state = ckpt_sg

    def failing(obj, path):
        raise OSError("disk full")
    monkeypatch.setattr(checkpoint.torch, "save", failing)
    checkpoint.save_checkpoint(str(tmp_path / "model0"), sg, state,
                               wait=False)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.wait_for_checkpoints()
    checkpoint.wait_for_checkpoints()      # raised once, then cleared
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save_checkpoint(str(tmp_path / "model1"), sg, state)
    assert not os.path.exists(tmp_path / "model0")


def test_pipeline_clis_end_to_end(port_pipeline, tmp_path):
    """vqvae_cli -> precompute_latents -> train.cli with --vq_ckpt,
    --latent_cache and a preview, all on the CPU."""
    from echoscene_torch.train import cli as train_cli
    from echoscene_torch.train import precompute_latents, vqvae_cli

    pytest.importorskip("torch.utils.tensorboard")
    root = port_pipeline.root
    exp = tmp_path / "exp"
    exp.mkdir()
    for name, text in (("tiny.yaml", TINY_YAML), ("df.yaml", TINY_DF),
                       ("vq.yaml", JOINT_VQ)):
        (exp / name).write_text(text)
    vq_exp = tmp_path / "vq"
    vqvae_cli.main(["--dataset", root, "--exp", str(vq_exp), "--batch", "2",
                    "--steps", "2", "--eval_every", "1", "--vq_cfg",
                    str(exp / "vq.yaml"), "--device", "cpu"])
    npz = precompute_latents.main([
        "--dataset", root, "--ckpt", str(vq_exp / "epoch-best"), "--out",
        str(tmp_path / "cache.npz"), "--vq_cfg", str(exp / "vq.yaml"),
        "--device", "cpu"])
    assert np.load(npz)["__zero__"].shape == (4, 4, 4, 3)
    state = train_cli.main([
        "--dataset", root, "--exp", str(exp), "--with_SDF", "True",
        "--diff_yaml", str(exp / "tiny.yaml"), "--batchSize", "2",
        "--max_nodes", "24", "--max_triples", "64", "--sdf_res", "16",
        "--diffusion_bs", "12", "--preview_every", "2", "--nepoch", "1",
        "--clip_backend", "hash", "--device", "cpu", "--compute_dtype",
        "float32", "--max_steps", "2", "--vq_ckpt",
        str(vq_exp / "epoch-best"), "--latent_cache", npz])
    assert state.step == 2
    assert (exp / "checkpoint" / "model1").exists()
    assert any(f.startswith("events") for f in os.listdir(exp / "logs"))


# --- the dataset checker -------------------------------------------------
@pytest.fixture(scope="module")
def check_roots(tmp_path_factory):
    """The fixture of tests/test_check_sgfront.py and a corrupted copy
    (the same five corruptions)."""
    import h5py
    from echoscene_tpu.data.fake import make_fake_dataset

    base = tmp_path_factory.mktemp("check")
    good = str(base / "sgfront")
    make_fake_dataset(good, num_scenes=4, min_objs=3, max_objs=5, sdf_res=16,
                      with_sdf=True)
    bad = str(base / "bad")
    shutil.copytree(good, bad)
    for suffix in ("trainval", "test"):
        p = os.path.join(bad, f"obj_boxes_bedroom_{suffix}.json")
        txt = open(p).read()
        open(p, "w").write(txt.replace(good, bad))
    sdf_dir = os.path.join(bad, "3D-FUTURE-SDF")
    victim = os.path.join(sdf_dir, sorted(os.listdir(sdf_dir))[0],
                          "ori_sample_grid.h5")
    os.remove(victim)
    with h5py.File(victim, "w") as f:
        f.create_dataset("wrong_name", data=np.zeros((2,), np.float32))
    rj = os.path.join(bad, "relationships_bedroom_trainval.json")
    d = json.load(open(rj))
    d["scans"][0]["relationships"].append([999, 1, 3, "front"])
    d["scans"][1]["relationships"].append([1, 2, 0, "left"])
    d["scans"][2]["relationships"].append([1, 2, "oops", "left"])
    json.dump(d, open(rj, "w"))
    bj = os.path.join(bad, "obj_boxes_bedroom_trainval.json")
    bd = json.load(open(bj))
    sid0 = d["scans"][0]["scan"]
    bd[sid0]["1"]["param7"] = [1.0, 2.0]
    del bd[sid0]["scene_center"]
    json.dump(bd, open(bj, "w"))
    with open(os.path.join(bad, "centered_bounds_bedroom_trainval.txt"),
              "w") as f:
        f.write("1.0 2.0 3.0\n")
    mp = os.path.join(bad, "mapping.json")
    m = json.load(open(mp))
    del m["lamp"]
    json.dump(m, open(mp, "w"))
    return base, good, bad


@pytest.mark.parametrize("which", ["good", "bad", "empty"])
def test_check_dataset_matches_jax(check_roots, which, tmp_path):
    from echoscene_tpu.data import check as jcheck
    from echoscene_torch.data import check as pcheck

    base, good, bad = check_roots
    root = {"good": good, "bad": bad, "empty": str(tmp_path)}[which]
    for kw in ({"sdf_res": 16}, {"sdf_res": 16, "sdf_sample": 0,
                                 "check_clip": True}):
        want = jcheck.check_dataset(root, **kw)
        got = pcheck.check_dataset(root, **kw)
        assert got.errors == want.errors
        assert got.warnings == want.warnings
        assert got.stats == want.stats
        assert got.render() == want.render()
    assert got.ok == (which == "good")


def _pickles(root):
    out = {}
    vis = os.path.join(root, "visualization")
    for sid in sorted(os.listdir(vis)):
        for name in sorted(os.listdir(os.path.join(vis, sid))):
            with open(os.path.join(vis, sid, name), "rb") as f:
                out[(sid, name)] = pickle.load(f)
    return out


def test_write_clip_cache_matches_jax(check_roots):
    from echoscene_tpu.data import check as jcheck
    from echoscene_tpu.data.clip_text import ClipTextEncoder as JClip
    from echoscene_torch.data import check as pcheck
    from echoscene_torch.data.clip_text import ClipTextEncoder

    base, good, _ = check_roots
    roots = []
    for name, mod, enc in (("jax", jcheck, JClip("hash")),
                           ("port", pcheck, ClipTextEncoder("hash"))):
        root = str(base / f"clip_{name}")
        shutil.copytree(good, root, ignore=shutil.ignore_patterns(
            "visualization"))
        assert mod.write_clip_cache(root, encoder=enc) > 0
        assert mod.write_clip_cache(root, encoder=enc) == 0
        roots.append(root)
    want, got = _pickles(roots[0]), _pickles(roots[1])
    assert want.keys() == got.keys() and len(want) > 0
    for key, w in want.items():
        g = got[key]
        assert g["instance_order"] == w["instance_order"]
        assert np.array_equal(g["instance_feats"], w["instance_feats"])
        assert g["instance_feats"].dtype == w["instance_feats"].dtype
        assert g["rel_feats"].keys() == w["rel_feats"].keys()
        for phrase, vec in w["rel_feats"].items():
            assert np.array_equal(g["rel_feats"][phrase], vec), phrase


def test_check_cli_exit_codes_match_jax(check_roots, capsys):
    from echoscene_torch.data import check_cli

    _, good, bad = check_roots
    script = _script("check_sgfront")
    for root, rc in ((good, 0), (bad, 1)):
        argv = ["--dataset", root, "--sdf_res", "16"]
        assert script.main(argv) == rc
        want = capsys.readouterr().out
        assert check_cli.main(argv) == rc
        got = capsys.readouterr().out
        assert got == want
        assert ("RESULT: OK" in got) == (rc == 0)
