"""Modules of the PyTorch port against their JAX counterparts, on the CPU.

Each test initialises the JAX module at test widths, perturbs its variables
(`perturb_params`: zero-initialised heads would make the comparison
vacuous), carries them into the port through convert/from_jax.py, loads them
with `load_state_dict(strict=True)` (so the port's key names and shapes are
the reference layout), and compares outputs on the same seeded inputs in
f32.  Tolerances: 1e-5 on the GCN and the VQ-VAE, 3e-3 on the UNets (as the
reference-tree parity tests).  The weight round trip JAX -> from_jax ->
torch_import must give back every leaf bit for bit.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import SHAPE_DEN_KW, perturb_params
from echoscene_tpu.convert import torch_import
from echoscene_torch.convert import from_jax
from echoscene_torch.nn import gcn as port_gcn
from echoscene_torch.nn import unet1d as port_unet1d
from echoscene_torch.nn import unet3d as port_unet3d
from echoscene_torch.nn import vqvae as port_vqvae

torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _variables(v):
    v = _np_tree(v)
    return v["params"], v.get("batch_stats", {})


def _load(module, sd):
    module.load_state_dict(from_jax.to_state_dict(sd), strict=True)
    return module.eval()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _assert_same_tree(a, b):
    fa, ta = jax.tree_util.tree_flatten_with_path(a)
    fb, tb = jax.tree_util.tree_flatten_with_path(b)
    assert ta == tb
    for (path, x), (_, y) in zip(fa, fb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and x.dtype == y.dtype, path
        assert np.array_equal(x, y), path


def _init_vars(module, *args, seed=0, **kw):
    """Variables of `module` without compiling its init: shapes from
    `jax.eval_shape`, values like flax's initialisers (kernels and
    embeddings drawn from `seed`, norm scales 1, biases 0, running mean 0,
    var 1), then `perturb_params` so that no head is zero."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args, **kw)
    r = np.random.default_rng(seed)

    def fill(path, s):
        name = getattr(path[-1], "key", "")
        if name in ("kernel", "embedding"):
            fan_in = int(np.prod(s.shape[:-1])) if name == "kernel" else 1
            return (r.normal(size=s.shape) / np.sqrt(fan_in)).astype(s.dtype)
        if name in ("scale", "var") or name.endswith("_scale"):
            return np.ones(s.shape, s.dtype)
        return np.zeros(s.shape, s.dtype)

    return perturb_params(jax.tree_util.tree_map_with_path(fill, shapes))


def _graph(rng, n, t, d_obj, d_pred):
    obj = rng.normal(size=(n, d_obj)).astype(np.float32)
    pred = rng.normal(size=(t, d_pred)).astype(np.float32)
    edges = rng.integers(0, n - 2, size=(t, 2)).astype(np.int32)
    obj_mask = np.ones(n, np.float32)
    obj_mask[-2:] = 0.0                      # padded node slots
    tri_mask = np.ones(t, np.float32)
    tri_mask[-3:] = 0.0                      # padded triple slots
    return obj, pred, edges, obj_mask, tri_mask


# --- schedules / boxes ----------------------------------------------------
def test_schedules_bit_equal():
    import dataclasses
    from echoscene_tpu.core import schedules as J
    from echoscene_torch.core import schedules as P

    for jt, pt in (
            (J.make_diffusion_tables(J.get_betas("linear", 1e-4, 0.02, 1000)),
             P.make_diffusion_tables(P.get_betas("linear", 1e-4, 0.02, 1000))),
            (J.make_diffusion_tables(J.ldm_linear_betas(8.5e-4, 0.012, 1000)),
             P.make_diffusion_tables(P.ldm_linear_betas(8.5e-4, 0.012, 1000)))):
        for f in dataclasses.fields(jt):
            assert np.array_equal(getattr(jt, f.name), getattr(pt, f.name))
        jd = J.ddim_tables(jt.alphas_cumprod, J.ddim_timesteps(100, 1000), 0.0)
        pd = P.ddim_tables(pt.alphas_cumprod, P.ddim_timesteps(100, 1000), 0.0)
        for f in dataclasses.fields(jd):
            assert np.array_equal(getattr(jd, f.name), getattr(pd, f.name))


def test_split_sample_matches_jax(rng):
    from echoscene_tpu.core.boxes import descale_box_params
    from echoscene_tpu.diffusion.ddpm import LayoutDiffusion as JLD
    from echoscene_torch.core.boxes import descale_box_params as p_descale
    from echoscene_torch.diffusion.ddpm import LayoutDiffusion as PLD

    vec = rng.normal(size=(9, 8)).astype(np.float32)
    want = JLD.split_sample(jnp.asarray(vec))
    got = PLD.split_sample(_t(vec))
    for k in ("sizes", "translations", "angles"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6)
    stats = rng.uniform(-2, 2, 14).astype(np.float32)
    np.testing.assert_allclose(
        p_descale(_t(vec), stats, angle=True).numpy(),
        np.asarray(descale_box_params(jnp.asarray(vec), jnp.asarray(stats),
                                      angle=True)), atol=1e-5)


# --- GCN --------------------------------------------------------------------
GCN_KW = dict(input_dim_obj=24, input_dim_pred=16, num_layers=2,
              hidden_dim=32, mlp_normalization="batch", residual=True,
              output_dim=20)


def _jax_gcn(rng, pooling):
    from echoscene_tpu.nn.gcn import GraphTripleConvNet

    jm = GraphTripleConvNet(pooling=pooling, **GCN_KW)
    inputs = _graph(rng, 9, 13, 24, 16)
    return jm, _init_vars(jm, *map(jnp.asarray, inputs)), inputs


def _port_gcn(pooling, params, stats):
    pm = port_gcn.GraphTripleConvNet(pooling=pooling, **GCN_KW)
    return _load(pm, from_jax.convert_gconv_net(
        params, stats, "", 2, batch_norm=True, residual=True))


@pytest.mark.parametrize("pooling", ["avg", "sum", "wAvg"])
def test_gcn_matches_jax(rng, pooling):
    """Eval mode (running statistics); masked one-hot pooling."""
    jm, v, inputs = _jax_gcn(rng, pooling)
    want = jax.jit(jm.apply)(v, *map(jnp.asarray, inputs))
    pm = _port_gcn(pooling, *_variables(v))
    with torch.no_grad():
        got = pm(*map(_t, inputs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_sum_matches_jax_onehot(rng, dtype):
    """`scatter_sum` against JAX's `scatter_sum_onehot` on padded, masked
    triples (the last 12 of 40 masked out, one node never hit), f32
    accumulation, the result in the input dtype: within 1e-6.  The bf16
    values sit on a grid whose sums are exact in f32, so both round the same
    sums."""
    from echoscene_tpu.nn.gcn import scatter_sum_onehot

    t, n, d = 40, 12, 24
    idx = rng.integers(0, n - 1, t).astype(np.int32)
    mask = (np.arange(t) < 28).astype(np.float32)
    values = (rng.normal(size=(t, d)) if dtype == "float32"
              else rng.integers(-512, 512, (t, d)) / 64).astype(np.float32)
    want = np.asarray(scatter_sum_onehot(
        jnp.asarray(values, dtype), jnp.asarray(idx), jnp.asarray(mask),
        n).astype(jnp.float32))
    got = port_gcn.scatter_sum(
        torch.from_numpy(values).to(getattr(torch, dtype)),
        torch.from_numpy(idx).long(), torch.from_numpy(mask), n)
    assert got.dtype == getattr(torch, dtype)
    assert np.all(want[n - 1] == 0) and np.abs(want).max() > 1
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=1e-6)


def test_masked_batchnorm_train_mode_matches_jax(rng):
    """Train mode: mask-weighted moments, and running statistics updated
    with torch momentum 0.1 == flax momentum 0.9, unbiased variance."""
    jm, v, inputs = _jax_gcn(rng, "avg")
    want, mutated = jax.jit(functools.partial(
        jm.apply, train=True, mutable=["batch_stats"]))(
            v, *map(jnp.asarray, inputs))
    pm = _port_gcn("avg", *_variables(v)).train()
    got = pm(*map(_t, inputs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-5)
    new_sd = from_jax.convert_gconv_net(
        _variables(v)[0], _np_tree(mutated["batch_stats"]), "", 2,
        batch_norm=True, residual=True)
    port_sd = pm.state_dict()
    for k, w in new_sd.items():
        if "running_" in k:
            np.testing.assert_allclose(port_sd[k].numpy(), w, atol=1e-6)


# --- denoisers -----------------------------------------------------------
LAYOUT_KW = dict(in_channels=8, model_channels=16, out_channels=8,
                 num_res_blocks=1, attention_resolutions=(2,),
                 channel_mult=(1, 2), num_heads=4, concat_dim=32,
                 crossattn_dim=32, gconv_num_layers=2, enable_t_emb=True)


def _layout_setup(rng, key):
    from echoscene_tpu.nn.unet1d import LayoutDenoiser

    jm = LayoutDenoiser(conditioning_key=key, use_checkpoint=False,
                        **LAYOUT_KW)
    n, t = 7, 9
    box = rng.normal(size=(n, 8)).astype(np.float32)
    obj, _, edges, obj_mask, tri_mask = _graph(rng, n, t, 24, 4)
    tri = np.stack([edges[:, 0], rng.integers(0, 16, t), edges[:, 1]],
                   1).astype(np.int32)
    steps = rng.integers(0, 1000, n).astype(np.int32)
    args = (box, obj, tri, steps)
    masks = dict(obj_mask=obj_mask, triple_mask=tri_mask)
    v = _init_vars(jm, *map(jnp.asarray, args), seed=1,
                   **{k: jnp.asarray(x) for k, x in masks.items()})
    return jm, v, args, masks


@pytest.mark.parametrize("key", ["crossattn", "concat"])
def test_layout_denoiser_matches_jax(rng, key):
    jm, v, args, masks = _layout_setup(rng, key)
    want = np.asarray(jax.jit(jm.apply)(
        v, *map(jnp.asarray, args),
        **{k: jnp.asarray(x) for k, x in masks.items()}))
    params, stats = _variables(v)
    pm = _load(port_unet1d.LayoutDenoiser(conditioning_key=key, obj_dim=24,
                                          **LAYOUT_KW),
               from_jax.convert_layout_denoiser(
                   params, stats, channel_mult=(1, 2), num_res_blocks=1,
                   attention_resolutions=(2,), gconv_num_layers=2))
    with torch.no_grad():
        got = pm(*map(_t, args), **{k: _t(x) for k, x in masks.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=3e-3)
    assert np.abs(want).max() > 1e-2      # perturbed heads: not vacuous


def _shape_port_kw():
    kw = dict(SHAPE_DEN_KW)
    kw.pop("use_checkpoint")
    return kw


def _shape_sd(params, stats):
    return from_jax.convert_shape_denoiser(
        params, stats, channel_mult=(1, 2), num_res_blocks=1,
        attention_resolutions=(2,), gconv_num_layers=2)


@pytest.fixture(scope="module")
def shape_setup():
    """SHAPE_DEN_KW (tests/conftest.py) with 4 objects of 8^3 latents."""
    from echoscene_tpu.nn.unet3d import ShapeDenoiser

    jm = ShapeDenoiser(**SHAPE_DEN_KW)
    r = np.random.default_rng(7)
    m, t = 4, 6
    x = r.normal(size=(m, 8, 8, 8, 3)).astype(np.float32)
    obj = r.normal(size=(m, 1, 24)).astype(np.float32)
    tri = np.stack([r.integers(0, m, t), r.integers(0, 16, t),
                    r.integers(0, m, t)], 1).astype(np.int32)
    steps = r.integers(0, 1000, m).astype(np.int32)
    masks = dict(obj_mask=np.ones(m, np.float32),
                 triple_mask=np.array([1, 1, 1, 1, 0, 1], np.float32))
    args = (x, obj, tri, steps)
    v = _init_vars(jm, *map(jnp.asarray, args), seed=3,
                   **{k: jnp.asarray(a) for k, a in masks.items()})
    return jm, v, args, masks


def test_shape_denoiser_matches_jax(shape_setup):
    """crossattn conditioning with the echo message-passing pass."""
    jm, v, args, masks = shape_setup
    want = np.asarray(jax.jit(jm.apply)(
        v, *map(jnp.asarray, args),
        **{k: jnp.asarray(a) for k, a in masks.items()}))
    pm = _load(port_unet3d.ShapeDenoiser(obj_dim=24, **_shape_port_kw()),
               _shape_sd(*_variables(v)))
    x, obj, tri, steps = map(_t, args)
    with torch.no_grad():
        got = pm(x, obj, tri.long(), steps,
                 **{k: _t(a) for k, a in masks.items()})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=3e-3)
    assert np.abs(want).max() > 1e-2


# --- VQ-VAE ----------------------------------------------------------------
VQ_KW = dict(n_embed=16, embed_dim=3, ch=4, ch_mult=(1, 2, 4),
             num_res_blocks=1, resolution=16)


@pytest.fixture(scope="module")
def vq_setup():
    from echoscene_tpu.nn.vqvae import VQVAE

    jm = VQVAE(attn_resolutions=(4,), **VQ_KW)
    r = np.random.default_rng(11)
    sdf = r.normal(size=(2, 16, 16, 16, 1)).astype(np.float32)
    v = _init_vars(jm, jnp.asarray(sdf), seed=2)
    params, _ = _variables(v)
    pm = _load(port_vqvae.VQVAE(attn_resolutions=(4,), **VQ_KW),
               from_jax.convert_vqvae(params, ch_mult=(1, 2, 4)))
    return jm, v, pm, sdf


def test_vq_encode_no_quant_matches_jax(vq_setup):
    from echoscene_tpu.nn.vqvae import VQVAE

    jm, v, pm, sdf = vq_setup
    want = np.asarray(jm.apply(v, jnp.asarray(sdf),
                               method=VQVAE.encode_no_quant))
    with torch.no_grad():
        got = pm.encode_no_quant(_t(sdf)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_vq_decode_no_quant_matches_jax(vq_setup):
    """Codebook indices compared tie-aware: each side's choice must be a
    nearest code (within 1e-6 of the f64 minimum distance), and they must
    agree wherever the nearest code is unique; then the decoded grids."""
    from echoscene_tpu.nn.vqvae import VQVAE

    jm, v, pm, _ = vq_setup
    z = (0.05 * np.random.default_rng(12).normal(size=(2, 4, 4, 4, 3))
         ).astype(np.float32)
    _, _, want_idx = jm.apply(v, jnp.asarray(z),
                              method=lambda m, h: m.quantize(h))
    with torch.no_grad():
        _, _, got_idx = pm.quantize(_t(z))
    book = np.asarray(v["params"]["quantize"]["embedding"], np.float64)
    d = ((z.reshape(-1, 1, 3).astype(np.float64) - book[None]) ** 2).sum(-1)
    dmin = d.min(1)
    wi, gi = np.asarray(want_idx).reshape(-1), got_idx.numpy().reshape(-1)
    rows = np.arange(d.shape[0])
    assert np.all(d[rows, gi] - dmin <= 1e-6)
    assert np.all(d[rows, wi] - dmin <= 1e-6)
    unique = (np.sort(d, 1)[:, 1] - dmin) > 1e-6
    assert np.array_equal(gi[unique], wi[unique])
    want = np.asarray(jm.apply(v, jnp.asarray(z),
                               method=VQVAE.decode_no_quant))
    with torch.no_grad():
        got = pm.decode_no_quant(_t(z)).numpy()
    assert got.shape == want.shape == (2, 16, 16, 16, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)


# --- weight round trip ------------------------------------------------------
def test_round_trip_gcn(rng):
    _, v, _ = _jax_gcn(rng, "avg")
    params, stats = _variables(v)
    sd = from_jax.convert_gconv_net(params, stats, "", 2, batch_norm=True,
                                    residual=True)
    p2, s2 = torch_import.convert_gconv_net(sd, "", 2, batch_norm=True,
                                            residual=True)
    _assert_same_tree(params, p2)
    _assert_same_tree(stats, s2)


@pytest.mark.parametrize("key", ["crossattn", "concat"])
def test_round_trip_layout_denoiser(rng, key):
    _, v, _, _ = _layout_setup(rng, key)
    params, stats = _variables(v)
    sd = from_jax.convert_layout_denoiser(
        params, stats, "LayoutDiff.df.model", channel_mult=(1, 2),
        num_res_blocks=1, attention_resolutions=(2,), gconv_num_layers=2)
    p2, s2 = torch_import.convert_layout_denoiser(
        sd, "LayoutDiff.df.model", model_channels=16, channel_mult=(1, 2),
        num_res_blocks=1, attention_resolutions=(2,), in_channels=8,
        gconv_num_layers=2)
    _assert_same_tree(params, p2)
    _assert_same_tree(stats, s2)


def test_round_trip_shape_denoiser(shape_setup):
    params, stats = _variables(shape_setup[1])
    p2, s2 = torch_import.convert_shape_denoiser(
        _shape_sd(params, stats), "", model_channels=16, channel_mult=(1, 2),
        num_res_blocks=1, attention_resolutions=(2,), in_channels=3,
        gconv_num_layers=2)
    _assert_same_tree(params, p2)
    _assert_same_tree(stats, s2)


def test_round_trip_vqvae():
    from echoscene_tpu.nn.vqvae import VQVAE

    jm = VQVAE(**VQ_KW)
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 16, 16, 16, 1)))
    r = np.random.default_rng(5)
    params = jax.tree.map(
        lambda s: r.normal(size=s.shape).astype(np.float32), v["params"])
    sd = from_jax.convert_vqvae(params, ch_mult=(1, 2, 4))
    p2 = torch_import.convert_vqvae(sd, ch=4, ch_mult=(1, 2, 4))
    _assert_same_tree(params, p2)
    _load(port_vqvae.VQVAE(**VQ_KW), sd)
