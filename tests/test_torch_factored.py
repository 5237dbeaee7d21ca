"""The exact factored upsample of the port's sampling twin against JAX's.

* `blocks.factored_upsample_conv` against JAX's function on the UNet's
  (H, W) and the VQ decoder's (D, H, W) upsample: f32 within 1e-5 of the
  output's peak, bf16 (JAX's FactoredUpsampleConv: x and kernel cast to
  bf16, taps summed in bf16, the f32 bias added before the last rounding)
  within one bf16 ulp of the peak, 2^-7 of it; both within f32 rounding of
  interpolate + conv;
* the bf16 twin sets `factored` on the shape denoiser's and the VQ-VAE's
  upsamples and their config fields, and keeps those convs' biases f32; the
  f32 module, f32 sampling and the data-parallel sampler's replicas follow
  the same rule (tests/test_config.py:56-71 checks it for JAX);
* the whole tiny `sample_fn` in f32 with `factored_upsample` set on both
  packages' configs, from JAX's draws, within 1e-4;
* one bf16 shape-denoiser forward and one bf16 decode of the two twins on
  the same perturbed weights (a bf16 chain drifts too far to compare
  whole).  Each bf16 twin lies ~2% (mean error of the mean magnitude) from
  the f32 result on these tiny widths, and the two twins round in other
  orders outside the upsample too, so the tolerance is bf16's own drift:
  the port's twin within twice the distance of JAX's twin from JAX's f32
  module, both as max error of the peak and as mean error of the mean
  magnitude, and within 2^-4 / 2^-5 of them outright;
* on a card (`cuda` marker): the factored form against interpolate + conv
  in f32.
"""
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

torch.set_num_threads(1)
# jax is imported inside the tests that use it: the GPU machine has no jax
# and runs the `cuda` tests of this file with `-m cuda --noconftest`

BF16_DRIFTS = 2.0           # bf16 twins: errors of JAX's bf16 drift
BF16_MAX = 2.0 ** -4        # ... and at most: max err of the peak
BF16_MEAN = 2.0 ** -5       # ... mean err of the mean magnitude


def _case(up_axes_port, shape=(2, 6, 3, 4, 5), k=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((k, shape[1], 3, 3, 3)) / 9).astype(np.float32)
    b = rng.standard_normal(k).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("up", [(1, 2), (0, 1, 2)])
def test_factored_upsample_conv_matches_jax(up):
    import jax.numpy as jnp

    from echoscene_tpu.nn.blocks import factored_upsample_conv as jax_fuc
    from echoscene_torch.nn.blocks import factored_upsample_conv

    x, w, b = _case(up)
    jx = jnp.asarray(x.transpose(0, 2, 3, 4, 1))        # channel-last
    jw = jnp.asarray(w.transpose(2, 3, 4, 1, 0))        # (3, 3, 3, C, K)
    jax_up = tuple(1 + a for a in up)                    # x-axis indices
    tx, tw, tb = map(torch.from_numpy, (x, w, b))

    want = np.asarray(jax_fuc(jx, jw, jnp.asarray(b), jax_up)).transpose(
        0, 4, 1, 2, 3)
    got = factored_upsample_conv(tx, tw, tb, up).numpy()
    assert got.shape == want.shape
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * peak
    scale = [2 if a in up else 1 for a in range(3)]
    direct = F.conv3d(F.interpolate(tx, scale_factor=scale, mode="nearest"),
                      tw, tb, padding=1).numpy()
    assert np.abs(got - direct).max() <= 1e-5 * peak

    # bf16 as JAX's FactoredUpsampleConv runs it in the sampling twin
    want16 = np.asarray(jax_fuc(jx.astype(jnp.bfloat16),
                                jw.astype(jnp.bfloat16), jnp.asarray(b),
                                jax_up).astype(jnp.float32)).transpose(
        0, 4, 1, 2, 3)
    got16 = factored_upsample_conv(tx.bfloat16(), tw.bfloat16(), tb, up)
    assert got16.dtype == torch.bfloat16
    err = np.abs(got16.float().numpy() - want16)
    assert err.max() <= 2.0 ** -7 * np.abs(want16).max(), err.max()


def _tiny_port_sg(sample_dtype="bfloat16", **cfg_kw):
    from echoscene_torch.models.config import tiny_config
    from echoscene_torch.models.sgdiff import SGDiff

    cfg = tiny_config()
    cfg.sample_dtype = sample_dtype
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    torch.manual_seed(0)
    return SGDiff(cfg, 9, 16, device="cpu")


def _upsamples(module):
    from echoscene_torch.nn.blocks import Upsample
    from echoscene_torch.nn.vqvae import Upsample3D

    return [m for m in module.modules()
            if isinstance(m, Upsample3D)
            or (isinstance(m, Upsample) and m.dims == 3)]


def test_twin_takes_the_factored_upsample():
    from echoscene_torch.parallel.dp import DPSampler

    sg = _tiny_port_sg()
    twin = sg.inference_module()
    for part in (twin.shape_denoiser, twin.vqvae):
        ups = _upsamples(part)
        assert ups and all(m.factored for m in ups)
        for m in ups:
            assert m.conv.weight.dtype == torch.bfloat16
            assert m.conv.bias.dtype == torch.float32
    assert twin.cfg.shape_branch.denoiser.factored_upsample is True
    assert twin.cfg.shape_branch.vqvae.factored_upsample is True
    # the f32 module (training) keeps interpolate + conv
    assert not any(m.factored for m in _upsamples(sg.module))
    assert sg.cfg.shape_branch.denoiser.factored_upsample is False
    assert sg.module.layout_denoiser is not twin.layout_denoiser
    # the data-parallel sampler's replicas are the same twin
    sampler = DPSampler(sg, ["cpu", "cpu"])
    (model,) = sampler.models.values()
    assert all(m.factored for m in _upsamples(model))
    # f32 sampling runs the module as configured
    f32 = _tiny_port_sg("float32")
    assert f32.inference_module() is f32.module
    assert not any(m.factored for m in _upsamples(f32.module))


def test_sample_fn_with_factored_upsample_matches_jax(fake_batch):
    """The tiny f32 sample_fn with factored_upsample on both packages'
    configs (f32 sampling runs the module as configured), from JAX's draws:
    boxes and SDFs within 1e-4."""
    import jax
    import jax.numpy as jnp

    from test_torch_port_sample import (ATOL, _jax_config, _jax_noise,
                                        _params_and_stats, _port_config,
                                        to_port_batch)
    from echoscene_tpu.models.sgdiff import SGDiff as JSGDiff
    from echoscene_tpu.models.sgdiff import shape_row_capacity
    from echoscene_torch.convert import from_jax
    from echoscene_torch.models.sgdiff import SGDiff as PSGDiff

    batch, num_objs, num_preds = fake_batch
    cfg = _jax_config(2)
    cfg.shape_branch.denoiser.factored_upsample = True
    cfg.shape_branch.vqvae.factored_upsample = True
    jsg = JSGDiff(cfg, num_objs=num_objs, num_preds=num_preds)
    n = batch.num_nodes
    params, stats = _params_and_stats(jsg.module, batch,
                                      jnp.zeros((n, cfg.embedding_dim)))
    rows = shape_row_capacity(batch)
    rng = jax.random.PRNGKey(4)
    want = jax.jit(functools.partial(
        jsg.sample_fn, gen_shape=True, with_manipulation=True,
        shape_rows=rows))(params, stats, batch, rng)

    psg = PSGDiff(_port_config(cfg), num_objs, num_preds, device="cpu")
    assert all(m.factored for m in _upsamples(psg.module.shape_denoiser))
    assert all(m.factored for m in _upsamples(psg.module.vqvae))
    psg.module.load_state_dict(from_jax.to_state_dict(
        from_jax.checkpoint_to_module(
            from_jax.convert_echoscene_checkpoint(params, stats, cfg))),
        strict=True)
    got = psg.sample_fn(to_port_batch(batch), with_manipulation=True,
                        shape_rows=rows, noise=_jax_noise(rng, n, cfg, rows))
    for k in ("sizes", "translations", "angles", "keep", "shapes"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, atol=ATOL, err_msg=k)
    assert np.abs(np.asarray(want["shapes"])).max() > 1e-2


@pytest.fixture(scope="module")
def fake_batch(tmp_path_factory):
    """test_torch_port_sample's batch: a JAX-collated fake batch with
    manipulations, and the vocabulary sizes."""
    from test_torch_port_sample import _jax_config
    from echoscene_tpu.data.collate import CollateSpec, collate_scenes
    from echoscene_tpu.data.fake import make_fake_dataset
    from echoscene_tpu.data.sgfront import SGFrontDataset

    root = str(tmp_path_factory.mktemp("factored_fake"))
    make_fake_dataset(root, num_scenes=4, min_objs=3, max_objs=4, sdf_res=16,
                      with_sdf=False)
    ds = SGFrontDataset(root, use_sdf=False, with_changes=True, seed=3,
                        sdf_res=16)
    cfg = _jax_config(2)
    spec = CollateSpec(max_nodes=cfg.max_nodes, max_triples=cfg.max_triples,
                       max_scenes=cfg.batch_scenes)
    batch = collate_scenes([ds[i] for i in range(3)], spec)
    return batch, len(ds.classes), len(ds.pred_names)


@pytest.fixture(scope="module")
def twins(fake_batch):
    """JAX's bf16 sampling twin (module_infer, factored) and the port's, on
    the same perturbed weights, with the shape step's inputs."""
    import jax.numpy as jnp

    from test_torch_port_sample import (_jax_config, _params_and_stats,
                                        _port_config)
    from echoscene_tpu.models.sgdiff import SGDiff as JSGDiff
    from echoscene_torch.convert import from_jax
    from echoscene_torch.models.echo_scene import rel_s_dims
    from echoscene_torch.models.sgdiff import SGDiff as PSGDiff

    batch, num_objs, num_preds = fake_batch
    cfg = _jax_config(2)
    cfg.sample_dtype = "bfloat16"
    jsg = JSGDiff(cfg, num_objs=num_objs, num_preds=num_preds)
    assert jsg.module_infer.cfg.shape_branch.denoiser.factored_upsample
    n = batch.num_nodes
    params, stats = _params_and_stats(jsg.module, batch,
                                      jnp.zeros((n, cfg.embedding_dim)))
    psg = PSGDiff(_port_config(cfg), num_objs, num_preds, device="cpu")
    psg.module.load_state_dict(from_jax.to_state_dict(
        from_jax.checkpoint_to_module(
            from_jax.convert_echoscene_checkpoint(params, stats, cfg))),
        strict=True)
    rng = np.random.default_rng(3)
    sd = cfg.shape_branch.denoiser
    m = 8
    inputs = {
        "z": rng.standard_normal((m,) + (sd.image_size,) * 3
                                 + (cfg.shape_branch.vqvae.embed_dim,)
                                 ).astype(np.float32),
        "t": np.full((m,), 7, np.int64),
        "ctx": rng.standard_normal((m, 1, rel_s_dims(psg.cfg)[-1])
                                   ).astype(np.float32),
        "triples": np.asarray(batch.dec.triples)[:16].clip(0, m - 1),
        "obj_mask": np.ones((m,), np.float32),
        "tri_mask": np.ones((16,), np.float32)}
    return jsg, params, stats, psg, inputs


def _errors(got, want):
    """(max error of the peak, mean error of the mean magnitude)."""
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    return (float(err.max() / np.abs(want).max()),
            float(err.mean() / np.abs(want).mean()))


def _check_twin(name, jax_call, port_call, twins):
    """JAX's bf16 twin, its f32 module and the port's bf16 twin on one
    call: the port's twin (factored) against JAX's at bf16's drift."""
    from echoscene_torch.models.sgdiff import inference_twin

    jsg, params, stats, psg, _ = twins
    variables = {"params": params, "batch_stats": stats}
    want = np.asarray(jax_call(jsg.module_infer, variables), np.float32)
    drift = _errors(want, jax_call(jsg.module, variables))
    twin = inference_twin(psg.module, torch.bfloat16)
    with torch.no_grad():
        got = port_call(twin)
    assert got.dtype == torch.bfloat16
    errs = _errors(got.float().numpy(), want)
    print(f"{name}: the port's bf16 twin vs JAX's (max of the peak, mean of "
          f"the mean magnitude) {errs}; JAX's bf16 twin vs its f32 module "
          f"{drift}")
    for e, d, cap in zip(errs, drift, (BF16_MAX, BF16_MEAN)):
        assert e <= min(BF16_DRIFTS * d, cap), (errs, drift)


def test_bf16_twin_shape_step_matches_jax(twins):
    from echoscene_tpu.models.echo_scene import EchoSceneModule as JM

    x = twins[-1]
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    _check_twin(
        "bf16 shape step",
        lambda mod, v: mod.apply(v, x["z"], x["t"], x["ctx"], x["triples"],
                                 x["obj_mask"], x["tri_mask"],
                                 method=JM.shape_eps),
        lambda twin: twin.shape_eps(t["z"], t["t"], t["ctx"], t["triples"],
                                    t["obj_mask"], t["tri_mask"]), twins)


def test_bf16_twin_decode_matches_jax(twins):
    z = twins[-1]["z"]
    _check_twin(
        "bf16 decode",
        lambda mod, v: mod.apply(v, z,
                                 method=lambda m, q: m.vqvae.decode(q)),
        lambda twin: twin.vqvae.decode(torch.from_numpy(z)), twins)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,up", [((8, 32, 16, 8, 8), (1, 2)),
                                      ((2, 16, 16, 16, 16), (0, 1, 2))])
def test_factored_upsample_on_card_matches_plain(shape, up):
    """On the card in f32 (TF32 off), the factored form equals
    interpolate + conv within 1e-5 of the output's peak."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from echoscene_torch.models.sgdiff import set_precision
    from echoscene_torch.nn.blocks import factored_upsample_conv

    set_precision()
    x, w, b = (torch.from_numpy(a).cuda()
               for a in _case(up, shape=shape, k=shape[1]))
    scale = [2 if a in up else 1 for a in range(3)]
    want = F.conv3d(F.interpolate(x, scale_factor=scale, mode="nearest"),
                    w, b, padding=1)
    got = factored_upsample_conv(x, w, b, up)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
