"""The int8 W8A8 sampling mode of the port against JAX's, on the CPU.

JAX's int8 mode (echoscene_tpu/nn/quant.py) runs here as its own tests run
it (XLA on the CPU); the port's wrappers take their plain versions on CPU
tensors (kernels/int8_conv.py).  Inputs come from numpy seeds; weights are
perturbed where a zero head would make a comparison vacuous.

* `quantize_symmetric` and Q1's plain version: int8 values and scales
  bit-equal to JAX's, per tensor and per channel, f32 and bf16 inputs;
* `Int8Conv3d` (3x3x3, strided (1, 2, 2), 1x1x1, the 3-channel conv_in on
  f32 input), `Int8Linear` and the quantized `factored_upsample_conv` on
  both `up_axes` sets against JAX's Int8Conv / Int8Dense /
  factored_upsample_conv(quantized=True): bf16 within 1 ulp on every
  element (the int32 accumulators are exact, so only the f32 epilogue's
  rounding can differ), bit-equal expected;
* one int8 ResBlock within 2^-7 of the peak (the bf16 GroupNorms and
  SiLU around the convolutions round in other orders);
* the int8 twin's structure: Int8Conv3d at exactly the torso sites,
  everything else bf16, in the data-parallel sampler's replicas too
  (tensor parallelism: tests/test_torch_tp_int8.py);
* the tiny `sample_fn` under `sample_dtype: int8` at DPM++ 3 layout / 2
  shape steps from JAX's draws: boxes within the bf16 twin rule of
  tests/test_torch_factored.py (twice JAX's own drift from its f32 module,
  capped at 2^-4 of the peak / 2^-5 of the mean magnitude), SDFs within
  twice JAX's int8 twin's drift from its f32 module, and SDFs strictly
  closer to JAX's int8 output than the port's bf16 twin is;
* `build_flagship`'s fast profile (bench.py's) as JAX sets it;
* Q2's tile plan (`int8_conv.conv_plan`) emulated in torch, bit-equal to
  the plain version at every torso shape and the ragged cases; Q1's plain
  version bit-equal to JAX's at the torso's 14 input shapes;
* on a card (`cuda` marker): Q1 bit-equal and Q2 within 1 bf16 ulp of
  their plain versions (the factored upsample's parities into strided
  views too).
"""
import functools
import math

import numpy as np
import pytest
import torch
from echoscene_torch.kernels.int8_conv import bf16_ulps

torch.set_num_threads(1)
# jax is imported inside the tests that use it: the GPU machine has no jax
# and runs the `cuda` tests of this file with `-m cuda --noconftest`

BF16_DRIFTS = 2.0           # the bf16 twin rule (test_torch_factored.py)
BF16_MAX = 2.0 ** -4
BF16_MEAN = 2.0 ** -5
INT8_DRIFTS = 2.0           # SDFs: twice JAX's int8 twin's drift


def _bf16(a) -> torch.Tensor:
    """A JAX / numpy array -> a bf16 torch tensor (exact for bf16 data)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_channel", [False, True])
def test_quantize_symmetric_matches_jax(dtype, per_channel):
    import jax.numpy as jnp
    from echoscene_tpu.nn.quant import quantize_symmetric as jq
    from echoscene_torch.nn.quant import quantize_symmetric

    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 4, 6, 7)) * 2.5).astype(np.float32)
    x[0, 0, 0, 0, :3] = [0.5, -1.5, 2.5]      # exact halves of some scale
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    axes = (1, 2, 3, 4) if per_channel else None
    want_q, want_s = jq(jx, axes=axes)
    got_q, got_s = quantize_symmetric(tx, dims=axes)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert np.array_equal(got_q.numpy(), np.asarray(want_q))
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_act_layout_matches_jax(dtype):
    """Q1's plain version (the CPU path of `quantize_act`): JAX's per-tensor
    int8 values, channels-last, zero channels past C up to a multiple of
    32; the scale bit-equal."""
    import jax.numpy as jnp
    from echoscene_tpu.nn.quant import quantize_act as jq
    from echoscene_torch.kernels.int8_conv import quantize_act

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 37, 3, 4, 5)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want_q, want_s = jq(jnp.asarray(x.transpose(0, 2, 3, 4, 1)).astype(
        getattr(jnp, dtype)))
    q, s = quantize_act(tx)
    assert q.shape == (2, 3, 4, 5, 64) and q.is_contiguous()
    assert np.array_equal(q[..., :37].numpy(), np.asarray(want_q))
    assert not q[..., 37:].any()
    assert np.array_equal(s.numpy().reshape(()), np.asarray(want_s).reshape(()))


CONV_CASES = {
    # name: (x shape channel-last, K, kernel, stride, input dtype)
    "3x3x3": ((2, 4, 6, 6, 40), 24, 3, (1, 1, 1), "bfloat16"),
    "strided": ((2, 4, 8, 6, 16), 16, 3, (1, 2, 2), "bfloat16"),
    "1x1x1": ((2, 4, 4, 4, 48), 40, 1, (1, 1, 1), "bfloat16"),
    "conv_in": ((3, 4, 4, 4, 3), 16, 3, (1, 1, 1), "float32"),
}


def _conv_case(name, seed=0):
    shape, k, ks, stride, dtype = CONV_CASES[name]
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((ks, ks, ks, c, k))
         / np.sqrt(ks ** 3 * c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(k)).astype(np.float32)
    return x, w, b, ks, stride, dtype


@pytest.mark.parametrize("name", list(CONV_CASES))
def test_int8_conv_matches_jax(name):
    import jax.numpy as jnp
    from echoscene_tpu.nn.quant import Int8Conv
    from echoscene_torch.nn.layers import Conv3d
    from echoscene_torch.nn.quant import Int8Conv3d

    x, w, b, ks, stride, dtype = _conv_case(name)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    jconv = Int8Conv(features=w.shape[-1], kernel_size=(ks,) * 3,
                     strides=stride, padding=[(ks // 2, ks // 2)] * 3)
    want = jconv.apply({"params": {"kernel": w, "bias": b}}, jx)
    conv = Conv3d(w.shape[3], w.shape[4], ks, stride=stride, padding=ks // 2)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(4, 3, 0, 1, 2)))
        conv.bias.copy_(torch.from_numpy(b))
    q = Int8Conv3d(conv)
    assert q.weight is conv.weight and q.bias is conv.bias
    assert set(dict(q.state_dict())) == {"weight", "bias"}
    got = q(torch.from_numpy(x.transpose(0, 4, 1, 2, 3)).to(
        getattr(torch, dtype)))
    assert got.dtype == torch.bfloat16
    want = _bf16(np.asarray(want, np.float32).transpose(0, 4, 1, 2, 3))
    assert got.shape == want.shape
    ulps = bf16_ulps(got, want)
    print(f"{name}: {int((ulps == 0).sum())} of {ulps.numel()} bit-equal, "
          f"max {int(ulps.max())} ulp")
    assert int(ulps.max()) <= 1


def test_int8_linear_matches_jax():
    import jax.numpy as jnp
    from echoscene_tpu.nn.quant import Int8Dense
    from echoscene_torch.nn.layers import Linear
    from echoscene_torch.nn.quant import Int8Linear

    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 20)) / 7).astype(np.float32)
    b = rng.standard_normal(20).astype(np.float32)
    for use_bias in (True, False):
        params = {"kernel": w, **({"bias": b} if use_bias else {})}
        want = Int8Dense(features=20, use_bias=use_bias).apply(
            {"params": params}, jnp.asarray(x).astype(jnp.bfloat16))
        lin = Linear(48, 20, bias=use_bias)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w.T))
            if use_bias:
                lin.bias.copy_(torch.from_numpy(b))
        got = Int8Linear(lin)(torch.from_numpy(x).bfloat16())
        assert got.shape == (3, 5, 20) and got.dtype == torch.bfloat16
        assert int(bf16_ulps(got, _bf16(want)).max()) <= 1


@pytest.mark.parametrize("up", [(1, 2), (0, 1, 2)])
def test_quantized_factored_upsample_matches_jax(up):
    """JAX's FactoredUpsampleConv under the int8 sentinel: x cast to bf16,
    quantized once; each parity's sub-kernel summed in f32 from the f32
    kernel and quantized; sub-outputs bf16 without bias; then the f32 bias.
    The port's function and its Int8Conv3d-prepared form (the twin's) give
    the same bits."""
    import jax.numpy as jnp
    from echoscene_tpu.nn.blocks import factored_upsample_conv as jfuc
    from echoscene_torch.nn.blocks import factored_upsample_conv
    from echoscene_torch.nn.layers import Conv3d
    from echoscene_torch.nn.quant import Int8Conv3d

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 40, 3, 4, 5)).astype(np.float32)
    w = (rng.standard_normal((24, 40, 3, 3, 3)) / 30).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    want = jfuc(jnp.asarray(x.transpose(0, 2, 3, 4, 1)).astype(jnp.bfloat16),
                jnp.asarray(w.transpose(2, 3, 4, 1, 0)), jnp.asarray(b),
                tuple(1 + a for a in up), quantized=True)
    want = _bf16(np.asarray(want, np.float32).transpose(0, 4, 1, 2, 3))
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    got = factored_upsample_conv(tx.bfloat16(), tw, tb, up, quantized=True)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    ulps = bf16_ulps(got, want)
    print(f"up {up}: {int((ulps == 0).sum())} of {ulps.numel()} bit-equal")
    assert int(ulps.max()) <= 1
    conv = Conv3d(40, 24, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(tw)
        conv.bias.copy_(tb)
    q = Int8Conv3d(conv, up_axes=up)
    again = factored_upsample_conv(tx.bfloat16(), q.weight, q.bias, up,
                                   quantized=True, int8_subs=q.factored_subs())
    assert torch.equal(again, got)


def _int8_resblock(block, dtype=torch.bfloat16):
    """The port's int8 twin of a ResBlock, as `inference_twin` makes it."""
    import copy
    from echoscene_torch.nn.quant import Int8Conv3d, jax_rounding_

    twin = copy.deepcopy(block).eval()
    twin.in_layers[2] = Int8Conv3d(twin.in_layers[2])
    twin.out_layers[3] = Int8Conv3d(twin.out_layers[3])
    if isinstance(twin.skip_connection, torch.nn.Conv3d):
        twin.skip_connection = Int8Conv3d(twin.skip_connection)
    keep = {id(p) for m in twin.modules() if isinstance(m, Int8Conv3d)
            for p in m.parameters()}
    keep |= jax_rounding_(twin)
    for p in twin.parameters():
        if id(p) not in keep:
            p.data = p.data.to(dtype)
    return twin


def test_int8_resblock_matches_jax():
    import jax
    import jax.numpy as jnp
    from conftest import perturb_params
    from echoscene_tpu.nn.blocks import ResBlock as JResBlock
    from echoscene_torch.convert import from_jax
    from echoscene_torch.nn.blocks import ResBlock

    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 6, 6, 32)).astype(np.float32)
    emb = rng.standard_normal((2, 64)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    f32 = JResBlock(channels=32, out_channels=48)
    params = perturb_params(jax.jit(f32.init)(jax.random.PRNGKey(0), jx,
                                              jnp.asarray(emb)))["params"]
    want = JResBlock(channels=32, out_channels=48, dtype="int8").apply(
        {"params": params}, jx, jnp.asarray(emb))
    want = np.asarray(want, np.float32).transpose(0, 4, 1, 2, 3)
    block = ResBlock(32, 64, 48)
    sd = from_jax.convert_resblock(jax.tree.map(np.asarray, params), "b")
    block.load_state_dict(from_jax.to_state_dict(
        {k[2:]: v for k, v in sd.items()}), strict=True)
    with torch.no_grad():
        got = _int8_resblock(block)(
            torch.from_numpy(x.transpose(0, 4, 1, 2, 3)).bfloat16(),
            torch.from_numpy(emb))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    print(f"int8 ResBlock: max err {err.max() / np.abs(want).max():.3e} of "
          f"the peak")
    assert np.abs(want).mean() > 1e-2
    assert err.max() <= 2.0 ** -7 * np.abs(want).max()


def _tiny_port_sg(sample_dtype="int8"):
    from echoscene_torch.models.config import tiny_config
    from echoscene_torch.models.sgdiff import SGDiff

    cfg = tiny_config()
    cfg.sample_dtype = sample_dtype
    torch.manual_seed(0)
    return SGDiff(cfg, 9, 16, device="cpu")


def test_int8_twin_converts_the_torso_convs_only():
    """Int8Conv3d at conv_in, each ResBlock's two convolutions and skip,
    each Downsample, each Upsample (quantized factored) and the output
    convolution of the shape denoiser, nowhere else; f32 parameters there,
    bf16 elsewhere; the data-parallel sampler's replicas the same."""
    from echoscene_torch.nn.blocks import Downsample, ResBlock, Upsample
    from echoscene_torch.nn.quant import Int8Conv3d, RoundedSiLU
    from echoscene_torch.parallel.dp import DPSampler

    sg = _tiny_port_sg()
    twin = sg.inference_module()
    sd = twin.shape_denoiser
    want = {id(sd.input_blocks[0][0]), id(sd.out[2])}
    for m in sd.modules():
        if isinstance(m, ResBlock):
            want |= {id(m.in_layers[2]), id(m.out_layers[3])}
            if not isinstance(m.skip_connection, torch.nn.Identity):
                want.add(id(m.skip_connection))
        elif isinstance(m, Downsample):
            want.add(id(m.op))
        elif isinstance(m, Upsample):
            want.add(id(m.conv))
            assert m.factored and m.conv.up_axes == (1, 2)
    got = {id(m) for m in twin.modules() if isinstance(m, Int8Conv3d)}
    assert got == want and len(got) == 25
    # f32: the int8 convolutions, the GroupNorms of the ResBlocks and of
    # the output head (JAX's rounding, nn.quant.jax_rounding_), and the
    # factored VQ-VAE upsamples' biases (as in the bf16 twin); bf16 else
    f32 = {id(p) for m in twin.modules() if isinstance(m, Int8Conv3d)
           for p in m.parameters()}
    norms = [sd.out[0]] + [n for m in sd.modules() if isinstance(m, ResBlock)
                           for n in (m.in_layers[0], m.out_layers[0])]
    f32 |= {id(p) for n in norms for p in n.parameters()}
    f32 |= {id(m.conv.bias) for m in twin.vqvae.modules()
            if hasattr(m, "factored") and m.factored}
    for name, p in twin.named_parameters():
        want_dtype = torch.float32 if id(p) in f32 else torch.bfloat16
        assert p.dtype == want_dtype, name
    assert isinstance(sd.out[1], RoundedSiLU)
    assert isinstance(sd.time_embed[1], RoundedSiLU)
    assert all(m.emb_layers[1].round_before_bias
               and isinstance(m.in_layers[1], RoundedSiLU)
               for m in sd.modules() if isinstance(m, ResBlock))
    # the layout denoiser is the bf16 twin's
    assert not any(getattr(m, "round_before_bias", False)
                   for m in twin.layout_denoiser.modules())
    # the twin leaves the f32 module and its state_dict keys alone
    assert set(twin.state_dict()) == set(sg.module.state_dict())
    assert not any(isinstance(m, Int8Conv3d) for m in sg.module.modules())
    sampler = DPSampler(sg, ["cpu", "cpu"])
    (model,) = sampler.models.values()
    assert sum(isinstance(m, Int8Conv3d) for m in model.modules()) == 25


def test_torso_conv_sites_match_the_twin(monkeypatch):
    """`int8_conv.torso_conv_sites` (the shapes chip_smoke.py checks Q1 /
    Q2 at, and the launch counts it expects) lists exactly the Q2 calls
    of one int8 twin shape step, and its Q1 count."""
    from collections import Counter
    from echoscene_torch.kernels import int8_conv as q8
    from echoscene_torch.models.echo_scene import rel_s_dims
    from echoscene_torch.nn import quant

    calls, q1 = [], []
    conv, act = q8.int8_conv3d, q8.quantize_act

    def record_conv(xq, wq, xs, ws, bias, stride, pads, out=None):
        calls.append((xq.shape[0], xq.shape[-1], tuple(xq.shape[1:4]),
                      wq.shape[0], tuple(wq.shape[1:4]), tuple(stride),
                      tuple(map(tuple, pads)), bias is not None))
        return conv(xq, wq, xs, ws, bias, stride, pads, out)

    def record_act(x):
        q1.append(tuple(x.shape))
        return act(x)
    for mod in (q8, quant):
        monkeypatch.setattr(mod, "int8_conv3d", record_conv)
        monkeypatch.setattr(mod, "quantize_act", record_act)
    sg = _tiny_port_sg()
    twin = sg.inference_module()
    sd = sg.cfg.shape_branch.denoiser
    m = 5
    z = torch.randn((m,) + (sd.image_size,) * 3
                    + (sg.cfg.shape_branch.vqvae.embed_dim,))
    with torch.no_grad():
        twin.shape_eps(z, torch.full((m,), 3), torch.randn(
            m, 1, rel_s_dims(sg.cfg)[-1]), torch.zeros((1, 3), dtype=torch.long),
            torch.ones(m), torch.ones(1))
    sites, q1_calls = q8.torso_conv_sites(sd, m)
    want = Counter()
    for site in sites:
        n, c = site["x_shape"][:2]
        want[(n, q8.padded_channels(c), site["x_shape"][2:], site["k"],
              site["taps"], site["stride"], site["pads"],
              site["bias"])] += site["calls"]
    assert Counter(calls) == want
    assert len(q1) == q1_calls == 25


# Q2's plan, emulated on the CPU: every distinct convolution of the
# flagship's int8 torso at 2 rows, chip_smoke.py's ragged case, the cuda
# test's 3-output one and Int8Linear's 1x1x1 rows
def _plan_sites():
    from echoscene_torch.kernels import int8_conv as q8
    from echoscene_torch.models.config import ShapeDenoiserConfig

    sites, _ = q8.torso_conv_sites(ShapeDenoiserConfig(), 2)
    cases = [(s["name"], s["x_shape"], s["k"], s["taps"], s["stride"],
              s["pads"], s["bias"]) for s in sites]
    cases += [
        ("ragged", (3, 37, 5, 7, 9), 19, (3, 3, 3), (1, 2, 2),
         ((1, 1),) * 3, True),
        ("ragged 3 outputs", (3, 40, 5, 7, 9), 3, (3, 3, 3), (1, 1, 1),
         ((1, 1),) * 3, True),
        ("linear rows", (300, 96, 1, 1, 1), 40, (1, 1, 1), (1, 1, 1),
         ((0, 0),) * 3, True)]
    return cases


PLAN_SITES = _plan_sites()


def _conv_by_plan(xq, wq, x_scale, w_scale, bias, plan):
    """Q2 as its plan lays it out: each tile's box of output positions in
    the kernel's row order, each tap's box of input positions at the
    plan's offsets and strides with zero fill outside the input and past
    the channels (TMA's out-of-range fill), each chunk of `cw` channels
    summed exactly (float32: at most 128 products of magnitude 127^2),
    accumulated over chunks and taps in float64, then `dequantize`; rows
    past the output dropped, as the epilogue does."""
    import torch.nn.functional as F
    from echoscene_torch.kernels import int8_conv as q8

    n, d, h, w, cp = xq.shape
    k = wq.shape[0]
    nb, db, hb, wb = plan["box"]
    tn, td, th, tw = plan["tiles"]
    sd, sh, sw = plan["stride"]
    cw = plan["cw"]
    cpad, kpad = plan["chunks"] * cw, plan["n_tiles"] * plan["bn"]
    assert nb * db * hb * wb == q8.TILE_M and cpad >= cp and kpad >= k
    x = F.pad(xq, (0, cpad - cp)).float()
    wm = F.pad(wq.reshape(k, -1, cp), (0, cpad - cp, 0, 0, 0, kpad - k))
    wm = wm.float()
    r = torch.arange(q8.TILE_M)
    t = torch.arange(tn * td * th * tw)[:, None]
    on = t // (tw * th * td) * nb + r // (wb * hb * db)
    od = t // (tw * th) % td * db + r // (wb * hb) % db
    oh = t // tw % th * hb + r // wb % hb
    ow = t % tw * wb + r % wb
    acc = torch.zeros(on.numel(), kpad, dtype=torch.float64)
    for tap, (fd, fh, fw) in enumerate(plan["tap_offsets"]):
        di, hi, wi = od * sd + fd, oh * sh + fh, ow * sw + fw
        inside = ((on < n) & (di >= 0) & (di < d) & (hi >= 0) & (hi < h)
                  & (wi >= 0) & (wi < w))
        a = x[on.clamp(max=n - 1), di.clamp(0, d - 1), hi.clamp(0, h - 1),
              wi.clamp(0, w - 1)] * inside[..., None]
        a = a.reshape(-1, cpad)
        for c0 in range(0, cpad, cw):
            acc += (a[:, c0:c0 + cw] @ wm[:, tap, c0:c0 + cw].T).double()
    do, ho, wo = plan["out_shape"]
    valid = ((on < n) & (od < do) & (oh < ho) & (ow < wo)).reshape(-1)
    y = q8.dequantize(acc[valid][:, :k].to(torch.int32), x_scale, w_scale,
                      bias)
    out = torch.zeros((n, k, do, ho, wo), dtype=torch.bfloat16)
    pos = [v.reshape(-1)[valid] for v in (on, od, oh, ow)]
    out[pos[0], :, pos[1], pos[2], pos[3]] = y
    # every output position is written by exactly one tile row
    assert int(valid.sum()) == n * do * ho * wo
    return out


@pytest.mark.parametrize("site", PLAN_SITES, ids=[
    f"{i}-{c[0]}" for i, c in enumerate(PLAN_SITES)])
def test_conv_plan_emulation_matches_plain(site):
    """Q2's tile plan (`int8_conv.conv_plan`: the box of output positions,
    each tap's input coordinates, the chunk width, the N tile), emulated in
    torch, equals `int8_conv3d_plain` bit for bit at every torso shape and
    the ragged cases: the plan covers every output once and reads the
    right inputs."""
    from echoscene_torch.kernels import int8_conv as q8
    from echoscene_torch.nn.quant import quantize_weight

    name, x_shape, k, taps, stride, pads, has_bias = site
    gen = torch.Generator().manual_seed(13)
    n, c = x_shape[:2]
    x = torch.randn(x_shape, generator=gen)
    xq, xs = q8.quantize_plain(x)
    wq, ws = quantize_weight(torch.randn((k, c) + tuple(taps), generator=gen))
    bias = torch.randn(k, generator=gen) if has_bias else None
    out_shape = q8.output_size(x_shape[2:], taps, stride, pads)
    out_strides = torch.empty((n, k) + out_shape).stride()
    plan = q8.conv_plan(n, tuple(x_shape[2:]), xq.shape[-1], k, tuple(taps),
                        tuple(stride), tuple(pads), out_strides)
    assert plan["cw"] in q8.CHUNKS and plan["bn"] == (
        q8.TILE_N_SMALL if k <= q8.TILE_N_SMALL else q8.TILE_N)
    assert len(plan["vector"]) == len(q8.PLAN_FIELDS) + 3 * math.prod(taps)
    got = _conv_by_plan(xq, wq, xs, ws, bias, plan)
    want = q8.int8_conv3d_plain(xq, wq, xs, ws, bias, stride, pads)
    assert torch.equal(got, want), name


def test_conv_plan_tiles_the_torso_without_waste():
    """At the flagship's 42 rows every torso convolution's box divides
    its output (no idle tile rows), 224, 448 and 672 output channels take
    1, 2 and 3 full N tiles and conv_out the small one; a shape the kernel
    does not take raises with its reason."""
    from echoscene_torch.kernels import int8_conv as q8
    from echoscene_torch.models.config import ShapeDenoiserConfig

    sites, _ = q8.torso_conv_sites(ShapeDenoiserConfig(), 42)
    for s in sites:
        n, c = s["x_shape"][:2]
        plan = q8.conv_plan(n, s["x_shape"][2:], q8.padded_channels(c),
                            s["k"], s["taps"], s["stride"], s["pads"],
                            (1, 1, 1, 1, 1))
        m = n * math.prod(plan["out_shape"])
        assert math.prod(plan["tiles"]) * q8.TILE_M == m, s["name"]
        assert plan["n_tiles"] * plan["bn"] == (
            s["k"] if s["k"] % q8.TILE_N == 0 else q8.TILE_N_SMALL), s["name"]
    args = dict(n=2, in_spatial=(4, 4, 4), cp=32, k=8, taps=(3, 3, 3),
                stride=(1, 1, 1), pads=((1, 1),) * 3,
                out_strides=(1, 1, 1, 1, 1))
    for bad, match in ((dict(stride=(1, 9, 1)), "strides"),
                       (dict(taps=(4, 3, 3)), "taps"),
                       (dict(pads=((1, 1), (-1, 1), (1, 1))), "pads"),
                       (dict(cp=48), "channels"),
                       (dict(in_spatial=(1, 1, 1), pads=((0, 0),) * 3),
                        "empty")):
        with pytest.raises(ValueError, match=match):
            q8.conv_plan(**{**args, **bad})


def test_q1_product_rounds_as_the_division():
    """Q1's kernel quantizes by y = x * rcp(scale) where y lies more than
    2^-15 from a half-integer, and by the IEEE division elsewhere
    (csrc/int8_conv.cu quant1).  Emulated in f32 at 64 scales, on every
    bf16 value up to the abs-max and on every f32 within 8 ulps of each
    half-integer multiple of the scale: the int8 values equal
    round(x / scale)'s everywhere, where the product alone misses some of
    the latter."""
    rng = np.random.default_rng(11)
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    bf16 = bits.view(torch.bfloat16).float()
    bf16 = bf16[torch.isfinite(bf16)]
    halves = torch.arange(-127, 127, dtype=torch.float32) + 0.5
    near = torch.arange(-8, 9, dtype=torch.int32)
    product_misses = 0
    for amax in np.exp(rng.uniform(np.log(1e-3), np.log(1e3), 64)):
        amax = torch.tensor(np.float32(amax))
        scale = torch.maximum(amax, torch.tensor(1e-8)) / torch.tensor(127.0)
        ties = ((halves * scale).view(torch.int32)[:, None] + near).view(
            torch.float32).reshape(-1)
        v = torch.cat([bf16, ties])
        v = v[v.abs() <= amax]
        want = torch.clamp(torch.round(v / scale), -127, 127)
        y = v * (torch.tensor(1.0) / scale)
        t = y.abs()
        fast = (t - torch.floor(t) - 0.5).abs() > 2.0 ** -15
        got = torch.where(fast, torch.round(y), torch.round(v / scale))
        assert torch.equal(torch.clamp(got, -127, 127), want)
        product_misses += int((torch.clamp(torch.round(y), -127, 127)
                               != want).sum())
    assert product_misses > 0

def _q1_inputs():
    from echoscene_torch.kernels import int8_conv as q8
    from echoscene_torch.models.config import ShapeDenoiserConfig

    sites, _ = q8.torso_conv_sites(ShapeDenoiserConfig(), 1)
    return sorted({(s["x_shape"], s["x_dtype"]) for s in sites})


Q1_INPUTS = _q1_inputs()


@pytest.mark.parametrize("case", Q1_INPUTS, ids=[
    f"{s[1]}x{s[2]}-{d}" for s, d in Q1_INPUTS])
def test_quantize_act_matches_jax_at_torso_inputs(case):
    """Q1's plain version at each of the torso's 14 input shapes (one row):
    JAX's per-tensor int8 values channels-last, zeros in the padded
    channels (Q2's chunks read past C), the scale bit-equal."""
    import jax.numpy as jnp
    from echoscene_tpu.nn.quant import quantize_act as jq
    from echoscene_torch.kernels.int8_conv import padded_channels, quantize_act

    shape, dtype = case
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want_q, want_s = jq(jnp.asarray(x.transpose(0, 2, 3, 4, 1)).astype(
        getattr(jnp, dtype)))
    q, s = quantize_act(tx)
    c = shape[1]
    assert q.shape == shape[:1] + shape[2:] + (padded_channels(c),)
    assert np.array_equal(q[..., :c].numpy(), np.asarray(want_q))
    assert not q[..., c:].any()
    assert np.array_equal(s.numpy().reshape(()),
                          np.asarray(want_s).reshape(()))


def test_fast_profile_config():
    """build_flagship(fast_profile=True) sets bench.py's fast profile: int8
    convs, DPM++ 50 layout / 20 shape steps (echoscene_tpu/benchmarks.py:
    59-67); sample_dtype alone overrides the config's."""
    from echoscene_torch.benchmarks import apply_profile
    from echoscene_torch.models.config import tiny_config

    cfg = apply_profile(tiny_config(), fast_profile=True)
    assert cfg.sample_dtype == "int8"
    assert cfg.layout_diffusion.sampler == "dpmpp"
    assert cfg.layout_diffusion.sample_steps == 50
    assert cfg.shape_branch.sampler == "dpmpp"
    assert cfg.shape_branch.ddim_steps == 20
    cfg = apply_profile(tiny_config(), sample_dtype="int8")
    assert cfg.sample_dtype == "int8"
    assert cfg.layout_diffusion.sampler == tiny_config().layout_diffusion.sampler


def _errors(got, want):
    """(max error of the peak, mean error of the mean magnitude)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    return (float(err.max() / np.abs(want).max()),
            float(err.mean() / np.abs(want).mean()))


@pytest.fixture(scope="module")
def int8_samples(tmp_path_factory):
    """JAX's tiny sample_fn under sample_dtype int8 and float32 on the same
    perturbed weights and draws (DPM++ 3 layout / 2 shape steps), and the
    port's int8 and bf16 twins on the same."""
    import jax
    import jax.numpy as jnp

    from test_torch_port_sample import (_jax_config, _jax_fast_noise,
                                        _params_and_stats, _port_config,
                                        to_port_batch)
    from echoscene_tpu.data.collate import CollateSpec, collate_scenes
    from echoscene_tpu.data.fake import make_fake_dataset
    from echoscene_tpu.data.sgfront import SGFrontDataset
    from echoscene_tpu.models.sgdiff import SGDiff as JSGDiff
    from echoscene_tpu.models.sgdiff import shape_row_capacity
    from echoscene_torch.convert import from_jax
    from echoscene_torch.models.sgdiff import SGDiff as PSGDiff

    root = str(tmp_path_factory.mktemp("int8_fake"))
    make_fake_dataset(root, num_scenes=4, min_objs=3, max_objs=4, sdf_res=16,
                      with_sdf=False)
    ds = SGFrontDataset(root, use_sdf=False, with_changes=True, seed=3,
                        sdf_res=16)
    cfg = _jax_config(2)
    cfg.layout_diffusion.sampler = "dpmpp"
    cfg.layout_diffusion.sample_steps = 3
    cfg.shape_branch.sampler = "dpmpp"
    cfg.shape_branch.ddim_steps = 2
    spec = CollateSpec(max_nodes=cfg.max_nodes, max_triples=cfg.max_triples,
                       max_scenes=cfg.batch_scenes)
    batch = collate_scenes([ds[i] for i in range(3)], spec)
    num_objs, num_preds = len(ds.classes), len(ds.pred_names)
    n = batch.num_nodes
    rows = shape_row_capacity(batch)
    rng = jax.random.PRNGKey(6)
    want = {}
    params = stats = None
    for sample_dtype in ("int8", "float32"):
        jcfg = _jax_config(2)
        jcfg.layout_diffusion.sampler = "dpmpp"
        jcfg.layout_diffusion.sample_steps = 3
        jcfg.shape_branch.sampler = "dpmpp"
        jcfg.shape_branch.ddim_steps = 2
        jcfg.sample_dtype = sample_dtype
        jsg = JSGDiff(jcfg, num_objs=num_objs, num_preds=num_preds)
        if params is None:
            params, stats = _params_and_stats(
                jsg.module, batch, jnp.zeros((n, cfg.embedding_dim)))
        out = jax.jit(functools.partial(
            jsg.sample_fn, gen_shape=True, with_manipulation=True,
            shape_rows=rows))(params, stats, batch, rng)
        want[sample_dtype] = {k: np.asarray(v, np.float32)
                              for k, v in out.items()}
    pcfg = _port_config(cfg)
    pcfg.sample_dtype = "int8"
    psg = PSGDiff(pcfg, num_objs, num_preds, device="cpu")
    psg.module.load_state_dict(from_jax.to_state_dict(
        from_jax.checkpoint_to_module(
            from_jax.convert_echoscene_checkpoint(params, stats, cfg))),
        strict=True)
    noise = _jax_fast_noise(rng, n, cfg)
    got = {}
    for sample_dtype in ("int8", "bfloat16"):
        psg.cfg.sample_dtype = sample_dtype
        out = psg.sample_fn(to_port_batch(batch), with_manipulation=True,
                            shape_rows=rows, noise=noise)
        got[sample_dtype] = {k: v.float().numpy() for k, v in out.items()}
    return want, got


def test_int8_sample_fn_boxes_match_jax(int8_samples):
    want, got = int8_samples
    for k in ("sizes", "translations", "angles"):
        drift = _errors(want["int8"][k], want["float32"][k])
        errs = _errors(got["int8"][k], want["int8"][k])
        print(f"{k}: port int8 vs JAX int8 {errs}; JAX int8 vs its f32 "
              f"{drift}")
        for e, d, cap in zip(errs, drift, (BF16_MAX, BF16_MEAN)):
            assert e <= min(BF16_DRIFTS * d, cap), (k, errs, drift)
    assert np.array_equal(got["int8"]["keep"], want["int8"]["keep"])


def test_int8_sample_fn_shapes_match_jax(int8_samples):
    """SDFs within twice JAX's int8 twin's drift from its f32 module.  The
    port's int8 SDFs are not closer to JAX's than its bf16 twin's are here:
    a one-ulp difference of f32 summation order in the echo GCN's one-hot
    pooling reaches the one-token cross-attention and, through 25
    per-tensor activation scales a step, becomes int8 noise of the size of
    the int8 error itself (CHANGES.md); the shape step without the echo
    pass holds that comparison (next test)."""
    want, got = int8_samples
    w8 = want["int8"]["shapes"]
    assert np.abs(w8).max() > 1e-2
    drift = _errors(w8, want["float32"]["shapes"])
    errs = _errors(got["int8"]["shapes"], w8)
    bf16 = _errors(got["bfloat16"]["shapes"], w8)
    print(f"SDFs (max of the peak, mean of the mean magnitude): port int8 vs "
          f"JAX int8 {errs}; port bf16 twin vs JAX int8 {bf16}; JAX int8 vs "
          f"its f32 {drift}")
    for e, d in zip(errs, drift):
        assert e <= INT8_DRIFTS * d, (errs, drift)


def test_int8_shape_denoiser_matches_jax():
    """The shape denoiser alone (SHAPE_DEN_KW at 64 channels without the
    echo pass, the context given; factored upsamples), JAX's int8 module
    against the port's int8 twin and its bf16 twin on the same perturbed
    weights, at t = 7 and t = 999: the int8 twin strictly closer to JAX's
    int8 output than the bf16 twin is, in both measures (a port that ran
    bf16 convolutions could not pass).  The torso is bit-equal up to the
    first SpatialTransformer; from there the packages' matrix products sum
    in other orders, and the per-tensor scales amplify the odd one-ulp
    difference."""
    import jax
    import jax.numpy as jnp
    from conftest import SHAPE_DEN_KW
    from test_torch_port_modules import _init_vars
    from echoscene_tpu.nn.unet3d import ShapeDenoiser as JShapeDenoiser
    from echoscene_torch.convert import from_jax
    from echoscene_torch.models.sgdiff import inference_twin
    from echoscene_torch.nn.unet3d import ShapeDenoiser

    # 64 channels: two a GroupNorm group, so the time embedding's shift
    # reaches the output (at 16 each group holds one channel and a
    # per-channel shift normalises away)
    kw = dict(SHAPE_DEN_KW, message_passing=False, model_channels=64)
    rng = np.random.default_rng(8)
    m = 4
    x = rng.standard_normal((m, 8, 8, 8, 3)).astype(np.float32)
    ctx = rng.standard_normal((m, 1, 32)).astype(np.float32)
    tri = np.zeros((2, 3), np.int32)
    for t_val in (7, 999):
        steps = np.full((m,), t_val, np.int32)
        args = [jnp.asarray(a) for a in (x, ctx[:, 0], tri, steps)]
        v = _init_vars(JShapeDenoiser(**kw), *args, context=jnp.asarray(ctx),
                       seed=4)
        want = np.asarray(JShapeDenoiser(
            **kw, factored_upsample=True, dtype="int8").apply(
                v, *args, context=jnp.asarray(ctx)), np.float32)
        port = ShapeDenoiser(**{k: a for k, a in kw.items()
                                if k != "use_checkpoint"})
        port.load_state_dict(from_jax.to_state_dict(
            from_jax.convert_shape_denoiser(
                jax.tree.map(np.asarray, v["params"]), None,
                channel_mult=(1, 2), num_res_blocks=1,
                attention_resolutions=(2,), message_passing=False)),
            strict=True)
        holder = torch.nn.Module()
        holder.shape_denoiser = port.eval()
        targs = [torch.from_numpy(a) for a in (x, ctx[:, 0], tri, steps)]
        got = {}
        with torch.no_grad():
            for name, int8 in (("int8", True), ("bf16", False)):
                twin = inference_twin(holder, torch.bfloat16, int8=int8)
                got[name] = twin.shape_denoiser(
                    targs[0], targs[1], targs[2].long(), targs[3].long(),
                    context=torch.from_numpy(ctx)).float().numpy()
        errs = _errors(got["int8"], want)
        bf16 = _errors(got["bf16"], want)
        print(f"t = {t_val}: port int8 vs JAX int8 {errs}, port bf16 twin vs "
              f"JAX int8 {bf16}")
        assert np.abs(want).mean() > 1e-2
        for e, b in zip(errs, bf16):
            assert e < b, (errs, bf16)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_q1_matches_plain(card, dtype):
    """Q1 on the card: int8 values and scale bit-equal to the plain
    version, channels padded with zeros."""
    from echoscene_torch.kernels import int8_conv as q

    from echoscene_torch.nn.quant import quantize_symmetric

    gen = torch.Generator(device=card).manual_seed(0)
    for shape in ((4, 224, 16, 16, 16), (3, 3, 16, 16, 16), (5, 37, 3, 5, 7),
                  (42, 1344, 16, 4, 4)):
        x = (3 * torch.randn(shape, generator=gen, device=card)).to(dtype)
        got_q, got_s = q.quantize_act(x)
        want_q, want_s = q.quantize_plain(x)
        assert torch.equal(got_s, want_s)
        assert torch.equal(got_q, want_q)
        # the plain version on the card equals the CPU's (IEEE division)
        cpu_q, cpu_s = q.quantize_plain(x.cpu())
        assert torch.equal(want_s.cpu(), cpu_s)
        assert torch.equal(want_q.cpu(), cpu_q)
        per_channel = [t.cpu() for t in quantize_symmetric(x, dims=(1, 2, 3,
                                                                    4))]
        for a, b in zip(per_channel, quantize_symmetric(x.cpu(),
                                                        dims=(1, 2, 3, 4))):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_q1_near_ties_match_plain(card):
    """Q1 on the card at f32 inputs within 8 ulps of every half-integer
    multiple of the scale (where the kernel's product and the division can
    round apart): bit-equal to the plain version."""
    from echoscene_torch.kernels import int8_conv as q

    amax = torch.tensor(3.7, device=card)
    scale = amax / torch.tensor(127.0, device=card)
    halves = torch.arange(-127, 127, dtype=torch.float32, device=card) + 0.5
    near = torch.arange(-8, 9, dtype=torch.int32, device=card)
    v = ((halves * scale).view(torch.int32)[:, None] + near).view(
        torch.float32).reshape(-1)
    v = torch.cat([v[v.abs() <= amax], amax.reshape(1)])
    x = v[: v.numel() // 7 * 7].reshape(1, 7, -1)
    x[0, 0, 0] = amax
    got = q.quantize_act(x)
    want = q.quantize_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ((2, 16, 8, 8, 224), 224, (3, 3, 3), (1, 1, 1), ((1, 1),) * 3, True),
    ((2, 16, 8, 8, 448), 448, (3, 3, 3), (1, 2, 2), ((1, 1),) * 3, True),
    ((2, 16, 4, 4, 672), 448, (1, 1, 1), (1, 1, 1), ((0, 0),) * 3, True),
    ((2, 16, 4, 4, 672), 672, (3, 2, 2), (1, 1, 1),
     ((1, 1), (1, 0), (0, 1)), False),
    ((3, 16, 16, 16, 3), 224, (3, 3, 3), (1, 1, 1), ((1, 1),) * 3, True),
    ((3, 5, 7, 9, 40), 3, (3, 3, 3), (1, 1, 1), ((1, 1),) * 3, True),
    # conv_out, the 1344 -> 672 ResBlock input, the level-0 Downsample,
    # a 1x1x1 skip, chip_smoke.py's ragged case and Int8Linear's rows
    ((2, 16, 16, 16, 224), 3, (3, 3, 3), (1, 1, 1), ((1, 1),) * 3, True),
    ((2, 16, 4, 4, 1344), 672, (3, 3, 3), (1, 1, 1), ((1, 1),) * 3, True),
    ((2, 16, 16, 16, 224), 224, (3, 3, 3), (1, 2, 2), ((1, 1),) * 3, True),
    ((2, 16, 16, 16, 672), 224, (1, 1, 1), (1, 1, 1), ((0, 0),) * 3, True),
    ((3, 5, 7, 9, 37), 19, (3, 3, 3), (1, 2, 2), ((1, 1),) * 3, True),
    ((300, 1, 1, 1, 96), 40, (1, 1, 1), (1, 1, 1), ((0, 0),) * 3, True)])
def test_cuda_q2_matches_plain(card, case):
    """Q2 on the card: bf16 output within 1 ulp of the plain version on
    every element (the int32 accumulators are exact)."""
    from echoscene_torch.kernels import int8_conv as q

    shape, k, taps, stride, pads, has_bias = case
    gen = torch.Generator(device=card).manual_seed(1)
    x = torch.randn((shape[0], shape[-1]) + shape[1:4], generator=gen,
                    device=card)
    xq, xs = q.quantize_act(x)
    w = torch.randn((k, shape[-1]) + taps, generator=gen, device=card)
    from echoscene_torch.nn.quant import quantize_weight
    wq, ws = quantize_weight(w)
    bias = torch.randn(k, generator=gen, device=card) if has_bias else None
    got = q.int8_conv3d(xq, wq, xs, ws, bias, stride, pads)
    want = q.int8_conv3d_plain(xq, wq, xs, ws, bias, stride, pads)
    torch.cuda.synchronize()
    assert int(bf16_ulps(got, want).max()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("level", [(448, (16, 8, 8)), (672, (16, 4, 4))])
@pytest.mark.parametrize("parity", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_cuda_q2_parity_into_strided_view(card, level, parity):
    """Each parity of the quantized factored upsample at both of the
    torso's levels, written by Q2 into its strided view of the 2x output
    as `nn.blocks.factored_upsample_conv` does: within 1 ulp of the plain
    version, and nothing outside the view written."""
    from echoscene_torch.kernels import int8_conv as q
    from echoscene_torch.nn.quant import quantize_weight

    c, spatial = level
    rh, rw = parity
    gen = torch.Generator(device=card).manual_seed(2)
    x = torch.randn((2, c) + spatial, generator=gen, device=card)
    xq, xs = q.quantize_act(x.to(torch.bfloat16))
    wq, ws = quantize_weight(torch.randn((c, c, 3, 2, 2), generator=gen,
                                         device=card))
    pads = ((1, 1), ((1, 0), (0, 1))[rh], ((1, 0), (0, 1))[rw])
    d, h, w = spatial
    full = torch.full((2, c, d, 2 * h, 2 * w), 7.0, dtype=torch.bfloat16,
                      device=card)
    view = full[:, :, :, rh::2, rw::2]
    q.int8_conv3d(xq, wq, xs, ws, None, (1, 1, 1), pads, out=view)
    want = q.int8_conv3d_plain(xq, wq, xs, ws, None, (1, 1, 1), pads)
    torch.cuda.synchronize()
    assert int(bf16_ulps(view, want).max()) <= 1
    rest = full.clone()
    rest[:, :, :, rh::2, rw::2] = 7.0
    assert bool((rest == 7.0).all())


@pytest.mark.cuda
def test_cuda_q2_raises_on_a_shape_it_does_not_take(card):
    """A stride past TMA's element strides raises before any launch."""
    from echoscene_torch.kernels import int8_conv as q

    xq = torch.zeros((1, 4, 20, 20, 32), dtype=torch.int8, device=card)
    wq = torch.zeros((8, 1, 1, 1, 32), dtype=torch.int8, device=card)
    one = torch.ones(1, device=card)
    q.reset_launches()
    with pytest.raises(ValueError, match="strides"):
        q.int8_conv3d(xq, wq, one, torch.ones(8, device=card), None,
                      (1, 9, 1), ((0, 0),) * 3)
    assert q.LAUNCHES["int8_conv3d"] == 0
