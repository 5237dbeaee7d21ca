"""The port's attention kernels (echoscene_torch/kernels) against the JAX ones.

On the CPU the wrappers compute their plain PyTorch versions, held here
against JAX's `_onepass_impl` / `_stream_impl` run in Pallas interpret mode
(f32, atol 2e-5, as tests/test_kernels.py holds the JAX kernels against
einsum).  The CUDA kernels themselves are held against the plain versions
by the `cuda`-marked test, which runs only where a card is present (and by
chip_smoke.py); jax is imported inside the JAX comparisons so that on the
GPU machine, which has no jax,
    python -m pytest tests/test_torch_port_kernels.py -m cuda --noconftest
runs it.
"""
import numpy as np
import pytest
import torch

from echoscene_torch.kernels import attention as port_attn
from echoscene_torch.kernels import flash_attention as port_fa

torch.set_num_threads(1)
ATOL = 2e-5


def _qkv(rng, b, l, h, d, s=None):
    s = l if s is None else s
    return (rng.normal(size=(b, l, h, d)).astype(np.float32),
            rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, s, h, d)).astype(np.float32))


def _port(fn, q, k, v):
    return fn(*(torch.from_numpy(x) for x in (q, k, v))).numpy()


@pytest.mark.parametrize("shape,q_block", [
    ((2, 64, 2, 24), 32),     # unaligned head dim (padded to 128 in JAX)
    ((1, 80, 3, 56), 16),     # the UNet site's head dim, several q blocks
])
def test_onepass_plain_matches_jax(rng, shape, q_block):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from echoscene_tpu.kernels.flash_attention import _onepass_impl

    q, k, v = _qkv(rng, *shape)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_onepass_impl(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), q_block=q_block))
    got = _port(port_fa.onepass_attention, q, k, v)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("shape,k_block", [
    ((1, 96, 2, 16), 32),     # K streamed in three blocks
    ((2, 72, 1, 20), 32),     # ragged last K block (72 = 2 * 32 + 8), odd D
    ((1, 40, 2, 200), 16),    # D = 200, padded to 256 by the card's kernel
])
def test_stream_plain_matches_jax(rng, shape, k_block):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from echoscene_tpu.kernels.flash_attention import _stream_impl

    q, k, v = _qkv(rng, *shape)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_stream_impl(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), q_block=32,
                                       k_block=k_block))
    got = _port(port_fa.stream_attention, q, k, v)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_dispatcher_matches_jax_einsum_path(rng):
    """Cross-attention and masked attention take the einsum path on every
    device; on the CPU so does a long self-attention."""
    import jax.numpy as jnp
    from echoscene_tpu.kernels.attention import _einsum_attention

    q, k, v = _qkv(rng, 2, 8, 2, 16, s=3)
    mask = rng.random((2, 1, 8, 3)) > 0.3
    mask[..., 0] = True
    for m in (None, mask):
        want = np.asarray(_einsum_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if m is None else jnp.asarray(m)))
        got = port_attn.dot_product_attention(
            *(torch.from_numpy(x) for x in (q, k, v)),
            mask=None if m is None else torch.from_numpy(m)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_cpu_tensors_never_count_launches(rng):
    port_fa.reset_launches()
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 1, 600, 1, 8))
    port_attn.dot_product_attention(q, k, v)
    port_fa.onepass_attention(q, k, v)
    port_fa.stream_attention(q, k, v)
    assert port_fa.LAUNCHES == {"onepass_attention": 0, "stream_attention": 0}


def test_dispatcher_keeps_jax_onepass_stream_split():
    """The UNet site (S = 1024, D = 56) is one-pass, the VQ-VAE site
    (S = 4096, D = 256) streams, as in flash_attention.py:148-150."""
    from echoscene_tpu.kernels.flash_attention import _kv_fits_vmem

    for s, d in ((1024, 56), (4096, 256), (256, 84), (8192, 64)):
        d_pad = -(-d // 128) * 128
        assert port_fa.kv_fits_onepass(s, d) == _kv_fits_vmem(s, d_pad)
    assert port_fa.kv_fits_onepass(1024, 56)
    assert not port_fa.kv_fits_onepass(4096, 256)


def test_kernel_tolerance_passes_rounding_and_fails_dropped_keys(rng):
    """`error_ratios`, the kernels' tolerance on the card: bf16 results that
    differ from the plain version only in where they round pass; the plain
    version with its last 32 of 512 keys left out fails."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(rng, 2, 512, 2, 56))
    ref = port_fa.attention_plain(q, k, v)
    f32_probs = port_fa.attention_plain(q.float(), k.float(), v.float())
    assert max(port_fa.error_ratios(f32_probs.to(torch.bfloat16), ref)) <= 1.0
    dropped = port_fa.attention_plain(q, k[:, :-32], v[:, :-32])
    assert min(port_fa.error_ratios(dropped, ref)) > 1.0


def test_attention_bound_at_the_main_path_shapes():
    """`attention_bound`, the least time chip_smoke.py holds K1 / K2 to: the
    UNet site is bound by its exponentials on the SFU (just above its
    tensor-core time), the VQ-VAE site by its tensor-core flops."""
    k1 = port_fa.attention_bound(42, 1024, 8, 56)
    assert (k1["flops"], k1["exps"]) == (4 * 336 * 1024 ** 2 * 56,
                                         336 * 1024 ** 2)
    assert k1["bytes"] == 2 * 4 * 42 * 1024 * 8 * 56
    assert (k1["by"], k1["bound_by"]) == ("exp2", "operations")
    assert k1["ms"] == k1["exp2_ms"] > k1["tensor_core_ms"] > k1["bytes_ms"]
    np.testing.assert_allclose(
        [k1["ms"], k1["tensor_core_ms"]],
        [336 * 1024 ** 2 / (132 * 16 * 1.98e9) * 1e3,
         4 * 336 * 1024 ** 2 * 56 / 989e12 * 1e3], rtol=1e-12)
    np.testing.assert_allclose(k1["ms"], 0.0842520, rtol=1e-6)
    k2 = port_fa.attention_bound(8, 4096, 1, 256)
    assert (k2["by"], k2["bound_by"]) == ("tensor_core", "operations")
    np.testing.assert_allclose(k2["ms"], 4 * 8 * 4096 ** 2 * 256 / 989e12 * 1e3,
                               rtol=1e-12)
    assert k2["exp2_ms"] < k2["ms"] / 4
    # at a lower SM clock the exponentials take longer, the products do not
    slow = port_fa.attention_bound(42, 1024, 8, 56, sm_clock_hz=1.5e9)
    assert slow["exp2_ms"] > k1["exp2_ms"]
    assert slow["tensor_core_ms"] == k1["tensor_core_ms"]


@pytest.mark.cuda
@pytest.mark.parametrize("entry,shape", [
    ("onepass_attention", (4, 1024, 8, 56)),    # 256 work tiles: 2 waves
    ("onepass_attention", (3, 200, 2, 24)),
    ("onepass_attention", (3, 333, 8, 56)),     # L, S not multiples of 128
    ("stream_attention", (2, 4096, 1, 256)),
    ("stream_attention", (2, 77, 3, 200)),      # ragged L, S; D padded to 256
    ("stream_attention", (9, 2048, 2, 128)),    # 288 work tiles, D_pad 128
])
def test_cuda_kernel_matches_plain(entry, shape):
    """bf16 kernel vs the f32-accumulated plain version, within
    `error_ratios`: max abs err <= 2^-6 of the plain output's peak, mean abs
    err <= 1e-2 of its mean magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(3))
    before = port_fa.LAUNCHES[entry]
    out = getattr(port_fa, entry)(q, k, v)
    torch.cuda.synchronize()
    assert port_fa.LAUNCHES[entry] == before + 1
    ref = port_fa.attention_plain(q, k, v)
    assert max(port_fa.error_ratios(out, ref)) <= 1.0
    with pytest.raises(TypeError):
        getattr(port_fa, entry)(q.half(), k.half(), v.half())


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["onepass_attention", "stream_attention"])
def test_cuda_attention_raises_on_inputs_it_does_not_take(entry):
    """No fallback: a CUDA tensor the kernel cannot take raises, and no
    launch is counted.  D % 8 != 0 (TMA needs 16-byte row strides), D > 256,
    f16, non-contiguous, no keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fn = getattr(port_fa, entry)

    def qkv(shape, dtype=torch.bfloat16):
        return [torch.randn(shape, device="cuda").to(dtype) for _ in range(3)]

    port_fa.reset_launches()
    with pytest.raises(ValueError):
        fn(*qkv((2, 77, 3, 130)))
    with pytest.raises(ValueError):
        fn(*qkv((1, 64, 1, 84)))
    with pytest.raises(ValueError):
        fn(*qkv((1, 64, 1, 264)))
    with pytest.raises(TypeError):
        fn(*qkv((1, 64, 1, 64), torch.float16))
    q, k, v = qkv((1, 64, 2, 64))
    with pytest.raises(ValueError):
        fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    with pytest.raises(ValueError):
        fn(q, k[:, :0], v[:, :0])
    with pytest.raises(ValueError):
        fn(q, k.cpu(), v)
    assert port_fa.LAUNCHES == {"onepass_attention": 0, "stream_attention": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("entry,shape", [
    ("onepass_attention", (2, 333, 8, 56)),
    ("onepass_attention", (8, 1024, 8, 56)),    # the training step's K1
    ("stream_attention", (2, 77, 3, 200)),
    ("stream_attention", (8, 4096, 1, 256)),    # the VQ encoder's K2
])
def test_cuda_kernel_gradients_match_plain_autograd(entry, shape):
    """The kernel's output carries the differentiable Function; its dq, dk,
    dv (the plain version recomputed and differentiated) equal plain
    autograd's from the same inputs and upstream gradient, and the backward
    launches no kernel.  An f16 input raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(4))
    fn = getattr(port_fa, entry)
    port_fa.reset_launches()
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = fn(*leaves)
    assert type(out.grad_fn).__name__ == "KernelAttentionBackward"
    got = torch.autograd.grad(out, leaves, g)
    assert port_fa.LAUNCHES[entry] == 1
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(port_fa.attention_plain(*plain), plain, g)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert ((a.float() - b.float()).abs().max()
                <= 1e-6 * b.float().abs().max())
    with torch.no_grad():
        assert fn(q, k, v).grad_fn is None
    with pytest.raises(TypeError):
        fn(*(x.half().requires_grad_(True) for x in (q, k, v)))


@pytest.mark.cuda
def test_cuda_dispatcher_routes_long_self_attention_to_kernels():
    """Self-attention at >= 512 tokens launches a kernel, the bf16 one for
    bf16 and the f32 one for f32, and raises on f16 (no kernel takes it);
    256-token sites take the einsum math."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((2, 1024, 8, 56), generator=gen, device="cuda")
               for _ in range(3))
    port_fa.reset_launches()
    with pytest.raises(TypeError):
        port_attn.dot_product_attention(q.half(), k.half(), v.half())
    short = [x[:, :256].to(torch.bfloat16) for x in (q, k, v)]
    out = port_attn.dot_product_attention(*short)
    assert port_fa.LAUNCHES == {"onepass_attention": 0, "stream_attention": 0}
    assert torch.equal(out, port_fa.attention_plain(*short))
    port_attn.dot_product_attention(*(x.to(torch.bfloat16) for x in (q, k, v)))
    assert port_fa.LAUNCHES["onepass_attention"] == 1
    out = port_attn.dot_product_attention(q, k, v)
    assert out.dtype == torch.float32
    assert port_fa.LAUNCHES["onepass_attention"] == 2
    assert port_fa.LAUNCHES_BY_DTYPE == {("onepass_attention", "bfloat16"): 1,
                                         ("onepass_attention", "float32"): 1}
    assert max(port_fa.error_ratios(out, port_fa.attention_plain(q, k, v))
               ) <= 1.0


def test_attention_bound_f32():
    """`attention_bound` for f32 inputs: the products as f32 FMAs at 67
    TFLOP/s (the kernel uses no tensor cores), 4-byte elements; at both
    path shapes the FMAs bound it."""
    for shape in ((42, 1024, 8, 56), (8, 4096, 1, 256)):
        b, l, h, d = shape
        f32 = port_fa.attention_bound(*shape, dtype=torch.float32)
        bf16 = port_fa.attention_bound(*shape)
        assert (f32["by"], f32["bound_by"]) == ("fma", "operations")
        assert "tensor_core_ms" not in f32
        np.testing.assert_allclose(
            f32["ms"], 4 * b * h * l * l * d / 67e12 * 1e3, rtol=1e-12)
        assert f32["bytes"] == 2 * bf16["bytes"] == 4 * 4 * b * l * h * d
        assert f32["exp2_ms"] == bf16["exp2_ms"]
    np.testing.assert_allclose(
        port_fa.attention_bound(42, 1024, 8, 56, dtype=torch.float32)["ms"],
        1.17791, rtol=1e-5)


def test_kernel_tolerance_f32_passes_rounding_and_fails_dropped_keys(rng):
    """`error_ratios` on f32 outputs (max err <= 2^-14 of the peak, mean err
    <= 1e-5 of the mean magnitude): the f64 result rounded to f32 passes,
    the plain version with its last 32 of 1024 keys left out fails both."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 2, 1024, 2, 56))
    ref = port_fa.attention_plain(q, k, v)
    f64 = port_fa.attention_plain(q.double(), k.double(), v.double())
    assert max(port_fa.error_ratios(f64.float(), ref)) <= 1.0
    dropped = port_fa.attention_plain(q, k[:, :-32], v[:, :-32])
    assert min(port_fa.error_ratios(dropped, ref)) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("entry,shape", [
    ("onepass_attention", (42, 1024, 8, 56)),   # the UNet site, 42 rows
    ("onepass_attention", (3, 200, 2, 24)),
    ("onepass_attention", (3, 333, 8, 56)),     # L, S not multiples of 64
    ("stream_attention", (8, 4096, 1, 256)),    # the VQ-VAE site
    ("stream_attention", (2, 77, 3, 200)),      # ragged L, S; D_pad 256
    ("stream_attention", (9, 2048, 2, 128)),
])
def test_cuda_f32_kernel_matches_plain(entry, shape):
    """The f32 kernel vs the plain version in f32, within `error_ratios`'
    f32 limits (max abs err <= 2^-14 of the peak, mean <= 1e-5 of the mean
    magnitude); one launch, counted as f32; f32 output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for _ in range(3))
    port_fa.reset_launches()
    out = getattr(port_fa, entry)(q, k, v)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    assert port_fa.LAUNCHES[entry] == 1
    assert port_fa.LAUNCHES_BY_DTYPE == {(entry, "float32"): 1}
    assert max(port_fa.error_ratios(out, port_fa.attention_plain(q, k, v))
               ) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["onepass_attention", "stream_attention"])
def test_cuda_attention_raises_on_a_dtype_mix(entry):
    """q, k, v of two dtypes raise before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = (torch.randn((1, 64, 2, 64), device="cuda") for _ in range(3))
    port_fa.reset_launches()
    fn = getattr(port_fa, entry)
    for mix in ((q, k.bfloat16(), v), (q.bfloat16(), k.bfloat16(), v)):
        with pytest.raises(TypeError):
            fn(*mix)
    assert port_fa.LAUNCHES == {"onepass_attention": 0, "stream_attention": 0}
    assert port_fa.LAUNCHES_BY_DTYPE == {}


@pytest.mark.cuda
def test_cuda_gcn_pooling_is_bit_reproducible():
    """Two calls of a GCN on the card give the same bits: the one-hot
    product adds in a fixed order (an atomic scatter would not)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from echoscene_torch.nn.gcn import GraphTripleConvNet, scatter_sum

    g = torch.Generator(device="cuda").manual_seed(4)
    n, t, d = 48, 160, 64
    net = GraphTripleConvNet(d, d, num_layers=5, hidden_dim=128,
                             pooling="avg").cuda()
    obj = torch.randn((n, d), generator=g, device="cuda")
    pred = torch.randn((t, d), generator=g, device="cuda")
    edges = torch.randint(0, n, (t, 2), generator=g, device="cuda")
    mask = (torch.arange(t, device="cuda") < 130).float()
    outs = [net(obj, pred, edges, None, mask) for _ in range(2)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    vals = torch.randn((t, 512), generator=g, device="cuda")
    sums = [scatter_sum(vals, edges[:, 0], mask, n) for _ in range(2)]
    assert torch.equal(*sums)


# --- K4: one-way nearest-neighbour distance (chamfer) ----------------------
NN_SHAPES = [(2, 100, 75), (1, 513, 9), (3, 37, 600)]


def _clouds(rng, b, n, m):
    return (rng.normal(size=(b, n, 3)).astype(np.float32),
            rng.normal(size=(b, m, 3)).astype(np.float32))


@pytest.mark.parametrize("b,n,m", NN_SHAPES)
def test_nn_distance_plain_matches_jax_pallas(rng, b, n, m):
    """The plain version (and the CPU wrapper) against JAX's `_nn_kernel` in
    interpret mode, on ragged N and M (rtol 1e-4, atol 1e-5, as
    tests/test_kernels.py:51)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from echoscene_tpu.kernels.chamfer_pallas import nn_distance_oneway

    from echoscene_torch.kernels import chamfer as port_k4
    a, t = _clouds(rng, b, n, m)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(nn_distance_oneway(jnp.asarray(a), jnp.asarray(t)))
    got = port_k4.nn_distance_oneway(torch.from_numpy(a), torch.from_numpy(t))
    assert got.shape == want.shape == (b, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(
        got.numpy(), port_k4.nn_distance_plain(torch.from_numpy(a),
                                               torch.from_numpy(t)).numpy())


@pytest.mark.parametrize("b,n,m", NN_SHAPES)
def test_chamfer_plain_matches_jax_pallas(rng, b, n, m):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from echoscene_tpu.kernels.chamfer_pallas import chamfer_pallas

    from echoscene_torch.kernels import chamfer as port_k4
    a, t = _clouds(rng, b, n, m)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(chamfer_pallas(jnp.asarray(a), jnp.asarray(t)))
    port_k4.reset_launches()
    got = port_k4.chamfer(torch.from_numpy(a), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert port_k4.LAUNCHES == {"nn_distance": 0}
    assert port_k4.LAUNCH_SHAPES == {}


def test_nn_distance_tolerance_rejects_dropped_targets():
    """`chamfer.error_ratios`, K4's tolerance on the card: f32 rounding of
    the float64 result passes; the plain version with its last 64 of 1001
    targets left out fails both limits, on surface-like clouds."""
    from echoscene_torch.kernels import chamfer as port_k4
    r = np.random.default_rng(5)
    dirs = r.normal(size=(2, 1777, 3))
    pts = 0.4 * dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    a = torch.from_numpy(pts[:, :777].astype(np.float32))
    t = torch.from_numpy(pts[:, 777:].astype(np.float32))
    ref = port_k4.nn_distance_plain(a.double(), t.double())
    assert max(port_k4.error_ratios(ref.float(), ref, a, t)) <= 1.0
    dropped = port_k4.nn_distance_plain(a.double(), t[:, :-64].double())
    assert min(port_k4.error_ratios(dropped, ref, a, t)) > 1.0


# B = 1, M below one chunk unit, the path shapes, N and M that are not
# multiples of 16 and 8, a large batch
PLAN_SHAPES = [(1, 1, 1), (1, 5000, 5000), (8, 5000, 5000), (16, 5000, 5000),
               (2, 5000, 5000), (3, 777, 1001), (1, 513, 9), (2, 100, 37),
               (4, 785, 561), (1, 17, 100_000), (600, 300, 300),
               (65535, 20, 40)]


def _plan_segments(p, b, m, unit):
    """The (cta, row, first target, end) segments the kernel walks for plan
    `p` (csrc/chamfer.cu, nn_kernel's loop)."""
    total = p.query_tiles * b * p.units_row
    segs = []
    for c in range(p.ctas):
        u, end = c * total // p.ctas, (c + 1) * total // p.ctas
        while u < end:
            row = u // p.units_row
            u0, u1 = u - row * p.units_row, min(p.units_row,
                                                end - row * p.units_row)
            u = row * p.units_row + u1
            if u0 * unit < min(m, u1 * unit):
                segs.append((c, row, u0 * unit, min(m, u1 * unit)))
    return segs


@pytest.mark.parametrize("b,n,m", PLAN_SHAPES)
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("ctas_per_sm", [3, 4])
def test_nn_distance_launch_plan(b, n, m, sms, ctas_per_sm):
    """`launch_plan`, the kernel's grid: every row (batch entry, query tile)
    has its targets [0, M) covered exactly once, `atomic` exactly when a
    row is shared by CTAs, every grid dimension within CUDA's limits, all
    CTAs that fit on the card (3 of the kernel fit on an H100 SM) unless
    every CTA has one chunk unit, and every CTA the same number of units,
    within one."""
    from echoscene_torch.kernels import chamfer as port_k4
    unit = port_k4.CHUNK_UNIT
    p = port_k4.launch_plan(b, n, m, sms, ctas_per_sm)
    assert (p.query_tiles - 1) * port_k4.BLOCK_N < n <= (p.query_tiles
                                                         * port_k4.BLOCK_N)
    assert p.units_row * unit >= m
    assert 1 <= p.ctas < 2 ** 31 and b <= 65535
    total = p.query_tiles * b * p.units_row
    assert p.ctas == ctas_per_sm * sms or p.ctas == total < ctas_per_sm * sms
    segs = _plan_segments(p, b, m, unit)
    by_row = {}
    for c, row, lo, hi in segs:
        by_row.setdefault(row, []).append((lo, hi, c))
    assert sorted(by_row) == list(range(p.query_tiles * b))
    shared = False
    for ranges in by_row.values():
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == m
        assert all(r[1] == s[0] for r, s in zip(ranges, ranges[1:]))
        shared |= len({c for _, _, c in ranges}) > 1
    assert p.atomic == shared
    work = [0] * p.ctas
    for c, _, lo, hi in segs:
        work[c] += -(-(hi - lo) // unit)
    assert max(work) - min(work) <= 1 + len(segs) / p.ctas


def test_nn_distance_bound_at_the_path_shapes():
    """`nn_distance_bound`: 8 flops a pair on the f64 tensor cores at
    67 TFLOP/s bound every path shape, far above the bytes."""
    from echoscene_torch.kernels import chamfer as port_k4
    for (b, want) in ((16, 0.0478), (8, 0.0239), (1, 0.0030)):
        bound = port_k4.nn_distance_bound(b, 5000, 5000)
        assert bound["bound_by"] == "operations"
        assert bound["ms"] == bound["tensor_core_ms"] > 10 * bound["bytes_ms"]
        assert round(bound["ms"], 4) == want
        np.testing.assert_allclose(bound["ms"],
                                   8 * b * 5000 ** 2 / 67e12 * 1e3, rtol=1e-12)


def _surface(rng, b, n, centre, radius=0.4):
    dirs = rng.normal(size=(b, n, 3))
    pts = centre + radius * dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    return torch.from_numpy(pts.astype(np.float32))


def _kernel_arithmetic(a, b):
    """csrc/chamfer.cu's arithmetic on the CPU: both clouds moved to the f32
    mean of 32 spread targets, the f64 Gram form |a'|^2 + |b'|^2 - 2 a'.b',
    its min by magnitude, truncated to f32 (0 below the smallest normal)."""
    m = b.shape[1]
    idx = torch.arange(32) * m // 32
    c = b[:, idx].double().sum(1, keepdim=True).div(32).float().double()
    a64, b64 = a.double() - c, b.double() - c
    d = ((a64 * a64).sum(-1)[:, :, None] + (b64 * b64).sum(-1)[:, None, :]
         - 2.0 * torch.einsum("bnd,bmd->bnm", a64, b64))
    bits = d.abs().amin(2).numpy().view(np.uint64) & ~np.uint64(2 ** 29 - 1)
    out = bits.view(np.float64).astype(np.float32)
    return torch.from_numpy(np.where(out < 2.0 ** -126, 0.0, out)
                            .astype(np.float32))


@pytest.mark.parametrize("centre", [0.0, 10.0])
def test_nn_distance_ulp_distance(centre):
    """`ulp_distance`, the <= 1 ulp check of the kernel: the float64
    reference rounded to f32 is 0 ulp from itself, the kernel's f64 Gram
    arithmetic within 1 ulp, and the f32 Gram form (JAX's arithmetic, the
    plain version in f32) many ulps off on surface clouds centred at
    (10, 10, 10)."""
    from echoscene_torch.kernels import chamfer as port_k4
    r = np.random.default_rng(11)
    a = _surface(r, 2, 700, centre)
    b = _surface(r, 2, 900, centre)
    ref = port_k4.nn_distance_f64(a, b)
    floor = port_k4.ulp_floor(a, b)
    assert 0.0 < floor < 1e-13
    assert port_k4.ulp_distance(ref.float(), ref) == 0.0
    nxt = torch.nextafter(ref.float(), torch.tensor(1.0))
    assert port_k4.ulp_distance(nxt, ref) == 1.0
    assert port_k4.ulp_distance(_kernel_arithmetic(a, b), ref, floor) <= 1.0
    np.testing.assert_allclose(
        ref.numpy(), port_k4.nn_distance_plain(a.double(), b.double()).numpy(),
        rtol=1e-9, atol=1e-12)
    gram32 = port_k4.ulp_distance(port_k4.nn_distance_plain(a, b), ref, floor)
    if centre:
        assert gram32 > 1e3
    # identical clouds: every exact distance is 0, the f64 form's rounding
    # stays under the floor
    same = _kernel_arithmetic(a, a)
    assert port_k4.ulp_distance(same, torch.zeros_like(ref),
                                port_k4.ulp_floor(a, a)) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m,centre", [(*s, 0.0) for s in NN_SHAPES] + [
    (16, 5000, 5000, 0.0), (8, 5000, 5000, 0.0), (1, 5000, 5000, 0.0),
    (3, 785, 561, 0.0),          # N = 1 (mod 16), M = 1 (mod 8)
    (2, 785, 561, 10.0), (8, 5000, 5000, 10.0)])
def test_cuda_nn_distance_matches_plain_f64(b, n, m, centre):
    """K4 against `nn_distance_plain` in float64 within `error_ratios`:
    max abs err <= 1e-6 (max|a|^2 + max|b|^2) per point, each mean
    distance within 1e-5 relative; and within 1 ulp of `nn_distance_f64`
    rounded to f32 (`ulp_distance`, floor `ulp_floor`); one launch per
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from echoscene_torch.kernels import chamfer as port_k4
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((b, n, 3), generator=gen, device="cuda") + centre
    t = torch.randn((b, m, 3), generator=gen, device="cuda") + centre
    before = port_k4.LAUNCHES["nn_distance"]
    at_shape = port_k4.LAUNCH_SHAPES.get((b, n, m), 0)
    out = port_k4.nn_distance_oneway(a, t)
    torch.cuda.synchronize()
    assert port_k4.LAUNCHES["nn_distance"] == before + 1
    assert port_k4.LAUNCH_SHAPES[(b, n, m)] == at_shape + 1
    ref = port_k4.nn_distance_plain(a.double(), t.double())
    assert max(port_k4.error_ratios(out, ref, a, t)) <= 1.0
    assert port_k4.ulp_distance(out, port_k4.nn_distance_f64(a, t),
                                port_k4.ulp_floor(a, t)) <= 1.0


@pytest.mark.cuda
def test_cuda_nn_distance_fragment_layout():
    """The f64 mma fragment layouts on the card: one query against 8
    targets at distinct, known squared distances, with the nearest target in
    each of the 8 columns of an mma tile (one batch entry each); then
    queries at every row of a CTA's tile (and past it), each with its own
    nearest target at a known offset, the targets in shuffled order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from echoscene_torch.kernels import chamfer as port_k4
    # offsets in quarter units: squared distances (i^2 + j^2 + k^2) / 16
    offs = torch.tensor([[1, 0, 0], [0, 2, 0], [0, 0, 3], [1, 1, 2],
                         [2, 1, 3], [3, 3, 1], [4, 0, 1], [2, 4, 4]],
                        dtype=torch.float32) / 4
    dist = (offs ** 2).sum(-1)
    assert len(set(dist.tolist())) == 8
    q = torch.tensor([0.75, -1.5, 2.25])
    a = q.expand(8, 1, 3).contiguous()
    t = torch.empty(8, 8, 3)
    for col in range(8):                 # nearest target in column `col`
        order = torch.roll(torch.arange(8), col)
        t[col] = q + offs[order]
    out = port_k4.nn_distance_oneway(a.cuda(), t.cuda()).cpu()
    assert torch.equal(out[:, 0], torch.full((8,), float(dist.min())))
    # every query row of two CTA tiles and a ragged third; query i sits at
    # (4 i, 0, 0) (far from the others) and its nearest target at a known
    # offset, the targets shuffled so each lands in another column
    n = 2 * port_k4.BLOCK_N + 37
    r = np.random.default_rng(2)
    pick = torch.from_numpy(r.integers(0, 8, n))
    qa = torch.zeros(n, 3)
    qa[:, 0] = 4.0 * torch.arange(n)
    perm = torch.from_numpy(r.permutation(n))
    tb = (qa + offs[pick])[perm]
    out = port_k4.nn_distance_oneway(qa[None].cuda(), tb[None].cuda()).cpu()
    want = dist[pick][None]
    assert port_k4.ulp_distance(out, want.double()) <= 1.0


@pytest.mark.cuda
def test_cuda_nn_distance_raises_on_inputs_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from echoscene_torch.kernels import chamfer as port_k4
    a = torch.randn((2, 10, 3), device="cuda")
    port_k4.reset_launches()
    bad = [(a.double(), a.double(), TypeError),
           (a, a.cpu(), ValueError),
           (a, a[:, :0], ValueError),
           (a, torch.randn((2, 10, 4), device="cuda"), ValueError),
           (a.transpose(0, 1), a.transpose(0, 1), ValueError)]
    for x, y, err in bad:
        with pytest.raises(err):
            port_k4.nn_distance_oneway(x, y)
    assert port_k4.LAUNCHES == {"nn_distance": 0}
    assert port_k4.LAUNCH_SHAPES == {}
    # the C entry rejects a plan (cudaErrorInvalidValue) whose shares split
    # a row without the atomic, or whose tiles do not cover N
    fn, _ = port_k4._kernel()
    out = torch.empty((2, 10), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    b = torch.randn((2, 1000, 3), device="cuda")
    units = -(-1000 // port_k4.CHUNK_UNIT)
    for tiles, ctas, atomic in ((1, 3, 0), (1, 2 * units - 1, 0), (2, 2, 0)):
        assert fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), 2, 10, 1000,
                  tiles, units, ctas, atomic, stream) == 1
    assert fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), 2, 10, 1000, 1,
              units, 3, 1, stream) == 0
    torch.cuda.synchronize()
    ref = port_k4.nn_distance_plain(a.double(), b.double())
    assert max(port_k4.error_ratios(out, ref, a, b)) <= 1.0
