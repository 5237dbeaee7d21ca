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


@pytest.mark.cuda
@pytest.mark.parametrize("entry,shape", [
    ("onepass_attention", (4, 1024, 8, 56)),
    ("onepass_attention", (3, 200, 2, 24)),
    ("stream_attention", (2, 4096, 1, 256)),
    ("stream_attention", (2, 77, 3, 130)),
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
        getattr(port_fa, entry)(q.float(), k.float(), v.float())


@pytest.mark.cuda
def test_cuda_dispatcher_routes_long_self_attention_to_kernels():
    """Self-attention at >= 512 tokens launches a kernel, and raises on f32
    (the kernels take bf16); 256-token sites take the einsum math."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((2, 1024, 8, 56), generator=gen, device="cuda")
               for _ in range(3))
    port_fa.reset_launches()
    with pytest.raises(TypeError):
        port_attn.dot_product_attention(q, k, v)
    short = [x[:, :256].to(torch.bfloat16) for x in (q, k, v)]
    out = port_attn.dot_product_attention(*short)
    assert port_fa.LAUNCHES == {"onepass_attention": 0, "stream_attention": 0}
    assert torch.equal(out, port_fa.attention_plain(*short))
    port_attn.dot_product_attention(*(x.to(torch.bfloat16) for x in (q, k, v)))
    assert port_fa.LAUNCHES["onepass_attention"] == 1


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


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", NN_SHAPES + [(16, 5000, 5000)])
def test_cuda_nn_distance_matches_plain_f64(b, n, m):
    """K4 against `nn_distance_plain` in float64 within `error_ratios`:
    max abs err <= 1e-6 (max|a|^2 + max|b|^2) per point, each mean
    distance within 1e-5 relative; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from echoscene_torch.kernels import chamfer as port_k4
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((b, n, 3), generator=gen, device="cuda")
    t = torch.randn((b, m, 3), generator=gen, device="cuda")
    before = port_k4.LAUNCHES["nn_distance"]
    out = port_k4.nn_distance_oneway(a, t)
    torch.cuda.synchronize()
    assert port_k4.LAUNCHES["nn_distance"] == before + 1
    ref = port_k4.nn_distance_plain(a.double(), t.double())
    assert max(port_k4.error_ratios(out, ref, a, t)) <= 1.0


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
