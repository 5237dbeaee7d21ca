"""The bf16 attention backward (K1 / K2 training) against JAX's `_fa_bwd`.

The port's backward is the hand-written kernel of
echoscene_torch/csrc/flash_attention_bwd.cu; its plain version,
`attention_backward_plain`, runs the kernel's algorithm in plain PyTorch
(P recomputed from the forward's log-sum-exp, delta = rowsum(dO * O), P and
dS rounded to the input dtype as the operands of their products).  Here it
is held against `jax.vjp(_einsum_reference)`, the backward of JAX's
`_fa_bwd`: in f32 within atol 1e-5, in bf16 within the bf16 limits of
`flash_attention.error_ratios`, which the same backward with its last 32
keys left out fails.  The tests also drive `KernelAttention`'s wiring with
the plain versions standing in for the kernels.  The kernel itself is held
to the same limits on the card by the `cuda` tests of
tests/test_torch_port_kernels.py and by chip_smoke.py.
"""
import types

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from echoscene_torch.kernels import flash_attention as port_fa

torch.set_num_threads(1)
# (B, L, H, D) and S: L != S, head dims 24, 56 and 200 (D_pad 64 and 256)
SHAPES = [((2, 64, 2, 24), 80), ((1, 80, 3, 56), 48), ((2, 72, 1, 200), 104)]


def _inputs(shape, s, seed=0):
    b, l, h, d = shape
    r = np.random.default_rng(seed)
    return [r.normal(size=x).astype(np.float32)
            for x in ((b, l, h, d), (b, s, h, d), (b, s, h, d), (b, l, h, d))]


def _torch(xs, dtype):
    return [torch.from_numpy(x).to(dtype) for x in xs]


def _jax_grads(q, k, v, g, dtype):
    """JAX's `_fa_bwd`: jax.vjp of `_einsum_reference`, in `dtype`."""
    import jax
    import jax.numpy as jnp

    from echoscene_tpu.kernels.flash_attention import _einsum_reference

    args = [jnp.asarray(x.float().numpy(), dtype) for x in (q, k, v)]
    _, vjp = jax.vjp(_einsum_reference, *args)
    return [torch.from_numpy(np.asarray(x, np.float32))
            for x in vjp(jnp.asarray(g.float().numpy(), dtype))]


def _plain_backward(q, k, v, g):
    o, lse = port_fa.attention_plain_lse(q, k, v)
    return port_fa.attention_backward_plain(q, k, v, o, lse, g)


@pytest.mark.parametrize("shape,s", SHAPES)
def test_backward_plain_matches_jax_vjp_f32(shape, s):
    q, k, v, g = _torch(_inputs(shape, s), torch.float32)
    got = _plain_backward(q, k, v, g)
    for x, y in zip(got, _jax_grads(q, k, v, g, "float32")):
        assert x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5)


@pytest.mark.parametrize("shape,s", SHAPES)
def test_backward_plain_bf16_meets_limits_and_dropped_keys_fail(shape, s):
    q, k, v, g = _torch(_inputs(shape, s, seed=1), torch.bfloat16)
    want = _jax_grads(q, k, v, g, "bfloat16")
    got = _plain_backward(q, k, v, g)
    for x, y in zip(got, want):
        assert x.dtype == torch.bfloat16
        assert max(port_fa.error_ratios(x, y)) <= 1.0
    # the same backward with the last 32 keys left out: each limit alone
    # fails on dq, and on the kept rows of dk and dv
    dropped = _plain_backward(q, k[:, :-32], v[:, :-32], g)
    kept = [want[0], want[1][:, :-32], want[2][:, :-32]]
    ratios = [port_fa.error_ratios(x, y) for x, y in zip(dropped, kept)]
    assert min(ratios[0]) > 1.0
    assert max(r[0] for r in ratios[1:]) > 1.0
    assert max(r[1] for r in ratios[1:]) > 1.0


@pytest.mark.parametrize("shape,s", SHAPES)
def test_backward_plain_bf16_error_against_float64(shape, s):
    """Against float64 from the same bf16 values, the plain backward's
    root-mean-square error is within 1.5x plain autograd's through
    `attention_plain`: rounding dS to bf16 (the operand of the tensor-core
    products, where autograd keeps it f32) costs little.  The max error, the
    statistic chip_smoke.py holds the kernel to at the path's shapes (<= 2x
    plain autograd's), is noisy at these few keys (up to 2.3x over seeds at
    the first shape, against <= 1.6x at (2, 77, 3, 200) and (2, 333, 8,
    56)), so the root-mean-square is the measure here."""
    q, k, v, g = _torch(_inputs(shape, s, seed=2), torch.bfloat16)
    exact = port_fa.attention_grads_float64(q, k, v, g)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    auto = torch.autograd.grad(port_fa.attention_plain(*leaves), leaves, g)
    for x, a, e in zip(_plain_backward(q, k, v, g), auto, exact):
        err = (x.double() - e).pow(2).mean().sqrt().item()
        assert err <= 1.5 * (a.double() - e).pow(2).mean().sqrt().item()


@pytest.mark.parametrize("shape,s", SHAPES)
def test_plain_lse_matches_jax_logsumexp(shape, s):
    import jax
    import jax.numpy as jnp

    q, k, v, _ = _inputs(shape, s)
    scores = jnp.einsum("blhd,bshd->bhls", q, k) * shape[-1] ** -0.5
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1)) * np.log2(np.e)
    o, lse = port_fa.attention_plain_lse(*_torch((q, k, v), torch.float32))
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)
    assert torch.equal(o, port_fa.attention_plain(
        *_torch((q, k, v), torch.float32)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_function_with_plain_stand_ins_equals_backward_plain(dtype):
    """`KernelAttention` with the lse-writing forward and the backward:
    its gradients are `attention_backward_plain`'s bit for bit."""
    q, k, v, g = _torch(_inputs((2, 64, 2, 24), 80), dtype)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = port_fa.KernelAttention.apply(
        port_fa.attention_plain_lse, *leaves,
        port_fa.attention_backward_plain)
    assert type(out.grad_fn).__name__ == "KernelAttentionBackward"
    assert torch.equal(out, port_fa.attention_plain(q, k, v))
    got = torch.autograd.grad(out, leaves, g)
    for x, y in zip(got, _plain_backward(q, k, v, g)):
        assert x.dtype == dtype and torch.equal(x, y)


def test_function_returns_none_for_inputs_without_grad():
    q, k, v, g = _torch(_inputs((1, 80, 3, 56), 48), torch.bfloat16)
    o, lse = port_fa.attention_plain_lse(q, k, v)
    want = port_fa.attention_backward_plain(q, k, v, o, lse, g)
    for needs in ((True, False, False), (False, True, True),
                  (True, False, True)):
        ctx = types.SimpleNamespace(
            bwd=port_fa.attention_backward_plain,
            saved_tensors=(q, k, v, o, lse),
            needs_input_grad=(False, *needs, False))
        grads = port_fa.KernelAttention.backward(ctx, g)
        assert len(grads) == 5 and grads[0] is None and grads[4] is None
        for x, y, need in zip(grads[1:4], want, needs):
            assert (x is None) if not need else torch.equal(x, y)
    # through autograd, only q recording
    qq = q.clone().requires_grad_(True)
    (gq,) = torch.autograd.grad(port_fa.KernelAttention.apply(
        port_fa.attention_plain_lse, qq, k, v,
        port_fa.attention_backward_plain), [qq], g)
    assert torch.equal(gq, want[0])


def test_no_function_and_no_lse_under_no_grad():
    calls = []

    def fwd_lse(q, k, v):
        calls.append("lse")
        return port_fa.attention_plain_lse(q, k, v)

    q, k, v, _ = _torch(_inputs((2, 64, 2, 24), 80), torch.bfloat16)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    with torch.no_grad():
        out = port_fa._differentiable(port_fa.attention_plain, *leaves,
                                      fwd_lse, port_fa.attention_backward_plain)
    assert out.grad_fn is None and calls == []
    out = port_fa._differentiable(port_fa.attention_plain, q, k, v, fwd_lse,
                                  port_fa.attention_backward_plain)
    assert out.grad_fn is None and calls == []


@pytest.mark.parametrize("dtype,backward_calls", [(torch.bfloat16, 1),
                                                  (torch.float32, 0)])
def test_route_bf16_backward_kernel_f32_plain_recompute(monkeypatch, dtype,
                                                        backward_calls):
    """The wrappers' route on CUDA, with the plain versions standing in for
    the kernels: bf16 goes through the lse-writing forward and the backward
    kernel; f32 keeps the plain recompute."""
    calls = []

    def launch(entry, q, k, v, lse=False):
        calls.append(("fwd", entry, lse))
        return (port_fa.attention_plain_lse(q, k, v) if lse
                else port_fa.attention_plain(q, k, v))

    def backward(entry, *args):
        calls.append(("bwd", entry))
        return port_fa.attention_backward_plain(*args)

    monkeypatch.setattr(port_fa, "_launch", launch)
    monkeypatch.setattr(port_fa, "attention_backward", backward)
    q, k, v, g = _torch(_inputs((1, 80, 3, 56), 48), dtype)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = port_fa._kernel_attention("stream_attention", *leaves)
    got = torch.autograd.grad(out, leaves, g)
    bf16 = dtype == torch.bfloat16
    assert calls == [("fwd", "stream_attention", bf16)] + [
        ("bwd", "stream_attention")] * backward_calls
    if bf16:
        want = _plain_backward(q, k, v, g)
    else:
        plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
        want = torch.autograd.grad(port_fa.attention_plain(*plain), plain, g)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    calls.clear()
    with torch.no_grad():
        port_fa._kernel_attention("stream_attention", q, k, v)
    assert calls == [("fwd", "stream_attention", False)]


def test_function_under_non_reentrant_checkpoint():
    """Under non-reentrant remat the recompute saves the same tensors
    (q, k, v, o, lse): the gradients equal those without remat."""
    q, k, v, g = _torch(_inputs((2, 72, 1, 200), 104), torch.bfloat16)

    def block(q, k, v):
        out = port_fa.KernelAttention.apply(
            port_fa.attention_plain_lse, q, k, v,
            port_fa.attention_backward_plain)
        return out.float().tanh()

    a = [x.clone().requires_grad_(True) for x in (q, k, v)]
    b = [x.clone().requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(checkpoint(block, *a, use_reentrant=False), a,
                              g.float())
    want = torch.autograd.grad(block(*b), b, g.float())
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_cpu_backward_is_plain_and_counts_nothing():
    q, k, v, g = _torch(_inputs((2, 64, 2, 24), 80), torch.bfloat16)
    o, lse = port_fa.attention_plain_lse(q, k, v)
    port_fa.reset_launches()
    got = port_fa.attention_backward("onepass_attention", q, k, v, o, lse, g)
    for x, y in zip(got, port_fa.attention_backward_plain(q, k, v, o, lse,
                                                          g)):
        assert torch.equal(x, y)
    assert port_fa.BACKWARD_LAUNCHES == {}
    assert port_fa.LAUNCHES == {"onepass_attention": 0, "stream_attention": 0}


def test_cpu_stream_backward_is_plain_and_counts_nothing():
    """K2's entry takes the plain version on CPU tensors too, at a head
    dim of 56 with S < L, and counts no launch under either entry."""
    q, k, v, g = _torch(_inputs((1, 80, 3, 56), 48), torch.bfloat16)
    o, lse = port_fa.attention_plain_lse(q, k, v)
    port_fa.reset_launches()
    got = port_fa.attention_backward("stream_attention", q, k, v, o, lse, g)
    for x, y in zip(got, port_fa.attention_backward_plain(q, k, v, o, lse,
                                                          g)):
        assert torch.equal(x, y)
    assert port_fa.BACKWARD_LAUNCHES == {}
    assert port_fa.LAUNCHES == {"onepass_attention": 0, "stream_attention": 0}


# (B, L, H, D) of chip_smoke.py's phase-2 backward shapes: the training
# shapes, a tp rank's, the ragged ones, D_pad 128, 2 x 132 + 4 tiles, fewer
# tiles than SMs; and L != S
PLAN_SHAPES = [((8, 1024, 8, 56), None), ((8, 4096, 1, 256), None),
               ((8, 1024, 4, 56), None), ((2, 333, 8, 56), None),
               ((2, 77, 3, 200), None), ((1, 200, 2, 128), None),
               ((1, 250, 67, 56), None), ((3, 301, 2, 256), None),
               ((2, 64, 2, 24), 80), ((2, 72, 1, 200), 104)]


@pytest.mark.parametrize("shape,s", PLAN_SHAPES)
def test_backward_tile_order_takes_every_tile_once(shape, s):
    """The backward launch's tiles: every (pass, b, h, tile) of the key
    tiles (covering S) and query tiles (covering L) exactly once over the
    CTAs, each CTA's walk strided by the grid, the key tiles first; one
    CTA an SM (at most one a tile) where the kernel is persistent (D_pad
    64), else one a tile."""
    b, l, h, d = shape
    s = l if s is None else s
    plan = port_fa.backward_plan(b, l, h, d, s)
    rows = plan["rows"]
    assert rows == {64: 128, 128: 128, 256: 64}[plan["d_pad"]]
    assert plan["d_pad"] >= d and plan["d_pad"] - d < 128
    assert plan["kv_tiles"] * rows >= s > (plan["kv_tiles"] - 1) * rows
    assert plan["q_tiles"] * rows >= l > (plan["q_tiles"] - 1) * rows
    assert plan["ctas"] == (min(plan["tiles"], 132) if plan["d_pad"] == 64
                            else plan["tiles"])
    walks = port_fa.backward_tile_order(plan)
    assert len(walks) == plan["ctas"]
    flat = [x for walk in walks for x in walk]
    want = {("kv", i, j, t) for i in range(b) for j in range(h)
            for t in range(plan["kv_tiles"])} | {
        ("q", i, j, t) for i in range(b) for j in range(h)
        for t in range(plan["q_tiles"])}
    assert len(flat) == len(set(flat)) == plan["tiles"] == len(want)
    assert set(flat) == want
    for walk in walks:
        passes = [x[0] for x in walk]
        assert passes == sorted(passes)   # "kv" before "q"
    sizes = [len(w) for w in walks]
    assert max(sizes) - min(sizes) <= 1


def test_backward_plan_matches_the_kernel_source():
    """`backward_plan`'s tile rows, streamed rows and persistent D_pad are
    those of csrc/flash_attention_bwd.cu (the C entry point rejects a plan
    that does not fit; this catches a drift on the CPU)."""
    import os
    import re

    from echoscene_torch.kernels import build

    with open(os.path.join(build.CSRC_DIR, port_fa.SOURCE_BWD)) as f:
        src = f.read()
    assert "constexpr int kBlockC = %d;" % port_fa.BWD_STREAMED_ROWS in src
    assert re.search(r"kSplit = D_PAD == 256;", src)
    assert re.search(r"kRows = kSplit \? 64 : 128;", src)
    assert port_fa.BWD_RESIDENT_ROWS == {64: 128, 128: 128, 256: 64}
    assert "kPersistent = D_PAD == 64;" in src
    assert port_fa.BWD_PERSISTENT == (64,)
    k1 = port_fa.backward_plan(8, 1024, 8, 56)
    assert (k1["tiles"], k1["ctas"]) == (1024, 132)
    k2 = port_fa.backward_plan(8, 4096, 1, 256)
    assert (k2["tiles"], k2["ctas"]) == (1024, 1024)
    assert port_fa.backward_plan(1, 250, 67, 56)["tiles"] == 2 * 132 + 4
    assert port_fa.backward_plan(3, 301, 2, 256)["tiles"] == 60


def test_attention_backward_bound_at_the_training_shapes():
    """The backward's bound: 5 products on the tensor cores at K1's and
    K2's training shapes (operations bind both), the exponentials and the
    bytes below them."""
    k1 = port_fa.attention_backward_bound(8, 1024, 8, 56)
    assert k1["flops"] == 10 * 8 * 8 * 1024 * 1024 * 56
    assert k1["bytes"] == 2 * 8 * 1024 * 8 * 56 * 8 + 4 * 8 * 8 * 1024
    assert k1["by"] == "tensor_core" and k1["bound_by"] == "operations"
    np.testing.assert_allclose(k1["ms"], k1["flops"] / 989e12 * 1e3)
    k2 = port_fa.attention_backward_bound(8, 4096, 1, 256)
    assert k2["by"] == "tensor_core"
    assert k2["exp2_ms"] < k2["ms"] and k2["bytes_ms"] < k2["ms"]
    np.testing.assert_allclose(k2["ms"], 0.347419, rtol=1e-5)
