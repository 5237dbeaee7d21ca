"""Softmax attention over long token sequences: CUDA kernels + plain versions.

Replaces the Pallas TPU kernels of echoscene_tpu/kernels/flash_attention.py:

  * `onepass_attention` <- `_onepass_impl` / `_onepass_kernel`: the shape
    UNet's 1024-token self-attention (8 heads of dim 56), 5 launches per
    shape step;
  * `stream_attention` <- `_stream_impl` / `_stream_kernel`: the VQ-VAE
    decoder's 4096-token single-head attention (C = 256), one launch per
    decode chunk.

Both compute softmax(q k^T * D^-1/2) v with f32 scores and f32 accumulation,
and keep the input dtype, as JAX's kernels do: bf16 inputs go to the
TMA + wgmma kernel of `csrc/flash_attention.cu`, f32 inputs to the kernel
of `csrc/flash_attention_tf32x3.cu`, which runs every f32 product as three
TF32 products on the tensor cores (3xTF32: x = hi + lo, a b ~ a_lo b_hi +
a_hi b_lo + a_hi b_hi) and is held to the f32 limits of `TOLERANCES`
(see each source's header for the design and what bounds it on the H100).
The f32 wrapper also allocates the kernel's scratch (`f32_scratch_floats`),
where a pre-pass of the same call writes the split operands.
They are differentiable through `KernelAttention`.  In bf16 the forward is
the kernel with each row's log-sum-exp as a second output and the backward
is the hand-written kernel of `csrc/flash_attention_bwd.cu`
(`attention_backward`): dq, dk, dv of JAX's `_fa_bwd` (jax.vjp of the
einsum reference; JAX has no backward Pallas kernel, XLA computes it),
FlashAttention-2's algorithm, plain version `attention_backward_plain`.  In
f32 the backward recomputes the plain version and differentiates it.
On a CUDA tensor each wrapper launches its hand-written sm_90a kernel and
raises on inputs the kernels do not take: a dtype other than bf16 or f32,
q, k, v of different dtypes, layout, alignment, D > 256, D % 8 != 0 (the
bf16 kernel's TMA loads need 16-byte row strides; the f32 kernel keeps the
same rule) or no queries / keys.  On a CPU tensor it computes the plain
PyTorch version, `attention_plain`; on CUDA no kernel site reaches it (the
dispatcher uses it only for the sites JAX also leaves to einsum).  Layout
is JAX's: q (B, L, H, D), k/v (B, S, H, D).  `attention_bound` is the least
time the H100 could take for a call, the yardstick chip_smoke.py holds the
kernels to.

`LAUNCHES` counts kernel launches per wrapper and `LAUNCHES_BY_DTYPE` the
same launches by (wrapper, dtype name); `BACKWARD_LAUNCHES` counts the
backward kernel's launches by (wrapper, dtype name); a run resets all three
to read which kernels its main path went through.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Optional, Tuple

import torch

from . import build

SOURCE = "flash_attention.cu"            # bf16: TMA + wgmma
SOURCE_F32 = "flash_attention_tf32x3.cu"  # f32: 3xTF32, TMA + wgmma
SOURCE_BWD = "flash_attention_bwd.cu"     # bf16 backward: TMA + wgmma
# the source and C-entry suffix of each dtype the kernels take
KERNELS = {torch.bfloat16: (SOURCE, ""), torch.float32: (SOURCE_F32, "_f32")}
LAUNCHES: Dict[str, int] = {"onepass_attention": 0, "stream_attention": 0}
LAUNCHES_BY_DTYPE: Dict[Tuple[str, str], int] = {}
BACKWARD_LAUNCHES: Dict[Tuple[str, str], int] = {}
LOG2E = 1.4426950408889634
MAX_HEAD_DIM = 256
# error_ratios' limits by output dtype: (max err of the peak, mean err of
# the mean magnitude)
TOLERANCES = {torch.bfloat16: (2.0 ** -6, 1e-2),
              torch.float32: (2.0 ** -14, 1e-5)}
_entries: Dict[Tuple[str, torch.dtype], ctypes._CFuncPtr] = {}
# guards _entries and the launch counts: the data-parallel sampler launches
# from one thread a device
_lock = threading.Lock()


# H100 SXM peaks (NVIDIA's data sheet) behind `attention_bound`
PEAK_BF16_FLOPS = 989e12     # dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12       # f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12     # dense TF32 tensor-core rate
PEAK_BYTES = 3.35e12         # HBM3
NUM_SMS = 132
EXP2_PER_SM_CLOCK = 16       # SFU results per SM per clock
MAX_SM_CLOCK_HZ = 1.98e9     # nvidia-smi clocks.max.sm of the H100 SXM


def attention_bound(b: int, l: int, h: int, d: int, s: Optional[int] = None,
                    sm_clock_hz: float = MAX_SM_CLOCK_HZ,
                    dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The least time one H100 could take for softmax(q k^T) v with q
    (b, l, h, d) and k, v (b, s, h, d) in `dtype` (bf16 or f32): the
    largest of
      * the time of its 4 b h l s d flops: on the tensor cores at 989
        TFLOP/s for bf16 ("tensor_core"); for f32 the faster of two routes
        that keep f32 accuracy, f32 FMAs at 67 TFLOP/s ("fma") and three
        TF32 tensor-core products per product at 495 TFLOP/s ("tf32x3",
        the route of the f32 kernel); both are reported,
      * the SFU time of its b h l s exponentials, one exp2 per score at
        132 SMs x 16 per clock at `sm_clock_hz`,
      * the time to read q, k, v once and write o once at 3.35 TB/s, in
        elements of `dtype`.
    Returns each time in ms (`<name>_ms`), the largest (`ms`), which one
    bounds (`by`), the work counted, and `bound_by`, "operations" or
    "bytes"."""
    s = l if s is None else s
    flops = 4 * b * h * l * s * d
    exps = b * h * l * s
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = size * (2 * b * l * h * d + 2 * b * s * h * d)
    if dtype == torch.bfloat16:
        routes = {"tensor_core": flops / PEAK_BF16_FLOPS * 1e3}
    else:
        routes = {"fma": flops / PEAK_F32_FLOPS * 1e3,
                  "tf32x3": 3 * flops / PEAK_TF32_FLOPS * 1e3}
    products = min(routes, key=routes.get)
    times = {products: routes[products],
             "exp2": exps / (NUM_SMS * EXP2_PER_SM_CLOCK * sm_clock_hz) * 1e3,
             "bytes": nbytes / PEAK_BYTES * 1e3}
    by = max(times, key=times.get)
    out = {"ms": times[by], "by": by,
           "bound_by": "bytes" if by == "bytes" else "operations",
           "flops": flops, "exps": exps, "bytes": nbytes}
    out.update({f"{name}_ms": t for name, t in {**routes, **times}.items()})
    return out


def attention_backward_bound(b: int, l: int, h: int, d: int,
                             s: Optional[int] = None,
                             sm_clock_hz: float = MAX_SM_CLOCK_HZ) -> Dict:
    """The least time one H100 could take for the bf16 backward (dq, dk, dv
    from q, k, v, o, lse and do): the largest of its 5 products' 10 b h l s
    d flops on the tensor cores (S recomputed, dP, dV, dQ, dK), its b h l s
    exponentials on the SFU, and the bytes of reading q, k, v, o, do (bf16)
    and lse (f32) once and writing dq, dk, dv (bf16) once.  Returns the
    same keys as `attention_bound`."""
    s = l if s is None else s
    flops = 10 * b * h * l * s * d
    exps = b * h * l * s
    nbytes = 2 * (3 * b * l * h * d + 2 * b * s * h * d) + 4 * b * h * l + \
        2 * (b * l * h * d + 2 * b * s * h * d)
    times = {"tensor_core": flops / PEAK_BF16_FLOPS * 1e3,
             "exp2": exps / (NUM_SMS * EXP2_PER_SM_CLOCK * sm_clock_hz) * 1e3,
             "bytes": nbytes / PEAK_BYTES * 1e3}
    by = max(times, key=times.get)
    out = {"ms": times[by], "by": by,
           "bound_by": "bytes" if by == "bytes" else "operations",
           "flops": flops, "exps": exps, "bytes": nbytes}
    out.update({f"{name}_ms": t for name, t in times.items()})
    return out


def reset_launches() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        LAUNCHES_BY_DTYPE.clear()
        BACKWARD_LAUNCHES.clear()


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """einsum -> f32 softmax -> einsum, as JAX's `_einsum_reference` and
    `_einsum_attention`: f32 products of the input values, probabilities
    cast to v's dtype.  `mask` (broadcastable to (B, H, L, S)) drops the
    scores where it is False."""
    d = q.shape[-1]
    scores = torch.einsum("blhd,bshd->bhls", q.float(), k.float()) * d ** -0.5
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhls,bshd->blhd", p.float(), v.float()).to(q.dtype)


def attention_plain_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`attention_plain` and each query row's log-sum-exp of the scaled
    scores in the log2 domain, f32 (B, H, L): log2 sum_s 2^(s D^-1/2 log2 e),
    what the bf16 forward kernel writes for the backward."""
    d = q.shape[-1]
    scores = torch.einsum("blhd,bshd->bhls", q.float(), k.float()) * d ** -0.5
    return attention_plain(q, k, v), torch.logsumexp(scores, dim=-1) * LOG2E


def attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """dq, dk, dv of attention for the upstream gradient `do`, by the
    backward kernel's algorithm in f32: P = exp2(q k^T c - lse) with c =
    D^-1/2 log2 e rounded to f32 as the kernel does, delta = rowsum(do * o),
    dV = P^T do, dS = P (do v^T - delta), dq = dS k D^-1/2, dk = dS^T q
    D^-1/2; P and dS are rounded to q's dtype as the operands of their
    products, where the kernel rounds them to bf16.  o and lse are the
    forward's (`attention_plain_lse`)."""
    d = q.shape[-1]
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    scale_log2 = (scale * torch.tensor(LOG2E, dtype=torch.float32)).item()
    s = torch.einsum("blhd,bshd->bhls", q.float(), k.float())
    p = torch.exp2(s * scale_log2 - lse.float()[..., None])
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    dv = torch.einsum("bhls,blhd->bshd", p.to(q.dtype).float(), do.float())
    dp = torch.einsum("blhd,bshd->bhls", do.float(), v.float())
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dq = torch.einsum("bhls,bshd->blhd", ds, k.float()) * scale
    dk = torch.einsum("bhls,blhd->bshd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_grads_float64(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor):
    """dq, dk, dv of softmax(q k^T D^-1/2) v in float64 from the same input
    values, nothing rounded: the yardstick both the kernel's and the plain
    path's gradient errors are measured against."""
    leaves = [x.detach().double().requires_grad_(True) for x in (q, k, v)]
    qd, kd, vd = leaves
    scores = torch.einsum("blhd,bshd->bhls", qd, kd) * q.shape[-1] ** -0.5
    out = torch.einsum("bhls,bshd->blhd", torch.softmax(scores, dim=-1), vd)
    return torch.autograd.grad(out, leaves, do.double())


def error_ratios(out: torch.Tensor, ref: torch.Tensor):
    """The tolerance a kernel's output is held to against `attention_plain`
    on the same inputs, as (max abs err / (max limit * max|ref|), mean abs
    err / (mean limit * mean|ref|)); both <= 1 passes.  The limits follow
    out's dtype (`TOLERANCES`): for bf16 2^-6 allows two bf16 ulps at the
    output's peak and 1e-2 a little over one ulp per element; for f32 2^-14
    and 1e-5 leave room for the kernel's other summation order and exp2.  A
    result that leaves out 32 of the keys is off by several times both
    (chip_smoke.py checks that)."""
    max_rel, mean_rel = TOLERANCES[out.dtype]
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    return (d.max().item() / (max_rel * r.max().item()),
            d.mean().item() / (mean_rel * r.mean().item()))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in KERNELS:
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q {q.dtype}: the kernels "
                            f"take q, k, v of one dtype")
        if x.dim() != 4 or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"(B, L, H, D) tensor, got shape "
                             f"{tuple(x.shape)}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if d > MAX_HEAD_DIM or d % 8 or k.shape[1] == 0 or q.shape[1] == 0:
        raise ValueError(f"unsupported head dim {d} (the kernel's TMA loads "
                         f"take D <= {MAX_HEAD_DIM}, D % 8 == 0) or empty "
                         f"queries / keys")


def f32_scratch_floats(b: int, h: int, d: int, s: int) -> int:
    """Floats of the f32 kernel's scratch: k as TF32 hi and lo parts in its
    own layout, and v's hi and lo parts transposed to (B, H, D, S8) with S8
    = S rounded up to 8 (the layout of `csrc/flash_attention_tf32x3.cu`,
    `scratch_layout`; q is split inside the kernel)."""
    s8 = -(-s // 8) * 8
    return 2 * b * h * d * (s + s8)


def _entry(entry: str, dtype: torch.dtype, lse: bool = False):
    """The C function of `entry` for `dtype`, its ctypes signature bound
    once when its library loads: (q, k, v, o, B, H, L, S, D, scale,
    stream), and for f32 a last pointer, the scratch; with `lse` (bf16
    only) the entry that also writes each row's log-sum-exp, (q, k, v, o,
    lse, B, H, L, S, D, scale, stream)."""
    key = (f"{entry}_lse" if lse else entry, dtype)
    with _lock:
        fn = _entries.get(key)
        if fn is None:
            source, suffix = KERNELS[dtype]
            lib = build.load(source)
            extra = [ctypes.c_void_p] if dtype == torch.float32 else []
            for name in LAUNCHES:
                f = getattr(lib, f"echoscene_{name}{suffix}")
                f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
                    ctypes.c_float, ctypes.c_void_p] + extra
                f.restype = ctypes.c_int
                _entries[(name, dtype)] = f
                if dtype == torch.bfloat16:
                    f = getattr(lib, f"echoscene_{name}_lse")
                    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
                        ctypes.c_float, ctypes.c_void_p]
                    f.restype = ctypes.c_int
                    _entries[(f"{name}_lse", dtype)] = f
            fn = _entries[key]
        return fn


def _launch(entry: str, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, lse: bool = False):
    """o = the forward kernel of `entry` on q, k, v; with `lse` (bf16
    only) (o, lse), lse each row's log-sum-exp, f32 (B, H, L)."""
    _check(q, k, v)
    if lse and q.dtype != torch.bfloat16:
        raise TypeError(f"the log-sum-exp output is bf16 only, got {q.dtype}")
    fn = _entry(entry, q.dtype, lse)
    b, l, h, d = q.shape
    o = torch.empty_like(q)
    extra = []
    if q.dtype == torch.float32:
        scratch = torch.empty(f32_scratch_floats(b, h, d, k.shape[1]),
                              dtype=torch.float32, device=q.device)
        extra = [scratch.data_ptr()]
    lse_out = (torch.empty((b, h, l), dtype=torch.float32, device=q.device)
               if lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 *([lse_out.data_ptr()] if lse else []), b, h, l,
                 k.shape[1], d, d ** -0.5, stream, *extra)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    _count(entry, q.dtype)
    return (o, lse_out) if lse else o


# the backward kernel's tiles: streamed rows a stage, and the resident rows
# a CTA holds by padded head dim (csrc/flash_attention_bwd.cu, BwdTiles);
# persistent at D_pad 64 only
BWD_STREAMED_ROWS = 64
BWD_RESIDENT_ROWS = {64: 128, 128: 128, 256: 64}
BWD_PERSISTENT = (64,)


def backward_plan(b: int, l: int, h: int, d: int, s: Optional[int] = None,
                  sms: int = NUM_SMS) -> Dict:
    """The backward kernel's launch for q (b, l, h, d) and k, v (b, s, h,
    d) on a card of `sms` SMs: `tiles` = b h (kv_tiles + q_tiles), the key
    tiles of every (b, h) first (the dK / dV pass: `rows` keys each, the
    queries streamed `streamed_rows` at a time), then the query tiles (the
    dQ pass, `rows` queries each, the keys streamed); one launch of `ctas`
    CTAs, CTA c taking tiles c, c + ctas, ... (`backward_tile_order`):
    min(tiles, sms) at D_pad 64, where the kernel is persistent, else one
    a tile.  The C entry point rejects a plan whose `rows` or `ctas` do not
    fit its source."""
    s = l if s is None else s
    d_pad = next(p for p in sorted(BWD_RESIDENT_ROWS) if d <= p)
    rows = BWD_RESIDENT_ROWS[d_pad]
    kv_tiles, q_tiles = -(-s // rows), -(-l // rows)
    tiles = b * h * (kv_tiles + q_tiles)
    return {"b": b, "h": h, "l": l, "s": s, "d_pad": d_pad, "rows": rows,
            "streamed_rows": BWD_STREAMED_ROWS, "kv_tiles": kv_tiles,
            "q_tiles": q_tiles, "tiles": tiles,
            "ctas": min(tiles, sms) if d_pad in BWD_PERSISTENT else tiles}


def backward_tile_order(plan: Dict):
    """Each CTA's tiles of `plan`'s launch, in the order it takes them, as
    (pass, b, h, tile): pass "kv" (tile t holds keys [t rows, (t + 1)
    rows)) or "q" (queries), as the kernel decodes its tile index."""
    b, h, kv_tiles = plan["b"], plan["h"], plan["kv_tiles"]

    def tile(x):
        if x < b * h * kv_tiles:
            name, tiles = "kv", kv_tiles
        else:
            name, tiles, x = "q", plan["q_tiles"], x - b * h * kv_tiles
        return name, x // tiles // h, x // tiles % h, x % tiles

    return [[tile(x) for x in range(c, plan["tiles"], plan["ctas"])]
            for c in range(plan["ctas"])]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _backward_entry():
    """The backward kernel's C function, its ctypes signature bound once:
    (q, k, v, o, do, lse, delta, dq, dk, dv, B, H, L, S, D, scale, rows,
    ctas, stream)."""
    key = ("attention_backward", torch.bfloat16)
    with _lock:
        fn = _entries.get(key)
        if fn is None:
            fn = build.load(SOURCE_BWD).echoscene_attention_backward
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_long, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _entries[key] = fn
        return fn


def _backward_launch(q, k, v, o, lse, do):
    """dq, dk, dv by the backward kernel after the checks
    `attention_backward` documents."""
    _check(q, k, v)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the backward kernel takes bfloat16, got {q.dtype}")
    if not do.is_contiguous() or do.data_ptr() % 16:
        do = do.clone(memory_format=torch.contiguous_format)
    b, l, h, d = q.shape
    for name, x, shape, dtype in (("o", o, q.shape, q.dtype),
                                  ("do", do, q.shape, q.dtype),
                                  ("lse", lse, (b, h, l), torch.float32)):
        if (x.shape != shape or x.dtype != dtype or x.device != q.device
                or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"{dtype} {tuple(shape)} tensor on {q.device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if b * h > 65535:
        raise ValueError(f"B * H = {b * h} exceeds the backward kernel's "
                         f"limit (65535)")
    fn = _backward_entry()
    p = backward_plan(b, l, h, d, k.shape[1], _sm_count(q.device.index))
    plan = [p["rows"], p["ctas"]]
    delta = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(*(x.data_ptr() for x in (q, k, v, o, do, lse, delta, dq, dk,
                                          dv)),
                 b, h, l, k.shape[1], d, d ** -0.5, *plan, stream)
    if err != 0:
        raise RuntimeError(f"attention backward kernel launch failed: CUDA "
                           f"error {err}")
    return dq, dk, dv


def attention_backward(entry: str, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                       do: torch.Tensor):
    """dq, dk, dv of the bf16 attention whose forward (`entry`'s kernel)
    gave o and lse, for the upstream gradient `do`.  CUDA: the sm_90a
    backward kernel of `csrc/flash_attention_bwd.cu` (two launches: the
    delta pre-pass, then one grid over the key tiles' dK / dV and the
    query tiles' dQ, `backward_plan`; no atomics), counted once in
    `BACKWARD_LAUNCHES`; it takes what the forward takes and raises on
    anything else (do is made contiguous first: autograd may hand it
    strided).  CPU: `attention_backward_plain`."""
    if q.device.type == "cpu":
        return attention_backward_plain(q, k, v, o, lse, do)
    grads = _backward_launch(q, k, v, o, lse, do)
    key = (entry, str(q.dtype).removeprefix("torch."))
    with _lock:
        BACKWARD_LAUNCHES[key] = BACKWARD_LAUNCHES.get(key, 0) + 1
    return grads


def _count(entry: str, dtype: torch.dtype) -> None:
    """One launch of `entry` in `dtype`, counted under the lock."""
    key = (entry, str(dtype).removeprefix("torch."))
    with _lock:
        LAUNCHES[entry] += 1
        LAUNCHES_BY_DTYPE[key] = LAUNCHES_BY_DTYPE.get(key, 0) + 1


class KernelAttention(torch.autograd.Function):
    """An attention kernel made differentiable, as JAX's `custom_vjp` does
    (`_fa_fwd` / `_fa_bwd`, flash_attention.py:226-243).
    `apply(fwd, q, k, v, bwd)`: the forward is `fwd(q, k, v) -> (o, lse)`,
    the backward `bwd(q, k, v, o, lse, do) -> (dq, dk, dv)` from the saved
    q, k, v, o and lse (the bf16 kernels).  `apply(fwd, q, k, v)`: the
    forward is `fwd(q, k, v) -> o` and the backward recomputes
    `attention_plain` from the saved q, k, v and differentiates it (f32).
    `fwd` and `bwd` are parameters so that a CPU test can run the wiring
    with the plain versions standing in for the kernels."""

    @staticmethod
    def forward(ctx, fwd, q, k, v, bwd=None):
        ctx.bwd = bwd
        if bwd is None:
            ctx.save_for_backward(q, k, v)
            return fwd(q, k, v)
        o, lse = fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, grad_out):
        needs = ctx.needs_input_grad[1:4]
        rest = (None,) * (len(ctx.needs_input_grad) - 4)
        if ctx.bwd is not None:
            grads = ctx.bwd(*ctx.saved_tensors, grad_out)
            return (None, *(g if need else None
                            for g, need in zip(grads, needs)), *rest)
        inputs = [x.detach().requires_grad_(need) for x, need in
                  zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            out = attention_plain(*inputs)
            wanted = [x for x in inputs if x.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return (None, *(next(grads) if x.requires_grad else None
                        for x in inputs), *rest)


def _differentiable(fwd, q, k, v, fwd_lse=None, bwd=None) -> torch.Tensor:
    """fwd(q, k, v), through `KernelAttention` when autograd records: with
    `bwd`, the Function of `fwd_lse` and `bwd`, else of `fwd` and the plain
    recompute.  No Function (and nothing saved) under torch.no_grad()."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if bwd is None:
            return KernelAttention.apply(fwd, q, k, v)
        return KernelAttention.apply(fwd_lse, q, k, v, bwd)
    return fwd(q, k, v)


def _kernel_attention(entry: str, q, k, v) -> torch.Tensor:
    """`entry`'s forward kernel, differentiable: bf16 through the
    lse-writing forward and the backward kernel, other dtypes through the
    plain recompute."""
    fwd = functools.partial(_launch, entry)
    if q.dtype != torch.bfloat16:
        return _differentiable(fwd, q, k, v)
    return _differentiable(fwd, q, k, v,
                           functools.partial(_launch, entry, lse=True),
                           functools.partial(attention_backward, entry))


def onepass_attention(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """K1 (replaces `_onepass_kernel`): attention where JAX keeps all of K/V
    resident.  CUDA: the sm_90a kernel (differentiable through
    `KernelAttention`); CPU: `attention_plain`."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return _kernel_attention("onepass_attention", q, k, v)


def stream_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """K2 (replaces `_stream_kernel`): attention where JAX streams K/V in
    blocks.  CUDA: the sm_90a kernel (differentiable through
    `KernelAttention`); CPU: `attention_plain`."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return _kernel_attention("stream_attention", q, k, v)


def kv_fits_onepass(s: int, d: int) -> bool:
    """JAX's one-pass/stream split (`_kv_fits_vmem`, flash_attention.py:
    148-150), kept so each call site takes the kernel it takes in JAX."""
    d_pad = -(-d // 128) * 128
    return 2 * 2 * s * d_pad * 4 <= 9 * 1024 * 1024


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q: (B, L, H, D); k, v: (B, S, H, D) -> (B, L, H, D)."""
    if kv_fits_onepass(k.shape[1], q.shape[-1]):
        return onepass_attention(q, k, v)
    return stream_attention(q, k, v)

