"""Softmax attention over long token sequences: CUDA kernels + plain versions.

Replaces the Pallas TPU kernels of echoscene_tpu/kernels/flash_attention.py:

  * `onepass_attention` <- `_onepass_impl` / `_onepass_kernel`: the shape
    UNet's 1024-token self-attention (8 heads of dim 56), 5 launches per
    DDIM step;
  * `stream_attention` <- `_stream_impl` / `_stream_kernel`: the VQ-VAE
    decoder's 4096-token single-head attention (C = 256), one launch per
    decode chunk.

Both compute softmax(q k^T * D^-1/2) v with f32 scores and f32 accumulation.
On a CUDA tensor each wrapper launches its hand-written sm_90a kernel
(`csrc/flash_attention.cu`; see its header for the design and what bounds it
on the H100) and raises on inputs the kernel does not take: dtype, layout,
alignment, D > 256, D % 8 != 0 (its TMA loads need 16-byte row strides) or
no queries / keys.  On a CPU tensor it computes the plain PyTorch version,
`attention_plain`; on CUDA no kernel site reaches it (the dispatcher uses it
only for the sites JAX also leaves to einsum).  Layout is JAX's:
q (B, L, H, D), k/v (B, S, H, D).  `attention_bound` is the least time the
H100 could take for a call, the yardstick chip_smoke.py holds the kernels
to.

`LAUNCHES` counts kernel launches per wrapper; a run resets it to read which
kernels its main path went through.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import build

SOURCE = "flash_attention.cu"
LAUNCHES: Dict[str, int] = {"onepass_attention": 0, "stream_attention": 0}
MAX_HEAD_DIM = 256
MAX_REL_ERR = 2.0 ** -6
MEAN_REL_ERR = 1e-2
_entries: Dict[str, ctypes._CFuncPtr] = {}


# H100 SXM peaks (NVIDIA's data sheet) behind `attention_bound`
PEAK_BF16_FLOPS = 989e12     # dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12         # HBM3
NUM_SMS = 132
EXP2_PER_SM_CLOCK = 16       # SFU results per SM per clock
MAX_SM_CLOCK_HZ = 1.98e9     # nvidia-smi clocks.max.sm of the H100 SXM


def attention_bound(b: int, l: int, h: int, d: int, s: Optional[int] = None,
                    sm_clock_hz: float = MAX_SM_CLOCK_HZ) -> Dict:
    """The least time one H100 could take for softmax(q k^T) v with q
    (b, l, h, d) and k, v (b, s, h, d) in bf16: the largest of
      * the tensor-core time of its 4 b h l s d flops at 989 TFLOP/s,
      * the SFU time of its b h l s exponentials, one exp2 per score at
        132 SMs x 16 per clock at `sm_clock_hz`,
      * the time to read q, k, v once and write o once at 3.35 TB/s.
    Returns each time in ms, the largest (`ms`), which one bounds (`by`:
    "tensor_core", "exp2" or "bytes"), the work counted, and `bound_by`,
    "operations" or "bytes"."""
    s = l if s is None else s
    flops = 4 * b * h * l * s * d
    exps = b * h * l * s
    nbytes = 2 * (2 * b * l * h * d + 2 * b * s * h * d)
    times = {"tensor_core": flops / PEAK_BF16_FLOPS * 1e3,
             "exp2": exps / (NUM_SMS * EXP2_PER_SM_CLOCK * sm_clock_hz) * 1e3,
             "bytes": nbytes / PEAK_BYTES * 1e3}
    by = max(times, key=times.get)
    return {"ms": times[by], "by": by,
            "bound_by": "bytes" if by == "bytes" else "operations",
            "tensor_core_ms": times["tensor_core"], "exp2_ms": times["exp2"],
            "bytes_ms": times["bytes"], "flops": flops, "exps": exps,
            "bytes": nbytes}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def error_ratios(out: torch.Tensor, ref: torch.Tensor):
    """The tolerance a kernel's bf16 output is held to against
    `attention_plain` on the same inputs, as (max abs err / MAX_REL_ERR *
    max|ref|, mean abs err / MEAN_REL_ERR * mean|ref|); both <= 1 passes.
    MAX_REL_ERR = 2^-6 allows two bf16 ulps at the output's peak, MEAN_REL_ERR
    = 1e-2 a little over one ulp per element; a result that leaves out 32
    of the keys is off by several times both (chip_smoke.py checks that)."""
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    return (d.max().item() / (MAX_REL_ERR * r.max().item()),
            d.mean().item() / (MEAN_REL_ERR * r.mean().item()))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {x.dtype}")
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


def _entry(entry: str):
    """The library's C function for `entry`, its ctypes signature bound
    once when the library loads."""
    fn = _entries.get(entry)
    if fn is None:
        lib = build.load(SOURCE)
        for name in LAUNCHES:
            f = getattr(lib, f"echoscene_{name}")
            f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
                ctypes.c_float, ctypes.c_void_p]
            f.restype = ctypes.c_int
            _entries[name] = f
        fn = _entries[entry]
    return fn


def _launch(entry: str, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    _check(q, k, v)
    fn = _entry(entry)
    b, l, h, d = q.shape
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 b, h, l, k.shape[1], d, d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    LAUNCHES[entry] += 1
    return o


def onepass_attention(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """K1 (replaces `_onepass_kernel`): attention where JAX keeps all of K/V
    resident.  CUDA: the sm_90a kernel; CPU: `attention_plain`."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return _launch("onepass_attention", q, k, v)


def stream_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """K2 (replaces `_stream_kernel`): attention where JAX streams K/V in
    blocks.  CUDA: the sm_90a kernel; CPU: `attention_plain`."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return _launch("stream_attention", q, k, v)


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

