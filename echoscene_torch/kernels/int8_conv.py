"""Int8 W8A8 convolution: CUDA kernels + plain versions.

Hand kernels of the port with no Pallas counterpart.  The JAX package's
`sample_dtype: int8` mode (echoscene_tpu/nn/quant.py) quantizes each shape
UNet convolution's input per tensor and its weight per output channel and
runs `lax.conv_general_dilated` on the int8 operands with int32
accumulation (nn/quant.py:89-92): XLA's convolution, not Pallas.  PyTorch
has no CUDA int8 3D convolution, so the port has two kernels of its own,
in `csrc/int8_conv.cu`:

  * Q1 `quantize_act`: the per-tensor abs-max, scale = max(amax, eps) /
    127, q = clip(round(x / scale), -127, 127) (round half to even, IEEE
    division: JAX's `quantize_symmetric`, nn/quant.py:27-33), written
    channels-last with the channels padded to a multiple of 32 by zeros
    (the layout Q2 reads); the scale stays on the device.  One abs-max
    pass into one device word, then a quantize / transpose pass with
    16-byte loads and stores.  The two passes are also two calls,
    `quantize_amax` (the word: max |x| as a non-negative f32's bits, int32)
    and `quantize_with_amax` (the quantize from a word), so that the words
    of a model group's channel shards can be folded by a MAX all-reduce in
    between (a convolution split on its input channels, nn/quant.py);
  * Q2 `int8_conv3d`: an implicit-GEMM convolution on `wgmma` (m64n224k32
    or m64n8k32 s8, operands loaded by TMA) with int32 accumulation and
    the dequantize epilogue acc * (x_scale * w_scale[k]) (+ bias[k]) in
    f32 -> bf16 (nn/quant.py:93-96), for kernels of 1-3 taps an axis,
    strides 1-8, per-side pads, written channel-first through the output's
    strides.  Its tile plan (`conv_plan`) is computed here and passed in.
    `int8_conv3d_acc` is the same kernel with an epilogue that writes the
    int32 accumulators themselves (no dequantize, no bias): a row-split
    convolution's partial sums, added as int32 over the model group before
    one `dequantize`.

On a CPU tensor each wrapper computes its plain version (`quantize_plain`,
`quantize_amax_plain`, `quantize_with_amax_plain`, `int8_conv3d_plain`,
`int8_conv3d_acc_plain`: F.conv3d in float64 on the integer values, exact
since every sum stays below 2^53); on a CUDA tensor it launches its kernel
or raises on a dtype, layout, alignment or shape the kernel does not take.
`LAUNCHES` counts kernel launches per wrapper; `quantize_bound` /
`int8_conv_bound` give the least time one H100 could take for a call.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import build

SOURCE = "int8_conv.cu"
LAUNCHES: Dict[str, int] = {"quantize_act": 0, "int8_conv3d": 0,
                            "quantize_amax": 0, "quantize_with_amax": 0,
                            "int8_conv3d_acc": 0}
CHANNEL_ALIGN = 32          # Q1 pads the channels to a multiple of 32
EPS = 1e-8                  # JAX's quantize_symmetric eps
# Q2's tiles: 128 output positions (a box of the output) x 224 output
# channels (8 for a convolution of at most 8), depth in chunks of 64 or 128
# channels, one tap at a time
TILE_M = 128
TILE_N = 224
TILE_N_SMALL = 8
CHUNKS = (128, 64)          # bytes of a chunk, the 128- or 64-byte swizzle
MAX_STRIDE = 8              # TMA's element strides
MAX_BOX = 256               # TMA's box extent along an axis
_entries: Dict[str, ctypes._CFuncPtr] = {}
_lock = threading.Lock()

# H100 SXM peaks (NVIDIA's data sheet)
PEAK_INT8_OPS = 1979e12     # dense int8 tensor-core rate
PEAK_BYTES = 3.35e12        # HBM3


def reset_launches() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def padded_channels(c: int) -> int:
    return -(-c // CHANNEL_ALIGN) * CHANNEL_ALIGN


def scale_of(amax: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """max(amax, eps) / 127 in f32 with IEEE division, as JAX computes it.
    The divisor is a tensor on amax's device: PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, which can round the scale
    one ulp away."""
    return (torch.maximum(amax, amax.new_tensor(eps))
            / amax.new_full((), 127.0))


def quantize_symmetric(x: torch.Tensor, dims: Optional[Sequence[int]] = None,
                       eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """abs-max int8 quantization over `dims` (all when None), JAX's
    quantize_symmetric (echoscene_tpu/nn/quant.py:27-33): scale =
    max(amax, eps) / 127 (kept dims), q = clip(round(x / scale), -127, 127)
    in f32, round half to even."""
    dims = tuple(range(x.dim())) if dims is None else tuple(dims)
    scale = scale_of(x.float().abs().amax(dim=dims, keepdim=True), eps)
    return quantize_with_scale(x, scale), scale


def quantize_with_scale(x: torch.Tensor, scale: torch.Tensor
                        ) -> torch.Tensor:
    """clip(round(x / scale), -127, 127) in f32, round half to even, int8
    (`scale` broadcasts against x)."""
    return torch.clamp(torch.round(x.float() / scale), -127,
                       127).to(torch.int8)


def quantize_plain(x: torch.Tensor, eps: float = EPS
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Q1's plain version: x (N, C, *spatial) -> (q (N, *spatial, Cp) int8,
    zeros in the padded channels; scale (1,) f32)."""
    return quantize_with_amax_plain(x, quantize_amax_plain(x), eps)


def quantize_amax_plain(x: torch.Tensor) -> torch.Tensor:
    """Q1's first pass, plain: max |x| over the whole tensor as the bits of
    a non-negative f32, a (1,) int32 tensor (the kernel's word).  Such
    words order as their floats do, so a MAX of several (over int32) is
    the word of their tensors together."""
    return x.float().abs().amax().reshape(1).view(torch.int32)


def quantize_with_amax_plain(x: torch.Tensor, amax: torch.Tensor,
                             eps: float = EPS
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Q1's second pass, plain: `quantize_plain` with the abs-max taken from
    the word `amax` ((1,) int32, `quantize_amax_plain`'s, or a MAX of
    several): scale = max(amax, eps) / 127, q = clip(round(x / scale),
    -127, 127) in Q1's layout."""
    scale = scale_of(amax.view(torch.float32).reshape(()), eps)
    q = quantize_with_scale(x, scale)
    c = x.shape[1]
    q = F.pad(q.movedim(1, -1), (0, padded_channels(c) - c))
    return q.contiguous(), scale.reshape(1)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-element distance in bf16 ulps of two bf16 tensors: the measure
    Q2 is held to against its plain version (at most 1)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i + 32768), i)
    return (ordered(a) - ordered(b)).abs()


def output_size(size: Sequence[int], kernel: Sequence[int],
                stride: Sequence[int], pads: Sequence[Tuple[int, int]]
                ) -> Tuple[int, ...]:
    return tuple((n + p0 + p1 - k) // s + 1 for n, k, s, (p0, p1)
                 in zip(size, kernel, stride, pads))


def dequantize(acc: torch.Tensor, x_scale: torch.Tensor,
               w_scale: torch.Tensor, bias: Optional[torch.Tensor]
               ) -> torch.Tensor:
    """f32(acc) * (x_scale * w_scale[k]) (+ bias[k]) -> bf16, channel-first
    acc (N, K, ...): the product rounded before the add (JAX's order)."""
    shape = (1, -1) + (1,) * (acc.dim() - 2)
    y = acc.float() * (x_scale.reshape(()) * w_scale).reshape(shape)
    if bias is not None:
        y = y + bias.float().reshape(shape)
    return y.to(torch.bfloat16)


def int8_conv3d_acc_plain(xq: torch.Tensor, wq: torch.Tensor,
                          stride: Sequence[int] = (1, 1, 1),
                          pads: Sequence[Tuple[int, int]] = ((1, 1),) * 3,
                          out: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The int32 accumulators of Q2, plain: F.conv3d in float64 on the
    integer values (exact).  xq (N, D, H, W, Cp), wq (K, kd, kh, kw, Cp)
    int8 -> (N, K, Do, Ho, Wo) int32, written into `out` when given."""
    xf = xq.permute(0, 4, 1, 2, 3).double()
    wf = wq.permute(0, 4, 1, 2, 3).double()
    (pd0, pd1), (ph0, ph1), (pw0, pw1) = pads
    xf = F.pad(xf, (pw0, pw1, ph0, ph1, pd0, pd1))
    acc = F.conv3d(xf, wf, stride=tuple(stride)).to(torch.int32)
    if out is None:
        return acc
    out.copy_(acc)
    return out


def int8_conv3d_plain(xq: torch.Tensor, wq: torch.Tensor,
                      x_scale: torch.Tensor, w_scale: torch.Tensor,
                      bias: Optional[torch.Tensor],
                      stride: Sequence[int] = (1, 1, 1),
                      pads: Sequence[Tuple[int, int]] = ((1, 1),) * 3,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Q2's plain version: `int8_conv3d_acc_plain`, then `dequantize`.  xq
    (N, D, H, W, Cp), wq (K, kd, kh, kw, Cp) int8 -> (N, K, Do, Ho, Wo)
    bf16, written into `out` when given."""
    y = dequantize(int8_conv3d_acc_plain(xq, wq, stride, pads), x_scale,
                   w_scale, bias)
    if out is None:
        return y
    out.copy_(y)
    return out


# the fields of the plan vector, in the order of csrc/int8_conv.cu's
# PlanField; the taps' (d, h, w) offsets follow
PLAN_FIELDS = ("n", "di", "hi", "wi", "cp", "k", "taps", "do", "ho", "wo",
               "sd", "sh", "sw", "nb", "db", "hb", "wb", "cw", "bn",
               "tiles_n", "tiles_d", "tiles_h", "tiles_w", "n_tiles",
               "chunks", "osn", "osk", "osd", "osh", "osw", "out_bytes")


def _box(m_shape: Sequence[int], stride: Sequence[int]) -> Tuple[int, ...]:
    """The box (Nb, Db, Hb, Wb) of TILE_M output positions that covers the
    output (N, Do, Ho, Wo) in the fewest tiles (most W, then H, then D
    among equals, for long runs of the output's innermost axis); each
    axis's extent times its stride is at most MAX_BOX."""
    e = int(math.log2(TILE_M))
    best = None
    for parts in itertools.product(range(e + 1), repeat=3):
        if sum(parts) > e:
            continue
        bw, bh, bd = (2 ** p for p in parts)
        box = (TILE_M // (bw * bh * bd), bd, bh, bw)
        if any(b * s > MAX_BOX for b, s in zip(box, (1,) + tuple(stride))):
            continue
        tiles = math.prod(-(-m // b) for m, b in zip(m_shape, box))
        key = (tiles, -bw, -bh, -bd)
        if best is None or key < best[0]:
            best = (key, box)
    return best[1]


@functools.lru_cache(maxsize=512)
def conv_plan(n: int, in_spatial: Tuple[int, int, int], cp: int, k: int,
              taps: Tuple[int, int, int], stride: Tuple[int, int, int],
              pads: Tuple[Tuple[int, int], ...],
              out_strides: Tuple[int, ...], out_bytes: int = 2) -> Dict:
    """Q2's tile plan for xq (n, *in_spatial, cp), wq (k, *taps, cp), the
    stride, per-side pads, the output's element strides (N, K, D, H, W) and
    its element size (2: bf16, the dequantized output; 4: int32, the
    accumulators; the C entry checks it): `box` (Nb, Db, Hb, Wb), the M
    tile; `tiles` (boxes along N, D, H,
    W); `bn`, the N tile (TILE_N, or TILE_N_SMALL for k <= 8), and
    `n_tiles`; `cw`, the chunk of channels a stage (128 or 64: whichever
    pads cp less, 128 on a tie) and `chunks`; `tap_offsets`, the input
    coordinate of output 0 for each tap in wq's (kd, kh, kw) order, each
    (d, h, w) = tap - front pad; `vector`, what the kernel reads
    (PLAN_FIELDS, then the offsets).  Raises ValueError on a shape the
    kernel does not take."""
    if any(t not in (1, 2, 3) for t in taps):
        raise ValueError(f"kernel taps {taps}: 1-3 an axis")
    if any(not 1 <= s <= MAX_STRIDE for s in stride):
        raise ValueError(f"strides {stride}: 1-{MAX_STRIDE} an axis (TMA's "
                         f"element strides)")
    if any(p < 0 for pair in pads for p in pair):
        raise ValueError(f"pads {pads}: must not be negative")
    if cp % CHANNEL_ALIGN:
        raise ValueError(f"channels {cp}: a multiple of {CHANNEL_ALIGN}")
    if out_bytes not in (2, 4):
        raise ValueError(f"output elements of {out_bytes} bytes: 2 (bf16) "
                         f"or 4 (int32)")
    out = output_size(in_spatial, taps, stride, pads)
    if n < 1 or k < 1 or min(out) < 1 or min(in_spatial) < 1:
        raise ValueError(f"empty convolution: n {n}, k {k}, input "
                         f"{in_spatial}, output {out}")
    m_shape = (n,) + out
    box = _box(m_shape, stride)
    tiles = tuple(-(-m // b) for m, b in zip(m_shape, box))
    cw = min(CHUNKS, key=lambda c: (-(-cp // c) * c, -c))
    chunks = -(-cp // cw)
    bn = TILE_N_SMALL if k <= TILE_N_SMALL else TILE_N
    n_tiles = -(-k // bn)
    offsets = tuple((tz - pads[0][0], ty - pads[1][0], tx - pads[2][0])
                    for tz in range(taps[0]) for ty in range(taps[1])
                    for tx in range(taps[2]))
    if math.prod(tiles) * n_tiles >= 2 ** 31:
        raise ValueError(f"{math.prod(tiles) * n_tiles} tiles: more than a "
                         f"grid holds")
    fields = dict(n=n, di=in_spatial[0], hi=in_spatial[1], wi=in_spatial[2],
                  cp=cp, k=k, taps=math.prod(taps), do=out[0], ho=out[1],
                  wo=out[2], sd=stride[0], sh=stride[1], sw=stride[2],
                  nb=box[0], db=box[1], hb=box[2], wb=box[3], cw=cw, bn=bn,
                  tiles_n=tiles[0], tiles_d=tiles[1], tiles_h=tiles[2],
                  tiles_w=tiles[3], n_tiles=n_tiles, chunks=chunks,
                  osn=out_strides[0], osk=out_strides[1],
                  osd=out_strides[2], osh=out_strides[3], osw=out_strides[4],
                  out_bytes=out_bytes)
    vector = tuple(fields[f] for f in PLAN_FIELDS) + tuple(
        v for off in offsets for v in off)
    return dict(box=box, tiles=tiles, bn=bn, n_tiles=n_tiles, cw=cw,
                chunks=chunks, tap_offsets=offsets, out_shape=out,
                stride=tuple(stride), vector=vector)


def _bind(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _entry(name: str):
    with _lock:
        fn = _entries.get(name)
        if fn is None:
            lib = build.load(SOURCE)
            _entries["quantize_act"] = _bind(
                lib, "echoscene_quantize_act",
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p])
            _entries["int8_conv3d"] = _bind(
                lib, "echoscene_int8_conv3d",
                [ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_longlong),
                                         ctypes.c_int, ctypes.c_void_p])
            _entries["quantize_amax"] = _bind(
                lib, "echoscene_quantize_amax",
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                 ctypes.c_void_p, ctypes.c_void_p])
            _entries["quantize_with_amax"] = _bind(
                lib, "echoscene_quantize_with_amax",
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p])
            _entries["int8_conv3d_acc"] = _bind(
                lib, "echoscene_int8_conv3d_acc",
                [ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_longlong),
                                         ctypes.c_int, ctypes.c_void_p])
            fn = _entries[name]
        return fn


def _count(name: str) -> None:
    with _lock:
        LAUNCHES[name] += 1


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _check_act(x: torch.Tensor) -> None:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quantize_act takes bf16 or f32, got {x.dtype}")
    if x.dim() < 2 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"quantize_act needs a contiguous, non-empty (N, C, "
                         f"...) tensor, got shape {tuple(x.shape)}")


def _act_outputs(x: torch.Tensor):
    n, c = x.shape[:2]
    q = torch.empty((n,) + tuple(x.shape[2:]) + (padded_channels(c),),
                    dtype=torch.int8, device=x.device)
    scale = torch.empty(1, dtype=torch.float32, device=x.device)
    return n, c, x.numel() // (n * c), q, scale


def quantize_act(x: torch.Tensor, eps: float = EPS
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Q1: x (N, C, *spatial) bf16 or f32, channel-first -> (q (N, *spatial,
    Cp) int8, channels-last, zeros past C; scale (1,) f32 on x's device).
    CUDA: the kernel (x must be contiguous); CPU: `quantize_plain`."""
    if x.device.type == "cpu":
        return quantize_plain(x, eps)
    _check_act(x)
    n, c, s, q, scale = _act_outputs(x)
    amax = torch.empty(1, dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _entry("quantize_act")(
            x.data_ptr(), int(x.dtype == torch.bfloat16), n, c, s,
            q.shape[-1], amax.data_ptr(), eps, q.data_ptr(),
            scale.data_ptr(), stream)
    _raise_on_error("quantize_act", err)
    _count("quantize_act")
    return q, scale


def quantize_amax(x: torch.Tensor) -> torch.Tensor:
    """Q1's first pass: x (N, C, *spatial) bf16 or f32 -> its abs-max word,
    a (1,) int32 tensor on x's device holding max |x| as a non-negative
    f32's bits.  CUDA: the kernel's pass (x must be contiguous); CPU:
    `quantize_amax_plain`."""
    if x.device.type == "cpu":
        return quantize_amax_plain(x)
    _check_act(x)
    amax = torch.empty(1, dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _entry("quantize_amax")(
            x.data_ptr(), int(x.dtype == torch.bfloat16), x.numel(),
            amax.data_ptr(), stream)
    _raise_on_error("quantize_amax", err)
    _count("quantize_amax")
    return amax


def quantize_with_amax(x: torch.Tensor, amax: torch.Tensor, eps: float = EPS
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Q1's second pass: x as `quantize_act` takes it, quantized with the
    scale of the abs-max word `amax` ((1,) int32 on x's device, from
    `quantize_amax` or a MAX of several) -> (q, scale) as `quantize_act`
    gives them.  CUDA: the kernel's pass; CPU: `quantize_with_amax_plain`."""
    if x.device.type == "cpu":
        return quantize_with_amax_plain(x, amax, eps)
    _check_act(x)
    if (amax.device != x.device or amax.dtype != torch.int32
            or amax.numel() != 1):
        raise ValueError(f"amax must be one int32 word on {x.device}, got "
                         f"{amax.dtype} {tuple(amax.shape)} on {amax.device}")
    n, c, s, q, scale = _act_outputs(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _entry("quantize_with_amax")(
            x.data_ptr(), int(x.dtype == torch.bfloat16), n, c, s,
            q.shape[-1], amax.data_ptr(), eps, q.data_ptr(),
            scale.data_ptr(), stream)
    _raise_on_error("quantize_with_amax", err)
    _count("quantize_with_amax")
    return q, scale


def _check_conv(xq, wq, x_scale, w_scale, bias, out,
                out_dtype=torch.bfloat16) -> None:
    dev = xq.device
    for name, t, dtype, dims in (("xq", xq, torch.int8, 5),
                                 ("wq", wq, torch.int8, 5),
                                 ("x_scale", x_scale, torch.float32, 1),
                                 ("w_scale", w_scale, torch.float32, 1),
                                 ("bias", bias, torch.float32, 1)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, xq on {dev}")
        if t.dtype != dtype or t.dim() != dims or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dims}-d {dtype} "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    cp, k = xq.shape[-1], wq.shape[0]
    if cp % CHANNEL_ALIGN or wq.shape[-1] != cp:
        raise ValueError(f"xq / wq channels {cp} / {wq.shape[-1]}: must agree"
                         f" and be a multiple of {CHANNEL_ALIGN}")
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("xq and wq must be 16-byte aligned")
    if (x_scale is not None and x_scale.numel() != 1) or (
            w_scale is not None and w_scale.numel() != k) or (
            bias is not None and bias.numel() != k):
        raise ValueError("x_scale must hold 1 value, w_scale and bias K")
    if out.dtype != out_dtype or out.device != dev:
        raise ValueError(f"out must be {out_dtype} on {dev}, got {out.dtype} "
                         f"on {out.device}")


def int8_conv3d(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                stride: Sequence[int] = (1, 1, 1),
                pads: Sequence[Tuple[int, int]] = ((1, 1),) * 3,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Q2: xq (N, D, H, W, Cp) int8 (Q1's layout), wq (K, kd, kh, kw, Cp)
    int8, x_scale (1,), w_scale (K,), bias (K,) or None, f32; stride and
    per-side pads ((front, back) per axis) -> (N, K, Do, Ho, Wo) bf16,
    written into `out` (any strides, e.g. a parity's view) when given.
    CUDA: the kernel; CPU: `int8_conv3d_plain`."""
    n, d, h, w, _ = xq.shape
    k = wq.shape[0]
    osize = output_size((d, h, w), wq.shape[1:4], stride, pads)
    if out is None:
        out = torch.empty((n, k) + osize, dtype=torch.bfloat16,
                          device=xq.device)
    if tuple(out.shape) != (n, k) + osize:
        raise ValueError(f"out has shape {tuple(out.shape)}, want "
                         f"{(n, k) + osize}")
    if xq.device.type == "cpu":
        return int8_conv3d_plain(xq, wq, x_scale, w_scale, bias, stride,
                                 pads, out)
    _check_conv(xq, wq, x_scale, w_scale, bias, out)
    plan = conv_plan(n, (d, h, w), xq.shape[-1], k, tuple(wq.shape[1:4]),
                     tuple(stride), tuple(tuple(p) for p in pads),
                     tuple(out.stride()))
    vector = (ctypes.c_longlong * len(plan["vector"]))(*plan["vector"])
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    with torch.cuda.device(xq.device):
        err = _entry("int8_conv3d")(
            xq.data_ptr(), wq.data_ptr(), x_scale.data_ptr(),
            w_scale.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), vector, len(vector), stream)
    _raise_on_error("int8_conv3d", err)
    _count("int8_conv3d")
    return out


def int8_conv3d_acc(xq: torch.Tensor, wq: torch.Tensor,
                    stride: Sequence[int] = (1, 1, 1),
                    pads: Sequence[Tuple[int, int]] = ((1, 1),) * 3,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Q2's int32 accumulators: xq, wq, stride and pads as `int8_conv3d`
    takes them -> (N, K, Do, Ho, Wo) int32 (no dequantize, no bias), into
    `out` (any strides) when given.  CUDA: the kernel with its int32
    epilogue; CPU: `int8_conv3d_acc_plain`."""
    n, d, h, w, _ = xq.shape
    k = wq.shape[0]
    osize = output_size((d, h, w), wq.shape[1:4], stride, pads)
    if out is None:
        out = torch.empty((n, k) + osize, dtype=torch.int32,
                          device=xq.device)
    if tuple(out.shape) != (n, k) + osize:
        raise ValueError(f"out has shape {tuple(out.shape)}, want "
                         f"{(n, k) + osize}")
    if xq.device.type == "cpu":
        return int8_conv3d_acc_plain(xq, wq, stride, pads, out)
    _check_conv(xq, wq, None, None, None, out, torch.int32)
    plan = conv_plan(n, (d, h, w), xq.shape[-1], k, tuple(wq.shape[1:4]),
                     tuple(stride), tuple(tuple(p) for p in pads),
                     tuple(out.stride()), out_bytes=4)
    vector = (ctypes.c_longlong * len(plan["vector"]))(*plan["vector"])
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    with torch.cuda.device(xq.device):
        err = _entry("int8_conv3d_acc")(
            xq.data_ptr(), wq.data_ptr(), out.data_ptr(), vector, len(vector),
            stream)
    _raise_on_error("int8_conv3d_acc", err)
    _count("int8_conv3d_acc")
    return out


def quantize_bound(numel: int, elem_bytes: int, out_bytes: int) -> Dict:
    """The least time one H100 could take for Q1: read x once, write q
    once (bytes at 3.35 TB/s; its operations are a few a byte)."""
    nbytes = numel * elem_bytes + out_bytes + 4
    ms = nbytes / PEAK_BYTES * 1e3
    return {"ms": ms, "bound_by": "bytes", "bytes": nbytes, "bytes_ms": ms}


def int8_conv_bound(n: int, in_spatial: Sequence[int], c_in: int, cp: int,
                    k: int, taps: Sequence[int], out_spatial: Sequence[int],
                    has_bias: bool, out_bytes: int = 2) -> Dict:
    """The least time one H100 could take for Q2: the larger of its 2 M K
    taps C_in operations (M the output positions, C_in the real input
    channels) at 1,979 TOP/s (dense int8) and the bytes of reading xq
    (Cp channels), wq, the scales and bias once and writing the output
    (bf16, or `out_bytes` 4: the int32 accumulators, no scales or bias)
    once at 3.35 TB/s."""
    m = n * math.prod(out_spatial)
    t = math.prod(taps)
    ops = 2 * m * k * t * c_in
    scales = 4 * (1 + k + (k if has_bias else 0)) if out_bytes == 2 else 0
    nbytes = (n * math.prod(in_spatial) * cp + k * t * cp + scales
              + out_bytes * m * k)
    times = {"operations": ops / PEAK_INT8_OPS * 1e3,
             "bytes": nbytes / PEAK_BYTES * 1e3}
    by = max(times, key=times.get)
    return {"ms": times[by], "bound_by": by, "ops": ops, "bytes": nbytes,
            "ops_ms": times["operations"], "bytes_ms": times["bytes"]}


def torso_conv_sites(denoiser_cfg, rows: int) -> Tuple[list, int]:
    """The int8 convolutions of one shape-denoiser call of the int8 twin
    (`sample_dtype: int8`, factored upsamples), from its config (image
    size, channels, channel_mult, num_res_blocks) at `rows` rows, in call
    order, merged by shape: a list of dicts (`x_shape` (N, C, D, H, W), `k`,
    `taps`, `stride`, `pads`, `bias`, `x_dtype` "float32" for conv_in, else
    "bfloat16", `calls` per denoiser call and `row_split_calls`, those of
    them that are a ResBlock's `out_layers.3`, the convolution tensor
    parallelism splits on its input channels), and the number of Q1
    launches per call (one per Int8Conv3d, one per factored upsample)."""
    sd = denoiser_cfg
    mc = sd.model_channels
    mult = tuple(sd.channel_mult)
    r = sd.image_size
    sites: Dict[tuple, Dict] = {}
    q1 = 0

    def add(name, c_in, k, spatial, taps=(3, 3, 3), stride=(1, 1, 1),
            pads=((1, 1),) * 3, bias=True, x_dtype="bfloat16",
            row_split=False):
        key = (c_in, k, spatial, taps, stride, pads, bias, x_dtype)
        if key not in sites:
            sites[key] = dict(name=name, x_shape=(rows, c_in) + spatial, k=k,
                              taps=taps, stride=stride, pads=pads, bias=bias,
                              x_dtype=x_dtype, calls=0, row_split_calls=0)
        sites[key]["calls"] += 1
        sites[key]["row_split_calls"] += int(row_split)

    def res(c_in, c_out, spatial):
        nonlocal q1
        add(f"ResBlock in {c_in}->{c_out}", c_in, c_out, spatial)
        add(f"ResBlock out {c_out}", c_out, c_out, spatial, row_split=True)
        q1 += 2
        if c_in != c_out:
            add(f"skip 1x1x1 {c_in}->{c_out}", c_in, c_out, spatial,
                taps=(1, 1, 1), pads=((0, 0),) * 3)
            q1 += 1

    spatial = (r, r, r)
    add("conv_in", sd.in_channels, mc, spatial, x_dtype="float32")
    q1 += 1
    chans, ch = [mc], mc
    for level, m in enumerate(mult):
        for _ in range(sd.num_res_blocks):
            res(ch, m * mc, spatial)
            ch = m * mc
            chans.append(ch)
        if level != len(mult) - 1:
            add(f"Downsample {ch}", ch, ch, spatial, stride=(1, 2, 2))
            q1 += 1
            spatial = (spatial[0], spatial[1] // 2, spatial[2] // 2)
            chans.append(ch)
    res(ch, ch, spatial)
    res(ch, ch, spatial)
    for level, m in reversed(list(enumerate(mult))):
        for i in range(sd.num_res_blocks + 1):
            res(ch + chans.pop(), m * mc, spatial)
            ch = m * mc
            if level and i == sd.num_res_blocks:
                q1 += 1
                for rh in (0, 1):
                    for rw in (0, 1):
                        add(f"Upsample {ch} parity ({rh}, {rw})", ch, ch,
                            spatial, taps=(3, 2, 2),
                            pads=((1, 1), ((1, 0), (0, 1))[rh],
                                  ((1, 0), (0, 1))[rw]), bias=False)
                spatial = (spatial[0], spatial[1] * 2, spatial[2] * 2)
    add("conv_out", mc, sd.out_channels, spatial)
    q1 += 1
    return list(sites.values()), q1
