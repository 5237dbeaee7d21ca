"""The yardstick's peaks and bound functions, frozen here so that a change
to the program cannot move them.

Copies of `echoscene_torch/kernels/flash_attention.py` `attention_bound` /
`attention_backward_bound` (bf16) and `echoscene_torch/kernels/int8_conv.py`
`quantize_bound` / `int8_conv_bound` / `torso_conv_sites`.  Peaks: one
NVIDIA H100 SXM at its full 700 W power limit (NVIDIA's data sheet, dense
rates): 989 TFLOP/s bf16, 1,979 TOP/s int8, 3.35 TB/s of HBM3; the SFU's
exp2 at 132 SMs x 16 a clock at 1.98 GHz.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
NUM_SMS = 132
EXP2_PER_SM_CLOCK = 16
MAX_SM_CLOCK_HZ = 1.98e9
CHANNEL_ALIGN = 32


def _exp2_ms(exps: float) -> float:
    return exps / (NUM_SMS * EXP2_PER_SM_CLOCK * MAX_SM_CLOCK_HZ) * 1e3


def attention_bound(b: int, l: int, h: int, d: int, s: int = None) -> Dict:
    """Least time of bf16 softmax(q k^T) v, q (b, l, h, d), k / v (b, s, h,
    d): the largest of its 4 b h l s d flops at 989 TFLOP/s, its b h l s
    exponentials on the SFU, and reading q, k, v and writing o once."""
    s = l if s is None else s
    flops = 4 * b * h * l * s * d
    nbytes = 2 * (2 * b * l * h * d + 2 * b * s * h * d)
    times = {"tensor_core": flops / PEAK_BF16_FLOPS * 1e3,
             "exp2": _exp2_ms(b * h * l * s),
             "bytes": nbytes / PEAK_BYTES * 1e3}
    by = max(times, key=times.get)
    return {"ms": times[by], "by": by, "flops": flops, "bytes": nbytes}


def attention_backward_bound(b: int, l: int, h: int, d: int,
                             s: int = None) -> Dict:
    """Least time of the bf16 attention backward: its 5 products' 10 b h l
    s d flops, its b h l s exponentials, and reading q, k, v, o, do (bf16)
    and lse (f32) once and writing dq, dk, dv once."""
    s = l if s is None else s
    flops = 10 * b * h * l * s * d
    nbytes = (2 * (3 * b * l * h * d + 2 * b * s * h * d) + 4 * b * h * l
              + 2 * (b * l * h * d + 2 * b * s * h * d))
    times = {"tensor_core": flops / PEAK_BF16_FLOPS * 1e3,
             "exp2": _exp2_ms(b * h * l * s),
             "bytes": nbytes / PEAK_BYTES * 1e3}
    by = max(times, key=times.get)
    return {"ms": times[by], "by": by, "flops": flops, "bytes": nbytes}


def padded_channels(c: int) -> int:
    return -(-c // CHANNEL_ALIGN) * CHANNEL_ALIGN


def quantize_bound(numel: int, elem_bytes: int, out_bytes: int) -> Dict:
    """Least time of Q1: read x once, write the int8 tensor (and its scale)
    once."""
    nbytes = numel * elem_bytes + out_bytes + 4
    return {"ms": nbytes / PEAK_BYTES * 1e3, "by": "bytes", "bytes": nbytes}


def int8_conv_bound(n: int, in_spatial: Sequence[int], c_in: int, cp: int,
                    k: int, taps: Sequence[int], out_spatial: Sequence[int],
                    has_bias: bool) -> Dict:
    """Least time of Q2 with a bf16 output: the larger of its 2 M K taps
    C_in operations at 1,979 TOP/s and the bytes of reading xq (Cp
    channels), wq, the scales and bias once and writing the output once."""
    m = n * math.prod(out_spatial)
    t = math.prod(taps)
    ops = 2 * m * k * t * c_in
    nbytes = (n * math.prod(in_spatial) * cp + k * t * cp
              + 4 * (1 + k + (k if has_bias else 0)) + 2 * m * k)
    times = {"operations": ops / PEAK_INT8_OPS * 1e3,
             "bytes": nbytes / PEAK_BYTES * 1e3}
    by = max(times, key=times.get)
    return {"ms": times[by], "by": by, "ops": ops, "bytes": nbytes}


def torso_conv_sites(unet: Dict, rows: int) -> Tuple[List[Dict], List[Dict]]:
    """The W8A8 convolutions of one shape-denoiser call (the configuration's
    `shape_branch.unet`, factored upsamples) at `rows` rows, merged by shape
    (`x_shape`, `k`, `taps`, `stride`, `pads`, `bias`, `x_bytes`, `calls`),
    and the Q1 inputs of the call ({`numel`, `x_bytes`, `cp`}, one an
    Int8Conv3d call; a factored upsample's four parities share one)."""
    mc, mult, r = unet["model_channels"], unet["channel_mult"], \
        unet["image_size"]
    sites: Dict[tuple, Dict] = {}
    q1: List[Dict] = []

    def quant(c_in, spatial, x_bytes=2):
        q1.append({"numel": rows * c_in * math.prod(spatial),
                   "x_bytes": x_bytes,
                   "out_bytes": rows * math.prod(spatial)
                   * padded_channels(c_in)})

    def add(c_in, k, spatial, taps=(3, 3, 3), stride=(1, 1, 1),
            pads=((1, 1),) * 3, bias=True, x_bytes=2):
        key = (c_in, k, spatial, taps, stride, pads, bias, x_bytes)
        if key not in sites:
            sites[key] = dict(x_shape=(rows, c_in) + spatial, k=k, taps=taps,
                              stride=stride, pads=pads, bias=bias,
                              x_bytes=x_bytes, calls=0)
        sites[key]["calls"] += 1

    def res(c_in, c_out, spatial):
        add(c_in, c_out, spatial)
        quant(c_in, spatial)
        add(c_out, c_out, spatial)
        quant(c_out, spatial)
        if c_in != c_out:
            add(c_in, c_out, spatial, taps=(1, 1, 1), pads=((0, 0),) * 3)
            quant(c_in, spatial)

    spatial = (r, r, r)
    add(unet["in_channels"], mc, spatial, x_bytes=4)
    quant(unet["in_channels"], spatial, x_bytes=4)
    chans, ch = [mc], mc
    for level, m in enumerate(mult):
        for _ in range(unet["num_res_blocks"]):
            res(ch, m * mc, spatial)
            ch = m * mc
            chans.append(ch)
        if level != len(mult) - 1:
            add(ch, ch, spatial, stride=(1, 2, 2))
            quant(ch, spatial)
            spatial = (spatial[0], spatial[1] // 2, spatial[2] // 2)
            chans.append(ch)
    res(ch, ch, spatial)
    res(ch, ch, spatial)
    for level, m in reversed(list(enumerate(mult))):
        for i in range(unet["num_res_blocks"] + 1):
            res(ch + chans.pop(), m * mc, spatial)
            ch = m * mc
            if level and i == unet["num_res_blocks"]:
                quant(ch, spatial)
                for rh in (0, 1):
                    for rw in (0, 1):
                        add(ch, ch, spatial, taps=(3, 2, 2),
                            pads=((1, 1), ((1, 0), (0, 1))[rh],
                                  ((1, 0), (0, 1))[rw]), bias=False)
                spatial = (spatial[0], spatial[1] * 2, spatial[2] * 2)
    add(mc, unet["out_channels"], spatial)
    quant(mc, spatial)
    return list(sites.values()), q1


def output_size(size: Sequence[int], taps: Sequence[int],
                stride: Sequence[int], pads) -> Tuple[int, ...]:
    return tuple((n + p[0] + p[1] - t) // s + 1
                 for n, t, s, p in zip(size, taps, stride, pads))


def torso_step_bound_ms(unet: Dict, rows: int) -> Dict:
    """Q1's and Q2's bounds summed over one shape-denoiser call: ms of each
    and the int8 operations of the call."""
    sites, q1 = torso_conv_sites(unet, rows)
    q2_ms = ops = 0.0
    for s in sites:
        n, c_in = s["x_shape"][:2]
        spatial = s["x_shape"][2:]
        b = int8_conv_bound(n, spatial, c_in, padded_channels(c_in), s["k"],
                            s["taps"], output_size(spatial, s["taps"],
                                                   s["stride"], s["pads"]),
                            s["bias"])
        q2_ms += s["calls"] * b["ms"]
        ops += s["calls"] * b["ops"]
    q1_ms = sum(quantize_bound(q["numel"], q["x_bytes"],
                               q["out_bytes"])["ms"] for q in q1)
    return {"q1_ms": q1_ms, "q2_ms": q2_ms, "int8_ops": ops,
            "q2_calls": sum(s["calls"] for s in sites), "q1_calls": len(q1)}
