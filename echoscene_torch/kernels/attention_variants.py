"""Design check of the attention kernel on the card: each variant undoes one
design choice of `csrc/flash_attention.cu` and is timed beside the kernel.

    python -m echoscene_torch.kernels.attention_variants [--rounds N]

A variant is the kernel's source with a few textual edits, built by nvcc
with `build.NVCC_FLAGS` into `build/kernels/variants/` (all variants at
once) and loaded through ctypes.  Each is held to `error_ratios` against
`attention_plain` (except the diagnostics, whose output is wrong by
design), then timed with CUDA events at the two main-path shapes and one
D = 128 shape, all variants in turns, N rounds.  Prints one line per
measurement and, last, a JSON object with the median over the rounds.
Needs a CUDA card and nvcc; no path of the port runs it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from typing import Dict, List, Tuple

from . import build
from . import flash_attention as fa

SHAPES = [(42, 1024, 8, 56), (8, 4096, 1, 256), (9, 2048, 2, 128)]
VARIANT_DIR = os.path.join(build.BUILD_DIR, "variants")

_EX2_POLY = r'''
// 2^x for x <= 0 on the FMA pipes: x = i + f, i = rint(x), f in [-0.5, 0.5];
// 2^f by a degree-5 minimax polynomial (relative error 2.3e-7 in f32, as
// ex2.approx); i added to the exponent bits
__device__ __forceinline__ float ex2_poly(float x) {
  x = fmaxf(x, -126.0f);
  const float t = x + 12582912.0f;  // 1.5 * 2^23: rint(x) in the low bits
  const float f = x - (t - 12582912.0f);
  float p = 0.001327647129073739f;
  p = fmaf(p, f, 0.009675540961325169f);
  p = fmaf(p, f, 0.05550713092088699f);
  p = fmaf(p, f, 0.24022120237350464f);
  p = fmaf(p, f, 0.6931469440460205f);
  p = fmaf(p, f, 1.0000001192092896f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}

'''
_EXP = "const float p = ex2(fmaf(s[i], scale_log2, neg_m[r]));"


def _wgmma_ss(n: int) -> str:
    """Source of `wgmma_ss_n<n>`, the SS score product for N = n."""
    regs = n // 2
    outs = ", ".join(f"%{i}" for i in range(regs))
    cons = ", ".join(f'"+f"(d[{i}])' for i in range(regs))
    return (f"__device__ __forceinline__ void wgmma_ss_n{n}(float (&d)[{regs}], "
            f"uint64_t da, uint64_t db, int scale_d) {{\n"
            f'  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 2}, 0;\\n"\n'
            f'      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 '
            f'{{{outs}}}, %{regs}, %{regs + 1}, p, 1, 1, 0, 0;\\n}}\\n"\n'
            f'      : {cons}\n      : "l"(da), "l"(db), "r"(scale_d));\n}}\n\n')


def _poly(every: int) -> List[Tuple[str, str]]:
    return [("// ---- the kernel", _EX2_POLY + "// ---- the kernel"),
            (_EXP, "const float x_ = fmaf(s[i], scale_log2, neg_m[r]); "
                   f"const float p = (i % {every} == {every - 1}) ? "
                   "ex2_poly(x_) : ex2(x_);")]


# name -> (what it undoes, [(text in the kernel's source, replacement)])
VARIANTS: Dict[str, Tuple[str, List[Tuple[str, str]]]] = {
    "no_pingpong": ("the consumers issue their products without taking "
                    "turns", [
        ("    if (wg == 1) named_arrive(1, 256);  // warpgroup 0 goes first\n",
         ""),
        ("        if (wg == 0 || !last_work) named_arrive(other_turn, 256);\n",
         ""),
        ("        named_sync(my_turn, 256);\n", ""),
        ("      named_sync(my_turn, 256);\n", ""),
        ("        named_arrive(other_turn, 256);\n", ""),
        ("      named_arrive(other_turn, 256);\n", "")]),
    "not_persistent": ("one CTA per work tile instead of one per SM", [
        ("const int grid = static_cast<int>(n_work < sms ? n_work : sms);",
         "const int grid = static_cast<int>(n_work);")]),
    "d256_block_n_64": ("64-key tiles at D_pad 256 instead of 80", [
        ("template <int N>\n__device__ __forceinline__ void wgmma_ss(",
         _wgmma_ss(64) + "template <int N>\n"
                         "__device__ __forceinline__ void wgmma_ss("),
        ('  static_assert(N == 80 || N == 128, "no wgmma wrapper for this '
         'BLOCK_N");\n  if constexpr (N == 80)',
         "  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);\n"
         "  else if constexpr (N == 80)"),
        ("launch<256, 80, 1>(", "launch<256, 64, 1>(")]),
    "exp2_poly_1_in_8": ("1 in 8 exponentials on the FMA pipes (degree-5 "
                         "polynomial) instead of the SFU", _poly(8)),
    "exp2_poly_1_in_4": ("1 in 4 exponentials on the FMA pipes", _poly(4)),
    "no_exp2": ("diagnostic: no exponential at all (wrong output): what "
                "the SFU work costs", [
        (_EXP, "const float p = fmaf(s[i], scale_log2, neg_m[r]);")]),
    "no_softmax": ("diagnostic: no softmax at all, P = S (wrong output): "
                   "what the products and the pipeline cost alone", [
        ("                                               int t) {\n"
         "  if (n0 + BLOCK_N > S) {",
         "                                               int t) {\n"
         "  alpha[0] = alpha[1] = l[0] = l[1] = 1.0f;\n  return;\n"
         "  if (n0 + BLOCK_N > S) {")]),
    "no_kv_stream": ("diagnostic: each CTA loads the K/V ring once and "
                     "reuses it (wrong output): what streaming K and V from "
                     "L2 costs", [
        (f"          mbar_expect_tx({x}_full + 8 * st, T::kKVBytes);\n",
         f"          if (kv >= kStages) {{\n"
         f"            mbar_arrive({x}_full + 8 * st);\n"
         f"          }} else {{\n"
         f"          mbar_expect_tx({x}_full + 8 * st, T::kKVBytes);\n")
        for x in "kv"] + [
        (f"{x}_full + 8 * st, c * kSubCols, h, n0, b);\n",
         f"{x}_full + 8 * st, c * kSubCols, h, n0, b);\n          }}\n")
        for x in "kv"]),
}
DIAGNOSTICS = ("no_exp2", "no_softmax", "no_kv_stream")  # wrong by design


def variant_sources() -> Dict[str, str]:
    with open(os.path.join(build.CSRC_DIR, fa.SOURCE)) as f:
        src = f.read()
    out = {}
    for name, (_, edits) in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: the kernel's source no "
                                   f"longer has {old[:60]!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_variants() -> Dict[str, ctypes.CDLL]:
    """Compile every variant (one nvcc each, all at once) and load it."""
    os.makedirs(VARIANT_DIR, exist_ok=True)
    procs = {}
    for name, text in variant_sources().items():
        cu = os.path.join(VARIANT_DIR, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(VARIANT_DIR, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, failed = {}, []
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{name}:\n{log[-3000:]}")
            continue
        notes = [line.strip() for line in log.splitlines()
                 if "spill" in line or "Performance Loss" in line]
        print(f"built {name}: {' | '.join(notes[:4])}")
        libs[name] = ctypes.CDLL(lib)
    if failed:
        raise RuntimeError("nvcc failed on variants\n" + "\n".join(failed))
    return libs


def _bind(lib: ctypes.CDLL):
    fn = lib.echoscene_onepass_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_variants: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    build.load(fa.SOURCE)
    fns = {"kernel": fa._entry("onepass_attention")}
    fns.update({name: _bind(lib) for name, lib in build_variants().items()})

    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {s: [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(3)] for s in SHAPES}

    def call(fn, q, k, v):
        b, l, h, d = q.shape
        o = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h,
                 l, k.shape[1], d, d ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return o

    def cuda_ms(fn, iters=30):
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    for s in SHAPES:
        ref = fa.attention_plain(*data[s])
        for name, fn in fns.items():
            ratios = fa.error_ratios(call(fn, *data[s]), ref)
            ok = max(ratios) <= 1.0
            if not ok and name not in DIAGNOSTICS:
                raise RuntimeError(f"{name} at {s}: error at {ratios} of the "
                                   f"limits")
            print(f"check {name} {s}: max / mean err at {ratios[0]:.3f} / "
                  f"{ratios[1]:.3f} of the limits")
    times: Dict[str, Dict[str, List[float]]] = {
        name: {str(s): [] for s in SHAPES} for name in [*fns, "sdpa"]}
    for rnd in range(args.rounds):
        for s in SHAPES:
            q, k, v = data[s]
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            times["sdpa"][str(s)].append(cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt)))
            for name, fn in fns.items():
                times[name][str(s)].append(
                    cuda_ms(lambda: call(fn, q, k, v)))
        for name in times:
            print(f"round {rnd} {name}: " + ", ".join(
                f"{s} {times[name][s][-1]:.4f} ms" for s in times[name]))
    print(json.dumps({"card": card, "rounds": args.rounds,
                      "what": {n: d for n, (d, _) in VARIANTS.items()},
                      "median_ms": {n: {s: statistics.median(t)
                                        for s, t in ts.items()}
                                    for n, ts in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
