"""Design check of the attention kernels on the card: each variant undoes one
design choice of `csrc/flash_attention.cu` (bf16) or, with --f32, of
`csrc/flash_attention_tf32x3.cu` (f32, 3xTF32) and is timed beside the
kernel.

    python -m echoscene_torch.kernels.attention_variants [--rounds N] [--f32]

A variant is the kernel's source with a few textual edits, built by nvcc
with `build.NVCC_FLAGS` into `build/kernels/variants/` (all variants at
once) and loaded through ctypes.  Each is held to `error_ratios` against
`attention_plain` (except the diagnostics, whose output is wrong by
design), then timed with CUDA events at the two main-path shapes and one
D = 128 shape, all variants in turns, N rounds.  Prints one line per
measurement and, last, a JSON object with the median over the rounds.
Needs a CUDA card and nvcc; no path of the port runs it.

Also here, run by the CPU tests and by no path: `tf32_round` and
`attention_tf32x3_emulated`, a plain PyTorch emulation of the arithmetic of
the f32 kernel `csrc/flash_attention_tf32x3.cu` (3xTF32 products on the
tensor cores, online softmax over key tiles).
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

import torch

from . import build
from . import flash_attention as fa

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 explicit mantissa bits), ties away
    from zero, as `cvt.rna.tf32.f32`: add half of the 13 dropped bits to
    the magnitude and clear them (a carry runs into the exponent;
    subnormals and zero keep their form)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor, products: int):
    hi = tf32_round(x)
    return hi, (tf32_round(x - hi) if products == 3 else None)


def _mma(a, b, eq: str, products: int) -> torch.Tensor:
    """One f32-accumulated product of split operands: a_lo b_hi + a_hi b_lo
    + a_hi b_hi (small terms first, as the kernel issues them), or a_hi
    b_hi alone for `products` = 1.  Each TF32 x TF32 product is exact in
    f32."""
    (a_hi, a_lo), (b_hi, b_lo) = a, b
    out = torch.einsum(eq, a_hi, b_hi)
    if products == 3:
        out = (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
               ) + out
    return out


def attention_tf32x3_emulated(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, block_n: int = 64,
                              products: int = 3) -> torch.Tensor:
    """softmax(q k^T D^-1/2) v for f32 q (B, L, H, D), k, v (B, S, H, D) by
    the f32 kernel's arithmetic: q, k, v split into TF32 hi + lo parts
    (`tf32_round`); per tile of `block_n` keys the scores from three TF32
    products, an online softmax in the log2 domain (running max and sum),
    the probabilities split in the same way and O += P V from three
    products; O / l at the end.  `products` = 1 keeps the hi x hi products
    only (plain TF32), which the f32 limits reject."""
    d = q.shape[-1]
    scale_log2 = d ** -0.5 * 1.4426950408889634
    qs, ks, vs = (_split(x.float().transpose(1, 2), products)
                  for x in (q, k, v))                      # (B, H, *, D)
    b, h, l, _ = qs[0].shape
    m = torch.full((b, h, l, 1), -torch.inf, device=q.device)
    s_sum = torch.zeros((b, h, l, 1), device=q.device)
    o = torch.zeros((b, h, l, d), device=q.device)
    for n0 in range(0, k.shape[1], block_n):
        kt = tuple(None if x is None else x[:, :, n0:n0 + block_n]
                   for x in ks)
        vt = tuple(None if x is None else x[:, :, n0:n0 + block_n]
                   for x in vs)
        s = _mma(qs, kt, "bhld,bhsd->bhls", products)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new)
        s_sum = s_sum * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _mma(_split(p, products), vt, "bhls,bhsd->bhld",
                             products)
        m = m_new
    return (o / s_sum).transpose(1, 2).contiguous()


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

F32_SHAPES = [(42, 1024, 8, 56), (8, 4096, 1, 256), (9, 2048, 2, 128)]
# the same for the f32 kernel
F32_VARIANTS: Dict[str, Tuple[str, List[Tuple[str, str]]]] = {
    "f32_no_combined_k": ("narrow key tiles run Q_hi K_hi and Q_hi K_lo as "
                          "two products (Q_hi read twice)", [
        ("static constexpr bool kCombineK = BLOCK_N <= 32;",
         "static constexpr bool kCombineK = false;")]),
    "f32_one_accumulator": ("P V of every key tile summed into one "
                            "accumulator, rescaled by alpha on the tensor "
                            "cores' side (D <= 128 only: at D_pad 256 the "
                            "accumulator holds half of O)", [
        ("          wgmma_rs<T::kPVN>(ot, term == 0 ? pl[kc] : ph[kc],\n"
         "                            dv[term == 1] + off, term > 0 || kc > 0);",
         "          wgmma_rs<T::kPVN>(ot, term == 0 ? pl[kc] : ph[kc],\n"
         "                            dv[term == 1] + off, 1);"),
        ("      a_pv[1] = alpha[1];\n",
         "      a_pv[1] = alpha[1];\n#pragma unroll\n"
         "      for (int i = 0; i < T::kPVN / 2; ++i) "
         "ot[i] *= alpha[(i >> 1) & 1];\n"),
        ("      for (int i = 0; i < D_PAD / 2; ++i) o[i] = 0.0f;\n",
         "      for (int i = 0; i < D_PAD / 2; ++i) o[i] = 0.0f;\n"
         "#pragma unroll\n"
         "      for (int i = 0; i < T::kPVN / 2; ++i) ot[i] = 0.0f;\n"),
        ("            fmaf(o[part * T::kPVN / 2 + i], a_pv[(i >> 1) & 1], "
         "ot[i]);", "            ot[i];")]),
}
F32_ONLY_UP_TO_D = {"f32_one_accumulator": 128}


def variant_sources(f32: bool = False) -> Dict[str, str]:
    with open(os.path.join(build.CSRC_DIR,
                           fa.SOURCE_F32 if f32 else fa.SOURCE)) as f:
        src = f.read()
    out = {}
    for name, (_, edits) in (F32_VARIANTS if f32 else VARIANTS).items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: the kernel's source no "
                                   f"longer has {old[:60]!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_variants(f32: bool = False) -> Dict[str, ctypes.CDLL]:
    """Compile every variant (one nvcc each, all at once) and load it."""
    os.makedirs(VARIANT_DIR, exist_ok=True)
    procs = {}
    for name, text in variant_sources(f32).items():
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


def _bind(lib: ctypes.CDLL, f32: bool = False):
    fn = getattr(lib, "echoscene_onepass_attention" + ("_f32" if f32 else ""))
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p] + [ctypes.c_void_p] * f32
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--f32", action="store_true",
                    help="the f32 (3xTF32) kernel's variants, on f32 inputs "
                         "(TF32 off for the yardsticks)")
    args = ap.parse_args(argv)
    f32 = args.f32
    dtype = torch.float32 if f32 else torch.bfloat16
    shapes = F32_SHAPES if f32 else SHAPES
    variants = F32_VARIANTS if f32 else VARIANTS
    diagnostics = tuple(F32_ONLY_UP_TO_D) if f32 else DIAGNOSTICS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        print("attention_variants: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    fns = {"kernel": fa._entry("onepass_attention", dtype)}
    fns.update({name: _bind(lib, f32)
                for name, lib in build_variants(f32).items()})

    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {s: [torch.randn(s, generator=gen, device="cuda").to(dtype)
                for _ in range(3)] for s in shapes}

    def runs(name, s):
        return s[-1] <= F32_ONLY_UP_TO_D.get(name, s[-1]) if f32 else True

    def call(fn, q, k, v):
        b, l, h, d = q.shape
        o = torch.empty_like(q)
        scratch = ([torch.empty(fa.f32_scratch_floats(b, h, d, k.shape[1]),
                                device=q.device)] if f32 else [])
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h,
                 l, k.shape[1], d, d ** -0.5,
                 torch.cuda.current_stream().cuda_stream,
                 *(x.data_ptr() for x in scratch))
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

    for s in shapes:
        ref = fa.attention_plain(*data[s])
        for name, fn in fns.items():
            if not runs(name, s):
                continue
            ratios = fa.error_ratios(call(fn, *data[s]), ref)
            ok = max(ratios) <= 1.0
            if not ok and name not in diagnostics:
                raise RuntimeError(f"{name} at {s}: error at {ratios} of the "
                                   f"limits")
            print(f"check {name} {s}: max / mean err at {ratios[0]:.3f} / "
                  f"{ratios[1]:.3f} of the limits")
    times: Dict[str, Dict[str, List[float]]] = {
        name: {str(s): [] for s in shapes if runs(name, s)}
        for name in [*fns, "sdpa"]}
    for rnd in range(args.rounds):
        for s in shapes:
            q, k, v = data[s]
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            times["sdpa"][str(s)].append(cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt)))
            for name, fn in fns.items():
                if runs(name, s):
                    times[name][str(s)].append(
                        cuda_ms(lambda: call(fn, q, k, v)))
        for name in times:
            print(f"round {rnd} {name}: " + ", ".join(
                f"{s} {times[name][s][-1]:.4f} ms" for s in times[name]))
    print(json.dumps({"card": card, "rounds": args.rounds,
                      "what": {n: d for n, (d, _) in variants.items()},
                      "median_ms": {n: {s: statistics.median(t)
                                        for s, t in ts.items()}
                                    for n, ts in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
