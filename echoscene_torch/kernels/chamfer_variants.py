"""Design check of the nearest-neighbour kernel K4 on the card: each variant
changes one design choice of `csrc/chamfer.cu` and is timed beside the
kernel.

    python -m echoscene_torch.kernels.chamfer_variants [--rounds N]

A variant is a kernel's source with a few textual edits, built by nvcc with
`build.NVCC_FLAGS` into `build/kernels/variants/` (all variants at once) and
loaded through ctypes; a variant may also launch with another
`chamfer.launch_plan`.  Each is held to `error_ratios` against the float64
plain version, and also to <= 1 ulp (`ulp_distance`), except
the diagnostics, whose output is wrong by design.  Then all are timed with
CUDA events at the path shapes, in turns with `cdist`^2 + min, N rounds.
Prints the SASS opcode counts of each variant's kernel (cuobjdump), one
line per measurement and, last, a JSON object with the median over the
rounds.  Needs a CUDA card and nvcc; no path of the port runs it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
from typing import Dict, List, Tuple

from . import build
from . import chamfer as k4

SHAPES = [(16, 5000, 5000), (8, 5000, 5000), (1, 5000, 5000)]
VARIANT_DIR = os.path.join(build.BUILD_DIR, "variants")
SLEEP_CYCLES = 5_000_000    # ~2.5 ms at the H100's clock: covers 30 calls

_MMA_16 = '''      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %8, %8};\\n"
      : "=d"(d[0]), "=d"(d[1]), "=d"(d[2]), "=d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b), "d"(c[0]), "d"(c[1]));'''
_MMA_8 = '''      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%4, %4};\\n"
      : "=d"(d[0]), "=d"(d[1])
      : "d"(a[0]), "d"(b), "d"(c[0]));'''

# double-buffered target tiles: pack_tile split into a load of the next
# tile's coordinates into registers, issued before the current tile is
# consumed, and the packing store after it
_PACK_HEAD = '''__device__ __forceinline__ void pack_tile(double* tile, const float* bb,
                                          int m0, int m_end, double cx,
                                          double cy, double cz) {
  float x[kPerThread], y[kPerThread], z[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int m = m0 + i * kThreads + threadIdx.x;
    const float* p = bb + 3 * static_cast<int64_t>(m < m_end ? m : m0);
    x[i] = p[0];
    y[i] = p[1];
    z[i] = p[2];
  }
'''
_PACK_HEAD_DB = '''struct Raw {
  float x[kPerThread], y[kPerThread], z[kPerThread];
};

__device__ __forceinline__ void load_raw(Raw& r, const float* bb, int m0,
                                         int m_end) {
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int m = m0 + i * kThreads + threadIdx.x;
    const float* p = bb + 3 * static_cast<int64_t>(m < m_end ? m : m0);
    r.x[i] = p[0];
    r.y[i] = p[1];
    r.z[i] = p[2];
  }
}

__device__ __forceinline__ void store_packed(double* tile, const Raw& r,
                                             int m0, int m_end, double cx,
                                             double cy, double cz) {
  const float *x = r.x, *y = r.y, *z = r.z;
'''
_LOOP_HEAD = '''    for (int m0 = m_begin; m0 < m_end; m0 += kTile) {
      const int len = min(kTile, m_end - m0);
      pack_tile(tile, bb, m0, m_end, cx, cy, cz);
      __syncthreads();
'''
_LOOP_HEAD_DB = '''    Raw raw;
    load_raw(raw, bb, m_begin, m_end);
    store_packed(tile[0], raw, m_begin, m_end, cx, cy, cz);
    __syncthreads();
    int stage = 0;
    for (int m0 = m_begin; m0 < m_end; m0 += kTile) {
      const int len = min(kTile, m_end - m0);
      const bool more = m0 + kTile < m_end;
      if (more) load_raw(raw, bb, m0 + kTile, m_end);
'''
_LOOP_TAIL = "      __syncthreads();   // this tile is consumed\n"
_LOOP_TAIL_DB = '''      if (more) {
        store_packed(tile[stage ^ 1], raw, m0 + kTile, m_end, cx, cy, cz);
      }
      stage ^= 1;
      __syncthreads();   // this tile is consumed, the next one stored
'''

_FOLD = ("#define FOLD(best, d0, d1) best = __vimin3_u32(best, key_of(d0), "
         "key_of(d1))")

_KEY = ("  return __funnelshift_l(static_cast<unsigned>(__double2loint(v)),\n"
        "                         static_cast<unsigned>(__double2hiint(v)), 3);")
_KEY_IMAD = ("  return __umulhi(static_cast<unsigned>(__double2loint(v)), 8u) +\n"
             "         (static_cast<unsigned>(__double2hiint(v)) << 3);")
_FOLD_MIXED = ("#define FOLD(best, d0, d1) best = __vimin3_u32(best, key_of(d0), "
               "__umulhi(static_cast<unsigned>(__double2loint(d1)), 8u) + "
               "(static_cast<unsigned>(__double2hiint(d1)) << 3))")


def first_grid_plan(b: int, n: int, m: int, sms: int, ctas_per_sm: int,
                    block_n: int = k4.BLOCK_N) -> k4.LaunchPlan:
    """The kernel's first grid, in `chamfer.launch_plan`'s terms: one CTA
    per row (batch entry, query tile) and chunk of targets, the targets
    split until `ctas_per_sm` CTAs per SM are launched."""
    query_tiles = -(-n // block_n)
    rows = query_tiles * b
    units = -(-m // k4.CHUNK_UNIT)
    want = min(-(-ctas_per_sm * sms // rows), units)
    s = want
    while True:
        chunk_units = -(-units // s)
        splits = -(-units // chunk_units)
        if splits >= want or s >= units:
            break
        s += 1
    return k4.LaunchPlan(query_tiles, splits * chunk_units, rows * splits,
                         splits > 1)


# name -> (what it changes, source, [(text in the source, replacement)],
#          launch_plan keywords, "planner" another plan function)
VARIANTS: Dict[str, Tuple[str, str, List[Tuple[str, str]], Dict]] = {
    "m8n8k4": ("mma.m8n8k4 (16 query blocks of 8) instead of m16n8k4",
               k4.SOURCE, [("constexpr int kMmaM = 16;",
                            "constexpr int kMmaM = 8;"),
                           ("constexpr int kBlocks = 8;",
                            "constexpr int kBlocks = 16;"),
                           (_MMA_16, _MMA_8)], {}),
    "blocks_2": ("2 query blocks per warp (32 queries) instead of 8",
                 k4.SOURCE, [("constexpr int kBlocks = 8;",
                              "constexpr int kBlocks = 2;")], {}),
    "blocks_4": ("4 query blocks per warp (64 queries) instead of 8",
                 k4.SOURCE, [("constexpr int kBlocks = 8;",
                              "constexpr int kBlocks = 4;")], {}),
    "blocks_6": ("6 query blocks per warp (96 queries) instead of 8",
                 k4.SOURCE, [("constexpr int kBlocks = 8;",
                              "constexpr int kBlocks = 6;")], {}),
    "regs_128": ("at most 128 registers a thread (4 CTAs per SM) instead "
                 "of ptxas's choice", k4.SOURCE,
                 [("__launch_bounds__(kThreads)\nnn_kernel",
                   "__launch_bounds__(kThreads, 4)\nnn_kernel")], {}),
    "warps_8": ("8 warps per CTA instead of 4", k4.SOURCE,
                [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")],
                {}),
    "tile_512": ("512-target shared tiles instead of 256", k4.SOURCE,
                 [("constexpr int kTile = 256;", "constexpr int kTile = 512;")],
                 {}),
    "unroll_4": ("the group loop unrolled by 4 instead of 2", k4.SOURCE,
                 [("#pragma unroll 2\n      for (int gi",
                   "#pragma unroll 4\n      for (int gi")], {}),
    "key_imad": ("keys by multiply-adds (umulhi, shift) instead of a "
                 "funnel shift", k4.SOURCE, [(_KEY, _KEY_IMAD)], {}),
    "key_mixed": ("one key of each pair by a funnel shift, the other by "
                  "multiply-adds", k4.SOURCE, [(_FOLD, _FOLD_MIXED)], {}),
    "double_buffer": ("two target tiles, the next one's coordinates loaded "
                      "into registers while the current one is consumed, "
                      "instead of one", k4.SOURCE,
                      [(_PACK_HEAD, _PACK_HEAD_DB),
                       ("double tile[kTile * 4];",
                        "double tile[2][kTile * 4];"),
                       (_LOOP_HEAD, _LOOP_HEAD_DB),
                       ("tile[gi * 32 + lane];", "tile[stage][gi * 32 + lane];"),
                       (_LOOP_TAIL, _LOOP_TAIL_DB)], {}),
    "ctas_2_per_sm": ("a wave of 2 CTAs per SM instead of all that fit",
                      k4.SOURCE, [], {"ctas_per_sm": 2}),
    "not_balanced": ("one CTA per row and chunk of targets, the targets "
                     "split until all CTAs that fit per SM are launched "
                     "(the first grid) instead of equal shares",
                     k4.SOURCE, [], {"planner": first_grid_plan}),
    "dmma_only": ("diagnostic: the products without the min, one XOR of "
                  "a result word per row kept so no product is dead (wrong "
                  "output): what the f64 tensor cores take",
                  k4.SOURCE, [(_FOLD, "#define FOLD(best, d0, d1) "
                               "best ^= __double2loint(d0)")], {}),
    "dmma_only_zero_c": ("diagnostic: dmma_only with a zero C operand "
                         "(wrong output)", k4.SOURCE, [
                             (_FOLD, "#define FOLD(best, d0, d1) "
                              "best ^= __double2loint(d0)"),
                             ('"d"(b), "d"(c[0]), "d"(c[1]));',
                              '"d"(b), "d"(0.0), "d"(0.0));')], {}),
    "min_only": ("diagnostic: the keys and min of the loaded B fragments "
                 "(one LOP3 a value makes them distinct), no products "
                 "(wrong output): what the min takes alone",
                 k4.SOURCE, [("        mma_tile(d, qa[q], qc[q], bf);\n",
                              "        for (int i = 0; i < kAcc; ++i) "
                              "d[i] = __hiloint2double(__double2hiint(bf), "
                              "__double2loint(bf) ^ (q * kAcc + i));\n")],
                 {}),
    "min_two_ops": ("two-way unsigned mins instead of the three-way DPX min",
                    k4.SOURCE, [(_FOLD, "#define FOLD(best, d0, d1) best = "
                                 "min(min(best, key_of(d0)), key_of(d1))")],
                    {}),
}
DIAGNOSTICS = ("dmma_only", "dmma_only_zero_c", "min_only")  # wrong output


def variant_sources() -> Dict[str, str]:
    texts = {}
    out = {}
    for name, (_, source, edits, _) in VARIANTS.items():
        if source not in texts:
            with open(os.path.join(build.CSRC_DIR, source)) as f:
                texts[source] = f.read()
        text = texts[source]
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {source} no longer has "
                                   f"{old[:60]!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_variants() -> Dict[str, Tuple[ctypes.CDLL, str]]:
    """Compile every variant (one nvcc each, all at once) and load it."""
    os.makedirs(VARIANT_DIR, exist_ok=True)
    procs = {}
    for name, text in variant_sources().items():
        cu = os.path.join(VARIANT_DIR, f"k4_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(VARIANT_DIR, f"libk4_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, failed = {}, []
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{name}:\n{log[-3000:]}")
            continue
        notes = [re.sub(r"ptxas info\s*:\s*", "", line.strip())
                 for line in log.splitlines()
                 if "registers" in line or "spill stores" in line]
        print(f"built {name}: {' | '.join(notes)}")
        libs[name] = (ctypes.CDLL(lib), lib)
    if failed:
        raise RuntimeError("nvcc failed on variants\n" + "\n".join(failed))
    return libs


def sass_counts(lib: str) -> Dict[str, int]:
    """Opcode counts of the `nn_kernel` function in a built library, the
    most frequent first."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True).stdout
    body = [part for part in text.split("Function : ")
            if "nn_kernel" in part.splitlines()[0]] if text else []
    if not body:
        return {}
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     body[0])
    counts = {op: ops.count(op) for op in set(ops)}
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def _bind(lib: ctypes.CDLL):
    fn = lib.echoscene_nn_distance
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chamfer_variants: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    build.load(k4.SOURCE)
    print(f"sass kernel: {json.dumps(sass_counts(build._target(k4.SOURCE)))}")
    print(f"kernel: {k4._kernel()[1]} CTAs per SM")
    fn, ctas_per_sm = k4._kernel()
    calls = {"kernel": (fn, {"ctas_per_sm": ctas_per_sm}, k4.BLOCK_N)}
    for name, (lib, path) in build_variants().items():
        block_n = lib.echoscene_nn_distance_block_n()
        plan_kw = {"ctas_per_sm": lib.echoscene_nn_distance_ctas_per_sm(),
                   **VARIANTS[name][3]}
        print(f"{name}: {plan_kw['ctas_per_sm']} CTAs per SM")
        calls[name] = (_bind(lib), plan_kw, block_n)
        print(f"sass {name}: {json.dumps(sass_counts(path))}")

    def call(entry, a, b):
        fn, plan_kw, block_n = entry
        B, N, M = a.shape[0], a.shape[1], b.shape[1]
        out = torch.empty((B, N), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        kw = dict(plan_kw)
        planner = kw.pop("planner", k4.launch_plan)
        p = planner(B, N, M, sms, block_n=block_n, **kw)
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), B, N, M,
                 p.query_tiles, p.units_row, p.ctas, int(p.atomic), stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    def cuda_ms(fn, iters=30):
        for _ in range(3):
            fn()
        # the card waits on a sleep while the host enqueues every call, so
        # a call shorter than its host time is timed on the card alone
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {}
    for b, n, m in SHAPES:
        both = k4.surface_clouds(b, n + m, gen)
        data[(b, n, m)] = (both[:, :n].contiguous(), both[:, n:].contiguous())
    for s in SHAPES:
        a, t = data[s]
        ref = k4.nn_distance_plain(a.double(), t.double())
        ref_ulp = k4.nn_distance_f64(a, t)
        floor = k4.ulp_floor(a, t)
        for name, entry in calls.items():
            out = call(entry, a, t)
            ratios = k4.error_ratios(out, ref, a, t)
            ulps = k4.ulp_distance(out, ref_ulp, floor)
            ok = max(ratios) <= 1.0 and ulps <= 1.0
            if not ok and name not in DIAGNOSTICS:
                raise RuntimeError(f"{name} at {s}: error at {ratios} of the "
                                   f"limits, {ulps} ulp")
            print(f"check {name} {s}: max / mean err at {ratios[0]:.3f} / "
                  f"{ratios[1]:.3f} of the limits, {ulps:.0f} ulp")
        del ref, ref_ulp
        torch.cuda.empty_cache()
    times: Dict[str, Dict[str, List[float]]] = {
        name: {str(s): [] for s in SHAPES} for name in [*calls, "cdist"]}
    for rnd in range(args.rounds):
        for s in SHAPES:
            a, t = data[s]
            times["cdist"][str(s)].append(cuda_ms(
                lambda: torch.cdist(a, t).square().amin(2), iters=5))
            for name, entry in calls.items():
                times[name][str(s)].append(cuda_ms(lambda: call(entry, a, t)))
        for name in times:
            print(f"round {rnd} {name}: " + ", ".join(
                f"{s} {times[name][s][-1]:.4f} ms" for s in times[name]))
    med = {n: {s: statistics.median(t) for s, t in ts.items()}
           for n, ts in times.items()}
    pairs = {str(s): s[0] * s[1] * s[2] for s in SHAPES}
    rate = {n: {s: 8 * pairs[s] / (ms * 1e9) for s, ms in ts.items()}
            for n, ts in med.items()}
    print(json.dumps({"card": card, "rounds": args.rounds,
                      "what": {n: d for n, (d, _, _, _) in VARIANTS.items()},
                      "median_ms": med, "pair_tflops": rate,
                      "bound_ms": {str(s): k4.nn_distance_bound(*s)["ms"]
                                   for s in SHAPES}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
