"""Design check of the bf16 attention backward on the card: each variant
turns off one design step of `csrc/flash_attention_bwd.cu` and is timed
beside the kernel and SDPA's backward.

    python -m echoscene_torch.kernels.attention_bwd_variants [--rounds N]

A variant is the kernel's source with a textual edit, built by nvcc with
`build.NVCC_FLAGS` into `build/kernels/variants/` (all at once, with the
ptxas report's spills printed) and called through ctypes with the
wrapper's arguments and plan.  The variants change only the order in which
the kernel issues its work, so each is held bit-equal to the kernel first,
and the kernel to the bf16 limits of `error_ratios` against
`attention_backward_plain`; then all are timed with CUDA events in turns,
N rounds, at K1's and K2's training shapes.  Prints one line per
measurement and, last, a JSON object with the medians.  Needs a CUDA card
and nvcc; no path of the port runs it.

  * `no_turns`: the consumers issue when they are ready (no named-barrier
    turns; at D_pad 256 consumer 1's dP need not follow consumer 0's S);
  * `no_pipeline`: a consumer computes P and dS of a tile only after its
    gradient products of the tile before have ended (D_pad 64 and 128; D_pad
    256 is not pipelined in the kernel either);
  * `two_launches`: the dK / dV tiles and the dQ tiles as two launches of
    the same kernel, the second waiting for the first to drain;
  * `not_persistent`: at D_pad 64 one CTA a tile, as at D_pad 128 and 256,
    each loading its resident tiles and writing its gradients with nothing
    else to hide either;
  * `one_resident_buffer`: at D_pad 64, persistent, the producer loads a
    CTA's next resident tiles only after the consumers' stores of the tile
    before;
  * `no_prefetch`: the producer loads a query tile's lse and delta only
    when the ring has room for the tile;
  * `ss_scores`: at D_pad 64, S and dP read the resident rows from shared
    memory (both operands there, as at D_pad 128 / 256) instead of from
    registers loaded once a tile.

Diagnostics, whose gradients are wrong by design (timed, not checked):
`diag_no_exp` computes P without the exponential (its cost on the SFU).
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
from . import flash_attention as fa

VARIANT_DIR = os.path.join(build.BUILD_DIR, "variants")
SHAPES = [(8, 1024, 8, 56), (8, 4096, 1, 256)]
SLEEP_CYCLES = 20_000_000   # ~10 ms at the H100's clock: covers the calls
SPILLS = re.compile(r"(\d+) bytes spill stores")

_LAUNCH = """  bwd_kernel<D_PAD><<<static_cast<unsigned>(ctas), kThreads, T::kSmemAlloc,
                      stream>>>(kv, qm, static_cast<const float*>(lse),
                                static_cast<const float*>(delta), H, L, S,
                                kv_tiles, q_tiles, kv_blocks, 0, tiles,
                                scale_log2, scale);"""
_TWO_LAUNCHES = """  const long kv_ctas = ctas < kv_blocks ? ctas : kv_blocks;
  const long q_ctas = ctas < tiles - kv_blocks ? ctas : tiles - kv_blocks;
  bwd_kernel<D_PAD><<<static_cast<unsigned>(kv_ctas), kThreads,
                      T::kSmemAlloc, stream>>>(
      kv, qm, static_cast<const float*>(lse),
      static_cast<const float*>(delta), H, L, S, kv_tiles, q_tiles,
      kv_blocks, 0, kv_blocks, scale_log2, scale);
  bwd_kernel<D_PAD><<<static_cast<unsigned>(q_ctas), kThreads,
                      T::kSmemAlloc, stream>>>(
      kv, qm, static_cast<const float*>(lse),
      static_cast<const float*>(delta), H, L, S, kv_tiles, q_tiles,
      kv_blocks, kv_blocks, tiles, scale_log2, scale);"""

VARIANTS: Dict[str, Tuple[str, List[Tuple[str, str]]]] = {
    "no_turns": ("no named-barrier turns between the consumers", [
        ("constexpr bool kTurns = true;", "constexpr bool kTurns = false;")]),
    "no_pipeline": ("P and dS of tile j + 1 after tile j's gradients", [
        ("constexpr bool kPipelined = true;",
         "constexpr bool kPipelined = false;")]),
    "two_launches": ("dK / dV tiles, then dQ tiles, two launches",
                     [(_LAUNCH, _TWO_LAUNCHES)]),
    "not_persistent": ("D_pad 64: one CTA a tile (grid = tiles)", [
        ("  bwd_kernel<D_PAD><<<static_cast<unsigned>(ctas), kThreads",
         "  bwd_kernel<D_PAD><<<static_cast<unsigned>(tiles), kThreads")]),
    "one_resident_buffer": ("D_pad 64: one resident buffer, not two", [
        ("kResBufs = kPersistent ? 2 : 1;", "kResBufs = 1;")]),
    "no_prefetch": ("lse / delta loaded when the ring has room", [
        ("  if constexpr (KV) fetch(0);\n", ""),
        ("((cjj / T::kStages) & 1) ^ 1);\n    if constexpr (KV) {\n",
         "((cjj / T::kStages) & 1) ^ 1);\n    if constexpr (KV) {\n"
         "      fetch(j);\n"),
        ("    if constexpr (KV)\n      if (j + 1 < n_tiles) fetch(j + 1);\n",
         "")]),
    "ss_scores": ("D_pad 64: S and dP with both operands in shared memory", [
        ("constexpr bool kRegisterA = true;",
         "constexpr bool kRegisterA = false;")]),
    "diag_no_exp": ("diagnostic: P = S c - lse, no exponential", [
        ("const float p = ex2(fmaf(x[i], scale_log2, -lse));",
         "const float p = fmaf(x[i], scale_log2, -lse);")]),
}


def variant_sources() -> Dict[str, str]:
    with open(os.path.join(build.CSRC_DIR, fa.SOURCE_BWD)) as f:
        base = f.read()
    out = {}
    for name, (_, edits) in VARIANTS.items():
        text = base
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {fa.SOURCE_BWD} no "
                                   f"longer has {old[:60]!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_variants() -> Dict[str, ctypes.CDLL]:
    """Compile every variant (one nvcc each, all at once) and load it;
    prints each one's spill stores (phase 1 of chip_smoke.py holds the
    kernel itself to none)."""
    os.makedirs(VARIANT_DIR, exist_ok=True)
    procs = {}
    for name, text in variant_sources().items():
        cu = os.path.join(VARIANT_DIR, f"bwd_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(VARIANT_DIR, f"libbwd_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, failed = {}, []
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{name}:\n{log[-3000:]}")
            continue
        print(f"variant {name}: spill stores {SPILLS.findall(log)}",
              flush=True)
        libs[name] = ctypes.CDLL(lib)
    if failed:
        raise RuntimeError("nvcc failed on variants\n" + "\n".join(failed))
    return libs


def main(argv=None) -> int:
    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_bwd_variants: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    report = build.build(fa.SOURCE_BWD)
    print(f"kernel: spill stores {SPILLS.findall(report)}", flush=True)
    kernel_fn = fa._backward_entry()
    fns = {name: getattr(lib, "echoscene_attention_backward")
           for name, lib in build_variants().items()}
    for fn in fns.values():
        fn.argtypes = kernel_fn.argtypes
        fn.restype = ctypes.c_int

    def call(fn, q, k, v, o, lse, g):
        b, l, h, d = q.shape
        plan = fa.backward_plan(b, l, h, d, k.shape[1],
                                fa._sm_count(q.device.index))
        delta = torch.empty((b, h, l), dtype=torch.float32, device="cuda")
        out = [torch.empty_like(x) for x in (q, k, v)]
        err = fn(*(x.data_ptr() for x in (q, k, v, o, g, lse, delta, *out)),
                 b, h, l, k.shape[1], d, d ** -0.5, plan["rows"],
                 plan["ctas"], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"backward launch failed: CUDA error {err}")
        return out

    def cuda_ms(fn, iters=10):
        for _ in range(2):
            fn()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    gen = torch.Generator(device="cuda").manual_seed(15)
    cases = {}
    for shape in SHAPES:
        q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(4))
        o, lse = fa._launch("onepass_attention", q, k, v, lse=True)
        inputs = (q, k, v, o, lse, g)
        got = fa.attention_backward("onepass_attention", *inputs)
        want = fa.attention_backward_plain(*inputs)
        ratios = [fa.error_ratios(a, b) for a, b in zip(got, want)]
        if max(max(r) for r in ratios) > 1.0:
            raise RuntimeError(f"kernel at {shape}: {ratios} of the limits")
        timed = {"kernel": lambda i=inputs: call(kernel_fn, *i)}
        print(f"check {shape}: kernel at {ratios} of the limits", flush=True)
        for name, fn in fns.items():
            if not name.startswith("diag_") and not all(
                    torch.equal(a, b) for a, b in zip(call(fn, *inputs),
                                                      got)):
                raise RuntimeError(f"variant {name} at {shape}: not "
                                   "bit-equal to the kernel")
            timed[name] = lambda fn=fn, i=inputs: call(fn, *i)
        print(f"check {shape}: every variant but the diagnostics bit-equal "
              "to the kernel",
              flush=True)
        tr = [x.transpose(1, 2).contiguous().requires_grad_(True)
              for x in (q, k, v)]
        out_t = F.scaled_dot_product_attention(*tr)
        gt = g.transpose(1, 2).contiguous()
        timed["sdpa_backward"] = lambda o=out_t, t=tr, gt=gt: \
            torch.autograd.grad(o, t, gt, retain_graph=True)
        cases[str(shape)] = (timed, fa.attention_backward_bound(*shape)["ms"])
    times = {c: {n: [] for n in fns_} for c, (fns_, _) in cases.items()}
    for rnd in range(args.rounds):
        for case, (fns_, _) in cases.items():
            for name, fn in fns_.items():
                times[case][name].append(cuda_ms(fn))
            print(f"round {rnd} {case}: " + ", ".join(
                f"{n} {t[-1]:.4f}" for n, t in times[case].items()),
                flush=True)
    med = {c: {n: statistics.median(t) for n, t in ts.items()}
           for c, ts in times.items()}
    print(json.dumps({"card": card, "rounds": args.rounds,
                      "what": {n: d for n, (d, _) in VARIANTS.items()},
                      "median_ms": med,
                      "bound_ms": {c: b for c, (_, b) in cases.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
