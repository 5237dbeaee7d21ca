"""Design check of the int8 kernels Q1 / Q2 on the card: each variant
changes one design choice of `csrc/int8_conv.cu` and is timed beside the
kernel.

    python -m echoscene_torch.kernels.int8_variants [--rounds N]

A variant is the source with a few textual edits, built by nvcc with
`build.NVCC_FLAGS` into `build/kernels/variants/` (all at once) and called
through ctypes with the wrapper's arguments and plan.  Each is held to the
plain version first (Q1 bit-equal, Q2 within 1 bf16 ulp), then all are
timed with CUDA events in turns with the kernel, N rounds, at the shapes
of the flagship's int8 torso at 42 rows.  Prints one line per
measurement and, last, a JSON object with the medians.  Needs a CUDA card
and nvcc; no path of the port runs it.

  * Q1: `q1_divide` always divides (no product fast path); `q1_512_split`
    takes 512-position tiles with 256 threads and each warp storing one
    channel half (the layout before whole-sector stores); `q1_512_paired`
    the 512-position tile with the paired stores; `q1_256_split` the
    256-position tile with split stores.
  * Q2: `q2_cw32` takes the depth in 32-byte chunks (32-byte swizzle, up
    to 16 stages), so 224 channels are not padded to 256; `q2_multicast` runs the 224-wide N tiles as 2-CTA clusters along M,
    each CTA loading half of the N tile's weights by TMA multicast to both,
    the stage released to both CTAs' producers (mbarrier arrives through
    `mapa`, one warp a CTA); `q2_cluster_only` launches the same clusters
    without the multicast (each CTA loads all of its weights), which
    separates the cost of the cluster launch from that of the multicast.
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
from . import int8_conv as q8

VARIANT_DIR = os.path.join(build.BUILD_DIR, "variants")
SLEEP_CYCLES = 5_000_000    # ~2.5 ms at the H100's clock: covers the calls

Q1_SHAPES = [((42, 224, 16, 16, 16), "bfloat16"),
             ((42, 672, 16, 16, 16), "bfloat16"),
             ((42, 448, 16, 8, 8), "bfloat16"),
             ((42, 448, 16, 4, 4), "bfloat16"),
             ((42, 3, 16, 16, 16), "float32")]
# (x shape, K, taps, stride, pads)
_SAME = ((1, 1),) * 3
Q2_SHAPES = [((42, 224, 16, 16, 16), 224, (3, 3, 3), (1, 1, 1), _SAME),
             ((42, 1120, 16, 8, 8), 448, (3, 3, 3), (1, 1, 1), _SAME),
             ((42, 672, 16, 4, 4), 672, (3, 3, 3), (1, 1, 1), _SAME),
             ((42, 448, 16, 8, 8), 448, (3, 2, 2), (1, 1, 1),
              ((1, 1), (1, 0), (0, 1))),
             ((42, 672, 16, 16, 16), 224, (1, 1, 1), (1, 1, 1),
              ((0, 0),) * 3),
             ((42, 224, 16, 8, 8), 448, (3, 3, 3), (1, 1, 1), _SAME),
             ((42, 224, 16, 16, 16), 3, (3, 3, 3), (1, 1, 1), _SAME),
             ((42, 3, 16, 16, 16), 224, (3, 3, 3), (1, 1, 1), _SAME)]

_Q1_512 = [("constexpr int kQuantThreads = 128;",
            "constexpr int kQuantThreads = 256;"),
           ("constexpr int kQuantS = 256;", "constexpr int kQuantS = 512;")]
_Q1_SPLIT = [
    ("      tile[cl][(g * kVec / 4 + w) ^ (cl & 16)] =",
     "      tile[cl][g * kVec / 4 + w] ="),
    ("  const int pg = threadIdx.x / 2;\n  const int half = threadIdx.x % 2;",
     "  const int pg = threadIdx.x % (kQuantS / 4);\n"
     "  const int half = threadIdx.x / (kQuantS / 4);"),
    ("    const int wi = pg ^ (r & 16);\n", "    const int wi = pg;\n")]

_CLUSTER_HELPERS = '''// arrive on the barrier at this CTA-relative address in CTA `cta` of the
// cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\\n.reg .b32 remote;\\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\\n}\\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\\nbarrier.cluster.wait.acquire;\\n" ::
          : "memory");
}

__device__ __forceinline__ void tma_load_3d_multicast(
    uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
    int c2, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {'''


def _cluster_edits(multicast: bool) -> List[Tuple[str, str]]:
    """The 224-wide N tiles in clusters of 2 CTAs on neighbouring M tiles
    (CL = 2; the 8-wide ones stay single CTAs)."""
    load_b = ('''          tma_load_3d_multicast(sa + T::kA + cta * (T::kB / CL), &tm_w,
                                full + 8 * st, ch * CW, tap,
                                k0 + cta * (BN / CL), (1 << CL) - 1);'''
              if multicast else
              '''          tma_load_3d(sa + T::kA, &tm_w, full + 8 * st, ch * CW, tap,
                      k0);''')
    release = ('''      if (it > 0 && tid % 32 == 0 && tid / 32 < CL) {
        const uint32_t bar = empty + 8 * ((it - 1) % T::kStages);
        if constexpr (CL == 1)
          mbar_arrive(bar);
        else
          mbar_arrive_cluster(bar, tid / 32);
      }''' if multicast else '''      if (it > 0 && tid == 0)
        mbar_arrive(empty + 8 * ((it - 1) % T::kStages));''')
    arrivals = "2 * CL" if multicast else "2"
    box = "BN / CL" if multicast else "BN"
    return [
        ("__device__ __forceinline__ void named_sync(int id, int threads) {",
         _CLUSTER_HELPERS),
        ("  using T = ConvTiles<CW, BN>;\n  extern __shared__",
         "  using T = ConvTiles<CW, BN>;\n"
         "  constexpr int CL = BN == 224 ? 2 : 1;\n  extern __shared__"),
        ("""  const int nt = blockIdx.x % a.n_tiles;
  int mt = blockIdx.x / a.n_tiles;""",
         """  const int cta = CL == 1 ? 0 : (int)cluster_rank();
  const int cid = blockIdx.x / CL;
  const int nt = cid % a.n_tiles;
  int mt = (cid / a.n_tiles) * CL + cta;"""),
        ("""      mbar_init(empty + 8 * i, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  __syncthreads();""",
         f"""      mbar_init(empty + 8 * i, {arrivals});
    }}
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }}
  if constexpr (CL == 1)
    __syncthreads();
  else
    cluster_sync();"""),
        ("""        tma_load_3d(sa + T::kA, &tm_w, full + 8 * st, ch * CW, tap, k0);
        if (++ch == a.chunks) {
          ch = 0;
          ++tap;
        }
      }
    }
  } else {""",
         f"""        if constexpr (CL == 1)
          tma_load_3d(sa + T::kA, &tm_w, full + 8 * st, ch * CW, tap, k0);
        else
{load_b}
        if (++ch == a.chunks) {{
          ch = 0;
          ++tap;
        }}
      }}
    }}
    if constexpr (CL == 2) cluster_sync();
  }} else {{"""),
        ("""      if (it > 0 && tid == 0)
        mbar_arrive(empty + 8 * ((it - 1) % T::kStages));""", release),
        ("""          if (ro[r] >= 0) dst[ro[r]] = src[r];
      }
    }
  }
}""", """          if (ro[r] >= 0) dst[ro[r]] = src[r];
      }
    }
    if constexpr (CL == 2) cluster_sync();
  }
}"""),
        ("""  using T = ConvTiles<CW, BN>;
  auto kernel = int8_conv3d_wgmma<CW, BN, kRaw>;""",
         """  using T = ConvTiles<CW, BN>;
  constexpr int CL = BN == 224 ? 2 : 1;
  auto kernel = int8_conv3d_wgmma<CW, BN, kRaw>;"""),
        ("const cuuint32_t box[3] = {(cuuint32_t)CW, 1, (cuuint32_t)BN};",
         f"const cuuint32_t box[3] = {{(cuuint32_t)CW, 1, (cuuint32_t)({box})}};"),
        ("""  const long long grid = p[kPTilesN] * p[kPTilesD] * p[kPTilesH] *
                         p[kPTilesW] * p[kPNTiles];
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<(unsigned)grid, kConvThreads, T::kSmemAlloc, stream>>>(tm_x, tm_w,
                                                                  a);""",
         """  const long long tiles_m =
      p[kPTilesN] * p[kPTilesD] * p[kPTilesH] * p[kPTilesW];
  const long long grid = (tiles_m + CL - 1) / CL * CL * p[kPNTiles];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kConvThreads);
  cfg.dynamicSmemBytes = T::kSmemAlloc;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[3] = {&tm_x, &tm_w, &a};
  const cudaError_t launched = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(kernel), args);
  if (launched != cudaSuccess) return static_cast<int>(launched);"""),
    ]


_CW32 = [
    ("constexpr int kMaxStages = 8;", "constexpr int kMaxStages = 16;"),
    ("  constexpr uint64_t kLayout = CW == 128 ? 1 : 2;",
     "  constexpr uint64_t kLayout = CW == 128 ? 1 : CW == 64 ? 2 : 3;"),
    ("(p[kPCw] != 64 && p[kPCw] != 128)",
     "(p[kPCw] != 32 && p[kPCw] != 64 && p[kPCw] != 128)"),
    ("      CW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;",
     "      CW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B\n"
     "      : CW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;"),
    ("  const float* b = static_cast<const float*>(bias);\n"
     "  const bool wide = plan[kPCw] == 128;",
     "  const float* b = static_cast<const float*>(bias);\n"
     "  if (plan[kPCw] == 32)\n"
     "    return plan[kPBn] == 224\n"
     "        ? launch<32, 224, false>(x, w, xs, ws, b, out, plan, stream)\n"
     "        : launch<32, 8, false>(x, w, xs, ws, b, out, plan, stream);\n"
     "  const bool wide = plan[kPCw] == 128;"),
]


def _chunks_of_32(vector: List[int]) -> List[int]:
    """The plan with 32-byte chunks (no channel padding past Cp)."""
    v = list(vector)
    cp = v[q8.PLAN_FIELDS.index("cp")]
    v[q8.PLAN_FIELDS.index("cw")] = 32
    v[q8.PLAN_FIELDS.index("chunks")] = cp // 32
    return v


VARIANTS: Dict[str, Tuple[str, List[Tuple[str, str]]]] = {
    "q1_divide": ("Q1 with the IEEE division on every element", [
        ("  if (fabsf(t - floorf(t) - 0.5f) > 0x1p-15f)", "  if (false)")]),
    "q1_512_split": ("Q1, 512-position tiles, 256 threads, split stores",
                     _Q1_512 + _Q1_SPLIT),
    "q1_512_paired": ("Q1, 512-position tiles, 256 threads, paired stores",
                      _Q1_512),
    "q1_256_split": ("Q1, 256-position tiles, split stores", _Q1_SPLIT),
    "q2_multicast": ("Q2, 2-CTA clusters, the weights multicast",
                     _cluster_edits(True)),
    "q2_cluster_only": ("Q2, 2-CTA clusters, no multicast",
                        _cluster_edits(False)),
    "q2_cw32": ("Q2, 32-byte chunks (32-byte swizzle, up to 16 stages)",
                _CW32),
}
# variants that run Q2 with another plan than conv_plan's
PLANS = {"q2_cw32": _chunks_of_32}


def variant_sources() -> Dict[str, str]:
    with open(os.path.join(build.CSRC_DIR, q8.SOURCE)) as f:
        base = f.read()
    out = {}
    for name, (_, edits) in VARIANTS.items():
        text = base
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {q8.SOURCE} no longer "
                                   f"has {old[:60]!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_variants() -> Dict[str, ctypes.CDLL]:
    """Compile every variant (one nvcc each, all at once) and load it."""
    os.makedirs(VARIANT_DIR, exist_ok=True)
    procs = {}
    for name, text in variant_sources().items():
        cu = os.path.join(VARIANT_DIR, f"int8_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(VARIANT_DIR, f"libint8_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, failed = {}, []
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{name}:\n{log[-3000:]}")
            continue
        libs[name] = ctypes.CDLL(lib)
    if failed:
        raise RuntimeError("nvcc failed on variants\n" + "\n".join(failed))
    return libs


def _bind(lib: ctypes.CDLL) -> Tuple:
    q1, q2 = lib.echoscene_quantize_act, lib.echoscene_int8_conv3d
    q1.argtypes = q8._entry("quantize_act").argtypes
    q2.argtypes = q8._entry("int8_conv3d").argtypes
    q1.restype = q2.restype = ctypes.c_int
    return q1, q2


def main(argv=None) -> int:
    import torch
    from ..nn.quant import quantize_weight

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_variants: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    build.load(q8.SOURCE)
    entries = {"kernel": _bind(build.load(q8.SOURCE))}
    entries.update({n: _bind(lib) for n, lib in build_variants().items()})
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def q1_call(fn, x):
        n, c, s, q, scale = q8._act_outputs(x)
        amax = torch.empty(1, dtype=torch.int32, device="cuda")
        err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), n, c, s,
                 q.shape[-1], amax.data_ptr(), q8.EPS, q.data_ptr(),
                 scale.data_ptr(), stream())
        if err:
            raise RuntimeError(f"Q1 launch failed: CUDA error {err}")
        return q, scale

    def q2_call(fn, args, vector):
        xq, wq, xs, ws, bias, out = args
        o = torch.empty_like(out)
        err = fn(xq.data_ptr(), wq.data_ptr(), xs.data_ptr(), ws.data_ptr(),
                 bias.data_ptr(), o.data_ptr(), vector, len(vector), stream())
        if err:
            raise RuntimeError(f"Q2 launch failed: CUDA error {err}")
        return o

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

    gen = torch.Generator(device="cuda").manual_seed(21)
    cases = {}   # name -> (timed fns by entry, bound ms)
    for shape, dtype in Q1_SHAPES:
        x = (2 * torch.randn(shape, generator=gen, device="cuda")).to(
            getattr(torch, dtype))
        want = q8.quantize_plain(x)
        fns = {}
        for name, (q1, _) in entries.items():
            if name.startswith("q2_"):
                continue
            got = q1_call(q1, x)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise RuntimeError(f"Q1 {name} at {shape}: not bit-equal")
            fns[name] = (lambda q1=q1, x=x: q1_call(q1, x))
        bound = q8.quantize_bound(x.numel(), x.element_size(),
                                  want[0].numel())["ms"]
        cases[f"Q1 {shape} {dtype}"] = (fns, bound)
        print(f"check Q1 {shape} {dtype}: bit-equal", flush=True)
    for shape, k, taps, stride, pads in Q2_SHAPES:
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        xq, xs = q8.quantize_act(x)
        wq, ws = quantize_weight(torch.randn((k, shape[1]) + taps,
                                             generator=gen, device="cuda"))
        bias = torch.randn(k, generator=gen, device="cuda")
        ref = q8.int8_conv3d_plain(xq, wq, xs, ws, bias, stride, pads)
        plan = q8.conv_plan(shape[0], shape[2:], xq.shape[-1], k, taps,
                            stride, pads, tuple(ref.stride()))
        args_ = (xq, wq, xs, ws, bias, ref)
        fns = {}
        for name, (_, q2) in entries.items():
            if name.startswith("q1_"):
                continue
            vec = PLANS.get(name, list)(plan["vector"])
            vector = (ctypes.c_longlong * len(vec))(*vec)
            ulps = int(q8.bf16_ulps(q2_call(q2, args_, vector), ref).max())
            if ulps > 1:
                raise RuntimeError(f"Q2 {name} at {shape}: {ulps} ulps")
            fns[name] = (lambda q2=q2, a=args_, v=vector: q2_call(q2, a, v))
        bound = q8.int8_conv_bound(shape[0], shape[2:], shape[1],
                                   xq.shape[-1], k, taps, ref.shape[2:],
                                   True)["ms"]
        cases[f"Q2 {shape} -> {k} {taps}"] = (fns, bound)
        print(f"check Q2 {shape} -> {k} {taps}: within 1 ulp", flush=True)
    times: Dict[str, Dict[str, List[float]]] = {
        c: {n: [] for n in fns} for c, (fns, _) in cases.items()}
    for rnd in range(args.rounds):
        for case, (fns, _) in cases.items():
            for name, fn in fns.items():
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
