// Backward of non-causal softmax attention for Hopper (sm_90a), bf16: the
// earlier design, kept to be timed beside the kernel of
// csrc/flash_attention_bwd.cu (chip_smoke.py phase 2 reaches it through
// flash_attention.earlier_attention_backward; no path of the port calls it).
//
// Computes what JAX's `_fa_bwd` computes (echoscene_tpu/kernels/
// flash_attention.py:237-240: jax.vjp of `_einsum_reference`, XLA einsums,
// no Pallas kernel): dq, dk, dv of O = softmax(Q K^T D^-1/2) V for an
// upstream gradient dO.  The forward (csrc/flash_attention.cu) writes each
// row's log-sum-exp in the log2 domain, lse = m + log2(l), so
// P = exp2(S c - lse), c = D^-1/2 log2 e, is recomputed here without a
// softmax pass.
//
// The algorithm is FlashAttention-2/3's, three launches on one stream:
//   1. delta_kernel: delta = rowsum(dO * O) in f32, (B, H, L);
//   2. bwd_kernel<KV = true>, key-parallel: a CTA holds one tile of keys of
//      one (b, h), its K and V loaded once by TMA; query tiles stream
//      through a ring of Q, dO (TMA), lse and delta.  Per query tile:
//      S^T = K Q^T and dP^T = V dO^T (wgmma, f32 accumulate),
//      P^T = exp2(S^T c - lse), dS^T = P^T * (dP^T - delta) in f32, then
//      dV += bf16(P^T) dO and dK += bf16(dS^T) Q; dK scaled by D^-1/2;
//   3. bwd_kernel<KV = false>, query-parallel: a CTA holds one tile of
//      queries, Q and dO loaded once; key tiles stream through the ring of K
//      and V.  Per key tile: S = Q K^T, dP = dO V^T, P and dS as above,
//      dQ += bf16(dS) K; dQ scaled by D^-1/2.
// dQ is summed in the registers of one CTA in one order: no atomics, so two
// runs give the same bits (the data-parallel step is held bit-equal to the
// single step, checkpoint resumes bit-exact).  The price is S and dP
// computed in both kernels: 7 products where an atomic dQ needs 5.  P and
// dS are rounded to bf16 only as the operands of their products (as the
// plain path rounds p); dS is formed from the f32 P.
//
// What bounds it on the H100: the products.  At K1's training shape
// (8, 1024, 8, 56) D pads to 64 and the 7 products are 60 GFLOP, 0.061 ms
// at 989 TFLOP/s; the exponentials (two per score) 0.034 ms on the SFU.
// At K2's (8, 4096, 1, 256) the 7 products are 481 GFLOP, 0.49 ms; with
// the column split below they are 11, 756 GFLOP, 0.76 ms.
//
// Design (one templated kernel serves both passes: the "resident" rows R1,
// R2 are K, V or Q, dO; the "streamed" tiles C1, C2 are Q, dO or K, V):
//   * 3 warpgroups a CTA, not persistent: warpgroup 2 is the producer
//     (setmaxnreg 24; lane 0 of its first warp issues every TMA load, the
//     warp's 32 lanes copy lse and delta), warpgroups 0 and 1
//     the consumers (setmaxnreg 240), 64 resident rows each.  At D_pad 256
//     the accumulators of 64 rows x 256 columns do not fit (dK and dV would
//     take 256 registers a thread), so there the two consumers share the
//     same 64 rows and split the columns, 128 each (SPLIT): each computes S
//     and dP in full itself, 11 products in all in place of 7.
//   * q, k, v, o, dO and the outputs are 4-D tensor maps (D, H, rows, B),
//     box (64, 1, rows, 1), 128-byte swizzle, as in the forward: TMA
//     zero-fills d >= D and rows past L or S, so no row or column needs a
//     mask except the streamed keys past S in the dQ pass (P = 0 there; a
//     padded query column of the key-parallel pass is masked the same way).
//   * The streamed ring has 4 stages (2 at D_pad 256), each a 64-row tile
//     of C1 and of C2 (TMA) and, in the key-parallel pass, the tile's 64
//     lse and delta values (copied by the producer warp's 32 lanes), with a
//     full and an empty mbarrier per stage.
//   * S and dP are wgmma m64n64k16 with both operands K-major in swizzled
//     shared memory; P (or dS) is packed to bf16 in registers as the A
//     fragment of a register-A wgmma whose B operand (dO, Q or K) is read
//     MN-major straight from its TMA tile, as the forward's P V.
//   * Epilogue: the accumulators as bf16 into the resident tiles' shared
//     memory (same swizzle), then TMA stores that skip rows and columns
//     past the tensor.
// The producer's waits trap after ~2^26 polls, and it waits for the
// consumers' last releases, so a refused TMA load fails the launch instead
// of hanging the card.  Instantiated for D_pad = 64, 128 and 256.
// TMA needs 16-byte global strides, so D % 8 == 0; the wrapper raises
// otherwise.
//
// Built by echoscene_torch/kernels/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a, plain C interface) and called through
// ctypes; the entry point returns a cudaError_t.  cuTensorMapEncodeTiled
// is looked up through the runtime's entry-point query (no -lcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 384;   // 2 consumer warpgroups + 1 producer
constexpr int kBlockC = 64;     // streamed rows a stage
constexpr int kSubCols = 64;    // bf16 columns per 128-byte swizzle row
constexpr int kRowBytes = 128;
constexpr int kDeltaThreads = 256;
constexpr int kDeltaLanes = 8;  // lanes that share one row of delta

// ---- shared memory, barriers, TMA -----------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// The consumers' wait: spin until the phase of the given parity has
// completed.  No trap here: a trap in the consumers' code keeps ptxas from
// giving them the registers setmaxnreg grants (the key-parallel pass then
// spilled 272 bytes at D_pad 256).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// The producer's wait: the same, but it traps after ~2^26 polls (seconds),
// so a ring that stalls (a TMA load the card refused) fails the launch.
// The producer waits for every stage the consumers release, its last ones
// too, so a stall anywhere ends in this trap.
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t polls = 0;
  while (!mbar_try_wait(bar, parity))
    if (++polls == (1u << 26)) __trap();
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (B128).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins wgmma operand registers at this point of the program (see the
// forward): no read of an accumulator before its wgmma has been waited for,
// no instruction on them between a wgmma.fence and its wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// D (64 x 64, f32, registers) (+)= A (64 x 16, smem, K-major) B (64 x 16,
// smem, K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x N) += A (64 x 16, bf16 registers) B (16 x N, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 64 || N == 128, "no wgmma wrapper for N");
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- delta = rowsum(dO * O) -------------------------------------------------

// 8 lanes a row of (B, L, H, D) bf16, 16-byte loads; delta is (B, H, L) f32
__global__ void __launch_bounds__(kDeltaThreads)
delta_kernel(const __nv_bfloat16* __restrict__ o,
             const __nv_bfloat16* __restrict__ d_o, float* __restrict__ delta,
             long rows, int L, int H, int D) {
  const long row = static_cast<long>(blockIdx.x) *
                       (kDeltaThreads / kDeltaLanes) +
                   threadIdx.x / kDeltaLanes;
  const int lane = threadIdx.x % kDeltaLanes;
  float sum = 0.0f;
  if (row < rows) {
    const uint4* a = reinterpret_cast<const uint4*>(o + row * D);
    const uint4* b = reinterpret_cast<const uint4*>(d_o + row * D);
    for (int c = lane; c < D / 8; c += kDeltaLanes) {
      const uint4 x = a[c];
      const uint4 y = b[c];
      const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xf = __bfloat1622float2(xs[e]);
        const float2 yf = __bfloat1622float2(ys[e]);
        sum = fmaf(xf.x, yf.x, sum);
        sum = fmaf(xf.y, yf.y, sum);
      }
    }
  }
#pragma unroll
  for (int off = kDeltaLanes / 2; off > 0; off /= 2)
    sum += __shfl_xor_sync(0xffffffff, sum, off);
  if (row < rows && lane == 0) {
    const long b = row / (static_cast<long>(L) * H);
    const int l = static_cast<int>((row / H) % L);
    const int h = static_cast<int>(row % H);
    delta[(b * H + h) * L + l] = sum;
  }
}

// ---- the dK / dV and dQ kernel ---------------------------------------------

template <int D_PAD, bool KV>
struct BwdTiles {
  static constexpr bool kSplit = D_PAD == 256;  // consumers split columns
  static constexpr int kRows = kSplit ? 64 : 128;        // resident rows
  static constexpr int kDW = kSplit ? D_PAD / 2 : D_PAD;  // columns a consumer
  static constexpr int kStages = D_PAD == 256 ? 2 : 4;
  static constexpr int kSubs = D_PAD / kSubCols;
  static constexpr int kRSub = kRows * kRowBytes;
  static constexpr int kRBytes = kSubs * kRSub;    // one resident tile
  static constexpr int kCSub = kBlockC * kRowBytes;
  static constexpr int kCBytes = kSubs * kCSub;    // one streamed tile
  static constexpr int kStatBytes = kBlockC * 4;   // lse or delta of a tile
  static constexpr int kR1 = 0;
  static constexpr int kR2 = kRBytes;
  static constexpr int kC = 2 * kRBytes;           // stage st: C1, then C2
  static constexpr int kStats = kC + kStages * 2 * kCBytes;
  static constexpr int kBars = kStats + (KV ? kStages * 2 * kStatBytes : 0);
  // r_full, then c_full and c_empty per stage
  static constexpr int kSmem = kBars + 8 * (1 + 2 * kStages);
  static constexpr int kSmemAlloc = kSmem + 1024;  // room to align to 1024
  static constexpr int kTx = 2 * kCBytes;          // TMA bytes a stage
};

struct BwdMaps {
  CUtensorMap r1, r2;      // resident: K, V (KV) or Q, dO
  CUtensorMap c1, c2;      // streamed: Q, dO (KV) or K, V
  CUtensorMap out1, out2;  // dK, dV (KV) or dQ (out2 unused)
};

// grid (resident tiles, B * H).  n_res / n_str: resident and streamed
// lengths (S / L for KV, L / S for dQ).  lse_p / delta_p: (B, H, L) f32,
// per streamed column (KV) or per resident row (dQ).
template <int D_PAD, bool KV>
__global__ void __launch_bounds__(kThreads, 1)
bwd_kernel(const __grid_constant__ BwdMaps maps, const float* __restrict__ lse_p,
           const float* __restrict__ delta_p, int H, int n_res, int n_str,
           float scale_log2, float out_scale) {
  using T = BwdTiles<D_PAD, KV>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sR1 = base + T::kR1;
  const uint32_t sR2 = base + T::kR2;
  const uint32_t sC = base + T::kC;
  const uint32_t sStats = base + T::kStats;
  const uint32_t r_full = base + T::kBars;
  const uint32_t c_full = r_full + 8;
  const uint32_t c_empty = c_full + 8 * T::kStages;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int r0 = blockIdx.x * T::kRows;
  const int n_tiles = (n_str + kBlockC - 1) / kBlockC;

  if (threadIdx.x == 0) {
    mbar_init(r_full, 1);
    for (int i = 0; i < T::kStages; ++i) {
      mbar_init(c_full + 8 * i, 1);
      mbar_init(c_empty + 8 * i, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: lane 0 of warp 8 issues every TMA load; in the
    // key-parallel pass the warp's 32 lanes also copy each query tile's lse
    // and delta into the stage (plain loads: a (b, h) row of L floats need
    // not start 16-byte aligned, which a TMA box would need) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid < 32) {
      if (tid == 0) {
        mbar_expect_tx(r_full, 2 * T::kRBytes);
#pragma unroll
        for (int c = 0; c < T::kSubs; ++c) {
          tma_load(sR1 + c * T::kRSub, &maps.r1, r_full, c * kSubCols, h, r0,
                   b);
          tma_load(sR2 + c * T::kRSub, &maps.r2, r_full, c * kSubCols, h, r0,
                   b);
        }
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % T::kStages;
        mbar_wait_or_trap(c_empty + 8 * st, ((j / T::kStages) & 1) ^ 1);
        if constexpr (KV) {
          const uint32_t stats = sStats + st * 2 * T::kStatBytes;
          const long row = static_cast<long>(bh) * n_str;
#pragma unroll
          for (int e = tid; e < kBlockC; e += 32) {
            const int col = j * kBlockC + e;
            const float lse_v = col < n_str ? lse_p[row + col] : 0.0f;
            const float delta_v = col < n_str ? delta_p[row + col] : 0.0f;
            asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(stats + 4 * e),
                         "f"(lse_v)
                         : "memory");
            asm volatile("st.shared.f32 [%0], %1;\n"
                         ::"r"(stats + T::kStatBytes + 4 * e), "f"(delta_v)
                         : "memory");
          }
          __threadfence_block();
          __syncwarp();
        }
        if (tid == 0) {
          // the arrival releases the lanes' stores; the consumers acquire
          // them with the stage's TMA bytes
          const uint32_t full = c_full + 8 * st;
          const uint32_t c1 = sC + st * 2 * T::kCBytes;
          mbar_expect_tx(full, T::kTx);
#pragma unroll
          for (int c = 0; c < T::kSubs; ++c) {
            tma_load(c1 + c * T::kCSub, &maps.c1, full, c * kSubCols, h,
                     j * kBlockC, b);
            tma_load(c1 + T::kCBytes + c * T::kCSub, &maps.c2, full,
                     c * kSubCols, h, j * kBlockC, b);
          }
        }
      }
      // the consumers' release of the last stages (tile j completes phase
      // j / kStages of its stage's empty barrier)
      for (int j = n_tiles > T::kStages ? n_tiles - T::kStages : 0;
           j < n_tiles; ++j)
        mbar_wait_or_trap(c_empty + 8 * (j % T::kStages),
                          (j / T::kStages) & 1);
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int row0 = T::kSplit ? 0 : 64 * wg;   // this consumer's rows
    const int col0 = T::kSplit ? T::kDW * wg : 0;  // ... and columns
    const uint32_t r1_rows = sR1 + row0 * kRowBytes;
    const uint32_t r2_rows = sR2 + row0 * kRowBytes;

    float acc1[T::kDW / 2];            // dK or dQ: bf16(dS) C1
    float acc2[KV ? T::kDW / 2 : 1];   // dV: bf16(P) C2
    float s[kBlockC / 2];              // S, then P (f32)
    float dp[kBlockC / 2];             // dP, then dS (f32)
    uint32_t pk_s[kBlockC / 16][4];    // dS as bf16 A fragments
    uint32_t pk_p[KV ? kBlockC / 16 : 1][4];  // P as bf16 A fragments
#pragma unroll
    for (int i = 0; i < T::kDW / 2; ++i) acc1[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < (KV ? T::kDW / 2 : 1); ++i) acc2[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < kBlockC / 2; ++i) s[i] = dp[i] = 0.0f;

    // the dQ pass's per-row statistics (rows past L: lse 0, delta 0; their
    // Q and dO rows are zero, so their dS is 0 and the store skips them).
    // Every lane loads (a clamped row) and selects: a lane-dependent branch
    // here would leave the warp diverged at the first aligned wgmma.
    float row_lse[2] = {0.0f, 0.0f};
    float row_delta[2] = {0.0f, 0.0f};
    if constexpr (!KV) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + row0 + warp * 16 + g + 8 * r;
        const long at = static_cast<long>(bh) * n_res + min(row, n_res - 1);
        const float lse_v = lse_p[at];
        const float delta_v = delta_p[at];
        row_lse[r] = row < n_res ? lse_v : 0.0f;
        row_delta[r] = row < n_res ? delta_v : 0.0f;
      }
    }
    __syncwarp();

    // X (64 x 64) = R (this consumer's rows) C(tile)^T over D_pad.  The
    // addresses pass through an empty asm so that the descriptors are made
    // here, each just before its wgmma, and not hoisted out of the loop
    // (16 64-bit descriptors a product at D_pad 256 would hold 64 registers)
    auto issue_ss = [&](float (&x)[kBlockC / 2], uint32_t r_rows,
                        uint32_t c_tile) {
      asm volatile("" : "+r"(r_rows), "+r"(c_tile));
#pragma unroll
      for (int kk = 0; kk < D_PAD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        const uint64_t da =
            gmma_desc(r_rows + (kk / 4) * T::kRSub + off, 16, 8 * kRowBytes);
        const uint64_t db =
            gmma_desc(c_tile + (kk / 4) * T::kCSub + off, 16, 8 * kRowBytes);
        wgmma_ss_n64(x, da, db, kk > 0);
      }
    };
    // acc (64 x kDW) += a (64 x 64 streamed) C(tile)[:, col0 : col0 + kDW]:
    // C is the MN-major B operand, a k-step 16 streamed rows (two 8-row
    // swizzle atoms, SBO apart), the N range the 64-column sub-tiles (LBO)
    auto issue_rs = [&](float (&acc)[T::kDW / 2],
                        const uint32_t (&a)[kBlockC / 16][4],
                        uint32_t c_tile) {
      asm volatile("" : "+r"(c_tile));
#pragma unroll
      for (int kc = 0; kc < kBlockC / 16; ++kc) {
        const uint64_t db =
            gmma_desc(c_tile + (col0 / kSubCols) * T::kCSub +
                          kc * 16 * kRowBytes,
                      T::kCSub, 8 * kRowBytes);
        wgmma_rs<T::kDW>(acc, a[kc], db);
      }
    };
    auto pack = [&](uint32_t (&a)[kBlockC / 16][4],
                    const float (&x)[kBlockC / 2]) {
#pragma unroll
      for (int kc = 0; kc < kBlockC / 16; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          a[kc][e] = pack_bf16x2(x[8 * kc + 2 * e], x[8 * kc + 2 * e + 1]);
    };

    mbar_wait(r_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % T::kStages;
      const uint32_t c1 = sC + st * 2 * T::kCBytes;
      const uint32_t c2 = c1 + T::kCBytes;
      const uint32_t stats = sStats + st * 2 * T::kStatBytes;
      const int n0 = j * kBlockC;
      mbar_wait(c_full + 8 * st, (j / T::kStages) & 1);

      // S = R1 C1^T and dP = R2 C2^T
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      issue_ss(s, r1_rows, c1);
      issue_ss(dp, r2_rows, c2);
      wgmma_commit();
      fence_regs(s);
      fence_regs(dp);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P = exp2(S c - lse) and dS = P (dP - delta) in f32, no product in
      // flight; streamed columns past n_str get P = 0.  s[4 jj + e] is row
      // g + 8 (e / 2), column 8 jj + 2 t + (e % 2).
#pragma unroll
      for (int jj = 0; jj < kBlockC / 8; ++jj) {
        float2 lse_c = make_float2(0.0f, 0.0f);
        float2 delta_c = make_float2(0.0f, 0.0f);
        if constexpr (KV) {
          lse_c = ld_shared_f2(stats + (8 * jj + 2 * t) * 4);
          delta_c = ld_shared_f2(stats + T::kStatBytes + (8 * jj + 2 * t) * 4);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jj + e;
          const float lse = KV ? ((e & 1) ? lse_c.y : lse_c.x)
                               : row_lse[e / 2];
          const float d = KV ? ((e & 1) ? delta_c.y : delta_c.x)
                             : row_delta[e / 2];
          const float p = ex2(fmaf(s[i], scale_log2, -lse));
          s[i] = (n0 + 8 * jj + 2 * t + (e & 1) < n_str) ? p : 0.0f;
          dp[i] = s[i] * (dp[i] - d);
        }
      }
      // KV: dV += bf16(P^T) dO and dK += bf16(dS^T) Q; else dQ += bf16(dS) K
      pack(pk_s, dp);
      if constexpr (KV) pack(pk_p, s);
      fence_regs(acc1);
      fence_regs(acc2);
      fence_regs(pk_s);
      fence_regs(pk_p);
      wgmma_fence();
      if constexpr (KV) issue_rs(acc2, pk_p, c2);
      issue_rs(acc1, pk_s, c1);
      wgmma_commit();
      fence_regs(acc1);
      fence_regs(acc2);
      fence_regs(pk_s);
      fence_regs(pk_p);
      wgmma_wait<0>();
      fence_regs(acc1);
      fence_regs(acc2);
      fence_regs(pk_s);
      fence_regs(pk_p);
      if (tid == 0) mbar_arrive(c_empty + 8 * st);
    }

    // epilogue: both consumers are done reading the resident tiles (with
    // SPLIT they share their rows); each writes its rows and columns as bf16
    // into them (same 128-byte swizzle: 16-byte chunk c of row r at c ^
    // (r % 8)), then TMA stores that skip rows past n_res and columns past D
    named_sync(1, 256);
#pragma unroll
    for (int j = 0; j < T::kDW / 8; ++j) {
      const int col = col0 + 8 * j;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;  // row % 8 == g
        const uint32_t off = (col / kSubCols) * T::kRSub + row * kRowBytes +
                             ((((col % kSubCols) / 8) ^ g) << 4) + 4 * t;
        const uint32_t v1 = pack_bf16x2(acc1[4 * j + 2 * r] * out_scale,
                                        acc1[4 * j + 2 * r + 1] * out_scale);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(r1_rows + off), "r"(v1)
                     : "memory");
        if constexpr (KV) {
          const uint32_t v2 =
              pack_bf16x2(acc2[4 * j + 2 * r], acc2[4 * j + 2 * r + 1]);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(r2_rows + off),
                       "r"(v2)
                       : "memory");
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(2 + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int c = col0 / kSubCols; c < (col0 + T::kDW) / kSubCols; ++c) {
        tma_store(&maps.out1, r1_rows + c * T::kRSub, c * kSubCols, h,
                  r0 + row0, b);
        if constexpr (KV)
          tma_store(&maps.out2, r2_rows + c * T::kRSub, c * kSubCols, h,
                    r0 + row0, b);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// ---- host side ------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// (B, rows, H, D) contiguous bf16 as a 4-D map (D, H, rows, B), box
// (64, 1, box_rows, 1), 128-byte swizzle, out-of-range elements read as 0
bool make_map(CUtensorMap* map, const void* ptr, int B, int rows, int H, int D,
              int box_rows) {
  EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t strides[3] = {row, row * H, row * H * rows};
  const cuuint32_t box[4] = {kSubCols, 1, static_cast<cuuint32_t>(box_rows),
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

// more than 48 KB of dynamic shared memory: set once per device and kernel
template <int D_PAD, bool KV>
cudaError_t configure(int dev) {
  static bool configured[kMaxDevices] = {};
  if (configured[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<D_PAD, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BwdTiles<D_PAD, KV>::kSmemAlloc);
  if (err == cudaSuccess) configured[dev] = true;
  return err;
}

template <int D_PAD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* d_o, const void* lse, void* delta, void* dq, void* dk,
           void* dv, int B, int H, int L, int S, int D, float scale,
           cudaStream_t stream) {
  using TKV = BwdTiles<D_PAD, true>;
  using TQ = BwdTiles<D_PAD, false>;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = configure<D_PAD, true>(dev);
  if (err == cudaSuccess) err = configure<D_PAD, false>(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  BwdMaps kv, qm;
  if (!make_map(&kv.r1, k, B, S, H, D, TKV::kRows) ||
      !make_map(&kv.r2, v, B, S, H, D, TKV::kRows) ||
      !make_map(&kv.c1, q, B, L, H, D, kBlockC) ||
      !make_map(&kv.c2, d_o, B, L, H, D, kBlockC) ||
      !make_map(&kv.out1, dk, B, S, H, D, 64) ||
      !make_map(&kv.out2, dv, B, S, H, D, 64) ||
      !make_map(&qm.r1, q, B, L, H, D, TQ::kRows) ||
      !make_map(&qm.r2, d_o, B, L, H, D, TQ::kRows) ||
      !make_map(&qm.c1, k, B, S, H, D, kBlockC) ||
      !make_map(&qm.c2, v, B, S, H, D, kBlockC) ||
      !make_map(&qm.out1, dq, B, L, H, D, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  qm.out2 = qm.out1;
  const float scale_log2 = scale * 1.4426950408889634f;

  const long rows = static_cast<long>(B) * L * H;
  const long per_block = kDeltaThreads / kDeltaLanes;
  delta_kernel<<<static_cast<unsigned>((rows + per_block - 1) / per_block),
                 kDeltaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(d_o), static_cast<float*>(delta), rows,
      L, H, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_kernel<D_PAD, true>
      <<<dim3((S + TKV::kRows - 1) / TKV::kRows, B * H), kThreads,
         TKV::kSmemAlloc, stream>>>(kv, static_cast<const float*>(lse),
                                    static_cast<const float*>(delta), H, S, L,
                                    scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_kernel<D_PAD, false>
      <<<dim3((L + TQ::kRows - 1) / TQ::kRows, B * H), kThreads,
         TQ::kSmemAlloc, stream>>>(qm, static_cast<const float*>(lse),
                                   static_cast<const float*>(delta), H, L, S,
                                   scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dq, dk, dv (bf16, the layout of q, k, v) of the attention whose forward
// gave o and lse, for the upstream gradient d_o; delta is (B, H, L) f32
// scratch the caller allocates.  Launches three kernels on `stream`.
int echoscene_attention_backward_fa2(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* d_o,
                                     const void* lse, void* delta, void* dq,
                                     void* dk, void* dv, int B, int H, int L,
                                     int S, int D, float scale,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % 8 != 0 || S <= 0 || L <= 0 || B <= 0 || H <= 0 ||
      static_cast<long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 64)
    return launch<64>(q, k, v, o, d_o, lse, delta, dq, dk, dv, B, H, L, S, D,
                      scale, st);
  if (D <= 128)
    return launch<128>(q, k, v, o, d_o, lse, delta, dq, dk, dv, B, H, L, S, D,
                       scale, st);
  if (D <= 256)
    return launch<256>(q, k, v, o, d_o, lse, delta, dq, dk, dv, B, H, L, S, D,
                       scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
