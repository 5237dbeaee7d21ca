// Backward of non-causal softmax attention for Hopper (sm_90a), bf16.
//
// Computes what JAX's `_fa_bwd` computes (echoscene_tpu/kernels/
// flash_attention.py:237-240: jax.vjp of `_einsum_reference`, XLA einsums,
// no Pallas kernel): dq, dk, dv of O = softmax(Q K^T D^-1/2) V for an
// upstream gradient dO, at K1's training site (the shape UNet's 1024-token
// self-attention, 8 heads of dim 56) and K2's (the VQ-VAE's 4096-token
// single-head attention, D = 256).  The forward (csrc/flash_attention.cu)
// writes each row's log-sum-exp in the log2 domain, lse = m + log2(l), so
// P = exp2(S c - lse), c = D^-1/2 log2 e, is recomputed here without a
// softmax pass.
//
// The algorithm is FlashAttention-2's, in two launches on one stream:
//   1. delta_kernel: delta = rowsum(dO * O) in f32, (B, H, L);
//   2. bwd_kernel, one grid for both passes: its first CTAs are key tiles
//      (the dK / dV pass: a CTA holds the tile's K and V, query tiles
//      stream through a ring of Q, dO, lse and delta; per query tile
//      S^T = K Q^T, dP^T = V dO^T, P^T = exp2(S^T c - lse),
//      dS^T = P^T (dP^T - delta), dV += bf16(P^T) dO, dK += bf16(dS^T) Q),
//      the rest query tiles (the dQ pass: Q and dO held, key tiles stream
//      through the ring of K and V; S, dP, P, dS as above, dQ += bf16(dS)
//      K).  The dQ tiles need nothing the dK / dV tiles write, so they fill
//      the last wave of the dK / dV tiles instead of waiting for it to
//      drain.  `flash_attention.backward_plan` lays out the grid
//      (`backward_tile_order` lists it); the entry point rejects a plan
//      whose tile rows or grid do not fit this source.
// dQ is summed in the registers of one CTA in one order: no atomics, so two
// runs give the same bits (the data-parallel step is held bit-equal to the
// single step, checkpoint resumes bit-exact).  P and dS are rounded to
// bf16 only as the operands of their products (as the plain path rounds
// p); dS is formed from the f32 P; dQ and dK are scaled by D^-1/2 in the
// epilogue.
//
// Products a (key tile, query tile) pair: 7 at every D_pad (S and dP in
// each pass, dV and dK in the first, dQ in the second), where an atomic dQ
// needs 5.
//
// What bounds it on the H100: the products.  At K1's training shape
// (8, 1024, 8, 56) D pads to 64 and the 7 products are 60 GFLOP, 0.061 ms
// at 989 TFLOP/s; the exponentials (two per score) 0.034 ms on the SFU.
// At K2's (8, 4096, 1, 256) the 7 products are 481 GFLOP, 0.49 ms.
//
// Design.  3 warpgroups a CTA, one CTA an SM (`__launch_bounds__(384,
// 1)`): warpgroup 2 is the producer (setmaxnreg 24; lane 0 of its first
// warp issues every TMA load, the warp's 32 lanes copy lse and delta, the
// next tile's loaded into registers while the ring waits), warpgroups 0 and
// 1 the consumers (setmaxnreg 240).
//   * D_pad 64 is persistent: min(tiles, SMs) CTAs walk the tiles in a
//     fixed order, with two resident buffers, so that a tile's resident
//     loads and first stages arrive while the tile before still computes,
//     and its epilogue's stores run under the next tile.  At D_pad 128 and
//     256 shared memory holds one resident buffer, and a CTA takes one tile
//     (with one buffer a persistent walk was no faster, and its loop state
//     made both spill).
//   * D_pad 64 and 128: 128 resident rows a CTA, 64 a consumer, each
//     computing all 4 (or 3) products of its rows.  At D_pad 64 the
//     consumer's resident rows of K and V (or Q and dO) sit in registers
//     as wgmma A fragments (loaded once a tile), so S and dP read only
//     their B operand from shared memory.  The two consumers take
//     turns to issue their products (named barriers 1 and 2, as the
//     forward's), so one warpgroup's exponentials run under the other's
//     products; and a consumer issues tile j + 1's S and dP together with
//     tile j's dV / dK (or dQ), then computes P and dS of tile j + 1 while
//     those run (`kPipelined`).  That holds S, dP, the packed P and dS,
//     the A fragments and the accumulators at once: 192 registers a thread
//     at D_pad 64; at D_pad 128 the dK / dV tiles would hold 224 and spill
//     with the exponentials' temporaries, so they compute S / dP and the
//     gradients of a tile in turn (the dQ tiles there, 144, are
//     pipelined).
//   * D_pad 256: dK and dV of 64 rows x 256 columns would take 256
//     registers a thread, so a CTA holds 64 resident rows and the two
//     consumers split the output columns, 128 each.  S and dP are computed
//     once a tile: consumer 0 issues S and forms the f32 P, consumer 1
//     issues dP and forms dS.  They exchange through shared memory, in the
//     accumulator's own thread layout (thread i's 32 values as 8 16-byte
//     chunks, chunk-major, so a warp's access is 512 contiguous bytes):
//     the f32 P (16 KB, barrier 6),
//     from which consumer 1 forms dS and its bf16 P operand, and bf16 dS as
//     register-A fragments (8 KB, barrier 7).  Each then issues its half of
//     dV / dK (or dQ).  Not pipelined: the 2-stage ring would then have to
//     hold two tiles in use and no tile in flight.
//   * q, k, v, o, dO and the outputs are 4-D tensor maps (D, H, rows, B),
//     box (64, 1, rows, 1), 128-byte swizzle, as in the forward: TMA
//     zero-fills d >= D and rows past L or S, so no row or column needs a
//     mask except the streamed keys past S in the dQ tiles (P = 0 there; a
//     padded query column of the dK / dV tiles is masked the same way).
//   * The streamed ring has 4 stages (2 at D_pad 256), each a 64-row tile
//     of the two streamed tensors (TMA) and, in the dK / dV tiles, its 64
//     lse and delta values, with a full and an empty mbarrier per stage.
//   * S and dP are wgmma m64n64k16 with both operands K-major in swizzled
//     shared memory (A from registers at D_pad 64, above); P (or dS) is
//     packed to bf16 in registers as the A
//     fragment of a register-A wgmma whose B operand (dO, Q or K) is read
//     MN-major straight from its TMA tile, as the forward's P V.
//   * Epilogue: the accumulators as bf16 into the resident tiles' shared
//     memory (same swizzle), then TMA stores that skip rows and columns
//     past the tensor.
// Shared memory: resident tiles 2 x 128 x D_pad x 2 B a buffer (64 rows at
// D_pad 256), the ring's stages 2 x 64 x D_pad x 2 B each, 512 B of lse /
// delta a stage, and the exchange at D_pad 256: 130 KB at D_pad 64 (2 x 32 +
// 64 + 2), 194 KB at 128 (64 + 128 + 2), 217 KB at 256 (64 + 128 + 1 + 24),
// of the 227 KB a CTA may use.
// The producer's waits trap after ~2^26 polls, and it waits for the
// consumers' last releases, so a refused TMA load fails the launch instead
// of hanging the card; the consumers' waits do not trap (a trap in their
// code keeps ptxas from giving them the registers setmaxnreg grants).
// Instantiated for D_pad = 64, 128 and 256.  TMA needs 16-byte global
// strides, so D % 8 == 0; the wrapper raises otherwise.
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
// Design switches; kernels/attention_bwd_variants.py times the kernel with
// each turned off by a text edit of its line.
constexpr bool kTurns = true;      // the consumers take turns to issue
constexpr bool kPipelined = true;  // S / dP of tile j + 1 beside tile j's
                                   // gradient products, where registers allow
constexpr bool kRegisterA = true;  // D_pad 64: S and dP with the resident
                                   // rows as register A fragments
// named barriers (0 is __syncthreads)
constexpr int kBarTurn = 1;      // 1 + wg: consumer wg's turn
constexpr int kBarDone = 3;      // both consumers done with resident tiles
constexpr int kBarStore = 4;     // 4 + wg: consumer wg's epilogue writes
constexpr int kBarP = 6;         // D_pad 256: a tile's P in the exchange
constexpr int kBarDS = 7;        // D_pad 256: a tile's dS in the exchange

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
// giving them the registers setmaxnreg grants.
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

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_shared_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_f4(uint32_t addr, float a, float b,
                                             float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

__device__ __forceinline__ void ld_shared_u4(uint32_t addr,
                                             uint32_t (&v)[4]) {
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void st_shared_u4(uint32_t addr,
                                             const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
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

// D (64 x 64) (+)= A (64 x 16, bf16 registers) B (64 x 16, smem, K-major);
// scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_n64_k(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
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

// ---- the dK / dV and dQ tiles ----------------------------------------------

template <int D_PAD>
struct BwdTiles {
  static constexpr bool kSplit = D_PAD == 256;  // consumers split columns
  static constexpr int kRows = kSplit ? 64 : 128;        // resident rows
  static constexpr int kDW = kSplit ? D_PAD / 2 : D_PAD;  // columns a consumer
  static constexpr int kStages = kSplit ? 2 : 4;
  static constexpr int kSubs = D_PAD / kSubCols;
  static constexpr int kRSub = kRows * kRowBytes;
  static constexpr int kRBytes = kSubs * kRSub;    // one resident tile
  static constexpr int kCSub = kBlockC * kRowBytes;
  static constexpr int kCBytes = kSubs * kCSub;    // one streamed tile
  static constexpr int kStatBytes = kBlockC * 4;   // lse or delta of a tile
  // D_pad 64: persistent, with two resident buffers, so that the producer
  // loads a CTA's next tile while the consumers work on this one (at D_pad
  // 128 and 256 shared memory holds one buffer, and a CTA takes one tile)
  static constexpr bool kPersistent = D_PAD == 64;
  static constexpr int kResBufs = kPersistent ? 2 : 1;
  static constexpr int kR1 = 0;       // buffer rb: R1, then R2, at rb kResBytes
  static constexpr int kResBytes = 2 * kRBytes;
  static constexpr int kC = kResBufs * kResBytes;  // stage st: C1, then C2
  static constexpr int kStats = kC + kStages * 2 * kCBytes;
  // the exchange (kSplit): f32 P, then bf16 dS fragments, of 64 x 64
  static constexpr int kXP = kStats + kStages * 2 * kStatBytes;
  static constexpr int kXDS = kXP + (kSplit ? kBlockC * kBlockC * 4 : 0);
  static constexpr int kBars = kXDS + (kSplit ? kBlockC * kBlockC * 2 : 0);
  // r_full and r_empty per resident buffer, c_full and c_empty per stage
  static constexpr int kSmem = kBars + 8 * (2 * kResBufs + 2 * kStages);
  static constexpr int kSmemAlloc = kSmem + 1024;  // room to align to 1024
  static constexpr int kTx = 2 * kCBytes;          // TMA bytes a stage
  static_assert(kSmemAlloc <= 232448, "shared memory over the 227 KB");
  static __device__ uint32_t r_full(uint32_t base, int rb) {
    return base + kBars + 8 * rb;
  }
  static __device__ uint32_t r_empty(uint32_t base, int rb) {
    return base + kBars + 8 * (kResBufs + rb);
  }
  static __device__ uint32_t c_full(uint32_t base, int j) {
    return base + kBars + 8 * (2 * kResBufs + j % kStages);
  }
  static __device__ uint32_t c_empty(uint32_t base, int j) {
    return base + kBars + 8 * (2 * kResBufs + kStages + j % kStages);
  }
};

struct BwdMaps {
  CUtensorMap r1, r2;      // resident: K, V (KV) or Q, dO
  CUtensorMap c1, c2;      // streamed: Q, dO (KV) or K, V
  CUtensorMap out1, out2;  // dK, dV (KV) or dQ (out2 unused)
};

// Where a CTA's tile lies: (b, h), its first resident row, the resident and
// streamed lengths (S / L for KV, L / S for dQ).
struct TileAt {
  int bh, b, h, r0, n_res, n_str;
};

// The producer warp, for the CTA's it-th tile (resident buffer it %
// kResBufs; cj streamed tiles went through the ring before it): lane 0
// issues every TMA load; in the dK / dV tiles the 32 lanes also copy each
// query tile's lse and delta into the stage (plain loads: a (b, h) row of L
// floats need not start 16-byte aligned, which a TMA box would need), the
// next one's loaded while the ring waits.  With one resident buffer the
// tile's first stages load before its resident tiles, while the consumers
// still write out the tile before.
template <int D_PAD, bool KV>
__device__ __forceinline__ void produce(const BwdMaps& maps,
                                        const float* __restrict__ lse_p,
                                        const float* __restrict__ delta_p,
                                        uint32_t base, const TileAt& at,
                                        int lane, int it, int cj) {
  using T = BwdTiles<D_PAD>;
  const int n_tiles = (at.n_str + kBlockC - 1) / kBlockC;
  const int rb = it % T::kResBufs;
  auto load_resident = [&]() {
    mbar_wait_or_trap(T::r_empty(base, rb), ((it / T::kResBufs) & 1) ^ 1);
    if (lane == 0) {
      const uint32_t full = T::r_full(base, rb);
      const uint32_t r1 = base + T::kR1 + rb * T::kResBytes;
      mbar_expect_tx(full, 2 * T::kRBytes);
#pragma unroll
      for (int c = 0; c < T::kSubs; ++c) {
        tma_load(r1 + c * T::kRSub, &maps.r1, full, c * kSubCols, at.h,
                 at.r0, at.b);
        tma_load(r1 + T::kRBytes + c * T::kRSub, &maps.r2, full,
                 c * kSubCols, at.h, at.r0, at.b);
      }
    }
  };
  const int jr = T::kResBufs > 1 ? -1 : min(n_tiles, T::kStages) - 1;
  if (jr < 0) load_resident();
  const long row = static_cast<long>(at.bh) * at.n_str;
  float lse_n[2] = {0.0f, 0.0f};
  float delta_n[2] = {0.0f, 0.0f};
  auto fetch = [&](int j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int col = j * kBlockC + lane + 32 * r;
      lse_n[r] = col < at.n_str ? lse_p[row + col] : 0.0f;
      delta_n[r] = col < at.n_str ? delta_p[row + col] : 0.0f;
    }
  };
  if constexpr (KV) fetch(0);
  for (int j = 0; j < n_tiles; ++j) {
    const int cjj = cj + j;  // the ring's count
    const int st = cjj % T::kStages;
    mbar_wait_or_trap(T::c_empty(base, cjj), ((cjj / T::kStages) & 1) ^ 1);
    if constexpr (KV) {
      const uint32_t stats = base + T::kStats + st * 2 * T::kStatBytes;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t at_e = stats + 4 * (lane + 32 * r);
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(at_e), "f"(lse_n[r])
                     : "memory");
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(at_e + T::kStatBytes),
                     "f"(delta_n[r])
                     : "memory");
      }
      __threadfence_block();
      __syncwarp();
    }
    if (lane == 0) {
      // the arrival releases the lanes' stores; the consumers acquire them
      // with the stage's TMA bytes
      const uint32_t full = T::c_full(base, cjj);
      const uint32_t c1 = base + T::kC + st * 2 * T::kCBytes;
      mbar_expect_tx(full, T::kTx);
#pragma unroll
      for (int c = 0; c < T::kSubs; ++c) {
        tma_load(c1 + c * T::kCSub, &maps.c1, full, c * kSubCols, at.h,
                 j * kBlockC, at.b);
        tma_load(c1 + T::kCBytes + c * T::kCSub, &maps.c2, full,
                 c * kSubCols, at.h, j * kBlockC, at.b);
      }
    }
    if constexpr (KV)
      if (j + 1 < n_tiles) fetch(j + 1);
    if (j == jr) load_resident();
  }
}

// A consumer warpgroup (wg 0 or 1, thread tid of 128) of the CTA's it-th
// tile, a dK / dV (KV) or dQ tile (resident buffer it % kResBufs; cj
// streamed tiles went through the ring before it; last_work: the CTA's last
// tile).
template <int D_PAD, bool KV>
__device__ __forceinline__ void consume(const BwdMaps& maps,
                                        const float* __restrict__ lse_p,
                                        const float* __restrict__ delta_p,
                                        uint32_t base, const TileAt& at,
                                        int wg, int tid, int it, int cj,
                                        bool last_work, float scale_log2,
                                        float out_scale) {
  using T = BwdTiles<D_PAD>;
  constexpr bool kSplit = T::kSplit;
  // registers held while a tile's gradient products run and the next
  // tile's S and dP are formed: the accumulators, S, dP, the packed P and
  // dS (the packed P only in KV) and, kRegA, the resident A fragments
  constexpr bool kRegA = kRegisterA && D_PAD == 64;
  constexpr int kLive = (KV ? 2 : 1) * T::kDW / 2 + 2 * kBlockC / 2 +
                        (KV ? 2 : 1) * kBlockC / 4 + (kRegA ? D_PAD / 2 : 0);
  constexpr bool kPipe = kPipelined && !kSplit && kLive <= 192;
  const int rb = it % T::kResBufs;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int n_tiles = (at.n_str + kBlockC - 1) / kBlockC;
  const int row0 = kSplit ? 0 : 64 * wg;        // this consumer's rows
  const int col0 = kSplit ? T::kDW * wg : 0;    // ... and columns
  const uint32_t r1_rows =
      base + T::kR1 + rb * T::kResBytes + row0 * kRowBytes;
  const uint32_t r2_rows = r1_rows + T::kRBytes;

  float acc1[T::kDW / 2];            // dK or dQ: bf16(dS) C1
  float acc2[KV ? T::kDW / 2 : 1];   // dV: bf16(P) C2
  float s[kBlockC / 2];              // S, then P (f32); kSplit: S / dP
  float dp[kSplit ? 1 : kBlockC / 2];  // dP, then dS (f32)
  uint32_t pk_s[kBlockC / 16][4];    // dS as bf16 A fragments
  uint32_t pk_p[KV ? kBlockC / 16 : 1][4];  // P as bf16 A fragments
  uint32_t ra1[kRegA ? D_PAD / 16 : 1][4];  // kRegA: R1, R2 rows as A
  uint32_t ra2[kRegA ? D_PAD / 16 : 1][4];  // fragments, loaded once
#pragma unroll
  for (int i = 0; i < T::kDW / 2; ++i) acc1[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (KV ? T::kDW / 2 : 1); ++i) acc2[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kBlockC / 2; ++i) s[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (kSplit ? 1 : kBlockC / 2); ++i) dp[i] = 0.0f;

  // the dQ tiles' per-row statistics (rows past L: lse 0, delta 0; their
  // Q and dO rows are zero, so their dS is 0 and the store skips them).
  // Every lane loads (a clamped row) and selects: a lane-dependent branch
  // here would leave the warp diverged at the first aligned wgmma.
  float row_lse[2] = {0.0f, 0.0f};
  float row_delta[2] = {0.0f, 0.0f};
  if constexpr (!KV) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = at.r0 + row0 + warp * 16 + g + 8 * r;
      const long idx =
          static_cast<long>(at.bh) * at.n_res + min(row, at.n_res - 1);
      const float lse_v = lse_p[idx];
      const float delta_v = delta_p[idx];
      row_lse[r] = row < at.n_res ? lse_v : 0.0f;
      row_delta[r] = row < at.n_res ? delta_v : 0.0f;
    }
  }
  __syncwarp();

  // streamed tile j of this tile is the ring's tile cj + j
  auto c1_of = [&](int j) {
    return base + T::kC + ((cj + j) % T::kStages) * 2 * T::kCBytes;
  };
  auto stats_of = [&](int j) {
    return base + T::kStats + ((cj + j) % T::kStages) * 2 * T::kStatBytes;
  };
  auto wait_full = [&](int j) {
    mbar_wait(T::c_full(base, cj + j), ((cj + j) / T::kStages) & 1);
  };
  auto release = [&](int j) {
    if (tid == 0) mbar_arrive(T::c_empty(base, cj + j));
  };
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
  // the same with this consumer's resident rows in registers (kRegA)
  auto issue_rk = [&](float (&x)[kBlockC / 2],
                      const uint32_t (&a)[D_PAD / 16][4], uint32_t c_tile) {
    asm volatile("" : "+r"(c_tile));
#pragma unroll
    for (int kk = 0; kk < D_PAD / 16; ++kk) {
      const uint64_t db = gmma_desc(
          c_tile + (kk / 4) * T::kCSub + (kk % 4) * 32, 16, 8 * kRowBytes);
      wgmma_rs_n64_k(x, a[kk], db, kk > 0);
    }
  };
  // A fragments of this consumer's 64 rows of a resident tile: register e
  // of k-step kk holds row 16 warp + g + 8 (e % 2), columns 16 kk + 8 (e /
  // 2) + 2 t, + 1 (the 128-byte swizzle: 16-byte chunk c of row r at c ^
  // (r % 8), and r % 8 == g)
  auto load_a = [&](uint32_t (&a)[D_PAD / 16][4], uint32_t r_rows) {
#pragma unroll
    for (int kk = 0; kk < D_PAD / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = warp * 16 + g + 8 * (e & 1);
        const int chunk = 2 * (kk % 4) + (e >> 1);
        const uint32_t addr = r_rows + (kk / 4) * T::kRSub + row * kRowBytes +
                              ((chunk ^ g) << 4) + 4 * t;
        asm volatile("ld.shared.b32 %0, [%1];\n"
                     : "=r"(a[kk][e])
                     : "r"(addr)
                     : "memory");
      }
  };
  // acc (64 x kDW) += a (64 x 64 streamed) C(tile)[:, col0 : col0 + kDW]:
  // C is the MN-major B operand, a k-step 16 streamed rows (two 8-row
  // swizzle atoms, SBO apart), the N range the 64-column sub-tiles (LBO)
  auto issue_rs = [&](float (&acc)[T::kDW / 2],
                      const uint32_t (&a)[kBlockC / 16][4], uint32_t c_tile) {
    asm volatile("" : "+r"(c_tile));
#pragma unroll
    for (int kc = 0; kc < kBlockC / 16; ++kc) {
      const uint64_t db = gmma_desc(
          c_tile + (col0 / kSubCols) * T::kCSub + kc * 16 * kRowBytes,
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
  // the gradient products of tile j: KV dV += bf16(P^T) dO and dK +=
  // bf16(dS^T) Q; else dQ += bf16(dS) K; one commit group
  auto issue_grads = [&](int j) {
    const uint32_t c1 = c1_of(j);
    fence_regs(acc1);
    fence_regs(acc2);
    fence_regs(pk_s);
    fence_regs(pk_p);
    wgmma_fence();
    if constexpr (KV) issue_rs(acc2, pk_p, c1 + T::kCBytes);
    issue_rs(acc1, pk_s, c1);
    wgmma_commit();
    fence_regs(acc1);
    fence_regs(acc2);
    fence_regs(pk_s);
    fence_regs(pk_p);
  };
  auto grads_done = [&](int j) {
    wgmma_wait<0>();
    fence_regs(acc1);
    fence_regs(acc2);
    fence_regs(pk_s);
    fence_regs(pk_p);
    release(j);
  };
  // P = exp2(S c - lse) of tile j in place; streamed columns past n_str
  // get P = 0.  x[4 jj + e] is row g + 8 (e / 2), column 8 jj + 2 t +
  // (e % 2).
  auto to_p = [&](float (&x)[kBlockC / 2], int j) {
    const int n0 = j * kBlockC;
    const uint32_t stats = stats_of(j);
#pragma unroll
    for (int jj = 0; jj < kBlockC / 8; ++jj) {
      float2 lse_c = make_float2(0.0f, 0.0f);
      if constexpr (KV) lse_c = ld_shared_f2(stats + (8 * jj + 2 * t) * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jj + e;
        const float lse = KV ? ((e & 1) ? lse_c.y : lse_c.x) : row_lse[e / 2];
        const float p = ex2(fmaf(x[i], scale_log2, -lse));
        x[i] = (n0 + 8 * jj + 2 * t + (e & 1) < at.n_str) ? p : 0.0f;
      }
    }
  };
  // dS = P (dP - delta) of tile j in place in y; p_at(jj) gives P's
  // elements 4 jj .. 4 jj + 3
  auto to_ds = [&](float (&y)[kBlockC / 2], int j, auto p_at) {
    const uint32_t stats = stats_of(j);
#pragma unroll
    for (int jj = 0; jj < kBlockC / 8; ++jj) {
      float2 delta_c = make_float2(0.0f, 0.0f);
      if constexpr (KV)
        delta_c = ld_shared_f2(stats + T::kStatBytes + (8 * jj + 2 * t) * 4);
      const float4 p = p_at(jj);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jj + e;
        const float d = KV ? ((e & 1) ? delta_c.y : delta_c.x)
                           : row_delta[e / 2];
        y[i] = pv[e] * (y[i] - d);
      }
    }
  };

  mbar_wait(T::r_full(base, rb), (it / T::kResBufs) & 1);
  if constexpr (kRegA) {
    load_a(ra1, r1_rows);
    load_a(ra2, r2_rows);
  }
  if constexpr (!kSplit) {
    // ---- D_pad 64 / 128: 64 resident rows a consumer, all products ----
    const int my_turn = kBarTurn + wg;
    const int other_turn = kBarTurn + 1 - wg;
    auto turn_begin = [&]() {
      if constexpr (kTurns) named_sync(my_turn, 256);
    };
    // warpgroup 1's very last turn is not followed by one of warpgroup 0
    auto turn_end = [&](bool last) {
      if constexpr (kTurns)
        if (wg == 0 || !(last && last_work)) named_arrive(other_turn, 256);
    };
    auto issue_sdp = [&](int j) {
      const uint32_t c1 = c1_of(j);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      if constexpr (kRegA) {
        issue_rk(s, ra1, c1);
        issue_rk(dp, ra2, c1 + T::kCBytes);
      } else {
        issue_ss(s, r1_rows, c1);
        issue_ss(dp, r2_rows, c1 + T::kCBytes);
      }
      wgmma_commit();
      fence_regs(s);
      fence_regs(dp);
    };
    auto softmax = [&](int j) {
      fence_regs(s);
      fence_regs(dp);
      to_p(s, j);
      to_ds(dp, j, [&](int jj) {
        return make_float4(s[4 * jj], s[4 * jj + 1], s[4 * jj + 2],
                           s[4 * jj + 3]);
      });
    };
    auto pack_all = [&]() {
      pack(pk_s, dp);
      if constexpr (KV) pack(pk_p, s);
    };

    if (kTurns && wg == 1 && it == 0)
      named_arrive(other_turn, 256);  // warpgroup 0 goes first
    wait_full(0);
    turn_begin();
    issue_sdp(0);
    turn_end(false);
    wgmma_wait<0>();
    softmax(0);
    pack_all();
    for (int j = 0; j + 1 < n_tiles; ++j) {
      wait_full(j + 1);
      turn_begin();
      if constexpr (kPipe) issue_sdp(j + 1);
      issue_grads(j);
      turn_end(false);
      if constexpr (kPipe) {
        wgmma_wait<1>();
        softmax(j + 1);
      }
      grads_done(j);
      if constexpr (!kPipe) {
        turn_begin();
        issue_sdp(j + 1);
        turn_end(false);
        wgmma_wait<0>();
        softmax(j + 1);
      }
      pack_all();
    }
    turn_begin();
    issue_grads(n_tiles - 1);
    turn_end(true);
    grads_done(n_tiles - 1);
  } else {
    // ---- D_pad 256: consumer 0 forms P, consumer 1 dS; each issues its
    // column half of the gradient products ----
    const uint32_t xp = base + T::kXP + tid * 16;    // + 2048 a chunk
    const uint32_t xds = base + T::kXDS + tid * 16;
    auto issue_x = [&](int j) {
      const uint32_t c1 = c1_of(j);
      fence_regs(s);
      wgmma_fence();
      issue_ss(s, wg == 0 ? r1_rows : r2_rows,
               wg == 0 ? c1 : c1 + T::kCBytes);
      wgmma_commit();
      fence_regs(s);
      wgmma_wait<0>();
      fence_regs(s);
    };
    if (wg == 0) {
      // S -> P, P to the exchange; dS of the tile from it
      auto put_p = [&]() {
#pragma unroll
        for (int c = 0; c < kBlockC / 8; ++c)
          st_shared_f4(xp + c * 2048, s[4 * c], s[4 * c + 1], s[4 * c + 2],
                       s[4 * c + 3]);
        named_arrive(kBarP, 256);
      };
      auto get_ds = [&]() {
        named_sync(kBarDS, 256);
#pragma unroll
        for (int kc = 0; kc < kBlockC / 16; ++kc)
          ld_shared_u4(xds + kc * 2048, pk_s[kc]);
      };
      for (int j = 0; j < n_tiles; ++j) {
        wait_full(j);
        issue_x(j);
        to_p(s, j);
        put_p();
        if constexpr (KV) pack(pk_p, s);
        get_ds();
        issue_grads(j);
        grads_done(j);
      }
    } else {
      // dP -> dS with the exchanged P; dS (and the bf16 P) to the exchange
      auto put_ds = [&]() {
        if constexpr (KV) {
#pragma unroll
          for (int kc = 0; kc < kBlockC / 16; ++kc) {
            const float4 a = ld_shared_f4(xp + (2 * kc) * 2048);
            const float4 b = ld_shared_f4(xp + (2 * kc + 1) * 2048);
            pk_p[kc][0] = pack_bf16x2(a.x, a.y);
            pk_p[kc][1] = pack_bf16x2(a.z, a.w);
            pk_p[kc][2] = pack_bf16x2(b.x, b.y);
            pk_p[kc][3] = pack_bf16x2(b.z, b.w);
          }
        }
        pack(pk_s, s);
#pragma unroll
        for (int kc = 0; kc < kBlockC / 16; ++kc)
          st_shared_u4(xds + kc * 2048, pk_s[kc]);
        named_arrive(kBarDS, 256);
      };
      for (int j = 0; j < n_tiles; ++j) {
        wait_full(j);
        issue_x(j);
        named_sync(kBarP, 256);
        to_ds(s, j, [&](int jj) { return ld_shared_f4(xp + jj * 2048); });
        put_ds();
        issue_grads(j);
        grads_done(j);
      }
    }
  }

  // epilogue: both consumers are done reading the resident tiles (with
  // kSplit they share their rows); each writes its rows and columns as bf16
  // into them (same 128-byte swizzle: 16-byte chunk c of row r at c ^
  // (r % 8)), then TMA stores that skip rows past n_res and columns past D
  named_sync(kBarDone, 256);
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
  named_sync(kBarStore + wg, 128);
  if (tid == 0) {
#pragma unroll
    for (int c = col0 / kSubCols; c < (col0 + T::kDW) / kSubCols; ++c) {
      tma_store(&maps.out1, r1_rows + c * T::kRSub, c * kSubCols, at.h,
                at.r0 + row0, at.b);
      if constexpr (KV)
        tma_store(&maps.out2, r2_rows + c * T::kRSub, c * kSubCols, at.h,
                  at.r0 + row0, at.b);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // the stores have read the buffer: the producer may load it again
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    mbar_arrive(T::r_empty(base, rb));
  }
}

template <int D_PAD>
__device__ __forceinline__ TileAt tile_at(int x, int tiles, int H, int n_res,
                                          int n_str) {
  TileAt at;
  at.bh = x / tiles;
  at.b = at.bh / H;
  at.h = at.bh % H;
  at.r0 = (x % tiles) * BwdTiles<D_PAD>::kRows;
  at.n_res = n_res;
  at.n_str = n_str;
  return at;
}

// CTA c takes tiles x0 + c, x0 + c + gridDim.x, ... below x_end of the
// B H (kv_tiles + q_tiles) tiles (flash_attention.backward_tile_order): tile
// x < kv_blocks = B H kv_tiles is key tile x % kv_tiles of (b, h) =
// x / kv_tiles, the rest query tiles in the same order.  Persistent (D_pad
// 64) the ring, the resident buffers and the consumers' turns run on across
// a CTA's tiles; else gridDim.x = x_end - x0, a tile a CTA.  One launch
// takes all tiles (x0 = 0).  lse_p / delta_p: (B, H, L) f32.
template <int D_PAD>
__global__ void __launch_bounds__(kThreads, 1)
bwd_kernel(const __grid_constant__ BwdMaps kv_maps,
           const __grid_constant__ BwdMaps q_maps,
           const float* __restrict__ lse_p, const float* __restrict__ delta_p,
           int H, int L, int S, int kv_tiles, int q_tiles, int kv_blocks,
           int x0, int x_end, float scale_log2, float out_scale) {
  using T = BwdTiles<D_PAD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int step = static_cast<int>(gridDim.x);
  auto at_of = [&](int tile) {
    return tile < kv_blocks
               ? tile_at<D_PAD>(tile, kv_tiles, H, S, L)
               : tile_at<D_PAD>(tile - kv_blocks, q_tiles, H, L, S);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < T::kResBufs; ++i) {
      mbar_init(T::r_full(base, i), 1);
      mbar_init(T::r_empty(base, i), 2);  // one arrival per consumer wg
    }
    for (int i = 0; i < T::kStages; ++i) {
      mbar_init(T::c_full(base, i), 1);
      mbar_init(T::c_empty(base, i), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the CTA's tiles: all of its walk when persistent, else its one tile
  // (no loop state to hold in the registers)
  auto walk = [&](auto&& body) {
    if constexpr (T::kPersistent) {
      int it = 0;  // this CTA's tiles so far
      int cj = 0;  // streamed tiles through the ring so far
      for (int tile = x0 + blockIdx.x; tile < x_end; tile += step, ++it) {
        const TileAt at = at_of(tile);
        body(tile, at, it, cj, tile + step >= x_end);
        cj += (at.n_str + kBlockC - 1) / kBlockC;
      }
      return cj;
    } else {
      const int tile = x0 + blockIdx.x;
      const TileAt at = at_of(tile);
      body(tile, at, 0, 0, true);
      return (at.n_str + kBlockC - 1) / kBlockC;
    }
  };
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid < 32) {
      const int cj = walk([&](int tile, const TileAt& at, int it, int c0,
                              bool) {
        if (tile < kv_blocks)
          produce<D_PAD, true>(kv_maps, lse_p, delta_p, base, at, tid, it,
                               c0);
        else
          produce<D_PAD, false>(q_maps, lse_p, delta_p, base, at, tid, it,
                                c0);
      });
      // the consumers' release of the last stages (ring tile j completes
      // phase j / kStages of its stage's empty barrier) and, persistent, of
      // the last resident buffers (after the epilogue's stores)
      for (int j = cj > T::kStages ? cj - T::kStages : 0; j < cj; ++j)
        mbar_wait_or_trap(T::c_empty(base, j), (j / T::kStages) & 1);
      if constexpr (T::kPersistent) {
        const int it = (x_end - x0 - static_cast<int>(blockIdx.x) + step - 1) /
                       step;
        for (int i = it > T::kResBufs ? it - T::kResBufs : 0; i < it; ++i)
          mbar_wait_or_trap(T::r_empty(base, i % T::kResBufs),
                            (i / T::kResBufs) & 1);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    walk([&](int tile, const TileAt& at, int it, int c0, bool last_work) {
      if (tile < kv_blocks)
        consume<D_PAD, true>(kv_maps, lse_p, delta_p, base, at, wg, tid, it,
                             c0, last_work, scale_log2, out_scale);
      else
        consume<D_PAD, false>(q_maps, lse_p, delta_p, base, at, wg, tid, it,
                              c0, last_work, scale_log2, out_scale);
    });
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
template <int D_PAD>
cudaError_t configure(int dev) {
  static bool configured[kMaxDevices] = {};
  if (configured[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<D_PAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BwdTiles<D_PAD>::kSmemAlloc);
  if (err == cudaSuccess) configured[dev] = true;
  return err;
}

template <int D_PAD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* d_o, const void* lse, void* delta, void* dq, void* dk,
           void* dv, int B, int H, int L, int S, int D, float scale, int rows,
           long ctas, cudaStream_t stream) {
  using T = BwdTiles<D_PAD>;
  const int kv_tiles = (S + T::kRows - 1) / T::kRows;
  const int q_tiles = (L + T::kRows - 1) / T::kRows;
  const long n_work = static_cast<long>(B) * H * (kv_tiles + q_tiles);
  // the caller's plan (flash_attention.backward_plan) must take this
  // source's tiles: at most one CTA a tile when persistent, else one each
  if (rows != T::kRows || ctas < 1 || ctas > n_work ||
      (!T::kPersistent && ctas != n_work) || n_work > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = static_cast<int>(n_work);
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = configure<D_PAD>(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  BwdMaps kv, qm;
  if (!make_map(&kv.r1, k, B, S, H, D, T::kRows) ||
      !make_map(&kv.r2, v, B, S, H, D, T::kRows) ||
      !make_map(&kv.c1, q, B, L, H, D, kBlockC) ||
      !make_map(&kv.c2, d_o, B, L, H, D, kBlockC) ||
      !make_map(&kv.out1, dk, B, S, H, D, 64) ||
      !make_map(&kv.out2, dv, B, S, H, D, 64) ||
      !make_map(&qm.r1, q, B, L, H, D, T::kRows) ||
      !make_map(&qm.r2, d_o, B, L, H, D, T::kRows) ||
      !make_map(&qm.c1, k, B, S, H, D, kBlockC) ||
      !make_map(&qm.c2, v, B, S, H, D, kBlockC) ||
      !make_map(&qm.out1, dq, B, L, H, D, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  qm.out2 = qm.out1;
  const float scale_log2 = scale * 1.4426950408889634f;

  const long n_rows = static_cast<long>(B) * L * H;
  const long per_block = kDeltaThreads / kDeltaLanes;
  delta_kernel<<<static_cast<unsigned>((n_rows + per_block - 1) / per_block),
                 kDeltaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(d_o), static_cast<float*>(delta),
      n_rows, L, H, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kv_blocks = B * H * kv_tiles;
  bwd_kernel<D_PAD><<<static_cast<unsigned>(ctas), kThreads, T::kSmemAlloc,
                      stream>>>(kv, qm, static_cast<const float*>(lse),
                                static_cast<const float*>(delta), H, L, S,
                                kv_tiles, q_tiles, kv_blocks, 0, tiles,
                                scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dq, dk, dv (bf16, the layout of q, k, v) of the attention whose forward
// gave o and lse, for the upstream gradient d_o; delta is (B, H, L) f32
// scratch the caller allocates.  rows / ctas: the plan's resident rows a
// tile and its grid (flash_attention.backward_plan: one CTA an SM, at most
// one a tile), rejected unless they fit this source.  Launches two kernels
// on `stream`.
int echoscene_attention_backward(const void* q, const void* k, const void* v,
                                 const void* o, const void* d_o,
                                 const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, int B, int H, int L,
                                 int S, int D, float scale, int rows,
                                 long ctas, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % 8 != 0 || S <= 0 || L <= 0 || B <= 0 || H <= 0 ||
      static_cast<long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 64)
    return launch<64>(q, k, v, o, d_o, lse, delta, dq, dk, dv, B, H, L, S, D,
                      scale, rows, ctas, st);
  if (D <= 128)
    return launch<128>(q, k, v, o, d_o, lse, delta, dq, dk, dv, B, H, L, S, D,
                       scale, rows, ctas, st);
  if (D <= 256)
    return launch<256>(q, k, v, o, d_o, lse, delta, dq, dk, dv, B, H, L, S, D,
                       scale, rows, ctas, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
