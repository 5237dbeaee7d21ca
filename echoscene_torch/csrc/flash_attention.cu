// Non-causal softmax attention for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the two Pallas TPU kernels of echoscene_tpu/kernels/flash_attention.py:
//   * _onepass_kernel (:73, driven by _onepass_impl): the shape UNet's
//     1024-token self-attention, 8 heads of dim 56, 5 launches per DDIM step;
//   * _stream_kernel (:35, driven by _stream_impl): the VQ-VAE decoder's
//     4096-token single-head attention with C = 256, one launch per decode
//     chunk.
// Both compute O = softmax(Q K^T * D^-1/2) V per (batch, head) with f32
// scores, f32 running max and sum, f32 accumulation of P V, P rounded to bf16
// as the A operand of P V, and the division by the row sum after P V, as the
// TPU kernels do.  The TPU split between "all of K/V resident in VMEM"
// (one-pass) and "K/V streamed in blocks" (stream) exists for VMEM capacity;
// on Hopper both entry points run the one streaming kernel below.
//
// What bounds it on the H100.  Per (batch, head) the function needs 4 L S D
// tensor-core flops and L S exponentials for 2 (2 L + 2 S) D bytes.  At the
// UNet site (L = S = 1024, D = 56) the exponentials bound it: one exp2 per
// score on the SFU (16 per SM per clock) takes about as long (0.084 ms) as
// the products at the full 989 TFLOP/s (0.080 ms), so the softmax has to run
// while the tensor cores work.  At the VQ-VAE site (L = S = 4096, D = 256)
// the products bound it (0.139 ms; the exponentials take a quarter of that).
// Bytes bound neither.
//
// Design: a persistent kernel, one CTA of three warpgroups per SM; each CTA
// walks over work tiles of 128 query rows of one (batch, head).
//   * Warpgroup 2 is the producer: it gives up its registers (setmaxnreg 24)
//     and one thread issues TMA loads: each tile's Q, and K and V tiles
//     through a ring of two slots each, with a full and an empty mbarrier
//     per slot (K and V have their own, so a K slot frees as soon as its
//     scores are done).  The ring runs on across work tiles, and with two Q
//     buffers the next tile's Q and first K/V tiles load while this tile
//     still computes.  q, k, v and o are described as 4-D tensor maps
//     (D, H, L|S, B) with a box of (64, 1, rows, 1) and the 128-byte
//     swizzle: TMA zero-fills d >= D and rows past L or S, so the head dim
//     is padded to 64 / 128 / 256 for free and no row is read twice.
//   * Warpgroups 0 and 1 are consumers (setmaxnreg 240), 64 query rows each.
//     S = Q K^T runs as wgmma m64nBLOCK_Nk16 with both operands K-major in
//     swizzled shared memory; the online softmax runs on the f32 accumulator
//     in the log2 domain (scale D^-1/2 log2 e folded into one FFMA before
//     ex2); P is packed to bf16 in registers as the A fragment of
//     O += P V, a register-A wgmma with V as the MN-major B operand read
//     straight from its TMA tile (no transposed copy).
//   * The loop is software-pipelined as in FlashAttention-3: a consumer
//     issues S(j+1) = Q K(j+1) and O += P(j) V(j) back to back, then runs the
//     softmax of S(j+1) while P(j) V(j) is still on the tensor cores.  The
//     two consumers take turns to issue (named barriers), so one
//     warpgroup's softmax overlaps the other's products.
//   * Epilogue: O / l is packed to bf16 into the warpgroup's own half of the
//     Q tile (same swizzle) and written by TMA stores, which skip rows past
//     L and columns past D.
// Instantiated for D_pad = 64 (BLOCK_N 128, two Q buffers, 96 KB of shared
// memory), 128 (BLOCK_N 128, two Q buffers, 192 KB) and 256 (BLOCK_N 80, one
// Q buffer, 224 KB).  TMA needs 16-byte global strides, so D % 8 == 0; the
// wrapper raises otherwise.
//
// Built by echoscene_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; each entry point returns a cudaError_t.
// cuTensorMapEncodeTiled (libcuda) is looked up at run time through the
// runtime's entry-point query, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 128;       // query rows per CTA, 64 per consumer
constexpr int kThreads = 384;      // 2 consumer warpgroups + 1 producer
constexpr int kSubCols = 64;       // bf16 columns per 128-byte swizzle row
constexpr int kRowBytes = 128;
constexpr int kStages = 2;        // slots of the K ring and of the V ring

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

// spin until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
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

// Pins wgmma operand registers at this point of the program, so the
// compiler neither reads an accumulator before the wgmma that writes it has
// been waited for nor moves other instructions on them in between a
// wgmma.fence and its wgmma (ptxas would then serialize every wgmma).
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

// D (64 x N, f32, registers) (+)= A (64 x 16, smem, K-major) B (N x 16, smem,
// K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n80(float (&d)[40],
                                              uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64],
                                              uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 80 || N == 128, "no wgmma wrapper for this BLOCK_N");
  if constexpr (N == 80) wgmma_ss_n80(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

// D (64 x N) += A (64 x 16, bf16 registers) B (16 x N, smem, MN-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 64 || N == 128 || N == 256, "no wgmma wrapper for N");
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, 1);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db, 1);
  else wgmma_rs_n256(d, a, db, 1);
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

// ---- the kernel -----------------------------------------------------------

template <int D_PAD, int BLOCK_N, int QBUF>
struct Tiles {
  static constexpr int kSubs = D_PAD / kSubCols;  // 64-column sub-tiles
  static constexpr int kQSub = kBlockM * kRowBytes;
  static constexpr int kKVSub = BLOCK_N * kRowBytes;
  static constexpr int kQBytes = kSubs * kQSub;    // one Q (and O) tile
  static constexpr int kKVBytes = kSubs * kKVSub;  // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + QBUF * kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes;
  // q_full, q_empty per Q buffer; k_full, v_full, k_empty, v_empty per stage
  static constexpr int kSmem = kBars + 8 * (2 * QBUF + 4 * kStages);
  static constexpr int kSmemAlloc = kSmem + 1024;  // room to align to 1024
};

// Online softmax of one score tile in the log2 domain.  s holds this
// thread's part of a 64 x BLOCK_N tile in the wgmma accumulator layout:
// s[4j + e] is row g + 8 (e / 2), column 8 j + 2 t + (e % 2).  On return s
// holds the f32 probabilities, m the new row maxima (scaled), alpha the
// factor for the earlier sums, l this thread's partial row sums.  Maxima
// and sums run in four independent chains per row, so the exponentials
// do not wait on one long dependent chain.
template <int BLOCK_N>
__device__ __forceinline__ void online_softmax(float (&s)[BLOCK_N / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int n0,
                                               int S, float scale_log2,
                                               int t) {
  if (n0 + BLOCK_N > S) {  // last tile: key columns >= S get -inf
#pragma unroll
    for (int i = 0; i < BLOCK_N / 2; ++i) {
      const int col = n0 + (i / 4) * 8 + 2 * t + (i & 1);
      if (col >= S) s[i] = -INFINITY;
    }
  }
  // element i belongs to row (i >> 1) & 1 and chain ((i >> 2) & 1) * 2 + i % 2
  float mx[2][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) mx[0][c] = mx[1][c] = -INFINITY;
#pragma unroll
  for (int i = 0; i < BLOCK_N / 2; ++i) {
    float& acc = mx[(i >> 1) & 1][((i >> 2) & 1) * 2 + (i & 1)];
    acc = fmaxf(acc, s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, 2));
    const float m_new = fmaxf(m[r], x * scale_log2);
    alpha[r] = ex2(m[r] - m_new);  // ex2(-inf) = 0 on the first tile
    m[r] = m_new;
  }
  const float neg_m[2] = {-m[0], -m[1]};
  float sum[2][4] = {};
#pragma unroll
  for (int i = 0; i < BLOCK_N / 2; ++i) {
    const int r = (i >> 1) & 1;
    const float p = ex2(fmaf(s[i], scale_log2, neg_m[r]));
    s[i] = p;
    sum[r][((i >> 2) & 1) * 2 + (i & 1)] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = fmaf(l[r], alpha[r],
                (sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
}

// Persistent: grid = min(tiles, SMs) CTAs of 384 threads; CTA c takes the
// tiles c, c + gridDim.x, ...; tile = q_tile + n_q * (b * H + h).  The
// K/V ring and its phases run on across tiles, and the producer loads the
// next tile's Q (into the other of QBUF buffers) while the consumers still
// work on this one.
template <int D_PAD, int BLOCK_N, int QBUF>
__global__ void __launch_bounds__(kThreads, 1)
attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_o, int H, int S,
                 int n_q, int n_work, float scale_log2) {
  using T = Tiles<D_PAD, BLOCK_N, QBUF>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base + T::kQ;
  const uint32_t sK = base + T::kK;
  const uint32_t sV = base + T::kV;
  const uint32_t q_full = base + T::kBars;
  const uint32_t q_empty = q_full + 8 * QBUF;
  const uint32_t k_full = q_empty + 8 * QBUF;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int n_tiles = (S + BLOCK_N - 1) / BLOCK_N;

  if (threadIdx.x == 0) {
    for (int i = 0; i < QBUF; ++i) {
      mbar_init(q_full + 8 * i, 1);
      mbar_init(q_empty + 8 * i, 2);  // one arrival per consumer warpgroup
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(k_full + 8 * i, 1);
      mbar_init(v_full + 8 * i, 1);
      mbar_init(k_empty + 8 * i, 2);
      mbar_init(v_empty + 8 * i, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      int kv = 0;  // K/V tiles loaded so far
      for (int w = blockIdx.x, it = 0; w < n_work; w += gridDim.x, ++it) {
        const int q0 = (w % n_q) * kBlockM;
        const int b = (w / n_q) / H;
        const int h = (w / n_q) % H;
        const int qb = it % QBUF;
        for (int j = 0; j < n_tiles; ++j, ++kv) {
          const int st = kv % kStages;
          const uint32_t par = ((kv / kStages) & 1) ^ 1;  // 1st round passes
          const int n0 = j * BLOCK_N;
          mbar_wait(k_empty + 8 * st, par);
          mbar_expect_tx(k_full + 8 * st, T::kKVBytes);
#pragma unroll
          for (int c = 0; c < T::kSubs; ++c)
            tma_load(sK + st * T::kKVBytes + c * T::kKVSub, &tm_k,
                     k_full + 8 * st, c * kSubCols, h, n0, b);
          if (j == 0) {
            // Q after the first K tile: with one Q buffer the K tile need
            // not wait for the previous tile's epilogue
            mbar_wait(q_empty + 8 * qb, ((it / QBUF) & 1) ^ 1);
            mbar_expect_tx(q_full + 8 * qb, T::kQBytes);
#pragma unroll
            for (int c = 0; c < T::kSubs; ++c)
              tma_load(sQ + qb * T::kQBytes + c * T::kQSub, &tm_q,
                       q_full + 8 * qb, c * kSubCols, h, q0, b);
          }
          mbar_wait(v_empty + 8 * st, par);
          mbar_expect_tx(v_full + 8 * st, T::kKVBytes);
#pragma unroll
          for (int c = 0; c < T::kSubs; ++c)
            tma_load(sV + st * T::kKVBytes + c * T::kKVSub, &tm_v,
                     v_full + 8 * st, c * kSubCols, h, n0, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    // turn barriers: warpgroup w issues its products after bar 1 + w
    const int my_turn = 1 + wg;
    const int other_turn = 2 - wg;

    float o[D_PAD / 2];
    float s[BLOCK_N / 2];
    uint32_t p[BLOCK_N / 16][4];
    float m[2], l[2], alpha[2];
#pragma unroll
    for (int i = 0; i < BLOCK_N / 2; ++i) s[i] = 0.0f;
    uint32_t q_rows = sQ;  // this warpgroup's rows of the current Q tile

    // S = Q K(tile)^T: the k-loop walks the 64-column sub-tiles, 32 bytes
    // (16 columns) at a time inside each swizzled row
    auto issue_scores = [&](int stage) {
      const uint32_t k_tile = sK + stage * T::kKVBytes;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D_PAD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        const uint64_t da = gmma_desc(q_rows + (kk / 4) * T::kQSub + off, 16,
                                      8 * kRowBytes);
        const uint64_t db = gmma_desc(k_tile + (kk / 4) * T::kKVSub + off, 16,
                                      8 * kRowBytes);
        wgmma_ss<BLOCK_N>(s, da, db, kk > 0);
      }
      wgmma_commit();
      fence_regs(s);
    };
    // O += P V(tile): V is the MN-major B operand; a k-step covers 16 key
    // rows (two 8-row swizzle atoms, SBO apart), the N range walks the
    // 64-column sub-tiles (LBO apart)
    auto issue_pv = [&](int stage) {
      const uint32_t v_tile = sV + stage * T::kKVBytes;
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BLOCK_N / 16; ++kc) {
        const uint64_t db = gmma_desc(v_tile + kc * 16 * kRowBytes, T::kKVSub,
                                      8 * kRowBytes);
        wgmma_rs<D_PAD>(o, p[kc], db);
      }
      wgmma_commit();
      fence_regs(o);
      fence_regs(p);
    };
    // O *= alpha, before a warpgroup takes its turn (no product on O is in
    // flight then)
    auto rescale_o = [&]() {
#pragma unroll
      for (int i = 0; i < D_PAD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int kc = 0; kc < BLOCK_N / 16; ++kc) {
        p[kc][0] = pack_bf16x2(s[8 * kc + 0], s[8 * kc + 1]);
        p[kc][1] = pack_bf16x2(s[8 * kc + 2], s[8 * kc + 3]);
        p[kc][2] = pack_bf16x2(s[8 * kc + 4], s[8 * kc + 5]);
        p[kc][3] = pack_bf16x2(s[8 * kc + 6], s[8 * kc + 7]);
      }
    };

    if (wg == 1) named_arrive(1, 256);  // warpgroup 0 goes first
    int kv = 0;  // K/V tiles consumed so far
    for (int w = blockIdx.x, it = 0; w < n_work; w += gridDim.x, ++it) {
      const int q0 = (w % n_q) * kBlockM;
      const int b = (w / n_q) / H;
      const int h = (w / n_q) % H;
      const int qb = it % QBUF;
      const bool last_work = w + gridDim.x >= n_work;
      q_rows = sQ + qb * T::kQBytes + wg * 64 * kRowBytes;
#pragma unroll
      for (int i = 0; i < D_PAD / 2; ++i) o[i] = 0.0f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.0f;
      mbar_wait(q_full + 8 * qb, (it / QBUF) & 1);

      // prologue: the scores of the first key tile
      mbar_wait(k_full + 8 * (kv % kStages), (kv / kStages) & 1);
      named_sync(my_turn, 256);
      issue_scores(kv % kStages);
      named_arrive(other_turn, 256);
      wgmma_wait<0>();
      fence_regs(s);
      if (tid == 0) mbar_arrive(k_empty + 8 * (kv % kStages));
      online_softmax<BLOCK_N>(s, m, l, alpha, 0, S, scale_log2, t);
      pack_p();
      if (QBUF > 1 && it > 0 && tid == 0) {
        // the previous tile's O stores have had the prologue's time to read
        // their half of the other Q buffer: release it for the next Q
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(q_empty + 8 * ((it - 1) % QBUF));
      }

      // steady state: issue S(j+1) and P(j) V(j) back to back, then the
      // softmax of S(j+1) while P(j) V(j) runs
      for (int j = 0; j + 1 < n_tiles; ++j, ++kv) {
        const int st = kv % kStages;
        const int st1 = (kv + 1) % kStages;
        mbar_wait(k_full + 8 * st1, ((kv + 1) / kStages) & 1);
        mbar_wait(v_full + 8 * st, (kv / kStages) & 1);
        rescale_o();
        named_sync(my_turn, 256);
        issue_scores(st1);
        issue_pv(st);
        named_arrive(other_turn, 256);
        wgmma_wait<1>();
        fence_regs(s);
        if (tid == 0) mbar_arrive(k_empty + 8 * st1);
        online_softmax<BLOCK_N>(s, m, l, alpha, (j + 1) * BLOCK_N, S,
                                scale_log2, t);
        wgmma_wait<0>();
        fence_regs(o);
        if (tid == 0) mbar_arrive(v_empty + 8 * st);
        pack_p();
      }
      // last key tile: P V only.  Warpgroup 1's very last turn is not
      // followed by one of warpgroup 0.
      {
        const int st = kv % kStages;
        mbar_wait(v_full + 8 * st, (kv / kStages) & 1);
        rescale_o();
        named_sync(my_turn, 256);
        issue_pv(st);
        if (wg == 0 || !last_work) named_arrive(other_turn, 256);
        wgmma_wait<0>();
        fence_regs(o);
        if (tid == 0) mbar_arrive(v_empty + 8 * st);
        ++kv;
      }

      // epilogue: O / l as bf16 into this warpgroup's half of the Q tile
      // (same 128-byte swizzle: 16-byte chunk c of row r sits at chunk
      // c ^ (r % 8)), then TMA stores that skip rows >= L and columns >= D.
      // The Q buffer is released once the stores have read it: at once with
      // one buffer, else in the next tile's prologue.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffff, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffff, l[r], 2);
        l[r] = 1.0f / l[r];
      }
#pragma unroll
      for (int j = 0; j < D_PAD / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = warp * 16 + g + 8 * r;  // row % 8 == g
          const uint32_t addr = q_rows + (j / 8) * T::kQSub + row * kRowBytes +
                                (((j % 8) ^ g) << 4) + 4 * t;
          const uint32_t v = pack_bf16x2(o[4 * j + 2 * r] * l[r],
                                         o[4 * j + 2 * r + 1] * l[r]);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v)
                       : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(3 + wg, 128);
      if (tid == 0) {
#pragma unroll
        for (int c = 0; c < T::kSubs; ++c)
          tma_store(&tm_o, q_rows + c * T::kQSub, c * kSubCols, h,
                    q0 + 64 * wg, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        if (QBUF == 1 || last_work) {
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          mbar_arrive(q_empty + 8 * qb);
        }
      }
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

// SMs of the current device, read once per device (0 on failure)
int num_sms(int dev) {
  static int count[kMaxDevices] = {};
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    count[dev] = 0;
  return count[dev];
}

template <int D_PAD, int BLOCK_N, int QBUF>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int L, int S, int D, float scale, cudaStream_t stream) {
  using T = Tiles<D_PAD, BLOCK_N, QBUF>;
  auto kernel = attention_kernel<D_PAD, BLOCK_N, QBUF>;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  static bool configured[kMaxDevices] = {};
  if (!configured[dev]) {  // more than 48 KB of dynamic shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemAlloc);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, q, B, L, H, D, kBlockM) ||
      !make_map(&tk, k, B, S, H, D, BLOCK_N) ||
      !make_map(&tv, v, B, S, H, D, BLOCK_N) ||
      !make_map(&to, o, B, L, H, D, kBlockM / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_q = (L + kBlockM - 1) / kBlockM;
  const long n_work = static_cast<long>(n_q) * B * H;
  const int sms = num_sms(dev);
  if (sms <= 0 || n_work > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_work < sms ? n_work : sms);
  kernel<<<grid, kThreads, T::kSmemAlloc, stream>>>(
      tq, tk, tv, to, H, S, n_q, static_cast<int>(n_work),
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o, int B, int H,
             int L, int S, int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % 8 != 0 || S <= 0 || L <= 0 || B <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 64)
    return launch<64, 128, 2>(q, k, v, o, B, H, L, S, D, scale, st);
  if (D <= 128)
    return launch<128, 128, 2>(q, k, v, o, B, H, L, S, D, scale, st);
  if (D <= 256)
    return launch<256, 80, 1>(q, k, v, o, B, H, L, S, D, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Replaces _onepass_kernel: the UNet's 1024-token sites.
int echoscene_onepass_attention(const void* q, const void* k, const void* v,
                                void* o, int B, int H, int L, int S, int D,
                                float scale, void* stream) {
  return dispatch(q, k, v, o, B, H, L, S, D, scale, stream);
}

// Replaces _stream_kernel: the VQ-VAE's 4096-token single-head site.
int echoscene_stream_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int L, int S, int D,
                               float scale, void* stream) {
  return dispatch(q, k, v, o, B, H, L, S, D, scale, stream);
}

}  // extern "C"
