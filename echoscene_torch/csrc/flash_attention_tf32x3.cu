// Non-causal softmax attention for Hopper (sm_90a), f32 in / f32 out, with
// every product as three TF32 products on the tensor cores (3xTF32).
//
// The f32 counterpart of csrc/flash_attention.cu (bf16).  It replaces the
// two Pallas TPU kernels of echoscene_tpu/kernels/flash_attention.py when
// they run on f32 inputs, which JAX's kernels take (the output keeps the
// input dtype, :139, :193):
//   * _onepass_kernel (:73, driven by _onepass_impl): the shape UNet's
//     1024-token self-attention, 8 heads of dim 56, 5 launches per shape step
//     under `sample_dtype: float32` or `compute_dtype: float32`;
//   * _stream_kernel (:35, driven by _stream_impl): the VQ-VAE's 4096-token
//     single-head attention with C = 256, one launch per 8-object chunk.
// Both compute O = softmax(Q K^T * D^-1/2) V per (batch, head) with an
// online softmax (running max and sum in the log2 domain), f32 accumulation
// of P V and the division by the row sum at the end, as the TPU kernels do.
//
// 3xTF32.  TF32 keeps 10 of f32's 23 mantissa bits.  Each f32 operand x is
// split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna.tf32.f32: nearest,
// ties away), and a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi (the small terms
// first where they share an f32 accumulator); the dropped a_lo b_lo is
// ~2^-22 of a b.
// The result is held to the f32 limits (flash_attention.TOLERANCES); plain
// TF32 fails them (kernels/attention_variants.attention_tf32x3_emulated
// emulates both on the CPU, tests/test_torch_port_kernels.py).
//
// What bounds it on the H100.  Per (batch, head) the function needs 4 L S D
// flops, here 12 L S D on the TF32 tensor cores (495 TFLOP/s): 0.478 ms at
// the UNet site (42 rows: B H = 336, L = S = 1024, D = 56), 0.833 ms at the
// VQ-VAE site (B = 8, L = S = 4096, D = 256), against 1.178 / 2.051 ms as
// f32 FMAs.  Its L S exponentials (0.084 / 0.032 ms on the SFU) and bytes
// (0.092 / 0.040 ms) bound neither site.
//
// Design.
//   * Operand split: wgmma reads B from shared memory, so the hi and lo
//     parts of K and V must both sit there.  A pre-pass (two small kernels
//     of the same call, on the same stream) reads k and v once and writes
//     their hi and lo parts into scratch that the wrapper allocates
//     (`scratch_layout`): k in its own (B, S, H, D) layout, v transposed to
//     (B, H, D, S8) (S8 = S rounded up to 8, zero-filled).  Splitting each
//     K / V tile after it lands would redo the split for every work tile of
//     query rows that reads it; the pre-pass moves one read and two writes
//     of k and v instead (bytes-bound: chip_smoke.py times it alone).  Q is
//     read once per work tile, so it lands as f32 and each consumer splits
//     its rows in shared memory, in place (`split_q`), saving the pre-pass
//     a third of its bytes.
//   * V^T: for .tf32 wgmma takes A and B K-major only (PTX allows the
//     transpose immediates for 16-bit types only), and the K of P V is the
//     key, so V goes in as V^T with keys contiguous.  Within each group of
//     8 keys the pre-pass stores them in the order 0 2 4 6 1 3 5 7: the f32
//     accumulator gives a thread the scores of keys 2t and 2t + 1 of each 8,
//     and the register A fragment of m64k8 .tf32 wants columns t and t + 4,
//     so with the keys of V^T permuted so, the scores go into the A
//     fragment where they lie, with no shuffle.
//   * A persistent kernel, one CTA per SM walking work tiles of query rows
//     of one (batch, head), warp-specialised as the bf16 kernel: one
//     producer warpgroup (setmaxnreg 24 where there are two consumers) whose
//     one thread issues every TMA load, and one or two consumer
//     warpgroups of 64 query rows each.  K tiles (hi, lo) and V^T tiles
//     (hi, lo) share one ring of equal slots, loaded in the order the
//     consumers need them (K0, then K(j+1), V(j) for each j, then the last
//     V) with a full and an empty mbarrier per slot.  TMA zero-fills d >= D
//     and rows past L or S.
//   * Consumers: S = Q K^T as three SS wgmma m64nBLOCK_Nk8 per 8 columns of
//     d (Q hi / lo and K hi / lo K-major, 128-byte swizzle, 32 floats a
//     row); with narrow key tiles (16 or 32 keys) Q_hi K_hi and Q_hi K_lo
//     run as one product of N = 2 BLOCK_N over K's hi and lo rows, which
//     sit next to each other in the slot, so each k-step reads its Q_hi
//     slice from shared memory once and not twice (kernels/
//     attention_variants.py --f32 times the kernel without it).  The online
//     softmax runs on the accumulator (as the bf16 kernel's); P is split in
//     registers into the hi / lo A fragments; P V runs as three RS wgmma
//     m64nNk8 per 8 keys.  Software-pipelined as the bf16 kernel: S(j+1)
//     and P(j) V(j) are issued back to back and the softmax of S(j+1) runs
//     while P(j) V(j) is on the tensor cores; two consumers take turns to
//     issue (named barriers).
//   * Accumulation: the tensor cores truncate where they add to an f32
//     accumulator, so a row's P V summed over all keys in one accumulator
//     came out biased towards 0, by more than the f32 mean limit at the
//     VQ-VAE site (attention_variants.py --f32 shows it at D 128).  Each
//     tile's P V therefore starts from 0 in its own accumulator and O =
//     alpha O + P V(tile) is added in f32 with rounding to nearest.  At
//     D_pad 256 that accumulator holds half of O's columns
//     (registers), so P V runs as two products of N = 128, one after the
//     other.
//   * Epilogue: O / l into the warpgroup's rows of the Q hi tile (same
//     swizzle), written by TMA stores that skip rows past L and columns
//     past D.
// Tiles within 227 KB (each instantiation's slots hold BLOCK_N x D_PAD x 8
// bytes, a K or a V^T tile with its hi and lo parts, 32 KB):
//   * D_pad 64 (the UNet site): 2 consumers x 64 rows, 64-key tiles; Q
//     hi / lo 64 KB, 4 slots (2 K and 2 V^T tiles in flight) 128 KB;
//   * D_pad 128: 2 consumers, 32-key tiles; Q 128 KB, 3 slots 96 KB;
//   * D_pad 256 (the VQ-VAE site): Q hi / lo for 64 rows alone is 128 KB
//     and O is 128 f32 registers a thread, so one consumer of 64 rows,
//     16-key tiles (V^T rows of 64 bytes, 64-byte swizzle); 3 slots 96 KB.
//     wgmma fits there; its score products are narrow (N = 16 and 32), so
//     each re-reads its 2 KB Q slice from shared memory for a fraction of
//     the work of an N = 64 product: shared-memory bandwidth more than the
//     tensor cores bounds them.
// Registers and shared memory per instantiation (nvcc -Xptxas -v for
// sm_90a; chip_smoke.py phase 1 prints them): D_pad 64 and 128
// 168 registers a thread at launch (the consumers raise theirs to 240 by
// setmaxnreg), no spill, 197,712 and 230,464 bytes of shared memory;
// D_pad 256 255 registers, no spill, 230,464 bytes.
//
// Built by echoscene_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; each entry point takes the wrapper's scratch
// (flash_attention.f32_scratch_floats floats) as its last argument and
// returns a cudaError_t.  cuTensorMapEncodeTiled (libcuda) is looked up at
// run time through the runtime's entry-point query, so the library needs no
// -lcuda.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSubCols = 32;   // f32 columns per 128-byte swizzle row
constexpr int kRowBytes = 128;

// ---- shared memory, barriers, TMA (as csrc/flash_attention.cu) ------------

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

// ---- TF32 ------------------------------------------------------------------

// nearest TF32 value, ties away from zero, as an f32 bit pattern
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type (1: 128-byte
// swizzle, 2: 64-byte swizzle).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t sbo,
                                              uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// x, hidden from the compiler: a descriptor made from it is computed where
// it is used, not hoisted out of the loop into registers held throughout
// (the 64 descriptors of the Q tile would take 128 registers at D_pad 256)
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
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

// Pins wgmma operand registers at this point of the program (see
// csrc/flash_attention.cu): without it ptxas serializes every wgmma.
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

// D (64 x 16, f32) (+)= A (64 x 8, smem) B (16 x 8, smem), both K-major
// TF32; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 32, f32) (+)= A (64 x 8, smem) B (32 x 8, smem), both K-major
// TF32; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) (+)= A (64 x 8, smem) B (64 x 8, smem), both K-major
// TF32; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) (+)= A (64 x 8, TF32 registers) B (64 x 8, smem, K-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D (64 x 128, f32) (+)= A (64 x 8, TF32 registers) B (128 x 8, smem, K-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D (64 x 256, f32) (+)= A (64 x 8, TF32 registers) B (256 x 8, smem, K-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
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
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64, "no wgmma wrapper for N");
  if constexpr (N == 16) wgmma_ss_n16(d, da, db, scale_d);
  else if constexpr (N == 32) wgmma_ss_n32(d, da, db, scale_d);
  else wgmma_ss_n64(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  static_assert(N == 64 || N == 128 || N == 256, "no wgmma wrapper for N");
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, scale_d);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db, scale_d);
  else wgmma_rs_n256(d, a, db, scale_d);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- the pre-pass: hi / lo parts of q, k and v -----------------------------

__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  hi = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z),
                   tf32_rna(x.w));
  lo = make_float4(tf32_rna(x.x - hi.x), tf32_rna(x.y - hi.y),
                   tf32_rna(x.z - hi.z), tf32_rna(x.w - hi.w));
}

// k: hi and lo in its own layout, 4 floats a thread
__global__ void split_k(const float4* __restrict__ k, float4* __restrict__ kh,
                        float4* __restrict__ kl, long n4) {
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
       i < n4; i += static_cast<long>(gridDim.x) * blockDim.x)
    split4(__ldg(k + i), kh[i], kl[i]);
}

// v (B, S, H, D) -> hi and lo of V^T (B, H, D, S8) through a 32 x 32 tile
// in shared memory; within each group of 8 keys, position c holds key 2c
// (c < 4) or 2c - 7 (c >= 4), the order of the A fragment (file header);
// keys past S are 0.  Grid (S8 / 32 rounded up, D / 32 rounded up, B H),
// block (32, 8).
__global__ void split_vt(const float* __restrict__ v, float* __restrict__ vth,
                         float* __restrict__ vtl, int H, int S, int S8,
                         int D) {
  __shared__ float tile[32][33];
  const int bh = blockIdx.z;
  const int b = bh / H;
  const int h = bh - b * H;
  const int s0 = blockIdx.x * 32;
  const int d0 = blockIdx.y * 32;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + ty + 8 * i;
    const int d = d0 + tx;
    tile[ty + 8 * i][tx] =
        s < S && d < D
            ? __ldg(v + ((static_cast<size_t>(b) * S + s) * H + h) * D + d)
            : 0.0f;
  }
  __syncthreads();
  const int c = tx & 7;
  const int key = (tx & ~7) + (c < 4 ? 2 * c : 2 * c - 7);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = d0 + ty + 8 * i;
    const int p = s0 + tx;
    if (d >= D || p >= S8) continue;
    const float x = tile[key][ty + 8 * i];
    const float hi = tf32_rna(x);
    const size_t at = (static_cast<size_t>(bh) * D + d) * S8 + p;
    vth[at] = hi;
    vtl[at] = tf32_rna(x - hi);
  }
}

// ---- the attention kernel ---------------------------------------------------

template <int D_PAD, int BLOCK_N, int NWG, int SLOTS>
struct Tiles {
  static constexpr int kBlockM = 64 * NWG;          // query rows per tile
  static constexpr int kThreads = 128 * (NWG + 1);  // consumers + producer
  static constexpr int kSubs = D_PAD / kSubCols;    // 32-column sub-tiles
  static constexpr int kQSub = kBlockM * kRowBytes;
  static constexpr int kQPart = kSubs * kQSub;      // Q hi (or lo) tile
  // K: per 32-column sub-tile, BLOCK_N rows of hi, then BLOCK_N of lo
  static constexpr int kKSub = BLOCK_N * kRowBytes;
  static constexpr int kKPart = kSubs * kKSub;      // K hi (or lo) tile
  // narrow key tiles: Q_hi K_hi and Q_hi K_lo as one product of N =
  // 2 BLOCK_N over the hi and lo rows together (one read of Q_hi)
  static constexpr bool kCombineK = BLOCK_N <= 32;
  // V^T: D_PAD rows of BLOCK_N keys in sub-tiles of kVK keys, one swizzle
  // row each (128 or 64 bytes)
  static constexpr int kVK = BLOCK_N < 32 ? BLOCK_N : 32;
  static constexpr int kVRow = kVK * 4;
  static constexpr int kVLayout = kVRow == 128 ? 1 : 2;  // B128 or B64
  static constexpr int kVSub = D_PAD * kVRow;
  static constexpr int kVPart = (BLOCK_N / kVK) * kVSub;
  static_assert(kVPart == kKPart, "K and V^T tiles share the ring's slots");
  // P V in kPVParts products of N = kPVN output columns each
  static constexpr int kPVParts = D_PAD > 128 ? 2 : 1;
  static constexpr int kPVN = D_PAD / kPVParts;
  static constexpr int kSlot = 2 * kKPart;          // hi + lo
  static constexpr int kRing = 2 * kQPart;
  static constexpr int kBars = kRing + SLOTS * kSlot;
  // q_full, q_empty, then a full and an empty barrier per slot
  static constexpr int kSmem = kBars + 8 * (2 + 2 * SLOTS);
  static constexpr int kSmemAlloc = kSmem + 1024;   // room to align to 1024
};

// Which accumulator element goes to A-fragment register e of an 8-key
// chunk: the accumulator holds (row g, key 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1); register e of the m64k8 .tf32 fragment is (row g + 8 (e
// % 2), column t + 4 (e / 2)), and V^T's key order maps column t to key 2t
// and column t + 4 to key 2t + 1.
__device__ __forceinline__ constexpr int frag_src(int e) {
  return e == 1 ? 2 : e == 2 ? 1 : e;
}

// Online softmax of one score tile in the log2 domain (as
// csrc/flash_attention.cu): s[4j + e] is row g + 8 (e / 2), column
// 8 j + 2 t + (e % 2) of this thread's part of a 64 x BLOCK_N tile.  On
// return s holds the f32 probabilities, m the new row maxima (scaled),
// alpha the factor for the earlier sums, l this thread's partial row sums.
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
    float& acc = mx[(i >> 1) & 1][(((i >> 2) & 1) * 2 + (i & 1))];
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
    sum[r][(((i >> 2) & 1) * 2 + (i & 1))] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = fmaf(l[r], alpha[r],
                (sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
}

struct Maps {
  CUtensorMap q, k[2], vt[2], o;  // q as it is; k and V^T [0] hi, [1] lo
};

// Persistent: grid = min(tiles, SMs) CTAs; CTA c takes the work tiles c,
// c + gridDim.x, ...; tile = q_tile + n_q * (b * H + h).  The ring and its
// phases run on across tiles.
template <int D_PAD, int BLOCK_N, int NWG, int SLOTS>
__global__ void __launch_bounds__(Tiles<D_PAD, BLOCK_N, NWG, SLOTS>::kThreads,
                                  1)
    attention_tf32x3_kernel(const __grid_constant__ Maps maps, int H, int S,
                            int n_q, int n_work, float scale_log2) {
  using T = Tiles<D_PAD, BLOCK_N, NWG, SLOTS>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;  // Q hi, then Q lo
  const uint32_t ring = base + T::kRing;
  const uint32_t q_full = base + T::kBars;
  const uint32_t q_empty = q_full + 8;
  const uint32_t full = q_empty + 8;
  const uint32_t empty = full + 8 * SLOTS;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int n_tiles = (S + BLOCK_N - 1) / BLOCK_N;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, NWG);  // one arrival per consumer warpgroup
    for (int i = 0; i < SLOTS; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer: one thread issues every TMA load ----
    if constexpr (NWG > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      int n = 0;  // ring loads so far
      auto next_slot = [&]() {
        const int slot = n % SLOTS;
        mbar_wait(empty + 8 * slot, ((n / SLOTS) & 1) ^ 1);  // 1st round passes
        mbar_expect_tx(full + 8 * slot, T::kSlot);
        ++n;
        return slot;
      };
      for (int w = blockIdx.x, it = 0; w < n_work; w += gridDim.x, ++it) {
        const int q0 = (w % n_q) * T::kBlockM;
        const int b = (w / n_q) / H;
        const int h = (w / n_q) % H;
        auto load_k = [&](int j) {
          const int slot = next_slot();
          const uint32_t dst = ring + slot * T::kSlot;
#pragma unroll
          for (int part = 0; part < 2; ++part)
#pragma unroll
            for (int c = 0; c < T::kSubs; ++c)
              tma_load(dst + (2 * c + part) * T::kKSub, &maps.k[part],
                       full + 8 * slot, c * kSubCols, h, j * BLOCK_N, b);
        };
        auto load_v = [&](int j) {
          const int slot = next_slot();
          const uint32_t dst = ring + slot * T::kSlot;
#pragma unroll
          for (int part = 0; part < 2; ++part)
#pragma unroll
            for (int c = 0; c < BLOCK_N / T::kVK; ++c)
              tma_load(dst + part * T::kVPart + c * T::kVSub, &maps.vt[part],
                       full + 8 * slot, j * BLOCK_N + c * T::kVK, 0, h, b);
        };
        // in the order the consumers take them: K0, Q, then K(j) with
        // V(j - 1), then the last V
        load_k(0);
        mbar_wait(q_empty, (it & 1) ^ 1);
        mbar_expect_tx(q_full, T::kQPart);
#pragma unroll
        for (int c = 0; c < T::kSubs; ++c)
          tma_load(sQ + c * T::kQSub, &maps.q, q_full, c * kSubCols, h, q0,
                   b);
        for (int j = 1; j < n_tiles; ++j) {
          load_k(j);
          load_v(j - 1);
        }
        load_v(n_tiles - 1);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) ----
    if constexpr (NWG > 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    // turn barriers (two consumers): warpgroup w issues after bar 1 + w
    const int my_turn = 1 + wg;
    const int other_turn = 2 - wg;
    constexpr int kTurn = 128 * NWG;

    float o[D_PAD / 2];
    float ot[T::kPVN / 2];
    float s[BLOCK_N / 2];
    float sc[T::kCombineK ? BLOCK_N : 1];  // Q_hi [K_hi; K_lo]
    float a_pv[2];
    uint32_t ph[BLOCK_N / 8][4], pl[BLOCK_N / 8][4];
    float m[2], l[2], alpha[2];
#pragma unroll
    for (int i = 0; i < BLOCK_N / 2; ++i) s[i] = 0.0f;
    const uint32_t q_hi = sQ + wg * 64 * kRowBytes;  // this warpgroup's rows
    const uint32_t q_lo = q_hi + T::kQPart;

    // S = Q K^T: Q_lo K_hi + Q_hi K_lo + Q_hi K_hi, 8 columns of d a step
    // (descriptor + (byte offset >> 4) moves the address field)
    auto issue_scores = [&](int slot) {
      const uint64_t dq[2] = {gmma_desc(opaque(q_hi), 8 * kRowBytes, 1),
                              gmma_desc(opaque(q_lo), 8 * kRowBytes, 1)};
      const uint32_t k_hi = ring + slot * T::kSlot;
      const uint64_t dk[2] = {
          gmma_desc(k_hi, 8 * kRowBytes, 1),
          gmma_desc(k_hi + T::kKSub, 8 * kRowBytes, 1)};
      fence_regs(s);
      fence_regs(sc);
      wgmma_fence();
      if constexpr (T::kCombineK) {
#pragma unroll
        for (int kk = 0; kk < D_PAD / 8; ++kk) {
          const uint32_t off = ((kk / 4) * T::kQSub + (kk % 4) * 32) >> 4;
          const uint32_t koff = ((kk / 4) * 2 * T::kKSub + (kk % 4) * 32) >> 4;
          wgmma_ss<BLOCK_N>(s, dq[1] + off, dk[0] + koff, kk > 0);
          wgmma_ss<2 * BLOCK_N>(sc, dq[0] + off, dk[0] + koff, kk > 0);
        }
      } else {
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int kk = 0; kk < D_PAD / 8; ++kk) {
            const uint32_t off = ((kk / 4) * T::kQSub + (kk % 4) * 32) >> 4;
            const uint32_t koff =
                ((kk / 4) * 2 * T::kKSub + (kk % 4) * 32) >> 4;
            wgmma_ss<BLOCK_N>(s, dq[term == 0] + off, dk[term == 1] + koff,
                              term > 0 || kk > 0);
          }
      }
      wgmma_commit();
      fence_regs(s);
      fence_regs(sc);
    };
    // after the score products: with the combined product, S = (Q_lo K_hi
    // + Q_hi K_lo) + Q_hi K_hi from the three accumulators
    auto scores_done = [&]() {
      fence_regs(s);
      fence_regs(sc);
      if constexpr (T::kCombineK) {
#pragma unroll
        for (int i = 0; i < BLOCK_N / 2; ++i)
          s[i] = (s[i] + sc[BLOCK_N / 2 + i]) + sc[i];
      }
    };
    // OT = P_lo V_hi + P_hi V_lo + P_hi V_hi over this tile's keys, 8 keys a
    // step, for the output columns [part kPVN, part kPVN + kPVN); V^T is the
    // K-major B operand.  OT starts from 0 for every tile: the tensor cores
    // truncate where they add to the accumulator, so summing all of a row's
    // keys in one accumulator would bias O towards 0 by one truncation per
    // step (2.9 times the mean limit at the VQ-VAE site); O adds each
    // tile's OT in f32 with rounding to nearest (add_pv).
    auto issue_pv = [&](int slot, int part) {
      const uint32_t v_hi = ring + slot * T::kSlot + part * T::kPVN * T::kVRow;
      const uint64_t dv[2] = {gmma_desc(v_hi, 8 * T::kVRow, T::kVLayout),
                              gmma_desc(v_hi + T::kVPart, 8 * T::kVRow,
                                        T::kVLayout)};
      fence_regs(ot);
      fence_regs(ph);
      fence_regs(pl);
      wgmma_fence();
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int kc = 0; kc < BLOCK_N / 8; ++kc) {
          const uint32_t off =
              ((kc / (T::kVK / 8)) * T::kVSub + (kc % (T::kVK / 8)) * 32) >> 4;
          wgmma_rs<T::kPVN>(ot, term == 0 ? pl[kc] : ph[kc],
                            dv[term == 1] + off, term > 0 || kc > 0);
        }
      wgmma_commit();
      fence_regs(ot);
      fence_regs(ph);
      fence_regs(pl);
    };
    // O = O a_pv + OT for the output columns of `part`
    auto add_pv = [&](int part) {
      fence_regs(ot);
#pragma unroll
      for (int i = 0; i < T::kPVN / 2; ++i)
        o[part * T::kPVN / 2 + i] =
            fmaf(o[part * T::kPVN / 2 + i], a_pv[(i >> 1) & 1], ot[i]);
    };
    // the column parts after the first, one at a time (D_pad 256: OT holds
    // half of O's columns, as the registers allow)
    auto rest_pv = [&](int slot) {
#pragma unroll
      for (int part = 1; part < T::kPVParts; ++part) {
        issue_pv(slot, part);
        wgmma_wait<0>();
        add_pv(part);
      }
    };
    // the factor of O for the tile whose P V is issued next (the softmax of
    // the following tile overwrites alpha while that product runs)
    auto keep_alpha = [&]() {
      a_pv[0] = alpha[0];
      a_pv[1] = alpha[1];
    };
    auto split_p = [&]() {
#pragma unroll
      for (int kc = 0; kc < BLOCK_N / 8; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[4 * kc + frag_src(e)];
          const float hi = tf32_rna(x);
          ph[kc][e] = __float_as_uint(hi);
          pl[kc][e] = __float_as_uint(tf32_rna(x - hi));
        }
    };
    // Q lands as f32 in the hi tile: split this warpgroup's rows in place
    // into hi and lo (the same swizzled offsets in both tiles), then make
    // the writes visible to wgmma
    auto split_q = [&]() {
#pragma unroll
      for (int c = 0; c < T::kSubs; ++c)
#pragma unroll
        for (int i = tid; i < 64 * kRowBytes / 16; i += 128) {
          const uint32_t at = q_hi + c * T::kQSub + 16 * i;
          float4 x, hi, lo;
          asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                       : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
                       : "r"(at)
                       : "memory");
          split4(x, hi, lo);
          asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n"
                       ::"r"(at), "f"(hi.x), "f"(hi.y), "f"(hi.z), "f"(hi.w)
                       : "memory");
          asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n"
                       ::"r"(at + T::kQPart), "f"(lo.x), "f"(lo.y), "f"(lo.z),
                       "f"(lo.w)
                       : "memory");
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(3 + wg, 128);
    };
    auto take_turn = [&]() {
      if constexpr (NWG > 1) named_sync(my_turn, kTurn);
    };
    auto pass_turn = [&]() {
      if constexpr (NWG > 1) named_arrive(other_turn, kTurn);
    };

    if (NWG > 1 && wg == 1) named_arrive(1, kTurn);  // warpgroup 0 first
    int n = 0;  // ring slots consumed so far
    for (int w = blockIdx.x, it = 0; w < n_work; w += gridDim.x, ++it) {
      const int q0 = (w % n_q) * T::kBlockM;
      const int b = (w / n_q) / H;
      const int h = (w / n_q) % H;
      const bool last_work = w + gridDim.x >= n_work;
#pragma unroll
      for (int i = 0; i < D_PAD / 2; ++i) o[i] = 0.0f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.0f;

      // prologue: the scores of the first key tile
      {
        const int sk = n % SLOTS;
        mbar_wait(full + 8 * sk, (n / SLOTS) & 1);
        mbar_wait(q_full, it & 1);
        split_q();
        take_turn();
        issue_scores(sk);
        pass_turn();
        wgmma_wait<0>();
        scores_done();
        if (tid == 0) mbar_arrive(empty + 8 * sk);
        ++n;
      }
      online_softmax<BLOCK_N>(s, m, l, alpha, 0, S, scale_log2, t);
      split_p();

      // steady state: issue S(j+1) and P(j) V(j) back to back, then the
      // softmax of S(j+1) while P(j) V(j) runs
      for (int j = 0; j + 1 < n_tiles; ++j, n += 2) {
        const int sk = n % SLOTS;        // K(j + 1)
        const int sv = (n + 1) % SLOTS;  // V(j)
        mbar_wait(full + 8 * sk, (n / SLOTS) & 1);
        mbar_wait(full + 8 * sv, ((n + 1) / SLOTS) & 1);
        keep_alpha();
        take_turn();
        issue_scores(sk);
        issue_pv(sv, 0);
        pass_turn();
        wgmma_wait<1>();
        scores_done();
        if (tid == 0) mbar_arrive(empty + 8 * sk);
        online_softmax<BLOCK_N>(s, m, l, alpha, (j + 1) * BLOCK_N, S,
                                scale_log2, t);
        wgmma_wait<0>();
        add_pv(0);
        rest_pv(sv);
        if (tid == 0) mbar_arrive(empty + 8 * sv);
        split_p();
      }
      // last key tile: P V only.  Warpgroup 1's very last turn is not
      // followed by one of warpgroup 0.
      {
        const int sv = n % SLOTS;
        mbar_wait(full + 8 * sv, (n / SLOTS) & 1);
        keep_alpha();
        take_turn();
        issue_pv(sv, 0);
        if (wg == 0 || !last_work) pass_turn();
        wgmma_wait<0>();
        add_pv(0);
        rest_pv(sv);
        if (tid == 0) mbar_arrive(empty + 8 * sv);
        ++n;
      }

      // epilogue: O / l into this warpgroup's rows of the Q hi tile (same
      // 128-byte swizzle: 16-byte chunk c of row r sits at chunk c ^ (r %
      // 8)), then TMA stores that skip rows >= L and columns >= D; the Q
      // buffer is released once the stores have read it
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
          const int chunk = 2 * (j % 4) + t / 2;
          const uint32_t addr = q_hi + (j / 4) * T::kQSub + row * kRowBytes +
                                ((chunk ^ g) << 4) + (t % 2) * 8;
          asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
                       "f"(o[4 * j + 2 * r] * l[r]),
                       "f"(o[4 * j + 2 * r + 1] * l[r])
                       : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(3 + wg, 128);
      if (tid == 0) {
#pragma unroll
        for (int c = 0; c < T::kSubs; ++c)
          tma_store(&maps.o, q_hi + c * T::kQSub, c * kSubCols, h,
                    q0 + 64 * wg, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(q_empty);
      }
    }
  }
}

// ---- host side --------------------------------------------------------------

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

// a contiguous f32 tensor of dims {d0 (innermost), d1, d2, d3} as a 4-D
// map with the given box; out-of-range elements read as 0
bool make_map(CUtensorMap* map, const void* ptr, const int (&dims)[4],
              const int (&box)[4], CUtensorMapSwizzle swizzle) {
  EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return false;
  cuuint64_t size[4], strides[3];
  cuuint32_t boxes[4];
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  cuuint64_t stride = 4;
  for (int i = 0; i < 4; ++i) {
    size[i] = static_cast<cuuint64_t>(dims[i]);
    boxes[i] = static_cast<cuuint32_t>(box[i]);
    if (i > 0) strides[i - 1] = stride;
    stride *= size[i];
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                const_cast<void*>(ptr), size, strides, boxes, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
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

// The wrapper's scratch: k hi, k lo (B S H D each), V^T hi, V^T lo (B H D
// S8); 2 B H D (S + S8) floats in all (flash_attention.f32_scratch_floats).
struct Scratch {
  float *kh, *kl, *vth, *vtl;
};

Scratch scratch_layout(void* scratch, int B, int H, int S, int S8, int D) {
  const size_t nk = static_cast<size_t>(B) * S * H * D;
  const size_t nv = static_cast<size_t>(B) * H * D * S8;
  float* p = static_cast<float*>(scratch);
  return {p, p + nk, p + 2 * nk, p + 2 * nk + nv};
}

template <int D_PAD, int BLOCK_N, int NWG, int SLOTS>
int launch(const void* q, const Scratch& sc, void* o, int B, int H, int L,
           int S, int S8, int D, float scale, int dev, cudaStream_t stream) {
  using T = Tiles<D_PAD, BLOCK_N, NWG, SLOTS>;
  auto kernel = attention_tf32x3_kernel<D_PAD, BLOCK_N, NWG, SLOTS>;
  static bool configured[kMaxDevices] = {};
  if (!configured[dev]) {  // more than 48 KB of dynamic shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemAlloc);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  const CUtensorMapSwizzle vswz = T::kVLayout == 1
                                      ? CU_TENSOR_MAP_SWIZZLE_128B
                                      : CU_TENSOR_MAP_SWIZZLE_64B;
  Maps maps;
  const int q_dims[4] = {D, H, L, B}, k_dims[4] = {D, H, S, B};
  const int vt_dims[4] = {S8, D, H, B};
  const int q_box[4] = {kSubCols, 1, T::kBlockM, 1};
  const int k_box[4] = {kSubCols, 1, BLOCK_N, 1};
  const int vt_box[4] = {T::kVK, D_PAD, 1, 1};
  const int o_box[4] = {kSubCols, 1, 64, 1};
  const float* ks[2] = {sc.kh, sc.kl};
  const float* vts[2] = {sc.vth, sc.vtl};
  bool ok = make_map(&maps.o, o, q_dims, o_box, CU_TENSOR_MAP_SWIZZLE_128B) &&
            make_map(&maps.q, q, q_dims, q_box, CU_TENSOR_MAP_SWIZZLE_128B);
  for (int part = 0; part < 2; ++part)
    ok = ok &&
         make_map(&maps.k[part], ks[part], k_dims, k_box,
                  CU_TENSOR_MAP_SWIZZLE_128B) &&
         make_map(&maps.vt[part], vts[part], vt_dims, vt_box, vswz);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int n_q = (L + T::kBlockM - 1) / T::kBlockM;
  const long n_work = static_cast<long>(n_q) * B * H;
  const int sms = num_sms(dev);
  if (sms <= 0 || n_work > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_work < sms ? n_work : sms);
  kernel<<<grid, T::kThreads, T::kSmemAlloc, stream>>>(
      maps, H, S, n_q, static_cast<int>(n_work), scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int B, int H, int L, int S, int D, const void* scratch) {
  return D > 0 && D % 8 == 0 && D <= 256 && S > 0 && L > 0 && B > 0 &&
         H > 0 && static_cast<long>(B) * H <= 65535 && scratch != nullptr;
}

// the pre-pass: hi / lo of k, then of V^T, into the scratch
int prepass(const void* k, const void* v, const Scratch& sc, int B, int H,
            int S, int S8, int D, cudaStream_t st) {
  const long bh = static_cast<long>(B) * H;
  const long n4 = static_cast<long>(B) * S * H * D / 4;
  const long blocks = (n4 + 255) / 256;
  split_k<<<static_cast<int>(blocks < 8 * 132 ? blocks : 8 * 132), 256, 0,
            st>>>(static_cast<const float4*>(k),
                  reinterpret_cast<float4*>(sc.kh),
                  reinterpret_cast<float4*>(sc.kl), n4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  split_vt<<<dim3((S8 + 31) / 32, (D + 31) / 32, static_cast<unsigned>(bh)),
             dim3(32, 8), 0, st>>>(static_cast<const float*>(v), sc.vth,
                                   sc.vtl, H, S, S8, D);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int L, int S, int D, float scale, void* stream,
             void* scratch) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid(B, H, L, S, D, scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  const int S8 = (S + 7) / 8 * 8;
  const Scratch sc = scratch_layout(scratch, B, H, S, S8, D);
  const int err = prepass(k, v, sc, B, H, S, S8, D, st);
  if (err != 0) return err;
  if (D <= 64)
    return launch<64, 64, 2, 4>(q, sc, o, B, H, L, S, S8, D, scale, dev, st);
  if (D <= 128)
    return launch<128, 32, 2, 3>(q, sc, o, B, H, L, S, S8, D, scale, dev, st);
  return launch<256, 16, 1, 3>(q, sc, o, B, H, L, S, S8, D, scale, dev, st);
}

}  // namespace

extern "C" {

// Replaces _onepass_kernel on f32 inputs: the UNet's 1024-token sites.
int echoscene_onepass_attention_f32(const void* q, const void* k,
                                    const void* v, void* o, int B, int H,
                                    int L, int S, int D, float scale,
                                    void* stream, void* scratch) {
  return dispatch(q, k, v, o, B, H, L, S, D, scale, stream, scratch);
}

// Replaces _stream_kernel on f32 inputs: the VQ-VAE's 4096-token site.
int echoscene_stream_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int L, int S, int D, float scale,
                                   void* stream, void* scratch) {
  return dispatch(q, k, v, o, B, H, L, S, D, scale, stream, scratch);
}

// The pre-pass alone (timed on its own by chip_smoke.py; no path calls it).
int echoscene_attention_f32_prepass(const void* k, const void* v, int B,
                                    int H, int L, int S, int D, void* stream,
                                    void* scratch) {
  if (!valid(B, H, L, S, D, scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  const int S8 = (S + 7) / 8 * 8;
  return prepass(k, v, scratch_layout(scratch, B, H, S, S8, D), B, H, S, S8,
                 D, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
