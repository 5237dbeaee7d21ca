// Int8 W8A8 convolution for Hopper (sm_90a): the activation quantize (Q1)
// and an implicit-GEMM int8 convolution with a dequantize epilogue (Q2).
//
// Hand kernels of the port with no Pallas counterpart: the JAX package's
// int8 sampling mode (echoscene_tpu/nn/quant.py, Int8Conv / Int8Dense and
// the quantized factored upsample of echoscene_tpu/nn/blocks.py) runs
// lax.conv_general_dilated on int8 operands with int32 accumulation, which
// XLA compiles; PyTorch has no CUDA int8 3D convolution.  Called by
// echoscene_torch/kernels/int8_conv.py, which also computes Q2's tile plan.
//
// Q1, echoscene_quantize_act (both passes), or its two passes as
// echoscene_quantize_amax and echoscene_quantize_with_amax, so that a caller
// can fold the amax word of several ranks' channel shards together (a MAX
// all-reduce) before the quantize.  The per-tensor symmetric quantize of JAX's
// quantize_symmetric(x, axes=None): amax = max |x| over the whole tensor,
// scale = max(amax, eps) / 127, q = clip(round(x / scale), -127, 127), in
// f32 with IEEE division and round-half-to-even (__fdiv_rn,
// __float2int_rn, or a product that provably rounds alike), so q and scale
// equal JAX's for the same input.  The input is channel-first (N, C, S) (S
// the spatial positions) in bf16 or f32; the output is channels-last (N, S,
// Cp), Cp = C rounded up to 32 with zero channels, the layout Q2 reads.
// Bound: bytes.  Two passes, since a dynamic per-tensor scale needs x read
// twice (the bound counts it once):
//   * abs-max: 16-byte loads, four in flight a thread, the maximum of the
//     magnitudes' bit patterns (|x| >= 0 orders as unsigned; bf16 pairs by
//     __vmaxu2), reduced in the block and folded into one device word by
//     atomicMax (zeroed by a memset before it);
//   * quantize: each block reads that word once and transposes a
//     32-channel x 256-position tile: 16-byte loads along positions,
//     quantized in registers into an int8 tile in shared memory, then 4 x 4
//     byte transposes (__byte_perm) into 16-byte stores of 16 channels, two
//     neighbouring threads filling a position's 32-byte sector.
//     The division is a product by the rounded reciprocal wherever that
//     cannot round to another integer, the IEEE division elsewhere (quant1).
//     Blocks walk the tiles from the end of x backwards: the abs-max pass
//     read the end last, so it is the likeliest part to be in L2.
//
// Q2, echoscene_int8_conv3d.  out[n, k, o] = f32(acc) * (x_scale *
// w_scale[k]) (+ bias[k]) rounded to bf16, acc = the int32 sum over taps t
// and channels c of xq[n, o * stride - pad_front + t, c] * wq[k, t, c]
// (taps outside the input read zero).  echoscene_int8_conv3d_acc writes acc
// itself as int32 (the template flag kRaw), with no dequantize and no bias:
// the partial sums of a convolution split on its input channels over the
// ranks of a model group, summed exactly as int32 before one dequantize (they
// reach ~2.9e8 at the flagship's widths, past f32's exact integers).  Bound: operations, 2 M K taps C_in at
// 1,979 TOP/s (dense int8), or bytes on the small-channel convolutions.
// Implicit GEMM on wgmma, warp-specialised, one CTA of three warpgroups an
// output tile:
//   * The M tile is a box of 128 output positions of the 5-D output (Nb x
//     Db x Hb x Wb, e.g. 1 x 1 x 8 x 16 at 16^3, 1 x 2 x 8 x 8 at 16 x 8 x 8,
//     1 x 8 x 4 x 4 at 16 x 4 x 4); the N tile is 224 output channels (it
//     divides 224, 448 and 672), or 8 for a convolution of at most 8
//     (conv_out).  The plan (box, tap offsets, chunk width, N tile) is
//     computed by kernels/int8_conv.py conv_plan and passed in.
//   * Warpgroup 2 is the producer (setmaxnreg 40): one thread issues TMA
//     loads into a ring of 4-8 stages with a full and an empty mbarrier a
//     stage.  A stage is one tap's chunk of CW = 64 or 128 channels (64- or
//     128-byte swizzle, whichever pads Cp less): A, the input box shifted by
//     the tap's offset, from a 5-D tiled map over xq (Cp, W, H, D, N) whose
//     out-of-range elements read as zero, which is exactly the padding
//     (one-sided pads included) and the channels past Cp; strided
//     convolutions take every s-th element by the map's elementStrides;
//     B, the tap's chunk of the N tile's weights, from a 3-D map over wq
//     (Cp, taps, K).
//   * Warpgroups 0 and 1 are consumers (setmaxnreg 232), 64 rows each:
//     wgmma.mma_async m64n224k32 (or m64n8k32) .s32.s8.s8 with both
//     operands K-major in swizzled shared memory, CW / 32 a stage, one
//     group in flight while the previous stage is released.
//   * Epilogue: the accumulators are dequantized exactly as the plain
//     version does (__fmul_rn of the f32 accumulator by x_scale * w_scale[k],
//     then __fadd_rn of the bias, then bf16 round-to-nearest; no FMA), or
//     kept as int32 (kRaw), into a channel-major tile in shared memory (the
//     ring's), the output positions of the 128 rows decoded once a tile; then
//     each run of 16 bytes of a channel (8 bf16 or 4 int32 rows) goes out as
//     one 16-byte store where the output is dense along those rows (W
//     innermost, channel-first), else element by element through the
//     output's strides (the factored upsample's parity views).
// Int32 accumulation is exact, so the result does not depend on the order
// of the sum.  Built by kernels/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a, plain C interface); cuTensorMapEncodeTiled
// is looked up through the runtime's entry-point query (no -lcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ---- Q1 -------------------------------------------------------------------

constexpr int kAmaxThreads = 256;
constexpr int kAmaxBlocks = 1024;  // most blocks of the abs-max pass
constexpr int kAmaxUnroll = 4;     // 16-byte loads in flight a thread
constexpr int kQuantThreads = 128;
constexpr int kQuantC = 32;        // channels a quantize tile (Cp % 32 == 0)
constexpr int kQuantS = 256;       // positions a quantize tile
static_assert(kQuantThreads * 2 == kQuantS, "a thread stores 4 positions of "
              "one of two channel halves");

// bit pattern of |v| as f32: for |v| >= 0 the unsigned order is the float's
__device__ __forceinline__ uint32_t abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}
__device__ __forceinline__ uint32_t abs_bits(__nv_bfloat16 v) {
  return ((uint32_t)__bfloat16_as_ushort(v) & 0x7fffu) << 16;
}

__device__ __forceinline__ uint32_t abs_bits_vec(const uint4& v, float) {
  uint32_t m = max(v.x & 0x7fffffffu, v.y & 0x7fffffffu);
  m = max(m, v.z & 0x7fffffffu);
  return max(m, v.w & 0x7fffffffu);
}
// eight bf16: halfword-wise unsigned maxima, then the larger half as f32 bits
__device__ __forceinline__ uint32_t abs_bits_vec(const uint4& v,
                                                 __nv_bfloat16) {
  uint32_t m = __vmaxu2(v.x & 0x7fff7fffu, v.y & 0x7fff7fffu);
  m = __vmaxu2(m, v.z & 0x7fff7fffu);
  m = __vmaxu2(m, v.w & 0x7fff7fffu);
  return max(m & 0xffffu, m >> 16) << 16;
}

// Pass 1: amax (one word, zero on entry) = max over x of abs_bits.
template <typename T>
__global__ void __launch_bounds__(kAmaxThreads)
    absmax_pass(const T* __restrict__ x, long long n,
                unsigned int* __restrict__ amax) {
  __shared__ uint32_t red[kAmaxThreads / 32];
  constexpr int kVec = 16 / sizeof(T);
  uint32_t m = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long head = 0;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const long long nvec = n / kVec;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (long long i = tid; i < nvec; i += kAmaxUnroll * stride) {
      uint4 v[kAmaxUnroll];
#pragma unroll
      for (int u = 0; u < kAmaxUnroll; ++u) {
        const long long j = i + u * stride;
        v[u] = j < nvec ? __ldg(xv + j) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kAmaxUnroll; ++u)
        m = max(m, abs_bits_vec(v[u], T()));
    }
    head = nvec * kVec;
  }
  for (long long i = head + tid; i < n; i += stride)
    m = max(m, abs_bits(x[i]));
  m = __reduce_max_sync(0xffffffffu, m);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kAmaxThreads / 32 ? red[lane] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) atomicMax(amax, m);
  }
}

__device__ __forceinline__ uint32_t word_of(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// element j (a compile-time index) of a 16-byte vector of T, as f32
template <typename T>
__device__ __forceinline__ float elem(const uint4& u, int j);
template <>
__device__ __forceinline__ float elem<float>(const uint4& u, int j) {
  return __uint_as_float(word_of(u, j));
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& u, int j) {
  const uint32_t w = word_of(u, j / 2);
  return __uint_as_float(j % 2 ? w & 0xffff0000u : w << 16);
}

// the first `left` (< 16 / sizeof(T)) elements at src, zeros after them
template <typename T>
__device__ __forceinline__ uint4 load_tail(const T* src, long long left) {
  constexpr int kVec = 16 / sizeof(T);
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    if (j < left) {
      const uint32_t bits =
          sizeof(T) == 2
              ? (uint32_t)reinterpret_cast<const unsigned short*>(src)[j]
              : reinterpret_cast<const uint32_t*>(src)[j];
      w[j * sizeof(T) / 4] |= bits << (8 * ((j * sizeof(T)) % 4));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// round(v / scale) clipped to [-127, 127], as __float2int_rn(__fdiv_rn(v,
// scale)) gives it.  y = v * inv (inv = 1 / scale rounded) lies within 2
// ulps of the rounded quotient (|y| < 128: 2 ulps <= 2^-16), so where y is
// more than 2^-15 from a half-integer both round to the same integer; else
// (and for NaN) the IEEE division decides.
__device__ __forceinline__ int quant1(float v, float scale, float inv) {
  const float y = v * inv;
  const float t = fabsf(y);
  int q;
  if (fabsf(t - floorf(t) - 0.5f) > 0x1p-15f)
    q = __float2int_rn(y);
  else
    q = __float2int_rn(__fdiv_rn(v, scale));
  return max(-127, min(127, q));
}

__device__ __forceinline__ uint32_t quant4(float a, float b, float c, float d,
                                           float scale, float inv) {
  return ((uint32_t)quant1(a, scale, inv) & 0xffu) |
         (((uint32_t)quant1(b, scale, inv) & 0xffu) << 8) |
         (((uint32_t)quant1(c, scale, inv) & 0xffu) << 16) |
         (((uint32_t)quant1(d, scale, inv) & 0xffu) << 24);
}

// Pass 2: quantize + transpose, x (N, C, S) -> q (N, S, Cp).  A block takes
// one (n, 32-channel, 256-position) tile, the last tile first.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
    quantize_pass(const T* __restrict__ x, int C, long long S, int Cp,
                  int tiles_s, int tiles_c, long long n_tiles, int vec_ok,
                  const unsigned int* __restrict__ amax, float eps,
                  int8_t* __restrict__ q, float* __restrict__ scale_out) {
  // int8 tile [channel][position], 4 positions a word (word w of rows
  // 16-31 at w ^ 16)
  __shared__ __align__(16) uint32_t tile[kQuantC][kQuantS / 4];
  constexpr int kVec = 16 / sizeof(T);          // positions a 16-byte load
  constexpr int kGroups = kQuantS / kVec;       // loads a channel row
  const float a = __uint_as_float(*amax);
  const float scale = a != a ? a : __fdiv_rn(fmaxf(a, eps), 127.0f);
  const float inv = __frcp_rn(scale);
  if (blockIdx.x == 0 && threadIdx.x == 0) scale_out[0] = scale;
  const long long b = n_tiles - 1 - blockIdx.x;
  const int ts = (int)(b % tiles_s);
  const long long rest = b / tiles_s;
  const int tc = (int)(rest % tiles_c);
  const long long n = rest / tiles_c;
  const int c0 = tc * kQuantC;
  const long long s0 = (long long)ts * kQuantS;

  for (int l = threadIdx.x; l < kQuantC * kGroups; l += kQuantThreads) {
    const int cl = l / kGroups, g = l - cl * kGroups;
    const int c = c0 + cl;
    const long long s = s0 + (long long)g * kVec;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (c < C && s < S) {
      const T* src = x + ((long long)n * C + c) * S + s;
      u = vec_ok && s + kVec <= S
              ? __ldg(reinterpret_cast<const uint4*>(src))
              : load_tail(src, S - s);
    }
#pragma unroll
    for (int w = 0; w < kVec / 4; ++w)
      tile[cl][(g * kVec / 4 + w) ^ (cl & 16)] =
          quant4(elem<T>(u, 4 * w), elem<T>(u, 4 * w + 1),
                 elem<T>(u, 4 * w + 2), elem<T>(u, 4 * w + 3), scale, inv);
  }
  __syncthreads();
  // store: a thread takes 4 positions x 16 channels (one channel half),
  // its neighbour the other half, so a warp writes whole 32-byte sectors;
  // rows 16-31 keep word w at w ^ 16, so the two halves read other banks
  const int pg = threadIdx.x / 2;
  const int half = threadIdx.x % 2;
  uint32_t out[4][4];   // [position][4-channel word]
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = 16 * half + 4 * j;
    const int wi = pg ^ (r & 16);
    const uint32_t w0 = tile[r][wi], w1 = tile[r + 1][wi],
                   w2 = tile[r + 2][wi], w3 = tile[r + 3][wi];
    const uint32_t lo01 = __byte_perm(w0, w1, 0x5140);
    const uint32_t hi01 = __byte_perm(w0, w1, 0x7362);
    const uint32_t lo23 = __byte_perm(w2, w3, 0x5140);
    const uint32_t hi23 = __byte_perm(w2, w3, 0x7362);
    out[0][j] = __byte_perm(lo01, lo23, 0x5410);
    out[1][j] = __byte_perm(lo01, lo23, 0x7632);
    out[2][j] = __byte_perm(hi01, hi23, 0x5410);
    out[3][j] = __byte_perm(hi01, hi23, 0x7632);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long s = s0 + 4 * pg + i;
    if (s < S)
      *reinterpret_cast<uint4*>(q + ((long long)n * S + s) * Cp + c0 +
                                16 * half) =
          make_uint4(out[i][0], out[i][1], out[i][2], out[i][3]);
  }
}

// Pass 1 on the host: zero the amax word, then fold |x| into it.
cudaError_t launch_amax(const void* x, int is_bf16, long long n,
                        unsigned int* amax, cudaStream_t stream) {
  const int elem = is_bf16 ? 2 : 4;
  const long long per_block = (long long)(16 / elem) * kAmaxThreads *
                              kAmaxUnroll;
  const long long blocks = (n + per_block - 1) / per_block;
  const int amax_blocks = (int)(blocks < kAmaxBlocks ? blocks : kAmaxBlocks);
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return err;
  if (is_bf16)
    absmax_pass<__nv_bfloat16><<<amax_blocks, kAmaxThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), n, amax);
  else
    absmax_pass<float><<<amax_blocks, kAmaxThreads, 0, stream>>>(
        static_cast<const float*>(x), n, amax);
  return cudaGetLastError();
}

// Pass 2 on the host: quantize x (N, C, S) from the amax word.
cudaError_t launch_quantize(const void* x, int is_bf16, int N, int C,
                            long long S, int Cp, const unsigned int* amax,
                            float eps, void* q, void* scale,
                            cudaStream_t stream) {
  const int elem = is_bf16 ? 2 : 4;
  const int tiles_s = (int)((S + kQuantS - 1) / kQuantS);
  const int tiles_c = Cp / kQuantC;
  const long long n_tiles = (long long)tiles_s * tiles_c * N;
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int vec_ok = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                     S % (16 / elem) == 0;
  if (is_bf16)
    quantize_pass<__nv_bfloat16><<<(unsigned)n_tiles, kQuantThreads, 0,
                                   stream>>>(
        static_cast<const __nv_bfloat16*>(x), C, S, Cp, tiles_s, tiles_c,
        n_tiles, vec_ok, amax, eps, static_cast<int8_t*>(q),
        static_cast<float*>(scale));
  else
    quantize_pass<float><<<(unsigned)n_tiles, kQuantThreads, 0, stream>>>(
        static_cast<const float*>(x), C, S, Cp, tiles_s, tiles_c, n_tiles,
        vec_ok, amax, eps, static_cast<int8_t*>(q),
        static_cast<float*>(scale));
  return cudaGetLastError();
}

bool act_shape_ok(int N, int C, long long S, int Cp) {
  return N >= 1 && C >= 1 && S >= 1 && Cp >= C && Cp % kQuantC == 0;
}

// ---- Q2: shared memory, barriers, TMA -------------------------------------

constexpr int kBM = 128;            // output positions a CTA (2 x 64 rows)
constexpr int kConvThreads = 384;   // 2 consumer warpgroups + 1 producer
constexpr int kMaxTaps = 27;
constexpr int kRingBudget = 184 * 1024;
constexpr int kMaxStages = 8;

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

// spin until the phase of the given parity has completed; a phase that
// never completes (a load the hardware refused) traps after ~2^26 polls, so
// the launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++polls == (1u << 26)) __trap();
  } while (!done);
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- Q2: wgmma ------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major operand in rows of CW bytes
// with the CW-byte swizzle (layout type 1: 128-byte, 2: 64-byte); 8-row
// groups are 8 CW bytes apart (SBO); LBO is unused by swizzled K-major
// layouts.
template <int CW>
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  constexpr uint64_t kLayout = CW == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * CW) >> 4) << 32) | (kLayout << 62);
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

// Pins the accumulator registers at this point of the program, so the
// compiler neither reads them before the wgmma that writes them has been
// waited for nor moves other instructions on them in between a wgmma.fence
// and its wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x N, s32, registers) (+)= A (64 x 32, s8, smem, K-major) B (N x 32,
// s8, smem, K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_s8_n224(int (&d)[112], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k32.s32.s8.s8 {"
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
      "%104, %105, %106, %107, %108, %109, %110, %111"
      "}, %112, %113, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
        "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),
        "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),
        "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]),
        "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]),
        "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]),
        "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
        "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]),
        "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]),
        "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]),
        "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]),
        "+r"(d[111])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n8(int (&d)[4], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(BN == 224 || BN == 8, "no wgmma wrapper for this N tile");
  if constexpr (BN == 224) wgmma_s8_n224(d, da, db, scale_d);
  else wgmma_s8_n8(d, da, db, scale_d);
}

// ---- Q2: the kernel -------------------------------------------------------

struct ConvArgs {
  const float* x_scale;
  const float* w_scale;
  const float* bias;    // null: no bias
  void* out;            // bf16, or int32 under kRaw
  long long osN, osK, osD, osH, osW;   // output strides (elements)
  int N, Do, Ho, Wo, K;
  int nb, db, hb, wb;                   // the M tile's box, product kBM
  int tiles_d, tiles_h, tiles_w;        // boxes along D, H, W
  int n_tiles;                          // N tiles of BN channels
  int sd, sh, sw;
  int taps, chunks;                     // depth = taps x chunks stages
  int off[3][kMaxTaps];                 // each tap's (d, h, w) offset
};

template <int CW, int BN>
struct ConvTiles {
  static constexpr int kA = kBM * CW;
  static constexpr int kB = BN * CW;
  static constexpr int kTx = kA + kB;                      // bytes a stage
  static constexpr int kStage = kA + (kB + 1023) / 1024 * 1024;  // its slot
  static constexpr int kStages = kRingBudget / kStage < kMaxStages
                                     ? kRingBudget / kStage
                                     : kMaxStages;
  static constexpr int kRing = kStages * kStage;
  // a channel of the epilogue tile: kBM + 8 elements of 2 (bf16) or 4
  // (int32, kRaw) bytes; the ring holds the larger
  static constexpr int kEpiRow = kBM + 8;
  static constexpr int kEpi = BN * kEpiRow * 4;
  static constexpr int kDeq = kRing;                  // BN floats
  static constexpr int kBias = kDeq + 4 * BN;         // BN floats
  static constexpr int kRowOff = kBias + 4 * BN;      // kBM long longs
  static constexpr int kBars = kRowOff + 8 * kBM;     // full, empty a stage
  static constexpr int kSmem = kBars + 16 * kStages;
  static constexpr int kSmemAlloc = kSmem + 1024;     // room to align
  static_assert(kStages >= 2 && kEpi <= kRing, "shared memory plan");
  static_assert(kA % 1024 == 0, "swizzle atoms start 1024-byte aligned");
};

template <int CW, int BN, bool kRaw>
__global__ void __launch_bounds__(kConvThreads, 1)
    int8_conv3d_wgmma(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_w,
                      const __grid_constant__ ConvArgs a) {
  using T = ConvTiles<CW, BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t full = base + T::kBars;
  const uint32_t empty = full + 8 * T::kStages;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  // this CTA's tile; the N tiles of one box are neighbours in the grid, so
  // they read its input while it is in L2
  const int nt = blockIdx.x % a.n_tiles;
  int mt = blockIdx.x / a.n_tiles;
  const int tw = mt % a.tiles_w;
  mt /= a.tiles_w;
  const int th = mt % a.tiles_h;
  mt /= a.tiles_h;
  const int td = mt % a.tiles_d;
  const int tn = mt / a.tiles_d;
  const int ow0 = tw * a.wb, oh0 = th * a.hb, od0 = td * a.db;
  const int on0 = tn * a.nb, k0 = nt * BN;
  const int iters = a.taps * a.chunks;

  if (threadIdx.x == 0) {
    for (int i = 0; i < T::kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      const int w0 = ow0 * a.sw, h0 = oh0 * a.sh, d0 = od0 * a.sd;
      int tap = 0, ch = 0;
      for (int it = 0; it < iters; ++it) {
        const int st = it % T::kStages;
        mbar_wait(empty + 8 * st, ((it / T::kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, T::kTx);
        const uint32_t sa = base + st * T::kStage;
        tma_load_5d(sa, &tm_x, full + 8 * st, ch * CW, w0 + a.off[2][tap],
                    h0 + a.off[1][tap], d0 + a.off[0][tap], on0);
        tma_load_3d(sa + T::kA, &tm_w, full + 8 * st, ch * CW, tap, k0);
        if (++ch == a.chunks) {
          ch = 0;
          ++tap;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int ctid = threadIdx.x;  // 0..255
    float* deq = reinterpret_cast<float*>(gbase + T::kDeq);
    float* bias = reinterpret_cast<float*>(gbase + T::kBias);
    long long* row_off = reinterpret_cast<long long*>(gbase + T::kRowOff);
    // epilogue constants, set while the first stages load
    if (!kRaw && ctid < BN) {
      const int k = k0 + ctid;
      deq[ctid] = k < a.K ? __fmul_rn(*a.x_scale, a.w_scale[k]) : 0.f;
      bias[ctid] = (a.bias != nullptr && k < a.K) ? a.bias[k] : 0.f;
    }
    if (ctid < kBM) {
      // row r of the tile is box position ((nb * Db + dz) * Hb + hy) * Wb
      // + wx, the order TMA writes the box in
      int r = ctid;
      const int wx = r % a.wb;
      r /= a.wb;
      const int hy = r % a.hb;
      r /= a.hb;
      const int dz = r % a.db;
      const int n = on0 + r / a.db;
      const int od = od0 + dz, oh = oh0 + hy, ow = ow0 + wx;
      row_off[ctid] = (n < a.N && od < a.Do && oh < a.Ho && ow < a.Wo)
                          ? n * a.osN + od * a.osD + oh * a.osH + ow * a.osW
                          : -1;
    }

    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int it = 0; it < iters; ++it) {
      const int st = it % T::kStages;
      mbar_wait(full + 8 * st, (it / T::kStages) & 1);
      const uint32_t sa = base + st * T::kStage + wg * 64 * CW;
      const uint32_t sb = base + st * T::kStage + T::kA;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CW / 32; ++kk)
        wgmma_s8<BN>(acc, gmma_desc<CW>(sa + 32 * kk),
                     gmma_desc<CW>(sb + 32 * kk), it > 0 || kk > 0);
      wgmma_commit();
      fence_regs(acc);
      // the previous stage's products are done: release its slot
      wgmma_wait<1>();
      fence_regs(acc);
      if (it > 0 && tid == 0)
        mbar_arrive(empty + 8 * ((it - 1) % T::kStages));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    // both warpgroups are done with the ring, and the constants are set
    named_sync(1, 256);

    // dequantize (or keep the int32 sums) into a channel-major tile over
    // the ring
    using Out = typename std::conditional<kRaw, int, __nv_bfloat16>::type;
    constexpr int kRun = 16 / (int)sizeof(Out);   // rows a 16-byte store
    Out* epi = reinterpret_cast<Out*>(gbase);
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const bool has_bias = a.bias != nullptr;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wg * 64 + warp * 16 + g + 8 * (e >> 1);
        const int col = 8 * j + 2 * t4 + (e & 1);
        if constexpr (kRaw) {
          epi[col * T::kEpiRow + row] = acc[4 * j + e];
        } else {
          float v = __fmul_rn(__int2float_rn(acc[4 * j + e]), deq[col]);
          if (has_bias) v = __fadd_rn(v, bias[col]);
          epi[col * T::kEpiRow + row] = __float2bfloat16_rn(v);
        }
      }
    named_sync(1, 256);

    // store: unit u is channel u / (kBM / kRun), rows kRun (u % (kBM /
    // kRun)) .. + kRun - 1
    for (int u = ctid; u < BN * (kBM / kRun); u += 256) {
      const int col = u / (kBM / kRun), seg = u % (kBM / kRun);
      const int k = k0 + col;
      if (k >= a.K) continue;
      const long long* ro = row_off + kRun * seg;
      const Out* src = epi + col * T::kEpiRow + kRun * seg;
      Out* dst = static_cast<Out*>(a.out) + k * a.osK;
      const long long o0 = ro[0];
      bool dense = o0 >= 0 &&
                   (reinterpret_cast<uintptr_t>(dst + o0) & 15) == 0;
#pragma unroll
      for (int r = 1; r < kRun; ++r) dense = dense && ro[r] == o0 + r;
      if (dense) {
        *reinterpret_cast<uint4*>(dst + o0) =
            *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int r = 0; r < kRun; ++r)
          if (ro[r] >= 0) dst[ro[r]] = src[r];
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

// The plan vector of kernels/int8_conv.py conv_plan: these fields, then the
// (d, h, w) offset of each tap.
enum PlanField {
  kPN, kPDi, kPHi, kPWi, kPCp, kPK, kPTaps, kPDo, kPHo, kPWo, kPSd, kPSh,
  kPSw, kPNb, kPDb, kPHb, kPWb, kPCw, kPBn, kPTilesN, kPTilesD, kPTilesH,
  kPTilesW, kPNTiles, kPChunks, kPOsN, kPOsK, kPOsD, kPOsH, kPOsW,
  kPOutBytes, kPlanHead
};

// a plan for an output of out_bytes a element (2: bf16, 4: int32)
bool plan_ok(const long long* p, int len, int out_bytes) {
  if (len < kPlanHead || p[kPTaps] < 1 || p[kPTaps] > kMaxTaps ||
      len != kPlanHead + 3 * p[kPTaps] || p[kPOutBytes] != out_bytes)
    return false;
  for (int f = kPN; f <= kPChunks; ++f)
    if (p[f] < 1 || p[f] > 0x7fffffffLL) return false;
  if (p[kPCp] % 32 != 0 || (p[kPCw] != 64 && p[kPCw] != 128) ||
      (p[kPBn] != 224 && p[kPBn] != 8) ||
      p[kPNb] * p[kPDb] * p[kPHb] * p[kPWb] != kBM ||
      p[kPChunks] * p[kPCw] < p[kPCp] || p[kPNTiles] * p[kPBn] < p[kPK])
    return false;
  const long long box[4][2] = {{p[kPWb], p[kPSw]}, {p[kPHb], p[kPSh]},
                               {p[kPDb], p[kPSd]}, {p[kPNb], 1}};
  for (const auto& b : box)
    if (b[1] < 1 || b[1] > 8 || b[0] * b[1] > 256) return false;
  return p[kPTilesN] * p[kPNb] >= p[kPN] && p[kPTilesD] * p[kPDb] >= p[kPDo] &&
         p[kPTilesH] * p[kPHb] >= p[kPHo] && p[kPTilesW] * p[kPWb] >= p[kPWo];
}

constexpr int kMaxDevices = 64;

template <int CW, int BN, bool kRaw>
int launch(const void* x, const void* w, const float* x_scale,
           const float* w_scale, const float* bias, void* out,
           const long long* p, cudaStream_t stream) {
  using T = ConvTiles<CW, BN>;
  auto kernel = int8_conv3d_wgmma<CW, BN, kRaw>;
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
  EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapSwizzle swizzle =
      CW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const cuuint64_t cp = p[kPCp];
  // xq (N, Di, Hi, Wi, Cp) as (Cp, Wi, Hi, Di, N); the box of a tap is the
  // output box times the strides, every s-th element taken
  CUtensorMap tm_x, tm_w;
  {
    const cuuint64_t dims[5] = {cp, (cuuint64_t)p[kPWi], (cuuint64_t)p[kPHi],
                                (cuuint64_t)p[kPDi], (cuuint64_t)p[kPN]};
    const cuuint64_t strides[4] = {cp, cp * p[kPWi], cp * p[kPWi] * p[kPHi],
                                   cp * p[kPWi] * p[kPHi] * p[kPDi]};
    const cuuint32_t box[5] = {(cuuint32_t)CW,
                               (cuuint32_t)(p[kPWb] * p[kPSw]),
                               (cuuint32_t)(p[kPHb] * p[kPSh]),
                               (cuuint32_t)(p[kPDb] * p[kPSd]),
                               (cuuint32_t)p[kPNb]};
    const cuuint32_t elem[5] = {1, (cuuint32_t)p[kPSw], (cuuint32_t)p[kPSh],
                                (cuuint32_t)p[kPSd], 1};
    if (encode(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5, const_cast<void*>(x),
               dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
               swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  // wq (K, taps, Cp) as (Cp, taps, K), box (CW, 1, BN)
  {
    const cuuint64_t dims[3] = {cp, (cuuint64_t)p[kPTaps], (cuuint64_t)p[kPK]};
    const cuuint64_t strides[2] = {cp, cp * p[kPTaps]};
    const cuuint32_t box[3] = {(cuuint32_t)CW, 1, (cuuint32_t)BN};
    const cuuint32_t elem[3] = {1, 1, 1};
    if (encode(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(w),
               dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
               swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  ConvArgs a;
  a.x_scale = x_scale;
  a.w_scale = w_scale;
  a.bias = bias;
  a.out = out;
  a.osN = p[kPOsN];
  a.osK = p[kPOsK];
  a.osD = p[kPOsD];
  a.osH = p[kPOsH];
  a.osW = p[kPOsW];
  a.N = (int)p[kPN];
  a.Do = (int)p[kPDo];
  a.Ho = (int)p[kPHo];
  a.Wo = (int)p[kPWo];
  a.K = (int)p[kPK];
  a.nb = (int)p[kPNb];
  a.db = (int)p[kPDb];
  a.hb = (int)p[kPHb];
  a.wb = (int)p[kPWb];
  a.tiles_d = (int)p[kPTilesD];
  a.tiles_h = (int)p[kPTilesH];
  a.tiles_w = (int)p[kPTilesW];
  a.n_tiles = (int)p[kPNTiles];
  a.sd = (int)p[kPSd];
  a.sh = (int)p[kPSh];
  a.sw = (int)p[kPSw];
  a.taps = (int)p[kPTaps];
  a.chunks = (int)p[kPChunks];
  for (int t = 0; t < a.taps; ++t)
    for (int i = 0; i < 3; ++i) a.off[i][t] = (int)p[kPlanHead + 3 * t + i];
  const long long grid = p[kPTilesN] * p[kPTilesD] * p[kPTilesH] *
                         p[kPTilesW] * p[kPNTiles];
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<(unsigned)grid, kConvThreads, T::kSmemAlloc, stream>>>(tm_x, tm_w,
                                                                  a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Q1: x (N, C, S) bf16 (is_bf16 = 1) or f32 -> q (N, S, Cp) int8, scale
// (1,) f32; amax: one 4-byte word of scratch.  Both passes: the same
// launches as echoscene_quantize_amax then echoscene_quantize_with_amax.
// Returns cudaGetLastError().
int echoscene_quantize_act(const void* x, int is_bf16, int N, int C,
                           long long S, int Cp, void* amax, float eps,
                           void* q, void* scale, cudaStream_t stream) {
  if (!act_shape_ok(N, C, S, Cp))
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned int* am = static_cast<unsigned int*>(amax);
  const cudaError_t err =
      launch_amax(x, is_bf16, (long long)N * C * S, am, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_quantize(x, is_bf16, N, C, S, Cp, am, eps, q, scale, stream));
}

// Q1's pass 1 alone: amax (one 4-byte word) = the bit pattern of max |x|
// over the n elements of x, a non-negative f32's bits.  Returns
// cudaGetLastError().
int echoscene_quantize_amax(const void* x, int is_bf16, long long n,
                            void* amax, cudaStream_t stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_amax(
      x, is_bf16, n, static_cast<unsigned int*>(amax), stream));
}

// Q1's pass 2 alone: x (N, C, S) -> q (N, S, Cp) int8, scale (1,) f32, from
// an amax word of echoscene_quantize_amax (or a MAX of several).  Returns
// cudaGetLastError().
int echoscene_quantize_with_amax(const void* x, int is_bf16, int N, int C,
                                 long long S, int Cp, const void* amax,
                                 float eps, void* q, void* scale,
                                 cudaStream_t stream) {
  if (!act_shape_ok(N, C, S, Cp))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_quantize(
      x, is_bf16, N, C, S, Cp, static_cast<const unsigned int*>(amax), eps,
      q, scale, stream));
}

// Q2: xq (N, Di, Hi, Wi, Cp) int8, wq (K, kd, kh, kw, Cp) int8, x_scale
// (1,) f32, w_scale (K,) f32, bias (K,) f32 or null -> out bf16 at the
// plan's element strides.  plan: plan_len int64 values of
// kernels/int8_conv.py conv_plan (PlanField, then the taps' offsets).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a plan the
// kernel does not take.
int echoscene_int8_conv3d(const void* x, const void* w, const void* x_scale,
                          const void* w_scale, const void* bias, void* out,
                          const long long* plan, int plan_len,
                          cudaStream_t stream) {
  if (!plan_ok(plan, plan_len, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xs = static_cast<const float*>(x_scale);
  const float* ws = static_cast<const float*>(w_scale);
  const float* b = static_cast<const float*>(bias);
  const bool wide = plan[kPCw] == 128;
  if (plan[kPBn] == 224)
    return wide ? launch<128, 224, false>(x, w, xs, ws, b, out, plan, stream)
                : launch<64, 224, false>(x, w, xs, ws, b, out, plan, stream);
  return wide ? launch<128, 8, false>(x, w, xs, ws, b, out, plan, stream)
              : launch<64, 8, false>(x, w, xs, ws, b, out, plan, stream);
}

// Q2's int32 accumulators alone: xq, wq as above -> out int32 at the plan's
// element strides, no dequantize, no bias.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan the kernel does not take.
int echoscene_int8_conv3d_acc(const void* x, const void* w, void* out,
                              const long long* plan, int plan_len,
                              cudaStream_t stream) {
  if (!plan_ok(plan, plan_len, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = plan[kPCw] == 128;
  if (plan[kPBn] == 224)
    return wide ? launch<128, 224, true>(x, w, nullptr, nullptr, nullptr,
                                         out, plan, stream)
                : launch<64, 224, true>(x, w, nullptr, nullptr, nullptr, out,
                                        plan, stream);
  return wide ? launch<128, 8, true>(x, w, nullptr, nullptr, nullptr, out,
                                     plan, stream)
              : launch<64, 8, true>(x, w, nullptr, nullptr, nullptr, out,
                                    plan, stream);
}

}  // extern "C"
