// GroupNorm (+ a per-channel shift) + activation in one pass, for Hopper
// (sm_90a): the shape UNet torso's 46 norms a denoiser call.
//
// A hand kernel of the port with no Pallas counterpart: the JAX package's
// group_norm_fast (echoscene_tpu/nn/blocks.py) is XLA's fusion of the norm,
// its `shift=` add and the SiLU that follows.  Written out in PyTorch
// (nn/blocks.py group_norm, then nn.SiLU or nn.quant.RoundedSiLU) the same
// function is five to nine passes over device memory: x to f32, + shift,
// the statistics, the apply, back to bf16, then the activation's one pass
// (SiLU) or five (RoundedSiLU's neg, exp, add, reciprocal, mul).  Called by
// echoscene_torch/kernels/group_norm.py, which holds the plain version.
//
// y = act(bf16(GN(x + shift))), x (N, C, S) bf16 channel-first (S the
// spatial positions), G groups of C / G channels; shift (N, C) bf16 or f32,
// or none; weight, bias (C,) bf16 or f32.  As the plain version:
//   * v = f32(x) + shift[n, c] in f32 (no add without a shift);
//   * mean and var = mean((v - mean)^2) of the (n, g) slab in f32, rstd =
//     rsqrtf(var + eps);
//   * a = rstd * weight[c], b = fma(-a, mean, bias[c]), y = fma(a, v, b)
//     (ATen's fused affine), rounded to bf16;
//   * the activation on that bf16 value: none; "silu", F.silu on a bf16
//     tensor, y / (1 + expf(-y)) in f32 rounded once; "rounded_silu",
//     RoundedSiLU's neg, exp, add 1, reciprocal and mul, each rounded to
//     bf16.
// Only the order of the f32 sums differs from the plain version.
//
// Bound: bytes, 2 read + 2 written an element at 3.35 TB/s.  One CTA of 512
// threads a (row, group) slab, which is contiguous in x:
//   * thread 0 copies the whole slab (at most ~226 KB: 86,016 bf16, 168 KB,
//     at the flagship's widest) into shared memory by TMA bulk copies of
//     16 KB, each completing on its own mbarrier;
//   * the sum is taken chunk by chunk as the chunks land, then the squared
//     deviations from the mean, both from shared memory (a two-pass
//     variance, no E[x^2] - E[x]^2);
//   * the apply reads shared memory once more and writes the result with
//     16-byte stores.
// So x is read from device memory once and y written once.  The sums are
// per-thread f32 sums, then a warp-shuffle tree, then one warp over the
// warps' sums: a fixed order, so runs are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kChunkBytes = 16384;          // one bulk copy
constexpr int kMaxChunks = 16;                   // mbarriers in the header
constexpr unsigned kHeaderBytes = 256;           // mbarriers + warp sums
constexpr unsigned kMaxSmem = 232448;            // a block's dynamic limit

enum Act { kNone = 0, kSilu = 1, kRoundedSilu = 2 };

__host__ __device__ constexpr unsigned params_bytes(int cpg) {
  // shift, a and b for each channel of the group, padded to 16 bytes
  return (12u * cpg + 15u) & ~15u;
}

__host__ __device__ constexpr unsigned long long smem_bytes(
    int cpg, long long hw) {
  return kHeaderBytes + params_bytes(cpg) + 2ull * cpg * hw;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
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

// Waits for phase `parity` of the mbarrier; traps after ~2^26 polls, so a
// copy that never completes fails the launch instead of hanging the card.
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

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float load_param(const void* p, int is_bf16,
                                            long long i) {
  return is_bf16 ? __bfloat162float(
                       static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// The sum over the block, in a fixed order; every thread gets it.
// `warp_sums` holds kWarps floats; the block must reach this together.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = lane < kWarps ? warp_sums[lane] : 0.f;
#pragma unroll
  for (int o = 16; o; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  __syncthreads();  // warp_sums free for the next sum
  return t;
}

// Eight bf16 of a 16-byte word, as f32, + the channel's shift.
__device__ __forceinline__ void unpack(const uint4& w, float sh,
                                       bool has_shift, float (&v)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    v[2 * i] = has_shift ? f.x + sh : f.x;
    v[2 * i + 1] = has_shift ? f.y + sh : f.y;
  }
}

template <int kAct>
__device__ __forceinline__ __nv_bfloat16 activate(__nv_bfloat16 h) {
  if (kAct == kNone) return h;
  const float y = __bfloat162float(h);
  if (kAct == kSilu) return __float2bfloat16_rn(y / (1.0f + expf(-y)));
  // RoundedSiLU: every op rounded to bf16 (neg is exact)
  __nv_bfloat16 t = __float2bfloat16_rn(expf(-y));
  t = __float2bfloat16_rn(__bfloat162float(t) + 1.0f);
  t = __float2bfloat16_rn(1.0f / __bfloat162float(t));
  return __float2bfloat16_rn(__bfloat162float(t) * y);
}

template <int kAct>
__global__ void __launch_bounds__(kThreads)
    group_norm_act_kernel(const __nv_bfloat16* __restrict__ x,
                          __nv_bfloat16* __restrict__ y,
                          const void* __restrict__ weight, int w_bf16,
                          const void* __restrict__ bias, int b_bf16,
                          const void* __restrict__ shift, int shift_bf16,
                          int C, int cpg, long long hw, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const long long slab_index = blockIdx.x;  // n * G + g
  const int groups = C / cpg;
  const int n = static_cast<int>(slab_index / groups);
  const int g = static_cast<int>(slab_index % groups);
  const long long slab = static_cast<long long>(cpg) * hw;  // elements
  const uint32_t slab_bytes = static_cast<uint32_t>(2 * slab);
  const int chunks = static_cast<int>((slab_bytes + kChunkBytes - 1) /
                                      kChunkBytes);
  const uint32_t bars = smem_addr(smem);
  float* warp_sums = reinterpret_cast<float*>(smem + 8 * kMaxChunks);
  float* ch_shift = reinterpret_cast<float*>(smem + kHeaderBytes);
  float* ch_a = ch_shift + cpg;
  float* ch_b = ch_a + cpg;
  const uint4* data = reinterpret_cast<const uint4*>(
      smem + kHeaderBytes + params_bytes(cpg));
  const char* src = reinterpret_cast<const char*>(x + slab_index * slab);

  if (tid == 0) {
    for (int i = 0; i < chunks; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < chunks; ++i) {
      const uint32_t off = i * kChunkBytes;
      const uint32_t bytes = min(kChunkBytes, slab_bytes - off);
      mbar_expect_tx(bars + 8 * i, bytes);
      bulk_load(smem_addr(data) + off, src + off, bytes, bars + 8 * i);
    }
  }
  const bool has_shift = shift != nullptr;
  for (int c = tid; c < cpg; c += kThreads)
    ch_shift[c] = has_shift ? load_param(shift, shift_bf16,
                                         static_cast<long long>(n) * C +
                                             g * cpg + c)
                            : 0.f;
  __syncthreads();  // the mbarriers initialised, the shifts in place

  // at most ~14,500 16-byte words a slab: int arithmetic
  const int vec_per_ch = static_cast<int>(hw / 8);
  const int nvec = static_cast<int>(slab / 8);
  constexpr int kVecPerChunk = kChunkBytes / 16;

  // pass 1: the sum, chunk by chunk as the copies land
  float s = 0.f;
  int waited = -1;
  for (int v = tid; v < nvec; v += kThreads) {
    const int chunk = v / kVecPerChunk;
    while (waited < chunk) mbar_wait(bars + 8 * ++waited, 0);
    float e[8];
    unpack(data[v], ch_shift[v / vec_per_ch], has_shift, e);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += e[i];
  }
  // a thread that read no vector of the last chunks still has to see them
  // landed before pass 2 reads any vector
  while (waited < chunks - 1) mbar_wait(bars + 8 * ++waited, 0);
  const float count = static_cast<float>(slab);
  const float mean = block_sum(s, warp_sums) / count;

  // pass 2: the squared deviations from the mean
  float m2 = 0.f;
  for (int v = tid; v < nvec; v += kThreads) {
    float e[8];
    unpack(data[v], ch_shift[v / vec_per_ch], has_shift, e);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = e[i] - mean;
      m2 = fmaf(d, d, m2);
    }
  }
  const float rstd = rsqrtf(block_sum(m2, warp_sums) / count + eps);

  // the fused affine of each channel (ATen's: a = rstd * w, b = -a mean + b)
  for (int c = tid; c < cpg; c += kThreads) {
    const float a = rstd * load_param(weight, w_bf16, g * cpg + c);
    ch_a[c] = a;
    ch_b[c] = fmaf(-a, mean, load_param(bias, b_bf16, g * cpg + c));
  }
  __syncthreads();

  // pass 3: apply, round, activate, 16-byte stores
  uint4* out = reinterpret_cast<uint4*>(y + slab_index * slab);
  for (int v = tid; v < nvec; v += kThreads) {
    const int c = v / vec_per_ch;
    const float a = ch_a[c], b = ch_b[c];
    float e[8];
    unpack(data[v], ch_shift[c], has_shift, e);
    uint4 w;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&w);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      h[i] = activate<kAct>(__float2bfloat16_rn(fmaf(a, e[i], b)));
    out[v] = w;
  }
}

template <int kAct>
cudaError_t launch(const void* x, void* y, const void* weight, int w_bf16,
                   const void* bias, int b_bf16, const void* shift,
                   int shift_bf16, int N, int C, int G, long long hw,
                   float eps, cudaStream_t stream) {
  // the shared-memory limit is set once a device (idempotent: threads that
  // race set it twice)
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !configured[dev]) {
    err = cudaFuncSetAttribute(group_norm_act_kernel<kAct>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return err;
    if (dev < 64) configured[dev] = true;
  }
  const int cpg = C / G;
  group_norm_act_kernel<kAct>
      <<<N * G, kThreads, static_cast<size_t>(smem_bytes(cpg, hw)),
         stream>>>(static_cast<const __nv_bfloat16*>(x),
                   static_cast<__nv_bfloat16*>(y), weight, w_bf16, bias,
                   b_bf16, shift, shift_bf16, C, cpg, hw, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y = act(bf16(GroupNorm(x + shift))): x, y (N, C, hw) bf16, contiguous,
// 16-byte aligned; weight, bias (C,) bf16 (w_bf16 / b_bf16 = 1) or f32;
// shift (N, C) bf16 or f32, or null; act 0 none, 1 silu, 2 rounded_silu.
// Takes G dividing C, hw a multiple of 8 and a slab that fits a block's
// shared memory (kernels/group_norm.py smem_bytes); returns
// cudaErrorInvalidValue on anything else, else cudaGetLastError().
int echoscene_group_norm_act(const void* x, void* y, const void* weight,
                             int w_bf16, const void* bias, int b_bf16,
                             const void* shift, int shift_bf16, int N, int C,
                             int G, long long hw, float eps, int act,
                             cudaStream_t stream) {
  if (N < 1 || G < 1 || C % G != 0 || hw < 8 || hw % 8 != 0 ||
      static_cast<long long>(N) * G >= (1ll << 31) ||
      smem_bytes(C / G, hw) > kMaxSmem ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (act) {
    case kNone:
      return static_cast<int>(launch<kNone>(x, y, weight, w_bf16, bias,
                                            b_bf16, shift, shift_bf16, N, C,
                                            G, hw, eps, stream));
    case kSilu:
      return static_cast<int>(launch<kSilu>(x, y, weight, w_bf16, bias,
                                            b_bf16, shift, shift_bf16, N, C,
                                            G, hw, eps, stream));
    case kRoundedSilu:
      return static_cast<int>(launch<kRoundedSilu>(
          x, y, weight, w_bf16, bias, b_bf16, shift, shift_bf16, N, C, G, hw,
          eps, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
