// The earlier design of the int8 W8A8 kernels Q1 / Q2 (the first one,
// written for Hopper sm_90a), kept unchanged beside their redesign in
// int8_conv.cu so that chip_smoke.py can time both on the same inputs in
// one run.  No path of the port calls these entry points
// (echoscene_quantize_act_mma, echoscene_int8_conv3d_mma); they are reached
// only through kernels/int8_conv.py's earlier_quantize_act /
// earlier_int8_conv3d.
//
// Q1, echoscene_quantize_act_mma.  The per-tensor symmetric quantize of
// JAX's quantize_symmetric(x, axes=None) (echoscene_tpu/nn/quant.py):
// amax = max |x|, scale = max(amax, eps) / 127, q = clip(round(x / scale),
// -127, 127), IEEE division and round-half-to-even, written channels-last
// (N, S, Cp), Cp = C rounded up to 32.  Two kernels: a grid-stride abs-max
// that writes one partial maximum a block, then the quantize, whose blocks
// each fold all the partials into the scale and transpose a 32-channel x
// 64-position tile through shared memory with 2-byte loads and 1-byte
// stores.
//
// Q2, echoscene_int8_conv3d_mma.  An implicit-GEMM int8 convolution: a CTA
// of 256 threads computes a 128 x 64 tile; each depth step is one tap's 32
// channels, staged by cp.async (zero fill for taps outside the input) in a
// 4-stage ring; each warp runs 2 x 4 mma.sync.m16n8k32.s32.s8.s8.s32 a
// step on fragments read by 32-bit shared loads; the epilogue dequantizes
// (product rounded before the bias add, no FMA) and stores bf16 through the
// output's strides, decoding the position of every element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAmaxThreads = 256;
constexpr int kQuantTileC = 32;   // channels a quantize tile
constexpr int kQuantTileS = 64;   // positions a quantize tile

constexpr int kBM = 128;          // output positions a CTA
constexpr int kBN = 64;           // output channels a CTA
constexpr int kBK = 32;           // bytes of depth a stage (one mma k)
constexpr int kStages = 4;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ float abs_max_of_vec(const uint4& v);

template <>
__device__ __forceinline__ float abs_max_of_vec<float>(const uint4& v) {
  float m = fabsf(__uint_as_float(v.x));
  m = fmaxf(m, fabsf(__uint_as_float(v.y)));
  m = fmaxf(m, fabsf(__uint_as_float(v.z)));
  return fmaxf(m, fabsf(__uint_as_float(v.w)));
}

template <>
__device__ __forceinline__ float abs_max_of_vec<__nv_bfloat16>(
    const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bf16 is the top half of an f32
    m = fmaxf(m, fabsf(__uint_as_float(w[i] << 16)));
    m = fmaxf(m, fabsf(__uint_as_float(w[i] & 0xffff0000u)));
  }
  return m;
}

__device__ __forceinline__ float block_max(float m, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = (blockDim.x * blockDim.y) >> 5;
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = lane < nwarps ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  return m;
}

// One partial abs-max a block; 16-byte loads where the tensor allows them.
template <typename T>
__global__ void __launch_bounds__(kAmaxThreads)
    absmax_partial(const T* __restrict__ x, long long n,
                   float* __restrict__ partial) {
  __shared__ float red[32];
  constexpr int kVec = 16 / sizeof(T);
  float m = 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  long long head = 0;
  if (aligned) {
    const long long nvec = n / kVec;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (long long i = tid; i < nvec; i += stride) {
      m = fmaxf(m, abs_max_of_vec<T>(xv[i]));
    }
    head = nvec * kVec;
  }
  for (long long i = head + tid; i < n; i += stride) {
    m = fmaxf(m, fabsf(to_float(x[i])));
  }
  // each warp holds its lanes in one register; threadIdx.y is 0 here
  m = block_max(m, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

// Quantize + transpose: block (s tile, c tile, n), threads (32, 8).
template <typename T>
__global__ void __launch_bounds__(256)
    quantize_cl(const T* __restrict__ x, int C, long long S, int Cp,
                const float* __restrict__ partial, int nparts, float eps,
                int8_t* __restrict__ q, float* __restrict__ scale_out) {
  __shared__ float red[32];
  __shared__ float tile[kQuantTileC][kQuantTileS + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int flat = ty * 32 + tx;
  float m = 0.f;
  for (int i = flat; i < nparts; i += 256) m = fmaxf(m, partial[i]);
  // block_max reads threadIdx.x as the flat index: use the flat id here
  {
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
    if (tx == 0) red[ty] = m;
    __syncthreads();
    m = tx < 8 ? red[tx] : 0.f;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
  }
  const float scale = fmaxf(m, eps) / 127.0f;   // IEEE division
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && flat == 0) {
    scale_out[0] = scale;
  }
  const long long n = blockIdx.z;
  const int c0 = blockIdx.y * kQuantTileC;
  const long long s0 = (long long)blockIdx.x * kQuantTileS;
  // load: rows of channels, positions along tx (coalesced in x)
  for (int cl = ty; cl < kQuantTileC; cl += 8) {
    const int c = c0 + cl;
#pragma unroll
    for (int sl = tx; sl < kQuantTileS; sl += 32) {
      const long long s = s0 + sl;
      float v = 0.f;
      if (c < C && s < S) v = to_float(x[(n * C + c) * S + s]);
      tile[cl][sl] = v;
    }
  }
  __syncthreads();
  // store: channels along tx (32 consecutive bytes a position)
  const int c = c0 + tx;
  for (int sl = ty; sl < kQuantTileS; sl += 8) {
    const long long s = s0 + sl;
    if (s >= S) break;
    int v = 0;
    if (c < C) {
      v = __float2int_rn(__fdiv_rn(tile[tx][sl], scale));
      v = max(-127, min(127, v));
    }
    q[(n * S + s) * Cp + c] = (int8_t)v;
  }
}

struct ConvParams {
  const int8_t* x;
  const int8_t* w;
  const float* x_scale;
  const float* w_scale;
  const float* bias;
  __nv_bfloat16* out;
  long long M;
  int Di, Hi, Wi, Cp, K;
  int kd, kh, kw, sd, sh, sw, pd, ph, pw;
  int Do, Ho, Wo;
  long long osN, osK, osD, osH, osW;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// byte offset of (row, 16-byte half) in a 32-byte-row stage: the halves
// swap on every other group of 4 rows (conflict-free fragment loads)
__device__ __forceinline__ int swz(int row, int half) {
  return row * kBK + ((half ^ ((row >> 2) & 1)) << 4);
}

__global__ void __launch_bounds__(kThreads)
    int8_conv3d_kernel(const ConvParams p) {
  __shared__ __align__(128) int8_t As[kStages][kBM * kBK];
  __shared__ __align__(128) int8_t Bs[kStages][kBN * kBK];

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // loader roles: A row tid / 2, half tid % 2; B the same for tid < 128
  const int a_row = tid >> 1, a_half = tid & 1;
  const long long am = m0 + a_row;
  const bool am_ok = am < p.M;
  int an = 0, ad = 0, ah = 0, aw = 0;
  if (am_ok) {
    long long t = am;
    aw = (int)(t % p.Wo);
    t /= p.Wo;
    ah = (int)(t % p.Ho);
    t /= p.Ho;
    ad = (int)(t % p.Do);
    an = (int)(t / p.Do);
  }
  const int d0 = ad * p.sd - p.pd, h0 = ah * p.sh - p.ph,
            w0 = aw * p.sw - p.pw;
  const bool b_loader = tid < kBN * 2;
  const int b_row = tid >> 1, b_half = tid & 1;
  const bool b_ok = b_loader && (n0 + b_row) < p.K;
  const int taps = p.kd * p.kh * p.kw;
  const int cchunks = p.Cp / kBK;
  const int iters = taps * cchunks;
  const long long w_row = (long long)taps * p.Cp;

  auto load_stage = [&](int stage, int it) {
    const int tap = it / cchunks, cc = it - tap * cchunks;
    const int tz = tap / (p.kh * p.kw);
    const int r = tap - tz * p.kh * p.kw;
    const int ty = r / p.kw, tx = r - ty * p.kw;
    const int di = d0 + tz, hi = h0 + ty, wi = w0 + tx;
    const bool ok = am_ok && di >= 0 && di < p.Di && hi >= 0 && hi < p.Hi &&
                    wi >= 0 && wi < p.Wi;
    const int8_t* src =
        ok ? p.x + ((((long long)an * p.Di + di) * p.Hi + hi) * p.Wi + wi) *
                       p.Cp + cc * kBK + a_half * 16
           : p.x;
    cp_async16(&As[stage][swz(a_row, a_half)], src, ok ? 16 : 0);
    if (b_loader) {
      const int8_t* wsrc =
          b_ok ? p.w + (long long)(n0 + b_row) * w_row + (long long)tap * p.Cp +
                     cc * kBK + b_half * 16
               : p.w;
      cp_async16(&Bs[stage][swz(b_row, b_half)], wsrc, b_ok ? 16 : 0);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < iters) load_stage(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = it + kStages - 1;
    if (nxt < iters) load_stage(nxt % kStages, nxt);
    cp_async_commit();
    const int8_t* as = As[it % kStages];
    const int8_t* bs = Bs[it % kStages];
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r0 = wm * 32 + mi * 16 + g, r1 = r0 + 8;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(as + swz(r0, 0) + 4 * t4);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(as + swz(r1, 0) + 4 * t4);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(as + swz(r0, 1) + 4 * t4);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(as + swz(r1, 1) + 4 * t4);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int rn = wn * 32 + ni * 8 + g;
      b[ni][0] = *reinterpret_cast<const uint32_t*>(bs + swz(rn, 0) + 4 * t4);
      b[ni][1] = *reinterpret_cast<const uint32_t*>(bs + swz(rn, 1) + 4 * t4);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(acc[mi][ni][0]), "+r"(acc[mi][ni][1]),
              "+r"(acc[mi][ni][2]), "+r"(acc[mi][ni][3])
            : "r"(a[mi][0]), "r"(a[mi][1]), "r"(a[mi][2]), "r"(a[mi][3]),
              "r"(b[ni][0]), "r"(b[ni][1]));
      }
  }
  cp_async_wait<0>();

  // epilogue: acc (row g / g + 8, column 2 t4 / 2 t4 + 1) of each tile
  const float xs = *p.x_scale;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = n0 + wn * 32 + ni * 8 + 2 * t4 + j;
      if (k >= p.K) continue;
      const float deq = __fmul_rn(xs, p.w_scale[k]);
      const float bk = p.bias != nullptr ? p.bias[k] : 0.f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long m = m0 + wm * 32 + mi * 16 + g + 8 * h;
          if (m >= p.M) continue;
          long long t = m;
          const int ow = (int)(t % p.Wo);
          t /= p.Wo;
          const int oh = (int)(t % p.Ho);
          t /= p.Ho;
          const int od = (int)(t % p.Do);
          const long long on = t / p.Do;
          float v = __fmul_rn(__int2float_rn(acc[mi][ni][2 * h + j]), deq);
          if (p.bias != nullptr) v = __fadd_rn(v, bk);
          p.out[on * p.osN + k * p.osK + od * p.osD + oh * p.osH +
                ow * p.osW] = __float2bfloat16_rn(v);
        }
    }
}

}  // namespace

extern "C" {

// Threads of the abs-max pass (the wrapper sizes the partials' scratch).
int echoscene_quantize_amax_threads_mma() { return kAmaxThreads; }

// Q1: x (N, C, S) bf16 (is_bf16 = 1) or f32 -> q (N, S, Cp) int8, scale
// (1,) f32; partial: nparts floats of scratch.  Returns cudaGetLastError().
int echoscene_quantize_act_mma(const void* x, int is_bf16, int N, int C,
                               long long S, int Cp, void* partial, int nparts,
                               float eps, void* q, void* scale,
                               cudaStream_t stream) {
  const long long n = (long long)N * C * S;
  dim3 grid((unsigned)((S + kQuantTileS - 1) / kQuantTileS),
            (unsigned)(Cp / kQuantTileC), (unsigned)N);
  dim3 block(32, 8);
  if (is_bf16) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    absmax_partial<__nv_bfloat16><<<nparts, kAmaxThreads, 0, stream>>>(
        xb, n, static_cast<float*>(partial));
    quantize_cl<__nv_bfloat16><<<grid, block, 0, stream>>>(
        xb, C, S, Cp, static_cast<const float*>(partial), nparts, eps,
        static_cast<int8_t*>(q), static_cast<float*>(scale));
  } else {
    const float* xf = static_cast<const float*>(x);
    absmax_partial<float><<<nparts, kAmaxThreads, 0, stream>>>(
        xf, n, static_cast<float*>(partial));
    quantize_cl<float><<<grid, block, 0, stream>>>(
        xf, C, S, Cp, static_cast<const float*>(partial), nparts, eps,
        static_cast<int8_t*>(q), static_cast<float*>(scale));
  }
  return (int)cudaGetLastError();
}

// Q2: xq (N, Di, Hi, Wi, Cp) int8, wq (K, kd, kh, kw, Cp) int8, x_scale
// (1,) f32, w_scale (K,) f32, bias (K,) f32 or null -> out bf16 at element
// strides (osN, osK, osD, osH, osW).  Returns cudaGetLastError().
int echoscene_int8_conv3d_mma(const void* x, const void* w,
                              const void* x_scale, const void* w_scale,
                              const void* bias, void* out, int N, int Di,
                              int Hi, int Wi, int Cp, int K, int kd, int kh,
                              int kw, int sd, int sh, int sw, int pd, int ph,
                              int pw, int Do, int Ho, int Wo, long long osN,
                              long long osK, long long osD, long long osH,
                              long long osW, cudaStream_t stream) {
  ConvParams p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.x_scale = static_cast<const float*>(x_scale);
  p.w_scale = static_cast<const float*>(w_scale);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.M = (long long)N * Do * Ho * Wo;
  p.Di = Di;
  p.Hi = Hi;
  p.Wi = Wi;
  p.Cp = Cp;
  p.K = K;
  p.kd = kd;
  p.kh = kh;
  p.kw = kw;
  p.sd = sd;
  p.sh = sh;
  p.sw = sw;
  p.pd = pd;
  p.ph = ph;
  p.pw = pw;
  p.Do = Do;
  p.Ho = Ho;
  p.Wo = Wo;
  p.osN = osN;
  p.osK = osK;
  p.osD = osD;
  p.osH = osH;
  p.osW = osW;
  dim3 grid((unsigned)((p.M + kBM - 1) / kBM), (unsigned)((K + kBN - 1) / kBN));
  int8_conv3d_kernel<<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
