// Non-causal softmax attention for Hopper (sm_90a), f32 in / f32 out, on the
// CUDA cores.
//
// The f32 counterpart of csrc/flash_attention.cu (bf16, TMA + wgmma).  It
// replaces the same two Pallas TPU kernels of
// echoscene_tpu/kernels/flash_attention.py when they run on f32 inputs, which
// JAX's kernels take (the output keeps the input dtype, :139, :193):
//   * _onepass_kernel (:73, driven by _onepass_impl): the shape UNet's
//     1024-token self-attention, 8 heads of dim 56, 5 launches per shape step
//     under `sample_dtype: float32` or `compute_dtype: float32`;
//   * _stream_kernel (:35, driven by _stream_impl): the VQ-VAE's 4096-token
//     single-head attention with C = 256, one launch per 8-object chunk.
// Both compute O = softmax(Q K^T * D^-1/2) V per (batch, head) in f32 with an
// online softmax (running max and sum in the log2 domain), f32 accumulation
// of P V and the division by the row sum at the end, as the TPU kernels do.
// Every product is an f32 FMA: no TF32 and no tensor cores, since the port
// keeps TF32 off so that f32 work stays f32.
//
// What bounds it on the H100.  Per (batch, head) the function needs 4 L S D
// flops, which outside the tensor cores run at 67 TFLOP/s: at the UNet site
// (42 rows: B H = 336, L = S = 1024, D = 56) that is 1.18 ms, at the VQ-VAE
// site (B = 8, L = S = 4096, D = 256) 2.05 ms.  Its L S exponentials take
// 0.084 / 0.032 ms on the SFU and its bytes 0.046 / 0.005 ms, so the FMAs bound
// both sites.
//
// Design (simple first; a 3xTF32 split on wgmma is the candidate for speed):
// one CTA of 256 threads per 64 query rows of one (batch, head).  The CTA
// keeps its Q tile in shared memory and walks over K/V in tiles of 64 keys:
//   * Q, K and V tiles sit in shared memory with an odd row stride (D_PAD + 1
//     floats), so a column read by 16 threads of consecutive rows hits 16
//     banks; rows past L or S are zero-filled;
//   * thread (ty, tx) of a 16 x 16 grid owns 4 query rows (4 ty + i) and,
//     for S = Q K^T, the 4 keys tx + 16 j; the row max and row sum of the
//     online softmax are taken over the 16 threads of a row by shuffles
//     within the half-warp;
//   * P goes through shared memory, and for O += P V the same thread owns the
//     D_PAD / 16 output columns tx + 16 c of its 4 rows.
// The loops are bound by shared-memory loads (one per two FMAs), so the
// kernel runs at a fraction of the FMA rate; the numbers are in PERF.md.
// Instantiated for D_PAD = 64, 128 and 256 (66, 116 and 214 KB of shared
// memory).  The wrapper checks what the bf16 kernel checks (D % 8 == 0,
// D <= 256, contiguous and 16-byte aligned), so both dtypes take the same
// shapes; the loads here are float4.
//
// Built by echoscene_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; each entry point returns a cudaError_t.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;    // query rows per CTA
constexpr int kBlockN = 64;    // keys per K/V tile
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kRows = 4;       // query rows per thread (kBlockM / 16)
constexpr int kKeys = 4;       // keys per thread in S (kBlockN / 16)
constexpr int kPStride = kBlockN + 1;

template <int D_PAD>
struct Layout {
  static constexpr int kStride = D_PAD + 1;  // odd: conflict-free columns
  static constexpr int kTile = kBlockM * kStride;
  static constexpr int kFloats = 3 * kTile + kBlockM * kPStride;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

// rows [row0, row0 + kBlockM) of one (batch, head): row r starts at
// src + r * row_step; rows at or past `n_rows` are zero-filled.  D % 4 == 0
// and 16-byte aligned rows, so each thread moves float4s.
template <int D_PAD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int n_rows,
                                          size_t row_step, int D) {
  const int vec = D / 4;
  for (int idx = threadIdx.x; idx < kBlockM * vec; idx += kThreads) {
    const int r = idx / vec;
    const int c = (idx - r * vec) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      x = __ldg(reinterpret_cast<const float4*>(
          src + static_cast<size_t>(row0 + r) * row_step + c));
    float* d = dst + r * Layout<D_PAD>::kStride + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

template <int D_PAD>
__global__ void __launch_bounds__(kThreads)
    attention_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int H, int L, int S, int D, float scale_log2) {
  using Lay = Layout<D_PAD>;
  constexpr int kStride = Lay::kStride;
  constexpr int kCols = D_PAD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + Lay::kTile;
  float* sv = sk + Lay::kTile;
  float* sp = sv + Lay::kTile;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row0 = blockIdx.x * kBlockM;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t row_step = static_cast<size_t>(H) * D;
  const float* qb = q + static_cast<size_t>(b) * L * row_step +
                    static_cast<size_t>(h) * D;
  const float* kb = k + static_cast<size_t>(b) * S * row_step +
                    static_cast<size_t>(h) * D;
  const float* vb = v + static_cast<size_t>(b) * S * row_step +
                    static_cast<size_t>(h) * D;

  load_tile<D_PAD>(sq, qb, row0, L, row_step, D);

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int key0 = 0; key0 < S; key0 += kBlockN) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<D_PAD>(sk, kb, key0, S, row_step, D);
    load_tile<D_PAD>(sv, vb, key0, S, row_step, D);
    __syncthreads();

    // S = Q K^T for 4 rows x 4 keys; D % 8 == 0
    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += 8) {
#pragma unroll
      for (int dd = 0; dd < 8; ++dd) {
        const int d = d0 + dd;
        float qr[kRows], kc[kKeys];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          qr[i] = sq[(ty * kRows + i) * kStride + d];
#pragma unroll
        for (int j = 0; j < kKeys; ++j) kc[j] = sk[(tx + 16 * j) * kStride + d];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
      }
    }

    // online softmax in the log2 domain; keys past S score -inf
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float x =
            key0 + tx + 16 * j < S ? s[i][j] * scale_log2 : -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // every tile holds a key below S, so m_new is finite
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);  // 0 on the first tile
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        s[i][j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        sp[(ty * kRows + i) * kPStride + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // O += P V over this tile's keys (rows past S carry p = 0 and v = 0)
    const int n_keys = min(kBlockN, S - key0);
    for (int c = 0; c < n_keys; ++c) {
      float pr[kRows], vc[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pr[i] = sp[(ty * kRows + i) * kPStride + c];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) vc[cc] = sv[c * kStride + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          acc[i][cc] = fmaf(pr[i], vc[cc], acc[i][cc]);
    }
  }

  // O / l, rows below L and columns below D only
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = row0 + ty * kRows + i;
    if (r >= L) continue;
    const float inv = 1.f / l[i];
    float* orow = o + (static_cast<size_t>(b) * L + r) * row_step +
                  static_cast<size_t>(h) * D;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) orow[d] = acc[i][cc] * inv;
    }
  }
}

constexpr int kMaxDevices = 64;

template <int D_PAD>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int H, int L, int S, int D, float scale, cudaStream_t stream) {
  using Lay = Layout<D_PAD>;
  auto kernel = attention_f32_kernel<D_PAD>;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  static bool configured[kMaxDevices] = {};
  if (!configured[dev]) {  // more than 48 KB of dynamic shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Lay::kBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  const long n_q = (static_cast<long>(L) + kBlockM - 1) / kBlockM;
  const long n_bh = static_cast<long>(B) * H;
  if (n_q > 0x7fffffff || n_bh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_q), static_cast<unsigned>(n_bh));
  kernel<<<grid, kThreads, Lay::kBytes, stream>>>(q, k, v, o, H, L, S, D,
                                                  scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int L, int S, int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  float* fo = static_cast<float*>(o);
  if (D <= 0 || D % 8 != 0 || S <= 0 || L <= 0 || B <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 64) return launch<64>(fq, fk, fv, fo, B, H, L, S, D, scale, st);
  if (D <= 128) return launch<128>(fq, fk, fv, fo, B, H, L, S, D, scale, st);
  if (D <= 256) return launch<256>(fq, fk, fv, fo, B, H, L, S, D, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Replaces _onepass_kernel on f32 inputs: the UNet's 1024-token sites.
int echoscene_onepass_attention_f32(const void* q, const void* k,
                                    const void* v, void* o, int B, int H,
                                    int L, int S, int D, float scale,
                                    void* stream) {
  return dispatch(q, k, v, o, B, H, L, S, D, scale, stream);
}

// Replaces _stream_kernel on f32 inputs: the VQ-VAE's 4096-token site.
int echoscene_stream_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int L, int S, int D, float scale,
                                   void* stream) {
  return dispatch(q, k, v, o, B, H, L, S, D, scale, stream);
}

}  // extern "C"
