// The earlier design of the nearest-neighbour kernel K4 (direct f32 form on
// the CUDA cores), kept as the baseline that chip_smoke.py and
// kernels/chamfer_variants.py time csrc/chamfer.cu against on the same card
// in the same run.  No path of the port calls it.
//
// One-way squared nearest-neighbour distance, f32:
//   out[b, n] = min_m |a[b, n] - b[b, m]|^2,  a (B, N, 3), b (B, M, 3) f32,
// the function of _nn_kernel in echoscene_tpu/kernels/chamfer_pallas.py.
//
// Design.  The TPU kernel pads xyz to 128 lanes so the distance tile is an
// MXU product (|a|^2 + |b|^2 - 2 a.b).  Here xyz stays in registers: each
// thread owns kQueries queries (their coordinates and running minima in
// registers), and the CTA streams the targets through shared memory in tiles
// of kTile points stored as float4, so every target is one broadcast
// 16-byte shared load, reused by the thread's kQueries queries.  The distance
// is the direct (a - b)^2 form: never negative (JAX's clamp at 0 holds by
// construction) and free of the Gram form's cancellation, which matters for
// the small neighbour distances of surface clouds.  Ragged N and M are bounds
// checks, not padding.  Grid: x over query tiles of kThreads * kQueries, y
// over the batch, z over chunks of the targets; with more than one chunk,
// each CTA folds its partial minima into the output with atomicMin on the int
// bits (order-preserving for non-negative floats) after a fill with +inf, so
// small batches (one consistency pair, B = 1) still fill the SMs.
//
// What bounds it on the H100.  Per (query, target) pair the kernel issues 7
// f32 instructions (3 sub, 1 mul, 2 fma, 1 min) on the CUDA cores, for
// 12 (N + M) + 4 N bytes of input and output per batch entry: far above the
// ridge, so the f32 issue rate (67 TFLOP/s, no tensor cores) bounds it.  The
// shared-memory broadcast costs one load per 4 x 7 instructions.
//
// Built by echoscene_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                  // threads per CTA
constexpr int kQueries = 4;                    // queries per thread
constexpr int kBlockN = kThreads * kQueries;   // queries per CTA
constexpr int kTile = 1024;                    // targets per shared tile
constexpr int kChunkUnit = 256;                // target chunks are multiples

__global__ void fill_inf(float* out, int64_t count) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < count) out[i] = INFINITY;
}

__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ a, const float* __restrict__ b,
          float* __restrict__ out, int N, int M, int chunk, bool atomic) {
  __shared__ float4 tile[kTile];
  const int batch = blockIdx.y;
  const float* ab = a + static_cast<int64_t>(batch) * N * 3;
  const float* bb = b + static_cast<int64_t>(batch) * M * 3;
  float* ob = out + static_cast<int64_t>(batch) * N;

  float ax[kQueries], ay[kQueries], az[kQueries], best[kQueries];
#pragma unroll
  for (int q = 0; q < kQueries; ++q) {
    const int n = blockIdx.x * kBlockN + q * kThreads + threadIdx.x;
    const bool ok = n < N;
    ax[q] = ok ? ab[3 * n] : 0.f;
    ay[q] = ok ? ab[3 * n + 1] : 0.f;
    az[q] = ok ? ab[3 * n + 2] : 0.f;
    best[q] = INFINITY;
  }

  const int m_begin = blockIdx.z * chunk;
  const int m_end = min(M, m_begin + chunk);
  for (int m0 = m_begin; m0 < m_end; m0 += kTile) {
    const int len = min(kTile, m_end - m0);
    __syncthreads();   // the previous tile is consumed
    for (int j = threadIdx.x; j < len; j += kThreads) {
      const float* p = bb + 3 * static_cast<int64_t>(m0 + j);
      tile[j] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < len; ++j) {
      const float4 t = tile[j];
#pragma unroll
      for (int q = 0; q < kQueries; ++q) {
        const float dx = ax[q] - t.x;
        const float dy = ay[q] - t.y;
        const float dz = az[q] - t.z;
        float d = dx * dx;
        d = fmaf(dy, dy, d);
        d = fmaf(dz, dz, d);
        best[q] = fminf(best[q], d);
      }
    }
  }

#pragma unroll
  for (int q = 0; q < kQueries; ++q) {
    const int n = blockIdx.x * kBlockN + q * kThreads + threadIdx.x;
    if (n >= N) continue;
    if (atomic) {
      atomicMin(reinterpret_cast<int*>(ob + n), __float_as_int(best[q]));
    } else {
      ob[n] = best[q];
    }
  }
}

}  // namespace

extern "C" {

// out (B, N) = one-way squared NN distance a -> b.  Requires B, N, M >= 1
// and contiguous f32 (B, N, 3) / (B, M, 3) inputs (checked by the caller).
int echoscene_nn_distance_direct(const void* a, const void* b, void* out, int B,
                          int N, int M, void* stream) {
  if (B < 1 || N < 1 || M < 1 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);

  // split the targets until about four CTAs per SM are in flight
  const int query_tiles = (N + kBlockN - 1) / kBlockN;
  const int64_t base = static_cast<int64_t>(query_tiles) * B;
  const int units = (M + kChunkUnit - 1) / kChunkUnit;
  int64_t want = (4 * static_cast<int64_t>(sms) + base - 1) / base;
  const int splits_wanted = static_cast<int>(want < units ? want : units);
  const int chunk =
      ((units + splits_wanted - 1) / splits_wanted) * kChunkUnit;
  const int splits = (M + chunk - 1) / chunk;
  const bool atomic = splits > 1;
  float* o = static_cast<float*>(out);
  if (atomic) {
    const int64_t count = static_cast<int64_t>(B) * N;
    fill_inf<<<static_cast<unsigned>((count + 255) / 256), 256, 0, st>>>(
        o, count);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(query_tiles, B, splits);
  nn_kernel<<<grid, kThreads, 0, st>>>(static_cast<const float*>(a),
                                       static_cast<const float*>(b), o, N, M,
                                       chunk, atomic);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
