// One-way squared nearest-neighbour distance for Hopper (sm_90a): the Gram
// form in f64 on the tensor cores.
//
// Replaces the Pallas TPU kernel _nn_kernel of
// echoscene_tpu/kernels/chamfer_pallas.py (driven by nn_distance_oneway):
//   out[b, n] = min_m |a[b, n] - b[b, m]|^2,  a (B, N, 3), b (B, M, 3) f32,
// the building block of the chamfer metric (chamfer = mean of a->b plus mean
// of b->a).  Called twice per chamfer by echoscene_torch/kernels/chamfer.py.
//
// Design.  Both clouds are moved to a centre c (the mean of 32 targets
// spread over the batch entry, rounded to f32; every warp computes the same
// one), so a - c and b - c are exact in f64 and their norms stay at the
// clouds' own extent.  Each query is packed as (a - c, 1) in registers and
// each target as 2^-600 (-2 (b - c), |b - c|^2) in shared memory, all f64;
// then one f64 mma of depth k = 4 with each row's 2^-600 |a - c|^2 as the C
// operand
//   D[n, m] = 2^-600 (|a_n - c|^2 + |b_m - c|^2 - 2 (a_n - c).(b_m - c))
// gives the squared distances of a 16 x 8 tile of pairs (mma.m16n8k4.f64,
// sm_90): depth 4 is the whole dot product.  The min is taken on integer
// keys, because an f64 min compiles to DSETP + two selects on this card
// (no DMNMX): the 2^-600 keeps every distance below 2^89 at an f64
// exponent under 512, so one funnel shift (key_of) makes a 32-bit key that
// orders like the distance, and one three-way unsigned min (a DPX
// instruction) folds two keys into a row's running minimum.  At the end the
// minima are reduced over the 4 lanes of a quad, and the key minus a
// constant is the distance's f32 bits, truncated (0 below the smallest
// normal f32).  Each warp holds kBlocks 16-row query blocks in registers
// (128 queries), so one conflict-free 8-byte shared load of a B fragment
// feeds kBlocks mma.  The CTA packs its targets into shared memory while
// loading (32 bytes a target, target-major, so lane l's B fragment is word
// l of an 8-target group) in tiles of kTile, one tile between two barriers
// (a double-buffered tile gained nothing measurable: PERF.md, the design
// runs).  Query rows past N are (0, 0, 0, 1) and not stored; target
// columns past M are (0, 0, 0, 2^88) scaled, a finite sentinel that never
// wins (no 0 * inf).
//
// Grid.  The work is B * ceil(N / kBlockN) rows (a batch entry's query
// tile) of ceil(M / kChunkUnit) units of targets; one wave of CTAs (as many
// as fit on the card, chamfer.launch_plan) takes equal shares of the units
// in order, so a CTA may end one row and start the next, and no CTA waits
// on a last partial wave.  A row shared by CTAs is folded into the output
// with atomicMin on the f32 bits (order-preserving for non-negative floats)
// after a fill with +inf; truncating to f32 is monotone, so it commutes
// with the min.
//
// Why f64 is exact enough.  Every f32 input is exact in f64, a - c is exact,
// and a product of two such values carries at most 48 significant bits, so
// D carries an error of a few units of 2^-53 (|a - c|^2 + |b - c|^2): the
// f32 Gram form's cancellation (~1e-8 absolute on unit-scale clouds, orders
// more far from the origin) is gone, and the f32 result is within 1 ulp of
// the exact squared distance wherever that distance is above the f64 floor
// (chamfer.ulp_floor).  A negative rounding remainder of a distance near 0
// counts by its magnitude, which is below that floor.
//
// What bounds it on the H100.  8 flops a pair on the f64 tensor cores
// (67 TFLOP/s, the same rate as f32 on the CUDA cores): at (16, 5000, 5000)
// 0.0478 ms.  Beside them each pair costs 1.5 integer instructions (a
// funnel shift, half a three-way min) on the ALU pipe, which limits the
// kernel first (PERF.md, the design runs).  Bytes are 12 (N + M) + 4 N a
// batch entry, far below either.
//
// Built by echoscene_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMmaM = 16;                      // rows of one mma.m16n8k4
constexpr int kBlocks = 8;                     // query blocks per warp
constexpr int kWarps = 4;                      // warps per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kMmaM / 8;               // query rows per lane and block
constexpr int kAcc = 2 * kRows;                // accumulator values per lane
constexpr int kBlockN = kWarps * kBlocks * kMmaM;   // queries per CTA
constexpr int kTile = 256;                     // targets per shared tile
constexpr int kChunkUnit = 64;                 // targets per unit of work
constexpr int kPerThread = kTile / kThreads;   // targets each thread packs
// every distance enters the min scaled by 2^-600: for d in [0, 2^89) the f64
// exponent of the scaled value stays below 512, so its bits from the 9 low
// exponent bits down to the 23rd mantissa bit are an unsigned key that
// orders like d (see key_of)
constexpr double kScale = 0x1p-600;
constexpr double kFar = 0x1p88;                // |b'|^2 of padding columns
constexpr unsigned kNone = 0xffffffffu;        // key above every distance
// f32 bits of d = key - this, for d >= 2^-126 (f64 bias 1023 - 600 - 127)
constexpr unsigned kF32Bias = 296u << 23;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTile % kThreads == 0 && kTile % 8 == 0, "tile shape");

// d (kAcc) = A (16 x 4, this lane's rows of component t) x B (4 x 8, this
// lane's component t of target g) + C (each row's scaled |a - c|^2).
// Fragments (PTX ISA, mma.m16n8k4 with .f64), g = lane / 4, t = lane % 4:
//   A: a[r] = A[g + 8 r][t];  B: b = B[t][g];
//   C, D: d[2 r + i] = D[g + 8 r][2 t + i].
__device__ __forceinline__ void mma_tile(double (&d)[kAcc],
                                         const double (&a)[kRows],
                                         const double (&c)[kRows], double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %8, %8};\n"
      : "=d"(d[0]), "=d"(d[1]), "=d"(d[2]), "=d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b), "d"(c[0]), "d"(c[1]));
}

// The order key of a scaled distance v = d 2^-600: bits 28..0 of its high
// word and the top 3 of its low word (one funnel shift), i.e. the 9 low
// exponent bits and 23 mantissa bits.  The 3 bits shifted out are the sign
// and the 2 top exponent bits, which are 0 for d in [0, 2^89): the key is
// then monotone in d, truncating d to f32 precision.  A negative rounding
// remainder of a distance near 0 loses its sign and counts by its magnitude
// (far below the f64 floor).
__device__ __forceinline__ unsigned key_of(double v) {
  return __funnelshift_l(static_cast<unsigned>(__double2loint(v)),
                         static_cast<unsigned>(__double2hiint(v)), 3);
}

// fold two keys into a running minimum: one three-way unsigned min (a DPX
// instruction on sm_90)
#define FOLD(best, d0, d1) best = __vimin3_u32(best, key_of(d0), key_of(d1))

__global__ void fill_inf(float* out, int64_t count) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < count) out[i] = INFINITY;
}

// Pack targets [m0, m0 + kTile) as 2^-600 (-2 (b - c), |b - c|^2),
// target-major, 32 bytes a target; targets at or past m_end become the
// sentinel 2^-600 (0, 0, 0, kFar).
__device__ __forceinline__ void pack_tile(double* tile, const float* bb,
                                          int m0, int m_end, double cx,
                                          double cy, double cz) {
  float x[kPerThread], y[kPerThread], z[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int m = m0 + i * kThreads + threadIdx.x;
    const float* p = bb + 3 * static_cast<int64_t>(m < m_end ? m : m0);
    x[i] = p[0];
    y[i] = p[1];
    z[i] = p[2];
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int j = i * kThreads + threadIdx.x;
    double2 lo = make_double2(0.0, 0.0), hi = make_double2(0.0, kScale * kFar);
    if (m0 + j < m_end) {
      const double dx = static_cast<double>(x[i]) - cx;
      const double dy = static_cast<double>(y[i]) - cy;
      const double dz = static_cast<double>(z[i]) - cz;
      lo = make_double2(-2.0 * kScale * dx, -2.0 * kScale * dy);
      hi = make_double2(-2.0 * kScale * dz,
                        kScale * fma(dz, dz, fma(dy, dy, dx * dx)));
    }
    double2* dst = reinterpret_cast<double2*>(tile + 4 * j);
    dst[0] = lo;
    dst[1] = hi;
  }
}

__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ a, const float* __restrict__ b,
          float* __restrict__ out, int B, int N, int M, int query_tiles,
          int units_row, bool atomic) {
  __shared__ __align__(16) double tile[kTile * 4];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  // this CTA's share of the work: units [u, u_end) of the rows (batch entry,
  // query tile), each row units_row chunk units of targets long
  const int64_t total = static_cast<int64_t>(query_tiles) * B * units_row;
  int64_t u = static_cast<int64_t>(blockIdx.x) * total / gridDim.x;
  const int64_t u_end = (static_cast<int64_t>(blockIdx.x) + 1) * total /
                        gridDim.x;
  int centre_of = -1;
  double cx = 0.0, cy = 0.0, cz = 0.0;
  while (u < u_end) {
    const int64_t row = u / units_row;
    const int u0 = static_cast<int>(u - row * units_row);
    const int u1 = static_cast<int>(
        u_end - row * units_row < units_row ? u_end - row * units_row
                                            : units_row);
    u = row * units_row + u1;
    const int batch = static_cast<int>(row / query_tiles);
    const int qtile = static_cast<int>(row % query_tiles);
    const int m_begin = u0 * kChunkUnit;
    const int m_end = min(M, u1 * kChunkUnit);
    if (m_begin >= m_end) continue;   // padding units of a row
    const float* ab = a + static_cast<int64_t>(batch) * N * 3;
    const float* bb = b + static_cast<int64_t>(batch) * M * 3;
    float* ob = out + static_cast<int64_t>(batch) * N;

    // the centre: mean of 32 targets spread over the entry, rounded to f32
    if (batch != centre_of) {
      centre_of = batch;
      const float* p = bb + 3 * (static_cast<int64_t>(lane) * M / 32);
      double sx = p[0], sy = p[1], sz = p[2];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sx += __shfl_xor_sync(kFull, sx, o);
        sy += __shfl_xor_sync(kFull, sy, o);
        sz += __shfl_xor_sync(kFull, sz, o);
      }
      // lanes may round their sums in different orders: take lane 0's,
      // which every warp computes in the same order from the same inputs
      cx = static_cast<double>(static_cast<float>(__shfl_sync(kFull, sx, 0) / 32));
      cy = static_cast<double>(static_cast<float>(__shfl_sync(kFull, sy, 0) / 32));
      cz = static_cast<double>(static_cast<float>(__shfl_sync(kFull, sz, 0) / 32));
    }
    const double ct = t == 0 ? cx : (t == 1 ? cy : cz);

    // this lane's A fragments: component t of rows g + 8 r of each block,
    // and each row's scaled |a - c|^2 (summed over the quad), the C fragment
    double qa[kBlocks][kRows], qc[kBlocks][kRows];
    unsigned best[kBlocks][kRows];
    const int warp_n0 = qtile * kBlockN + warp * kBlocks * kMmaM;
#pragma unroll
    for (int q = 0; q < kBlocks; ++q) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int n = warp_n0 + q * kMmaM + g + 8 * r;
        double v = 0.0;
        if (n < N && t < 3) v = static_cast<double>(ab[3 * n + t]) - ct;
        double sq = v * v;
        sq += __shfl_xor_sync(kFull, sq, 1);
        sq += __shfl_xor_sync(kFull, sq, 2);
        qa[q][r] = t == 3 ? 1.0 : v;
        qc[q][r] = kScale * sq;
        best[q][r] = kNone;
      }
    }

    for (int m0 = m_begin; m0 < m_end; m0 += kTile) {
      const int len = min(kTile, m_end - m0);
      pack_tile(tile, bb, m0, m_end, cx, cy, cz);
      __syncthreads();
      const int groups = (len + 7) >> 3;
#pragma unroll 2
      for (int gi = 0; gi < groups; ++gi) {
        const double bf = tile[gi * 32 + lane];   // component t of target g
#pragma unroll
        for (int q = 0; q < kBlocks; ++q) {
          double d[kAcc];
          mma_tile(d, qa[q], qc[q], bf);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            FOLD(best[q][r], d[2 * r], d[2 * r + 1]);
          }
        }
      }
      __syncthreads();   // this tile is consumed
    }

    // min over the quad; lane t == r stores row g + 8 r, as f32 (0 below
    // the smallest normal f32)
#pragma unroll
    for (int q = 0; q < kBlocks; ++q) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        unsigned k = best[q][r];
        k = min(k, __shfl_xor_sync(kFull, k, 1));
        k = min(k, __shfl_xor_sync(kFull, k, 2));
        const int n = warp_n0 + q * kMmaM + g + 8 * r;
        if (t != r || n >= N) continue;
        const float d = k >= kF32Bias + (1u << 23)
                            ? __uint_as_float(k - kF32Bias) : 0.0f;
        if (atomic) {
          atomicMin(reinterpret_cast<int*>(ob + n), __float_as_int(d));
        } else {
          ob[n] = d;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Queries per query tile and targets per chunk unit (chamfer.launch_plan).
int echoscene_nn_distance_block_n() { return kBlockN; }
int echoscene_nn_distance_chunk_unit() { return kChunkUnit; }

// CTAs of the kernel that fit on one SM at once (0 if the query fails).
int echoscene_nn_distance_ctas_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, nn_kernel, kThreads,
                                                    0) != cudaSuccess) {
    return 0;
  }
  return n;
}

// Replaces _nn_kernel: out (B, N) = one-way squared NN distance a -> b.
// Requires B, N, M >= 1 and contiguous f32 (B, N, 3) / (B, M, 3) inputs
// (checked by the Python wrapper) and the launch plan of
// chamfer.launch_plan: query_tiles = ceil(N / kBlockN), units_row >=
// ceil(M / kChunkUnit), ctas CTAs, each over an equal share of the
// query_tiles * B * units_row units, and atomic unless every share starts
// at a row's start; any other plan is rejected.
int echoscene_nn_distance(const void* a, const void* b, void* out, int B,
                          int N, int M, int query_tiles, int units_row,
                          int ctas, int atomic, void* stream) {
  const int64_t rows = static_cast<int64_t>(query_tiles) * B;
  if (B < 1 || N < 1 || M < 1 || B > 65535 || ctas < 1 ||
      query_tiles != (N + kBlockN - 1) / kBlockN ||
      static_cast<int64_t>(units_row) * kChunkUnit < M ||
      ctas > rows * units_row) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // without the atomic each row must lie in one CTA's share: a share that
  // starts inside a row would store its partial minimum over the others'
  const int64_t total = rows * units_row;
  for (int c = 1; c < ctas && !atomic; ++c) {
    if (c * total / ctas % units_row != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (atomic) {
    const int64_t count = static_cast<int64_t>(B) * N;
    fill_inf<<<static_cast<unsigned>((count + 255) / 256), 256, 0, st>>>(
        o, count);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nn_kernel<<<ctas, kThreads, 0, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), o, B, N, M,
      query_tiles, units_row, atomic != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
