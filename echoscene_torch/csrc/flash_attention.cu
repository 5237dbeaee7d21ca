// Non-causal softmax attention for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the two Pallas TPU kernels of echoscene_tpu/kernels/flash_attention.py:
//   * _onepass_kernel (driven by _onepass_impl): the shape UNet's 1024-token
//     self-attention, 8 heads of dim 56, 5 launches per DDIM step;
//   * _stream_kernel (driven by _stream_impl): the VQ-VAE decoder's 4096-token
//     single-head attention with C = 256, one launch per decode chunk.
// Both compute O = softmax(Q K^T * D^-1/2) V per (batch, head) with f32 scores,
// f32 softmax state and f32 accumulation of P V, dividing by the row sum after
// P V, as the TPU kernels do.
//
// Design.  The TPU split between "all of K/V resident in VMEM" (one-pass) and
// "K/V streamed in blocks" (stream) exists for VMEM capacity.  On Hopper a
// block has at most 227 KB of shared memory, so both entry points run the same
// streaming loop: one CTA of 4 warps per (batch*head, 64-row query tile); each
// warp owns 16 query rows.  K and V tiles stream through a two-stage
// shared-memory ring filled by cp.async, so the copy of tile j+1 overlaps the
// math on tile j.  Fragments come from shared memory by ldmatrix (V through
// ldmatrix.trans, so V needs no transposed copy); S = Q K^T and O += P V run
// on the tensor cores with bf16 mma.sync.m16n8k16 and f32 accumulation; the
// running max / denominator recurrence lives in f32 registers, and the S
// fragments are re-packed in registers as the A operand of P V.  D is
// zero-padded to 32 / 64 / 128 / 256 in shared memory only; key columns past
// S are masked to -inf.
//
// What bounds it on the H100.  Per (batch, head) the function needs 4 L S D
// flops for 2 (2 L + 2 S) D bytes of q, k, v and o: 512 flop/byte at the
// UNet site (L = S = 1024, D = 56) and 2048 at the VQ-VAE site (L = S = 4096,
// D = 256), above the card's ~295 flop/byte bf16 ridge, so the tensor-core
// rate (989 TFLOP/s bf16 dense) bounds both.  mma.sync reaches only part of
// that rate (wgmma is the full-rate path), and the padded head dim (56 -> 64)
// and the exp of every score add work the bound does not count; wgmma + TMA
// are later work.
//
// Built by echoscene_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;          // query rows per CTA
constexpr int kWarps = 4;            // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;              // bf16 elements of row padding in smem

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows [row0, row0 + ROWS) of one head into smem as [ROWS][ld],
// zero-filling rows >= n_rows and columns >= D.  Row r of the head starts at
// base + r * row_stride (elements).  With D % 8 == 0 (every call site) the
// copy is asynchronous (cp.async, 16 bytes per thread); otherwise it is a
// plain element-wise copy, complete when the caller's barrier passes.
template <int D_PAD, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* base,
                                          long row_stride, int row0,
                                          int n_rows, int D) {
  constexpr int kChunks = D_PAD / 8;  // 8 bf16 = 16 bytes per chunk
  const bool vec = (D % 8) == 0;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const int gr = row0 + r;
    __nv_bfloat16* d = dst + r * ld + c;
    if (vec) {
      const bool ok = gr < n_rows && c < D;
      cp_async16(d, ok ? base + gr * row_stride + c : base, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        d[e] = (gr < n_rows && c + e < D) ? base[gr * row_stride + c + e]
                                          : __float2bfloat16(0.0f);
      }
    }
  }
}

// q, k, v, o: contiguous (B, L|S, H, D) bf16.  grid = (ceil(L / 64), B * H).
template <int D_PAD, int BLOCK_K>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int H, int L, int S, int D,
                 float scale_log2) {
  constexpr int LD = D_PAD + kPad;    // row stride of every smem tile
  constexpr int N_S = BLOCK_K / 8;    // n-tiles of the score block
  constexpr int N_O = D_PAD / 8;      // n-tiles of the output block
  constexpr int K_QK = D_PAD / 16;    // k-steps of Q K^T
  constexpr int K_PV = BLOCK_K / 16;  // k-steps of P V
  // Q fragments stay in registers when they fit beside the accumulators
  constexpr bool Q_IN_REGS = D_PAD <= 128;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* KV = Qs + kBlockQ * LD;  // 2 stages of [K tile | V tile]
  constexpr int kTile = BLOCK_K * LD;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kBlockQ;
  const long row_stride = static_cast<long>(H) * D;
  const __nv_bfloat16* qb = q + static_cast<long>(b) * L * row_stride + h * D;
  const __nv_bfloat16* kb = k + static_cast<long>(b) * S * row_stride + h * D;
  const __nv_bfloat16* vb = v + static_cast<long>(b) * S * row_stride + h * D;
  __nv_bfloat16* ob = o + static_cast<long>(b) * L * row_stride + h * D;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row group
  const int t4 = lane % 4;  // thread in group
  // ldmatrix row / column offsets of this lane (see the fragment maps of
  // mma.m16n8k16: A as 4 8x8 matrices row-block-major, B as n-tile pairs)
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;

  const int n_tiles = (S + BLOCK_K - 1) / BLOCK_K;
  load_tile<D_PAD, kBlockQ>(Qs, LD, qb, row_stride, q0, L, D);
  load_tile<D_PAD, BLOCK_K>(KV, LD, kb, row_stride, 0, S, D);
  load_tile<D_PAD, BLOCK_K>(KV + kTile, LD, vb, row_stride, 0, S, D);
  cp_async_commit();

  float acc[N_O][4];
#pragma unroll
  for (int i = 0; i < N_O; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_run[2] = {0.0f, 0.0f};            // this thread's partial row sums
  uint32_t qf[Q_IN_REGS ? K_QK : 1][4];

  const __nv_bfloat16* q_warp = Qs + warp * 16 * LD;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {  // prefetch tile j + 1 into the other stage
      __nv_bfloat16* nxt = KV + ((j + 1) & 1) * 2 * kTile;
      load_tile<D_PAD, BLOCK_K>(nxt, LD, kb, row_stride, (j + 1) * BLOCK_K, S, D);
      load_tile<D_PAD, BLOCK_K>(nxt + kTile, LD, vb, row_stride,
                                (j + 1) * BLOCK_K, S, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Ks = KV + (j & 1) * 2 * kTile;
    const __nv_bfloat16* Vs = Ks + kTile;
    const int k0 = j * BLOCK_K;

    if constexpr (Q_IN_REGS) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < K_QK; ++kk)
          ldmatrix_x4(qf[kk], q_warp + a_row * LD + kk * 16 + a_col);
      }
    }

    // S = Q K^T for this warp's 16 rows x BLOCK_K keys
    float s[N_S][4];
#pragma unroll
    for (int n = 0; n < N_S; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < K_QK; ++kk) {
      uint32_t a[4];
      if constexpr (Q_IN_REGS) {
        a[0] = qf[kk][0];
        a[1] = qf[kk][1];
        a[2] = qf[kk][2];
        a[3] = qf[kk][3];
      } else {
        ldmatrix_x4(a, q_warp + a_row * LD + kk * 16 + a_col);
      }
#pragma unroll
      for (int n = 0; n < N_S; n += 2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, Ks + (n * 8 + b_row) * LD + kk * 16 + b_col);
        mma_16816(s[n], a, bf[0], bf[1]);
        mma_16816(s[n + 1], a, bf[2], bf[3]);
      }
    }

    // online softmax in the log2 domain; columns >= S are masked to -inf
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < N_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + t4 * 2 + (e & 1);
        const float x = col < S ? s[n][e] * scale_log2 : -INFINITY;
        s[n][e] = x;
        m_new[e >> 1] = fmaxf(m_new[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffff, m_new[r], 1));
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffff, m_new[r], 2));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = exp2f(m_run[r] - m_new[r]);  // exp2(-inf) = 0 on the first tile
      m_run[r] = m_new[r];
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < N_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m_new[e >> 1]);
        s[n][e] = p;
        l_run[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < N_O; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // O += P V, P re-packed from the score fragments as the A operand
#pragma unroll
    for (int kc = 0; kc < K_PV; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16x2(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int n = 0; n < N_O; n += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, Vs + (kc * 16 + a_row) * LD + n * 8 + a_col);
        mma_16816(acc[n], a, bf[0], bf[1]);
        mma_16816(acc[n + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage is refilled two iterations on
  }

  // full row sums across the 4 threads of each row group, then O / l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffff, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffff, l_run[r], 2);
    l_run[r] = 1.0f / fmaxf(l_run[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= L) continue;
    __nv_bfloat16* orow = ob + row * row_stride;
#pragma unroll
    for (int n = 0; n < N_O; ++n) {
      const int col = n * 8 + t4 * 2;
      const float x0 = acc[n][2 * r] * l_run[r];
      const float x1 = acc[n][2 * r + 1] * l_run[r];
      if (col + 1 < D && D % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < D) orow[col] = __float2bfloat16(x0);
        if (col + 1 < D) orow[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int D_PAD, int BLOCK_K>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int L, int S, int D, float scale, cudaStream_t stream) {
  constexpr int LD = D_PAD + kPad;
  constexpr size_t smem =
      sizeof(__nv_bfloat16) * static_cast<size_t>(kBlockQ + 4 * BLOCK_K) * LD;
  auto kernel = attention_kernel<D_PAD, BLOCK_K>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kBlockQ - 1) / kBlockQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, L,
      S, D, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// Head dims up to 256, padded to the next of 32 / 64 / 128 / 256.  The key
// tile shrinks at D_pad = 256 so the f32 output fragments (128 per thread)
// and the score fragments fit the register file.
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int H,
             int L, int S, int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch<32, 64>(q, k, v, o, B, H, L, S, D, scale, st);
  if (D <= 64) return launch<64, 64>(q, k, v, o, B, H, L, S, D, scale, st);
  if (D <= 128) return launch<128, 64>(q, k, v, o, B, H, L, S, D, scale, st);
  if (D <= 256) return launch<256, 32>(q, k, v, o, B, H, L, S, D, scale, st);
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
