// bf16 tensor-core GEMM template with a LayerNorm prologue and bias,
// GEGLU and residual epilogues: the matrix products of the TPU kernels
// latentsync_tpu/ops/ffn.py _geglu_kernel and latentsync_tpu/ops/attn_block.py
// _kernel (its q/k/v and output projections).
//
//   C[m, n] = epi( sum_k A'[m, k] * B[n, k] )
//   A'      = A, or bf16(LN(A) [+ pe[m % pe_rows]]) with per-row stats
//   epi     = + bias[n]                         (bias may be null)
//           | (acc + bias) * gelu(acc2 + bias2) (dual: B2 is the gate half)
//           then + residual[m, n]               (residual may be null)
//   AQ      : A arrives as int8 codes with one f32 scale a row and is
//             dequantized to bf16(code * scale) while it is staged (K10)
//   F32OUT  : C is written as f32, unrounded (K10's down-projection, whose
//             rows are quantized by a later pass)
//
// B is a torch nn.Linear weight, (N, K) row-major, i.e. the column-major
// (K, N) operand, so weights are used as stored.
//
// Design: one 128x64 output tile per block, 8 warps each owning a 32x32
// sub-tile as 2x2 WMMA 16x16x16 bf16 fragments with f32 accumulation; the
// K loop stages a 128x32 A tile and one (or two, dual) 64x32 B tiles in
// shared memory with 16-byte loads. The prologue normalises A while it is
// staged, so LN(x) never reaches device memory. Accumulators start from
// the bias (a broadcast tile), so the GEGLU gate is applied fragment-wise
// and only one f32 tile is staged for the coalesced bf16 store.
//
// What bounds it on the card: at the UNet's shapes (K = 320..5120) these
// products are compute bound; this first version uses mma.sync through
// WMMA without a cp.async/TMA pipeline, so it reaches a fraction of the
// 989 TFLOP/s bf16 peak (wgmma + TMA are left to a later change).
#pragma once

#include <mma.h>

#include "common.cuh"

namespace ls_gemm {

using namespace nvcuda;

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int LDT = BK + 8;  // bf16 tile row pitch (80 bytes)
constexpr int LDC = BN + 4;  // f32 staging row pitch (272 bytes)
constexpr int THREADS = 256;

struct Args {
  const bf16* a;
  int lda;
  const bf16* b;
  const bf16* b2;  // dual (GEGLU gate) weight, or null
  int ldb;
  bf16* c;
  int ldc;
  int m, n, k;
  const float* bias;
  const float* bias2;
  const float2* stats;  // per-row (mean, rstd) when the LN prologue is on
  const float* ln_w;
  const float* ln_b;
  const bf16* pe;  // (pe_rows, k) added after the LN, or null
  int pe_rows;
  const bf16* res;  // residual (m, n) with row pitch ldr, or null
  int ldr;
  const int8_t* a_q;     // AQ: int8 A (m, k) with row pitch lda, instead of a
  const float* a_scale;  // AQ: one dequantization scale a row
  float* c_f32;          // F32OUT: f32 C with row pitch ldc, instead of c
};

static __device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.0f + erff(g * 0.70710678118654752f));
}

template <bool LN, bool DUAL, bool AQ = false, bool F32OUT = false>
__global__ void __launch_bounds__(THREADS) gemm_kernel(const Args p) {
  constexpr int NB = DUAL ? 2 : 1;
  constexpr int TILE_BYTES = (BM * LDT + NB * BN * LDT) * (int)sizeof(bf16);
  constexpr int STAGE_BYTES = BM * LDC * (int)sizeof(float);
  constexpr int SMEM = TILE_BYTES > STAGE_BYTES ? TILE_BYTES : STAGE_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  __shared__ __align__(128) float sbias[NB][16 * LDC];
  __shared__ float2 sstats[LN ? BM : 1];

  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = as + BM * LDT;  // NB tiles of BN x LDT
  float* stage = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // 0..3: 32-row slab
  const int wn = warp & 1;   // 0..1: 32-col slab
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  if (LN) {
    for (int r = tid; r < BM; r += THREADS) {
      const int gr = m0 + r;
      sstats[r] = gr < p.m ? p.stats[gr] : make_float2(0.f, 1.f);
    }
  }
  for (int i = tid; i < 16 * BN; i += THREADS) {
    const int c = i % BN;
    const int gc = n0 + c;
    const int r = i / BN;
    sbias[0][r * LDC + c] = (p.bias != nullptr && gc < p.n) ? p.bias[gc] : 0.f;
    if (DUAL) sbias[NB - 1][r * LDC + c] = (p.bias2 != nullptr && gc < p.n) ? p.bias2[gc] : 0.f;
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NB][2][2];
#pragma unroll
  for (int t = 0; t < NB; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(acc[t][i][j], &sbias[t][wn * 32 + j * 16], LDC,
                               wmma::mem_row_major);

  for (int k0 = 0; k0 < p.k; k0 += BK) {
    // A tile: 128 rows x 4 vectors of 8 bf16.
#pragma unroll
    for (int rep = 0; rep < (BM * BK / 8) / THREADS; ++rep) {
      const int idx = tid + rep * THREADS;
      const int r = idx >> 2;
      const int cv = (idx & 3) * 8;
      const int gr = m0 + r;
      const int gk = k0 + cv;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (AQ) {
        if (gr < p.m && gk < p.k) {
          const uint2 qv = *reinterpret_cast<const uint2*>(p.a_q + (size_t)gr * p.lda + gk);
          const signed char* qb = reinterpret_cast<const signed char*>(&qv);
          const float sc = p.a_scale[gr];
          bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
          for (int t = 0; t < 8; ++t) e[t] = __float2bfloat16((float)qb[t] * sc);
        }
      } else if (gr < p.m && gk < p.k) {
        v = *reinterpret_cast<const uint4*>(p.a + (size_t)gr * p.lda + gk);
        if (LN) {
          const float2 st = sstats[r];
          bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const float xn = (__bfloat162float(e[t]) - st.x) * st.y;
            bf16 h = __float2bfloat16(xn * p.ln_w[gk + t] + p.ln_b[gk + t]);
            if (p.pe != nullptr) {
              const float pv = __bfloat162float(p.pe[(size_t)(gr % p.pe_rows) * p.k + gk + t]);
              h = __float2bfloat16(__bfloat162float(h) + pv);
            }
            e[t] = h;
          }
        }
      }
      *reinterpret_cast<uint4*>(as + r * LDT + cv) = v;
    }
    // B tile(s): 64 rows (output features) x 4 vectors.
#pragma unroll
    for (int t = 0; t < NB; ++t) {
      const bf16* src = t == 0 ? p.b : p.b2;
      const int r = tid >> 2;
      const int cv = (tid & 3) * 8;
      const int gn = n0 + r;
      const int gk = k0 + cv;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gn < p.n && gk < p.k) v = *reinterpret_cast<const uint4*>(src + (size_t)gn * p.ldb + gk);
      *reinterpret_cast<uint4*>(bs + t * BN * LDT + r * LDT + cv) = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * LDT + kk, LDT);
#pragma unroll
      for (int t = 0; t < NB; ++t) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, bs + t * BN * LDT + (wn * 32 + j * 16) * LDT + kk, LDT);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[t][i][j], fa[i], fb, acc[t][i][j]);
        }
      }
    }
    __syncthreads();
  }

  if (DUAL) {
    // value and gate fragments share one element layout
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < acc[0][i][j].num_elements; ++e)
          acc[0][i][j].x[e] = acc[0][i][j].x[e] * gelu_erf(acc[NB - 1][i][j].x[e]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(stage + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[0][i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();

  // coalesced bf16x2 store, residual added in f32
  for (int idx = tid; idx < BM * BN / 2; idx += THREADS) {
    const int r = idx / (BN / 2);
    const int c = (idx % (BN / 2)) * 2;
    const int gr = m0 + r;
    const int gc = n0 + c;
    if (gr >= p.m || gc >= p.n) continue;
    float v0 = stage[r * LDC + c];
    float v1 = stage[r * LDC + c + 1];
    if (p.res != nullptr) {
      const float2 rv = __bfloat1622float2(
          *reinterpret_cast<const bf162*>(p.res + (size_t)gr * p.ldr + gc));
      v0 += rv.x;
      v1 += rv.y;
    }
    if (F32OUT)
      *reinterpret_cast<float2*>(p.c_f32 + (size_t)gr * p.ldc + gc) = make_float2(v0, v1);
    else
      *reinterpret_cast<bf162*>(p.c + (size_t)gr * p.ldc + gc) = __floats2bfloat162_rn(v0, v1);
  }
}

// Per-row LayerNorm statistics (mean, 1/sqrt(var + eps)), two-pass like
// the reference: one warp per row, f32 sums.
static __global__ void row_stats_kernel(const bf16* __restrict__ x, int m, int k, int ldx, float eps,
                                 float2* __restrict__ stats) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= m) return;
  const bf16* xr = x + (size_t)row * ldx;
  float s = 0.f;
  for (int c = lane; c < k; c += 32) s += __bfloat162float(xr[c]);
  const float mu = ls_warp_sum(s) / k;
  float v = 0.f;
  for (int c = lane; c < k; c += 32) {
    const float d = __bfloat162float(xr[c]) - mu;
    v += d * d;
  }
  const float var = ls_warp_sum(v) / k;
  if (lane == 0) stats[row] = make_float2(mu, rsqrtf(var + eps));
}

static inline cudaError_t row_stats(const bf16* x, int m, int k, int ldx, float eps, float2* stats,
                                    cudaStream_t s) {
  const int rows_per_block = 8;
  row_stats_kernel<<<(m + rows_per_block - 1) / rows_per_block, 32 * rows_per_block, 0, s>>>(
      x, m, k, ldx, eps, stats);
  return cudaGetLastError();
}

static inline cudaError_t gemm(const Args& p, cudaStream_t s) {
  const dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM);
  const bool ln = p.stats != nullptr;
  const bool dual = p.b2 != nullptr;
  if (ln && dual) gemm_kernel<true, true><<<grid, THREADS, 0, s>>>(p);
  else if (ln) gemm_kernel<true, false><<<grid, THREADS, 0, s>>>(p);
  else if (dual) gemm_kernel<false, true><<<grid, THREADS, 0, s>>>(p);
  else gemm_kernel<false, false><<<grid, THREADS, 0, s>>>(p);
  return cudaGetLastError();
}

// The GEGLU up-projection on an int8 A with row scales (p.a_q, p.a_scale,
// p.b2 set), and a plain projection with bias that leaves its result in f32
// (p.c_f32 set).
static inline cudaError_t gemm_dequant_geglu(const Args& p, cudaStream_t s) {
  const dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM);
  gemm_kernel<false, true, true, false><<<grid, THREADS, 0, s>>>(p);
  return cudaGetLastError();
}

static inline cudaError_t gemm_f32out(const Args& p, cudaStream_t s) {
  const dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM);
  gemm_kernel<false, false, false, true><<<grid, THREADS, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace ls_gemm
