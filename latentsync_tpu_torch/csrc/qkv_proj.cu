// K9: the fused q/k/v projection
//   q, k, v = x Wq^T, x Wk^T, x Wv^T     (no bias, f32 accumulation, bf16 out)
// with x (M, C) and the three weights (inner, C) in the nn.Linear layout.
// Replaces the TPU kernel latentsync_tpu/ops/ffn.py _qkv_kernel (:269,
// pallas_call at :286): one read of x, three separate (M, inner) outputs
// (no (C, 3 inner) weight relayout, no split of a fused output).
//
// Design: gemm.cuh's tile loop with three B operands. One launch; a block
// owns a 128-row x 64-column tile of all three outputs, stages each
// 128 x 32 A tile of x once per k-step and multiplies it into three
// accumulator sets (3 x 2 x 2 WMMA 16x16x16 fragments a warp), so x is read
// from device memory once per column block instead of three times. The
// three results leave through one f32 staging tile, one after the other.
// Rows past M and columns past inner are masked; C and inner must be
// multiples of 8 (16-byte loads, paired stores).
//
// Bound: operations, 6 M C inner FLOP on the tensor cores, against
// M (C + 3 inner) bf16 values moved: at C = inner = 320 about 240 FLOP per
// byte, near the card's balance point. Like the template it uses mma.sync
// through WMMA with synchronous staging.
#include "gemm.cuh"

namespace {

using namespace nvcuda;
using ls_gemm::BK;
using ls_gemm::BM;
using ls_gemm::BN;
using ls_gemm::LDC;
using ls_gemm::LDT;
using ls_gemm::THREADS;

__global__ void __launch_bounds__(THREADS)
    qkv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wq, const bf16* __restrict__ wk,
               const bf16* __restrict__ wv, bf16* __restrict__ q, bf16* __restrict__ k,
               bf16* __restrict__ v, int m, int c, int inner) {
  constexpr int TILE_BYTES = (BM * LDT + 3 * BN * LDT) * (int)sizeof(bf16);
  constexpr int STAGE_BYTES = BM * LDC * (int)sizeof(float);
  constexpr int SMEM = TILE_BYTES > STAGE_BYTES ? TILE_BYTES : STAGE_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = as + BM * LDT;  // three tiles of BN x LDT
  float* stage = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // 0..3: 32-row slab
  const int wn = warp & 1;   // 0..1: 32-col slab
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const bf16* ws[3] = {wq, wk, wv};
  bf16* outs[3] = {q, k, v};

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[3][2][2];
#pragma unroll
  for (int w = 0; w < 3; ++w)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[w][i][j], 0.f);

  for (int k0 = 0; k0 < c; k0 += BK) {
    // A tile: 128 rows x 4 vectors of 8 bf16, staged once for all three products
#pragma unroll
    for (int rep = 0; rep < (BM * BK / 8) / THREADS; ++rep) {
      const int idx = tid + rep * THREADS;
      const int r = idx >> 2;
      const int cv = (idx & 3) * 8;
      const int gr = m0 + r;
      const int gk = k0 + cv;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gr < m && gk < c) val = *reinterpret_cast<const uint4*>(x + (size_t)gr * c + gk);
      *reinterpret_cast<uint4*>(as + r * LDT + cv) = val;
    }
    // B tiles: 64 output features x 4 vectors, one tile a weight
#pragma unroll
    for (int w = 0; w < 3; ++w) {
      const int r = tid >> 2;
      const int cv = (tid & 3) * 8;
      const int gn = n0 + r;
      const int gk = k0 + cv;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gn < inner && gk < c) val = *reinterpret_cast<const uint4*>(ws[w] + (size_t)gn * c + gk);
      *reinterpret_cast<uint4*>(bs + w * BN * LDT + r * LDT + cv) = val;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * LDT + kk, LDT);
#pragma unroll
      for (int w = 0; w < 3; ++w) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, bs + w * BN * LDT + (wn * 32 + j * 16) * LDT + kk, LDT);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[w][i][j], fa[i], fb, acc[w][i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int w = 0; w < 3; ++w) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(stage + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[w][i][j],
                                LDC, wmma::mem_row_major);
    __syncthreads();
    bf16* out = outs[w];
    for (int idx = tid; idx < BM * BN / 2; idx += THREADS) {
      const int r = idx / (BN / 2);
      const int col = (idx % (BN / 2)) * 2;
      const int gr = m0 + r;
      const int gc = n0 + col;
      if (gr >= m || gc >= inner) continue;
      *reinterpret_cast<bf162*>(out + (size_t)gr * inner + gc) =
          __floats2bfloat162_rn(stage[r * LDC + col], stage[r * LDC + col + 1]);
    }
    __syncthreads();  // the staging tile is free for the next output
  }
}

}  // namespace

extern "C" int ls_qkv_proj(const void* x, const void* wq, const void* wk, const void* wv, void* q,
                           void* k, void* v, int m, int c, int inner, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((inner + BN - 1) / BN, (m + BM - 1) / BM);
  qkv_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wq), static_cast<const bf16*>(wk),
      static_cast<const bf16*>(wv), static_cast<bf16*>(q), static_cast<bf16*>(k),
      static_cast<bf16*>(v), m, c, inner);
  return (int)cudaGetLastError();
}
