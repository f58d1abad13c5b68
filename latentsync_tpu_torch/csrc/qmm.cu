// K8: the int8 matmul with fused dynamic row quantization and a dequant
// epilogue,
//   ascale[m]  = max(max_k |x[m, k]|, 1e-8) * (1/127)
//   acc[m, n]  = sum_k clamp(rint(x[m, k] / ascale[m]), -127, 127) * wq[n, k]   (int32)
//   out[m, n]  = bf16( bf16((acc[m, n] * ascale[m]) * wscale[n]) + bias[n] )
// with x (M, K) bf16, wq the int8 weight (N, K) row-major (the nn.Linear
// layout, i.e. the column-major (K, N) operand) and wscale its f32
// per-out-channel scales; bias (bf16) may be null.
//
// Replaces the TPU kernel latentsync_tpu/ops/qmm.py _qmm_kernel
// (pallas_call at qmm.py:59), which quantized a whole (bm, K) row block in
// VMEM per output block. Hopper has no sequential grid and a block here
// holds a K-slice, not the whole row, so the row scales come from a first
// pass (one warp per row, over the whole K): a tile never computes its own
// amax. The GEMM then quantizes each bf16 A tile while it stages it in
// shared memory (IEEE division, round half to even as jnp.round, clamp),
// so the int8 activations never reach device memory; it accumulates on the
// int8 tensor cores (WMMA s8 16x16x16, int32) and dequantizes in the
// epilogue in the reference's order, rounding to bf16 before the bias and
// again after it, as the reference does.
//
// Design: one 128x64 output tile per block, 8 warps each owning a 32x32
// sub-tile as 2x2 WMMA fragments; the K loop stages a 128x64 int8 A tile
// and a 64x64 int8 B tile in shared memory as four 16-deep k-slabs of
// 16-byte rows (every fragment pointer 256-byte aligned, ldm = 16).
// Rows past M and columns past N are masked; K must be a multiple of 8
// (16-byte loads of x, 8-byte loads of wq) and is zero-padded to the tile.
// A row of zeros gives ascale = 1e-8/127, zero codes, and exactly the bias.
//
// What bounds it on the card: at the served shapes (K = 320..5120) the
// int8 products are compute bound; this first version uses mma.sync
// through WMMA with synchronous staging (no cp.async/TMA/wgmma pipeline)
// and re-quantizes the A tile for each of the N/64 column blocks, trading
// CUDA-core work (one IEEE division an element and column block) for
// never writing the int8 activations to device memory.
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace ls_qmm {

using namespace nvcuda;

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int SLABS = BK / 16;
constexpr int LDC = BN + 4;  // int32 staging row pitch (272 bytes)
constexpr int THREADS = 256;
// the reference multiplies by the f32 rounding of the double 1/127
#define LS_INV127 ((float)(1.0 / 127.0))

// One warp per row: ascale = max(amax, 1e-8) * (1/127) over the whole K.
static __global__ void row_scale_kernel(const bf16* __restrict__ x, int m, int k,
                                        float* __restrict__ ascale) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= m) return;
  const bf16* xr = x + (size_t)row * k;
  float amax = 0.f;
  for (int c = lane * 8; c < k; c += 32 * 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int t = 0; t < 8; ++t) amax = fmaxf(amax, fabsf(__bfloat162float(e[t])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(LS_FULL_MASK, amax, o));
  if (lane == 0) ascale[row] = fmaxf(amax, 1e-8f) * LS_INV127;
}

static __global__ void __launch_bounds__(THREADS)
    qmm_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ wq,
               const float* __restrict__ wscale, const float* __restrict__ ascale,
               const bf16* __restrict__ bias, bf16* __restrict__ out, int m, int k, int n) {
  constexpr int A_BYTES = SLABS * BM * 16;
  constexpr int B_BYTES = SLABS * BN * 16;
  constexpr int STAGE_BYTES = BM * LDC * (int)sizeof(int);
  constexpr int SMEM = A_BYTES + B_BYTES > STAGE_BYTES ? A_BYTES + B_BYTES : STAGE_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  __shared__ float sscale[BM];

  signed char* as = reinterpret_cast<signed char*>(smem);
  signed char* bs = as + A_BYTES;
  int* stage = reinterpret_cast<int*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // 0..3: 32-row slab
  const int wn = warp & 1;   // 0..1: 32-col slab
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  for (int r = tid; r < BM; r += THREADS) sscale[r] = m0 + r < m ? ascale[m0 + r] : 1.f;
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < k; k0 += BK) {
    // A tile: 128 rows x 8 vectors of 8 bf16, quantized on the way in.
#pragma unroll
    for (int rep = 0; rep < (BM * BK / 8) / THREADS; ++rep) {
      const int idx = tid + rep * THREADS;
      const int r = idx >> 3;
      const int cv = (idx & 7) * 8;
      const int gr = m0 + r;
      const int gk = k0 + cv;
      uint2 q = make_uint2(0, 0);
      if (gr < m && gk < k) {
        const uint4 v = *reinterpret_cast<const uint4*>(x + (size_t)gr * k + gk);
        const bf16* e = reinterpret_cast<const bf16*>(&v);
        const float s = sscale[r];
        signed char* qb = reinterpret_cast<signed char*>(&q);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int c = __float2int_rn(__bfloat162float(e[t]) / s);
          qb[t] = (signed char)min(max(c, -127), 127);
        }
      }
      *reinterpret_cast<uint2*>(as + (cv >> 4) * (BM * 16) + r * 16 + (cv & 15)) = q;
    }
    // B tile: 64 output features x 8 vectors of 8 int8.
#pragma unroll
    for (int rep = 0; rep < (BN * BK / 8) / THREADS; ++rep) {
      const int idx = tid + rep * THREADS;
      const int r = idx >> 3;
      const int cv = (idx & 7) * 8;
      const int gn = n0 + r;
      const int gk = k0 + cv;
      uint2 v = make_uint2(0, 0);
      if (gn < n && gk < k) v = *reinterpret_cast<const uint2*>(wq + (size_t)gn * k + gk);
      *reinterpret_cast<uint2*>(bs + (cv >> 4) * (BN * 16) + r * 16 + (cv & 15)) = v;
    }
    __syncthreads();

#pragma unroll
    for (int s = 0; s < SLABS; ++s) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + s * (BM * 16) + (wm * 32 + i * 16) * 16, 16);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, bs + s * (BN * 16) + (wn * 32 + j * 16) * 16, 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(stage + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();

  // dequant as the reference orders it: (acc * ascale) * wscale, rounded
  // to bf16, then + bias in bf16 (a second rounding)
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN;
    const int c = idx % BN;
    const int gr = m0 + r;
    const int gc = n0 + c;
    if (gr >= m || gc >= n) continue;
    const float v = (float)stage[r * LDC + c] * sscale[r] * wscale[gc];
    bf16 o = __float2bfloat16(v);
    if (bias != nullptr) o = __float2bfloat16(__bfloat162float(o) + __bfloat162float(bias[gc]));
    out[(size_t)gr * n + gc] = o;
  }
}

}  // namespace ls_qmm

extern "C" int ls_quantized_matmul(const void* x, const void* wq, const float* wscale,
                                   const void* bias, int m, int k, int n, float* ascale, void* out,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const int rows_per_block = 8;
  ls_qmm::row_scale_kernel<<<(m + rows_per_block - 1) / rows_per_block, 32 * rows_per_block, 0,
                             s>>>(xb, m, k, ascale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + ls_qmm::BN - 1) / ls_qmm::BN, (m + ls_qmm::BM - 1) / ls_qmm::BM);
  ls_qmm::qmm_kernel<<<grid, ls_qmm::THREADS, 0, s>>>(
      xb, static_cast<const int8_t*>(wq), wscale, ascale, static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), m, k, n);
  return (int)cudaGetLastError();
}
