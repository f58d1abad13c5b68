// The streaming-softmax (flash) attention core shared by
// flash_attention.cu (the route of dot_product_attention) and
// flash_kernel.cu (K12, flash_attention).
//
//   o = softmax(q k^T * scale) v over (B, S, H, D) through strides, f32
//   logits and online softmax, f32 accumulation, bf16 in and out.
//
// Two numerics, chosen at compile time so that each entry point rounds
// where the TPU kernel it replaces rounds:
//   EXACT = false: probabilities rounded to bf16 before the value product
//     (jax's library flash kernel and the plain dot_product_attention);
//   EXACT = true: probabilities are not rounded (the TPU _flash_kernel
//     keeps p and v in f32). The tensor cores take bf16, so each f32
//     probability is split into three bf16 terms p0 + p1 + p2 (8 + 8 + 8
//     mantissa bits: the split is exact) and the value product runs once
//     per term into one f32 accumulator; bf16 q, k and v are exact in f32
//     already, so both products equal f32 products up to summation order.
//     exp is expf, and the end divides by the row sum.
//
// Design. Common flash kernels stop at D = 256 because the output
// accumulator lives in registers. Here one block of 8 warps owns 32 query
// rows of one (batch, head), and the 32 x DP f32 accumulator is spread
// over all 8 warps: warp w owns output columns [w DP/8, (w+1) DP/8) of all
// 32 rows (64 f32 registers a thread at D = 512). The Q tile (32 x DP)
// and one key block of K and V (64 x DP each) sit in shared memory
// (178 KB at D = 512). Per key block: every warp computes a 16 x 16 piece
// of the 32 x 64 logits with mma.sync m16n8k16 (bf16 in, f32 out) over
// the whole DP; 8 threads per row take the online-softmax step on the f32
// logits in shared memory and write the probabilities; every warp then
// adds P (32 x 64) . V[:, its columns] into its accumulator, rescaled by
// the row's correction factor first.
//
// Head dims. DP is D rounded up to a multiple of 64 (8 warps x 8-wide
// n-tiles): D = 40 runs as DP = 64 and D = 80 as DP = 128, the extra
// columns of the Q, K and V tiles zero in shared memory (they add nothing
// to the logits and their output columns are not stored).
//
// Bound: at S = 1024, D = 512 the two products are 4 S^2 D FLOP per
// (batch, head) on the tensor cores; K and V are re-read from L2 by each
// of the S / 32 query blocks (2 MB per block per batch at D = 512), and
// each tile's loads go out together as cp.async but are waited for before
// the products start (no pipeline across key blocks yet), so this version
// is bound by those L2 reads and their latency.
#pragma once

#include "mma.cuh"

namespace ls_flash {

using namespace ls_mma;

constexpr int FQ = 32;   // query rows per block
constexpr int FK = 64;   // keys per step
constexpr int F_THREADS = 256;
constexpr int F_WARPS = F_THREADS / 32;

template <int D, int DP, bool EXACT>
__global__ void __launch_bounds__(F_THREADS, 1)
    flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, long qb, long qs, long qh, long kb, long ks,
                 long kh, long vb, long vs, long vh, bf16* __restrict__ o, int seq_q, int seq_k,
                 int heads, float scale) {
  static_assert(D % 8 == 0 && DP % 64 == 0 && DP >= D, "head dim");
  constexpr int LD = DP + 8;   // bf16 pitch of the Q/K/V tiles
  constexpr int LDS = FK + 4;  // f32 pitch of the logits
  constexpr int LDP = FK + 8;  // bf16 pitch of the probabilities
  constexpr int NP = EXACT ? 3 : 1;  // bf16 terms per probability
  constexpr int WC = DP / F_WARPS;   // output columns per warp
  constexpr int NT = WC / 8;         // n-tiles of 8 per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qt = reinterpret_cast<bf16*>(smem_raw);
  bf16* kt = qt + FQ * LD;
  bf16* vt = kt + FK * LD;
  float* st = reinterpret_cast<float*>(vt + FK * LD);
  bf16* pt = reinterpret_cast<bf16*>(st + FQ * LDS);  // NP tiles of FQ x LDP
  float* row_m = reinterpret_cast<float*>(pt + NP * FQ * LDP);
  float* row_l = row_m + FQ;
  float* row_a = row_l + FQ;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * FQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  copy_rows<D, DP, F_THREADS>(qt, LD, q + b * qb + (long)q0 * qs + h * qh, qs, FQ);
  if (tid < FQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }
  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;

  // logits: warp w computes rows [16 (w & 1), +16) x keys [16 (w >> 1), +16)
  const int s_r0 = (warp & 1) * 16;
  const int s_c0 = (warp >> 1) * 16;
  const unsigned short* vt16 = reinterpret_cast<const unsigned short*>(vt);

  for (int k0 = 0; k0 < seq_k; k0 += FK) {
    __syncthreads();  // the previous step is done with K, V and P
    copy_rows<D, DP, F_THREADS>(kt, LD, k + b * kb + (long)k0 * ks + h * kh, ks, FK);
    copy_rows<D, DP, F_THREADS>(vt, LD, v + b * vb + (long)k0 * vs + h * vh, vs, FK);
    copy_wait();  // Q too, in the first step
    __syncthreads();

    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t a[4];
      load_a(a, qt, LD, s_r0, kk, g, t);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bf16* kr = kt + (s_c0 + j * 8 + g) * LD + kk + 2 * t;
        mma16816(sc[j], a, ld32(kr), ld32(kr + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = s_c0 + j * 8 + 2 * t;
      st[(s_r0 + g) * LDS + c] = sc[j][0] * scale;
      st[(s_r0 + g) * LDS + c + 1] = sc[j][1] * scale;
      st[(s_r0 + g + 8) * LDS + c] = sc[j][2] * scale;
      st[(s_r0 + g + 8) * LDS + c + 1] = sc[j][3] * scale;
    }
    __syncthreads();

    {  // online softmax step: 8 threads per row, 8 keys each
      const int r = tid >> 3;
      const int c0 = (tid & 7) * 8;
      float sv[8];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sv[i] = st[r * LDS + c0 + i];
        mx = fmaxf(mx, sv[i]);
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(LS_FULL_MASK, mx, o));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; i += 2) {
        float p0 = EXACT ? expf(sv[i] - m_new) : __expf(sv[i] - m_new);
        float p1 = EXACT ? expf(sv[i + 1] - m_new) : __expf(sv[i + 1] - m_new);
        sum += p0 + p1;
#pragma unroll
        for (int term = 0; term < NP; ++term) {
          const bf162 hi = __floats2bfloat162_rn(p0, p1);
          *reinterpret_cast<bf162*>(pt + term * FQ * LDP + r * LDP + c0 + i) = hi;
          const float2 back = __bfloat1622float2(hi);
          p0 -= back.x;  // exact: the remainder of a bf16 rounding fits in f32
          p1 -= back.y;
        }
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) sum += __shfl_xor_sync(LS_FULL_MASK, sum, o);
      __syncwarp();  // every thread of the row has read row_m
      if ((tid & 7) == 0) {
        const float alpha = EXACT ? expf(m_old - m_new) : __expf(m_old - m_new);
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float a0 = row_a[mt * 16 + g];
      const float a1 = row_a[mt * 16 + g + 8];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[mt][n][0] *= a0;
        acc[mt][n][1] *= a0;
        acc[mt][n][2] *= a1;
        acc[mt][n][3] *= a1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < FK; kk += 16) {
      uint32_t a[NP][2][4];
#pragma unroll
      for (int term = 0; term < NP; ++term) {
        load_a(a[term][0], pt + term * FQ * LDP, LDP, 0, kk, g, t);
        load_a(a[term][1], pt + term * FQ * LDP, LDP, 16, kk, g, t);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = warp * WC + n * 8 + g;
        const int r0 = kk + 2 * t;
        const uint32_t b0 = pack2(vt16, r0 * LD + col, (r0 + 1) * LD + col);
        const uint32_t b1 = pack2(vt16, (r0 + 8) * LD + col, (r0 + 9) * LD + col);
#pragma unroll
        for (int term = 0; term < NP; ++term) {
          mma16816(acc[0][n], a[term][0], b0, b1);
          mma16816(acc[1][n], a[term][1], b0, b1);
        }
      }
    }
  }
  __syncthreads();

  const long o_row = (long)heads * D;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mt * 16 + g + half * 8;
      const float l = row_l[r];
      const float inv = 1.f / l;
      bf16* orow = o + ((long)b * seq_q + q0 + r) * o_row + (long)h * D;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = warp * WC + n * 8 + 2 * t;
        if (c >= D) continue;  // a padded column
        const float x0 = acc[mt][n][2 * half];
        const float x1 = acc[mt][n][2 * half + 1];
        *reinterpret_cast<bf162*>(orow + c) =
            EXACT ? __floats2bfloat162_rn(x0 / l, x1 / l) : __floats2bfloat162_rn(x0 * inv, x1 * inv);
      }
    }
  }
}

// q: (batch, seq_q, heads, D) and k, v: (batch, seq_k, heads, D) through
// their (batch, seq, head) strides; o contiguous (batch, seq_q, heads, D).
// seq_q must be a multiple of FQ and seq_k of FK.
template <int D, int DP, bool EXACT>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, long qb, long qs, long qh, long kb,
                   long ks, long kh, long vb, long vs, long vh, bf16* o, int batch, int seq_q,
                   int seq_k, int heads, float scale, cudaStream_t s) {
  if (seq_q % FQ != 0 || seq_k % FK != 0) return cudaErrorInvalidValue;
  constexpr int LD = DP + 8;
  constexpr int NP = EXACT ? 3 : 1;
  const size_t smem = (size_t)(FQ + 2 * FK) * LD * sizeof(bf16) +
                      (size_t)FQ * (FK + 4) * sizeof(float) +
                      (size_t)NP * FQ * (FK + 8) * sizeof(bf16) + 3 * FQ * sizeof(float);
  cudaError_t e = ls_allow_smem(flash_kernel<D, DP, EXACT>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(seq_q / FQ, heads, batch);
  flash_kernel<D, DP, EXACT><<<grid, F_THREADS, smem, s>>>(q, k, v, qb, qs, qh, kb, ks, kh, vb, vs,
                                                          vh, o, seq_q, seq_k, heads, scale);
  return cudaGetLastError();
}

}  // namespace ls_flash
