// Attention cores for the UNet's self-attention: the temporal core (16
// frames per sequence) and the spatial core (S tokens per frame).
//
// Both read q/k/v in the model's (rows, heads * D) layout through a row
// pitch, so they take either separate q/k/v tensors or column slices of
// one fused (rows, 3 * inner) projection, and write o as (rows, inner).
// Softmax statistics and every sum are f32; inputs and outputs are bf16.
#pragma once

#include "common.cuh"

namespace ls_attn {

// ---------------------------------------------------------------------------
// Temporal core. Replaces the TPU kernels latentsync_tpu/ops/
// temporal_attention.py _kernel (frame-major (F, heads) fold + block-
// diagonal mask) and the attention part of latentsync_tpu/ops/
// attn_block.py _kernel in temporal mode (head-major fold). On the TPU the
// fold fed the 128-wide MXU; on Hopper one warp owns one (sequence, head)
// pair, so no fold and no mask exist and heads can never mix.
//
// Bound: memory. Each (sequence, head) reads 3 * 16 * D bf16 and does
// 2 * 16 * 16 * D FMAs (about 2 FLOP per byte), far below the card's
// ~295 FLOP/byte balance point, so the design is about one coalesced
// 16-byte pass over q/k/v and o, with the 16x16 logits kept in registers.
// Lane layout: lane & 15 is the query row, lane >> 4 picks keys 0-7 or
// 8-15; the two halves combine through one shuffle.
// ---------------------------------------------------------------------------

constexpr int TF = 16;
constexpr int T_WARPS = 4;

static __global__ void __launch_bounds__(32 * T_WARPS)
    temporal_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, int ldq, int ldk, int ldv, bf16* __restrict__ o,
                    int ldo, int batch, int heads, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long task = (long)blockIdx.x * T_WARPS + warp;
  if (task >= (long)batch * heads) return;  // whole warp leaves together
  const int b = (int)(task / heads);
  const int h = (int)(task % heads);

  bf16* qs = reinterpret_cast<bf16*>(smem_raw) + (size_t)warp * 3 * TF * d;
  bf16* ks = qs + TF * d;
  bf16* vs = ks + TF * d;

  const int vpr = d / 8;  // 16-byte vectors per row
  for (int i = lane; i < TF * vpr; i += 32) {
    const int f = i / vpr;
    const int c = (i % vpr) * 8;
    const size_t row = (size_t)b * TF + f;
    *reinterpret_cast<uint4*>(qs + f * d + c) =
        *reinterpret_cast<const uint4*>(q + row * ldq + (size_t)h * d + c);
    *reinterpret_cast<uint4*>(ks + f * d + c) =
        *reinterpret_cast<const uint4*>(k + row * ldk + (size_t)h * d + c);
    *reinterpret_cast<uint4*>(vs + f * d + c) =
        *reinterpret_cast<const uint4*>(v + row * ldv + (size_t)h * d + c);
  }
  __syncwarp();

  const int qi = lane & 15;
  const int half = lane >> 4;
  const int d2 = d / 2;
  const bf162* q2 = reinterpret_cast<const bf162*>(qs + qi * d);
  float s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = 0.f;
  for (int c = 0; c < d2; ++c) {
    const float2 qf = __bfloat1622float2(q2[c]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 kf =
          __bfloat1622float2(reinterpret_cast<const bf162*>(ks + (half * 8 + j) * d)[c]);
      s[j] = fmaf(qf.x, kf.x, fmaf(qf.y, kf.y, s[j]));
    }
  }
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j] *= scale;
    mx = fmaxf(mx, s[j]);
  }
  mx = fmaxf(mx, __shfl_xor_sync(LS_FULL_MASK, mx, 16));
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j] = expf(s[j] - mx);
    l += s[j];
  }
  l += __shfl_xor_sync(LS_FULL_MASK, l, 16);
  const float inv = 1.f / l;
  __syncwarp();  // q rows are reused below as the output staging buffer

  bf162* out_row = reinterpret_cast<bf162*>(qs + qi * d);
  for (int c = 0; c < d2; ++c) {
    float ax = 0.f, ay = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 vf =
          __bfloat1622float2(reinterpret_cast<const bf162*>(vs + (half * 8 + j) * d)[c]);
      ax = fmaf(s[j], vf.x, ax);
      ay = fmaf(s[j], vf.y, ay);
    }
    ax += __shfl_xor_sync(LS_FULL_MASK, ax, 16);
    ay += __shfl_xor_sync(LS_FULL_MASK, ay, 16);
    if ((c & 1) == half) out_row[c] = __floats2bfloat162_rn(ax * inv, ay * inv);
  }
  __syncwarp();
  for (int i = lane; i < TF * vpr; i += 32) {
    const int f = i / vpr;
    const int c = (i % vpr) * 8;
    const size_t row = (size_t)b * TF + f;
    *reinterpret_cast<uint4*>(o + row * ldo + (size_t)h * d + c) =
        *reinterpret_cast<const uint4*>(qs + f * d + c);
  }
}

static inline cudaError_t temporal(const bf16* q, const bf16* k, const bf16* v, int ldq, int ldk,
                                   int ldv, bf16* o, int ldo, int batch, int heads, int d,
                                   float scale, cudaStream_t s) {
  const size_t smem = (size_t)T_WARPS * 3 * TF * d * sizeof(bf16);
  cudaError_t e = ls_allow_smem(temporal_kernel, smem);
  if (e != cudaSuccess) return e;
  const long tasks = (long)batch * heads;
  const int blocks = (int)((tasks + T_WARPS - 1) / T_WARPS);
  temporal_kernel<<<blocks, 32 * T_WARPS, smem, s>>>(q, k, v, ldq, ldk, ldv, o, ldo, batch, heads,
                                                     d, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Spatial core (K4). Replaces the TPU kernel latentsync_tpu/ops/
// temporal_attention.py _spatial_kernel (heads sliced on lanes, whole
// (S, S) logits per head in VMEM) and the attention part of
// latentsync_tpu/ops/attn_block.py _kernel in spatial mode. Head dims 40,
// 80 and 160, any S >= 1. Defined once, in spatial_attention.cu, on the
// tensor-core attention core of attn_core.cuh (design and bound there);
// block_q picks the query rows a block (64 or 128; 0: by S).
// ---------------------------------------------------------------------------

cudaError_t spatial(const bf16* q, const bf16* k, const bf16* v, int ldq, int ldk, int ldv,
                    bf16* o, int ldo, int batch, int seq, int heads, int d, float scale,
                    cudaStream_t s, int block_q = 0);

// K2's spatial mode: the same core at head dims 40 and 80 (block_q by S),
// its kernels named apart (attn_kernel<..., ls_attn::k2_spatial_core>) so
// that a profile tells them from K4's.
struct k2_spatial_core;
constexpr bool k2_spatial_takes(int d) { return d == 40 || d == 80; }
cudaError_t spatial_k2(const bf16* q, const bf16* k, const bf16* v, int ldq, int ldk, int ldv,
                       bf16* o, int ldo, int batch, int seq, int heads, int d, float scale,
                       cudaStream_t s);

}  // namespace ls_attn
