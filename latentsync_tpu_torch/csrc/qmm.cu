// K8: the int8 matmul with fused dynamic row quantization and a dequant
// epilogue,
//   wscale[n]  = max(max_k |w[n, k]|, 1e-8) * (1/127),  wq = rint(w / wscale)
//   ascale[m]  = max(max_k |x[m, k]|, 1e-8) * (1/127),  xq = clamp(rint(x / ascale), -127, 127)
//   acc[m, n]  = sum_k xq[m, k] * wq[n, k]   (int32)
//   out[m, n]  = bf16( bf16((f32(acc[m, n]) * ascale[m]) * wscale[n]) + bias[n] )
// with x (M, K) bf16, w (N, K) bf16 or f32 (the nn.Linear layout, i.e. the
// K-major operand), bias (bf16) possibly null.
//
// Replaces the TPU kernel latentsync_tpu/ops/qmm.py _qmm_kernel
// (pallas_call at qmm.py:59), which quantized a whole (bm, K) row block in
// VMEM for each of its output blocks, the weight having been quantized by
// XLA before the call. Here it is two launches:
//   1. the quantizing row pass: one warp a row over the M rows of x and then
//      the N rows of w in one launch. A row is read once for its amax and
//      again (from L1/L2) for its codes: one IEEE division a value
//      (__fdiv_rn, round half to even as jnp.round, clamp to +-127, which
//      for w is never reached), the f32 scale and the int8 codes written at
//      a pitch kp = K rounded up to 16 with a zero tail;
//   2. the product on the GEMM template's int8 mode (gemm.cuh): wgmma
//      s32.s8.s8 behind the 3-stage cp.async ring of 128-code k-tiles in the
//      128-byte swizzle, resident blocks, and K8's dequantization in the
//      epilogue from registers (__int2float_rn: |acc| can pass 2^24 at
//      K = 5120 and the plain version rounds it the same way).
// The result is bitwise the plain version's (quantized_matmul_reference). A
// row of zeros gives ascale = 1e-8/127, zero codes, and exactly the bias.
//
// What bounds it: the function moves 2MK + 2NK + 2MN bytes and does 2MNK
// int8 operations, so at the served shapes (K = 320..5120) it is bound by
// bytes below K of about 1000 and by operations above. The row pass writes
// the codes (MK + NK bytes) and the product reads them back, a round trip
// the bound does not count; in exchange a value is divided once, where the
// first version divided it again for each of the N / 64 column blocks that
// staged it.
#include "gemm.cuh"

namespace {

// the reference multiplies by the f32 rounding of the double 1/127
#define LS_INV127 ((float)(1.0 / 127.0))

// values 8i..8i+7 of a row, in f32
__device__ __forceinline__ void load8(const bf16* row, int i, float (&v)[8]) {
  const uint4 u = reinterpret_cast<const uint4*>(row)[i];
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int t = 0; t < 8; ++t) v[t] = __bfloat162float(e[t]);
}

__device__ __forceinline__ void load8(const float* row, int i, float (&v)[8]) {
  const float4 lo = reinterpret_cast<const float4*>(row)[2 * i];
  const float4 hi = reinterpret_cast<const float4*>(row)[2 * i + 1];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// Rows [0, m) of x into (xq, ascale), then rows [0, n) of w (bf16 or f32,
// WT) into (wq, wscale); one warp a row, eight values a lane, codes at pitch kp.
template <typename WT>
__global__ void qmm_quantize_rows_kernel(const bf16* __restrict__ x, int m,
                                         const WT* __restrict__ w, int n, int k, int kp,
                                         int8_t* __restrict__ xq, float* __restrict__ ascale,
                                         int8_t* __restrict__ wq, float* __restrict__ wscale) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)m + n) return;
  const bool is_x = row < m;  // the same for the whole warp
  const int r = (int)(is_x ? row : row - m);
  const bf16* xr = x + (size_t)r * k;
  const WT* wr = w + (size_t)r * k;
  uint2* dst = reinterpret_cast<uint2*>((is_x ? xq : wq) + (size_t)r * kp);
  const int vk = k / 8, vkp = kp / 8;
  float v[8];
  float amax = 0.f;
  for (int i = lane; i < vk; i += 32) {
    if (is_x) load8(xr, i, v); else load8(wr, i, v);
#pragma unroll
    for (int t = 0; t < 8; ++t) amax = fmaxf(amax, fabsf(v[t]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(LS_FULL_MASK, amax, o));
  const float scale = fmaxf(amax, 1e-8f) * LS_INV127;
  if (lane == 0) (is_x ? ascale : wscale)[r] = scale;
  for (int i = lane; i < vkp; i += 32) {
    uint2 q = make_uint2(0, 0);  // the tail past K stays zero
    if (i < vk) {
      if (is_x) load8(xr, i, v); else load8(wr, i, v);
      signed char* qb = reinterpret_cast<signed char*>(&q);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int c = __float2int_rn(__fdiv_rn(v[t], scale));
        qb[t] = (signed char)min(max(c, -127), 127);
      }
    }
    dst[i] = q;
  }
}

}  // namespace

// x (m, k), out (m, n) bf16 contiguous, w (n, k) contiguous bf16 or (w_f32)
// f32, bias (n) bf16 or null; k and n multiples of 8. Scratch: xq (m, kp) and
// wq (n, kp) int8, ascale (m) and wscale (n) f32, kp = k rounded up to 16,
// each 16-byte aligned.
extern "C" int ls_quantized_matmul(const void* x, const void* w, const void* bias, void* xq,
                                   int m, int k, int n, float* ascale, void* wq, float* wscale,
                                   void* out, int w_f32, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 8 || n % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kp = (k + 15) / 16 * 16;
  const int rows_per_block = 8;
  const long long blocks = ((long long)m + n + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL || (long long)m * kp > 0x7fffffffLL ||
      (long long)n * kp > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  int8_t *xqb = static_cast<int8_t*>(xq), *wqb = static_cast<int8_t*>(wq);
  if (w_f32)
    qmm_quantize_rows_kernel<<<(unsigned)blocks, 32 * rows_per_block, 0, s>>>(
        xb, m, static_cast<const float*>(w), n, k, kp, xqb, ascale, wqb, wscale);
  else
    qmm_quantize_rows_kernel<<<(unsigned)blocks, 32 * rows_per_block, 0, s>>>(
        xb, m, static_cast<const bf16*>(w), n, k, kp, xqb, ascale, wqb, wscale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  ls_gemm::Args p = {};
  p.a = xq;
  p.lda = kp;
  p.b = wq;
  p.ldb = kp;
  p.c = static_cast<bf16*>(out);
  p.ldc = n;
  p.m = m;
  p.n = n;
  p.k = kp;
  p.a_scale = ascale;
  p.b_scale = wscale;
  p.bias_bf16 = static_cast<const bf16*>(bias);
  return (int)ls_gemm::gemm_s8(p, s);
}
