// K10: the int8-in / int8-out GEGLU feed-forward
//   x      = bf16(xi * xs)                        (xi int8 (M, C), xs f32 (M,))
//   hidden = bf16((x Wv^T + bv) * gelu_erf(x Wg^T + bg))
//   res    = hidden Wd^T + bd                     (f32)
//   os     = max_c |res| / 127 + 1e-12;  oi = int8(rint(res / os))
// Replaces the TPU kernel latentsync_tpu/ops/ffn.py _geglu_i8_kernel
// (:338, pallas_call at :386), which kept the dequantized x, the hidden and
// the f32 result of a row block in VMEM across an inner grid axis.
//
// Hopper has no sequential grid, so this is geglu.cu's chain with other
// ends: a row pass dequantizes x once into a bf16 scratch buffer (gemm.cuh
// dequant_rows, in the place of geglu.cu's LayerNorm pass), the
// up-projection reads it like any A; the down-projection leaves its (M, C)
// result in an f32 scratch buffer (gemm.cuh F32OUT), because a block of the
// GEMM owns part of a row's C columns and the output scale needs the whole
// row; a last pass, one warp a row, takes the row's amax and writes the int8
// codes and the scale. The scratch buffers stay inside the chain: what
// leaves is int8 + f32 scales. The codes use IEEE division and round half to
// even and need no clamp (|res| / os <= 127 by construction), as the TPU
// kernel's; an all-zero row gives os = 1e-12 and zero codes.
//
// Bound: operations, the 24 M C^2 FLOP of the two GEMMs on the tensor cores
// (see gemm.cuh); the int8 ends halve the activation bytes that enter and
// leave, which the bf16 x and hidden and the f32 scratch outweigh in this
// version.
#include "gemm.cuh"

namespace {

// One warp per row of the f32 result: amax, scale, codes. c % 4 == 0.
__global__ void row_quantize_kernel(const float* __restrict__ res, int m, int c,
                                    int8_t* __restrict__ codes, float* __restrict__ scales) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= m) return;
  const float4* r4 = reinterpret_cast<const float4*>(res + (size_t)row * c);
  const int nv = c / 4;
  float amax = 0.f;
  for (int i = lane; i < nv; i += 32) {
    const float4 v = r4[i];
    amax = fmaxf(fmaxf(amax, fmaxf(fabsf(v.x), fabsf(v.y))), fmaxf(fabsf(v.z), fabsf(v.w)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(LS_FULL_MASK, amax, o));
  const float s = amax / 127.0f + 1e-12f;
  char4* out = reinterpret_cast<char4*>(codes + (size_t)row * c);
  for (int i = lane; i < nv; i += 32) {
    const float4 v = r4[i];
    out[i] = make_char4((signed char)__float2int_rn(v.x / s), (signed char)__float2int_rn(v.y / s),
                        (signed char)__float2int_rn(v.z / s), (signed char)__float2int_rn(v.w / s));
  }
  if (lane == 0) scales[row] = s;
}

}  // namespace

extern "C" int ls_geglu_ffn_int8io(const void* xi, const float* xs, int m, int c, const void* w_up,
                                   const float* b_up, const void* w_down, const float* b_down,
                                   void* xdq, void* hidden, float* res, void* out_codes,
                                   float* out_scales, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int inner = 4 * c;
  const bf16* wu = static_cast<const bf16*>(w_up);
  cudaError_t e = ls_gemm::dequant_rows(static_cast<const int8_t*>(xi), xs, m, c,
                                        static_cast<bf16*>(xdq), s);
  if (e != cudaSuccess) return (int)e;
  ls_gemm::Args up = {};
  up.a = static_cast<const bf16*>(xdq);
  up.lda = c;
  up.b = wu;                          // value rows [0, inner)
  up.b_gate = wu + (size_t)inner * c;  // gate rows [inner, 2 inner)
  up.ldb = c;
  up.c = static_cast<bf16*>(hidden);
  up.ldc = inner;
  up.m = m;
  up.n = inner;
  up.k = c;
  up.bias = b_up;
  up.bias_gate = b_up + inner;
  e = ls_gemm::gemm(up, s);
  if (e != cudaSuccess) return (int)e;
  ls_gemm::Args down = {};
  down.a = static_cast<const bf16*>(hidden);
  down.lda = inner;
  down.b = static_cast<const bf16*>(w_down);
  down.ldb = inner;
  down.c_f32 = res;
  down.ldc = c;
  down.m = m;
  down.n = c;
  down.k = inner;
  down.bias = b_down;
  e = ls_gemm::gemm(down, s);
  if (e != cudaSuccess) return (int)e;
  const int rows_per_block = 8;
  row_quantize_kernel<<<(m + rows_per_block - 1) / rows_per_block, 32 * rows_per_block, 0, s>>>(
      res, m, c, static_cast<int8_t*>(out_codes), out_scales);
  return (int)cudaGetLastError();
}
