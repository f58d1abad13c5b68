// K1: the fused GEGLU feed-forward
//   out = x + (gelu_erf(LN(x) Wg^T + bg) * (LN(x) Wv^T + bv)) Wd^T + bd
// Replaces the TPU kernel latentsync_tpu/ops/ffn.py _geglu_kernel
// (pallas_call at ffn.py:156). The TPU kept the (M, 4C) hidden in VMEM
// across an inner grid axis; Hopper has no sequential grid, so the
// product becomes a chain of three launches on one stream: LayerNorm row
// statistics, the up-projection with the LN prologue and a fused
// value * GELU(gate) epilogue (the (M, 8C) pre-activation never reaches
// device memory, only the bf16 (M, 4C) hidden does), and the
// down-projection with bias and residual epilogue. Bound: tensor-core
// throughput of the two GEMMs (see gemm.cuh).
#include "gemm.cuh"

extern "C" int ls_geglu_ffn(const void* x, int m, int c, const void* w_up, const float* b_up,
                            const void* w_down, const float* b_down, const float* ln_w,
                            const float* ln_b, float eps, int residual, void* stats, void* hidden,
                            void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int inner = 4 * c;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wu = static_cast<const bf16*>(w_up);
  float2* st = ln_w != nullptr ? static_cast<float2*>(stats) : nullptr;
  cudaError_t e = cudaSuccess;
  if (st != nullptr) {
    e = ls_gemm::row_stats(xb, m, c, c, eps, st, s);
    if (e != cudaSuccess) return (int)e;
  }
  ls_gemm::Args up = {};
  up.a = xb;
  up.lda = c;
  up.b = wu;                      // value rows [0, inner)
  up.b2 = wu + (size_t)inner * c;  // gate rows [inner, 2 inner)
  up.ldb = c;
  up.c = static_cast<bf16*>(hidden);
  up.ldc = inner;
  up.m = m;
  up.n = inner;
  up.k = c;
  up.bias = b_up;
  up.bias2 = b_up + inner;
  up.stats = st;
  up.ln_w = ln_w;
  up.ln_b = ln_b;
  e = ls_gemm::gemm(up, s);
  if (e != cudaSuccess) return (int)e;
  ls_gemm::Args down = {};
  down.a = static_cast<const bf16*>(hidden);
  down.lda = inner;
  down.b = static_cast<const bf16*>(w_down);
  down.ldb = inner;
  down.c = static_cast<bf16*>(out);
  down.ldc = c;
  down.m = m;
  down.n = c;
  down.k = inner;
  down.bias = b_down;
  down.res = residual ? xb : nullptr;
  down.ldr = c;
  return (int)ls_gemm::gemm(down, s);
}

extern "C" const char* ls_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
