// K2: the fused self-attention block
//   out = x + Wo . SelfAttn(QKV(LN(x) [+ pe])) + bo
// Replaces the TPU kernel latentsync_tpu/ops/attn_block.py _kernel
// (pallas_call at attn_block.py:238), in both its temporal mode (16-frame
// sequences, positional encoding added after the LN) and its spatial mode.
// On the TPU one program kept LN(x), q/k/v and the attention output in
// VMEM; here it is a chain of four launches on one stream: LayerNorm row
// statistics, ONE q/k/v projection against the concatenated (3 inner, C)
// weight with the LN (+PE) prologue, the attention core reading q/k/v as
// column slices of that (M, 3 inner) buffer, and the output projection
// with bias and residual epilogue. LN(x) never reaches device memory.
// Bound: the projections are tensor-core bound, the temporal core memory
// bound and the spatial core FMA bound (see gemm.cuh, attention.cuh).
#include "attention.cuh"
#include "gemm.cuh"

extern "C" int ls_attn_block(const void* x, int batch, int seq, int c, int inner, int heads,
                             int temporal, const float* ln_w, const float* ln_b, float eps,
                             const void* pe, const void* w_qkv, const void* w_o, const float* b_o,
                             float scale, void* stats, void* qkv, void* attn, void* out,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = batch * seq;
  const int d = inner / heads;
  const bf16* xb = static_cast<const bf16*>(x);
  float2* st = static_cast<float2*>(stats);
  bf16* qkvb = static_cast<bf16*>(qkv);
  bf16* ob = static_cast<bf16*>(attn);
  cudaError_t e = ls_gemm::row_stats(xb, m, c, c, eps, st, s);
  if (e != cudaSuccess) return (int)e;
  ls_gemm::Args proj = {};
  proj.a = xb;
  proj.lda = c;
  proj.b = static_cast<const bf16*>(w_qkv);
  proj.ldb = c;
  proj.c = qkvb;
  proj.ldc = 3 * inner;
  proj.m = m;
  proj.n = 3 * inner;
  proj.k = c;
  proj.stats = st;
  proj.ln_w = ln_w;
  proj.ln_b = ln_b;
  proj.pe = static_cast<const bf16*>(pe);
  proj.pe_rows = seq;
  e = ls_gemm::gemm(proj, s);
  if (e != cudaSuccess) return (int)e;
  const int ld = 3 * inner;
  if (temporal) {
    if (seq != ls_attn::TF) return (int)cudaErrorInvalidValue;
    e = ls_attn::temporal(qkvb, qkvb + inner, qkvb + 2 * inner, ld, ld, ld, ob, inner, batch,
                          heads, d, scale, s);
  } else {
    e = ls_attn::spatial(qkvb, qkvb + inner, qkvb + 2 * inner, ld, ld, ld, ob, inner, batch, seq,
                         heads, d, scale, s);
  }
  if (e != cudaSuccess) return (int)e;
  ls_gemm::Args o = {};
  o.a = ob;
  o.lda = inner;
  o.b = static_cast<const bf16*>(w_o);
  o.ldb = inner;
  o.c = static_cast<bf16*>(out);
  o.ldc = c;
  o.m = m;
  o.n = c;
  o.k = inner;
  o.bias = b_o;
  o.res = xb;
  o.ldr = c;
  return (int)ls_gemm::gemm(o, s);
}
