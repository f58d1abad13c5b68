// K2: the fused self-attention block
//   out = x + Wo . SelfAttn(QKV(LN(x) [+ pe])) + bo
// Replaces the TPU kernel latentsync_tpu/ops/attn_block.py _kernel
// (pallas_call at attn_block.py:238), in both its temporal mode (16-frame
// sequences, positional encoding added after the LN) and its spatial mode.
//
// Temporal mode (ls_temporal_block, 1 <= F <= 24 frames a sequence): one
// launch that keeps LN(x), q/k/v and
// the attention output on chip, as the TPU kernel kept them in VMEM; at head
// dim 80 (C = 640) the attention output goes to the scratch `attn` and the
// output product to the GEMM template (design, traffic and bound:
// temporal_block.cuh).
//
// Spatial mode (ls_attn_block): a chain of four launches on one stream: the
// LayerNorm row pass (bf16(LN(x)) written once to a scratch buffer), ONE
// q/k/v projection of it against the three weights (the template's
// three-operand launch, outputs at pitch 3 inner in one buffer), the
// spatial core (attn_core.cuh, at head dims 40 and 80, named apart from K4's
// in a profile) reading q/k/v as column slices of that buffer, and the
// output projection with bias and residual epilogue.
// Bound: the projections (wgmma behind a shared-memory ring) and the core
// are tensor-core bound (the core's exponentials first at D = 40).
#include "attention.cuh"
#include "temporal_block.cuh"

extern "C" int ls_temporal_block(const void* x, int batch, int frames, int c, int inner,
                                 int heads, const float* ln_w, const float* ln_b, float eps,
                                 const void* pe, const void* wq, const void* wk, const void* wv,
                                 const void* wo, const float* bo, float scale, void* attn,
                                 void* out, void* stream) {
  return (int)ls_tblock::temporal_block(x, batch, frames, c, inner, heads, ln_w, ln_b, eps, pe,
                                         wq, wk, wv, wo, bo, scale, attn, out,
                                         static_cast<cudaStream_t>(stream));
}

// The widest C that K2 takes at head dim d, in temporal mode or not (0: no
// kernel): what the wrapper checks before it allocates and launches.
extern "C" int ls_attn_block_max_c(int temporal, int d) {
  if (temporal) return ls_tblock::max_c(d);
  return ls_attn::k2_spatial_takes(d) ? 0x7fffffff : 0;
}

extern "C" int ls_attn_block(const void* x, int batch, int seq, int c, int inner, int heads,
                             const float* ln_w, const float* ln_b, float eps, const void* wq,
                             const void* wk, const void* wv, const void* w_o, const float* b_o,
                             float scale, void* normed, void* qkv, void* attn, void* out,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = batch * seq;
  const int d = inner / heads;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* nb = static_cast<bf16*>(normed);
  bf16* qkvb = static_cast<bf16*>(qkv);
  bf16* ob = static_cast<bf16*>(attn);
  cudaError_t e = ls_gemm::ln_rows(xb, m, c, c, eps, ln_w, ln_b, nb, s);
  if (e != cudaSuccess) return (int)e;
  const int ld = 3 * inner;
  ls_gemm::Args proj = {};
  proj.a = nb;
  proj.lda = c;
  proj.b = wq;
  proj.b1 = wk;
  proj.b2 = wv;
  proj.nb = 3;
  proj.ldb = c;
  proj.c = qkvb;
  proj.c1 = qkvb + inner;
  proj.c2 = qkvb + 2 * inner;
  proj.ldc = ld;
  proj.m = m;
  proj.n = inner;
  proj.k = c;
  e = ls_gemm::gemm(proj, s);
  if (e != cudaSuccess) return (int)e;
  e = ls_attn::spatial_k2(qkvb, qkvb + inner, qkvb + 2 * inner, ld, ld, ld, ob, inner, batch,
                          seq, heads, d, scale, s);
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
