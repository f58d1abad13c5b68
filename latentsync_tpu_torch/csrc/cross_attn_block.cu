// K5: the audio cross-attention block
//   out = x + Wo . Attn(Q(LN(x)), K(ctx), V(ctx)) + bo
// Replaces the TPU kernel latentsync_tpu/ops/attn_block.py _cross_kernel
// (pallas_call at attn_block.py:370). On the TPU one program kept LN(x),
// q/k/v and the attention output in VMEM; here it is a chain of five
// launches on one stream, reusing the GEMM template of gemm.cuh:
//   1. the LayerNorm row pass: bf16(LN(x)) written once to a scratch buffer;
//   2. q = bf16(LN(x)) Wq^T;
//   3. [k | v] = ctx [Wk; Wv]^T, one product on the raw context;
//   4. the attention core below;
//   5. out = x + o Wo^T + bo, bias and residual added to the f32
//      accumulator before the one rounding to bf16.
// Rounding points follow _cross_kernel: LN(x), q, k, v, the probabilities
// and the attention output are bf16; logits, softmax and sums are f32.
//
// The core is the attention core of attn_core.cuh with K11's numerics
// (P_NORMALISED): each row's maximum and sum over all its keys first, then
// bf16(exp(s - max) / sum) into the value product, the plain version's
// rounding. The Sk = 50 audio keys are one 64-key tile, masked past Sk; k and
// v are read in place from the [k | v] projection (row pitch 2 * inner, v
// starting inner columns on), q and the output at pitch inner, one (batch,
// head) of 64 or 128 query rows a block, d = 40 or 80 zero-padded to the
// 16-deep k-step. Both products run on the tensor cores (wgmma) and no logit
// leaves the registers.
// Bound: the three GEMMs (K = 320 or 640, and 384 for [k | v]) are bound by
// their traffic from L2 at these K (see gemm.cuh). The core moves q in and o
// out (2 * B * S * inner * 2 bytes: 84 MB at (64, 1024, 320)) for 4 B S Sk
// inner FLOP, so its bound is bytes (~0.025 ms there); the key tile's two
// sweeps recompute q k^T once, a third of the core's tensor work.
#include "attn_core.cuh"
#include "gemm.cuh"

namespace {

cudaError_t cross_core(const bf16* q, const bf16* kv, bf16* o, int batch, int seq, int sk,
                       int heads, int d, float scale, cudaStream_t s) {
  const int inner = heads * d;
  const ls_core::Args a = {q, kv, kv + inner, inner, 2 * inner, 2 * inner, o, inner,
                           batch, seq, sk, heads, scale};
  switch (d) {
    case 40: return ls_core::run<40, ls_core::P_NORMALISED>(a, 0, s);
    case 80: return ls_core::run<80, ls_core::P_NORMALISED>(a, 0, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int ls_cross_attn_block(const void* x, const void* ctx, int batch, int seq, int c,
                                   int sk, int cc, int inner, int heads, const float* ln_w,
                                   const float* ln_b, float eps, const void* w_q,
                                   const void* w_kv, const void* w_o, const float* b_o,
                                   float scale, void* normed, void* q, void* kv, void* attn,
                                   void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = batch * seq;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* nb = static_cast<bf16*>(normed);
  bf16* qb = static_cast<bf16*>(q);
  bf16* kvb = static_cast<bf16*>(kv);
  bf16* ob = static_cast<bf16*>(attn);
  cudaError_t e = ls_gemm::ln_rows(xb, m, c, c, eps, ln_w, ln_b, nb, s);
  if (e != cudaSuccess) return (int)e;

  ls_gemm::Args pq = {};
  pq.a = nb;
  pq.lda = c;
  pq.b = static_cast<const bf16*>(w_q);
  pq.ldb = c;
  pq.c = qb;
  pq.ldc = inner;
  pq.m = m;
  pq.n = inner;
  pq.k = c;
  e = ls_gemm::gemm(pq, s);
  if (e != cudaSuccess) return (int)e;

  ls_gemm::Args pkv = {};
  pkv.a = static_cast<const bf16*>(ctx);
  pkv.lda = cc;
  pkv.b = static_cast<const bf16*>(w_kv);
  pkv.ldb = cc;
  pkv.c = kvb;
  pkv.ldc = 2 * inner;
  pkv.m = batch * sk;
  pkv.n = 2 * inner;
  pkv.k = cc;
  e = ls_gemm::gemm(pkv, s);
  if (e != cudaSuccess) return (int)e;

  e = cross_core(qb, kvb, ob, batch, seq, sk, heads, inner / heads, scale, s);
  if (e != cudaSuccess) return (int)e;

  ls_gemm::Args po = {};
  po.a = ob;
  po.lda = inner;
  po.b = static_cast<const bf16*>(w_o);
  po.ldb = inner;
  po.c = static_cast<bf16*>(out);
  po.ldc = c;
  po.m = m;
  po.n = c;
  po.k = inner;
  po.bias = b_o;
  po.res = xb;
  po.ldr = c;
  return (int)ls_gemm::gemm(po, s);
}
