// K9: the fused q/k/v projection
//   q, k, v = x Wq^T, x Wk^T, x Wv^T     (no bias, f32 accumulation, bf16 out)
// with x (M, C) and the three weights (inner, C) in the nn.Linear layout.
// Replaces the TPU kernel latentsync_tpu/ops/ffn.py _qkv_kernel (:269,
// pallas_call at :286): one read of x, three separate (M, inner) outputs
// (no (C, 3 inner) weight relayout, no split of a fused output).
//
// Design: one launch of gemm.cuh's template with three B operands. The
// output tiles are numbered through the column tiles of q, then k, then v
// for one 128-row panel of x before the next panel, and the resident blocks
// take them in turn, so the blocks that share a panel run together: x comes
// from device memory once and from the L2 cache for the other column tiles,
// and each block writes its 128 x BN tile of one output straight from its
// accumulator fragments. wgmma from a 3-stage shared-memory ring, see
// gemm.cuh. Rows past M and columns past inner are masked; C and inner must
// be multiples of 8.
//
// Bound: at C = inner = 320 bytes, M (C + 3 inner) bf16 values moved for
// 6 M C inner FLOP, about 240 FLOP per byte, near the card's balance point;
// at C = 640 and 1280 operations.
#include "gemm.cuh"

extern "C" int ls_qkv_proj(const void* x, const void* wq, const void* wk, const void* wv, void* q,
                           void* k, void* v, int m, int c, int inner, void* stream) {
  ls_gemm::Args p = {};
  p.a = static_cast<const bf16*>(x);
  p.lda = c;
  p.b = static_cast<const bf16*>(wq);
  p.b1 = static_cast<const bf16*>(wk);
  p.b2 = static_cast<const bf16*>(wv);
  p.nb = 3;
  p.ldb = c;
  p.c = static_cast<bf16*>(q);
  p.c1 = static_cast<bf16*>(k);
  p.c2 = static_cast<bf16*>(v);
  p.ldc = inner;
  p.m = m;
  p.n = inner;
  p.k = c;
  return (int)ls_gemm::gemm(p, static_cast<cudaStream_t>(stream));
}
