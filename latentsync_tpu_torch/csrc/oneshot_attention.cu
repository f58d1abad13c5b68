// K11: one-shot (whole-row) attention over (B, S, D), B folding batch and
// heads, S a multiple of 64 up to 1024, head dims 40 and 80:
//   s = q k^T * scale (f32);  p = exp(s - max) / sum over the WHOLE row;
//   o = bf16(p) v with f32 accumulation.
// Replaces the TPU kernel latentsync_tpu/ops/attention.py _oneshot_kernel
// (:109, pallas_call at :130), which held the whole (S, S) f32 logits of
// one (batch, head) in VMEM. What makes it K11 and not K4 is where it
// rounds: the probabilities are normalised by the whole row's statistics
// BEFORE they are rounded to bf16 for the value product. A warpgroup cannot
// hold 64 x 1024 f32 logits in registers and a block that parks them in
// shared memory has an SM to itself, so the kernel sweeps the keys twice
// on the attention core of attn_core.cuh (its P_NORMALISED numerics): sweep 1
// computes q k^T and keeps only each row's maximum and sum; sweep 2
// recomputes q k^T, forms bf16(exp(s - max) / sum) in registers and feeds
// the value product. That is 6 B S^2 D tensor-core FLOP instead of 4 and
// twice the exponentials, no logit ever stored, and several blocks an SM.
// Bound: operations, as the core (the least work, 4 B S^2 D, is what the
// bound counts).
#include "attn_core.cuh"

// q, k, v, o: contiguous (bh, seq, d) bf16; seq a multiple of 64, at most 1024.
extern "C" int ls_oneshot_attention(const void* q, const void* k, const void* v, void* o, int bh,
                                    int seq, int d, float scale, void* stream) {
  if (seq % ls_core::KT != 0 || seq > 1024 || seq <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ls_core::Args a = {static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                           static_cast<const bf16*>(v), d, d, d, static_cast<bf16*>(o), d,
                           bh, seq, seq, 1, scale};
  switch (d) {
    case 40: return (int)ls_core::run<40, ls_core::P_NORMALISED>(a, 0, s);
    case 80: return (int)ls_core::run<80, ls_core::P_NORMALISED>(a, 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
