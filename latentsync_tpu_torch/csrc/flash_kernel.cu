// K12: streaming-softmax attention over (B, S, D), B folding batch and
// heads, D a multiple of 128.
// Replaces the TPU kernel latentsync_tpu/ops/attention.py _flash_kernel
// (:145, pallas_call at :201), which takes q * scale, K and V blocks of
// 256 keys in f32, keeps a running max and sum, never rounds the
// probabilities and divides the accumulator by the row sum at the end.
//
// The core is flash.cuh with EXACT = true (one head, contiguous rows):
// each f32 probability goes to the tensor cores as three bf16 terms whose
// sum is the f32 value, so nothing is rounded where the TPU kernel did not
// round. The TPU's block_q / block_k were VMEM tile sizes; here a block
// owns 32 query rows and streams keys 64 at a time, and the wrapper only
// holds the shapes to the TPU kernel's tiling rule.
//
// Bound: operations. At (64, 1024, 512) the products are 4 B S^2 D =
// 137 GFLOP on the tensor cores (the value product runs three times for
// the split), against 268 MB of q, k, v and o.
#include "flash.cuh"

extern "C" int ls_flash_kernel(const void* q, const void* k, const void* v, void* o, int batch,
                               int seq_q, int seq_k, int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  const long qb = (long)seq_q * d, kb = (long)seq_k * d;
#define LS_FLASH_CASE(D)                                                                       \
  case D:                                                                                      \
    return (int)ls_flash::launch<D, D, true>(qp, kp, vp, qb, D, 0, kb, D, 0, kb, D, 0, op,     \
                                             batch, seq_q, seq_k, 1, scale, s)
  switch (d) {
    LS_FLASH_CASE(128);
    LS_FLASH_CASE(512);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LS_FLASH_CASE
}
