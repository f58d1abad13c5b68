// Flash attention over (B, S, H, D): the route of dot_product_attention
// for unmasked 4-D self-attention with S >= 256 and S % 128 == 0. On the
// serving path that is the VAE mid-block (S = 1024, one head, D = 512);
// the kernel probe sends it the UNet's spatial shapes, 8 heads of D = 40
// and D = 80.
// Replaces jax's library TPU flash kernel as the reference routes to it:
// latentsync_tpu/ops/attention.py _flash_bshd (:85, routed at :51-59).
//
// The core is flash.cuh with EXACT = false: probabilities rounded to bf16
// before the value product, as the plain dot_product_attention rounds
// them. Head dims 40 and 80 are no multiple of the MMA's 16-deep k-step
// and run zero-padded in shared memory to 64 and 128 columns (flash.cuh);
// a head dim with no instantiation below is refused.
#include "flash.cuh"

extern "C" int ls_flash_attention(const void* q, const void* k, const void* v, long long qb,
                                  long long qs, long long qh, long long kb, long long ks,
                                  long long kh, long long vb, long long vs, long long vh, void* o,
                                  int batch, int seq, int heads, int d, float scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
#define LS_FLASH_CASE(D, DP)                                                                     \
  case D:                                                                                        \
    return (int)ls_flash::launch<D, DP, false>(qp, kp, vp, qb, qs, qh, kb, ks, kh, vb, vs, vh,   \
                                               op, batch, seq, seq, heads, scale, s)
  switch (d) {
    LS_FLASH_CASE(40, 64);
    LS_FLASH_CASE(80, 128);
    LS_FLASH_CASE(512, 512);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LS_FLASH_CASE
}
