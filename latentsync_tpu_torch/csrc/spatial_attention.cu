// K4: the spatial self-attention core over (B, S, heads * D), head dims 40,
// 80 and 160. Replaces the TPU kernel latentsync_tpu/ops/
// temporal_attention.py _spatial_kernel (pallas_call at
// temporal_attention.py:213), which held one head's whole (S, S) logits in
// VMEM. Here the softmax is online, in f32, over tiles of 64 keys, on the
// attention core of attn_core.cuh: both products on the tensor cores
// (wgmma), logits and probabilities in registers, K/V tiles through a
// cp.async ring. Bound: operations (the exponentials before the tensor
// cores at D = 40); see attn_core.cuh.
#include "attention.cuh"
#include "attn_core.cuh"

namespace ls_attn {

cudaError_t spatial(const bf16* q, const bf16* k, const bf16* v, int ldq, int ldk, int ldv,
                    bf16* o, int ldo, int batch, int seq, int heads, int d, float scale,
                    cudaStream_t s, int block_q) {
  const ls_core::Args a = {q, k, v, ldq, ldk, ldv, o, ldo, batch, seq, seq, heads, scale};
  switch (d) {
    case 40: return ls_core::run<40, ls_core::P_ROUNDED>(a, block_q, s);
    case 80: return ls_core::run<80, ls_core::P_ROUNDED>(a, block_q, s);
    case 160: return ls_core::run<160, ls_core::P_ROUNDED>(a, block_q, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t spatial_k2(const bf16* q, const bf16* k, const bf16* v, int ldq, int ldk, int ldv,
                       bf16* o, int ldo, int batch, int seq, int heads, int d, float scale,
                       cudaStream_t s) {
  const ls_core::Args a = {q, k, v, ldq, ldk, ldv, o, ldo, batch, seq, seq, heads, scale};
  static_assert(k2_spatial_takes(40) && k2_spatial_takes(80), "the cases below");
  switch (d) {
    case 40: return ls_core::run<40, ls_core::P_ROUNDED, k2_spatial_core>(a, 0, s);
    case 80: return ls_core::run<80, ls_core::P_ROUNDED, k2_spatial_core>(a, 0, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ls_attn

extern "C" int ls_spatial_attention(const void* q, const void* k, const void* v, int ldq, int ldk,
                                    int ldv, void* o, int ldo, int batch, int seq, int heads, int d,
                                    float scale, int block_q, void* stream) {
  return (int)ls_attn::spatial(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                               static_cast<const bf16*>(v), ldq, ldk, ldv, static_cast<bf16*>(o),
                               ldo, batch, seq, heads, d, scale,
                               static_cast<cudaStream_t>(stream), block_q);
}
