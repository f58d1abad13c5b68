// K4: the spatial self-attention core over (B, S, heads * D).
// Replaces the TPU kernel latentsync_tpu/ops/temporal_attention.py
// _spatial_kernel (pallas_call at temporal_attention.py:213). Design and
// bound: see ls_attn::spatial_kernel in attention.cuh.
#include "attention.cuh"

extern "C" int ls_spatial_attention(const void* q, const void* k, const void* v, int ldq, int ldk,
                                    int ldv, void* o, int ldo, int batch, int seq, int heads, int d,
                                    float scale, void* stream) {
  return (int)ls_attn::spatial(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                               static_cast<const bf16*>(v), ldq, ldk, ldv, static_cast<bf16*>(o),
                               ldo, batch, seq, heads, d, scale,
                               static_cast<cudaStream_t>(stream));
}
