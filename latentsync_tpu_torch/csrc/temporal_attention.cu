// K3: the temporal attention core over (B, F = 16, heads * D).
// Replaces the TPU kernel latentsync_tpu/ops/temporal_attention.py _kernel
// (pallas_call at temporal_attention.py:101). Design and bound: see
// ls_attn::temporal_kernel in attention.cuh.
#include "attention.cuh"

extern "C" int ls_temporal_attention(const void* q, const void* k, const void* v, int ldq, int ldk,
                                     int ldv, void* o, int ldo, int batch, int heads, int d,
                                     float scale, void* stream) {
  return (int)ls_attn::temporal(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                static_cast<const bf16*>(v), ldq, ldk, ldv, static_cast<bf16*>(o),
                                ldo, batch, heads, d, scale, static_cast<cudaStream_t>(stream));
}
