// Attention cores for the UNet's self-attention: the temporal core (16
// frames per sequence) and the spatial core (S tokens per frame), each
// defined in its own source.
//
// Both read q/k/v in the model's (rows, heads * D) layout through a row
// pitch, so they take either separate q/k/v tensors or column slices of
// one fused (rows, 3 * inner) projection, and write o as (rows, inner).
// Softmax statistics and every sum are f32; inputs and outputs are bf16.
#pragma once

#include "common.cuh"

namespace ls_attn {

// ---------------------------------------------------------------------------
// Temporal core (K3). Replaces the TPU kernel latentsync_tpu/ops/
// temporal_attention.py _kernel (frame-major (F, heads) fold + block-
// diagonal mask). Defined once, in temporal_attention.cu, on mma.sync
// behind a cp.async ring (design and bound there). F = 16; any D % 8 == 0
// whose ring fits shared memory.
// ---------------------------------------------------------------------------

cudaError_t temporal(const bf16* q, const bf16* k, const bf16* v, int ldq, int ldk, int ldv,
                     bf16* o, int ldo, int batch, int heads, int d, float scale,
                     cudaStream_t s);

// ---------------------------------------------------------------------------
// Spatial core (K4). Replaces the TPU kernel latentsync_tpu/ops/
// temporal_attention.py _spatial_kernel (heads sliced on lanes, whole
// (S, S) logits per head in VMEM) and the attention part of
// latentsync_tpu/ops/attn_block.py _kernel in spatial mode. Head dims 40,
// 80 and 160, any S >= 1. Defined once, in spatial_attention.cu, on the
// tensor-core attention core of attn_core.cuh (design and bound there);
// block_q picks the query rows a block (64 or 128; 0: by S).
// ---------------------------------------------------------------------------

cudaError_t spatial(const bf16* q, const bf16* k, const bf16* v, int ldq, int ldk, int ldv,
                    bf16* o, int ldo, int batch, int seq, int heads, int d, float scale,
                    cudaStream_t s, int block_q = 0);

// K2's spatial mode: the same core at head dims 40 and 80 (block_q by S),
// its kernels named apart (attn_kernel<..., ls_attn::k2_spatial_core>) so
// that a profile tells them from K4's.
struct k2_spatial_core;
constexpr bool k2_spatial_takes(int d) { return d == 40 || d == 80; }
cudaError_t spatial_k2(const bf16* q, const bf16* k, const bf16* v, int ldq, int ldk, int ldv,
                       bf16* o, int ldo, int batch, int seq, int heads, int d, float scale,
                       cudaStream_t s);

}  // namespace ls_attn
