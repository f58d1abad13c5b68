// Flash attention over (B, S, H, D): the route of dot_product_attention
// for unmasked 4-D self-attention with S >= 256 and S % 128 == 0. On the
// serving path that is the VAE mid-block (S = 1024, one head, D = 512);
// the kernel probe sends it the UNet's spatial shapes, 8 heads of D = 40
// and D = 80; CodeFormer's transformer (models/codeformer.py) 8 heads of
// D = 64 over its 256 latent tokens, nine times a forward.
// Replaces jax's library TPU flash kernel as the reference routes to it:
// latentsync_tpu/ops/attention.py _flash_bshd (:85, routed at :51-59).
//
// The attention core of attn_core.cuh with its online softmax and the
// probabilities rounded to bf16 before the value product, as the plain
// dot_product_attention rounds them: both products on wgmma, logits and
// probabilities in registers, K/V tiles behind a cp.async ring. (B, S, H, D)
// through a row pitch is the core's (rows, heads * D) layout, so head dims 40
// and 80 run as K4 does, and D = 64 on the same row tiling with its K and V
// rows one 128-byte swizzle atom each (attn_core.cuh Tile::SW); D = 512 runs
// the core's column-split tiling (a block's two warpgroups own 256 output
// columns each). A head dim with no instantiation below is refused. Bound:
// operations (attn_core.cuh); at CodeFormer's shapes, bytes, and there the
// 16 or 64 blocks of a call leave most SMs idle (PERF.md section 6).
//
// Under grad the route launches ls_flash_attention_lse instead: the same
// kernels instantiated with the core's LSE parameter, which also write each
// row's base-2 log-sum-exp, the residual of the backward
// (flash_attention_bwd.cu), as jax's forward keeps l and m when asked for
// residuals (flash_attention.py:246-251). D = 64 has no backward yet and so
// no such instantiation: the wrapper refuses it under grad.
#include "attn_core.cuh"

namespace {

template <bool LSE>
int flash(const void* q, const void* k, const void* v, int ldq, int ldk, int ldv, void* o,
          int batch, int seq, int heads, int d, float scale, void* lse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ls_core::Args a = {static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                           static_cast<const bf16*>(v), ldq, ldk, ldv, static_cast<bf16*>(o),
                           heads * d, batch, seq, seq, heads, scale, static_cast<float*>(lse)};
  switch (d) {
    case 40: return (int)ls_core::run<40, ls_core::P_ROUNDED, void, LSE>(a, 0, s);
    case 64:
      if constexpr (LSE) return (int)cudaErrorInvalidValue;
      else return (int)ls_core::run<64, ls_core::P_ROUNDED>(a, 0, s);
    case 80: return (int)ls_core::run<80, ls_core::P_ROUNDED, void, LSE>(a, 0, s);
    case 512: return (int)ls_core::run_wide<512, ls_core::P_ROUNDED, LSE>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: (batch, seq, heads, d) bf16 with row pitches ldq, ldk, ldv (a
// batch entry seq rows on, a head d columns on); o contiguous.
extern "C" int ls_flash_attention(const void* q, const void* k, const void* v, int ldq, int ldk,
                                  int ldv, void* o, int batch, int seq, int heads, int d,
                                  float scale, void* stream) {
  return flash<false>(q, k, v, ldq, ldk, ldv, o, batch, seq, heads, d, scale, nullptr, stream);
}

// The same, also writing lse: (batch, heads, seq) f32, base 2.
extern "C" int ls_flash_attention_lse(const void* q, const void* k, const void* v, int ldq,
                                      int ldk, int ldv, void* o, int batch, int seq, int heads,
                                      int d, float scale, void* lse, void* stream) {
  return flash<true>(q, k, v, ldq, ldk, ldv, o, batch, seq, heads, d, scale, lse, stream);
}
