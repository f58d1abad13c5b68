// K12: streaming-softmax attention over (B, S, D), B folding batch and
// heads, D a multiple of 128, query and key lengths apart.
// Replaces the TPU kernel latentsync_tpu/ops/attention.py _flash_kernel
// (:145, pallas_call at :201), which takes q * scale, K and V blocks of
// 256 keys in f32, keeps a running max and sum, never rounds the
// probabilities and divides the accumulator by the row sum at the end.
//
// The attention core of attn_core.cuh in its P_SPLIT numerics: the tensor
// cores take bf16, so each f32 probability goes to them as three bf16 terms
// whose sum is the f32 value, and the value product runs once a term into
// one f32 accumulator: nothing is rounded where the TPU kernel did not
// round (bf16 q, k and v are exact in f32 already). D = 128 is one more head
// dim of the core's row tiling (wgmma m64n128k16 for the value product);
// D = 512 runs its column-split tiling. The TPU's block_q / block_k were
// VMEM tile sizes; the wrapper only holds the shapes to their tiling rule.
//
// Bound: operations. At (64, 1024, 512) the products are 4 B S^2 D =
// 137 GFLOP on the tensor cores, which is what the bound counts; the split
// makes the value product three, so the kernel does 8 B S^2 D.
#include "attn_core.cuh"

// q, o: contiguous (batch, seq_q, d) bf16; k, v: contiguous (batch, seq_k, d)
extern "C" int ls_flash_kernel(const void* q, const void* k, const void* v, void* o, int batch,
                               int seq_q, int seq_k, int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ls_core::Args a = {static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                           static_cast<const bf16*>(v), d, d, d, static_cast<bf16*>(o), d,
                           batch, seq_q, seq_k, 1, scale};
  switch (d) {
    // 64 query rows a block: at 216 registers a thread two such blocks share
    // an SM and drift apart, where two warpgroups of one block meet at every
    // tile's barrier and run the same phase at the same time (0.99 against
    // 1.12 ms at (512, 1024, 128) on an NVIDIA H100 80GB HBM3 at 700.00 W,
    // though K and V then come from L2 twice as often)
    case 128: return (int)ls_core::launch<128, 1, ls_core::P_SPLIT>(a, s);
    case 512: return (int)ls_core::run_wide<512, ls_core::P_SPLIT>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
