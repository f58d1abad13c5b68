"""The audio cross-attention block: x + W_o·Attn(W_q LN(x), W_k a, W_v a)
over the 50 whisper positions a of the frame. Operations: the query and
output projections 2·B·S·C·inner·2, the key and value projections
2·B·Sk·Cc·inner·2, the attention products 4·B·S·Sk·inner."""

from lsbench.counts import nbytes, precision

TARGETS = ["latentsync_tpu_torch.models.unet3d:cross_attention_block"]


def count(x, ln_scale, ln_bias, ctx, wq, wk, wv, wo, bo, heads, eps=1e-6):
    b, s, c = x.shape
    sk, cc = ctx.shape[1], ctx.shape[2]
    inner = wq.shape[0]
    ops = 4 * b * s * c * inner + 4 * b * sk * cc * inner + 4 * b * s * sk * inner
    moved = 2 * nbytes(x) + nbytes(ctx, ln_scale, ln_bias, wq, wk, wv, wo, bo)
    return ops, moved, precision(x)
