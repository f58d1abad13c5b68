"""K2's operation (with K3 / K4 where the block runs composed): the
self-attention block x + W_o·Attn(W_q h, W_k h, W_v h) with h = LN(x)
[+ positions], spatial over S = H·W positions of a frame or temporal
over the F frames of a position. Operations: the four projections,
2·B·S·C·inner·4, and the two attention products, 4·B·S²·inner."""

from lsbench.counts import nbytes, precision

TARGETS = ["latentsync_tpu_torch.models.unet3d:self_attention_block"]


def count(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, heads, temporal=False, pe=None, eps=1e-6):
    b, s, c = x.shape
    inner = wq.shape[0]
    ops = 2 * b * s * c * inner * 4 + 4 * b * s * s * inner
    moved = 2 * nbytes(x) + nbytes(ln_scale, ln_bias, wq, wk, wv, wo, bo, pe)
    return ops, moved, precision(x)
