"""The whisper encoder's self-attention core (float32), 6 heads over the
1500 positions of a 30 s segment. Operations: 4·B·H·S²·D."""

from lsbench.counts import nbytes, precision

TARGETS = ["latentsync_tpu_torch.models.whisper:dot_product_attention"]


def count(q, k, v, scale=None, mask=None):
    *lead, sq, h, d = q.shape
    b = 1
    for n in lead:
        b *= n
    ops = 4 * b * h * sq * k.shape[-3] * d
    return ops, nbytes(q, k, v) + nbytes(q), precision(q)
