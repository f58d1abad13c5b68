"""The VAE mid-block attention core (the flash route): one head over the
H·W positions. Operations: the two attention products, 4·B·H·Sq·Sk·D."""

from lsbench.counts import nbytes, precision

TARGETS = ["latentsync_tpu_torch.models.vae:dot_product_attention"]


def count(q, k, v, scale=None, mask=None):
    *lead, sq, h, d = q.shape
    b = 1
    for n in lead:
        b *= n
    ops = 4 * b * h * sq * k.shape[-3] * d
    return ops, nbytes(q, k, v) + nbytes(q), precision(q)
