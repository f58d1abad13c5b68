"""K1's operation: the GEGLU feed-forward of every transformer and motion
block, x + W_down(value · GELU(gate)) with (value, gate) = W_up(LN(x)).
Operations: the two products, 2·M·C·8C + 2·M·4C·C."""

from lsbench.counts import nbytes, precision

TARGETS = ["latentsync_tpu_torch.models.unet3d:geglu_ffn"]


def count(x, w_up, b_up, w_down, b_down, ln_scale=None, ln_bias=None, residual=False,
          eps=1e-6):
    c = x.shape[-1]
    m = x.numel() // c
    inner = w_down.shape[1]
    ops = 2 * m * c * 2 * inner + 2 * m * inner * c
    return ops, 2 * nbytes(x) + nbytes(w_up, b_up, w_down, b_down, ln_scale, ln_bias), precision(x)
