"""Every kernel wrapper's plain version, on any device, for the duration of
a ``with plain_kernels():`` block.

The wrappers launch their hand kernels on a CUDA tensor; inside the block
the module-level launchers of K1-K5, K8 and the flash route (forward and
backward) run their plain torch compositions instead, on the card or on the
``meta`` device. The ``autograd.Function``s and their composed or
straight-through backwards stay. ``torch.utils.flop_counter.FlopCounterMode``
cannot see a ctypes launch, so counting a model's operations goes through
this block (``scripts/perf_probe.py``); the plain versions compute the same
products as the kernels.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def plain_kernels():
    from . import attention, attn_block, ffn, qconv, qmm
    from . import temporal_attention as ta

    def k1(x, w_up, b_up, w_down, b_down, ln_scale, ln_bias, residual, eps):
        return ffn.geglu_ffn_reference(x, w_up, b_up, w_down, b_down, ln_scale, ln_bias,
                                       residual, eps)

    def flash_forward(q, k, v, scale, with_lse=False):
        o = attention.dot_product_attention_reference(q, k, v, scale)
        return (o, None) if with_lse else o

    def flash_backward(q, k, v, grad, scale, o=None, lse=None):
        return attention.flash_attention_bwd_reference(q, k, v, grad, scale)

    patches = [(ffn, "_geglu_ffn_kernel", k1),
               (attn_block, "self_attention_block_fused",
                attn_block.self_attention_block_reference),
               (ta, "_temporal_kernel", ta.temporal_attention_reference),
               (ta, "_spatial_kernel", lambda q, k, v, heads, scale, block_q:
                ta.spatial_attention_reference(q, k, v, heads, scale)),
               (attention, "_flash_forward", flash_forward),
               (attention, "flash_attention_bwd", flash_backward),
               (attn_block, "cross_attention_block_fused",
                attn_block.cross_attention_block_reference),
               (qconv, "quantized_matmul", qmm.quantized_matmul_reference)]
    old = [(m, n, getattr(m, n)) for m, n, _ in patches]
    for m, n, fn in patches:
        setattr(m, n, fn)
    try:
        yield
    finally:
        for m, n, fn in old:
            setattr(m, n, fn)
