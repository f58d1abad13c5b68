"""Gradients through the hand kernels.

The JAX package gives each Pallas kernel on the training path a
``jax.custom_vjp`` whose backward differentiates the kernel's *composed*
lowering (``ops/ffn.py:208-224``, ``:278-311``, ``ops/attn_block.py:258-274``,
``:388-404``, ``ops/temporal_attention.py:115-125``, ``:225-235``): the
forward keeps only its inputs, and the backward recomputes the composition
and takes its VJP. :func:`with_composed_grad` is that rule as a
``torch.autograd.Function``: its forward is the kernel on a CUDA tensor
and the plain version on a CPU tensor (whatever `forward` does), its
backward recomputes `composed` on the saved inputs under
``torch.enable_grad()`` and returns ``torch.autograd.grad`` of it. Either
may return one tensor or a tuple of them (K9's q, k, v); an output that
nothing used gets no gradient. The wrappers of K1 (``ffn.geglu_ffn``), K2
(``attn_block.self_attention_block``), K3 and K4 (``temporal_attention``),
K5 (``attn_block.cross_attention_block``) and K9 (``ffn.qkv_proj``) go
through it on both devices, so the CPU tests reach the backward. The
int8 routes' straight-through rules (``ops/qconv.py``) are the same
Function with the float product as the composition. The flash route of
``attention.dot_product_attention`` has a backward kernel of its own
(``csrc/flash_attention_bwd.cu``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


class ComposedGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, forward: Callable, composed: Callable, *inputs: Optional[torch.Tensor]):
        ctx.composed = composed
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)
        return forward(*inputs)

    @staticmethod
    def backward(ctx, *grads: Optional[torch.Tensor]):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, needs)]
            outs = ctx.composed(*leaves)
            outs = outs if isinstance(outs, tuple) else (outs,)
            used = [(o, g) for o, g in zip(outs, grads) if g is not None]
            wrt = [t for t, n in zip(leaves, needs) if n]
            grads_in = iter(torch.autograd.grad([o for o, _ in used], wrt,
                                                [g for _, g in used], allow_unused=True)
                            if used and wrt else [None] * len(wrt))
        return (None, None, *(next(grads_in) if n else None for n in needs))


def with_composed_grad(forward: Callable, composed: Callable, *inputs: Optional[torch.Tensor]):
    """`forward(*inputs)`, differentiated as `composed(*inputs)` is. Both
    take the same positional tensors (None where an optional one is
    absent) and return a tensor or a tuple of tensors; anything else they
    need is bound in the callables."""
    return ComposedGrad.apply(forward, composed, *inputs)
