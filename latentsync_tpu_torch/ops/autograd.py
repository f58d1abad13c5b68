"""Gradients through the hand kernels.

The JAX package gives each Pallas kernel on the training path a
``jax.custom_vjp`` whose backward differentiates the kernel's *composed*
lowering (``ops/ffn.py:208-224``, ``ops/attn_block.py:258-274``,
``ops/temporal_attention.py:115-125``, ``:225-235``): the forward keeps
only its inputs, and the backward recomputes the composition and takes
its VJP. :func:`with_composed_grad` is that rule as a
``torch.autograd.Function``: its forward is the kernel on a CUDA tensor
and the plain version on a CPU tensor (whatever `forward` does), its
backward recomputes `composed` on the saved inputs under
``torch.enable_grad()`` and returns ``torch.autograd.grad`` of it. The
wrappers of K1 (``ffn.geglu_ffn``), K2 (``attn_block.self_attention_block``),
K3 and K4 (``temporal_attention``) go through it on both devices, so the
CPU tests reach the backward. The flash route of
``attention.dot_product_attention`` has a backward kernel of its own
(``csrc/flash_attention_bwd.cu``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


class _ComposedGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, forward: Callable, composed: Callable, *inputs: Optional[torch.Tensor]):
        ctx.composed = composed
        ctx.save_for_backward(*inputs)
        return forward(*inputs)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, needs)]
            out = ctx.composed(*leaves)
            wrt = [t for t, n in zip(leaves, needs) if n]
            grads = iter(torch.autograd.grad(out, wrt, grad, allow_unused=True))
        return (None, None, *(next(grads) if n else None for n in needs))


def with_composed_grad(forward: Callable, composed: Callable,
                       *inputs: Optional[torch.Tensor]) -> torch.Tensor:
    """`forward(*inputs)`, differentiated as `composed(*inputs)` is. Both
    take the same positional tensors (None where an optional one is
    absent); anything else they need is bound in the callables."""
    return _ComposedGrad.apply(forward, composed, *inputs)
