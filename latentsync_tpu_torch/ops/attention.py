"""Multi-head scaled-dot-product attention, routed like the reference.

Counterpart of ``latentsync_tpu/ops/attention.py``
``dot_product_attention``: (..., S, H, D) layout, f32 logits and softmax
whatever the input dtype, probabilities rounded to the input dtype
before the value product.

``dot_product_attention`` routes exactly as the reference does
(``attention.py:51-57``): unmasked 4-D self-attention with S ≥ 256 and
S a multiple of 128 — on the serving path the VAE mid-block (S = 1024,
one head, D = 512), where the TPU ran jax's library flash kernel, and
from the kernel probe the UNet's spatial shapes (8 heads of D = 40 and
80) — launches the hand-written flash kernel of
``csrc/flash_attention.cu`` on a CUDA tensor. Everything else (whisper's
S = 1500, the audio cross-attention with Sk = 50) and every CPU tensor
runs the plain ``dot_product_attention_reference``, which is also what
the plain versions of the other attention ops call.

Two more kernels of the reference live here, in its (B, S, D) layout with
B folding batch and heads; only the kernel probe calls them:

- ``oneshot_attention`` (K11, ``csrc/oneshot_attention.cu``): whole-row
  attention for S ≤ 1024, exact max / exp / divide softmax, the
  probabilities rounded to the input dtype before the value product;
- ``flash_attention`` (K12, ``csrc/flash_kernel.cu``): streaming-softmax
  attention for D a multiple of 128 whose probabilities are never
  rounded. Nothing in the reference calls it, so nothing here does.

Each plain version rounds where its own kernel rounds.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

# head dims the flash route's kernel is instantiated for: the UNet's
# spatial attention at C = 320 and 640 (8 heads) and the VAE mid-block's
FLASH_HEAD_DIMS = (40, 80, 512)
ONESHOT_HEAD_DIMS = (40, 80)
ONESHOT_MAX_SEQ = 1024
FLASH_KERNEL_HEAD_DIMS = (128, 512)


def dot_product_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    scale: Optional[float] = None) -> torch.Tensor:
    """Plain version. q: (..., Sq, H, D); k, v: (..., Sk, H, D) → (..., Sq, H, D)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qh = q.transpose(-3, -2).float()                   # (..., H, Sq, D)
    kh = k.transpose(-3, -2).float()
    logits = (qh @ kh.transpose(-1, -2)) * scale       # (..., H, Sq, Sk)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    o = w @ v.transpose(-3, -2)                        # (..., H, Sq, D)
    return o.transpose(-3, -2)


def flash_route(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether the reference sent this (unmasked) call to its flash kernel:
    4-D self-attention, S ≥ 256, S a multiple of 128 (``_pick_block``)."""
    s = q.shape[1] if q.dim() == 4 else 0
    return q.dim() == 4 and s >= 256 and s == k.shape[1] and s % 128 == 0


def _strides(t: torch.Tensor, name: str):
    """(batch, seq, head) strides of a (B, S, H, D) view with a contiguous
    last axis and 16-byte aligned rows."""
    sb, ss, sh, sd = t.stride()
    if sd != 1 or sb % 8 or ss % 8 or sh % 8:
        raise ValueError(f"dot_product_attention: unsupported {name} strides {t.stride()}")
    return sb, ss, sh


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q: (..., Sq, H, D); k, v: (..., Sk, H, D) → (..., Sq, H, D)."""
    if q.device.type == "cpu" or not flash_route(q, k):
        return dot_product_attention_reference(q, k, v, scale)
    b, s, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape or d not in FLASH_HEAD_DIMS:
        raise ValueError(f"dot_product_attention: no flash kernel for q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} (head dims "
                         f"{FLASH_HEAD_DIMS})")
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    o = torch.empty((b, s, h, d), device=q.device, dtype=q.dtype)
    _build.check_cuda("dot_product_attention", q, k, v, o)
    _build.call("ls_flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                *_strides(q, "q"), *_strides(k, "k"), *_strides(v, "v"), o.data_ptr(),
                b, s, h, d, scale, _build.stream(q))
    dot_product_attention.launches += 1
    return o


dot_product_attention.launches = 0


# ---------------------------------------------------------------------------
# K11 and K12, in the (B, S, D) layout
# ---------------------------------------------------------------------------


def _attention_bsd(q, k, v, scale: float, round_p: bool) -> torch.Tensor:
    """softmax(q k^T · scale) v over (B, S, D) with f32 logits and softmax;
    the probabilities go to the value product rounded to q.dtype, or in f32."""
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    w = torch.softmax(logits, dim=-1)
    if round_p:
        return (w.to(q.dtype).float() @ v.float()).to(q.dtype)
    return (w @ v.float()).to(q.dtype)


def _check_bsd(name: str, q, k, v) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"{name}: expected (B, S, D) tensors, got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")


def oneshot_attention_reference(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of K11: probabilities rounded to q.dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    return _attention_bsd(q, k, v, scale, round_p=True)


def oneshot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: (B, S, D) with B folding batch·heads, S ≤ 1024 → (B, S, D)."""
    if q.device.type == "cpu":
        return oneshot_attention_reference(q, k, v, scale)
    _check_bsd("oneshot_attention", q, k, v)
    b, s, d = q.shape
    if k.shape != q.shape or d not in ONESHOT_HEAD_DIMS or s % 64 or s > ONESHOT_MAX_SEQ:
        raise ValueError(f"oneshot_attention: no kernel for q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} (head dims {ONESHOT_HEAD_DIMS}, S a multiple of "
                         f"64 up to {ONESHOT_MAX_SEQ})")
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    _build.check_cuda("oneshot_attention", q, k, v, o)
    if b == 0:
        return o
    _build.call("ls_oneshot_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                b, s, d, scale, _build.stream(q))
    oneshot_attention.launches += 1
    return o


oneshot_attention.launches = 0


def flash_attention_reference(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of K12: q, k, v and the probabilities all in f32."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    return _attention_bsd(q, k, v, scale, round_p=False)


def flash_tiles(sq: int, sk: int, d: int, block_q: int, block_k: int) -> bool:
    """Whether the reference ran its streaming kernel (``attention.py:189-194``)."""
    return sq % block_q == 0 and sk % block_k == 0 and d % 128 == 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None, block_q: int = 256,
                    block_k: int = 256) -> torch.Tensor:
    """q: (B, Sq, D); k, v: (B, Sk, D), B folding batch·heads → (B, Sq, D).

    `block_q` and `block_k` are the reference's tile sizes: they decide, as
    there, whether the shapes tile (Sq % block_q, Sk % block_k, D % 128 all
    0). Where they do not, the reference ran its composed lowering (with
    rounded probabilities): a CPU tensor does the same here, and a CUDA
    tensor raises. The Hopper kernel has its own tiles (32 queries, 64
    keys), so the blocks must be multiples of 64."""
    _check_bsd("flash_attention", q, k, v)
    b, sq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    tiles = flash_tiles(sq, sk, d, block_q, block_k)
    if q.device.type == "cpu":
        return _attention_bsd(q, k, v, scale, round_p=not tiles)
    if not tiles or block_q % 64 or block_k % 64 or d not in FLASH_KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: no kernel for q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, blocks ({block_q}, {block_k}) (head dims "
                         f"{FLASH_KERNEL_HEAD_DIMS}, blocks multiples of 64 that tile S)")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    _build.check_cuda("flash_attention", q, k, v, o)
    if b == 0:
        return o
    if b > 65535:
        raise ValueError(f"flash_attention: {b} sequences exceed the grid")
    _build.call("ls_flash_kernel", q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                b, sq, sk, d, scale, _build.stream(q))
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
