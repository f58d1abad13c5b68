"""Multi-head scaled-dot-product attention, routed like the reference.

Counterpart of ``latentsync_tpu/ops/attention.py``
``dot_product_attention``: (..., S, H, D) layout, f32 logits and softmax
whatever the input dtype, probabilities rounded to the input dtype
before the value product.

``dot_product_attention`` routes exactly as the reference does
(``attention.py:51-57``): unmasked 4-D self-attention with S ≥ 256 and
S a multiple of 128 — on the serving path the VAE mid-block (S = 1024,
one head, D = 512), where the TPU ran jax's library flash kernel, on the
face-restoration path CodeFormer's transformer (S = 256, 8 heads of
D = 64), and from the kernel probe the UNet's spatial shapes (8 heads of
D = 40 and 80) — launches the hand-written flash kernel of
``csrc/flash_attention.cu`` (the tensor-core attention core of
``csrc/attn_core.cuh``) on a CUDA tensor. Everything else (whisper's
S = 1500, the audio cross-attention with Sk = 50), every masked call (the
whisper decoder's causal and cache masks) and every CPU tensor run the
plain ``dot_product_attention_reference``, which is also what
the plain versions of the other attention ops call.

The flash route has a gradient of its own: a ``torch.autograd.Function``
whose forward is that kernel (the plain version on a CPU tensor) and whose
backward is ``flash_attention_bwd``, the hand-written kernels of
``csrc/flash_attention_bwd.cu`` on a CUDA tensor (dQ, dK and dV of the
route's forward, probabilities rounded as there) and the autograd of the
plain version on a CPU tensor. Under grad the forward is the kernel's
residual instantiation (``flash_attention_fwd``): it also writes each
row's log-sum-exp, and the Function saves q, k, v, the output and that
lse, as jax's forward keeps its residuals; the backward is then two
launches, dQ (which also writes delta = rowsum(o · do)) and dK / dV, with
no sweep for row statistics. It replaces the VJP of jax's library flash
kernel (``_flash_attention_bwd_dkv`` and ``_flash_attention_bwd_dq``),
which the reference's ``_flash_bshd`` never reaches: it gives jax only the
forward's block sizes, and jax raises when the route is differentiated on
a TPU. Every other call is plain torch, which autograd differentiates.
The backward kernels exist for head dims 40, 80 and 512
(``FLASH_BWD_HEAD_DIMS``); at D = 64 (CodeFormer, whose training is still
to port) the route has a forward only, and a CUDA call under grad with an
input that requires grad raises before anything launches.

Two more kernels of the reference live here, in its (B, S, D) layout with
B folding batch and heads; only the kernel probe calls them:

- ``oneshot_attention`` (K11, ``csrc/oneshot_attention.cu``): whole-row
  attention for S ≤ 1024, the probabilities normalised by the whole
  row's max and sum and then rounded to the input dtype before the value
  product (two sweeps over the keys on the core of ``csrc/attn_core.cuh``);
- ``flash_attention`` (K12, ``csrc/flash_kernel.cu``): streaming-softmax
  attention for D a multiple of 128 whose probabilities are never
  rounded (the same core; each f32 probability reaches the tensor cores
  as three bf16 terms). Nothing in the reference calls it, so nothing
  here does.

Neither has a gradient: a launch under grad with an input that requires
grad raises.

Each plain version rounds where its own kernel rounds.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

# head dims the flash route's forward kernel is instantiated for: the UNet's
# spatial attention at C = 320 and 640 (8 heads), CodeFormer's transformer
# (8 heads of 64) and the VAE mid-block's; and those its backward (and the
# residual forward it reads) is instantiated for
FLASH_FWD_HEAD_DIMS = (40, 64, 80, 512)
FLASH_BWD_HEAD_DIMS = (40, 80, 512)
ONESHOT_HEAD_DIMS = (40, 80)
ONESHOT_MAX_SEQ = 1024
FLASH_KERNEL_HEAD_DIMS = (128, 512)


def dot_product_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    scale: Optional[float] = None,
                                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version. q: (..., Sq, H, D); k, v: (..., Sk, H, D) → (..., Sq, H, D).
    `mask` is added to the f32 logits (..., H, Sq, Sk) before the softmax."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    acc = torch.promote_types(q.dtype, torch.float32)
    qh = q.transpose(-3, -2).to(acc)                   # (..., H, Sq, D)
    kh = k.transpose(-3, -2).to(acc)
    logits = (qh @ kh.transpose(-1, -2)) * scale       # (..., H, Sq, Sk)
    if mask is not None:
        logits = logits + mask
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    o = w @ v.transpose(-3, -2)                        # (..., H, Sq, D)
    return o.transpose(-3, -2)


def flash_route(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether the reference sent this (unmasked) call to its flash kernel:
    4-D self-attention, S ≥ 256, S a multiple of 128 (``_pick_block``)."""
    s = q.shape[1] if q.dim() == 4 else 0
    return q.dim() == 4 and s >= 256 and s == k.shape[1] and s % 128 == 0


def _row_pitch(t: torch.Tensor, name: str) -> int:
    """Row pitch of a (B, S, H, D) view the kernel can read: D contiguous,
    a head D elements on, a batch entry S rows on, rows 16-byte aligned (a
    contiguous tensor, or its column slice of a wider projection). Any
    other view raises: nothing is copied silently."""
    b, s, h, d = t.shape
    sb, ss, sh, sd = t.stride()
    if sd != 1 or ss % 8 or ss >= 2**31 or (h > 1 and sh != d) or (b > 1 and sb != s * ss):
        raise ValueError(f"dot_product_attention: unsupported {name} strides {t.stride()} "
                         f"for shape {tuple(t.shape)}")
    return ss


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (..., Sq, H, D); k, v: (..., Sk, H, D) → (..., Sq, H, D); an additive
    `mask` on the f32 logits (the whisper decoder's) never takes the flash
    route, as in the reference."""
    if mask is not None or not flash_route(q, k):
        return dot_product_attention_reference(q, k, v, scale, mask)
    if q.device.type != "cpu" and q.shape[-1] not in FLASH_BWD_HEAD_DIMS \
            and torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError(f"dot_product_attention: the flash route has no backward kernel at "
                         f"head dim {q.shape[-1]} (backward head dims "
                         f"{FLASH_BWD_HEAD_DIMS}; ROADMAP.md §2 queues D = 64's): call it "
                         "under torch.no_grad() or with inputs that need no gradient")
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    return _FlashRoute.apply(q, k, v, scale)


class _FlashRoute(torch.autograd.Function):
    """The flash route: its kernel forward (plain on a CPU tensor) and
    ``flash_attention_bwd`` for the gradient. On a CUDA tensor with an input
    that needs a gradient the forward is the residual instantiation, and
    q, k, v, its output and the row log-sum-exp are saved for the backward;
    on a CPU tensor q, k, v (the backward is the plain version's autograd)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        ctx.scale = scale
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v)
            return dot_product_attention_reference(q, k, v, scale)
        if not any(ctx.needs_input_grad[:3]):
            return _flash_forward(q, k, v, scale)
        o, lse = flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, grad):
        q, k, v, *res = ctx.saved_tensors
        if res:
            o, lse = res
            return (*flash_attention_bwd(q, k, v, grad, ctx.scale, o=o, lse=lse), None)
        return (*flash_attention_bwd(q, k, v, grad, ctx.scale), None)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """The flash route's forward with its residual, on a CUDA tensor: (o,
    lse), lse (B, H, S) f32, the base-2 log-sum-exp of each row's scaled
    logits, log2(sum 2^(s c)) with c = scale · log2(e) (natural units: lse ·
    ln 2). One launch of ``csrc/flash_attention.cu``'s residual
    instantiation, counted in ``dot_product_attention.launches``."""
    return _flash_forward(q, k, v, scale, with_lse=True)


def flash_attention_fwd_reference(q, k, v, scale: float):
    """Plain version of ``flash_attention_fwd``: the plain forward and the
    f32 log-sum-exp of the scaled logits, in base 2."""
    qh, kh = q.transpose(1, 2).float(), k.transpose(1, 2).float()
    lse = torch.logsumexp((qh @ kh.transpose(-1, -2)) * scale, dim=-1) / math.log(2.0)
    return dot_product_attention_reference(q, k, v, scale), lse


def _flash_forward(q, k, v, scale: float, with_lse: bool = False):
    b, s, h, d = q.shape
    dims = FLASH_BWD_HEAD_DIMS if with_lse else FLASH_FWD_HEAD_DIMS
    if k.shape != q.shape or v.shape != q.shape or d not in dims:
        raise ValueError(f"dot_product_attention: no flash kernel for q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} (head dims {dims}"
                         f"{' with the residual' if with_lse else ''})")
    if not scale > 0:
        raise ValueError(f"dot_product_attention: the kernel needs scale > 0, got {scale}")
    o = torch.empty((b, s, h, d), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, s), device=q.device, dtype=torch.float32) if with_lse else None
    _build.check_cuda("dot_product_attention", q, k, v, o)
    if b == 0:
        return (o, lse) if with_lse else o
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), _row_pitch(q, "q"), _row_pitch(k, "k"),
            _row_pitch(v, "v"), o.data_ptr(), b, s, h, d, scale]
    if with_lse:
        args.append(lse.data_ptr())
    _build.call("ls_flash_attention_lse" if with_lse else "ls_flash_attention", *args,
                _build.stream(q))
    dot_product_attention.launches += 1
    return (o, lse) if with_lse else o


dot_product_attention.launches = 0


def flash_attention_bwd_reference(q, k, v, grad, scale: float):
    """Plain version of the flash route's backward: autograd of
    ``dot_product_attention_reference`` (f32 logits and softmax,
    probabilities rounded to q.dtype before the value product), (dq, dk, dv)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = dot_product_attention_reference(*leaves, scale)
        return torch.autograd.grad(out, leaves, grad)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        grad: torch.Tensor, scale: float, *, o: Optional[torch.Tensor] = None,
                        lse: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of the flash route's forward for the output gradient
    `grad`, all (B, S, H, D). On a CUDA tensor the two launches of
    ``csrc/flash_attention_bwd.cu`` (dQ with delta = rowsum(o · grad), then
    dK / dV), for S a multiple of 64 and head dims ``FLASH_BWD_HEAD_DIMS``, from
    the forward's output `o` and row log-sum-exp `lse` (``flash_attention_fwd``;
    the Function passes its saved ones): without them the residual forward
    runs first, one more launch. On a CPU tensor the plain version."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, grad, scale)
    b, s, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape or grad.shape != q.shape \
            or d not in FLASH_BWD_HEAD_DIMS or s % 64:
        raise ValueError(f"flash_attention_bwd: no kernel for q {tuple(q.shape)}, grad "
                         f"{tuple(grad.shape)} (head dims {FLASH_BWD_HEAD_DIMS}, S a multiple "
                         "of 64)")
    if not scale > 0:
        raise ValueError(f"flash_attention_bwd: the kernel needs scale > 0, got {scale}")
    if o is None or lse is None:
        o, lse = flash_attention_fwd(q, k, v, scale)
    if o.shape != q.shape or o.dtype != q.dtype or not o.is_contiguous() \
            or lse.shape != (b, h, s) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: residuals o {tuple(o.shape)} {o.dtype}, lse "
                         f"{tuple(lse.shape)} {lse.dtype}: want a contiguous o like q and a "
                         f"contiguous f32 lse of shape {(b, h, s)}")
    grad = grad.to(q.dtype).contiguous()
    dq, dk, dv = (torch.empty((b, s, h, d), device=q.device, dtype=q.dtype) for _ in range(3))
    delta = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    bf, f32 = torch.bfloat16, torch.float32
    _build.check_cuda("flash_attention_bwd", q, k, v, o, grad, lse, dq, dk, dv, delta,
                      dtypes=(bf, bf, bf, bf, bf, f32, bf, bf, bf, f32))
    if b == 0:
        return dq, dk, dv
    _build.call("ls_flash_attention_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                o.data_ptr(), grad.data_ptr(), _row_pitch(q, "q"), _row_pitch(k, "k"),
                _row_pitch(v, "v"), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), b, s, h, d, scale, _build.stream(q))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


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
    if not scale > 0:
        raise ValueError(f"oneshot_attention: the kernel needs scale > 0, got {scale}")
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
    tensor raises. The Hopper kernel has its own tiles (64 queries, 32 or
    64 keys), so the blocks must be multiples of 64."""
    _check_bsd("flash_attention", q, k, v)
    b, sq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    tiles = flash_tiles(sq, sk, d, block_q, block_k)
    if q.device.type == "cpu":
        return _attention_bsd(q, k, v, scale, round_p=not tiles)
    if not scale > 0:
        raise ValueError(f"flash_attention: the kernel needs scale > 0, got {scale}")
    if not tiles or block_q % 64 or block_k % 64 or d not in FLASH_KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: no kernel for q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, blocks ({block_q}, {block_k}) (head dims "
                         f"{FLASH_KERNEL_HEAD_DIMS}, blocks multiples of 64 that tile S)")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    _build.check_cuda("flash_attention", q, k, v, o)
    if b == 0:
        return o
    _build.call("ls_flash_kernel", q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                b, sq, sk, d, scale, _build.stream(q))
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
