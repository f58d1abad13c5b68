"""Self- and cross-attention blocks: x + Wo·Attn(QKV(LN(x) [+ PE])) + bo.

Counterpart of ``latentsync_tpu/ops/attn_block.py``.

``self_attention_block`` (K2) on a CUDA tensor routes like the
reference: where the TPU ran its fused block kernel (temporal mode at
C = 320 and 640, spatial mode at S ≤ 256 with C = 640), it launches the
kernel chain of ``csrc/attn_block.cu``; where the reference's weight or
VMEM budget sent the block to its composed lowering (C = 1280, and
spatial S = 1024 at C = 320), it runs that composition, whose attention
core is the K3/K4 kernel (``temporal_attention``/``spatial_attention``).
On a CPU tensor it runs the plain version.

``cross_attention_block`` (K5), the audio cross-attention, follows the
reference's opt-in switch: with ``LATENTSYNC_FUSED_XATTN=1`` (read at
each call, as the reference reads it at trace time), on a CUDA tensor,
it launches the kernel chain of ``csrc/cross_attn_block.cu`` wherever
the reference ran ``_cross_fused`` (``cross_fused_route``: C = 320 and
640 on the UNet; C = 1280 is over the 8 MiB weight budget). Everywhere
else on the card it runs the composed torch of the reference's
``_xla_cross_block``. On a CPU tensor it runs the plain version.

The two compositions, ``self_attention_composed`` and
``cross_attention_composed``, take the projection as an argument: the
UNet runs them with ``qconv.dense_with_params`` where the reference runs
its composed blocks (``LATENTSYNC_FUSED_ATTN=0``, or an int8 dense mode).

Weights use the torch ``nn.Linear`` layout: wq/wk/wv (inner, C) without
bias, wo (C, inner) with bias bo.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from . import _build
from .attention import dot_product_attention, dot_product_attention_reference
from .ffn import layer_norm_f32, linear
from .temporal_attention import (
    SPATIAL_HEAD_DIMS,
    TEMPORAL_FRAMES,
    spatial_attention,
    spatial_attention_reference,
    spatial_smem_ok,
    temporal_attention,
    temporal_attention_reference,
)

# the reference's fused-block limits (attn_block.py:172-174 weight budget,
# and the spatial shapes it fused at the flagship)
_FUSED_WEIGHT_BYTES = 8 * 2**20
_FUSED_SPATIAL_MAX_S = 256
# head widths of the cross blocks on the fused route (C = 320, 640; 8 heads)
_CROSS_HEAD_DIMS = (40, 80)


def fused_attn_block_enabled() -> bool:
    """The reference's switch: on unless ``LATENTSYNC_FUSED_ATTN=0``."""
    return os.environ.get("LATENTSYNC_FUSED_ATTN", "1") != "0"


def fused_route(s: int, c: int, inner: int, temporal: bool) -> bool:
    """Whether the reference ran this block as its fused TPU kernel."""
    if (3 * c * inner + inner * c) * 2 > _FUSED_WEIGHT_BYTES:
        return False
    return temporal or s <= _FUSED_SPATIAL_MAX_S


def cross_fused_route(b: int, s: int, sk: int, c: int, cc: int, inner: int) -> bool:
    """Whether the reference ran this cross block as its fused TPU kernel:
    ``_pick_cross_block(...) > 0`` (weight budget, and a batch block whose
    VMEM estimate fits 6 MB) and 16 ≤ S ≤ 1024, Sk ≥ 8 (``attn_block.py:341-353,
    421-429``)."""
    weights = (c * inner + 2 * cc * inner + inner * c) * 2

    def vmem(blk):
        xbytes = blk * s * c * (2 + 4) + blk * sk * cc * 2
        qkv = blk * (s + 2 * sk) * inner * 2 + blk * s * inner * 2
        return weights + xbytes + qkv + blk * s * sk * 4 * 2

    return (weights <= _FUSED_WEIGHT_BYTES and 16 <= s <= 1024 and sk >= 8
            and any(b % blk == 0 and vmem(blk) <= 6 * 2**20
                    for blk in (64, 32, 16, 8, 4, 2, 1)))


def self_attention_block_reference(x, ln_scale, ln_bias, wq, wk, wv, wo, bo,
                                   heads: int, *, temporal: bool = False,
                                   pe: Optional[torch.Tensor] = None,
                                   eps: float = 1e-6) -> torch.Tensor:
    """Plain version: f32 LN and products, rounded to x.dtype where the
    kernel chain rounds (normalised input, q/k/v, attention output,
    block output)."""
    dt = x.dtype
    d = wq.shape[0] // heads
    scale = 1.0 / math.sqrt(d)
    h = layer_norm_f32(x, ln_scale, ln_bias, eps).to(dt)
    if pe is not None:
        h = h + pe.to(dt)
    hf = h.float()
    q, k, v = ((hf @ w.float().t()).to(dt) for w in (wq, wk, wv))
    core = temporal_attention_reference if temporal else spatial_attention_reference
    o = core(q, k, v, heads, scale)
    return (x.float() + o.float() @ wo.float().t() + bo.float()).to(dt)


def self_attention_composed(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, heads: int, *,
                            temporal: bool = False, pe: Optional[torch.Tensor] = None,
                            eps: float = 1e-6, dense=linear) -> torch.Tensor:
    """The reference's ``_xla_block`` (and, with `dense` =
    ``qconv.dense_with_params``, the UNet's ``_self_attn_composed``):
    four projections around the K3/K4 core."""
    dt = x.dtype
    h = layer_norm_f32(x, ln_scale, ln_bias, eps).to(dt)
    if pe is not None:
        h = h + pe.to(dt)
    q, k, v = (dense(h, w, None, dt) for w in (wq, wk, wv))
    o = (temporal_attention if temporal else spatial_attention)(q, k, v, heads)
    return x + dense(o, wo, bo, dt)


def self_attention_block(x: torch.Tensor, ln_scale, ln_bias, wq, wk, wv, wo, bo,
                         heads: int, *, temporal: bool = False,
                         pe: Optional[torch.Tensor] = None,
                         eps: float = 1e-6) -> torch.Tensor:
    """x: (B, S, C) → x + OutProj(SelfAttn(QKV(LN(x) [+ pe]))). `pe`: (S, C)
    positional encoding added after the LN (temporal mode)."""
    if x.device.type == "cpu":
        return self_attention_block_reference(
            x, ln_scale, ln_bias, wq, wk, wv, wo, bo, heads, temporal=temporal,
            pe=pe, eps=eps)
    b, s, c = x.shape
    inner = wq.shape[0]
    if not fused_route(s, c, inner, temporal):
        return self_attention_composed(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, heads,
                                       temporal=temporal, pe=pe, eps=eps)
    d = inner // heads
    core_ok = (s == TEMPORAL_FRAMES if temporal
               else d in SPATIAL_HEAD_DIMS and spatial_smem_ok(s, d))
    if c % 8 or d % 8 or inner != heads * d or not core_ok:
        raise ValueError(f"self_attention_block: no kernel for S={s}, C={c}, "
                         f"inner={inner}, heads={heads}, temporal={temporal}")
    dt = x.dtype
    dev = x.device
    f32 = dict(device=dev, dtype=torch.float32)
    x = x.contiguous()
    w_qkv = torch.cat([wq, wk, wv], dim=0).to(dt).contiguous()
    w_o = wo.to(dt).contiguous()
    b_o = bo.to(**f32).contiguous()
    ln_w = ln_scale.to(**f32).contiguous()
    ln_b = ln_bias.to(**f32).contiguous()
    pe_b = None if pe is None else pe.to(device=dev, dtype=dt).contiguous()
    _build.check_cuda("self_attention_block", x, w_qkv, w_o)
    m = b * s
    stats = torch.empty((m, 2), **f32)
    qkv = torch.empty((m, 3 * inner), device=dev, dtype=dt)
    attn = torch.empty((m, inner), device=dev, dtype=dt)
    out = torch.empty_like(x)
    scale = 1.0 / math.sqrt(d)
    _build.call(
        "ls_attn_block", x.data_ptr(), b, s, c, inner, heads, int(temporal),
        ln_w.data_ptr(), ln_b.data_ptr(), eps, _build.ptr(pe_b),
        w_qkv.data_ptr(), w_o.data_ptr(), b_o.data_ptr(), scale,
        stats.data_ptr(), qkv.data_ptr(), attn.data_ptr(), out.data_ptr(),
        _build.stream(x))
    self_attention_block.launches += 1
    return out


self_attention_block.launches = 0


def cross_attention_block_reference(x, ln_scale, ln_bias, ctx, wq, wk, wv, wo, bo,
                                    heads: int, *, eps: float = 1e-6) -> torch.Tensor:
    """Plain version: f32 LN and products, rounded to x.dtype where the
    kernel chain rounds (LN(x), q, k, v, probabilities, attention output,
    block output)."""
    dt = x.dtype
    b, s, _ = x.shape
    sk = ctx.shape[1]
    inner = wq.shape[0]
    d = inner // heads
    h = layer_norm_f32(x, ln_scale, ln_bias, eps).to(dt)
    cf = ctx.to(dt).float()
    q = (h.float() @ wq.float().t()).to(dt).reshape(b, s, heads, d)
    k = (cf @ wk.float().t()).to(dt).reshape(b, sk, heads, d)
    v = (cf @ wv.float().t()).to(dt).reshape(b, sk, heads, d)
    o = dot_product_attention_reference(q, k, v).reshape(b, s, inner)
    return (x.float() + o.float() @ wo.float().t() + bo.float()).to(dt)


def cross_attention_composed(x, ln_scale, ln_bias, ctx, wq, wk, wv, wo, bo, heads: int, *,
                             eps: float = 1e-6, dense=linear) -> torch.Tensor:
    """The reference's ``_xla_cross_block`` (and, with `dense` =
    ``qconv.dense_with_params``, the UNet's ``_cross_attn_composed``):
    four projections around the routed attention; the context is cast to
    x.dtype."""
    dt = x.dtype
    b, s, _ = x.shape
    inner = wq.shape[0]
    d = inner // heads
    h = layer_norm_f32(x, ln_scale, ln_bias, eps).to(dt)
    ctx = ctx.to(dt)
    sk = ctx.shape[1]
    q = dense(h, wq, None, dt).reshape(b, s, heads, d)
    k = dense(ctx, wk, None, dt).reshape(b, sk, heads, d)
    v = dense(ctx, wv, None, dt).reshape(b, sk, heads, d)
    o = dot_product_attention(q, k, v).reshape(b, s, inner)
    return x + dense(o, wo, bo, dt)


def cross_attention_block(x: torch.Tensor, ln_scale, ln_bias, ctx: torch.Tensor,
                          wq, wk, wv, wo, bo, heads: int, *,
                          eps: float = 1e-6) -> torch.Tensor:
    """x: (B, S, C), ctx: (B, Sk, Cc) → x + OutProj(Attn(Q(LN(x)), K(ctx),
    V(ctx))); the context is used raw, like the reference."""
    if x.device.type == "cpu":
        return cross_attention_block_reference(x, ln_scale, ln_bias, ctx, wq, wk, wv, wo, bo,
                                               heads, eps=eps)
    b, s, c = x.shape
    sk, cc = ctx.shape[1:]
    inner = wq.shape[0]
    opted_in = os.environ.get("LATENTSYNC_FUSED_XATTN", "0") == "1"
    if not (opted_in and cross_fused_route(b, s, sk, c, cc, inner)):
        return cross_attention_composed(x, ln_scale, ln_bias, ctx, wq, wk, wv, wo, bo, heads,
                                        eps=eps)
    d = inner // heads
    if c % 8 or cc % 8 or inner != heads * d or d not in _CROSS_HEAD_DIMS \
            or 2 * sk * d * 2 > 227 * 1024:
        raise ValueError(f"cross_attention_block: no kernel for C={c}, Cc={cc}, "
                         f"inner={inner}, heads={heads}, Sk={sk}")
    dt = x.dtype
    dev = x.device
    f32 = dict(device=dev, dtype=torch.float32)
    x = x.contiguous()
    ctx = ctx.to(dt).contiguous()
    w_q = wq.to(dt).contiguous()
    w_kv = torch.cat([wk, wv], dim=0).to(dt).contiguous()
    w_o = wo.to(dt).contiguous()
    b_o = bo.to(**f32).contiguous()
    ln_w = ln_scale.to(**f32).contiguous()
    ln_b = ln_bias.to(**f32).contiguous()
    _build.check_cuda("cross_attention_block", x, ctx, w_q, w_kv, w_o)
    m = b * s
    stats = torch.empty((m, 2), **f32)
    q = torch.empty((m, inner), device=dev, dtype=dt)
    kv = torch.empty((b * sk, 2 * inner), device=dev, dtype=dt)
    attn = torch.empty((m, inner), device=dev, dtype=dt)
    out = torch.empty_like(x)
    _build.call(
        "ls_cross_attn_block", x.data_ptr(), ctx.data_ptr(), b, s, c, sk, cc, inner, heads,
        ln_w.data_ptr(), ln_b.data_ptr(), eps, w_q.data_ptr(), w_kv.data_ptr(),
        w_o.data_ptr(), b_o.data_ptr(), 1.0 / math.sqrt(d), stats.data_ptr(), q.data_ptr(),
        kv.data_ptr(), attn.data_ptr(), out.data_ptr(), _build.stream(x))
    cross_attention_block.launches += 1
    return out


cross_attention_block.launches = 0
