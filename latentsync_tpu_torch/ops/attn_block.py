"""Self- and cross-attention blocks: x + Wo·Attn(QKV(LN(x) [+ PE])) + bo.

Counterpart of ``latentsync_tpu/ops/attn_block.py``.

``self_attention_block`` (K2) on a CUDA tensor routes like the
reference: where the TPU ran its fused block kernel (temporal mode at
C = 320 and 640 with 8 ≤ F ≤ 24 frames, spatial mode at S ≤ 256 with
C = 640), it launches
``csrc/attn_block.cu``: one kernel in temporal mode (two at C = 640), a
chain of four in spatial mode; where the reference's weight or
VMEM budget sent the block to its composed lowering (C = 1280, and
spatial S = 1024 at C = 320), it runs that composition, whose attention
core is the K3/K4 kernel (``temporal_attention``/``spatial_attention``).
On a CPU tensor it runs the plain version. On the CPU and on the fused
route it differentiates as the reference's ``custom_vjp`` does
(``attn_block.py:258-274``): the backward recomputes the composed
``self_attention_composed`` (``_xla_block``, whose cores are the K3/K4
ops with gradients of their own) and takes its gradient
(``ops/autograd.py``); the composed route is differentiated as it runs.

``cross_attention_block`` (K5), the audio cross-attention, follows the
reference's opt-in switch: with ``LATENTSYNC_FUSED_XATTN=1`` (read at
each call, as the reference reads it at trace time), on a CUDA tensor,
it launches the kernel chain of ``csrc/cross_attn_block.cu`` wherever
the reference ran ``_cross_fused`` (``cross_fused_route``: C = 320 and
640 on the UNet; C = 1280 is over the 8 MiB weight budget). Everywhere
else on the card it runs the composed torch of the reference's
``_xla_cross_block``. On a CPU tensor it runs the plain version. On the
CPU and on the fused route it differentiates as the reference's
``_cross_fwd`` / ``_cross_bwd`` do (``attn_block.py:388-404``): the
backward recomputes ``cross_attention_composed`` (``_xla_cross_block``)
and takes its gradient (``ops/autograd.py``).

The two compositions, ``self_attention_composed`` and
``cross_attention_composed``, take the projection as an argument: the
UNet runs them with ``qconv.dense_with_params`` where the reference runs
its composed blocks (``LATENTSYNC_FUSED_ATTN=0``, or an int8 dense mode).

Weights use the torch ``nn.Linear`` layout: wq/wk/wv (inner, C) without
bias, wo (C, inner) with bias bo.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Optional

import torch

from . import _build
from .attention import dot_product_attention, dot_product_attention_reference
from .autograd import with_composed_grad
from .ffn import acc_dtype, layer_norm_f32, linear
from .temporal_attention import (
    TEMPORAL_MAX_FRAMES,
    spatial_attention,
    spatial_attention_reference,
    temporal_attention,
    temporal_attention_reference,
)

# the reference's fused-block limits (attn_block.py:172-174 weight budget,
# and the spatial shapes it fused at the flagship)
_FUSED_WEIGHT_BYTES = 8 * 2**20
_FUSED_SPATIAL_MAX_S = 256
# head widths of the cross blocks on the fused route (C = 320, 640; 8 heads)
_CROSS_HEAD_DIMS = (40, 80)


@functools.lru_cache(maxsize=None)
def block_max_c(temporal: bool, d: int) -> int:
    """The widest C that K2's kernels take at head dim `d` (0: none), as the
    library states it (``ls_attn_block_max_c``, ``csrc/attn_block.cu``)."""
    return _build.query("ls_attn_block_max_c", int(temporal), d)


def fused_attn_block_enabled() -> bool:
    """The reference's switch: on unless ``LATENTSYNC_FUSED_ATTN=0``."""
    return os.environ.get("LATENTSYNC_FUSED_ATTN", "1") != "0"


def fused_route(s: int, c: int, inner: int, temporal: bool, heads: int = 8) -> bool:
    """Whether the reference ran this block as its fused TPU kernel
    (``attn_block.py:455-465``): its weight budget, and in temporal mode
    ``8 <= F``, ``F * heads <= 512`` and a batch block whose VMEM estimate
    fits 6 MB (``_pick_block``: the estimate grows with the block, so one
    sequence a block decides it). `heads` defaults to the UNet's 8."""
    weights = (3 * c * inner + inner * c) * 2
    if weights > _FUSED_WEIGHT_BYTES:
        return False
    if not temporal:
        return s <= _FUSED_SPATIAL_MAX_S
    t = s * heads
    vmem = weights + s * c * 6 + 3 * s * inner * 4 + s * inner * 2 + t * t * 8
    return 8 <= s and t <= 512 and vmem <= 6 * 2**20


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
    kernels round (normalised input, q/k/v, attention output, block
    output)."""
    dt, acc = x.dtype, acc_dtype(x)
    d = wq.shape[0] // heads
    scale = 1.0 / math.sqrt(d)
    h = layer_norm_f32(x, ln_scale, ln_bias, eps).to(dt)
    if pe is not None:
        h = h + pe.to(dt)
    hf = h.to(acc)
    q, k, v = ((hf @ w.to(acc).t()).to(dt) for w in (wq, wk, wv))
    core = temporal_attention_reference if temporal else spatial_attention_reference
    o = core(q, k, v, heads, scale)
    return (x.to(acc) + o.to(acc) @ wo.to(acc).t() + bo.to(acc)).to(dt)


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
    cpu = x.device.type == "cpu"
    if not cpu and not fused_route(x.shape[1], x.shape[2], wq.shape[0], temporal, heads):
        return self_attention_composed(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, heads,
                                       temporal=temporal, pe=pe, eps=eps)
    kernel = self_attention_block_reference if cpu else self_attention_block_fused

    def run(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, pe):
        return kernel(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, heads, temporal=temporal,
                      pe=pe, eps=eps)

    def composed(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, pe):
        return self_attention_composed(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, heads,
                                       temporal=temporal, pe=pe, eps=eps)

    return with_composed_grad(run, composed, x, ln_scale, ln_bias, wq, wk, wv, wo, bo, pe)


def self_attention_block_fused(x: torch.Tensor, ln_scale, ln_bias, wq, wk, wv, wo, bo,
                               heads: int, *, temporal: bool = False,
                               pe: Optional[torch.Tensor] = None,
                               eps: float = 1e-6) -> torch.Tensor:
    """K2's kernels on a CUDA tensor, whatever the route: what
    ``self_attention_block`` launches on the fused route (its count goes up
    here); raises for a shape they do not take (temporal mode: 1 <= F <= 24)."""
    b, s, c = x.shape
    inner = wq.shape[0]
    d = inner // heads
    frames_ok = not temporal or 1 <= s <= TEMPORAL_MAX_FRAMES
    if c % 8 or d % 8 or inner != heads * d or not frames_ok or c > block_max_c(temporal, d):
        raise ValueError(f"self_attention_block: no kernel for S={s}, C={c}, "
                         f"inner={inner}, heads={heads}, temporal={temporal}")
    dt = x.dtype
    dev = x.device
    f32 = dict(device=dev, dtype=torch.float32)
    x = x.contiguous()
    w_q, w_k, w_v, w_o = (w.to(dt).contiguous() for w in (wq, wk, wv, wo))
    b_o = bo.to(**f32).contiguous()
    ln_w = ln_scale.to(**f32).contiguous()
    ln_b = ln_bias.to(**f32).contiguous()
    _build.refuse_grad("self_attention_block", x, ln_scale, ln_bias, wq, wk, wv, wo, bo, pe)
    _build.check_cuda("self_attention_block", x, w_q, w_k, w_v, w_o)
    out = torch.empty_like(x)
    scale = 1.0 / math.sqrt(d)
    if temporal:  # q/k/v never leave the chip
        pe_b = None if pe is None else pe.to(device=dev, dtype=dt).contiguous()
        # at D = 80 the attention output goes through device memory to the
        # output product (csrc/temporal_block.cuh)
        attn = torch.empty((b * s, inner), device=dev, dtype=dt) if d == 80 else None
        _build.call(
            "ls_temporal_block", x.data_ptr(), b, s, c, inner, heads, ln_w.data_ptr(),
            ln_b.data_ptr(), eps, _build.ptr(pe_b), w_q.data_ptr(), w_k.data_ptr(),
            w_v.data_ptr(), w_o.data_ptr(), b_o.data_ptr(), scale, _build.ptr(attn),
            out.data_ptr(), _build.stream(x))
    else:
        m = b * s
        normed = torch.empty((m, c), device=dev, dtype=dt)  # scratch: bf16(LN(x))
        qkv = torch.empty((m, 3 * inner), device=dev, dtype=dt)
        attn = torch.empty((m, inner), device=dev, dtype=dt)
        _build.call(
            "ls_attn_block", x.data_ptr(), b, s, c, inner, heads, ln_w.data_ptr(),
            ln_b.data_ptr(), eps, w_q.data_ptr(), w_k.data_ptr(), w_v.data_ptr(),
            w_o.data_ptr(), b_o.data_ptr(), scale, normed.data_ptr(), qkv.data_ptr(),
            attn.data_ptr(), out.data_ptr(), _build.stream(x))
    self_attention_block.launches += 1
    return out


self_attention_block.launches = 0


def cross_attention_block_reference(x, ln_scale, ln_bias, ctx, wq, wk, wv, wo, bo,
                                    heads: int, *, eps: float = 1e-6) -> torch.Tensor:
    """Plain version: f32 LN and products, rounded to x.dtype where the
    kernel chain rounds (LN(x), q, k, v, probabilities, attention output,
    block output)."""
    dt, acc = x.dtype, acc_dtype(x)
    b, s, _ = x.shape
    sk = ctx.shape[1]
    inner = wq.shape[0]
    d = inner // heads
    h = layer_norm_f32(x, ln_scale, ln_bias, eps).to(dt)
    cf = ctx.to(dt).to(acc)
    q = (h.to(acc) @ wq.to(acc).t()).to(dt).reshape(b, s, heads, d)
    k = (cf @ wk.to(acc).t()).to(dt).reshape(b, sk, heads, d)
    v = (cf @ wv.to(acc).t()).to(dt).reshape(b, sk, heads, d)
    o = dot_product_attention_reference(q, k, v).reshape(b, s, inner)
    return (x.to(acc) + o.to(acc) @ wo.to(acc).t() + bo.to(acc)).to(dt)


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
    cpu = x.device.type == "cpu"
    if not cpu:
        b, s, c = x.shape
        sk, cc = ctx.shape[1:]
        opted_in = os.environ.get("LATENTSYNC_FUSED_XATTN", "0") == "1"
        if not (opted_in and cross_fused_route(b, s, sk, c, cc, wq.shape[0])):
            return cross_attention_composed(x, ln_scale, ln_bias, ctx, wq, wk, wv, wo, bo,
                                            heads, eps=eps)
    kernel = cross_attention_block_reference if cpu else cross_attention_block_fused

    def run(x, ln_scale, ln_bias, ctx, wq, wk, wv, wo, bo):
        return kernel(x, ln_scale, ln_bias, ctx, wq, wk, wv, wo, bo, heads, eps=eps)

    def composed(x, ln_scale, ln_bias, ctx, wq, wk, wv, wo, bo):
        return cross_attention_composed(x, ln_scale, ln_bias, ctx, wq, wk, wv, wo, bo, heads,
                                        eps=eps)

    return with_composed_grad(run, composed, x, ln_scale, ln_bias, ctx, wq, wk, wv, wo, bo)


def cross_attention_block_fused(x: torch.Tensor, ln_scale, ln_bias, ctx: torch.Tensor,
                                wq, wk, wv, wo, bo, heads: int, *,
                                eps: float = 1e-6) -> torch.Tensor:
    """K5's kernel chain on a CUDA tensor: what ``cross_attention_block``
    launches on the fused route (its count goes up here); raises for a
    shape it does not take."""
    b, s, c = x.shape
    sk, cc = ctx.shape[1:]
    inner = wq.shape[0]
    d = inner // heads
    if c % 8 or cc % 8 or inner != heads * d or d not in _CROSS_HEAD_DIMS:
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
    _build.refuse_grad("cross_attention_block", x, ctx, ln_scale, ln_bias, wq, wk, wv, wo, bo)
    _build.check_cuda("cross_attention_block", x, ctx, w_q, w_kv, w_o)
    m = b * s
    normed = torch.empty((m, c), device=dev, dtype=dt)  # scratch: bf16(LN(x))
    q = torch.empty((m, inner), device=dev, dtype=dt)
    kv = torch.empty((b * sk, 2 * inner), device=dev, dtype=dt)
    attn = torch.empty((m, inner), device=dev, dtype=dt)
    out = torch.empty_like(x)
    _build.call(
        "ls_cross_attn_block", x.data_ptr(), ctx.data_ptr(), b, s, c, sk, cc, inner, heads,
        ln_w.data_ptr(), ln_b.data_ptr(), eps, w_q.data_ptr(), w_kv.data_ptr(),
        w_o.data_ptr(), b_o.data_ptr(), 1.0 / math.sqrt(d), normed.data_ptr(), q.data_ptr(),
        kv.data_ptr(), attn.data_ptr(), out.data_ptr(), _build.stream(x))
    cross_attention_block.launches += 1
    return out


cross_attention_block.launches = 0
