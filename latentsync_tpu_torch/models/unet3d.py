"""Audio-conditioned 3D UNet (LatentSync stage 2) in torch.

Counterpart of ``latentsync_tpu/models/unet3d.py`` ``UNet3DConditionModel``,
its DeepCache paths included (``forward``'s ``cache_*`` arguments). Layout
is torch's (B, C, F, H, W); parameter names follow the upstream checkpoint,
so ``state_dict()`` is the upstream key layout that
``latentsync_tpu.utils.convert.convert_unet`` reads.

The self-attention blocks, the audio cross-attention blocks and the GEGLU
feed-forwards call the fused ops of ``..ops`` with the LayerNorm and the
residual folded in, exactly as the JAX model calls its Pallas kernels;
the modules named ``norm1``/``attn1``/``ff``… only hold the weights.

The reference's two opt-in kernel switches configure the same model
here, read at each call as the reference reads them at trace time:
``LATENTSYNC_PALLAS_GN=1`` sends the norms that the reference routes
through ``gn_silu`` to the GroupNorm kernels of ``ops.groupnorm`` (the
parameters stay nn.GroupNorm's), and ``LATENTSYNC_FUSED_XATTN=1`` turns
on the fused audio cross-attention kernel (``ops.attn_block``). Both are
off by default.

The reference's int8 switches configure it too (``ops.qconv``):
``LATENTSYNC_INT8=1`` runs every convolution the reference routes through
``QConv`` (``InflatedConv2d``: conv_in/out, the resnets' convs and 1×1
shortcuts, the samplers) as the int8 convolution over the frame-folded
batch; the transformers' 1×1 proj_in/out, the motion modules' proj_in/out
and the time embeddings stay float, as there. Under
``LATENTSYNC_INT8_DENSE`` (or ``LATENTSYNC_FUSED_ATTN=0`` /
``LATENTSYNC_FUSED_FFN=0``) the transformer and motion blocks run the
reference's composed forms, every projection through ``dense_with_params``
(K8 under ``LATENTSYNC_INT8_DENSE=pallas``) around the K3/K4 cores.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import MotionModuleConfig, UNet3DConfig
from ..ops.attn_block import (
    cross_attention_block,
    cross_attention_composed,
    fused_attn_block_enabled,
    self_attention_block,
    self_attention_composed,
)
from ..ops.ffn import fused_ffn_enabled, geglu_ffn, geglu_ffn_composed
from ..ops.groupnorm import group_norm_silu_auto
from ..ops.qconv import QConv2d, dense_with_params, int8_dense_enabled


def timestep_embedding(timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0, max_period: float = 10000.0) -> torch.Tensor:
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    freqs = torch.exp(exponent / (half - freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def interleaved_positional_encoding(max_len: int, d_model: int) -> np.ndarray:
    """pe[:, 0::2] = sin, pe[:, 1::2] = cos (the motion module's table)."""
    position = np.arange(max_len)[:, None]
    div = np.exp(np.arange(0, d_model, 2) * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


def group_norm(x: torch.Tensor, norm: nn.GroupNorm, silu: bool = False) -> torch.Tensor:
    """GroupNorm (+ SiLU) computed in f32 and returned in x.dtype, like the
    reference's f32 flax GroupNorm. Statistics span every non-batch axis:
    a 5D input normalises across frames, a frame-folded 4D input per frame."""
    y = F.group_norm(x.float(), norm.num_groups, norm.weight.float(), norm.bias.float(),
                     norm.eps)
    return (F.silu(y) if silu else y).to(x.dtype)


def gn_silu(x: torch.Tensor, norm: nn.GroupNorm, silu: bool = False) -> torch.Tensor:
    """The reference's ``gn_silu``: `group_norm` by default, the GroupNorm
    kernels (``group_norm_silu_auto``) under ``LATENTSYNC_PALLAS_GN=1``."""
    if os.environ.get("LATENTSYNC_PALLAS_GN") == "1":
        return group_norm_silu_auto(x, norm.weight, norm.bias, norm.num_groups, norm.eps, silu)
    return group_norm(x, norm, silu)


def _fold(x: torch.Tensor) -> torch.Tensor:
    """(B, C, F, H, W) → (B·F, C, H, W)."""
    b, c, f, h, w = x.shape
    return x.permute(0, 2, 1, 3, 4).reshape(b * f, c, h, w)


def _unfold(x: torch.Tensor, b: int) -> torch.Tensor:
    """(B·F, C, H, W) → (B, C, F, H, W)."""
    bf, c, h, w = x.shape
    return x.reshape(b, bf // b, c, h, w).permute(0, 2, 1, 3, 4)


def _fused_blocks() -> bool:
    """The reference's routing of the attention blocks (``unet3d.py:396``,
    ``:412``, ``:528``): the fused ops unless ``LATENTSYNC_FUSED_ATTN=0`` or
    an int8 dense mode is on."""
    return fused_attn_block_enabled() and not int8_dense_enabled()


class InflatedConv2d(QConv2d):
    """2D conv applied per frame on (B, C, F, H, W) (the int8 convolution
    under ``LATENTSYNC_INT8=1``, with per-frame scales)."""

    def forward(self, x):
        return _unfold(super().forward(_fold(x)), x.shape[0])


class ResnetBlock3D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_ch: int, groups: int = 32,
                 eps: float = 1e-5, output_scale_factor: float = 1.0):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = InflatedConv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_ch, out_ch)
        self.norm2 = nn.GroupNorm(groups, out_ch, eps=eps)
        self.conv2 = InflatedConv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = InflatedConv2d(in_ch, out_ch, 1) if in_ch != out_ch else None
        self.output_scale_factor = output_scale_factor

    def forward(self, x, temb):
        h = self.conv1(gn_silu(x, self.norm1, silu=True))
        t = self.time_emb_proj(F.silu(temb.float()).to(x.dtype))
        h = h + t[:, :, None, None, None]
        h = self.conv2(gn_silu(h, self.norm2, silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return (x + h) / self.output_scale_factor


class Attention(nn.Module):
    """Parameter holder in the diffusers layout: unbiased to_q/to_k/to_v,
    biased to_out.0."""

    def __init__(self, query_dim: int, inner: int, kv_dim: Optional[int] = None):
        super().__init__()
        kv_dim = kv_dim or query_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(kv_dim, inner, bias=False)
        self.to_v = nn.Linear(kv_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim), nn.Dropout(0.0)])

    def weights(self):
        o = self.to_out[0]
        return self.to_q.weight, self.to_k.weight, self.to_v.weight, o.weight, o.bias


class _GEGLUProj(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)


class FeedForward(nn.Module):
    """GEGLU feed-forward, mult 4 (keys net.0.proj, net.2)."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([_GEGLUProj(dim, dim * 4), nn.Dropout(0.0),
                                  nn.Linear(dim * 4, dim)])

    def forward(self, x, norm: nn.LayerNorm):
        """x + FF(LN(x)): one fused op, or the reference's composition."""
        up, down = self.net[0].proj, self.net[2]
        if fused_ffn_enabled() and not int8_dense_enabled():
            return geglu_ffn(x, up.weight, up.bias, down.weight, down.bias,
                             ln_scale=norm.weight, ln_bias=norm.bias, residual=True,
                             eps=norm.eps)
        return geglu_ffn_composed(x, up.weight, up.bias, down.weight, down.bias, norm.weight,
                                  norm.bias, norm.eps, dense=dense_with_params)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, cross_dim: int,
                 add_audio_layer: bool):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = Attention(dim, inner)
        self.add_audio_layer = add_audio_layer
        if add_audio_layer:
            self.norm2 = nn.LayerNorm(dim, eps=1e-6)
            self.attn2 = Attention(dim, inner, cross_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim)

    def forward(self, x, audio=None):
        if _fused_blocks():
            self_attn, cross_attn = self_attention_block, cross_attention_block
        else:
            self_attn = functools.partial(self_attention_composed, dense=dense_with_params)
            cross_attn = functools.partial(cross_attention_composed, dense=dense_with_params)
        x = self_attn(x, self.norm1.weight, self.norm1.bias, *self.attn1.weights(), self.heads)
        if self.add_audio_layer and audio is not None:
            x = cross_attn(x, self.norm2.weight, self.norm2.bias, audio, *self.attn2.weights(),
                           self.heads)
        return self.ff(x, self.norm3)


class SpatialTransformer(nn.Module):
    """Transformer3DModel: per-frame GroupNorm, 1×1 conv projections."""

    def __init__(self, in_ch: int, heads: int, dim_head: int, cross_dim: int,
                 add_audio_layer: bool, groups: int = 32, num_layers: int = 1):
        super().__init__()
        inner = heads * dim_head
        self.norm = nn.GroupNorm(groups, in_ch, eps=1e-6)
        self.proj_in = nn.Conv2d(in_ch, inner, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, cross_dim, add_audio_layer)
            for _ in range(num_layers)])
        self.proj_out = nn.Conv2d(inner, in_ch, 1)

    def forward(self, x, audio=None):
        b, c, f, hh, ww = x.shape
        x2 = _fold(x)
        h = self.proj_in(gn_silu(x2, self.norm))
        inner = h.shape[1]
        h = h.permute(0, 2, 3, 1).reshape(b * f, hh * ww, inner)
        if audio is not None and audio.dim() == 4:
            audio = audio.reshape(b * f, audio.shape[2], audio.shape[3])
        for blk in self.transformer_blocks:
            h = blk(h, audio)
        h = h.reshape(b * f, hh, ww, inner).permute(0, 3, 1, 2)
        return _unfold(self.proj_out(h) + x2, b)


class TemporalTransformerBlock(nn.Module):
    """Two Temporal_Self attention blocks and a GEGLU feed-forward, over
    (B·S, F, C) sequences (keys attention_blocks.i, norms.i, ff, ff_norm)."""

    def __init__(self, dim: int, heads: int, n_attn: int):
        super().__init__()
        self.heads = heads
        self.attention_blocks = nn.ModuleList([Attention(dim, dim) for _ in range(n_attn)])
        self.norms = nn.ModuleList([nn.LayerNorm(dim, eps=1e-6) for _ in range(n_attn)])
        self.ff = FeedForward(dim)
        self.ff_norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, h, pe):
        block = self_attention_block if _fused_blocks() else functools.partial(
            self_attention_composed, dense=dense_with_params)
        for attn, norm in zip(self.attention_blocks, self.norms):
            h = block(h, norm.weight, norm.bias, *attn.weights(), self.heads, temporal=True,
                      pe=pe)
        return self.ff(h, self.ff_norm)


class TemporalModule(nn.Module):
    """VanillaTemporalModule → TemporalTransformer3DModel; state-dict keys
    nest under ``temporal_transformer.``."""

    def __init__(self, in_ch: int, mm: MotionModuleConfig, groups: int = 32):
        super().__init__()
        heads = mm.num_attention_heads
        inner = heads * (in_ch // heads // mm.temporal_attention_dim_div)
        tt = nn.Module()
        tt.norm = nn.GroupNorm(groups, in_ch, eps=1e-6)
        tt.proj_in = nn.Linear(in_ch, inner)
        tt.transformer_blocks = nn.ModuleList([
            TemporalTransformerBlock(inner, heads, len(mm.attention_block_types))
            for _ in range(mm.num_transformer_block)])
        tt.proj_out = nn.Linear(inner, in_ch)
        self.temporal_transformer = tt
        pe = (interleaved_positional_encoding(mm.temporal_position_encoding_max_len, inner)
              if mm.temporal_position_encoding else None)
        self.register_buffer("pe", None if pe is None else torch.from_numpy(pe),
                             persistent=False)

    def forward(self, x):
        tt = self.temporal_transformer
        b, c, f, hh, ww = x.shape
        s = hh * ww
        x2 = _fold(x)
        h = gn_silu(x2, tt.norm).permute(0, 2, 3, 1).reshape(b * f, s, c)
        h = tt.proj_in(h)
        inner = h.shape[-1]
        # one layout change for the block stack: (b·f, s, c) → (b·s, f, c)
        h = h.reshape(b, f, s, inner).transpose(1, 2).reshape(b * s, f, inner)
        pe = None if self.pe is None else self.pe[:f]
        for blk in tt.transformer_blocks:
            h = blk(h, pe)
        h = h.reshape(b, s, f, inner).transpose(1, 2).reshape(b * f, s, inner)
        h = tt.proj_out(h).reshape(b * f, hh, ww, c).permute(0, 3, 1, 2)
        return _unfold(h + x2, b)


class Downsample3D(nn.Module):
    def __init__(self, ch: int, padding: int = 1):
        super().__init__()
        self.conv = InflatedConv2d(ch, ch, 3, stride=2, padding=padding)

    def forward(self, x):
        return self.conv(x)


class Upsample3D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = InflatedConv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        b = x.shape[0]
        x2 = F.interpolate(_fold(x), scale_factor=2.0, mode="nearest")
        return self.conv(_unfold(x2, b))


class _Block(nn.Module):
    """One down/mid/up block's module lists (upstream key layout)."""

    def __init__(self, cfg: UNet3DConfig, in_chs, out_ch: int, has_attention: bool,
                 use_motion: bool, output_scale_factor: float = 1.0, n_layers=None):
        """`in_chs`: one resnet per input width; `n_layers` attention and
        motion layers (default one per resnet; the mid block has 2 resnets
        around 1)."""
        super().__init__()
        temb = cfg.time_embed_dim
        n = len(in_chs) if n_layers is None else n_layers
        self.resnets = nn.ModuleList([
            ResnetBlock3D(ci, out_ch, temb, cfg.norm_num_groups, cfg.norm_eps,
                          output_scale_factor) for ci in in_chs])
        self.attentions = nn.ModuleList([
            SpatialTransformer(out_ch, cfg.attention_head_dim,
                               out_ch // cfg.attention_head_dim, cfg.cross_attention_dim,
                               cfg.add_audio_layer, cfg.norm_num_groups)
            for _ in range(n)] if has_attention else [])
        self.motion_modules = nn.ModuleList([
            TemporalModule(out_ch, cfg.motion_module, cfg.norm_num_groups)
            for _ in range(n)] if use_motion else [])

    def layer(self, i, x, temb, audio):
        x = self.resnets[i](x, temb)
        if len(self.attentions):
            x = self.attentions[i](x, audio)
        if len(self.motion_modules):
            x = self.motion_modules[i](x)
        return x


class UNet3DConditionModel(nn.Module):
    """forward(sample (B, Cin, F, H, W), timesteps (B,) or scalar,
    encoder_hidden_states (B, F, S, D) or None) → eps (B, Cout, F, H, W)."""

    def __init__(self, config: UNet3DConfig = UNet3DConfig()):
        super().__init__()
        cfg = self.config = config
        chs = cfg.block_out_channels
        nb = len(chs)
        temb = cfg.time_embed_dim
        self.conv_in = InflatedConv2d(cfg.in_channels, chs[0], 3, padding=1)
        te = nn.Module()
        te.linear_1 = nn.Linear(chs[0], temb)
        te.linear_2 = nn.Linear(temb, temb)
        self.time_embedding = te

        self.down_blocks = nn.ModuleList()
        skip_chs = [chs[0]]
        ch = chs[0]
        for i, btype in enumerate(cfg.down_block_types):
            use_mm = (cfg.use_motion_module and 2**i in cfg.motion_module_resolutions
                      and not cfg.motion_module_decoder_only)
            blk = _Block(cfg, [ch] + [chs[i]] * (cfg.layers_per_block - 1), chs[i],
                         btype.startswith("CrossAttn"), use_mm)
            skip_chs += [chs[i]] * cfg.layers_per_block
            if i < nb - 1:
                blk.downsamplers = nn.ModuleList([Downsample3D(chs[i], cfg.downsample_padding)])
                skip_chs.append(chs[i])
            self.down_blocks.append(blk)
            ch = chs[i]

        self.mid_block = _Block(cfg, [ch, ch], ch, True,
                                cfg.use_motion_module and cfg.motion_module_mid_block,
                                cfg.mid_block_scale_factor, n_layers=1)

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(chs))
        for i, btype in enumerate(cfg.up_block_types):
            use_mm = cfg.use_motion_module and 2 ** (nb - 1 - i) in cfg.motion_module_resolutions
            in_chs = []
            for _ in range(cfg.layers_per_block + 1):
                in_chs.append(ch + skip_chs.pop())
                ch = rev[i]
            blk = _Block(cfg, in_chs, rev[i], btype.startswith("CrossAttn"), use_mm)
            if i < nb - 1:
                blk.upsamplers = nn.ModuleList([Upsample3D(rev[i])])
            self.up_blocks.append(blk)

        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, chs[0], eps=cfg.norm_eps)
        self.conv_out = InflatedConv2d(chs[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, encoder_hidden_states=None, deep_cache=None,
                cache_depth: int = 0, cache_read: bool = False, cache_encoder: bool = False,
                cache_sub: int = 0):
        """The reference's DeepCache paths (``cache_depth`` d > 0): the call
        returns ``(eps, cache)``. A write step (``cache_read=False``) is the
        exact forward and caches the feature entering up block nb - d; a
        read step fed that feature runs conv_in and down blocks 0..d-1 only
        (not the last one's downsampler, which fed the skipped deep trunk)
        and splices it in. With ``cache_encoder`` the cache is (deep
        feature, the shallow skips still unconsumed there) and a read runs
        up blocks nb - d.. and conv_out alone; ``cache_sub`` k (encoder mode
        only, at most layers_per_block) moves the cut to the feature
        entering layer k of that first cached up block, before its skip
        concat, and keeps the skips of layers k.. only. A read returns the
        cache it was given. Cached tensors are in this layout, (B, C, F, H,
        W)."""
        cfg = self.config
        dt = self.conv_in.weight.dtype
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                   cfg.flip_sin_to_cos, cfg.freq_shift).to(dt)
        emb = self.time_embedding.linear_2(F.silu(self.time_embedding.linear_1(t_emb)))
        if cfg.center_input_sample:
            sample = 2 * sample - 1.0
        audio = encoder_hidden_states
        nb = len(self.down_blocks)
        read = bool(cache_depth) and cache_read
        enc = bool(cache_depth) and cache_encoder
        sub = min(cache_sub, cfg.layers_per_block) if enc else 0
        n_down = (0 if enc else cache_depth) if read else nb
        skips = []
        if n_down:
            x = self.conv_in(sample.to(dt))
            skips.append(x)
        for i, blk in enumerate(self.down_blocks[:n_down]):
            for j in range(len(blk.resnets)):
                x = blk.layer(j, x, emb, audio)
                skips.append(x)
            # a read's last shallow downsampler would feed only the deep trunk
            if hasattr(blk, "downsamplers") and not (read and i == n_down - 1):
                x = blk.downsamplers[0](x)
                skips.append(x)
        if read and enc:
            deep, cached_skips = deep_cache
            x, skips = deep.to(dt), [s.to(dt) for s in cached_skips]
        elif read:
            x = deep_cache.to(dt)
        else:
            mid = self.mid_block
            x = mid.resnets[0](x, emb)
            x = mid.attentions[0](x, audio)
            if len(mid.motion_modules):
                x = mid.motion_modules[0](x)
            x = mid.resnets[1](x, emb)
        cache_out = deep_cache
        for i, blk in enumerate(self.up_blocks):
            if read and i < nb - cache_depth:
                continue
            first_cached = bool(cache_depth) and i == nb - cache_depth
            start = sub if first_cached and read else 0
            if first_cached and not read and not sub:
                cache_out = (x, tuple(skips)) if enc else x
            for j in range(start, len(blk.resnets)):
                if first_cached and not read and sub and j == sub:
                    cache_out = (x, tuple(skips))
                x = blk.layer(j, torch.cat([x, skips.pop()], dim=1), emb, audio)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        x = gn_silu(x, self.conv_norm_out, silu=True)
        eps = self.conv_out(x)
        return (eps, cache_out) if cache_depth else eps
