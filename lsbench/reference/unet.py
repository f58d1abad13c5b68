"""The audio-conditioned 3D UNet of LatentSync 1.5 stage 2, plain.

A frozen plain form of the served model: parameter names and shapes in the
upstream checkpoint layout (``bytedance/LatentSync`` ``latentsync/models/
unet.py``), every product through :class:`Numerics`, no kernel, no cache
beyond DeepCache's own feature, no batching. The layer equations:

- ResnetBlock3D: GroupNorm + SiLU over (C/G, F, H, W) of the 5-D input,
  a 3x3 conv per frame, + Linear(SiLU(temb)), GroupNorm + SiLU, a 3x3 conv,
  + the input (a 1x1 conv where widths differ), / output_scale_factor.
- Transformer3DModel: GroupNorm per frame, a 1x1 conv in, per transformer
  block self-attention (LayerNorm, q/k/v unbiased, 8 heads, softmax,
  out-projection with bias, residual), audio cross-attention (q from the
  LayerNorm of x, k/v from the raw whisper chunk of the frame), a GEGLU
  feed-forward (LayerNorm, up 8C with bias: value first, gate second,
  exact GELU; down with bias; residual), a 1x1 conv out, + the input.
- Motion module (AnimateDiff): GroupNorm per frame, Linear in, two
  temporal self-attentions over the F frames of each position (sinusoidal
  positions added after the LayerNorm), the GEGLU feed-forward, Linear
  out, + the input.
- DeepCache (arXiv:2312.00858): a write step caches the feature entering
  up block nb - d (with ``enc``, also the shallow skips still unconsumed);
  a read step runs only what lies above the cut.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .numerics import Numerics


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0) -> torch.Tensor:
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device)
    args = t.float()[:, None] * torch.exp(exponent / (half - freq_shift))[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)] if flip_sin_to_cos
                    else [torch.sin(args), torch.cos(args)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


def positional_table(max_len: int, d: int) -> torch.Tensor:
    pos = np.arange(max_len)[:, None]
    div = np.exp(np.arange(0, d, 2) * (-math.log(10000.0) / d))
    pe = np.zeros((max_len, d), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe)


def gn(x, norm: nn.GroupNorm, silu: bool = False):
    y = F.group_norm(x.float(), norm.num_groups, norm.weight.float(), norm.bias.float(),
                     norm.eps)
    return F.silu(y) if silu else y


def ln(x, norm: nn.LayerNorm):
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps)


def fold(x):
    b, c, f, h, w = x.shape
    return x.permute(0, 2, 1, 3, 4).reshape(b * f, c, h, w)


def unfold(x, b):
    bf, c, h, w = x.shape
    return x.reshape(b, bf // b, c, h, w).permute(0, 2, 1, 3, 4)


def attention(num: Numerics, q, k, v, heads: int):
    """q (B, Sq, H·D), k/v (B, Sk, H·D) → (B, Sq, H·D); f32 softmax."""
    b, sq, hd = q.shape
    sk = k.shape[1]
    d = hd // heads
    qh = q.reshape(b, sq, heads, d).transpose(1, 2)
    kh = k.reshape(b, sk, heads, d).transpose(1, 2)
    vh = v.reshape(b, sk, heads, d).transpose(1, 2)
    p = torch.softmax(num.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(d), dim=-1)
    return num.matmul(p, vh).transpose(1, 2).reshape(b, sq, hd)


class Conv(nn.Conv2d):
    """A per-frame conv; `int8` when the configuration quantizes it."""

    def run(self, num, x, int8: bool):
        return num.conv2d(x, self.weight, self.bias, self.stride, self.padding, int8=int8)


class Resnet(nn.Module):
    def __init__(self, cin, cout, temb, groups, eps, scale):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = Conv(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = Conv(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv(cin, cout, 1) if cin != cout else None
        self.scale = scale

    def forward(self, m, x, temb):
        b = x.shape[0]
        h = unfold(self.conv1.run(m.num, fold(gn(x, self.norm1, True)), m.int8), b)
        t = m.num.linear(F.silu(temb), self.time_emb_proj.weight, self.time_emb_proj.bias)
        h = h + t[:, :, None, None, None]
        h = unfold(self.conv2.run(m.num, fold(gn(h, self.norm2, True)), m.int8), b)
        if self.conv_shortcut is not None:
            x = unfold(self.conv_shortcut.run(m.num, fold(x), m.int8), b)
        return (x + h) / self.scale


class Attn(nn.Module):
    def __init__(self, qdim, inner, kvdim=None):
        super().__init__()
        kvdim = kvdim or qdim
        self.to_q = nn.Linear(qdim, inner, bias=False)
        self.to_k = nn.Linear(kvdim, inner, bias=False)
        self.to_v = nn.Linear(kvdim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, qdim), nn.Dropout(0.0)])

    def forward(self, num, h, ctx, heads):
        q = num.linear(h, self.to_q.weight)
        k = num.linear(ctx, self.to_k.weight)
        v = num.linear(ctx, self.to_v.weight)
        o = self.to_out[0]
        return num.linear(attention(num, q, k, v, heads), o.weight, o.bias)


class GEGLUProj(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([GEGLUProj(dim, 4 * dim), nn.Dropout(0.0),
                                  nn.Linear(4 * dim, dim)])

    def forward(self, num, x, norm):
        up, down = self.net[0].proj, self.net[2]
        value, gate = num.linear(ln(x, norm), up.weight, up.bias).chunk(2, dim=-1)
        return x + num.linear(value * F.gelu(gate), down.weight, down.bias)


class TransformerBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, cross_dim, audio):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = Attn(dim, inner)
        self.add_audio_layer = audio
        if audio:
            self.norm2 = nn.LayerNorm(dim, eps=1e-6)
            self.attn2 = Attn(dim, inner, cross_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim)

    def forward(self, num, x, audio):
        h = ln(x, self.norm1)
        x = x + self.attn1(num, h, h, self.heads)
        if self.add_audio_layer and audio is not None:
            x = x + self.attn2(num, ln(x, self.norm2), audio, self.heads)
        return self.ff(num, x, self.norm3)


class Transformer3D(nn.Module):
    def __init__(self, ch, heads, dim_head, cross_dim, audio, groups):
        super().__init__()
        inner = heads * dim_head
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = nn.Conv2d(ch, inner, 1)
        self.transformer_blocks = nn.ModuleList([
            TransformerBlock(inner, heads, dim_head, cross_dim, audio)])
        self.proj_out = nn.Conv2d(inner, ch, 1)

    def forward(self, m, x, audio):
        b, c, f, hh, ww = x.shape
        x2 = fold(x)
        h = m.num.conv2d(gn(x2, self.norm), self.proj_in.weight, self.proj_in.bias)
        inner = h.shape[1]
        h = h.permute(0, 2, 3, 1).reshape(b * f, hh * ww, inner)
        a = None if audio is None else audio.reshape(b * f, audio.shape[2], audio.shape[3])
        for blk in self.transformer_blocks:
            h = blk(m.num, h, a)
        h = h.reshape(b * f, hh, ww, inner).permute(0, 3, 1, 2)
        return unfold(m.num.conv2d(h, self.proj_out.weight, self.proj_out.bias) + x2, b)


class TemporalBlock(nn.Module):
    def __init__(self, dim, heads, n_attn):
        super().__init__()
        self.heads = heads
        self.attention_blocks = nn.ModuleList([Attn(dim, dim) for _ in range(n_attn)])
        self.norms = nn.ModuleList([nn.LayerNorm(dim, eps=1e-6) for _ in range(n_attn)])
        self.ff = FeedForward(dim)
        self.ff_norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, num, h, pe):
        for attn, norm in zip(self.attention_blocks, self.norms):
            hn = ln(h, norm) + pe
            h = h + attn(num, hn, hn, self.heads)
        return self.ff(num, h, self.ff_norm)


class MotionModule(nn.Module):
    def __init__(self, ch, mm: dict, groups):
        super().__init__()
        heads = mm["num_attention_heads"]
        inner = heads * (ch // heads // mm["temporal_attention_dim_div"])
        tt = nn.Module()
        tt.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        tt.proj_in = nn.Linear(ch, inner)
        tt.transformer_blocks = nn.ModuleList([
            TemporalBlock(inner, heads, len(mm["attention_block_types"]))
            for _ in range(mm["num_transformer_block"])])
        tt.proj_out = nn.Linear(inner, ch)
        self.temporal_transformer = tt
        self.pe_len = mm["temporal_position_encoding_max_len"]

    def forward(self, m, x):
        tt = self.temporal_transformer
        b, c, f, hh, ww = x.shape
        s = hh * ww
        x2 = fold(x)
        h = gn(x2, tt.norm).permute(0, 2, 3, 1).reshape(b * f, s, c)
        h = m.num.linear(h, tt.proj_in.weight, tt.proj_in.bias)
        inner = h.shape[-1]
        h = h.reshape(b, f, s, inner).transpose(1, 2).reshape(b * s, f, inner)
        pe = positional_table(self.pe_len, inner).to(h.device)[:f]
        for blk in tt.transformer_blocks:
            h = blk(m.num, h, pe)
        h = h.reshape(b, s, f, inner).transpose(1, 2).reshape(b * f, s, inner)
        h = m.num.linear(h, tt.proj_out.weight, tt.proj_out.bias)
        return unfold(h.reshape(b * f, hh, ww, c).permute(0, 3, 1, 2) + x2, b)


class Sampler(nn.Module):
    def __init__(self, ch, stride, padding):
        super().__init__()
        self.conv = Conv(ch, ch, 3, stride=stride, padding=padding)


class Block(nn.Module):
    def __init__(self, cfg, in_chs, out_ch, attn, motion, scale=1.0, n_layers=None):
        super().__init__()
        temb = cfg["block_out_channels"][0] * 4
        g = cfg["norm_num_groups"]
        n = len(in_chs) if n_layers is None else n_layers
        heads = cfg["attention_head_dim"]
        self.resnets = nn.ModuleList([Resnet(ci, out_ch, temb, g, cfg["norm_eps"], scale)
                                      for ci in in_chs])
        self.attentions = nn.ModuleList([
            Transformer3D(out_ch, heads, out_ch // heads, cfg["cross_attention_dim"],
                          cfg["add_audio_layer"], g) for _ in range(n)] if attn else [])
        self.motion_modules = nn.ModuleList([
            MotionModule(out_ch, cfg["motion_module"], g) for _ in range(n)] if motion else [])

    def layer(self, m, i, x, temb, audio):
        x = self.resnets[i](m, x, temb)
        if len(self.attentions):
            x = self.attentions[i](m, x, audio)
        if len(self.motion_modules):
            x = self.motion_modules[i](m, x)
        return x


class UNet3D(nn.Module):
    """forward(sample (B, Cin, F, H, W), t (B,), audio (B, F, S, D)) → eps,
    or (eps, cache) on a DeepCache step."""

    def __init__(self, cfg: dict, num: Numerics = None, int8: bool = False):
        super().__init__()
        self.cfg = cfg
        self.num = num or Numerics("f32")
        self.int8 = int8
        chs = cfg["block_out_channels"]
        nb = len(chs)
        lpb = cfg["layers_per_block"]
        mm_res = cfg["motion_module_resolutions"]
        self.conv_in = Conv(cfg["in_channels"], chs[0], 3, padding=1)
        te = nn.Module()
        te.linear_1 = nn.Linear(chs[0], chs[0] * 4)
        te.linear_2 = nn.Linear(chs[0] * 4, chs[0] * 4)
        self.time_embedding = te
        self.down_blocks = nn.ModuleList()
        skip = [chs[0]]
        ch = chs[0]
        for i, bt in enumerate(cfg["down_block_types"]):
            motion = cfg["use_motion_module"] and 2**i in mm_res \
                and not cfg["motion_module_decoder_only"]
            blk = Block(cfg, [ch] + [chs[i]] * (lpb - 1), chs[i], bt.startswith("CrossAttn"),
                        motion)
            skip += [chs[i]] * lpb
            if i < nb - 1:
                blk.downsamplers = nn.ModuleList([Sampler(chs[i], 2, cfg["downsample_padding"])])
                skip.append(chs[i])
            self.down_blocks.append(blk)
            ch = chs[i]
        self.mid_block = Block(cfg, [ch, ch], ch, True,
                               cfg["use_motion_module"] and cfg["motion_module_mid_block"],
                               cfg["mid_block_scale_factor"], n_layers=1)
        self.up_blocks = nn.ModuleList()
        rev = list(reversed(chs))
        for i, bt in enumerate(cfg["up_block_types"]):
            motion = cfg["use_motion_module"] and 2 ** (nb - 1 - i) in mm_res
            in_chs = []
            for _ in range(lpb + 1):
                in_chs.append(ch + skip.pop())
                ch = rev[i]
            blk = Block(cfg, in_chs, rev[i], bt.startswith("CrossAttn"), motion)
            if i < nb - 1:
                blk.upsamplers = nn.ModuleList([Sampler(rev[i], 1, 1)])
            self.up_blocks.append(blk)
        self.conv_norm_out = nn.GroupNorm(cfg["norm_num_groups"], chs[0], eps=cfg["norm_eps"])
        self.conv_out = Conv(chs[0], cfg["out_channels"], 3, padding=1)

    def _conv5(self, conv, x):
        return unfold(conv.run(self.num, fold(x), self.int8), x.shape[0])

    def forward(self, sample, t, audio, cache=None, depth: int = 0, read: bool = False,
                enc: bool = False, sub: int = 0):
        cfg = self.cfg
        num = self.num
        chs = cfg["block_out_channels"]
        nb = len(self.down_blocks)
        temb = timestep_embedding(t, chs[0], cfg["flip_sin_to_cos"], cfg["freq_shift"])
        te = self.time_embedding
        emb = num.linear(F.silu(num.linear(temb, te.linear_1.weight, te.linear_1.bias)),
                         te.linear_2.weight, te.linear_2.bias)
        read = bool(depth) and read
        enc = bool(depth) and enc
        sub = min(sub, cfg["layers_per_block"]) if enc else 0
        n_down = (0 if enc else depth) if read else nb
        skips = []
        x = None
        if n_down:
            x = self._conv5(self.conv_in, sample.float())
            skips.append(x)
        for i, blk in enumerate(self.down_blocks[:n_down]):
            for j in range(len(blk.resnets)):
                x = blk.layer(self, j, x, emb, audio)
                skips.append(x)
            if hasattr(blk, "downsamplers") and not (read and i == n_down - 1):
                x = self._conv5(blk.downsamplers[0].conv, x)
                skips.append(x)
        if read and enc:
            x, skips = cache[0], list(cache[1])
        elif read:
            x = cache
        else:
            mid = self.mid_block
            x = mid.resnets[0](self, x, emb)
            x = mid.attentions[0](self, x, audio)
            if len(mid.motion_modules):
                x = mid.motion_modules[0](self, x)
            x = mid.resnets[1](self, x, emb)
        cache_out = cache
        for i, blk in enumerate(self.up_blocks):
            if read and i < nb - depth:
                continue
            first = bool(depth) and i == nb - depth
            start = sub if first and read else 0
            if first and not read and not sub:
                cache_out = (x, tuple(skips)) if enc else x
            for j in range(start, len(blk.resnets)):
                if first and not read and sub and j == sub:
                    cache_out = (x, tuple(skips))
                x = blk.layer(self, j, torch.cat([x, skips.pop()], dim=1), emb, audio)
            if hasattr(blk, "upsamplers"):
                b = x.shape[0]
                x2 = F.interpolate(fold(x), scale_factor=2.0, mode="nearest")
                x = self._conv5(blk.upsamplers[0].conv, unfold(x2, b))
        eps = self._conv5(self.conv_out, gn(x, self.conv_norm_out, True))
        return (eps, cache_out) if depth else eps
