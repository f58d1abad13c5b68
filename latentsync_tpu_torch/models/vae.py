"""Stable Diffusion AutoencoderKL (sd-vae-ft-mse shape) in torch.

Counterpart of ``latentsync_tpu/models/vae.py``: GroupNorm(32, eps 1e-6)
+ SiLU throughout, SD's asymmetric (0, 1) padding before each stride-2
downsample, a single-head mid-block attention, deterministic (mode)
encoding. Layout is NCHW; parameter names follow diffusers, the layout
``latentsync_tpu.utils.convert.convert_vae`` reads.

The mid-block attention (S = 1024 at 256² faces, one head, D = 512)
goes through the routed ``ops.attention.dot_product_attention``, which
launches the flash kernel on the card. The GroupNorms stay plain
``group_norm`` whatever ``LATENTSYNC_PALLAS_GN`` says: the reference's
VAE never reads that switch. Under ``LATENTSYNC_INT8=1`` exactly the
reference's ``QConv`` set runs as the int8 convolution (``QConv2d``): the
resnets' conv1/conv2, the samplers, and the encoder's and decoder's
conv_in/conv_out; the 1×1 shortcuts, quant_conv, post_quant_conv and the
attention projections stay float, as there. Decoding runs under autograd
(the trainer's x̂₀): the mid-block's flash route has a backward kernel.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import VAEConfig
from ..ops.attention import dot_product_attention
from ..ops.qconv import QConv2d
from .unet3d import group_norm


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=1e-6)
        self.conv1 = QConv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, out_ch, eps=1e-6)
        self.conv2 = QConv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(group_norm(x, self.norm1, silu=True))
        h = self.conv2(group_norm(h, self.norm2, silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the H·W positions (diffusers keys)."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch), nn.Dropout(0.0)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = group_norm(x, self.group_norm).permute(0, 2, 3, 1).reshape(b, h * w, 1, c)
        o = dot_product_attention(self.to_q(y), self.to_k(y), self.to_v(y))
        o = self.to_out[0](o.reshape(b, h * w, c))
        return x + o.reshape(b, h, w, c).permute(0, 3, 1, 2)


class _Sampler(nn.Module):
    def __init__(self, ch: int, stride: int):
        super().__init__()
        self.conv = QConv2d(ch, ch, 3, stride=stride, padding=0 if stride == 2 else 1)


def _mid(ch: int, groups: int) -> nn.Module:
    mid = nn.Module()
    mid.resnets = nn.ModuleList([ResnetBlock(ch, ch, groups), ResnetBlock(ch, ch, groups)])
    mid.attentions = nn.ModuleList([AttnBlock(ch, groups)])
    return mid


def _run_mid(mid: nn.Module, h):
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))


class AutoencoderKL(nn.Module):
    """Input/output (B, 3, H, W) in [-1, 1]; latents (B, 4, H/8, W/8)."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = cfg = config
        chs = cfg.block_out_channels
        g = cfg.norm_num_groups
        lat = cfg.latent_channels

        enc = nn.Module()
        enc.conv_in = QConv2d(cfg.in_channels, chs[0], 3, padding=1)
        enc.down_blocks = nn.ModuleList()
        ch = chs[0]
        for i, co in enumerate(chs):
            blk = nn.Module()
            blk.resnets = nn.ModuleList([ResnetBlock(ch if j == 0 else co, co, g)
                                         for j in range(cfg.layers_per_block)])
            if i < len(chs) - 1:
                blk.downsamplers = nn.ModuleList([_Sampler(co, 2)])
            enc.down_blocks.append(blk)
            ch = co
        enc.mid_block = _mid(ch, g)
        enc.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        enc.conv_out = QConv2d(ch, 2 * lat, 3, padding=1)
        self.encoder = enc

        dec = nn.Module()
        rev = list(reversed(chs))
        dec.conv_in = QConv2d(lat, rev[0], 3, padding=1)
        dec.mid_block = _mid(rev[0], g)
        dec.up_blocks = nn.ModuleList()
        ch = rev[0]
        for i, co in enumerate(rev):
            blk = nn.Module()
            blk.resnets = nn.ModuleList([ResnetBlock(ch if j == 0 else co, co, g)
                                         for j in range(cfg.layers_per_block + 1)])
            if i < len(rev) - 1:
                blk.upsamplers = nn.ModuleList([_Sampler(co, 1)])
            dec.up_blocks.append(blk)
            ch = co
        dec.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        dec.conv_out = QConv2d(ch, cfg.out_channels, 3, padding=1)
        self.decoder = dec

        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)

    def moments(self, x):
        """Posterior (mean, logvar clipped to [-30, 20])."""
        enc = self.encoder
        h = enc.conv_in(x.to(enc.conv_in.weight.dtype))
        for blk in enc.down_blocks:
            for r in blk.resnets:
                h = r(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        h = _run_mid(enc.mid_block, h)
        h = enc.conv_out(group_norm(h, enc.conv_norm_out, silu=True))
        mean, logvar = self.quant_conv(h).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x):
        """Unscaled latents, the posterior mode."""
        return self.moments(x)[0]

    def decode(self, z):
        dec = self.decoder
        h = dec.conv_in(self.post_quant_conv(z.to(dec.conv_in.weight.dtype)))
        h = _run_mid(dec.mid_block, h)
        for blk in dec.up_blocks:
            for r in blk.resnets:
                h = r(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return dec.conv_out(group_norm(h, dec.conv_norm_out, silu=True))


def scale_latents(z, cfg: VAEConfig):
    return (z - cfg.shift_factor) * cfg.scaling_factor


def unscale_latents(z, cfg: VAEConfig):
    return z / cfg.scaling_factor + cfg.shift_factor
