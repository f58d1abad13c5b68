"""Stable Diffusion's AutoencoderKL (the sd-vae-ft-mse shape), plain.

Diffusers' parameter names; GroupNorm(32, eps 1e-6) + SiLU, SD's (0, 1)
padding before each stride-2 conv, a one-head mid-block attention over the
H·W positions, the posterior mean as the encoding. Under the
configuration's int8 route the resnets' conv1 / conv2, the samplers and
the encoder's and decoder's conv_in / conv_out are int8 convolutions; the
1x1 shortcuts, quant_conv, post_quant_conv and the attention stay float.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .numerics import Numerics
from .unet import attention, gn


class Resnet(nn.Module):
    def __init__(self, cin, cout, groups):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-6)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, v, x):
        h = v.qconv(self.conv1, gn(x, self.norm1, True))
        h = v.qconv(self.conv2, gn(h, self.norm2, True))
        if self.conv_shortcut is not None:
            x = v.num.conv2d(x, self.conv_shortcut.weight, self.conv_shortcut.bias)
        return x + h


class AttnBlock(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch), nn.Dropout(0.0)])

    def forward(self, v, x):
        b, c, h, w = x.shape
        y = gn(x, self.group_norm).permute(0, 2, 3, 1).reshape(b, h * w, c)
        num = v.num
        o = attention(num, num.linear(y, self.to_q.weight, self.to_q.bias),
                      num.linear(y, self.to_k.weight, self.to_k.bias),
                      num.linear(y, self.to_v.weight, self.to_v.bias), 1)
        o = num.linear(o, self.to_out[0].weight, self.to_out[0].bias)
        return x + o.reshape(b, h, w, c).permute(0, 3, 1, 2)


class Sampler(nn.Module):
    def __init__(self, ch, stride):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=stride, padding=0 if stride == 2 else 1)


def _mid(ch, groups):
    mid = nn.Module()
    mid.resnets = nn.ModuleList([Resnet(ch, ch, groups), Resnet(ch, ch, groups)])
    mid.attentions = nn.ModuleList([AttnBlock(ch, groups)])
    return mid


class VAE(nn.Module):
    def __init__(self, cfg: dict, num: Numerics = None, int8: bool = False):
        super().__init__()
        self.cfg = cfg
        self.num = num or Numerics("f32")
        self.int8 = int8
        chs = cfg["block_out_channels"]
        g = cfg["norm_num_groups"]
        lat = cfg["latent_channels"]
        lpb = cfg["layers_per_block"]
        enc = nn.Module()
        enc.conv_in = nn.Conv2d(cfg["in_channels"], chs[0], 3, padding=1)
        enc.down_blocks = nn.ModuleList()
        ch = chs[0]
        for i, co in enumerate(chs):
            blk = nn.Module()
            blk.resnets = nn.ModuleList([Resnet(ch if j == 0 else co, co, g) for j in range(lpb)])
            if i < len(chs) - 1:
                blk.downsamplers = nn.ModuleList([Sampler(co, 2)])
            enc.down_blocks.append(blk)
            ch = co
        enc.mid_block = _mid(ch, g)
        enc.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        enc.conv_out = nn.Conv2d(ch, 2 * lat, 3, padding=1)
        self.encoder = enc
        dec = nn.Module()
        rev = list(reversed(chs))
        dec.conv_in = nn.Conv2d(lat, rev[0], 3, padding=1)
        dec.mid_block = _mid(rev[0], g)
        dec.up_blocks = nn.ModuleList()
        ch = rev[0]
        for i, co in enumerate(rev):
            blk = nn.Module()
            blk.resnets = nn.ModuleList([Resnet(ch if j == 0 else co, co, g)
                                         for j in range(lpb + 1)])
            if i < len(rev) - 1:
                blk.upsamplers = nn.ModuleList([Sampler(co, 1)])
            dec.up_blocks.append(blk)
            ch = co
        dec.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        dec.conv_out = nn.Conv2d(ch, cfg["out_channels"], 3, padding=1)
        self.decoder = dec
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)

    def qconv(self, conv, x):
        return self.num.conv2d(x, conv.weight, conv.bias, conv.stride, conv.padding,
                               int8=self.int8)

    @staticmethod
    def _mid_run(v, mid, h):
        return mid.resnets[1](v, mid.attentions[0](v, mid.resnets[0](v, h)))

    def encode(self, x):
        """(B, 3, H, W) in [-1, 1] → unscaled latents, the posterior mean."""
        enc = self.encoder
        h = self.qconv(enc.conv_in, x.float())
        for blk in enc.down_blocks:
            for r in blk.resnets:
                h = r(self, h)
            if hasattr(blk, "downsamplers"):
                h = self.qconv(blk.downsamplers[0].conv, F.pad(h, (0, 1, 0, 1)))
        h = self._mid_run(self, enc.mid_block, h)
        h = self.qconv(enc.conv_out, gn(h, enc.conv_norm_out, True))
        h = self.num.conv2d(h, self.quant_conv.weight, self.quant_conv.bias)
        return h.chunk(2, dim=1)[0]

    def decode(self, z):
        dec = self.decoder
        h = self.num.conv2d(z.float(), self.post_quant_conv.weight, self.post_quant_conv.bias)
        h = self.qconv(dec.conv_in, h)
        h = self._mid_run(self, dec.mid_block, h)
        for blk in dec.up_blocks:
            for r in blk.resnets:
                h = r(self, h)
            if hasattr(blk, "upsamplers"):
                h = self.qconv(blk.upsamplers[0].conv,
                               F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return self.qconv(dec.conv_out, gn(h, dec.conv_norm_out, True))


def decode_u8(vae: VAE, latents: torch.Tensor, scaling: float, shift: float) -> torch.Tensor:
    """(N, h, w, 4) scaled latents → (N, H, W, 3) uint8."""
    z = latents.permute(0, 3, 1, 2).float() / scaling + shift
    img = vae.decode(z)
    return ((img + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
