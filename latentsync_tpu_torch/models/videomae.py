"""VideoMAE-style video ViT and the TREPA loss of stage-2 training.

Counterpart of ``latentsync_tpu/models/videomae.py`` (``VideoViTConfig``,
``ViTBlock``, ``VideoViT``, ``TREPALoss``; ref:latentsync/trepa/loss.py:21-54
and the vendored VideoMAEv2 finetune model): a tubelet-embedded joint
space-time ViT with a fixed sinusoid position table, mean pooling and
``fc_norm``. Layout is torch's: the ViT takes (B, 3, T, H, W), the loss
(B, F, 3, H, W) frames. Parameter names follow the upstream checkpoint
(``patch_embed.proj``, ``blocks.N.{norm1,attn.{qkv,q_bias,v_bias,proj},
norm2,mlp.{fc1,fc2}}``, ``fc_norm``), the layout
``latentsync_tpu.models.videomae.convert_videomae`` reads: the q/k/v
projection has no bias of its own and adds [q_bias, 0, v_bias].
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention
from ..ops.ffn import layer_norm_f32


@dataclass(frozen=True)
class VideoViTConfig:
    img_size: int = 224
    num_frames: int = 16
    patch_size: int = 14
    tubelet_size: int = 2
    embed_dim: int = 1408
    depth: int = 40
    num_heads: int = 16
    mlp_ratio: float = 48 / 11

    @classmethod
    def giant(cls):
        return cls()


def sinusoid_encoding_table(n_position: int, d_hid: int) -> np.ndarray:
    """sin on even dims, cos on odd dims (ref:videomaev2_finetune.py:357-368)."""
    pos = np.arange(n_position)[:, None]
    i = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (i // 2) / d_hid)
    table = np.zeros((n_position, d_hid), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


class _Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = nn.Linear(dim, dim)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _Attention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        b, t, dim = x.shape
        dt = x.dtype
        a = self.attn
        h = layer_norm_f32(x, self.norm1.weight, self.norm1.bias, 1e-6).to(dt)
        bias = torch.cat([a.q_bias, torch.zeros_like(a.q_bias), a.v_bias])
        qkv = F.linear(h, a.qkv.weight, bias).reshape(b, t, 3, self.heads, dim // self.heads)
        o = dot_product_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        x = x + a.proj(o.reshape(b, t, dim))
        h = layer_norm_f32(x, self.norm2.weight, self.norm2.bias, 1e-6).to(dt)
        h = self.mlp.fc1(h)
        h = 0.5 * h * torch.erfc(-h * math.sqrt(0.5))
        return x + self.mlp.fc2(h)


class VideoViT(nn.Module):
    """forward(video (B, 3, T, H, W)) → (B, embed_dim) f32 pooled features."""

    def __init__(self, config: VideoViTConfig = VideoViTConfig.giant()):
        super().__init__()
        cfg = self.config = config
        pe = nn.Module()
        pe.proj = nn.Conv3d(3, cfg.embed_dim, (cfg.tubelet_size, cfg.patch_size, cfg.patch_size),
                            stride=(cfg.tubelet_size, cfg.patch_size, cfg.patch_size))
        self.patch_embed = pe
        self.blocks = nn.ModuleList([ViTBlock(cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio)
                                     for _ in range(cfg.depth)])
        self.fc_norm = nn.LayerNorm(cfg.embed_dim, eps=1e-6)

    def forward(self, video):
        proj = self.patch_embed.proj
        dt = proj.weight.dtype
        x = proj(video.to(dt)).flatten(2).transpose(1, 2)  # tokens in (t, h, w) order
        table = sinusoid_encoding_table(x.shape[1], self.config.embed_dim)
        x = x + torch.from_numpy(table).to(x.device, dt)[None]
        for blk in self.blocks:
            x = blk(x)
        return layer_norm_f32(x.mean(dim=1), self.fc_norm.weight, self.fc_norm.bias, 1e-6)


class TREPALoss:
    """Temporal-representation alignment (ref:trepa/loss.py:21-54): frames
    resized to the ViT's size (bilinear, antialiased when downsampling, as
    ``jax.image.resize``), tiled up to its frame count, features unit-
    normalised, their mean squared difference."""

    def __init__(self, model: VideoViT):
        self.model = model
        self.config = model.config

    def _prep(self, v):
        cfg = self.config
        b, f = v.shape[:2]
        flat = F.interpolate(v.reshape((b * f,) + v.shape[2:]), size=(cfg.img_size,) * 2,
                             mode="bilinear", align_corners=False, antialias=True)
        vid = flat.reshape(b, f, 3, cfg.img_size, cfg.img_size)
        if f < cfg.num_frames:
            vid = vid.repeat(1, -(-cfg.num_frames // f), 1, 1, 1)
        return vid[:, :cfg.num_frames].transpose(1, 2)

    def __call__(self, pred_video, gt_video):
        """(B, F, 3, H, W) each, in [-1, 1] → scalar loss."""
        fa = self.model(self._prep(pred_video))
        fb = self.model(self._prep(gt_video))
        fa = fa / torch.clamp(torch.linalg.vector_norm(fa, dim=-1, keepdim=True), min=1e-10)
        fb = fb / torch.clamp(torch.linalg.vector_norm(fb, dim=-1, keepdim=True), min=1e-10)
        return torch.mean((fa - fb) ** 2)
