"""Whisper audio encoder in torch, returning every layer's embeddings.

Counterpart of ``latentsync_tpu/models/whisper.py`` ``WhisperEncoder``:
two GELU conv1d stems (the second stride 2), the sinusoidal position
table, pre-LN residual blocks; beside ``ln_post(x)`` it returns the
stack of block inputs and outputs (before ``ln_post``) as
(B, n_layer + 1, T', D). Parameter names follow openai whisper's
``AudioEncoder`` (``conv1``, ``blocks.i.attn.query`` …, ``ln_post``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import WhisperConfig
from ..ops.attention import dot_product_attention


def sinusoid_positions(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    log_inc = math.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


class MultiHeadAttention(nn.Module):
    """q/v/out biased, k unbiased."""

    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(n_state, n_state)
        self.key = nn.Linear(n_state, n_state, bias=False)
        self.value = nn.Linear(n_state, n_state)
        self.out = nn.Linear(n_state, n_state)

    def forward(self, x):
        b, t, c = x.shape
        d = c // self.n_head
        q = self.query(x).reshape(b, t, self.n_head, d)
        k = self.key(x).reshape(b, t, self.n_head, d)
        v = self.value(x).reshape(b, t, self.n_head, d)
        return self.out(dot_product_attention(q, k, v).reshape(b, t, c))


def _layer_norm(x, ln: nn.LayerNorm):
    """f32 LayerNorm (eps 1e-6, the flax default the reference uses)."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(x.dtype)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.attn = MultiHeadAttention(n_state, n_head)
        self.attn_ln = nn.LayerNorm(n_state, eps=1e-6)
        self.mlp = nn.Sequential(nn.Linear(n_state, 4 * n_state), nn.GELU(),
                                 nn.Linear(4 * n_state, n_state))
        self.mlp_ln = nn.LayerNorm(n_state, eps=1e-6)

    def forward(self, x):
        x = x + self.attn(_layer_norm(x, self.attn_ln))
        return x + self.mlp(_layer_norm(x, self.mlp_ln))


class WhisperEncoder(nn.Module):
    """mel (B, n_mels, T) → (ln_post(x), embeddings (B, L+1, T/2, D)), or
    ln_post(x) alone with ``include_embeddings=False`` (transcription)."""

    def __init__(self, config: WhisperConfig = WhisperConfig()):
        super().__init__()
        self.config = cfg = config
        self.conv1 = nn.Conv1d(cfg.n_mels, cfg.n_audio_state, 3, padding=1)
        self.conv2 = nn.Conv1d(cfg.n_audio_state, cfg.n_audio_state, 3, stride=2, padding=1)
        self.register_buffer(
            "positional_embedding",
            torch.from_numpy(sinusoid_positions(cfg.n_audio_ctx, cfg.n_audio_state)),
            persistent=False)
        self.blocks = nn.ModuleList([ResidualAttentionBlock(cfg.n_audio_state, cfg.n_audio_head)
                                     for _ in range(cfg.n_audio_layer)])
        self.ln_post = nn.LayerNorm(cfg.n_audio_state, eps=1e-6)

    def forward(self, mel: torch.Tensor, include_embeddings: bool = True):
        dt = self.conv1.weight.dtype
        x = F.gelu(self.conv1(mel.to(dt)))
        x = F.gelu(self.conv2(x)).transpose(1, 2)
        if x.shape[1] != self.config.n_audio_ctx:
            raise ValueError(f"incorrect audio shape {tuple(x.shape)}, expected ctx "
                             f"{self.config.n_audio_ctx}")
        x = x + self.positional_embedding.to(dt)
        embeddings = [x]
        for blk in self.blocks:
            x = blk(x)
            embeddings.append(x)
        if not include_embeddings:
            return _layer_norm(x, self.ln_post)
        return _layer_norm(x, self.ln_post), torch.stack(embeddings, dim=1)
