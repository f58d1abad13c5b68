"""StableSyncNet, the frozen lip-sync supervisor of stage-2 training, and
the Wav2Lip-style SyncNet ablation ``Wav2LipSyncNet``.

Counterpart of ``latentsync_tpu/models/syncnet.py`` (``SyncResnetBlock2D``,
``SyncAttentionBlock2D``, ``DownEncoder2D``, ``StableSyncNet``): twin
towers reduce 16 stacked lower-half face frames and a Wav2Lip mel window
to unit embeddings whose cosine similarity supervises lip sync. Layout is
torch's NCHW; parameter names follow the upstream ``stable_syncnet.pt``
(``{audio,visual}_encoder.{conv_in,down_blocks.N.*,norm_out}``, resnets and
attention blocks interleaved in ``down_blocks``), the layout
``latentsync_tpu.utils.convert.convert_stable_syncnet`` reads.

GroupNorms and LayerNorms run in f32 and cast back, as the JAX model's f32
flax norms do. The attention blocks' feed-forward is the UNet's GEGLU: it
runs K1 (``ops/ffn.geglu_ffn``) where the reference's ``geglu_ffn`` runs its
kernel (``geglu_route``) and the composed ``geglu_ffn_xla_full`` elsewhere,
which at the stage-2 inputs is every one of its four shapes (16 to 130
rows, no multiple of 128). Their attention (at most 130 tokens) is plain
torch, as in the reference.

``Wav2LipSyncNet`` (the JAX package's ``Wav2LipSyncNet``) is convolutions
and batch norms alone, cuDNN's on the card: it reaches no Pallas kernel in
the JAX package and has no hand kernel here.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import SyncNetConfig, SyncNetEncoderConfig
from ..ops.attention import dot_product_attention
from ..ops.ffn import geglu_ffn, geglu_ffn_xla_full, geglu_route, layer_norm_f32
from .unet3d import FeedForward, group_norm


def _factor2d(f) -> Tuple[int, int]:
    if isinstance(f, (tuple, list)):
        return int(f[0]), int(f[1])
    return int(f), int(f)


class SyncResnetBlock2D(nn.Module):
    """GN → SiLU → conv ×2 with a 1×1 shortcut where the width changes, then
    the reference's asymmetric pad and a strided 3×3 conv where it
    downsamples (ref:stable_syncnet.py:65-133)."""

    def __init__(self, in_ch: int, out_ch: int, factor: Union[int, Tuple[int, int]],
                 groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.norm1 = nn.GroupNorm(math.gcd(groups, in_ch), in_ch, eps=eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = nn.GroupNorm(math.gcd(groups, out_ch), out_ch, eps=eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None
        self.factor = _factor2d(factor)
        if self.factor != (1, 1):
            self.downsample_conv = nn.Conv2d(out_ch, out_ch, 3, stride=self.factor)

    def forward(self, x):
        h = self.conv1(group_norm(x, self.norm1, silu=True))
        h = self.conv2(group_norm(h, self.norm2, silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        h = h + x
        fy, fx = self.factor
        if (fy, fx) == (1, 1):
            return h
        # (left, right, top, bottom), as ref:stable_syncnet.py:104-109
        pad = (0, 1, 1, 1) if fy == 1 else (1, 1, 0, 1) if fx == 1 else (0, 1, 0, 1)
        return self.downsample_conv(F.pad(h, pad))


class _SyncAttention(nn.Module):
    """Biased q/k/v/out projections (keys ``attn.to_q`` … ``attn.to_out.0``)."""

    def __init__(self, c: int):
        super().__init__()
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])


class SyncAttentionBlock2D(nn.Module):
    """GN → 1×1 conv in → LN, 8-head attention, residual → LN, GEGLU FF,
    residual → 1×1 conv out, residual (ref:stable_syncnet.py:136-169)."""

    def __init__(self, c: int, groups: int = 32):
        super().__init__()
        self.norm1 = nn.GroupNorm(math.gcd(groups, c), c, eps=1e-6)
        self.conv_in = nn.Conv2d(c, c, 1)
        self.norm2 = nn.LayerNorm(c, eps=1e-6)
        self.attn = _SyncAttention(c)
        self.norm3 = nn.LayerNorm(c, eps=1e-6)
        self.ff = FeedForward(c)
        self.conv_out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        b, c, hh, ww = x.shape
        dt = x.dtype
        h = self.conv_in(group_norm(x, self.norm1))
        h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        hn = layer_norm_f32(h, self.norm2.weight, self.norm2.bias, 1e-6).to(dt)
        heads = 8
        q, k, v = (proj(hn).reshape(b, hh * ww, heads, c // heads)
                   for proj in (self.attn.to_q, self.attn.to_k, self.attn.to_v))
        h = h + self.attn.to_out[0](dot_product_attention(q, k, v).reshape(b, hh * ww, c))
        hn = layer_norm_f32(h, self.norm3.weight, self.norm3.bias, 1e-6).to(dt)
        up, down = self.ff.net[0].proj, self.ff.net[2]
        ff = geglu_ffn if geglu_route(b * hh * ww, c) else geglu_ffn_xla_full
        h = h + ff(hn, up.weight, up.bias, down.weight, down.bias)
        h = h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return self.conv_out(h) + x


class DownEncoder2D(nn.Module):
    """conv_in, the resnet (and attention) blocks, GN → ReLU
    (ref:stable_syncnet.py:172-233)."""

    def __init__(self, cfg: SyncNetEncoderConfig, groups: int = 32):
        super().__init__()
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.block_out_channels[0], 3, padding=1)
        blocks = []
        ch = cfg.block_out_channels[0]
        for i, out in enumerate(cfg.block_out_channels):
            blocks.append(SyncResnetBlock2D(ch, out, cfg.downsample_factors[i], groups))
            if cfg.attn_blocks[i] == 1:
                blocks.append(SyncAttentionBlock2D(out, groups))
            ch = out
        self.down_blocks = nn.ModuleList(blocks)
        self.norm_out = nn.GroupNorm(math.gcd(groups, ch), ch, eps=1e-6)

    def forward(self, x):
        h = self.conv_in(x.to(self.conv_in.weight.dtype))
        for blk in self.down_blocks:
            h = blk(h)
        return F.relu(group_norm(h, self.norm_out))


class StableSyncNet(nn.Module):
    """forward(images (B, F·3, H/2, W), mel (B, 1, 80, T)) → (vision, audio)
    unit embeddings (B, D) in f32 (ref:stable_syncnet.py:28-62). Frame f's
    RGB are channels 3f..3f+2, as the reference stacks them."""

    def __init__(self, config: SyncNetConfig = SyncNetConfig()):
        super().__init__()
        self.visual_encoder = DownEncoder2D(config.visual_encoder)
        self.audio_encoder = DownEncoder2D(config.audio_encoder)

    def forward(self, image_sequences, audio_sequences):
        return (_unit_embedding(self.visual_encoder(image_sequences)),
                _unit_embedding(self.audio_encoder(audio_sequences)))


def _unit_embedding(h):
    """A tower's (B, C, H, W) output flattened channels-last, as the JAX models
    flatten it (one element where the towers end at 1×1, as every released
    config does), in f32, L2-normalised with a 1e-12 floor."""
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1).float()
    return h / torch.clamp(torch.linalg.vector_norm(h, dim=1, keepdim=True), min=1e-12)


_WAV2LIP_ACTS = {"relu": F.relu, "leaky": lambda x: F.leaky_relu(x, 0.2), "silu": F.silu,
                 "tanh": torch.tanh}


class _Wav2LipConv(nn.Module):
    """conv → batch norm (``conv_block.0`` / ``conv_block.1``, upstream's
    names), the residual added before the activation."""

    def __init__(self, cin: int, cout: int, kernel: int, stride, padding: int,
                 residual: bool, act: str):
        super().__init__()
        self.conv_block = nn.Sequential(nn.Conv2d(cin, cout, kernel, stride, padding),
                                        nn.BatchNorm2d(cout))
        self.residual = residual
        self.act = act

    def forward(self, x):
        conv, bn = self.conv_block
        # the running statistics always, as the JAX model's
        # use_running_average=True, in train() mode too; in f32
        h = F.batch_norm(conv(x).float(), bn.running_mean.float(), bn.running_var.float(),
                         bn.weight.float(), bn.bias.float(), training=False, eps=bn.eps)
        if self.residual:
            h = h + x
        return _WAV2LIP_ACTS[self.act](h).to(x.dtype)


class Wav2LipSyncNet(nn.Module):
    """The Wav2Lip-style SyncNet ablation (ref:latentsync/models/
    wav2lip_syncnet.py:8-90), counterpart of the JAX package's
    ``Wav2LipSyncNet``: the conv / batch-norm towers of ``VISUAL`` (20
    blocks) and ``AUDIO`` (17), the residual added before the activation.
    forward(faces (B, 15, 128, 256) stacked half-frames, mel (B, 1, 80, 16))
    → (visual, audio) unit embeddings (B, 1024) in f32. `act_fn` is leaky
    (LeakyReLU 0.2, upstream's), relu, silu or tanh; the last blocks of each
    tower are ReLU whatever it is. The batch norms normalise with their
    running statistics in every mode and are never updated, as the JAX
    module's. Parameter names are upstream's
    (``{visual,audio}_encoder.{i}.conv_block.{0,1}``), which the JAX
    package's ``convert_wav2lip_syncnet`` reads."""

    # (cout, kernel, stride, padding, residual, act_override)
    VISUAL = (
        (32, 7, 1, 3, False, None), (64, 5, (1, 2), 1, False, None),
        (64, 3, 1, 1, True, None), (64, 3, 1, 1, True, None),
        (128, 3, 2, 1, False, None),
        (128, 3, 1, 1, True, None), (128, 3, 1, 1, True, None),
        (128, 3, 1, 1, True, None),
        (256, 3, 3, 1, False, None),
        (256, 3, 1, 1, True, None), (256, 3, 1, 1, True, None),
        (512, 3, 2, 1, False, None),
        (512, 3, 1, 1, True, None), (512, 3, 1, 1, True, None),
        (1024, 3, 2, 1, False, None),
        (1024, 3, 1, 1, True, None), (1024, 3, 1, 1, True, None),
        (1024, 3, 2, 1, False, "relu"),
        (1024, 3, 1, 0, False, "relu"),
        (1024, 1, 1, 0, False, "relu"),
    )
    AUDIO = (
        (32, 3, 1, 1, False, None),
        (32, 3, 1, 1, True, None), (32, 3, 1, 1, True, None),
        (64, 3, (3, 1), 1, False, None),
        (64, 3, 1, 1, True, None), (64, 3, 1, 1, True, None),
        (128, 3, 3, 1, False, None),
        (128, 3, 1, 1, True, None), (128, 3, 1, 1, True, None),
        (256, 3, (3, 2), 1, False, None),
        (256, 3, 1, 1, True, None), (256, 3, 1, 1, True, None),
        (512, 3, 1, 1, False, None),
        (512, 3, 1, 1, True, None), (512, 3, 1, 1, True, None),
        (1024, 3, 1, 0, False, "relu"),
        (1024, 1, 1, 0, False, "relu"),
    )

    def __init__(self, act_fn: str = "leaky"):
        super().__init__()
        if act_fn not in _WAV2LIP_ACTS:
            raise ValueError(act_fn)
        self.act_fn = act_fn

        def tower(specs, cin):
            blocks = []
            for cout, k, s, p, res, act in specs:
                blocks.append(_Wav2LipConv(cin, cout, k, s, p, res, act or act_fn))
                cin = cout
            return nn.Sequential(*blocks)

        self.visual_encoder = tower(self.VISUAL, 15)
        self.audio_encoder = tower(self.AUDIO, 1)

    def forward(self, faces, audio):
        dt = self.visual_encoder[0].conv_block[0].weight.dtype
        return (_unit_embedding(self.visual_encoder(faces.to(dt))),
                _unit_embedding(self.audio_encoder(audio.to(dt))))
