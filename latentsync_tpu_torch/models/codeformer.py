"""VQGAN and CodeFormer face restoration, as torch modules in (B, C, H, W).

Counterpart of ``latentsync_tpu/models/codeformer.py`` (basicsr's
``vqgan_arch.py`` and ``codeformer_arch.py``). The state dicts keep the
upstream layout (``encoder.blocks.N.*``, ``generator.blocks.N.*``,
``quantize.embedding``, ``ft_layers.N.self_attn.in_proj_weight``,
``idx_pred_layer.{0,1}``, ``fuse_convs_dict.<size>.*``), so a released
``codeformer.pth`` loads as it is, the JAX package's
``utils/convert_codeformer.py`` carries these weights into flax, and
``utils/convert.py`` ``codeformer_state_dict_from_flax`` carries the JAX
parameters back.

The only TPU kernel on this path is the transformer's attention: each
``TransformerSALayer`` calls the port's ``dot_product_attention`` on
(B, 256, heads, D) — at the default width 8 heads of 64 — which is the
flash route, the hand-written kernel of ``csrc/flash_attention.cu`` on a
CUDA tensor. The rest is convolutions, norms and two small einsums, plain
torch as in the reference (its GroupNorms are flax's, not the UNet's
GroupNorm kernels).

Numerics follow the JAX modules at their serving dtype: GroupNorm (eps
1e-6, 32 groups or gcd(32, C) at narrow widths) and LayerNorm (eps 1e-6)
compute their statistics in f32 with f32 parameters, their outputs are
cast to the weights' dtype, and the VQGAN's attention blocks take f32
logits and softmax with probabilities rounded to that dtype. ``cast_floating_``
gives a module the serving dtype with its norms left in f32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention

Specs = Tuple[Tuple[str, int], ...]


class GroupNorm(nn.GroupNorm):
    """flax's GroupNorm as the reference uses it: statistics and affine in
    f32, f32 out (the caller casts)."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6):
        g = groups if channels % groups == 0 else math.gcd(groups, channels)
        super().__init__(g, channels, eps=eps)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(),
                            self.eps)


class LayerNorm(nn.LayerNorm):
    """flax's LayerNorm defaults: eps 1e-6, f32 statistics and output."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps)


@torch.no_grad()
def cast_floating_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Every floating parameter and buffer in `dtype` but those of the
    norms (GroupNorm, LayerNorm, BatchNorm), which stay in f32: the JAX
    package's ``cast_floating`` for inference, with the norms' statistics
    in f32 as there."""
    module.to(dtype)
    for m in module.modules():
        if isinstance(m, (nn.GroupNorm, nn.LayerNorm, nn.modules.batchnorm._BatchNorm)):
            m.float()
    return module


def _dtype(module: nn.Module) -> torch.dtype:
    return next(p.dtype for p in module.parameters() if p.dim() > 1)


def swish(x):
    return x * torch.sigmoid(x)


class ResBlock(nn.Module):
    """GN → swish → conv3 → GN → swish → conv3, plus the input (through a
    1x1 ``conv_out`` where the widths differ)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.cin, self.cout = cin, cout
        self.norm1 = GroupNorm(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = GroupNorm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_out = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        dt = self.conv1.weight.dtype
        h = self.conv1(swish(self.norm1(x)).to(dt))
        h = self.conv2(swish(self.norm2(h)).to(dt))
        if self.cin != self.cout:
            x = self.conv_out(x.to(dt))
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the pixels with 1x1-conv projections."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = GroupNorm(c)
        self.q = nn.Conv2d(c, c, 1)
        self.k = nn.Conv2d(c, c, 1)
        self.v = nn.Conv2d(c, c, 1)
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        dt = self.q.weight.dtype
        hn = self.norm(x).to(dt)
        q = self.q(hn).flatten(2).transpose(1, 2)     # (B, HW, C)
        k = self.k(hn).flatten(2).transpose(1, 2)
        v = self.v(hn).flatten(2).transpose(1, 2)
        logits = q.float() @ k.float().transpose(1, 2)
        weights = torch.softmax(logits * c**-0.5, dim=-1).to(dt)
        o = (weights @ v).transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(o)


class Downsample(nn.Module):
    """Pad the bottom and right by one, then a VALID stride-2 3x3 conv."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest x2, then a 3x3 conv."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def encoder_block_specs(nf, ch_mult, num_res_blocks, resolution, attn_resolutions,
                        emb_dim) -> List[Tuple[str, int]]:
    """(kind, out channels) of each encoder block, index for index."""
    specs: List[Tuple[str, int]] = [("conv_in", nf)]
    curr, ch = resolution, nf
    for i in range(len(ch_mult)):
        out_ch = nf * ch_mult[i]
        for _ in range(num_res_blocks):
            specs.append(("res", out_ch))
            ch = out_ch
            if curr in attn_resolutions:
                specs.append(("attn", ch))
        if i != len(ch_mult) - 1:
            specs.append(("down", ch))
            curr //= 2
    specs += [("res", ch), ("attn", ch), ("res", ch), ("norm", ch), ("conv_out", emb_dim)]
    return specs


def generator_block_specs(nf, ch_mult, num_res_blocks, resolution, attn_resolutions,
                          emb_dim) -> List[Tuple[str, int]]:
    """(kind, out channels) of each generator block, index for index."""
    ch = nf * ch_mult[-1]
    curr = resolution // 2 ** (len(ch_mult) - 1)
    specs: List[Tuple[str, int]] = [("conv_in", ch), ("res", ch), ("attn", ch), ("res", ch)]
    for i in reversed(range(len(ch_mult))):
        out_ch = nf * ch_mult[i]
        for _ in range(num_res_blocks):
            specs.append(("res", out_ch))
            ch = out_ch
            if curr in attn_resolutions:
                specs.append(("attn", ch))
        if i != 0:
            specs.append(("up", ch))
            curr *= 2
    specs += [("norm", ch), ("conv_out", 3)]
    return specs


class BlockStack(nn.Module):
    """The indexed block list. ``taps`` returns the output of the listed
    blocks; ``injections[i]`` maps the output of block i before the next
    block (CodeFormer's fuse blocks). Both act AFTER block i."""

    def __init__(self, specs: Specs, cin: int):
        super().__init__()
        self.specs = tuple(specs)
        blocks = []
        ch = cin
        for kind, out in self.specs:
            if kind in ("conv_in", "conv_out"):
                blocks.append(nn.Conv2d(ch, out, 3, padding=1))
            elif kind == "res":
                blocks.append(ResBlock(ch, out))
            elif kind == "attn":
                blocks.append(AttnBlock(ch))
            elif kind == "down":
                blocks.append(Downsample(ch))
            elif kind == "up":
                blocks.append(Upsample(ch))
            elif kind == "norm":
                blocks.append(GroupNorm(ch))
            else:
                raise ValueError(f"unknown block kind {kind!r}")
            ch = out
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x, taps: Sequence[int] = (), injections: Optional[Dict[int, object]] = None):
        tapped = {}
        for i, ((kind, _), block) in enumerate(zip(self.specs, self.blocks)):
            x = block(x)
            if kind == "norm":  # a bare GroupNorm, no activation after it
                x = x.to(_dtype(self))
            if injections and i in injections:
                x = injections[i](x)
            if i in taps:
                tapped[i] = x
        return (x, tapped) if taps else x


class VectorQuantizer(nn.Module):
    """Nearest-codebook quantizer with the straight-through output."""

    def __init__(self, codebook_size: int = 1024, emb_dim: int = 256, beta: float = 0.25):
        super().__init__()
        self.codebook_size, self.emb_dim, self.beta = codebook_size, emb_dim, beta
        self.embedding = nn.Embedding(codebook_size, emb_dim)

    def forward(self, z):
        """z (B, E, H, W) → (z_q, loss, indices (B, H, W))."""
        b, e, h, w = z.shape
        zl = z.permute(0, 2, 3, 1)
        flat = zl.reshape(-1, e).float()
        emb = self.embedding.weight.float()
        d = flat.pow(2).sum(1, keepdim=True) + emb.pow(2).sum(1) - 2.0 * flat @ emb.t()
        idx = d.argmin(1)
        z_q = emb[idx].reshape(zl.shape).to(z.dtype)
        loss = torch.mean((z_q.detach() - zl) ** 2) \
            + self.beta * torch.mean((z_q - zl.detach()) ** 2)
        z_q = zl + (z_q - zl).detach()
        return z_q.permute(0, 3, 1, 2), loss, idx.reshape(b, h, w)

    def codebook_lookup(self, idx, shape):
        """Codes (B, T) → (B, E, H, W) for `shape` = (B, H, W, E)."""
        return self.embedding.weight[idx.reshape(-1)].reshape(shape).permute(0, 3, 1, 2)


class GumbelQuantizer(nn.Module):
    """The Gumbel-softmax quantizer's forward without noise (the JAX module's
    ``rng=None``), hard codes at temperature 1."""

    def __init__(self, codebook_size: int = 1024, emb_dim: int = 256, num_hiddens: int = 256,
                 kl_weight: float = 1e-8):
        super().__init__()
        self.codebook_size, self.kl_weight = codebook_size, kl_weight
        self.proj = nn.Conv2d(num_hiddens, codebook_size, 1)
        self.embed = nn.Embedding(codebook_size, emb_dim)

    def forward(self, z):
        logits = self.proj(z)                                   # (B, K, H, W)
        y = torch.softmax(logits, dim=1)
        idx = y.argmax(dim=1)
        y_hard = F.one_hot(idx, self.codebook_size).permute(0, 3, 1, 2).to(y.dtype)
        y = y + (y_hard - y).detach()
        z_q = torch.einsum("bnhw,nd->bdhw", y, self.embed.weight.to(y.dtype))
        qy = torch.softmax(logits, dim=1)
        diff = self.kl_weight * torch.mean(
            torch.sum(qy * torch.log(qy * self.codebook_size + 1e-10), dim=1))
        return z_q, diff, idx


class VQAutoEncoder(nn.Module):
    """Encoder → quantizer → generator: (reconstruction, loss, indices)."""

    def __init__(self, img_size: int = 512, nf: int = 64,
                 ch_mult: Tuple[int, ...] = (1, 2, 2, 4, 4, 8), quantizer: str = "nearest",
                 res_blocks: int = 2, attn_resolutions: Tuple[int, ...] = (16,),
                 codebook_size: int = 1024, emb_dim: int = 256, beta: float = 0.25):
        super().__init__()
        self.img_size = img_size
        self.encoder = BlockStack(encoder_block_specs(nf, ch_mult, res_blocks, img_size,
                                                      attn_resolutions, emb_dim), 3)
        self.generator = BlockStack(generator_block_specs(nf, ch_mult, res_blocks, img_size,
                                                          attn_resolutions, emb_dim), emb_dim)
        if quantizer == "nearest":
            self.quantize = VectorQuantizer(codebook_size, emb_dim, beta)
        elif quantizer == "gumbel":
            self.quantize = GumbelQuantizer(codebook_size, emb_dim, emb_dim)
        else:
            raise ValueError(f"unknown quantizer {quantizer!r}")

    def forward(self, x):
        z = self.encoder(x.to(_dtype(self)))
        z_q, loss, idx = self.quantize(z)
        return self.generator(z_q), loss, idx


class SelfAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (packed ``in_proj_weight`` /
    ``in_proj_bias``, ``out_proj``) on the port's ``dot_product_attention``
    in (B, T, heads, D)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, qk, v):
        b, t, c = v.shape
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        shape = (b, t, self.heads, c // self.heads)
        o = dot_product_attention(F.linear(qk, wq, bq).reshape(shape),
                                  F.linear(qk, wk, bk).reshape(shape),
                                  F.linear(v, wv, bv).reshape(shape))
        return self.out_proj(o.reshape(b, t, c))


class TransformerSALayer(nn.Module):
    """Pre-LN self-attention layer; the learned positions go into q and k
    only. Tokens first: (B, T, C)."""

    def __init__(self, embed_dim: int = 512, nhead: int = 8, dim_mlp: int = 1024):
        super().__init__()
        self.self_attn = SelfAttention(embed_dim, nhead)
        self.linear1 = nn.Linear(embed_dim, dim_mlp)
        self.linear2 = nn.Linear(dim_mlp, embed_dim)
        self.norm1 = LayerNorm(embed_dim)
        self.norm2 = LayerNorm(embed_dim)

    def forward(self, x, query_pos):
        dt = self.linear1.weight.dtype
        h = self.norm1(x).to(dt)
        x = x + self.self_attn(h + query_pos.to(dt), h)
        h = self.norm2(x).to(dt)
        return x + self.linear2(F.gelu(self.linear1(h)))


def adaptive_instance_norm(content, style, eps: float = 1e-5):
    """AdaIN over (B, C, H, W): the content's per-channel mean and standard
    deviation (population variance + eps) replaced by the style's."""
    def stats(f):
        m = f.mean(dim=(2, 3), keepdim=True)
        v = f.var(dim=(2, 3), keepdim=True, unbiased=False) + eps
        return m, torch.sqrt(v)

    cm, cs = stats(content)
    sm, ss = stats(style)
    return (content - cm) / cs * ss + sm


class FuseSftBlock(nn.Module):
    """The skip fusion: dec + w · (dec · scale(enc') + shift(enc')), enc' =
    ResBlock([enc, dec])."""

    def __init__(self, ch: int):
        super().__init__()
        self.encode_enc = ResBlock(2 * ch, ch)
        self.scale = nn.Sequential(nn.Conv2d(ch, ch, 3, padding=1), nn.LeakyReLU(0.2),
                                   nn.Conv2d(ch, ch, 3, padding=1))
        self.shift = nn.Sequential(nn.Conv2d(ch, ch, 3, padding=1), nn.LeakyReLU(0.2),
                                   nn.Conv2d(ch, ch, 3, padding=1))

    def forward(self, enc_feat, dec_feat, w: float = 1.0):
        h = self.encode_enc(torch.cat([enc_feat, dec_feat], dim=1))
        return dec_feat + w * (dec_feat * self.scale(h) + self.shift(h))


class CodeFormer(nn.Module):
    """Input (B, 3, 512, 512) in [-1, 1]; returns (restored image, code
    logits (B, T, K), lq feature (B, emb_dim, 16, 16)), or with
    ``code_only`` (logits, lq feature)."""

    FUSE_ENCODER = {"512": 2, "256": 5, "128": 8, "64": 11, "32": 14, "16": 18}
    FUSE_GENERATOR = {"16": 6, "32": 9, "64": 12, "128": 15, "256": 18, "512": 21}
    CHANNEL_MULT = {"16": 8, "32": 4, "64": 4, "128": 2, "256": 2, "512": 1}

    def __init__(self, dim_embd: int = 512, n_head: int = 8, n_layers: int = 9,
                 codebook_size: int = 1024, latent_size: int = 256,
                 connect_list: Tuple[str, ...] = ("32", "64", "128", "256"),
                 img_size: int = 512, nf: int = 64, ch_mult: Tuple[int, ...] = (1, 2, 2, 4, 4, 8),
                 emb_dim: int = 256):
        super().__init__()
        self.connect_list = tuple(connect_list)
        self.emb_dim = emb_dim
        self.latent_hw = img_size // 2 ** (len(ch_mult) - 1)
        attn = (self.latent_hw,)
        self.encoder = BlockStack(encoder_block_specs(nf, ch_mult, 2, img_size, attn, emb_dim), 3)
        self.generator = BlockStack(generator_block_specs(nf, ch_mult, 2, img_size, attn,
                                                          emb_dim), emb_dim)
        self.quantize = VectorQuantizer(codebook_size, emb_dim)
        self.position_emb = nn.Parameter(torch.zeros(latent_size, dim_embd))
        self.feat_emb = nn.Linear(emb_dim, dim_embd)
        self.ft_layers = nn.Sequential(*[TransformerSALayer(dim_embd, n_head, 2 * dim_embd)
                                         for _ in range(n_layers)])
        self.idx_pred_layer = nn.Sequential(LayerNorm(dim_embd),
                                            nn.Linear(dim_embd, codebook_size, bias=False))
        self.fuse_convs_dict = nn.ModuleDict({f: FuseSftBlock(nf * self.CHANNEL_MULT[f])
                                              for f in self.connect_list})

    def forward(self, x, w: float = 0.0, adain: bool = False, code_only: bool = False):
        dt = _dtype(self)
        enc_taps = tuple(self.FUSE_ENCODER[f] for f in self.connect_list)
        if enc_taps:
            z, tapped = self.encoder(x.to(dt), taps=enc_taps)
        else:
            z, tapped = self.encoder(x.to(dt)), {}
        lq_feat = z
        b = z.shape[0]
        h = self.feat_emb(z.flatten(2).transpose(1, 2).to(dt))  # (B, T, dim_embd)
        pos = self.position_emb[None]
        for layer in self.ft_layers:
            h = layer(h, pos)
        norm, linear = self.idx_pred_layer
        logits = linear(norm(h).to(dt))                        # (B, T, K)
        if code_only:
            return logits, lq_feat

        idx = logits.argmax(dim=-1)
        quant = self.quantize.codebook_lookup(
            idx, (b, self.latent_hw, self.latent_hw, self.emb_dim)).to(dt).detach()
        if adain:
            quant = adaptive_instance_norm(quant, lq_feat)
        injections = {}
        for f in self.connect_list:
            fuse, enc = self.fuse_convs_dict[f], tapped[self.FUSE_ENCODER[f]]
            injections[self.FUSE_GENERATOR[f]] = (lambda fuse, enc: lambda d: fuse(enc, d, w))(
                fuse, enc)
        out = self.generator(quant, injections=injections or None)
        return out, logits, lq_feat


def batch_norm_running(m: nn.BatchNorm2d, h: torch.Tensor) -> torch.Tensor:
    """flax's ``BatchNorm(use_running_average=True)`` in f32: (h - mean) ·
    (scale · rsqrt(var + eps)) + bias on the running statistics, written
    out so that it is the same whatever the module's train / eval mode and
    differentiable in the statistics (the restoration trainers train them,
    as the JAX trainers do)."""
    mul = torch.rsqrt(m.running_var.float() + m.eps) * m.weight.float()
    y = (h.float() - m.running_mean.float()[:, None, None]) * mul[:, None, None]
    return y + m.bias.float()[:, None, None]


class VQGANDiscriminator(nn.Module):
    """The PatchGAN discriminator (forward; batch norms on their running
    statistics, ``batch_norm_running``): ``main`` is upstream's Sequential,
    index for index."""

    def __init__(self, nc: int = 3, ndf: int = 64, n_layers: int = 4):
        super().__init__()
        layers = [nn.Conv2d(nc, ndf, 4, stride=2, padding=1), nn.LeakyReLU(0.2)]
        mult = 1
        for n in range(1, n_layers + 1):
            prev, mult = mult, min(2**n, 8)
            stride = 2 if n != n_layers else 1
            layers += [nn.Conv2d(ndf * prev, ndf * mult, 4, stride=stride, padding=1, bias=False),
                       nn.BatchNorm2d(ndf * mult), nn.LeakyReLU(0.2)]
        layers.append(nn.Conv2d(ndf * mult, 1, 4, stride=1, padding=1))
        self.main = nn.Sequential(*layers)

    def forward(self, x):
        h = x.to(_dtype(self))
        for m in self.main:
            h = batch_norm_running(m, h).to(h.dtype) if isinstance(m, nn.BatchNorm2d) else m(h)
        return h
