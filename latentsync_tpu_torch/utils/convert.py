"""Weights for the port: JAX parameter trees → torch state dicts, and a
seeded non-zero random initialisation.

``{unet,vae,whisper,fan,s3fd}_state_dict_from_flax`` take the JAX package's
parameter trees (nested dicts of numpy arrays, with or without the
top-level ``"params"``) and return state dicts in the upstream PyTorch
key layout the port's modules use. They invert
``latentsync_tpu/utils/convert.py`` ``convert_unet``, ``convert_vae`` and
``convert_whisper_encoder``, and ``latentsync_tpu/utils/convert_eval.py``
``convert_fan`` and ``convert_s3fd``: flax (kh, kw, I, O) conv kernels become
(O, I, kh, kw), (k, I, O) become (O, I, k), (I, O) dense kernels become
(O, I), and norm ``scale`` becomes ``weight``.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn as nn


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _leaf(name: str, w: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "bias":
        return "bias", w
    if name == "scale":
        return "weight", w
    if name != "kernel":
        raise ValueError(f"unexpected parameter leaf {name!r}")
    if w.ndim == 4:
        return "weight", np.transpose(w, (3, 2, 0, 1))
    if w.ndim == 3:
        return "weight", np.transpose(w, (2, 1, 0))
    return "weight", np.transpose(w)


def _convert(params, module_path) -> Dict[str, torch.Tensor]:
    tree = params.get("params", params)
    sd = {}
    for path, w in _flatten(tree):
        name, value = _leaf(path[-1], w)
        key = module_path("/".join(path[:-1]))
        sd[f"{key}.{name}"] = torch.from_numpy(np.ascontiguousarray(value, np.float32))
    return sd


_UNET_RULES = [
    (r"^(down_blocks|up_blocks)_(\d+)/", r"\1.\2."),
    (r"^mid_block/", "mid_block."),
    (r"^time_embedding_linear_(\d)$", r"time_embedding.linear_\1"),
    (r"^(conv_in|conv_out)/conv$", r"\1"),
    (r"resnets_(\d+)/(conv1|conv2|conv_shortcut)/conv$", r"resnets.\1.\2"),
    (r"resnets_(\d+)/", r"resnets.\1."),
    (r"(downsamplers|upsamplers)_0/conv/conv$", r"\1.0.conv"),
    (r"attentions_(\d+)/", r"attentions.\1."),
    (r"motion_modules_(\d+)/", r"motion_modules.\1.temporal_transformer."),
    (r"transformer_blocks_(\d+)_attention_blocks_(\d+)/attn/",
     r"transformer_blocks.\1.attention_blocks.\2."),
    (r"transformer_blocks_(\d+)_norms_(\d+)$", r"transformer_blocks.\1.norms.\2"),
    (r"transformer_blocks_(\d+)_ff_norm$", r"transformer_blocks.\1.ff_norm"),
    (r"transformer_blocks_(\d+)_ff/", r"transformer_blocks.\1.ff/"),
    (r"transformer_blocks_(\d+)/", r"transformer_blocks.\1."),
    (r"to_out_0$", "to_out.0"),
    (r"ff/net_0_proj$", "ff.net.0.proj"),
    (r"ff/net_2$", "ff.net.2"),
]

_VAE_RULES = [
    (r"^(encoder|decoder)/", r"\1."),
    (r"down_(\d+)_block_(\d+)/", r"down_blocks.\1.resnets.\2."),
    (r"up_(\d+)_block_(\d+)/", r"up_blocks.\1.resnets.\2."),
    (r"down_(\d+)_downsample/conv$", r"down_blocks.\1.downsamplers.0.conv"),
    (r"up_(\d+)_upsample/conv$", r"up_blocks.\1.upsamplers.0.conv"),
    (r"mid_block_1/", "mid_block.resnets.0."),
    (r"mid_block_2/", "mid_block.resnets.1."),
    (r"mid_attn/to_out$", "mid_block.attentions.0.to_out.0"),
    (r"mid_attn/", "mid_block.attentions.0."),
]

_WHISPER_RULES = [
    (r"^blocks_(\d+)/", r"blocks.\1."),
    (r"mlp_(\d)$", r"mlp.\1"),
]


def _apply(rules, path: str) -> str:
    for pat, rep in rules:
        path = re.sub(pat, rep, path)
    return path.replace("/", ".")


def unet_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """JAX UNet3DConditionModel params → the port's UNet state dict."""
    return _convert(params, lambda p: _apply(_UNET_RULES, p))


def vae_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """JAX AutoencoderKL params → the port's (diffusers-layout) state dict."""
    return _convert(params, lambda p: _apply(_VAE_RULES, p))


def whisper_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """JAX WhisperEncoder params → the port's (openai AudioEncoder) state
    dict, without the ``encoder.`` prefix of a full whisper checkpoint."""
    return _convert(params, lambda p: _apply(_WHISPER_RULES, p))


_FAN_BLOCK = {"b1_bn": "bn1", "b1_conv": "conv1", "b2_bn": "bn2", "b2_conv": "conv2",
              "b3_bn": "bn3", "b3_conv": "conv3", "ds_bn": "downsample.0",
              "ds_conv": "downsample.2"}
_FAN_HG = {"up1": "b1", "low1": "b2", "low2": "b2_plus", "low3": "b3"}
_FAN_HEADS = {"conv_last": "conv_last{}", "bn_end": "bn_end{}", "l": "l{}", "bl": "bl{}",
              "al": "al{}", "top": "top_m_{}"}
_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _fan_module(path: Tuple[str, ...]) -> str:
    """A FAN2D module path of the JAX package → the face_alignment name."""
    head, rest = path[0], list(path[1:])
    m = re.fullmatch(r"m(\d+)_(hg|top|conv_last|bn_end|l|bl|al)", head)
    if m and m.group(2) == "hg":
        name, level = rest.pop(0).rsplit("_", 1)
        out = [f"m{m.group(1)}", f"{_FAN_HG[name]}_{level}"]
    elif m:
        out = [_FAN_HEADS[m.group(2)].format(m.group(1))]
    else:
        out = [head]
    return ".".join(out + [_FAN_BLOCK[r] for r in rest])


def _state_dict(variables, module_name) -> Dict[str, torch.Tensor]:
    """Flax variables (params, and batch_stats where present) → a state
    dict, each array in its own dtype."""
    if "params" not in variables:
        variables = {"params": variables}
    sd = {}
    for coll in ("params", "batch_stats"):
        for path, w in _flatten(variables.get(coll, {})):
            leaf = path[-1]
            if leaf == "kernel":
                name, w = "weight", np.transpose(w, (3, 2, 0, 1))
            else:
                name = _BN_LEAF.get(leaf, leaf)
            sd[f"{module_name(path[:-1])}.{name}"] = torch.from_numpy(np.ascontiguousarray(w))
    return sd


def fan_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """JAX FAN2D variables ({"params", "batch_stats"}) → the port's FAN2D
    state dict in the face_alignment 2DFAN4 layout: the inverse of
    ``latentsync_tpu/utils/convert_eval.py`` ``convert_fan``."""
    return _state_dict(variables, _fan_module)


_S3FD_NAMES = {**{f"vgg_{i}": f"vgg.{j}" for i, j in enumerate(
    (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28))}, "fc6": "vgg.31", "fc7": "vgg.33",
    "conv6_1": "extras.0", "conv6_2": "extras.1", "conv7_1": "extras.2", "conv7_2": "extras.3",
    "l2norm3": "L2Norm3_3", "l2norm4": "L2Norm4_3", "l2norm5": "L2Norm5_3"}


def _s3fd_module(path: Tuple[str, ...]) -> str:
    (head,) = path
    m = re.fullmatch(r"(box|cls)_(\d)", head)
    if m:
        return f"{'loc' if m.group(1) == 'box' else 'conf'}.{m.group(2)}"
    return _S3FD_NAMES[head]


def s3fd_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """JAX S3FD params → the port's S3FD state dict in the upstream
    ``sfd_face.pth`` layout: the inverse of ``convert_eval.convert_s3fd``."""
    return _state_dict(variables, _s3fd_module)


def load_state_dict_file(path: str, from_flax=None) -> Dict[str, torch.Tensor]:
    """A weight file as a state dict: ``.pth`` / ``.pt`` through
    ``torch.load`` (tensors only; a ``state_dict`` entry is unwrapped), or
    an ``.npz``: of state-dict names, or a JAX package parameter tree
    (``/``-separated names), which `from_flax` (e.g.
    ``fan_state_dict_from_flax``) converts."""
    if path.endswith((".pth", ".pt")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd)
        return {k.removeprefix("module."): v for k, v in sd.items()}
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    if not any("/" in k for k in arrays):
        return {k: torch.from_numpy(v) for k, v in arrays.items()}
    if from_flax is None:
        raise ValueError(f"{path}: a JAX parameter tree, and no converter was given")
    tree: dict = {}
    for k, v in arrays.items():
        *parents, leaf = k.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = v
    return from_flax(tree)


def linear_weight(kernel) -> torch.Tensor:
    """A JAX dense kernel (in, out) → the ``nn.Linear`` weight (out, in) the
    port's ops take (``qkv_proj``'s wq/wk/wv, ``geglu_ffn``'s w_up/w_down)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(kernel).T))


_BIAS_STD = 0.02
_NORM_STD = 0.1


@torch.no_grad()
def init_random_(module: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter with seeded, non-zero random values.

    Matrices and convolution kernels get N(0, 1/fan_in), so activations
    keep unit scale through depth; norm scales get 1 + N(0, 0.1²) and
    biases N(0, 0.02²). No tensor is zero, including the ones the
    reference zero-initialises (conv_in, conv_out, every proj_out): with
    those at zero the UNet's output is identically 0 and every
    transformer adds nothing, which would hide a wrong kernel. The values
    are drawn on the CPU in f32 from `seed` in parameter-name order, so
    they do not depend on the device."""
    g = torch.Generator().manual_seed(seed)
    norms = {id(m.weight) for m in module.modules()
             if isinstance(m, (nn.GroupNorm, nn.LayerNorm)) and m.weight is not None}
    for name, p in module.named_parameters():
        if p.dim() >= 2:
            fan_in = p[0].numel()
            v = torch.randn(p.shape, generator=g) / fan_in**0.5
        elif id(p) in norms:
            v = 1.0 + _NORM_STD * torch.randn(p.shape, generator=g)
        else:
            v = _BIAS_STD * torch.randn(p.shape, generator=g)
        p.copy_(v)
    return module
