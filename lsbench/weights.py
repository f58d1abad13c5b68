"""Seeded random weights, made on the device in one draw a model.

Both sides get the same values: the program's modules and the plain
reference's are filled by :func:`fill_` from one flat buffer drawn with a
``torch.Generator`` on the device, in the type the weights are served in.
The rule (the port's ``init_random_``'s): a matrix or kernel N(0, 1/fan_in),
a norm scale 1 + N(0, 0.1²), any other vector N(0, 0.02²); nothing is zero,
so no branch of the model (conv_out, proj_out) drops out of the check.
Parameters are laid out in the order of their sorted names, each at an
offset aligned to 256 elements (a kernel may load weights in 16-byte
vectors), so two modules with the same names and shapes get the same
values whatever order they declare them in.
"""

from __future__ import annotations

import torch
import torch.nn as nn

ALIGN = 256
SALT = {"unet": 11, "vae": 23, "whisper": 37}


def _kinds(module: nn.Module):
    norms = {id(m.weight) for m in module.modules()
             if isinstance(m, (nn.GroupNorm, nn.LayerNorm)) and m.weight is not None}
    out = []
    for name, p in sorted(module.named_parameters(), key=lambda kv: kv[0]):
        kind = "matrix" if p.dim() >= 2 else ("norm" if id(p) in norms else "vector")
        out.append((name, tuple(p.shape), kind))
    return out


def layout(module: nn.Module):
    """[(name, shape, kind, offset)] and the buffer's length."""
    rows, off = [], 0
    for name, shape, kind in _kinds(module):
        rows.append((name, shape, kind, off))
        n = 1
        for s in shape:
            n *= s
        off += -(-n // ALIGN) * ALIGN
    return rows, off


@torch.no_grad()
def fill_(module: nn.Module, seed: int, part: str, device, dtype) -> nn.Module:
    """Replace every parameter of `module` (built on any device, the meta
    device included) by a view into one seeded buffer on `device`."""
    rows, total = layout(module)
    g = torch.Generator(device=device).manual_seed((int(seed) * 1000003 + SALT[part]) % 2**63)
    flat = torch.randn(total, generator=g, device=device, dtype=dtype)
    params = dict(module.named_parameters())
    owners = {}
    for mod_name, mod in module.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            owners[f"{mod_name}.{pname}" if mod_name else pname] = (mod, pname)
    for name, shape, kind, off in rows:
        n = params[name].numel()
        view = flat[off:off + n].view(shape)
        if kind == "matrix":
            view.mul_(1.0 / (n // shape[0]) ** 0.5)
        elif kind == "norm":
            view.mul_(0.1).add_(1.0)
        else:
            view.mul_(0.02)
        mod, pname = owners[name]
        mod._parameters[pname] = nn.Parameter(view, requires_grad=False)
    return module


def signature(module: nn.Module):
    """The layout's names, shapes and kinds: equal on both sides, or the
    two are not the same model."""
    return [(n, s, k) for n, s, k, _ in layout(module)[0]]
