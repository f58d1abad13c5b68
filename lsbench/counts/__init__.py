"""Operations and bytes from shapes, and the card's peaks.

- ``peaks.json``: the peak rate of each precision and of HBM for each
  card, by the name ``torch.cuda.get_device_name()`` gives.
- ``entries/<name>.py``: one model operation each (an entry point of the
  port that the model calls): ``TARGETS``, the ``module:attribute`` names
  the harness wraps in a traced run, and ``count(*args, **kwargs)`` →
  (operations, bytes read and written once, precision) of one call.
- ``schedule.py``: the products a configuration's served work needs.
- ``op_tally.py``: the analytic per-family tally of one UNet forward.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def peaks(card: str) -> dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        table = json.load(f)["cards"]
    if card not in table:
        raise KeyError(f"no peaks for card {card!r} in counts/peaks.json ({sorted(table)})")
    return table[card]


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entries() -> dict:
    """Every entry point's count module, by file name."""
    out = {}
    for path in sorted(glob.glob(os.path.join(HERE, "entries", "*.py"))):
        name = os.path.splitext(os.path.basename(path))[0]
        out[name] = load_module(path, f"lsbench_entry_{name.replace('.', '_')}")
    return out


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def precision(t) -> str:
    import torch

    return {torch.bfloat16: "bf16", torch.float16: "bf16", torch.float32: "f32"}.get(t.dtype, "f32")
