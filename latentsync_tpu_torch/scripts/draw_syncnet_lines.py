"""Sync-confidence chart (the port's counterpart of
``scripts/draw_syncnet_lines.py``; ref:eval/draw_syncnet_lines.py).

    python -m latentsync_tpu_torch.scripts.draw_syncnet_lines \\
        --inputs a.jsonl b.jsonl [--labels A B] [--out syncnet_lines.png]

Draws one line per JSON-lines file of ``eval_sync_conf`` (its rows'
``confidence`` in order) with ``utils/observability.plot_loss_chart``. Host
code only: no device.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--inputs", nargs="+", required=True,
                   help="JSON-lines files of latentsync_tpu_torch.scripts.eval_sync_conf")
    p.add_argument("--labels", nargs="*", default=None)
    p.add_argument("--out", default="syncnet_lines.png")
    args = p.parse_args(argv)

    from ..utils.observability import plot_loss_chart

    series = []
    for i, path in enumerate(args.inputs):
        confs = []
        with open(path) as f:
            for line in f:
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "confidence" in row:
                    confs.append(row["confidence"])
        label = args.labels[i] if args.labels and i < len(args.labels) else path
        series.append((label, list(range(len(confs))), confs))
    plot_loss_chart(args.out, *series)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
