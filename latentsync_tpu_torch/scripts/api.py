"""Serve lip-sync requests over HTTP from the command line.

    python -m latentsync_tpu_torch.scripts.api --avatars DIR [--port 8000] \
        [--continuous-batching] [--batch-windows 8] [--workers 2] \
        [--unet-config ...] [--unet-ckpt ...] [--vae-ckpt ...] [--whisper-ckpt ...] \
        [--device cuda]

Counterpart of ``scripts/api.py``: builds the pipeline once (the flags and
checkpoint files of ``inference``), then serves ``POST /process``,
``GET /jobs/<id>`` and ``GET /ping`` on a ``ThreadingHTTPServer``
(``serving.api.serve``) until interrupted. ``--avatars`` holds each avatar
as ``<id>.mp4`` with its bundle ``<id>.npz`` (``prepare_video``). With
``--continuous-batching`` the windows of concurrent requests share denoise
batches of ``--batch-windows``. The reference's switches
(``LATENTSYNC_INT8``, ``LATENTSYNC_DEEPCACHE``, ...) are read from the
environment at each request. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile


def main(argv=None) -> int:
    from .inference import add_model_args, build_pipeline, no_card

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--avatars", required=True)
    p.add_argument("--out-dir", default=os.path.join(tempfile.gettempdir(), "lipsync_out"))
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    add_model_args(p)
    p.add_argument("--continuous-batching", action="store_true",
                   help="share denoise batches across concurrent clips")
    p.add_argument("--batch-windows", type=int, default=8)
    p.add_argument("--workers", type=int, default=2)
    args = p.parse_args(argv)
    if no_card("api", args.device):
        return 2

    from ..serving.api import serve
    from ..serving.artifacts import AvatarStore

    serve(build_pipeline(args), AvatarStore(args.avatars), args.out_dir, host=args.host,
          port=args.port, continuous_batching=args.continuous_batching,
          batch_windows=args.batch_windows, num_workers=args.workers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
