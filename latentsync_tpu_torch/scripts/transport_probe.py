"""Probe the host↔card transport (the port's counterpart of
``scripts/transport_probe.py``).

    python -m latentsync_tpu_torch.scripts.transport_probe [--device cuda]

One JSON line a reading, after a line with the card's name and power limit:
host→card and card→host bandwidth at 1, 8, 32 and 128 MB from pageable
and from pinned host memory; eager dispatch latency (1, 16 and 64 chained
tiny ops, one sync); the audio frontend exactly as the pipeline runs it
(whisper-tiny with seeded random weights on 5 s of audio, three runs;
``feature2chunks``; the log-mel, the segment stack, the encoder call and
the embeddings' fetch apart); and the decode fetch: a window batch of
decoded faces (64 × 256² uint8) copied to pinned host memory behind an
event, as ``LipsyncPipeline.finish`` fetches them (``_to_host``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def probe(device="cuda", emit=print, sizes_mb=(1, 8, 32, 128), seed: int = 0):
    """Run every reading; `emit` gets each JSON line. Returns the rows."""
    from ..audio.features import Audio2Feature
    from ..config import WhisperConfig
    from ..models.whisper import WhisperEncoder
    from ..ops.mel import WHISPER_N_FRAMES, pad_or_trim, whisper_log_mel
    from ..pipelines.lipsync import _fetched, _to_host
    from ..utils.convert import init_random_

    dev = torch.device(device)
    rows = []

    def put(**kw):
        rows.append(kw)
        emit(json.dumps(kw))

    rng = np.random.default_rng(seed)
    for mb in sizes_mb:
        host = torch.from_numpy(rng.integers(0, 255, mb * 2**20, np.uint8))
        for pinned in (False, True):
            src = host.pin_memory() if pinned and dev.type == "cuda" else host
            d, h2d = _timed(lambda: src.to(dev, non_blocking=pinned), dev)
            dst = torch.empty_like(src, pin_memory=pinned and dev.type == "cuda")
            _, d2h = _timed(lambda: dst.copy_(d, non_blocking=pinned), dev)
            assert bool(dst[0] == host[0])
            put(xfer_mb=mb, pinned=pinned, h2d_s=h2d, h2d_mb_s=mb / h2d, d2h_s=d2h,
                d2h_mb_s=mb / d2h)

    x = torch.ones(128, 128, device=dev)
    _sync(dev)
    for n_ops in (1, 16, 64):
        def chain():
            y = x
            for _ in range(n_ops):
                y = y + 1.0
            return y

        chain()
        _, t = _timed(chain, dev)
        put(eager_ops=n_ops, total_s=t, per_op_ms=t / n_ops * 1e3)

    whisper = init_random_(WhisperEncoder(WhisperConfig.tiny()), seed=seed).to(dev).eval()
    a2f = Audio2Feature(whisper)
    audio = (rng.standard_normal(5 * 16000) * 0.05).astype(np.float32)
    for run in range(3):
        feats, t = _timed(lambda: a2f.audio2feat(audio), dev)
        put(stage="audio2feat_5s", run=run, s=t, feat_shape=list(feats.shape))
    chunks, t = _timed(lambda: a2f.feature2chunks(feats, fps=25), dev)
    put(stage="feature2chunks", s=t, shape=list(chunks.shape))
    with torch.inference_mode():
        mel, t = _timed(lambda: whisper_log_mel(torch.from_numpy(audio).to(dev)), dev)
        put(stage="whisper_log_mel", s=t, shape=list(mel.shape))
        batch, t = _timed(lambda: torch.stack([pad_or_trim(mel[:, :500], WHISPER_N_FRAMES)]),
                          dev)
        put(stage="pad_stack", s=t)
        (_, embeds), t = _timed(lambda: whisper(batch), dev)
        put(stage="encoder_call", s=t, shape=list(embeds.shape))
        host, t = _timed(lambda: embeds.float().cpu().numpy(), dev)
        put(stage="embeds_fetch_f32", s=t, mb=host.nbytes / 1e6)
    faces = torch.from_numpy(rng.integers(0, 255, (64, 256, 256, 3), np.uint8)).to(dev)
    for run in range(2):
        fetched, t = _timed(lambda: _fetched(_to_host(faces)), dev)
        put(stage="decode_fetch_64x256", run=run, s=t, mb=fetched.nbytes / 1e6,
            mb_s=fetched.nbytes / 1e6 / t)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from .inference import no_card
    from .micro_probe import gpu_line

    if no_card("transport_probe", args.device):
        return 2
    if torch.device(args.device).type == "cuda":
        print(gpu_line(), flush=True)
    probe(args.device, emit=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
