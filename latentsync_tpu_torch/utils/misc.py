"""Host helpers covering the reference's small utilities.

The port's own copy of ``latentsync_tpu/utils/misc.py``:

- HTTP download and folder cleanup (ref:latentsync/utils/download.py:6);
- a copy to a persistent directory (ref:latentsync/utils/persist_data.py);
- audio padding (ref:latentsync/utils/edit_audio.py);
- the word-timestamp trim hook (ref:latentsync/utils/whisper.py:6 shells
  out to the whisper CLI; here any transcriber yields word timestamps);
- video concatenation (ref:job-queue-listener/src/helpers/ffmpeg.ts),
  through ffmpeg's concat demuxer where there is one, else OpenCV frames;
- the video-duration counter and the recursive ``.mp4`` walk (ref:tools/);
- :func:`occupy_gpu`, the reference's ``tools/occupy_gpu.py``: a bf16
  product loop that keeps the card busy (the JAX package's ``occupy_tpu``).

The JAX module's ``enable_compile_cache`` turns on XLA's persistent
compilation cache and has no counterpart: the port's kernels are built
once into ``latentsync_tpu_torch/_build/`` and reused from there.
"""

from __future__ import annotations

import os
import shutil
import time
import urllib.request
from typing import List, Optional, Sequence

import numpy as np


def download_file(url: str, dst: str, timeout: float = 60.0) -> str:
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    with urllib.request.urlopen(url, timeout=timeout) as r, open(dst, "wb") as f:
        shutil.copyfileobj(r, f)
    return dst


def clean_folder(path: str) -> None:
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)


def persist_copy(src: str, persistent_dir: str) -> str:
    os.makedirs(persistent_dir, exist_ok=True)
    dst = os.path.join(persistent_dir, os.path.basename(src))
    shutil.copy(src, dst)
    return dst


def pad_audio_silence(audio: np.ndarray, sample_rate: int,
                      start_sec: float = 0.0, end_sec: float = 0.0) -> np.ndarray:
    """Prepend / append silence (ref:edit_audio.py)."""
    pre = np.zeros(int(start_sec * sample_rate), audio.dtype)
    post = np.zeros(int(end_sec * sample_rate), audio.dtype)
    return np.concatenate([pre, audio, post])


def concat_videos(paths: Sequence[str], out_path: str) -> str:
    """Concatenate videos of one geometry: ffmpeg's concat demuxer where
    there is ffmpeg, else their frames through OpenCV."""
    from .media import have_ffmpeg, read_video, write_video

    if have_ffmpeg():
        import subprocess
        import tempfile

        with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
            for p in paths:
                f.write(f"file '{os.path.abspath(p)}'\n")
            listfile = f.name
        try:
            subprocess.run(["ffmpeg", "-y", "-nostdin", "-v", "error", "-f", "concat",
                            "-safe", "0", "-i", listfile, "-c", "copy", out_path],
                           check=True, capture_output=True)
        finally:
            os.unlink(listfile)
        return out_path
    frames = np.concatenate([read_video(p, change_fps=False) for p in paths])
    return write_video(out_path, frames)


def trim_video_by_word_timestamps(video_path: str, out_path: str, transcriber=None,
                                  start_word: Optional[int] = None,
                                  end_word: Optional[int] = None) -> str:
    """Trim a video (at 25 fps) to word boundaries, given a transcriber that
    returns ``[(word, start_sec, end_sec)]``."""
    from .media import read_video, write_video

    if transcriber is None:
        raise RuntimeError("no transcriber provided: plug any word-timestamp ASR "
                           "(audio/transcribe.py gives segments with word timings)")
    words = transcriber(video_path)
    t0 = words[start_word or 0][1]
    t1 = words[(end_word if end_word is not None else len(words) - 1)][2]
    frames = read_video(video_path, change_fps=False)
    fps = 25
    return write_video(out_path, frames[int(t0 * fps): int(t1 * fps)], fps=fps)


def count_video_time(video_path: str) -> float:
    """Seconds of video (ref:latentsync/utils/util.py:337-342)."""
    from .media import video_info

    _, _, fps, n = video_info(video_path)
    return n / fps if fps else 0.0


def gather_video_paths_recursively(input_dir: str) -> List[str]:
    """Every ``.mp4`` under `input_dir`, sorted within each directory
    (ref:util.py:321-334)."""
    out = []
    for root, _, files in os.walk(input_dir):
        for f in sorted(files):
            if f.endswith(".mp4"):
                out.append(os.path.join(root, f))
    return out


def occupy_gpu(seconds: float = 3600.0, device="cuda", size: int = 8192) -> int:
    """Keep the card busy for `seconds` with a bf16 (size × size) product
    loop (ref:tools/occupy_gpu.py); returns the products run. The card
    unless `device` says otherwise."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("occupy_gpu: no CUDA device (torch.cuda.is_available() is false)")
    x = torch.ones(size, size, dtype=torch.bfloat16, device=dev)
    n, t0 = 0, time.time()
    while time.time() - t0 < seconds:
        x = x @ x * 1e-3
        n += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return n
