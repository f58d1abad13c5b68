"""Training data: sample windows of a clip list and batch them.

Counterpart of ``latentsync_tpu/training/data.py`` (``load_fileslist``,
``_MelCache``, ``UNetSampleSource``, ``SyncNetSampleSource``,
``HostDataLoader``; ref:latentsync/data/unet_dataset.py,
syncnet_dataset.py). Stage 2: a random 16-frame ground-truth window and a
non-overlapping reference window of the same clip, masked with the fixed
mask, and the Wav2Lip mel window aligned at 80 mel frames a second (start
80·start/fps, length ceil(F/5·16)), with an optional ``_mel.npz`` cache and
resampling on any per-sample failure. SyncNet: a frame window and, on a
coin flip, its own mel window (label 1) or one shifted by more than F/2
frames (label 0), the window's lower halves stacked into channels in
[-1, 1]. Samples are numpy arrays in the JAX package's layout (frames
channels-last), so a source here and one there draw the same windows from
the same seed.
Clips are read through ``utils/media.py``: OpenCV, and the ``.wav``
sidecar for the audio where there is no ffmpeg.
"""

from __future__ import annotations

import math
import os
import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..config import LatentSyncConfig
from ..ops.mel import wav2lip_melspectrogram_np
from ..utils.image_processor import ImageProcessor, load_fixed_mask
from ..utils.media import read_audio, read_video

# How long `HostDataLoader.close` waits for the thread to finish its sample.
CLOSE_TIMEOUT_S = 60.0


def load_fileslist(fileslist: str = "", data_dir: str = "") -> List[str]:
    if fileslist:
        with open(fileslist) as f:
            return [line.rstrip() for line in f if line.strip()]
    if data_dir:
        return sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir)
                      if f.endswith(".mp4"))
    raise ValueError("data_dir and fileslist cannot be both empty")


class _MelCache:
    def __init__(self, cache_dir: Optional[str], sample_rate: int):
        self.cache_dir = cache_dir
        self.sample_rate = sample_rate
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    def mel_for(self, video_path: str) -> np.ndarray:
        if not self.cache_dir:
            return self._compute(video_path)
        cache = os.path.join(self.cache_dir,
                             os.path.basename(video_path).rsplit(".", 1)[0] + "_mel.npz")
        if os.path.isfile(cache):
            try:
                return np.load(cache)["mel"]
            except Exception:  # noqa: BLE001 — a damaged cache entry is recomputed
                os.remove(cache)
        mel = self._compute(video_path)
        np.savez(cache, mel=mel)
        return mel

    def _compute(self, video_path: str) -> np.ndarray:
        # the audio lives in the container (ffmpeg) or in a sidecar .wav
        try:
            audio = read_audio(video_path, self.sample_rate)
        except Exception:  # noqa: BLE001
            audio = read_audio(video_path.rsplit(".", 1)[0] + ".wav", self.sample_rate)
        return wav2lip_melspectrogram_np(audio)


@dataclass
class UNetSampleSource:
    """One training sample: GT window, its masked copy and keep-mask, a
    reference window, and the mel window."""

    config: LatentSyncConfig
    video_paths: List[str] = None
    seed: int = 0

    def __post_init__(self):
        cfg = self.config.data
        if self.video_paths is None:
            self.video_paths = load_fileslist(cfg.train_fileslist, cfg.train_data_dir)
        self.rng = np.random.default_rng(self.seed)
        self.num_frames = cfg.num_frames
        self.mel_window = math.ceil(self.num_frames / 5 * 16)
        self.processor = ImageProcessor(
            cfg.resolution, mask=cfg.mask,
            mask_image=load_fixed_mask(cfg.resolution, cfg.mask_image_path or None))
        self.mel_cache = _MelCache(cfg.audio_mel_cache_dir or None, cfg.audio_sample_rate)
        self.load_audio = self.config.unet.add_audio_layer and self.config.run.use_syncnet

    def _windows(self, total: int):
        f = self.num_frames
        start = int(self.rng.integers(0, total - f + 1))
        while True:
            ref = int(self.rng.integers(0, total - f + 1))
            if ref <= start - f or ref >= start + f:
                return start, ref

    def sample(self) -> Dict[str, np.ndarray]:
        """Retry with another draw on any failure (ref:unet_dataset.py:97-146)."""
        while True:
            path = self.video_paths[int(self.rng.integers(0, len(self.video_paths)))]
            try:
                frames = read_video(path, change_fps=False)
                if len(frames) < 3 * self.num_frames:
                    continue
                start, ref_start = self._windows(len(frames))
                gt = frames[start:start + self.num_frames]
                ref = frames[ref_start:ref_start + self.num_frames]
                if self.load_audio:
                    mel_full = self.mel_cache.mel_for(path)
                    m0 = int(80.0 * start / self.config.data.video_fps)
                    mel = mel_full[:, m0:m0 + self.mel_window]
                    if mel.shape[-1] != self.mel_window:
                        continue
                    mel = mel[:, :, None].astype(np.float32)  # (80, T, 1)
                else:
                    mel = np.zeros((80, self.mel_window, 1), np.float32)
                gt_px, masked_px, masks = self.processor.prepare_masks_and_masked_images(gt)
                ref_px = self.processor.normalize(self.processor.resize_batch(ref))
                return {"gt_pixels": gt_px, "masked_pixels": masked_px, "ref_pixels": ref_px,
                        "masks": masks[..., :1], "mel": mel, "video_path": path,
                        "start_idx": start}
            except Exception as e:  # noqa: BLE001 — resample on any failure
                print(f"{type(e).__name__} - {e} - {path}")


@dataclass
class SyncNetSampleSource:
    """Aligned vs shifted windows with a coin-flip label
    (ref:syncnet_dataset.py:123-129)."""

    config: LatentSyncConfig
    video_paths: List[str] = None
    seed: int = 0

    def __post_init__(self):
        cfg = self.config.data
        if self.video_paths is None:
            self.video_paths = load_fileslist(cfg.train_fileslist, cfg.train_data_dir)
        self.rng = np.random.default_rng(self.seed)
        self.num_frames = cfg.num_frames
        self.mel_window = math.ceil(self.num_frames / 5 * 16)
        self.resolution = cfg.resolution
        self.mel_cache = _MelCache(cfg.audio_mel_cache_dir or None, cfg.audio_sample_rate)

    def sample(self) -> Dict[str, np.ndarray]:
        """{"vision" (H/2, W, F·3) in [-1, 1], "mel" (80, T, 1), "y"}; the
        same draws in the same order as the JAX source."""
        import cv2

        while True:
            path = self.video_paths[int(self.rng.integers(0, len(self.video_paths)))]
            try:
                frames = read_video(path, change_fps=False)
                f = self.num_frames
                if len(frames) < 3 * f:
                    continue
                start = int(self.rng.integers(0, len(frames) - f + 1))
                y = int(self.rng.integers(0, 2))
                audio_start = start
                while y == 0:
                    audio_start = int(self.rng.integers(0, len(frames) - f + 1))
                    if abs(audio_start - start) > f // 2:
                        break
                mel_full = self.mel_cache.mel_for(path)
                m0 = int(80.0 * audio_start / self.config.data.video_fps)
                mel = mel_full[:, m0:m0 + self.mel_window]
                if mel.shape[-1] != self.mel_window:
                    continue
                res = self.resolution
                win = np.stack([cv2.resize(fr, (res, res)) for fr in frames[start:start + f]])
                # lower half, frames stacked into channels (ref:train_syncnet.py:204-206)
                half = win[:, res // 2:]
                vis = np.moveaxis(half, 0, -2).reshape(half.shape[1], half.shape[2], -1)
                return {"vision": vis.astype(np.float32) / 255.0 * 2.0 - 1.0,
                        "mel": mel[:, :, None].astype(np.float32), "y": np.float32(y)}
            except Exception as e:  # noqa: BLE001 — resample on any failure
                print(f"{type(e).__name__} - {e} - {path}")


class HostDataLoader:
    """A thread that keeps two batches of stacked samples ready. The
    source draws the stream the JAX loader gives host `host_id` of
    `num_hosts`: under data parallelism each rank is one such host."""

    def __init__(self, source, batch_size: int, host_id: int = 0, num_hosts: int = 1):
        self.source = source
        self.batch_size = batch_size
        source.rng = np.random.default_rng(
            np.random.SeedSequence([source.seed, host_id, num_hosts]))
        self.q: "queue.Queue" = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        while not self._stop.is_set():
            samples = []
            for _ in range(self.batch_size):
                if self._stop.is_set():
                    return
                samples.append(self.source.sample())
            batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]
                     if isinstance(samples[0][k], np.ndarray) or np.isscalar(samples[0][k])}
            while not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.q.get()

    def close(self):
        """Stop the thread and wait for it (it finishes the sample it is
        drawing): a thread left inside a native video read while the
        interpreter exits aborts the process."""
        self._stop.set()
        self.thread.join(CLOSE_TIMEOUT_S)
