"""Media I/O for the serving path: WAV audio and video in and out.

Counterpart of ``latentsync_tpu/utils/media.py``. Audio is WAV through
scipy (or any format through an ffmpeg binary when one exists). Video
goes through the ffmpeg binary when present, else through OpenCV; both
are imported or probed lazily, at the first call.

Three faults of the reference's streaming writer are repaired here:
ffmpeg's stderr goes to a temporary file, so a chatty encoder can never
fill a pipe nobody reads and stall; ``abort()`` ends the encoder and
deletes the partial output when the producer fails; and a failure of
the encode thread surfaces as a new exception chained to the original,
raised in the caller's thread.
"""

from __future__ import annotations

import functools
import os
import queue
import shutil
import subprocess
import tempfile
import threading
import time
import warnings
from typing import Optional, Tuple

import numpy as np


@functools.lru_cache(maxsize=1)
def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None and shutil.which("ffprobe") is not None


def _run(cmd, **kw):
    return subprocess.run(cmd, check=True, capture_output=True, **kw)


def _probe_ffmpeg(path: str) -> Tuple[int, int, float]:
    import json

    info = json.loads(_run(["ffprobe", "-v", "error", "-print_format", "json",
                            "-show_streams", str(path)]).stdout)
    vs = next(s for s in info["streams"] if s["codec_type"] == "video")
    num, den = vs["r_frame_rate"].split("/")
    return int(vs["width"]), int(vs["height"]), float(num) / float(den)


def read_video(path: str, change_fps: bool = True, fps: int = 25) -> np.ndarray:
    """Decode to (F, H, W, 3) uint8 RGB, optionally resampled to `fps`."""
    if have_ffmpeg():
        w, h, src_fps = _probe_ffmpeg(path)
        cmd = ["ffmpeg", "-nostdin", "-v", "error", "-i", str(path)]
        if change_fps and abs(src_fps - fps) > 1e-3:
            cmd += ["-vf", f"fps={fps}"]
        raw = _run(cmd + ["-f", "rawvideo", "-pix_fmt", "rgb24", "-"]).stdout
        n = len(raw) // (h * w * 3)
        return np.frombuffer(raw, np.uint8)[: n * h * w * 3].reshape(n, h, w, 3)
    import cv2

    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise IOError(f"cannot open {path}")
    src_fps = cap.get(cv2.CAP_PROP_FPS) or float(fps)
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    finally:
        cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    video = np.stack(frames)
    if change_fps and abs(src_fps - fps) > 1e-3:
        n_out = int(round(len(video) * fps / src_fps))
        idx = np.minimum((np.arange(n_out) * src_fps / fps).astype(np.int64), len(video) - 1)
        video = video[idx]
    return video


def read_audio(path: str, sample_rate: int = 16000) -> np.ndarray:
    """Decode to mono float32 in [-1, 1] at `sample_rate`."""
    if have_ffmpeg():
        raw = _run(["ffmpeg", "-nostdin", "-v", "error", "-i", str(path), "-f", "s16le",
                    "-acodec", "pcm_s16le", "-ac", "1", "-ar", str(sample_rate), "-"]).stdout
        return np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    if not str(path).lower().endswith(".wav"):
        raise RuntimeError(f"no ffmpeg binary: only .wav audio can be read, got {path}")
    from scipy.io import wavfile

    sr, data = wavfile.read(str(path))
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:
        audio = data.astype(np.float32)
    if audio.ndim == 2:
        audio = audio.mean(axis=1)
    if sr != sample_rate:
        from scipy.signal import resample_poly

        g = np.gcd(sr, sample_rate)
        audio = resample_poly(audio, sample_rate // g, sr // g).astype(np.float32)
    return audio


def write_audio(path: str, samples: np.ndarray, sample_rate: int = 16000) -> None:
    """16-bit PCM WAV."""
    from scipy.io import wavfile

    wavfile.write(str(path), sample_rate,
                  np.clip(samples * 32768.0, -32768, 32767).astype(np.int16))


class StreamingVideoWriter:
    """Encode (Fi, H, W, 3) uint8 RGB chunks on a background thread.

    With ffmpeg the audio is muxed in the same pass; with OpenCV the video
    is mp4v and the audio is copied beside it as ``<name>.wav``. Appended
    chunks must not be mutated afterwards. ``busy_s`` is the encode
    thread's busy time. Call ``close()`` on success and ``abort()`` on
    failure."""

    def __init__(self, path: str, fps: int, frame_hw: Tuple[int, int],
                 audio_path: Optional[str] = None):
        if not path.lower().endswith(".mp4"):
            path = path.rsplit(".", 1)[0] + ".mp4"
        self.path = path
        self.sidecar = path.rsplit(".", 1)[0] + ".wav"
        self._audio_path = audio_path
        self.busy_s = 0.0
        self._err: Optional[BaseException] = None
        self._q: "queue.Queue" = queue.Queue(maxsize=4)
        self._proc = None
        self._stderr = None
        self._cv2_writer = None
        h, w = frame_hw
        if have_ffmpeg():
            cmd = ["ffmpeg", "-y", "-nostdin", "-v", "error", "-f", "rawvideo",
                   "-pix_fmt", "rgb24", "-s", f"{w}x{h}", "-r", str(fps), "-i", "-"]
            if audio_path is not None:
                cmd += ["-i", str(audio_path), "-c:a", "aac", "-shortest"]
            cmd += ["-c:v", "libx264", "-crf", "10", "-preset", "medium",
                    "-pix_fmt", "yuv420p", path]
            self._stderr = tempfile.TemporaryFile()
            self._proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                          stdout=subprocess.DEVNULL, stderr=self._stderr)
        else:
            import cv2

            self._cv2_writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                                               (w, h))
            if not self._cv2_writer.isOpened():
                raise IOError(f"cannot open a video writer for {path}")
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        try:
            while True:
                chunk = self._q.get()
                if chunk is None:
                    return
                t0 = time.time()
                if self._proc is not None:
                    self._proc.stdin.write(np.ascontiguousarray(chunk).tobytes())
                else:
                    import cv2

                    for frame in chunk:
                        self._cv2_writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
                self.busy_s += time.time() - t0
        except Exception as e:  # noqa: BLE001 — reported to the producer
            self._err = e
            while self._q.get() is not None:  # unblock a producer stuck in put()
                pass

    def _raise_if_failed(self) -> None:
        if self._err is not None:
            raise RuntimeError(f"video encode failed: {self._err!r}") from self._err

    def append(self, frames: np.ndarray) -> None:
        self._raise_if_failed()
        if len(frames):
            self._q.put(frames)

    def _stderr_text(self) -> str:
        self._stderr.seek(0)
        return self._stderr.read().decode(errors="replace")[-2000:]

    def close(self) -> str:
        """Flush, finalise the container and return the output path."""
        self._q.put(None)
        self._thread.join()
        try:
            if self._proc is not None:
                self._proc.stdin.close()
                if self._proc.wait() != 0:
                    raise RuntimeError(f"ffmpeg stream encode failed: {self._stderr_text()}")
            else:
                self._cv2_writer.release()
                if self._audio_path is not None:
                    shutil.copy(str(self._audio_path), self.sidecar)
                    warnings.warn(f"no ffmpeg binary: wrote audio as sidecar {self.sidecar}")
            self._raise_if_failed()
        finally:
            if self._stderr is not None:
                self._stderr.close()
        return self.path

    def abort(self) -> None:
        """Stop encoding and remove the partial output."""
        if self._proc is not None:
            # the encode thread then fails its next write and drains the queue
            self._proc.kill()
            self._proc.wait()
            self._stderr.close()
        self._q.put(None)
        self._thread.join()
        if self._cv2_writer is not None:
            self._cv2_writer.release()
        for p in (self.path, self.sidecar):
            if os.path.exists(p):
                os.remove(p)
