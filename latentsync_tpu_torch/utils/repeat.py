"""Length reconciliation between audio chunks, audio samples and faces.

Counterpart of ``latentsync_tpu/utils/repeat.py``, all seven of its
functions: whisper chunk stacks are padded to whole 16-frame windows with
zero chunks (at the end, at the start, or to a target length), the audio
is zero-padded by the same duration, faces / boxes / matrices are repeated
or truncated to match, and the silent lead-in that serving prepends
(``add_start_silence`` with ``duplicate_first_frames``) is cut off the
written clip by ``process_video_with_trim``. Every function takes numpy
arrays or lists; chunk stacks are (N, 50, D) arrays.
"""

from __future__ import annotations

import math
import os
import subprocess
from typing import Tuple, Union

import numpy as np

Arr = Union[np.ndarray, list]


def repeat_to_length(array: Arr, target_length: int) -> Arr:
    """Tile (or cut) to exactly `target_length` entries."""
    n = len(array)
    if n >= target_length:
        return array[:target_length]
    if isinstance(array, np.ndarray):
        parts = [array] * (target_length // n)
        if target_length % n:
            parts.append(array[: target_length % n])
        return np.concatenate(parts)
    return (list(array) * -(-target_length // n))[:target_length]


def truncate_to_length(array: Arr, target_length: int) -> Arr:
    """Keep the last `target_length` entries: the cut is at the FRONT."""
    n = len(array)
    if n <= target_length:
        return array
    return array[n - target_length:]


def _zeros_like_rows(chunks: np.ndarray, n: int) -> np.ndarray:
    return np.zeros((n,) + chunks.shape[1:], chunks.dtype)


def _silence(audio_samples: np.ndarray, seconds: float, sample_rate: int) -> np.ndarray:
    return np.zeros(int(seconds * sample_rate), audio_samples.dtype)


def pad_chunks_end(chunks: np.ndarray, audio_samples: np.ndarray, audio_sample_rate: int,
                   fps: float = 25, multiple: int = 16) -> Tuple[np.ndarray, np.ndarray, float]:
    """Append zero chunks until len % multiple == 0 and zero-pad the audio
    at the end by the same duration. Returns (chunks, audio, padding_sec)."""
    add = (multiple - len(chunks) % multiple) % multiple
    pad_sec = add / fps
    if add:
        chunks = np.concatenate([chunks, _zeros_like_rows(chunks, add)])
        audio_samples = np.concatenate(
            [audio_samples, _silence(audio_samples, pad_sec, audio_sample_rate)])
    return chunks, audio_samples, pad_sec


def pad_chunks_start(chunks: np.ndarray, audio_samples: np.ndarray, audio_sample_rate: int,
                     fps: float = 25, multiple: int = 16
                     ) -> Tuple[np.ndarray, np.ndarray, float, int]:
    """Prepend zero chunks until len % multiple == 0 and zero-pad the audio
    at the start by the same duration. Returns (chunks, audio, padding_sec,
    the number of chunks prepended)."""
    add = (multiple - len(chunks) % multiple) % multiple
    pad_sec = add / fps
    if add:
        chunks = np.concatenate([_zeros_like_rows(chunks, add), chunks])
        audio_samples = np.concatenate(
            [_silence(audio_samples, pad_sec, audio_sample_rate), audio_samples])
    return chunks, audio_samples, pad_sec, add


def pad_chunks_to_target(chunks: np.ndarray, audio_samples: np.ndarray, audio_sample_rate: int,
                         target: int, fps: float = 25) -> Tuple[np.ndarray, np.ndarray, float]:
    """Exactly `target` chunks: zero chunks appended and the audio zero-padded
    at the end by their duration, or, where there are `target` or more, the
    chunks cut to `target` and the audio shortened by the duration cut
    (padding 0). Returns (chunks, audio, padding_sec)."""
    n = len(chunks)
    if n >= target:
        trimmed_sec = (n - target) / fps
        new_len = int(len(audio_samples) - trimmed_sec * audio_sample_rate)
        return chunks[:target], audio_samples[:max(new_len, 0)], 0.0
    pad_sec = (target - n) / fps
    chunks = np.concatenate([chunks, _zeros_like_rows(chunks, target - n)])
    audio_samples = np.concatenate(
        [audio_samples, _silence(audio_samples, pad_sec, audio_sample_rate)])
    return chunks, audio_samples, pad_sec


def add_start_silence(audio_samples: np.ndarray, audio_sample_rate: int,
                      silence_duration: float = 1) -> np.ndarray:
    """Prepend `silence_duration` seconds of zeros: the silent lead-in the
    model warms up on, which ``process_video_with_trim`` cuts off again."""
    return np.concatenate([_silence(np.asarray(audio_samples), silence_duration,
                                    audio_sample_rate), np.asarray(audio_samples)])


def duplicate_first_frames(array: Arr, num_frames: int = 16) -> Arr:
    """Prepend a copy of the first ``min(num_frames, len(array))`` entries
    (the frames under the silent lead-in); an empty input comes back as it
    is."""
    n = len(array)
    if n == 0:
        return array
    k = min(num_frames, n)
    if isinstance(array, np.ndarray):
        return np.concatenate([array[:k].copy(), array], axis=0)
    return list(array[:k]) + list(array)


def process_video_with_trim(temp_dir: str, video_out_path: str, padding_duration: float = 0,
                            fps: float = 25, frames_to_trim: int = 16) -> str:
    """Cut the lead-in (the first `frames_to_trim` frames, ``ceil(frames /
    fps * 1000) / 1000`` s of audio) and `padding_duration` s of trailing
    padding off ``temp_dir/{video.mp4,audio.wav}``, and write the rest to
    `video_out_path`. With an ffmpeg binary the video is cut by ``ffmpeg
    -ss``; without one, by dropping decoded frames. The audio is muxed where
    there is ffmpeg, else written as the ``.wav`` sidecar beside the
    ``.mp4``. Returns the path written."""
    from .media import have_ffmpeg, read_audio, read_video, write_audio, write_video

    in_video = os.path.join(temp_dir, "video.mp4")
    in_audio = os.path.join(temp_dir, "audio.wav")
    trim_sec = math.ceil(frames_to_trim / fps * 1000) / 1000

    if have_ffmpeg():
        trimmed_video = os.path.join(temp_dir, "trimmed_video.mp4")
        subprocess.run(["ffmpeg", "-y", "-nostdin", "-v", "error", "-ss", f"{trim_sec}",
                        "-i", in_video, "-c:v", "libx264", "-an", trimmed_video],
                       check=True, capture_output=True)
        frames = read_video(trimmed_video, change_fps=False)
    else:
        frames = read_video(in_video, change_fps=False)[frames_to_trim:]
    if padding_duration > 0:
        keep = len(frames) - int(round(padding_duration * fps))
        frames = frames[:max(keep, 0)]

    sr = 16000
    audio = read_audio(in_audio, sr)
    start = int(trim_sec * sr)
    audio = audio[start:start + int(len(frames) / fps * sr)]
    trimmed_audio = os.path.join(temp_dir, "trimmed_audio.wav")
    write_audio(trimmed_audio, audio, sr)
    return write_video(video_out_path, frames, fps=fps, audio_path=trimmed_audio)
