"""Length reconciliation between audio chunks, audio samples and faces.

The serving-path subset of ``latentsync_tpu/utils/repeat.py``.
"""

from __future__ import annotations

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


def pad_chunks_end(chunks: np.ndarray, audio_samples: np.ndarray, audio_sample_rate: int,
                   fps: float = 25, multiple: int = 16) -> Tuple[np.ndarray, np.ndarray, float]:
    """Append zero chunks until len % multiple == 0 and zero-pad the audio
    at the end by the same duration. Returns (chunks, audio, padding_sec)."""
    add = (multiple - len(chunks) % multiple) % multiple
    pad_sec = add / fps
    if add:
        chunks = np.concatenate([chunks, np.zeros((add,) + chunks.shape[1:], chunks.dtype)])
        audio_samples = np.concatenate(
            [audio_samples, np.zeros(int(pad_sec * audio_sample_rate), audio_samples.dtype)])
    return chunks, audio_samples, pad_sec
