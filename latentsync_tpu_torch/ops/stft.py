"""Centered, reflect-padded, periodic-Hann STFT in torch.

Counterpart of ``latentsync_tpu/ops/stft.py``: the same framing (a strided
gather over the reflect-padded signal) and an rfft per frame, so both
packages produce the same spectra for the whisper front end.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def hann_window(win_length: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window / scipy fftbins=True)."""
    n = torch.arange(win_length, device=device, dtype=dtype)
    return 0.5 * (1.0 - torch.cos(2.0 * math.pi * n / win_length))


def frame_signal(audio: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(T,) → (1 + T // hop, n_fft) overlapping frames of the centered signal."""
    pad = n_fft // 2
    padded = F.pad(audio[None, None], (pad, pad), mode="reflect")[0, 0]
    num_frames = 1 + audio.shape[0] // hop_length
    idx = (torch.arange(num_frames, device=audio.device)[:, None] * hop_length
           + torch.arange(n_fft, device=audio.device)[None, :])
    return padded[idx]


def stft_power(audio: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """|STFT|² with an n_fft-long window, (n_fft // 2 + 1, num_frames)."""
    frames = frame_signal(audio, n_fft, hop_length)
    window = hann_window(n_fft, audio.device, audio.dtype)
    mag = torch.fft.rfft(frames * window[None, :], dim=-1).abs().T
    return mag * mag
