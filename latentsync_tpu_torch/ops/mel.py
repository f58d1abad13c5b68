"""Whisper log-mel front end in torch.

Counterpart of ``latentsync_tpu/ops/mel.py`` ``whisper_log_mel`` and
``pad_or_trim``: STFT n_fft = 400, hop 160, the last frame dropped,
slaney mel-80 filterbank, log10 with a 1e-10 floor, an 8-decade dynamic
range floor below the maximum and (x + 4) / 4 scaling.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .stft import stft_power

WHISPER_SAMPLE_RATE = 16000
WHISPER_N_FFT = 400
WHISPER_N_MELS = 80
WHISPER_HOP_LENGTH = 160
WHISPER_CHUNK_LENGTH = 30
WHISPER_N_SAMPLES = WHISPER_CHUNK_LENGTH * WHISPER_SAMPLE_RATE  # 480000
WHISPER_N_FRAMES = WHISPER_N_SAMPLES // WHISPER_HOP_LENGTH  # 3000


def _hz_to_mel_slaney(freq):
    freq = np.asanyarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    if mels.ndim:
        log_t = freq >= min_log_hz
        mels[log_t] = min_log_mel + np.log(freq[log_t] / min_log_hz) / logstep
    elif freq >= min_log_hz:
        mels = min_log_mel + np.log(freq / min_log_hz) / logstep
    return mels


def _mel_to_hz_slaney(mels):
    mels = np.asanyarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    freqs[log_t] = min_log_hz * np.exp(logstep * (mels[log_t] - min_log_mel))
    return freqs


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    """librosa.filters.mel(htk=False, norm='slaney') from 0 Hz to Nyquist,
    (n_mels, 1 + n_fft // 2)."""
    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel_slaney(0.0), _hz_to_mel_slaney(sample_rate / 2.0), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    weights = np.zeros((n_mels, n_bins), dtype=np.float64)
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=1)
def _whisper_filters() -> np.ndarray:
    return mel_filterbank(WHISPER_SAMPLE_RATE, WHISPER_N_FFT, WHISPER_N_MELS)


def whisper_log_mel(audio: torch.Tensor) -> torch.Tensor:
    """(T,) float32 waveform at 16 kHz → (80, T // 160) log-mel."""
    power = stft_power(audio.float(), WHISPER_N_FFT, WHISPER_HOP_LENGTH)[:, :-1]
    filters = torch.from_numpy(_whisper_filters()).to(audio.device)
    log_spec = torch.log10(torch.clamp(filters @ power, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0


def pad_or_trim(mel: torch.Tensor, length: int = WHISPER_N_FRAMES) -> torch.Tensor:
    """Zero-pad or trim the last (time) axis to `length`."""
    t = mel.shape[-1]
    if t > length:
        return mel[..., :length]
    if t < length:
        return F.pad(mel, (0, length - t))
    return mel
