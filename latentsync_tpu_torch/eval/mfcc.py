"""MFCC features for the classic SyncNet scorer (the port's own copy of
``latentsync_tpu/eval/mfcc.py``, float64 numpy, bit for bit the same).

The reference depends on python_speech_features.mfcc with default
parameters (ref:eval/syncnet/syncnet_eval.py:94): 25 ms rectangular
frames at 10 ms hop, 512-point FFT, 26 HTK-mel filters, 13 cepstra
(DCT-II with lifter 22, first coefficient replaced by log energy).
Re-implemented in numpy so no extra dependency is needed; the 100 Hz
MFCC stream aligns 4 frames per 25 fps video frame
(ref:syncnet_eval.py:128-129).
"""

from __future__ import annotations

import numpy as np


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def _filterbank(nfilt, nfft, sample_rate, lowfreq=0.0, highfreq=None):
    highfreq = highfreq or sample_rate / 2.0
    mel_pts = np.linspace(_hz_to_mel_htk(lowfreq), _hz_to_mel_htk(highfreq), nfilt + 2)
    bins = np.floor((nfft + 1) * _mel_to_hz_htk(mel_pts) / sample_rate).astype(int)
    fbank = np.zeros((nfilt, nfft // 2 + 1))
    for j in range(nfilt):
        for i in range(bins[j], bins[j + 1]):
            fbank[j, i] = (i - bins[j]) / max(bins[j + 1] - bins[j], 1)
        for i in range(bins[j + 1], bins[j + 2]):
            fbank[j, i] = (bins[j + 2] - i) / max(bins[j + 2] - bins[j + 1], 1)
    return fbank


def mfcc(
    signal: np.ndarray,
    samplerate: int = 16000,
    winlen: float = 0.025,
    winstep: float = 0.01,
    numcep: int = 13,
    nfilt: int = 26,
    nfft: int = 512,
    preemph: float = 0.97,
    ceplifter: int = 22,
    append_energy: bool = True,
) -> np.ndarray:
    """(num_frames, numcep) MFCC matching python_speech_features defaults
    (rectangular window, HTK mel, ortho DCT-II, sinusoidal liftering)."""
    signal = np.asarray(signal, np.float64)
    signal = np.append(signal[0], signal[1:] - preemph * signal[:-1])

    frame_len = int(round(winlen * samplerate))
    frame_step = int(round(winstep * samplerate))
    n = len(signal)
    num_frames = 1 + int(np.ceil((n - frame_len) / frame_step)) if n > frame_len else 1
    pad = (num_frames - 1) * frame_step + frame_len - n
    padded = np.concatenate([signal, np.zeros(pad)])
    idx = (
        np.arange(frame_len)[None, :]
        + np.arange(num_frames)[:, None] * frame_step
    )
    frames = padded[idx]

    spec = np.abs(np.fft.rfft(frames, nfft, axis=1))
    pspec = (spec**2) / nfft
    energy = np.maximum(pspec.sum(axis=1), np.finfo(np.float64).eps)

    fbank = _filterbank(nfilt, nfft, samplerate)
    feat = np.maximum(pspec @ fbank.T, np.finfo(np.float64).eps)
    feat = np.log(feat)

    # ortho DCT-II, keep first numcep coefficients
    k = np.arange(nfilt)
    dct = np.cos(np.pi * np.outer(np.arange(nfilt), (2 * k + 1)) / (2 * nfilt))
    dct *= np.sqrt(2.0 / nfilt)
    dct[0] /= np.sqrt(2.0)
    feat = feat @ dct.T[:, :numcep]

    if ceplifter > 0:
        lift = 1 + (ceplifter / 2.0) * np.sin(np.pi * np.arange(numcep) / ceplifter)
        feat *= lift
    if append_energy:
        feat[:, 0] = np.log(energy)
    return feat
