"""Whisper's audio front end and encoder, and LatentSync's per-frame audio
chunks, plain.

- Log-mel (openai/whisper ``audio.py``): a centred, reflect-padded STFT
  with a periodic Hann window, n_fft 400, hop 160, the last frame dropped,
  the slaney mel-80 filterbank, log10 floored at 1e-10 and at 8 decades
  below the maximum, (x + 4) / 4; segments of 3000 frames (30 s),
  zero-padded.
- Encoder (``model.py`` ``AudioEncoder``): two GELU conv1d stems (the
  second stride 2), sinusoidal positions, pre-LayerNorm residual blocks;
  LatentSync keeps the stack of every block's input and output.
- Chunks (LatentSync ``audio2feature.py``): each segment keeps its first
  (frames of the segment) / 2 positions; video frame i takes the 10
  clamped 50 Hz positions around int(i·50/fps), each with every layer's
  embedding; the clip is padded with zero chunks to a multiple of 16.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .numerics import Numerics
from .unet import ln

N_FFT, HOP, N_MELS, N_FRAMES = 400, 160, 80, 3000


def _hz_to_mel(f):
    f = np.asanyarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    mels = f / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = f >= min_log_hz
    mels = np.where(log_t, min_log_hz / f_sp + np.log(np.maximum(f, 1e-9) / min_log_hz)
                    / logstep, mels)
    return mels


def _mel_to_hz(m):
    m = np.asanyarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


def mel_filters(sr: int = 16000, n_fft: int = N_FFT, n_mels: int = N_MELS) -> np.ndarray:
    """librosa.filters.mel(sr, n_fft, n_mels) (slaney scale and norm)."""
    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - fft_freqs[None, :]
    w = np.zeros((n_mels, n_bins))
    for i in range(n_mels):
        w[i] = np.maximum(0.0, np.minimum(-ramps[i] / fdiff[i], ramps[i + 2] / fdiff[i + 1]))
    w *= (2.0 / (hz[2:n_mels + 2] - hz[:n_mels]))[:, None]
    return w.astype(np.float32)


def log_mel(audio: torch.Tensor) -> torch.Tensor:
    """(T,) float32 at 16 kHz → (80, T // 160)."""
    audio = audio.float()
    pad = N_FFT // 2
    padded = F.pad(audio[None, None], (pad, pad), mode="reflect")[0, 0]
    n = 1 + audio.shape[0] // HOP
    idx = torch.arange(n, device=audio.device)[:, None] * HOP \
        + torch.arange(N_FFT, device=audio.device)[None, :]
    win = 0.5 * (1.0 - torch.cos(2.0 * math.pi * torch.arange(N_FFT, device=audio.device)
                                 / N_FFT))
    power = torch.fft.rfft(padded[idx] * win, dim=-1).abs().T ** 2
    power = power[:, :-1]
    filt = torch.from_numpy(mel_filters()).to(audio.device)
    spec = torch.log10(torch.clamp(filt @ power, min=1e-10))
    spec = torch.maximum(spec, spec.max() - 8.0)
    return (spec + 4.0) / 4.0


def positions(length: int, channels: int) -> torch.Tensor:
    inc = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate([np.sin(scaled), np.cos(scaled)], 1)
                            .astype(np.float32))


class MHA(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d, bias=False)
        self.value = nn.Linear(d, d)
        self.out = nn.Linear(d, d)


class Block(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.attn = MHA(d)
        self.attn_ln = nn.LayerNorm(d, eps=1e-6)
        self.mlp = nn.Sequential(nn.Linear(d, 4 * d), nn.GELU(), nn.Linear(4 * d, d))
        self.mlp_ln = nn.LayerNorm(d, eps=1e-6)


class WhisperEncoder(nn.Module):
    def __init__(self, cfg: dict, num: Numerics = None):
        super().__init__()
        self.cfg = cfg
        self.num = num or Numerics("f32")
        d = cfg["n_audio_state"]
        self.conv1 = nn.Conv1d(cfg["n_mels"], d, 3, padding=1)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1)
        self.blocks = nn.ModuleList([Block(d) for _ in range(cfg["n_audio_layer"])])
        self.ln_post = nn.LayerNorm(d, eps=1e-6)

    def embeddings(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, 80, 3000) → (B, L + 1, 1500, D)."""
        num, heads = self.num, self.cfg["n_audio_head"]
        x = F.gelu(num.conv1d(mel, self.conv1.weight, self.conv1.bias, 1, 1))
        x = F.gelu(num.conv1d(x, self.conv2.weight, self.conv2.bias, 2, 1)).transpose(1, 2)
        x = x + positions(x.shape[1], x.shape[2]).to(x.device)
        out = [x]

        def lin(t, m):
            return num.linear(t, m.weight, m.bias, f32_config=True)

        for blk in self.blocks:
            h = ln(x, blk.attn_ln)
            a = blk.attn
            q, k, v = lin(h, a.query), num.linear(h, a.key.weight, None, True), lin(h, a.value)
            qh = q.reshape(q.shape[0], q.shape[1], heads, -1).transpose(1, 2)
            kh = k.reshape(k.shape[0], k.shape[1], heads, -1).transpose(1, 2)
            vh = v.reshape(v.shape[0], v.shape[1], heads, -1).transpose(1, 2)
            p = torch.softmax(num.matmul(qh, kh.transpose(-1, -2), True)
                              / math.sqrt(qh.shape[-1]), -1)
            o = num.matmul(p, vh, True).transpose(1, 2).reshape(q.shape)
            x = x + lin(o, a.out)
            h = ln(x, blk.mlp_ln)
            x = x + lin(F.gelu(lin(h, blk.mlp[0])), blk.mlp[2])
            out.append(x)
        return torch.stack(out, dim=1)


def audio_chunks(encoder: WhisperEncoder, samples: np.ndarray, fps: float = 25.0,
                 multiple: int = 16, ctx=(2, 2)) -> np.ndarray:
    """16 kHz samples → (frames padded to `multiple`, 10·(L+1), D) float32."""
    dev = encoder.conv1.weight.device
    mel = log_mel(torch.as_tensor(np.asarray(samples, np.float32), device=dev))
    n = mel.shape[-1]
    segs, keep = [], []
    for seek in range(0, n, N_FRAMES):
        end = min(seek + N_FRAMES, n)
        seg = mel[:, seek:end]
        segs.append(F.pad(seg, (0, N_FRAMES - seg.shape[-1])))
        keep.append((end - seek) // 2)
    with torch.no_grad():
        emb = encoder.embeddings(torch.stack(segs)).float().cpu().numpy().transpose(0, 2, 1, 3)
    feats = np.concatenate([e[:k] for e, k in zip(emb, keep)], axis=0)  # (T50, L+1, D)
    length = len(feats)
    count = 0
    while True:
        count += 1
        if int(count * 50 / fps) > length:
            break
    idx = []
    for i in range(count):
        c = int(i * 50 / fps)
        idx.append(np.clip(np.arange(c - ctx[0] * 2, c + (ctx[1] + 1) * 2), 0, length - 1))
    chunks = feats[np.stack(idx)].reshape(count, -1, feats.shape[-1])
    add = (multiple - count % multiple) % multiple
    if add:
        chunks = np.concatenate([chunks, np.zeros((add,) + chunks.shape[1:], chunks.dtype)])
    return chunks.astype(np.float32)
