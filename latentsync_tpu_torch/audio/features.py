"""Audio → per-video-frame whisper embedding chunks.

Counterpart of ``latentsync_tpu/audio/features.py`` ``Audio2Feature``:
30 s mel segments of 3000 frames (zero-padded) go through the encoder in
one batch, each keeps its first (end - start) / 2 encoder frames; frame i
of the video takes the 10 clamped 50 Hz positions around int(i·50/fps),
each carrying the (n_layer + 1) stacked layer embeddings.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import WhisperConfig
from ..models.whisper import WhisperEncoder
from ..ops.mel import WHISPER_N_FRAMES, pad_or_trim, whisper_log_mel


class Audio2Feature:
    """`model` is a WhisperEncoder already on its device and dtype."""

    def __init__(self, model: WhisperEncoder, num_frames: int = 16,
                 audio_feat_length=(2, 2)):
        self.model = model
        self.config: WhisperConfig = model.config
        self.num_frames = num_frames
        self.embedding_dim = self.config.n_audio_state
        self.audio_feat_length = tuple(audio_feat_length)

    @property
    def device(self) -> torch.device:
        return self.model.conv1.weight.device

    @torch.inference_mode()
    def _audio2feat_array(self, audio: np.ndarray) -> np.ndarray:
        """Waveform (16 kHz float) → (T50, n_layer + 1, n_state) float32."""
        mel = whisper_log_mel(torch.as_tensor(np.asarray(audio, np.float32),
                                              device=self.device))
        num_frames = mel.shape[-1]
        segments, keep = [], []
        for seek in range(0, num_frames, WHISPER_N_FRAMES):
            end = min(seek + WHISPER_N_FRAMES, num_frames)
            segments.append(pad_or_trim(mel[:, seek:end], WHISPER_N_FRAMES))
            keep.append((end - seek) // 2)
        _, embeds = self.model(torch.stack(segments))
        embeds = embeds.float().cpu().numpy().transpose(0, 2, 1, 3)  # (S, 1500, L+1, D)
        return np.concatenate([e[:k] for e, k in zip(embeds, keep)], axis=0)

    def audio2feat(self, audio_or_path) -> np.ndarray:
        if isinstance(audio_or_path, (str, os.PathLike)):
            from ..utils.media import read_audio

            return self._audio2feat_array(read_audio(os.fspath(audio_or_path)))
        return self._audio2feat_array(np.asarray(audio_or_path))

    def slice_indices(self, vid_idx: int, length: int, fps: float = 25) -> np.ndarray:
        left_ctx, right_ctx = self.audio_feat_length
        center = int(vid_idx * 50 / fps)
        idx = np.arange(center - left_ctx * 2, center + (right_ctx + 1) * 2)
        return np.clip(idx, 0, length - 1)

    def num_chunks(self, feature_len: int, fps: float) -> int:
        """The upstream loop count: frames i = 0.. until int(i·50/fps)
        exceeds the feature length (that final i included)."""
        i = 0
        while True:
            i += 1
            if int(i * 50 / fps) > feature_len:
                return i

    def feature2chunks(self, feature_array: np.ndarray, fps: float) -> np.ndarray:
        """(T50, L+1, D) → (num_video_frames, 10·(L+1), D)."""
        n = self.num_chunks(len(feature_array), fps)
        idx = np.stack([self.slice_indices(i, len(feature_array), fps) for i in range(n)])
        return feature_array[idx].reshape(n, -1, self.embedding_dim)
