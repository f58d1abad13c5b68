"""Frozen-SyncNet scoring: AV offset and sync confidence.

Counterpart of ``latentsync_tpu/eval/sync_eval.py``: the Chung & Zisserman
scorer the reference uses as its acceptance metric
(ref:eval/syncnet/syncnet.py:18-113 model, syncnet_eval.py:20-157
scoring). A 3D-conv lip tower on 5-frame windows of 224² crops and a
2D-conv tower on 20-step MFCC windows give one 1024-d feature each; the L2
distance of every lip feature to the audio features ±15 frames away gives
the offset (the argmin of the mean distances) and the confidence (their
median minus their minimum).

The net keeps upstream's ``nn.Sequential`` indices (``netcnnaud.0``,
``netfclip.3``, ...), so ``syncnet_v2.model`` loads as it is, its
``__S__.`` prefix stripped. NCHW / NCDHW; f32 with TF32 off on the card,
as the JAX evaluator runs in f32. Windows are gathered on the device from
the clip's frames, 64 at a time; on the card the last batch is padded by
repetition to the full 64 (one shape for cuDNN, as the JAX evaluator pads
for one jit shape), on the CPU it runs as it is (rows are independent in
inference mode, so the features are the same).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .mfcc import mfcc


def _conv_bn_relu(conv: nn.Module, bn: nn.Module):
    return [conv, bn, nn.ReLU(inplace=True)]


class SyncNetS(nn.Module):
    """The classic SyncNet scorer (ref:eval/syncnet/syncnet.py:18).

    ``forward_aud``: MFCC windows (B, 1, 13, 20) → (B, 1024);
    ``forward_lip``: frame windows (B, 3, 5, 224, 224) → (B, 1024). Batch
    norms in inference mode at eps 1e-5."""

    def __init__(self, embedding_dim: int = 1024):
        super().__init__()
        c2, c3 = nn.Conv2d, nn.Conv3d
        self.netcnnaud = nn.Sequential(
            *_conv_bn_relu(c2(1, 64, 3, 1, 1), nn.BatchNorm2d(64)),
            nn.MaxPool2d((1, 1), (1, 1)),
            *_conv_bn_relu(c2(64, 192, 3, 1, 1), nn.BatchNorm2d(192)),
            nn.MaxPool2d((3, 3), (1, 2)),
            *_conv_bn_relu(c2(192, 384, 3, 1, 1), nn.BatchNorm2d(384)),
            *_conv_bn_relu(c2(384, 256, 3, 1, 1), nn.BatchNorm2d(256)),
            *_conv_bn_relu(c2(256, 256, 3, 1, 1), nn.BatchNorm2d(256)),
            nn.MaxPool2d((3, 3), (2, 2)),
            *_conv_bn_relu(c2(256, 512, (5, 4), 1, 0), nn.BatchNorm2d(512)),
        )
        self.netfcaud = nn.Sequential(nn.Linear(512, 512), nn.BatchNorm1d(512), nn.ReLU(),
                                      nn.Linear(512, embedding_dim))
        self.netfclip = nn.Sequential(nn.Linear(512, 512), nn.BatchNorm1d(512), nn.ReLU(),
                                      nn.Linear(512, embedding_dim))
        self.netcnnlip = nn.Sequential(
            *_conv_bn_relu(c3(3, 96, (5, 7, 7), (1, 2, 2), 0), nn.BatchNorm3d(96)),
            nn.MaxPool3d((1, 3, 3), (1, 2, 2)),
            *_conv_bn_relu(c3(96, 256, (1, 5, 5), (1, 2, 2), (0, 1, 1)), nn.BatchNorm3d(256)),
            nn.MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1)),
            *_conv_bn_relu(c3(256, 256, (1, 3, 3), 1, (0, 1, 1)), nn.BatchNorm3d(256)),
            *_conv_bn_relu(c3(256, 256, (1, 3, 3), 1, (0, 1, 1)), nn.BatchNorm3d(256)),
            *_conv_bn_relu(c3(256, 256, (1, 3, 3), 1, (0, 1, 1)), nn.BatchNorm3d(256)),
            nn.MaxPool3d((1, 3, 3), (1, 2, 2)),
            *_conv_bn_relu(c3(256, 512, (1, 6, 6), 1, 0), nn.BatchNorm3d(512)),
        )

    def forward_aud(self, x: torch.Tensor) -> torch.Tensor:
        h = self.netcnnaud(x)
        return self.netfcaud(h.reshape(h.shape[0], -1))

    def forward_lip(self, x: torch.Tensor) -> torch.Tensor:
        h = self.netcnnlip(x)
        return self.netfclip(h.reshape(h.shape[0], -1))

    def forward(self, lip: torch.Tensor, aud: torch.Tensor):
        return self.forward_lip(lip), self.forward_aud(aud)


def load_syncnet_s_file(path: str) -> Dict[str, torch.Tensor]:
    """``syncnet_v2.model`` (or any ``torch.save`` of the scorer's state dict)
    as the port's state dict: a ``state_dict`` wrapper unwrapped, the
    ``__S__.`` / ``module.`` prefixes stripped, the step counters dropped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    out = {}
    for k, v in sd.items():
        for prefix in ("__S__.", "module."):
            k = k.removeprefix(prefix)
        if not k.endswith("num_batches_tracked"):
            out[k] = v
    return out


def pairwise_shift_distances(feat_lip: torch.Tensor, feat_aud: torch.Tensor,
                             vshift: int = 15) -> torch.Tensor:
    """(T, 2·vshift+1) L2 distances between lip feature i and audio feature
    i+k−vshift (ref:syncnet_eval.py:20-33); shifts past either end meet
    zero padding, as in the reference."""
    t = feat_lip.shape[0]
    win = 2 * vshift + 1
    padded = torch.nn.functional.pad(feat_aud, (0, 0, vshift, vshift))
    idx = torch.arange(t, device=feat_lip.device)[:, None] \
        + torch.arange(win, device=feat_lip.device)[None, :]
    diff = feat_lip[:, None, :] - padded[idx]
    return torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-12))


def offset_and_confidence(dists: torch.Tensor, vshift: int = 15) -> Tuple[int, float, float]:
    """(av_offset, min_dist, confidence) from the distance matrix
    (ref:syncnet_eval.py:142-153): the first index of the least mean
    distance, and the median of the (odd count of) mean distances."""
    mean_dists = dists.mean(0)
    minidx = int(torch.argmin(mean_dists))
    min_dist = mean_dists[minidx]
    conf = torch.median(mean_dists) - min_dist
    return vshift - minidx, float(min_dist), float(conf)


class SyncNetEvaluator:
    """Video + audio → (av_offset, min_dist, confidence). `state_dict`: the
    scorer's weights in upstream layout (``load_syncnet_s_file``), else
    seeded random ones (``init_random_bn_``). Runs on the card unless
    `device` says otherwise."""

    def __init__(self, state_dict: Optional[Dict[str, torch.Tensor]] = None, device=None,
                 batch_size: int = 64):
        from ..models.face_detection import _load, _module_device
        from ..utils.convert import init_random_bn_

        self.device = _module_device(device)
        self.model = SyncNetS()
        if state_dict is None:
            init_random_bn_(self.model, seed=0)
        else:
            _load(self.model, state_dict)
        self.model.to(self.device).eval()
        self.batch_size = batch_size

    @torch.inference_mode()
    def features(self, frames: np.ndarray, audio: np.ndarray):
        """frames: (F, 224, 224, 3) uint8 or float; audio: 16 kHz mono →
        (lip features, audio features), each (windows, 1024) f32 on the
        device."""
        from ..models.face_detection import no_tf32

        cc = mfcc(audio, 16000).T  # (13, T100)
        last = min(len(frames), cc.shape[1] // 4) - 5
        if last <= 0:
            raise ValueError("clip too short for SyncNet scoring")
        dev = self.device
        # (F, 3, H, W) f32 on the device; each window a gather of 5 frames
        video = torch.from_numpy(np.ascontiguousarray(frames[: last + 4])).to(dev)
        video = video.permute(0, 3, 1, 2).float()
        aud_idx = (np.arange(last) * 4)[:, None] + np.arange(20)[None, :]
        aud = torch.from_numpy(
            np.ascontiguousarray(cc[:, aud_idx].transpose(1, 0, 2), np.float32)).to(dev)
        offsets = torch.arange(5, device=dev)
        bs = self.batch_size
        lips, auds = [], []
        with no_tf32(dev):
            for i in range(0, last, bs):
                n = min(bs, last - i)
                starts = torch.arange(i, i + n, device=dev)
                aw = aud[i:i + n]
                if dev.type == "cuda" and n < bs:
                    starts = torch.cat([starts, starts[-1:].expand(bs - n)])
                    aw = torch.cat([aw, aw[-1:].expand(bs - n, -1, -1)])
                lw = video[starts[:, None] + offsets].permute(0, 2, 1, 3, 4)
                lips.append(self.model.forward_lip(lw)[:n])
                auds.append(self.model.forward_aud(aw[:, None])[:n])
        return torch.cat(lips), torch.cat(auds)

    def evaluate_arrays(self, frames: np.ndarray, audio: np.ndarray, vshift: int = 15):
        lip, aud = self.features(frames, audio)
        return offset_and_confidence(pairwise_shift_distances(lip, aud, vshift), vshift)

    def evaluate(self, video_path: str, vshift: int = 15):
        """ref:syncnet_eval.py:46-157 on a (cropped or raw) video file, its
        frames resized to 224² as the reference does."""
        import cv2

        from ..utils.media import read_audio, read_video

        frames = read_video(video_path, change_fps=False)
        frames = np.stack([cv2.resize(fr, (224, 224)) for fr in frames])
        return self.evaluate_arrays(frames, read_audio(audio_source(video_path), 16000), vshift)


def audio_source(video_path: str) -> str:
    """The audio to score: the video's container where ffmpeg can read it,
    else the ``.wav`` sidecar the OpenCV writer leaves beside the video."""
    from ..utils.media import have_ffmpeg

    if have_ffmpeg():
        return video_path
    sidecar = video_path.rsplit(".", 1)[0] + ".wav"
    return sidecar if os.path.isfile(sidecar) else video_path


def syncnet_eval(evaluator: SyncNetEvaluator, video_path: str,
                 temp_dir: str = "temp") -> Tuple[int, float, float]:
    """ref:eval/eval_sync_conf.py:25's helper."""
    return evaluator.evaluate(video_path)


def evaluator_from_file(path: str, device=None):
    """(``SyncNetEvaluator``, "pretrained") with the scorer file at `path`,
    or (one with seeded random weights, "random") where there is none."""
    if path and os.path.isfile(path):
        return SyncNetEvaluator(load_syncnet_s_file(path), device=device), "pretrained"
    return SyncNetEvaluator(device=device), "random"
