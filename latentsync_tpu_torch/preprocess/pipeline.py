"""The data-processing pipeline (ref:preprocess/data_processing_pipeline.py:28-65).

Counterpart of ``latentsync_tpu/preprocess/pipeline.py``. Eight stages,
each writing a fresh sibling directory and skipping outputs it already
made, so that a rerun resumes:

1. remove_broken    — decodability probe (ref:remove_broken_videos.py)
2. resample         — 25 fps / 16 kHz (ref:resample_fps_hz.py)
3. detect_shot      — adaptive content-change shot splitting
                      (ref:detect_shot.py:35; pyscenedetect's
                      AdaptiveDetector semantics, in numpy and OpenCV)
4. segment          — 5–10 s segments (ref:segment_videos.py)
5. affine_transform — every frame aligned to a 256² face crop
                      (ref:preprocess/affine_transform.py), through the
                      port's ``ImageProcessor`` on the card
6. remove_incorrect — the crops' geometry checked
                      (ref:remove_incorrect_affined.py)
7. sync_av          — SyncNet confidence ≥ 3 and |offset| ≤ 6, resynced
                      (ref:sync_av.py:40-63, thresholds README.md:148)
8. filter_quality   — HyperIQA ≥ 40 on 3 sampled frames
                      (ref:filter_visual_quality.py:57)

Without ffmpeg (the card's machine) video is OpenCV mp4v and each clip's
audio a ``.wav`` sidecar beside it, which every stage carries along (and
the shot and segment stages cut). The model stages (5, 7, 8) run on the
device the pipeline is given; a file that fails in one of them is reported
("... failed <path>: ...") and left out, as in the JAX package.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from ..utils.media import have_ffmpeg, read_video, video_info, write_video


def _gather(input_dir: str, exts=(".mp4", ".avi", ".mov")) -> List[str]:
    out = []
    for root, _, files in os.walk(input_dir):
        for f in sorted(files):
            if f.lower().endswith(exts):
                out.append(os.path.join(root, f))
    return out


def _out_path(path: str, input_dir: str, output_dir: str, suffix: str = "") -> str:
    base, ext = os.path.splitext(os.path.relpath(path, input_dir))
    dst = os.path.join(output_dir, base + suffix + ext)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    return dst


def _sidecar(path: str) -> str:
    return os.path.splitext(path)[0] + ".wav"


def _copy_sidecar(src_video: str, dst_video: str) -> None:
    """Carry the ``.wav`` sidecar through a stage."""
    s = _sidecar(src_video)
    if os.path.exists(s) and not os.path.exists(_sidecar(dst_video)):
        shutil.copy(s, _sidecar(dst_video))


def _slice_sidecar(src_video: str, dst_video: str, start_frame: int, n_frames: int,
                   fps: int) -> None:
    """The sidecar's samples of frames [start, start + n) of the video."""
    s = _sidecar(src_video)
    if not os.path.exists(s) or os.path.exists(_sidecar(dst_video)):
        return
    from scipy.io import wavfile

    rate, data = wavfile.read(s)
    a = int(start_frame / fps * rate)
    b = int((start_frame + n_frames) / fps * rate)
    wavfile.write(_sidecar(dst_video), rate, data[a:b])


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


def remove_broken_videos(input_dir: str, output_dir: str) -> List[str]:
    kept = []
    for path in _gather(input_dir):
        dst = _out_path(path, input_dir, output_dir)
        if os.path.exists(dst):
            kept.append(dst)
            continue
        try:
            w, h, fps, n = video_info(path)
            if n <= 0 or w <= 0:
                continue
            shutil.copy(path, dst)
            _copy_sidecar(path, dst)
            kept.append(dst)
        except Exception:  # noqa: BLE001 — an undecodable file is what this stage drops
            continue
    return kept


def resample_fps_hz(input_dir: str, output_dir: str, fps: int = 25,
                    sample_rate: int = 16000) -> List[str]:
    out = []
    for path in _gather(input_dir):
        dst = _out_path(path, input_dir, output_dir)
        if os.path.exists(dst):
            out.append(dst)
            continue
        if have_ffmpeg():
            subprocess.run(["ffmpeg", "-y", "-nostdin", "-v", "error", "-i", path,
                            "-r", str(fps), "-ar", str(sample_rate), dst],
                           check=True, capture_output=True)
        else:
            write_video(dst, read_video(path, change_fps=True, fps=fps), fps=fps)
            _copy_sidecar(path, dst)
        out.append(dst)
    return out


def content_scores(frames: np.ndarray) -> np.ndarray:
    """Per-frame content score: the mean absolute per-channel HSV delta
    between consecutive frames, channels averaged (pyscenedetect
    ContentDetector's score with its default weights: hue, saturation and
    luma 1, edges 0); scores[0] = 0. Frames are first subsampled to about
    256 px wide by plain striding (factor width // 256), as pyscenedetect's
    default downscale does."""
    import cv2

    factor = max(1, frames.shape[2] // 256) if frames.ndim == 4 else 1
    scores = np.zeros(len(frames), np.float64)
    prev = None
    for i, frame in enumerate(frames):
        if factor > 1:
            frame = frame[::factor, ::factor]
        hsv = cv2.cvtColor(frame, cv2.COLOR_RGB2HSV).astype(np.int16)
        if prev is not None:
            scores[i] = np.abs(hsv - prev).mean(axis=(0, 1)).mean()
        prev = hsv
    return scores


def detect_shots(frames: np.ndarray, adaptive_threshold: float = 2.0,
                 min_content_val: float = 15.0, window_width: int = 2,
                 min_scene_len: int = 15) -> List[int]:
    """Shot boundaries with pyscenedetect AdaptiveDetector semantics (the
    reference runs ``scenedetect detect-adaptive --threshold 2``,
    ref:preprocess/detect_shot.py:38). Frame i is a cut where its score over
    the mean of the ±`window_width` frames around it (i excluded) is at
    least `adaptive_threshold`, its own score at least `min_content_val`,
    and at least `min_scene_len` frames have passed since the last cut.
    Frames whose window is incomplete are never cuts; a gradual fade (a
    flat plateau of scores, ratio about 1) is not cut."""
    n = len(frames)
    scores = content_scores(frames)
    cuts: List[int] = []
    last_cut = 0
    for i in range(1, n):
        lo, hi = i - window_width, i + window_width
        if lo < 1 or hi >= n:
            continue
        denom = np.concatenate([scores[lo:i], scores[i + 1:hi + 1]]).mean()
        ratio = scores[i] / denom if denom > 1e-5 else (
            255.0 if scores[i] >= min_content_val else 0.0)
        if (ratio >= adaptive_threshold and scores[i] >= min_content_val
                and i - last_cut >= min_scene_len):
            cuts.append(i)
            last_cut = i
    return cuts


def split_shots(input_dir: str, output_dir: str, fps: int = 25) -> List[str]:
    out = []
    for path in _gather(input_dir):
        base_dst = _out_path(path, input_dir, output_dir, "_shot0")
        if os.path.exists(base_dst):
            stem = os.path.basename(path).rsplit(".", 1)[0] + "_shot"
            out.extend(p for p in _gather(os.path.dirname(base_dst))
                       if os.path.basename(p).startswith(stem))
            continue
        frames = read_video(path, change_fps=False)
        cuts = [0] + detect_shots(frames) + [len(frames)]
        for i in range(len(cuts) - 1):
            seg = frames[cuts[i]:cuts[i + 1]]
            if len(seg) < 15:
                continue
            dst = _out_path(path, input_dir, output_dir, f"_shot{i}")
            write_video(dst, seg, fps=fps)
            _slice_sidecar(path, dst, cuts[i], len(seg), fps)
            out.append(dst)
    return out


def segment_videos(input_dir: str, output_dir: str, min_sec: float = 5.0,
                   max_sec: float = 10.0, fps: int = 25) -> List[str]:
    out = []
    for path in _gather(input_dir):
        frames = read_video(path, change_fps=False)
        seg_len, min_len = int(max_sec * fps), int(min_sec * fps)
        idx = 0
        for start in range(0, len(frames), seg_len):
            seg = frames[start:start + seg_len]
            if len(seg) < min_len:
                break
            dst = _out_path(path, input_dir, output_dir, f"_seg{idx}")
            if not os.path.exists(dst):
                write_video(dst, seg, fps=fps)
                _slice_sidecar(path, dst, start, len(seg), fps)
            out.append(dst)
            idx += 1
    return out


def affine_transform_stage(input_dir: str, output_dir: str, resolution: int = 256,
                           fps: int = 25, processor=None, device=None) -> List[str]:
    """Every frame of each clip aligned to a `resolution`² face crop. One
    ``ImageProcessor`` (its landmark detector on `device`, the card unless
    told otherwise) serves the whole stage, frame by frame, as in the JAX
    package. (``affine_transform_batch`` would crop every frame of a clip at
    one consensus box, which gives other landmarks than the per-frame
    crops.)"""
    from ..utils.image_processor import ImageProcessor

    processor = processor or ImageProcessor(resolution, device=device)
    out = []
    for path in _gather(input_dir):
        dst = _out_path(path, input_dir, output_dir)
        if os.path.exists(dst):
            out.append(dst)
            continue
        try:
            faces = [processor.affine_transform(frame)[0]
                     for frame in read_video(path, change_fps=False)]
            write_video(dst, np.stack(faces), fps=fps)
            _copy_sidecar(path, dst)
            out.append(dst)
        except Exception as e:  # noqa: BLE001 — per-file isolation
            print(f"affine failed {path}: {e}")
    return out


def remove_incorrect_affined(input_dir: str, output_dir: str,
                             resolution: int = 256) -> List[str]:
    out = []
    for path in _gather(input_dir):
        dst = _out_path(path, input_dir, output_dir)
        if os.path.exists(dst):
            out.append(dst)
            continue
        try:
            w, h, _, n = video_info(path)
            if w != resolution or h != resolution or n < 25:
                continue
            shutil.copy(path, dst)
            _copy_sidecar(path, dst)
            out.append(dst)
        except Exception:  # noqa: BLE001 — an unreadable crop is what this stage drops
            continue
    return out


def sync_av_stage(input_dir: str, output_dir: str, evaluator=None, min_conf: float = 3.0,
                  max_offset: int = 6, device=None) -> List[str]:
    """SyncNet confidence filter and ``-itsoffset`` resync (ref:sync_av.py:40-63);
    without ffmpeg a kept clip is copied as it is."""
    if evaluator is None:
        from ..eval.sync_eval import SyncNetEvaluator

        evaluator = SyncNetEvaluator(device=device)
    out = []
    for path in _gather(input_dir):
        dst = _out_path(path, input_dir, output_dir)
        if os.path.exists(dst):
            out.append(dst)
            continue
        try:
            offset, _, conf = evaluator.evaluate(path)
            if conf < min_conf or abs(offset) > max_offset:
                continue
            if offset != 0 and have_ffmpeg():
                subprocess.run(["ffmpeg", "-y", "-nostdin", "-v", "error", "-itsoffset",
                                f"{offset / 25.0:.4f}", "-i", path, "-i", path, "-map", "0:v",
                                "-map", "1:a", "-c:v", "copy", dst],
                               check=True, capture_output=True)
            else:
                shutil.copy(path, dst)
                _copy_sidecar(path, dst)
            out.append(dst)
        except Exception as e:  # noqa: BLE001
            print(f"sync_av failed {path}: {e}")
    return out


def filter_visual_quality(input_dir: str, output_dir: str, scorer=None,
                          min_score: float = 40.0, samples: int = 3) -> List[str]:
    """The HyperIQA threshold on `samples` evenly spaced frames
    (ref:filter_visual_quality.py:57); without a scorer every clip passes."""
    out = []
    for path in _gather(input_dir):
        dst = _out_path(path, input_dir, output_dir)
        if os.path.exists(dst):
            out.append(dst)
            continue
        try:
            if scorer is not None:
                frames = read_video(path, change_fps=False)
                idx = np.linspace(0, len(frames) - 1, samples).astype(int)
                if float(np.mean([scorer(frames[i]) for i in idx])) < min_score:
                    continue
            shutil.copy(path, dst)
            _copy_sidecar(path, dst)
            out.append(dst)
        except Exception as e:  # noqa: BLE001
            print(f"quality filter failed {path}: {e}")
    return out


@dataclass
class DataProcessingPipeline:
    """The eight stages chained, resumable (ref:data_processing_pipeline.py:28-65);
    the model stages on `device` (the card unless told otherwise)."""

    output_root: str
    resolution: int = 256
    evaluator: object = None
    quality_scorer: Optional[Callable] = None
    # the reference's thresholds (README.md:148-149); tunable for reduced runs
    min_sync_conf: float = 3.0
    max_av_offset: int = 6
    min_iqa: float = 40.0
    device: object = None

    def run(self, input_dir: str) -> List[str]:
        stages = [
            ("decodable", remove_broken_videos),
            ("resampled", resample_fps_hz),
            ("shot", split_shots),
            ("segmented", segment_videos),
            ("affine_transformed", lambda i, o: affine_transform_stage(
                i, o, self.resolution, device=self.device)),
            ("filtered_affined", lambda i, o: remove_incorrect_affined(i, o, self.resolution)),
            ("av_synced", lambda i, o: sync_av_stage(
                i, o, self.evaluator, self.min_sync_conf, self.max_av_offset, self.device)),
            ("high_visual_quality", lambda i, o: filter_visual_quality(
                i, o, self.quality_scorer, self.min_iqa)),
        ]
        cur, files = input_dir, []
        for name, fn in stages:
            out_dir = os.path.join(self.output_root, name)
            os.makedirs(out_dir, exist_ok=True)
            files = fn(cur, out_dir)
            print(f"stage {name}: {len(files)} files", flush=True)
            cur = out_dir
        return files


def write_fileslist(files: List[str], path: str) -> None:
    """ref:tools/write_fileslist.py."""
    with open(path, "w") as f:
        for p in files:
            f.write(p + "\n")
