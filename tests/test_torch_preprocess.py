"""The port's data preparation against the JAX package, on the CPU: the host
code around the stages.

Shot detection on ``tests/test_shot_detection.py``'s synthetic cases and
on random frames; IoU tracking on random tracks with gaps; the SyncNet
face tracks and their crops; ``video_info``. The pipeline itself is
``tests/test_torch_preprocess_pipeline.py``.

Tolerances: exact (host code on both sides: shots, tracks, crops, probes).
"""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from latentsync_tpu.eval import syncnet_detect as jsd  # noqa: E402
from latentsync_tpu.models import face_detection as jfd  # noqa: E402
from latentsync_tpu.preprocess import pipeline as jpl  # noqa: E402
from latentsync_tpu.utils import media as jmedia  # noqa: E402
from latentsync_tpu_torch.eval import syncnet_detect as psd  # noqa: E402
from latentsync_tpu_torch.models import face_detection as pfd  # noqa: E402
from latentsync_tpu_torch.preprocess import pipeline as ppl  # noqa: E402
from latentsync_tpu_torch.utils import media as pmedia  # noqa: E402
from test_shot_detection import _solid  # noqa: E402

from test_torch_ops import _one_torch_thread  # noqa: E402,F401 (autouse)

# ---------------------------------------------------------------------------
# shots
# ---------------------------------------------------------------------------


def _fade():
    a, b = np.array((220.0,) * 3), np.array((20.0,) * 3)
    return np.stack([np.full((48, 48, 3), a + (b - a) * t, np.float32)
                     for t in np.linspace(0, 1, 60)]).astype(np.uint8)


SHOT_CASES = {
    "hard_cuts": (np.concatenate([_solid(40, (200, 40, 40)), _solid(40, (40, 200, 40)),
                                  _solid(40, (40, 40, 220))]), {}),
    "fade": (_fade(), {}),
    "static_noise": (_solid(80, (128, 128, 128), noise=6.0, seed=1), {}),
    "rapid_cuts": (np.concatenate([_solid(30, (200, 40, 40)), _solid(8, (40, 200, 40)),
                                   _solid(30, (40, 40, 220))]), {}),
    "rapid_cuts_short_scene": (np.concatenate([_solid(30, (200, 40, 40)),
                                               _solid(8, (40, 200, 40)),
                                               _solid(30, (40, 40, 220))]),
                               {"min_scene_len": 5}),
    "window_edge": (np.concatenate([_solid(1, (200, 40, 40)), _solid(20, (40, 200, 40))]), {}),
    "wide_random": (np.random.default_rng(3).integers(0, 256, (24, 40, 600, 3), np.uint8), {}),
}


@pytest.mark.parametrize("case", sorted(SHOT_CASES))
def test_shot_detection_matches_jax(case):
    frames, kw = SHOT_CASES[case]
    np.testing.assert_array_equal(ppl.content_scores(frames), jpl.content_scores(frames))
    assert ppl.detect_shots(frames, **kw) == jpl.detect_shots(frames, **kw)


def test_hard_cuts_are_found():
    assert ppl.detect_shots(SHOT_CASES["hard_cuts"][0]) == [40, 80]


# ---------------------------------------------------------------------------
# tracks
# ---------------------------------------------------------------------------


def _random_detections(seed: int, n: int = 90, two: bool = False, miss: float = 0.25):
    """Per-frame boxes of a drifting face, missing on random frames (with a
    long gap for odd seeds) and jumping at frame 70, which starts a new
    track; with `two`, a second face listed first in every frame that has
    the first (the order in which the JAX package's tracking never raises)."""
    rng = np.random.default_rng(seed)
    dets = []
    for f in range(n):
        rows = []
        if rng.random() >= miss and not (30 <= f < 60 and seed % 2):
            x = 60.0 + 0.3 * f + rng.normal(0, 1.5) + (90 if f >= 70 else 0)
            rows.append([x, 40 + rng.normal(0, 1.5), x + 110, 160 + rng.normal(0, 1.5), 0.99])
        if two and rows:
            rows.insert(0, [300 + rng.normal(0, 1), 50, 420, 170, 0.9])
        dets.append(np.array(rows, np.float32).reshape(-1, 5))
    return dets


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", [{}, {"min_track": 5, "num_failed_det": 10},
                                {"min_face_size": 115.0}])
@pytest.mark.parametrize("two", [False, True])
def test_iou_tracking_matches_jax(seed, kw, two):
    dets = _random_detections(seed, two=two)
    got = pfd.iou_tracking([d.copy() for d in dets], **kw)
    want = jfd.iou_tracking([d.copy() for d in dets], **kw)
    assert len(got) == len(want)
    assert len(want) >= (0 if "min_face_size" in kw else 2)
    for g, w in zip(got, want):
        assert g["frames"] == w["frames"]
        np.testing.assert_array_equal(np.stack(g["boxes"]), np.stack(w["boxes"]))
    a, b = [10, 10, 50, 60], [20, 15, 70, 50]
    assert pfd.bounding_box_iou(a, b) == jfd.bounding_box_iou(a, b)


def test_iou_tracking_where_the_jax_package_raises():
    """A frame whose second face continues the track while the first does
    not: the JAX package's ``list.remove`` compares the two arrays by value
    and raises; the port joins by identity and tracks both faces."""
    a = [10.0, 10, 110, 110, 1]
    b = [300.0, 10, 400, 110, 1]
    dets = [np.array([b], np.float32)] + [np.array([a, b], np.float32)] * 20
    with pytest.raises(ValueError):
        jfd.iou_tracking([d.copy() for d in dets], min_track=5)
    tracks = pfd.iou_tracking([d.copy() for d in dets], min_track=5)
    assert [t["frames"] for t in tracks] == [list(range(21)), list(range(1, 21))]


class _TableDetector:
    """The same per-frame boxes on both sides (a stand-in for a face detector)."""

    def __init__(self, dets):
        self.dets, self.i = dets, 0

    def detect(self, img):
        d = self.dets[self.i % len(self.dets)]
        self.i += 1
        return d[:1]


def _track_clip(n: int = 90):
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:240, 0:320]
    frames = [np.stack([(120 + 80 * np.sin(xx / 11 + t / 4 + c)).astype(np.uint8)
                        for c in range(3)], -1) for t in range(n)]
    frames = np.stack(frames)
    frames[45:] = 255 - frames[45:]  # a hard cut at 45
    return frames + rng.integers(0, 3, frames.shape, np.uint8)


@pytest.mark.parametrize("min_track,miss", [(10, 0.25), (200, 0.0)])
def test_syncnet_detector_tracks_and_crops_match_jax(min_track, miss):
    """Shots of 45 frames: tracked at min_track 10; at 200 the whole clip is
    shorter than min_track, so its shots are tracked all the same."""
    frames = _track_clip()
    dets = _random_detections(4, miss=miss)
    p = psd.SyncNetDetector(face_detector=_TableDetector(dets), min_track=min_track)
    j = jsd.SyncNetDetector(face_detector=_TableDetector(dets), min_track=min_track)
    pt, jt = p.extract_tracks(frames), j.extract_tracks(frames)
    assert len(pt) == len(jt) > 0
    for a, b in zip(pt, jt):
        assert a.frames == b.frames
        np.testing.assert_array_equal(a.boxes, b.boxes)
        np.testing.assert_array_equal(p.crop_track(frames, a), j.crop_track(frames, b))
        assert p.crop_track(frames, a).shape == (len(a.frames), 224, 224, 3)


def test_syncnet_detector_default_box_and_call(tmp_path, monkeypatch):
    """The Haar-anchor box adapter gives the JAX one's rows, and ``__call__``
    on a written clip writes the same crop arrays."""
    frames = _track_clip(60)
    assert np.array_equal(psd.HaarBoxAdapter().detect(frames[0]),
                          jsd.SyncNetDetector().detector.detect(frames[0]))
    path = str(tmp_path / "v.mp4")
    pmedia.write_video(path, frames, fps=25)
    got = psd.SyncNetDetector(min_track=20)(path, out_dir=str(tmp_path / "tracks"))
    want = jsd.SyncNetDetector(min_track=20)(path)
    assert len(got) == len(want) > 0
    for (pc, ptr), (jc, jtr) in zip(got, want):
        np.testing.assert_array_equal(pc, jc)
        assert ptr.frames == jtr.frames
    assert sorted(os.listdir(tmp_path / "tracks")) == [f"track_{i:04d}.mp4"
                                                       for i in range(len(got))]


def test_video_info_matches_jax(tmp_path):
    frames = np.random.default_rng(0).integers(0, 255, (17, 48, 64, 3), np.uint8)
    path = pmedia.write_video(str(tmp_path / "c.mp4"), frames, fps=25)
    assert pmedia.video_info(path) == jmedia.video_info(path) == (64, 48, 25.0, 17)
    # an NTSC rate, which the fps goes through as a fraction
    path = pmedia.write_video(str(tmp_path / "ntsc.mp4"), frames[:9], fps=30000 / 1001)
    assert pmedia.video_info(path) == jmedia.video_info(path)
    assert abs(pmedia.video_info(path)[2] - 29.97) < 1e-3
