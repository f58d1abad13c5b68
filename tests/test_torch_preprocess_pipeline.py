"""The port's eight-stage data pipeline against the JAX package's, on the CPU.

``tests/test_preprocess_e2e.py``'s clips, plus one with a hard cut (so that
the shot stage cuts), go through both packages' ``DataProcessingPipeline``:
each stage's file list and ``.wav`` sidecars, the arrays each stage hands to
``write_video`` (the written files are lossy, so the arrays are held), the
final list and a resumed run. The scorers of stages 7 and 8 are the same
deterministic stand-ins on both sides (the nets themselves are held against
the JAX package in ``test_torch_eval*.py``), and the face path is the Haar
anchor heuristic (``LATENTSYNC_NO_FALLBACK_FAN``) on both; the affine stage
through a small random FAN behind the Haar box is compared on its own.

Tolerances: exact (file lists, sidecar bytes, the arrays of every stage but
the affine one); the affine stage's faces as the face path's
(``tests/test_torch_onboarding.py``): within one code, on under 0.1 % of
the values.
"""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
from scipy.io import wavfile  # noqa: E402

from latentsync_tpu.models import face_detection as jfd  # noqa: E402
from latentsync_tpu.preprocess import pipeline as jpl  # noqa: E402
from latentsync_tpu.utils import image_processor as jip  # noqa: E402
from latentsync_tpu_torch.models import face_detection as pfd  # noqa: E402
from latentsync_tpu_torch.preprocess import pipeline as ppl  # noqa: E402
from latentsync_tpu_torch.utils import image_processor as pip_  # noqa: E402
from latentsync_tpu_torch.utils import media as pmedia  # noqa: E402

from test_torch_ops import _one_torch_thread  # noqa: E402,F401 (autouse)

STAGES = ["decodable", "resampled", "shot", "segmented", "affine_transformed",
          "filtered_affined", "av_synced", "high_visual_quality"]


def _write_clip(path, frames, seconds, rng):
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, frames.shape[1:3][::-1])
    for img in frames:
        wr.write(img)
    wr.release()
    wavfile.write(path.replace(".mp4", ".wav"), 16000,
                  (rng.standard_normal(int(16000 * seconds)) * 3000).astype(np.int16))


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """``tests/test_preprocess_e2e.py``'s two 6 s clips, and a 12 s one with a
    hard cut at 6 s."""
    src = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(0)
    for ci in range(2):
        frames = []
        for _ in range(150):
            img = rng.uniform(0, 60, (320, 320, 3)).astype(np.uint8)
            cv2.circle(img, (160, 160), 90, (200, 170, 150), -1)
            cv2.circle(img, (130, 140), 10, (30, 30, 30), -1)
            cv2.circle(img, (190, 140), 10, (30, 30, 30), -1)
            frames.append(img)
        _write_clip(str(src / f"clip{ci}.mp4"), np.stack(frames), 6, rng)
    frames = []
    for t in range(300):
        img = np.full((120, 160, 3), (30, 60, 90) if t < 150 else (200, 180, 40), np.uint8)
        cv2.circle(img, (80, 55 + t % 7), 35, (150, 170, 200), -1)
        frames.append(img)
    _write_clip(str(src / "cut.mp4"), np.stack(frames), 12, rng)
    return str(src)


class _StubEvaluator:
    """(offset, min_dist, conf) from the clip's name and frames: the same
    numbers on both sides, ``clip1``'s under the confidence gate."""

    def evaluate(self, path):
        frames = pmedia.read_video(path, change_fps=False)
        conf = 1.0 if "clip1" in os.path.basename(path) else 5.0 + float(frames.mean()) / 1e3
        return 0, 0.0, conf


def _stub_scorer(frame):
    return float(frame.std())


def _capture(monkeypatch, module, root, sink):
    real = module.write_video

    def spy(path, frames, *a, **kw):
        sink[os.path.relpath(path, root)] = np.array(frames)
        return real(path, frames, *a, **kw)

    monkeypatch.setattr(module, "write_video", spy)


def _tree(root):
    """{relative path: bytes of its sidecar, or None} of every stage's videos."""
    out = {}
    for stage in STAGES:
        for path in ppl._gather(os.path.join(root, stage)):
            wav = os.path.splitext(path)[0] + ".wav"
            out[os.path.relpath(path, root)] = (open(wav, "rb").read()
                                                if os.path.exists(wav) else None)
    return out


@pytest.fixture(scope="module")
def runs(clips, tmp_path_factory):
    """Both packages' pipelines on the same clips: (roots, final lists, the
    arrays each handed to write_video, the resumed port run's list)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("LATENTSYNC_FAN_CKPT", "/nonexistent.npz")
    mp.setenv("LATENTSYNC_NO_FALLBACK_FAN", "1")
    # the detector is built (and its fallback warned) once a process: start
    # afresh, whatever ran before in this process
    mp.setattr(pip_, "_detector_cache", {})
    mp.setattr(pip_, "_warned_fallback", False)
    out = tmp_path_factory.mktemp("runs")
    written = {"port": {}, "jax": {}}
    roots = {k: str(out / k) for k in written}
    try:
        _capture(mp, ppl, roots["port"], written["port"])
        _capture(mp, jpl, roots["jax"], written["jax"])
        kw = dict(evaluator=_StubEvaluator(), quality_scorer=_stub_scorer,
                  min_sync_conf=3.0, min_iqa=5.0)
        with pytest.warns(UserWarning, match="Haar"):
            port = ppl.DataProcessingPipeline(roots["port"], device="cpu", **kw)
            files = {"port": port.run(clips)}
        files["jax"] = jpl.DataProcessingPipeline(roots["jax"], **kw).run(clips)
        resumed = port.run(clips)
    finally:
        mp.undo()
    return roots, files, written, resumed


def test_pipeline_stages_match_jax(runs):
    roots, files, _, _ = runs
    port, jax_ = _tree(roots["port"]), _tree(roots["jax"])
    assert sorted(port) == sorted(jax_)
    for name, wav in jax_.items():
        assert wav is not None and port[name] == wav, name
    for stage in STAGES:
        n = sum(k.startswith(stage + os.sep) for k in port)
        assert n > 0, stage
    # the cut clip split in two shots; one clip under the stand-in's gate
    assert sum("cut_shot" in k for k in port if k.startswith("shot" + os.sep)) == 2
    assert len(files["port"]) == 3
    assert [os.path.relpath(f, roots["port"]) for f in files["port"]] == \
        [os.path.relpath(f, roots["jax"]) for f in files["jax"]]


def test_pipeline_write_video_arrays_match_jax(runs):
    _, _, written, _ = runs
    assert sorted(written["port"]) == sorted(written["jax"]) and written["port"]
    for name, want in written["jax"].items():
        got = written["port"][name]
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if name.startswith("affine_transformed"):
            delta = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert delta.max() <= 1 and delta.mean() < 1e-3, name
            assert got.shape[1:] == (256, 256, 3)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_pipeline_resumes_to_the_same_list(runs, tmp_path):
    roots, files, _, resumed = runs
    assert resumed == files["port"]
    ppl.write_fileslist(resumed, str(tmp_path / "list.txt"))
    assert (tmp_path / "list.txt").read_text().splitlines() == resumed


def test_affine_stage_with_a_fan_matches_jax(tmp_path):
    """The affine stage through a small random FAN behind the Haar box on both
    sides, frame by frame: the faces within the face path's tolerance, the
    sidecar carried."""
    from latentsync_tpu.training.synthetic_faces import render_face
    from latentsync_tpu_torch.utils.convert import fan_state_dict_from_flax
    from test_torch_onboarding import _fan_variables

    rng = np.random.default_rng(7)
    src = tmp_path / "in"
    src.mkdir()
    frames = []
    for t in range(6):
        img, _ = render_face(rng, 150)
        frame = np.full((200, 200, 3), 90, np.uint8)
        frame[20 + t:170 + t, 25:175] = img
        frames.append(frame)
    pmedia.write_video(str(src / "a.mp4"), np.stack(frames), fps=25)
    pmedia.write_audio(str(src / "a.wav"), np.zeros(4000, np.float32))
    variables = _fan_variables()
    jproc = jip.ImageProcessor(256, landmark_detector=jfd.FANLandmarkDetector(
        variables, face_detector=jfd.HaarBoxDetector()))
    pproc = pip_.ImageProcessor(256, device="cpu", landmark_detector=pfd.FANLandmarkDetector(
        fan_state_dict_from_flax(variables), face_detector=pfd.HaarBoxDetector(), device="cpu"))
    written = {}
    mp = pytest.MonkeyPatch()
    try:
        _capture(mp, ppl, str(tmp_path / "p"), written.setdefault("port", {}))
        _capture(mp, jpl, str(tmp_path / "j"), written.setdefault("jax", {}))
        got = ppl.affine_transform_stage(str(src), str(tmp_path / "p"), processor=pproc)
        want = jpl.affine_transform_stage(str(src), str(tmp_path / "j"), processor=jproc)
    finally:
        mp.undo()
    assert len(got) == len(want) == 1
    assert open(str(tmp_path / "p" / "a.wav"), "rb").read() == \
        open(str(tmp_path / "j" / "a.wav"), "rb").read()
    # the written files are lossy: the arrays handed to the encoder are held
    fa, fb = written["port"]["a.mp4"], written["jax"]["a.mp4"]
    assert fa.shape == fb.shape == (6, 256, 256, 3)
    delta = np.abs(fa.astype(np.int32) - fb.astype(np.int32))
    assert delta.max() <= 1 and delta.mean() < 1e-3
