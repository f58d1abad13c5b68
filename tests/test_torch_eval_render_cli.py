"""The port's render-and-score CLIs with ``--device cpu``, on the tiny UNet
of ``tests/test_torch_cli.py`` with seeded random weights.

``inference_videos --score`` on one pair; ``validate_fidelity`` at the
production point against the exact trajectory (one pipeline, the switches
set per render: random weights give ``"weights": "random"`` and the gate
INCONCLUSIVE, finite confidences and a pixel delta; the switches are
cleared afterwards) and ``--ladder`` (cut to two rungs here) on a
``step_*.pt`` of the port's trainer (``"trained-tiny"``). The trainer's
scored validation is ``tests/test_torch_train_validation.py``. The face
path is the Haar anchor heuristic (``LATENTSYNC_NO_FALLBACK_FAN``).
"""

import json
import math
import os

import numpy as np
import pytest

from latentsync_tpu_torch.scripts import inference_videos, validate_fidelity
from latentsync_tpu_torch.utils.media import read_video, write_audio, write_video

from test_torch_cli import TINY_YAML
from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)

SWITCHES = ("LATENTSYNC_INT8", "LATENTSYNC_DEEPCACHE", "LATENTSYNC_CFG_INTERVAL")


def _lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.fixture
def haar(monkeypatch, tmp_path):
    monkeypatch.setenv("LATENTSYNC_FAN_CKPT", str(tmp_path / "absent.npz"))
    monkeypatch.setenv("LATENTSYNC_NO_FALLBACK_FAN", "1")
    for k in SWITCHES:  # set (not deleted) so that what a run sets is undone after
        monkeypatch.setenv(k, "")


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 96² talking clip of 20 frames, 1.2 s of speech-like audio and a
    tiny UNet YAML."""
    root = tmp_path_factory.mktemp("render")
    (root / "tiny.yaml").write_text(TINY_YAML)
    yy, xx = np.mgrid[0:96, 0:96]
    frames = np.stack([np.stack([(128 + 100 * np.sin(xx / 9 + t / 3 + c)).astype(np.uint8)
                                 for c in range(3)], -1) for t in range(20)])
    write_video(str(root / "v.mp4"), frames, fps=25)
    rng = np.random.default_rng(0)
    write_audio(str(root / "a.wav"), (0.3 * rng.standard_normal(int(16000 * 1.2)))
                .astype(np.float32))
    return root


def _model_args(root):
    return ["--unet-config", str(root / "tiny.yaml"), "--unet-ckpt", str(root / "absent.pt"),
            "--vae-ckpt", str(root / "absent.pt"), "--whisper-ckpt", str(root / "absent.pt"),
            "--device", "cpu"]


def test_inference_videos_scores_each_render(clip, tmp_path, capsys, haar):
    pairs = tmp_path / "pairs.tsv"
    pairs.write_text(f"{clip / 'v.mp4'}\t{clip / 'a.wav'}\n")
    assert inference_videos.main(["--pairs", str(pairs), "--out-dir", str(tmp_path / "out"),
                                  "--score", *_model_args(clip)]) == 0
    (row,) = _lines(capsys.readouterr().out)
    assert row["frames"] == 32 and row["out"] == str(tmp_path / "out" / "v.mp4")
    assert read_video(row["out"], change_fps=False).shape == (32, 96, 96, 3)
    assert math.isfinite(row["confidence"]) and isinstance(row["av_offset"], int)


def test_validate_fidelity_at_the_production_point(clip, tmp_path, capsys, haar):
    out = tmp_path / "gate.json"
    assert validate_fidelity.main([
        "--video", str(clip / "v.mp4"), "--audio", str(clip / "a.wav"), *_model_args(clip),
        "--fast", "int8,deepcache=4:1:enc,cfg=0:0.5", "--inference-steps", "4",
        "--workdir", str(tmp_path / "work"), "--out", str(out)]) == 0
    (row,) = _lines(capsys.readouterr().out)
    assert json.loads(out.read_text()) == row
    assert row["weights"] == "random" and row["gate"].startswith("INCONCLUSIVE")
    assert row["fast_mode"] == "int8,deepcache=4:1:enc,cfg=0:0.5"
    assert math.isfinite(row["conf_exact"]) and math.isfinite(row["conf_fast"])
    assert row["pixel_delta"] > 0
    assert sorted(os.listdir(tmp_path / "work")) == ["exact.mp4", "exact.wav", "fast.mp4",
                                                     "fast.wav"]
    assert [os.environ[k] for k in SWITCHES] == ["0", "0", ""]


def test_validate_fidelity_ladder_on_a_trainer_step(clip, tmp_path, capsys, haar,
                                                    monkeypatch):
    from latentsync_tpu_torch.config import load_unet_config
    from latentsync_tpu_torch.models.unet3d import UNet3DConditionModel
    from latentsync_tpu_torch.utils.checkpoint import save_checkpoint
    from latentsync_tpu_torch.utils.convert import init_random_

    unet = init_random_(UNet3DConditionModel(load_unet_config(str(clip / "tiny.yaml")).unet),
                        seed=9)
    step = save_checkpoint(str(tmp_path / "ckpt"), 3, dict(unet.state_dict()))
    monkeypatch.setattr(validate_fidelity, "LADDER", ["int8,deepcache=2:1", "int8"])
    args = _model_args(clip)
    args[args.index("--unet-ckpt") + 1] = step
    assert validate_fidelity.main([
        "--video", str(clip / "v.mp4"), "--audio", str(clip / "a.wav"), *args, "--ladder",
        "--inference-steps", "1", "--workdir", str(tmp_path / "work")]) == 0
    (row,) = _lines(capsys.readouterr().out)
    assert row["weights"] == "trained-tiny" and row["gate"].startswith("INCONCLUSIVE")
    assert [r["spec"] for r in row["rungs"]] == ["int8,deepcache=2:1", "int8"]
    assert row["selected"] == "exact"
    assert all(math.isfinite(r["conf"]) for r in row["rungs"])


def test_validate_fidelity_exact_render_is_unchanged_by_an_int8_render(clip, tmp_path, capsys,
                                                                       haar, monkeypatch):
    """One pipeline renders every mode, its switches set for each render: its
    exact render after an int8 production render equals, frame for frame,
    its exact render when freshly built (the switches are read at each call
    and an int8 render leaves nothing behind that the exact one reads)."""
    from latentsync_tpu_torch.scripts import inference

    real, built = inference.build_pipeline, []

    def build_once(args, dtype=None):
        if not built:
            built.append(real(args) if dtype is None else real(args, dtype))
        return built[0]

    monkeypatch.setattr(inference, "build_pipeline", build_once)
    for work in ("fresh", "after_int8"):
        assert validate_fidelity.main([
            "--video", str(clip / "v.mp4"), "--audio", str(clip / "a.wav"), *_model_args(clip),
            "--fast", "int8,deepcache=4:1:enc,cfg=0:0.5", "--inference-steps", "2",
            "--workdir", str(tmp_path / work)]) == 0
    capsys.readouterr()
    assert len(built) == 1
    fresh, after = (read_video(str(tmp_path / work / "exact.mp4"), change_fps=False)
                    for work in ("fresh", "after_int8"))
    np.testing.assert_array_equal(after, fresh)
    assert not np.array_equal(read_video(str(tmp_path / "fresh" / "fast.mp4"),
                                         change_fps=False), fresh)
