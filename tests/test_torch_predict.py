"""The port's cog ``Predictor`` against the top-level ``predict.Predictor``
and the port's inference CLI, on the CPU.

The signatures of ``setup`` and ``predict`` are the JAX package's, plus
``device``. On the upstream-layout ``.pt`` files of the JAX package's random
weights and the tiny stage YAML that ``tests/test_torch_cli.py`` writes (its
``files`` fixture, shared), ``setup(device="cpu")`` builds a pipeline with
the state ``scripts/inference.build_pipeline`` gives on the same files, and
``predict()`` at 2 steps on a short clip of a rendered face, without a
bundle (the face path, whisper, the VAE and the UNet), writes the frames and
the sidecar audio that ``inference.main`` writes on the same inputs and
seed, bit for bit. Without a card, ``setup()`` raises.
"""

import inspect
import os
import shutil

import numpy as np
import pytest
import torch

from latentsync_tpu_torch.predict import Predictor
from latentsync_tpu_torch.scripts import inference as pinf
from latentsync_tpu_torch.training.synthetic_faces import render_face
from latentsync_tpu_torch.utils.media import read_audio, read_video, write_audio, write_video

from test_torch_cli import _args, _assert_state, files  # noqa: F401 (fixture)
from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)

SWITCHES = ("LATENTSYNC_INT8", "LATENTSYNC_DEEPCACHE", "LATENTSYNC_CFG_INTERVAL")


def _params(fn, drop=()):
    return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()
            if p.name not in drop]


def test_signatures_are_the_jax_predictors_plus_device():
    import predict as jpredict

    assert _params(Predictor.predict) == _params(jpredict.Predictor.predict)
    assert _params(Predictor.setup, drop=("device",)) == _params(jpredict.Predictor.setup)
    assert _params(Predictor.setup)[-1] == ("device", "cuda")


def _setup(root, **kw):
    p = Predictor()
    p.setup(unet_ckpt=str(root / "unet_wrapped.pt"), vae_ckpt=str(root / "vae.pt"),
            whisper_ckpt=str(root / "tiny.pt"), unet_config=str(root / "tiny.yaml"), **kw)
    return p


def test_setup_builds_the_inference_clis_pipeline(files):
    root = files[0]
    got = _setup(root, device="cpu").pipeline
    want = pinf.build_pipeline(_args(root))
    assert got.device.type == "cpu" and got.dtype == want.dtype == torch.float32
    for name, module in (("unet", lambda p: p.unet), ("vae", lambda p: p.vae),
                         ("whisper", lambda p: p.audio_encoder.model)):
        _assert_state(module(got), module(want).state_dict())
    assert got.config == want.config


def test_setup_without_a_card_raises(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor().setup()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _setup(files[0])


@pytest.fixture(scope="module")
def clip(files):
    """12 frames of one rendered face, moving a little, and 0.5 s of audio."""
    root = files[0]
    face, _ = render_face(np.random.default_rng(100), 96)
    frames = np.full((12, 128, 128, 3), 80, np.uint8)
    for i, frame in enumerate(frames):
        y, x = 12 + i % 3, 14 + 2 * (i % 4)
        frame[y:y + 96, x:x + 96] = face
    write_video(str(root / "face.mp4"), frames, fps=25)
    rng = np.random.default_rng(4)
    write_audio(str(root / "face.wav"), (0.3 * rng.standard_normal(8000)).astype(np.float32))
    return str(root / "face.mp4"), str(root / "face.wav")


def test_predict_writes_what_the_inference_cli_writes(files, clip, tmp_path, monkeypatch,
                                                      capsys):
    root = files[0]
    for k in SWITCHES:
        monkeypatch.setenv(k, "")
    video, audio = clip
    got = _setup(root, device="cpu").predict(video, audio, inference_steps=2)
    try:
        assert os.path.basename(got) == "out.mp4"
        got_frames = read_video(got, change_fps=False)
        got_audio = read_audio(got[:-4] + ".wav")
    finally:
        shutil.rmtree(os.path.dirname(got))
    want = str(tmp_path / "cli.mp4")
    assert pinf.main(["--video", video, "--audio", audio, "--out", want,
                      "--unet-config", str(root / "tiny.yaml"),
                      "--unet-ckpt", str(root / "unet_wrapped.pt"),
                      "--vae-ckpt", str(root / "vae.pt"), "--whisper-ckpt", str(root / "tiny.pt"),
                      "--inference-steps", "2", "--device", "cpu"]) == 0
    capsys.readouterr()
    want_frames = read_video(want, change_fps=False)
    assert got_frames.shape == (16, 128, 128, 3)
    np.testing.assert_array_equal(got_frames, want_frames)
    np.testing.assert_array_equal(got_audio, read_audio(want[:-4] + ".wav"))
    # the face was regenerated: the output is not the input looped
    src = read_video(video, change_fps=False)
    assert np.abs(got_frames[:12].astype(int) - src.astype(int)).max() > 8
