"""The port's tooling against the JAX package's, on the CPU.

``utils/misc.py``'s helpers against the JAX module's (``download_file`` on a
``file://`` URL: no network; ``concat_videos`` and the word-timestamp trim
through OpenCV, decoded frame for frame; ``occupy_gpu``'s loop on the CPU),
``utils/darken_restore.py`` bit for bit against the JAX module (landmark
masks, a failing detector, the Haar box), ``utils/thumbnail.py`` under its
size cap and byte for byte the JAX module's GIF, ``scripts/op_tally.py``
equal to the JAX tally, ``scripts/perf_probe.py``'s FLOP count (the meta
device, the kernels' plain versions) against ``op_tally`` at a tiny config
(within 1e-3: the time-embedding MLP is not in the tally) and its whole
probe at that size, ``scripts/transport_probe.py`` at one size,
and ``scripts/gradio_app.py``'s stdlib form answering one POST with a tiny
pipeline. ``scripts/train_artifact.py`` is ``tests/test_torch_train_artifact.py``'s.
"""

import json
import os
import threading
import types
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from latentsync_tpu.utils import darken_restore as jdark
from latentsync_tpu.utils import misc as jmisc
from latentsync_tpu.utils import thumbnail as jthumb
from latentsync_tpu_torch.config import load_unet_config
from latentsync_tpu_torch.scripts import gradio_app, op_tally, perf_probe
from latentsync_tpu_torch.scripts import transport_probe
from latentsync_tpu_torch.utils import darken_restore as pdark
from latentsync_tpu_torch.utils import misc as pmisc
from latentsync_tpu_torch.utils import thumbnail as pthumb
from latentsync_tpu_torch.utils.media import read_video, write_audio, write_video
from scripts import op_tally as jtally

from test_torch_cli import TINY_YAML
from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)

FRAMES_HW = (48, 64)


def _video(path, n=20, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (n, *FRAMES_HW, 3), dtype=np.uint8)
    write_video(str(path), frames)
    return frames


def test_misc_helpers_match_jax(tmp_path):
    audio = np.random.default_rng(1).standard_normal(1000).astype(np.float32)
    np.testing.assert_array_equal(pmisc.pad_audio_silence(audio, 16000, 0.01, 0.02),
                                  jmisc.pad_audio_silence(audio, 16000, 0.01, 0.02))
    a, b = tmp_path / "v" / "a.mp4", tmp_path / "v" / "sub" / "b.mp4"
    b.parent.mkdir(parents=True)
    _video(a, 10, 1)
    _video(b, 15, 2)
    (tmp_path / "v" / "note.txt").write_text("x")
    assert pmisc.gather_video_paths_recursively(str(tmp_path / "v")) == \
        jmisc.gather_video_paths_recursively(str(tmp_path / "v"))
    assert pmisc.count_video_time(str(b)) == jmisc.count_video_time(str(b)) == 15 / 25
    got = pmisc.concat_videos([str(a), str(b)], str(tmp_path / "cat_p.mp4"))
    want = jmisc.concat_videos([str(a), str(b)], str(tmp_path / "cat_j.mp4"))
    np.testing.assert_array_equal(read_video(got, change_fps=False),
                                  read_video(want, change_fps=False))

    def words(_):
        return [("a", 0.08, 0.2), ("b", 0.2, 0.36)]

    got = pmisc.trim_video_by_word_timestamps(str(b), str(tmp_path / "t_p.mp4"), words)
    want = jmisc.trim_video_by_word_timestamps(str(b), str(tmp_path / "t_j.mp4"), words)
    trimmed = read_video(got, change_fps=False)
    assert len(trimmed) == 7
    np.testing.assert_array_equal(trimmed, read_video(want, change_fps=False))
    with pytest.raises(RuntimeError, match="no transcriber"):
        pmisc.trim_video_by_word_timestamps(str(b), str(tmp_path / "x.mp4"))

    src = tmp_path / "payload.bin"
    src.write_bytes(os.urandom(4096))
    url = "file://" + urllib.request.pathname2url(str(src))
    got = pmisc.download_file(url, str(tmp_path / "dl" / "p.bin"))
    want = jmisc.download_file(url, str(tmp_path / "dl" / "j.bin"))
    assert open(got, "rb").read() == open(want, "rb").read() == src.read_bytes()
    kept = pmisc.persist_copy(str(src), str(tmp_path / "keep"))
    assert open(kept, "rb").read() == src.read_bytes()
    (tmp_path / "scratch").mkdir()
    (tmp_path / "scratch" / "f").write_text("x")
    pmisc.clean_folder(str(tmp_path / "scratch"))
    assert os.listdir(tmp_path / "scratch") == []
    assert pmisc.occupy_gpu(0.05, device="cpu", size=32) >= 1


def test_occupy_gpu_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmisc.occupy_gpu(0.01)


def _landmarks(frame):
    h, w = frame.shape[:2]
    t = np.linspace(0, 2 * np.pi, 20, endpoint=False)
    return np.stack([w / 2 + w / 4 * np.cos(t), h / 2 + h / 3 * np.sin(t)], -1)


def _failing_after_one():
    calls = []

    def detect(frame):
        calls.append(1)
        if len(calls) > 1:
            raise ValueError("no face")
        return _landmarks(frame)

    return detect


@pytest.mark.parametrize("detector", ["landmarks", "fails", "haar"])
def test_darken_restore_bit_for_bit(detector):
    frames = np.random.default_rng(2).integers(0, 255, (3, 64, 80, 3), dtype=np.uint8)
    make = {"landmarks": lambda: _landmarks, "fails": _failing_after_one,
            "haar": lambda: None}[detector]
    got = pdark.enhance_face_brightness(frames, 1.3, make())
    want = jdark.enhance_face_brightness(frames, 1.3, make())
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, frames)
    assert pdark.enhance_face_brightness(frames, 1.0) is frames
    assert pdark.calculate_inverse_factor(1.25) == jdark.calculate_inverse_factor(1.25)
    np.testing.assert_array_equal(
        pdark.face_mask_from_box((40, 50), (5, 6, 20, 24)),
        jdark.face_mask_from_box((40, 50), (5, 6, 20, 24)))


def test_thumbnail_under_its_cap(tmp_path):
    video = tmp_path / "clip.mp4"
    yy, xx = np.mgrid[0:FRAMES_HW[0], 0:FRAMES_HW[1]]
    write_video(str(video), np.stack([np.stack([(128 + 90 * np.sin(xx / 7 + t / 2 + c)).astype(
        np.uint8) for c in range(3)], -1) for t in range(24)]))
    cap = 30_000
    kw = dict(text="hello", max_bytes=cap, width=128)
    got = pthumb.create_video_thumbnail_gif(str(video), str(tmp_path / "p.gif"), **kw)
    want = jthumb.create_video_thumbnail_gif(str(video), str(tmp_path / "j.gif"), **kw)
    data = open(got, "rb").read()
    assert len(data) <= cap and data[:6] in (b"GIF87a", b"GIF89a")
    assert data == open(want, "rb").read()


def test_op_tally_is_the_jax_tally(capsys):
    for w in (1, 4):
        assert op_tally.tally(w) == jtally.tally(w)
    assert op_tally.main(["--w", "2"]) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert rows[-1]["family"] == "TOTAL" and "pred_ms" not in rows[-1]
    mfu = ",".join(f"{r['family']}=0.5" for r in rows[:-1])
    assert op_tally.main(["--w", "2", "--mfu", mfu]) == 0
    total = [json.loads(x) for x in capsys.readouterr().out.splitlines()][-1]
    assert total["pred_fwd_mfu"] == pytest.approx(0.5, rel=1e-2)


@pytest.fixture(scope="module")
def tiny_yaml(tmp_path_factory):
    path = tmp_path_factory.mktemp("tiny") / "tiny.yaml"
    path.write_text(TINY_YAML)
    return str(path)


@pytest.fixture(scope="module")
def probe_yaml(tmp_path_factory):
    """TINY_YAML at 4 frames and 4 DDIM steps."""
    path = tmp_path_factory.mktemp("probe") / "probe.yaml"
    path.write_text(TINY_YAML.replace("num_frames: 16", "num_frames: 4")
                    + "run:\n  inference_steps: 4\n")
    return str(path)


def test_perf_probe_counts_what_op_tally_counts(probe_yaml):
    cfg = load_unet_config(probe_yaml)
    lat = cfg.data.resolution // cfg.vae.scale_factor
    counted = perf_probe.unet_flops(cfg.unet, 2, cfg.data.num_frames, lat,
                                    dtype=torch.float32)
    analytic = op_tally.tally(1, cfg.unet, frames=cfg.data.num_frames, latent=lat)
    products = sum(analytic[k] for k in op_tally.PRODUCT_FAMILIES)
    assert counted == pytest.approx(products, rel=1e-3)
    lines = []
    report = perf_probe.probe(windows=1, rounds=1, config=probe_yaml, device="cpu",
                              emit=lines.append)
    assert [json.loads(x)["component"] for x in lines] == \
        ["flops_check", "unet_fwd", "vae_encode", "vae_decode", "denoise"]
    assert report["flops_check"]["ratio"] == pytest.approx(1.0, rel=1e-3)
    # the exact schedule: every step runs the CFG batch, the forward's
    assert cfg.run.inference_steps == 4
    assert report["denoise"]["tflop"] == pytest.approx(4 * report["unet_fwd"]["tflop"],
                                                       rel=1e-3)
    for row in report.values():
        assert all(np.isfinite(v) for v in row.values() if isinstance(v, float))


def test_transport_probe_at_one_size():
    rows = transport_probe.probe("cpu", emit=lambda _: None, sizes_mb=(1,))
    stages = {r.get("stage") for r in rows}
    assert {"audio2feat_5s", "encoder_call", "decode_fetch_64x256"} <= stages
    assert sum("xfer_mb" in r for r in rows) == 2  # pageable and pinned


def test_gradio_fallback_answers_a_form_post(tmp_path, tiny_yaml, monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "gradio", None)  # the stdlib form
    res, crop, hw, n = 64, 16, 96, 20
    yy, xx = np.mgrid[0:hw, 0:hw]
    frames = np.stack([np.stack([(128 + 100 * np.sin(xx / 9 + t / 3 + ch)).astype(np.uint8)
                                 for ch in range(3)], -1) for t in range(n)])
    write_video(str(tmp_path / "avatar.mp4"), frames)
    mat = np.array([[1.0, 0.0, -crop], [0.0, 1.0, -crop]])
    np.savez(tmp_path / "avatar.npz", faces=frames[:, crop:crop + res, crop:crop + res],
             boxes=np.tile([0, 0, res, res], (n, 1)), affine_matrices=np.repeat(mat[None], n, 0))
    write_audio(str(tmp_path / "speech.wav"),
                (0.3 * np.random.default_rng(0).standard_normal(16000)).astype(np.float32))
    args = types.SimpleNamespace(unet_config=tiny_yaml, unet_ckpt="", vae_ckpt="",
                                 whisper_ckpt="", device="cpu", out_dir=str(tmp_path / "out"))
    server = gradio_app.make_server(gradio_app.build_infer(args), "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}/"
        with urllib.request.urlopen(base, timeout=30) as r:
            assert b"<form method=post>" in r.read()
        form = urllib.parse.urlencode({
            "video": str(tmp_path / "avatar.mp4"), "audio": str(tmp_path / "speech.wav"),
            "data": str(tmp_path / "avatar.npz"), "guidance": "1.5", "steps": "2",
            "seed": "7"}).encode()
        with urllib.request.urlopen(base, data=form, timeout=300) as r:
            page = r.read().decode()
    finally:
        server.shutdown()
        server.server_close()
    assert "done: " in page, page
    out = page.split("done: ")[1].split("</p>")[0]
    assert read_video(out, change_fps=False).shape == (32, hw, hw, 3)
