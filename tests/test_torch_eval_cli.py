"""The port's evaluation and data-preparation CLIs with ``--device cpu``.

``eval_sync_conf`` on a directory of two clips with ``.wav`` sidecars,
against the JAX CLI given the same ``syncnet_v2.model`` (written here from
the JAX package's random weights, with upstream's ``__S__.`` prefix);
``eval_fvd`` without I3D weights (the stderr warning and ``"random"``) and
with them (a ``.pt`` in piergiaj's layout and an ``.npz`` of the JAX
package's tree: the same FVD); ``draw_syncnet_lines`` on ``eval_sync_conf``'s
lines; ``data_processing_pipeline --with-quality-gate`` on a 5 s clip with
permissive gates; and every CLI's default: the card, exiting 2 without
one. The render CLIs are ``tests/test_torch_eval_render_cli.py``.

Tolerances: the scorer's rows within the JAX CLI's by the rules of
``tests/test_torch_eval.py`` (the printed confidence is rounded to 1e-4);
the FVD of one weight file read two ways exactly, and within 1e-4
relative of the JAX CLI's (f32 logits on both sides, float64 statistics).
"""

import json
import os
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.eval import sync_eval as je
from latentsync_tpu.models import i3d as ji
from latentsync_tpu_torch.scripts import (data_processing_pipeline, draw_syncnet_lines,
                                          eval_fvd, eval_sync_conf, inference_videos,
                                          validate_fidelity)
from latentsync_tpu_torch.utils import convert as pconv
from latentsync_tpu_torch.utils.media import read_audio, read_video, write_audio, write_video

from test_torch_eval import REL, talking_clip
from test_torch_eval_models import random_variables
from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)


FVD_REL = 1e-4


def _lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("clips")
    for i, n in enumerate((12, 16)):
        frames, audio = talking_clip(n, seed=i)
        write_video(str(root / f"v{i}.mp4"), frames[:, ::2, ::2], fps=25)
        write_audio(str(root / f"v{i}.wav"), audio)
    return root


def test_eval_sync_conf_matches_the_jax_cli(clips, tmp_path, capsys, monkeypatch):
    v = random_variables(je.SyncNetS(), (jnp.zeros((1, 5, 224, 224, 3)),
                                         jnp.zeros((1, 13, 20, 1))), seed=11)
    ckpt = str(tmp_path / "syncnet_v2.model")
    torch.save({"__S__." + k: t for k, t in pconv.syncnet_s_state_dict_from_flax(v).items()},
               ckpt)
    assert eval_sync_conf.main(["--dir", str(clips), "--syncnet-ckpt", ckpt,
                                "--device", "cpu"]) == 0
    got = _lines(capsys.readouterr().out)
    from scripts import eval_sync_conf as jcli

    monkeypatch.setattr(sys, "argv", ["eval_sync_conf", "--dir", str(clips),
                                      "--syncnet-ckpt", ckpt])
    jcli.main()
    want = _lines(capsys.readouterr().out)
    assert len(got) == len(want) == 3
    from latentsync_tpu_torch.eval import sync_eval as pe

    ev = pe.SyncNetEvaluator(pe.load_syncnet_s_file(ckpt), device="cpu")
    for g, w in zip(got[:2], want[:2]):
        assert g["video"] == w["video"]
        # the rows' distances, for the tie rule (the CLI's own frames and audio)
        frames = np.stack([cv2.resize(f, (224, 224)) for f in read_video(g["video"], False)])
        d = pe.pairwise_shift_distances(*ev.features(frames, read_audio(g["video"][:-4]
                                                                        + ".wav")))
        scale = float(d.abs().max())
        tol = REL * scale + 1e-4  # the printed numbers are rounded to 1e-4
        assert abs(g["confidence"] - w["confidence"]) <= tol
        assert abs(g["min_dist"] - w["min_dist"]) <= tol
        mean = np.sort(d.mean(0).numpy())
        if mean[1] - mean[0] > REL * scale:
            assert g["av_offset"] == w["av_offset"]
    assert abs(got[2]["mean_confidence"] - want[2]["mean_confidence"]) < 1e-3
    # the rows feed the chart CLI
    jsonl = tmp_path / "a.jsonl"
    jsonl.write_text("\n".join(json.dumps(r) for r in got) + "\nnot json\n")
    out = str(tmp_path / "lines.png")
    assert draw_syncnet_lines.main(["--inputs", str(jsonl), str(jsonl), "--labels", "a",
                                    "--out", out]) == 0
    assert cv2.imread(out).shape == (480, 640, 3)
    assert f"wrote {out}" in capsys.readouterr().out


@pytest.fixture(scope="module")
def fvd_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fvd")
    rng = np.random.default_rng(2)
    for name, shift in (("real", 0), ("fake", 40)):
        os.makedirs(root / name)
        for i in range(3):
            frames = rng.integers(shift, 180 + shift, (9, 40, 40, 3), np.uint8)
            write_video(str(root / name / f"c{i}.mp4"), frames, fps=25)
        write_video(str(root / name / "short.mp4"), frames[:4], fps=25)  # skipped
    return root


def test_eval_fvd_random_and_from_files(fvd_dirs, tmp_path, capsys, monkeypatch):
    args = ["--real-dir", str(fvd_dirs / "real"), "--fake-dir", str(fvd_dirs / "fake"),
            "--num-frames", "8", "--size", "32", "--device", "cpu"]
    monkeypatch.setenv("LATENTSYNC_I3D_CKPT", str(tmp_path / "absent.pt"))
    assert eval_fvd.main(args) == 0
    out = capsys.readouterr()
    row = _lines(out.out)[-1]
    assert "RANDOM weights" in out.err
    assert row["i3d_weights"] == "random" and row["n_real"] == row["n_fake"] == 3
    assert np.isfinite(row["fvd"])

    v = random_variables(ji.InceptionI3D(), (jnp.zeros((1, 8, 32, 32, 3)),), seed=3)
    sd = pconv.i3d_state_dict_from_flax(v)
    torch.save(sd, tmp_path / "i3d.pt")
    np.savez(tmp_path / "i3d.npz", **{"/".join(p.key for p in path): np.asarray(leaf)
                                      for path, leaf in _leaves(v)})
    rows = []
    for name in ("i3d.pt", "i3d.npz"):
        monkeypatch.setenv("LATENTSYNC_I3D_CKPT", str(tmp_path / name))
        assert eval_fvd.main(args) == 0
        rows.append(_lines(capsys.readouterr().out)[-1])
        model, source = eval_fvd.load_i3d(str(tmp_path / name), "cpu")
        assert source == "pretrained"
        for k, t in sd.items():
            assert torch.equal(model.state_dict()[k], t), k
    assert rows[0] == rows[1] and rows[0]["i3d_weights"] == "pretrained"
    assert np.isfinite(rows[0]["fvd"]) and rows[0]["fvd"] != row["fvd"]

    # the JAX CLI on the same directories and the same weights (its .npz tree):
    # the clip preparation and the net end to end
    from scripts import eval_fvd as jcli

    monkeypatch.setattr(sys, "argv", ["eval_fvd", *args[:-2]])
    jcli.main()
    (want,) = _lines(capsys.readouterr().out)
    assert {k: want[k] for k in ("n_real", "n_fake", "i3d_weights")} \
        == {k: rows[0][k] for k in ("n_real", "n_fake", "i3d_weights")}
    assert abs(rows[0]["fvd"] - want["fvd"]) <= FVD_REL * abs(want["fvd"])


def _leaves(tree):
    import jax

    return jax.tree_util.tree_leaves_with_path(tree)


def test_data_processing_pipeline_cli_on_the_cpu(tmp_path, capsys, monkeypatch):
    """A 5 s clip through the eight stages with the quality gate and the
    permissive gates: one training-ready 256² clip with its sidecar, each
    stage's count printed, no stage's failure line."""
    monkeypatch.setenv("LATENTSYNC_FAN_CKPT", str(tmp_path / "absent.npz"))
    monkeypatch.setenv("LATENTSYNC_NO_FALLBACK_FAN", "1")
    # the fallback is warned once a process: warned afresh whatever ran before
    from latentsync_tpu_torch.utils import image_processor

    monkeypatch.setattr(image_processor, "_warned_fallback", False)
    src = tmp_path / "raw"
    src.mkdir()
    frames, audio = talking_clip(125, seed=3)
    write_video(str(src / "talk.mp4"), frames[:, ::2, ::2], fps=25)
    write_audio(str(src / "talk.wav"), audio)
    files = str(tmp_path / "files.txt")
    with pytest.warns(UserWarning, match="Haar"):
        assert data_processing_pipeline.main([
            "--input", str(src), "--output", str(tmp_path / "out"), "--fileslist", files,
            "--with-quality-gate", "--min-sync-conf=-1e9", "--max-av-offset", "1000000",
            "--min-iqa=-1e9", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "failed" not in text
    for stage in ("decodable", "resampled", "shot", "segmented", "affine_transformed",
                  "filtered_affined", "av_synced", "high_visual_quality"):
        assert f"stage {stage}: 1 files" in text
    (out,) = open(files).read().split()
    assert out.endswith(os.path.join("high_visual_quality", "talk_shot0_seg0.mp4"))
    assert os.path.exists(out[:-4] + ".wav")
    from latentsync_tpu_torch.utils.media import video_info

    assert video_info(out)[:2] == (256, 256)


@pytest.mark.parametrize("cli,argv", [
    (eval_sync_conf, ["--video", "v.mp4"]),
    (eval_fvd, ["--real-dir", "r", "--fake-dir", "f"]),
    (data_processing_pipeline, ["--input", "i", "--output", "o"]),
    (inference_videos, ["--pairs", "p.tsv", "--out-dir", "o"]),
    (validate_fidelity, ["--video", "v.mp4", "--audio", "a.wav"]),
])
def test_clis_default_to_the_card_and_exit_nonzero_without_one(monkeypatch, capsys, cli, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(argv) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err and "--device cpu" in out.err
