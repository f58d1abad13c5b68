"""The SyncNet CLIs, the trainers' loss charts, checkpoints' ``aux`` and the
observability helpers, on the CPU.

``train_syncnet`` on a tiny config over clips written here: 2 steps with
validation (a held-out list) at step 2, the chart and a checkpoint with
both loss histories, then ``--resume`` for a third step that carries them
on; ``eval_syncnet_acc``'s JSON line; ``train_unet``'s chart at the end
of a run; the ``aux`` round trip of ``utils/checkpoint.py`` against what
the JAX checkpoint's ``aux.npz`` holds; and ``utils/observability.py``
against the JAX package's module (timers and their summary, rank-0
logging, metrics lines, the chart's file and size).
"""

import json
import os

import numpy as np
import pytest
import yaml

from latentsync_tpu.utils import observability as jobs
from latentsync_tpu_torch.utils import checkpoint as pckpt
from latentsync_tpu_torch.utils import observability as pobs

from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_data import _json_lines, _tiny_yaml, _write_clips


def _syncnet_yaml(root, files, val=""):
    enc = {"audio_encoder": {"in_channels": 1, "block_out_channels": [32, 64, 256],
                             "downsample_factors": [[4, 2], [4, 2], [5, 4]],
                             "attn_blocks": [0, 1, 0]},
           "visual_encoder": {"in_channels": 12, "block_out_channels": [32, 64, 256],
                              "downsample_factors": [[1, 2], 4, 4], "attn_blocks": [0, 1, 0]}}
    cfg = {"syncnet": enc,
           "data": {"train_fileslist": files, "val_fileslist": val, "num_frames": 4,
                    "resolution": 32, "batch_size": 2},
           "run": {"seed": 7, "lr": 1e-4}}
    path = os.path.join(root, "syncnet.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("clips")
    _write_clips(str(root), n=2, frames=24, size=40)
    return str(root)


def _png(path):
    import cv2

    img = cv2.imread(path)
    assert img is not None, path
    return img


def test_train_syncnet_validates_charts_saves_and_resumes(clips, tmp_path, capsys):
    from latentsync_tpu_torch.scripts import train_syncnet

    files = os.path.join(clips, "files.txt")
    cfg = _syncnet_yaml(str(tmp_path), files, val=files)
    out = str(tmp_path / "out")
    common = ["--config", cfg, "--device", "cpu", "--output-dir", out, "--log-every", "1",
              "--validation-steps", "2"]
    assert train_syncnet.main(common + ["--max-steps", "2"]) == 0
    lines = _json_lines(capsys.readouterr().out)
    steps = [r for r in lines if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    for r in steps:
        assert np.isfinite(r["loss"]) and 0 <= r["sat_frac"] <= 1 and r["steps_per_sec"] > 0
    val = [r for r in lines if "val_step" in r]
    assert len(val) == 1 and val[0]["val_step"] == 2 and 0 <= val[0]["val_acc"] <= 1
    assert _png(os.path.join(out, "loss_chart.png")).shape == (480, 640, 3)
    saved = pckpt.latest_checkpoint(out)
    assert saved.endswith("step_00000002.pt") and lines[-1] == {"saved": saved, "step": 2}
    state = pckpt.restore_checkpoint(saved)
    assert state["step"] == 2 and state["opt_state"]["state"]
    aux = state["aux"]
    assert [s for s, _ in aux["train_hist"]] == [1, 2]
    assert aux["val_hist"] == [[2.0, pytest.approx(val[0]["val_loss"])]]

    assert train_syncnet.main(common + ["--max-steps", "3", "--resume"]) == 0
    lines = _json_lines(capsys.readouterr().out)
    assert lines[0] == {"resumed_from": saved, "step": 2}
    assert [r["step"] for r in lines if "loss" in r] == [3]
    aux = pckpt.restore_checkpoint(pckpt.latest_checkpoint(out))["aux"]
    assert [s for s, _ in aux["train_hist"]] == [1, 2, 3] and len(aux["val_hist"]) == 1


def test_eval_syncnet_acc_prints_its_json_line(clips, tmp_path, capsys):
    from latentsync_tpu_torch.scripts import eval_syncnet_acc

    cfg = _syncnet_yaml(str(tmp_path), "")
    assert eval_syncnet_acc.main(["--config", cfg, "--data-dir", clips, "--num-samples", "4",
                                  "--batch-size", "2", "--device", "cpu"]) == 0
    (line,) = _json_lines(capsys.readouterr().out)
    assert set(line) == {"accuracy", "loss", "samples"}
    assert line["samples"] == 4 and 0 <= line["accuracy"] <= 1 and np.isfinite(line["loss"])


def test_cli_defaults_to_the_card(capsys):
    """Without a card the CLIs refuse ``--device cuda``, their default."""
    import torch

    from latentsync_tpu_torch.scripts import eval_syncnet_acc, train_syncnet

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (train_syncnet.main, eval_syncnet_acc.main):
        assert main([]) == 2
        assert "no CUDA device" in capsys.readouterr().err


def test_train_unet_draws_its_loss_chart(tmp_path, capsys):
    from latentsync_tpu_torch.scripts import train_unet

    _write_clips(str(tmp_path))
    cfg = _tiny_yaml(str(tmp_path), str(tmp_path / "files.txt"))
    out = str(tmp_path / "out")
    assert train_unet.main(["--config", cfg, "--device", "cpu", "--output-dir", out,
                            "--log-every", "1", "--max-steps", "2"]) == 0
    text = capsys.readouterr().out
    assert "loss chart failed" not in text
    assert [r["step"] for r in _json_lines(text) if "loss" in r] == [1, 2]
    assert _png(os.path.join(out, "loss_chart.png")).shape == (480, 640, 3)


def test_checkpoint_aux_round_trips_as_the_jax_aux_npz(tmp_path):
    """The JAX checkpoint writes ``aux.npz`` (``step`` and each history as
    an array) and restores it under ``"aux"``; the port keeps the same keys
    and values in its ``.pt``."""
    import torch

    hist = {"train_hist": [(1, 0.75), (2, 0.5)], "val_hist": [(2, 0.625)]}
    path = pckpt.save_checkpoint(str(tmp_path), 2, {"w": torch.ones(2)}, aux=hist)
    got = pckpt.restore_checkpoint(path)["aux"]
    np.savez(tmp_path / "aux.npz", step=2, **{k: np.asarray(v) for k, v in hist.items()})
    with np.load(tmp_path / "aux.npz") as ref:
        assert set(got) == set(ref.files)
        for k in ref.files:
            np.testing.assert_array_equal(np.asarray(got[k]), ref[k])
    assert "aux" not in pckpt.restore_checkpoint(
        pckpt.save_checkpoint(str(tmp_path), 3, {"w": torch.ones(2)}))


def test_observability_helpers_behave_as_the_jax_module(tmp_path, capsys):
    for mod in (jobs, pobs):
        mod.reset_timings()
        sink = {}
        for _ in range(2):
            with mod.stage_timer("a", sink):
                pass
        with mod.stage_timer("b"):
            pass
        summary = mod.timing_summary()
        assert set(summary) == {"a", "b"} and summary["a"]["count"] == 2
        assert set(summary["a"]) == {"count", "total_s", "mean_s", "min_s"}
        assert summary["a"]["total_s"] == pytest.approx(2 * summary["a"]["mean_s"])
        assert set(sink) == {"a"}
        mod.reset_timings()
        assert mod.timing_summary() == {}
        mod.log_main("hello")
        assert capsys.readouterr().out == "### hello\n"
        path = tmp_path / f"{mod.__name__}.jsonl"
        mod.write_metrics(str(path), {"step": 1})
        mod.write_metrics(str(path), {"step": 2, "loss": 0.5})
        assert [json.loads(x) for x in path.read_text().splitlines()] == \
            [{"step": 1}, {"step": 2, "loss": 0.5}]
    assert pobs.is_main_process()


def test_loss_chart_file_and_size_as_matplotlib(tmp_path):
    """The same file at matplotlib's default size (640x480), for one and
    for two series; a point that is not finite is left out; the lines are
    drawn in matplotlib's default colours."""
    series = [("train", [1, 2, 3, 4], [1.0, 0.8, float("nan"), 0.5]),
              ("val", [2, 4], [0.9, 0.7])]
    for n in (1, 2):
        ours, ref = str(tmp_path / f"p{n}.png"), str(tmp_path / f"j{n}.png")
        pobs.plot_loss_chart(ours, *series[:n])
        jobs.plot_loss_chart(ref, *series[:n])
        a, b = _png(ours), _png(ref)
        assert a.shape == b.shape == (480, 640, 3)
        for colour in pobs._COLOURS[:n]:
            assert (a == np.array(colour, np.uint8)).all(-1).sum() > 50
    pobs.plot_loss_chart(str(tmp_path / "empty.png"))
    assert _png(str(tmp_path / "empty.png")).shape == (480, 640, 3)


def test_profile_trace_writes_a_trace(tmp_path):
    import torch

    with pobs.profile_trace(str(tmp_path / "trace")) as d:
        torch.ones(64).sum()
    assert d == str(tmp_path / "trace") and os.listdir(d)


def test_loader_close_stops_its_thread():
    """``HostDataLoader.close`` returns once the thread has stopped (within
    the sample it was drawing), so that no thread is left inside a native
    video read while the interpreter exits."""
    import time

    from latentsync_tpu_torch.training.data import HostDataLoader

    class Slow:
        seed = 0

        def sample(self):
            time.sleep(0.05)
            return {"x": np.zeros(2, np.float32)}

    loader = HostDataLoader(Slow(), batch_size=8)
    first = next(iter(loader))
    assert first["x"].shape == (8, 2)
    t0 = time.time()
    loader.close()
    assert not loader.thread.is_alive() and time.time() - t0 < 5
