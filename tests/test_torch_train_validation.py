"""The UNet trainer's validation on the CPU: it now scores its render with
the port's SyncNet scorer (``eval/sync_eval.py``, seeded random weights as in
the JAX CLI), prints a finite ``val_sync_conf`` at each checkpoint and draws
the validation scores beside the train loss, as the JAX trainer
(``scripts/train_unet.py:276-283, 318-330``) does. The tiny trainer config
of ``tests/test_torch_train_data.py``; the face path is the Haar anchor
heuristic (``LATENTSYNC_NO_FALLBACK_FAN``).
"""

import json
import math
import os

import torch
import yaml

from latentsync_tpu_torch.scripts import train_unet

from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_data import _tiny_yaml, _write_clips


def _lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_train_unet_validation_scores_and_charts(tmp_path, capsys, monkeypatch):
    """Two steps with a checkpoint (and so a validation) at step 2: its line
    has a finite ``val_sync_conf``; the chart gets the train loss and the
    validation scores as two series."""
    monkeypatch.setenv("LATENTSYNC_FAN_CKPT", str(tmp_path / "absent.npz"))
    monkeypatch.setenv("LATENTSYNC_NO_FALLBACK_FAN", "1")
    _write_clips(str(tmp_path), n=1, frames=30)
    cfg_path = _tiny_yaml(str(tmp_path), str(tmp_path / "files.txt"))
    cfg = yaml.safe_load(open(cfg_path))
    cfg["data"].update(val_video_path=str(tmp_path / "clip0.mp4"),
                       val_audio_path=str(tmp_path / "clip0.wav"))
    cfg["run"].update(save_ckpt_steps=2, inference_steps=2)
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    from latentsync_tpu_torch.utils import observability

    charts = []
    real = observability.plot_loss_chart
    monkeypatch.setattr(observability, "plot_loss_chart",
                        lambda path, *series: charts.append(series) or real(path, *series))
    out = str(tmp_path / "out")
    assert train_unet.main(["--config", cfg_path, "--device", "cpu", "--output-dir", out,
                            "--log-every", "1", "--max-steps", "2"]) == 0
    text = capsys.readouterr().out
    assert "failed" not in text and "skipped" not in text
    vals = [r for r in _lines(text) if "val_sync_conf" in r]
    assert [r["val_step"] for r in vals] == [2]
    assert all(isinstance(r["val_sync_conf"], float) and math.isfinite(r["val_sync_conf"])
               for r in vals)
    (series,) = charts
    assert [s[0] for s in series] == ["train_loss", "val_sync_conf"]
    assert series[0][1] == [1, 2] and series[1][1] == [2]
    assert series[1][2] == [r["val_sync_conf"] for r in vals]
    assert os.path.exists(os.path.join(out, "loss_chart.png"))


def test_run_validation_returns_none_without_a_val_pair(tmp_path):
    from latentsync_tpu_torch.config import LatentSyncConfig

    assert train_unet.run_validation(None, None, LatentSyncConfig(), str(tmp_path), 1,
                                     torch.device("cpu"), torch.float32) is None
