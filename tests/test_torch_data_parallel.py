"""Data-parallel training (``latentsync_tpu_torch/parallel/mesh.py``) on the CPU.

Two gloo ranks launched by ``python -m torch.distributed.run`` take one
SyncNet step at global batch 4, two samples each, and end with the weights
one process gets from the same 4 samples (f32, relative L2 1e-5; the lr is
the SyncNet configs' 1e-5: Adam's first update is ±lr wherever a gradient
is zero but for rounding, such as a convolution's bias ahead of a
GroupNorm, and the two runs round those apart), the same loss and the same
norm of the averaged gradient. The JAX trainers' rule ``dp = gcd(batch,
devices)`` and a rank beyond it, which says so and exits 0, in both CLIs.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from latentsync_tpu_torch import config as pcfg
from latentsync_tpu_torch.models.syncnet import StableSyncNet
from latentsync_tpu_torch.parallel import mesh
from latentsync_tpu_torch.training.syncnet_trainer import SyncNetTrainer
from latentsync_tpu_torch.utils import convert as pc

from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)
from test_torch_syncnet_trainer import _batch, _cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-5  # configs/syncnet_*.yaml

WORKER = """
import sys
import torch
sys.path.insert(0, {repo!r})
from latentsync_tpu_torch.models.syncnet import StableSyncNet
from latentsync_tpu_torch.parallel import mesh
from latentsync_tpu_torch.training.syncnet_trainer import SyncNetTrainer

torch.set_num_threads(1)
payload = torch.load({payload!r}, weights_only=False)
cfg = payload["config"]
place = mesh.init_data_parallel(cfg.data.batch_size, torch.device("cpu"))
assert place.active and place.dp == 2 and torch.distributed.get_backend() == "gloo"
model = StableSyncNet(cfg.syncnet)
model.load_state_dict(payload["weights"])
trainer = SyncNetTrainer(cfg, dtype=torch.float32, device="cpu", model=model)
share = cfg.data.batch_size // place.dp
rows = slice(place.rank * share, (place.rank + 1) * share)
metrics = trainer.train_step({{k: v[rows] for k, v in payload["batch"].items()}})
torch.save({{"params": {{k: v.detach() for k, v in trainer.params.items()}},
            "metrics": metrics}}, {out!r}.format(place.rank))
mesh.shutdown()
"""


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("batch,devices,dp", [(32, 1, 1), (32, 4, 4), (6, 4, 2), (1, 4, 1),
                                              (5, 4, 1), (4, 8, 4)])
def test_data_parallel_degree_is_the_jax_gcd(batch, devices, dp):
    assert mesh.data_parallel_degree(batch, devices) == dp == math.gcd(batch, devices)


def test_two_gloo_ranks_take_the_step_of_one_rank(tmp_path):
    cfg = _cfg(pcfg, lr=LR)
    model = pc.init_random_(StableSyncNet(cfg.syncnet), seed=23)
    batch = _batch(4)
    payload = str(tmp_path / "payload.pt")
    torch.save({"config": cfg, "weights": model.state_dict(),
                "batch": batch}, payload)
    out = str(tmp_path / "rank{}.pt")
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO, payload=payload, out=out))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         str(script)], capture_output=True, text=True, timeout=240, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]

    one = SyncNetTrainer(cfg, dtype=torch.float32, device="cpu", model=model)
    ref = one.train_step(batch)
    flat = torch.cat([p.detach().reshape(-1) for p in one.params.values()]).numpy()
    for rank in (0, 1):
        got = torch.load(out.format(rank), weights_only=False)
        g = torch.cat([got["params"][k].reshape(-1) for k in one.params]).numpy()
        assert _rel(g, flat) < 1e-5, rank
        m = got["metrics"]
        assert m["loss"] == pytest.approx(ref["loss"], rel=1e-5)
        assert m["sat_frac"] == ref["sat_frac"]
        assert m["grad_norm"] == pytest.approx(ref["grad_norm"], rel=1e-5)


def _yaml(tmp_path, batch):
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump({"data": {"batch_size": batch}}))
    return str(path)


@pytest.mark.parametrize("cli", ["train_syncnet", "train_unet"])
def test_a_rank_beyond_the_degree_exits(tmp_path, monkeypatch, capsys, cli):
    """Batch 4 over 3 ranks: dp = 1, so ranks 1 and 2 say so and exit 0
    without joining a process group."""
    import importlib

    main = importlib.import_module(f"latentsync_tpu_torch.scripts.{cli}").main
    for rank in (1, 2):
        monkeypatch.setenv("RANK", str(rank))
        monkeypatch.setenv("LOCAL_RANK", str(rank))
        monkeypatch.setenv("WORLD_SIZE", "3")
        assert main(["--config", _yaml(tmp_path, 4), "--device", "cpu",
                     "--output-dir", str(tmp_path / "out")]) == 0
        said = capsys.readouterr().out
        assert f"rank {rank} of 3 idle" in said and "= 1" in said
        assert not torch.distributed.is_initialized()
    assert not (tmp_path / "out").exists()
    place = mesh.init_data_parallel(4, torch.device("cpu"))
    assert (place.rank, place.dp, place.world, place.active) == (2, 1, 3, False)


def test_unet_draws_are_the_global_batch_rows():
    """Each rank's t and noise are its rows of the global batch's draws, so
    two ranks of one sample draw what one rank of two samples draws."""
    from latentsync_tpu_torch.models.unet3d import UNet3DConditionModel
    from latentsync_tpu_torch.models.vae import AutoencoderKL
    from latentsync_tpu_torch.training.unet_trainer import UNetTrainer

    from test_torch_trainer import _cfg as _unet_cfg

    cfg = _unet_cfg(pcfg)
    trainer = UNetTrainer(cfg, UNet3DConditionModel(cfg.unet), AutoencoderKL(cfg.vae),
                          dtype=torch.float32)
    one = {"gt_pixels": np.zeros((1, 4, 32, 32, 3), np.float32)}
    two = {"gt_pixels": np.zeros((2, 4, 32, 32, 3), np.float32)}
    t, noise = trainer.draw(two, 3)
    for rank in (0, 1):
        tr, nr = trainer.draw(one, 3, rank, 2)
        assert torch.equal(tr, t[rank:rank + 1]) and torch.equal(nr, noise[rank:rank + 1])
    t1, n1 = trainer.draw(one, 3)
    assert torch.equal(t1, trainer.draw(one, 3, 0, 1)[0]) and n1.shape == trainer.latent_shape(one)
