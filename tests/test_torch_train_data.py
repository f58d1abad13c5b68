"""The port's stage-2 training data, masks, checkpoints and CLI.

``UNetSampleSource`` against the JAX package's on clips written here (the
same windows, pixels, masks and mel from the same seed), the mask's
nearest resize against ``jax.image.resize``, the trainable set against the
JAX ``trainable_mask`` through the converter (stage 2 and
``stage2_efficient``), AdamW's settings against ``optax.adamw``,
checkpoints (a restored trainer takes the same next step), and
``scripts/train_unet.main`` on the CPU with ``--resume``. The tiny config is
``tests/test_torch_trainer.py``'s.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from latentsync_tpu import config as jc
from latentsync_tpu.training import data as jdata
from latentsync_tpu.training.unet_trainer import trainable_mask as j_mask
from latentsync_tpu.utils.convert import convert_unet
from latentsync_tpu_torch import config as pcfg
from latentsync_tpu_torch.models.unet3d import UNet3DConditionModel
from latentsync_tpu_torch.models.vae import AutoencoderKL
from latentsync_tpu_torch.training import data as pdata
from latentsync_tpu_torch.training.unet_trainer import UNetTrainer, trainable_mask
from latentsync_tpu_torch.utils import checkpoint as pckpt
from latentsync_tpu_torch.utils import convert as pc

from test_torch_trainer import LR, _batch, _cfg, _np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_adamw_decay_is_optax_not_torch_default():
    from latentsync_tpu_torch.training import unet_trainer as ut

    assert ut.ADAMW_WEIGHT_DECAY == 1e-4 and ut.ADAMW_EPS == 1e-8
    assert ut.ADAMW_BETAS == (0.9, 0.999)
    p = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.AdamW([p], lr=0.1, betas=ut.ADAMW_BETAS, eps=ut.ADAMW_EPS,
                            weight_decay=ut.ADAMW_WEIGHT_DECAY)
    p.grad = torch.tensor([1.0, -1.0, 0.0])
    opt.step()
    tx = optax.adamw(0.1)
    u, _ = tx.update(jnp.array([1.0, -1.0, 0.0]), tx.init(jnp.ones(3)), jnp.ones(3))
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(optax.apply_updates(
        jnp.ones(3), u)), rtol=1e-6)


@pytest.mark.parametrize("yaml", ["unet_stage2.yaml", "unet_stage2_efficient.yaml"])
def test_trainable_set_equals_the_jax_mask(yaml):
    modules = pcfg.load_unet_config(os.path.join(REPO, "configs", yaml)).run.trainable_modules
    assert modules == jc.load_unet_config(os.path.join(REPO, "configs", yaml)).run \
        .trainable_modules
    unet = UNet3DConditionModel(_cfg(pcfg).unet)
    params = convert_unet(_np(unet.state_dict()), 13, 4, 16)
    mask = j_mask(params, modules)
    as_arrays = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32), mask,
                             params)
    ref = {n: bool(v.numpy().all()) for n, v in pc.unet_state_dict_from_flax(as_arrays).items()}
    got = trainable_mask(list(ref), modules)
    assert got == ref
    assert 0 < sum(got.values()) < len(got)


@pytest.mark.parametrize("src,dst", [(256, 32), (32, 16), (20, 8), (6, 9)])
def test_mask_nearest_resize_matches_jax(src, dst):
    m = (np.random.default_rng(src).uniform(size=(2, 3, src, src, 1)) > 0.5).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(m), (2, 3, dst, dst, 1), "nearest"))
    got = torch.nn.functional.interpolate(torch.from_numpy(m[..., 0]), size=(dst, dst),
                                          mode="nearest-exact").numpy()
    np.testing.assert_array_equal(got, ref[..., 0])


def _write_clips(root, n=2, frames=48, size=40, seed=0):
    import cv2
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        path = os.path.join(root, f"clip{i}.mp4")
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (size, size))
        for _ in range(frames):
            w.write(rng.integers(0, 255, (size, size, 3), dtype=np.uint8))
        w.release()
        wavfile.write(path[:-4] + ".wav", 16000,
                      (rng.standard_normal(16000 * frames // 25 + 1600) * 3000).astype(np.int16))
        paths.append(path)
    with open(os.path.join(root, "files.txt"), "w") as f:
        f.write("\n".join(paths) + "\n")
    return paths


def test_sample_source_equals_the_jax_source(tmp_path):
    paths = _write_clips(str(tmp_path))
    js_ = jdata.UNetSampleSource(_cfg(jc), video_paths=paths, seed=5)
    ps = pdata.UNetSampleSource(_cfg(pcfg), video_paths=paths, seed=5)
    for _ in range(3):
        a, b = js_.sample(), ps.sample()
        assert set(a) == set(b)
        for k in a:
            if k == "mel":  # two FFT implementations in f32
                np.testing.assert_allclose(b[k], a[k], atol=5e-5)
            else:
                np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)


def _tiny_yaml(root, files):
    import yaml

    cfg = {"data": {"train_fileslist": files, "num_frames": 4, "resolution": 32},
           "run": {"seed": 7, "save_ckpt_steps": 1000},
           "model": {"block_out_channels": [32, 64, 64, 64], "layers_per_block": 1,
                     "norm_num_groups": 8, "cross_attention_dim": 16, "attention_head_dim": 4,
                     "motion_module_kwargs": {"num_attention_heads": 4}},
           "vae": {"block_out_channels": [16, 32], "layers_per_block": 1,
                   "norm_num_groups": 8},
           "syncnet": {"audio_encoder": {"in_channels": 1, "block_out_channels": [32, 64, 64],
                                         "downsample_factors": [[4, 2], [4, 2], [5, 4]],
                                         "attn_blocks": [0, 1, 0]},
                       "visual_encoder": {"in_channels": 12, "block_out_channels": [32, 64, 64],
                                          "downsample_factors": [[1, 2], 4, 4],
                                          "attn_blocks": [0, 1, 0]}}}
    path = os.path.join(root, "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_cli_trains_on_the_cpu_and_resumes(tmp_path, capsys):
    from latentsync_tpu_torch.scripts import train_unet

    _write_clips(str(tmp_path))
    yaml_path = _tiny_yaml(str(tmp_path), str(tmp_path / "files.txt"))
    out = str(tmp_path / "out")
    common = ["--config", yaml_path, "--device", "cpu", "--output-dir", out, "--log-every", "1"]
    assert train_unet.main(common + ["--max-steps", "2"]) == 0
    lines = _json_lines(capsys.readouterr().out)
    steps = [r for r in lines if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    for r in steps:
        assert math.isfinite(r["loss"]) and r["steps_per_sec"] > 0
        assert set(r["loss_components"]) == {"recon", "perceptual", "trepa", "sync"}
    saved = pckpt.latest_checkpoint(out)
    assert saved.endswith("step_00000002.pt") and lines[-1]["saved"] == saved
    state = pckpt.restore_checkpoint(saved)
    assert state["step"] == 2 and state["opt_state"]["state"]

    assert train_unet.main(common + ["--max-steps", "3", "--resume"]) == 0
    lines = _json_lines(capsys.readouterr().out)
    assert lines[0] == {"resumed_from": saved, "step": 2}
    assert [r["step"] for r in lines if "loss" in r] == [3]
    assert pckpt.latest_checkpoint(out).endswith("step_00000003.pt")


def test_checkpoint_round_trip(tmp_path):
    """Weights, optimizer state and step come back as saved, and a trainer
    restored from them takes the same next step as the one that saved."""
    cfg = _cfg(pcfg)
    unet = pc.init_random_(UNet3DConditionModel(cfg.unet), seed=1)
    vae = pc.init_random_(AutoencoderKL(cfg.vae), seed=2)
    run_off = pcfg.LatentSyncConfig(unet=cfg.unet, vae=cfg.vae, data=cfg.data,
                                    run=pcfg.RunConfig(pixel_space_supervise=False,
                                                       use_syncnet=False, lr=LR))
    tr = UNetTrainer(run_off, unet, vae, dtype=torch.float32)
    batch = _batch(1)
    t, noise = tr.draw(batch, 0)
    tr.train_step(batch, t, noise)
    path = pckpt.save_checkpoint(str(tmp_path), 1, tr.params, tr.optimizer.state_dict())
    assert pckpt.latest_checkpoint(str(tmp_path)) == path
    state = pckpt.restore_checkpoint(path)
    unet2 = UNet3DConditionModel(cfg.unet)
    unet2.load_state_dict(state["params"])
    tr2 = UNetTrainer(run_off, unet2, vae, dtype=torch.float32)
    tr2.optimizer.load_state_dict(state["opt_state"])
    t, noise = tr.draw(batch, 1)
    tr.train_step(batch, t, noise)
    tr2.train_step(batch, t, noise)
    for n, p in tr.params.items():
        assert torch.equal(p.detach(), tr2.params[n].detach()), n
