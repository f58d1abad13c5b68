"""The port's SyncNet trainer and its data source against the JAX package.

``SyncNetTrainer`` on the same weights (the port's StableSyncNet carried
into the JAX layout by ``convert_stable_syncnet`` and back by
``stable_syncnet_state_dict_from_flax``) and the same batch, in f32: one
train step's loss, ``sat_frac`` and gradients against
``jax.value_and_grad`` of the JAX trainer's own loss, the parameters after
the step (the clip, then AdamW) against the JAX train step's, and the eval
step's loss and accuracy. ``SyncNetSampleSource`` draws the same
``(vision, mel, y)`` as the JAX source from the same seed, on frames and a
mel injected into both. The towers end at 1×1 with 256 channels: groups of
8 in the last GroupNorm (with 2 the f32 gradient through it is
ill-conditioned in both packages, ``test_torch_train_models.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu import config as jc
from latentsync_tpu.training import data as jdata
from latentsync_tpu.training.syncnet_trainer import SyncNetTrainer as JTrainer
from latentsync_tpu.utils.convert import convert_stable_syncnet
from latentsync_tpu_torch import config as pcfg
from latentsync_tpu_torch.models.syncnet import StableSyncNet
from latentsync_tpu_torch.training import data as pdata
from latentsync_tpu_torch.training.syncnet_trainer import SyncNetTrainer
from latentsync_tpu_torch.utils import convert as pc

from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)

LR = 1e-2


def _cfg(m, lr=LR, frames=4, res=32):
    enc = m.SyncNetEncoderConfig
    return m.LatentSyncConfig(
        syncnet=m.SyncNetConfig(
            audio_encoder=enc(1, (32, 64, 256), ((4, 2), (4, 2), (5, 4)), (0, 1, 0)),
            visual_encoder=enc(3 * frames, (32, 64, 256), ((1, 2), 4, 4), (0, 1, 0))),
        run=m.RunConfig(lr=lr, max_grad_norm=1.0),
        data=m.DataConfig(num_frames=frames, resolution=res, batch_size=4))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _batch(seed=0, b=4):
    rng = np.random.default_rng(seed)
    return {"vision": rng.uniform(-1, 1, (b, 16, 32, 12)).astype(np.float32),
            "mel": (rng.standard_normal((b, 80, 13, 1)) * 2).astype(np.float32),
            "y": np.array([1, 0, 1, 0, 1, 1, 0, 0][:b], np.float32)}


@pytest.fixture(scope="module")
def pair():
    """(port trainer, JAX params, JAX step functions, tx), the same weights."""
    port = pc.init_random_(StableSyncNet(_cfg(pcfg).syncnet), seed=21)
    params = jax.tree.map(jnp.asarray, convert_stable_syncnet(
        {k: v.detach().numpy() for k, v in port.state_dict().items()}))
    jt = JTrainer(_cfg(jc), dtype=jnp.float32)
    tx = jt.make_optimizer()
    loss_fn, train_step, eval_step = jt.make_step_fns(tx)
    return port, params, (loss_fn, train_step, eval_step), tx


def _trainer(port):
    import copy

    return SyncNetTrainer(_cfg(pcfg), dtype=torch.float32, device="cpu",
                          model=copy.deepcopy(port))


def _torch_layout(tree):
    return {k: v.numpy() for k, v in pc.stable_syncnet_state_dict_from_flax(
        jax.tree.map(np.asarray, tree)).items()}


def test_train_step_loss_sat_and_gradients_match_jax(pair):
    port, params, (loss_fn, train_step, _), tx = pair
    batch = _batch(0)
    jb = jax.tree.map(jnp.asarray, batch)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(params, jb)
    _, _, metrics = train_step(params, tx.init(params), jb)
    tr = _trainer(port)
    loss, sat, grads = tr.gradients(batch)
    # f32 sums in other orders; the similarities are far from the clip's edges
    assert abs(float(loss.detach()) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    assert float(metrics["loss"]) == pytest.approx(float(ref_loss), rel=1e-6)
    assert float(sat) == float(metrics["sat_frac"])
    ref = _torch_layout(ref_grads)
    assert set(ref) == set(grads)
    flat = np.concatenate([ref[k].ravel() for k in sorted(ref)])
    total = _rel(np.concatenate([grads[k].numpy().ravel() for k in sorted(ref)]), flat)
    assert total < 1e-5, total
    # each tensor within 1e-4 of its own norm, or, where its gradient is
    # zero but for rounding (a convolution's bias ahead of a GroupNorm, the
    # keys' bias under the softmax: ~1e-8 here), 1e-6 of the whole gradient's
    scale = np.linalg.norm(flat)
    for k in ref:
        d = np.linalg.norm(grads[k].numpy() - ref[k])
        assert d <= max(1e-4 * np.linalg.norm(ref[k]), 1e-6 * scale), (k, d)


def test_parameters_after_one_step_match_jax(pair):
    """The clip over all gradients, then AdamW (weight decay 1e-4): Adam's
    first update is lr·g/(|g| + eps), nearly ±lr whatever |g|, so an element
    whose gradient is near zero may round to another sign; every element is
    held within 2·lr and all but a few within 1e-3·lr."""
    port, params, (_, train_step, _), tx = pair
    batch = _batch(1)
    new, _, metrics = train_step(params, tx.init(params), jax.tree.map(jnp.asarray, batch))
    tr = _trainer(port)
    out = tr.train_step(batch)
    assert set(out) == {"loss", "sat_frac", "grad_norm"}
    assert out["loss"] == pytest.approx(float(metrics["loss"]), rel=1e-5)
    assert out["sat_frac"] == float(metrics["sat_frac"])
    ref = _torch_layout(new)
    diffs = np.concatenate([np.abs(tr.params[k].detach().numpy() - ref[k]).ravel()
                            for k in ref])
    assert diffs.max() <= 2 * LR * (1 + 1e-6)
    assert np.mean(diffs > 1e-3 * LR) < 1e-3
    moved = np.concatenate([np.abs(tr.params[k].detach().numpy()
                                   - port.state_dict()[k].numpy()).ravel() for k in ref])
    assert np.median(moved) > 0.5 * LR  # the step moved the weights


def test_eval_step_matches_jax(pair):
    port, params, (_, _, eval_step), _ = pair
    batch = _batch(2, b=8)
    ref_loss, ref_acc = eval_step(params, jax.tree.map(jnp.asarray, batch))
    loss, acc = _trainer(port).eval_step(batch)
    assert loss == pytest.approx(float(ref_loss), rel=1e-5)
    assert acc == float(ref_acc)


def test_sample_source_equals_the_jax_source(monkeypatch):
    """The same draws in the same order (clip, window, coin flip, shifted
    audio window |Δ| > F/2), the lower halves of the resized frames stacked
    into channels in [-1, 1] and the mel window, from frames and a mel
    injected into both sources (the clips' reader and the mel are held
    against the JAX package elsewhere)."""
    rng = np.random.default_rng(3)
    clips = {f"c{i}.mp4": rng.integers(0, 255, (n, 40, 48, 3), dtype=np.uint8)
             for i, n in enumerate((20, 30))}
    mels = {p: rng.standard_normal((80, math.ceil(len(v) * 80 / 25) + 8)).astype(np.float32)
            for p, v in clips.items()}
    paths = sorted(clips)
    sources = []
    for mod, m in ((jdata, jc), (pdata, pcfg)):
        monkeypatch.setattr(mod, "read_video", lambda p, change_fps=False: clips[p])
        src = mod.SyncNetSampleSource(_cfg(m), video_paths=paths, seed=9)
        src.mel_cache.mel_for = lambda p: mels[p]
        sources.append(src)
    labels = []
    for _ in range(12):
        a, b = (s.sample() for s in sources)
        assert set(a) == set(b) == {"vision", "mel", "y"}
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)
        assert b["vision"].shape == (16, 32, 12) and b["mel"].shape == (80, 13, 1)
        assert -1 <= b["vision"].min() and b["vision"].max() <= 1
        labels.append(float(b["y"]))
    assert set(labels) == {0.0, 1.0}
