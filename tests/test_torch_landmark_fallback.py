"""The landmark-fallback trainer (``latentsync_tpu_torch/training/
synthetic_faces.py`` and ``scripts/train_landmark_fallback.py``) against the
JAX package's, on the CPU.

``synthetic_faces`` bit for bit from the same ``np.random.Generator``; the
device heatmaps, the argmax decode (ties included) and the NME against the
JAX script's functions (1e-6); the schedule against optax's (atol 1e-10:
optax rounds in f32); two training steps of a narrow FAN (1 module × 16 features, batch 2 at 256²) against
the JAX step rebuilt from the script's own lines (``train_step`` is local
to its ``main``), from one seeded FAN with random batch statistics carried
into flax by the JAX package's ``convert_fan``, with the batch indices
injected: the loss (rtol 5e-5), the batch norms' running statistics (rtol
1e-4), the parameters unmoved after the first step (its lr is 0, in both)
and the second step's Adam update (relative L2 0.05 a tensor, 1e-3 over
all; the two biases ahead of a batch norm are left out: their gradient is
rounding alone, and Adam turns it into ±lr either way). torch's default
``BatchNorm2d`` fails the statistics' check. The CLI at a tiny size writes
an asset the port's detector loads.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from latentsync_tpu.models.face_detection import FAN2D as JFAN2D
from latentsync_tpu.training import synthetic_faces as jsf
from latentsync_tpu.utils.convert_eval import convert_fan
from latentsync_tpu_torch.models.face_detection import FAN2D, FANLandmarkDetector
from latentsync_tpu_torch.scripts import train_landmark_fallback as tl
from latentsync_tpu_torch.training import synthetic_faces as psf
from latentsync_tpu_torch.utils.convert import (fan_state_dict_from_flax, init_random_bn_,
                                                load_state_dict_file)
from scripts import train_landmark_fallback as jtl

from test_torch_flop_cuts import FAST_COMPILE
from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, LR, POS_WEIGHT, SIGMA, BATCH = 10, 1e-3, 30.0, 1.5, 2
# biases ahead of a batch norm: their gradient is zero but for rounding
BN_FED = ("conv1.bias", "conv_last0.bias")
# the batch statistics of a channel whose mean is far from 0 round apart in
# E[x²] − E[x]² (2e-5 relative at the second step)
RTOL_STATS = 1e-4
# the loss, a mean over 2 x 68 x 64² f32 terms (1.04e-5 apart at the second step)
LOSS_RTOL = 5e-5
# the Adam update of the second step, relative L2 a tensor and over all
# (bn1.weight's gradient is 7 % apart: 2e-6 in norm, near rounding)
UPDATE_REL, UPDATE_REL_ALL = 0.05, 1e-3


@pytest.mark.parametrize("hair_p", [0.0, 0.85])
def test_synthetic_faces_bit_for_bit(hair_p):
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(4):
        img_j, pts_j = jsf.render_face(a, 256, hair_p=hair_p)
        img_p, pts_p = psf.render_face(b, 256, hair_p=hair_p)
        np.testing.assert_array_equal(img_p, img_j)
        np.testing.assert_array_equal(pts_p, pts_j)
    np.testing.assert_array_equal(psf.canonical_68(), jsf.canonical_68())
    got = psf.make_batch(np.random.default_rng(4), 2, 128)
    want = jsf.make_batch(np.random.default_rng(4), 2, 128)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_device_heatmaps_decode_and_nme():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-8, 264, (3, 68, 2)).astype(np.float32)
    got = tl.device_heatmaps(torch.from_numpy(pts), sigma=SIGMA).numpy()
    want = np.asarray(jtl.device_heatmaps(jnp.asarray(pts), sigma=SIGMA)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, want, atol=1e-6)
    heat = rng.standard_normal((3, 64, 64, 68)).astype(np.float32)
    heat[0, 5, 7] = heat[0, 9, 2] = 10.0  # a tie: the first maximum wins in both
    got = tl.device_decode(torch.from_numpy(heat.transpose(0, 3, 1, 2).copy())).numpy()
    want = np.asarray(jtl.device_decode(jnp.asarray(heat)))
    np.testing.assert_array_equal(got, want)
    got_nme = float(tl.nme(torch.from_numpy(got), torch.from_numpy(pts)))
    np.testing.assert_allclose(got_nme, float(jtl.nme(jnp.asarray(want), jnp.asarray(pts))),
                               rtol=1e-6)


@pytest.mark.parametrize("steps", [10, 2000])
def test_schedule_is_optax(steps):
    warmup, decay = min(100, steps // 2), max(steps, steps // 2 + 1)
    sched = optax.warmup_cosine_decay_schedule(0.0, LR, warmup, decay, LR * 0.01)
    for count in sorted({0, 1, warmup - 1, warmup, warmup + 1, steps // 2, steps - 1, steps,
                         steps + 5}):
        np.testing.assert_allclose(tl.warmup_cosine_decay(count, LR, warmup, decay, LR * 0.01),
                                   float(sched(count)), rtol=1e-6, atol=1e-10)


def _jax_step(model_t, tx):
    """The JAX script's ``train_step`` (``scripts/train_landmark_fallback.py:
    134-155``) with `idx` an argument instead of its ``jax.random`` draw."""

    @jax.jit
    def train_step(params, batch_stats, opt_state, idx, d_imgs, d_lms):
        x = d_imgs[idx].astype(jnp.float32) / 255.0
        target = jtl.device_heatmaps(d_lms[idx], sigma=SIGMA)

        def loss_fn(p):
            outs, mut = model_t.apply(
                {"params": p, "batch_stats": batch_stats}, x,
                mutable=["batch_stats"])
            w = 1.0 + POS_WEIGHT * target
            loss = sum(jnp.mean(w * (o - target) ** 2) for o in outs)
            return loss, mut["batch_stats"]

        (loss, new_bs), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, new_opt = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_bs, new_opt, loss

    return train_step


@pytest.fixture(scope="module")
def stepped():
    images, lms = tl.render_dataset(68, seed=1)
    init = FAN2D(num_modules=1, features=16)
    init.load_state_dict(init_random_bn_(FAN2D(num_modules=1, features=16), seed=2).state_dict())
    variables = convert_fan({k: v.numpy() for k, v in init.state_dict().items()
                             if not k.endswith("num_batches_tracked")})
    params, batch_stats = variables["params"], variables["batch_stats"]
    model_t = JFAN2D(num_modules=1, features=16, train=True)
    tx = optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adam(optax.warmup_cosine_decay_schedule(
            0.0, LR, min(100, STEPS // 2), max(STEPS, STEPS // 2 + 1), LR * 0.01)),
    )
    opt_state = tx.init(params)
    indices = [np.array([64, 66]), np.array([67, 65])]
    data = (jnp.asarray(images), jnp.asarray(lms))
    step = _jax_step(model_t, tx).lower(params, batch_stats, opt_state, jnp.asarray(indices[0]),
                                        *data).compile(FAST_COMPILE)
    jax_states = []
    for idx in indices:
        params, batch_stats, opt_state, loss = step(params, batch_stats, opt_state,
                                                    jnp.asarray(idx), *data)
        jax_states.append((float(loss), fan_state_dict_from_flax(
            {"params": params, "batch_stats": batch_stats})))

    def port_run(flax_bn: bool):
        model = copy.deepcopy(init)
        trainer = tl.LandmarkTrainer(images, lms, STEPS, lr=LR, pos_weight=POS_WEIGHT,
                                     sigma=SIGMA, batch=BATCH, device="cpu", model=model)
        if not flax_bn:
            for m in trainer.model.modules():
                if isinstance(m, tl.FlaxBatchNorm2d):
                    m.__class__ = torch.nn.BatchNorm2d
        states = []
        for idx in indices:
            loss = trainer.train_step(torch.from_numpy(idx))
            states.append((float(loss), {k: v.clone() for k, v in
                                         trainer.model.state_dict().items()}))
        return states

    return init.state_dict(), jax_states, port_run(True), port_run(False)


def _stats(sd):
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_matches_jax(stepped, step):
    start, jax_states, port, _ = stepped
    (jloss, jsd), (ploss, psd) = jax_states[step], port[step]
    np.testing.assert_allclose(ploss, jloss, rtol=LOSS_RTOL)
    for k, v in _stats(jsd).items():
        np.testing.assert_allclose(psd[k].numpy(), v.numpy(), rtol=RTOL_STATS, atol=1e-6,
                                   err_msg=k)
    weights = [k for k in jsd if not k.endswith(("running_mean", "running_var"))
               and k not in BN_FED]
    if step == 0:  # the schedule's first lr is 0: nothing moves
        for k in weights:
            torch.testing.assert_close(psd[k], start[k], rtol=0, atol=0)
            torch.testing.assert_close(jsd[k], start[k], rtol=0, atol=0)
        return
    # the second step's lr is 2e-4: the update, tensor by tensor
    deltas = [(psd[k].double() - start[k].double(), jsd[k].double() - start[k].double())
              for k in weights]
    for k, (dp, dj) in zip(weights, deltas):
        assert float(dj.norm()) > 0, k
        assert _rel(dp, dj) <= UPDATE_REL, (k, _rel(dp, dj))
    whole = _rel(torch.cat([d.flatten() for d, _ in deltas]),
                 torch.cat([d.flatten() for _, d in deltas]))
    assert whole <= UPDATE_REL_ALL, whole


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def test_default_batch_norm_fails_the_statistics(stepped):
    _, jax_states, _, default = stepped
    jsd, psd = jax_states[0][1], default[0][1]
    worst = max(float(((psd[k] - v).abs() / v.abs().clamp_min(1e-7)).max())
                for k, v in _stats(jsd).items())
    assert worst > 1e-2


def test_cli_writes_an_asset_the_detector_loads(tmp_path):
    out = str(tmp_path / "fallback.npz")
    assert tl.main(["--steps", "2", "--dataset", "66", "--batch", "2", "--features", "16",
                    "--eval-every", "1", "--device", "cpu", "--out", out]) == 0
    sd = load_state_dict_file(out)
    assert all(v.dtype == torch.float16 for v in sd.values())
    assert not any(k.endswith("num_batches_tracked") for k in sd)
    committed = load_state_dict_file(os.path.join(
        REPO, "latentsync_tpu_torch", "utils", "assets", "landmark_fallback.npz"))
    assert {k.split(".")[-1] for k in sd} == {k.split(".")[-1] for k in committed}
    det = FANLandmarkDetector(sd, device="cpu")
    crops = tl.render_dataset(2, seed=5)[0]
    lm = det.landmarks(crops)
    assert lm.shape == (2, 68, 2) and np.isfinite(lm).all()
