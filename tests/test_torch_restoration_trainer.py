"""One step of the port's VQGAN stage against the JAX package's trainer, on
the CPU in f32, and the helpers the stage-II and stage-III files share.

The JAX loss functions are the trainers' own (``g_loss_fn`` / ``d_loss_fn``
of ``VQGANTrainer.make_steps`` and ``CodeFormerStageIII.make_step``,
``loss_fn`` of ``CodeFormerStageII.make_step``, taken from the step's
closure) under ``jax.value_and_grad``; the JAX step is then assembled from
them as its ``train_step`` does (the generator's optax update, then the
discriminator's loss at the updated generator). The models are
``tests/test_torch_codeformer.py``'s small geometry — ``VQ_SMALL`` (32²),
``SMALL`` (CodeFormer at 512² with nf 2, two layers of 8-wide heads) and
``VQGANDiscriminator(ndf=8, n_layers=3)`` — with seeded non-zero variables
carried into the port by ``codeformer_state_dict_from_flax``, the batch
from a numpy seed.

Tolerances (f32, the two packages sum in other orders): losses and metrics
1e-5 relative; every gradient 1e-4 in relative L2, where a gradient that is
zero in exact arithmetic (a bias before a one-channel GroupNorm, a key
bias under a softmax) is held instead to 1e-5 of the largest gradient's
norm, and all gradients together to 1e-5 in relative L2 (stage II states
its own, looser bounds and why). Adam's first
update is lr · g / (|g| + eps), so where |g| is near eps a rounding flips a
whole lr: parameters after the step are held to 2 lr; the discriminator's
metrics, taken after the generator's update, to 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from latentsync_tpu.models import codeformer as jcf
from latentsync_tpu.training import restoration_trainer as jrt
from latentsync_tpu_torch.models import codeformer as pcf
from latentsync_tpu_torch.training import restoration_trainer as prt
from latentsync_tpu_torch.utils import convert as pconv

from test_torch_codeformer import VQ_SMALL, random_variables
from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)

LR = 1e-4
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
ZERO_GRAD_FRAC = 1e-5
STEP_METRIC_RTOL = 1e-4


def closure(step):
    """The free variables of a JAX trainer's jitted step: its loss functions."""
    fn = getattr(step, "__wrapped__", step)
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


def port_module(module, variables):
    module.load_state_dict(pconv.codeformer_state_dict_from_flax(variables))
    return module


def as_port(tree):
    """A JAX gradient or parameter tree as numpy arrays under the port's names."""
    return {k: v.numpy() for k, v in pconv.codeformer_state_dict_from_flax(tree).items()
            if v.is_floating_point()}


def assert_grads_close(net, jax_grads, rel=GRAD_REL_L2, floor=ZERO_GRAD_FRAC,
                       overall=ZERO_GRAD_FRAC):
    want = as_port(jax_grads)
    got = {k: t.grad.numpy() for k, t in net.leaves.items()}
    assert set(got) == set(want)
    scale = max(np.linalg.norm(w) for w in want.values())
    diff2 = total2 = 0.0
    for k, w in want.items():
        err = np.linalg.norm(got[k] - w)
        diff2, total2 = diff2 + err**2, total2 + np.linalg.norm(w) ** 2
        assert err <= max(rel * np.linalg.norm(w), floor * scale), k
    assert np.sqrt(diff2 / total2) <= overall


def assert_metrics_close(got, want, rtol=LOSS_RTOL):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=rtol, atol=1e-7, err_msg=k)


def assert_params_within_lr(net, jax_params):
    want = as_port(jax_params)
    for k, t in net.leaves.items():
        assert float(np.abs(t.detach().numpy() - want[k]).max()) <= 2 * LR * (1 + 1e-3), k


def as_torch(arrays):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}


def jax_update(tx, grads, params):
    updates, _ = tx.update(grads, tx.init(params), params)
    return optax.apply_updates(params, updates)


def batch_of(seed, size, n=2):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
    lq = np.clip(gt + 0.3 * rng.standard_normal(gt.shape), -1, 1).astype(np.float32)
    return {"gt": gt, "lq": lq}


def run_gan_stage(jtrainer, make_port, gv, dv, batch, jkeys, loss_rtol=LOSS_RTOL, **grad_tol):
    """The generator / discriminator losses and gradients of a GAN stage
    (I or III) at the first parameters (gv, dv), then one step of each
    package; the port's discriminator metrics must be those of the
    generator its own step has updated."""
    g_tx, d_tx = optax.adam(LR), optax.adam(LR)
    fns = closure(jtrainer.make_step(g_tx, d_tx) if hasattr(jtrainer, "make_step")
                  else jtrainer.make_steps(g_tx, d_tx))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    g_vg = jax.jit(jax.value_and_grad(fns["g_loss_fn"], has_aux=True))
    d_vg = jax.jit(jax.value_and_grad(fns["d_loss_fn"], has_aux=True))
    (gl, gm), gg = g_vg(gv, dv, jb)
    (dl, dm), dg = d_vg(dv, gv, jb)

    trainer = make_port()
    loss, metrics = trainer.g_loss(batch)
    loss.backward()
    trainer.g.zero_missing_grads()  # as jax.grad: zeros where the loss does not reach
    assert_metrics_close({"g": loss, **metrics}, {"g": gl, **gm}, loss_rtol)
    assert_grads_close(trainer.g, gg, **grad_tol)
    loss, metrics = trainer.d_loss(batch)
    loss.backward()
    assert_metrics_close({"d": loss, **metrics}, {"d": dl, **dm}, loss_rtol)
    assert_grads_close(trainer.d, dg, **grad_tol)

    trainer = make_port()
    g_opt = torch.optim.Adam(trainer.g.leaves.values(), lr=LR, eps=1e-8)
    d_opt = torch.optim.Adam(trainer.d.leaves.values(), lr=LR, eps=1e-8)
    step = (trainer.make_steps if hasattr(trainer, "make_steps") else trainer.make_step)(
        g_opt, d_opt)
    got = step(batch)
    gv1 = jax_update(g_tx, gg, gv)
    (dl1, dm1), dg1 = d_vg(dv, gv1, jb)
    want = {**{k: gm[k] for k in jkeys}, **dm1, "g": gl, "d": dl1}
    assert_metrics_close({k: got[k] for k in ("g", *jkeys)}, {k: want[k] for k in ("g", *jkeys)},
                         loss_rtol)
    assert_metrics_close(got, want, max(loss_rtol, STEP_METRIC_RTOL))
    assert_params_within_lr(trainer.g, gv1)
    assert_params_within_lr(trainer.d, jax_update(d_tx, dg1, dv))
    # the step's discriminator loss is that of the generator as the step left it,
    # evaluated before the discriminator's own update
    trainer.d.module.load_state_dict(as_torch(as_port(dv)), strict=False)
    with torch.no_grad():
        np.testing.assert_allclose(got["d"], float(trainer.d_loss(batch)[0]), rtol=1e-6)
    return got


def test_vqgan_stage_matches_jax():
    jm, jd = jcf.VQAutoEncoder(**VQ_SMALL), jcf.VQGANDiscriminator(ndf=8, n_layers=3)
    gv = random_variables(jm, jnp.zeros((1, 32, 32, 3)), seed=1)
    dv = random_variables(jd, jnp.zeros((1, 32, 32, 3)), seed=2)
    assert "batch_stats" in dv  # trained by the JAX step, and by the port's

    def make_port():
        return prt.VQGANTrainer(port_module(pcf.VQAutoEncoder(**VQ_SMALL), gv),
                                port_module(pcf.VQGANDiscriminator(ndf=8, n_layers=3), dv),
                                dtype=torch.float32)

    got = run_gan_stage(jrt.VQGANTrainer(jm, jd), make_port, gv, dv, batch_of(0, 32),
                        ("l1", "codebook", "adv"))
    assert {"d_real", "d_fake"} <= set(got)


def test_validate_matches_jax():
    """``option_trainer.validate``: the net on each lq, PSNR / SSIM of its
    first output against gt, averaged, as the JAX function computes them
    (f32: 1e-4 relative)."""
    from latentsync_tpu.training.option_trainer import validate as j_validate
    from latentsync_tpu_torch.training.option_trainer import validate as p_validate

    jm = jcf.VQAutoEncoder(**VQ_SMALL)
    gv = random_variables(jm, jnp.zeros((1, 32, 32, 3)), seed=7)
    port = port_module(pcf.VQAutoEncoder(**VQ_SMALL), gv).eval()
    rng = np.random.default_rng(4)
    pairs = [tuple(rng.uniform(-1, 1, (32, 32, 3)).astype(np.float32) for _ in range(2))
             for _ in range(2)]
    want = j_validate(jax.tree_util.tree_map(jnp.asarray, gv), jm, pairs)
    got = p_validate(None, port, pairs)
    assert set(got) == set(want) == {"psnr", "ssim"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    sd = {k: v * 0.5 if v.is_floating_point() else v for k, v in port.state_dict().items()}
    assert p_validate(sd, port, pairs)["psnr"] != got["psnr"]  # the given weights are used
