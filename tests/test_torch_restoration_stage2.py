"""One step of CodeFormer's stage II in the port against the JAX package's
trainer, on the CPU in f32 (``tests/test_torch_restoration_trainer.py``
says how the JAX step is assembled from the trainer's own loss functions,
and the tolerances).

Stage II's gradients flow from the cross-entropy through the transformer
into the whole 512² encoder, whose f32 forward (GroupNorms of one or two
channels over 262,144 pixels) the two packages round apart; the
transformer amplifies the difference: measured at this geometry, 9e-5 in
relative L2 over all gradients and up to 6.4e-4 on a single leaf (the first
GroupNorm scales), where stages I and III stay under 2e-6. So stage II's
gradients are held to 1e-3 in relative L2 a leaf (1e-4 of the largest
gradient's norm for one that nearly cancels) and 2e-4 over all; the
losses, the accuracy and the target codes as the other stages.
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

from test_torch_codeformer import SMALL, random_variables
from test_torch_restoration_trainer import (LR, assert_grads_close, assert_metrics_close,
                                            assert_params_within_lr, batch_of, closure,
                                            jax_update, port_module)
from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)


def test_codeformer_stage_ii_matches_jax():
    """The target codes are the current encoder's and quantizer's on the GT,
    index for index; the cross-entropy, its accuracy and every gradient
    (the generator's and the fuse blocks' are zero: the code-only forward
    does not reach them) match; then one step."""
    jm = jcf.CodeFormer(**SMALL)
    gv = random_variables(jm, jnp.zeros((1, 512, 512, 3)), seed=3)
    batch = batch_of(1, 512, n=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = optax.adam(LR)
    vg = jax.jit(jax.value_and_grad(closure(jrt.CodeFormerStageII(jm).make_step(tx))["loss_fn"],
                                    has_aux=True))
    (loss, metrics), grads = vg(gv, jb)

    def make_port():
        return prt.CodeFormerStageII(port_module(pcf.CodeFormer(**SMALL), gv),
                                     dtype=torch.float32)

    z = jm.apply(gv, jb["gt"], method=lambda m, x: m.encoder(x))
    want_idx = np.asarray(jm.apply(gv, z, method=lambda m, zz: m.quantize(zz))[2]).reshape(1, -1)
    trainer = make_port()
    got_idx = trainer.target_codes(torch.from_numpy(batch["gt"]).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    got_loss, got_metrics = trainer.loss(batch)
    got_loss.backward()
    trainer.g.zero_missing_grads()
    assert_metrics_close(got_metrics, metrics)
    assert_grads_close(trainer.g, grads, rel=1e-3, floor=1e-4, overall=2e-4)
    assert not trainer.g.leaves["generator.blocks.0.weight"].grad.any()

    trainer = make_port()
    step = trainer.make_step(torch.optim.Adam(trainer.g.leaves.values(), lr=LR, eps=1e-8))
    assert_metrics_close(step(batch), metrics)
    assert_params_within_lr(trainer.g, jax_update(tx, grads, gv))
