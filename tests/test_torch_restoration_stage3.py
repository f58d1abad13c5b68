"""One step of CodeFormer's stage III in the port against the JAX package's
trainer, on the CPU in f32 (``tests/test_torch_restoration_trainer.py``
says how the JAX step is assembled from the trainer's own loss functions,
and the tolerances).

The generated image runs through the whole 512² encoder, generator and
fuse blocks in f32, which the two packages round apart by up to 5e-3 a
pixel (``tests/test_torch_codeformer.py``'s image tolerance), and every
generator and discriminator gradient flows back through it. Measured at
this geometry: the L1 to the GT differs by 1.4e-5 relative; the
generator's gradients by 5.8e-4 in relative L2 over all (up to 2.3e-3 on a
leaf, 5.4e-4 of the largest leaf's norm), the discriminator's by 1.2e-4 —
where stage I at 32² stays under 2e-6. So the losses and metrics are held
to 1e-4 relative here, and the gradients to 5e-3 in relative L2 a leaf
(1e-3 of the largest gradient's norm for one that nearly cancels) and 1e-3
over all.
"""

import jax.numpy as jnp
import torch

from latentsync_tpu.models import codeformer as jcf
from latentsync_tpu.training import restoration_trainer as jrt
from latentsync_tpu_torch.models import codeformer as pcf
from latentsync_tpu_torch.training import restoration_trainer as prt

from test_torch_codeformer import SMALL, random_variables
from test_torch_restoration_trainer import batch_of, port_module, run_gan_stage
from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)


def test_codeformer_stage_iii_matches_jax():
    """w = 1 through every fuse block; the generator path's codes are
    detached, as the JAX model's."""
    jm, jd = jcf.CodeFormer(**SMALL), jcf.VQGANDiscriminator(ndf=8, n_layers=3)
    gv = random_variables(jm, jnp.zeros((1, 512, 512, 3)), seed=5)
    dv = random_variables(jd, jnp.zeros((1, 512, 512, 3)), seed=6)

    def make_port():
        return prt.CodeFormerStageIII(port_module(pcf.CodeFormer(**SMALL), gv),
                                      port_module(pcf.VQGANDiscriminator(ndf=8, n_layers=3), dv),
                                      dtype=torch.float32)

    run_gan_stage(jrt.CodeFormerStageIII(jm, jd), make_port, gv, dv, batch_of(2, 512, n=1),
                  ("l1", "adv"), loss_rtol=1e-4, rel=5e-3, floor=1e-3, overall=1e-3)
