"""The port's ``OptionTrainer`` against the JAX package's, from each shipped
option file, on the CPU in f32 (the two CodeFormer stages' files in
``tests/test_torch_option_trainer_codeformer.py``).

Each of ``options/{vqgan_stage1,codeformer_stage2,codeformer_stage3}.yaml``
with its network widths overridden to ``tests/test_option_trainer.py``'s
tiny size (``_tiny``: 32² images) builds the same generator and
discriminator in both packages: the JAX trainer's own initial parameter
tree, through ``codeformer_state_dict_from_flax``, has exactly the port
networks' keys and loads into them. From those weights and the same
batches (``batch_fn``, numpy) both run two steps with the options'
optimizers, schedule and EMA; the JSON lines of both steps must agree
(1e-5 relative on the first step, 1e-4 on the second, which follows
Adam's first update: lr · g / (|g| + eps) flips a whole lr where |g| is
near eps), and the EMA the port's checkpoint holds must round-trip into a
fresh network and stay within 2 lr of the JAX trainer's EMA.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from latentsync_tpu.training import option_trainer as j_ot
from latentsync_tpu_torch.training import option_trainer as p_ot
from latentsync_tpu_torch.utils import checkpoint as p_ckpt
from latentsync_tpu_torch.utils import convert as pconv

from test_option_trainer import _tiny
from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_RTOL = (1e-5, 1e-4)


def _batch_fn(img=32):
    def fn(step):
        rng = np.random.default_rng(100 + step)
        gt = rng.uniform(-1, 1, (2, img, img, 3)).astype(np.float32)
        return {"gt": gt, "lq": (gt * 0.8).astype(np.float32)}

    return fn


@pytest.mark.parametrize("name", ["vqgan_stage1"])
def test_option_trainer_matches_jax(name, tmp_path):
    """``options/vqgan_stage1.yaml`` (the CodeFormer stages:
    ``tests/test_torch_option_trainer_codeformer.py``, so that each file
    stays near 30 s)."""
    check_option_file(name, tmp_path)


def check_option_file(name, tmp_path):
    opt = _tiny(p_ot.parse_options(f"{REPO}/options/{name}.yaml"))
    j_lines, p_lines = [], []
    jt = j_ot.OptionTrainer(copy.deepcopy(opt), data_source=object(), log_fn=j_lines.append)
    g0, d0 = jt._init_params(int(opt["manual_seed"]), 32)
    pt = p_ot.OptionTrainer(copy.deepcopy(opt), data_source=object(), log_fn=p_lines.append,
                            device="cpu")
    init = [pconv.codeformer_state_dict_from_flax(v) for v in (g0, d0)]
    for sd, net in zip(init, (pt.net_g, pt.net_d)):
        # every key but batch norm's step counter, torch's own bookkeeping
        assert set(sd) == {k for k in net.state_dict() if not k.endswith("num_batches_tracked")}
        net.load_state_dict(sd)
    j_out = jt.run(max_steps=2, img_size=32, log_every=1, batch_fn=_batch_fn())
    p_out = pt.run(max_steps=2, img_size=32, log_every=1, batch_fn=_batch_fn(),
                   output_dir=str(tmp_path / "ck"))

    assert len(j_lines) == len(p_lines) == 2
    for rtol, jl, pl in zip(STEP_RTOL, j_lines, p_lines):
        want, got = json.loads(jl), json.loads(pl)
        assert got.pop("step") == want.pop("step")
        del got["iters_per_sec"], want["iters_per_sec"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-7, err_msg=k)

    lr = opt["train"]["optim_g"]["lr"]
    ema = p_out["ema_params"]
    want = pconv.codeformer_state_dict_from_flax(j_out["ema_params"])
    for k, v in ema.items():
        assert float((v - want[k]).abs().max()) <= 2 * lr * (1 + 1e-3), k
    saved = p_ckpt.restore_checkpoint(p_ckpt.latest_checkpoint(str(tmp_path / "ck")))
    assert saved["step"] == 2 and set(saved["params"]) == set(ema)
    fresh = p_ot.OptionTrainer(copy.deepcopy(opt), data_source=object(), device="cpu").net_g
    fresh.load_state_dict(saved["params"])
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, ema[k]), k
