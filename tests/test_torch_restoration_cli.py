"""The port's restoration-training CLIs on the CPU (``--device cpu``):
``train_codeformer`` for each stage, ``train_restoration`` from an option
file and ``generate_latent_gt``, on tiny synthetic face images written
here (FFHQ is not in the repository).

The full-width models are monkeypatched to ``tests/test_torch_codeformer.py``'s
small CodeFormer (``SMALL``, 512²) and a VQGAN of the same 512² geometry
(nf 2, attention at 16² only), as ``tests/test_torch_codeformer_cli.py``
does, so the CLIs run all their code in seconds. Checked: the JSON lines
(every step, with ``train_codeformer.LOG_EVERY`` patched to 1; finite,
the stage's keys), the checkpoint (the generator's weights, loadable
into the model), the option file's
dataset read from an ``.lmdb``, and the ``.npz`` codes of
``generate_latent_gt`` from a JAX ``.npz`` parameter tree, equal to the
JAX model's codes on the same images and their flips.
"""

import copy
import json
import math
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from latentsync_tpu.models import codeformer as jcf
from latentsync_tpu_torch.models import codeformer as pcf
from latentsync_tpu_torch.scripts import generate_latent_gt, train_codeformer, train_restoration
from latentsync_tpu_torch.training import file_client as p_fc
from latentsync_tpu_torch.training import registry as p_reg
from latentsync_tpu_torch.utils import checkpoint as p_ckpt

from test_torch_codeformer import SMALL, random_variables
from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VQ_512 = dict(img_size=512, nf=2, ch_mult=(1, 2, 2, 4, 4, 8), attn_resolutions=(16,),
              codebook_size=16, emb_dim=8)
STAGE_KEYS = {"vqgan": {"l1", "codebook", "adv", "d_real", "d_fake", "g", "d"},
              "code": {"ce", "code_acc"}, "joint": {"l1", "adv", "g", "d"}}


@pytest.fixture
def small_models(monkeypatch):
    # the registries keep what they first hold: fill them with the
    # full-width classes, so that no later test in this process builds a
    # patched one
    p_reg.register_builtin()
    full_cf, full_vq, full_d = pcf.CodeFormer, pcf.VQAutoEncoder, pcf.VQGANDiscriminator
    monkeypatch.setattr(pcf, "CodeFormer", lambda **kw: full_cf(**{**SMALL, **kw}))
    monkeypatch.setattr(pcf, "VQAutoEncoder", lambda **kw: full_vq(**{**VQ_512, **kw}))
    monkeypatch.setattr(pcf, "VQGANDiscriminator",
                        lambda **kw: full_d(**{"ndf": 8, "n_layers": 3, **kw}))


def _faces(root, n=3, size=80):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(7)
    for i in range(n):
        img = np.full((size, size, 3), 70 + 10 * i, np.uint8)
        cv2.ellipse(img, (size // 2, size // 2), (size // 4, size // 3), 0, 0, 360,
                    (190, 150, 130), -1)
        cv2.imwrite(os.path.join(root, f"f{i}.png"),
                    cv2.add(img, rng.integers(0, 30, img.shape, dtype=np.uint8)))
    return root


def _json_lines(out):
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("stage", ["vqgan", "code", "joint"])
def test_train_codeformer_cli(stage, small_models, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(train_codeformer, "LOG_EVERY", 1)
    data = _faces(str(tmp_path / "faces"))
    out = train_codeformer.main(["--stage", stage, "--data-dir", data, "--device", "cpu",
                                 "--max-steps", "2", "--batch-size", "1",
                                 "--output-dir", str(tmp_path / "ck")])
    lines = _json_lines(capsys.readouterr().out)
    assert [line.pop("step") for line in lines] == [1, 2]
    for line, metrics in zip(lines, out["metrics"]):
        assert set(line) == STAGE_KEYS[stage] and line == metrics
        assert all(math.isfinite(v) for v in line.values())
    assert len(out["step_seconds"]) == 2
    saved = p_ckpt.restore_checkpoint(p_ckpt.latest_checkpoint(str(tmp_path / "ck")))
    model = pcf.VQAutoEncoder() if stage == "vqgan" else pcf.CodeFormer()
    model.load_state_dict(saved["params"])
    assert saved["step"] == 2


def test_train_restoration_cli_reads_an_lmdb(small_models, tmp_path, capsys):
    """``options/codeformer_stage2.yaml`` as it ships but for its data root
    (an ``.lmdb`` of the synthetic faces), its batch and the net's widths
    (``SMALL``, written into the options: the registry may hold the
    unpatched class); the EMA checkpoint at the end."""
    data = _faces(str(tmp_path / "faces"))
    names = sorted(os.listdir(data))
    db = str(tmp_path / "ffhq.lmdb")
    p_fc.make_lmdb_from_imgs(data, db, names, [n[:-4] for n in names])
    with open(os.path.join(REPO, "options", "codeformer_stage2.yaml")) as f:
        opt = yaml.safe_load(f)
    opt = copy.deepcopy(opt)
    opt["datasets"]["train"]["dataroot_gt"] = db
    opt["datasets"]["train"]["batch_size_per_gpu"] = 1
    opt["network_g"] = {"type": "CodeFormer", **{k: list(v) if isinstance(v, tuple) else v
                                                for k, v in SMALL.items()}}
    path = str(tmp_path / "stage2.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    out = train_restoration.main(["-opt", path, "--max-steps", "2", "--log-every", "1",
                                  "--device", "cpu", "--seed", "3",
                                  "--output-dir", str(tmp_path / "ck")])
    lines = _json_lines(capsys.readouterr().out)
    assert [line["step"] for line in lines] == [1, 2]
    assert all(math.isfinite(line["ce"]) and 0 <= line["code_acc"] <= 1 for line in lines)
    saved = p_ckpt.restore_checkpoint(p_ckpt.latest_checkpoint(str(tmp_path / "ck")))
    for k, v in out["ema_params"].items():
        assert torch.equal(saved["params"][k], v)


def test_generate_latent_gt_matches_the_jax_codes(small_models, tmp_path):
    """A JAX ``.npz`` parameter tree of the 512² VQGAN (seeded non-zero
    variables), read through the converter: the codes of every image and
    its flip equal the JAX model's."""
    data = _faces(str(tmp_path / "faces"), n=2, size=96)
    jm = jcf.VQAutoEncoder(**VQ_512)
    variables = random_variables(jm, jnp.zeros((1, 512, 512, 3)), seed=8)
    flat = {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(variables["params"])[0]}
    ckpt = str(tmp_path / "vqgan.npz")
    np.savez(ckpt, **flat)
    path = generate_latent_gt.main(["-i", data, "-o", str(tmp_path / "codes"), "--codebook_size",
                                    "16", "--ckpt_path", ckpt, "--device", "cpu"])
    got = np.load(path)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    apply = jax.jit(lambda x: jm.apply(jvars, x)[2])
    for name in ("f0", "f1"):
        img = cv2.cvtColor(cv2.imread(os.path.join(data, f"{name}.png")), cv2.COLOR_BGR2RGB)
        img = cv2.resize(img, (512, 512))
        for flip, x in (("orig", img), ("hflip", img[:, ::-1])):
            want = np.asarray(apply(jnp.asarray(x[None].astype(np.float32) / 255.0 * 2 - 1)))
            np.testing.assert_array_equal(got[f"{flip}/{name}"], want.reshape(16, 16))
