"""The port's restoration CLIs on the CPU (``--device cpu``).

``inference_codeformer`` (two PNGs and an 8-frame ``.mp4``), the
``.pth`` and ``.npz`` checkpoints it reads, ``inference_vqgan``,
``inference_colorization``, ``inference_inpainting`` and
``crop_align_face``. The models' constructors are monkeypatched to small
configurations (``tests/test_torch_codeformer.py``'s), so the CLIs run
their full code at a few seconds each; the outputs must exist with the
input's shape. The model forwards themselves are held against the JAX
package in ``tests/test_torch_codeformer.py``.
"""

import functools
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.models import codeformer as jcf
from latentsync_tpu_torch.models import codeformer as pcf
from latentsync_tpu_torch.scripts import crop_align_face, inference_codeformer
from latentsync_tpu_torch.scripts import inference_colorization, inference_inpainting
from latentsync_tpu_torch.scripts import inference_vqgan
from latentsync_tpu_torch.utils import convert as pconv

from test_torch_codeformer import SMALL, random_variables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small tensors: about as fast
    alone, and the parallel test workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_models(monkeypatch):
    full = pcf.CodeFormer
    monkeypatch.setattr(pcf, "CodeFormer", lambda **kw: full(**{**SMALL, **kw}))
    monkeypatch.setattr(pcf, "VQAutoEncoder", functools.partial(
        pcf.VQAutoEncoder, img_size=32, nf=8, ch_mult=(1, 2), codebook_size=16, emb_dim=16))


def _face(seed, h, w):
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 90, np.uint8)
    cv2.ellipse(img, (w // 2, h // 2), (w // 5, h // 3), 0, 0, 360, (200, 160, 140), -1)
    return cv2.add(img, rng.integers(0, 20, img.shape, dtype=np.uint8))


def _write_images(root, shapes):
    os.makedirs(root, exist_ok=True)
    for i, (h, w) in enumerate(shapes):
        cv2.imwrite(os.path.join(root, f"f{i}.png"), _face(i, h, w))


def test_codeformer_cli_images_and_video(small_models, tmp_path):
    src = str(tmp_path / "in")
    _write_images(src, [(120, 160), (144, 112)])
    inference_codeformer.main(["--input", src, "--out", str(tmp_path / "out"), "--device",
                               "cpu", "--ckpt", ""])
    for name, shape in (("f0.png", (120, 160, 3)), ("f1.png", (144, 112, 3))):
        out = cv2.imread(str(tmp_path / "out" / name))
        assert out is not None and out.shape == shape
        assert not np.array_equal(out, cv2.imread(os.path.join(src, name)))  # a face was pasted
    video = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 25, (96, 80))
    for i in range(8):
        writer.write(_face(10 + i, 80, 96))
    writer.release()
    inference_codeformer.main(["--input", video, "--out", str(tmp_path / "vout"), "--device",
                               "cpu", "-w", "1.0", "--ckpt", ""])
    cap = cv2.VideoCapture(str(tmp_path / "vout" / "clip.mp4"))
    frames = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        frames.append(fr)
    assert len(frames) == 8 and frames[0].shape == (80, 96, 3)


def test_codeformer_checkpoints_load(small_models, tmp_path):
    """A released-layout ``.pth`` (``params_ema`` wrapper) and an ``.npz`` of
    the JAX package's tree give the same weights, carried from the JAX
    parameters; the CLI's bf16 model keeps them (norms in f32)."""
    variables = random_variables(jcf.CodeFormer(**SMALL), jnp.zeros((1, 512, 512, 3)), seed=11)
    sd = pconv.codeformer_state_dict_from_flax(variables)
    pth, npz = str(tmp_path / "cf.pth"), str(tmp_path / "cf.npz")
    torch.save({"params_ema": sd}, pth)
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(variables["params"])[0]}
    np.savez(npz, **flat)
    for path in (pth, npz):
        loaded = pconv.load_state_dict_file(path, pconv.codeformer_state_dict_from_flax)
        assert set(loaded) == set(sd)
        for k in sd:
            torch.testing.assert_close(torch.as_tensor(loaded[k]), sd[k], rtol=0, atol=0)
        model = inference_codeformer.build_codeformer(path, torch.device("cpu"))
        assert model.position_emb.dtype == torch.bfloat16
        assert model.idx_pred_layer[0].weight.dtype == torch.float32
        torch.testing.assert_close(model.position_emb.float(),
                                   sd["position_emb"].to(torch.bfloat16).float())


def test_vqgan_colorization_and_inpainting_clis(small_models, tmp_path):
    src = str(tmp_path / "in")
    _write_images(src, [(64, 80)])
    inference_vqgan.main(["-i", src, "-o", str(tmp_path / "rec"), "--codebook_size", "16",
                          "--device", "cpu"])
    rec = cv2.imread(str(tmp_path / "rec" / "f0_rec.png"))
    assert rec is not None and rec.shape == (32, 32, 3)
    face = os.path.join(src, "f0.png")
    inference_colorization.main(["--input", face, "--out", str(tmp_path / "color"),
                                 "--device", "cpu", "--ckpt", ""])
    out = cv2.imread(str(tmp_path / "color" / "f0.png"))
    assert out is not None and out.shape == (512, 512, 3)
    mask = np.zeros((64, 80), np.uint8)
    mask[30:50, 20:60] = 255
    cv2.imwrite(str(tmp_path / "mask.png"), mask)
    inference_inpainting.main(["--input", face, "--out", str(tmp_path / "inpaint"),
                               "--mask", str(tmp_path / "mask.png"), "--device", "cpu",
                               "--ckpt", ""])
    out = cv2.imread(str(tmp_path / "inpaint" / "f0.png"))
    img = cv2.resize(cv2.imread(face), (512, 512))
    keep = cv2.resize(mask, (512, 512)) == 0
    assert out.shape == (512, 512, 3) and np.array_equal(out[keep], img[keep])
    assert not np.array_equal(out[~keep], img[~keep])


def test_crop_align_face_cli(tmp_path):
    src = str(tmp_path / "in")
    _write_images(src, [(160, 128), (128, 160)])
    crop_align_face.main(["-i", src, "-o", str(tmp_path / "out"), "--output_size", "64",
                          "--transform_size", "128", "--device", "cpu"])
    for name in ("f0.png", "f1.png"):
        out = cv2.imread(str(tmp_path / "out" / name))
        assert out is not None and out.shape == (64, 64, 3)
