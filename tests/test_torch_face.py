"""The port's face path against the JAX package, on the CPU in float32.

The FAN (two modules of width 32 on 64² inputs, and the packaged one-module
fallback), S3FD (128² input) and their decoders, with random non-zero
weights and batch-norm statistics made from a numpy seed in the JAX
package's layout and carried into the port by ``utils/convert.py``'s
inverses; the two-pass ``detect_batch``; box decoding and NMS; the
host geometry of ``utils/face.py``; every mask mode; and the resizes, which
must equal OpenCV's as the JAX package calls it. Inputs are transposed at
the boundary: the JAX package is channels-last, the port NCHW.

Tolerances: network outputs within 1e-4 relative to their largest value
(f32 on both sides, sums in another order); landmarks within 1e-3 px (the
±0.25 px refinement compares neighbouring heatmap values, which agree far
closer than their gaps); host geometry and masks exactly, or to 1e-9 for
float64 geometry. The fallback asset holds float16 weights: the JAX
package then runs some of its arithmetic in float16, so parity uses the
asset cast to float32 on the JAX side, and the fallback's accuracy on
rendered faces is held to the reference test's NME 0.08.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.models import face_detection as jfd
from latentsync_tpu.training.synthetic_faces import render_face
from latentsync_tpu.utils import face as jface
from latentsync_tpu.utils import image_processor as jip
from latentsync_tpu.utils.checkpoint import load_pytree
from latentsync_tpu_torch.models import face_detection as pfd
from latentsync_tpu_torch.utils import convert as pconv
from latentsync_tpu_torch.utils import face as pface
from latentsync_tpu_torch.utils import image_processor as pip_

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ASSET = os.path.join(ROOT, "latentsync_tpu", "utils", "assets", "landmark_fallback.npz")
REL = 1e-4
LM_TOL = 1e-3


def _random_variables(model, x, seed: int):
    """The model's variables with every leaf replaced by seeded non-zero
    values: kernels N(0, 1/fan_in), biases N(0, 0.02²), norm scales
    1 + N(0, 0.1²), running means N(0, 0.1²), running variances
    1 + |N(0, 0.3²)|."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = 1 + 0.1 * rng.standard_normal(shape)
        elif name == "mean":
            v = 0.1 * rng.standard_normal(shape)
        elif name == "var":
            v = 1 + np.abs(0.3 * rng.standard_normal(shape))
        elif name == "weight":  # S3FD's L2Norm scales
            v = 5 + rng.standard_normal(shape)
        else:
            v = 0.02 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = float(np.abs(got - ref).max())
    assert err <= rel * max(1.0, float(np.abs(ref).max())), err


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def fan_pair():
    """A two-module FAN of width 32 on both sides, the same random weights."""
    model = jfd.FAN2D(num_modules=2, features=32)
    variables = _random_variables(model, jnp.zeros((1, 64, 64, 3)), seed=3)
    sd = pconv.fan_state_dict_from_flax(variables)
    port = pfd.FAN2D(*pfd.fan_shape(sd))
    pfd._load(port, sd)
    return model, variables, port.eval(), sd


def test_fan_forward_matches_jax(fan_pair):
    model, variables, port, sd = fan_pair
    assert pfd.fan_shape(sd) == (2, 32)
    x = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)
    ref = jax.jit(model.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(_nchw(x))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert tuple(g.shape) == (2, 68, 16, 16)
        _close(_nhwc(g), r)


def test_fan_state_dict_has_the_face_alignment_names(fan_pair):
    """The converted names are 2DFAN4's (face_alignment): a .pth of that
    package loads as it is."""
    _, _, port, sd = fan_pair
    for key in ("conv1.weight", "bn1.running_var", "conv2.downsample.0.weight",
                "conv2.downsample.2.weight", "m0.b1_4.conv1.weight", "m0.b2_plus_1.bn3.bias",
                "m1.b3_2.bn1.running_mean", "top_m_0.conv3.weight", "conv_last1.bias",
                "bn_end0.weight", "l1.weight", "bl0.weight", "al0.bias"):
        assert key in sd, key
    expected = {k for k in port.state_dict() if not k.endswith("num_batches_tracked")}
    assert set(sd) == expected


def _heatmaps(seed: int):
    """Random heatmaps with exact ties (the first maximum must win), maxima
    on every edge and in the corners (no refinement there), and equal
    neighbours (a refinement of 0)."""
    rng = np.random.default_rng(seed)
    heat = rng.standard_normal((3, 64, 64, 68)).astype(np.float32)
    heat[0, 10, 20, 0] = heat[0, 30, 5, 0] = 9.0  # a tie: (20, 10) comes first
    heat[0, 10, 19, 0] = heat[0, 10, 21, 0] = heat[0, 9, 20, 0] = heat[0, 11, 20, 0] = 1.0
    heat[0, 40, 40, 1] = 9.0
    heat[0, 40, 39, 1] = heat[0, 40, 41, 1] = 1.0  # equal x neighbours: dx = 0
    heat[1, 0, 17, 2] = 9.0   # top edge
    heat[1, 63, 2, 3] = 9.0   # bottom edge
    heat[1, 33, 0, 4] = 9.0   # left edge
    heat[1, 12, 63, 5] = 9.0  # right edge
    heat[2, 0, 0, 6] = 9.0    # a corner
    heat[2, 63, 63, 7] = heat[2, 63, 62, 7] = 9.0  # a tie on the bottom edge
    return heat


def test_heatmap_decoders_match_jax_with_ties_and_edges():
    """The port's one decoder (on the device) against both of the JAX
    package's, the device one and the numpy one, exactly."""
    heat = _heatmaps(1)
    j_dev = np.asarray(jfd.decode_heatmaps_device(jnp.asarray(heat)))
    j_host = jfd.heatmaps_to_landmarks(heat)
    p_dev = pfd.decode_heatmaps_device(_nchw(heat)).numpy()
    np.testing.assert_array_equal(p_dev, j_dev)
    np.testing.assert_array_equal(p_dev, j_host)
    assert tuple(p_dev[0, 0]) == ((20 + 0.5) * 4, (10 + 0.5) * 4)
    assert tuple(p_dev[0, 1]) == ((40 + 0.5) * 4, (40 + 0.25 * np.sign(
        heat[0, 41, 40, 1] - heat[0, 39, 40, 1]) + 0.5) * 4)
    assert tuple(p_dev[2, 6]) == (2.0, 2.0)


def _detectors(variables, sd, box_stage: bool):
    jbox = jfd.HaarBoxDetector() if box_stage else None
    pbox = pfd.HaarBoxDetector() if box_stage else None
    return (jfd.FANLandmarkDetector(variables, face_detector=jbox),
            pfd.FANLandmarkDetector(sd, face_detector=pbox, device="cpu"))


def _faces_clip(n: int, seed: int, hw=(240, 320)):
    """Rendered faces pasted into larger frames, moving a little."""
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        img, _ = render_face(rng, 160)
        frame = np.full(hw + (3,), 90, np.uint8)
        y, x = 30 + i % 3, 70 + 2 * (i % 5)
        frame[y:y + 160, x:x + 160] = img
        frames.append(frame)
    return frames


def test_detect_batch_matches_jax():
    """Both passes (the first on a stride subsample, the second at the median
    consensus box) behind the Haar box stage, on a clip of 9 frames; one
    frame alone through ``__call__``."""
    model256 = jfd.FAN2D(num_modules=1, features=16)
    variables = _random_variables(model256, jnp.zeros((1, 256, 256, 3)), seed=3)
    sd = pconv.fan_state_dict_from_flax(variables)
    jdet, pdet = _detectors(variables, sd, True)
    frames = _faces_clip(9, 5)
    got = pdet.detect_batch(frames)
    ref = jdet.detect_batch(frames)
    assert got.shape == (9, 68, 2)
    np.testing.assert_allclose(got, ref, atol=LM_TOL)
    np.testing.assert_allclose(pdet(frames[3]), jdet(frames[3]), atol=LM_TOL)


def test_port_fan_runs_unpadded_chunks(fan_pair, monkeypatch):
    """Chunks of at most CHUNK crops, unpadded: a crop's landmarks do not
    depend on the chunk it rides in."""
    _, _, _, sd = fan_pair
    det = pfd.FANLandmarkDetector(sd, device="cpu")
    crops = np.random.default_rng(2).integers(0, 255, (3, 256, 256, 3)).astype(np.uint8)
    whole = det.landmarks(crops)
    monkeypatch.setattr(det, "CHUNK", 2)
    np.testing.assert_allclose(det.landmarks(crops), whole, atol=1e-4)
    np.testing.assert_allclose(det.landmarks(crops[2:3])[0], whole[2], atol=1e-4)


def test_s3fd_matches_jax():
    model = jfd.S3FD()
    variables = _random_variables(model, jnp.zeros((1, 96, 96, 3)), seed=4)
    sd = pconv.s3fd_state_dict_from_flax(variables)
    port = pfd.S3FD()
    assert set(sd) == set(port.state_dict())
    pfd._load(port, sd)
    x = (np.random.default_rng(1).random((1, 96, 96, 3)) * 255 - 117).astype(np.float32)
    j_cls, j_box = jax.jit(model.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        p_cls, p_box = port(_nchw(x))
    assert len(p_cls) == len(p_box) == 6
    for g, r in zip(p_cls + p_box, list(j_cls) + list(j_box)):
        _close(_nhwc(g), r)
    # the whole detector: anchors, decoding, NMS
    jdet = jfd.S3FDDetector(variables)
    pdet = pfd.S3FDDetector(sd, device="cpu")
    img = x[0].astype(np.uint8)
    for thresh in (0.3, 0.5):
        got, ref = pdet.detect(img, thresh), jdet.detect(img, thresh)
        assert got.shape == ref.shape and len(got) > 0
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


def test_box_utilities_match_jax():
    rng = np.random.default_rng(0)
    loc = rng.standard_normal((50, 4)).astype(np.float32)
    priors = np.abs(rng.standard_normal((50, 4))).astype(np.float32) * 50
    np.testing.assert_array_equal(pfd.decode_boxes(loc, priors), jfd.decode_boxes(loc, priors))
    xy = rng.random((60, 2)) * 200
    boxes = np.concatenate([xy, xy + 20 + rng.random((60, 2)) * 60], 1)
    scores = rng.random(60)
    for thresh in (0.1, 0.3, 0.7):
        assert pfd.nms(boxes, scores, thresh) == jfd.nms(boxes, scores, thresh)


def test_similarity_smoother_and_anchors_match_jax():
    rng = np.random.default_rng(1)
    template = np.array([[17.0, 20.0], [58.0, 20.0], [37.5, 40.0]]) * 2.8
    pj = pp = None
    sj, sp = jface.LandmarkSmoother(), pface.LandmarkSmoother()
    for i in range(6):
        src = template * (0.5 + rng.random()) + rng.standard_normal((3, 2)) * 3 + 40
        mj, pj = jface.similarity_from_points(src, template, True, pj)
        mp, pp = pface.similarity_from_points(src, template, True, pp)
        np.testing.assert_allclose(mp, mj, atol=1e-9)
        np.testing.assert_allclose(pp, pj, atol=1e-9)
        lm = rng.standard_normal((68, 2)) * 30 + 100 + i
        np.testing.assert_allclose(sp(lm), sj(lm), atol=1e-9)
        np.testing.assert_array_equal(pface.landmarks68_to_anchor3(lm),
                                      jface.landmarks68_to_anchor3(lm))
    same = np.full((3, 2), 7.0)  # degenerate anchors: a translation, no NaN
    np.testing.assert_array_equal(pface.similarity_from_points(same, template)[0],
                                  jface.similarity_from_points(same, template)[0])


def test_align_restore_matches_jax():
    rng = np.random.default_rng(2)
    frame = rng.integers(0, 255, (240, 320, 3), dtype=np.uint8)
    anchors = np.array([[120.0, 90.0], [190.0, 95.0], [152.0, 130.0]])
    aj, ap = jface.AlignRestore(), pface.AlignRestore()
    for shift in (0.0, 1.5):
        fj, mj = aj.align_warp_face(frame, anchors + shift)
        fp, mp = ap.align_warp_face(frame, anchors + shift)
        np.testing.assert_array_equal(fp, fj)
        np.testing.assert_array_equal(mp, mj)
    assert fp.shape == (280, 210, 3)
    face = rng.integers(0, 255, fp.shape, dtype=np.uint8)
    np.testing.assert_array_equal(ap.restore_img(frame, face, mp),
                                  aj.restore_img(frame, face, mj))


def test_haar_detectors_match_jax():
    """The same branch on both sides (one OpenCV build): cascade boxes where
    it ships one, else the static heuristic."""
    for img in [np.zeros((240, 320, 3), np.uint8)] + _faces_clip(2, 9):
        hj, hp = jface.HaarAnchorDetector(), pface.HaarAnchorDetector()
        assert (hp.cascade is None) == (hj.cascade is None)
        np.testing.assert_array_equal(hp(img), hj(img))
        np.testing.assert_array_equal(pfd.HaarBoxDetector().detect(img),
                                      jfd.HaarBoxDetector().detect(img))


def _lm68_in_crop(seed: int, res: int):
    rng = np.random.default_rng(seed)
    _, pts = render_face(rng, res)
    return pts


@pytest.mark.parametrize("mode", ["mouth", "face", "eye"])
def test_landmark_masks_match_jax(mode):
    for seed in range(3):
        lm = _lm68_in_crop(seed, 256)
        np.testing.assert_array_equal(pip_.landmark_mask_from_68(mode, lm, 256),
                                      jip.landmark_mask_from_68(mode, lm, 256))
    mesh = np.random.default_rng(4).random((478, 2)) * 256  # a 478-point mesh
    np.testing.assert_array_equal(pip_.mediapipe_lm478_to_lm68(mesh),
                                  jip.mediapipe_lm478_to_lm68(mesh))
    pj = jip.ImageProcessor(256, mask=mode)
    pp = pip_.ImageProcessor(256, mask=mode, device="cpu")
    face = np.zeros((256, 256, 3), np.uint8)
    np.testing.assert_array_equal(pp._landmark_mask(face, mesh), pj._landmark_mask(face, mesh))


@pytest.mark.parametrize("mode", ["fix_mask", "half", "mouth", "face", "eye"])
def test_prepare_masks_and_masked_images_match_jax(mode):
    """Every mode, faces at 200² (resized to 256²); the per-frame modes take
    68-point landmarks for some frames' crops, a 478-point mesh for others."""
    rng = np.random.default_rng(5)
    faces = rng.integers(0, 255, (3, 200, 200, 3), dtype=np.uint8)
    lms = None
    if mode not in ("fix_mask", "half"):  # two frames of 68 points, one 478-point mesh
        lms = [_lm68_in_crop(s, 256) for s in range(2)] + [rng.random((478, 2)) * 256]
    pj = jip.ImageProcessor(256, mask=mode)
    pp = pip_.ImageProcessor(256, mask=mode, device="cpu")
    got = pp.prepare_masks_and_masked_images(faces, lms)
    ref = pj.prepare_masks_and_masked_images(faces, lms)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    keep = pp.keep_mask(pp.resize_batch(faces), lms)
    assert keep.shape == ((1, 256, 256, 3) if mode in ("fix_mask", "half") else (3, 256, 256, 1))


@pytest.mark.parametrize("size", [320, 200, 512, 256])
def test_resize_batch_equals_the_reference(size):
    """INTER_AREA when shrinking, INTER_LINEAR when growing, as the JAX
    package calls OpenCV: at 320² and 200² → 256² the port's former
    bilinear resize through the native library differed in most values."""
    faces = np.random.default_rng(size).integers(0, 255, (3, size, size, 3), dtype=np.uint8)
    got = pip_.ImageProcessor(256, device="cpu").resize_batch(faces)
    ref = jip.ImageProcessor(256).resize_batch(faces)
    assert got.shape == (3, 256, 256, 3)
    np.testing.assert_array_equal(got, ref)
    if size != 256:  # the former path gives other values here
        from latentsync_tpu_torch.utils.native import restore_lib

        old = restore_lib().resize_frames_native(faces, (256, 256))
        assert (old != ref).mean() > 0.3 if size in (320, 200) else (old != ref).any()


@pytest.mark.parametrize("res", [512, 200, 64])
def test_fixed_mask_equals_the_reference(res):
    """Decoded by OpenCV and resized with LANCZOS4; the former path was off
    by 1.0 at the mask's edges at 512."""
    np.testing.assert_array_equal(pip_.load_fixed_mask(res), jip.load_fixed_mask(res))
    assert pip_._generated_mouth_mask(res).shape == (res, res, 3)
    np.testing.assert_array_equal(pip_._generated_mouth_mask(res),
                                  jip._generated_mouth_mask(res))


def test_committed_fallback_asset_is_the_conversion_of_the_jax_one():
    """The port's asset, in its state-dict layout, equals the conversion of
    the JAX package's asset array for array (float16, as stored there)."""
    want = pconv.fan_state_dict_from_flax(load_pytree(JAX_ASSET))
    got = pconv.load_state_dict_file(pip_.FALLBACK_FAN_PATH)
    assert set(got) == set(want) and len(got) == 274
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float16, k
        assert torch.equal(got[k], want[k]), k
    assert sum(v.numel() for v in got.values()) == 1592516
    assert os.path.getsize(pip_.FALLBACK_FAN_PATH) < 4 * 2**20


def test_fallback_fan_accuracy_and_parity_on_rendered_faces():
    """The port's fallback (whole-frame crops) within NME 0.08
    (outer-eye-corner normalised) on fresh rendered faces, as the
    reference's test holds its own, and equal to the JAX detector's
    landmarks on the same weights in float32."""
    jvars = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), load_pytree(JAX_ASSET))
    jdet = jfd.FANLandmarkDetector(jvars)
    pdet = pfd.FANLandmarkDetector(pconv.load_state_dict_file(pip_.FALLBACK_FAN_PATH),
                                   device="cpu")
    assert pdet.model.num_modules == 1
    rng = np.random.default_rng(123)
    errs = []
    for i in range(8):
        img, gt = render_face(rng, 256)
        lm = pdet(img)
        if i == 0:
            np.testing.assert_allclose(lm, jdet(img), atol=LM_TOL)
        inter = np.linalg.norm(gt[45] - gt[36])
        errs.append(np.linalg.norm(lm - gt, axis=-1).mean() / max(inter, 1))
    assert float(np.mean(errs)) < 0.08, errs


def test_default_detector_is_memoized_and_uses_the_fallback(monkeypatch):
    monkeypatch.setenv("LATENTSYNC_FAN_CKPT", "/nonexistent.npz")
    monkeypatch.delenv("LATENTSYNC_NO_FALLBACK_FAN", raising=False)
    a = pip_.default_landmark_detector("cpu")
    assert a is pip_.default_landmark_detector("cpu")
    assert isinstance(a, pfd.FANLandmarkDetector) and a.face_detector is not None
    assert a.device == torch.device("cpu") and a.model.num_modules == 1
    monkeypatch.setenv("LATENTSYNC_NO_FALLBACK_FAN", "1")
    monkeypatch.setattr(pip_, "_warned_fallback", False)
    monkeypatch.setattr(pip_, "_detector_cache", {})
    with pytest.warns(UserWarning, match="Haar-box"):
        c = pip_.default_landmark_detector("cpu")
    assert isinstance(c, pface.HaarAnchorDetector)


def test_fan_checkpoint_files_load(tmp_path, monkeypatch, fan_pair):
    """``$LATENTSYNC_FAN_CKPT`` as an upstream ``.pth`` state dict and as
    the JAX package's ``.npz`` tree give the same detector weights; an
    S3FD file (here a ``.pth``) adds the box stage."""
    from latentsync_tpu.utils.checkpoint import save_pytree

    _, variables, _, sd = fan_pair
    pth = str(tmp_path / "fan.pth")
    torch.save({k: v.clone() for k, v in sd.items()}, pth)
    tree = str(tmp_path / "fan.npz")
    save_pytree(tree, jax.tree_util.tree_map(np.asarray, variables))
    s3_path = str(tmp_path / "s3fd.pth")
    torch.save(pfd.S3FD().state_dict(), s3_path)
    monkeypatch.setenv("LATENTSYNC_S3FD_CKPT", s3_path)
    monkeypatch.delenv("LATENTSYNC_NO_FALLBACK_FAN", raising=False)
    dets = []
    for path in (pth, tree):
        monkeypatch.setenv("LATENTSYNC_FAN_CKPT", path)
        det = pip_.default_landmark_detector("cpu")
        assert isinstance(det.face_detector, pfd.S3FDDetector)
        dets.append(det)
    for k, v in dets[0].model.state_dict().items():
        torch.testing.assert_close(dets[1].model.state_dict()[k], v, rtol=0, atol=0)
