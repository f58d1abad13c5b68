"""The port's face-restoration stack around CodeFormer against the JAX package's.

On the CPU, from seeded numpy inputs and random non-zero JAX variables
carried into the port by ``utils/convert.py``'s inverses: the restore
helper's align and paste-back and ``ffhq_align`` (host OpenCV / PIL code:
bit for bit), RetinaFace (mobile0.25 and resnet50) and YOLOv5-face (n and
l) nets and detectors, ParseNet, BiSeNet and the parser's mask, RRDBNet
(x2, x4), ArcFace and the RealESRGAN upsampler's tiling. Nets within 5e-4
of the JAX outputs (``tests/test_parity_codeformer.py``'s feature
tolerance), relative to max(1, max|JAX|); each JAX converter taken back
over the port's state dict gives the tree it came from.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.models import parsing as jparse
from latentsync_tpu.models import retinaface as jrf
from latentsync_tpu.models import rrdbnet as jrr
from latentsync_tpu.models import yolov5face as jy5
from latentsync_tpu.models.face_detection import init_detection_model as j_init_detection_model
from latentsync_tpu.utils import face_restore_helper as jhelp
from latentsync_tpu.utils import ffhq_align as jalign
from latentsync_tpu.utils import realesrgan as jesr
from latentsync_tpu.utils.convert_eval import convert_bisenet
from latentsync_tpu_torch.models import face_detection as pfd
from latentsync_tpu_torch.models import parsing as pparse
from latentsync_tpu_torch.models import retinaface as prf
from latentsync_tpu_torch.models import rrdbnet as prr
from latentsync_tpu_torch.models import yolov5face as py5
from latentsync_tpu_torch.utils import convert as pconv
from latentsync_tpu_torch.utils import face_restore_helper as phelp
from latentsync_tpu_torch.utils import ffhq_align as palign
from latentsync_tpu_torch.utils import realesrgan as pesr

from test_torch_codeformer import random_variables

TOL = 5e-4
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small tensors: about as fast
    alone, and the parallel test workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    if got.size:
        err = float(np.abs(got - ref).max())
        assert err <= tol * max(1.0, float(np.abs(ref).max())), err


def same_tree(a, b):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(b)[0])
    assert len(fa) == len(fb)
    for path, leaf in fa:
        np.testing.assert_array_equal(np.asarray(fb[path]), np.asarray(leaf))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def frame(seed, h=180, w=240):
    """A smooth synthetic frame: a face-like ellipse on a gradient."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.uint8)
    img[:] = np.linspace(40, 200, w, dtype=np.uint8)[None, :, None]
    cv2.ellipse(img, (w // 2, h // 2), (w // 5, h // 3), 0, 0, 360, (200, 160, 140), -1)
    noise = rng.integers(0, 12, img.shape, dtype=np.uint8)
    return cv2.add(img, noise)


# ---------------------------------------------------------------------------
# host code: bit for bit
# ---------------------------------------------------------------------------


def lm68(cx=120.0, cy=95.0, s=40.0, angle=0.1):
    rot = np.array([[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]])
    rng = np.random.default_rng(4)
    lm = rng.uniform(-0.6, 0.6, (68, 2))
    lm[36:42] = (-0.5, -0.3)
    lm[42:48] = (0.5, -0.3)
    lm[30] = (0.0, 0.1)
    lm[48], lm[54] = (-0.35, 0.45), (0.35, 0.45)
    lm = lm + rng.normal(0, 0.02, lm.shape)
    return (lm @ rot.T) * s + (cx, cy)


@pytest.mark.parametrize("source", ["haar", "rows", "five", "68"])
def test_helper_align_and_paste_are_the_jax_helpers_bytes(source):
    img = frame(1)
    lm = lm68()
    five = jhelp.five_from_68(lm).astype(np.float32)
    np.testing.assert_array_equal(phelp.five_from_68(lm), jhelp.five_from_68(lm))
    detector = {"haar": None,
                "rows": lambda im: np.concatenate([[10, 10, 90, 90, 0.9], five.ravel()])[None],
                "five": lambda im: five, "68": lambda im: lm}[source]
    jh = jhelp.FaceRestoreHelper(upscale_factor=1.5, face_size=128, landmark_detector=detector)
    ph = phelp.FaceRestoreHelper(upscale_factor=1.5, face_size=128, landmark_detector=detector)
    jf, pf = jh.align_faces(img), ph.align_faces(img)
    assert len(jf) == len(pf) == 1
    np.testing.assert_array_equal(pf[0].crop, jf[0].crop)
    np.testing.assert_array_equal(pf[0].affine, jf[0].affine)
    restored = 255 - jf[0].crop
    np.testing.assert_array_equal(ph.paste_faces(img, [(pf[0], restored)]),
                                  jh.paste_faces(img, [(jf[0], restored)]))
    mask = (np.random.default_rng(2).uniform(0, 1, (128, 128)) > 0.3).astype(np.float32)
    jh.parser = ph.parser = lambda crop: mask
    np.testing.assert_array_equal(ph.paste_faces(img, [(pf[0], restored)]),
                                  jh.paste_faces(img, [(jf[0], restored)]))


@pytest.mark.parametrize("padding", [False, True])
def test_ffhq_align_is_the_jax_recipe_bytes(padding):
    img = frame(3, 200, 200)
    lm = lm68(cx=60, cy=60, s=50)  # the quad pokes outside the frame: the padding branch
    np.testing.assert_array_equal(palign.ffhq_quad(lm)[0], jalign.ffhq_quad(lm)[0])
    kw = dict(output_size=64, transform_size=128, enable_padding=padding)
    np.testing.assert_array_equal(palign.ffhq_align_face(img, lm, **kw),
                                  jalign.ffhq_align_face(img, lm, **kw))


# ---------------------------------------------------------------------------
# detectors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("net", ["mobile0.25", "resnet50"])
def test_retinaface_net_detector_and_converter_match_jax(net):
    """The net on a 100 x 120 frame (levels of 13 x 15, 7 x 8 and 4 x 4: the
    FPN's nearest resizes are not 2x) through both detectors, then their
    decoded, thresholded and suppressed rows."""
    jmodel = jrf.RetinaFaceMobile() if net == "mobile0.25" else jrf.RetinaFaceResNet50()
    variables = random_variables(jmodel, jnp.zeros((1, 96, 96, 3)), seed=31)
    sd = pconv.retinaface_state_dict_from_flax(variables)
    back = (jrf.convert_retinaface if net == "mobile0.25" else jrf.convert_retinaface_resnet50)(
        {k: v.numpy() for k, v in sd.items()})
    same_tree(back, variables)
    img = frame(5, 100, 120)
    jdet = jrf.RetinaFaceDetector(params=variables, network=net)
    pdet = prf.RetinaFaceDetector(sd, network=net, device=CPU)
    x = img[..., ::-1].astype(np.float32) - np.array([104.0, 117.0, 123.0], np.float32)
    for got, ref in zip(pdet.forward(img), jdet._fn(variables, jnp.asarray(x[None]))):
        for g, r in zip(got, ref):
            close(g, r[0])
    for thresh in (0.5, 0.6):
        ref = jdet.detect(img, conf_thresh=thresh)
        got = pdet.detect(img, conf_thresh=thresh)
        assert got.shape == ref.shape and got.shape[1] == 15
        close(got, ref, 1e-3)
    assert len(pdet.detect(img, conf_thresh=0.5))


@pytest.mark.parametrize("net", ["YOLOv5n", "YOLOv5l"])
def test_yolov5face_net_detector_and_converter_match_jax(net):
    jmodel = jy5.YOLOv5nFace() if net == "YOLOv5n" else jy5.YOLOv5lFace()
    variables = random_variables(jmodel, jnp.zeros((1, 64, 64, 3)), seed=37)
    sd = pconv.yolov5face_state_dict_from_flax(variables, net)
    back = (jy5.convert_yolov5face if net == "YOLOv5n" else jy5.convert_yolov5l_face)(
        {k: v.numpy() for k, v in sd.items()})
    same_tree(back, variables)
    img = frame(6, 90, 120)
    jdet = jy5.YOLOv5FaceDetector(params=variables, img_size=128, network=net)
    pdet = py5.YOLOv5FaceDetector(sd, img_size=128, network=net, device=CPU)
    canvas = np.random.default_rng(1).integers(0, 256, (128, 128, 3), dtype=np.uint8)
    close(pdet.predict(canvas),
          jdet._fn(variables, jnp.asarray(canvas[None].astype(np.float32) / 255.0))[0])
    ref = jdet.detect(img, conf_thres=0.3)
    got = pdet.detect(img, conf_thres=0.3)
    assert got.shape == ref.shape and len(got)
    close(got, ref, 1e-3)


def test_channel_shuffle_and_nms_match_jax():
    x = np.arange(2 * 3 * 4 * 8, dtype=np.float32).reshape(2, 3, 4, 8)
    np.testing.assert_array_equal(nhwc(py5.channel_shuffle(nchw(x))),
                                  np.asarray(jy5.channel_shuffle(jnp.asarray(x))))
    rng = np.random.default_rng(8)
    pred = np.concatenate([rng.uniform(20, 60, (200, 2)), rng.uniform(5, 30, (200, 2)),
                           rng.uniform(0, 1, (200, 1)), rng.uniform(0, 80, (200, 10)),
                           rng.uniform(0.5, 1, (200, 1))], 1).astype(np.float32)
    np.testing.assert_array_equal(py5._nms_face(pred), jy5._nms_face(pred))


def test_init_detection_model_names():
    """The reference's four names (``latentsync_tpu/models/face_detection.py``
    ``init_detection_model``) and its refusal of any other."""
    for name, kind in (("retinaface_resnet50", prf.RetinaFaceDetector),
                       ("retinaface_mobile0.25", prf.RetinaFaceDetector),
                       ("YOLOv5l", py5.YOLOv5FaceDetector), ("YOLOv5n", py5.YOLOv5FaceDetector)):
        assert isinstance(pfd.init_detection_model(name, device=CPU), kind)
    with pytest.raises(NotImplementedError):
        pfd.init_detection_model("dlib", device=CPU)
    with pytest.raises(NotImplementedError):
        j_init_detection_model("dlib")


# ---------------------------------------------------------------------------
# parsers
# ---------------------------------------------------------------------------

PARSENET_SMALL = dict(in_size=64, out_size=64, min_feat_size=16, base_ch=16, res_depth=2,
                      ch_range=(16, 64))


def test_parsenet_and_bisenet_match_jax():
    x = np.random.default_rng(7).standard_normal((1, 72, 88, 3)).astype(np.float32)
    for jmodel, port, to_port, to_jax, inp in (
            (jparse.ParseNet(**PARSENET_SMALL), pparse.ParseNet(**PARSENET_SMALL),
             pconv.parsenet_state_dict_from_flax, jparse.convert_parsenet, x[:, :64, :64]),
            (jparse.BiSeNet(), pparse.BiSeNet(), pconv.bisenet_state_dict_from_flax,
             convert_bisenet, x)):
        variables = random_variables(jmodel, jnp.zeros((1, 64, 64, 3)), seed=41)
        sd = to_port(variables)
        same_tree(to_jax({k: v.numpy() for k, v in sd.items()}), variables)
        pfd._load(port, sd)
        with torch.no_grad():
            got = port.eval()(nchw(inp))
        for g, r in zip(got, jax.jit(jmodel.apply)(variables, jnp.asarray(inp))):
            close(nhwc(g), r)


def test_face_parser_mask_matches_jax():
    """The parser's mask at 512² (a narrow ParseNet behind both wrappers): the
    same face classes, resized back to the crop."""
    small = dict(in_size=512, out_size=512, min_feat_size=128, base_ch=8, res_depth=1,
                 ch_range=(8, 16))
    jmodel = jparse.ParseNet(**small)
    variables = random_variables(jmodel, jnp.zeros((1, 512, 512, 3)), seed=43)
    jparser = object.__new__(jparse.FaceParser)
    jparser.model, jparser.params = jmodel, variables
    jparser._fn = jax.jit(lambda p, x: jmodel.apply(p, x)[0])
    pparser = object.__new__(pparse.FaceParser)
    pparser.device, pparser.model = CPU, pparse.ParseNet(**small)
    pfd._load(pparser.model, pconv.parsenet_state_dict_from_flax(variables))
    pparser.model.eval()
    crop = cv2.resize(frame(9), (256, 256))
    ref, got = jparser(crop), pparser(crop)
    assert got.shape == (256, 256) and 0 < got.mean() < 1
    assert np.mean(got != ref) < 1e-3  # a logit tie may flip a pixel's class


# ---------------------------------------------------------------------------
# upsampler and identity net
# ---------------------------------------------------------------------------

RRDB_SMALL = dict(num_feat=16, num_block=2, num_grow_ch=8)


@pytest.mark.parametrize("scale", [2, 4])
def test_rrdbnet_matches_jax(scale):
    jmodel = jrr.RRDBNet(scale=scale, **RRDB_SMALL)
    variables = random_variables(jmodel, jnp.zeros((1, 24, 20, 3)), seed=47)
    sd = pconv.rrdbnet_state_dict_from_flax(variables)
    same_tree(jrr.convert_rrdbnet({k: v.numpy() for k, v in sd.items()}), variables)
    port = prr.RRDBNet(scale=scale, **RRDB_SMALL)
    port.load_state_dict(sd)
    x = np.random.default_rng(2).uniform(0, 1, (1, 24, 20, 3)).astype(np.float32)
    with torch.no_grad():
        close(nhwc(port.eval()(nchw(x))), jax.jit(jmodel.apply)(variables, jnp.asarray(x)))


@pytest.mark.parametrize("use_se", [False, True])
def test_arcface_matches_jax(use_se):
    jmodel = jrr.ArcFaceResNet18(layers=(1, 1, 1, 1), use_se=use_se)
    variables = random_variables(jmodel, jnp.zeros((2, 32, 32, 1)), seed=53)
    sd = pconv.arcface_state_dict_from_flax(variables)
    same_tree(jrr.convert_arcface({k: v.numpy() for k, v in sd.items()}), variables)
    port = prr.ArcFaceResNet18(layers=(1, 1, 1, 1), use_se=use_se, input_size=32)
    pfd._load(port, sd)
    x = np.random.default_rng(5).standard_normal((2, 32, 32, 1)).astype(np.float32)
    with torch.no_grad():
        close(port.eval()(nchw(x)).numpy(), jax.jit(jmodel.apply)(variables, jnp.asarray(x)))


def test_upsampler_tiling_matches_jax():
    """A 37 x 50 frame in 16² tiles with 4 pixels of context: ragged last
    tiles, each on the fixed zero canvas; f32 nets on both sides."""
    jmodel = jrr.RRDBNet(scale=2, **RRDB_SMALL)
    variables = random_variables(jmodel, jnp.zeros((1, 24, 24, 3)), seed=59)
    jup = object.__new__(jesr.RealESRGANUpsampler)
    jup.scale, jup.tile, jup.tile_pad, jup.model, jup.params = 2, 16, 4, jmodel, variables
    jup._fn = jax.jit(lambda p, x: jmodel.apply(p, x))
    sd = pconv.rrdbnet_state_dict_from_flax(variables)

    def port(tile, pad):
        up = object.__new__(pesr.RealESRGANUpsampler)
        up.scale, up.tile, up.tile_pad, up.device = 2, tile, pad, CPU
        up.model = prr.RRDBNet(scale=2, **RRDB_SMALL)
        up.model.load_state_dict(sd)
        up.model.eval()
        return up

    pup = port(16, 4)
    img = frame(11, 37, 50)
    ref, got = jup.enhance(img), pup.enhance(img)
    assert got.shape == ref.shape == (74, 100, 3)
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and np.mean(diff > 0) < 1e-2  # float rounding at a code boundary
    # the canvas: the same tile alone (no zero border below / right) differs at the edges
    whole = port(64, 0).enhance(img)
    assert not np.array_equal(whole, got)
