"""The port's evaluation nets against the JAX package, on the CPU in float32:
Inception-I3D (FVD's feature net), the Fréchet distance, the JAX package's
small FVD tower, and HyperIQA (the quality gate's scorer).

Weights are random and non-zero, batch-norm statistics included, made from
a numpy seed in the JAX package's layout and carried into the port by
``utils/convert.py``'s inverses. I3D runs at (2, 16, 64, 64) and at
(1, 9, 50, 50), where TF ``SAME`` padding is asymmetric (50 at stride 2:
2 before, 3 after), so that a port with torch's symmetric padding fails
(checked here with such a port). HyperIQA runs at its fixed 224², batch 2.

HyperIQA's local-distortion heads: the JAX module flattens its pooled maps
channels-last, upstream (``tests/torch_ref_models.TorchHyperIQA``) NCHW, and
``convert_hyperiqa`` copies ``ldaN_fc``'s columns as they are; so the JAX
module on upstream's own state dict computes another function than
upstream. The port flattens as upstream, and its carrier permutes those
columns: the tests show both halves.

Tolerances: net outputs within 1e-4 in relative L2 (f32 on both sides,
sums in another order); the Fréchet distance within 1e-9 relative (the same
float64 numpy on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.models import hyper_iqa as jh
from latentsync_tpu.models import i3d as ji
from latentsync_tpu.models import perceptual as jp
from latentsync_tpu_torch.models import hyper_iqa as ph
from latentsync_tpu_torch.models import i3d as pi
from latentsync_tpu_torch.models import perceptual as pp
from latentsync_tpu_torch.models.face_detection import _load
from latentsync_tpu_torch.utils import convert as pconv
from torch_ref_models import TorchHyperIQA

from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)

REL = 1e-4


def random_variables(model, args, seed: int):
    """`model`'s variables with every leaf seeded and non-zero: kernels
    N(0, 1/fan_in), biases N(0, 0.02²), norm scales 1 + N(0, 0.1²), running
    means N(0, 0.1²), running variances 1 + |N(0, 0.3²)|."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = 1 + 0.1 * rng.standard_normal(shape)
        elif name == "mean":
            v = 0.1 * rng.standard_normal(shape)
        elif name == "var":
            v = 1 + np.abs(0.3 * rng.standard_normal(shape))
        else:
            v = 0.02 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def rel_l2(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def lda_columns_chw_to_hwc(weight: torch.Tensor, channels: int) -> torch.Tensor:
    """The inverse of ``utils/convert.py`` ``lda_columns_hwc_to_chw``: upstream's
    (C, H, W) columns in the JAX module's channels-last order."""
    out, n = weight.shape
    side = int(round((n // channels) ** 0.5))
    return weight.reshape(out, channels, side, side).permute(0, 2, 3, 1).reshape(out, n)


def _port(module, sd):
    _load(module, sd)
    return module.eval()


# ---------------------------------------------------------------------------
# I3D
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def i3d_vars():
    return {feat: random_variables(ji.InceptionI3D(features=feat),
                                   (jnp.zeros((1, 8, 32, 32, 3)),), seed=2)
            for feat in ("logits", "pool")}


def _ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3)))


@pytest.mark.parametrize("shape", [(2, 16, 64, 64), (1, 9, 50, 50)])
@pytest.mark.parametrize("feat", ["logits", "pool"])
def test_i3d_matches_jax(i3d_vars, shape, feat):
    v = i3d_vars[feat]
    x = np.random.default_rng(1).uniform(-1, 1, shape + (3,)).astype(np.float32)
    ref = np.asarray(jax.jit(ji.InceptionI3D(features=feat).apply)(v, x))
    net = _port(pi.InceptionI3D(features=feat), pconv.i3d_state_dict_from_flax(v))
    with torch.no_grad():
        got = net(_ncdhw(x)).numpy()
    assert got.shape == (shape[0], 400 if feat == "logits" else 1024)
    assert rel_l2(got, ref) < REL


def test_i3d_symmetric_padding_would_fail(i3d_vars, monkeypatch):
    """At (1, 9, 50, 50) torch's symmetric padding (the total split evenly,
    the odd one dropped and the output size kept by padding both sides the
    same) lands one pixel off: the check above would catch such a port."""
    v = i3d_vars["logits"]
    x = np.random.default_rng(1).uniform(-1, 1, (1, 9, 50, 50, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(ji.InceptionI3D().apply)(v, x))

    def symmetric(size, kernel, stride):
        pads = [(k // 2, k // 2) if k > 1 else (0, 0) for k in kernel]
        return [p for pair in reversed(pads) for p in pair]

    monkeypatch.setattr(pi, "same_pads", symmetric)
    net = _port(pi.InceptionI3D(), pconv.i3d_state_dict_from_flax(v))
    with torch.no_grad():
        got = net(_ncdhw(x)).numpy()
    assert got.shape == ref.shape and rel_l2(got, ref) > 100 * REL


def test_i3d_converter_round_trip(i3d_vars):
    """The port's piergiaj-layout state dict → the JAX ``convert_i3d`` → the
    JAX variables, leaf for leaf; and the state dict has exactly the port's
    keys (``logits.conv3d.*`` lower-case, as piergiaj's files)."""
    v = i3d_vars["logits"]
    sd = pconv.i3d_state_dict_from_flax(v)
    net = pi.InceptionI3D()
    own = {k for k in net.state_dict() if not k.endswith("num_batches_tracked")}
    assert set(sd) == own and "logits.conv3d.bias" in sd
    back = ji.convert_i3d({k: t.numpy() for k, t in sd.items()})
    flat_v = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_v) == len(flat_b)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf))


# ---------------------------------------------------------------------------
# FVD
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d", [(12, 8), (40, 16)])
def test_frechet_distance_matches_jax(n, d):
    rng = np.random.default_rng(n)
    a = rng.standard_normal((n, d)).astype(np.float32)
    b = (rng.standard_normal((n, d)) * 1.3 + 0.2).astype(np.float32)
    want = jp.frechet_distance(a, b)
    assert want > 0
    assert abs(pp.frechet_distance(a, b) - want) <= 1e-9 * abs(want)
    assert abs(pp.compute_fvd(torch.from_numpy(a), torch.from_numpy(b))
               - jp.compute_fvd(a, b)) <= 1e-9 * abs(want)
    assert abs(pp.frechet_distance(a, a)) < 1e-6


def test_i3d_features_tower_matches_jax():
    m = jp.I3DFeatures(feature_dim=32)
    v = random_variables(m, (jnp.zeros((1, 8, 32, 32, 3)),), seed=5)
    x = np.random.default_rng(3).uniform(-1, 1, (2, 8, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(m.apply)(v, x))
    sd = pconv._state_dict(v, lambda path: ".".join(path))
    net = _port(pp.I3DFeatures(feature_dim=32), sd)
    with torch.no_grad():
        got = net(_ncdhw(x)).numpy()
    assert rel_l2(got, ref) < REL


# ---------------------------------------------------------------------------
# HyperIQA
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hyper():
    model = jh.HyperIQA()
    v = random_variables(model, (jnp.zeros((1, 224, 224, 3)),), seed=4)
    x = np.random.default_rng(8).standard_normal((2, 224, 224, 3)).astype(np.float32)
    return model, v, jax.jit(model.apply), x


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _lda_vectors(model, variables, x):
    """The JAX module's three local-distortion vectors (B, 48)."""
    _, state = jax.jit(lambda v, x: model.apply(
        v, x, capture_intermediates=lambda mdl, _: mdl.name in (
            "lda1_fc", "lda2_fc", "lda3_fc")))(variables, x)
    inter = state["intermediates"]
    return np.concatenate([np.asarray(inter[f"lda{i}_fc"]["__call__"][0]) for i in (1, 2, 3)],
                          -1)


def test_hyperiqa_matches_jax(hyper):
    model, v, apply, x = hyper
    ref = np.asarray(apply(v, x))
    net = _port(ph.HyperIQA(), pconv.hyperiqa_state_dict_from_flax(v))
    with torch.no_grad():
        got = net(_nchw(x)).numpy()
        _, vec = net.res(_nchw(x))
    assert got.shape == (2,)
    assert rel_l2(got, ref) < REL
    assert rel_l2(vec[:, :48].numpy(), _lda_vectors(model, v, x)) < REL


def test_hyperiqa_port_computes_upstream_and_the_jax_flatten_does_not(hyper):
    """On one upstream-layout state dict: the port equals upstream's HyperNet
    (``TorchHyperIQA``); the JAX module through ``convert_hyperiqa`` of that
    same file does not (its lda vectors are other combinations); with the
    lda columns permuted to channels-last first it agrees again."""
    model, v, apply, x = hyper
    sd = pconv.hyperiqa_state_dict_from_flax(v)  # upstream layout
    net = _port(ph.HyperIQA(), sd)
    upstream = TorchHyperIQA()
    upstream.load_state_dict(sd, strict=False)
    with torch.no_grad():
        got = net(_nchw(x)).numpy()
        _, vec = net.res(_nchw(x))
        want = upstream.eval()(_nchw(x)).numpy()[:, 0]
    np.testing.assert_array_equal(got, want)

    as_is = jax.tree.map(jnp.asarray, jh.convert_hyperiqa({k: t.numpy() for k, t in sd.items()}))
    lda = vec[:, :48].numpy()
    assert rel_l2(_lda_vectors(model, as_is, x), lda) > 0.3
    # the sigmoid gates damp it in the score, which still moves past the tolerance
    assert rel_l2(np.asarray(apply(as_is, x)), got) > REL

    hwc = {k: (lda_columns_chw_to_hwc(t, pconv._LDA_CHANNELS[k])
               if k in pconv._LDA_CHANNELS else t).numpy() for k, t in sd.items()}
    permuted = jax.tree.map(jnp.asarray, jh.convert_hyperiqa(hwc))
    assert rel_l2(np.asarray(apply(permuted, x)), got) < REL
    assert rel_l2(_lda_vectors(model, permuted, x), lda) < REL


def test_hyperiqa_state_dict_layout_and_inverse_permutation():
    """The carrier gives upstream's keys exactly (``res.ldaN_pool.0``,
    ``res.layerL.B.downsample.{0,1}``, ``conv1.{0,2,4}``), and the two column
    permutations invert each other."""
    sd = pconv.hyperiqa_state_dict_from_flax(
        random_variables(jh.HyperIQA(), (jnp.zeros((1, 224, 224, 3)),), seed=6))
    want = {k for k in TorchHyperIQA().state_dict() if not k.endswith("num_batches_tracked")}
    assert set(sd) == want
    w = torch.randn(16, 1024)
    back = lda_columns_chw_to_hwc(pconv.lda_columns_hwc_to_chw(w, 16), 16)
    assert torch.equal(back, w)


def test_hyperiqa_scorer_normalises_as_the_jax_scorer(hyper):
    """``HyperIQAScorer``'s resize and ImageNet normalisation equal the JAX
    scorer's arrays bit for bit; the scorer end to end (resize,
    normalisation, the net), on the same weights, gives the JAX scorer's
    score on frames of three sizes; and a frame's score equals a batch's
    row."""
    rng = np.random.default_rng(9)
    frames = rng.integers(0, 256, (3, 100, 120, 3), np.uint8)
    import cv2

    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    want = np.stack([(cv2.resize(f, (224, 224)).astype(np.float32) / 255.0 - mean) / std
                     for f in frames]).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(ph.normalize_frames(frames), want)

    _, v, _, _ = hyper
    jax_scorer = jh.HyperIQAScorer(v)
    scorer = ph.HyperIQAScorer(pconv.hyperiqa_state_dict_from_flax(v), device="cpu")
    sized = [rng.integers(0, 256, hw + (3,), np.uint8) for hw in ((100, 120), (224, 224),
                                                                 (300, 260))]
    got = np.array([scorer(f) for f in sized])
    assert rel_l2(got, [jax_scorer(f) for f in sized]) < REL
    batch = scorer.score_batch(frames)
    assert batch.shape == (3,) and np.isfinite(batch).all()
    assert abs(scorer(frames[1]) - batch[1]) <= 1e-4 * max(1.0, abs(batch[1]))
