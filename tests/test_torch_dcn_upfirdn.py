"""``latentsync_tpu_torch/ops/{deform_conv,upfirdn}.py`` against the JAX
package's functions, on the CPU in float32.

The cases of ``tests/test_ops.py`` (upfirdn2d's three (up, down, pad)
settings, the fused leaky ReLU, DCNv2 with zero offsets, a whole-pixel
shift and a halved mask), plus random fractional offsets that sample
outside the image on every side (the zero border), stride and dilation,
``dcn_v2_pack``, StyleGAN2's up- and downsampling and a negative pad. The
JAX layout is channels-last; the port's torch's. Tolerance: 1e-5 absolute
and relative (both sides accumulate in f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.ops import deform_conv as jdc
from latentsync_tpu.ops import upfirdn as jup
from latentsync_tpu_torch.ops import deform_conv as pdc
from latentsync_tpu_torch.ops import upfirdn as pup

from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-5, rtol=1e-5)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("up,down,pad", [(1, 1, (1, 1)), (2, 1, (2, 1)), (1, 2, (1, 1)),
                                         (2, 2, (0, 3)), (1, 1, (-1, 2))])
def test_upfirdn2d_matches_jax(up, down, pad):
    rng = np.random.default_rng(up * 10 + down)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    k = rng.standard_normal((4, 4)).astype(np.float32)
    want = np.asarray(jup.upfirdn2d(jnp.asarray(x), jnp.asarray(k), up, down, pad))
    got = _nhwc(pup.upfirdn2d(_nchw(x), k, up, down, pad))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    as_tensor = _nhwc(pup.upfirdn2d(_nchw(x), torch.from_numpy(k), up, down, pad))
    np.testing.assert_array_equal(as_tensor, got)


@pytest.mark.parametrize("which", ["up", "down"])
def test_resample_matches_jax(which):
    x = np.random.default_rng(1).standard_normal((1, 9, 7, 2)).astype(np.float32)
    jfn, pfn = (jup.upsample2d, pup.upsample2d) if which == "up" else \
        (jup.downsample2d, pup.downsample2d)
    np.testing.assert_allclose(_nhwc(pfn(_nchw(x))), np.asarray(jfn(jnp.asarray(x))), **TOL)


def test_fused_leaky_relu_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 4, 3, 5)).astype(np.float32)
    bias = np.array([1.0, -0.5, 0.25, 0.0], np.float32)
    want = np.asarray(jup.fused_leaky_relu(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                           jnp.asarray(bias)))
    got = _nhwc(pup.fused_leaky_relu(torch.from_numpy(x), torch.from_numpy(bias)))
    np.testing.assert_allclose(got, want, **TOL)
    out = pup.fused_leaky_relu(torch.tensor([[-1.0], [0.0], [2.0]]), torch.tensor([1.0]))
    np.testing.assert_allclose(out[:, 0].numpy(), np.array([0.0, 1.0, 3.0]) * np.sqrt(2),
                               atol=1e-6)


def _dcn_case(kind, rng):
    """test_ops.py's three DCN cases, and random offsets past every edge."""
    if kind == "zero":
        x, w = rng.standard_normal((1, 8, 8, 4)), rng.standard_normal((3, 3, 4, 6)) * 0.1
        off, mask = np.zeros((1, 8, 8, 18)), np.ones((1, 8, 8, 9))
    elif kind == "shift":
        x, w = rng.standard_normal((1, 10, 10, 2)), rng.standard_normal((3, 3, 2, 3)) * 0.1
        off, mask = np.zeros((1, 10, 10, 18)), np.ones((1, 10, 10, 9))
        off[..., 1::2] = 1.0
    elif kind == "half_mask":
        x, w = rng.standard_normal((1, 6, 6, 2)), rng.standard_normal((3, 3, 2, 2))
        off, mask = np.zeros((1, 6, 6, 18)), np.full((1, 6, 6, 9), 0.5)
    else:  # fractional offsets up to 4 px, far outside the 7×9 image at its edges
        x, w = rng.standard_normal((2, 7, 9, 3)), rng.standard_normal((3, 3, 3, 5)) * 0.2
        off, mask = rng.uniform(-4, 4, (2, 7, 9, 18)), rng.uniform(0, 1, (2, 7, 9, 9))
    return [a.astype(np.float32) for a in (x, off, mask, w)]


@pytest.mark.parametrize("kind", ["zero", "shift", "half_mask", "random"])
def test_modulated_deform_conv2d_matches_jax(kind):
    x, off, mask, w = _dcn_case(kind, np.random.default_rng(3))
    bias = np.random.default_rng(4).standard_normal(w.shape[-1]).astype(np.float32)
    want = np.asarray(jdc.modulated_deform_conv2d(*map(jnp.asarray, (x, off, mask, w, bias))))
    got = pdc.modulated_deform_conv2d(_nchw(x), _nchw(off), _nchw(mask),
                                      torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                                      torch.from_numpy(bias))
    np.testing.assert_allclose(_nhwc(got), want, **TOL)


def test_outside_samples_are_zero():
    """Every tap displaced 20 px off the image reads zeros: the output is
    the bias alone."""
    x = torch.randn(1, 2, 5, 5)
    off = torch.full((1, 18, 5, 5), 20.0)
    bias = torch.tensor([0.5, -1.0, 2.0])
    out = pdc.modulated_deform_conv2d(x, off, torch.ones(1, 9, 5, 5), torch.randn(3, 2, 3, 3),
                                      bias)
    torch.testing.assert_close(out, bias[None, :, None, None].expand_as(out))


@pytest.mark.parametrize("stride,padding,dilation", [(1, 1, 1), (2, 1, 1), (1, 2, 2)])
def test_dcn_v2_pack_matches_jax(stride, padding, dilation):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 8, 3)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 4)) * 0.2).astype(np.float32)
    w_off = (rng.standard_normal((3, 3, 3, 27)) * 0.5).astype(np.float32)
    b_off = rng.standard_normal(27).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    want = np.asarray(jdc.dcn_v2_pack(*map(jnp.asarray, (x, w_off, b_off, w, bias)),
                                      stride=stride, padding=padding, dilation=dilation))

    def oihw(k):
        return torch.from_numpy(k.transpose(3, 2, 0, 1).copy())

    got = pdc.dcn_v2_pack(_nchw(x), oihw(w_off), torch.from_numpy(b_off), oihw(w),
                          torch.from_numpy(bias), stride, padding, dilation)
    np.testing.assert_allclose(_nhwc(got), want, **TOL)
