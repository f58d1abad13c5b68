"""The port's device restore against the JAX package, on the CPU in float32.

``utils/face.warp_affine_batch`` (channels-last at its boundary, as the
JAX function), ``ops/restore.py``'s erosion and blur, and
``restore_frames_device`` against ``latentsync_tpu/ops/restore.py`` on the
same seeded frames, faces and matrices; and the pipeline's paste-back
route (``LATENTSYNC_RESTORE``): unknown values raise, ``cv2`` is the native
route, a CPU pipeline takes the native route by default, and a forced
device route through ``finish`` pastes what the JAX package's
``restore_frames_device`` gives on the same chunks.

Tolerances: the warp within 2e-3 on values up to 255 (both f32; the JAX
package's compiled program fuses some products into FMAs, eager torch
rounds each); erosion exactly; the blur within 1e-5; composited frames
within 1 code on at most 0.1 % of bytes (a value that lands within a
rounding of an integer may truncate either way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.ops import restore as jrestore
from latentsync_tpu.utils import face as jface
from latentsync_tpu.utils import native as jnative
from latentsync_tpu_torch import config as pcfg
from latentsync_tpu_torch.models.vae import AutoencoderKL
from latentsync_tpu_torch.ops import restore as prestore
from latentsync_tpu_torch.pipelines import lipsync as plipsync
from latentsync_tpu_torch.pipelines.lipsync import JobState, LipsyncPipeline
from latentsync_tpu_torch.utils import face as pface

MAX_CODE, MAX_SHARE = 1, 1e-3


def _close_u8(got, want):
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert d.max() <= MAX_CODE, d.max()
    assert (d > 0).mean() <= MAX_SHARE, (d > 0).mean()


@pytest.mark.parametrize("fill", [127.0, 0.0])
def test_warp_affine_batch_matches_jax(fill):
    """Matrices that scale, rotate and shift the image partly outside the
    output, so taps outside the source read `fill`."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (4, 24, 20, 3)).astype(np.float32)
    mats = np.stack([np.array([[1.3, 0.2, -6.0 + 3 * i], [-0.15, 1.1, 9.0 - 4 * i]])
                     for i in range(4)]).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, m: jface.warp_affine_batch(x, m, (30, 34), fill=fill))(
        jnp.asarray(img), jnp.asarray(mats)))
    got = pface.warp_affine_batch(torch.from_numpy(img), mats, (30, 34), fill=fill).numpy()
    assert got.shape == want.shape == (4, 30, 34, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    assert 0.05 < (got == fill).mean() < 0.95  # some pixels inside, some outside


@pytest.mark.parametrize("k", [2, 3, 16, 17])
def test_min_pool_matches_jax(k):
    rng = np.random.default_rng(k)
    x = (rng.random((2, 21, 26)) > 0.2).astype(np.float32) * rng.random((2, 21, 26),
                                                                         dtype=np.float32)
    want = np.asarray(jrestore._min_pool(jnp.asarray(x), k))
    np.testing.assert_allclose(prestore._min_pool(torch.from_numpy(x), k).numpy(), want,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("ksize", [17, 33])
def test_gaussian_blur_matches_jax(ksize):
    rng = np.random.default_rng(ksize)
    x = (rng.random((2, 40, 45)) > 0.4).astype(np.float32)
    want = np.asarray(jrestore._gaussian_blur(jnp.asarray(x), ksize))
    got = prestore._gaussian_blur(torch.from_numpy(x), ksize).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # a region of ones stays exactly 1.0
    ones = prestore._gaussian_blur(torch.ones(1, 3 * ksize, 3 * ksize), ksize)
    assert float(ones[0, ksize + ksize // 2, ksize + ksize // 2]) == 1.0


def _restore_inputs(face_size, per_frame, n=6, hw=(280, 300)):
    rng = np.random.default_rng(face_size + 7 * per_frame)
    frames = rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8)
    faces = rng.integers(0, 256, (n, face_size, face_size, 3), dtype=np.uint8)
    # frame → crop: a scale of 4/5 (every fourth pixel samples the face on a
    # whole pixel) and a shift; the served case is one constant matrix
    base = np.array([[0.8, 0.0, -20.0], [0.0, 0.8, -15.0]])
    mats = np.repeat(base[None], n, 0)
    if per_frame:
        mats = mats + rng.normal(0, 0.02, mats.shape) * np.array([1, 1, 40.0])
    return frames, faces, mats


@pytest.mark.parametrize("face_size,edge", [(100, 8), (200, 16)])
@pytest.mark.parametrize("per_frame", [False, True], ids=["constant", "per_frame"])
def test_restore_frames_device_matches_jax(face_size, edge, per_frame):
    frames, faces, mats = _restore_inputs(face_size, per_frame)
    assert prestore.edge_radius(mats, faces.shape[1:3]) == edge
    want = jrestore.restore_frames_device(frames, faces, mats)
    got = prestore.restore_frames_device(frames, faces, mats, device="cpu")
    _close_u8(got, want)
    assert (got != frames).mean() > 0.1  # the face was pasted
    for chunk in (1, 5):
        np.testing.assert_array_equal(
            prestore.restore_frames_device(frames, faces, mats, chunk=chunk, device="cpu"), got)
    into = frames.copy()
    assert prestore.restore_frames_device(into, faces, mats, device="cpu", out=into) is into
    np.testing.assert_array_equal(into, got)


class _Writer:
    """Stands in for StreamingVideoWriter: keeps a copy of what is appended."""

    chunks = []

    def __init__(self, path, fps, frame_hw, audio_path=None):
        self.path, self.busy_s = path, 0.0

    def append(self, frames):
        _Writer.chunks.append(np.array(frames, copy=True))

    def close(self):
        return self.path

    def abort(self):
        pass


@pytest.fixture(scope="module")
def cpu_pipeline():
    vae = AutoencoderKL(pcfg.VAEConfig(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                                       norm_num_groups=4))
    return LipsyncPipeline(None, vae, None, dtype=torch.float32, device="cpu")


def _finish_state(nf=8, nw=2, res=32, hw=(96, 104), box=48, seed=3):
    """A clip of nf · nw source frames (no wrap), one crop size, and its
    decoded chunks (one a window)."""
    rng = np.random.default_rng(seed)
    total = nf * nw
    frames = rng.integers(0, 256, (total, *hw, 3), dtype=np.uint8)
    mat = np.array([[1.0, 0.0, -20.0], [0.0, 1.0, -14.0]])
    masks = (rng.random((total, res, res, 1)) > 0.5).astype(np.float32)
    pixel_values = rng.uniform(-1, 1, (total, res, res, 3)).astype(np.float32)
    pieces = [(slice(i, i + nf), torch.from_numpy(rng.integers(0, 256, (nf, res, res, 3),
                                                               dtype=np.uint8)))
              for i in range(0, total, nf)]
    state = JobState(
        latents0=None, mask_w=None, masked_lat_w=None, ref_lat_w=None, audio_w=None,
        frames=frames.copy(), boxes=[[0, 0, box, box]] * total, matrices=[mat] * total,
        masks=masks, pixel_values=pixel_values, audio_samples=np.zeros(16000, np.float32),
        num_frames=nf, num_windows=nw, video_fps=25, audio_sample_rate=16000, lat_hw=4,
        processor=None, timings={}, start_time=0.0)
    return state, pieces, frames


def _finish(pipe, tmp_path, monkeypatch, route):
    if route is None:
        monkeypatch.delenv("LATENTSYNC_RESTORE", raising=False)
    else:
        monkeypatch.setenv("LATENTSYNC_RESTORE", route)
    monkeypatch.setattr(plipsync, "StreamingVideoWriter", _Writer)
    _Writer.chunks = []
    state, pieces, frames = _finish_state()
    out = pipe.finish(state, None, str(tmp_path / "x.mp4"), pieces=pieces)
    return np.concatenate(_Writer.chunks), out, state, pieces, frames


def test_restore_route_reads_the_switch(monkeypatch):
    cpu = torch.device("cpu")
    monkeypatch.delenv("LATENTSYNC_RESTORE", raising=False)
    assert not plipsync._transport_is_fast(cpu)
    assert plipsync.restore_route(cpu) == "native"  # a CPU pipeline: the host route
    for value, route in (("device", "device"), ("native", "native"), ("cv2", "native")):
        monkeypatch.setenv("LATENTSYNC_RESTORE", value)
        assert plipsync.restore_route(cpu) == route
    for bad in ("", "gpu", "Device", "auto"):
        monkeypatch.setenv("LATENTSYNC_RESTORE", bad)
        with pytest.raises(ValueError, match="LATENTSYNC_RESTORE"):
            plipsync.restore_route(cpu)


def test_finish_routes(cpu_pipeline, tmp_path, monkeypatch):
    """Default and ``cv2`` paste on the host, bit for bit the native route;
    a forced device route pastes the JAX package's ``restore_frames_device``
    of the same chunks (each chunk one call: one crop size, no wrap); an
    unknown value raises out of ``finish`` and leaves no file."""
    native, out, _, _, _ = _finish(cpu_pipeline, tmp_path, monkeypatch, "native")
    assert out.restore_route == "native"
    for route in (None, "cv2"):
        got, out, _, _, _ = _finish(cpu_pipeline, tmp_path, monkeypatch, route)
        assert out.restore_route == "native"
        np.testing.assert_array_equal(got, native)

    got, out, state, pieces, frames = _finish(cpu_pipeline, tmp_path, monkeypatch, "device")
    assert out.restore_route == "device"
    m_all = state.masks[..., :1]
    pix_u8 = np.clip((state.pixel_values + 1.0) * 127.5, 0, 255)
    mats = np.stack(state.matrices)
    want = []
    for sl, dec in pieces:
        m = m_all[sl]
        combined = (dec.numpy() * (1.0 - m) + pix_u8[sl] * m).astype(np.uint8)
        resized = jnative.resize_frames_native(combined, (48, 48))
        want.append(jrestore.restore_frames_device(frames[sl], resized, mats[sl]))
    _close_u8(got, np.concatenate(want))
    assert (got != native).any()  # another composite than the host's

    monkeypatch.setenv("LATENTSYNC_RESTORE", "gpu")
    monkeypatch.setattr(plipsync, "StreamingVideoWriter", _Writer)
    state, pieces, _ = _finish_state()
    out_dir = tmp_path / "bad"
    out_dir.mkdir()
    with pytest.raises(ValueError, match="LATENTSYNC_RESTORE"):
        cpu_pipeline.finish(state, None, str(out_dir / "x.mp4"), pieces=pieces)
    assert list(out_dir.iterdir()) == []
