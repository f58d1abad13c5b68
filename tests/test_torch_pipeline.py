"""The port's serving slice against the JAX pipeline, on the CPU in float32.

Tiny configs (resolution 64, 2 DDIM steps, CFG 1.5), the same random
non-zero weights (the port's ``init_random_`` carried into flax by the
JAX package's converters), the same avatar bundle and the same injected
initial noise x_T go through both ``LipsyncPipeline``s. The decoded
mouth crops are compared in uint8 and the written videos by pixel delta.
A second test serves one request through the port's HTTP server. The
``finish`` tests hold its in-place paste (main frame array plus a small
wrapped tail, slice views for a chunk of one crop size) bitwise against a
copy-everything version written here, with the chunks as tensors and as
host copies behind events, and its fetch thread: a failure there surfaces
as a new chained exception, the writer is aborted, no file is left and the
thread has ended. The timing-key test holds ``JobState.timings`` to the JAX
package's key set.
"""

import json
import os
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu import config as jcfg
from latentsync_tpu.audio.features import Audio2Feature as JAudio2Feature
from latentsync_tpu.pipelines.lipsync import LipsyncPipeline as JPipeline
from latentsync_tpu.utils.convert import convert_unet, convert_vae, convert_whisper_encoder
from latentsync_tpu.utils.image_processor import load_fixed_mask as j_load_fixed_mask
from latentsync_tpu_torch import config as pcfg
from latentsync_tpu_torch.audio.features import Audio2Feature
from latentsync_tpu_torch.models.unet3d import UNet3DConditionModel
from latentsync_tpu_torch.models.vae import AutoencoderKL
from latentsync_tpu_torch.models.whisper import WhisperEncoder
from latentsync_tpu_torch.pipelines import lipsync as plipsync
from latentsync_tpu_torch.pipelines.lipsync import HostCopy, JobState, LipsyncPipeline
from latentsync_tpu_torch.serving.api import ServingState, make_handler
from latentsync_tpu_torch.serving.artifacts import AvatarStore
from latentsync_tpu_torch.utils.convert import init_random_
from latentsync_tpu_torch.utils.image_processor import load_fixed_mask
from latentsync_tpu_torch.utils.media import StreamingVideoWriter, read_video, write_audio

from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)


RES, CROP_AT, FRAME_HW, N_FRAMES = 64, 16, 96, 20
STEPS = 2
# decoded uint8 crops: f32 on both sides, so at most a one-step rounding
# difference on a few pixels
MAX_U8_DELTA, MEAN_U8_DELTA = 1, 1e-3
# written videos: both go through the same lossy encoder
MEAN_VIDEO_DELTA = 0.1


def _configs(mod):
    unet = mod.UNet3DConfig(block_out_channels=(32, 64, 64, 64), layers_per_block=1,
                            norm_num_groups=8, cross_attention_dim=16, attention_head_dim=4,
                            motion_module=mod.MotionModuleConfig(num_attention_heads=4))
    return mod.LatentSyncConfig(
        unet=unet, vae=mod.VAEConfig(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                                     norm_num_groups=4),
        whisper=mod.WhisperConfig(n_audio_state=16, n_audio_head=2, n_audio_layer=1),
        data=mod.DataConfig(resolution=RES))


def _sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("avatar")
    rng = np.random.default_rng(0)
    # smooth synthetic frames (the codec keeps them nearly intact)
    yy, xx = np.mgrid[0:FRAME_HW, 0:FRAME_HW]
    frames = np.stack([
        np.stack([(128 + 100 * np.sin(xx / 9 + t / 3 + ch)).astype(np.uint8)
                  for ch in range(3)], -1) for t in range(N_FRAMES)])
    writer = StreamingVideoWriter(str(root / "avatar.mp4"), fps=25,
                                  frame_hw=(FRAME_HW, FRAME_HW))
    writer.append(frames)
    writer.close()
    faces = frames[:, CROP_AT:CROP_AT + RES, CROP_AT:CROP_AT + RES]
    mat = np.array([[1.0, 0.0, -CROP_AT], [0.0, 1.0, -CROP_AT]])
    np.savez(root / "avatar.npz", faces=faces, boxes=np.tile([0, 0, RES, RES], (N_FRAMES, 1)),
             affine_matrices=np.repeat(mat[None], N_FRAMES, 0))
    write_audio(str(root / "speech.wav"),
                (0.3 * rng.standard_normal(int(16000 * 1.2))).astype(np.float32))
    # a mask at the test resolution, so neither side resizes it
    mask = cv2.imread(os.path.join(os.path.dirname(pcfg.__file__), "utils", "assets", "mask.png"))
    cv2.imwrite(str(root / "mask.png"), np.ascontiguousarray(mask[::4, ::4]))

    cfg = _configs(pcfg)
    unet = init_random_(UNet3DConditionModel(cfg.unet), seed=11)
    vae = init_random_(AutoencoderKL(cfg.vae), seed=12)
    whisper = init_random_(WhisperEncoder(cfg.whisper), seed=13)
    port = LipsyncPipeline(unet, vae, Audio2Feature(whisper), cfg, dtype=torch.float32,
                           device="cpu")
    j_audio = JAudio2Feature(_configs(jcfg).whisper, params=convert_whisper_encoder(
        {"encoder." + k: v for k, v in _sd(whisper).items()}))
    jax_pipe = JPipeline(convert_unet(_sd(unet), 13, 4, 16), convert_vae(_sd(vae)), j_audio,
                         _configs(jcfg), dtype=jnp.float32)
    return root, port, jax_pipe


def test_serving_slice_matches_jax(slice_setup):
    root, port, jax_pipe = slice_setup
    kw = dict(data_path=str(root / "avatar.npz"), mask_image_path=str(root / "mask.png"))
    j_state = jax_pipe.prepare(str(root / "avatar.mp4"), str(root / "speech.wav"), **kw)
    p_state = port.prepare(str(root / "avatar.mp4"), str(root / "speech.wav"), **kw)
    assert p_state.num_windows == j_state.num_windows == 2
    for name in ("mask_w", "masked_lat_w", "ref_lat_w", "audio_w"):
        np.testing.assert_allclose(getattr(p_state, name).numpy(),
                                   np.asarray(getattr(j_state, name)), atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    # the same x_T on both sides (the two frameworks' RNGs differ)
    x_t = np.random.default_rng(1).standard_normal((1, 1, 8, 8, 4)).astype(np.float32)
    x_t = np.broadcast_to(x_t, j_state.latents0.shape)
    j_state.latents0 = jnp.asarray(x_t)
    p_state.latents0 = torch.from_numpy(np.ascontiguousarray(x_t))

    j_pieces = jax_pipe.denoise_decode_chunks(j_state, num_inference_steps=STEPS)
    p_pieces = port.denoise_decode_chunks(p_state, num_inference_steps=STEPS)
    j_dec = np.concatenate([np.asarray(d)[: s.stop - s.start] for s, d in j_pieces])
    p_dec = np.concatenate([d.numpy()[: s.stop - s.start] for s, d in p_pieces])
    assert p_dec.shape == j_dec.shape == (32, RES, RES, 3)
    delta = np.abs(p_dec.astype(np.int32) - j_dec.astype(np.int32))
    assert delta.max() <= MAX_U8_DELTA and delta.mean() < MEAN_U8_DELTA
    # the denoised latents depend on the audio
    args = (p_state.latents0, p_state.mask_w, p_state.masked_lat_w, p_state.ref_lat_w)
    lat = port._denoise(*args, p_state.audio_w, STEPS, 1.5)
    lat0 = port._denoise(*args, torch.zeros_like(p_state.audio_w), STEPS, 1.5)
    assert (lat - lat0).abs().mean() > 1e-2 * lat.abs().mean()

    # finish consumes its JobState (it pastes into state.frames and drops
    # them): the second finish below gets the source frames again
    src_frames = p_state.frames.copy()
    j_out = jax_pipe.finish(j_state, None, str(root / "jax.mp4"), pieces=j_pieces)
    p_out = port.finish(p_state, None, str(root / "port.mp4"), pieces=p_pieces)
    assert p_out.num_frames == j_out.num_frames == 32
    # the stage keys are the JAX package's; on the CPU no device-time key exists
    assert set(p_out.elapsed) == set(j_out.elapsed) == REFERENCE_TIMING_KEYS
    with pytest.raises(RuntimeError, match="finished already"):
        port.finish(p_state, None, str(root / "again.mp4"), pieces=p_pieces)
    p_state.frames = src_frames
    j_video = read_video(j_out.video_path, change_fps=False).astype(np.int32)
    p_video = read_video(p_out.video_path, change_fps=False).astype(np.int32)
    assert p_video.shape == j_video.shape == (32, FRAME_HW, FRAME_HW, 3)
    assert np.abs(p_video - j_video).mean() < MEAN_VIDEO_DELTA
    # finish() from latents (decoding itself) writes the same video
    l_out = port.finish(p_state, lat, str(root / "port_latents.mp4"))
    np.testing.assert_array_equal(read_video(l_out.video_path, change_fps=False), p_video)
    # the mouth region was regenerated: it differs from the source frames
    src = read_video(str(root / "avatar.mp4"), change_fps=False).astype(np.int32)
    mouth = np.s_[:N_FRAMES, CROP_AT + 40:CROP_AT + 56, CROP_AT + 20:CROP_AT + 44]
    assert np.abs(p_video[mouth] - src[mouth]).mean() > 5


# JobState.timings of a bundle-path request in the JAX package
# (latentsync_tpu/pipelines/lipsync.py prepare, denoise_decode_chunks, finish)
REFERENCE_TIMING_KEYS = {"faces", "audio_device", "audio", "vae_encode", "denoise_dispatch",
                         "vae_decode", "restore", "decode_restore_total", "write", "write_wait",
                         "total"}


def test_timing_keys_of_a_cpu_request(slice_setup, tmp_path):
    """A whole request through ``__call__`` on the CPU: the reference's
    stage keys, each a non-negative float, and no ``device_*`` key (those
    come from CUDA events and are absent, not zero, without a card)."""
    root, port, _ = slice_setup
    out = port(str(root / "avatar.mp4"), str(root / "speech.wav"), str(tmp_path / "o.mp4"),
               num_inference_steps=1, data_path=str(root / "avatar.npz"),
               mask_image_path=str(root / "mask.png"))
    assert set(out.elapsed) == REFERENCE_TIMING_KEYS
    assert not any(k.startswith("device_") for k in out.elapsed)
    assert all(isinstance(v, float) and v >= 0.0 for v in out.elapsed.values())
    assert out.elapsed["total"] >= out.elapsed["decode_restore_total"]


class _RecordingWriter:
    """Stands in for StreamingVideoWriter: keeps a copy of what is appended."""

    instances = []

    def __init__(self, path, fps, frame_hw, audio_path=None):
        self.path, self.frame_hw, self.chunks, self.busy_s = path, tuple(frame_hw), [], 0.0
        _RecordingWriter.instances.append(self)

    def append(self, frames):
        assert frames.shape[1:3] == self.frame_hw
        self.chunks.append(np.array(frames, copy=True))

    def close(self):
        return self.path

    def abort(self):
        pass


def _finish_copy_everything(state, pieces):
    """finish's frames, the straightforward way: the whole (wrapped) frame
    array copied first, each crop-size group through a fancy index."""
    total = state.num_windows * state.num_frames
    frames = np.asarray(state.frames)
    out = frames[np.arange(total) % len(frames)].copy()
    m_all = state.masks[..., :1].astype(np.float32)
    pix_u8 = np.clip((state.pixel_values + 1.0) * 127.5, 0, 255)
    mats = np.stack([np.asarray(m, np.float64) for m in state.matrices[:total]])
    crop_hws = [(int(b[3] - b[1]), int(b[2] - b[0])) for b in state.boxes[:total]]
    for sl, dev in pieces:
        dec = dev.numpy()[: sl.stop - sl.start]
        m = m_all[sl]
        combined = (dec * (1.0 - m) + pix_u8[sl] * m).astype(np.uint8)
        groups = {}
        for idx in range(sl.start, sl.stop):
            groups.setdefault(crop_hws[idx], []).append(idx)
        for crop_hw, idxs in groups.items():
            idxs = np.asarray(idxs)
            out[idxs] = LipsyncPipeline._restore_group(out[idxs], combined[idxs - sl.start],
                                                       mats[idxs], crop_hw)
    return out


FINISH_CASES = [
    (10, 8, 2, 8, False),   # wraps: the second chunk straddles the clip's end
    (10, 8, 2, 8, True),    # the same with two crop sizes a chunk
    (5, 4, 3, 8, False),    # wraps twice over a 5-frame clip; padded last chunk
    (20, 8, 2, 8, False),   # no wrap: pasted into the frame array itself
    (16, 8, 2, 16, True),   # no wrap, one chunk, two crop sizes
    (16, 4, 3, 4, False),   # no wrap, a clip longer than the output
]


def _finish_case(n_src, nf, nw, chunk, mixed):
    """A synthetic clip and its decoded chunks: (make_state, pieces, frames)."""
    rng = np.random.default_rng(n_src * 100 + nf * 10 + nw + int(mixed))
    total, res, hw = nf * nw, 32, 48
    frames = rng.integers(0, 256, (n_src, hw, hw, 3), dtype=np.uint8)
    boxes = [[0, 0, 32, 32] if not (mixed and i % 3 == 1) else [2, 4, 26, 30]
             for i in range(total)]
    mats = [np.array([[1.0, 0.0, -8.0 - (i % 2 if mixed else 0)], [0.0, 1.0, -8.0]])
            for i in range(total)]
    masks = (rng.random((total, res, res, 1)) > 0.5).astype(np.float32)
    pixel_values = rng.uniform(-1, 1, (total, res, res, 3)).astype(np.float32)
    pieces = []
    for i in range(0, total, chunk):
        sl = slice(i, min(i + chunk, total))
        # a short last batch arrives padded to the full chunk
        pieces.append((sl, torch.from_numpy(
            rng.integers(0, 256, (chunk, res, res, 3), dtype=np.uint8))))

    def make_state():
        return JobState(
            latents0=None, mask_w=None, masked_lat_w=None, ref_lat_w=None, audio_w=None,
            frames=frames.copy(), boxes=boxes, matrices=mats, masks=masks,
            pixel_values=pixel_values, audio_samples=np.zeros(16000, np.float32),
            num_frames=nf, num_windows=nw, video_fps=25, audio_sample_rate=16000, lat_hw=4,
            processor=None, timings={}, start_time=time.time())

    return make_state, pieces, frames


def _fetch_threads():
    return [t for t in threading.enumerate() if t.name == "finish-fetch"]


def _check_finish(port, tmp_path, monkeypatch, case, pieces_as=lambda pieces: pieces):
    n_src, nf, nw, _, _ = case
    make_state, pieces, frames = _finish_case(*case)
    total, hw = nf * nw, frames.shape[1]
    want = _finish_copy_everything(make_state(), pieces)
    monkeypatch.setattr(plipsync, "StreamingVideoWriter", _RecordingWriter)
    _RecordingWriter.instances.clear()
    state = make_state()
    own = state.frames
    out = port.finish(state, None, str(tmp_path / "x.mp4"), pieces=pieces_as(pieces))
    assert out.num_frames == total
    (writer,) = _RecordingWriter.instances
    got = np.concatenate(writer.chunks)
    assert got.shape == want.shape == (total, hw, hw, 3)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, frames[np.arange(total) % n_src])  # faces were pasted
    # the main segment was pasted into the state's own frame array, not a
    # copy, and the state no longer holds it: it cannot be finished twice
    n_main = min(total, n_src)
    np.testing.assert_array_equal(own[:n_main], want[:n_main])
    if n_src > total:
        np.testing.assert_array_equal(own[total:], frames[total:])
    assert state.frames is None
    assert "write" in out.elapsed and "vae_decode" in out.elapsed
    assert not _fetch_threads()  # the fetch thread has ended
    return out


@pytest.mark.parametrize("n_src,nf,nw,chunk,mixed", FINISH_CASES)
def test_finish_in_place_matches_copy_everything(slice_setup, tmp_path, monkeypatch,
                                                 n_src, nf, nw, chunk, mixed):
    _, port, _ = slice_setup
    _check_finish(port, tmp_path, monkeypatch, (n_src, nf, nw, chunk, mixed))


class _Event:
    """Stands in for the CUDA event behind a chunk's copy to the host."""

    def __init__(self, log, index, fail=None, delay=0.0):
        self.log, self.index, self.fail, self.delay = log, index, fail, delay

    def synchronize(self):
        time.sleep(self.delay)
        self.log.append((self.index, threading.current_thread().name))
        if self.fail is not None:
            raise self.fail


@pytest.mark.parametrize("n_src,nf,nw,chunk,mixed", FINISH_CASES)
def test_finish_takes_host_copies_behind_events(slice_setup, tmp_path, monkeypatch,
                                                n_src, nf, nw, chunk, mixed):
    """The chunks as a CUDA device hands them over (a host buffer and the
    event behind its copy): the same frames, bit for bit; each event is
    waited for once, in order, on the fetch thread; the stage keys stand."""
    _, port, _ = slice_setup
    log = []
    out = _check_finish(
        port, tmp_path, monkeypatch, (n_src, nf, nw, chunk, mixed),
        lambda pieces: [(sl, HostCopy(t, _Event(log, i, delay=0.01)))
                        for i, (sl, t) in enumerate(pieces)])
    assert [i for i, _ in log] == list(range(len(log))) and len(log) == -(-nf * nw // chunk)
    assert {name for _, name in log} == {"finish-fetch"}
    assert {"vae_decode", "restore", "decode_restore_total", "write", "write_wait",
            "total"} <= set(out.elapsed)
    assert out.elapsed["vae_decode"] >= 0.01 * len(log)  # the fetch thread's busy time


@pytest.mark.parametrize("fail_at", [0, 1, 2])
def test_finish_fetch_failure_is_raised_anew_and_cleans_up(slice_setup, tmp_path, fail_at):
    """An exception inside the fetch thread surfaces from finish as a new
    exception chained to it; the writer is aborted (no output file, no
    temporary directory left) and the fetch thread has ended, wherever in
    the clip the failure falls."""
    _, port, _ = slice_setup
    make_state, pieces, _ = _finish_case(16, 4, 3, 4, False)
    boom = OSError("copy failed")
    log = []
    pieces = [(sl, HostCopy(t, _Event(log, i, fail=boom if i == fail_at else None)))
              for i, (sl, t) in enumerate(pieces)]
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    with pytest.raises(RuntimeError, match="fetching a decoded chunk failed") as info:
        port.finish(make_state(), None, str(out_dir / "x.mp4"), pieces=pieces)
    assert info.value.__cause__ is boom and info.value is not boom
    assert len(log) == fail_at + 1  # no chunk past the failing one was waited for
    assert not _fetch_threads()
    assert list(out_dir.iterdir()) == []


def test_finish_restore_failure_releases_the_fetch_thread(slice_setup, tmp_path, monkeypatch):
    """The restoring thread fails while the fetch thread has chunks to hand
    over (a full queue): finish raises that failure, and the thread ends."""
    _, port, _ = slice_setup
    make_state, pieces, _ = _finish_case(16, 2, 8, 2, False)  # 8 chunks
    log = []
    pieces = [(sl, HostCopy(t, _Event(log, i))) for i, (sl, t) in enumerate(pieces)]

    def broken(*a, **k):
        time.sleep(0.2)  # the fetch thread runs ahead and fills the queue
        raise ValueError("restore failed")

    monkeypatch.setattr(LipsyncPipeline, "_restore_group", staticmethod(broken))
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    with pytest.raises(ValueError, match="restore failed"):
        port.finish(make_state(), None, str(out_dir / "x.mp4"), pieces=pieces)
    assert 2 <= len(log) < len(pieces)  # ahead of the restore, but not to the end
    assert not _fetch_threads()
    assert list(out_dir.iterdir()) == []


def test_http_server_serves_one_request(slice_setup, tmp_path):
    root, port, _ = slice_setup
    state = ServingState(port, AvatarStore(str(root)), str(tmp_path))
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        body = json.dumps({"avatar_id": "avatar", "audio_path": str(root / "speech.wav"),
                           "inference_steps": STEPS}).encode()
        req = urllib.request.Request(base + "/process", data=body, method="POST",
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            job_id = json.loads(r.read())["job_id"]
        deadline = time.time() + 120
        while True:
            with urllib.request.urlopen(f"{base}/jobs/{job_id}", timeout=30) as r:
                job = json.loads(r.read())
            if job["status"] in ("completed", "failed") or time.time() > deadline:
                break
            time.sleep(0.2)
        assert job["status"] == "completed", job
        assert job["num_frames"] == 32
        assert read_video(job["output"], change_fps=False).shape[0] == 32
    finally:
        server.shutdown()
        server.server_close()
        state.shutdown()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_mask_png_decodes_like_opencv():
    """The port decodes the mouth mask with OpenCV and resizes it with
    LANCZOS4, as the JAX package does: equal at the mask's own size and at
    others."""
    path = os.path.join(os.path.dirname(pcfg.__file__), "utils", "assets", "mask.png")
    ref = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(load_fixed_mask(256), ref.astype(np.float32) / 255.0)
    for res in (64, 200, 512):
        np.testing.assert_array_equal(load_fixed_mask(res), j_load_fixed_mask(res))
