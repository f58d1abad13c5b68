"""Continuous window batching, overlapped clips and the threaded ``prepare``
of the port, on the CPU at tiny size.

The batcher mirrors ``tests/test_batcher.py`` (aggregation across clips,
padding of a short batch to ``max_windows``, a failure reaching every
future of its batch) on torch tensors. Three concurrent clips served over
HTTP by a continuous-batching ``ServingState`` (two workers, batches of two
windows) and three clips through ``run_pipelined`` each equal the serial
path frame for frame within the JAX package's bound
(``tests/test_pipeline.py``: mean |delta| < 1.5 over the written video), in
job order; a failed clip raises. ``prepare`` reads the bundle and the video
on a thread under the whisper encode: its ``JobState`` equals the one of
the same work done in turn, and an error raised on the thread reaches the
caller. What concurrent requests share holds under many threads at once:
the native restore plan cache (more matrices than it keeps) and the default
landmark detector's cache (built once).
"""

import json
import os
import sys
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import cv2
import numpy as np
import pytest
import torch

from latentsync_tpu_torch import config as pcfg
from latentsync_tpu_torch.audio.features import Audio2Feature
from latentsync_tpu_torch.models.unet3d import UNet3DConditionModel
from latentsync_tpu_torch.models.vae import AutoencoderKL
from latentsync_tpu_torch.models.whisper import WhisperEncoder
from latentsync_tpu_torch.pipelines import lipsync as plipsync
from latentsync_tpu_torch.pipelines.lipsync import LipsyncPipeline
from latentsync_tpu_torch.serving.api import ServingState, make_handler
from latentsync_tpu_torch.serving.artifacts import AvatarStore
from latentsync_tpu_torch.serving.batcher import WindowBatcher
from latentsync_tpu_torch.utils.convert import init_random_
from latentsync_tpu_torch.utils.media import StreamingVideoWriter, read_video, write_audio

from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)

RES, CROP_AT, FRAME_HW, N_FRAMES, STEPS = 64, 16, 96, 20, 2
# the JAX package's bound for a pipelined or batched clip against the serial one
MEAN_VIDEO_DELTA = 1.5


# ---------------------------------------------------------------------------
# WindowBatcher
# ---------------------------------------------------------------------------


def test_batcher_aggregates_across_clips():
    calls = []

    def batch_fn(stacked):
        calls.append(stacked["x"].shape[0])
        return stacked["x"] * 2.0

    b = WindowBatcher(batch_fn, max_windows=4, max_wait_ms=50)
    f1 = b.submit_clip([{"x": torch.full((2, 2), float(i))} for i in range(3)])
    f2 = b.submit_clip([{"x": torch.full((2, 2), 10.0 + i)} for i in range(3)])
    for i, f in enumerate(f1):
        assert torch.equal(f.result(timeout=5), torch.full((2, 2), 2.0 * i))
    for i, f in enumerate(f2):
        assert torch.equal(f.result(timeout=5), torch.full((2, 2), 2.0 * (10 + i)))
    # 6 windows in batches of 4: at most 3 calls, one of them with both clips
    assert sum(calls) >= 6 and len(calls) <= 3
    b.close()
    assert not b.thread.is_alive()


def test_batcher_propagates_errors_to_every_future_of_the_batch():
    def batch_fn(stacked):
        raise RuntimeError("boom")

    b = WindowBatcher(batch_fn, max_windows=2, max_wait_ms=50)
    futures = b.submit_clip([{"x": torch.zeros(2)}, {"x": torch.ones(2)}])
    for f in futures:
        with pytest.raises(RuntimeError, match="boom"):
            f.result(timeout=5)
    b.close()


def test_batcher_pads_a_short_batch_with_its_last_item():
    seen = []

    def batch_fn(stacked):
        seen.append(stacked["x"].clone())
        return stacked["x"]

    b = WindowBatcher(batch_fn, max_windows=8, max_wait_ms=5)
    f = b.submit({"x": torch.arange(3.0)})
    assert torch.equal(f.result(timeout=5), torch.arange(3.0))
    assert seen[0].shape == (8, 3) and torch.equal(seen[0], torch.arange(3.0).expand(8, 3))
    b.close()


def test_batcher_close_serves_what_was_queued():
    gate = threading.Event()

    def batch_fn(stacked):
        gate.wait(5)
        return stacked["x"]

    b = WindowBatcher(batch_fn, max_windows=1, max_wait_ms=1)
    futures = [b.submit({"x": torch.tensor([float(i)])}) for i in range(3)]
    closer = threading.Thread(target=b.close)
    closer.start()
    gate.set()
    closer.join(10)
    assert [float(f.result(timeout=5)[0]) for f in futures] == [0.0, 1.0, 2.0]
    assert not b.thread.is_alive()


# ---------------------------------------------------------------------------
# the pipeline on tiny models
# ---------------------------------------------------------------------------


def _config():
    unet = pcfg.UNet3DConfig(block_out_channels=(32, 64, 64, 64), layers_per_block=1,
                             norm_num_groups=8, cross_attention_dim=16, attention_head_dim=4,
                             motion_module=pcfg.MotionModuleConfig(num_attention_heads=4))
    return pcfg.LatentSyncConfig(
        unet=unet, vae=pcfg.VAEConfig(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                                      norm_num_groups=4),
        whisper=pcfg.WhisperConfig(n_audio_state=16, n_audio_head=2, n_audio_layer=1),
        data=pcfg.DataConfig(resolution=RES))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """An avatar (video + bundle, mask at the test resolution) and three
    distinct speech tracks (1.2 s, 2.4 s, 1.2 s: 2, 4 and 2 windows)."""
    root = tmp_path_factory.mktemp("avatars")
    rng = np.random.default_rng(0)
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
    audios = []
    for i, sec in enumerate((1.2, 2.4, 1.2)):
        path = str(root / f"speech{i}.wav")
        write_audio(path, (0.3 * rng.standard_normal(int(16000 * sec))).astype(np.float32))
        audios.append(path)
    mask = cv2.imread(os.path.join(os.path.dirname(pcfg.__file__), "utils", "assets", "mask.png"))
    cv2.imwrite(str(root / "mask.png"), np.ascontiguousarray(mask[::4, ::4]))
    cfg = _config()
    pipe = LipsyncPipeline(init_random_(UNet3DConditionModel(cfg.unet), seed=11),
                           init_random_(AutoencoderKL(cfg.vae), seed=12),
                           Audio2Feature(init_random_(WhisperEncoder(cfg.whisper), seed=13)),
                           cfg, dtype=torch.float32, device="cpu")
    return root, pipe, audios


@pytest.fixture(scope="module")
def serial(setup, tmp_path_factory):
    """The three clips served one after another: their written videos."""
    root, pipe, audios = setup
    out = tmp_path_factory.mktemp("serial")
    return [pipe(str(root / "avatar.mp4"), audio, str(out / f"serial{i}.mp4"),
                 num_inference_steps=STEPS, data_path=str(root / "avatar.npz")).video_path
            for i, audio in enumerate(audios)]


def _video_delta(a_path, b_path):
    a = read_video(a_path, change_fps=False).astype(np.int16)
    b = read_video(b_path, change_fps=False).astype(np.int16)
    assert a.shape == b.shape
    return float(np.abs(a - b).mean())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def test_concurrent_clips_continuous_batched_over_http(setup, serial, tmp_path):
    root, pipe, audios = setup
    state = ServingState(pipe, AvatarStore(str(root)), str(tmp_path / "out"),
                         continuous_batching=True, batch_windows=2, num_workers=2)
    assert len(state._workers) == 2 and set(state._batchers) == {(20, 1.5)}
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        job_ids = []
        for audio in audios:
            body = json.dumps({"avatar_id": "avatar", "audio_path": audio,
                               "inference_steps": STEPS}).encode()
            req = urllib.request.Request(base + "/process", data=body, method="POST",
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                job_ids.append(json.loads(r.read())["job_id"])
        jobs, deadline = {}, time.time() + 300
        while len(jobs) < len(job_ids) and time.time() < deadline:
            for jid in job_ids:
                job = _get(f"{base}/jobs/{jid}")
                if job["status"] in ("completed", "failed"):
                    jobs[jid] = job
            time.sleep(0.2)
        assert [jobs[j]["status"] for j in job_ids] == ["completed"] * 3, jobs
        assert [jobs[j]["num_frames"] for j in job_ids] == [32, 64, 32]
        # a per-request (steps, guidance) gets its own batcher
        assert set(state._batchers) == {(20, 1.5), (STEPS, 1.5)}
    finally:
        server.shutdown()
        server.server_close()
        state.shutdown()
        thread.join(timeout=10)
    assert not any(t.is_alive() for t in state._workers)
    assert not any(b.thread.is_alive() for b in state._batchers.values())
    for i, jid in enumerate(job_ids):
        assert _video_delta(jobs[jid]["output"], serial[i]) < MEAN_VIDEO_DELTA


def test_run_pipelined_in_job_order_equals_serial(setup, serial, tmp_path):
    root, pipe, audios = setup
    jobs = [(str(root / "avatar.mp4"), a, str(tmp_path / f"pipelined{i}.mp4"))
            for i, a in enumerate(audios)]
    outs = pipe.run_pipelined(jobs, num_inference_steps=STEPS, data_path=str(root / "avatar.npz"))
    assert [o.video_path for o in outs] == [j[2] for j in jobs]
    assert [o.num_frames for o in outs] == [32, 64, 32]
    assert not any(t.name == "run-pipelined" for t in threading.enumerate())
    for i, (_, _, out) in enumerate(jobs):
        assert _video_delta(out, serial[i]) < MEAN_VIDEO_DELTA


def test_run_pipelined_propagates_errors(setup, tmp_path):
    root, pipe, audios = setup
    jobs = [(str(root / "avatar.mp4"), audios[0], str(tmp_path / "ok.mp4")),
            ("/nonexistent/v.mp4", "/nonexistent/a.wav", str(tmp_path / "bad.mp4"))]
    with pytest.raises(Exception):
        pipe.run_pipelined(jobs, num_inference_steps=STEPS)
    assert not any(t.name == "run-pipelined" for t in threading.enumerate())


class _InTurn:
    """Stands in for threading.Thread: runs the target in the caller's
    thread when started (the work done in turn)."""

    def __init__(self, target, name=None, daemon=None):
        self.target = target

    def start(self):
        self.target()

    def join(self, timeout=None):
        pass


def test_prepare_reads_faces_on_a_thread_and_gives_the_same_state(setup, monkeypatch):
    root, pipe, audios = setup
    kw = dict(data_path=str(root / "avatar.npz"), mask_image_path=str(root / "mask.png"))
    seen = []
    load = plipsync.load_affine_bundle

    def spy(path):
        seen.append(threading.current_thread().name)
        return load(path)

    monkeypatch.setattr(plipsync, "load_affine_bundle", spy)
    threaded = pipe.prepare(str(root / "avatar.mp4"), audios[1], **kw)
    assert seen == ["prepare-faces"]
    assert threaded.timings["faces"] >= 0.0
    monkeypatch.setattr(plipsync.threading, "Thread", _InTurn)
    in_turn = pipe.prepare(str(root / "avatar.mp4"), audios[1], **kw)
    assert seen[1] == threading.current_thread().name
    for name in ("latents0", "mask_w", "masked_lat_w", "ref_lat_w", "audio_w"):
        assert torch.equal(getattr(threaded, name), getattr(in_turn, name)), name
    for name in ("frames", "masks", "pixel_values", "audio_samples"):
        np.testing.assert_array_equal(getattr(threaded, name), getattr(in_turn, name))
    np.testing.assert_array_equal(np.asarray(threaded.matrices), np.asarray(in_turn.matrices))
    np.testing.assert_array_equal(np.asarray(threaded.boxes), np.asarray(in_turn.boxes))
    assert (threaded.num_windows, threaded.num_frames) == (in_turn.num_windows, 16)
    assert set(threaded.timings) == set(in_turn.timings)


def test_prepare_raises_an_error_of_the_face_thread(setup, monkeypatch):
    root, pipe, audios = setup

    def broken(path):
        raise OSError("bundle unreadable")

    monkeypatch.setattr(plipsync, "load_affine_bundle", broken)
    with pytest.raises(OSError, match="bundle unreadable"):
        pipe.prepare(str(root / "avatar.mp4"), audios[0], data_path=str(root / "avatar.npz"))
    assert not any(t.name == "prepare-faces" for t in threading.enumerate())


# ---------------------------------------------------------------------------
# state that concurrent requests share
# ---------------------------------------------------------------------------


def test_restore_plans_under_concurrent_requests():
    """More align matrices than the native plan cache holds, restored from
    16 threads at once with a short switch interval: every result equals the
    one-thread result, and no plan is left in use or awaiting its free."""
    from latentsync_tpu_torch.utils import native

    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (2, 48, 48, 3), dtype=np.uint8)
    faces = rng.integers(0, 256, (2, 24, 24, 3), dtype=np.uint8)
    mats = [np.array([[1.0, 0.0, -4.0 - i], [0.0, 1.0, -6.0]]) for i in range(3 * 8)]
    want = [native.restore_frames_const_native(frames, faces, m) for m in mats]
    errors = []

    def work(k):
        try:
            for r in range(6):
                i = (5 * k + r) % len(mats)
                if not np.array_equal(native.restore_frames_const_native(frames, faces, mats[i]),
                                      want[i]):
                    errors.append(i)
        except Exception as e:  # noqa: BLE001 — reported by the assertion below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    cache = native._plan_cache
    assert not cache.users and not cache.retired and len(cache.entries) <= cache.cap


def test_default_detector_is_built_once_under_concurrent_first_use(monkeypatch):
    from latentsync_tpu_torch.utils import image_processor as ip

    monkeypatch.setattr(ip, "_detector_cache", {})
    built = []

    def slow_build(device):
        time.sleep(0.05)
        built.append(device)
        return object()

    monkeypatch.setattr(ip, "_build_default_landmark_detector", slow_build)
    got = []
    threads = [threading.Thread(target=lambda: got.append(ip.default_landmark_detector("cpu")))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert len(built) == 1 and len(got) == 8 and all(g is got[0] for g in got)
