"""The port's serving slice against the JAX pipeline, on the CPU in float32.

Tiny configs (resolution 64, 2 DDIM steps, CFG 1.5), the same random
non-zero weights (the port's ``init_random_`` carried into flax by the
JAX package's converters), the same avatar bundle and the same injected
initial noise x_T go through both ``LipsyncPipeline``s. The decoded
mouth crops are compared in uint8 and the written videos by pixel delta.
A second test serves one request through the port's HTTP server.
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
from latentsync_tpu_torch import config as pcfg
from latentsync_tpu_torch.audio.features import Audio2Feature
from latentsync_tpu_torch.models.unet3d import UNet3DConditionModel
from latentsync_tpu_torch.models.vae import AutoencoderKL
from latentsync_tpu_torch.models.whisper import WhisperEncoder
from latentsync_tpu_torch.pipelines.lipsync import LipsyncPipeline
from latentsync_tpu_torch.serving.api import ServingState, make_handler
from latentsync_tpu_torch.serving.artifacts import AvatarStore
from latentsync_tpu_torch.utils.convert import init_random_
from latentsync_tpu_torch.utils.image_processor import load_fixed_mask, read_png
from latentsync_tpu_torch.utils.media import StreamingVideoWriter, read_video, write_audio

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
    mask = read_png(os.path.join(os.path.dirname(pcfg.__file__), "utils", "assets", "mask.png"))
    cv2.imwrite(str(root / "mask.png"), np.ascontiguousarray(mask[::4, ::4, ::-1]))

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

    j_out = jax_pipe.finish(j_state, None, str(root / "jax.mp4"), pieces=j_pieces)
    p_out = port.finish(p_state, None, str(root / "port.mp4"), pieces=p_pieces)
    assert p_out.num_frames == j_out.num_frames == 32
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
    """The port reads the mouth mask with zlib + numpy; OpenCV agrees."""
    path = os.path.join(os.path.dirname(pcfg.__file__), "utils", "assets", "mask.png")
    ref = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(read_png(path), ref)
    np.testing.assert_array_equal(load_fixed_mask(256), ref.astype(np.float32) / 255.0)
    small = load_fixed_mask(64)  # other resolutions resize through native/restore.cpp
    assert small.shape == (64, 64, 3) and 0.0 <= small.min() and small.max() <= 1.0
