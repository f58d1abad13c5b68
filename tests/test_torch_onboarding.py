"""Onboarding and the face path of a request, the port against the JAX
package, on the CPU in float32 with tiny models.

The same synthetic avatar video (rendered faces, moving a little), the same
small random FAN (one module of width 16, numpy-seeded, carried into the
port by its inverse converter) behind the Haar box stage, and the tiny
UNet / VAE / whisper of ``test_torch_pipeline.py``'s configuration go
through ``generate_affine_bundle`` and ``LipsyncPipeline.prepare`` without a
bundle on both sides; then the port's onboarding artifact: the
``_latents.npz`` that ``precompute_avatar_latents`` writes, the request
that skips its VAE encode, and the stale and legacy artifacts.

Tolerances: matrices within 1e-6 (landmarks agree to about 1e-5 px),
faces equal in uint8 but for a rounding step on a few values where a
LANCZOS4 tap sits on a rounding boundary, latents within 1e-4.
"""

import copy
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu import config as jcfg
from latentsync_tpu.audio.features import Audio2Feature as JAudio2Feature
from latentsync_tpu.models import face_detection as jfd
from latentsync_tpu.pipelines.lipsync import LipsyncPipeline as JPipeline
from latentsync_tpu.serving import artifacts as jart
from latentsync_tpu.training.synthetic_faces import render_face
from latentsync_tpu.utils import image_processor as jip
from latentsync_tpu.utils.convert import convert_unet, convert_vae, convert_whisper_encoder
from latentsync_tpu_torch import config as pcfg
from latentsync_tpu_torch.audio.features import Audio2Feature
from latentsync_tpu_torch.models import face_detection as pfd
from latentsync_tpu_torch.models.unet3d import UNet3DConditionModel
from latentsync_tpu_torch.models.vae import AutoencoderKL
from latentsync_tpu_torch.models.whisper import WhisperEncoder
from latentsync_tpu_torch.pipelines.lipsync import LipsyncPipeline
from latentsync_tpu_torch.scripts import prepare_video
from latentsync_tpu_torch.serving import artifacts as part
from latentsync_tpu_torch.utils import image_processor as pip_
from latentsync_tpu_torch.utils.convert import fan_state_dict_from_flax, init_random_
from latentsync_tpu_torch.utils.media import StreamingVideoWriter, write_audio

RES, N_FRAMES, HW = 64, 12, (200, 240)
MAT_TOL, LAT_TOL = 1e-6, 1e-4


def _configs(mod, mask="fix_mask"):
    unet = mod.UNet3DConfig(block_out_channels=(32, 64, 64, 64), layers_per_block=1,
                            norm_num_groups=8, cross_attention_dim=16, attention_head_dim=4,
                            motion_module=mod.MotionModuleConfig(num_attention_heads=4))
    return mod.LatentSyncConfig(
        unet=unet, vae=mod.VAEConfig(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                                     norm_num_groups=4),
        whisper=mod.WhisperConfig(n_audio_state=16, n_audio_head=2, n_audio_layer=1),
        data=mod.DataConfig(resolution=RES, mask=mask))


def _sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _fan_variables():
    """A one-module FAN of width 16 with seeded non-zero weights and
    statistics, in the JAX package's layout."""
    model = jfd.FAN2D(num_modules=1, features=16)
    x = jnp.zeros((1, 256, 256, 3))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x))
    rng = np.random.default_rng(7)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = 1 + 0.1 * rng.standard_normal(shape)
        elif name == "var":
            v = 1 + np.abs(0.3 * rng.standard_normal(shape))
        else:
            v = 0.05 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("onboard")
    rng = np.random.default_rng(3)
    frames = []
    for i in range(N_FRAMES):
        img, _ = render_face(np.random.default_rng(100), 150)  # one face, moving
        frame = np.full(HW + (3,), 80, np.uint8)
        y, x = 20 + i % 4, 40 + 2 * (i % 6)
        frame[y:y + 150, x:x + 150] = img
        frames.append(frame)
    writer = StreamingVideoWriter(str(root / "avatar.mp4"), fps=25, frame_hw=HW)
    writer.append(np.stack(frames))
    writer.close()
    write_audio(str(root / "speech.wav"),
                (0.3 * rng.standard_normal(int(16000 * 0.5))).astype(np.float32))
    variables = _fan_variables()
    fan_sd = fan_state_dict_from_flax(variables)
    jdet = jfd.FANLandmarkDetector(variables, face_detector=jfd.HaarBoxDetector())
    pdet = pfd.FANLandmarkDetector(fan_sd, face_detector=pfd.HaarBoxDetector(), device="cpu")

    cfg = _configs(pcfg)
    unet = init_random_(UNet3DConditionModel(cfg.unet), seed=21)
    vae = init_random_(AutoencoderKL(cfg.vae), seed=22)
    whisper = init_random_(WhisperEncoder(cfg.whisper), seed=23)
    j_audio = JAudio2Feature(_configs(jcfg).whisper, params=convert_whisper_encoder(
        {"encoder." + k: v for k, v in _sd(whisper).items()}))
    j_args = (convert_unet(_sd(unet), 13, 4, 16), convert_vae(_sd(vae)), j_audio)
    pipes = {}
    for mask in ("fix_mask", "mouth"):
        pipes[mask] = (
            LipsyncPipeline(unet, vae, Audio2Feature(whisper), _configs(pcfg, mask),
                            dtype=torch.float32, device="cpu", landmark_detector=pdet),
            JPipeline(*j_args, _configs(jcfg, mask), dtype=jnp.float32, landmark_detector=jdet))
    return root, jdet, pdet, pipes, vae


def test_generate_affine_bundle_matches_jax(setup):
    root, jdet, pdet, _, _ = setup
    video = str(root / "avatar.mp4")
    pb = part.generate_affine_bundle(pip_.ImageProcessor(RES, landmark_detector=pdet,
                                                         device="cpu"),
                                     video, str(root / "port_bundle.npz"))
    jb = jart.generate_affine_bundle(jip.ImageProcessor(RES, landmark_detector=jdet), video,
                                     str(root / "jax_bundle.npz"))
    (pf, pbox, pm), (jf, jbox, jm) = part.load_affine_bundle(pb), jart.load_affine_bundle(jb)
    assert pf.shape == jf.shape == (N_FRAMES, RES, RES, 3) and pf.dtype == np.uint8
    np.testing.assert_array_equal(np.asarray(pbox), np.asarray(jbox))
    np.testing.assert_allclose(np.stack(pm), np.stack(jm), atol=MAT_TOL)
    delta = np.abs(pf.astype(np.int32) - jf.astype(np.int32))
    assert delta.max() <= 1 and delta.mean() < 1e-3
    # the faces moved with the frames: the matrices are not all equal
    assert np.ptp(np.stack(pm)[:, :, 2], axis=0).max() > 1.0


@pytest.mark.parametrize("mask", ["fix_mask", "mouth"])
def test_prepare_without_a_bundle_matches_jax(setup, mask):
    """Stage 3 inside ``prepare``: the video read at 25 fps, every frame
    aligned (``affine_transform_batch``), then masks and encodes; with the
    mouth mode one KEEP mask a frame from live landmarks on each crop."""
    root, _, _, pipes, _ = setup
    port, jax_pipe = pipes[mask]
    args = (str(root / "avatar.mp4"), str(root / "speech.wav"))
    p_state = port.prepare(*args)
    j_state = jax_pipe.prepare(*args)
    assert p_state.num_windows == j_state.num_windows == 1
    np.testing.assert_allclose(np.stack(p_state.matrices), np.stack(j_state.matrices),
                               atol=MAT_TOL)
    assert [list(b) for b in p_state.boxes] == [list(b) for b in j_state.boxes]
    for name in ("mask_w", "masked_lat_w", "ref_lat_w", "audio_w"):
        np.testing.assert_allclose(getattr(p_state, name).numpy(),
                                   np.asarray(getattr(j_state, name)), atol=LAT_TOL,
                                   rtol=LAT_TOL, err_msg=name)
    np.testing.assert_array_equal(p_state.masks, j_state.masks)
    mask_w = p_state.mask_w.numpy()
    per_frame = not np.all(mask_w == mask_w[:1, :1])
    assert per_frame == (mask == "mouth")
    assert "faces" in p_state.timings and "vae_encode" in p_state.timings


def test_request_without_a_bundle_through_call(setup, tmp_path):
    root, _, _, pipes, _ = setup
    port, _ = pipes["fix_mask"]
    out = port(str(root / "avatar.mp4"), str(root / "speech.wav"), str(tmp_path / "o.mp4"),
               num_inference_steps=1)
    assert out.num_frames == 16 and os.path.isfile(out.video_path)


def _spy_encodes(pipe, monkeypatch):
    calls = []
    real = pipe._vae_encode_pair

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(pipe, "_vae_encode_pair", spy)
    return calls


def test_precomputed_latents_skip_the_encode(setup, tmp_path, monkeypatch):
    root, _, pdet, pipes, _ = setup
    port, _ = pipes["fix_mask"]
    bundle = part.generate_affine_bundle(
        pip_.ImageProcessor(RES, landmark_detector=pdet, device="cpu"),
        str(root / "avatar.mp4"), str(tmp_path / "alice.npz"))
    args = (str(root / "avatar.mp4"), str(root / "speech.wav"))
    fresh = port.prepare(*args, data_path=bundle)
    lat_path = port.precompute_avatar_latents(bundle)
    assert lat_path == str(tmp_path / "alice_latents.npz")
    with np.load(lat_path) as d:
        assert d["masked_lat"].shape == (N_FRAMES, RES // 8, RES // 8, 4)
        assert str(d["mask_mode"]) == "fix_mask" and int(d["resolution"]) == RES
        assert str(d["fingerprint"]) == port._artifact_fingerprint(pip_.load_fixed_mask(RES))
    calls = _spy_encodes(port, monkeypatch)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a valid artifact warns of nothing
        state = port.prepare(*args, data_path=bundle)
    assert calls == []
    # the same latents (the fresh encode ran at another batch size: f32 sums
    # in another order)
    for name in ("masked_lat_w", "ref_lat_w", "mask_w"):
        torch.testing.assert_close(getattr(state, name), getattr(fresh, name), rtol=LAT_TOL,
                                   atol=LAT_TOL)


def test_stale_legacy_and_reference_artifacts(setup, tmp_path, monkeypatch):
    """Another VAE or mask makes the fingerprint stale: the request warns and
    encodes. An artifact with no fingerprint (a legacy one) is taken on
    shape, resolution and mask mode, with a warning. The JAX package's own
    artifact carries its fingerprint, which the port's never equals: it is
    stale here, and re-encoded."""
    root, _, pdet, pipes, vae = setup
    port, jax_pipe = pipes["fix_mask"]
    bundle = part.generate_affine_bundle(
        pip_.ImageProcessor(RES, landmark_detector=pdet, device="cpu"),
        str(root / "avatar.mp4"), str(tmp_path / "bob.npz"))
    args = (str(root / "avatar.mp4"), str(root / "speech.wav"))
    lat_path = port.precompute_avatar_latents(bundle)
    calls = _spy_encodes(port, monkeypatch)
    # another mask image
    other_mask = str(tmp_path / "mask.png")
    import cv2

    cv2.imwrite(other_mask, np.full((64, 64, 3), 255, np.uint8))
    with pytest.warns(UserWarning, match="stale"):
        port.prepare(*args, data_path=bundle, mask_image_path=other_mask)
    assert len(calls) == 1
    # a legacy artifact: no fingerprint
    with np.load(lat_path) as d:
        kept = {k: d[k] for k in d.files if k != "fingerprint"}
    np.savez(lat_path, **kept)
    with pytest.warns(UserWarning, match="no VAE-weights fingerprint"):
        port.prepare(*args, data_path=bundle)
    assert len(calls) == 1
    # the JAX package's artifact for the same bundle
    jax_pipe.precompute_avatar_latents(bundle)
    with pytest.warns(UserWarning, match="stale"):
        port.prepare(*args, data_path=bundle)
    assert len(calls) == 2
    # other VAE weights (the artifact is written anew first: one encode)
    port.precompute_avatar_latents(bundle)
    assert len(calls) == 3
    with torch.no_grad():
        for p in port.vae.parameters():
            p.add_(1e-3)
    try:
        with pytest.warns(UserWarning, match="stale"):
            port.prepare(*args, data_path=bundle)
        assert len(calls) == 4
    finally:
        with torch.no_grad():
            for p in port.vae.parameters():
                p.sub_(1e-3)


def test_prepare_video_entry_point(setup, tmp_path, monkeypatch, capsys):
    """The onboarding entry point on the CPU: the video copied into the
    store, the bundle from the default landmark detector (here the small
    FAN as a ``.pth`` at ``$LATENTSYNC_FAN_CKPT``), and with a VAE file the
    latent artifact, which a serving pipeline of the same weights in
    bfloat16 (the serving dtype, in which the entry point encodes) reads as
    valid."""
    root, _, pdet, pipes, vae = setup
    fan_path = str(tmp_path / "fan.pth")
    torch.save(pdet.model.state_dict(), fan_path)
    monkeypatch.setenv("LATENTSYNC_FAN_CKPT", fan_path)
    monkeypatch.setenv("LATENTSYNC_S3FD_CKPT", "/nonexistent.npz")
    tiny = _configs(pcfg)  # the entry point builds the tiny VAE
    monkeypatch.setattr(pcfg, "LatentSyncConfig", lambda: tiny)
    vae_path = str(tmp_path / "vae.pt")
    torch.save(vae.state_dict(), vae_path)
    store = str(tmp_path / "store")
    rc = prepare_video.main(["--video", str(root / "avatar.mp4"), "--avatar-id", "carol",
                             "--store", store, "--resolution", str(RES), "--device", "cpu",
                             "--vae-ckpt", vae_path])
    assert rc == 0
    record = __import__("json").loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["bundle"] == os.path.join(store, "carol.npz")
    assert record["latents"] == os.path.join(store, "carol_latents.npz")
    faces, boxes, mats = part.load_affine_bundle(record["bundle"])
    assert faces.shape == (N_FRAMES, RES, RES, 3) and len(boxes) == len(mats) == N_FRAMES
    f32, _ = pipes["fix_mask"]
    port = LipsyncPipeline(copy.deepcopy(f32.unet), copy.deepcopy(f32.vae), f32.audio_encoder,
                           f32.config, device="cpu", landmark_detector=pdet)
    assert port.dtype == torch.bfloat16
    calls = _spy_encodes(port, monkeypatch)
    state = port.prepare(record["video"], str(root / "speech.wav"),
                         data_path=record["bundle"])
    assert calls == [] and state.masked_lat_w.shape[0] == 1
