"""LipsyncPipeline: avatar video + audio in → lip-synced video out.

Counterpart of ``latentsync_tpu/pipelines/lipsync.py`` at reference
semantics. A request names an avatar video and either a precomputed
``{faces, boxes, affine_matrices}`` bundle (``data_path``; with the
``_latents.npz`` artifact of ``precompute_avatar_latents`` beside it, the
VAE encode is skipped) or none, and then the FAN face path aligns every
frame (``ImageProcessor.affine_transform_batch``, the landmark model on the
pipeline's device). Then: 16-frame windows denoised in batches
with classifier-free guidance folded into the batch (unconditional =
zero audio first, conditional second), DDIM, one noise frame shared by
every frame, VAE decode, mouth composite and the host inverse-warp
paste-back of ``native/restore.cpp``. The public API, the ``JobState``
fields and the keys of ``JobState.timings`` are the JAX package's; its
tensors keep the JAX layouts ((W, F, h, w, C) latents, (W, F, S, D)
audio) and live on the pipeline's device.

Stage timers. The host-side keys read the host's clock, and launches on a
CUDA device return before the work is done: ``vae_encode`` and
``denoise_dispatch`` are the time to enqueue their stage. Each decoded
chunk's copy to the host is enqueued right behind its decode, into pinned
memory, and ``finish`` waits for the chunks on a fetch thread while the
calling thread restores: ``vae_decode`` is the fetch thread's busy time (the
device's tail included) and ``restore`` the restoring thread's, so
``vae_decode + restore > decode_restore_total`` shows the overlap. Beside
them, on a CUDA device only (absent on the CPU, not zero),
``device_vae_encode``, ``device_denoise`` and ``device_vae_decode``
are device seconds between CUDA events recorded around each stage on the
current stream and read once, after the request's last fetch: no
synchronisation is added inside the request. The reference's int8 switches (``LATENTSYNC_INT8``,
``LATENTSYNC_INT8_DENSE``) are read by the models at each call, so one
pipeline serves whichever configuration the environment names at that
call. Not ported yet: DeepCache and the CFG interval (their switches raise
rather than serve another operating point) and ``run_pipelined``.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import queue
import tempfile
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..audio.features import Audio2Feature
from ..config import LatentSyncConfig
from ..models.unet3d import UNet3DConditionModel
from ..models.vae import AutoencoderKL, scale_latents, unscale_latents
from ..ops.ddim import DDIMScheduler
from ..serving.artifacts import load_affine_bundle
from ..utils import repeat as lrepeat
from ..utils.image_processor import ImageProcessor, load_fixed_mask
from ..utils.media import StreamingVideoWriter, read_audio, read_video, write_audio
from ..utils.native import restore_lib


def _bucket(n: int, buckets=(1, 2, 4, 8, 16, 32, 64, 128)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n


def _refuse_unported_switches() -> None:
    """DeepCache and the CFG interval are not ported: a request under their
    switches must fail, not run at the reference semantics silently."""
    dc = os.environ.get("LATENTSYNC_DEEPCACHE", "")
    if dc not in ("", "0"):
        raise NotImplementedError(f"LATENTSYNC_DEEPCACHE={dc!r}: DeepCache is not ported yet")
    ci = os.environ.get("LATENTSYNC_CFG_INTERVAL", "")
    if ci:
        raise NotImplementedError(
            f"LATENTSYNC_CFG_INTERVAL={ci!r}: the CFG interval is not ported yet")


def _nearest_indices(n_in: int, n_out: int) -> torch.Tensor:
    """jax.image.resize "nearest" source indices: floor((i + 0.5)·in/out)."""
    return ((torch.arange(n_out, dtype=torch.float64) + 0.5) * n_in / n_out).floor().long()


@dataclass
class PipelineOutput:
    video_path: str
    num_frames: int
    elapsed: dict


@dataclass
class JobState:
    latents0: torch.Tensor     # (W, F, h, w, 4) float32
    mask_w: torch.Tensor       # (W, F, h, w, 1)
    masked_lat_w: torch.Tensor
    ref_lat_w: torch.Tensor
    audio_w: torch.Tensor      # (W, F, S, D)
    frames: Optional[np.ndarray]  # None once finish has pasted into them
    boxes: list
    matrices: list
    masks: np.ndarray
    pixel_values: np.ndarray
    audio_samples: np.ndarray
    num_frames: int
    num_windows: int
    video_fps: int
    audio_sample_rate: int
    lat_hw: int
    processor: object
    timings: dict
    start_time: float
    # device stage -> [(start, end) CUDA events]; empty on a CPU device
    device_events: dict = field(default_factory=dict)


@dataclass
class HostCopy:
    """A decoded chunk on its way to the host: the pinned buffer its copy was
    enqueued into and the CUDA event recorded behind the copy."""
    host: torch.Tensor
    event: object


def _to_host(dev: torch.Tensor):
    """Enqueue the copy of a decoded chunk to the host behind the work that
    produces it. On the CPU the piece is the tensor itself."""
    if dev.device.type != "cuda":
        return dev
    dev = dev.contiguous()
    host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
    host.copy_(dev, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return HostCopy(host, event)


def _fetched(piece) -> np.ndarray:
    """The chunk of a piece on the host, once it is there."""
    if isinstance(piece, HostCopy):
        piece.event.synchronize()  # releases the GIL while it waits
        return piece.host.numpy()
    return piece.cpu().numpy()


class LipsyncPipeline:
    def __init__(self, unet: Optional[UNet3DConditionModel], vae: AutoencoderKL,
                 audio_encoder: Optional[Audio2Feature],
                 config: LatentSyncConfig = LatentSyncConfig(),
                 dtype: torch.dtype = torch.bfloat16,
                 device: Optional[torch.device] = None, landmark_detector=None):
        """`landmark_detector`: the face path's landmark source; by default
        ``ImageProcessor``'s (the FAN on this pipeline's device). `unet` and
        `audio_encoder` may be None for a pipeline that only onboards
        (``precompute_avatar_latents``); it serves no request."""
        self.config = config
        self.landmark_detector = landmark_detector
        self.dtype = dtype
        # the pipeline runs on the card unless the caller asks for another
        # device: models built on the CPU are moved, never followed there
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("LipsyncPipeline: no CUDA device (torch.cuda.is_available() is "
                               "false); pass device='cpu' to run on the CPU")
        self.unet = None if unet is None else unet.to(self.device, dtype).eval()
        self.vae = vae.to(self.device, dtype).eval()
        if audio_encoder is not None:
            audio_encoder.model.to(self.device)
        self.audio_encoder = audio_encoder
        self.scheduler = DDIMScheduler.create(config.scheduler)
        # build the paste-back library now: a missing toolchain fails here,
        # and the first request does not pay for the build
        restore_lib()

    # ------------------------------------------------------------------
    # device stages
    # ------------------------------------------------------------------

    @contextlib.contextmanager
    def _device_stage(self, events: dict, name: str):
        """Record a CUDA event before and after the block on the current
        stream and keep the pair under `name`; nothing on a CPU device."""
        if self.device.type != "cuda":
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            events.setdefault(name, []).append((start, end))

    def _processor(self, res: int, mask_image) -> ImageProcessor:
        return ImageProcessor(res, mask=self.config.data.mask, mask_image=mask_image,
                              landmark_detector=self.landmark_detector, device=self.device)

    @torch.inference_mode()
    def _vae_encode_pair(self, faces_u8: np.ndarray, keep: np.ndarray, chunk: int = 64):
        """uint8 faces (N, H, W, 3) + KEEP mask, (1, H, W, C) shared by the
        clip or (N, H, W, C) one a frame → scaled (masked_latents,
        ref_latents), each (N, h, w, 4) float32."""
        cfg = self.config.vae
        m = torch.from_numpy(np.ascontiguousarray(keep)).to(self.device).permute(0, 3, 1, 2)
        zms, zrs = [], []
        for i in range(0, len(faces_u8), chunk):
            f = torch.from_numpy(faces_u8[i:i + chunk]).to(self.device)
            pix = (f.float() / 255.0 * 2.0 - 1.0).permute(0, 3, 1, 2)
            mk = m if m.shape[0] == 1 else m[i:i + chunk]
            zr = scale_latents(self.vae.encode(pix.to(self.dtype)), cfg)
            zm = scale_latents(self.vae.encode((pix * mk).to(self.dtype)), cfg)
            zms.append(zm.float().permute(0, 2, 3, 1))
            zrs.append(zr.float().permute(0, 2, 3, 1))
        return torch.cat(zms), torch.cat(zrs)

    @torch.inference_mode()
    def _decode_u8(self, latents: torch.Tensor) -> torch.Tensor:
        """(N, h, w, 4) scaled latents → (N, H, W, 3) uint8 on the device."""
        z = unscale_latents(latents.permute(0, 3, 1, 2), self.config.vae).to(self.dtype)
        img = self.vae.decode(z).float()
        return ((img + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)

    @torch.inference_mode()
    def _denoise(self, latents0, mask_l, masked_l, ref_l, audio, num_steps: int,
                 guidance: float) -> torch.Tensor:
        """One window batch: latents0/mask/masked/ref (W, F, h, w, C), audio
        (W, F, S, D) → denoised latents (W, F, h, w, 4) float32."""
        _refuse_unported_switches()
        dt = self.dtype
        w = latents0.shape[0]
        do_cfg = guidance > 1.0
        steps, alpha_t, alpha_prev = self.scheduler.step_tables(num_steps)
        to_ncfhw = (0, 4, 1, 2, 3)
        cond = torch.cat([mask_l, masked_l, ref_l], dim=-1).permute(*to_ncfhw).to(dt)
        audio = audio.to(dt)
        if do_cfg:
            cond = torch.cat([cond, cond])
            audio = torch.cat([torch.zeros_like(audio), audio])  # uncond first
        lat = latents0.permute(*to_ncfhw).float()
        for j in range(num_steps):
            lat_in = torch.cat([lat, lat]) if do_cfg else lat
            unet_in = torch.cat([lat_in.to(dt), cond], dim=1)
            t = torch.full((unet_in.shape[0],), int(steps[j]), device=self.device)
            eps = self.unet(unet_in, t, audio).float()
            if do_cfg:
                eps_u, eps_a = eps[:w], eps[w:]
                eps = eps_u + guidance * (eps_a - eps_u)
            lat = DDIMScheduler.step(eps, lat, alpha_t[j], alpha_prev[j])
        return lat.permute(0, 2, 3, 4, 1)

    # ------------------------------------------------------------------
    # host orchestration
    # ------------------------------------------------------------------

    def prepare(self, video_path: str, audio_path: str, num_frames: int = 16,
                video_fps: int = 25, audio_sample_rate: int = 16000, seed: int = 1247,
                mask_image_path: Optional[str] = None, data_path: Optional[str] = None,
                height: Optional[int] = None) -> JobState:
        """Stages 1-4: faces (the bundle's, or the face path's), audio
        features, VAE encodes (or the bundle's latent artifact), shared
        noise."""
        if self.unet is None or self.audio_encoder is None:
            raise RuntimeError("LipsyncPipeline: built without a UNet or an audio encoder, it "
                               "only onboards (precompute_avatar_latents)")
        t_start = time.time()
        cfg = self.config
        res = height or cfg.data.resolution
        timings, device_events = {}, {}

        t0 = time.time()
        mask_image = load_fixed_mask(res, mask_image_path)
        processor = self._processor(res, mask_image)
        stored_latents = None
        if data_path:
            faces, boxes, matrices = load_affine_bundle(data_path)
            frames = read_video(video_path, change_fps=False)
            stored_latents = self._stored_latents(data_path, len(faces), res, mask_image)
        else:
            frames = read_video(video_path, change_fps=True, fps=video_fps)
            faces, boxes, matrices = processor.affine_transform_batch(frames)
        timings["faces"] = time.time() - t0

        t0 = time.time()
        audio_samples = read_audio(audio_path, audio_sample_rate)
        feats = self.audio_encoder.audio2feat(audio_samples)
        chunks = self.audio_encoder.feature2chunks(feats, fps=video_fps)
        timings["audio_device"] = time.time() - t0

        t0 = time.time()
        chunks, audio_samples, _ = lrepeat.pad_chunks_end(
            chunks.astype(np.float32), audio_samples, audio_sample_rate, fps=video_fps,
            multiple=num_frames)
        num_chunks = len(chunks)
        if num_chunks > len(faces):
            faces = lrepeat.repeat_to_length(faces, num_chunks)
            boxes = lrepeat.repeat_to_length(boxes, num_chunks)
            matrices = lrepeat.repeat_to_length(matrices, num_chunks)
        timings["audio"] = time.time() - t0

        num_windows = num_chunks // num_frames
        total = num_windows * num_frames
        faces = faces[:total]

        t0 = time.time()
        faces_rs = processor.resize_batch(faces)
        pixel_values = processor.normalize(faces_rs)
        keep = processor.keep_mask(faces_rs)
        masks = np.ascontiguousarray(
            np.broadcast_to(keep[..., :1], pixel_values.shape[:3] + (1,)))
        lat_hw = res // cfg.vae.scale_factor
        if stored_latents is not None:  # the onboarding artifact: no encode
            masked_lat, ref_lat = (
                torch.from_numpy(lrepeat.repeat_to_length(z, num_chunks)[:total]).to(self.device)
                for z in stored_latents)
        else:
            with self._device_stage(device_events, "vae_encode"):
                masked_lat, ref_lat = self._vae_encode_pair(faces_rs, keep)
        idx = _nearest_indices(keep.shape[1], lat_hw)
        keep_small = torch.from_numpy(keep[:, :, :, :1])[:, idx][:, :, idx].to(self.device)
        # one mask for the clip, or one a frame (the landmark modes)
        mask_small = keep_small.expand(total, lat_hw, lat_hw, 1) if keep.shape[0] == 1 \
            else keep_small
        timings["vae_encode"] = time.time() - t0

        # one frame of noise repeated over every frame of every window
        gen = torch.Generator().manual_seed(seed)
        base_noise = torch.randn((1, 1, lat_hw, lat_hw, 4), generator=gen).to(self.device)
        latents0 = base_noise.expand(num_windows, num_frames, lat_hw, lat_hw, 4) \
            * self.scheduler.init_noise_sigma

        def window_shape(x):
            return x.reshape((num_windows, num_frames) + tuple(x.shape[1:]))

        audio_w = torch.from_numpy(chunks[:total]).to(self.device).reshape(
            num_windows, num_frames, chunks.shape[1], chunks.shape[2])
        return JobState(
            latents0=latents0, mask_w=window_shape(mask_small),
            masked_lat_w=window_shape(masked_lat), ref_lat_w=window_shape(ref_lat),
            audio_w=audio_w, frames=frames, boxes=boxes, matrices=matrices, masks=masks,
            pixel_values=pixel_values, audio_samples=audio_samples, num_frames=num_frames,
            num_windows=num_windows, video_fps=video_fps,
            audio_sample_rate=audio_sample_rate, lat_hw=lat_hw, processor=processor,
            timings=timings, start_time=t_start, device_events=device_events)

    def _stored_latents(self, data_path: str, n_faces: int, res: int, mask_image):
        """The bundle's ``_latents.npz`` (masked, reference latents) when it
        fits this request: this pipeline's VAE weights and mask (its
        fingerprint), the bundle's face count, the resolution and the mask
        mode. An artifact without a fingerprint (a legacy one) is taken on
        the rest, with a warning; a stale one is ignored, and the request
        encodes."""
        lat_path = os.path.splitext(data_path)[0] + "_latents.npz"
        if not os.path.isfile(lat_path):
            return None
        with np.load(lat_path, allow_pickle=False) as d:
            legacy = "fingerprint" not in d.files
            fits = (legacy or str(d["fingerprint"]) == self._artifact_fingerprint(mask_image)) \
                and d["masked_lat"].shape[0] == n_faces and int(d["resolution"]) == res \
                and str(d["mask_mode"]) == self.config.data.mask
            latents = (d["masked_lat"], d["ref_lat"]) if fits else None
        if latents is None:
            warnings.warn(f"avatar latent artifact {lat_path} is stale (VAE weights, mask or "
                          "shape changed since onboarding): encoding this request; re-run "
                          "precompute_avatar_latents", stacklevel=2)
        elif legacy:
            warnings.warn(f"avatar latent artifact {lat_path} has no VAE-weights fingerprint; "
                          "accepted on shape, resolution and mask mode: re-run "
                          "precompute_avatar_latents to add one", stacklevel=2)
        return latents

    def _artifact_fingerprint(self, mask_image) -> str:
        """Identity of what the avatar latents depend on besides the video:
        the VAE's state dict (every name and shape, and the first 16 values
        of four tensors spread over it) and the mask image."""
        h = hashlib.md5()
        items = list(self.vae.state_dict().items())
        for name, t in items:
            h.update(name.encode())
            h.update(str(tuple(t.shape)).encode())
        for _, t in items[::max(1, len(items) // 4)][:4]:
            h.update(t.detach().reshape(-1)[:16].float().cpu().numpy().tobytes())
        if mask_image is not None:
            h.update(np.ascontiguousarray(mask_image).tobytes())
        return h.hexdigest()

    def precompute_avatar_latents(self, data_path: str, mask_image_path: Optional[str] = None,
                                  height: Optional[int] = None) -> str:
        """Onboarding: VAE-encode a bundle's faces once and keep (masked_lat,
        ref_lat) beside it as ``<bundle>_latents.npz``, with the resolution,
        the mask mode and the fingerprint; ``prepare`` then skips the
        encode. Returns the artifact's path."""
        res = height or self.config.data.resolution
        mask_image = load_fixed_mask(res, mask_image_path)
        faces, _, _ = load_affine_bundle(data_path)
        processor = self._processor(res, mask_image)
        faces_rs = processor.resize_batch(faces)
        masked_lat, ref_lat = self._vae_encode_pair(faces_rs, processor.keep_mask(faces_rs))
        lat_path = os.path.splitext(data_path)[0] + "_latents.npz"
        np.savez(lat_path, masked_lat=masked_lat.float().cpu().numpy(),
                 ref_lat=ref_lat.float().cpu().numpy(), resolution=res,
                 mask_mode=self.config.data.mask,
                 fingerprint=self._artifact_fingerprint(mask_image))
        return lat_path

    def denoise_decode_chunks(self, state: JobState, num_inference_steps: int = 20,
                              guidance_scale: float = 1.5, window_batch: int = 2):
        """Stages 5-6: each window batch is denoised and decoded at once, and
        the copy of its frames to the host is enqueued behind the decode.
        Returns [(slice into the clip's frames, the uint8 frames: a
        `HostCopy` on a CUDA device, the tensor itself on the CPU)]; a short
        last batch is padded by repeating its last window."""
        t0 = time.time()
        nw, nf, hw = state.num_windows, state.num_frames, state.lat_hw
        wb = min(_bucket(nw), window_batch)
        pieces = []
        for i in range(0, nw, wb):
            sl = slice(i, min(i + wb, nw))
            n = sl.stop - sl.start

            def padw(x):
                part = x[sl]
                if n == wb:
                    return part
                return torch.cat([part, part[-1:].expand((wb - n,) + tuple(part.shape[1:]))])

            with self._device_stage(state.device_events, "denoise"):
                lat = self._denoise(padw(state.latents0), padw(state.mask_w),
                                    padw(state.masked_lat_w), padw(state.ref_lat_w),
                                    padw(state.audio_w), num_inference_steps, guidance_scale)
            with self._device_stage(state.device_events, "vae_decode"):
                dev = self._decode_u8(lat.reshape(wb * nf, hw, hw, 4))
            pieces.append((slice(i * nf, (i + n) * nf), _to_host(dev)))
        # launches are asynchronous: this is the time to enqueue the stage
        state.timings["denoise_dispatch"] = time.time() - t0
        return pieces

    @staticmethod
    def _restore_group(frames, combined, mats, crop_hw):
        """Resize faces to their box and inverse-warp them into the frames
        (in place) with the native restore library."""
        native = restore_lib()
        resized = native.resize_frames_native(combined, crop_hw)
        if all(np.array_equal(m, mats[0]) for m in mats[1:]):
            return native.restore_frames_const_native(frames, resized, mats[0], copy=False)
        return native.restore_frames_native(frames, resized, mats, copy=False)

    def finish(self, state: JobState, latents: Optional[torch.Tensor],
               video_out_path: str, pieces=None) -> PipelineOutput:
        """Stages 6-8: decode (unless `pieces` is given), composite, restore
        and write. On any failure the partial output is removed. It consumes
        `state`: the faces are pasted into `state.frames` itself, which is
        then dropped from the state, so a second finish of one state raises."""
        if state.frames is None:
            raise RuntimeError("finish: this JobState was finished already "
                               "(its frames were pasted in place)")
        timings = state.timings
        nf = state.num_frames
        total = state.num_windows * nf
        t0 = time.time()
        if pieces is None:
            hw = state.lat_hw
            lat = latents.reshape(total, hw, hw, 4)
            pieces = []
            for i in range(0, total, 64):
                with self._device_stage(state.device_events, "vae_decode"):
                    dev = self._decode_u8(lat[i:i + 64])
                pieces.append((slice(i, min(i + 64, total)), _to_host(dev)))
        m_all = state.masks[..., :1].astype(np.float32)
        pix_u8 = np.clip((state.pixel_values + 1.0) * 127.5, 0, 255)
        mats = np.stack([np.asarray(m, np.float64) for m in state.matrices[:total]])
        crop_hws = [(int(b[3] - b[1]), int(b[2] - b[0])) for b in state.boxes[:total]]
        # finish owns the JobState: the faces are pasted INTO its decoded
        # frame array, which is not copied first
        frames = np.asarray(state.frames)
        state.frames = None
        n_src = len(frames)
        out_frames = frames[: min(total, n_src)]
        if not out_frames.flags.writeable:
            out_frames = out_frames.copy()
        # frames past the source clip (audio padded to whole windows) wrap
        # around to its start: only those are copied, into a small tail buffer
        tail = frames[np.arange(n_src, total) % n_src] if total > n_src else out_frames[:0]

        def seg_views(gsl):
            """A global frame slice as (buffer, buffer slice, offset into the
            chunk) segments over the main and the tail array."""
            segs = []
            if gsl.start < n_src:
                segs.append((out_frames, slice(gsl.start, min(gsl.stop, n_src)), 0))
            if gsl.stop > n_src:
                lo = max(gsl.start, n_src)
                segs.append((tail, slice(lo - n_src, gsl.stop - n_src), lo - gsl.start))
            return segs

        audio_keep = int(total / state.video_fps * state.audio_sample_rate)
        restore_s = 0.0
        # The fetch thread waits for each chunk in turn and hands it over
        # through a short queue while this thread restores the one before.
        # A failure there travels through the queue too; `stop` releases
        # the thread if this side fails first.
        fetch_q: queue.Queue = queue.Queue(maxsize=2)
        fetch_busy = [0.0]
        stop = threading.Event()

        def hand_over(item) -> bool:
            while not stop.is_set():
                try:
                    fetch_q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def fetch():
            try:
                for sl, piece in pieces:
                    tc = time.time()
                    dec_u8 = _fetched(piece)[: sl.stop - sl.start]
                    fetch_busy[0] += time.time() - tc
                    if not hand_over((sl, dec_u8)):
                        return
                hand_over(None)
            except Exception as e:  # noqa: BLE001 — raised anew by the consumer
                hand_over(e)

        fetch_thread = threading.Thread(target=fetch, name="finish-fetch", daemon=True)
        with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(video_out_path))) \
                as tmp:
            t0w = time.time()
            wav_path = os.path.join(tmp, "audio.wav")
            write_audio(wav_path, state.audio_samples[:audio_keep], state.audio_sample_rate)
            writer = StreamingVideoWriter(video_out_path, fps=state.video_fps,
                                          frame_hw=out_frames.shape[1:3], audio_path=wav_path)
            audio_write_s = time.time() - t0w
            try:
                fetch_thread.start()
                while True:
                    item = fetch_q.get()
                    if item is None:
                        break
                    if isinstance(item, Exception):
                        raise RuntimeError(
                            f"finish: fetching a decoded chunk failed: {item!r}") from item
                    sl, dec_u8 = item
                    tc = time.time()
                    m = m_all[sl]
                    combined = (dec_u8 * (1.0 - m) + pix_u8[sl] * m).astype(np.uint8)
                    # each face is resized to ITS OWN box: group by crop size
                    groups = {}
                    for idx in range(sl.start, sl.stop):
                        groups.setdefault(crop_hws[idx], []).append(idx)
                    for crop_hw, idxs in groups.items():
                        if len(groups) == 1:
                            # one crop size (the served case): restore the chunk
                            # in place through slice views, no fancy-index copies
                            for buf, bsl, off in seg_views(sl):
                                n = bsl.stop - bsl.start
                                view = buf[bsl]
                                restored = self._restore_group(
                                    view, combined[off:off + n],
                                    mats[sl.start + off:sl.start + off + n], crop_hw)
                                if restored is not view:
                                    buf[bsl] = restored
                            continue
                        idxs = np.asarray(idxs)
                        in_main = idxs < n_src
                        for buf, gidx, base in ((out_frames, idxs[in_main], 0),
                                                (tail, idxs[~in_main], n_src)):
                            if len(gidx):
                                buf[gidx - base] = self._restore_group(
                                    buf[gidx - base], combined[gidx - sl.start], mats[gidx],
                                    crop_hw)
                    restore_s += time.time() - tc
                    # the chunk's frames are final: main segment, then wrapped tail
                    for buf, bsl, _ in seg_views(sl):
                        writer.append(buf[bsl])
                # every fetch has returned, so every stage's events are complete
                for name, pairs in state.device_events.items():
                    timings["device_" + name] = sum(s.elapsed_time(e) for s, e in pairs) / 1e3
                timings["vae_decode"] = fetch_busy[0]
                timings["restore"] = restore_s
                timings["decode_restore_total"] = time.time() - t0
                t1 = time.time()
                video_out_path = writer.close()
            except BaseException:
                writer.abort()
                raise
            finally:
                stop.set()
                if fetch_thread.ident is not None:
                    fetch_thread.join()
        timings["write"] = writer.busy_s + audio_write_s
        timings["write_wait"] = time.time() - t1
        timings["total"] = time.time() - state.start_time
        return PipelineOutput(video_path=video_out_path, num_frames=total, elapsed=timings)

    def __call__(self, video_path: str, audio_path: str, video_out_path: str,
                 num_frames: int = 16, video_fps: int = 25, audio_sample_rate: int = 16000,
                 num_inference_steps: int = 20, guidance_scale: float = 1.5, seed: int = 1247,
                 mask_image_path: Optional[str] = None, data_path: Optional[str] = None,
                 window_batch: int = 2, height: Optional[int] = None) -> PipelineOutput:
        state = self.prepare(video_path, audio_path, num_frames=num_frames,
                             video_fps=video_fps, audio_sample_rate=audio_sample_rate,
                             seed=seed, mask_image_path=mask_image_path, data_path=data_path,
                             height=height)
        pieces = self.denoise_decode_chunks(state, num_inference_steps=num_inference_steps,
                                            guidance_scale=guidance_scale,
                                            window_batch=window_batch)
        return self.finish(state, None, video_out_path, pieces=pieces)
