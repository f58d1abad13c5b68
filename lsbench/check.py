"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, the plain
reference (``lsbench/reference``, float32, TF32 off) is built from the same
seeded weights and judges a sample of the requests the timed path served,
drawn from the seed with the longest among them, stage by stage:

- ``audio_rel_l2``: the whisper chunks the program's ``prepare`` produced
  against the reference's, from the clip's samples;
- ``latents_rel_l2``: the denoised latents the program handed to
  ``finish`` against the reference's own trajectory from the raw inputs
  (the bundle's faces encoded by the reference VAE, the reference's audio
  chunks, the shared noise), on the configuration's schedule;
- ``frames_rms``: the output frames handed to the video writer, in the
  region the faces are pasted into, against the reference's decode of the
  program's latents, composited, resized and pasted into the decoded
  source frames (root mean square, in 8-bit codes). This stage follows the
  program from its own latents; the denoise above is checked from the
  start.

Each number is the largest over the requests judged. The control
(``control.py``) is the same reference in the precision below the
configuration's, put in the program's place and judged the same way.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .inputs import read_wav
from .reference.denoise import denoise
from .reference.numerics import Numerics
from .reference.restore import composite, paste, resize_bilinear_u8
from .reference.unet import UNet3D
from .reference.vae import VAE, decode_u8
from .reference.whisper import WhisperEncoder, audio_chunks
from .spec import ROOT
from .weights import fill_, signature

NOISE_SEED = 1247  # the seed of the one noise frame every request's windows share
REF_BATCH = 2  # windows the reference denoises at once
MASK_PATH = os.path.join(ROOT, "latentsync_tpu_torch", "utils", "assets", "mask.png")


def rel_l2(a, b) -> float:
    a = torch.as_tensor(a).double()
    b = torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def served_dtype(config: dict, device) -> torch.dtype:
    if torch.device(device).type == "cpu":
        return torch.float32
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[config["dtype"]]


class Models:
    """The reference's UNet, VAE and whisper encoder in float32 on `device`,
    with the weights the program got (the same draw, in the served type)."""

    def __init__(self, config: dict, seed: int, device, mode: str = "f32"):
        self.num = Numerics(mode)
        int8 = config.get("env", {}).get("LATENTSYNC_INT8") == "1"
        dt = served_dtype(config, device)
        with torch.device("meta"):
            self.unet = UNet3D(config["unet"], self.num, int8)
            self.vae = VAE(config["vae"], self.num, int8)
            self.whisper = WhisperEncoder(config["whisper"], self.num)
        fill_(self.unet, seed, "unet", device, dt)
        fill_(self.vae, seed, "vae", device, dt)
        fill_(self.whisper, seed, "whisper", device, torch.float32)
        self.unet.float().eval()
        self.vae.float().eval()
        self.whisper.float().eval()
        self.device = torch.device(device)

    def signatures(self):
        return {"unet": signature(self.unet), "vae": signature(self.vae),
                "whisper": signature(self.whisper)}


class Avatar:
    """The avatar as both sides read it: the bundle, the decoded video and
    the mouth mask."""

    def __init__(self, video: str, bundle: str, res: int):
        import cv2

        with np.load(bundle) as d:
            self.faces = d["faces"]
            self.boxes = d["boxes"]
            self.matrices = d["affine_matrices"]
        cap = cv2.VideoCapture(video)
        frames = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
        cap.release()
        self.frames = np.stack(frames)
        img = cv2.cvtColor(cv2.imread(MASK_PATH), cv2.COLOR_BGR2RGB)
        img = cv2.resize(img, (res, res), interpolation=cv2.INTER_LANCZOS4)
        self.keep = (img.astype(np.float32) / 255.0)[None]  # (1, r, r, 3)
        self.res = res


def _tile(a: np.ndarray, n: int) -> np.ndarray:
    reps = -(-n // len(a))
    return np.concatenate([a] * reps)[:n]


def crop_region(boxes: np.ndarray, hw, margin: int = 8):
    """(y0, y1, x0, x1): every box, with a margin, inside the frame."""
    h, w = hw
    return (max(0, int(boxes[:, 1].min()) - margin), min(h, int(boxes[:, 3].max()) + margin),
            max(0, int(boxes[:, 0].min()) - margin), min(w, int(boxes[:, 2].max()) + margin))


@torch.no_grad()
def inputs(models: Models, config: dict, avatar: Avatar, samples: np.ndarray) -> dict:
    """The reference's inputs of one request: its audio chunks, encoded
    faces, mask and noise, windowed (W, F, ...)."""
    dev = models.device
    data = config["data"]
    f = data["num_frames"]
    chunks = audio_chunks(models.whisper, samples, fps=data["video_fps"], multiple=f,
                          ctx=tuple(data["audio_feat_length"]))
    total = len(chunks)
    nw = total // f
    faces = _tile(avatar.faces, total)
    pix = faces.astype(np.float32) / 255.0 * 2.0 - 1.0
    keep = avatar.keep
    vcfg = config["vae"]
    zm, zr = [], []
    for i in range(0, total, 16):
        p = torch.from_numpy(pix[i:i + 16]).to(dev).permute(0, 3, 1, 2)
        k = torch.from_numpy(keep).to(dev).permute(0, 3, 1, 2)
        for out, x in ((zr, p), (zm, p * k)):
            z = (models.vae.encode(x) - vcfg.get("shift_factor", 0.0)) * vcfg["scaling_factor"]
            out.append(z.permute(0, 2, 3, 1).float())
    lat_hw = avatar.res // 2 ** (len(vcfg["block_out_channels"]) - 1)
    idx = ((torch.arange(lat_hw, dtype=torch.float64) + 0.5) * avatar.res / lat_hw).floor().long()
    small = torch.from_numpy(keep[:, :, :, :1])[:, idx][:, :, idx].to(dev)
    noise = torch.randn((1, 1, lat_hw, lat_hw, 4),
                        generator=torch.Generator().manual_seed(NOISE_SEED)).to(dev)

    def win(x):
        return x.reshape((nw, f) + tuple(x.shape[1:]))

    return {"audio": torch.from_numpy(chunks).to(dev).reshape(nw, f, *chunks.shape[1:]),
            "masked": win(torch.cat(zm)), "ref": win(torch.cat(zr)),
            "mask": win(small.expand(total, lat_hw, lat_hw, 1)),
            "latents0": noise.expand(nw, f, lat_hw, lat_hw, 4), "total": total,
            "faces": faces, "pix": pix}


@torch.no_grad()
def latents(models: Models, config: dict, inp: dict) -> torch.Tensor:
    """The reference's denoised latents (W, F, h, w, 4), ``REF_BATCH``
    windows at a time (a block whose float32 activations fit the card)."""
    out = []
    nw = inp["audio"].shape[0]
    for i in range(0, nw, REF_BATCH):
        sl = slice(i, i + REF_BATCH)
        out.append(denoise(models.unet, inp["latents0"][sl], inp["mask"][sl],
                           inp["masked"][sl], inp["ref"][sl], inp["audio"][sl],
                           config["inference_steps"], config["guidance_scale"],
                           config.get("env", {})))
    return torch.cat(out)


@torch.no_grad()
def frames(models: Models, config: dict, avatar: Avatar, inp: dict, lat: torch.Tensor,
           region) -> np.ndarray:
    """The output frames' `region` from latents (W, F, h, w, 4): decoded,
    composited with the original face where the mask keeps it, resized to
    the box and pasted into the source frames, in the chunks ``finish``
    pastes them in (64 frames; the frames past the source video apart)."""
    dev = models.device
    vcfg = config["vae"]
    total = inp["total"]
    flat = lat.reshape(total, *lat.shape[2:]).to(dev)
    dec = torch.cat([decode_u8(models.vae, flat[i:i + 16], vcfg["scaling_factor"],
                               vcfg.get("shift_factor", 0.0)) for i in range(0, total, 16)])
    pix_u8 = torch.from_numpy(np.clip((inp["pix"] + 1.0) * 127.5, 0, 255)).to(dev)
    keep = torch.from_numpy(np.ascontiguousarray(avatar.keep[..., :1])).to(dev)
    comb = composite(dec, pix_u8, keep)
    boxes = _tile(avatar.boxes, total)
    mats = _tile(avatar.matrices, total)
    n_src = len(avatar.frames)
    src = np.concatenate([avatar.frames[:min(total, n_src)],
                          avatar.frames[np.arange(n_src, total) % n_src]]) \
        if total > n_src else avatar.frames[:total]
    y0, y1, x0, x1 = region
    out = []
    for i in range(0, total, 64):
        stop = min(i + 64, total)
        for a, b in ((i, min(stop, n_src)), (max(i, n_src), stop)):
            if a >= b:
                continue
            bh, bw = int(boxes[a][3] - boxes[a][1]), int(boxes[a][2] - boxes[a][0])
            faces = resize_bilinear_u8(comb[a:b], (bh, bw))
            pasted = paste(torch.from_numpy(src[a:b]).to(dev), faces, mats[a:b])
            out.append(pasted[:, y0:y1, x0:x1].cpu().numpy())
    return np.concatenate(out)


def judge(models: Models, config: dict, avatar: Avatar, clip: str, got: dict,
          region) -> dict:
    """`got`: what was served for the request ("audio" (W, F, S, D),
    "latents" (W, F, h, w, 4), "frames" the region of every output frame)
    → the three numbers."""
    inp = inputs(models, config, avatar, read_wav(clip))
    want_lat = latents(models, config, inp)
    got_lat = torch.as_tensor(got["latents"]).float().to(models.device)
    want_frames = frames(models, config, avatar, inp, got_lat, region)
    got_frames = np.asarray(got["frames"])
    if got_frames.shape != want_frames.shape:
        return {"audio_rel_l2": math.inf, "latents_rel_l2": math.inf, "frames_rms": math.inf}
    diff = got_frames.astype(np.float64) - want_frames.astype(np.float64)
    return {"audio_rel_l2": rel_l2(torch.as_tensor(got["audio"]).float().cpu(),
                                   inp["audio"].cpu()),
            "latents_rel_l2": rel_l2(got_lat.cpu(), want_lat.cpu()),
            "frames_rms": float(np.sqrt(np.mean(diff ** 2)))}


def produce(models: Models, config: dict, avatar: Avatar, clip: str, region) -> dict:
    """What `models` serve for a clip, in `got`'s form (the control)."""
    inp = inputs(models, config, avatar, read_wav(clip))
    lat = latents(models, config, inp)
    return {"audio": inp["audio"].cpu(), "latents": lat.cpu(),
            "frames": frames(models, config, avatar, inp, lat, region)}


def choose(items, windows, config: dict, seed: int) -> list:
    """The requests to judge: the one with the most `windows` (a function
    of an item; among equals the first in an order drawn from the seed),
    then the others in that order, taken while they fit the check's budget
    of windows and of requests."""
    ccfg = config["check"]
    order = list(np.random.default_rng([int(seed), 4]).permutation(len(items)))
    if order:
        longest = max(order, key=lambda i: windows(items[i]))
        order.remove(longest)
        order.insert(0, longest)
    chosen, total = [], 0
    for i in order:
        w = windows(items[i])
        if not chosen or (len(chosen) < ccfg["requests"] and total + w <= ccfg["max_windows"]):
            chosen.append(items[i])
            total += w
    return chosen


def verdict(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)])."""
    rows = [(k, float(numbers.get(k, math.inf)), float(limits[k])) for k in sorted(limits)]
    ok = all(v <= lim for _, v, lim in rows)
    return ok, rows


def set_reference_numerics() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
