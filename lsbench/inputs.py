"""The inputs a cell's traffic needs, made from the seed: the avatar video
with its bundle, and a pool of speech clips whose lengths come from the
mix's distribution.

Every seed gets the same set of clip lengths (the distribution's quantiles
at (i + 0.5) / pool), with a content of its own, in an order of its own or
(``order: fixed``) in one order for every seed, so the seed changes what is
said, and not how much work the pool holds.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch


# ---------------------------------------------------------------------------
# clip lengths and speech
# ---------------------------------------------------------------------------


def clip_lengths(spec: dict) -> np.ndarray:
    """The pool's clip lengths in seconds, sorted."""
    n = int(spec["pool"])
    q = (np.arange(n) + 0.5) / n
    if spec["dist"] == "uniform":
        sec = spec["min_s"] + q * (spec["max_s"] - spec["min_s"])
    elif spec["dist"] == "lognormal":
        from statistics import NormalDist

        z = np.array([NormalDist().inv_cdf(float(v)) for v in q])
        sec = np.clip(spec["median_s"] * np.exp(spec["sigma"] * z), spec["min_s"], spec["max_s"])
    else:
        raise ValueError(f"clip distribution {spec['dist']!r}: expected uniform or lognormal")
    return np.round(sec, 3)


def speech(seconds: float, rng: np.random.Generator, sr: int = 16000) -> np.ndarray:
    """Speech-like audio: a voiced source (f0 110-220 Hz with drift and
    vibrato, harmonics to 7 kHz) through three formants that jump to a new
    vowel every syllable (4-6 a second), syllable envelopes with pauses,
    and noise bursts for consonants. Float32 in [-0.6, 0.6]."""
    n = int(round(seconds * sr))
    t = np.arange(n) / sr
    f0 = rng.uniform(110, 220) * (1 + 0.08 * np.sin(2 * np.pi * rng.uniform(0.3, 0.9) * t
                                                      + rng.uniform(0, 6.3)))
    f0 *= 1 + 0.01 * np.sin(2 * np.pi * 5.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    # syllables: (start, length) covering the clip, some of them silent
    bounds, pos = [], 0.0
    while pos < seconds:
        length = rng.uniform(0.14, 0.28)
        bounds.append((pos, length, rng.random() < 0.12))
        pos += length
    vowels = np.array([[730, 1090, 2440], [270, 2290, 3010], [300, 870, 2240],
                       [530, 1840, 2480], [570, 840, 2410], [440, 1020, 2240]], np.float64)
    formants = np.zeros((n, 3))
    env = np.zeros(n)
    burst = np.zeros(n)
    for start, length, silent in bounds:
        i0, i1 = int(start * sr), min(n, int((start + length) * sr))
        if i1 <= i0:
            continue
        formants[i0:i1] = vowels[rng.integers(len(vowels))] * rng.uniform(0.9, 1.1, 3)
        if silent:
            continue
        u = np.linspace(0, 1, i1 - i0)
        env[i0:i1] = np.sin(np.pi * u) ** 0.6 * rng.uniform(0.5, 1.0)
        b = min(i1 - i0, int(0.03 * sr))
        burst[i0:i0 + b] = rng.uniform(0.2, 0.6) * np.linspace(1, 0, b)
    kernel = np.hanning(int(0.02 * sr))
    kernel /= kernel.sum()
    formants = np.stack([np.convolve(formants[:, k], kernel, mode="same") for k in range(3)], 1)
    wave = np.zeros(n)
    for k in range(1, 40):
        fk = k * f0
        gain = sum(1.0 / (1.0 + ((fk - formants[:, j]) / (80.0 + 40 * j)) ** 2)
                   for j in range(3)) / k ** 0.5
        wave += np.where(fk < 7000, gain, 0.0) * np.sin(k * phase)
    noise = rng.standard_normal(n)
    wave = wave * env + noise * (burst + 0.01)
    wave = 0.6 * wave / max(np.abs(wave).max(), 1e-9)
    return wave.astype(np.float32)


def write_wav(path: str, samples: np.ndarray, sr: int = 16000) -> str:
    from scipy.io import wavfile

    wavfile.write(path, sr, np.clip(samples * 32768.0, -32768, 32767).astype(np.int16))
    return path


def read_wav(path: str) -> np.ndarray:
    from scipy.io import wavfile

    _, data = wavfile.read(path)
    return data.astype(np.float32) / 32768.0


def clip_pool(spec: dict, seed: int, root: str):
    """[(seconds, wav path)], the clips sent in this order. ``order``
    ``seeded``: the lengths shuffled by the seed; ``fixed``: the same order
    for every seed, the sorted lengths taken at the ranks of (i * golden
    ratio) mod 1, so that any run of consecutive requests spans the
    distribution evenly. The seed draws what each clip says."""
    lengths = clip_lengths(spec)
    n = len(lengths)
    if spec["order"] == "seeded":
        order = np.random.default_rng([int(seed), 1]).permutation(n)
    elif spec["order"] == "fixed":
        order = np.argsort(np.argsort(np.arange(n) * 0.6180339887498949 % 1.0))
    else:
        raise ValueError(f"clip order {spec['order']!r}: expected seeded or fixed")
    pool = []
    for i, idx in enumerate(order):
        sec = float(lengths[idx])
        rng = np.random.default_rng([int(seed), 2, i])
        pool.append((sec, write_wav(os.path.join(root, f"clip_{i:03d}.wav"), speech(sec, rng))))
    return pool


# ---------------------------------------------------------------------------
# the avatar
# ---------------------------------------------------------------------------


def avatar_geometry(av: dict, n: int):
    """Per frame: the face centre, the in-plane angle, the box and the
    frame→crop matrix (a rotation about the box centre and a translation
    into the box, in box pixels)."""
    w, h, box = av["width"], av["height"], av["box"]
    t = np.arange(n)
    cx = w * av["center"][0] + av["sway_px"] * np.sin(2 * np.pi * t / 50.0)
    cy = h * av["center"][1] + 0.6 * av["sway_px"] * np.sin(2 * np.pi * t / 70.0 + 1.0)
    ang = np.deg2rad(av["tilt_deg"]) * np.sin(2 * np.pi * t / 60.0)
    boxes, mats = [], []
    for i in range(n):
        x0, y0 = int(round(cx[i])) - box // 2, int(round(cy[i])) - box // 2
        c, s = math.cos(-ang[i]), math.sin(-ang[i])
        r = np.array([[c, -s], [s, c]])
        off = np.array([box / 2.0, box / 2.0]) - r @ np.array([cx[i], cy[i]])
        mats.append(np.concatenate([r, off[:, None]], 1))
        boxes.append([x0, y0, x0 + box, y0 + box])
    return cx, cy, np.asarray(boxes), np.stack(mats)


@torch.no_grad()
def avatar_frames(av: dict, seed: int, device) -> torch.Tensor:
    """(n, H, W, 3) uint8 on `device`: a lit background, a head (skin
    ellipse, hair, eyes, a mouth that opens and closes) that sways and
    tilts, and seeded sensor noise."""
    n, w, h = av["frames"], av["width"], av["height"]
    g = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    cx, cy, _, _ = avatar_geometry(av, n)
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    base = torch.stack([90 + 60 * xs / w + 20 * torch.sin(ys / 97.0),
                        100 + 40 * ys / h + 0 * xs,
                        120 + 30 * torch.cos(xs / 151.0) + 0 * ys], -1)
    skin = torch.tensor([205.0, 160.0, 135.0], device=device)
    hair = torch.tensor([60.0, 40.0, 30.0], device=device)
    dark = torch.tensor([40.0, 30.0, 35.0], device=device)
    lips = torch.tensor([150.0, 70.0, 75.0], device=device)
    r = av["box"] / 2.0
    out = torch.empty((n, h, w, 3), device=device, dtype=torch.uint8)
    for i in range(n):
        img = base.clone()
        dx, dy = xs - float(cx[i]), ys - float(cy[i])
        head = (dx / (0.62 * r)) ** 2 + (dy / (0.82 * r)) ** 2
        top = ((dx / (0.70 * r)) ** 2 + ((dy + 0.35 * r) / (0.62 * r)) ** 2 < 1) & (dy < -0.3 * r)
        shade = (1.0 - 0.25 * head.clamp(0, 1))[..., None]
        img = torch.where((head < 1)[..., None], skin * shade, img)
        img = torch.where(top[..., None], hair.expand_as(img), img)
        for ex in (-0.25 * r, 0.25 * r):
            eye = ((xs - float(cx[i]) - ex) / (0.09 * r)) ** 2 + ((dy + 0.18 * r) / (0.05 * r)) ** 2
            img = torch.where((eye < 1)[..., None], dark.expand_as(img), img)
        openness = 0.03 + 0.05 * (0.5 + 0.5 * math.sin(2 * math.pi * i / 9.0))
        mouth = (dx / (0.22 * r)) ** 2 + ((dy - 0.38 * r) / (openness * r)) ** 2
        lip = (dx / (0.26 * r)) ** 2 + ((dy - 0.38 * r) / ((openness + 0.04) * r)) ** 2
        img = torch.where((lip < 1)[..., None], lips.expand_as(img), img)
        img = torch.where((mouth < 1)[..., None], dark.expand_as(img), img)
        noise = torch.randn((h, w, 3), generator=g, device=device) * 3.0
        out[i] = (img + noise).clamp(0, 255).to(torch.uint8)
    return out


@torch.no_grad()
def crop_faces(frames: torch.Tensor, mats: np.ndarray, box: int, res: int) -> np.ndarray:
    """The aligned faces of the bundle: each frame warped by its frame→crop
    matrix into a box² crop (bilinear), then averaged down to res²."""
    n, h, w, _ = frames.shape
    dev = frames.device
    faces = []
    u = torch.arange(box, device=dev, dtype=torch.float32) + 0.0
    vv, uu = torch.meshgrid(u, u, indexing="ij")
    for i in range(n):
        m = np.asarray(mats[i], np.float64)
        inv = np.linalg.inv(np.vstack([m, [0, 0, 1]]))[:2]
        sx = float(inv[0, 0]) * uu + float(inv[0, 1]) * vv + float(inv[0, 2])
        sy = float(inv[1, 0]) * uu + float(inv[1, 1]) * vv + float(inv[1, 2])
        grid = torch.stack([sx / (w - 1) * 2 - 1, sy / (h - 1) * 2 - 1], -1)[None]
        img = frames[i].permute(2, 0, 1)[None].float()
        crop = torch.nn.functional.grid_sample(img, grid, mode="bilinear", align_corners=True)
        crop = torch.nn.functional.avg_pool2d(crop, box // res)
        faces.append(crop[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).cpu())
    return torch.stack(faces).numpy()


def write_avatar(av: dict, seed: int, root: str, res: int, device) -> dict:
    """The avatar video (``avatar.mp4``, OpenCV mp4v) and its bundle
    (``avatar.npz``: faces, boxes, affine matrices) under `root`."""
    import cv2

    frames = avatar_frames(av, seed, device)
    n = frames.shape[0]
    _, _, boxes, mats = avatar_geometry(av, n)
    faces = crop_faces(frames, mats, av["box"], res)
    host = frames.cpu().numpy()
    del frames
    path = os.path.join(root, "avatar.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), av["fps"],
                             (av["width"], av["height"]))
    if not writer.isOpened():
        raise IOError(f"cannot open a video writer for {path}")
    for f in host:
        writer.write(np.ascontiguousarray(f[:, :, ::-1]))
    writer.release()
    bundle = os.path.join(root, "avatar.npz")
    np.savez(bundle, faces=faces, boxes=boxes, affine_matrices=mats)
    return {"video": path, "bundle": bundle, "frames": n, "boxes": boxes, "matrices": mats}
