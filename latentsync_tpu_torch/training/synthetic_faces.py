"""Procedural face generator with exact 68-point landmark geometry.

The port's own copy of ``latentsync_tpu/training/synthetic_faces.py``
(numpy and OpenCV only): for the same ``np.random.Generator`` it draws the
same faces, bit for bit (``tests/test_torch_landmark_fallback.py``).

Training data source for the no-checkpoint landmark fallback
(``latentsync_tpu_torch/scripts/train_landmark_fallback.py``): the reference's zero-config
landmark path is mediapipe's pretrained mesh
(ref:latentsync/utils/image_processor.py:181-264), which cannot be
redistributed here — instead a small FAN is trained on procedurally
rendered faces whose iBUG-68 landmark layout is known by construction.

Faces are drawn FROM the landmarks (brows/eyes/nose/lips rendered along
their own annotation points), so appearance and supervision are
geometrically consistent by design. Augmentations cover the crop
distribution the live detector produces (face roughly centered with
margin jitter, rotation, scale, lighting, blur, occluders).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def canonical_68() -> np.ndarray:
    """iBUG-68 landmark layout for a canonical frontal face in a
    [-1, 1]² box (x right, y down). Constructed from ellipse arcs with
    the standard ordering: 0-16 jaw, 17-26 brows, 27-35 nose, 36-47
    eyes, 48-59 outer lip, 60-67 inner lip."""
    pts = np.zeros((68, 2), np.float64)
    # jaw: 17 points ear → chin → ear, bulging downward
    t = np.linspace(-1.0, 1.0, 17)
    pts[0:17, 0] = 0.82 * t
    pts[0:17, 1] = 0.15 + 0.75 * np.sqrt(np.clip(1 - t**2, 0, 1))

    def arc(x0, x1, y, bow, n):
        xs = np.linspace(x0, x1, n)
        ys = y - bow * np.sin(np.linspace(0, math.pi, n))
        return np.stack([xs, ys], -1)

    # brows (17-21 left, 22-26 right)
    pts[17:22] = arc(-0.55, -0.12, -0.42, 0.10, 5)
    pts[22:27] = arc(0.12, 0.55, -0.42, 0.10, 5)
    # nose bridge 27-30 (top → tip), bottom row 31-35
    pts[27:31, 0] = 0.0
    pts[27:31, 1] = np.linspace(-0.32, 0.08, 4)
    pts[31:36, 0] = np.linspace(-0.16, 0.16, 5)
    pts[31:36, 1] = 0.18 - 0.04 * np.sin(np.linspace(0, math.pi, 5))

    def eye(cx, cy, w, h, start):
        # 6 points: outer corner, two top, inner corner, two bottom
        a = np.array([math.pi, 2.4, 0.75, 0.0, -0.75, -2.4])
        pts[start : start + 6, 0] = cx + w * np.cos(a)
        pts[start : start + 6, 1] = cy - h * np.sin(a)

    eye(-0.33, -0.22, 0.15, 0.08, 36)
    eye(0.33, -0.22, 0.15, 0.08, 42)

    # outer lip 48-59 (12 pts), inner lip 60-67 (8 pts)
    a12 = np.linspace(math.pi, -math.pi, 12, endpoint=False)
    pts[48:60, 0] = 0.28 * np.cos(a12)
    pts[48:60, 1] = 0.48 + np.where(np.sin(a12) > 0, -0.10, 0.13) * np.abs(
        np.sin(a12)
    )
    a8 = np.linspace(math.pi, -math.pi, 8, endpoint=False)
    pts[60:68, 0] = 0.17 * np.cos(a8)
    pts[60:68, 1] = 0.48 + np.where(np.sin(a8) > 0, -0.035, 0.05) * np.abs(
        np.sin(a8)
    )
    return pts


def _similarity(theta: float, scale: float, tx: float, ty: float) -> np.ndarray:
    c, s = math.cos(theta) * scale, math.sin(theta) * scale
    return np.array([[c, -s, tx], [s, c, ty]], np.float64)


def render_face(
    rng: np.random.Generator, size: int = 256, hair_p: float = 0.0
) -> Tuple[np.ndarray, np.ndarray]:
    """One synthetic face crop. Returns (image uint8 (size, size, 3) RGB,
    landmarks (68, 2) float in pixel coords).

    `hair_p`: probability of rendering a hair fringe + side curtains.
    Measured negative for the shipped fallback: training with
    hair_p=0.85 made the net latch onto background drapery as "hair" on
    the real demo photo and scatter the whole track off-face; the
    shipped asset trains with hair_p=0. Kept opt-in for experiments."""
    import cv2

    # pose: face center near crop center, half-height 35-60% of the crop
    theta = rng.uniform(-0.35, 0.35)
    half = rng.uniform(0.35, 0.60) * size
    cx = size / 2 + rng.uniform(-0.12, 0.12) * size
    cy = size / 2 + rng.uniform(-0.12, 0.12) * size
    mat = _similarity(theta, half, cx, cy)

    lm = canonical_68().copy()
    # expression/morph jitter: mouth open, brow raise, eye squint
    mouth_open = rng.uniform(0.0, 0.22)
    lm[54:60, 1] += mouth_open * 0.3  # lower outer lip (right-to-left arc)
    lm[48:60, 1] += np.where(np.arange(48, 60) >= 54, mouth_open, 0.0) * 0.2
    lm[64:68, 1] += mouth_open * 0.8
    lm[17:27, 1] += rng.uniform(-0.04, 0.04)
    lm += rng.normal(0, 0.012, lm.shape)  # per-point identity jitter
    width_jit = rng.uniform(0.85, 1.1)
    lm[:, 0] *= width_jit

    pts = lm @ mat[:, :2].T + mat[:, 2]

    # ---- render ----
    img = np.zeros((size, size, 3), np.uint8)
    bg = rng.integers(0, 200, 3)
    img[:] = bg
    if rng.uniform() < 0.7:  # background clutter
        for _ in range(rng.integers(1, 5)):
            p1 = rng.integers(0, size, 2)
            p2 = rng.integers(0, size, 2)
            col = tuple(int(v) for v in rng.integers(0, 255, 3))
            cv2.rectangle(img, tuple(p1), tuple(p2), col, -1)

    # skin tones: R >= G >= B ordering biases toward plausible skin
    # while keeping wide diversity for robustness
    r_ch = int(rng.integers(120, 255))
    g_ch = int(rng.integers(max(70, r_ch - 120), r_ch + 1))
    b_ch = int(rng.integers(max(50, g_ch - 110), g_ch + 1))
    skin = np.array([r_ch, g_ch, b_ch])

    def P(i):
        return (int(round(pts[i, 0])), int(round(pts[i, 1])))

    # head: fill the closed contour jaw (ear→chin→ear) + forehead arc —
    # the face boundary passes EXACTLY through the jaw landmarks
    t_f = np.linspace(1.0, -1.0, 17)
    forehead = np.stack([
        0.82 * t_f * width_jit,
        0.15 - 0.95 * np.sqrt(np.clip(1 - t_f**2, 0, 1)),
    ], -1)
    fh_pts = forehead @ mat[:, :2].T + mat[:, 2]
    contour = np.concatenate([pts[0:17], fh_pts], axis=0)
    cv2.fillPoly(img, [contour.astype(np.int32)],
                 tuple(int(v) for v in skin))
    # jaw shading along the contour
    cv2.polylines(img, [pts[0:17].astype(np.int32)], False,
                  tuple(int(v) for v in np.clip(skin * 0.75, 0, 255)), 2)

    # hair: real faces carry hair over the forehead and down the jaw
    # sides — without it the trained net scatters brow/jaw heatmaps
    # into background clutter on photos (observed on the demo fixture).
    # A fringe band hugging the forehead arc plus optional side curtains
    # over the outer jaw keeps the visible-feature geometry identical
    # while teaching "dark textured mass adjacent to the face boundary".
    if rng.uniform() < hair_p:
        hair_col = tuple(int(v) for v in rng.integers(5, 110, 3))
        depth = rng.uniform(0.15, 0.45)  # fringe drop (brows stay mostly visible)
        outer = np.stack([
            0.98 * t_f * width_jit,
            0.15 - 1.25 * np.sqrt(np.clip(1 - t_f**2, 0, 1)),
        ], -1)
        inner = np.stack([
            0.82 * np.linspace(-1.0, 1.0, 17) * width_jit,
            0.15 - (0.95 - depth) * np.sqrt(
                np.clip(1 - np.linspace(-1.0, 1.0, 17) ** 2, 0, 1))
            + rng.normal(0, 0.03, 17),  # ragged fringe edge
        ], -1)
        band = np.concatenate([outer, inner], axis=0) @ mat[:, :2].T + mat[:, 2]
        cv2.fillPoly(img, [band.astype(np.int32)], hair_col)
        if rng.uniform() < 0.6:  # side curtains over the outer jaw
            for sgn in (-1.0, 1.0):
                tc = np.linspace(0.55, 1.0, 8) * sgn
                edge = np.stack([
                    0.84 * tc * width_jit,
                    0.15 + 0.80 * np.sqrt(np.clip(1 - tc**2, 0, 1)),
                ], -1)
                out_e = edge * np.array([rng.uniform(1.15, 1.45), 1.0]) \
                    + np.array([0.0, rng.uniform(0.0, 0.25)])
                poly = np.concatenate([edge, out_e[::-1]], axis=0) \
                    @ mat[:, :2].T + mat[:, 2]
                cv2.fillPoly(img, [poly.astype(np.int32)], hair_col)

    # brows
    brow_col = tuple(int(v) for v in rng.integers(10, 90, 3))
    cv2.polylines(img, [pts[17:22].astype(np.int32)], False, brow_col,
                  max(2, size // 96 * 2))
    cv2.polylines(img, [pts[22:27].astype(np.int32)], False, brow_col,
                  max(2, size // 96 * 2))

    # eyes: sclera polygon + iris at eye center
    for s in (36, 42):
        eye_pts = pts[s : s + 6].astype(np.int32)
        cv2.fillPoly(img, [eye_pts], (245, 245, 245))
        c = pts[s : s + 6].mean(axis=0)
        r = max(2, int(np.linalg.norm(pts[s] - pts[s + 3]) * 0.22))
        iris = tuple(int(v) for v in rng.integers(20, 140, 3))
        cv2.circle(img, (int(c[0]), int(c[1])), r, iris, -1)
        cv2.circle(img, (int(c[0]), int(c[1])), max(1, r // 2), (15, 15, 15), -1)
        cv2.polylines(img, [eye_pts], True,
                      tuple(int(v) for v in np.clip(skin * 0.6, 0, 255)), 1)

    # nose: bridge line + nostril dots on the bottom row
    nose_col = tuple(int(v) for v in np.clip(skin * 0.8, 0, 255))
    cv2.polylines(img, [pts[27:31].astype(np.int32)], False, nose_col, 2)
    cv2.polylines(img, [pts[31:36].astype(np.int32)], False, nose_col, 2)
    cv2.circle(img, P(31), 2, (40, 30, 30), -1)
    cv2.circle(img, P(35), 2, (40, 30, 30), -1)

    # lips: filled outer polygon, darker inner line
    lip = tuple(int(v) for v in
                (rng.integers(120, 220), rng.integers(30, 90),
                 rng.integers(40, 100)))
    cv2.fillPoly(img, [pts[48:60].astype(np.int32)], lip)
    if mouth_open > 0.08:  # open mouth: dark inner region
        cv2.fillPoly(img, [pts[60:68].astype(np.int32)], (25, 10, 10))
    else:
        cv2.polylines(img, [pts[60:68].astype(np.int32)], True,
                      tuple(int(v * 0.6) for v in lip), 1)

    # lighting + degradation
    if rng.uniform() < 0.5:
        grad = np.linspace(rng.uniform(0.7, 1.0), rng.uniform(1.0, 1.3),
                           size, dtype=np.float32)
        axis = rng.integers(0, 2)
        g = grad[:, None] if axis == 0 else grad[None, :]
        img = np.clip(img.astype(np.float32) * g[..., None], 0, 255
                      ).astype(np.uint8)
    if rng.uniform() < 0.35:  # occluder
        p1 = rng.integers(0, size, 2)
        w, h = rng.integers(size // 10, size // 3, 2)
        col = tuple(int(v) for v in rng.integers(0, 255, 3))
        cv2.rectangle(img, tuple(p1), (int(p1[0] + w), int(p1[1] + h)),
                      col, -1)
    k = int(rng.integers(0, 3)) * 2 + 1
    if k > 1:
        img = cv2.GaussianBlur(img, (k, k), 0)
    if rng.uniform() < 0.5:
        img = np.clip(img.astype(np.float32)
                      + rng.normal(0, rng.uniform(2, 10), img.shape),
                      0, 255).astype(np.uint8)
    return img, pts.astype(np.float32)


def landmark_heatmaps(pts: np.ndarray, size: int = 64, stride: float = 4.0,
                      sigma: float = 1.0) -> np.ndarray:
    """(68, 2) pixel landmarks → (size, size, 68) gaussian heatmaps on
    the stride-4 grid (the FAN supervision target)."""
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    p = pts / stride - 0.5
    d2 = (xs[..., None] - p[None, None, :, 0]) ** 2 + \
         (ys[..., None] - p[None, None, :, 1]) ** 2
    return np.exp(-d2 / (2 * sigma**2)).astype(np.float32)


def make_batch(rng: np.random.Generator, n: int, size: int = 256):
    imgs, heats, lms = [], [], []
    for _ in range(n):
        img, pts = render_face(rng, size)
        imgs.append(img.astype(np.float32) / 255.0)
        heats.append(landmark_heatmaps(pts, size // 4))
        lms.append(pts)
    return np.stack(imgs), np.stack(heats), np.stack(lms)
