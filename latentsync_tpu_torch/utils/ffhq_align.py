"""FFHQ-style face alignment from 68 landmarks.

The port's copy of ``latentsync_tpu/utils/ffhq_align.py`` (host code:
numpy, PIL and scipy; the same bytes out for the same inputs): the NVLabs
FFHQ recipe of an oriented crop quad from eye / mouth anchors, a shrink for
huge inputs, a bordered crop, optional reflect-pad + blur feathering, PIL's
QUAD transform and a final resize. The landmark source is pluggable (the
port's FAN detector emits the 68-point iBUG layout).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def ffhq_quad(lm68: np.ndarray) -> Tuple[np.ndarray, float]:
    """(quad (4,2), qsize) from 68 landmarks
    (ref:crop_align_face.py:88-115)."""
    lm = np.asarray(lm68, np.float64)
    eye_left = lm[36:42].mean(0)
    eye_right = lm[42:48].mean(0)
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    mouth_avg = (lm[48] + lm[54]) * 0.5
    eye_to_mouth = mouth_avg - eye_avg

    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    x /= np.hypot(*x)
    x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
    y = np.flipud(x) * [-1, 1]
    c = eye_avg + eye_to_mouth * 0.1
    quad = np.stack([c - x - y, c - x + y, c + x + y, c + x - y])
    return quad, float(np.hypot(*x) * 2)


def ffhq_align_face(
    img_rgb: np.ndarray,
    lm68: np.ndarray,
    output_size: int = 512,
    transform_size: int = 4096,
    enable_padding: bool = False,
) -> np.ndarray:
    """uint8 RGB frame + 68 landmarks → aligned output_size² crop
    (ref:crop_align_face.py:120-185, defaults preserved)."""
    import PIL.Image
    import scipy.ndimage

    quad, qsize = ffhq_quad(lm68)
    img = PIL.Image.fromarray(np.asarray(img_rgb, np.uint8))

    # shrink oversize inputs
    shrink = int(np.floor(qsize / output_size * 0.5))
    if shrink > 1:
        rsize = (int(np.rint(img.size[0] / shrink)),
                 int(np.rint(img.size[1] / shrink)))
        img = img.resize(rsize, PIL.Image.LANCZOS)
        quad /= shrink
        qsize /= shrink

    # bordered crop
    border = max(int(np.rint(qsize * 0.1)), 3)
    crop = (int(np.floor(quad[:, 0].min())), int(np.floor(quad[:, 1].min())),
            int(np.ceil(quad[:, 0].max())), int(np.ceil(quad[:, 1].max())))
    crop = (max(crop[0] - border, 0), max(crop[1] - border, 0),
            min(crop[2] + border, img.size[0]),
            min(crop[3] + border, img.size[1]))
    if crop[2] - crop[0] < img.size[0] or crop[3] - crop[1] < img.size[1]:
        img = img.crop(crop)
        quad = quad - crop[0:2]

    # reflect-pad + feather for quads poking outside the frame
    pad = (int(np.floor(quad[:, 0].min())), int(np.floor(quad[:, 1].min())),
           int(np.ceil(quad[:, 0].max())), int(np.ceil(quad[:, 1].max())))
    pad = (max(-pad[0] + border, 0), max(-pad[1] + border, 0),
           max(pad[2] - img.size[0] + border, 0),
           max(pad[3] - img.size[1] + border, 0))
    if enable_padding and max(pad) > border - 4:
        pad = np.maximum(pad, int(np.rint(qsize * 0.3)))
        arr = np.pad(np.float32(img),
                     ((pad[1], pad[3]), (pad[0], pad[2]), (0, 0)), "reflect")
        h, w, _ = arr.shape
        yy, xx, _ = np.ogrid[:h, :w, :1]
        mask = np.maximum(
            1.0 - np.minimum(np.float32(xx) / max(pad[0], 1),
                             np.float32(w - 1 - xx) / max(pad[2], 1)),
            1.0 - np.minimum(np.float32(yy) / max(pad[1], 1),
                             np.float32(h - 1 - yy) / max(pad[3], 1)))
        blur = qsize * 0.02
        arr += (scipy.ndimage.gaussian_filter(arr, [blur, blur, 0]) - arr) * \
            np.clip(mask * 3.0 + 1.0, 0.0, 1.0)
        arr += (np.median(arr, axis=(0, 1)) - arr) * np.clip(mask, 0.0, 1.0)
        img = PIL.Image.fromarray(
            np.uint8(np.clip(np.rint(arr), 0, 255)), "RGB")
        quad = quad + pad[:2]

    img = img.transform((transform_size, transform_size), PIL.Image.QUAD,
                        (quad + 0.5).flatten(), PIL.Image.BILINEAR)
    if output_size < transform_size:
        img = img.resize((output_size, output_size), PIL.Image.LANCZOS)
    return np.asarray(img)
