"""The products a configuration's served work needs, by precision.

Counted with ``torch.utils.flop_counter.FlopCounterMode`` on the ``meta``
device over the plain reference, which runs the configuration's schedule
itself: a DeepCache read counts the partial forward it runs, a step
outside the guidance interval its half batch. The int8 convolutions
(``LATENTSYNC_INT8=1``) are counted apart, from their shapes, so that
their operations are timed at the int8 peak and the rest at the peak of
the type the configuration serves in (whisper: float32).
"""

from __future__ import annotations

import functools
import json

import torch

from ..reference.numerics import Numerics


class _CountingNumerics(Numerics):
    def __init__(self):
        super().__init__("f32")
        self.int8_ops = 0

    def qconv2d(self, x, w, b, stride, padding):
        y = torch.nn.functional.conv2d(x, w, None, stride, padding)
        n, cout, ho, wo = y.shape
        self.int8_ops += 2 * n * cout * ho * wo * w.shape[1] * w.shape[2] * w.shape[3]
        return y


def _count(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn()
    return counter.get_total_flops()


def _meta(*shape):
    return torch.empty(*shape, device="meta", dtype=torch.float32)


def _split(total: int, num: _CountingNumerics, served: str) -> dict:
    return {served: total - num.int8_ops, "int8": num.int8_ops}


@functools.lru_cache(maxsize=8)
def _per_unit(config_json: str) -> dict:
    from ..reference.denoise import denoise
    from ..reference.unet import UNet3D
    from ..reference.vae import VAE
    from ..reference.whisper import WhisperEncoder

    config = json.loads(config_json)
    int8 = config.get("env", {}).get("LATENTSYNC_INT8") == "1"
    served = {"bfloat16": "bf16", "float32": "f32"}[config["dtype"]]
    f = config["data"]["num_frames"]
    lat = config["data"]["resolution"] // 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    d = config["whisper"]["n_audio_state"]
    tokens = 10 * (config["whisper"]["n_audio_layer"] + 1)
    out = {}
    with torch.device("meta"):
        num = _CountingNumerics()
        unet = UNet3D(config["unet"], num, int8)
        lat4 = _meta(1, f, lat, lat, 4)
        total = _count(lambda: denoise(unet, lat4, _meta(1, f, lat, lat, 1), lat4, lat4,
                                       _meta(1, f, tokens, d), config["inference_steps"],
                                       config["guidance_scale"], config.get("env", {})))
        out["denoise_window"] = _split(total, num, served)
        num = _CountingNumerics()
        vae = VAE(config["vae"], num, int8)
        total = _count(lambda: vae.decode(_meta(1, config["vae"]["latent_channels"], lat, lat)))
        out["decode_frame"] = _split(total, num, served)
        enc = WhisperEncoder(config["whisper"])
        out["whisper_segment"] = {"f32": _count(lambda: enc.embeddings(
            _meta(1, config["whisper"]["n_mels"], 3000)))}
    return out


def per_unit(config: dict) -> dict:
    """{"denoise_window", "decode_frame", "whisper_segment"} → {precision:
    operations}: one window's denoise on the configuration's schedule, one
    frame's VAE decode, one 30 s whisper segment."""
    return _per_unit(json.dumps(config, sort_keys=True))


def ideal_seconds(ops: dict, peaks: dict) -> float:
    """The least time the card needs for `ops` (precision → operations)."""
    return sum(n / peaks[p] for p, n in ops.items() if n)
