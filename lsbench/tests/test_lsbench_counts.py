"""The count functions against each other at tiny width: the reference's
meta-device count of one forward equals the copied ``op_tally``'s product
families and the port's own meta-device count (``perf_probe``); the
scheduled count of a window is the configuration's trajectory; each entry
point's count is its operation's arithmetic."""

import json
import os

import pytest
import torch

from lsbench.counts import entries, op_tally, schedule
from lsbench.reference.numerics import Numerics
from lsbench.reference.unet import UNet3D
from lsbench.tests.conftest import DATA

TINY = json.load(open(os.path.join(DATA, "tiny-exact.json")))
FULL = json.load(open(os.path.join(os.path.dirname(DATA), "..", "configs",
                                   "ls15-stage2-exact.json")))


def _forward_flops(cfg, w, f, lat, tokens):
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        unet = UNet3D(cfg["unet"], Numerics())
        x = torch.empty(2 * w, cfg["unet"]["in_channels"], f, lat, lat)
        a = torch.empty(2 * w, f, tokens, cfg["unet"]["cross_attention_dim"])
        with FlopCounterMode(display=False) as c, torch.no_grad():
            unet(x, torch.empty(2 * w), a)
    return c.get_total_flops()


@pytest.mark.parametrize("cfg", [TINY, FULL], ids=["tiny", "full"])
def test_reference_count_matches_op_tally(cfg):
    f, lat, tokens = 16, cfg["data"]["resolution"] // 8, 50
    fl = op_tally.tally(1, cfg["unet"], f, lat, tokens)
    products = sum(v for k, v in fl.items() if k in op_tally.PRODUCT_FAMILIES)
    counted = _forward_flops(cfg, 1, f, lat, tokens)
    # the counter also sees the two time-embedding products op_tally leaves out
    assert abs(counted - products) / products < 1e-3


def test_reference_count_matches_the_ports_meta_count():
    from latentsync_tpu_torch.scripts.perf_probe import unet_flops

    from lsbench.program import port_config

    cfg = port_config(TINY)
    lat = TINY["data"]["resolution"] // 8
    port = unet_flops(cfg.unet, 2, 16, lat)
    assert _forward_flops(TINY, 1, 16, lat, 50) == port


def test_schedule_counts_the_trajectory():
    exact = schedule.per_unit(TINY)
    full = _forward_flops(TINY, 1, 16, TINY["data"]["resolution"] // 8,
                          10 * (TINY["whisper"]["n_audio_layer"] + 1))
    assert exact["denoise_window"]["bf16"] == pytest.approx(TINY["inference_steps"] * full,
                                                           rel=1e-9)
    assert exact["denoise_window"]["int8"] == 0
    prod = dict(TINY, env={"LATENTSYNC_INT8": "1", "LATENTSYNC_DEEPCACHE": "2:1:enc",
                           "LATENTSYNC_CFG_INTERVAL": "0:0.5"}, inference_steps=4)
    cut = schedule.per_unit(prod)["denoise_window"]
    assert cut["int8"] > 0
    assert cut["bf16"] + cut["int8"] < 4 * full
    assert schedule.per_unit(prod)["decode_frame"]["int8"] > 0


def test_entry_counts():
    e = entries()
    x = torch.empty(2, 64, 32, dtype=torch.bfloat16, device="meta")
    w_up = torch.empty(256, 32, device="meta")
    w_dn = torch.empty(32, 128, device="meta")
    ops, moved, prec = e["geglu_ffn"].count(x, w_up, None, w_dn, None)
    assert ops == 24 * 128 * 32 * 32 and prec == "bf16"
    assert moved == 2 * x.numel() * 2 + (w_up.numel() + w_dn.numel()) * 4
    wq = torch.empty(32, 32, device="meta")
    ops, _, _ = e["self_attention_block"].count(x, None, None, wq, wq, wq, wq, None, 4)
    assert ops == 2 * 2 * 64 * 32 * 32 * 4 + 4 * 2 * 64 * 64 * 32
    q = torch.empty(3, 1024, 1, 512, device="meta")
    ops, _, prec = e["vae_attention"].count(q, q, q)
    assert ops == 4 * 3 * 1024 * 1024 * 512 and prec == "f32"
