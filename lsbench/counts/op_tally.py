"""Analytic per-family FLOP tally of the UNet forward: a copy of the
port's ``latentsync_tpu_torch/scripts/op_tally.py`` ``tally`` that reads a
configuration file's ``unet`` section and imports nothing of the port.

Every op instance of the LatentSync stage-2 UNet at the CFG-batched
serving shape (2·W windows of F frames at latent²). ``groupnorm_silu`` is
an elementwise estimate (10 operations an element); every other family
counts a multiply-add as 2 operations, as ``torch.utils.flop_counter``
does. ``PRODUCT_FAMILIES`` are the products.
"""

from __future__ import annotations

from collections import defaultdict

PRODUCT_FAMILIES = ("conv3x3", "proj_conv1x1", "dense_ff", "attn_proj", "spatial_attn_core",
                    "audio_attn_core", "temporal_attn_core", "time_proj")


def tally(w: int = 4, unet=None, frames: int = 16, latent: int = 32, audio_tokens: int = 50):
    """FLOPs per family of one forward at batch 2·`w` (CFG) of `frames`
    frames at `latent`²; `unet` is a configuration file's ``unet`` section."""
    cfg = unet
    f = frames
    bf = 2 * w * f  # frames through the 2D-folded path
    nb = 2 * w  # videos through the temporal path
    heads = cfg["attention_head_dim"]  # SD legacy: this is the number of heads
    mm_heads = cfg["motion_module"]["num_attention_heads"]
    chans = cfg["block_out_channels"]
    levels = len(chans)
    res_of_level = [latent // (2**i) for i in range(levels)]
    fl = defaultdict(float)

    def conv3(res, cin, cout, n=1.0):
        fl["conv3x3"] += n * 2 * bf * res * res * 9 * cin * cout

    def conv1(res, cin, cout, n=1.0):
        fl["proj_conv1x1"] += n * 2 * bf * res * res * cin * cout

    def dense(tokens, cin, cout, fam="dense_ff"):
        fl[fam] += 2 * tokens * cin * cout

    def spatial_attn(res, c):
        s = res * res
        d = c // heads
        dense(bf * s, c, 3 * c, "attn_proj")  # q, k, v
        dense(bf * s, c, c, "attn_proj")  # out
        fl["spatial_attn_core"] += 2 * 2 * bf * heads * s * s * d  # QK^T + PV

    def audio_attn(res, c):
        s = res * res
        d = c // heads
        dense(bf * s, c, c, "attn_proj")  # q
        dense(bf * audio_tokens, cfg["cross_attention_dim"], 2 * c, "attn_proj")  # k, v
        dense(bf * s, c, c, "attn_proj")  # out
        fl["audio_attn_core"] += 2 * 2 * bf * heads * s * audio_tokens * d

    def ff(tokens, c):
        dense(tokens, c, 8 * c)  # GEGLU up (2 × 4c)
        dense(tokens, 4 * c, c)  # down

    def temporal_module(res, c):
        s = res * res
        d = c // mm_heads
        dense(nb * s * f, c, c, "attn_proj")  # proj_in
        dense(nb * s * f, c, c, "attn_proj")  # proj_out
        for _ in cfg["motion_module"]["attention_block_types"]:
            dense(nb * s * f, c, 3 * c, "attn_proj")
            dense(nb * s * f, c, c, "attn_proj")
            fl["temporal_attn_core"] += 2 * 2 * nb * s * mm_heads * f * f * d
        ff(nb * s * f, c)

    def gn(res, c, n=1.0):
        fl["groupnorm_silu"] += n * 10 * bf * res * res * c  # elementwise estimate

    def resnet(res, cin, cout):
        conv3(res, cin, cout)
        conv3(res, cout, cout)
        gn(res, cin)
        gn(res, cout)
        if cin != cout:
            conv1(res, cin, cout)
        dense(bf // f, cfg["block_out_channels"][0] * 4, cout, "time_proj")

    def transformer(res, c):
        gn(res, c)
        conv1(res, c, c, 2)  # proj_in / proj_out
        spatial_attn(res, c)
        audio_attn(res, c)
        ff(bf * res * res, c)

    conv3(latent, cfg["in_channels"], chans[0])  # conv_in
    for i, btype in enumerate(cfg["down_block_types"]):
        res, c = res_of_level[i], chans[i]
        cin = chans[i - 1] if i else chans[0]
        for j in range(cfg["layers_per_block"]):
            resnet(res, cin if j == 0 else c, c)
            if btype.startswith("CrossAttn"):
                transformer(res, c)
            if cfg["use_motion_module"]:
                temporal_module(res, c)
        if i < levels - 1:  # the stride-2 conv, at its output size
            conv3(res_of_level[i + 1], c, c)
    res, c = res_of_level[-1], chans[-1]  # mid
    resnet(res, c, c)
    transformer(res, c)
    resnet(res, c, c)
    rev = list(reversed(chans))
    for i, btype in enumerate(cfg["up_block_types"]):
        level = levels - 1 - i
        res, c = res_of_level[level], rev[i]
        prev_c = rev[i - 1] if i else chans[-1]
        for j in range(cfg["layers_per_block"] + 1):
            # skip channels: the last layer takes the level below's
            res_skip = rev[i + 1] if (j == cfg["layers_per_block"] and i < levels - 1) else rev[i]
            cin = (prev_c if j == 0 else c) + res_skip
            resnet(res, cin, c)
            if btype.startswith("CrossAttn"):
                transformer(res, c)
            if cfg["use_motion_module"]:
                temporal_module(res, c)
        if i < levels - 1:  # upsample, then the conv at twice the size
            conv3(res * 2, c, c)
    gn(latent, chans[0])  # conv_norm_out
    conv3(latent, chans[0], cfg["out_channels"])  # conv_out
    return dict(fl)
