"""DDIM with classifier-free guidance and the configuration's two cuts,
plain.

DDIM (diffusers ``DDIMScheduler``: scaled-linear betas 0.00085 → 0.012
over 1000 steps, "leading" spacing with offset 1, eta 0, epsilon
prediction, ``set_alpha_to_one`` false). Guidance: the batch holds the
unconditional half (zero audio) first; eps = eps_u + g·(eps_c − eps_u).

The cuts, as the configuration's switches state them:
``LATENTSYNC_DEEPCACHE`` "I:d[:enc[:k]]": the whole UNet runs at every
I-th step and writes the cache; the other steps read it, except the first
step of the guidance interval when the interval starts after step 0.
``LATENTSYNC_CFG_INTERVAL`` "lo:hi": guidance runs for steps
round(lo·N) <= j < round(hi·N), the conditional half alone elsewhere; a
half-batch step reads and writes the conditional half of the cache.
"""

from __future__ import annotations

import numpy as np
import torch


def ddim_tables(steps: int, train_steps: int = 1000, beta_start: float = 0.00085,
                beta_end: float = 0.012, offset: int = 1):
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, train_steps, dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas).astype(np.float32)
    ratio = train_steps // steps
    ts = ((np.arange(steps) * ratio).round()[::-1] + offset).astype(np.int64)
    prev = ts - ratio
    a_t = acp[ts]
    a_p = np.where(prev >= 0, acp[np.clip(prev, 0, None)], acp[0]).astype(np.float32)
    return ts, a_t, a_p


def knobs(env: dict, steps: int, n_blocks: int):
    """(interval, depth, enc, sub, cfg_lo, cfg_hi) from the configuration's
    switch strings."""
    dc = env.get("LATENTSYNC_DEEPCACHE", "")
    interval, depth, enc, sub = 0, 0, False, 0
    if dc and dc != "0":
        parts = dc.split(":")
        interval = int(parts[0])
        depth = int(parts[1]) if len(parts) > 1 else 1
        enc = len(parts) > 2
        sub = int(parts[3]) if enc and len(parts) > 3 else 0
        assert 0 <= depth <= n_blocks
        if interval <= 1:
            interval, depth, enc, sub = 0, 0, False, 0
    lo, hi = 0, steps
    ci = env.get("LATENTSYNC_CFG_INTERVAL", "")
    if ci:
        a, b = (float(v) for v in ci.split(":"))
        lo, hi = int(round(a * steps)), int(round(b * steps))
    return interval, depth, enc, sub, lo, hi


def _tmap(fn, *trees):
    if isinstance(trees[0], tuple):
        return tuple(_tmap(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def schedule(env: dict, steps: int, guidance: float, n_blocks: int):
    """The static per-step plan: [(use_cfg, read, half_with_cache)]."""
    interval, depth, enc, sub, lo, hi = knobs(env, steps, n_blocks)
    do_cfg = guidance > 1.0
    varies = do_cfg and (lo > 0 or hi < steps)
    plan = []
    for j in range(steps):
        use_cfg = do_cfg and lo <= j < hi
        read = bool(interval) and j % interval != 0
        if interval and varies and lo > 0 and j == lo:
            read = False
        plan.append((use_cfg, read, bool(interval) and do_cfg and not use_cfg))
    return plan, (depth, enc, sub)


@torch.no_grad()
def denoise(unet, latents0, mask, masked, ref, audio, steps: int, guidance: float, env: dict):
    """latents0/mask/masked/ref (W, F, h, w, C), audio (W, F, S, D) →
    denoised latents (W, F, h, w, 4) float32."""
    plan, (depth, enc, sub) = schedule(env, steps, guidance,
                                       len(unet.cfg["block_out_channels"]))
    ts, a_t, a_p = ddim_tables(steps)
    w = latents0.shape[0]
    cond = torch.cat([mask, masked, ref], dim=-1).permute(0, 4, 1, 2, 3).float()
    audio = audio.float()
    cond2 = torch.cat([cond, cond])
    audio2 = torch.cat([torch.zeros_like(audio), audio])
    lat = latents0.permute(0, 4, 1, 2, 3).float()
    cache = None

    def call(x, c, a, t, cache_in, read):
        inp = torch.cat([x, c], dim=1)
        tv = torch.full((inp.shape[0],), float(t), device=inp.device)
        if not depth:
            return unet(inp, tv, a), cache_in
        return unet(inp, tv, a, cache=cache_in, depth=depth, read=read, enc=enc, sub=sub)

    for j, (use_cfg, read, half) in enumerate(plan):
        if use_cfg:
            eps, cache = call(torch.cat([lat, lat]), cond2, audio2, ts[j], cache, read)
            eps = eps[:w] + guidance * (eps[w:] - eps[:w])
        elif half:
            part = None if cache is None else _tmap(lambda c: c[w:], cache)
            eps, new = call(lat, cond, audio, ts[j], part, read)
            if not read:
                old = cache if cache is not None else _tmap(torch.zeros_like, new)
                cache = _tmap(lambda full, n: torch.cat([full[:w], n]), old, new)
        else:
            eps, cache = call(lat, cond, audio, ts[j], cache, read)
        at = torch.tensor(a_t[j], dtype=torch.float32)
        ap = torch.tensor(a_p[j], dtype=torch.float32)
        x0 = (lat - torch.sqrt(1.0 - at) * eps) / torch.sqrt(at)
        lat = torch.sqrt(ap) * x0 + torch.sqrt(1.0 - ap) * eps
    return lat.permute(0, 2, 3, 4, 1)
