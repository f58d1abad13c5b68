"""Stage-2 UNet training, on one card or data-parallel across several (the
port's counterpart of ``scripts/train_unet.py``).

    python -m latentsync_tpu_torch.scripts.train_unet --config configs/unet_stage2.yaml \\
        --max-steps 4 --output-dir debug/unet [--device cpu]
    python -m torch.distributed.run --nproc_per_node 4 \\
        -m latentsync_tpu_torch.scripts.train_unet --config ...

Trains ``training/unet_trainer.UNetTrainer`` on the clips the config's
``data.train_fileslist`` / ``train_data_dir`` name (``.mp4`` with a ``.wav``
sidecar where there is no ffmpeg), printing one JSON line every
``--log-every`` steps (``step``, ``loss``, ``steps_per_sec``,
``loss_components``, and on the card ``peak_memory_gib``) and saving
``step_%08d.pt`` every ``save_ckpt_steps`` and at the end; ``--resume``
continues from the latest one (weights, optimizer state and step). Where a
checkpoint file is absent the weights are random, as the JAX CLI's: the
UNet with ``UNET_ZERO_PATHS`` zeroed, the VAE, SyncNet and LPIPS filled
as ``fast_init`` fills them, and TREPA on the small 64² ViT of the JAX CLI.
``$LATENTSYNC_LPIPS_CKPT`` and ``$LATENTSYNC_VIDEOMAE_CKPT`` name the LPIPS
and VideoMAEv2-giant files. The card unless ``--device cpu``. Under
``torch.distributed.run`` the first ``gcd(batch, ranks)`` ranks train, each
on its share of the batch and its own card (``parallel/mesh.py``); a rank
beyond them says so and exits 0; rank 0 alone prints, saves and validates.
Validation runs the port's ``LipsyncPipeline`` on the config's val pair at
each checkpoint and scores the render with the SyncNet scorer
(``eval/sync_eval.py``, seeded random weights as in the JAX CLI), printing
``val_sync_conf``. At the end the train losses and the validation scores
(where there are any) are drawn to ``loss_chart.png``, best-effort as in
the JAX CLI.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import torch


def _load_file(path: str):
    """(state dict, global step) of a torch checkpoint (``state_dict`` and
    ``global_step`` unwrapped where present)."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    return raw.get("state_dict", raw), int(raw.get("global_step", 0))


def build(config, args, device, dtype):
    """(UNet in f32, VAE, SyncNet, LPIPS, TREPA, global step) as the JAX
    CLI builds them, each made and filled on `device`."""
    with torch.device(device):
        return _build_models(config, args, device, dtype)


def _build_models(config, args, device, dtype):
    from ..models.perceptual import LPIPS
    from ..models.syncnet import StableSyncNet
    from ..models.unet3d import UNet3DConditionModel
    from ..models.vae import AutoencoderKL
    from ..models.videomae import TREPALoss, VideoViT, VideoViTConfig
    from ..utils.convert import UNET_ZERO_PATHS, fast_init_
    from .inference import _isfile, _load_unet, _load_vae

    unet = fast_init_(UNet3DConditionModel(config.unet), seed=0, zero_paths=UNET_ZERO_PATHS)
    step = 0
    if _isfile(args.unet_ckpt):
        _load_unet(unet, args.unet_ckpt)
        step = _load_file(args.unet_ckpt)[1]
    vae = AutoencoderKL(config.vae)
    if _isfile(args.vae_ckpt):
        _load_vae(vae, args.vae_ckpt)
    else:
        fast_init_(vae, seed=1)
    syncnet = lpips = trepa = None
    run = config.run
    if run.pixel_space_supervise:
        if run.use_syncnet:
            syncnet = fast_init_(StableSyncNet(config.syncnet), seed=2)
            if _isfile(args.syncnet_ckpt):
                syncnet.load_state_dict(_load_file(args.syncnet_ckpt)[0])
            syncnet = syncnet.to(device, dtype).eval()
        if run.perceptual_loss_weight > 0:
            lpips = fast_init_(LPIPS(), seed=3)
            path = os.environ.get("LATENTSYNC_LPIPS_CKPT", "")
            if _isfile(path):
                lpips.load_state_dict(_load_file(path)[0])
            lpips = lpips.to(device, dtype).eval()
        if run.trepa_loss_weight > 0:
            path = os.environ.get("LATENTSYNC_VIDEOMAE_CKPT", "")
            if _isfile(path):
                vit = VideoViT(VideoViTConfig.giant())
                sd = _load_file(path)[0]
                vit.load_state_dict({k: v for k, v in sd.get("module", sd).items()
                                     if not k.startswith("head")})
            else:
                # no release weights: the small 64² ViT of the JAX CLI
                vit = fast_init_(VideoViT(VideoViTConfig(
                    img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4,
                    mlp_ratio=4.0)), seed=0)
            trepa = TREPALoss(vit.to(device, dtype).eval())
    return unet.to(device), vae.to(device, dtype).eval(), syncnet, lpips, trepa, step


def run_validation(unet, vae, config, output_dir: str, step: int, device, dtype):
    """The full inference pipeline on the config's val pair at a checkpoint,
    its render scored by the SyncNet scorer (ref:scripts/train_unet.py:459-494);
    returns the sync confidence, or None where the pair is absent or a step
    failed. Never raises: validation must not stop training."""
    vp, ap = config.data.val_video_path, config.data.val_audio_path
    if not (vp and ap and os.path.isfile(vp) and os.path.isfile(ap)):
        return None
    try:
        from ..audio.features import Audio2Feature
        from ..config import WhisperConfig
        from ..models.whisper import WhisperEncoder
        from ..pipelines.lipsync import LipsyncPipeline
        from ..utils.convert import init_random_

        cad = config.unet.cross_attention_dim
        wcfg = (WhisperConfig.tiny() if cad == 384 else WhisperConfig.small() if cad == 768
                else WhisperConfig(n_audio_state=cad, n_audio_head=max(1, cad // 8),
                                   n_audio_layer=1))
        whisper = init_random_(WhisperEncoder(wcfg), seed=3).to(device, dtype).eval()
        pipe = LipsyncPipeline(copy.deepcopy(unet).to(dtype).eval(), vae,
                               Audio2Feature(whisper, num_frames=config.data.num_frames),
                               config, dtype=dtype, device=device)
        out_dir = os.path.join(output_dir, "val_videos")
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, f"step_{step:08d}.mp4")
        pipe(vp, ap, out, num_inference_steps=config.run.inference_steps,
             guidance_scale=config.run.guidance_scale, seed=config.run.seed)
        conf = None
        try:
            from ..eval.sync_eval import SyncNetEvaluator

            conf = float(SyncNetEvaluator(device=device).evaluate(out)[2])
        except Exception as e:  # noqa: BLE001 — scoring must not kill training
            print(f"val sync scoring skipped: {e}")
        print(json.dumps({"val_step": step, "val_video": out, "val_sync_conf": conf}))
        return conf
    except Exception as e:  # noqa: BLE001 — validation must not kill training
        print(f"validation failed at step {step}: {e}")
        return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="")
    p.add_argument("--max-steps", type=int, default=0)
    p.add_argument("--output-dir", default="debug/unet")
    p.add_argument("--unet-ckpt", default="")
    p.add_argument("--vae-ckpt", default="")
    p.add_argument("--syncnet-ckpt", default="")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest step_*.pt in --output-dir (weights, "
                        "optimizer state and step)")
    p.add_argument("--overfit", action="store_true",
                   help="train on the first batch with the same t and noise every step")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from ..config import LatentSyncConfig, load_unet_config
    from ..parallel.mesh import card_of_rank, init_data_parallel, shutdown
    from .inference import no_card

    if no_card("train_unet", args.device):
        return 2
    device = card_of_rank(args.device)
    dtype = torch.bfloat16
    config = load_unet_config(args.config) if args.config else LatentSyncConfig()
    batch_size = max(config.data.batch_size, 1)
    place = init_data_parallel(batch_size, device)
    if not place.active:
        print(f"train_unet: rank {place.rank} of {place.world} idle: the data-parallel degree "
              f"is gcd(batch {batch_size}, {place.world} ranks) = {place.dp}")
        return 0
    try:
        return _train(args, config, place, device, dtype)
    finally:
        shutdown()


def _train(args, config, place, device, dtype) -> int:
    from ..parallel.mesh import broadcast_
    from ..training.data import HostDataLoader, UNetSampleSource
    from ..training.unet_trainer import UNetTrainer
    from ..utils.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint

    main = place.rank == 0
    if main:
        os.makedirs(args.output_dir, exist_ok=True)
        if place.distributed:
            print(json.dumps({"data_parallel": {"backend": torch.distributed.get_backend(),
                                                "world": place.world, "dp": place.dp}}))
    unet, vae, syncnet, lpips, trepa, global_step = build(config, args, device, dtype)
    trainer = UNetTrainer(config, unet, vae, syncnet, lpips, trepa, dtype=dtype)
    if args.resume:
        ckpt = latest_checkpoint(args.output_dir)
        if ckpt:
            state = restore_checkpoint(ckpt)
            unet.load_state_dict(state["params"])
            trainer.optimizer.load_state_dict(state["opt_state"])
            global_step = int(state["step"])
            if main:
                print(json.dumps({"resumed_from": ckpt, "step": global_step}))
    broadcast_(list(trainer.params.values()))

    f = config.data.num_frames
    loader = HostDataLoader(UNetSampleSource(config, seed=config.run.seed),
                            batch_size=max(config.data.batch_size, 1) // place.dp,
                            host_id=place.rank, num_hosts=place.dp)
    max_steps = args.max_steps or config.run.max_train_steps
    fixed = None
    losses, val_confs = [], []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    try:
        for batch in loader:
            if args.overfit:
                fixed = batch if fixed is None else fixed
                batch = fixed
            if "audio_embeds" not in batch:
                # the whisper cache feeds them in full training; zero-conditioned here
                batch["audio_embeds"] = torch.zeros(
                    (batch["gt_pixels"].shape[0], f, 50, config.unet.cross_attention_dim))
            t, noise = trainer.draw(batch, 0 if args.overfit else global_step, place.rank,
                                    place.dp)
            metrics = trainer.train_step(batch, t, noise)
            global_step += 1
            if global_step % args.log_every == 0:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                losses.append((global_step, metrics["total"]))
                rec = {"step": global_step, "loss": metrics["total"],
                       "steps_per_sec": args.log_every / (time.time() - t0)}
                extra = {k: v for k, v in metrics.items()
                         if k not in ("total", "recon", "grad_norm")}
                if extra:
                    rec["loss_components"] = dict({"recon": metrics["recon"]}, **extra)
                if device.type == "cuda":
                    rec["peak_memory_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
                if place.dp > 1:
                    rec["data_parallel"] = place.dp
                if main:
                    print(json.dumps(rec), flush=True)
                t0 = time.time()
            if global_step % config.run.save_ckpt_steps == 0 and main:
                save_checkpoint(args.output_dir, global_step, trainer.params,
                                trainer.optimizer.state_dict())
                conf = run_validation(unet, vae, config, args.output_dir, global_step, device,
                                      dtype)
                if conf is not None:
                    val_confs.append((global_step, conf))
            if global_step >= max_steps:
                break
    finally:
        loader.close()
    if not main:
        return 0
    print(json.dumps({"saved": save_checkpoint(args.output_dir, global_step, trainer.params,
                                               trainer.optimizer.state_dict()),
                      "step": global_step}))
    if losses or val_confs:
        try:
            from ..utils.observability import plot_loss_chart

            series = [("train_loss", [s for s, _ in losses], [v for _, v in losses])]
            if val_confs:
                series.append(("val_sync_conf", [s for s, _ in val_confs],
                               [v for _, v in val_confs]))
            plot_loss_chart(os.path.join(args.output_dir, "loss_chart.png"), *series)
        except Exception as e:  # noqa: BLE001 — charting is best-effort
            print(f"loss chart failed: {e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
