#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (latentsync_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each of which must pass (the script exits nonzero otherwise,
and without CUDA it exits nonzero before doing anything):

1. print the card's name and power limit; build the CUDA kernels from
   ``latentsync_tpu_torch/csrc`` (one nvcc per source, all at once, sm_90a);
2. hold every kernel against its plain PyTorch version in bf16 at every
   shape the serving path gives it (K8 at the 15 projection shapes of the
   int8-dense configuration, where it must be bitwise equal) and, for
   the kernels only the kernel probe runs (K9 fused q/k/v projection, K10
   int8-in/int8-out GEGLU, K11 one-shot attention, K12 streaming attention,
   and the flash route at head dims 40 and 80), at every shape the probe
   gives them at its default 4 windows (K10 up to C = 1280), and the flash
   route at CodeFormer's head dim 64 at 4 faces and 1 (one device kernel a
   call, none of torch's; under grad its residual forward gives the same
   output bits and one backward call, and a head dim with no kernel, or a
   launch the kernels refuse, still raises); K1, K2 (both
   modes), K3 and K4 also at the half-batch shapes of a step outside the
   CFG interval (window batch 2, no CFG batch); K2's temporal
   mode and K3 also at F = 8 and 24 frames; K1, K2 and K9 also at one shape
   whose K is no multiple of the GEMM template's 64-deep k-tile and whose M
   and N are ragged; time both with CUDA events, and beside them the one
   PyTorch library call that computes the same function, where there is
   one, or the library composition (K8: ``torch._int_mm`` on codes quantized
   before the timing, and the dequantization; K2 and K5: ``F.layer_norm``,
   ``F.linear``, SDPA, ``F.linear`` and the residual; K1: the cuBLAS
   composition of the GEGLU feed-forward; K10: dequantization, that
   composition and the row quantization), timed here and used nowhere in
   the port; count the device kernels one call of each kernel's wrapper
   launches (from a CUDA graph of the call) at its first shape, and K2's, K3's, K7's
   and K10's at every shape (K2's temporal mode must be ONE kernel, two at
   C = 640; K3, K7 and K10 one); compute each kernel's bound, the least time the card
   could take for the same work, from the bytes of its inputs and outputs and the
   operations of its shapes, and for the attention kernels the time their
   exponentials alone need on the special-function units
   (``exp_bound_ms``); the int8 convolution route (im2col +
   ``torch._int_mm``) against its float64 plain version at one UNet shape
   per width and the VAE's largest ones, with equal int32 accumulators;
   the flash route's backward kernels (``csrc/flash_attention_bwd.cu``)
   against their plain version at the three shapes of a UNet train step
   ((16, 1024, 1, 512), (16, 1024, 8, 40), (16, 256, 8, 80)) and the two
   of CodeFormer's training ((4, 256, 8, 64), (1, 256, 8, 64)), each of dq,
   dk, dv within TOL_REL of its own and BWD_REL_L2_TOL in relative L2,
   two device kernels a call from the residual forward's o and lse (three
   without them) and none of torch's, a repeat call equal bit for bit, the
   residual forward's o equal bit for bit to the forward without grad and
   its lse within LSE_TOL of the plain logsumexp; timed beside SDPA's
   backward and their bound, the residual forward beside the forward
   without grad;
3. the full-width UNet (LatentSync 1.5 stage 2, random seeded non-zero
   weights) in four configurations of the reference's switches: default,
   fused (``LATENTSYNC_PALLAS_GN=1 LATENTSYNC_FUSED_XATTN=1``), int8
   (``LATENTSYNC_INT8=1``) and int8-dense (``LATENTSYNC_INT8=1
   LATENTSYNC_INT8_DENSE=pallas``): eps is finite, non-zero and depends on
   the audio, each agrees with the default, and each bf16 GPU forward
   agrees with the f32 CPU forward of the same weights and configuration
   on a small input; the median of 5 warm batch-4 forwards of each, the
   GroupNorm shapes of one fused forward and the K8 shapes of one
   int8-dense forward, which must be those phase 2 checked, with K8's
   launches at each shape and the sum of their bounds; one default forward
   at F = 24 (window batch 1), finite, with K2 and K3 launched as often as
   the route predicts from each block's shape;
4. hold ``finish`` with its decoded chunks as host copies behind CUDA
   events (pinned memory, fetched on a thread) bitwise against the same
   chunks fetched in turn; serve three requests through the port's HTTP
   server at full width (synthetic 576² avatar, 1.2 s and 2.4 s of audio,
   20 DDIM steps, CFG 1.5) in the default configuration, check the output
   frame counts and that every kernel of that path ran (and no kernel of
   another); each request line prints ``overlap_s`` = ``vae_decode`` +
   ``restore`` - ``decode_restore_total`` (the fetch thread's and the
   restoring thread's busy time against the wall time of both);
5. serve two requests (1.2 s and 2.4 s) in the fused-kernel
   configuration, with the same checks;
6. serve the same two requests in the int8 and in the int8-dense
   configuration, with the same checks (int8-dense runs K8, the int8
   convolutions and the K3/K4/flash cores, and no K1/K2/K5);
7. run the port's kernel probe (``latentsync_tpu_torch.scripts.micro_probe``)
   in process at full width and its default 4 windows for its modes ffn,
   ffn8, spat and attn: every measurement it prints must be finite, and
   K9, K10 and K11 must have launched there; K12, which nothing in either
   package calls, is driven through its entry point at its three shapes;
8. onboard a synthetic talking head with the port's ``prepare_video`` on the
   card (the packaged fallback FAN behind the Haar box stage, the served
   VAE's weights from a file: bundle and ``_latents.npz``), hold the card's
   landmarks against the CPU port's on the same 16 frames, time the FAN per
   128 crops (the fallback, and a 2DFAN4-shaped FAN of 4 modules x 256 with
   seeded random weights, the size real weights have), and serve one request
   with no bundle (stage 3, face detection and alignment, on the card) and
   one from the new bundle, which must record no ``device_vae_encode``;
   frame counts, and the default configuration's kernels (and no other)
   launched in this phase.
9. the reference's production serving point (``LATENTSYNC_INT8=1
   LATENTSYNC_DEEPCACHE=4:1:enc LATENTSYNC_CFG_INTERVAL=0:0.5``): at batch 4
   a depth-1 write step (plain, ``enc``, ``enc:1``) equals the exact
   forward bit for bit, a read fed its true cache agrees with it within
   UNET_TOL, a stale cache moves it, and one ``enc`` read launches K1, K2
   and K4 and no K3; the kernel probe's ``dcread`` mode at batch 4 and 2
   with each variant's device kernels and device ms; one window batch
   denoised at the exact trajectory and at the FLOP cuts in the default and
   int8 configurations (wall, events, device ms, launches; the distance
   from the exact trajectory printed, not gated); three concurrent requests
   served with continuous batching at the production point, one device
   batch holding windows of two requests (1.8 s, 2.6 s and 1.8 s of
   audio: 3, 5 and 3 windows) and the int8 configuration's
   kernels (and no other) launched; three clips through ``run_pipelined``
   in job order beside the same clips one after another; and
   ``python -m latentsync_tpu_torch.scripts.inference --fast --device cuda``
   in a subprocess;
10. the paste-back, transcription and the job-queue worker: the host-link
   probe behind the default restore route (``LATENTSYNC_RESTORE`` unset:
   ``device`` above 200 MB/s); ``restore_frames_device`` on the card against
   its own CPU run on 64 synthetic 1920x1080 frames with 400² faces, for one
   constant align matrix and for per-frame jittered ones (within 1 code on
   at most 0.1 % of bytes), timed with its copies beside the native
   library and beside the frames' copies alone; one request with the default route and one with
   ``LATENTSYNC_RESTORE=native`` (both complete; the share of output bytes
   that differ printed); whisper-tiny at full width (random seeded weights,
   a stub tokenizer with Whisper's id layout) on one 30 s window of
   synthetic speech: teacher-forced logits card vs CPU within LOGIT_TOL,
   greedy tokens equal up to the CPU's first near tie, the encoder, the
   greedy decode and a beam of 5 timed; and ``QueueWorker`` draining three
   jobs against the server (plain, dependent and concatenated after it, with
   subtitles from that transcriber). Every request line of phases 4-10
   prints the restore route it took;
11. stage-2 training (LatentSync 1.5, ``configs/unet_stage2.yaml``): (a) the gradients of K1-K4 and the flash route through their
   ``autograd.Function``s against the plain versions' at the trainer's
   shapes (batch 1, 16 frames); (b) one full-width loss and backward (phase
   3's weights, seeded SyncNet, LPIPS and TREPA nets) with the kernels
   against the same step with every wrapper forced to its plain version on
   the card: loss and per-group gradient distances, every trainable tensor
   with a finite non-zero gradient, each kernel of the path launched (counts
   set to 0 just before), peak memory, the step's time and its split, one
   step under ``torch.profiler``; (c)
   ``python -m latentsync_tpu_torch.scripts.train_unet`` on the stage-2
   config for 4 steps in its own process on clips written here (60 frames,
   ``.wav`` sidecars), whose checkpoint phase 14 (c) resumes;
12. face restoration: (a) the full-width CodeFormer (``CodeFormer()``
   defaults, seeded random non-zero weights, positions included) in bf16 at
   1 and 4 faces of 512², w = 0.5: finite, w = 0 and w = 1 apart, the
   flash kernel launched once a transformer layer (9) a forward and no
   other kernel of the port; against the same weights in f32 with every
   wrapper forced to its plain version (TF32 off): code logits within
   UNET_TOL in relative L2, the share of equal code indices printed, the
   output given the f32 run's codes within UNET_TOL; median of 5 warm
   forwards and device ms at each batch; (b) the full-width VQGAN
   autoencoder at 4 faces, finite and timed; (c) RetinaFace (mobile0.25,
   resnet50), YOLOv5-face (n, l), ParseNet and BiSeNet in f32 (TF32 off)
   within NET_F32_TOL of the port on the CPU, RRDBNet x2 in bf16 within
   UNET_TOL; (d) ``inference_codeformer --device cuda`` (its ``main`` in
   process) on two synthetic 720p PNGs and an 8-frame ``.mp4``, then
   ``inference_vqgan`` and ``crop_align_face``, each output of the input's
   (or the requested) shape;
13. restoration training at full width (``CodeFormer()``, the 512²
   ``VQAutoEncoder`` and ``VQGANDiscriminator``, batch 4, bf16, seeded
   random weights, synthetic faces written here): (a) a few steps of each
   stage (vqgan, code, joint) through ``train_codeformer.main``, finite
   losses, the median warm step and the peak memory of each; (b) with the
   counts set to 0 just before (a), the port's launcher of the flash
   backward called 9 times a stage-II step (one call a transformer layer:
   2 device kernels each, phase 2) and never in stages I and III (stage
   III's losses reach the transformer only through the argmax of its
   codes, so its gradient there is zero and no backward runs, as in the
   JAX package), the flash forward 9 times a stage-II step and 18 a
   stage-III one, neither the backward's plain version nor torch's SDPA
   called, no other kernel of the port launched; (c) one stage-II step at
   batch 1 on the card in bf16 and on the CPU in f32 (the plain attention)
   from the same weights and batch: at least RESTORE_CODES_MIN of the
   target codes equal, and with the CPU's target codes the loss within
   RESTORE_LOSS_TOL and the transformer's gradients within
   RESTORE_GRAD_TOL in relative L2 (the free-running loss and gradients printed); (d) ``train_restoration`` with a copy of
   ``options/codeformer_stage2.yaml`` naming the faces, 2 steps, and
   ``generate_latent_gt`` on 4 faces, each ``main`` in process;
14. the rest of training: (a) the gradients this slice adds against the
   plain composition's autograd on the card (K5 at the training forward's
   two fused shapes, K8 through ``dense_with_params`` at its 15 training
   shapes, K9 at the probe's, and the int8 convolution and dense routes
   straight through: the float product's gradient): one launch a call, the
   forward under grad equal bit for bit to the one without, each gradient
   within TOL_REL and BWD_REL_L2_TOL; (b) one full-width stage-2 loss and
   backward in each training configuration (``LATENTSYNC_FUSED_XATTN=1``,
   int8, int8-dense) against the same step with every wrapper forced to its
   plain version (K5 and K8 included): loss and per-group gradient
   distances, 100 % finite non-zero trainable gradients, the kernels of
   each path launched (K5 10 times, K8 360 at the shapes (a) checked) and no
   other, peak memory, the median of 3 warm steps; (c) ``train_unet``'s
   ``main`` under ``LATENTSYNC_INT8=1`` in process, in the environment
   ``python -m torch.distributed.run --nproc_per_node 1`` gives it (NCCL,
   world size 1), resuming phase 11 (c)'s step-4 checkpoint for 2 steps, its
   loss chart written; (d) the SyncNet trainer
   at full width (``configs/syncnet_16_pixel_attn.yaml``, batch 32, bf16)
   on seeded synthetic clips: warm steps, peak memory, ``sat_frac``, one
   step at batch 2 on the card in f32 and in bf16 against f32 on the CPU,
   ``train_syncnet`` for 4 steps with validation every 2 (chart,
   checkpoints with both loss histories) and a ``--resume`` step, and
   ``eval_syncnet_acc``, each ``main`` in process;
15. evaluation and data preparation (seeded random weights, batch-norm
   statistics included; each sub-phase's wall time printed): (a) the SyncNet
   scorer (f32, TF32 off) on a 5 s synthetic talking clip (125 frames at
   224², 16 kHz), card against the CPU port: lip and audio features and the
   distance matrix within EVAL_TOL in relative L2, the offset (unless the
   CPU's two smallest mean distances are a near tie) and the confidence;
   the median ``evaluate_arrays`` and windows per second; (b) HyperIQA
   (ResNet50, 224²) on the quality gate's 3 sampled frames and a batch of
   16, card against CPU, frames per second; (c) Inception-I3D at the FVD
   point (16 × 224², batch 4), logits card against CPU, clips per second,
   and ``eval_fvd --device cuda`` in a subprocess on two directories of 4
   synthetic 16-frame clips (a finite FVD tagged ``random``); (d)
   ``data_processing_pipeline --device cuda --with-quality-gate`` in a
   subprocess with permissive gates on a 6 s clip and a 12 s one with a hard
   cut at 6 s (256², ``.wav`` sidecars): three 256² clips with their
   sidecars, every stage's count, no stage's failure line (the stages
   swallow a file's exception), the same list from a resumed run in process,
   then ``eval_sync_conf --device cuda`` over them in process (a finite row a
   file and the mean); (e) at
   full width, each ``main()`` in process (``build_pipeline`` answering with
   phase 4's pipeline): ``validate_fidelity`` on a 1.2 s clip, the exact
   trajectory against the production point (``weights: random``, gate
   INCONCLUSIVE, finite confidences, a non-zero ``pixel_delta``; each
   render's launches read on its own: the exact render's the default
   configuration's kernels and no other, the production render's the int8
   configuration's and no other),
   ``inference_videos --score`` on one pair (the default configuration's
   kernels and no other) and the trainer's ``run_validation`` on phase 3's
   UNet (a finite ``val_sync_conf``);
16. the last modules: (a) ``scripts/mesh_serving.py`` under ``python
   -m torch.distributed.run`` over every card of the machine (NCCL; one
   card: world 1, dp 1 × tp 1) at full width, CFG 1.5, bf16, a window a
   card (at least MESH_WINDOWS_MIN), in the default configuration (20
   steps), then in the fused and int8-dense ones (MESH_CONFIG_STEPS steps,
   the two launches at once): every dp × tp layout's UNet forward and
   window batch within MESH_TOL of the single-rank run in relative L2
   (bitwise printed), each rank's kernel launches a forward those of the
   single-rank forward at its shape, and every kernel of the
   configuration's UNet (MESH_ON_PATH: K1-K4; K5-K7; K8 and the int8
   convolution route) launched; (b) the landmark
   trainer (``train_landmark_fallback``, 1 module × 128 features, batch 16)
   for LANDMARK_STEPS steps on LANDMARK_FACES rendered faces (its default
   draws 4000), its ``main`` in process: the loss falls, the NME is
   printed, the saved asset loads through the port's FAN detector; two
   steps from one model on the card and on the CPU (f32, TF32 off, the same
   batch indices) agree (LANDMARK_TOL); (c) ``ops/deform_conv.py`` and
   ``ops/upfirdn.py`` on the card against their CPU runs (CV_TOL), timed;
   (d) ``perf_probe`` on phase 4's pipeline and ``transport_probe``, in
   process, their lines printed: the FLOP count of the kernels' plain
   versions on the meta device within 1e-3 of ``op_tally``'s;
17. the last pieces: (a) the cog ``Predictor`` (``latentsync_tpu_torch/
   predict.py``), ``setup()`` then ``predict()`` as cog calls them, on a 1.2
   s synthetic talking clip without a bundle at phase 4's full width (the
   FAN face path on the card; ``build_pipeline`` answers with phase 4's
   pipeline): the frames padded to whole windows, the audio, regenerated
   faces (at least REGEN_SHARE_MIN of the pixels), the wall time, and the
   default configuration's kernels each launched and no other; (b)
   ``Wav2LipSyncNet`` at its real geometry, card against CPU in f32 with
   TF32 off (EVAL_TOL), and a bf16 forward at batch WAV2LIP_BATCH_BF16: its
   median ms by CUDA events beside its bound, and its distance from f32.

The line before the last is a JSON object with each kernel's launches on
its path (``"path"``: the served configuration, ``probe``, ``train`` for
the flash route's backward (phase 11 (b); its launches in phase 13 (a)
beside them as ``restoration_train_launches``, and each of its shapes
marked ``train`` or ``restoration_train``), ``codeformer`` for the flash
route at D = 64 (one forward at 4 faces in phase 12 (a); its launches in
phase 13 beside them) or, for K12, ``kernels``), its largest error
against the plain version, its time, the plain version's, the library
call's (or null) and its bound with the resource that sets it (K12's
``at_shapes``: those numbers at each of its three shapes). A name
appears once, but for the flash route's forward
(``dot_product_attention``), which has an entry for the served
configurations and one for ``codeformer``. K5's and K8's entries carry
``train_launches``, their launches in phase 14 (b)'s fused and int8-dense
steps, K9's ``train_launches`` 0 (no trainer calls it) beside its
launches under grad in phase 14 (a), and K1's its launches in a SyncNet
step. K1-K8 carry ``mesh_launches``: a forward's launches on rank 0 of
phase 16 (a)'s first layout in ``mesh_path``, the first of the default,
fused and int8-dense configurations that serves them. The last line is
the device record.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import types
import urllib.request

SEED = 1247
# kernel vs plain version in bf16: |err| <= TOL_REL * max(1, max|plain|),
# about two bf16 ulps at the output's top binade (the kernels keep f32
# where the plain versions round to bf16, and sum in another order)
TOL_REL = 2.0**-6
# full-width UNet, bf16 GPU vs f32 CPU, and fused vs default
# configuration: relative L2 error of eps
UNET_TOL = 5e-2
# int8 configurations: eps against the default's (quantization error; the
# reference's own tests allow 0.10-0.12 mean-relative at toy size), and the
# bf16 GPU forward against the f32 CPU forward of the same configuration
INT8_TOL = 0.25
INT8_CPU_TOL = 0.10
# the reference's switches, by configuration of the same served model
CONFIGS = {
    "default": {},
    "fused": {"LATENTSYNC_PALLAS_GN": "1", "LATENTSYNC_FUSED_XATTN": "1"},
    "int8": {"LATENTSYNC_INT8": "1"},
    "int8-dense": {"LATENTSYNC_INT8": "1", "LATENTSYNC_INT8_DENSE": "pallas"},
}
# the configurations that train besides the default (``LATENTSYNC_PALLAS_GN``
# cannot: K6 and K7 have no gradient in either package)
TRAIN_CONFIGS = {"fused": {"LATENTSYNC_FUSED_XATTN": "1"}, "int8": CONFIGS["int8"],
                 "int8-dense": CONFIGS["int8-dense"]}
# every configuration by the name `configured` takes: a training one as
# ``train <name>``
_SWITCHES_OF = {**CONFIGS, **{f"train {k}": v for k, v in TRAIN_CONFIGS.items()}}
# the reference's production serving point and --fast mode (bench.py:32-53,
# scripts/inference.py:139-150): int8 with DeepCache 4:1:enc and CFG on the
# first half of the trajectory
FLOP_CUTS = {"LATENTSYNC_DEEPCACHE": "4:1:enc", "LATENTSYNC_CFG_INTERVAL": "0:0.5"}
SWITCHES = sorted({k for env in CONFIGS.values() for k in env} | set(FLOP_CUTS))
CACHE_MODES = {"plain": {}, "enc": {"cache_encoder": True},
               "enc:1": {"cache_encoder": True, "cache_sub": 1}}
# (M, K, N) of every K8 launch of one int8-dense forward at batch 4, 16
# frames, 32² latents: the q/k/v/out, GEGLU up and down projections of the
# spatial and temporal blocks at each level, and the audio context's k/v
QMM_SHAPES = [(65536, 320, 2560), (65536, 320, 320), (65536, 1280, 320),
              (16384, 640, 640), (16384, 640, 5120), (16384, 2560, 640),
              (4096, 1280, 1280), (4096, 1280, 10240), (4096, 5120, 1280),
              (1024, 1280, 1280), (1024, 1280, 10240), (1024, 5120, 1280),
              (3200, 384, 320), (3200, 384, 640), (3200, 384, 1280)]
# (N, C, *spatial), eps, SiLU of every GroupNorm of the served UNet at
# batch 4 (2 windows × CFG 2), 16 frames, 32² latents, by the kernel the
# reference's routing gives it: per-frame transformer/motion norms and
# the cross-frame resnet norms (up-block resnets see concatenated widths)
GN_SINGLE = [((64, 320, 32, 32), 1e-6, False), ((64, 640, 16, 16), 1e-6, False),
             ((64, 1280, 8, 8), 1e-6, False), ((64, 1280, 4, 4), 1e-6, False),
             ((4, 1280, 16, 4, 4), 1e-5, True)]
# the counted kernels (and the int8 convolution route) that each
# configuration's served path must launch; every other counted one must not
# published peaks of one NVIDIA H100 SXM (dense): bytes/s of device memory,
# operations/s by the type of the operands
MEM_RATE = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
# exponentials a clock an SM (the special-function units of one Hopper SM)
EXP_PER_CLOCK_SM = 16
# where the kernels run that no served configuration launches
PROBE_PATH = {"qkv_proj": "probe", "geglu_ffn_int8io": "probe", "oneshot_attention": "probe",
              "flash_attention": "kernels"}
FLASH_KERNEL_SHAPES = [(64, 1024, 512), (32, 1024, 512), (512, 1024, 128)]
# kernels whose every shape the kernels line gives (``at_shapes``), not the first alone
SHAPES_IN_LINE = {"flash_attention"}
_CORES = {"temporal_attention", "spatial_attention", "dot_product_attention"}
ON_PATH = {
    "default": _CORES | {"geglu_ffn", "self_attention_block"},
    "fused": _CORES | {"geglu_ffn", "self_attention_block", "cross_attention_block",
                       "group_norm_silu", "group_norm_silu_streaming"},
    "int8": _CORES | {"geglu_ffn", "self_attention_block", "conv_acc"},
    "int8-dense": _CORES | {"quantized_matmul", "conv_acc"},
}
GN_STREAMING = [((4, c, 16, 32, 32), 1e-5, True) for c in (960, 640, 320)] \
    + [((4, c, 16, 16, 16), 1e-5, True) for c in (1920, 1280, 960, 640, 320)] \
    + [((4, c, 16, 8, 8), 1e-5, True) for c in (2560, 1920, 1280, 640)] \
    + [((4, 2560, 16, 4, 4), 1e-5, True)]


_T0 = time.time()


def log(msg: str) -> None:
    """A line of the report (a phase's verdict with the seconds since the
    start); a failed check's line also goes to standard error, so that the
    reason stands beside the exit code."""
    if msg.startswith("phase "):
        msg = f"{msg} [{time.time() - _T0:.0f} s since the start]"
    print(msg, flush=True)
    if "FAIL" in msg:
        print(msg, file=sys.stderr, flush=True)


def gpu_query(fields: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def gpu_line() -> str:
    return gpu_query("name,power.limit")


def exp_rate() -> float:
    """Exponentials a second the card can do at most: 16 a clock on each SM
    at the highest SM clock ``nvidia-smi`` reports for it."""
    import torch

    mhz = float(gpu_query("clocks.max.sm").split()[0])
    return EXP_PER_CLOCK_SM * torch.cuda.get_device_properties(0).multi_processor_count * mhz * 1e6


@contextlib.contextmanager
def configured(conf: str, cuts: bool = False):
    """The switches of configuration `conf` (a name of _SWITCHES_OF; with
    `cuts`, and the FLOP cuts of the production point), and no other, for
    the duration (the port reads them at each call)."""
    old = {k: os.environ.pop(k, None) for k in SWITCHES}
    os.environ.update(_SWITCHES_OF[conf])
    if cuts:
        os.environ.update(FLOP_CUTS)
    try:
        yield
    finally:
        for k, v in old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def cuda_ms(fn, warmup: int = 2, iters: int = 10) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_cases():
    """One entry per kernel: name, wrapper, plain version, source, the TPU
    kernel it replaces, the library call (or None) and its shapes, each
    (label, make_args, operations, operand type) and, for an attention
    kernel, the exponentials of its softmax (one a logit: the least the
    function needs, whatever the kernel spends). The served kernels get
    the shapes of the served path: window batch 2 × CFG 2 → B = 4 sequences
    of 16 frames, 32² latents, channels 320/640/1280, 8 heads; the VAE
    encodes up to 64 faces and decodes 32 frames at a time. The probe's
    kernels get the probe's shapes at 4 windows (bf = 128 frames). The
    first shape of each kernel is the one whose times the JSON line
    reports."""
    import torch
    import torch.nn.functional as F

    from latentsync_tpu_torch.ops import attention, attn_block, ffn, groupnorm as gn
    from latentsync_tpu_torch.ops import qmm
    from latentsync_tpu_torch.ops import temporal_attention as ta

    def ffn_args(m, c):
        def make(r):
            return (r(m, c), r(8 * c, c, s=c**-0.5), r(8 * c, s=0.1), r(c, 4 * c, s=(4 * c) ** -0.5),
                    r(c, s=0.1), 1 + r(c, s=0.1), r(c, s=0.1)), {"residual": True}
        return f"M={m} C={c}", make, 24 * m * c * c, "bf16"

    def block_args(b, s, c, temporal, heads=8):
        def make(r):
            ws = [r(c, c, s=c**-0.5) for _ in range(4)]
            return ((r(b, s, c), 1 + r(c, s=0.1), r(c, s=0.1), *ws, r(c, s=0.1), heads),
                    {"temporal": temporal, "pe": r(s, c) if temporal else None})
        mode = "temporal" if temporal else "spatial"
        return f"{mode} B={b} S={s} C={c}", make, 8 * b * s * c * c + 4 * b * s * s * c, "bf16"

    def attn_args(b, s, hd, sliced=False):
        def make(r):
            if sliced:  # q/k/v as column slices of one (rows, 3·inner) projection
                qkv = r(b, s, 3 * hd)
                return (qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:], 8), {}
            return (r(b, s, hd), r(b, s, hd), r(b, s, hd), 8), {}
        label = f"B={b} S={s} heads*D={hd}" + (" sliced" if sliced else "")
        return label, make, 4 * b * s * s * hd, "bf16", b * 8 * s * s

    def flash_args(b, s=1024, h=1, d=512):
        def make(r):
            return (r(b, s, h, d), r(b, s, h, d), r(b, s, h, d)), {}
        return f"B={b} S={s} H={h} D={d}", make, 4 * b * h * s * s * d, "bf16", b * h * s * s

    def cross_args(b, s, c):
        def make(r):
            return ((r(b, s, c), 1 + r(c, s=0.1), r(c, s=0.1), r(b, 50, 384),
                     r(c, c, s=c**-0.5), r(c, 384, s=384**-0.5), r(c, 384, s=384**-0.5),
                     r(c, c, s=c**-0.5), r(c, s=0.1), 8), {})
        ops = 4 * b * s * c * c + 4 * b * 50 * 384 * c + 4 * b * s * 50 * c
        return f"B={b} S={s} C={c} Sk=50 Cc=384", make, ops, "bf16"

    def qmm_args(m, k, n):
        def make(r):
            return (r(m, k), r(n, k, s=k**-0.5), r(n, s=0.1)), {}
        return f"M={m} K={k} N={n}", make, 2 * m * k * n, "int8"

    def gn_args(shape, eps, silu):
        def make(r):
            c = shape[1]
            return (r(*shape) * 2 + 0.5, 1 + r(c, s=0.1), r(c, s=0.1), 32), \
                {"eps": eps, "silu": silu}
        # about ten f32 operations an element (statistics, normalise, SiLU)
        return f"{shape} eps={eps} silu={int(silu)}", make, 10 * math.prod(shape), "f32"

    def qkv_args(m, c):
        def make(r):
            return (r(m, c), *[r(c, c, s=c**-0.5) for _ in range(3)]), {}
        return f"M={m} C={c} inner={c}", make, 6 * m * c * c, "bf16"

    def i8_args(m, c):
        def make(r):
            return (*ffn.quantize_rowwise(r(m, c)), r(8 * c, c, s=c**-0.5), r(8 * c, s=0.1).float(),
                    r(c, 4 * c, s=(4 * c) ** -0.5), r(c, s=0.1).float()), {}
        return f"M={m} C={c}", make, 24 * m * c * c, "bf16"

    def bsd_args(b, s, d):
        def make(r):
            return (r(b, s, d), r(b, s, d), r(b, s, d)), {}
        return f"B={b} S={s} D={d}", make, 4 * b * s * s * d, "bf16", b * s * s

    # the one PyTorch call for the same function, where there is one
    def sdpa_bshd(q, k, v):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2)).transpose(1, 2)

    def sdpa_rows(q, k, v, heads):
        b, s, hd = q.shape
        q, k, v = (t.reshape(b, s, heads, hd // heads) for t in (q, k, v))
        return sdpa_bshd(q, k, v).reshape(b, s, hd)

    def sdpa_bsd(q, k, v):
        return F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None])[:, 0]

    def library_gn(x, scale, bias, groups, eps, silu):
        y = F.group_norm(x, groups, scale, bias, eps)
        return F.silu(y) if silu else y

    cat_cache = {}
    i8_cache = {}

    def library_qmm(x, w, b):
        """``torch._int_mm`` on codes quantized once a shape (in the warm-up,
        untimed) and its dequantization: the product and epilogue of K8
        without its quantization."""
        # shapes too: a freed shape's memory comes back for the next one
        key = (x.data_ptr(), w.data_ptr(), tuple(x.shape), tuple(w.shape))
        if key not in i8_cache:
            i8_cache.clear()
            xq, ascale = qmm.quantize_activations(x)
            wq, wscale = qmm.quantize_weight(w)
            i8_cache[key] = (xq.to(torch.int8), ascale, wq.t(), wscale)
        xq, ascale, wq_t, wscale = i8_cache[key]
        return (torch._int_mm(xq, wq_t).float() * ascale * wscale).to(x.dtype) + b

    def library_cross(x, ln_w, ln_b, ctx, wq, wk, wv, wo, bo, heads):
        b, s, c = x.shape
        h = F.layer_norm(x, (c,), ln_w, ln_b, 1e-6)
        q = F.linear(h, wq).view(b, s, heads, -1).transpose(1, 2)
        k = F.linear(ctx, wk).view(b, ctx.shape[1], heads, -1).transpose(1, 2)
        v = F.linear(ctx, wv).view(b, ctx.shape[1], heads, -1).transpose(1, 2)
        o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, s, -1)
        return x + F.linear(o, wo, bo)

    def library_qkv(x, wq, wk, wv):
        key = (wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), tuple(wq.shape))
        if key not in cat_cache:  # concatenated once a shape, in the warm-up
            cat_cache.clear()
            cat_cache[key] = torch.cat([wq, wk, wv])
        return F.linear(x, cat_cache[key]).chunk(3, dim=-1)

    def library_block(x, ln_w, ln_b, wq, wk, wv, wo, bo, heads, temporal, pe):
        """K2: ``F.layer_norm`` (+ pe), ``F.linear`` on the q/k/v weight
        concatenated once a shape, SDPA over each sequence's heads,
        ``F.linear`` with bias and the residual."""
        b, s, c = x.shape
        h = F.layer_norm(x, (c,), ln_w, ln_b, 1e-6)
        if pe is not None:
            h = h + pe
        q, k, v = (t.reshape(b, s, heads, -1).transpose(1, 2)
                   for t in library_qkv(h, wq, wk, wv))
        o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, s, -1)
        return x + F.linear(o, wo, bo)

    def library_ffn(x, w_up, b_up, w_dn, b_dn, ln_w, ln_b, residual):
        """K1: the cuBLAS composition (``F.layer_norm``, ``F.linear``, GELU
        gate, ``F.linear``, residual)."""
        h = F.layer_norm(x, (x.shape[-1],), ln_w, ln_b, 1e-6)
        value, gate = F.linear(h, w_up, b_up).chunk(2, dim=-1)
        y = F.linear(value * F.gelu(gate), w_dn, b_dn)
        return x + y if residual else y

    def library_ffn_int8io(codes, scales, w_up, b_up, w_dn, b_dn):
        """K10: dequantize, the GEGLU composition, quantize by rows."""
        x = (codes.float() * scales).to(w_up.dtype)
        value, gate = F.linear(x, w_up, b_up.to(x.dtype)).chunk(2, dim=-1)
        return ffn.quantize_rowwise(F.linear(value * F.gelu(gate), w_dn, b_dn.to(x.dtype)))

    def case(name, wrapper, plain, source, replaces, shapes, library=None, **extra):
        return dict(name=name, wrapper=wrapper, plain=plain, source=source, replaces=replaces,
                    shapes=shapes, library=library, **extra)

    return [
        case("geglu_ffn", ffn.geglu_ffn, ffn.geglu_ffn_reference,
             "latentsync_tpu_torch/csrc/geglu.cu", "latentsync_tpu/ops/ffn.py:82",
             [ffn_args(65536, 320), ffn_args(16384, 640), ffn_args(4096, 1280),
              ffn_args(1024, 1280),
              # a step outside the CFG interval (window batch 2, no CFG batch)
              ffn_args(32768, 320), ffn_args(8192, 640), ffn_args(2048, 1280),
              ffn_args(512, 1280),
              # K no multiple of the 64-deep k-tile, ragged M and N: the
              # zero-filled last tile and the masks
              ffn_args(200, 72)], library_ffn),
        case("self_attention_block", attn_block.self_attention_block,
             attn_block.self_attention_block_reference,
             "latentsync_tpu_torch/csrc/attn_block.cu", "latentsync_tpu/ops/attn_block.py:76",
             [block_args(4096, 16, 320, True), block_args(1024, 16, 640, True),
              block_args(64, 256, 640, False),
              # M = 208 (a row tile and a part), K = 120 (a short last k-tile)
              block_args(13, 16, 120, True, heads=3),
              # F != 16: sequences padded to 16 tile rows (F = 8) and to 32 (F = 24)
              block_args(4096, 8, 320, True), block_args(4096, 24, 320, True),
              block_args(1024, 8, 640, True), block_args(1024, 24, 640, True),
              # half batch
              block_args(2048, 16, 320, True), block_args(512, 16, 640, True),
              block_args(32, 256, 640, False)],
             library_block),
        case("temporal_attention", ta.temporal_attention, ta.temporal_attention_reference,
             "latentsync_tpu_torch/csrc/temporal_attention.cu",
             "latentsync_tpu/ops/temporal_attention.py:47",
             [attn_args(256, 16, 1280), attn_args(64, 16, 1280),
              # the composed blocks of int8-dense at C = 320 and 640
              attn_args(4096, 16, 320), attn_args(1024, 16, 640),
              # q/k/v pitched inside one fused projection (head dim 40)
              attn_args(64, 16, 320, sliced=True),
              # F != 16: one row tile, keys past F masked (8); two row tiles (24)
              attn_args(256, 8, 1280), attn_args(256, 24, 1280),
              # half batch
              attn_args(128, 16, 1280), attn_args(32, 16, 1280)], sdpa_rows),
        case("spatial_attention", ta.spatial_attention, ta.spatial_attention_reference,
             "latentsync_tpu_torch/csrc/spatial_attention.cu",
             "latentsync_tpu/ops/temporal_attention.py:173",
             [attn_args(64, 1024, 320), attn_args(64, 64, 1280), attn_args(64, 16, 1280),
              attn_args(64, 256, 640),  # int8-dense's block at C = 640
              # a length that is no multiple of the key tile, and K2's spatial
              # mode: q/k/v pitched inside one fused projection
              attn_args(2, 100, 320), attn_args(64, 256, 640, sliced=True),
              # half batch
              attn_args(32, 1024, 320), attn_args(32, 64, 1280), attn_args(32, 16, 1280)],
             sdpa_rows),
        case("dot_product_attention", attention.dot_product_attention,
             attention.dot_product_attention_reference,
             "latentsync_tpu_torch/csrc/flash_attention.cu", "latentsync_tpu/ops/attention.py:85",
             [flash_args(64), flash_args(32),
              # the probe's spatial shapes at 4 windows, 8 heads of D = 40 and 80
              flash_args(128, 1024, 8, 40), flash_args(128, 256, 8, 80)], sdpa_bshd),
        # CodeFormer's transformer (phase 12): 8 heads of 64 over 256 tokens,
        # 4 faces and 1; one device kernel a call at every shape
        case("dot_product_attention", attention.dot_product_attention,
             attention.dot_product_attention_reference,
             "latentsync_tpu_torch/csrc/flash_attention.cu", "latentsync_tpu/ops/attention.py:85",
             [flash_args(4, 256, 8, 64), flash_args(1, 256, 8, 64)], sdpa_bshd,
             path="codeformer", one_kernel=True, grad_runs=True),
        case("cross_attention_block", attn_block.cross_attention_block,
             attn_block.cross_attention_block_reference,
             "latentsync_tpu_torch/csrc/cross_attn_block.cu", "latentsync_tpu/ops/attn_block.py:284",
             [cross_args(64, 1024, 320), cross_args(64, 256, 640),
              cross_args(3, 300, 640)],  # a query length off the core's 128-row block
             library_cross),
        case("group_norm_silu", gn.group_norm_silu, gn.group_norm_silu_reference,
             "latentsync_tpu_torch/csrc/groupnorm.cu", "latentsync_tpu/ops/groupnorm.py:43",
             [gn_args(*a) for a in GN_SINGLE], library_gn),
        case("group_norm_silu_streaming", gn.group_norm_silu_streaming,
             gn.group_norm_silu_reference,
             "latentsync_tpu_torch/csrc/groupnorm.cu", "latentsync_tpu/ops/groupnorm.py:107",
             [gn_args(*a) for a in GN_STREAMING]
             # a spatial size that is no multiple of 8: element loads
             + [gn_args((3, 64, 5, 7), 1e-5, False)], library_gn),
        case("quantized_matmul", qmm.quantized_matmul, qmm.quantized_matmul_reference,
             "latentsync_tpu_torch/csrc/qmm.cu", "latentsync_tpu/ops/qmm.py:41",
             [qmm_args(*a) for a in QMM_SHAPES], library_qmm),
        case("qkv_proj", ffn.qkv_proj, ffn.qkv_proj_reference,
             "latentsync_tpu_torch/csrc/qkv_proj.cu", "latentsync_tpu/ops/ffn.py:269",
             [qkv_args(131072, 320), qkv_args(32768, 640), qkv_args(8192, 1280),
              qkv_args(200, 72)],  # ragged M, N and last k-tile
             library_qkv),
        case("geglu_ffn_int8io", ffn.geglu_ffn_int8io, ffn.geglu_ffn_int8io_reference,
             "latentsync_tpu_torch/csrc/geglu_i8.cu", "latentsync_tpu/ops/ffn.py:338",
             [i8_args(131072, 320), i8_args(32768, 640),
              i8_args(200, 72),  # ragged M, N and last k-tile
              i8_args(300, 400),  # the column split with a ragged last piece
              # the probe's third level: column groups across blocks, the row pass
              i8_args(8192, 1280)],
             library_ffn_int8io),
        case("oneshot_attention", attention.oneshot_attention,
             attention.oneshot_attention_reference,
             "latentsync_tpu_torch/csrc/oneshot_attention.cu",
             "latentsync_tpu/ops/attention.py:109",
             [bsd_args(1024, 1024, 40), bsd_args(1024, 256, 80)], sdpa_bsd),
        case("flash_attention", attention.flash_attention, attention.flash_attention_reference,
             "latentsync_tpu_torch/csrc/flash_kernel.cu", "latentsync_tpu/ops/attention.py:145",
             [bsd_args(*a) for a in FLASH_KERNEL_SHAPES], sdpa_bsd),
    ]


def _tensors(x):
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def bound(args, kw, out, ops: float, kind: str):
    """(ms, "bytes" or "operations"): the least time the card could take,
    each input read once and each output written once at the memory rate,
    against `ops` operations at the peak rate for operands of `kind`."""
    nbytes = sum(t.numel() * t.element_size() for t in _tensors((args, kw, out)))
    by_bytes, by_ops = nbytes / MEM_RATE * 1e3, ops / PEAK_OPS[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def compare(name: str, got, ref):
    """(max abs err, tolerance, within tolerance, finite, bitwise equal) of a
    kernel's result against its plain version's."""
    import torch

    if name == "geglu_ffn_int8io":
        # scales within 2^-6 relative, codes within 1 (another summation
        # order can move a value across a rounding boundary), the
        # dequantized output within TOL_REL · max(1, max|plain|) plus one
        # output quantum
        (gi, gs), (ri, rs) = got, ref
        plain = ri.float() * rs
        err = (gi.float() * gs - plain).abs()
        tol = TOL_REL * max(1.0, float(plain.abs().max())) + rs
        good = bool((err <= tol).all()) and float(((gs - rs).abs() / rs).max()) <= TOL_REL \
            and int((gi.int() - ri.int()).abs().max()) <= 1
        return float(err.max()), float(tol.max()), good, bool(torch.isfinite(gs).all()), \
            torch.equal(gi, ri) and torch.equal(gs, rs)
    got, ref = _tensors(got), _tensors(ref)
    err = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))
    tol = TOL_REL * max(1.0, *(float(r.float().abs().max()) for r in ref))
    return err, tol, len(got) == len(ref) and err <= tol, \
        all(bool(torch.isfinite(g).all()) for g in got), \
        all(torch.equal(g, r) for g, r in zip(got, ref))


# device kernels of the port that one call must launch, by shape label (no
# torch kernel counted): K2's temporal mode is one kernel (two at C = 640,
# where the output product runs on the GEMM template), K3 and K7 one, K10
# one (two at C = 1280: the column-split kernel and its row pass)
KERNELS_A_CALL = {
    "self_attention_block": lambda label: (2 if "C=640" in label else 1)
    if label.startswith("temporal") else 4,
    "temporal_attention": lambda label: 1,
    "group_norm_silu_streaming": lambda label: 1,
    "geglu_ffn_int8io": lambda label: 2 if label.endswith("C=1280") else 1,
}


def _trace(fn):
    """[(name, device µs)] of the device kernels in one ``torch.profiler``
    trace of one call of `fn`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def device_kernels(fn, attempts: int = 8):
    """[(name, device µs)] of the device kernels one call of `fn` launches,
    from ``torch.profiler``. A call launches at least one kernel, so a
    trace with none lost its events (it happens on the card now and then,
    sometimes for several traces in a row): it is taken again, up to
    `attempts` times, each after a longer pause."""
    kernels = []
    for attempt in range(attempts):
        if attempt:
            time.sleep(0.25 * attempt)
        kernels = _trace(fn)
        if kernels:
            break
    return kernels


def graph_kernel_names(fn):
    """The names of the kernels one call of `fn` launches, read from the
    kernel nodes of a CUDA graph it is captured into (after one call
    outside the capture): every launch on the current stream becomes a
    node, so nothing is lost as a profiler trace's events can be. The
    names come from libcuda (``cuGraphKernelNodeGetParams``,
    ``cuFuncGetName`` / ``cuKernelGetName``)."""
    import ctypes

    import torch

    cu = ctypes.CDLL("libcuda.so.1")

    def check(code, what):
        if code:
            raise RuntimeError(f"{what}: libcuda error {code}")

    class KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                    ("block", ctypes.c_uint * 3), ("shared_mem", ctypes.c_uint),
                    ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                    ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        p = KernelNodeParams()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(p)),
              "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if p.func:
            check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func)), "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(p.kern)),
                  "cuKernelGetName")
        names.append(name.value.decode(errors="replace"))
    del graph
    torch.cuda.synchronize()
    return names


def _torch_kernel(name: str) -> bool:
    """Whether a device kernel, named as libcuda names it (mangled), is
    torch's (the wrappers' casts of parameters): ``_ZN2at...`` or
    ``...N2at6native...``."""
    return name.startswith("_ZN2at") or "2at6native" in name


def kernels_a_call(fn):
    """(the port's device kernels, torch's device kernels) that one call of
    `fn` launches, counted from the kernel nodes of a CUDA graph of the call
    (``graph_kernel_names``): a ``torch.profiler`` trace can lose some or
    all of its events on the card, a graph loses none."""
    names = graph_kernel_names(fn)
    port = sum(not _torch_kernel(n) for n in names)
    return port, len(names) - port


def device_busy(fn):
    """(device kernels, their summed device ms) of one call of `fn`."""
    kernels = device_kernels(fn)
    return len(kernels), sum(us for _, us in kernels) / 1e3


def check_kernels(device):
    import torch

    gen = torch.Generator().manual_seed(SEED)

    def r(*shape, s=1.0):
        return (torch.randn(shape, generator=gen) * s).to(device, torch.bfloat16)

    results, ok = [], True
    exps_per_s = exp_rate()
    for case in kernel_cases():
        name, wrapper, plain, library = (case[k] for k in ("name", "wrapper", "plain", "library"))
        entry = {"name": name, "route": "cuda", "source": case["source"],
                 "replaces": case["replaces"], "launches": 0, "max_abs_err": 0.0, "ms": None,
                 "plain_ms": None, "bound_ms": None, "bound_by": None, "library_ms": None,
                 "shape": case["shapes"][0][0]}
        if "path" in case:
            entry["path"] = case["path"]
        for i, (label, make, ops, kind, *exps) in enumerate(case["shapes"]):
            args, kw = make(r)
            with configured("fused"):  # the cross block launches its kernel only so
                before = wrapper.launches
                got = wrapper(*args, **kw)
                ref = plain(*args, **kw)
                torch.cuda.synchronize()
                launched = wrapper.launches == before + 1
                err, tol, close, finite, bitwise = compare(name, got, ref)
                bound_ms, bound_by = bound(args, kw, got, ops, kind)
                del ref
                ms = cuda_ms(lambda: wrapper(*args, **kw))
                plain_ms = cuda_ms(lambda: plain(*args, **kw))
                library_ms = None
                if library is not None:
                    library_ms = cuda_ms(lambda: library(*args, *kw.values()))
            # K8 must equal its plain version bit for bit
            good = launched and finite and close and (bitwise or name != "quantized_matmul")
            calls = ""
            one = case.get("one_kernel", False)
            if i == 0 or name in KERNELS_A_CALL or one:
                with configured("fused"):
                    port_k, torch_k = kernels_a_call(lambda: wrapper(*args, **kw))
                if i == 0:
                    entry.update(kernels_a_call=port_k, torch_kernels_a_call=torch_k)
                good &= name not in KERNELS_A_CALL or port_k == KERNELS_A_CALL[name](label)
                good &= not one or (port_k, torch_k) == (1, 0)
                calls = f" kernels_a_call={port_k} (+{torch_k} torch)"
            ok &= good
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            exp_bound = f" exp_bound_ms={exps[0] / exps_per_s * 1e3:.4f}" if exps else ""
            if name in SHAPES_IN_LINE:
                entry.setdefault("at_shapes", []).append(
                    {"shape": label, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by})
            if i == 0:
                entry.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
                if exps:
                    entry["exp_bound_ms"] = exps[0] / exps_per_s * 1e3
            lib = "none" if library_ms is None else f"{library_ms:.4f}"
            log(f"kernel {name:22s} {label:28s} max_abs_err={err:.6g} tol={tol:.6g} "
                f"bitwise={bitwise} ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib} "
                f"bound_ms={bound_ms:.4f} ({bound_by}){exp_bound}{calls} "
                f"{'ok' if good else 'FAIL'}")
            del args, kw, got
            torch.cuda.empty_cache()
        if case.get("grad_runs"):
            ok &= check_grad_route(name, wrapper, case["shapes"][0], r)
        results.append(entry)
    return results, ok


def check_grad_route(name, wrapper, shape, r) -> bool:
    """The flash route at D = 64 under grad: the residual forward launches
    once and gives the no-grad output bit for bit, its backward launches
    the backward kernels once; a head dim with no kernel raises before
    launching anything, and a launch the kernels refuse (D = 96 straight
    at the entry point) raises."""
    import torch

    from latentsync_tpu_torch.ops import _build, attention

    label, make = shape[0], shape[1]
    args, kw = make(r)
    q = args[0].detach().requires_grad_(True)
    with torch.no_grad():
        plain_out = wrapper(*args, **kw)
    before, bwd = wrapper.launches, attention.flash_attention_bwd.launches
    out = wrapper(q, *args[1:], **kw)
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    runs = (wrapper.launches == before + 1 and attention.flash_attention_bwd.launches == bwd + 1
            and torch.equal(out.detach(), plain_out) and bool(torch.isfinite(q.grad).all()))
    bad = torch.zeros((1, 256, 1, 128), device=q.device, dtype=q.dtype, requires_grad=True)
    try:
        wrapper(bad, bad, bad)
        no_kernel = ""
    except ValueError as e:
        no_kernel = str(e)
    t = torch.zeros((1, 256, 1, 96), device=q.device, dtype=q.dtype)
    f32 = torch.zeros((1, 1, 256), device=q.device)
    try:
        _build.call("ls_flash_attention_bwd", *[t.data_ptr()] * 5, 96, 96, 96,
                    *[t.data_ptr()] * 3, f32.data_ptr(), f32.data_ptr(), 1, 256, 1, 96,
                    96**-0.5, _build.stream(t))
        refused = ""
    except RuntimeError as e:
        refused = str(e)
    good = runs and bool(no_kernel) and bool(refused) \
        and attention.flash_attention_bwd.launches == bwd + 1
    log(f"kernel {name:22s} {label:28s} under grad: residual forward same_bits_as_no_grad="
        f"{torch.equal(out.detach(), plain_out)}, backward launched once={runs}; no kernel "
        f"at D = 128: {'raised' if no_kernel else 'did not raise'}; refused launch at D = 96: "
        f"{'raised (' + refused[:60] + ')' if refused else 'did not raise'} "
        f"{'ok' if good else 'FAIL'}")
    return good


def check_int8_conv(device) -> bool:
    """The int8 convolution route (im2col + ``torch._int_mm``) against its
    float64 plain version: equal int32 accumulators, at one UNet shape per
    width (64 frames; conv_in has K = 117, padded) and the VAE's 256² × 128
    convolution and decoder conv_out at the frames of one of the route's
    chunks; then the whole int8 convolution (quantization and dequant
    included) against the float bf16 convolution it replaces."""
    import torch
    import torch.nn.functional as F

    from latentsync_tpu_torch.ops import qconv

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    ok = True
    # (label, frames, Cin, H, Cout, frames timed)
    cases = [("UNet conv_in", 64, 13, 32, 320, 64), ("UNet 32² C=320", 64, 320, 32, 320, 64),
             ("UNet 16² C=640", 64, 640, 16, 640, 64), ("UNet 8² C=1280", 64, 1280, 8, 1280, 64),
             ("VAE 256² C=128", None, 128, 256, 128, 32),
             ("VAE decoder conv_out", None, 128, 256, 3, 32)]
    for label, n, cin, hw, cout, n_timed in cases:
        n = n or qconv.chunk_frames(hw, hw, cin * 9, cout)
        xq = torch.randint(-127, 128, (n, cin, hw, hw), generator=gen, device=device,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (cout, cin, 3, 3), generator=gen, device=device,
                           dtype=torch.int8)
        acc = qconv.conv_acc(xq, wq, (1, 1), (1, 1))
        equal = bool(torch.equal(acc, qconv.conv_acc_reference(xq, wq, (1, 1), (1, 1))))
        del xq, acc
        x = torch.randn((n_timed, cin, hw, hw), generator=gen, device=device).to(torch.bfloat16)
        w = (torch.randn((cout, cin, 3, 3), generator=gen, device=device)
             * (cin * 9) ** -0.5).to(torch.bfloat16)
        b = (0.1 * torch.randn(cout, generator=gen, device=device)).to(torch.bfloat16)
        y = qconv.quantized_conv2d(x, w, b, (1, 1), (1, 1))
        y_float = F.conv2d(x, w, b, 1, 1)
        rel = float((y.float() - y_float.float()).norm() / y_float.float().norm())
        ms = cuda_ms(lambda: qconv.quantized_conv2d(x, w, b, (1, 1), (1, 1)), iters=5)
        float_ms = cuda_ms(lambda: F.conv2d(x, w, b, 1, 1), iters=5)
        ok &= equal
        log(f"int8 conv {label:22s} acc ({n}, {cin}, {hw}, {hw})→{cout}: equal_int32={equal}; "
            f"({n_timed} frames) ms={ms:.4f} float_bf16_ms={float_ms:.4f} "
            f"rel_l2_vs_float={rel:.4g} {'ok' if equal else 'FAIL'}")
        del x, y, y_float
    torch.cuda.empty_cache()
    return ok


# ---------------------------------------------------------------------------
# phase 3: the full-width UNet
# ---------------------------------------------------------------------------


def check_unet(unet, device) -> bool:
    import torch

    from latentsync_tpu_torch.models.unet3d import UNet3DConditionModel

    gen = torch.Generator().manual_seed(SEED + 1)
    cfg = unet.config
    ok = True
    with torch.inference_mode():
        x = torch.randn((2, cfg.in_channels, 16, 32, 32), generator=gen)
        audio = torch.randn((2, 16, 50, cfg.cross_attention_dim), generator=gen)
        t = torch.tensor([981, 451])
        xb, ab = x.to(device, torch.bfloat16), audio.to(device, torch.bfloat16)
        xs, as_, ts = x[:1, :, :, :8, :8], audio[:1], t[:1]
        eps, small = {}, {}
        for conf in CONFIGS:
            with configured(conf):
                e = unet(xb, t.to(device), ab).float()
                e0 = unet(xb, t.to(device), torch.zeros_like(ab)).float()
                small[conf] = unet(xs.to(device, torch.bfloat16), ts.to(device),
                                   as_.to(device, torch.bfloat16)).float().cpu()
            torch.cuda.synchronize()
            eps[conf] = e
            finite = bool(torch.isfinite(e).all() and torch.isfinite(e0).all())
            mag = float(e.abs().mean())
            dep = float((e - e0).norm() / e.norm())
            good = finite and e.shape == (2, cfg.out_channels, 16, 32, 32) and mag > 1e-2 \
                and dep > 1e-3
            ok &= good
            log(f"unet {conf} eps (2, 4, 16, 32, 32): finite={finite} mean|eps|={mag:.6g} "
                f"|eps(audio)-eps(0)|/|eps|={dep:.6g} {'ok' if good else 'FAIL'}")
            if conf != "default":
                tol = INT8_TOL if conf.startswith("int8") else UNET_TOL
                rel = float((e - eps["default"]).norm() / eps["default"].norm())
                good = rel <= tol
                ok &= good
                log(f"unet {conf} vs default eps (2, 4, 16, 32, 32): rel_l2={rel:.6g} "
                    f"tol={tol} {'ok' if good else 'FAIL'}")
            del e0

        # the same weights in f32 on the CPU run the plain versions
        ref_model = UNet3DConditionModel(cfg)
        ref_model.load_state_dict({k: v.float().cpu() for k, v in unet.state_dict().items()})
        ref_model.eval()
        for conf, got in small.items():
            t0 = time.time()
            with configured("default" if conf == "fused" else conf):
                ref = ref_model(xs, ts, as_)
            cpu_s = time.time() - t0
            tol = INT8_CPU_TOL if conf.startswith("int8") else UNET_TOL
            rel = float((got - ref).norm() / ref.norm())
            good = bool(torch.isfinite(got).all()) and rel <= tol
            ok &= good
            log(f"unet {conf} bf16 GPU vs f32 CPU (1, 13, 16, 8, 8): rel_l2={rel:.6g} "
                f"tol={tol} cpu_s={cpu_s:.1f} {'ok' if good else 'FAIL'}")
        del ref_model
    return ok


def time_forwards(unet, device) -> bool:
    """Median of 5 warm forwards at the served batch 4 in each
    configuration; the GroupNorm shapes of one fused forward and the K8
    shapes of one int8-dense forward must be the ones phase 2 checked."""
    import statistics

    import torch

    from latentsync_tpu_torch.models import unet3d
    from latentsync_tpu_torch.ops import groupnorm as gn
    from latentsync_tpu_torch.ops import qconv

    gen = torch.Generator().manual_seed(SEED + 4)
    cfg = unet.config
    x = torch.randn((4, cfg.in_channels, 16, 32, 32), generator=gen).to(device, torch.bfloat16)
    audio = torch.randn((4, 16, 50, cfg.cross_attention_dim), generator=gen).to(
        device, torch.bfloat16)
    t = torch.full((4,), 501, device=device)
    seen = {"single": set(), "streaming": set(), None: set()}
    seen_qmm = collections.Counter()  # launches by (M, K, N)
    auto, qmm_fn = unet3d.group_norm_silu_auto, qconv.quantized_matmul

    def gn_spy(x, scale, bias, groups, eps=1e-5, silu=True):
        route = gn.gn_route(math.prod(x.shape[2:]), x.shape[1])
        seen[route].add((tuple(x.shape), eps, silu))
        return auto(x, scale, bias, groups, eps, silu)

    def qmm_spy(x2d, w, bias=None):
        seen_qmm[(*x2d.shape, w.shape[0])] += 1
        return qmm_fn(x2d, w, bias)

    with torch.inference_mode():
        for conf in CONFIGS:
            with configured(conf):
                unet3d.group_norm_silu_auto, qconv.quantized_matmul = gn_spy, qmm_spy
                try:
                    unet(x, t, audio)
                finally:
                    unet3d.group_norm_silu_auto, qconv.quantized_matmul = auto, qmm_fn
                if conf != "int8-dense":
                    assert not seen_qmm, "K8 ran outside the int8-dense configuration"
                if conf != "fused":
                    assert not any(seen.values()), "a GroupNorm kernel ran outside 'fused'"
                times = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    unet(x, t, audio)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
            log(f"unet forward batch 4 ({conf}): median_ms={statistics.median(times):.3f} "
                f"all_ms={[round(v, 3) for v in times]}")
            if conf == "fused":
                fused_seen = {k: set(v) for k, v in seen.items()}
                for v in seen.values():
                    v.clear()
    ok = True
    for route, want in (("single", GN_SINGLE), ("streaming", GN_STREAMING), (None, [])):
        good = fused_seen[route] == set(want)
        ok &= good
        log(f"GroupNorm shapes of one fused forward, {route}: {sorted(fused_seen[route])} "
            f"{'ok (as phase 2)' if good else 'FAIL (phase 2 checked ' + str(sorted(want)) + ')'}")
    good = set(seen_qmm) == set(QMM_SHAPES)
    ok &= good
    log(f"K8 shapes (M, K, N) of one int8-dense forward: {sorted(seen_qmm)} "
        f"{'ok (as phase 2)' if good else 'FAIL (phase 2 checked ' + str(sorted(QMM_SHAPES)) + ')'}")
    for shape, n in sorted(seen_qmm.items()):
        log(f"K8 launches of one int8-dense forward at (M, K, N) = {shape}: {n}, "
            f"bound {n} x {qmm_bound_ms(*shape):.4f} ms")
    log(f"K8 in one int8-dense forward: {sum(seen_qmm.values())} launches, bound sum "
        f"{sum(n * qmm_bound_ms(*shape) for shape, n in seen_qmm.items()):.4f} ms")
    return ok


def check_unet_frames(unet, device, frames: int = 24) -> bool:
    """One default forward at F = `frames` (window batch 1 × CFG 2): eps
    finite and of the expected shape, and K2 and K3 launched as often as
    the route predicts from each attention block's input shape (forward
    pre-hooks on the transformer blocks: a temporal block's sequences go to
    K2 where ``fused_route`` takes them, else to K3; a spatial block's to K2
    where it takes them). Counts are set to 0 just before the forward and
    read just after."""
    import torch

    from latentsync_tpu_torch.models import unet3d
    from latentsync_tpu_torch.ops import attn_block
    from latentsync_tpu_torch.ops import temporal_attention as ta

    want = collections.Counter()

    def temporal_hook(mod, inp):
        _, f, c = inp[0].shape
        for _ in mod.attention_blocks:
            want["K2" if attn_block.fused_route(f, c, c, True, mod.heads) else "K3"] += 1

    def spatial_hook(mod, inp):
        _, s_len, c = inp[0].shape
        if attn_block.fused_route(s_len, c, mod.attn1.weights()[0].shape[0], False, mod.heads):
            want["K2"] += 1

    hooks = [m.register_forward_pre_hook(temporal_hook) for m in unet.modules()
             if isinstance(m, unet3d.TemporalTransformerBlock)]
    hooks += [m.register_forward_pre_hook(spatial_hook) for m in unet.modules()
              if isinstance(m, unet3d.BasicTransformerBlock)]
    gen = torch.Generator().manual_seed(SEED + 6)
    cfg = unet.config
    x = torch.randn((2, cfg.in_channels, frames, 32, 32), generator=gen).to(device, torch.bfloat16)
    audio = torch.randn((2, frames, 50, cfg.cross_attention_dim), generator=gen).to(
        device, torch.bfloat16)
    t = torch.full((2,), 501, device=device)
    try:
        with torch.inference_mode(), configured("default"):
            attn_block.self_attention_block.launches = ta.temporal_attention.launches = 0
            eps = unet(x, t, audio)
            torch.cuda.synchronize()
            got = {"K2": attn_block.self_attention_block.launches,
                   "K3": ta.temporal_attention.launches}
    finally:
        for h in hooks:
            h.remove()
    finite = bool(torch.isfinite(eps.float()).all())
    good = finite and tuple(eps.shape) == (2, cfg.out_channels, frames, 32, 32) \
        and got == dict(want) and want["K2"] > 0 and want["K3"] > 0
    log(f"unet default eps (2, 4, {frames}, 32, 32) at F = {frames}: finite={finite} "
        f"launches K2={got['K2']} K3={got['K3']} (route predicts K2={want['K2']} "
        f"K3={want['K3']}) {'ok' if good else 'FAIL'}")
    return good


def qmm_bound_ms(m: int, k: int, n: int) -> float:
    """K8's bound at one shape: x, w and the output moved once (2MK + 2NK +
    2MN bytes) against 2MNK int8 operations."""
    return max((2 * m * k + 2 * n * k + 2 * m * n) / MEM_RATE,
               2 * m * n * k / PEAK_OPS["int8"]) * 1e3


# ---------------------------------------------------------------------------
# phase 4: the served path
# ---------------------------------------------------------------------------


def make_avatar(root: str, n_frames: int = 40, size: int = 576, crop_at: int = 32):
    """A synthetic avatar: smooth moving frames, a translation-only align
    matrix, 256² faces as the 2×2 average of the 512² crop, 512 boxes."""
    import numpy as np

    from latentsync_tpu_torch.utils.media import StreamingVideoWriter

    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    frames = np.stack([np.stack([128 + 90 * np.sin(xx / 37 + t / 5 + c) * np.cos(yy / 53 - c)
                                 for c in range(3)], -1) for t in range(n_frames)])
    frames = np.clip(frames + rng.normal(0, 4, frames.shape), 0, 255).astype(np.uint8)
    writer = StreamingVideoWriter(os.path.join(root, "avatar.mp4"), fps=25,
                                  frame_hw=(size, size))
    writer.append(frames)
    writer.close()
    crop = frames[:, crop_at:crop_at + 512, crop_at:crop_at + 512].astype(np.float32)
    faces = crop.reshape(n_frames, 256, 2, 256, 2, 3).mean(axis=(2, 4)).round().astype(np.uint8)
    mat = np.array([[1.0, 0.0, -crop_at], [0.0, 1.0, -crop_at]])
    np.savez(os.path.join(root, "avatar.npz"), faces=faces,
             boxes=np.tile([0, 0, 512, 512], (n_frames, 1)),
             affine_matrices=np.repeat(mat[None], n_frames, 0))
    return {f"{sec}s": write_speech(os.path.join(root, f"speech_{sec}.wav"), sec)
            for sec in (1.2, 2.4)}


def check_finish_fetch(pipeline, device) -> bool:
    """``finish`` on the card: decoded chunks handed over as host copies
    behind CUDA events (as ``denoise_decode_chunks`` hands them) give bitwise
    the frames of the same chunks fetched in turn with ``.cpu()``. A small
    synthetic clip that wraps past its end, the writer replaced by one that
    keeps the frames."""
    import numpy as np
    import torch

    from latentsync_tpu_torch.pipelines import lipsync

    kept = []

    class KeepFrames:
        def __init__(self, path, fps, frame_hw, audio_path=None):
            self.path, self.busy_s = path, 0.0

        def append(self, frames):
            kept.append(np.array(frames, copy=True))

        def close(self):
            return self.path

        def abort(self):
            pass

    rng = np.random.default_rng(SEED)
    nf, nw, res, hw, n_src = 16, 4, 256, 320, 40
    total = nf * nw
    frames = rng.integers(0, 256, (n_src, hw, hw, 3), dtype=np.uint8)
    gen = torch.Generator(device=device).manual_seed(SEED)
    chunks = [torch.randint(0, 256, (2 * nf, res, res, 3), generator=gen, device=device,
                            dtype=torch.uint8) for _ in range(nw // 2)]
    mat = np.array([[1.0, 0.0, -32.0], [0.0, 1.0, -32.0]])
    masks = (rng.random((total, res, res, 1)) > 0.5).astype(np.float32)

    def run(as_host_copies: bool):
        state = lipsync.JobState(
            latents0=None, mask_w=None, masked_lat_w=None, ref_lat_w=None, audio_w=None,
            frames=frames.copy(), boxes=[[0, 0, res, res]] * total, matrices=[mat] * total,
            masks=masks, pixel_values=np.zeros((total, res, res, 3), np.float32),
            audio_samples=np.zeros(16000 * 3, np.float32), num_frames=nf, num_windows=nw,
            video_fps=25, audio_sample_rate=16000, lat_hw=32, processor=None, timings={},
            start_time=time.time())
        pieces = [(slice(i * 2 * nf, (i + 1) * 2 * nf),
                   lipsync._to_host(c) if as_host_copies else c.cpu())
                  for i, c in enumerate(chunks)]
        writer_cls, lipsync.StreamingVideoWriter = lipsync.StreamingVideoWriter, KeepFrames
        kept.clear()
        try:
            with tempfile.TemporaryDirectory() as tmp:
                out = pipeline.finish(state, None, os.path.join(tmp, "x.mp4"), pieces=pieces)
        finally:
            lipsync.StreamingVideoWriter = writer_cls
        return np.concatenate(kept), out.elapsed, pieces

    got, timings, pieces = run(True)
    want, _, _ = run(False)
    good = all(isinstance(p, lipsync.HostCopy) and p.host.is_pinned() for _, p in pieces) \
        and got.shape == (total, hw, hw, 3) and bool(np.array_equal(got, want)) \
        and not np.array_equal(got, frames[np.arange(total) % n_src]) \
        and not any(t.name == "finish-fetch" for t in threading.enumerate())
    log(f"finish with host copies behind events vs chunks fetched in turn: bitwise="
        f"{bool(np.array_equal(got, want))} vae_decode={timings['vae_decode']:.4f}s "
        f"restore={timings['restore']:.4f}s {'ok' if good else 'FAIL'}")
    return good


def serve_requests(pipeline, root: str, audios, plan, counters, conf: str, cuts: bool = False,
                   on_state=None, **state_kw):
    """Serve `plan` [(audio, frames wanted)] in configuration `conf` (with
    `cuts`, at the production point's FLOP cuts) with every count at 0
    first; the kernels of that configuration (``ON_PATH``) must launch, and
    every other counted one must not. `state_kw` go to ``ServingState``,
    which `on_state` sees before the first request."""
    import torch

    from latentsync_tpu_torch.utils.media import read_video

    ok, jobs, launches = True, [], {}
    label = conf + (" + FLOP cuts" if cuts else "")
    # requests that overlap share the stream: their device_* stages are inclusive
    stages_note = " (device_* inclusive)" if state_kw.get("continuous_batching") else ""
    with http_server(pipeline, root, on_state, **state_kw) as base:
        for fn in counters:
            fn.launches = 0
        with configured(conf, cuts):
            jobs = submit_all(base, audios, plan)
            done = wait_all(base, jobs)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}
        for (job_id, _), (sec, want) in zip(jobs, plan):
            job = done.get(job_id, {"status": "timeout"})
            frames = -1
            if job["status"] == "completed":
                frames = read_video(job["output"], change_fps=False).shape[0]
            good = job["status"] == "completed" and job.get("num_frames") == want == frames
            ok &= good
            tm = job.get("timings", {})
            overlap = tm.get("vae_decode", float("nan")) + tm.get("restore", float("nan")) \
                - tm.get("decode_restore_total", float("nan"))
            log(f"request ({label}) audio={sec} status={job['status']} frames={frames} "
                f"(want {want}) restore_route={job.get('restore_route')} "
                f"latency_s={job.get('latency_s', float('nan')):.3f} "
                f"worker_s={job.get('elapsed', float('nan')):.3f} overlap_s={overlap:.3f} "
                f"stages{stages_note}={json.dumps(job.get('timings', {}), sort_keys=True)} "
                f"{'ok' if good else 'FAIL ' + str(job.get('error', ''))}")
    for name, n in launches.items():
        want_some = name in ON_PATH[conf]
        good = n > 0 if want_some else n == 0
        ok &= good
        log(f"launches on the served path ({label}): {name}={n} "
            f"{'ok' if good else 'FAIL'}{'' if want_some else ' (must be 0)'}")
    return launches, ok


@contextlib.contextmanager
def http_server(pipeline, root: str, on_state=None, **state_kw):
    """The port's HTTP server over `pipeline` and the avatars in `root`, on a
    free local port, for the duration; yields its base URL. `state_kw` go to
    ``ServingState``, which `on_state` sees before the first request."""
    from http.server import ThreadingHTTPServer

    from latentsync_tpu_torch.serving.api import ServingState, make_handler
    from latentsync_tpu_torch.serving.artifacts import AvatarStore

    state = ServingState(pipeline, AvatarStore(root), os.path.join(root, "out"), **state_kw)
    if on_state is not None:
        on_state(state)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        state.shutdown()
        thread.join(timeout=30)


def submit_all(base: str, audios, plan):
    jobs = []
    for sec, _ in plan:
        body = json.dumps({"avatar_id": "avatar", "audio_path": audios[sec]}).encode()
        req = urllib.request.Request(base + "/process", data=body, method="POST",
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            jobs.append((json.loads(resp.read())["job_id"], time.time()))
    return jobs


def wait_all(base: str, jobs, timeout_s: float = 900):
    done = {}
    deadline = time.time() + timeout_s
    while len(done) < len(jobs) and time.time() < deadline:
        for job_id, t_sub in jobs:
            if job_id in done:
                continue
            with urllib.request.urlopen(f"{base}/jobs/{job_id}", timeout=60) as resp:
                job = json.loads(resp.read())
            if job["status"] in ("completed", "failed"):
                job["latency_s"] = time.time() - t_sub
                done[job_id] = job
        time.sleep(0.2)
    return done


# card vs CPU landmarks of the same frames (the FAN's f32 convolutions with
# TF32 off on the card): most points agree to float rounding; a point whose
# two neighbouring heatmap values are nearly equal may flip its ±0.25 px
# refinement, which moves it by at most half a heatmap pixel (2 crop px at
# a 256² crop, scaled to the frame)
LM_CLOSE_PX, LM_CLOSE_SHARE, LM_MAX_PX = 0.05, 0.95, 4.0


def make_face_video(path: str, n_frames: int = 48, size: int = 320):
    """A synthetic talking head drawn with OpenCV (RGB): a skin-toned head
    on a plain background, brows, eyes, a nose and a mouth that opens and
    closes, moving a little; written at 25 fps. Returns the frames."""
    import cv2
    import numpy as np

    from latentsync_tpu_torch.utils.media import StreamingVideoWriter

    rng = np.random.default_rng(SEED)
    frames = []
    for t in range(n_frames):
        img = np.zeros((size, size, 3), np.uint8)
        img[:] = (70, 90, 110)
        cx = size // 2 + int(round(6 * math.sin(t / 7)))
        cy = int(size * 0.45) + int(round(4 * math.cos(t / 9)))
        cv2.ellipse(img, (cx, cy), (70, 92), 0, 0, 360, (224, 180, 150), -1)
        for side in (-1, 1):
            cv2.line(img, (cx + side * 42, cy - 36), (cx + side * 14, cy - 40), (60, 40, 30), 4)
            cv2.ellipse(img, (cx + side * 28, cy - 18), (12, 6), 0, 0, 360, (250, 250, 250), -1)
            cv2.circle(img, (cx + side * 28, cy - 18), 4, (40, 30, 20), -1)
        cv2.line(img, (cx, cy - 10), (cx - 5, cy + 18), (170, 120, 100), 3)
        opening = 3 + int(round(10 * abs(math.sin(t / 3))))
        cv2.ellipse(img, (cx, cy + 46), (26, opening), 0, 0, 360, (120, 40, 50), -1)
        noisy = img.astype(np.float32) + rng.normal(0, 3, img.shape)
        frames.append(np.clip(noisy, 0, 255).astype(np.uint8))
    frames = np.stack(frames)
    writer = StreamingVideoWriter(path, fps=25, frame_hw=(size, size))
    writer.append(frames)
    writer.close()
    return frames


def write_speech(path: str, sec: float, seed: int = SEED) -> str:
    """`sec` seconds of a tone (220 Hz, another pitch for another seed),
    amplitude-modulated at 3 Hz, with seeded noise: a 16 kHz WAV."""
    import numpy as np

    from latentsync_tpu_torch.utils.media import write_audio

    rng = np.random.default_rng(seed)
    tt = np.arange(int(16000 * sec)) / 16000.0
    hz = 220 + 20 * (seed - SEED)
    wave = 0.3 * np.sin(2 * np.pi * hz * tt) * (1 + np.sin(2 * np.pi * 3 * tt)) \
        + 0.05 * rng.standard_normal(tt.shape)
    write_audio(path, wave.astype(np.float32))
    return path


def landmark_agreement(a, b):
    """(largest distance in px, share of points within LM_CLOSE_PX)."""
    import numpy as np

    d = np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64), axis=-1)
    return float(d.max()), float((d <= LM_CLOSE_PX).mean())


def check_onboarding(pipeline, vae, device, counters):
    """Phase 8: onboard a synthetic talking head with the port's
    ``prepare_video`` on the card (the packaged fallback FAN behind the Haar
    box stage, the served VAE's weights from a file), hold the card's
    landmarks against the CPU port's on the same frames, time the FAN, then
    serve one request with no bundle (stage 3 on the card) and one from the
    new bundle with its ``_latents.npz`` (no VAE encode). Counts are set to
    0 before the onboarding and read after the two requests: the default
    configuration's kernels must launch and no other."""
    import contextlib
    import io

    import numpy as np
    import torch

    from latentsync_tpu_torch.models.face_detection import (FAN2D, FANLandmarkDetector,
                                                            HaarBoxDetector)
    from latentsync_tpu_torch.scripts import prepare_video
    from latentsync_tpu_torch.utils.convert import init_random_, load_state_dict_file
    from latentsync_tpu_torch.utils.image_processor import FALLBACK_FAN_PATH
    from latentsync_tpu_torch.utils.media import read_video

    ok = True
    saved = {k: os.environ.pop(k, None) for k in (
        "LATENTSYNC_FAN_CKPT", "LATENTSYNC_S3FD_CKPT", "LATENTSYNC_NO_FALLBACK_FAN")}
    try:
        with tempfile.TemporaryDirectory() as root, configured("default"):
            n_frames = 48
            video = os.path.join(root, "talker.mp4")
            make_face_video(video, n_frames)
            speech = write_speech(os.path.join(root, "speech.wav"), 1.2)
            vae_path = os.path.join(root, "vae.pt")
            torch.save(vae.state_dict(), vae_path)
            for fn in counters:
                fn.launches = 0
            out = io.StringIO()
            t0 = time.time()
            with contextlib.redirect_stdout(out):
                rc = prepare_video.main(["--video", video, "--avatar-id", "talker", "--store",
                                         os.path.join(root, "store"), "--vae-ckpt", vae_path,
                                         "--device", "cuda"])
            record = json.loads(out.getvalue().strip().splitlines()[-1])
            with np.load(record["bundle"]) as bundle:
                faces, mats = bundle["faces"], bundle["affine_matrices"]
            good = rc == 0 and faces.shape == (n_frames, 256, 256, 3) \
                and os.path.isfile(record["latents"]) and bool(np.isfinite(mats).all())
            ok &= good
            log(f"onboarding prepare_video on cuda: {n_frames} frames in "
                f"{time.time() - t0:.3f}s (faces {record['faces_s']:.3f}s, latents "
                f"{record['latents_s']:.3f}s) bundle faces {faces.shape} "
                f"{'ok' if good else 'FAIL'}")

            # the card's landmarks against the CPU port's on the same frames
            clip = list(read_video(video, change_fps=True, fps=25)[:16])
            sd = load_state_dict_file(FALLBACK_FAN_PATH)
            lm = {dev: FANLandmarkDetector(sd, face_detector=HaarBoxDetector(), device=dev)
                  .detect_batch(clip) for dev in (device, "cpu")}
            worst, share = landmark_agreement(lm[device], lm["cpu"])
            good = bool(np.isfinite(lm[device]).all()) and worst <= LM_MAX_PX \
                and share >= LM_CLOSE_SHARE
            ok &= good
            log(f"landmarks card vs CPU, 16 frames x 68 points: max {worst:.4g} px, "
                f"{100 * share:.2f}% within {LM_CLOSE_PX} px {'ok' if good else 'FAIL'}")

            # the FAN forward (and decode, and the coordinates' fetch) per 128
            # crops: the fallback, and the size of real 2DFAN4 weights
            fan4 = init_random_(FAN2D(4, 256), seed=SEED).state_dict()
            crops = np.repeat(faces, 3, axis=0)[:128]
            for label, state in (("fallback, 1 module x 128", sd),
                                 ("2DFAN4 shape, 4 modules x 256, random weights", fan4)):
                det = FANLandmarkDetector(state, device=device)
                det.landmarks(crops)
                times = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    det.landmarks(crops)
                    times.append((time.perf_counter() - t0) * 1e3)
                good = bool(np.isfinite(det.landmarks(crops[:4])).all())
                ok &= good
                log(f"FAN forward per 128 crops ({label}): median_ms={sorted(times)[1]:.3f} "
                    f"all_ms={[round(v, 3) for v in times]} {'ok' if good else 'FAIL'}")
                del det

            # one request with no bundle: stage 3 on the card
            res = pipeline(video, speech, os.path.join(root, "nobundle.mp4"))
            frames = read_video(res.video_path, change_fps=False).shape[0]
            tm = res.elapsed
            good = res.num_frames == frames == 32 and "device_vae_encode" in tm
            ok &= good
            log(f"request without a bundle: frames={frames} (want 32) restore_route="
                f"{res.restore_route} faces_s={tm['faces']:.3f} "
                f"({tm['faces'] / (n_frames / 25):.3f} s per second of video) "
                f"stages={json.dumps(tm, sort_keys=True)} {'ok' if good else 'FAIL'}")

            # one request from the new bundle and its latents: no VAE encode
            res = pipeline(record["video"], speech, os.path.join(root, "bundle.mp4"),
                           data_path=record["bundle"])
            frames = read_video(res.video_path, change_fps=False).shape[0]
            tm = res.elapsed
            good = res.num_frames == frames == 32 and "device_vae_encode" not in tm \
                and "device_denoise" in tm
            ok &= good
            log(f"request from the onboarded bundle and its _latents.npz: frames={frames} "
                f"(want 32) restore_route={res.restore_route} device_vae_encode recorded="
                f"{'device_vae_encode' in tm} "
                f"stages={json.dumps(tm, sort_keys=True)} {'ok' if good else 'FAIL'}")
            torch.cuda.synchronize()
            for fn in counters:
                want_some = fn.__name__ in ON_PATH["default"]
                good = fn.launches > 0 if want_some else fn.launches == 0
                ok &= good
                log(f"launches on the onboarding path: {fn.__name__}={fn.launches} "
                    f"{'ok' if good else 'FAIL'}{'' if want_some else ' (must be 0)'}")
    finally:
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
    return ok


def run_probe(device, counters):
    """Phase 7: the port's kernel probe in process, at full width and its
    default 4 windows, for the modes that run K9 (ffn), K10 (ffn8), K11
    (spat) and the flash route at head dims 40 and 80 (spat, attn); then
    K12 through its entry point at its three shapes. Every count is set to
    0 first and read after."""
    import torch

    from latentsync_tpu_torch.ops import attention
    from latentsync_tpu_torch.scripts import micro_probe

    for fn in counters:
        fn.launches = 0
    probe = micro_probe.Probe(device, w=4, iters=20,
                              emit=lambda rec: log("probe " + json.dumps(rec)))
    for which in ("ffn", "ffn8", "spat", "attn"):
        micro_probe.run(probe, which)
    ok = True
    for rec in probe.results:
        nums = [v for v in rec.values() if isinstance(v, (int, float))]
        good = "ms" in rec and all(math.isfinite(v) and v > 0 for v in nums)
        ok &= good
        if not good:
            log(f"probe measurement {rec.get('name')}: FAIL (not finite and positive)")
    good = len(probe.results) == 33
    ok &= good
    log(f"probe: {len(probe.results)} measurements (want 33) {'ok' if good else 'FAIL'}")
    with torch.inference_mode():
        for b, s, d in FLASH_KERNEL_SHAPES:
            q = probe.randn(b, s, d)
            o = attention.flash_attention(q, q, q)
            torch.cuda.synchronize()
            good = o.shape == q.shape and bool(torch.isfinite(o).all())
            ok &= good
            log(f"flash_attention ({b}, {s}, {d}) through its entry point: "
                f"{'ok' if good else 'FAIL'}")
    launches = {fn.__name__: fn.launches for fn in counters}
    for name, n in launches.items():
        good = n > 0 or name not in PROBE_PATH
        ok &= good
        log(f"launches on the probe path: {name}={n} {'ok' if good else 'FAIL (must launch)'}")
    return launches, ok


# ---------------------------------------------------------------------------
# phase 9: the production serving point
# ---------------------------------------------------------------------------


def _rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def _tree(fn, tree):
    return tuple(_tree(fn, t) for t in tree) if isinstance(tree, tuple) else fn(tree)


def check_deepcache(unet, device, counters) -> bool:
    """Phase 9.1, at batch 4 in the default configuration: a depth-1 write
    step (plain, ``enc``, ``enc:1``) is the exact forward bit for bit, a
    read fed its true cache agrees with it within UNET_TOL and a stale
    cache (x 1.5) moves it; one ``enc`` read launches K1, K2 and K4 and no
    K3 (the wrappers' counts, set to 0 just before it), and its device
    kernels are counted by ``torch.profiler``."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 7)
    cfg = unet.config
    x = torch.randn((4, cfg.in_channels, 16, 32, 32), generator=gen).to(device, torch.bfloat16)
    audio = torch.randn((4, 16, 50, cfg.cross_attention_dim), generator=gen).to(
        device, torch.bfloat16)
    t = torch.full((4,), 501, device=device)
    ok = True
    with torch.inference_mode(), configured("default"):
        base = unet(x, t, audio)
        for mode, kw in CACHE_MODES.items():
            eps, cache = unet(x, t, audio, cache_depth=1, **kw)
            bitwise = torch.equal(eps, base)
            read, _ = unet(x, t, audio, deep_cache=cache, cache_depth=1, cache_read=True, **kw)
            stale, _ = unet(x, t, audio, deep_cache=_tree(lambda c: c * 1.5, cache),
                            cache_depth=1, cache_read=True, **kw)
            rel, rel_stale = _rel_l2(read, base), _rel_l2(stale, base)
            good = bitwise and bool(torch.isfinite(read).all()) and rel <= UNET_TOL \
                and rel_stale > max(rel, 1e-3)
            ok &= good
            log(f"deepcache depth 1 {mode:5s} batch 4: write == exact forward bitwise={bitwise}; "
                f"read (true cache) rel_l2={rel:.6g} tol={UNET_TOL}; stale cache (x1.5) "
                f"rel_l2={rel_stale:.6g} {'ok' if good else 'FAIL'}")
            del eps, cache, read, stale
        kw = CACHE_MODES["enc"]
        _, cache = unet(x, t, audio, cache_depth=1, **kw)

        def enc_read():
            unet(x, t, audio, deep_cache=cache, cache_depth=1, cache_read=True, **kw)

        for fn in counters:
            fn.launches = 0
        enc_read()
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in counters}
        n_dev, dev_ms = device_busy(enc_read)
    ran = {k: counts[k] for k in ("geglu_ffn", "self_attention_block", "spatial_attention")}
    good = counts["temporal_attention"] == 0 and all(ran.values()) and n_dev > 0
    ok &= good
    log(f"one enc read at batch 4: temporal_attention={counts['temporal_attention']} "
        f"(must be 0) {' '.join(f'{k}={v}' for k, v in ran.items())} (must be > 0); "
        f"{n_dev} device kernels, {dev_ms:.3f} device ms {'ok' if good else 'FAIL'}")
    return ok


def run_dcread(unet, device) -> bool:
    """Phase 9.2: the probe's ``dcread`` mode in process at batch 4 and 2
    (``--w`` 2 and 1) on the served model, and beside each of its three
    variants the device kernels and device ms of one call
    (``torch.profiler``)."""
    import torch

    from latentsync_tpu_torch.scripts import micro_probe

    ok = True
    cfg = unet.config
    for w in (2, 1):
        b = 2 * w
        probe = micro_probe.Probe(device, w=w, iters=10,
                                  emit=lambda rec: log("probe " + json.dumps(rec)))
        with configured("default"):
            micro_probe.run(probe, "dcread", unet=unet)
            gen = torch.Generator().manual_seed(SEED + 8)
            x = torch.randn((b, cfg.in_channels, 16, 32, 32), generator=gen).to(
                device, torch.bfloat16)
            audio = torch.randn((b, 16, 50, cfg.cross_attention_dim), generator=gen).to(
                device, torch.bfloat16)
            t = torch.full((b,), 500, device=device)
            with torch.inference_mode():
                caches = {name: unet(x, t, audio, cache_depth=1, **CACHE_MODES[name])[1]
                          for name in ("plain", "enc")}
                calls = {"full": lambda: unet(x, t, audio)}
                for name in ("plain", "enc"):
                    calls[f"read_{name}"] = functools.partial(
                        unet, x, t, audio, deep_cache=caches[name], cache_depth=1,
                        cache_read=True, **CACHE_MODES[name])
                busy = {name: device_busy(fn) for name, fn in calls.items()}
            del caches
        ms = {rec["name"]: rec["ms"] for rec in probe.results}
        for name, (n_dev, dev_ms) in busy.items():
            probe_ms = ms.get(f"unet_{name}_b{b}", float("nan"))
            good = math.isfinite(probe_ms) and probe_ms > 0 and n_dev > 0
            ok &= good
            log(f"dcread batch {b} {name:10s}: ms={probe_ms:.3f} (probe, CUDA events over "
                f"chained calls) device_kernels={n_dev} device_ms={dev_ms:.3f} "
                f"{'ok' if good else 'FAIL'}")
    torch.cuda.empty_cache()
    return ok


def time_denoise(pipeline, device, counters) -> bool:
    """Phase 9.3: one window batch (W = 2, 20 DDIM steps, CFG 1.5) at the
    exact trajectory and at the production point's FLOP cuts, in the
    default and the int8 configuration, warm: wall time, the CUDA events'
    span on the stream, the device kernels' sum (``torch.profiler``, one
    more call) and the wrappers' launches. Latents finite; the relative L2
    from the exact trajectory is printed, not gated (random weights)."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 9)
    w, f, lat = 2, 16, 32
    lat0 = (torch.randn((1, 1, lat, lat, 4), generator=gen)
            .expand(w, f, lat, lat, 4).to(device))
    mask = torch.ones((w, f, lat, lat, 1), device=device)
    masked, ref = (torch.randn((w, f, lat, lat, 4), generator=gen).to(device) for _ in range(2))
    audio = torch.randn((w, f, 50, 384), generator=gen).to(device)

    def denoise():
        return pipeline._denoise(lat0, mask, masked, ref, audio, 20, 1.5)

    ok = True
    for conf in ("default", "int8"):
        exact = None
        for cuts in (False, True):
            with configured(conf, cuts):
                denoise()
                for fn in counters:
                    fn.launches = 0
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t0 = time.perf_counter()
                start.record()
                out = denoise()
                end.record()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
                launches = {fn.__name__: fn.launches for fn in counters if fn.launches}
                n_dev, dev_ms = device_busy(denoise)
            finite = bool(torch.isfinite(out).all())
            good = finite and tuple(out.shape) == (w, f, lat, lat, 4)
            ok &= good
            rel = "" if exact is None else f" rel_l2_vs_exact={_rel_l2(out, exact):.6g}"
            label = "4:1:enc + 0:0.5" if cuts else "exact"
            log(f"denoise W=2 20 steps ({conf}, {label}): wall_ms={wall_ms:.3f} "
                f"events_ms={start.elapsed_time(end):.3f} device_kernels={n_dev} "
                f"device_ms={dev_ms:.3f} launches={json.dumps(launches, sort_keys=True)} "
                f"finite={finite}{rel} {'ok' if good else 'FAIL'}")
            if exact is None:
                exact = out
    return ok


def serve_production(pipeline, root: str, counters):
    """Phase 9.4: three concurrent requests (1.8 s, 2.6 s and 1.8 s of three
    different speech tracks: 3, 5 and 3 windows) over HTTP, continuous
    batching (two workers, batches of two windows), at the production point.
    A request submits its windows together, so at batches of two an even
    count pairs up within the request; an odd one leaves a window to share
    a batch with the next request's. The batch function is wrapped here to
    name the request of each window of a batch (each window's audio against
    the windows ``prepare`` gave each request): at least one batch must
    hold windows of two requests."""
    import torch

    audios = {f"{sec}s #{i}": write_speech(os.path.join(root, f"prod_{i}.wav"), sec,
                                           seed=SEED + 1 + i)
              for i, sec in enumerate((1.8, 2.6, 1.8))}
    plan = [(label, 80 if label.startswith("2.6") else 48) for label in audios]
    lock = threading.Lock()
    prepared, requests_a_batch = [], []
    prepare = pipeline.prepare

    def prepare_spy(*a, **k):
        state = prepare(*a, **k)
        with lock:
            prepared.append(state.audio_w)
        return state

    def wrap(state):
        batcher = state._batchers[(20, 1.5)]
        batch_fn = batcher.batch_fn

        def batch_spy(stacked):
            with lock:
                known = list(enumerate(prepared))
            owners = {j for row in stacked["audio"] for j, windows in known
                      if any(torch.equal(row, win) for win in windows)}
            requests_a_batch.append(len(owners))
            return batch_fn(stacked)

        batcher.batch_fn = batch_spy

    pipeline.prepare = prepare_spy
    try:
        launches, ok = serve_requests(pipeline, root, audios, plan, counters, "int8", cuts=True,
                                      on_state=wrap, continuous_batching=True, batch_windows=2,
                                      num_workers=2)
    finally:
        del pipeline.prepare
    good = len(prepared) == 3 and max(requests_a_batch, default=0) >= 2
    ok &= good
    log(f"continuous batching: {len(requests_a_batch)} device batches of 2 windows, requests "
        f"a batch {requests_a_batch} (one must hold two) {'ok' if good else 'FAIL'}")
    return launches, ok


def check_pipelined(pipeline, root: str, audios) -> bool:
    """Phase 9.5: three clips (1.2 s, 2.4 s, 1.2 s) through ``run_pipelined``
    in the default configuration: outputs in job order with the right frame
    counts; its wall time beside the sum of the three clips served one after
    another in the same call. Overlapped clips share the stream, so their
    ``device_*`` stages are inclusive."""
    from latentsync_tpu_torch.utils.media import read_video

    video, bundle = os.path.join(root, "avatar.mp4"), os.path.join(root, "avatar.npz")
    plan = [("1.2s", 32), ("2.4s", 64), ("1.2s", 32)]
    ok = True
    with configured("default"):
        serial_s = 0.0
        for i, (key, _) in enumerate(plan):
            t0 = time.time()
            pipeline(video, audios[key], os.path.join(root, f"serial_{i}.mp4"), data_path=bundle)
            serial_s += time.time() - t0
        jobs = [(video, audios[key], os.path.join(root, f"pipelined_{i}.mp4"))
                for i, (key, _) in enumerate(plan)]
        t0 = time.time()
        outs = pipeline.run_pipelined(jobs, data_path=bundle)
        wall_s = time.time() - t0
    for (_, _, path), out, (key, want) in zip(jobs, outs, plan):
        frames = read_video(out.video_path, change_fps=False).shape[0]
        good = out.video_path == path and out.num_frames == want == frames
        ok &= good
        log(f"run_pipelined clip audio={key}: frames={frames} (want {want}) restore_route="
            f"{out.restore_route} total_s="
            f"{out.elapsed['total']:.3f} device_denoise_s (inclusive)="
            f"{out.elapsed.get('device_denoise', float('nan')):.3f} {'ok' if good else 'FAIL'}")
    log(f"run_pipelined: 3 clips in {wall_s:.3f} s wall, the same clips one after another "
        f"{serial_s:.3f} s (ratio {wall_s / serial_s:.3f})")
    return ok


def run_cli(root: str, audios) -> bool:
    """Phase 9.6: ``python -m latentsync_tpu_torch.scripts.inference --fast
    --device cuda`` in a subprocess on the synthetic avatar and its bundle
    (random seeded weights: no checkpoint files): it exits 0 and its JSON
    line has the frame count."""
    out = os.path.join(root, "cli.mp4")
    cmd = [sys.executable, "-m", "latentsync_tpu_torch.scripts.inference", "--video",
           os.path.join(root, "avatar.mp4"), "--audio", audios["1.2s"], "--out", out,
           "--data-path", os.path.join(root, "avatar.npz"), "--fast", "--device", "cuda"]
    env = {k: v for k, v in os.environ.items() if k not in SWITCHES}
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = proc.stdout.strip().splitlines()
    record = {}
    if proc.returncode == 0 and lines:
        record = json.loads(lines[-1])
    good = proc.returncode == 0 and record.get("frames") == 32
    log(f"inference CLI --fast --device cuda: rc={proc.returncode} frames={record.get('frames')} "
        f"(want 32) wall_s={time.time() - t0:.1f} stages="
        f"{json.dumps(record.get('timings', {}), sort_keys=True)} {'ok' if good else 'FAIL'}")
    if not good:
        log(proc.stderr[-3000:])
    return good


# ---------------------------------------------------------------------------
# phase 10: device restore, transcription, the job-queue worker
# ---------------------------------------------------------------------------

# device restore on the card against its own CPU run: every byte within 1
# code, at most 0.1 % of bytes off (a value within a rounding of an integer
# may truncate either way)
RESTORE_MAX_CODE, RESTORE_MAX_SHARE = 1, 1e-3
# whisper-tiny's teacher-forced logits, card against CPU, both f32 (TF32 off
# in the encoder's convolutions; products without TF32): within 1e-3 of the
# largest |logit|
LOGIT_TOL = 1e-3


@contextlib.contextmanager
def restore_switch(value):
    """``LATENTSYNC_RESTORE`` set to `value` (None: unset) for the duration."""
    old = os.environ.pop("LATENTSYNC_RESTORE", None)
    if value is not None:
        os.environ["LATENTSYNC_RESTORE"] = value
    try:
        yield
    finally:
        os.environ.pop("LATENTSYNC_RESTORE", None)
        if old is not None:
            os.environ["LATENTSYNC_RESTORE"] = old


def check_transport(device) -> bool:
    """Phase 10.1: the host link probe behind the default restore route."""
    from latentsync_tpu_torch.pipelines import lipsync

    rate = lipsync._transport_rate(device)
    fast = lipsync._transport_is_fast(device)
    with restore_switch(None):
        route = lipsync.restore_route(device)
    good = fast == (rate > 200.0) and route == ("device" if fast else "native")
    log(f"[{gpu_line()}] transport probe: 4 MB host->device {rate:.1f} MB/s, fast={fast} "
        f"(threshold 200 MB/s), default restore route={route} {'ok' if good else 'FAIL'}")
    return good


def check_device_restore(device) -> bool:
    """Phase 10.2: ``restore_frames_device`` on the card against the same
    function on the CPU, on 64 synthetic 1920x1080 frames with 400² faces,
    for one constant align matrix (the served case: the face lands on whole
    pixels) and for per-frame jittered ones; the device route (copies to the
    card and back included) timed beside the native library on the same
    frames, and the frames' copies up and back timed alone."""
    import numpy as np
    import torch

    from latentsync_tpu_torch.ops.restore import edge_radius, restore_frames_device
    from latentsync_tpu_torch.utils import native

    rng = np.random.default_rng(SEED)
    n, h, w, fs = 64, 1080, 1920, 400
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 80 * np.sin(xx / 71 + c) * np.cos(yy / 53 - c) for c in range(3)], -1)
    frames = np.empty((n, h, w, 3), np.uint8)
    for i, shift in enumerate(rng.normal(0, 6, (n, 3)).astype(np.float32)):
        frames[i] = np.clip(base + shift, 0, 255)
    faces = rng.integers(0, 256, (n, fs, fs, 3), dtype=np.uint8)
    const = np.repeat(np.array([[1.0, 0.0, -760.0], [0.0, 1.0, -300.0]])[None], n, 0)
    theta = rng.normal(0, 0.02, n)
    scale = 1.0 + rng.normal(0, 0.02, n)
    jitter = np.stack([np.array([[s * np.cos(t), -s * np.sin(t), -760.0 + dx],
                                 [s * np.sin(t), s * np.cos(t), -300.0 + dy]])
                       for t, s, dx, dy in zip(theta, scale, rng.normal(0, 4, n),
                                               rng.normal(0, 4, n))])
    # the copies the device route makes, alone: the frames up and back (pageable)
    torch.from_numpy(frames[:8]).to(device).cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = torch.from_numpy(frames).to(device)
    torch.cuda.synchronize()
    up_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    on_card.cpu()
    back_ms = (time.perf_counter() - t0) * 1e3
    del on_card
    log(f"[{gpu_line()}] the frames' copies alone ({frames.nbytes / 2**20:.0f} MiB, pageable): "
        f"up {up_ms:.1f} ms ({frames.nbytes / up_ms / 1e6:.2f} GB/s), back {back_ms:.1f} ms "
        f"({frames.nbytes / back_ms / 1e6:.2f} GB/s)")
    ok = True
    for label, mats in (("constant matrix", const), ("per-frame matrices", jitter)):
        restore_frames_device(frames[:8], faces[:8], mats[:8], device=device)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = restore_frames_device(frames, faces, mats, device=device)
        dev_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = restore_frames_device(frames, faces, mats, device="cpu")
        cpu_ms = (time.perf_counter() - t0) * 1e3
        scratch = frames.copy()
        t0 = time.perf_counter()
        if label.startswith("constant"):
            native.restore_frames_const_native(scratch, faces, mats[0], copy=False)
        else:
            native.restore_frames_native(scratch, faces, mats, copy=False)
        native_ms = (time.perf_counter() - t0) * 1e3
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        share = float((d > 0).mean())
        good = got.shape == frames.shape and int(d.max()) <= RESTORE_MAX_CODE \
            and share <= RESTORE_MAX_SHARE and float((got != frames).mean()) > 0.01
        ok &= good
        log(f"[{gpu_line()}] device restore ({label}, {n} x {w}x{h}, faces {fs}², edge "
            f"{edge_radius(mats, (fs, fs))}): card vs CPU max {int(d.max())} code(s), "
            f"{100 * share:.4f}% of bytes differ (limits {RESTORE_MAX_CODE}, "
            f"{100 * RESTORE_MAX_SHARE:.1f}%); device_ms={dev_ms:.1f} (with the copies) "
            f"native_ms={native_ms:.1f} cpu_device_route_ms={cpu_ms:.1f} "
            f"{'ok' if good else 'FAIL'}")
    return ok


def serve_both_routes(pipeline, root: str, audios) -> bool:
    """Phase 10.3: one request through the HTTP server with the default
    restore route and one with ``LATENTSYNC_RESTORE=native``: both complete
    with the right frame count; the share of output bytes that differ is
    printed (the two composites are different functions)."""
    import numpy as np

    from latentsync_tpu_torch.pipelines.lipsync import restore_route
    from latentsync_tpu_torch.utils.media import read_video

    ok, outputs = True, {}
    for value in (None, "native"):
        with restore_switch(value):
            route = restore_route(pipeline.device)
            with http_server(pipeline, root) as base:
                with configured("default"):
                    (job_id, t_sub), = submit_all(base, audios, [("1.2s", 32)])
                    job = wait_all(base, [(job_id, t_sub)])[job_id]
        frames = read_video(job["output"], change_fps=False) if job["status"] == "completed" \
            else None
        n = -1 if frames is None else len(frames)
        tm = job.get("timings", {})
        good = job["status"] == "completed" and n == 32 == job.get("num_frames") \
            and job.get("restore_route") == route
        ok &= good
        outputs[value] = frames
        nan = float("nan")
        overlap = tm.get("vae_decode", nan) + tm.get("restore", nan) \
            - tm.get("decode_restore_total", nan)
        log(f"[{gpu_line()}] request (default configuration, LATENTSYNC_RESTORE="
            f"{value or 'unset'}) restore_route={job.get('restore_route')} frames={n} (want 32) "
            f"restore_s={tm.get('restore', nan):.4f} decode_restore_total_s="
            f"{tm.get('decode_restore_total', nan):.4f} overlap_s={overlap:.4f} "
            f"{'ok' if good else 'FAIL ' + str(job.get('error', ''))}")
    if ok:
        a, b = outputs[None], outputs["native"]
        log(f"device vs native route, the same request: {100 * float((a != b).mean()):.3f}% of "
            f"output bytes differ (the two composites differ; not gated)")
    return ok


class StubTokenizer:
    """Whisper's multilingual id layout (end of text 50257, start of
    transcript 50258, 99 languages, timestamps from 50364) without a
    vocabulary: text ids decode to ``w<id>``."""

    eot, sot, no_timestamps, sot_prev, timestamp_begin = 50257, 50258, 50363, 50361, 50364
    sot_sequence = (50258, 50259, 50359)  # <|startoftranscript|><|en|><|transcribe|>

    def encode(self, text):
        return [220] if text == " " else [(ord(c) % 200) + 30 for c in text]

    def decode(self, toks):
        return " " + " ".join(f"w{int(t)}" for t in toks)

    def suppress_set(self):
        return tuple(range(50258, 50363))  # start of transcript ... no speech


def check_transcription(device, root: str):
    """Phase 10.4: whisper-tiny at full width (4 + 4 layers, width 384, vocab
    51865, text context 448, random seeded weights, the stub tokenizer) on
    one 30 s window of synthetic speech: teacher-forced logits on the card
    against the CPU in f32; greedy tokens equal to the CPU's up to the first
    position where the CPU's top-two gap (after the logit filters) is below
    LOGIT_TOL of the largest |logit|; the encoder, the greedy decode and a
    beam of 5 timed. Returns (ok, the card's transcriber)."""
    import numpy as np
    import torch

    from latentsync_tpu_torch.audio.transcribe import WhisperTranscriber
    from latentsync_tpu_torch.config import WhisperConfig
    from latentsync_tpu_torch.models import whisper_decoder as wd
    from latentsync_tpu_torch.models.whisper import WhisperEncoder
    from latentsync_tpu_torch.ops.mel import WHISPER_N_FRAMES, pad_or_trim, whisper_log_mel
    from latentsync_tpu_torch.utils.convert import init_random_
    from latentsync_tpu_torch.utils.media import read_audio

    cfg = WhisperConfig.tiny()
    enc = init_random_(WhisperEncoder(cfg), seed=SEED + 7)
    dec = init_random_(wd.WhisperTextDecoder(cfg), seed=SEED + 8)
    tok = StubTokenizer()
    cpu = WhisperTranscriber(enc, dec, tok)
    card = WhisperTranscriber(WhisperEncoder(cfg).to(device), wd.WhisperTextDecoder(cfg).to(device),
                              tok)
    card.encoder.load_state_dict(enc.state_dict())
    card.decoder.load_state_dict(dec.state_dict())
    wav = write_speech(os.path.join(root, "speech_30.wav"), 30.0, seed=SEED + 9)
    audio = read_audio(wav)
    sot = tok.sot_sequence
    feats, tokens = {}, {}
    for name, tr in (("cpu", cpu), ("card", card)):
        mel = whisper_log_mel(torch.as_tensor(audio, device=tr.device))
        feats[name] = tr.encode(pad_or_trim(mel, WHISPER_N_FRAMES))
        tokens[name], _ = wd.greedy_decode(tr.decoder, feats[name], sot, tr.rules)
    # teacher-forced logits over the CPU's decoded sequence
    seq = torch.from_numpy(tokens["cpu"].astype(np.int64))
    with torch.inference_mode():
        want = cpu.decoder(seq, feats["cpu"])
        got = card.decoder(seq.to(device), feats["card"]).cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    ok = bool(torch.isfinite(got).all()) and err <= LOGIT_TOL * scale
    log(f"[{gpu_line()}] whisper-tiny teacher-forced logits ({seq.shape[1]} tokens x 51865) card "
        f"vs CPU: max err {err:.3e} (limit {LOGIT_TOL:g} x max|logit| {scale:.3f}) "
        f"{'ok' if ok else 'FAIL'}")
    # the CPU's decisions and their margins, after the logit filters
    sb = len(sot)
    suppress = wd._suppress_mask(card.rules, cfg.n_vocab, "cpu")
    needed = 0
    for pos in range(sb - 1, seq.shape[1] - 1):
        row = wd._apply_logit_filters(want[:, pos].clone(), seq, pos, cpu.rules, sb, suppress)
        top2 = row[0].topk(2).values
        if float(top2[0] - top2[1]) < LOGIT_TOL * scale or int(seq[0, pos + 1]) == tok.eot:
            needed += int(float(top2[0] - top2[1]) >= LOGIT_TOL * scale)
            break
        needed += 1
    a, b = tokens["cpu"][0, sb:], tokens["card"][0, sb:]
    agree = int(np.argmin(a == b)) if (a != b).any() else len(a)
    good = agree >= needed
    ok &= good
    log(f"[{gpu_line()}] greedy t=0, card vs CPU: {agree} leading sampled tokens agree "
        f"(required: {needed}, up to the first CPU top-two gap below the limit or the end "
        f"of text) {'ok' if good else 'FAIL'}")

    def timed(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[len(times) // 2], out

    steps = collections.Counter()
    step = card.decoder.step

    def counted(*a, **k):
        steps["n"] += 1
        return step(*a, **k)

    card.decoder.step = counted
    try:
        enc_ms, _ = timed(lambda: card.encode(pad_or_trim(whisper_log_mel(
            torch.as_tensor(audio, device=device)), WHISPER_N_FRAMES)))
        for label, fn in (("greedy", lambda: wd.greedy_decode(card.decoder, feats["card"], sot,
                                                               card.rules)),
                          ("beam 5", lambda: wd.beam_decode(card.decoder, feats["card"], sot,
                                                             card.rules, beam_size=5))):
            steps.clear()
            fn()
            n_steps = steps["n"]
            ms, (toks, lp) = timed(fn)
            n_sampled = int((toks[0, sb:] != tok.eot).sum())
            good = np.isfinite(lp).all() and n_steps >= sb
            ok &= good
            log(f"[{gpu_line()}] whisper-tiny {label} decode on the card: {ms:.1f} ms, "
                f"{n_steps} steps ({n_steps / ms * 1e3:.1f} steps/s), {n_sampled} tokens kept "
                f"({n_sampled / ms * 1e3:.1f} tokens/s), encoder {enc_ms:.1f} ms for the 30 s "
                f"window {'ok' if good else 'FAIL'}")
    finally:
        del card.decoder.step
    return ok, card


def run_worker(pipeline, root: str, audios, transcriber) -> bool:
    """Phase 10.5: ``LocalDirQueue`` with three jobs drained by ``QueueWorker``
    against the running server: a plain one, one ``waiting-dependency`` on it
    that is concatenated after its output (``concat_with``), and one with
    subtitles from the card's transcriber. All complete; the concatenation
    has the frames of both parts; the subtitles come back as a VTT data URI."""
    from latentsync_tpu_torch.serving.worker import LocalDirQueue, QueueWorker
    from latentsync_tpu_torch.utils.media import read_video

    q = LocalDirQueue(os.path.join(root, "queue"))
    q.submit({"id": "job-a", "avatar_id": "avatar", "audio_path": audios["1.2s"]})
    q.submit({"id": "job-b", "avatar_id": "avatar", "audio_path": audios["2.4s"],
              "status": "waiting-dependency", "dependencies": ["job-a"],
              "concat_with": ["job-a"]})
    q.submit({"id": "job-c", "avatar_id": "avatar", "audio_path": audios["1.2s"],
              "subtitles": True})
    t0 = time.time()
    with http_server(pipeline, root) as base, configured("default"):
        handled = QueueWorker(q, api_url=base, transcriber=transcriber).run_once()
    wall = time.time() - t0
    jobs = {j: q.get(j) for j in ("job-a", "job-b", "job-c")}
    status = {j: job["status"] for j, job in jobs.items()}
    ok = handled == 3 and set(status.values()) == {"completed"}
    n = {}
    if ok:
        n = {j: read_video(job["output"], change_fps=False).shape[0] for j, job in jobs.items()}
        ok = n == {"job-a": 32, "job-b": 32 + 64, "job-c": 32} \
            and jobs["job-b"].get("concatenated") is True \
            and str(jobs["job-c"].get("subtitles_uri", "")).startswith("data:text/vtt;base64,")
    log(f"[{gpu_line()}] job-queue worker: {handled} jobs in {wall:.1f} s, status {status}, "
        f"frames {n} (want job-b = 32 + 64), subtitles_uri "
        f"{str(jobs['job-c'].get('subtitles_uri', ''))[:40]}... "
        f"{'ok' if ok else 'FAIL ' + str({j: job.get('error') for j, job in jobs.items()})}")
    return ok


# ---------------------------------------------------------------------------
# phase 11: stage-2 training on the card
# ---------------------------------------------------------------------------

# the flash backward's shapes in a UNet train step: the VAE mid-block's
# attention in the decode of x̂₀ (16 frames of 32² latents), then the UNet's
# spatial attention at 32² (C = 320) and 16² (C = 640) through K4's and K2's
# composed gradients; and CodeFormer's transformer in its stage-II
# training (phase 13) at batch 4 and 1: 8 heads of 64 over 256 tokens
FLASH_BWD_SHAPES = [(16, 1024, 1, 512), (16, 1024, 8, 40), (16, 256, 8, 80), (4, 256, 8, 64),
                    (1, 256, 8, 64)]
# the residual forward's lse against the plain f32 logsumexp, natural units
LSE_TOL = 1e-3
# the flash backward's relative L2 error a gradient, beside TOL_REL: where
# max|plain| < 1 the latter is absolute (2^-6), and this one also holds terms
# that are small beside dp, such as delta
BWD_REL_L2_TOL = 1e-2
# the share of the two runs' gradients (kernels vs every wrapper's plain
# version, both bf16) above which a group's gradient is a fault, not rounding
GRAD_TOL = 0.25
# the trainer's shapes at batch 1, 16 frames, 32² latents: (label, wrapper,
# plain version, tensors (shape, scale, shift), keyword arguments)
TRAIN_FN_CASES = [
    ("geglu_ffn", "M=16384 C=320", 16384, 320), ("geglu_ffn", "M=4096 C=640", 4096, 640),
    ("geglu_ffn", "M=1024 C=1280", 1024, 1280),
    # SyncNet's feed-forward widths and rows: the reference's routing (and
    # so the port's, geglu_route) gives them the composed form, never K1;
    # the kernel is held at them all the same
    ("geglu_ffn", "M=130 C=256 (SyncNet)", 130, 256),
    ("geglu_ffn", "M=16 C=1024 (SyncNet)", 16, 1024),
    ("self_attention_block", "temporal B=1024 S=16 C=320", 1024, 16, 320, True),
    ("self_attention_block", "temporal B=256 S=16 C=640", 256, 16, 640, True),
    ("self_attention_block", "spatial B=16 S=256 C=640", 16, 256, 640, False),
    ("temporal_attention", "B=64 F=16 heads*D=1280", 64, 16, 1280),
    ("spatial_attention", "B=16 S=1024 heads*D=320", 16, 1024, 320),
    ("spatial_attention", "B=16 S=64 heads*D=1280", 16, 64, 1280),
    ("spatial_attention", "B=16 S=16 heads*D=1280", 16, 16, 1280),
    ("dot_product_attention", "B=16 S=1024 H=1 D=512", 16, 1024, 1, 512),
]


def _per_output(got, ref):
    """(largest error, its tolerance, all within): each output against
    TOL_REL · max(1, max|plain|) of its own."""
    import torch

    errs, ok = [], True
    for g, r in zip(got, ref):
        err = float((g.float() - r.float()).abs().max())
        tol = TOL_REL * max(1.0, float(r.float().abs().max()))
        ok &= err <= tol and bool(torch.isfinite(g).all())
        errs.append((err / tol, err, tol))
    worst = max(errs)
    return worst[1], worst[2], ok


def check_flash_backward(device):
    """Phase 2, last: the flash route's backward kernels against their plain
    version at the shapes a UNet train step and CodeFormer's training give
    them (FLASH_BWD_SHAPES),
    each gradient within TOL_REL of its own and BWD_REL_L2_TOL in relative
    L2, and each shape timed beside the plain version and SDPA's backward
    (from one forward graph kept for repeated backwards) with the bound of
    the function itself: the five products it needs, and q, k, v, do read
    and dq, dk, dv written once. The backward takes the forward's output
    and row log-sum-exp from the residual forward (``flash_attention_fwd``),
    as the train step's Function does: two device kernels a call, three when
    the call has to run the residual forward itself, and none of torch's. A
    second call must equal the first bit for bit, the residual forward's
    output must equal the forward's without grad bit for bit and its lse be
    within LSE_TOL of the plain f32 logsumexp of the scaled logits; its time
    is logged beside the forward without grad. Returns (the kernels line's
    entry, its top-level numbers those of the first shape and each shape
    marked with its path: ``train`` for the UNet's shapes,
    ``restoration_train`` for D = 64; ok)."""
    import torch
    import torch.nn.functional as F

    from latentsync_tpu_torch.ops import attention

    entry, ok = None, True
    for i, (b, s, h, d) in enumerate(FLASH_BWD_SHAPES):
        gen = torch.Generator().manual_seed(SEED + 11 + i)
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen).to(device, torch.bfloat16)
                       for _ in range(4))
        scale = d**-0.5
        o, lse = attention.flash_attention_fwd(q, k, v, scale)
        lse_ref = attention.flash_attention_fwd_reference(q, k, v, scale)[1]
        lse_err = float((lse - lse_ref).abs().max()) * math.log(2.0)  # natural units
        del lse_ref
        before = attention.flash_attention_bwd.launches
        got = attention.flash_attention_bwd(q, k, v, do, scale, o=o, lse=lse)
        again = attention.flash_attention_bwd(q, k, v, do, scale, o=o, lse=lse)
        direct = attention.flash_attention_bwd(q, k, v, do, scale)  # its own residual forward
        ref = attention.flash_attention_bwd_reference(q, k, v, do, scale)
        torch.cuda.synchronize()
        launched = attention.flash_attention_bwd.launches == before + 3
        err, tol, close = _per_output(got, ref)
        rel = max(_rel_l2(g, r) for g, r in zip(got, ref))
        bitwise = all(torch.equal(x, y) for x, y in zip(got, again))
        same_direct = all(torch.equal(x, y) for x, y in zip(got, direct))
        del again, direct, ref
        port_k, torch_k = kernels_a_call(
            lambda: attention.flash_attention_bwd(q, k, v, do, scale, o=o, lse=lse))
        port_d, torch_d = kernels_a_call(lambda: attention.flash_attention_bwd(q, k, v, do, scale))
        dev_n, dev_ms = device_busy(
            lambda: attention.flash_attention_bwd(q, k, v, do, scale, o=o, lse=lse))
        ms = cuda_ms(lambda: attention.flash_attention_bwd(q, k, v, do, scale, o=o, lse=lse))
        plain_ms = cuda_ms(lambda: attention.flash_attention_bwd_reference(q, k, v, do, scale))
        fwd_ms = cuda_ms(lambda: attention.flash_attention_fwd(q, k, v, scale))
        with torch.no_grad():
            nograd_ms = cuda_ms(lambda: attention.dot_product_attention(q, k, v, scale))
            same_o = torch.equal(o, attention.dot_product_attention(q, k, v, scale))
        qs, ks, vs = (t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs)
        dot = do.transpose(1, 2)
        library_ms = cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dot,
                                                         retain_graph=True))
        # the function's own tensors: q, k, v, do in, dq, dk, dv out
        bound_ms, bound_by = bound((q, k, v, do), {}, got, 10 * b * h * s * s * d, "bf16")
        good = launched and close and rel <= BWD_REL_L2_TOL and bitwise and same_direct \
            and lse_err <= LSE_TOL and port_k == 2 and torch_k == 0 and port_d == 3 \
            and torch_d == 0 and same_o
        ok &= good
        label = f"B={b} S={s} H={h} D={d}"
        log(f"kernel flash_attention_bwd    {label:28s} max_abs_err={err:.6g} tol={tol:.6g} (each "
            f"of dq, dk, dv against its own) rel_l2={rel:.4g} (tol {BWD_REL_L2_TOL}, each) "
            f"bitwise_repeat={bitwise} "
            f"same_without_residuals={same_direct} ms={ms:.4f} device_ms={dev_ms:.4f} "
            f"({dev_n} kernels) plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (SDPA "
            f"backward) bound_ms={bound_ms:.4f} ({bound_by}) share={bound_ms / ms:.3f} "
            f"kernels_a_call={port_k} (+{torch_k} torch), without residuals {port_d} "
            f"(+{torch_d} torch) {'ok' if good else 'FAIL'}")
        log(f"kernel flash_attention_fwd    {label:28s} residual forward ms={fwd_ms:.4f} beside "
            f"the forward without grad ms={nograd_ms:.4f}; same output bits={same_o}; lse "
            f"max_abs_err={lse_err:.3g} (natural units, tol {LSE_TOL}) "
            f"{'ok' if lse_err <= LSE_TOL and same_o else 'FAIL'}")
        shape = {"shape": label, "path": "restoration_train" if d == 64 else "train",
                 "max_abs_err": err, "rel_l2": rel, "ms": ms,
                 "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by, "kernels_a_call": port_k,
                 "residual_forward_ms": fwd_ms, "forward_without_grad_ms": nograd_ms}
        if entry is None:
            entry = {"name": "flash_attention_bwd", "route": "cuda",
                     "source": "latentsync_tpu_torch/csrc/flash_attention_bwd.cu",
                     "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
                     "launches": 0, "torch_kernels_a_call": torch_k, "shapes": [],
                     **{k_: shape[k_] for k_ in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms", "kernels_a_call")},
                     "shape": label}
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["shapes"].append(shape)
        del q, k, v, do, o, lse, got, out, qs, ks, vs
        torch.cuda.empty_cache()
    return entry, ok


def check_function_grads(device) -> bool:
    """Phase 11 (a): the gradients of K1-K4 and the flash route through their
    ``autograd.Function``s (the kernel forward, the composed backward on the
    card's kernels) against the autograd of the same call's plain version,
    at the trainer's shapes, each input and weight within TOL_REL."""
    import torch

    from latentsync_tpu_torch.ops import attention, attn_block, ffn
    from latentsync_tpu_torch.ops import temporal_attention as ta

    gen = torch.Generator().manual_seed(SEED + 12)

    def r(*shape, s=1.0, add=0.0):
        return (torch.randn(shape, generator=gen) * s + add).to(device, torch.bfloat16) \
            .requires_grad_(True)

    def case(name, *dims):
        if name == "geglu_ffn":
            m, c = dims
            args = [r(m, c), r(8 * c, c, s=c**-0.5), r(8 * c, s=0.1),
                    r(c, 4 * c, s=(4 * c) ** -0.5), r(c, s=0.1), r(c, s=0.1, add=1.0),
                    r(c, s=0.1)]
            return (args, lambda *a: ffn.geglu_ffn(*a, residual=True),
                    lambda *a: ffn.geglu_ffn_reference(*a, residual=True))
        if name == "self_attention_block":
            b, s, c, temporal = dims
            args = [r(b, s, c), r(c, s=0.1, add=1.0), r(c, s=0.1),
                    *[r(c, c, s=c**-0.5) for _ in range(4)], r(c, s=0.1)]
            pe = [r(s, c)] if temporal else []

            def call(fn):
                return lambda *a: fn(*a[:8], 8, temporal=temporal,
                                     pe=a[8] if temporal else None)
            return (args + pe, call(attn_block.self_attention_block),
                    call(attn_block.self_attention_block_reference))
        if name == "dot_product_attention":
            return ([r(*dims) for _ in range(3)], attention.dot_product_attention,
                    attention.dot_product_attention_reference)
        fn, plain = {"temporal_attention": (ta.temporal_attention,
                                            ta.temporal_attention_reference),
                     "spatial_attention": (ta.spatial_attention,
                                           ta.spatial_attention_reference)}[name]
        return ([r(*dims) for _ in range(3)], lambda q, k, v: fn(q, k, v, 8),
                lambda q, k, v: plain(q, k, v, 8))

    ok = True
    for name, label, *dims in TRAIN_FN_CASES:
        args, fn, plain = case(name, *dims)
        out = fn(*args)
        has_fn = out.grad_fn is not None
        cot = torch.randn(out.shape, generator=gen).to(out)
        got = torch.autograd.grad(out, args, cot)
        ref = torch.autograd.grad(plain(*args), args, cot)
        torch.cuda.synchronize()
        err, tol, close = _per_output(got, ref)
        good = has_fn and close
        ok &= good
        log(f"grad {name:22s} {label:28s} grad_fn={has_fn} {len(args)} gradients, worst "
            f"max_abs_err={err:.6g} tol={tol:.6g} {'ok' if good else 'FAIL'}")
        del args, out, got, ref
    torch.cuda.empty_cache()
    return ok


def _train_batch(cfg):
    """One synthetic stage-2 batch in the data source's layout (batch 1)."""
    import numpy as np

    from latentsync_tpu_torch.utils.image_processor import load_fixed_mask

    rng = np.random.default_rng(SEED + 13)
    f, res = cfg.data.num_frames, cfg.data.resolution
    gt = rng.uniform(-1, 1, (1, f, res, res, 3)).astype(np.float32)
    keep = load_fixed_mask(res)[None, None, ..., :1].astype(np.float32)
    return {"gt_pixels": gt, "masked_pixels": gt * keep,
            "ref_pixels": rng.uniform(-1, 1, (1, f, res, res, 3)).astype(np.float32),
            "masks": np.broadcast_to(keep, (1, f, res, res, 1)).copy(),
            "audio_embeds": rng.standard_normal((1, f, 50, cfg.unet.cross_attention_dim))
            .astype(np.float32),
            "mel": rng.uniform(-4, 4, (1, 80, math.ceil(f / 5 * 16), 1)).astype(np.float32)}


def _group(name: str) -> str:
    if "motion_modules." in name:
        return "motion modules"
    return "cross attentions (attn2)" if ".attn2." in name else "spatial attentions"


def stage2_trainer(unet, vae, device):
    """The stage-2 trainer of phases 11 and 14: an f32 master copy of `unet`
    (phase 3's weights, nothing zeroed), the served VAE, and seeded SyncNet,
    LPIPS and the small TREPA ViT in bf16."""
    import copy

    import torch

    from latentsync_tpu_torch.config import LatentSyncConfig
    from latentsync_tpu_torch.models.perceptual import LPIPS
    from latentsync_tpu_torch.models.syncnet import StableSyncNet
    from latentsync_tpu_torch.models.videomae import TREPALoss, VideoViT, VideoViTConfig
    from latentsync_tpu_torch.training.unet_trainer import UNetTrainer
    from latentsync_tpu_torch.utils.convert import init_random_

    bf = torch.bfloat16
    cfg = LatentSyncConfig()
    master = copy.deepcopy(unet).float().train()
    syncnet = init_random_(StableSyncNet(cfg.syncnet), seed=SEED + 4).to(device, bf)
    lpips = init_random_(LPIPS(), seed=SEED + 5).to(device, bf)
    vit = init_random_(VideoViT(VideoViTConfig(img_size=64, patch_size=16, embed_dim=64,
                                               depth=2, num_heads=4, mlp_ratio=4.0)),
                       seed=SEED + 6).to(device, bf)
    return UNetTrainer(cfg, master, vae, syncnet, lpips, TREPALoss(vit), dtype=bf)


def check_train_step(unet, vae, device, counters):
    """Phase 11 (b): one full-width stage-2 loss and backward (weights of
    phase 3, nothing zeroed; the loss nets seeded; one batch, t and noise)
    with the kernels, against the same step with every wrapper forced to
    its plain version on the card: loss, per-group gradient rel L2, the
    share of trainable tensors with a finite non-zero gradient (must be
    100 %), the kernels' launches in the kernel run (counts set to 0 just
    before it), peak memory, the step's time and its split, and one step
    under ``torch.profiler``. Returns (launches, ok)."""
    import dataclasses

    import torch

    from latentsync_tpu_torch.config import LatentSyncConfig
    from latentsync_tpu_torch.ops import _build
    from latentsync_tpu_torch.ops.plain import plain_kernels
    from latentsync_tpu_torch.training.unet_trainer import UNetTrainer

    bf = torch.bfloat16
    cfg = LatentSyncConfig()
    trainer = stage2_trainer(unet, vae, device)
    master, syncnet, lpips, vit = trainer.unet, trainer.syncnet, trainer.lpips, trainer.trepa.model
    batch = _train_batch(cfg)
    t, noise = trainer.draw(batch, 0)
    trainable = [n for n, m in trainer.mask.items() if m]

    def step():
        losses, grads = trainer.gradients(batch, t, noise)
        torch.cuda.synchronize()
        return {k: float(v.detach()) for k, v in losses.items()}, grads

    shapes = collections.Counter()

    def observe(entry, args):
        """The shape each launch of the step is given, from its arguments."""
        dims = {"ls_geglu_ffn": args[1:3], "ls_temporal_block": args[1:4],
                "ls_attn_block": args[1:4], "ls_temporal_attention": args[8:12],
                "ls_spatial_attention": args[8:12], "ls_flash_attention": args[7:11],
                "ls_flash_attention_lse": args[7:11],
                "ls_flash_attention_bwd": args[13:17]}.get(entry)
        shapes[f"{entry}{tuple(dims)}"] += 1

    with configured("default"):
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.observer = observe
        t0 = time.time()
        try:
            losses_k, grads = step()
        finally:
            _build.observer = None
        first_s = time.time() - t0
        launches = {c.__name__: c.launches for c in counters}
        peak = torch.cuda.max_memory_allocated() / 2**30
        good_grads = [bool(torch.isfinite(grads[n]).all()) and bool(grads[n].abs().max() > 0)
                      for n in trainable]
        kept = {n: grads[n].clone() for n in trainable}
        del grads
        t0 = time.time()
        step()
        step_s = time.time() - t0
        with plain_kernels():
            losses_p, grads_p = step()
    share = sum(good_grads) / len(good_grads)
    on_path = ("geglu_ffn", "self_attention_block", "temporal_attention", "spatial_attention",
               "dot_product_attention", "flash_attention_bwd")
    ran = all(launches[n] > 0 for n in on_path)
    others = {n: v for n, v in launches.items() if n not in on_path and v}
    loss_rel = abs(losses_k["total"] - losses_p["total"]) / abs(losses_p["total"])
    groups = collections.defaultdict(lambda: [0.0, 0.0])
    for n in trainable:
        g = groups[_group(n)]
        g[0] += float((kept[n].float() - grads_p[n].float()).pow(2).sum())
        g[1] += float(grads_p[n].float().pow(2).sum())
    rels = {k: math.sqrt(d / max(r, 1e-30)) for k, (d, r) in groups.items()}
    del kept, grads_p
    ok = share == 1.0 and ran and not others and loss_rel <= UNET_TOL \
        and all(v <= GRAD_TOL for v in rels.values())
    log(f"[{gpu_line()}] train step (full width, batch 1, 16 frames, 256²): losses (kernels) "
        + ", ".join(f"{k}={v:.6g}" for k, v in losses_k.items())
        + f"; plain total={losses_p['total']:.6g}, loss rel. error {loss_rel:.3g} "
        f"(tol {UNET_TOL}); gradient rel L2 vs plain "
        + ", ".join(f"{k} {v:.4g}" for k, v in sorted(rels.items()))
        + f" (tol {GRAD_TOL}); trainable tensors with a finite non-zero gradient "
        f"{sum(good_grads)}/{len(good_grads)} = {100 * share:.1f} %; launches in the kernel "
        f"run {json.dumps({n: launches[n] for n in on_path})}, other kernels {others}; peak "
        f"device memory {peak:.2f} GiB; step {step_s:.3f} s (first {first_s:.3f} s) "
        f"{'ok' if ok else 'FAIL'}")

    log("launch shapes of the step (entry point (dims) x launches): "
        + ", ".join(f"{k} x{v}" for k, v in sorted(shapes.items())))

    # where the step's time goes: each part alone, host clock around synchronised work
    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        return time.time() - t0

    recon_only = UNetTrainer(dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, pixel_space_supervise=False)), master, vae, dtype=bf)
    f = cfg.data.num_frames
    encode_s = timed(lambda: [trainer._encode(batch[k], 1, f)
                              for k in ("gt_pixels", "masked_pixels", "ref_pixels")])
    unet_s = timed(lambda: recon_only.gradients(batch, t, noise)) - encode_s
    z = torch.randn((f, 4, 32, 32), device=device, dtype=bf, requires_grad=True)
    decode_s = timed(lambda: torch.autograd.grad(vae.decode(z).float().mean(), z))
    pix = torch.rand((1, f, 3, 256, 256), device=device, requires_grad=True)
    mel = torch.as_tensor(batch["mel"], device=device).permute(0, 3, 1, 2).to(bf)

    def loss_nets():
        lower = pix[:, :, :, 128:]
        loss = lpips(lower.flatten(0, 1).to(bf), lower.flatten(0, 1).detach().to(bf)).mean() \
            + trainer.trepa(pix, pix.detach())
        v, a = syncnet(lower.flatten(1, 2).to(bf), mel)
        return torch.autograd.grad(loss + (v * a).sum(), pix)

    nets_s = timed(loss_nets)
    for p in master.parameters():
        p.grad = None
    log(f"[{gpu_line()}] train step split (s): VAE encode x3 (no grad) {encode_s:.4f}, UNet "
        f"forward+backward {unet_s:.4f}, VAE decode forward+backward {decode_s:.4f}, loss nets "
        f"(LPIPS, TREPA, SyncNet) forward+backward {nets_s:.4f}; parts "
        f"{encode_s + unet_s + decode_s + nets_s:.4f} of the step's {step_s:.4f}")
    n_k, dev_ms = device_busy(lambda: trainer.gradients(batch, t, noise))
    fams = collections.Counter()
    for name, us in device_kernels(lambda: trainer.gradients(batch, t, noise)):
        fams[name[:70]] += us / 1e3
    log(f"train step under torch.profiler: {n_k} device kernels, {dev_ms:.3f} device ms; "
        "largest families (ms): " + "; ".join(f"{n} {ms:.3f}" for n, ms in fams.most_common(8)))
    for p in master.parameters():
        p.grad = None
    del trainer, recon_only, master, syncnet, lpips, vit, z, pix
    torch.cuda.empty_cache()
    return launches, ok


def _write_training_clips(root: str, n: int = 2, frames: int = 60, size: int = 256):
    """Clips the data source can draw 16-frame windows from (≥ 48 frames),
    each with its .wav sidecar, and a fileslist naming them."""
    import cv2
    import numpy as np

    from latentsync_tpu_torch.utils.media import write_audio

    rng = np.random.default_rng(SEED + 14)
    paths = []
    for i in range(n):
        path = os.path.join(root, f"train{i}.mp4")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (size, size))
        base = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
        for j in range(frames):
            writer.write(np.roll(base, 3 * j, axis=1))
        writer.release()
        write_audio(path[:-4] + ".wav",
                    0.3 * rng.standard_normal(16000 * frames // 25 + 1600).astype(np.float32))
        paths.append(path)
    fileslist = os.path.join(root, "files.txt")
    with open(fileslist, "w") as f:
        f.write("\n".join(paths) + "\n")
    return fileslist


def run_train_cli(root: str) -> bool:
    """Phase 11 (c): ``python -m latentsync_tpu_torch.scripts.train_unet`` on
    ``configs/unet_stage2.yaml`` (its ``data.train_fileslist`` pointed at the
    clips written here) for 4 steps in its own process: every step's JSON
    line, steps/s, peak device memory. Phase 14 (c) resumes its checkpoint."""
    import yaml

    with open("configs/unet_stage2.yaml") as f:
        stage2 = yaml.safe_load(f)
    stage2["data"]["train_fileslist"] = _write_training_clips(root)
    config = os.path.join(root, "unet_stage2.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(stage2, f)
    out = os.path.join(root, "train_out")
    cmd = [sys.executable, "-m", "latentsync_tpu_torch.scripts.train_unet", "--config", config,
           "--output-dir", out, "--log-every", "1"]
    t0 = time.time()
    proc = subprocess.run(cmd + ["--max-steps", "4"], capture_output=True, text=True,
                          timeout=900)
    wall = time.time() - t0
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    steps = [x for x in lines if "loss" in x]
    good = proc.returncode == 0 and [x["step"] for x in steps] == [1, 2, 3, 4] \
        and all(math.isfinite(x["loss"]) for x in steps)
    for x in lines:
        log(f"  train_unet: {json.dumps(x)}")
    log(f"[{gpu_line()}] train_unet --max-steps 4: exit {proc.returncode}, {wall:.1f} s "
        f"in its own process, steps/s "
        f"{[round(x['steps_per_sec'], 4) for x in steps]}, peak device memory "
        f"{max([x.get('peak_memory_gib', 0) for x in steps] or [0]):.2f} GiB "
        f"{'ok' if good else 'FAIL: ' + proc.stderr[-3000:]}")
    return good


# ---------------------------------------------------------------------------
# phase 12: face restoration
# ---------------------------------------------------------------------------

# f32 nets on the card (TF32 off) against the port on the CPU: relative L2
NET_F32_TOL = 1e-3
# CodeFormer's transformer layers at the default width: one flash launch each
CODEFORMER_LAYERS = 9


@contextlib.contextmanager
def no_tf32():
    """f32 convolutions and products without TF32 for the duration."""
    import torch

    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def timed_forwards(fn, n: int = 5):
    """(median wall ms of `n` warm calls, device ms of one call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    _, device_ms = device_busy(fn)
    return sorted(walls)[n // 2], device_ms


def check_codeformer(device, counters):
    """Phase 12 (a) and (b): the full-width CodeFormer (``CodeFormer()``
    defaults, seeded random non-zero weights, positions included) in bf16 at
    1 and 4 faces of 512², w = 0.5: finite, w = 0 and 1 apart, the flash
    kernel launched once a transformer layer a forward (counts set to 0
    just before); against the same weights in f32 with every wrapper forced
    to its plain version (TF32 off): the code logits within UNET_TOL in
    relative L2, the share of equal code indices printed, and the output
    given the f32 run's indices within UNET_TOL; median of 5 warm forwards
    and device ms at each batch. Then the full-width VQAutoEncoder: finite,
    timed. Returns (flash launches of one forward at B = 4, ok)."""
    import copy

    import torch

    from latentsync_tpu_torch.models import codeformer as cf
    from latentsync_tpu_torch.ops import attention
    from latentsync_tpu_torch.ops.plain import plain_kernels
    from latentsync_tpu_torch.utils.convert import init_random_

    ok = True
    gen = torch.Generator().manual_seed(SEED + 12)
    model = init_random_(cf.CodeFormer(), seed=SEED + 12).eval()
    ok &= bool(model.position_emb.abs().min() > 0)
    ref_model = copy.deepcopy(model).to(device)
    model = cf.cast_floating_(model, torch.bfloat16).to(device)
    faces = (torch.rand((4, 3, 512, 512), generator=gen) * 2 - 1).to(device)
    launches = 0
    with torch.no_grad():
        for b in (1, 4):
            x = faces[:b]
            for fn in counters:
                fn.launches = 0
            out, logits, lq = model(x, w=0.5)
            torch.cuda.synchronize()
            n_flash = attention.dot_product_attention.launches
            others = {fn.__name__: fn.launches for fn in counters
                      if fn is not attention.dot_product_attention and fn.launches}
            if b == 4:
                launches = n_flash
            zero, _, _ = model(x, w=0.0)
            one, _, _ = model(x, w=1.0)
            finite = bool(torch.isfinite(out).all() and torch.isfinite(logits).all())
            apart = not torch.equal(zero, one)
            with plain_kernels(), no_tf32():
                ref_out, ref_logits, _ = ref_model(x, w=0.5)
            ref_idx = ref_logits.argmax(-1)
            logits_err = _rel_l2(logits.float(), ref_logits)
            agree = float((logits.argmax(-1) == ref_idx).float().mean())
            lookup = model.quantize.codebook_lookup
            model.quantize.codebook_lookup = lambda idx, shape: lookup(ref_idx, shape)
            try:  # the generator on the f32 run's codes
                held, _, _ = model(x, w=0.5)
            finally:
                model.quantize.codebook_lookup = lookup
            out_err = _rel_l2(held.float(), ref_out)
            wall_ms, device_ms = timed_forwards(lambda: model(x, w=0.5))
            good = (finite and apart and n_flash == CODEFORMER_LAYERS and not others
                    and logits_err <= UNET_TOL and out_err <= UNET_TOL
                    and tuple(out.shape) == (b, 3, 512, 512))
            ok &= good
            log(f"codeformer B={b}: out {tuple(out.shape)} finite={finite} w0_vs_w1_apart={apart} "
                f"flash_launches={n_flash} (want {CODEFORMER_LAYERS}) other_kernels={others} "
                f"logits_rel_l2={logits_err:.5f} equal_codes={agree:.4f} "
                f"out_rel_l2_on_f32_codes={out_err:.5f} tol={UNET_TOL} "
                f"median_ms={wall_ms:.2f} device_ms={device_ms:.2f} {'ok' if good else 'FAIL'}")
    del model, ref_model
    torch.cuda.empty_cache()

    vq = cf.cast_floating_(init_random_(cf.VQAutoEncoder(), seed=SEED + 13).eval(),
                           torch.bfloat16).to(device)
    with torch.no_grad():
        rec, _, idx = vq(faces)
        finite = bool(torch.isfinite(rec).all())
        wall_ms, device_ms = timed_forwards(lambda: vq(faces))
    good = finite and tuple(rec.shape) == (4, 3, 512, 512) and tuple(idx.shape) == (4, 16, 16)
    ok &= good
    log(f"vqgan autoencoder B=4: rec {tuple(rec.shape)} finite={finite} median_ms={wall_ms:.2f} "
        f"device_ms={device_ms:.2f} {'ok' if good else 'FAIL'}")
    del vq
    torch.cuda.empty_cache()
    return launches, ok


def randomize_bn_(module, seed: int):
    """Batch norms with seeded statistics and affine terms (scale 1 + N(0,
    0.1²), shift N(0, 0.02²), running mean N(0, 0.1²), running variance 1 +
    |N(0, 0.3²)|): ``init_random_`` treats a 1-D tensor as a bias."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                n = m.num_features
                m.weight.copy_(1 + 0.1 * torch.randn(n, generator=gen))
                m.bias.copy_(0.02 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(1 + (0.3 * torch.randn(n, generator=gen)).abs())
    return module


def check_restoration_nets(device) -> bool:
    """Phase 12 (c): the detectors, parsers and the upsampler's net on the
    card against the port on the CPU, one small image each, seeded random
    weights: RetinaFace (mobile0.25, resnet50), YOLOv5-face (n, l), ParseNet
    and BiSeNet in f32 with TF32 off (within NET_F32_TOL in relative L2 of
    all outputs), RRDBNet x2 in bf16, the dtype ``RealESRGANUpsampler``
    runs it in (within UNET_TOL of the f32 CPU run)."""
    import copy

    import torch

    from latentsync_tpu_torch.models.parsing import BiSeNet, ParseNet
    from latentsync_tpu_torch.models.retinaface import RetinaFace
    from latentsync_tpu_torch.models.rrdbnet import RRDBNet
    from latentsync_tpu_torch.models.yolov5face import YOLOv5Face
    from latentsync_tpu_torch.utils.convert import init_random_

    gen = torch.Generator().manual_seed(SEED + 14)
    bgr = torch.randn((1, 3, 160, 160), generator=gen) * 60
    rgb01 = torch.rand((1, 3, 128, 128), generator=gen)
    face = torch.rand((1, 3, 128, 128), generator=gen) * 2 - 1
    nets = [("retinaface mobile0.25", lambda: RetinaFace("mobile0.25"), bgr, torch.float32),
            ("retinaface resnet50", lambda: RetinaFace("resnet50"), bgr, torch.float32),
            ("yolov5n-face", lambda: YOLOv5Face("yolov5n"), rgb01, torch.float32),
            ("yolov5l-face", lambda: YOLOv5Face("yolov5l"), rgb01, torch.float32),
            ("parsenet", ParseNet, face, torch.float32),
            ("bisenet", BiSeNet, face, torch.float32),
            ("rrdbnet x2", lambda: RRDBNet(scale=2), rgb01[..., :64, :64], torch.bfloat16)]
    ok = True
    for i, (name, make, x, dtype) in enumerate(nets):
        cpu = randomize_bn_(init_random_(make(), seed=SEED + 20 + i), SEED + 40 + i).eval()
        card = copy.deepcopy(cpu).to(device, dtype)
        with torch.no_grad(), no_tf32():
            ref = [t.float() for t in _tensors(cpu(x))]
            t0 = time.time()
            got = [t.float().cpu() for t in _tensors(card(x.to(device)))]
            torch.cuda.synchronize()
            card_s = time.time() - t0
        err = _rel_l2(torch.cat([t.flatten() for t in got]), torch.cat([t.flatten() for t in ref]))
        tol = NET_F32_TOL if dtype == torch.float32 else UNET_TOL
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        good = finite and err <= tol and [t.shape for t in got] == [t.shape for t in ref]
        ok &= good
        log(f"restoration net {name:22s} {str(dtype).split('.')[-1]} card vs CPU rel_l2={err:.3g} "
            f"tol={tol} outputs={len(got)} first_call_s={card_s:.2f} {'ok' if good else 'FAIL'}")
    return ok


def _write_faces(root: str, n: int, hw) -> list:
    """n synthetic faces (a skin ellipse, eyes and a mouth on a gradient)."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(SEED)
    h, w = hw
    paths = []
    for i in range(n):
        img = np.zeros((h, w, 3), np.uint8)
        img[:] = np.linspace(40, 200, w, dtype=np.uint8)[None, :, None]
        cx, cy, r = w // 2 + 20 * i, h // 2, min(h, w) // 4
        cv2.ellipse(img, (cx, cy), (int(r * 0.8), r), 0, 0, 360, (140, 160, 200), -1)
        for dx in (-0.35, 0.35):
            cv2.circle(img, (int(cx + dx * r), int(cy - 0.2 * r)), max(r // 10, 2), (40, 30, 30),
                       -1)
        cv2.ellipse(img, (cx, int(cy + 0.45 * r)), (r // 3, r // 10), 0, 0, 360, (60, 60, 150),
                    -1)
        img = cv2.add(img, rng.integers(0, 10, img.shape, dtype=np.uint8))
        path = os.path.join(root, f"face{i}.png")
        cv2.imwrite(path, img)
        paths.append(path)
    return paths


def run_restoration_clis(root: str) -> bool:
    """Phase 12 (d): the restoration CLIs on the card, each ``main`` in process
    (seeded random weights: no checkpoint files): ``inference_codeformer`` on two
    synthetic 720p PNGs and an 8-frame ``.mp4``, ``inference_vqgan`` and
    ``crop_align_face``; each exits 0 and writes outputs of the expected
    shapes."""
    import cv2

    src = os.path.join(root, "faces")
    os.makedirs(src)
    paths = _write_faces(src, 2, (720, 1280))
    video = os.path.join(root, "clip.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 25, (640, 360))
    for i in range(8):
        writer.write(cv2.resize(cv2.imread(paths[i % 2]), (640, 360)))
    writer.release()
    ckpt = os.path.join(root, "none.pth")

    def run(module, *args):
        rc, stdout, err, wall = run_main(module, [*args, "--device", "cuda"])
        if rc:
            log((err or stdout)[-3000:])
        return rc, wall

    def shape(path):
        img = cv2.imread(path)
        return None if img is None else img.shape

    ok = True
    out = os.path.join(root, "restored")
    rc, wall = run("inference_codeformer", "--input", src, "--out", out, "--ckpt", ckpt)
    shapes = [shape(os.path.join(out, os.path.basename(p))) for p in paths]
    good = rc == 0 and shapes == [(720, 1280, 3)] * 2
    rc_v, wall_v = run("inference_codeformer", "--input", video, "--out", out, "-w", "0.7",
                       "--ckpt", ckpt)
    cap = cv2.VideoCapture(os.path.join(out, "clip.mp4"))
    frames = []
    while True:
        read, fr = cap.read()
        if not read:
            break
        frames.append(fr.shape)
    cap.release()
    good_v = rc_v == 0 and frames == [(360, 640, 3)] * 8
    log(f"inference_codeformer CLI: 2 PNGs rc={rc} shapes={shapes} wall_s={wall:.1f}; 8-frame "
        f"mp4 rc={rc_v} frames={len(frames)} wall_s={wall_v:.1f} "
        f"{'ok' if good and good_v else 'FAIL'}")
    ok &= good and good_v
    rec = os.path.join(root, "rec")
    rc, wall = run("inference_vqgan", "-i", src, "-o", rec, "--ckpt_path", ckpt)
    shapes = [shape(os.path.join(rec, f"face{i}_rec.png")) for i in range(2)]
    good = rc == 0 and shapes == [(512, 512, 3)] * 2
    ok &= good
    log(f"inference_vqgan CLI: rc={rc} shapes={shapes} wall_s={wall:.1f} {'ok' if good else 'FAIL'}")
    aligned = os.path.join(root, "aligned")
    rc, wall = run("crop_align_face", "-i", src, "-o", aligned, "--output_size", "256",
                   "--transform_size", "1024")
    shapes = [shape(os.path.join(aligned, f"face{i}.png")) for i in range(2)]
    good = rc == 0 and shapes == [(256, 256, 3)] * 2
    ok &= good
    log(f"crop_align_face CLI: rc={rc} shapes={shapes} wall_s={wall:.1f} {'ok' if good else 'FAIL'}")
    return ok


# ---------------------------------------------------------------------------
# phase 13: restoration training on the card
# ---------------------------------------------------------------------------

# steps of each stage in (a): the first builds and warms, the median of the rest
RESTORE_TRAIN_STEPS = 4
# (c), one stage-II step at batch 1, bf16 on the card against f32 on the CPU,
# each bound set from the readings of this seed on an H100 with room on both
# sides: the share of target codes that must agree (the nearest codebook
# entries of the encoder's output: no kernel of the port on that path, only
# bf16's rounding against f32's; read 0.9648), then, with the CPU's codes as
# the card's targets, the cross-entropy's relative difference (read 2.3e-4)
# and the relative L2 of the transformer's gradients (read 0.0138; each on
# its own codes, printed only, 0.092). A backward without its delta term
# reads 0.05-0.33 in the CPU mirror's check.
RESTORE_LOSS_TOL = 1e-3
RESTORE_GRAD_TOL = 0.04
RESTORE_CODES_MIN = 0.9


@contextlib.contextmanager
def counting(owner, name: str):
    """Replace ``owner.name`` by a wrapper that counts its calls for the
    duration; yields the count (a one-item list)."""
    orig = getattr(owner, name)
    calls = [0]

    def wrapper(*args, **kwargs):
        calls[0] += 1
        return orig(*args, **kwargs)

    # a launcher's body adds to the count of the module global of its own
    # name, which is this wrapper while it is in place: carry the count over
    counted = hasattr(orig, "launches")
    if counted:
        wrapper.launches = orig.launches
    setattr(owner, name, wrapper)
    try:
        yield calls
    finally:
        setattr(owner, name, orig)
        if counted:
            orig.launches = wrapper.launches


def train_stages(root: str, counters):
    """Phase 13 (a) and (b): ``train_codeformer.main`` for RESTORE_TRAIN_STEPS
    steps of each stage at full width, batch 4, on the faces in `root`:
    finite metrics, the median warm step and the peak memory of each. The
    counts are set to 0 just before; during stage II the port's launcher of
    the flash backward (``attention.flash_attention_bwd``, wrapped here)
    must be called once a transformer layer a step, in stages I and III
    never (stage III's losses reach the transformer only through an
    argmax), and its plain version and torch's SDPA never; the flash
    forward launches once a layer a stage-II step and twice a stage-III
    one (the generator's step and the discriminator's); no other kernel of
    the port may launch. Returns (the launches of the flash forward and
    backward, ok)."""
    import torch
    import torch.nn.functional as F

    from latentsync_tpu_torch.ops import attention
    from latentsync_tpu_torch.scripts import train_codeformer

    ok = True
    for fn in counters:
        fn.launches = 0
    calls = {}
    with counting(attention, "flash_attention_bwd") as bwd_calls, \
            counting(attention, "flash_attention_bwd_reference") as plain_calls, \
            counting(F, "scaled_dot_product_attention") as sdpa_calls:
        for stage in ("vqgan", "code", "joint"):
            before = bwd_calls[0]
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            out = train_codeformer.main(["--stage", stage, "--data-dir", root, "--max-steps",
                                         str(RESTORE_TRAIN_STEPS), "--batch-size", "4",
                                         "--output-dir",
                                         os.path.join(root, "ck_" + stage), "--seed",
                                         str(SEED + 13)])
            wall = time.time() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            calls[stage] = bwd_calls[0] - before
            want = CODEFORMER_LAYERS * RESTORE_TRAIN_STEPS if stage == "code" else 0
            finite = all(math.isfinite(v) for m in out["metrics"] for v in m.values())
            warm = sorted(out["step_seconds"][1:])[len(out["step_seconds"][1:]) // 2]
            good = finite and calls[stage] == want
            ok &= good
            log(f"[{gpu_line()}] train_codeformer --stage {stage} B=4 512²: "
                f"{RESTORE_TRAIN_STEPS} steps, metrics of the last {json.dumps(out['metrics'][-1])}"
                f" finite={finite}; median warm step {warm * 1e3:.1f} ms (steps "
                f"{[round(x * 1e3, 1) for x in out['step_seconds']]} ms); peak device memory "
                f"{peak:.2f} GiB; flash backward launcher calls {calls[stage]} (want {want}); "
                f"{wall:.1f} s with model building "
                f"{'ok' if good else 'FAIL'}")
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters if fn.launches}
    others = {k: v for k, v in launches.items()
              if k not in ("dot_product_attention", "flash_attention_bwd")}
    n_bwd = launches.get("flash_attention_bwd", 0)
    n_fwd = launches.get("dot_product_attention", 0)
    good = (plain_calls[0] == 0 and sdpa_calls[0] == 0 and not others
            and n_bwd == bwd_calls[0] == CODEFORMER_LAYERS * RESTORE_TRAIN_STEPS
            and n_fwd == 3 * CODEFORMER_LAYERS * RESTORE_TRAIN_STEPS)
    ok &= good
    log(f"restoration training launches (counts set to 0 before (a)): {launches}; flash "
        f"backward launcher calls {bwd_calls[0]}, its plain version {plain_calls[0]}, SDPA "
        f"{sdpa_calls[0]}; other kernels of the port {others} {'ok' if good else 'FAIL'}")
    return launches, ok


def _rel_diff(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def check_stage2_against_cpu(root: str, device) -> bool:
    """Phase 13 (c): one stage-II loss and backward at batch 1 on the card in
    bf16 and on the CPU in f32 (the plain attention there) from the same
    weights and batch: at least RESTORE_CODES_MIN of the target codes
    equal; with the CPU's codes as the card's targets the loss within
    RESTORE_LOSS_TOL and the transformer's gradients (``ft_layers.*``)
    within RESTORE_GRAD_TOL in relative L2; the free-running loss and gradients
    (each on its own codes) printed."""
    import copy

    import torch

    from latentsync_tpu_torch.models import codeformer as cf
    from latentsync_tpu_torch.training.degradations import FFHQBlindSource
    from latentsync_tpu_torch.training.restoration_trainer import CodeFormerStageII
    from latentsync_tpu_torch.utils.convert import init_random_

    sample = FFHQBlindSource(root, seed=SEED).sample()
    batch = {k: v[None] for k, v in sample.items()}
    with torch.no_grad():
        cpu_model = init_random_(cf.CodeFormer(), seed=SEED + 14)
    card = CodeFormerStageII(copy.deepcopy(cpu_model).to(device), dtype=torch.bfloat16)
    cpu = CodeFormerStageII(cpu_model, dtype=torch.float32)

    def step(trainer, codes=None):
        """(loss, the target codes, the transformer's gradients, seconds)."""
        t0 = time.time()
        for t in trainer.g.leaves.values():
            t.grad = None
        gt = torch.from_numpy(batch["gt"]).to(trainer.device).permute(0, 3, 1, 2)
        own = trainer.target_codes(gt)
        if codes is not None:
            trainer.target_codes = lambda x: codes.to(trainer.device)
        try:
            loss, _ = trainer.loss(batch)
            loss.backward()
        finally:
            trainer.__dict__.pop("target_codes", None)
        grads = torch.cat([t.grad.float().flatten().cpu() for k, t in trainer.g.leaves.items()
                           if k.startswith("ft_layers.")])
        return float(loss.detach()), own.cpu(), grads, time.time() - t0

    cpu_loss, cpu_codes, cpu_grads, cpu_s = step(cpu)
    free_loss, card_codes, free_grads, card_s = step(card)
    held_loss, _, held_grads, _ = step(card, cpu_codes)
    codes_equal = float((card_codes == cpu_codes).float().mean())
    loss_rel = _rel_diff(held_loss, cpu_loss)
    grad_rel = _rel_l2(held_grads, cpu_grads)
    good = (codes_equal >= RESTORE_CODES_MIN and loss_rel <= RESTORE_LOSS_TOL
            and grad_rel <= RESTORE_GRAD_TOL and math.isfinite(free_loss))
    log(f"stage II at B=1, card bf16 vs CPU f32: equal target codes {codes_equal:.4f} (min "
        f"{RESTORE_CODES_MIN}); on the CPU's codes: ce {held_loss:.6f} vs {cpu_loss:.6f} "
        f"rel_diff={loss_rel:.4g} (tol {RESTORE_LOSS_TOL}), transformer gradients "
        f"rel_l2={grad_rel:.4g} (tol {RESTORE_GRAD_TOL}); free-running: ce {free_loss:.6f} rel_diff="
        f"{_rel_diff(free_loss, cpu_loss):.4g}, gradients rel_l2="
        f"{_rel_l2(free_grads, cpu_grads):.4g}; card {card_s:.1f} s, CPU {cpu_s:.1f} s "
        f"{'ok' if good else 'FAIL'}")
    return good


def run_restoration_train_clis(root: str, faces: str) -> bool:
    """Phase 13 (d): ``train_restoration`` on a copy of
    ``options/codeformer_stage2.yaml`` whose ``dataroot_gt`` names the faces,
    2 steps (JSON lines, the EMA checkpoint), and ``generate_latent_gt`` on 4
    faces (seeded random weights: 16 × 16 codes of each face and its flip),
    each ``main`` in process."""
    import numpy as np
    import yaml

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "options", "codeformer_stage2.yaml")) as f:
        opt = yaml.safe_load(f)
    opt["datasets"]["train"]["dataroot_gt"] = faces
    options = os.path.join(root, "codeformer_stage2.yaml")
    with open(options, "w") as f:
        yaml.safe_dump(opt, f)

    def run(module, *args):
        rc, stdout, err, wall = run_main(module, args)
        if rc:
            log((err or stdout)[-3000:])
        return types.SimpleNamespace(returncode=rc, stdout=stdout), wall

    ok = True
    ck = os.path.join(root, "option_ck")
    proc, wall = run("train_restoration", "-opt", options, "--max-steps", "2", "--log-every", "1",
                     "--output-dir", ck)
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    good = (proc.returncode == 0 and [x["step"] for x in lines] == [1, 2]
            and all(math.isfinite(x["ce"]) for x in lines)
            and os.path.isfile(os.path.join(ck, "step_00000002.pt")))
    ok &= good
    for x in lines:
        log(f"  train_restoration: {json.dumps(x)}")
    log(f"[{gpu_line()}] train_restoration -opt codeformer_stage2.yaml (batch 4, full width) "
        f"--max-steps 2: exit {proc.returncode}, {wall:.1f} s in process "
        f"{'ok' if good else 'FAIL'}")
    codes = os.path.join(root, "codes")
    proc, wall = run("generate_latent_gt", "-i", faces, "-o", codes)
    path = os.path.join(codes, "latent_gt_code1024.npz")
    good = proc.returncode == 0 and os.path.isfile(path)
    if good:
        with np.load(path) as data:
            good = len(data.files) == 8 and all(
                data[k].shape == (16, 16) and 0 <= data[k].min() and data[k].max() < 1024
                for k in data.files)
    ok &= good
    log(f"generate_latent_gt on 4 faces: exit {proc.returncode}, {wall:.1f} s in process "
        f"{'ok' if good else 'FAIL'}")
    return ok


# ---------------------------------------------------------------------------
# phase 14: the rest of training on the card
# ---------------------------------------------------------------------------

# (M, K, N) of every K8 launch of one int8-dense training forward (batch 1,
# 16 frames, no CFG): QMM_SHAPES' rows over four
TRAIN_QMM_SHAPES = [(m // 4, k, n) for m, k, n in QMM_SHAPES]
# (a)'s cases: K5 at the training forward's shapes (B, S, C; Sk = 50), K8 at
# its training shapes (M, K, N), K9 at the probe's (M, C), the int8
# convolution (frames, Cin, H = W, Cout: a UNet shape per width at 16 frames
# and the VAE decoder's widest) and the int8 dense route (M, K, N)
TRAIN_GRAD_CASES = [("cross_attention_block", (16, 1024, 320)),
                    ("cross_attention_block", (16, 256, 640))] \
    + [("quantized_matmul", dims) for dims in TRAIN_QMM_SHAPES] \
    + [("qkv_proj", dims) for dims in ((131072, 320), (32768, 640), (8192, 1280))] \
    + [("quantized_conv2d", dims) for dims in ((16, 320, 32, 320), (16, 640, 16, 640),
                                               (16, 1280, 8, 1280), (16, 128, 256, 128))] \
    + [("dense_with_params (int8)", dims) for dims in ((16384, 320, 320), (1024, 1280, 10240))]
# the kernels (and the int8 convolution route) each training configuration
# must launch in a step; every other counted one must not
_TRAIN_CORES = {"temporal_attention", "spatial_attention", "dot_product_attention",
                "flash_attention_bwd"}
TRAIN_ON_PATH = {
    "fused": _TRAIN_CORES | {"geglu_ffn", "self_attention_block", "cross_attention_block"},
    "int8": _TRAIN_CORES | {"geglu_ffn", "self_attention_block", "conv_acc"},
    "int8-dense": _TRAIN_CORES | {"quantized_matmul", "conv_acc"},
}
# (b): the step with the kernels against the same step with every wrapper's
# plain version, in each training configuration: the total loss's relative
# difference, and each trainable group's gradient in relative L2. Set from
# the readings of this seed on an H100 with room on both sides (loss
# 2.28e-4 fused, 7.65e-4 int8, 2.21e-4 int8-dense; the worst group
# 0.0075, 0.0179, 0.0188; three runs agreed to three digits)
TRAIN_LOSS_TOL = 5e-3
TRAIN_GRAD_TOL = 0.05
# (d): one SyncNet step at batch 2 from the same weights, on the CPU in f32
# against the card in f32 (TF32 off, every wrapper's plain version: only
# summation orders differ) and in bf16 with the kernels: the loss's
# relative difference and the relative L2 of all gradients together; and
# the kernels' bf16 gradients against the plain versions' bf16 ones. The
# bf16 bounds are set from the readings of this seed on an H100 with room
# on both sides. bf16 itself is the distance from f32: the plain versions
# in bf16 read 1.7e-3 and 0.1675 (the same bits twice), the kernels 1.15e-3
# and 0.1626, and the kernels against the plain bf16 run 0.0567 (K1's two
# launches keep f32 where the plain version rounds to bf16)
SYNCNET_F32_TOL = 1e-3
SYNCNET_LOSS_TOL = 3e-3
SYNCNET_GRAD_TOL = 0.2
SYNCNET_KERNEL_TOL = 0.08


def check_train_grads(device):
    """Phase 14 (a): the gradients this slice adds, on the card against the
    plain composition's autograd on the same bf16 inputs: K5 at the training
    forward's shapes (16 frames, no CFG: C = 320 at 32², C = 640 at 16²;
    Sk = 50), K8 through ``dense_with_params`` at its 15 training shapes, K9
    at the probe's, and the int8 convolution (a UNet shape per width and the
    VAE decoder's widest) and int8 dense routes, straight through (their
    plain composition is the float product). Each: one launch a call under
    grad (K5, K8, K9; the convolution at least one), the forward under grad
    equal bit for bit to the one without, each gradient finite, within
    TOL_REL · max(1, max|plain|) and within BWD_REL_L2_TOL in relative L2.
    Returns ({name: launches under grad}, ok)."""
    import torch

    from latentsync_tpu_torch.ops import attn_block, ffn, qconv, qmm

    gen = torch.Generator().manual_seed(SEED + 15)

    def r(*shape, s=1.0, add=0.0):
        return (torch.randn(shape, generator=gen) * s + add).to(device, torch.bfloat16) \
            .requires_grad_(True)

    def cross(b, s, c):
        return ([r(b, s, c), r(c, s=0.1, add=1.0), r(c, s=0.1), r(b, 50, 384),
                 r(c, c, s=c**-0.5), r(c, 384, s=384**-0.5), r(c, 384, s=384**-0.5),
                 r(c, c, s=c**-0.5), r(c, s=0.1)],
                lambda *a: attn_block.cross_attention_block(*a, 8),
                lambda *a: attn_block.cross_attention_block_reference(*a, 8),
                attn_block.cross_attention_block)

    def k8(m, k, n):
        return ([r(m, k), r(n, k, s=k**-0.5), r(n, s=0.1)],
                lambda *a: qconv.dense_with_params(*a, torch.bfloat16), qconv.float_dense,
                qmm.quantized_matmul)

    def qkv(m, c):
        return ([r(m, c)] + [r(c, c, s=c**-0.5) for _ in range(3)], ffn.qkv_proj,
                ffn.qkv_proj_reference, ffn.qkv_proj)

    def conv(n, cin, hw, cout):
        return ([r(n, cin, hw, hw), r(cout, cin, 3, 3, s=(9 * cin) ** -0.5), r(cout, s=0.1)],
                lambda *a: qconv.quantized_conv2d(*a, (1, 1), (1, 1)),
                lambda *a: qconv.float_conv(*a, (1, 1), (1, 1)), qconv.conv_acc)

    def dense(m, k, n):
        return ([r(m, k), r(n, k, s=k**-0.5), r(n, s=0.1)], qconv._qdense_xla,
                qconv.float_dense, None)

    makers = {"cross_attention_block": cross, "quantized_matmul": k8, "qkv_proj": qkv,
              "quantized_conv2d": conv, "dense_with_params (int8)": dense}
    launches, ok = collections.Counter(), True
    for name, dims in TRAIN_GRAD_CASES:
        # K5 launches under the fused switch, K8 under the int8-dense ones
        conf = "train fused" if name == "cross_attention_block" else "train int8-dense"
        with configured(conf):
            label = "x".join(map(str, dims))
            args, fn, plain, counter = makers[name](*dims)
            before = counter.launches if counter is not None else 0
            out = fn(*args)
            n_launch = (counter.launches - before) if counter is not None else None
            with torch.no_grad():
                again = fn(*args)
            outs = out if isinstance(out, tuple) else (out,)
            same = all(torch.equal(o.detach(), a) for o, a in
                       zip(outs, again if isinstance(again, tuple) else (again,)))
            cots = [torch.randn(o.shape, generator=gen).to(o) for o in outs]
            got = torch.autograd.grad(outs, args, cots)
            ref = plain(*args)
            ref = torch.autograd.grad(ref if isinstance(ref, tuple) else (ref,), args, cots)
            torch.cuda.synchronize()
            err, tol, close = _per_output(got, ref)
            rel = max(_rel_l2(g, p) for g, p in zip(got, ref))
            once = n_launch is None or (n_launch >= 1 if name == "quantized_conv2d"
                                        else n_launch == 1)
            good = same and close and rel <= BWD_REL_L2_TOL and once and all(
                o.grad_fn is not None for o in outs)
            ok &= good
            if n_launch:
                launches[name] += n_launch
            log(f"grad {name:24s} {label:26s} forward under grad same bits={same}, launches "
                f"{n_launch}; {len(args)} gradients, worst max_abs_err={err:.6g} tol={tol:.6g}"
                f" rel_l2={rel:.4g} (tol {BWD_REL_L2_TOL}) {'ok' if good else 'FAIL'}")
            del args, out, again, got, ref, cots
    torch.cuda.empty_cache()
    return dict(launches), ok


def check_train_configs(unet, vae, device, counters):
    """Phase 14 (b): one full-width stage-2 loss and backward in each of the
    fused (K5), int8 and int8-dense (K8) configurations, phase 11's trainer,
    batch, t and noise, against the same step with every wrapper forced to
    its plain version (``plain_kernels``): loss within TRAIN_LOSS_TOL, each
    group's gradient within TRAIN_GRAD_TOL in relative L2, 100 % of trainable
    tensors with a finite non-zero gradient, each kernel of the
    configuration's path launched (counts set to 0 just before) and no
    other, the K8 launch shapes those (a) checked, peak memory and the
    median of 3 warm steps. Returns ({conf: launches}, ok)."""
    import torch

    from latentsync_tpu_torch.config import LatentSyncConfig
    from latentsync_tpu_torch.ops import _build
    from latentsync_tpu_torch.ops.plain import plain_kernels

    cfg = LatentSyncConfig()
    trainer = stage2_trainer(unet, vae, device)
    batch = _train_batch(cfg)
    t, noise = trainer.draw(batch, 0)
    trainable = [n for n, m in trainer.mask.items() if m]

    def step():
        losses, grads = trainer.gradients(batch, t, noise)
        torch.cuda.synchronize()
        return {k: float(v.detach()) for k, v in losses.items()}, grads

    shapes = collections.Counter()

    def observe(entry, args):
        if entry == "ls_quantized_matmul":
            shapes[tuple(args[4:7])] += 1

    all_launches, ok = {}, True
    for conf in TRAIN_CONFIGS:
        with configured(f"train {conf}"):
            for c in counters:
                c.launches = 0
            shapes.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.observer = observe
            try:
                losses_k, grads = step()
            finally:
                _build.observer = None
            launches = {c.__name__: c.launches for c in counters}
            peak = torch.cuda.max_memory_allocated() / 2**30
            good_grads = [bool(torch.isfinite(grads[n]).all())
                          and bool(grads[n].abs().max() > 0) for n in trainable]
            kept = {n: grads[n].clone() for n in trainable}
            del grads
            warm = []
            for _ in range(3):
                t0 = time.time()
                step()
                warm.append(time.time() - t0)
            with plain_kernels():
                losses_p, grads_p = step()
        share = sum(good_grads) / len(good_grads)
        on_path = TRAIN_ON_PATH[conf]
        ran = all(launches[n] > 0 for n in on_path)
        others = {n: v for n, v in launches.items() if n not in on_path and v}
        loss_rel = abs(losses_k["total"] - losses_p["total"]) / abs(losses_p["total"])
        groups = collections.defaultdict(lambda: [0.0, 0.0])
        for n in trainable:
            g = groups[_group(n)]
            g[0] += float((kept[n].float() - grads_p[n].float()).pow(2).sum())
            g[1] += float(grads_p[n].float().pow(2).sum())
        rels = {k: math.sqrt(d / max(r_, 1e-30)) for k, (d, r_) in groups.items()}
        del kept, grads_p
        qmm_ok = conf != "int8-dense" or set(shapes) == set(TRAIN_QMM_SHAPES)
        good = share == 1.0 and ran and not others and qmm_ok \
            and loss_rel <= TRAIN_LOSS_TOL and all(v <= TRAIN_GRAD_TOL for v in rels.values())
        ok &= good
        all_launches[conf] = launches
        log(f"[{gpu_line()}] train step, {conf} ({' '.join(f'{k}={v}' for k, v in TRAIN_CONFIGS[conf].items())}; full "
            f"width, batch 1, 16 frames, 256²): losses (kernels) "
            + ", ".join(f"{k}={v:.6g}" for k, v in losses_k.items())
            + f"; plain total={losses_p['total']:.6g}, loss rel. error {loss_rel:.3g} (tol "
            f"{TRAIN_LOSS_TOL}); gradient rel L2 vs plain "
            + ", ".join(f"{k} {v:.4g}" for k, v in sorted(rels.items()))
            + f" (tol {TRAIN_GRAD_TOL}); trainable tensors with a finite non-zero gradient "
            f"{sum(good_grads)}/{len(good_grads)} = {100 * share:.1f} %; launches "
            f"{json.dumps({n: launches[n] for n in sorted(on_path)})}, other kernels {others}"
            + (f"; K8 shapes {sorted(shapes.items())} (as (a): {qmm_ok})"
               if conf == "int8-dense" else "")
            + f"; peak device memory {peak:.2f} GiB; warm steps (s) "
            f"{', '.join(f'{w:.3f}' for w in warm)}, median {sorted(warm)[1]:.3f} "
            f"{'ok' if good else 'FAIL'}")
    for p in trainer.params.values():
        p.grad = None
    del trainer
    torch.cuda.empty_cache()
    return all_launches, ok


def _json_records(text: str):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_main(module: str, argv, env=None):
    """``latentsync_tpu_torch.scripts.<module>.main(argv)`` in this process,
    with `env` set (and every serving switch cleared) for the duration:
    (exit code, its standard output, its traceback or "", wall s). In
    process, a CLI pays no interpreter, CUDA or import start-up."""
    import gc
    import importlib

    import torch

    main = importlib.import_module(f"latentsync_tpu_torch.scripts.{module}").main
    env = dict(env or {})
    old = {k: os.environ.pop(k, None) for k in set(SWITCHES) | set(env)}
    os.environ.update(env)
    buf, err = io.StringIO(), ""
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            result = main(list(argv))
        # an int is the exit code; the CLIs whose ``__main__`` drops what
        # ``main`` returns (a path, a state) exit 0
        rc = result if isinstance(result, int) and not isinstance(result, bool) else 0
    except SystemExit as e:  # argparse's errors, a CLI's own exit
        rc = e.code if isinstance(e.code, int) else 1
        err = traceback.format_exc()
    except Exception:  # noqa: BLE001 — the check reports it
        rc, err = 1, traceback.format_exc()
    finally:
        for k, v in old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
        gc.collect()
        torch.cuda.empty_cache()
    return rc, buf.getvalue(), err, time.time() - t0


def run_train_cli_ddp(root: str) -> bool:
    """Phase 14 (c): ``train_unet`` under ``LATENTSYNC_INT8=1`` as ``python -m
    torch.distributed.run --nproc_per_node 1`` starts it (its environment:
    ``WORLD_SIZE`` 1, rank 0, a free local port; NCCL, world size 1), in this
    process, with ``--resume`` from the checkpoint phase 11 (c) left in `root`
    (step 4, saved by the CLI without a launcher): the resume announced at
    step 4, 2 int8 steps, its loss chart written, step 6 saved. It is the
    resume of phase 11 (c)'s run: it pays a checkpoint's 10 GB of I/O each
    way, and the script keeps inside its time limit."""
    out = os.path.join(root, "train_out")
    for old in sorted(f for f in os.listdir(out) if f.startswith("step_"))[:-1]:
        os.remove(os.path.join(out, old))  # keep the latest checkpoint alone on disk
    chart = os.path.join(out, "loss_chart.png")
    if os.path.exists(chart):
        os.remove(chart)
    argv = ["--config", os.path.join(root, "unet_stage2.yaml"), "--output-dir", out,
            "--log-every", "1", "--max-steps", "6", "--resume"]
    launcher = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    rc, stdout, err, wall = run_main("train_unet", argv, dict(launcher, LATENTSYNC_INT8="1"))
    lines = _json_records(stdout)
    steps = [x for x in lines if "loss" in x]
    dp = [x["data_parallel"] for x in lines if "data_parallel" in x]
    good = rc == 0 and [x["step"] for x in steps] == [5, 6] \
        and all(math.isfinite(x["loss"]) for x in steps) \
        and dp == [{"backend": "nccl", "world": 1, "dp": 1}] \
        and any(x.get("step") == 4 and "resumed_from" in x for x in lines) \
        and any(x.get("step") == 6 and "saved" in x for x in lines) and os.path.isfile(chart)
    for x in lines:
        log(f"  train_unet (the torch.distributed.run environment, int8): {json.dumps(x)}")
    log(f"[{gpu_line()}] train_unet --resume --max-steps 6 in process under a launcher's "
        f"environment (world size 1, LATENTSYNC_INT8=1): exit {rc}, {wall:.1f} s, loss chart "
        f"{os.path.isfile(chart)} {'ok' if good else 'FAIL: ' + (err or stdout)[-3000:]}")
    return good


def check_syncnet_training(root: str, device, counters):
    """Phase 14 (d): the SyncNet trainer at full width
    (``configs/syncnet_16_pixel_attn.yaml``: 16 frames, 256², batch 32, bf16)
    on seeded synthetic clips: one batch drawn by ``SyncNetSampleSource``,
    its steps' loss and ``sat_frac`` finite, the median of 3 warm steps
    (host clock, ending in the step's metrics), peak memory and the port's
    kernels launched in a step; one step at batch 2 from the same weights
    on the CPU in f32 against the card in f32 with the plain versions
    (SYNCNET_F32_TOL), in bf16 with the plain versions (twice, printed) and
    in bf16 with the kernels (SYNCNET_LOSS_TOL, SYNCNET_GRAD_TOL; and against
    the plain bf16 run, SYNCNET_KERNEL_TOL); then ``train_syncnet`` for 4
    steps with validation
    every 2 (chart and checkpoint with both histories) and one ``--resume``
    step, and ``eval_syncnet_acc`` on the same clips, in subprocesses.
    Returns (launches in a step, ok)."""
    import copy
    import dataclasses

    import numpy as np
    import torch
    import yaml

    from latentsync_tpu_torch.config import load_config
    from latentsync_tpu_torch.ops.plain import plain_kernels
    from latentsync_tpu_torch.training.data import SyncNetSampleSource
    from latentsync_tpu_torch.training.syncnet_trainer import SyncNetTrainer
    from latentsync_tpu_torch.utils.checkpoint import latest_checkpoint, restore_checkpoint

    files = _write_training_clips(root)
    path = "configs/syncnet_16_pixel_attn.yaml"
    cfg = load_config(path)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, train_fileslist=files))
    source = SyncNetSampleSource(cfg, seed=SEED)
    t0 = time.time()
    samples = [source.sample() for _ in range(cfg.data.batch_size)]
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    sample_s = time.time() - t0
    trainer = SyncNetTrainer(cfg, device=device)
    n_params = sum(p.numel() for p in trainer.params.values())
    initial = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}

    # the card in bf16 and in f32 against the CPU in f32 at batch 2, from the
    # same weights
    small = {k: v[:2] for k, v in batch.items()}
    cpu = SyncNetTrainer(cfg, dtype=torch.float32, device="cpu",
                         model=copy.deepcopy(trainer.model).cpu())
    cpu.model.load_state_dict(initial)
    t0 = time.time()
    loss_f, _, grads_f = cpu.gradients(small)
    cpu_s = time.time() - t0
    loss_f = float(loss_f.detach())

    def against_cpu(tr):
        loss, _, grads = tr.gradients(small)
        return abs(float(loss.detach()) - loss_f) / abs(loss_f), rel_l2(grads, grads_f), grads

    def rel_l2(grads, ref):
        num = sum(float((grads[k].float().cpu() - ref[k].float().cpu()).pow(2).sum())
                  for k in ref)
        den = sum(float(ref[k].float().cpu().pow(2).sum()) for k in ref)
        return math.sqrt(num / max(den, 1e-30))

    card32 = SyncNetTrainer(cfg, dtype=torch.float32, device=device,
                            model=copy.deepcopy(trainer.model))
    with no_tf32(), plain_kernels():  # K1 is bf16 only: f32 takes its plain version
        loss_diff32, grad_rel32, _ = against_cpu(card32)
    del card32
    # bf16 with every wrapper's plain version, twice, separates bf16 rounding
    # from the kernels: the kernels' run is held against it as well
    with plain_kernels():
        loss_diff_p, grad_rel_p, grads_p = against_cpu(trainer)
        again = rel_l2(against_cpu(trainer)[2], grads_p)
    loss_diff, grad_rel, grads_k = against_cpu(trainer)
    kernel_rel = rel_l2(grads_k, grads_p)
    del cpu, grads_f, grads_p, grads_k
    vs_cpu = loss_diff32 <= SYNCNET_F32_TOL and grad_rel32 <= SYNCNET_F32_TOL \
        and loss_diff <= SYNCNET_LOSS_TOL and grad_rel <= SYNCNET_GRAD_TOL \
        and kernel_rel <= SYNCNET_KERNEL_TOL

    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics = [trainer.train_step(batch)]
    launches = {c.__name__: c.launches for c in counters if c.launches}
    warm = []
    for _ in range(3):
        t0 = time.time()
        metrics.append(trainer.train_step(batch))
        warm.append(time.time() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    finite = all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) for m in metrics)
    good = finite and vs_cpu
    log(f"[{gpu_line()}] SyncNet trainer (full width, {n_params / 1e6:.1f}M params, batch "
        f"{cfg.data.batch_size}, bf16; the batch drawn in {sample_s:.2f} s): losses "
        f"{[round(m['loss'], 6) for m in metrics]}, sat_frac "
        f"{[m['sat_frac'] for m in metrics]}, grad_norm {metrics[0]['grad_norm']:.4g}; warm "
        f"steps (s) {', '.join(f'{w:.4f}' for w in warm)}, median {sorted(warm)[1]:.4f}; peak "
        f"device memory {peak:.2f} GiB; the port's kernels in a step {launches}; batch 2 "
        f"against the CPU in f32 (loss {loss_f:.6g}, {cpu_s:.1f} s): card f32 (TF32 off) loss "
        f"rel. difference {loss_diff32:.3g}, gradients rel L2 {grad_rel32:.4g} (tol "
        f"{SYNCNET_F32_TOL} each); card bf16 with the plain versions: loss rel. difference "
        f"{loss_diff_p:.3g}, gradients rel L2 {grad_rel_p:.4g} (a second such run against the "
        f"first: {again:.4g}); card bf16 with the kernels: loss rel. difference "
        f"{loss_diff:.3g} (tol {SYNCNET_LOSS_TOL}), gradients rel L2 {grad_rel:.4g} (tol "
        f"{SYNCNET_GRAD_TOL}), against the plain bf16 run {kernel_rel:.4g} (tol "
        f"{SYNCNET_KERNEL_TOL}) {'ok' if good else 'FAIL'}")
    del trainer
    torch.cuda.empty_cache()

    with open(path) as f:
        tree = yaml.safe_load(f)
    tree["data"]["train_fileslist"] = files
    config = os.path.join(root, "syncnet.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(tree, f)
    out = os.path.join(root, "syncnet_out")
    argv = ["--config", config, "--output-dir", out, "--log-every", "1", "--validation-steps",
            "2"]
    for extra, want in ((["--max-steps", "4"], [1, 2, 3, 4]),
                        (["--max-steps", "5", "--resume"], [5])):
        rc, stdout, err, wall = run_main("train_syncnet", argv + extra)
        lines = _json_records(stdout)
        steps = [x for x in lines if "loss" in x]
        vals = [x["val_step"] for x in lines if "val_step" in x]
        ran = rc == 0 and [x["step"] for x in steps] == want \
            and all(math.isfinite(x["loss"]) for x in steps)
        aux = {}
        if ran:
            aux = restore_checkpoint(latest_checkpoint(out)).get("aux", {})
        if "--resume" in extra:
            ran &= any(x.get("step") == 4 and "resumed_from" in x for x in lines)
            ran &= [s for s, _ in aux.get("train_hist", [])] == [1, 2, 3, 4, 5]
        else:
            ran &= vals == [2, 4] and os.path.isfile(os.path.join(out, "loss_chart.png"))
            ran &= [s for s, _ in aux.get("train_hist", [])] == [1, 2, 3, 4] \
                and [s for s, _ in aux.get("val_hist", [])] == [2, 4]
        good &= ran
        log(f"[{gpu_line()}] train_syncnet {' '.join(extra)} (in process): exit {rc}, "
            f"{wall:.1f} s, steps {[(x['step'], round(x['loss'], 5), x['sat_frac']) for x in steps]}"
            f", validation at {vals}, histories in the checkpoint "
            f"{ {k: len(v) for k, v in aux.items() if k != 'step'} } "
            f"{'ok' if ran else 'FAIL: ' + (err or stdout)[-3000:]}")
    rc, stdout, err, wall = run_main("eval_syncnet_acc", ["--config", config, "--num-samples",
                                                          "32", "--batch-size", "32"])
    lines = _json_records(stdout)
    ran = rc == 0 and len(lines) == 1 and lines[0].get("samples") == 32 \
        and 0 <= lines[0].get("accuracy", -1) <= 1 and math.isfinite(lines[0].get("loss", math.nan))
    good &= ran
    log(f"[{gpu_line()}] eval_syncnet_acc (32 samples, in process): exit {rc}, {wall:.1f} s, "
        f"{lines[-1] if lines else None} {'ok' if ran else 'FAIL: ' + (err or stdout)[-3000:]}")
    return launches, good




# ---------------------------------------------------------------------------
# phase 15: evaluation and data preparation
# ---------------------------------------------------------------------------

# the evaluation nets in f32 on the card (TF32 off) against the CPU port on the
# same inputs, relative L2: 10x this phase's first readings on an H100 (lip
# 2.17e-6, audio 1.54e-6, distances 2.26e-7, HyperIQA 2.2e-7, I3D 4.08e-7;
# PERF.md §6)
EVAL_TOL = {"syncnet_lip": 2e-5, "syncnet_aud": 1.5e-5, "syncnet_dists": 2e-6,
            "hyperiqa": 2e-6, "i3d": 4e-6,
            # phase 17 (b), Wav2LipSyncNet's two embeddings: 10x the first readings
            # (visual 2.74e-6, audio 1.66e-6; PERF.md §6)
            "wav2lip_vis": 3e-5, "wav2lip_aud": 2e-5}
# the production point validate_fidelity holds against the exact trajectory
PRODUCTION_FAST = "int8,deepcache=4:1:enc,cfg=0:0.5"


def _eval_clip(root: str, name: str, seconds: float, size: int = 320, cut: bool = False,
               seed: int = SEED):
    """A synthetic talking head of `seconds` at 25 fps with its ``.wav``
    sidecar (``make_face_video`` and ``write_speech``); with `cut`, the second
    half a hard cut away (the colour channels swapped, the head moved). Returns
    (path, frames)."""
    import numpy as np

    from latentsync_tpu_torch.utils.media import write_video

    n = int(round(seconds * 25))
    path = os.path.join(root, f"{name}.mp4")
    frames = make_face_video(path, n_frames=n, size=size)
    if cut:
        half = n // 2
        frames = frames.copy()
        frames[half:] = np.roll(frames[half:, ..., ::-1], size // 5, axis=2)
        write_video(path, frames, fps=25)
    write_speech(os.path.join(root, f"{name}.wav"), seconds, seed=seed)
    return path, frames


def _median_s(fn, n: int = 5) -> float:
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[n // 2]


def check_sync_scorer(root: str, device) -> bool:
    """Phase 15 (a): the SyncNet scorer (f32, TF32 off, seeded random weights
    with batch-norm statistics) on a 5 s synthetic talking clip (125 frames
    at 224², 16 kHz audio), on the card and on the CPU: lip and audio
    features and the distance matrix in relative L2, the offset under the
    tie rule, min_dist and the confidence; the median of 5 ``evaluate_arrays``
    on the card and windows per second."""
    import numpy as np

    from latentsync_tpu_torch.eval import sync_eval as se
    from latentsync_tpu_torch.utils.media import read_audio

    path, frames = _eval_clip(root, "scorer", 5.0, size=224)
    audio = read_audio(path[:-4] + ".wav")
    card, cpu = se.SyncNetEvaluator(device=device), se.SyncNetEvaluator(device="cpu")
    t0 = time.time()
    c_lip, c_aud = cpu.features(frames, audio)
    cpu_s = time.time() - t0
    g_lip, g_aud = card.features(frames, audio)
    c_d = se.pairwise_shift_distances(c_lip, c_aud)
    g_d = se.pairwise_shift_distances(g_lip, g_aud).cpu()
    errs = {"syncnet_lip": _rel_l2(g_lip.cpu(), c_lip), "syncnet_aud": _rel_l2(g_aud.cpu(), c_aud),
            "syncnet_dists": _rel_l2(g_d, c_d)}
    c_res, g_res = se.offset_and_confidence(c_d), se.offset_and_confidence(g_d)
    mean = np.sort(c_d.mean(0).numpy())
    scale = float(c_d.abs().max())
    # the tie rule: offsets must agree where the CPU's two smallest mean distances
    # are further apart than the distances' tolerance of its largest distance
    near = EVAL_TOL["syncnet_dists"] * scale
    tie = mean[1] - mean[0] <= near
    good = all(errs[k] <= EVAL_TOL[k] for k in errs) and (tie or g_res[0] == c_res[0])
    good &= abs(g_res[2] - c_res[2]) <= near and math.isfinite(g_res[2])
    windows = len(c_lip)
    med = _median_s(lambda: card.evaluate_arrays(frames, audio))
    log(f"[{gpu_line()}] SyncNet scorer, 5 s clip ({windows} windows, batch {card.batch_size}): "
        f"card vs CPU rel L2 lip {errs['syncnet_lip']:.3g} audio {errs['syncnet_aud']:.3g} "
        f"distances {errs['syncnet_dists']:.3g} (tols {EVAL_TOL['syncnet_lip']}, "
        f"{EVAL_TOL['syncnet_aud']}, {EVAL_TOL['syncnet_dists']}); "
        f"(offset, min_dist, conf) card {tuple(round(x, 5) for x in g_res)} CPU "
        f"{tuple(round(x, 5) for x in c_res)}{' (a near tie: offsets not compared)' if tie else ''}; "
        f"evaluate_arrays median {med * 1e3:.2f} ms = {windows / med:.1f} windows/s "
        f"(CPU features {cpu_s:.2f} s) {'ok' if good else 'FAIL'}")
    return good


def check_hyperiqa(frames, device) -> bool:
    """Phase 15 (b): HyperIQA (ResNet50 at 224², f32, TF32 off, seeded random
    weights) on the quality gate's 3 evenly spaced frames and on a batch of
    16, card against CPU; the median of 5 batches of 16 on the card and
    frames per second."""
    import numpy as np

    from latentsync_tpu_torch.models.hyper_iqa import HyperIQAScorer

    card, cpu = HyperIQAScorer(device=device), HyperIQAScorer(device="cpu")
    sampled = frames[np.linspace(0, len(frames) - 1, 3).astype(int)]
    batch = frames[:16]
    good, errs = True, []
    for x in (sampled, batch):
        got, want = card.score_batch(x), cpu.score_batch(x)
        err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        errs.append(err)
        good &= bool(np.isfinite(got).all()) and err <= EVAL_TOL["hyperiqa"]
    gate = float(np.mean([card(f) for f in sampled]))
    med = _median_s(lambda: card.score_batch(batch))
    log(f"[{gpu_line()}] HyperIQA: card vs CPU rel L2 {errs[0]:.3g} (3 sampled frames), "
        f"{errs[1]:.3g} (batch 16) (tol {EVAL_TOL['hyperiqa']}); the gate's mean score "
        f"{gate:.4f}; batch 16 median {med * 1e3:.2f} ms = {16 / med:.1f} frames/s "
        f"{'ok' if good else 'FAIL'}")
    return good


def check_i3d(root: str, device) -> bool:
    """Phase 15 (c): Inception-I3D at the FVD point (16 × 224², batch 4, f32,
    TF32 off, seeded random weights): logits card against CPU, the median of
    5 batches on the card and clips per second; then ``eval_fvd --device
    cuda`` in a subprocess on two directories of 4 synthetic 16-frame clips:
    a finite FVD tagged ``random`` (no I3D weights), with its warning."""
    import numpy as np
    import torch

    from latentsync_tpu_torch.models.face_detection import no_tf32
    from latentsync_tpu_torch.models.i3d import InceptionI3D
    from latentsync_tpu_torch.utils.convert import init_random_bn_
    from latentsync_tpu_torch.utils.media import write_video

    cpu = init_random_bn_(InceptionI3D(), seed=0).eval()
    card = init_random_bn_(InceptionI3D(), seed=0).to(device).eval()
    gen = torch.Generator().manual_seed(SEED)
    x = torch.rand((4, 3, 16, 224, 224), generator=gen) * 2 - 1
    with torch.inference_mode():
        want = cpu(x)
        with no_tf32(device):
            xd = x.to(device)
            got = card(xd).cpu()
            med = _median_s(lambda: card(xd))
    err = _rel_l2(got, want)
    good = bool(torch.isfinite(got).all()) and got.shape == (4, 400) and err <= EVAL_TOL["i3d"]
    log(f"[{gpu_line()}] I3D (4, 3, 16, 224, 224): card vs CPU logits rel L2 {err:.3g} (tol "
        f"{EVAL_TOL['i3d']}); median {med * 1e3:.2f} ms = {4 / med:.1f} clips/s "
        f"{'ok' if good else 'FAIL'}")

    rng = np.random.default_rng(SEED)
    for name, shift in (("real", 0), ("fake", 50)):
        os.makedirs(os.path.join(root, name))
        for i in range(4):
            clip = rng.integers(shift, 150 + shift, (16, 112, 112, 3), np.uint8)
            write_video(os.path.join(root, name, f"c{i}.mp4"), clip, fps=25)
    env = dict(os.environ, LATENTSYNC_I3D_CKPT=os.path.join(root, "no_i3d.pt"))
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "latentsync_tpu_torch.scripts.eval_fvd",
                           "--real-dir", os.path.join(root, "real"), "--fake-dir",
                           os.path.join(root, "fake"), "--device", "cuda"],
                          capture_output=True, text=True, timeout=600, env=env)
    rows = _json_records(proc.stdout)
    row = rows[-1] if rows else {}
    ran = proc.returncode == 0 and math.isfinite(row.get("fvd", math.nan)) \
        and row.get("i3d_weights") == "random" and row.get("n_real") == row.get("n_fake") == 4 \
        and "RANDOM weights" in proc.stderr
    log(f"[{gpu_line()}] eval_fvd --device cuda: exit {proc.returncode}, "
        f"{time.time() - t0:.1f} s, {row} {'ok' if ran else 'FAIL: ' + proc.stderr[-3000:]}")
    return good and ran


PIPELINE_STAGES = ["decodable", "resampled", "shot", "segmented", "affine_transformed",
                   "filtered_affined", "av_synced", "high_visual_quality"]


def run_data_pipeline(root: str) -> bool:
    """Phase 15 (d): ``data_processing_pipeline --device cuda
    --with-quality-gate`` in a subprocess, with the permissive gates of
    ``tests/test_preprocess_e2e.py`` (``--min-sync-conf=-1e9 --max-av-offset
    1000000 --min-iqa=-1e9``), on a 6 s synthetic talking clip and a 12 s one
    with a hard cut at 6 s, each with its ``.wav`` sidecar: three
    training-ready 256² clips, each with its sidecar, every stage's count
    printed and no stage's failure line (the stages swallow a file's
    exception, as in the JAX package); a second run (its ``main()`` in this
    process) resumes to the same list; then ``eval_sync_conf --device cuda``
    (in this process) over the output prints one finite row a file and the
    mean."""
    from latentsync_tpu_torch.scripts import data_processing_pipeline, eval_sync_conf
    from latentsync_tpu_torch.utils.media import video_info

    src = os.path.join(root, "raw")
    os.makedirs(src)
    _eval_clip(src, "talk", 6.0, size=256)
    _eval_clip(src, "cut", 12.0, size=256, cut=True, seed=SEED + 1)
    out, files = os.path.join(root, "data"), os.path.join(root, "files.txt")
    argv = ["--input", src, "--output", out, "--fileslist", files, "--with-quality-gate",
            "--min-sync-conf=-1e9", "--max-av-offset", "1000000", "--min-iqa=-1e9",
            "--device", "cuda"]
    good, lists = True, []
    for run in ("first", "resumed"):
        t0 = time.time()
        if run == "first":
            proc = subprocess.run([sys.executable, "-m",
                                   "latentsync_tpu_torch.scripts.data_processing_pipeline",
                                   *argv], capture_output=True, text=True, timeout=900)
            rc, text, err = proc.returncode, proc.stdout, proc.stderr
        else:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = data_processing_pipeline.main(argv)
            text, err = buf.getvalue(), ""
        wall = time.time() - t0
        counts = [line for line in text.splitlines() if line.startswith("stage ")]
        listed = open(files).read().split() if os.path.exists(files) else []
        lists.append(listed)
        ran = rc == 0 and "failed" not in text \
            and [c.split(":")[0] for c in counts] == [f"stage {s}" for s in PIPELINE_STAGES] \
            and len(listed) == 3 and all(os.path.exists(p) and os.path.exists(p[:-4] + ".wav")
                                         and video_info(p)[:2] == (256, 256) for p in listed)
        good &= ran
        per_s = f", {wall / 18.0:.3f} s per input video-second" if run == "first" else ""
        log(f"[{gpu_line()}] data_processing_pipeline ({run} run"
            f"{', its own process' if run == 'first' else ', in process'}): exit {rc}, "
            f"{wall:.1f} s{per_s}; {'; '.join(counts)}; {len(listed)} files "
            f"{[os.path.basename(p) for p in listed]} "
            f"{'ok' if ran else 'FAIL: ' + (text + err)[-3000:]}")
    resumed = lists[0] == lists[1]
    good &= resumed
    log(f"the resumed run's list equals the first's: {resumed} {'ok' if resumed else 'FAIL'}")
    t0 = time.time()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = eval_sync_conf.main(["--dir", os.path.join(out, "high_visual_quality"),
                                  "--device", "cuda"])
    rows = _json_records(buf.getvalue())
    per_file = [r for r in rows if "confidence" in r]
    ran = rc == 0 and len(per_file) == 3 and "mean_confidence" in rows[-1] \
        and all(math.isfinite(r["confidence"]) for r in per_file) \
        and math.isfinite(rows[-1]["mean_confidence"])
    good &= ran
    log(f"[{gpu_line()}] eval_sync_conf --device cuda over the output: exit {rc}, "
        f"{time.time() - t0:.1f} s, {rows} {'ok' if ran else 'FAIL'}")
    return good


@contextlib.contextmanager
def _serving(pipeline):
    """``scripts/inference.build_pipeline`` answering with `pipeline` for the
    duration: the CLIs below build the same full-width model (seeded random
    weights, no checkpoint files) that phase 9's inference CLI builds in its
    own process, so they reuse phase 4's instead of drawing 1.3 G weights
    again."""
    from latentsync_tpu_torch.scripts import inference

    real = inference.build_pipeline
    inference.build_pipeline = lambda args, dtype=None: pipeline
    try:
        yield
    finally:
        inference.build_pipeline = real


class _PerRender:
    """`pipeline` answering as itself, with each call's kernel launches
    recorded in ``renders`` (name → launches during that call), so that each
    render of one CLI run is checked on its own."""

    def __init__(self, pipeline, counters):
        self._pipeline, self._counters, self.renders = pipeline, counters, []

    def __call__(self, *args, **kwargs):
        before = {fn.__name__: fn.launches for fn in self._counters}
        out = self._pipeline(*args, **kwargs)
        self.renders.append({fn.__name__: fn.launches - before[fn.__name__]
                             for fn in self._counters})
        return out

    def __getattr__(self, name):
        return getattr(self._pipeline, name)


def _counted(launches: dict, want, label: str) -> bool:
    """Every counted kernel in `want` launched, and no other (`launches`:
    name → count)."""
    ok = True
    for name, n in launches.items():
        good = n > 0 if name in want else n == 0
        ok &= good
        log(f"launches ({label}): {name}={n} "
            f"{'ok' if good else 'FAIL'}{'' if name in want else ' (must be 0)'}")
    return ok


def run_render_paths(root: str, pipeline, unet, vae, device, counters) -> bool:
    """Phase 15 (e), at full width (LatentSync 1.5 stage 2, 20 DDIM steps, CFG
    1.5), each ``main()`` in this process so that the kernel counts can be
    read: ``validate_fidelity`` on a 1.2 s synthetic talking clip (the exact
    trajectory against the production point ``int8,deepcache=4:1:enc,cfg=
    0:0.5``, one pipeline, the switches set per render): ``weights: random``,
    the gate INCONCLUSIVE, finite confidences, a non-zero ``pixel_delta``,
    and, each render's launches read on its own, the exact render's the
    default configuration's kernels and the production render's the int8
    configuration's, each launched and no other;
    ``inference_videos --score`` on one pair in the default configuration;
    and the UNet trainer's ``run_validation`` on phase 3's UNet: a finite
    ``val_sync_conf``."""
    import dataclasses

    import torch

    from latentsync_tpu_torch.scripts import inference_videos, train_unet, validate_fidelity

    video, _ = _eval_clip(root, "render", 1.2)
    audio = video[:-4] + ".wav"
    ok = True
    recorder = _PerRender(pipeline, counters)
    with _serving(recorder), configured("default"):
        for fn in counters:
            fn.launches = 0
        gate_path = os.path.join(root, "gate.json")
        t0 = time.time()
        rc = validate_fidelity.main(["--video", video, "--audio", audio, "--fast",
                                     PRODUCTION_FAST, "--workdir", os.path.join(root, "work"),
                                     "--out", gate_path])
        torch.cuda.synchronize()
        wall = time.time() - t0
        row = json.load(open(gate_path)) if os.path.exists(gate_path) else {}
        good = rc == 0 and row.get("weights") == "random" \
            and str(row.get("gate", "")).startswith("INCONCLUSIVE") \
            and all(math.isfinite(row.get(k, math.nan)) for k in ("conf_exact", "conf_fast")) \
            and row.get("pixel_delta", 0) > 0 and row.get("fast_mode") == PRODUCTION_FAST
        log(f"[{gpu_line()}] validate_fidelity --fast {PRODUCTION_FAST}: exit {rc}, {wall:.1f} s, "
            f"{json.dumps(row)} {'ok' if good else 'FAIL'}")
        # each render on its own: the exact one must launch the default
        # configuration's kernels and no int8 one, whatever the switches of the
        # production render or of earlier phases left behind
        good &= len(recorder.renders) == 2
        for launches, conf, label in zip(recorder.renders, ("default", "int8"),
                                         ("exact", "production")):
            good &= _counted(launches, ON_PATH[conf], f"validate_fidelity, the {label} render")
        ok &= good

        for fn in counters:
            fn.launches = 0
        pairs = os.path.join(root, "pairs.tsv")
        with open(pairs, "w") as f:
            f.write(f"{video}\t{audio}\n")
        t0 = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = inference_videos.main(["--pairs", pairs, "--out-dir", os.path.join(root, "iv"),
                                        "--score"])
        torch.cuda.synchronize()
        rows = _json_records(buf.getvalue())
        good = rc == 0 and len(rows) == 1 and rows[0].get("frames") == 32 \
            and math.isfinite(rows[0].get("confidence", math.nan))
        log(f"[{gpu_line()}] inference_videos --score: exit {rc}, {time.time() - t0:.1f} s, "
            f"{rows} {'ok' if good else 'FAIL'}")
        good &= _counted({fn.__name__: fn.launches for fn in counters}, ON_PATH["default"],
                         "inference_videos, default configuration")
        ok &= good

        config = pipeline.config
        config = dataclasses.replace(config, data=dataclasses.replace(
            config.data, val_video_path=video, val_audio_path=audio))
        t0 = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            conf = train_unet.run_validation(unet, vae, config, os.path.join(root, "val"), 1,
                                             device, torch.bfloat16)
        text = buf.getvalue()
        good = isinstance(conf, float) and math.isfinite(conf) and "failed" not in text \
            and "skipped" not in text
        log(f"[{gpu_line()}] run_validation on phase 3's UNet: val_sync_conf {conf}, "
            f"{time.time() - t0:.1f} s, its lines {text.strip().splitlines()} "
            f"{'ok' if good else 'FAIL'}")
        ok &= good
    return ok


def check_evaluation(pipeline, unet, vae, device, counters) -> bool:
    """Phase 15, sub-phase by sub-phase with its wall time."""
    ok = True
    with tempfile.TemporaryDirectory() as root:
        steps = [("(a) the SyncNet scorer", lambda: check_sync_scorer(root, device)),
                 ("(b) HyperIQA", lambda: check_hyperiqa(
                     make_face_video(os.path.join(root, "iqa.mp4"), n_frames=32, size=256),
                     device)),
                 ("(c) I3D and eval_fvd", lambda: check_i3d(os.path.join(root, "fvd"), device)),
                 ("(d) the data pipeline and eval_sync_conf",
                  lambda: run_data_pipeline(os.path.join(root, "prep"))),
                 ("(e) the render paths", lambda: run_render_paths(
                     os.path.join(root, "render"), pipeline, unet, vae, device, counters))]
        for label, step in steps:
            t0 = time.time()
            for sub in ("fvd", "prep", "render"):
                os.makedirs(os.path.join(root, sub), exist_ok=True)
            good = step()
            ok &= good
            log(f"phase 15 {label}: {time.time() - t0:.1f} s {'ok' if good else 'FAIL'}")
    return ok


# ---------------------------------------------------------------------------
# phase 16: serving across cards, the landmark trainer, DCNv2 / upfirdn, probes
# ---------------------------------------------------------------------------

# the mesh serving script's windows: every card gets at least one, one card two
MESH_WINDOWS_MIN = 2
# the kernels each served configuration launches in a UNet forward (the
# flash route serves the VAE only)
MESH_ON_PATH = {conf: ON_PATH[conf] - {"dot_product_attention"}
                for conf in ("default", "fused", "int8-dense")}
# each configuration's largest relative L2 from the single rank (one card:
# the same computation; over cards int8 flips on any float difference)
MESH_TOL = {"default": UNET_TOL, "fused": UNET_TOL, "int8-dense": INT8_TOL}
# the fused and int8-dense launches' depth (the default one runs the 20)
MESH_CONFIG_STEPS = 2
# the landmark trainer's cut: its default draws 4000 faces for 2000 steps
LANDMARK_FACES, LANDMARK_STEPS = 512, 300
# two landmark steps, card (f32, TF32 off) against the CPU from one model:
# the losses' relative difference, the running statistics' and the second
# step's update's relative L2 (Adam turns gradients that are rounding alone,
# ahead of a batch norm, into ±lr either way: those two biases are left out)
LANDMARK_TOL = 1e-2
LANDMARK_BN_FED = ("conv1.bias", "conv_last0.bias")
# DCNv2 / upfirdn2d in f32 (TF32 off), card against CPU: relative L2
CV_TOL = 1e-5


def _mesh_row_ok(conf: str, r: dict, tol: float) -> bool:
    launched = r["launches_a_forward"]
    fine = r["ok"] and r["denoise_rel_l2"] <= tol and r["forward_rel_l2"] <= tol \
        and launched == r["single_rank_launches"] \
        and all(launched[k] > 0 for k in MESH_ON_PATH[conf])
    log(f"[{gpu_line()}] mesh {conf} {r['layout']} (dp x tp; {r['windows']} windows, "
        f"{r['steps']} steps, {r['dtype']}, {r['sharded_params']} sharded weights): denoise rel "
        f"L2 {r['denoise_rel_l2']:.3g} max abs {r['denoise_max_abs']:.3g}, forward rel L2 "
        f"{r['forward_rel_l2']:.3g} (tol {tol}; bitwise "
        f"{r['denoise_max_abs'] == 0 and r['forward_max_abs'] == 0}); window batch "
        f"{r['window_batch_wall_ms']:.1f} ms wall; kernels a forward "
        f"{ {k: v for k, v in launched.items() if v} } (single rank "
        f"{ {k: v for k, v in r['single_rank_launches'].items() if v} }), all-gathers a forward "
        f"{r['all_gathers_a_forward']}; peak GiB per rank {r['peak_gib_per_rank']} "
        f"{'ok' if fine else 'FAIL'}")
    return fine


def check_mesh_serving(device):
    """Phase 16 (a): the mesh serving script over every card, in the default
    configuration at full depth, then in the fused and int8-dense ones
    (MESH_CONFIG_STEPS steps, both launches at once); returns ({configuration:
    rank 0's kernel launches a forward in the first layout}, ok)."""
    import torch

    cards = torch.cuda.device_count()
    windows = max(MESH_WINDOWS_MIN, cards)
    base = {k: v for k, v in os.environ.items() if k not in SWITCHES}

    def launch(conf, steps=0):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
               str(cards), "-m", "latentsync_tpu_torch.scripts.mesh_serving", "--windows",
               str(windows), "--tol", str(MESH_TOL[conf])]
        cmd += ["--steps", str(steps)] if steps else []
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                env=dict(base, **CONFIGS[conf]))

    good, launches = True, {}
    for group in (("default",), ("fused", "int8-dense")):
        t0 = time.time()
        procs = {conf: launch(conf, 0 if conf == "default" else MESH_CONFIG_STEPS)
                 for conf in group}
        try:
            for conf, proc in procs.items():
                stdout, stderr = proc.communicate(timeout=900)
                rows = [r for r in _json_records(stdout) if "layout" in r]
                fine = proc.returncode == 0 and bool(rows)
                for r in rows:
                    fine &= _mesh_row_ok(conf, r, MESH_TOL[conf])
                launches[conf] = rows[0]["launches_a_forward"] if rows else {}
                good &= fine
                log(f"mesh_serving ({conf}) under torch.distributed.run ({cards} card(s)): "
                    f"exit {proc.returncode}, {time.time() - t0:.1f} s "
                    f"{'ok' if fine else 'FAIL: ' + stderr[-3000:]}")
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return launches, good


def check_landmark_trainer(device) -> bool:
    """Phase 16 (b): the landmark-fallback trainer on the card."""
    import copy

    import numpy as np
    import torch

    from latentsync_tpu_torch.models.face_detection import FANLandmarkDetector
    from latentsync_tpu_torch.scripts import train_landmark_fallback as tl
    from latentsync_tpu_torch.utils.convert import load_state_dict_file

    # two steps from one model on the card and on the CPU
    images, lms = tl.render_dataset(72, seed=SEED)
    cpu = tl.LandmarkTrainer(images, lms, LANDMARK_STEPS, batch=4, seed=SEED, device="cpu")
    card = tl.LandmarkTrainer(images, lms, LANDMARK_STEPS, batch=4, seed=SEED, device=device,
                              model=copy.deepcopy(cpu.model))
    start = {k: v.detach().clone() for k, v in cpu.model.state_dict().items()}
    indices = [torch.tensor([64, 70, 66, 71]), torch.tensor([68, 65, 69, 67])]
    t0 = time.time()
    with no_tf32():
        losses = [(float(cpu.train_step(i)), float(card.train_step(i))) for i in indices]
    pair_s = time.time() - t0
    got = {k: v.detach().cpu() for k, v in card.model.state_dict().items()}
    want = cpu.model.state_dict()

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))

    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    weights = [k for k in want if k not in stats and k not in LANDMARK_BN_FED
               and not k.endswith("num_batches_tracked")]
    loss_diff = max(abs(a - b) / abs(a) for a, b in losses)
    stat_rel = rel(torch.cat([got[k].flatten() for k in stats]),
                   torch.cat([want[k].flatten() for k in stats]))
    update_rel = rel(torch.cat([(got[k] - start[k]).flatten() for k in weights]),
                     torch.cat([(want[k] - start[k]).flatten() for k in weights]))
    pair = loss_diff <= LANDMARK_TOL and stat_rel <= LANDMARK_TOL and update_rel <= LANDMARK_TOL
    del cpu, card
    log(f"[{gpu_line()}] landmark trainer, two steps card (f32, TF32 off) vs CPU from one "
        f"model (batch 4): losses {[(round(a, 6), round(b, 6)) for a, b in losses]}, loss rel. "
        f"difference {loss_diff:.3g}, running statistics rel L2 {stat_rel:.3g}, second step's "
        f"update rel L2 {update_rel:.3g} (tol {LANDMARK_TOL}; {pair_s:.1f} s) "
        f"{'ok' if pair else 'FAIL'}")

    with tempfile.TemporaryDirectory() as root:
        out = os.path.join(root, "landmark_fallback.npz")
        rc, stdout, err, wall = run_main("train_landmark_fallback", [
            "--steps", str(LANDMARK_STEPS), "--dataset", str(LANDMARK_FACES), "--eval-every",
            "50", "--seed", str(SEED), "--out", out])
        lines = _json_records(stdout)
        steps = [x for x in lines if "loss" in x]
        ran = rc == 0 and len(steps) == LANDMARK_STEPS // 50 and os.path.isfile(out)
        falls = ran and min(x["loss"] for x in steps[-2:]) < steps[0]["loss"]
        loaded = False
        det_nme = math.nan
        if ran:
            det = FANLandmarkDetector(load_state_dict_file(out), device=device)
            faces, truth = tl.render_dataset(8, seed=SEED + 1)
            found = det.landmarks(faces)
            loaded = found.shape == (8, 68, 2) and bool(np.isfinite(found).all())
            det_nme = float(tl.nme(torch.from_numpy(found), torch.from_numpy(truth)))
        for x in lines:
            log(f"  train_landmark_fallback: {json.dumps(x)}")
        secs = steps[-1]["s"] if steps else math.nan
        good = pair and ran and falls and loaded
        log(f"[{gpu_line()}] train_landmark_fallback (1 x 128, batch 16, {LANDMARK_STEPS} steps "
            f"on {LANDMARK_FACES} faces, in process): exit {rc}, {wall:.1f} s, "
            f"{LANDMARK_STEPS / secs:.1f} steps/s in the loop, loss {steps[0]['loss'] if steps else None} -> "
            f"{steps[-1]['loss'] if steps else None} (falls {falls}), final eval NME "
            f"{steps[-1]['eval_nme'] if steps else None}; the asset through FANLandmarkDetector: "
            f"{loaded}, NME {det_nme:.4f} on 8 new faces {'ok' if good else 'FAIL: ' + err[-3000:]}")
    return good


def check_cv_ops(device) -> bool:
    """Phase 16 (c): DCNv2 and upfirdn2d on the card against their CPU runs."""
    import torch

    from latentsync_tpu_torch.ops import deform_conv as dc
    from latentsync_tpu_torch.ops import upfirdn as uf

    g = torch.Generator().manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    x = randn(2, 64, 48, 48)
    w = randn(64, 64, 3, 3, scale=0.05)
    fir = randn(4, 4)
    cases = [
        ("modulated_deform_conv2d (2, 64, 48², offsets to ±3 px)", dc.modulated_deform_conv2d,
         (x, randn(2, 18, 48, 48, scale=1.5), torch.rand(2, 9, 48, 48, generator=g), w,
          randn(64))),
        ("dcn_v2_pack (2, 64, 48²)", dc.dcn_v2_pack,
         (x, randn(27, 64, 3, 3, scale=0.02), randn(27), w, randn(64))),
        ("upfirdn2d up 2 (4, 32, 64²)", lambda a, k: uf.upfirdn2d(a, k, 2, 1, (2, 1)),
         (randn(4, 32, 64, 64), fir)),
        ("upfirdn2d down 2 (4, 32, 64²)", lambda a, k: uf.upfirdn2d(a, k, 1, 2, (1, 1)),
         (randn(4, 32, 64, 64), fir)),
        ("upsample2d (4, 32, 64²)", uf.upsample2d, (randn(4, 32, 64, 64),)),
        ("downsample2d (4, 32, 64²)", uf.downsample2d, (randn(4, 32, 64, 64),)),
        ("fused_leaky_relu (4, 32, 64²)", uf.fused_leaky_relu, (randn(4, 32, 64, 64), randn(32))),
    ]
    ok = True
    with no_tf32():
        for name, fn, args in cases:
            want = fn(*args)
            dev = [a.to(device) if isinstance(a, torch.Tensor) else a for a in args]
            got = fn(*dev)
            err = float((got.cpu().double() - want.double()).norm()
                        / want.double().norm().clamp_min(1e-30))
            ms = cuda_ms(lambda: fn(*dev), warmup=1, iters=5)
            good = tuple(got.shape) == tuple(want.shape) and err <= CV_TOL
            ok &= good
            log(f"[{gpu_line()}] {name}: card vs CPU rel L2 {err:.3g} (tol {CV_TOL}), "
                f"{ms:.3f} ms on the card {'ok' if good else 'FAIL'}")
    return ok


def run_probes(pipeline, device) -> bool:
    """Phase 16 (d): perf_probe on phase 4's pipeline and transport_probe,
    in process, every line printed."""
    from latentsync_tpu_torch.scripts import perf_probe, transport_probe

    t0 = time.time()
    with configured("default"):
        report = perf_probe.probe(windows=2, rounds=3, pipe=pipeline,
                                  emit=lambda line: log(f"  perf_probe: {line}"))
    check = report["flops_check"]
    shares = [r["share_of_bf16_peak"] for k, r in report.items() if k != "flops_check"]
    good = abs(check["ratio"] - 1.0) <= 1e-3 and all(0 < v < 1 for v in shares)
    log(f"[{gpu_line()}] perf_probe (windows 2, best of 3; {time.time() - t0:.1f} s): FLOP "
        f"counter / op_tally {check['ratio']:.6f}, shares of the bf16 peak "
        f"{ {k: round(r['share_of_bf16_peak'], 4) for k, r in report.items() if k != 'flops_check'} } "
        f"{'ok' if good else 'FAIL'}")
    t0 = time.time()
    rows = transport_probe.probe(device, emit=lambda line: log(f"  transport_probe: {line}"))
    ran = sum("xfer_mb" in r for r in rows) == 8 and any(
        r.get("stage") == "decode_fetch_64x256" for r in rows)
    log(f"[{gpu_line()}] transport_probe ({time.time() - t0:.1f} s) {'ok' if ran else 'FAIL'}")
    return good and ran


# ---------------------------------------------------------------------------
# phase 17: the last pieces: the cog Predictor and the Wav2Lip SyncNet
# ---------------------------------------------------------------------------

# a regenerated pixel: |output - input| above this many uint8 levels (the mp4v
# round trip of the synthetic head stays well below it), and the share of the
# first clip's pixels that must be regenerated (the mouth region is ~5 %)
REGEN_LEVELS = 40
REGEN_SHARE_MIN = 0.005
WAV2LIP_BATCH_CPU = 4
WAV2LIP_BATCH_BF16 = 32
# the bf16 forward's embeddings against the f32 forward's on the card, relative
# L2 (bf16 rounds each of 20 convolutions' inputs: ~1e-2 expected)
WAV2LIP_BF16_TOL = 0.1


def run_predictor(root: str, pipeline, counters) -> bool:
    """Phase 17 (a): ``predict.Predictor`` as cog drives it, ``setup()`` then
    ``predict()``, on a 1.2 s synthetic talking clip without a bundle (the
    FAN face path on the card), at full width (LatentSync 1.5 stage 2, 20
    DDIM steps, CFG 1.5, bf16): ``build_pipeline`` answers with phase 4's
    pipeline. The output has the input's frames padded to whole 16-frame
    windows (the audio's 1.2 s give 32: the frames past the clip wrap around,
    as every render does), its ``.wav`` sidecar, regenerated faces, and the
    render launched the default configuration's kernels, each of them, and
    no other."""
    import shutil

    import numpy as np
    import torch

    from latentsync_tpu_torch.predict import Predictor
    from latentsync_tpu_torch.utils.media import have_ffmpeg, read_audio, read_video

    video, _ = _eval_clip(root, "predict", 1.2)
    audio = video[:-4] + ".wav"
    src = read_video(video, change_fps=False)
    recorder = _PerRender(pipeline, counters)
    with _serving(recorder), configured("default"):
        for fn in counters:
            fn.launches = 0
        t0 = time.time()
        predictor = Predictor()
        predictor.setup()
        out = predictor.predict(video, audio)
        torch.cuda.synchronize()
        wall = time.time() - t0
    try:
        got = read_video(out, change_fps=False)
        # the audio is muxed where there is ffmpeg, else the .wav sidecar
        sidecar = out if have_ffmpeg() else out[:-4] + ".wav"
        sound = read_audio(sidecar) if os.path.isfile(sidecar) else np.zeros(0, np.float32)
    finally:
        shutil.rmtree(os.path.dirname(out), ignore_errors=True)
    windows = -(-len(src) // 16) * 16
    n = min(len(src), len(got))
    share = float((np.abs(got[:n].astype(np.int16) - src[:n].astype(np.int16))
                   > REGEN_LEVELS).mean()) if n else 0.0
    good = predictor.pipeline is recorder and len(recorder.renders) == 1 \
        and len(got) == windows and got.shape[1:] == src.shape[1:] \
        and int(1.2 * 16000) <= len(sound) <= int(windows / 25 * 16000) \
        and share >= REGEN_SHARE_MIN
    log(f"[{gpu_line()}] Predictor.setup() + predict() on {len(src)} frames of "
        f"{src.shape[1]}² and 1.2 s of audio (no bundle): {wall:.1f} s wall; {len(got)} frames "
        f"out (want {windows}), audio {len(sound)} samples ({os.path.basename(sidecar)}), {share * 100:.2f} % of pixels "
        f"regenerated (> {REGEN_LEVELS} levels; min {REGEN_SHARE_MIN * 100:.1f} %) "
        f"{'ok' if good else 'FAIL'}")
    renders = recorder.renders or [{fn.__name__: fn.launches for fn in counters}]
    return _counted(renders[0], ON_PATH["default"], "Predictor.predict, default "
                    "configuration") and good


def check_wav2lip_syncnet(device) -> bool:
    """Phase 17 (b): ``Wav2LipSyncNet`` at its real geometry (faces (B, 15,
    128, 256), mel (B, 1, 80, 16); seeded random weights and batch-norm
    statistics): f32 with TF32 off at batch WAV2LIP_BATCH_CPU on the card
    against the CPU (both embeddings within EVAL_TOL in relative L2), then a
    bf16 forward at batch WAV2LIP_BATCH_BF16 (the convolutions' weights in
    bf16, the batch norms in f32, as the JAX module's ``dtype``): its median
    ms over 10 calls by CUDA events beside the bound, and its distance from
    the f32 forward on the card."""
    import torch

    from latentsync_tpu_torch.models.syncnet import Wav2LipSyncNet
    from latentsync_tpu_torch.utils.convert import init_random_bn_

    cpu_model = init_random_bn_(Wav2LipSyncNet(), seed=SEED).eval()
    card = init_random_bn_(Wav2LipSyncNet(), seed=SEED).eval().to(device)
    g = torch.Generator().manual_seed(SEED)
    faces = torch.randn(WAV2LIP_BATCH_BF16, 15, 128, 256, generator=g)
    mel = torch.randn(WAV2LIP_BATCH_BF16, 1, 80, 16, generator=g)
    b = WAV2LIP_BATCH_CPU
    with torch.no_grad():
        t0 = time.time()
        c_vis, c_aud = cpu_model(faces[:b], mel[:b])
        cpu_s = time.time() - t0
        with no_tf32():
            g_vis, g_aud = card(faces[:b].to(device), mel[:b].to(device))
            f32_all = card(faces.to(device), mel.to(device))
    errs = {"wav2lip_vis": _rel_l2(g_vis.cpu(), c_vis), "wav2lip_aud": _rel_l2(g_aud.cpu(), c_aud)}
    good = all(errs[k] <= EVAL_TOL[k] for k in errs) and g_vis.shape == (b, 1024) \
        and g_aud.shape == (b, 1024) and bool(torch.isfinite(g_vis).all())

    for m in card.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.to(torch.bfloat16)
    x = (faces.to(device, torch.bfloat16), mel.to(device, torch.bfloat16))
    times = []
    with torch.no_grad():
        bf16 = card(*x)
        for _ in range(10):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            card(*x)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    med = sorted(times)[len(times) // 2]
    dist = [_rel_l2(o, r) for o, r in zip(bf16, f32_all)]
    good &= all(torch.isfinite(o).all() for o in bf16) and max(dist) <= WAV2LIP_BF16_TOL
    flops = WAV2LIP_BATCH_BF16 * 2 * sum(
        m.weight.numel() * out_hw for m, out_hw in _conv_output_sizes(card, x))
    log(f"[{gpu_line()}] Wav2LipSyncNet (65.2 M parameters): card vs CPU (f32, TF32 off, batch "
        f"{b}) rel L2 visual {errs['wav2lip_vis']:.3g} audio {errs['wav2lip_aud']:.3g} (tols "
        f"{EVAL_TOL['wav2lip_vis']}, {EVAL_TOL['wav2lip_aud']}; CPU forward {cpu_s:.2f} s); "
        f"bf16 batch {WAV2LIP_BATCH_BF16}: median {med:.3f} ms of 10 (CUDA events), "
        f"{flops / 1e9:.1f} GFLOP, bound {flops / PEAK_OPS['bf16'] * 1e3:.3f} ms (operations), "
        f"{flops / (med * 1e-3) / 1e12:.1f} TFLOP/s; rel L2 from f32 visual {dist[0]:.3g} audio "
        f"{dist[1]:.3g} (tol {WAV2LIP_BF16_TOL}) {'ok' if good else 'FAIL'}")
    return good


def _conv_output_sizes(model, inputs):
    """(convolution, output H·W) of each convolution of one forward of `model`
    on one sample of `inputs`."""
    import torch

    sizes, hooks = [], []
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            hooks.append(m.register_forward_hook(
                lambda mod, _, out: sizes.append((mod, out.shape[-2] * out.shape[-1]))))
    try:
        with torch.no_grad():
            model(*(t[:1] for t in inputs))
    finally:
        for h in hooks:
            h.remove()
    return sizes


def check_last_pieces(pipeline, device, counters) -> bool:
    """Phase 17, sub-phase by sub-phase with its wall time."""
    ok = True
    with tempfile.TemporaryDirectory() as root:
        for label, fn in (("(a) the cog Predictor", lambda: run_predictor(root, pipeline,
                                                                         counters)),
                          ("(b) Wav2LipSyncNet", lambda: check_wav2lip_syncnet(device))):
            t0 = time.time()
            good = bool(fn())
            ok &= good
            log(f"phase 17 {label}: {time.time() - t0:.1f} s {'ok' if good else 'FAIL'}")
    return ok


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    try:
        from latentsync_tpu_torch.config import LatentSyncConfig
        from latentsync_tpu_torch.ops import _build, attention, attn_block, ffn, qconv, qmm
        from latentsync_tpu_torch.ops import groupnorm as gn
        from latentsync_tpu_torch.ops import temporal_attention as ta
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the repository root",
              file=sys.stderr)
        return 2

    device = torch.device("cuda", 0)
    log(gpu_line())
    log(f"SM clocks (highest, now): {gpu_query('clocks.max.sm,clocks.sm')}; "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.time()
    so = _build.build()
    _build.lib()
    log(f"phase 1: built {so.name} in {time.time() - t0:.1f}s")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # the int8 convolution route (conv_acc, torch._int_mm) is counted
    # beside the kernels, though it is no kernel of this repository
    counters = [ffn.geglu_ffn, attn_block.self_attention_block, ta.temporal_attention,
                ta.spatial_attention, attention.dot_product_attention,
                attn_block.cross_attention_block, gn.group_norm_silu,
                gn.group_norm_silu_streaming, qmm.quantized_matmul, qconv.conv_acc,
                ffn.qkv_proj, ffn.geglu_ffn_int8io, attention.oneshot_attention,
                attention.flash_attention, attention.flash_attention_bwd]
    ok = True
    phase = "kernels"
    try:
        kernels, good = check_kernels(device)
        ok &= good
        log(f"phase 2 (kernels vs plain versions): {'ok' if good else 'FAIL'}")
        phase = "int8 convolution"
        good = check_int8_conv(device)
        ok &= good
        log(f"phase 2 (int8 convolution route vs plain version): {'ok' if good else 'FAIL'}")
        phase = "flash backward"
        bwd_entry, good = check_flash_backward(device)
        ok &= good
        log(f"phase 2 (the flash route's backward kernels vs their plain version): "
            f"{'ok' if good else 'FAIL'}")

        phase = "unet"
        from latentsync_tpu_torch.audio.features import Audio2Feature
        from latentsync_tpu_torch.models.unet3d import UNet3DConditionModel
        from latentsync_tpu_torch.models.vae import AutoencoderKL
        from latentsync_tpu_torch.models.whisper import WhisperEncoder
        from latentsync_tpu_torch.pipelines.lipsync import LipsyncPipeline
        from latentsync_tpu_torch.utils.convert import init_random_

        cfg = LatentSyncConfig()
        t0 = time.time()
        unet = init_random_(UNet3DConditionModel(cfg.unet), seed=SEED).to(device, torch.bfloat16)
        vae = init_random_(AutoencoderKL(cfg.vae), seed=SEED + 2).to(device, torch.bfloat16)
        whisper = init_random_(WhisperEncoder(cfg.whisper), seed=SEED + 3).to(device)
        n_params = sum(p.numel() for p in unet.parameters())
        log(f"models: unet {n_params / 1e6:.1f}M params, init {time.time() - t0:.1f}s")
        good = check_unet(unet.eval(), device)
        good &= time_forwards(unet, device)
        good &= check_unet_frames(unet, device)
        ok &= good
        log(f"phase 3 (full-width UNet, four configurations; F = 24): "
            f"{'ok' if good else 'FAIL'}")

        phase = "serving"
        pipeline = LipsyncPipeline(unet, vae, Audio2Feature(whisper), cfg,
                                   dtype=torch.bfloat16, device=device)
        good = check_finish_fetch(pipeline, device)
        ok &= good
        launches = {}
        with tempfile.TemporaryDirectory() as root:
            audios = make_avatar(root)
            # 1.2 s of audio → 31 frames → 2 windows of 16; 2.4 s → 4 windows
            short, long_ = ("1.2s", 32), ("2.4s", 64)
            for number, conf, plan in ((4, "default", [short, long_, short]),
                                       (5, "fused", [short, long_]),
                                       (6, "int8", [short, long_]),
                                       (6, "int8-dense", [short, long_])):
                phase = f"serving ({conf})"
                torch.cuda.reset_peak_memory_stats()
                launches[conf], good = serve_requests(pipeline, root, audios, plan, counters,
                                                      conf)
                ok &= good
                log(f"phase {number} (served path, {conf} configuration, peak device memory "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB): "
                    f"{'ok' if good else 'FAIL'}")
        phase = "probe"
        probe_launches, good = run_probe(device, counters)
        ok &= good
        log(f"phase 7 (kernel probe at full width: ffn, ffn8, spat, attn; K12's entry point): "
            f"{'ok' if good else 'FAIL'}")
        phase = "onboarding"
        good = check_onboarding(pipeline, vae, device, counters)
        ok &= good
        log(f"phase 8 (onboarding with the FAN face path on the card; a request without a "
            f"bundle and one from the new bundle): {'ok' if good else 'FAIL'}")
        phase = "production point"
        good = check_deepcache(unet, device, counters)
        good &= run_dcread(unet, device)
        good &= time_denoise(pipeline, device, counters)
        with tempfile.TemporaryDirectory() as root:
            audios = make_avatar(root)
            _, served = serve_production(pipeline, root, counters)
            good &= served
            good &= check_pipelined(pipeline, root, audios)
            good &= run_cli(root, audios)
        ok &= good
        log(f"phase 9 (the production serving point: DeepCache paths, dcread, a window batch's "
            f"denoise, three requests continuous-batched at int8 + 4:1:enc + 0:0.5, "
            f"run_pipelined, the inference CLI): {'ok' if good else 'FAIL'}")
        phase = "restore, transcription and the worker"
        t0 = time.time()
        good = check_transport(device)
        good &= check_device_restore(device)
        with tempfile.TemporaryDirectory() as root:
            audios = make_avatar(root)
            good &= serve_both_routes(pipeline, root, audios)
            transcribed, transcriber = check_transcription(device, root)
            good &= transcribed
            good &= run_worker(pipeline, root, audios, transcriber)
        ok &= good
        log(f"phase 10 (device restore against its CPU run, one request on both restore routes, "
            f"whisper-tiny transcription on the card, the job-queue worker; {time.time() - t0:.0f}"
            f" s): {'ok' if good else 'FAIL'}")
        phase = "training"
        t0 = time.time()
        good = check_function_grads(device)
        train_launches, trained = check_train_step(unet, vae, device, counters)
        good &= trained
        train_root = tempfile.TemporaryDirectory()  # phase 14 (c) resumes this run
        good &= run_train_cli(train_root.name)
        ok &= good
        log(f"phase 11 (stage-2 training on the card: the kernels' "
            f"gradients, a full-width loss and backward against the plain versions, the "
            f"training CLI for 4 steps (phase 14 resumes it); {time.time() - t0:.0f} s): "
            f"{'ok' if good else 'FAIL'}")
        phase = "face restoration"
        t0 = time.time()
        restore_launches, good = check_codeformer(device, counters)
        good &= check_restoration_nets(device)
        with tempfile.TemporaryDirectory() as root:
            good &= run_restoration_clis(root)
        ok &= good
        log(f"phase 12 (face restoration: full-width CodeFormer at 1 and 4 faces against its "
            f"f32 plain run, the VQGAN autoencoder, the detectors, parsers and upsampler net "
            f"against the CPU, the restoration CLIs; {time.time() - t0:.0f} s): "
            f"{'ok' if good else 'FAIL'}")
        phase = "restoration training"
        t0 = time.time()
        with tempfile.TemporaryDirectory() as root:
            faces = os.path.join(root, "faces")
            os.makedirs(faces)
            _write_faces(faces, 4, (512, 512))
            train_launches13, good = train_stages(faces, counters)
            good &= check_stage2_against_cpu(faces, device)
            good &= run_restoration_train_clis(root, faces)
        ok &= good
        log(f"phase 13 (restoration training at full width: three stages, the flash backward "
            f"at D = 64 nine times a step, stage II card against CPU, train_restoration and "
            f"generate_latent_gt; {time.time() - t0:.0f} s): {'ok' if good else 'FAIL'}")
        phase = "the rest of training"
        t0 = time.time()
        grad_launches, good = check_train_grads(device)
        train14, trained = check_train_configs(unet, vae, device, counters)
        good &= trained
        good &= run_train_cli_ddp(train_root.name)
        train_root.cleanup()
        with tempfile.TemporaryDirectory() as root:
            syncnet_launches, trained = check_syncnet_training(root, device, counters)
            good &= trained
        ok &= good
        log(f"phase 14 (the rest of training: K5, K8, K9 and the int8 routes' gradients, "
            f"full-width steps in the fused, int8 and int8-dense configurations against the "
            f"plain versions, train_unet under torch.distributed.run with its resume, the "
            f"SyncNet trainer at full width and its two CLIs; {time.time() - t0:.0f} s): "
            f"{'ok' if good else 'FAIL'}")
        phase = "evaluation and data preparation"
        t0 = time.time()
        good = check_evaluation(pipeline, unet, vae, device, counters)
        ok &= good
        log(f"phase 15 (evaluation and data preparation: the SyncNet scorer, HyperIQA and I3D "
            f"against the CPU, eval_fvd, the eight-stage pipeline and eval_sync_conf, "
            f"validate_fidelity, inference_videos and the trainer's validation at full width; "
            f"{time.time() - t0:.0f} s): {'ok' if good else 'FAIL'}")
        phase = "the last modules"
        t0 = time.time()
        parts = []
        for label, fn in (("(a) serving across cards", lambda: check_mesh_serving(device)),
                          ("(b) the landmark trainer", lambda: check_landmark_trainer(device)),
                          ("(c) DCNv2 and upfirdn2d", lambda: check_cv_ops(device)),
                          ("(d) perf_probe and transport_probe",
                           lambda: run_probes(pipeline, device))):
            t1 = time.time()
            result = fn()
            if label.startswith("(a)"):
                mesh_launches, result = result
            good = bool(result)
            parts.append(good)
            log(f"phase 16 {label}: {time.time() - t1:.1f} s {'ok' if good else 'FAIL'}")
        ok &= all(parts)
        log(f"phase 16 (the last modules: mesh serving over every card, the landmark "
            f"trainer, DCNv2 and upfirdn2d against the CPU, perf_probe and transport_probe; "
            f"{time.time() - t0:.0f} s): {'ok' if all(parts) else 'FAIL'}")
        phase = "the last pieces"
        t0 = time.time()
        good = check_last_pieces(pipeline, device, counters)
        ok &= good
        log(f"phase 17 (the last pieces: the cog Predictor at full width without a bundle, "
            f"Wav2LipSyncNet card against CPU and in bf16; {time.time() - t0:.0f} s): "
            f"{'ok' if good else 'FAIL'}")
        train_paths = {"cross_attention_block": "fused", "quantized_matmul": "int8-dense"}
        for k in kernels:
            if k["name"] in train_paths:
                k["train_launches"] = train14[train_paths[k["name"]]][k["name"]]
                k["train_path"] = train_paths[k["name"]]
            elif k["name"] == "qkv_proj":
                # no trainer calls K9: its launches under grad are phase 14 (a)'s
                k["train_launches"] = 0
                k["grad_check_launches"] = grad_launches.get("qkv_proj", 0)
            if k["name"] in syncnet_launches:
                k["syncnet_train_launches"] = syncnet_launches[k["name"]]
        for k in kernels:
            conf = next((c for c in MESH_ON_PATH if k["name"] in MESH_ON_PATH[c]), None)
            if conf and k.get("path") != "codeformer":
                k["mesh_launches"] = mesh_launches[conf].get(k["name"], 0)
                k["mesh_path"] = conf
        for k in kernels:
            if k.get("path") == "codeformer":
                k["launches"] = restore_launches
                k["restoration_train_launches"] = train_launches13.get("dot_product_attention", 0)
                continue
            if k["name"] in PROBE_PATH:
                k["path"], k["launches"] = PROBE_PATH[k["name"]], probe_launches[k["name"]]
                continue
            k["path"] = next(conf for conf in CONFIGS if k["name"] in ON_PATH[conf])
            k["launches"] = launches[k["path"]][k["name"]]
        bwd_entry["path"] = "train"
        bwd_entry["launches"] = train_launches["flash_attention_bwd"]
        bwd_entry["restoration_train_launches"] = train_launches13.get("flash_attention_bwd", 0)
        kernels.append(bwd_entry)
    except Exception:  # noqa: BLE001 — report the phase, then fail
        traceback.print_exc()
        print(f"chip_smoke: phase {phase} raised", file=sys.stderr)
        return 1
    if not ok:
        print("chip_smoke: a check failed (see FAIL above)", file=sys.stderr)
        return 1
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
