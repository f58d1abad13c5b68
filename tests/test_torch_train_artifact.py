"""``latentsync_tpu_torch/scripts/train_artifact.py`` at the tiny configs of
``tests/test_torch_train_cli.py`` (the UNet's of ``test_torch_train_data``'s
``_tiny_yaml`` and its ``_syncnet_yaml``; the full loss stack at the script's
own small config), on the CPU: every check of the script holds (a step
checkpoint, the resume, two scored validation renders that differ, the
UNet's and SyncNet's losses falling, the overfit run's loss below 0.5 and
below half its first value, finite loss components, SyncNet's checkpoint,
resume and live gradients, and its data-parallel run under
``torch.distributed.run`` on two gloo ranks). The overfit run here takes
twice the script's lr for a third of its steps on 8² latents.
"""

import json

import yaml

from latentsync_tpu_torch.scripts import train_artifact

from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_cli import _syncnet_yaml
from test_torch_train_data import _tiny_yaml

OVERFIT_LR, OVERFIT_STEPS = 4e-3, 16


def test_train_artifact_at_tiny_configs(tmp_path):
    files = str(tmp_path / "work" / "data" / "files.txt")
    unet = yaml.safe_load(open(_tiny_yaml(str(tmp_path), files)))
    val = tmp_path / "work" / "val" / "clip_0"
    unet["data"].update(batch_size=2, val_video_path=f"{val}.mp4", val_audio_path=f"{val}.wav")
    unet["run"].update(save_ckpt_steps=2, inference_steps=2, use_syncnet=False,
                       pixel_space_supervise=False,
                       trainable_modules=["motion_modules.", "attentions.", "conv_out"])
    overfit = {**unet, "vae": dict(unet["vae"], block_out_channels=[16, 32, 32]),
               "data": dict(unet["data"], val_video_path="", val_audio_path=""),
               "run": dict(unet["run"], save_ckpt_steps=100000, trainable_modules=[], lr=OVERFIT_LR,
                           use_mixed_noise=False)}
    syncnet = yaml.safe_load(open(_syncnet_yaml(str(tmp_path), files, val=files)))
    report, ok = train_artifact.run(
        str(tmp_path / "work"), "cpu", steps=4, resume_steps=1, overfit_steps=OVERFIT_STEPS,
        fullstack_steps=1, dp_ranks=2, log_every=1, val_frames=12,
        trees={"unet": unet, "overfit": overfit, "syncnet": syncnet})
    assert ok, json.dumps(report["checks"]) + json.dumps(report["unet_overfit"]["loss"])
    assert report["unet"]["checkpoints"] and len(report["unet"]["validations"]) == 2
    assert report["data_parallel"]["exit"] == 0
