"""The Replicate cog predictor (ref:predict.py, web-demos/replicate/): the
pipeline behind ``setup()`` / ``predict()``.

Counterpart of the top-level ``predict.py``, with the same argument names
and defaults, plus `device`::

    from latentsync_tpu_torch.predict import Predictor

    p = Predictor()
    p.setup(unet_config="configs/unet_stage2.yaml")  # device="cpu" off the card
    out_mp4 = p.predict("face.mp4", "speech.wav")

``setup`` builds the pipeline as ``scripts/inference.build_pipeline`` does
(a checkpoint file that is missing leaves its model with seeded random
weights); on the card unless asked for the CPU, and it raises where the card
is asked for and there is none. ``predict`` runs one clip through the whole
path (the face path, whisper, the VAE and the UNet) into a fresh temporary
directory and returns the written video's path (with its ``.wav`` sidecar
where there is no ffmpeg).
"""

from __future__ import annotations

import argparse
import os
import tempfile


class Predictor:
    def setup(self, unet_ckpt: str = "checkpoints/latentsync_unet.pt",
              vae_ckpt: str = "checkpoints/sd-vae-ft-mse.pt",
              whisper_ckpt: str = "checkpoints/whisper/tiny.pt",
              unet_config: str = "", device: str = "cuda"):
        from .scripts import inference

        message = inference.no_card_message("Predictor.setup", device)
        if message:
            raise RuntimeError(message)
        args = argparse.Namespace(unet_config=unet_config, unet_ckpt=unet_ckpt,
                                  vae_ckpt=vae_ckpt, whisper_ckpt=whisper_ckpt, device=device)
        self.pipeline = inference.build_pipeline(args)

    def predict(self, video: str, audio: str, guidance_scale: float = 1.5,
                inference_steps: int = 20, seed: int = 1247) -> str:
        out = os.path.join(tempfile.mkdtemp(), "out.mp4")
        result = self.pipeline(video_path=video, audio_path=audio, video_out_path=out,
                               guidance_scale=guidance_scale,
                               num_inference_steps=inference_steps, seed=seed)
        return result.video_path
