"""The port's command-line entry points against the JAX package's, on the CPU.

``build_pipeline`` reads the checkpoint files the JAX package's CLI reads,
written here in their upstream layouts from the JAX package's random
weights (``fast_init``): the LatentSync UNet ``.pt`` with its ``state_dict``
wrapper and without (positional-encoding tables included, as upstream
files carry them), the diffusers VAE ``.pt`` under both spellings of its
mid-block attention (the legacy one with 1x1-convolution weights) and
OpenAI's whisper ``.pt`` (``dims`` + ``model_state_dict``, decoder keys
included). The pipeline it builds holds exactly those weights, and its
UNet computes the eps of the pipeline the JAX CLI builds from the same
files, within the model tolerance of ``tests/test_torch_models.py``.
``--fast`` sets the switches as ``scripts/validate_fidelity._set_fast_env``
does. ``inference.main`` runs a clip end to end on a tiny ``--unet-config``
with ``--device cpu``; ``api.main`` serves ``/ping`` in a process of its
own; both exit nonzero without a card by default.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.config import load_unet_config as j_load_unet_config
from latentsync_tpu.models.unet3d import UNet3DConditionModel as JUNet
from latentsync_tpu.models.vae import AutoencoderKL as JVAE
from latentsync_tpu.models.whisper import WhisperEncoder as JWhisper
from latentsync_tpu.utils.params import fast_init
from latentsync_tpu_torch.scripts import api as papi
from latentsync_tpu_torch.scripts import inference as pinf
from latentsync_tpu_torch.utils.convert import (unet_state_dict_from_flax,
                                                vae_state_dict_from_flax,
                                                whisper_state_dict_from_flax)
from latentsync_tpu_torch.utils.media import StreamingVideoWriter, read_video, write_audio

from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the model tolerance of tests/test_torch_models.py, relative to max(1, max|eps|)
ATOL, RTOL = 2e-4, 1e-4
RES, CROP_AT, FRAME_HW, N_FRAMES = 64, 16, 96, 20

TINY_YAML = """\
model:
  block_out_channels: [32, 64, 64, 64]
  layers_per_block: 1
  norm_num_groups: 8
  cross_attention_dim: 16
  attention_head_dim: 4
  motion_module_kwargs:
    num_attention_heads: 4
    num_transformer_block: 1
data:
  num_frames: 16
  resolution: 64
vae:
  block_out_channels: [8, 16, 16, 16]
  layers_per_block: 1
  norm_num_groups: 4
"""


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Upstream-layout checkpoint files of the JAX package's random weights,
    and the state dicts the port must load from them."""
    root = tmp_path_factory.mktemp("ckpt")
    (root / "tiny.yaml").write_text(TINY_YAML)
    cfg = j_load_unet_config(str(root / "tiny.yaml"))
    lat, f = RES // cfg.vae.scale_factor, cfg.data.num_frames
    unet = fast_init(lambda s, t, a: JUNet(cfg.unet).init(jax.random.PRNGKey(0), s, t, a),
                     jnp.zeros((1, f, lat, lat, 13)), jnp.zeros((1,), jnp.int32),
                     jnp.zeros((1, f, 50, 16)), seed=5, scale=0.05)
    vae = fast_init(lambda x: JVAE(cfg.vae).init(jax.random.PRNGKey(0), x, jax.random.PRNGKey(1)),
                    jnp.zeros((1, RES, RES, 3)), seed=6, scale=0.05)
    wcfg = type(cfg.whisper)(n_audio_state=16, n_audio_head=2, n_audio_layer=1)
    whisper = fast_init(lambda m: JWhisper(wcfg).init(jax.random.PRNGKey(0), m),
                        jnp.zeros((1, 80, 3000)), seed=7, scale=0.05)
    unet_sd = unet_state_dict_from_flax(_np_tree(unet))
    vae_sd = vae_state_dict_from_flax(_np_tree(vae))
    whisper_sd = whisper_state_dict_from_flax(_np_tree(whisper))

    upstream = dict(unet_sd)
    pe_key = ("down_blocks.0.motion_modules.0.temporal_transformer.transformer_blocks.0."
              "attention_blocks.0.pos_encoder.pe")
    upstream[pe_key] = torch.zeros(1, 24, 32)
    torch.save({"global_step": 5, "state_dict": upstream}, root / "unet_wrapped.pt")
    torch.save(upstream, root / "unet_bare.pt")
    torch.save(vae_sd, root / "vae.pt")
    legacy = {}
    for k, v in vae_sd.items():
        for new, old in (("to_q", "query"), ("to_k", "key"), ("to_v", "value"),
                         ("to_out.0", "proj_attn")):
            if f".attentions.0.{new}." in k:
                k = k.replace(f".attentions.0.{new}.", f".attentions.0.{old}.")
                v = v[:, :, None, None] if v.dim() == 2 else v
        legacy[k] = v
    torch.save(legacy, root / "vae_legacy.pt")
    model_sd = {"encoder." + k: v for k, v in whisper_sd.items()}
    model_sd["encoder.positional_embedding"] = torch.zeros(1500, 16)
    model_sd["decoder.token_embedding.weight"] = torch.zeros(8, 16)
    torch.save({"dims": {"n_mels": 80, "n_audio_ctx": 1500, "n_audio_state": 16,
                         "n_audio_head": 2, "n_audio_layer": 1},
                "model_state_dict": model_sd}, root / "tiny.pt")
    return root, unet_sd, vae_sd, whisper_sd


def _args(root, unet="unet_wrapped.pt", vae="vae.pt", **kw):
    return types.SimpleNamespace(unet_config=str(root / "tiny.yaml"), unet_ckpt=str(root / unet),
                                 vae_ckpt=str(root / vae), whisper_ckpt=str(root / "tiny.pt"),
                                 device="cpu", **kw)


def _assert_state(module, want):
    got = module.state_dict()
    assert set(want) <= set(got)
    for k, v in want.items():
        assert torch.equal(got[k].float(), v.float()), k


@pytest.mark.parametrize("unet_file,vae_file", [("unet_wrapped.pt", "vae.pt"),
                                                ("unet_bare.pt", "vae_legacy.pt")])
def test_build_pipeline_loads_upstream_files(files, unet_file, vae_file):
    root, unet_sd, vae_sd, whisper_sd = files
    pipe = pinf.build_pipeline(_args(root, unet_file, vae_file))
    assert pipe.dtype == torch.float32 and pipe.device.type == "cpu"
    _assert_state(pipe.unet, unet_sd)
    _assert_state(pipe.vae, vae_sd)
    _assert_state(pipe.audio_encoder.model, whisper_sd)


def test_build_pipeline_eps_matches_the_jax_cli(files):
    """The port's and the JAX CLI's pipelines from the same files: the same eps."""
    from scripts.inference import build_pipeline as j_build_pipeline

    root = files[0]
    port = pinf.build_pipeline(_args(root))
    jpipe = j_build_pipeline(_args(root), dtype=jnp.float32)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 13, 16, 8, 8)).astype(np.float32)
    audio = rng.standard_normal((2, 16, 10, 16)).astype(np.float32)
    t = np.array([17, 503])
    with torch.no_grad():
        eps = port.unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(audio)).numpy()
    jargs = (jpipe.unet_params, jnp.asarray(x.transpose(0, 2, 3, 4, 1)), jnp.asarray(t),
             jnp.asarray(audio))
    # XLA's CPU backend at its lowest optimisation compiles in about half the time
    fast = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    apply = jax.jit(jpipe.unet.apply).lower(*jargs).compile(fast)
    ref = np.asarray(apply(*jargs)).transpose(0, 4, 1, 2, 3)
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(ref).max()) > 1e-2
    np.testing.assert_allclose(eps, ref, atol=ATOL * scale, rtol=RTOL)


def test_a_missing_file_means_seeded_random_weights(files):
    root = files[0]
    args = _args(root, "nothing.pt", "nothing.pt")
    args.whisper_ckpt = str(root / "nothing.pt")
    a, b = pinf.build_pipeline(args), pinf.build_pipeline(args)
    for m in ("unet", "vae"):
        sa, sb = getattr(a, m).state_dict(), getattr(b, m).state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
        assert all(bool(v.abs().sum() > 0) for k, v in sa.items() if v.is_floating_point())


SPECS = ["int8", "int8,deepcache=4:1:enc,cfg=0:0.5", "deepcache=2:1", " cfg=0.2:0.8 , int8",
         "deepcache=4:1:enc:2,cfg=0:0.5", ""]


@pytest.mark.parametrize("spec", SPECS)
def test_fast_spec_sets_the_switches_as_the_jax_cli(spec, monkeypatch):
    from scripts.validate_fidelity import _set_fast_env

    names = ("LATENTSYNC_INT8", "LATENTSYNC_DEEPCACHE", "LATENTSYNC_CFG_INTERVAL")
    for k in names:
        monkeypatch.setenv(k, "stale")
    _set_fast_env(spec)
    want = {k: os.environ[k] for k in names}
    for k in names:
        monkeypatch.setenv(k, "stale")
    pinf.set_fast_env(spec)
    assert {k: os.environ[k] for k in names} == want


def test_fast_bare_is_the_production_point_and_unknown_tokens_exit(monkeypatch):
    from scripts.validate_fidelity import _set_fast_env

    assert pinf.FAST_DEFAULT == "int8,deepcache=4:1:enc,cfg=0:0.5"
    for k in ("LATENTSYNC_INT8", "LATENTSYNC_DEEPCACHE", "LATENTSYNC_CFG_INTERVAL"):
        monkeypatch.setenv(k, "")
    with pytest.raises(SystemExit) as want:
        _set_fast_env("int8,turbo")
    with pytest.raises(SystemExit) as got:
        pinf.set_fast_env("int8,turbo")
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def avatar(files):
    root = files[0]
    yy, xx = np.mgrid[0:FRAME_HW, 0:FRAME_HW]
    frames = np.stack([np.stack([(128 + 100 * np.sin(xx / 9 + t / 3 + ch)).astype(np.uint8)
                                 for ch in range(3)], -1) for t in range(N_FRAMES)])
    writer = StreamingVideoWriter(str(root / "avatar.mp4"), fps=25,
                                  frame_hw=(FRAME_HW, FRAME_HW))
    writer.append(frames)
    writer.close()
    mat = np.array([[1.0, 0.0, -CROP_AT], [0.0, 1.0, -CROP_AT]])
    np.savez(root / "avatar.npz", faces=frames[:, CROP_AT:CROP_AT + RES, CROP_AT:CROP_AT + RES],
             boxes=np.tile([0, 0, RES, RES], (N_FRAMES, 1)),
             affine_matrices=np.repeat(mat[None], N_FRAMES, 0))
    rng = np.random.default_rng(0)
    write_audio(str(root / "speech.wav"),
                (0.3 * rng.standard_normal(int(16000 * 1.2))).astype(np.float32))
    return root


def test_inference_main_end_to_end_on_the_cpu(avatar, tmp_path, capsys, monkeypatch):
    root = avatar
    # set (not deleted) first, so that the switches --fast sets are undone after
    for k in ("LATENTSYNC_INT8", "LATENTSYNC_DEEPCACHE", "LATENTSYNC_CFG_INTERVAL"):
        monkeypatch.setenv(k, "")
    out = tmp_path / "out.mp4"
    rc = pinf.main(["--video", str(root / "avatar.mp4"), "--audio", str(root / "speech.wav"),
                    "--out", str(out), "--data-path", str(root / "avatar.npz"),
                    "--unet-config", str(root / "tiny.yaml"), "--unet-ckpt",
                    str(root / "unet_bare.pt"), "--vae-ckpt", str(root / "vae.pt"),
                    "--whisper-ckpt", str(root / "tiny.pt"), "--inference-steps", "2",
                    "--fast", "--device", "cpu"])
    assert rc == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["frames"] == 32 and set(record) == {"out", "frames", "timings"}
    assert read_video(record["out"], change_fps=False).shape == (32, FRAME_HW, FRAME_HW, 3)
    assert os.environ["LATENTSYNC_DEEPCACHE"] == "4:1:enc"  # --fast took effect


@pytest.mark.parametrize("main,argv", [
    (pinf.main, ["--video", "v.mp4", "--audio", "a.wav", "--out", "o.mp4"]),
    (papi.main, ["--avatars", "avatars"]),
])
def test_clis_default_to_the_card_and_exit_nonzero_without_one(monkeypatch, capsys, main, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(argv) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err and "--device cpu" in out.err


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_api_main_answers_ping_on_the_cpu(avatar, tmp_path):
    root = avatar
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "latentsync_tpu_torch.scripts.api", "--avatars", str(root),
         "--out-dir", str(tmp_path / "out"), "--host", "127.0.0.1", "--port", str(port),
         "--unet-config", str(root / "tiny.yaml"), "--device", "cpu",
         "--continuous-batching", "--batch-windows", "2"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        reply, deadline = None, time.time() + 120
        while reply is None and time.time() < deadline and proc.poll() is None:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/ping", timeout=5) as r:
                    reply = json.loads(r.read())
            except OSError:
                time.sleep(0.3)
        assert reply == {"status": "ok", "queued": 0}, proc.stderr.read() if proc.poll() else ""
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            out, _ = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    assert proc.returncode == 0
    assert "continuous_batching=True" in out
