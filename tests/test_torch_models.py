"""The port's models against the JAX package, on the CPU in float32.

Seeded non-zero random weights go into the port's modules
(``init_random_``: conv_in, conv_out and every proj_out included, which
the reference zero-initialises and which would otherwise make the UNet's
output identically 0); their state dicts go through the JAX package's own
converters into the flax models; both see the same numpy inputs. The
converters of the port are checked to invert the JAX ones.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.audio.features import Audio2Feature as JAudio2Feature
from latentsync_tpu import config as jconfig
from latentsync_tpu.config import MotionModuleConfig as JMM
from latentsync_tpu.config import UNet3DConfig as JUNetCfg
from latentsync_tpu.config import VAEConfig as JVAECfg
from latentsync_tpu.config import WhisperConfig as JWhisperCfg
from latentsync_tpu.models.unet3d import UNet3DConditionModel as JUNet
from latentsync_tpu.models.vae import AutoencoderKL as JVAE
from latentsync_tpu.ops.mel import whisper_log_mel as j_log_mel
from latentsync_tpu.utils.convert import convert_unet, convert_vae, convert_whisper_encoder
from latentsync_tpu_torch import config as pconfig
from latentsync_tpu_torch.audio.features import Audio2Feature
from latentsync_tpu_torch.config import MotionModuleConfig, UNet3DConfig, VAEConfig, WhisperConfig
from latentsync_tpu_torch.models.unet3d import UNet3DConditionModel
from latentsync_tpu_torch.models.vae import AutoencoderKL
from latentsync_tpu_torch.models.whisper import WhisperEncoder
from latentsync_tpu_torch.ops.mel import whisper_log_mel
from latentsync_tpu_torch.utils.convert import (
    init_random_,
    unet_state_dict_from_flax,
    vae_state_dict_from_flax,
    whisper_state_dict_from_flax,
)

# the existing bar of the torch-oracle UNet parity test (test_parity_unet_vae.py)
UNET_ATOL, UNET_RTOL = 2e-4, 1e-4

UNET_KW = dict(block_out_channels=(32, 64, 64, 64), layers_per_block=1, norm_num_groups=8,
               cross_attention_dim=16, attention_head_dim=4)
VAE_KW = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1, norm_num_groups=4)
WHISPER_KW = dict(n_audio_state=16, n_audio_head=2, n_audio_layer=2)


def _numpy_sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def unet_pair():
    port = init_random_(UNet3DConditionModel(
        UNet3DConfig(**UNET_KW, motion_module=MotionModuleConfig(num_attention_heads=4))),
        seed=3)
    params = convert_unet(_numpy_sd(port), in_channels=13, out_channels=4,
                          cross_attention_dim=16)
    jax_model = JUNet(JUNetCfg(**UNET_KW, motion_module=JMM(num_attention_heads=4)))
    return port, jax_model, params


def test_unet_matches_jax_and_eps_depends_on_audio(unet_pair):
    port, jax_model, params = unet_pair
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 13, 16, 8, 8)).astype(np.float32)
    audio = rng.standard_normal((2, 16, 5, 16)).astype(np.float32)
    t = np.array([17, 503])
    with torch.no_grad():
        eps = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(audio)).numpy()
        eps0 = port(torch.from_numpy(x), torch.from_numpy(t),
                    torch.zeros(audio.shape)).numpy()
    ref = jax_model.apply(params, jnp.asarray(x.transpose(0, 2, 3, 4, 1)), jnp.asarray(t),
                          jnp.asarray(audio))
    np.testing.assert_allclose(eps, np.asarray(ref).transpose(0, 4, 1, 2, 3),
                               atol=UNET_ATOL, rtol=UNET_RTOL)
    assert np.abs(eps).mean() > 0.1                 # random weights carry signal
    assert np.abs(eps - eps0).mean() > 1e-2 * np.abs(eps).mean()  # audio conditions eps


def test_unet_converter_inverts_convert_unet(unet_pair):
    port, _, params = unet_pair
    sd = unet_state_dict_from_flax(jax.tree.map(np.asarray, params))
    assert set(sd) == set(port.state_dict())
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
    # and back: the round trip through convert_unet is the identity
    again = convert_unet({k: v.numpy() for k, v in sd.items()}, in_channels=13,
                         out_channels=4, cross_attention_dim=16)
    jax.tree.map(np.testing.assert_array_equal, again, params)


def test_random_init_fills_the_reference_zero_tensors(unet_pair):
    port = unet_pair[0]
    sd = port.state_dict()
    zero_inits = [k for k in sd if k.startswith(("conv_in.", "conv_out.")) or ".proj_out." in k]
    assert len(zero_inits) > 10
    assert all(float(sd[k].abs().mean()) > 1e-3 for k in zero_inits)


@pytest.fixture(scope="module")
def vae_pair():
    port = init_random_(AutoencoderKL(VAEConfig(**VAE_KW)), seed=5)
    return port, JVAE(JVAECfg(**VAE_KW)), convert_vae(_numpy_sd(port))


def test_vae_encode_decode_match_jax(vae_pair):
    port, jax_model, params = vae_pair
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    z = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    with torch.no_grad():
        mean, logvar = port.moments(torch.from_numpy(x))
        dec = port.decode(torch.from_numpy(z))
    j_mean, j_logvar = jax_model.apply(params, jnp.asarray(x.transpose(0, 2, 3, 1)),
                                       method="moments")
    j_dec = jax_model.apply(params, jnp.asarray(z.transpose(0, 2, 3, 1)), method="decode")
    for got, ref in ((mean, j_mean), (logvar, j_logvar), (dec, j_dec)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref).transpose(0, 3, 1, 2),
                                   atol=5e-5, rtol=1e-4)


def test_vae_converter_inverts_convert_vae(vae_pair):
    port, _, params = vae_pair
    sd = vae_state_dict_from_flax(params)
    assert set(sd) == set(port.state_dict())
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)


@pytest.fixture(scope="module")
def whisper_pair():
    port = init_random_(WhisperEncoder(WhisperConfig(**WHISPER_KW)), seed=7)
    params = convert_whisper_encoder({"encoder." + k: v for k, v in _numpy_sd(port).items()})
    return port, params


@pytest.mark.parametrize("seconds", [2.0, 31.3])  # one 30 s segment, and two
def test_audio_features_match_jax(whisper_pair, seconds):
    """Mel front end + whisper encoder + per-layer stacking, end to end."""
    port, params = whisper_pair
    audio = (0.1 * np.random.default_rng(2).standard_normal(int(16000 * seconds))
             ).astype(np.float32)
    ref = JAudio2Feature(JWhisperCfg(**WHISPER_KW), params=params).audio2feat(audio)
    got = Audio2Feature(port).audio2feat(audio)
    assert got.shape == ref.shape == (int(seconds * 50), 3, 16)
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=1e-4)
    chunks = Audio2Feature(port).feature2chunks(got, fps=25)
    j_chunks = JAudio2Feature(JWhisperCfg(**WHISPER_KW), params=params).feature2chunks(ref, 25)
    np.testing.assert_allclose(chunks, j_chunks, atol=5e-5, rtol=1e-4)


def test_log_mel_matches_jax():
    audio = np.random.default_rng(3).standard_normal(16000).astype(np.float32)
    np.testing.assert_allclose(whisper_log_mel(torch.from_numpy(audio)).numpy(),
                               np.asarray(j_log_mel(jnp.asarray(audio))), atol=1e-5)


def test_whisper_converter_inverts_convert_whisper_encoder(whisper_pair):
    port, params = whisper_pair
    sd = whisper_state_dict_from_flax(params)
    assert set(sd) == set(port.state_dict())
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)


@pytest.mark.parametrize("path", [None, "configs/unet_stage2.yaml", "configs/unet_stage1.yaml"])
def test_config_tree_matches_jax(path):
    """Same dataclasses, fields and defaults; the same YAML loads the same."""
    if path is None:
        port, ref = pconfig.LatentSyncConfig(), jconfig.LatentSyncConfig()
    else:
        port, ref = pconfig.load_unet_config(path), jconfig.load_unet_config(path)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
