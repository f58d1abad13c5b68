"""The port's ``Wav2LipSyncNet`` against the JAX package's, on the CPU.

The port's model with seeded random weights and batch-norm statistics
(``init_random_bn_``); its own ``state_dict()``, as numpy, goes through the
JAX package's ``convert_wav2lip_syncnet`` into the JAX module, run under
``jax.jit``. The same faces (2, 128, 256, 15) and mel (2, 80, 16, 1) from
``np.random.default_rng``, channels-last for JAX and transposed to NCHW for
the port, must give both unit embeddings within EMB_TOL (f32 on both sides;
the towers sum 20 and 17 convolutions in another order). The other
activations run at batch 1; ``train()`` mode must give the same result,
since the JAX module normalises with the running statistics in training too;
and the inverse converter must undo ``convert_wav2lip_syncnet`` leaf for
leaf.
"""

import jax
import numpy as np
import pytest
import torch

from latentsync_tpu.models.syncnet import Wav2LipSyncNet as JWav2Lip
from latentsync_tpu.models.syncnet import convert_wav2lip_syncnet
from latentsync_tpu_torch.models.syncnet import Wav2LipSyncNet
from latentsync_tpu_torch.utils.convert import (init_random_bn_,
                                                wav2lip_syncnet_state_dict_from_flax)

from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)

# max |port - JAX| over each unit embedding (f32 both sides)
EMB_TOL = 1e-4


def _model(act_fn="leaky", seed=0):
    return init_random_bn_(Wav2LipSyncNet(act_fn), seed=seed).eval()


def _numpy_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _inputs(batch, seed=0):
    rng = np.random.default_rng(seed)
    faces = rng.standard_normal((batch, 128, 256, 15)).astype(np.float32)
    mel = rng.standard_normal((batch, 80, 16, 1)).astype(np.float32)
    return faces, mel


def _port(model, faces, mel):
    with torch.no_grad():
        v, a = model(torch.from_numpy(faces.transpose(0, 3, 1, 2)),
                     torch.from_numpy(mel.transpose(0, 3, 1, 2)))
    return v.numpy(), a.numpy()


def _jax(model, act_fn, faces, mel):
    variables = convert_wav2lip_syncnet(_numpy_sd(model))
    v, a = jax.jit(JWav2Lip(act_fn=act_fn).apply)(variables, faces, mel)
    return np.asarray(v), np.asarray(a)


def _close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(np.linalg.norm(g, axis=1), 1.0, atol=1e-5)
        assert np.abs(g - w).max() <= EMB_TOL, np.abs(g - w).max()


@pytest.fixture(scope="module")
def leaky():
    model = _model()
    faces, mel = _inputs(2)
    return model, faces, mel, _jax(model, "leaky", faces, mel)


def test_tower_geometry_and_parameters():
    model = Wav2LipSyncNet()
    assert len(model.visual_encoder) == len(JWav2Lip.VISUAL) == 20
    assert len(model.audio_encoder) == len(JWav2Lip.AUDIO) == 17
    # weights, biases and the running statistics: 65.2 M a model
    stats = sum(b.numel() for n, b in model.named_buffers() if "running" in n)
    assert sum(p.numel() for p in model.parameters()) + stats == 65_243_776
    keys = set(model.state_dict())
    assert "visual_encoder.0.conv_block.0.weight" in keys
    assert "audio_encoder.16.conv_block.1.running_var" in keys


def test_default_leaky_matches_jax(leaky):
    model, faces, mel, want = leaky
    _close(_port(model, faces, mel), want)


def test_train_mode_normalises_with_the_running_statistics(leaky):
    model, faces, mel, want = leaky
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    try:
        _close(_port(model, faces, mel), want)
    finally:
        model.eval()
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


@pytest.mark.parametrize("act_fn", ["relu", "silu", "tanh"])
def test_other_activations_match_jax(act_fn):
    model = _model(act_fn, seed=1)
    faces, mel = _inputs(1, seed=1)
    _close(_port(model, faces, mel), _jax(model, act_fn, faces, mel))


def test_an_unknown_activation_raises():
    with pytest.raises(ValueError):
        Wav2LipSyncNet("gelu")


def test_inverse_converter_round_trips():
    sd = _model(seed=2).state_dict()
    back = wav2lip_syncnet_state_dict_from_flax(
        convert_wav2lip_syncnet({k: v.numpy() for k, v in sd.items()}))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    Wav2LipSyncNet().load_state_dict(back)  # strict
