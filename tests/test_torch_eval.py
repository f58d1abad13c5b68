"""The port's SyncNet scorer against the JAX package, on the CPU in float32.

MFCC (the port's own numpy copy) bit for bit; ``SyncNetS``'s two towers at
224², batch 2, with random non-zero weights and batch-norm statistics made
from a numpy seed in the JAX package's layout and carried into the port by
``syncnet_s_state_dict_from_flax``; the shift-distance matrix and the
offset / confidence (a constructed tie included); ``evaluate_arrays`` on a
40-frame clip and ``evaluate`` on a written clip with its ``.wav`` sidecar;
and the state-dict layout against ``convert_syncnet_s``, with and without
upstream's ``__S__.`` prefix.

Tolerances: features and distances within 1e-4 in relative L2 (f32 on both
sides, sums in another order); the offset equal wherever the two smallest
mean distances are further apart than that tolerance of the distances (on
random weights near-ties happen, and either side may then take either
index); MFCC and the tie exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.eval import mfcc as jmfcc
from latentsync_tpu.eval import sync_eval as je
from latentsync_tpu.utils.convert_eval import convert_syncnet_s
from latentsync_tpu_torch.eval import mfcc as pmfcc
from latentsync_tpu_torch.eval import sync_eval as pe
from latentsync_tpu_torch.utils import convert as pconv
from latentsync_tpu_torch.utils.media import write_audio, write_video

from test_torch_eval_models import random_variables, rel_l2
from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)

REL = 1e-4


@pytest.fixture(scope="module")
def scorer():
    """(JAX evaluator, port evaluator) on the same random weights."""
    model = je.SyncNetS()
    v = random_variables(model, (jnp.zeros((1, 5, 224, 224, 3)), jnp.zeros((1, 13, 20, 1))),
                         seed=3)
    port = pe.SyncNetEvaluator(pconv.syncnet_s_state_dict_from_flax(v), device="cpu")
    return je.SyncNetEvaluator(jax.tree.map(jnp.asarray, v)), port, v


def talking_clip(n_frames: int, seed: int = 0):
    """(frames (n, 224, 224, 3) uint8, 16 kHz audio of the same length): a
    smooth moving pattern with a mouth-like band whose opening follows the
    audio's envelope."""
    rng = np.random.default_rng(seed)
    audio = (0.3 * rng.standard_normal(n_frames * 640)
             * (0.5 + 0.5 * np.sin(np.arange(n_frames * 640) / 900.0))).astype(np.float32)
    env = np.abs(audio).reshape(n_frames, 640).mean(1)
    yy, xx = np.mgrid[0:224, 0:224]
    frames = []
    for t in range(n_frames):
        img = np.stack([128 + 60 * np.sin(xx / 17 + t / 5 + c) * np.cos(yy / 23 - c)
                        for c in range(3)], -1)
        half = 6 + 60 * env[t]
        img[(np.abs(yy - 160) < half) & (np.abs(xx - 112) < 40)] = (40, 20, 30)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(frames), audio


def _assert_same_offset(j_dists, p_res, j_res):
    """Offsets equal unless the JAX side's two smallest mean distances lie
    within the distance tolerance of each other; min_dist and confidence
    within the tolerance."""
    scale = float(np.abs(j_dists).max())
    mean = np.sort(np.asarray(j_dists).mean(0))
    if mean[1] - mean[0] > REL * scale:
        assert p_res[0] == j_res[0]
    assert abs(p_res[1] - j_res[1]) <= REL * scale
    assert abs(p_res[2] - j_res[2]) <= REL * scale


@pytest.mark.parametrize("n", [100, 400, 401, 16000, 25333])
def test_mfcc_is_bit_for_bit_the_jax_one(n):
    audio = np.random.default_rng(n).standard_normal(n).astype(np.float32) * 0.2
    got, want = pmfcc.mfcc(audio), jmfcc.mfcc(audio)
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_syncnet_towers_match_jax(scorer):
    jev, port, v = scorer
    rng = np.random.default_rng(5)
    lip = rng.uniform(0, 255, (2, 5, 224, 224, 3)).astype(np.float32)
    aud = rng.standard_normal((2, 13, 20, 1)).astype(np.float32)
    j_lip = np.asarray(jev._lip_fn(jev.params, lip))
    j_aud = np.asarray(jev._aud_fn(jev.params, aud))
    with torch.no_grad():
        p_lip = port.model.forward_lip(torch.from_numpy(lip.transpose(0, 4, 1, 2, 3).copy()))
        p_aud = port.model.forward_aud(torch.from_numpy(aud.transpose(0, 3, 1, 2).copy()))
    assert p_lip.shape == p_aud.shape == (2, 1024)
    assert rel_l2(p_lip.numpy(), j_lip) < REL
    assert rel_l2(p_aud.numpy(), j_aud) < REL


@pytest.mark.parametrize("t,vshift", [(35, 15), (8, 15), (20, 3)])
def test_shift_distances_and_offset_match_jax(t, vshift):
    rng = np.random.default_rng(t)
    lip = rng.standard_normal((t, 64)).astype(np.float32)
    aud = rng.standard_normal((t, 64)).astype(np.float32)
    aud[3:] = lip[:-3] + 0.1 * aud[3:]  # audio 3 frames behind the lips
    j_d = np.asarray(je.pairwise_shift_distances(jnp.asarray(lip), jnp.asarray(aud), vshift))
    p_d = pe.pairwise_shift_distances(torch.from_numpy(lip), torch.from_numpy(aud), vshift)
    assert p_d.shape == (t, 2 * vshift + 1)
    assert rel_l2(p_d.numpy(), j_d) < REL
    _assert_same_offset(j_d, pe.offset_and_confidence(p_d, vshift),
                        je.offset_and_confidence(jnp.asarray(j_d), vshift))


def test_offset_takes_the_first_of_tied_minima_as_jax():
    """Two columns with the same (exactly representable) mean distance: both
    take the first index, and the median is the middle of 31 values."""
    d = np.tile(np.arange(31, dtype=np.float32) + 10, (4, 1))
    d[:, 20] = d[:, 7] = 3.0
    d[:, 9] = 100.0
    got = pe.offset_and_confidence(torch.from_numpy(d))
    want = je.offset_and_confidence(jnp.asarray(d))
    assert got == want and got[0] == 15 - 7


def test_evaluate_arrays_on_a_40_frame_clip(scorer):
    jev, port, _ = scorer
    frames, audio = talking_clip(40)
    j_lip, j_aud = jev.features(frames, audio)
    p_lip, p_aud = port.features(frames, audio)
    assert p_lip.shape == p_aud.shape == j_lip.shape == (34, 1024)
    assert rel_l2(p_lip.numpy(), j_lip) < REL and rel_l2(p_aud.numpy(), j_aud) < REL
    j_d = je.pairwise_shift_distances(jnp.asarray(j_lip), jnp.asarray(j_aud))
    p_d = pe.pairwise_shift_distances(p_lip, p_aud)
    assert rel_l2(p_d.numpy(), np.asarray(j_d)) < REL
    got = port.evaluate_arrays(frames, audio)
    assert got == pe.offset_and_confidence(p_d)
    _assert_same_offset(np.asarray(j_d), got, je.offset_and_confidence(j_d))


def test_evaluate_reads_the_sidecar_and_windows_in_small_batches(scorer, tmp_path):
    """``evaluate`` on an OpenCV clip (resized to 224² as the reference does)
    with its ``.wav`` sidecar, against the JAX evaluator on the same file;
    batches of 4 windows give the features of one batch."""
    jev, port, _ = scorer
    frames, audio = talking_clip(14, seed=1)
    path = str(tmp_path / "clip.mp4")
    write_video(path, frames[:, ::2, ::2], fps=25)
    write_audio(str(tmp_path / "clip.wav"), audio)
    assert pe.audio_source(path) == str(tmp_path / "clip.wav")
    got = port.evaluate(path)
    # the JAX evaluator's evaluate(path), its distances kept for the tie rule
    import cv2

    from latentsync_tpu.utils.media import read_audio, read_video

    read = np.stack([cv2.resize(f, (224, 224)) for f in read_video(path, change_fps=False)])
    j_d = je.pairwise_shift_distances(*map(jnp.asarray, jev.features(
        read, read_audio(str(tmp_path / "clip.wav")))))
    _assert_same_offset(np.asarray(j_d), got, je.offset_and_confidence(j_d))
    small = pe.SyncNetEvaluator(port.model.state_dict(), device="cpu", batch_size=4)
    p4 = small.features(frames, audio)
    p64 = port.features(frames, audio)
    assert rel_l2(p4[0].numpy(), p64[0].numpy()) < REL


def test_too_short_a_clip_raises(scorer):
    frames, audio = talking_clip(5)
    with pytest.raises(ValueError, match="too short"):
        scorer[1].features(frames, audio)


@pytest.mark.parametrize("prefix", ["", "__S__."])
def test_state_dict_is_upstream_and_converts_back_to_the_jax_tree(scorer, tmp_path, prefix):
    """The port's state dict (upstream's keys, running statistics included)
    written as ``syncnet_v2.model`` is (with or without ``__S__.``), through
    ``load_syncnet_s_file`` and the JAX ``convert_syncnet_s``, the JAX
    variables leaf for leaf."""
    _, port, v = scorer
    sd = pconv.syncnet_s_state_dict_from_flax(v)
    own = {k for k in pe.SyncNetS().state_dict() if not k.endswith("num_batches_tracked")}
    assert set(sd) == own and "netcnnlip.19.running_var" in sd and "netfcaud.3.bias" in sd
    path = str(tmp_path / "syncnet_v2.model")
    torch.save({prefix + k: t for k, t in port.model.state_dict().items()}, path)
    loaded = pe.load_syncnet_s_file(path)
    assert set(loaded) == set(sd)
    for k in sd:
        assert torch.equal(loaded[k], sd[k]), k
    back = convert_syncnet_s({prefix + k: t.numpy() for k, t in loaded.items()})
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    leaves = jax.tree_util.tree_leaves_with_path(v)
    assert len(flat) == len(leaves)
    for p, leaf in leaves:
        np.testing.assert_array_equal(np.asarray(flat[p]), np.asarray(leaf))
    ev, source = pe.evaluator_from_file(path, device="cpu")
    assert source == "pretrained" and ev.device.type == "cpu"
    assert pe.evaluator_from_file(os.path.join(tmp_path, "absent"), "cpu")[1] == "random"


def test_random_weights_are_seeded_and_nonzero_with_statistics():
    a = pe.SyncNetEvaluator(device="cpu").model.state_dict()
    b = pe.SyncNetEvaluator(device="cpu").model.state_dict()
    for k, t in a.items():
        assert torch.equal(t, b[k]), k
        if t.is_floating_point():
            assert bool(t.abs().min() > 0) or "bias" in k, k
    assert float((a["netcnnlip.1.running_var"] - 1).abs().mean()) > 0.1
