"""The port's DeepCache and CFG-interval paths against the JAX package, on
the CPU in float32.

The UNet is the tiny one of ``tests/test_flop_cuts.py`` (32/64/64/64, one
layer a block, 4 frames of 8² latents) with the port's seeded non-zero
weights carried into flax by the JAX package's converter. Its cache paths
hold the contract of that file: a write step is the exact forward (bit for
bit against the port's own forward), a read step fed the true cache
reproduces it, an ``enc`` read ignores ``sample`` and a stale cache moves
the output. Against the JAX model, at depth 1 and 2 in the plain, ``enc``
and ``enc:1`` modes: eps and every cached tensor of a write step, and the
eps of a read step fed the JAX model's own cache transposed into the
port's layout (B, C, F, H, W), within the model tolerance of
``tests/test_torch_models.py``.

The trajectories: the port's ``_denoise`` against the JAX package's own
``_denoise_fn`` (its body run eagerly) under six switch settings at 6 DDIM
steps, from the same x_T. Inside ``_denoise_fn`` the JAX UNet is replaced by the port's
(through ``jax.pure_callback``, layouts transposed): the step variants of
the UNet are held against the JAX model above, so this test holds what
``_denoise`` adds, the schedule (which step runs the CFG batch or the half
batch, which reads or writes, the write forced at the interval's entry,
the cache halves, the zero-filled unconditional half, CFG and DDIM).
Compiling the JAX UNet's unrolled trajectory instead costs ~38 s a
setting here. Tolerance: 1e-3 relative L1 over the trajectory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu import config as jcfg
from latentsync_tpu.models.unet3d import UNet3DConditionModel as JUNet
from latentsync_tpu.pipelines.lipsync import LipsyncPipeline as JPipeline
from latentsync_tpu.utils.convert import convert_unet, convert_vae
from latentsync_tpu_torch import config as pcfg
from latentsync_tpu_torch.models.unet3d import UNet3DConditionModel
from latentsync_tpu_torch.models.vae import AutoencoderKL
from latentsync_tpu_torch.pipelines.lipsync import LipsyncPipeline
from latentsync_tpu_torch.utils.convert import init_random_

from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)

# the model tolerance of tests/test_torch_models.py
ATOL, RTOL = 2e-4, 1e-4
# relative L1 of a denoised trajectory against the JAX package's
TRAJ_REL_L1 = 1e-3
STEPS = 6
# XLA's CPU backend at its lowest optimisation: the JAX references compile
# in about half the time, and their float results stay within the
# tolerances above
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
MODES = {"plain": {}, "enc": {"cache_encoder": True},
         "enc:1": {"cache_encoder": True, "cache_sub": 1}}


def _configs(mod):
    unet = mod.UNet3DConfig(block_out_channels=(32, 64, 64, 64), layers_per_block=1,
                            norm_num_groups=8, cross_attention_dim=16, attention_head_dim=4,
                            motion_module=mod.MotionModuleConfig(num_attention_heads=4,
                                                                 num_transformer_block=1))
    return mod.LatentSyncConfig(
        unet=unet, vae=mod.VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                                     norm_num_groups=4),
        data=mod.DataConfig(num_frames=4, resolution=16))


def _sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _to_port(a):
    """A JAX-layout (B, F, H, W, C) array → the port's (B, C, F, H, W)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 4, 1, 2, 3)))


def _to_jax(t):
    return np.ascontiguousarray(t.numpy().transpose(0, 2, 3, 4, 1))


def _tree(fn, tree):
    if isinstance(tree, (tuple, list)):
        return tuple(_tree(fn, t) for t in tree)
    return fn(tree)


def _leaves(tree):
    return [tree] if not isinstance(tree, (tuple, list)) else [x for t in tree for x in _leaves(t)]


@pytest.fixture(scope="module")
def tiny():
    cfg = _configs(pcfg)
    port = init_random_(UNet3DConditionModel(cfg.unet), seed=11).eval()
    params = convert_unet(_sd(port), 13, 4, 16)
    jax_model = JUNet(_configs(jcfg).unet)
    rng = np.random.default_rng(7)
    x = (0.3 * rng.standard_normal((2, 13, 4, 8, 8))).astype(np.float32)
    audio = (0.3 * rng.standard_normal((2, 4, 10, 16))).astype(np.float32)
    t = np.array([500, 500])
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(audio))
    with torch.no_grad():
        base = port(*args)
    jargs = (jnp.asarray(x.transpose(0, 2, 3, 4, 1)), jnp.asarray(t), jnp.asarray(audio))
    return port, jax_model, params, args, jargs, base


def _port(port, args, **kw):
    with torch.no_grad():
        return port(*args, **kw)


@pytest.fixture(scope="module")
def jax_refs(tiny):
    """The JAX model's write steps, one per (depth, sub-block cut), and its
    read steps fed their caches, in one jitted program (a third of the
    time of the same applies run eagerly here, less again at FAST_COMPILE). The plain mode's cache is
    the ``enc`` mode's deep feature."""
    _, jax_model, params, _, jargs, _ = tiny

    def refs(p, x, t, a):
        writes = {(d, sub): jax_model.apply(p, x, t, a, cache_depth=d, cache_encoder=True,
                                            cache_sub=sub)
                  for d in (1, 2) for sub in (0, 1)}
        reads = {}
        for mode, kw in MODES.items():
            for d in (1, 2):
                cache = _jax_write(writes, mode, d)[1]
                reads[(mode, d)] = jax_model.apply(p, x, t, a, deep_cache=cache, cache_read=True,
                                                   cache_depth=d, **kw)[0]
        return writes, reads

    return jax.jit(refs).lower(params, *jargs).compile(FAST_COMPILE)(params, *jargs)


def _jax_write(writes, mode, depth):
    eps, cache = writes[(depth, MODES[mode].get("cache_sub", 0))]
    return eps, cache[0] if mode == "plain" else cache


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("mode", list(MODES))
def test_write_matches_base_and_jax(tiny, jax_refs, mode, depth):
    """A write step is the port's exact forward bit for bit, and its eps
    and cache are the JAX model's."""
    port, _, _, args, _, base = tiny
    eps, cache = _port(port, args, cache_depth=depth, **MODES[mode])
    assert torch.equal(eps, base)
    j_eps, j_cache = _jax_write(jax_refs[0], mode, depth)
    np.testing.assert_allclose(_to_jax(eps), np.asarray(j_eps), atol=ATOL, rtol=RTOL)
    got, want = _leaves(cache), _leaves(j_cache)
    assert len(got) == len(want)
    if mode != "plain":
        lpb, sub = 1, MODES[mode].get("cache_sub", 0)
        # conv_in + depth levels x (a layer and a downsampler), less the
        # last downsampler and the skips of the layers the cut passes
        assert len(got) == 1 + (1 + depth * (lpb + 1) - 1 - sub)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_to_jax(g), np.asarray(w), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("mode", list(MODES))
def test_read_true_cache_matches_base_and_jax(tiny, jax_refs, mode, depth):
    """A read step fed the true cache reproduces the exact forward, fed the
    JAX model's cache (transposed) it gives the JAX model's read eps, and
    it hands back the cache it was given."""
    port, _, _, args, _, base = tiny
    kw = dict(cache_depth=depth, **MODES[mode])
    _, cache = _port(port, args, **kw)
    eps, passthrough = _port(port, args, deep_cache=cache, cache_read=True, **kw)
    np.testing.assert_allclose(eps.numpy(), base.numpy(), atol=1e-5, rtol=1e-5)
    assert passthrough is cache
    _, j_cache = _jax_write(jax_refs[0], mode, depth)
    j_eps = jax_refs[1][(mode, depth)]
    eps, _ = _port(port, args, deep_cache=_tree(_to_port, j_cache), cache_read=True, **kw)
    np.testing.assert_allclose(_to_jax(eps), np.asarray(j_eps), atol=ATOL, rtol=RTOL)


def test_enc_read_ignores_sample(tiny):
    port, _, _, args, _, _ = tiny
    kw = dict(cache_depth=1, cache_encoder=True)
    _, cache = _port(port, args, **kw)
    a, _ = _port(port, args, deep_cache=cache, cache_read=True, **kw)
    other = (args[0] * -3.0 + 1.0,) + args[1:]
    b, _ = _port(port, other, deep_cache=cache, cache_read=True, **kw)
    assert torch.equal(a, b)


@pytest.mark.parametrize("mode", list(MODES))
def test_stale_cache_differs(tiny, mode):
    port, _, _, args, _, base = tiny
    kw = dict(cache_depth=1, **MODES[mode])
    _, cache = _port(port, args, **kw)
    stale = _tree(lambda c: c * 1.5, cache)
    eps, _ = _port(port, args, deep_cache=stale, cache_read=True, **kw)
    assert bool(torch.isfinite(eps).all()) and not torch.allclose(eps, base, atol=1e-3)


# ---------------------------------------------------------------------------
# the schedule: _denoise against the JAX package's _denoise_fn
# ---------------------------------------------------------------------------


class _PortUNetInJax:
    """Stands in for the JAX UNet inside the JAX package's ``_denoise_fn``:
    the port's UNet on the arrays, layouts transposed; under a trace (the
    ``jax.eval_shape`` of the cache's structure) through
    ``jax.pure_callback``, the result's structure from one call on zeros."""

    def __init__(self, port):
        self.port = port

    def apply(self, params, x, t, audio, deep_cache=None, **kw):
        def run(x, t, audio, cache):
            with torch.no_grad():
                out = self.port(_to_port(x), torch.from_numpy(np.array(t)),
                                torch.from_numpy(np.asarray(audio)),
                                deep_cache=None if cache is None else _tree(_to_port, cache),
                                **kw)
            return _tree(_to_jax, out)

        if not isinstance(x, jax.core.Tracer):  # run eagerly (disable_jit)
            return run(x, t, audio, deep_cache)

        def zeros(a):
            return np.zeros(a.shape, a.dtype)

        like = run(zeros(x), zeros(t), zeros(audio),
                   None if deep_cache is None else jax.tree.map(zeros, deep_cache))
        shapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), like)
        return jax.pure_callback(run, shapes, x, t, audio, deep_cache)


@pytest.fixture(scope="module")
def pipelines(tiny):
    port_unet = tiny[0]
    cfg = _configs(pcfg)
    vae = init_random_(AutoencoderKL(cfg.vae), seed=12)
    port = LipsyncPipeline(port_unet, vae, None, cfg, dtype=torch.float32, device="cpu")
    jax_pipe = JPipeline(convert_unet(_sd(port_unet), 13, 4, 16), convert_vae(_sd(vae)), None,
                         _configs(jcfg), dtype=jnp.float32)
    jax_pipe.unet = _PortUNetInJax(port.unet)
    rng = np.random.default_rng(3)
    w, f, lat = 2, 4, 8
    x_t = np.broadcast_to(rng.standard_normal((1, 1, lat, lat, 4)), (w, f, lat, lat, 4))
    arrays = [x_t, rng.random((w, f, lat, lat, 1)) > 0.5,
              rng.standard_normal((w, f, lat, lat, 4)), rng.standard_normal((w, f, lat, lat, 4)),
              0.3 * rng.standard_normal((w, f, 10, 16))]
    arrays = [np.ascontiguousarray(a, np.float32) for a in arrays]
    return port, jax_pipe, arrays


SETTINGS = [
    {"LATENTSYNC_DEEPCACHE": "2:1"},
    {"LATENTSYNC_CFG_INTERVAL": "0.2:0.8"},
    # cfg_lo = 1: a half-batch write first, then the write forced at j = 1
    {"LATENTSYNC_DEEPCACHE": "2:1", "LATENTSYNC_CFG_INTERVAL": "0.2:0.8"},
    {"LATENTSYNC_DEEPCACHE": "2:1:enc"},
    {"LATENTSYNC_DEEPCACHE": "2:1:enc", "LATENTSYNC_CFG_INTERVAL": "0.2:0.8"},
    {"LATENTSYNC_DEEPCACHE": "2:1:enc:1", "LATENTSYNC_CFG_INTERVAL": "0.2:0.8"},
]


def _set(monkeypatch, env):
    monkeypatch.delenv("LATENTSYNC_DEEPCACHE", raising=False)
    monkeypatch.delenv("LATENTSYNC_CFG_INTERVAL", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.fixture(scope="module")
def exact(pipelines):
    """The port's exact trajectory (no switch set)."""
    port, _, arrays = pipelines
    with pytest.MonkeyPatch.context() as mp:
        _set(mp, {})
        return port._denoise(*map(torch.from_numpy, arrays), STEPS, 1.5).numpy()


@pytest.mark.parametrize("env", SETTINGS, ids=lambda e: "+".join(e.values()))
def test_denoise_matches_jax_schedule(pipelines, exact, monkeypatch, env):
    port, jax_pipe, arrays = pipelines
    _set(monkeypatch, env)
    got = port._denoise(*map(torch.from_numpy, arrays), STEPS, 1.5).numpy()
    with jax.disable_jit():  # the schedule's few array ops run eagerly: no compile
        want = np.asarray(jax_pipe._denoise_fn(STEPS, 1.5, True)(
            jax_pipe.unet_params, *map(jnp.asarray, arrays)))
    assert got.shape == want.shape == arrays[0].shape and np.isfinite(got).all()
    assert np.abs(got - want).mean() / np.abs(want).mean() < TRAJ_REL_L1
    # an approximate trajectory: near the exact one, and not it
    assert not np.array_equal(got, exact)
    assert np.abs(got - exact).mean() / np.abs(exact).mean() < 0.5


def test_a_flipped_switch_changes_the_next_call(pipelines, monkeypatch):
    """The switches are read at each call: one pipeline, three calls."""
    port, _, arrays = pipelines

    def run():
        return port._denoise(*map(torch.from_numpy, arrays), STEPS, 1.5)

    _set(monkeypatch, {})
    first = run()
    _set(monkeypatch, {"LATENTSYNC_DEEPCACHE": "2:1", "LATENTSYNC_CFG_INTERVAL": "0:0.5"})
    cut = run()
    _set(monkeypatch, {})
    assert not torch.equal(cut, first)
    assert torch.equal(run(), first)


class _Stub:
    config = jcfg.LatentSyncConfig()


KNOB_VALUES = [
    ("", ""), ("0", ""), ("1", ""), ("3", ""), ("2:2", "0.25:0.75"), ("4:1:enc:2", "0.25:0.75"),
    ("4:1:enc", "0:0.5"), ("4:1:1", ""), ("4:1:enc:9", ""), ("1:3:enc", "0.2:0.8"),
    ("5:0", "0.5:0.5"), ("4:4", "0:1"),
    # the four ValueErrors
    ("4:1:ecn:2", ""), ("4:9:enc", ""), ("4:1:enc", "0.5"), ("4:1:enc", "0.7:0.2"),
]


@pytest.mark.parametrize("dc,ci", KNOB_VALUES)
@pytest.mark.parametrize("steps", [20, 6])
def test_flop_cut_knobs_match_jax(pipelines, monkeypatch, dc, ci, steps):
    port = pipelines[0]
    _set(monkeypatch, {"LATENTSYNC_DEEPCACHE": dc, "LATENTSYNC_CFG_INTERVAL": ci})
    try:
        want = JPipeline._flop_cut_knobs(_Stub(), steps)
    except ValueError as e:
        with pytest.raises(ValueError) as info:
            port._flop_cut_knobs(steps)
        assert str(info.value) == str(e)
        return
    assert port._flop_cut_knobs(steps) == want
