"""The int8 serving configurations of the port against the JAX package, on
the CPU in float32.

The JAX package's two int8 switches configure the same served model in
both packages: ``LATENTSYNC_INT8=1`` ("int8": every ``QConv`` as the
dynamic-quantization int8 convolution) and, on top of it,
``LATENTSYNC_INT8_DENSE=pallas`` ("int8-dense": every ``QDense``
projection of the transformer and motion blocks through the K8 int8
matmul, the blocks in their composed form). The tests set the switches
with ``monkeypatch.setenv`` on both sides; the JAX side runs K8 in
interpret mode, as ``quantized_matmul_pallas`` chooses off the TPU, and
the port its plain versions, whose int32 accumulation is an exact float64
product.

Tolerances: the ops, max abs error ≤ 1e-6 · max(1, max|ref|) (the same
integer codes and the same f32 dequant, so only the last bit of a scale
can differ); the small UNet and VAE, relative L2 ≤ 1e-3,
because a float difference upstream of a quantizer can flip one rounding
of one code. The kernels themselves are held against these plain
versions on the card by ``tests/test_torch_kernels.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.config import MotionModuleConfig as JMM
from latentsync_tpu.config import UNet3DConfig as JUNetCfg
from latentsync_tpu.config import VAEConfig as JVAECfg
from latentsync_tpu.models.unet3d import UNet3DConditionModel as JUNet
from latentsync_tpu.models.vae import AutoencoderKL as JVAE
from latentsync_tpu.ops import qconv as j_qc
from latentsync_tpu.ops.qmm import quantized_matmul_pallas
from latentsync_tpu.utils.convert import convert_unet, convert_vae
from latentsync_tpu_torch import config as pcfg
from latentsync_tpu_torch.audio.features import Audio2Feature
from latentsync_tpu_torch.models import unet3d as p_unet3d
from latentsync_tpu_torch.models.unet3d import UNet3DConditionModel
from latentsync_tpu_torch.models.vae import AutoencoderKL
from latentsync_tpu_torch.models.whisper import WhisperEncoder
from latentsync_tpu_torch.ops import qconv as p_qc
from latentsync_tpu_torch.pipelines.lipsync import LipsyncPipeline
from latentsync_tpu_torch.utils.convert import init_random_

from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)


OP_TOL = 1e-6
MODEL_TOL = 1e-3
SWITCHES = ("LATENTSYNC_INT8", "LATENTSYNC_INT8_DENSE", "LATENTSYNC_FUSED_ATTN",
            "LATENTSYNC_FUSED_FFN", "LATENTSYNC_PALLAS_GN", "LATENTSYNC_FUSED_XATTN")
CONFIGS = {"float": {}, "int8": {"LATENTSYNC_INT8": "1"},
           "int8-dense": {"LATENTSYNC_INT8": "1", "LATENTSYNC_INT8_DENSE": "pallas"}}
# tests/test_int8.py's small UNet and VAE (as tests/test_torch_models.py's)
UNET_KW = dict(block_out_channels=(32, 64, 64, 64), layers_per_block=1, norm_num_groups=8,
               cross_attention_dim=16, attention_head_dim=4)
VAE_KW = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1, norm_num_groups=4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _configure(monkeypatch, conf):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in CONFIGS[conf].items():
        monkeypatch.setenv(k, v)


def _assert_op_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= OP_TOL * max(1.0, float(np.abs(ref).max())), err


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


# --------------------------------------------------------------------------
# ops
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case,bias", [("3x3 SAME", True), ("1x1", True), ("1x1", False),
                                       ("3x3 stride 2 VALID after (0,1) pad", True)])
def test_quantized_conv2d_matches_jax(case, bias):
    rng = np.random.default_rng(len(case) + bias)
    kh, stride = (1, 1) if case == "1x1" else (3, 2 if "stride" in case else 1)
    x = rng.standard_normal((2, 8, 12, 12)).astype(np.float32)
    # per-out-channel weight magnitudes 1 and 1e-3
    w = rng.standard_normal((12, 8, kh, kh)).astype(np.float32)
    w[6:] *= 1e-3
    b = (0.1 * rng.standard_normal(12)).astype(np.float32) if bias else None
    if "stride" in case:
        x = np.pad(x, ((0, 0), (0, 0), (0, 1), (0, 1)))
        pad, j_pad = (0, 0), "VALID"
    else:
        pad = j_pad = (kh // 2, kh // 2)
        j_pad = kh // 2
    got = p_qc.quantized_conv2d(_t(x), _t(w), None if b is None else _t(b), (stride, stride),
                                pad)
    ref = j_qc.quantized_conv2d(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                jnp.asarray(w.transpose(2, 3, 1, 0)), b, (stride, stride), j_pad)
    _assert_op_close(got.numpy(), np.asarray(ref).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("mode", ["xla", "pallas"])
@pytest.mark.parametrize("x_shape,n", [((130, 24), 136), ((2, 65, 24), 136), ((48, 40), 96)])
@pytest.mark.parametrize("bias", [True, False])
def test_dense_with_params_matches_jax(monkeypatch, mode, x_shape, n, bias):
    """Ragged M/N as in ``test_qmm_pallas_ragged_edges``."""
    rng = np.random.default_rng(n + len(x_shape) + bias)
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = rng.standard_normal((x_shape[-1], n)).astype(np.float32)  # the JAX (K, N) kernel
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    monkeypatch.setenv("LATENTSYNC_INT8_DENSE", mode)
    got = p_qc.dense_with_params(_t(x), _t(w.T), None if b is None else _t(b), torch.float32)
    x2d = jnp.asarray(x.reshape(-1, x_shape[-1]))
    ref = (quantized_matmul_pallas(x2d, w, b) if mode == "pallas"
           else j_qc._qdense_ste(x2d, w, b))
    _assert_op_close(got.numpy(), np.asarray(ref).reshape(x_shape[:-1] + (n,)))
    # the reference's own routing gives the same
    _assert_op_close(got.numpy(), j_qc.dense_with_params(jnp.asarray(x), w, b, jnp.float32))


@pytest.mark.parametrize("mode", ["xla", "pallas"])
def test_a_row_of_zeros_gives_exactly_the_bias(monkeypatch, mode):
    """The CFG pass feeds an all-zero audio context."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((40, 32)).astype(np.float32)
    x[[0, 17, 39]] = 0.0
    w, b = rng.standard_normal((24, 32)).astype(np.float32), rng.standard_normal(24)
    monkeypatch.setenv("LATENTSYNC_INT8_DENSE", mode)
    got = p_qc.dense_with_params(_t(x), _t(w), _t(b.astype(np.float32)), torch.float32)
    np.testing.assert_array_equal(got.numpy()[[0, 17, 39]],
                                  np.broadcast_to(b.astype(np.float32), (3, 24)))
    assert np.abs(got.numpy()[1]).max() > 0


def test_unknown_int8_dense_mode_raises(monkeypatch):
    monkeypatch.setenv("LATENTSYNC_INT8_DENSE", "int4")
    with pytest.raises(ValueError, match="LATENTSYNC_INT8_DENSE"):
        p_qc.dense_with_params(torch.ones(4, 8), torch.ones(8, 8), None, torch.float32)
    unet = UNet3DConditionModel(_small_unet_config())
    with pytest.raises(ValueError, match="LATENTSYNC_INT8_DENSE"):
        unet(torch.zeros(1, 13, 2, 8, 8), torch.tensor([1]), torch.zeros(1, 2, 5, 16))


# --------------------------------------------------------------------------
# models
# --------------------------------------------------------------------------


def _small_unet_config():
    return pcfg.UNet3DConfig(**UNET_KW, motion_module=pcfg.MotionModuleConfig(
        num_attention_heads=4))


@pytest.fixture(scope="module")
def unet_pair():
    port = init_random_(UNet3DConditionModel(_small_unet_config()), seed=3)
    params = convert_unet({k: v.numpy() for k, v in port.state_dict().items()},
                          in_channels=13, out_channels=4, cross_attention_dim=16)
    return port, JUNet(JUNetCfg(**UNET_KW, motion_module=JMM(num_attention_heads=4))), params


@pytest.fixture(scope="module")
def unet_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 13, 16, 8, 8)).astype(np.float32)
    audio = rng.standard_normal((1, 16, 5, 16)).astype(np.float32)
    return x, np.array([503]), audio


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


class _QuantizerForcing:
    """Teacher forcing at the quantizers. A 1e-6 relative change of the
    small int8 UNet's input changes its own output by ~4 % rel L2 (a
    flipped code moves its conv's output by a whole quantum, which flips
    codes in the next layer): two float implementations that agree to
    1e-7 cannot agree to 1e-3 free-running. So the JAX model records the
    input and output of every quantized op in call order, and the port's
    run checks, at each of its quantized ops, its own input against JAX's
    (the float segment since the previous quantizer), then runs its op on
    JAX's input, checks the output at the op tolerance, and carries on from
    it. Every segment and every quantized op of the port's forward is held
    to the JAX model's, and the two final outputs agree."""

    def __init__(self, monkeypatch):
        self.calls, self.i, self.segment_err = [], 0, 0.0
        mp = monkeypatch
        j_conv, j_dense = j_qc.quantized_conv2d, j_qc._qdense_pallas_ste
        mp.setattr(j_qc, "quantized_conv2d", lambda x, *a: self._record(
            "conv", x, j_conv(x, *a), _nchw))
        mp.setattr(j_qc, "_qdense_pallas_ste", lambda x, *a: self._record(
            "dense", x, j_dense(x, *a), np.asarray))
        p_conv, p_dense = p_qc.quantized_conv2d, p_qc.quantized_matmul
        mp.setattr(p_qc, "quantized_conv2d", lambda x, *a: self._force("conv", p_conv, x, *a))
        mp.setattr(p_qc, "quantized_matmul", lambda x, *a: self._force("dense", p_dense, x, *a))

    def _record(self, kind, x, y, layout):
        """Runs while the JAX model is traced; the values arrive in call
        order when the compiled program runs."""
        jax.debug.callback(lambda xv, yv: self.calls.append((kind, layout(xv), layout(yv))),
                           x, y, ordered=True)
        return y

    def _force(self, kind, fn, x, *args):
        want_kind, jx, jy = self.calls[self.i]
        self.i += 1
        assert (kind, tuple(x.shape)) == (want_kind, jx.shape), (self.i, kind, x.shape)
        self.segment_err = max(self.segment_err, _rel_l2(x.numpy(), jx))
        y = fn(_t(jx), *args)
        _assert_op_close(y.numpy(), jy)
        return y

    def check(self, got, ref, what):
        assert self.calls and self.i == len(self.calls), (self.i, len(self.calls))
        assert self.segment_err <= MODEL_TOL, \
            f"{what}: a float segment between quantizers is {self.segment_err:.3g} from JAX's"
        rel = _rel_l2(got, ref)
        assert rel <= MODEL_TOL, f"{what}: rel L2 vs JAX {rel:.3g} > {MODEL_TOL}"
        return rel


@pytest.mark.parametrize("conf", ["int8", "int8-dense"])
def test_unet_int8_configuration_matches_jax(unet_pair, unet_inputs, monkeypatch, conf):
    port, jax_model, params = unet_pair
    x, t, audio = unet_inputs
    with torch.no_grad():
        _configure(monkeypatch, "float")
        eps_float = port(_t(x), _t(t), _t(audio)).numpy()
        _configure(monkeypatch, conf)
        eps_free = port(_t(x), _t(t), _t(audio)).numpy()
        forcing = _QuantizerForcing(monkeypatch)
        ref = np.asarray(jax.jit(lambda *a: jax_model.apply(*a))(
            params, jnp.asarray(x.transpose(0, 2, 3, 4, 1)), jnp.asarray(t), jnp.asarray(audio)))
        eps = port(_t(x), _t(t), _t(audio)).numpy()
    forcing.check(eps, ref.transpose(0, 4, 1, 2, 3), f"UNet {conf}")
    kinds = [k for k, _, _ in forcing.calls]
    # every InflatedConv2d ran as the int8 convolution, and, under
    # int8-dense, every projection of the attention blocks and FFs as K8
    assert kinds.count("conv") == sum(isinstance(m, p_unet3d.InflatedConv2d)
                                      for m in port.modules())
    assert kinds.count("dense") == (0 if conf == "int8" else sum(
        isinstance(m, torch.nn.Linear) for name, m in port.named_modules()
        if ".attn" in name or ".attention_blocks." in name or ".ff." in name))
    live = _rel_l2(eps_free, eps_float)
    assert live > MODEL_TOL, f"{conf}: rel L2 vs the float output only {live:.3g}"


@pytest.fixture(scope="module")
def vae_pair():
    port = init_random_(AutoencoderKL(pcfg.VAEConfig(**VAE_KW)), seed=5)
    return port, JVAE(JVAECfg(**VAE_KW)), convert_vae(
        {k: v.numpy() for k, v in port.state_dict().items()})


@pytest.mark.parametrize("method", ["encode", "decode"])
def test_vae_int8_matches_jax(vae_pair, monkeypatch, method):
    port, jax_model, params = vae_pair
    rng = np.random.default_rng(1)
    x = (rng.uniform(-1, 1, (2, 3, 32, 32)) if method == "encode"
         else rng.standard_normal((2, 4, 4, 4))).astype(np.float32)
    run = port.encode if method == "encode" else port.decode
    with torch.no_grad():
        _configure(monkeypatch, "float")
        out_float = run(_t(x)).numpy()
        _configure(monkeypatch, "int8")
        out_free = run(_t(x)).numpy()
        forcing = _QuantizerForcing(monkeypatch)
        ref = jax.jit(lambda p, v: jax_model.apply(
            p, v, method="moments" if method == "encode" else "decode"))(
                params, jnp.asarray(x.transpose(0, 2, 3, 1)))
        out = run(_t(x)).numpy()
    forcing.check(out, _nchw(ref[0] if method == "encode" else ref), f"VAE {method}")
    assert len(forcing.calls) == sum(
        isinstance(m, p_qc.QConv2d) for m in (port.encoder if method == "encode"
                                              else port.decoder).modules())
    live = _rel_l2(out_free, out_float)
    assert live > MODEL_TOL, f"VAE {method}: rel L2 vs the float output only {live:.3g}"


# the ops the UNet's blocks may call, by the kernel the reference would run
_BLOCK_OPS = ("self_attention_block", "cross_attention_block", "geglu_ffn",
              "self_attention_composed", "cross_attention_composed", "geglu_ffn_composed")


@pytest.mark.parametrize("env,called", [
    ({"LATENTSYNC_INT8": "1"},
     {"self_attention_block", "cross_attention_block", "geglu_ffn"}),
    ({"LATENTSYNC_INT8": "1", "LATENTSYNC_INT8_DENSE": "pallas"},
     {"self_attention_composed", "cross_attention_composed", "geglu_ffn_composed"}),
    ({"LATENTSYNC_INT8_DENSE": "1"},
     {"self_attention_composed", "cross_attention_composed", "geglu_ffn_composed"}),
    ({"LATENTSYNC_FUSED_ATTN": "0"},
     {"self_attention_composed", "cross_attention_composed", "geglu_ffn"}),
    ({"LATENTSYNC_FUSED_FFN": "0"},
     {"self_attention_block", "cross_attention_block", "geglu_ffn_composed"}),
])
def test_blocks_route_like_the_reference(monkeypatch, env, called):
    """K1/K2/K5 (the fused ops) never run under an int8 dense mode."""
    unet = init_random_(UNet3DConditionModel(_small_unet_config()), seed=4)
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = set()
    for name in _BLOCK_OPS:
        fn = getattr(p_unet3d, name)
        monkeypatch.setattr(p_unet3d, name,
                            lambda *a, _fn=fn, _name=name, **k: seen.add(_name) or _fn(*a, **k))
    with torch.no_grad():
        unet(torch.randn(1, 13, 2, 8, 8), torch.tensor([7]), torch.randn(1, 2, 5, 16))
    assert seen == called


def test_parameters_are_the_same_with_the_switches(monkeypatch):
    """Both int8 modes read the float parameters: the checkpoint layout and
    converters do not change."""
    def layout():
        torch.manual_seed(0)
        return ({k: v.shape for k, v in UNet3DConditionModel(_small_unet_config()).state_dict()
                 .items()},
                {k: v.shape for k, v in AutoencoderKL(pcfg.VAEConfig(**VAE_KW)).state_dict()
                 .items()})

    _configure(monkeypatch, "float")
    plain = layout()
    _configure(monkeypatch, "int8-dense")
    assert layout() == plain


# --------------------------------------------------------------------------
# the pipeline
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipeline():
    cfg = pcfg.LatentSyncConfig(
        unet=_small_unet_config(), vae=pcfg.VAEConfig(**VAE_KW),
        whisper=pcfg.WhisperConfig(n_audio_state=16, n_audio_head=2, n_audio_layer=1),
        data=pcfg.DataConfig(resolution=64))
    return LipsyncPipeline(init_random_(UNet3DConditionModel(cfg.unet), seed=11),
                           init_random_(AutoencoderKL(cfg.vae), seed=12),
                           Audio2Feature(init_random_(WhisperEncoder(cfg.whisper), seed=13)),
                           cfg, dtype=torch.float32, device="cpu")


def _denoise_args(seed=2, windows=1, frames=2):
    rng = np.random.default_rng(seed)
    lat = _t(rng.standard_normal((windows, frames, 8, 8, 4)).astype(np.float32))
    mask = torch.ones((windows, frames, 8, 8, 1))
    audio = _t(rng.standard_normal((windows, frames, 5, 16)).astype(np.float32))
    return lat, mask, 0.5 * lat, -0.5 * lat, audio


def test_pipeline_reads_the_int8_switches_at_each_call(pipeline, monkeypatch):
    """No stale state: flipping a switch between two calls of one pipeline
    changes its VAE and UNet outputs, and flipping it back restores them
    (the reference's jit caches miss LATENTSYNC_INT8 for the VAE and
    LATENTSYNC_INT8_DENSE for the denoise loop)."""
    rng = np.random.default_rng(3)
    faces = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    keep = np.ones((1, 64, 64, 3), np.float32)
    keep[:, 32:] = 0

    def run():
        zm, zr = pipeline._vae_encode_pair(faces, keep)
        lat = pipeline._denoise(*_denoise_args(), 2, 1.5)
        return zm.numpy(), lat.numpy(), pipeline._decode_u8(zr).numpy()

    outs = {}
    for conf in ("float", "int8", "int8-dense", "float"):
        _configure(monkeypatch, conf)
        outs.setdefault(conf, []).append(run())
    for name, i in (("VAE encode", 0), ("denoise", 1), ("VAE decode", 2)):
        assert not np.array_equal(outs["int8"][0][i], outs["float"][0][i]), name
        np.testing.assert_array_equal(outs["float"][1][i], outs["float"][0][i], err_msg=name)
    # the dense switch changes only the UNet
    assert not np.array_equal(outs["int8-dense"][0][1], outs["int8"][0][1])
    np.testing.assert_array_equal(outs["int8-dense"][0][0], outs["int8"][0][0])


@pytest.mark.parametrize("name,value,error", [
    # the values that used to be refused now run (1: DeepCache off)
    ("LATENTSYNC_DEEPCACHE", "4", None), ("LATENTSYNC_DEEPCACHE", "4:1:enc", None),
    ("LATENTSYNC_DEEPCACHE", "1", None), ("LATENTSYNC_CFG_INTERVAL", "0:0.5", None),
    ("LATENTSYNC_DEEPCACHE", "0", None), ("LATENTSYNC_DEEPCACHE", "", None),
    ("LATENTSYNC_CFG_INTERVAL", "", None),
    # malformed values raise the reference's ValueErrors
    ("LATENTSYNC_DEEPCACHE", "4:1:ecn", "third field"),
    ("LATENTSYNC_DEEPCACHE", "4:9:enc", "depth"),
    ("LATENTSYNC_CFG_INTERVAL", "0.5", "lo:hi"),
    ("LATENTSYNC_CFG_INTERVAL", "0.7:0.2", "lo <= hi"),
])
def test_pipeline_switch_values(pipeline, monkeypatch, name, value, error):
    _configure(monkeypatch, "float")
    monkeypatch.setenv(name, value)
    if error:
        with pytest.raises(ValueError, match=error):
            pipeline._denoise(*_denoise_args(), 4, 1.5)
    else:
        lat = pipeline._denoise(*_denoise_args(), 4, 1.5)
        assert lat.shape == (1, 2, 8, 8, 4) and math.isfinite(float(lat.abs().sum()))
