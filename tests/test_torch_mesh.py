"""Serving across ranks (``latentsync_tpu_torch/parallel/mesh.py``'s data and
model axes) against the JAX package's single-device results, on the CPU.

The tiny f32 pipeline of ``tests/test_mesh_serving.py`` (UNet 32/64/64/64,
one layer a block, 4 frames of 8² latents, 4 windows), with the port's
seeded non-zero weights carried into flax by the JAX package's converter.
``latentsync_tpu_torch.scripts.mesh_serving`` runs under ``python -m
torch.distributed.run`` on two gloo ranks (dp 2) and on four (dp 2 × tp
2); each layout's UNet forward and 3-step CFG ``_denoise`` (gathered back
to rank 0) is held against the JAX package's jitted forward and
``_denoise_fn`` at that file's tolerance, ``atol=2e-4, rtol=2e-3``; two more
launches at dp 1 × tp 2 serve the fused configuration with the FLOP cuts
and the int8-dense one, each against its own single-rank run. The
port's sharded parameters are the JAX rule's (``param_tp_sharding`` at tp
2 over the flax tree, mapped through ``unet_state_dict_from_flax``), more
than 10 of them; windows the data axis does not divide raise; a plain
``Linear`` / ``Conv2d`` computes its own output shard.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu import config as jcfg
from latentsync_tpu.audio.features import Audio2Feature
from latentsync_tpu.models.vae import AutoencoderKL as JVAE
from latentsync_tpu.parallel.mesh import make_mesh as jax_make_mesh
from latentsync_tpu.parallel.mesh import param_tp_sharding as jax_param_tp_sharding
from latentsync_tpu.pipelines.lipsync import LipsyncPipeline as JPipeline
from latentsync_tpu.utils.convert import convert_unet
from latentsync_tpu.utils.params import fast_init
from latentsync_tpu_torch import config as pcfg
from latentsync_tpu_torch.models.unet3d import UNet3DConditionModel
from latentsync_tpu_torch.parallel import mesh as pm
from latentsync_tpu_torch.utils.convert import init_random_, unet_state_dict_from_flax

from test_torch_flop_cuts import FAST_COMPILE, _configs, _sd
from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_mesh_serving.py's tolerance
ATOL, RTOL = 2e-4, 2e-3
W, F_, LAT, STEPS, GUIDANCE = 4, 4, 8, 3, 1.5
LAUNCHES = {2: "2x1", 4: "2x2"}  # ranks: the layout they serve
# the other served configurations at dp 1 × tp 2, each against the launch's
# own single-rank run in the same switches: (switches, relative L2 bound).
# On the CPU both are deterministic at tp 2: the output shards are gathered
# exactly and the int8 route quantizes the whole gathered weight, so the
# int8 configuration is held as tightly as the float one (0.0 was read)
CONFIG_LAUNCHES = {
    "fused+cuts": ({"LATENTSYNC_PALLAS_GN": "1", "LATENTSYNC_FUSED_XATTN": "1",
                    "LATENTSYNC_DEEPCACHE": "2:1:enc", "LATENTSYNC_CFG_INTERVAL": "0:0.5"}, 1e-5),
    "int8-dense": ({"LATENTSYNC_INT8": "1", "LATENTSYNC_INT8_DENSE": "pallas"}, 1e-5),
}
SWITCHES = ("LATENTSYNC_PALLAS_GN", "LATENTSYNC_FUSED_XATTN", "LATENTSYNC_DEEPCACHE",
            "LATENTSYNC_CFG_INTERVAL", "LATENTSYNC_INT8", "LATENTSYNC_INT8_DENSE")


def _inputs():
    rng = np.random.default_rng(5)
    n = rng.standard_normal
    return {"latents0": n((W, F_, LAT, LAT, 4)), "mask": np.ones((W, F_, LAT, LAT, 1)),
            "masked": n((W, F_, LAT, LAT, 4)), "ref": n((W, F_, LAT, LAT, 4)),
            "audio": n((W, F_, 10, 16)), "sample": n((W, F_, LAT, LAT, 13)),
            "t": np.full((W,), 317), "audio2": n((W, F_, 10, 16))}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every launch's results (started first, so that they run while the
    JAX references compile) and the JAX references."""
    tmp = tmp_path_factory.mktemp("mesh")
    cfg = _configs(pcfg)
    port = init_random_(UNet3DConditionModel(cfg.unet), seed=11).eval()
    x = _inputs()
    inputs = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in x.items()}
    inputs["sample"] = inputs["sample"].permute(0, 4, 1, 2, 3).contiguous()
    inputs["t"] = inputs["t"].long()
    payload = str(tmp / "payload.pt")
    torch.save({"config": cfg, "unet": port.state_dict(), "inputs": inputs, "steps": STEPS,
                "guidance": GUIDANCE}, payload)
    base = {k: v for k, v in os.environ.items() if k not in SWITCHES}
    base["PYTHONPATH"] = REPO
    launches = [(ranks, layout, {}, None) for ranks, layout in LAUNCHES.items()]
    launches += [(name, "1x2", switches, tol)
                 for name, (switches, tol) in CONFIG_LAUNCHES.items()]
    procs = {}
    for key, layout, switches, tol in launches:
        out = str(tmp / f"out{key}.pt")
        ranks = key if isinstance(key, int) else 2
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
               str(ranks), "-m", "latentsync_tpu_torch.scripts.mesh_serving", "--device", "cpu",
               "--payload", payload, "--out", out, "--layouts", layout]
        cmd += ["--tol", str(tol)] if tol else []
        procs[key] = (subprocess.Popen(cmd, cwd=REPO, env=dict(base, **switches),
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True), out)

    jc = _configs(jcfg)
    params = convert_unet(_sd(port), 13, 4, 16)
    vae = JVAE(jc.vae)
    vae_params = fast_init(lambda v: vae.init(jax.random.PRNGKey(0), v, jax.random.PRNGKey(1)),
                           jnp.zeros((1, 16, 16, 3)), seed=3)
    pipe = JPipeline(params, vae_params, Audio2Feature(jcfg.WhisperConfig(
        n_audio_state=16, n_audio_head=4, n_audio_layer=1)), jc, dtype=jnp.float32)
    f32 = {k: np.asarray(v, np.float32) for k, v in x.items()}
    fargs = (params, f32["sample"], x["t"].astype(np.int32), f32["audio2"])
    fwd = jax.jit(pipe.unet.apply).lower(*fargs).compile(FAST_COMPILE)
    jax_fwd = np.asarray(fwd(*fargs)).transpose(0, 4, 1, 2, 3)
    dargs = (params, f32["latents0"], f32["mask"], f32["masked"], f32["ref"], f32["audio"])
    dn = pipe._denoise_fn(STEPS, GUIDANCE, True).lower(*dargs).compile(FAST_COMPILE)
    jax_dn = np.asarray(dn(*dargs))

    results = {}
    for ranks, (proc, out) in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stdout[-3000:] + stderr[-3000:]
        results[ranks] = (torch.load(out), stdout)
    return results, jax_fwd, jax_dn


@pytest.mark.parametrize("ranks", sorted(LAUNCHES))
@pytest.mark.parametrize("what", ["forward", "denoise"])
def test_mesh_serving_matches_jax_single_device(served, ranks, what):
    results, jax_fwd, jax_dn = served
    got, stdout = results[ranks]
    ref = jax_fwd if what == "forward" else jax_dn
    assert '"ok": true' in stdout, stdout
    layout = got[LAUNCHES[ranks]][what].numpy()
    np.testing.assert_allclose(layout, ref, atol=ATOL, rtol=RTOL)
    # the launch's own single-rank run agrees too
    np.testing.assert_allclose(got["single"][what].numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(CONFIG_LAUNCHES))
@pytest.mark.parametrize("what", ["forward", "denoise"])
def test_mesh_serves_every_configuration(served, name, what):
    """Every configuration that serves on one rank serves under the mesh:
    the fused kernels' switches with DeepCache and the CFG interval, and
    the int8 convolutions with K8's dense route, each at dp 1 × tp 2
    against the launch's single-rank run in the same switches."""
    results = served[0]
    got, stdout = results[name]
    tol = CONFIG_LAUNCHES[name][1]
    assert '"ok": true' in stdout, stdout
    layout, single = got["1x2"][what].double(), got["single"][what].double()
    assert torch.isfinite(layout).all()
    assert float((layout - single).norm() / single.norm()) <= tol


def test_sharded_set_is_the_jax_rule():
    cfg = _configs(pcfg)
    port = UNet3DConditionModel(cfg.unet)
    params = convert_unet(_sd(port), 13, 4, 16)
    specs = jax_param_tp_sharding(jax_make_mesh(8, model_parallel=2), params)
    # a flax tree of 1.0 where the JAX rule shards, through the converter
    marks = jax.tree.map(lambda p, s: np.full(p.shape, float(any(a is not None for a in s.spec)),
                                              np.float32), params, specs)
    jax_set = {k for k, v in unet_state_dict_from_flax(marks).items() if bool(v.all())}
    mesh = pm.Mesh(dp=4, tp=2)
    port_set = {k for k, s in pm.param_tp_sharding(mesh, port).items() if s.sharded}
    assert len(jax_set) > 10
    assert port_set == jax_set


def test_windows_must_divide_the_data_axis():
    mesh = pm.Mesh(dp=2, tp=1)
    with pytest.raises(ValueError, match="does not split"):
        pm.data_parallel_call(mesh, lambda a: a, torch.zeros(3, 2))
    assert pm.batch_sharding(mesh).piece(4) == slice(0, 2)
    assert pm.batch_sharding(pm.Mesh(dp=2, tp=1, rank=1)).piece(4) == slice(2, 4)


def test_one_rank_mesh_without_a_process_group():
    assert pm.make_mesh() == pm.Mesh()
    with pytest.raises(RuntimeError, match="no process group"):
        pm.make_mesh(2, model_parallel=2)
    lin = torch.nn.Linear(4, 16)
    assert pm.tensor_parallel_(lin, pm.Mesh()) == []


def test_plain_layers_compute_their_output_shard():
    """At tp 2 (rank 1 of a row, the gather stubbed by the rank's own piece
    twice), a Linear, a Conv2d and the 5-D per-frame form of an
    InflatedConv2d keep half their weight and compute rank 1's output
    channels from it; a read of the weight gathers the whole."""
    from latentsync_tpu_torch.models.unet3d import InflatedConv2d

    mesh = pm.Mesh(dp=1, tp=2, rank=1)
    torch.manual_seed(0)
    cases = [(torch.nn.Linear(8, 16), torch.randn(3, 8)),
             (torch.nn.Conv2d(4, 16, 3, padding=1), torch.randn(2, 4, 5, 5)),
             (InflatedConv2d(4, 16, 3, padding=1), torch.randn(2, 4, 3, 5, 5))]
    gathered = []
    orig = pm.all_gather

    def stub(t, m, axis, dim):
        gathered.append((axis, dim))
        return torch.cat([t, t], dim=dim)

    pm.all_gather = stub
    try:
        for mod, x in cases:
            with torch.no_grad():
                want = mod(x)
            half = mod.weight.shape[0] // 2
            names = pm.tensor_parallel_(mod, mesh)
            assert names == ["weight"]
            assert mod.parametrizations.weight.original.shape[0] == half
            with torch.no_grad():
                got = mod(x)
            dim = -1 if isinstance(mod, torch.nn.Linear) else 1
            mine = want.narrow(dim % want.dim(), half, half)
            torch.testing.assert_close(got.narrow(dim % got.dim(), half, half), mine)
            assert mod.weight.shape[0] == 2 * half  # the read gathers
    finally:
        pm.all_gather = orig
    assert gathered and all(axis == "model" for axis, _ in gathered)
