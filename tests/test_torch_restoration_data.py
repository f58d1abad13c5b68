"""The port's restoration-training infrastructure against the JAX package's,
on the CPU: the two restart schedules step by step, PSNR / SSIM, every
restoration loss (penalties with the JAX draws handed over), the LMDB
writer and reader in both directions byte for byte, ``FFHQBlindSource``
over a directory of PNGs and over an ``.lmdb``, the sampler and the
prefetcher, and the registries' names and the architectures' keyword
names (``_filter_kwargs`` keeps the keys the JAX dataclass has).

Schedules are Python floats in the port and f32 in the JAX package: 1e-6
relative, and 1e-6 of the base rate absolute (the cosine's cancellation
near its floor). Metrics and losses are f32 in both, summed in other orders:
1e-5 relative (1e-4 on SSIM's sums of window products). Data and bytes
are exact.
"""

import dataclasses
import inspect
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.models import codeformer as jcf
from latentsync_tpu.training import degradations as j_deg
from latentsync_tpu.training import file_client as j_fc
from latentsync_tpu.training import loader as j_loader
from latentsync_tpu.training import losses as j_losses
from latentsync_tpu.training import lr_schedules as j_lr
from latentsync_tpu.training import metrics as j_metrics
from latentsync_tpu.training import registry as j_reg
from latentsync_tpu_torch.models import codeformer as pcf
from latentsync_tpu_torch.training import degradations as p_deg
from latentsync_tpu_torch.training import file_client as p_fc
from latentsync_tpu_torch.training import loader as p_loader
from latentsync_tpu_torch.training import losses as p_losses
from latentsync_tpu_torch.training import lr_schedules as p_lr
from latentsync_tpu_torch.training import metrics as p_metrics
from latentsync_tpu_torch.training import option_trainer as p_ot
from latentsync_tpu_torch.training import registry as p_reg

from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)


SCHED_RTOL = 1e-6
RTOL = 1e-5


@pytest.mark.parametrize("kw", [
    dict(milestones=[10, 20, 45], gamma=0.5, restarts=[0, 30, 50], restart_weights=[1, 0.5, 0.2]),
    dict(milestones=[400, 450], gamma=0.5),
])
def test_multistep_restart_schedule_matches_jax(kw):
    j, p = j_lr.multistep_restart_lr(7.2e-5, **kw), p_lr.multistep_restart_lr(7.2e-5, **kw)
    for step in range(0, 500):
        np.testing.assert_allclose(p(step), float(j(step)), rtol=SCHED_RTOL)


@pytest.mark.parametrize("kw", [dict(periods=[10, 20, 5], restart_weights=[1.0, 0.5, 0.25]),
                                dict(periods=[7], eta_min=1e-6)])
def test_cosine_restart_schedule_matches_jax(kw):
    j = j_lr.cosine_annealing_restart_lr(1e-4, **kw)
    p = p_lr.cosine_annealing_restart_lr(1e-4, **kw)
    for step in range(0, 50):
        np.testing.assert_allclose(p(step), float(j(step)), rtol=SCHED_RTOL,
                                   atol=SCHED_RTOL * 1e-4)
    w_j, w_p = j_lr.warmup_wrap(j, 4, 0.1), p_lr.warmup_wrap(p, 4, 0.1)
    for step in range(0, 12):
        np.testing.assert_allclose(w_p(step), float(w_j(step)), rtol=SCHED_RTOL,
                                   atol=SCHED_RTOL * 1e-4)


def test_psnr_and_ssim_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 255, (40, 36, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 12, a.shape), 0, 255).astype(np.float32)
    np.testing.assert_allclose(p_metrics.psnr(a, b), j_metrics.psnr(a, b), rtol=RTOL)
    np.testing.assert_allclose(p_metrics.ssim(a, b), j_metrics.ssim(a, b), rtol=1e-4)
    np.testing.assert_allclose(p_metrics.ssim(a[None], b[None]), j_metrics.ssim(a, b), rtol=1e-4)
    assert p_metrics.psnr(a, a) == j_metrics.psnr(a, a)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def test_image_and_gan_losses_match_jax():
    rng = np.random.default_rng(1)
    x, y = (rng.standard_normal((2, 9, 7, 3)).astype(np.float32) for _ in range(2))
    mask = (rng.uniform(size=(2, 9, 7, 1)) > 0.5).astype(np.float32)
    pairs = [
        (p_losses.masked_l1(_nchw(x), _nchw(y)), j_losses.masked_l1(x, y)),
        (p_losses.masked_l1(_nchw(x), _nchw(y), _nchw(mask)), j_losses.masked_l1(x, y, mask)),
        (p_losses.charbonnier(_nchw(x), _nchw(y)), j_losses.charbonnier(x, y)),
        (p_losses.total_variation(_nchw(x)), j_losses.total_variation(x)),
    ]
    for mode in ("vanilla", "lsgan", "hinge", "wgan"):
        for real in (True, False):
            pairs.append((p_losses.gan_loss(_nchw(x), real, mode),
                          j_losses.gan_loss(jnp.asarray(x), real, mode)))
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=1e-7)
    with pytest.raises(ValueError):
        p_losses.gan_loss(_nchw(x), True, "nope")


def _tiny_disc():
    """A small discriminator in both packages with the same weights."""
    from test_torch_codeformer import load_port, random_variables

    jd = jcf.VQGANDiscriminator(ndf=8, n_layers=2)
    dv = random_variables(jd, jnp.zeros((1, 32, 32, 3)), seed=4)
    return (lambda p, z: jd.apply(p, z)), dv, load_port(pcf.VQGANDiscriminator(ndf=8, n_layers=2),
                                                        dv)


def test_gradient_penalties_match_jax():
    """R1 and WGAN-GP on a small discriminator, the interpolation weights
    drawn by the JAX function's key and handed to the port; and each is
    differentiable in the discriminator's weights."""
    j_fn, dv, port = _tiny_disc()
    rng = np.random.default_rng(2)
    real, fake = (rng.standard_normal((2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    disc = lambda z: port(z)  # noqa: E731
    got = p_losses.r1_penalty(disc, _nchw(real))
    np.testing.assert_allclose(float(got.detach()), float(j_losses.r1_penalty(j_fn, dv, jnp.asarray(real))),
                               rtol=1e-4)
    key = jax.random.PRNGKey(3)
    alpha = np.array(jax.random.uniform(key, (2, 1, 1, 1)))
    gp = p_losses.gradient_penalty_loss(disc, _nchw(real), _nchw(fake),
                                        alpha=torch.from_numpy(alpha))
    want = j_losses.gradient_penalty_loss(j_fn, dv, jnp.asarray(real), jnp.asarray(fake), key)
    np.testing.assert_allclose(float(gp.detach()), float(want), rtol=1e-4)
    (got + gp).backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in port.parameters() if p.dim() > 1)


def test_path_length_regularizer_matches_jax():
    """A linear 'generator' fake = latents @ W, whose Jacobian-vector grad
    each package builds its own way, with the JAX noise handed over."""
    rng = np.random.default_rng(5)
    lat = rng.standard_normal((2, 6)).astype(np.float32)
    w = rng.standard_normal((6, 4 * 5 * 3)).astype(np.float32)
    fake_j = (lat @ w).reshape(2, 4, 5, 3)
    key = jax.random.PRNGKey(7)

    def j_grad(noise):
        return jax.grad(lambda z: jnp.sum((z @ w).reshape(2, 4, 5, 3) * noise))(jnp.asarray(lat))

    want = j_losses.g_path_regularize(jnp.asarray(fake_j), j_grad, 0.5, rng=key)
    noise = np.array(jax.random.normal(key, fake_j.shape)) / np.sqrt(4 * 5)
    lat_t = torch.from_numpy(lat).requires_grad_(True)
    fake_p = (lat_t @ torch.from_numpy(w)).reshape(2, 4, 5, 3).permute(0, 3, 1, 2)
    noise_p = torch.from_numpy(np.ascontiguousarray(np.transpose(noise, (0, 3, 1, 2))))

    def p_grad(n):
        return torch.autograd.grad((fake_p * n).sum(), lat_t, create_graph=True)[0]

    got = p_losses.g_path_regularize(fake_p, p_grad, 0.5, noise=noise_p)
    for g, j in zip(got, want):
        np.testing.assert_allclose(float(g.detach()), float(j), rtol=1e-5)


def _pairs():
    rng = np.random.default_rng(0)
    pairs = [(f"key-{i:04d}", (f"payload-{i}-" * 7).encode()) for i in range(300)]
    pairs += [(f"img{i}", rng.bytes(3000 + 4096 * i)) for i in range(3)]
    return pairs


@pytest.mark.parametrize("psize", [4096, 512])
def test_lmdb_written_by_one_package_reads_in_the_other(tmp_path, psize):
    """The port writes and the JAX package reads, then the other way; the
    two writers' files are the same bytes."""
    pairs = _pairs()
    paths = {}
    for name, fc in (("port", p_fc), ("jax", j_fc)):
        paths[name] = str(tmp_path / f"{name}.lmdb")
        w = fc.LmdbWriter(paths[name], psize=psize)
        for k, v in pairs:
            w.put(k, v)
        w.close()
    for written, reader in (("port", j_fc.LmdbReader), ("jax", p_fc.LmdbReader)):
        r = reader(paths[written])
        for k, v in pairs:
            assert r.get(k.encode()) == v
        assert r.entries == len(pairs)
        r.close()
    for f in os.listdir(paths["jax"]):
        with open(os.path.join(paths["jax"], f), "rb") as a, \
                open(os.path.join(paths["port"], f), "rb") as b:
            assert a.read() == b.read(), f


def _faces(root, n=3, size=96):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(11)
    for i in range(n):
        img = np.full((size, size, 3), 80, np.uint8)
        cv2.ellipse(img, (size // 2, size // 2), (size // 4, size // 3), 0, 0, 360,
                    (190, 150, 130), -1)
        cv2.imwrite(os.path.join(root, f"f{i}.png"),
                    cv2.add(img, rng.integers(0, 30, img.shape, dtype=np.uint8)))
    return sorted(os.listdir(root))


def test_ffhq_blind_source_matches_jax_over_a_dir_and_an_lmdb(tmp_path):
    src = str(tmp_path / "faces")
    names = _faces(src)
    db = str(tmp_path / "faces.lmdb")
    p_fc.make_lmdb_from_imgs(src, db, names, [n[:-4] for n in names])
    assert p_fc.read_lmdb_meta(db) == j_fc.read_lmdb_meta(db)
    for root in (src, db):
        j_src = j_deg.FFHQBlindSource(root, j_deg.BlindDegradationConfig(gt_size=64), seed=3)
        p_src = p_deg.FFHQBlindSource(root, p_deg.BlindDegradationConfig(gt_size=64), seed=3)
        for _ in range(4):
            a, b = j_src.sample(), p_src.sample()
            for key in ("lq", "gt"):
                assert a[key].shape == (64, 64, 3) and np.array_equal(a[key], b[key])
    img = np.random.default_rng(1).uniform(0, 255, (20, 17, 3))
    for scale in (0.5, 2.0, 0.3):
        np.testing.assert_array_equal(p_deg.imresize_matlab(img, scale),
                                      j_deg.imresize_matlab(img, scale))


def test_sampler_and_prefetcher_match_jax():
    for kw in (dict(num_samples=10, world_size=4, rank=1, ratio=2, seed=3),
               dict(num_samples=7, shuffle=False)):
        j, p = j_loader.EnlargedSampler(**kw), p_loader.EnlargedSampler(**kw)
        for epoch in range(3):
            j.set_epoch(epoch)
            p.set_epoch(epoch)
            assert list(p) == list(j) and len(p) == len(j)
        assert list(p_loader.batched_indices(p, 3, drop_last=False)) == \
            list(j_loader.batched_indices(j, 3, drop_last=False))

    def make(idx):
        return {"x": np.full((2, 3), sum(idx), np.float32)}

    j_batches = list(j_loader.Prefetcher(j_loader.batched_indices(range(9), 2), make))
    p_batches = list(p_loader.Prefetcher(p_loader.batched_indices(range(9), 2), make,
                                         device="cpu"))
    assert len(p_batches) == len(j_batches) == 4
    for a, b in zip(j_batches, p_batches):
        assert torch.is_tensor(b["x"]) and np.array_equal(b["x"].numpy(), a["x"])

    def broken(idx):
        raise RuntimeError("bad sample")

    with pytest.raises(RuntimeError, match="bad sample"):
        list(p_loader.Prefetcher(iter([[0]]), broken))


def test_registries_and_architecture_keywords_match_jax():
    """The same names in every registry; and each restoration architecture
    takes exactly the JAX dataclass's fields as keywords, which is what
    ``_filter_kwargs`` keeps."""
    j_reg.register_builtin()
    p_reg.register_builtin()
    for name in ("ARCH_REGISTRY", "LOSS_REGISTRY", "METRIC_REGISTRY", "SCHEDULER_REGISTRY",
                 "DATASET_REGISTRY"):
        assert sorted(getattr(p_reg, name)._map) == sorted(getattr(j_reg, name)._map)
    for name in ("CodeFormer", "VQAutoEncoder", "VQGANDiscriminator"):
        j_cls, p_cls = j_reg.ARCH_REGISTRY.get(name), p_reg.ARCH_REGISTRY.get(name)
        fields = {f.name for f in dataclasses.fields(j_cls)} - {"dtype", "parent", "name"}
        assert set(inspect.signature(p_cls).parameters) == fields
        opts = {f: 1 for f in fields} | {"fidelity_weight": 0, "blur_sigma": [1, 2]}
        assert set(p_ot._filter_kwargs(p_cls, opts)) == fields
    assert p_reg.build_from_options(p_reg.ARCH_REGISTRY, {"type": "VQGANDiscriminator",
                                                          "ndf": 4}).main[0].out_channels == 4
    with pytest.raises(KeyError):
        p_reg.build_from_options(p_reg.ARCH_REGISTRY, {"type": "Nope"})
