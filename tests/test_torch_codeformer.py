"""The port's CodeFormer / VQGAN stack against the JAX package's, on the CPU.

The JAX modules get seeded non-zero random variables (numpy), which
``utils/convert.py`` ``codeformer_state_dict_from_flax`` carries into the
port's modules; ``position_emb``, which both packages zero-initialise, is
filled too, so a wrong positional term shows. The tolerances are
``tests/test_parity_codeformer.py``'s: 5e-4 on features and logits, 5e-3
on images, equal code indices. The transformer stack runs at (2, 256, 128)
with 2 heads, D = 64: the flash route's shape on the card (its plain
version here), as CodeFormer's 8 heads of 64 at full width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.models import codeformer as jcf
from latentsync_tpu.utils.convert_codeformer import convert_codeformer
from latentsync_tpu_torch.models import codeformer as pcf
from latentsync_tpu_torch.ops import attention as p_attn
from latentsync_tpu_torch.utils import convert as pconv

FEAT_TOL = 5e-4
IMG_TOL = 5e-3

SMALL = dict(dim_embd=16, n_head=2, n_layers=2, codebook_size=16, latent_size=256,
             connect_list=("32", "64", "128", "256"), img_size=512, nf=2,
             ch_mult=(1, 2, 2, 4, 4, 8), emb_dim=8)
VQ_SMALL = dict(img_size=32, nf=8, ch_mult=(1, 2), res_blocks=2, attn_resolutions=(16,),
                codebook_size=16, emb_dim=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small tensors: about as fast
    alone, and the parallel test workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_variables(model, *args, seed: int, **kw):
    """The model's variables with every leaf seeded and non-zero: kernels
    N(0, 1/fan_in), biases N(0, 0.02²), norm scales 1 + N(0, 0.1²),
    codebooks and positions N(0, 1), running means N(0, 0.1²), running
    variances 1 + |N(0, 0.3²)|."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args, **kw))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = 1 + 0.1 * rng.standard_normal(shape)
        elif name in ("embedding", "embed", "position_emb"):
            v = rng.standard_normal(shape)
        elif name == "mean":
            v = 0.1 * rng.standard_normal(shape)
        elif name == "var":
            v = 1 + np.abs(0.3 * rng.standard_normal(shape))
        else:
            v = 0.02 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def load_port(module, variables):
    sd = pconv.codeformer_state_dict_from_flax(variables)
    module.load_state_dict(sd)
    return module.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def codeformer_pair():
    jmodel = jcf.CodeFormer(**SMALL)
    x = np.random.default_rng(3).uniform(-1, 1, (1, 512, 512, 3)).astype(np.float32)
    variables = random_variables(jmodel, jnp.zeros((1, 512, 512, 3)), seed=11)
    assert np.abs(variables["params"]["position_emb"]).min() > 0
    port = load_port(pcf.CodeFormer(**SMALL), variables)
    apply = jax.jit(lambda v, x, w: jmodel.apply(v, x, w), static_argnums=())
    return jmodel, variables, port, x, apply


@pytest.mark.parametrize("w", [0.0, 0.5, 1.0])
def test_codeformer_matches_jax(codeformer_pair, w):
    _, variables, port, x, apply = codeformer_pair
    j_out, j_logits, j_lq = apply(variables, jnp.asarray(x), w)
    with torch.no_grad():
        out, logits, lq = port(nchw(x), w=w)
    close(nhwc(lq), j_lq, FEAT_TOL)
    close(logits.numpy(), j_logits, FEAT_TOL)
    assert (logits.numpy().argmax(-1) == np.asarray(j_logits).argmax(-1)).all()
    close(nhwc(out), j_out, IMG_TOL)


def test_codeformer_fidelity_weight_moves_the_output(codeformer_pair):
    """w = 0 leaves the fuse blocks adding exactly zero; w = 1 does not."""
    _, _, port, x, _ = codeformer_pair
    with torch.no_grad():
        zero, _, _ = port(nchw(x), w=0.0)
        one, _, _ = port(nchw(x), w=1.0)
        port_nofuse = pcf.CodeFormer(**{**SMALL, "connect_list": ()})
        port_nofuse.load_state_dict(port.state_dict(), strict=False)
        plain, _, _ = port_nofuse.eval()(nchw(x))
    assert torch.equal(zero, plain)
    assert not torch.allclose(zero, one)


def test_codeformer_adain_and_code_only_match_jax(codeformer_pair):
    jmodel, variables, port, x, _ = codeformer_pair
    j_out, _, _ = jax.jit(lambda v, x: jmodel.apply(v, x, 0.5, adain=True))(variables,
                                                                            jnp.asarray(x))
    j_logits, j_lq = jax.jit(lambda v, x: jmodel.apply(v, x, code_only=True))(variables,
                                                                              jnp.asarray(x))
    with torch.no_grad():
        out, _, _ = port(nchw(x), w=0.5, adain=True)
        logits, lq = port(nchw(x), code_only=True)
    close(nhwc(out), j_out, IMG_TOL)
    close(logits.numpy(), j_logits, FEAT_TOL)
    close(nhwc(lq), j_lq, FEAT_TOL)


def test_adaptive_instance_norm_uses_the_population_variance():
    rng = np.random.default_rng(5)
    c, s = rng.standard_normal((2, 4, 6, 5, 3)).astype(np.float32)
    got = pcf.adaptive_instance_norm(nchw(c), nchw(s))
    close(nhwc(got), jcf.adaptive_instance_norm(jnp.asarray(c), jnp.asarray(s)), 1e-5)


@pytest.mark.parametrize("quantizer", ["nearest", "gumbel"])
def test_vq_autoencoder_matches_jax(quantizer):
    jmodel = jcf.VQAutoEncoder(quantizer=quantizer, **VQ_SMALL)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    variables = random_variables(jmodel, jnp.zeros((1, 32, 32, 3)), seed=5)
    port = load_port(pcf.VQAutoEncoder(quantizer=quantizer, **VQ_SMALL), variables)
    j_rec, j_loss, j_idx = jmodel.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        rec, loss, idx = port(nchw(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    close(nhwc(rec), j_rec, IMG_TOL)
    close(loss.numpy(), j_loss, FEAT_TOL)


def test_transformer_stack_at_head_dim_64_matches_jax():
    """Two layers at (2, 256, 128) with 2 heads: D = 64, S = 256, the flash
    route's shape (the port's route runs its plain version on the CPU)."""
    b, t, c, heads = 2, 256, 128, 2
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    pos = rng.standard_normal((1, t, c)).astype(np.float32)
    layers = [jcf.TransformerSALayer(c, heads, 2 * c) for _ in range(2)]
    variables = [random_variables(m, jnp.zeros((1, t, c)), jnp.zeros((1, t, c)), seed=20 + i)
                 for i, m in enumerate(layers)]
    ref = jnp.asarray(x)
    for m, v in zip(layers, variables):
        ref = m.apply(v, ref, jnp.asarray(pos))
    stack = torch.nn.Sequential(*[pcf.TransformerSALayer(c, heads, 2 * c) for _ in range(2)])
    sd = {}
    for i, v in enumerate(variables):
        tree = {"params": {f"ft_layers_{i}": v["params"]}}
        sd.update({k.removeprefix("ft_layers."): w for k, w in
                   pconv.codeformer_state_dict_from_flax(tree).items()})
    stack.load_state_dict(sd)
    before = p_attn.dot_product_attention.launches
    with torch.no_grad():
        h = torch.from_numpy(x)
        for layer in stack:
            assert p_attn.flash_route(torch.zeros(b, t, heads, c // heads),
                                      torch.zeros(b, t, heads, c // heads))
            h = layer(h, torch.from_numpy(pos))
    assert p_attn.dot_product_attention.launches == before  # no kernel on the CPU
    close(h.numpy(), ref, FEAT_TOL)


def test_discriminator_matches_jax():
    jmodel = jcf.VQGANDiscriminator(ndf=8, n_layers=3)
    x = np.random.default_rng(2).standard_normal((1, 64, 64, 3)).astype(np.float32)
    variables = random_variables(jmodel, jnp.zeros((1, 64, 64, 3)), seed=9)
    port = load_port(pcf.VQGANDiscriminator(ndf=8, n_layers=3), variables)
    with torch.no_grad():
        got = port(nchw(x))
    close(nhwc(got), jmodel.apply(variables, jnp.asarray(x)), FEAT_TOL)


def test_converter_round_trip(codeformer_pair):
    """The port's state dict, through the JAX package's own converter, is the
    JAX parameter tree it came from, leaf for leaf; and every key of the
    port's CodeFormer (the upstream layout) is produced."""
    _, variables, port, _, _ = codeformer_pair
    sd = pconv.codeformer_state_dict_from_flax(variables)
    assert set(sd) == set(port.state_dict())
    back = convert_codeformer({k: v.numpy() for k, v in sd.items()})
    want = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back["params"])[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))


def test_cast_floating_keeps_norms_in_f32():
    port = pcf.cast_floating_(pcf.CodeFormer(**SMALL), torch.bfloat16)
    norms = {id(p) for m in port.modules() if isinstance(m, (torch.nn.GroupNorm,
                                                             torch.nn.LayerNorm))
             for p in m.parameters()}
    assert len(norms) > 100
    for name, p in port.named_parameters():
        assert p.dtype == (torch.float32 if id(p) in norms else torch.bfloat16), name
