"""The port's whisper text decoder and decodes against the JAX package.

On the CPU in float32, with ``tests/test_whisper_decoder.py``'s tiny
``WhisperConfig`` shapes (vocab 200, text context 32, width 64, 4 heads,
2 layers): random non-zero weights made by the port's ``init_random_``
and carried into flax by the JAX package's ``convert_whisper_decoder``,
the same numpy-seeded tokens and audio features on both sides.

Tolerances: logits within 1e-4 relative to their largest magnitude (sums
in another order); a KV-cached step within the same of the full forward;
the logit filters exactly (masks, and -inf where the JAX package puts
it); greedy and beam tokens identical at t = 0, and their average
log-probabilities within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.config import WhisperConfig as JWhisperConfig
from latentsync_tpu.models import whisper_decoder as jwd
from latentsync_tpu.ops.attention import dot_product_attention as j_attention
from latentsync_tpu_torch.config import WhisperConfig
from latentsync_tpu_torch.models import whisper_decoder as pwd
from latentsync_tpu_torch.ops.attention import dot_product_attention as p_attention
from latentsync_tpu_torch.utils.convert import init_random_, whisper_decoder_state_dict_from_flax

DIMS = dict(n_audio_state=64, n_audio_head=4, n_audio_layer=2, n_vocab=200, n_text_ctx=32,
            n_text_state=64, n_text_head=4, n_text_layer=2)
TINY, JTINY = WhisperConfig(**DIMS), JWhisperConfig(**DIMS)
LOGIT_RTOL, LP_TOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def pair():
    port = init_random_(pwd.WhisperTextDecoder(TINY), seed=5).eval()
    state = {"decoder." + k: v.numpy() for k, v in port.state_dict().items()}
    params = jwd.convert_whisper_decoder(state)
    return port, jwd.WhisperTextDecoder(JTINY), params


def _xa(seed, b=2, ta=9, scale=0.3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, ta, TINY.n_text_state)) * scale).astype(np.float32)


def _close(got, want, rtol=LOGIT_RTOL):
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def test_decoder_converter_round_trip(pair):
    port, _, params = pair
    back = whisper_decoder_state_dict_from_flax(params)
    own = port.state_dict()
    assert set(back) == set(own)
    for k, v in own.items():
        assert torch.equal(back[k], v), k
    fresh = pwd.WhisperTextDecoder(TINY)
    fresh.load_state_dict(back)  # the upstream layout loads as is


def test_attention_with_mask_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    k = rng.standard_normal((2, 7, 3, 8)).astype(np.float32)
    v = rng.standard_normal((2, 7, 3, 8)).astype(np.float32)
    mask = np.where(rng.random((1, 1, 5, 7)) > 0.3, 0.0, -np.inf).astype(np.float32)
    mask[..., 0] = 0.0  # every row keeps one key
    mask[..., 1] = 0.7  # and an additive value that is no mask
    want = np.asarray(j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  mask=jnp.asarray(mask)))
    got = p_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                      mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_teacher_forced_logits_match_jax(pair):
    port, jdec, params = pair
    tokens = np.random.default_rng(0).integers(0, TINY.n_vocab, (2, 7))
    xa = _xa(1, ta=11)
    want = np.asarray(jdec.apply(params, jnp.asarray(tokens), jnp.asarray(xa)))
    with torch.no_grad():
        got = port(torch.from_numpy(tokens), torch.from_numpy(xa)).numpy()
    assert got.shape == (2, 7, TINY.n_vocab) and got.dtype == np.float32
    _close(got, want)


def test_step_matches_full_forward(pair):
    """KV-cached single-token steps give the teacher-forced logits position
    by position, and the JAX package's steps."""
    port, jdec, params = pair
    n = 6
    tokens = np.random.default_rng(2).integers(0, TINY.n_vocab, (2, n))
    xa = _xa(3)
    with torch.no_grad():
        full = port(torch.from_numpy(tokens), torch.from_numpy(xa)).numpy()
        xa_k, xa_v = port.audio_kv(torch.from_numpy(xa))
        kc, vc = port.new_cache(2)
        j_k, j_v = jdec.apply(params, jnp.asarray(xa), method="audio_kv")
        jkc = jnp.zeros(kc.shape)
        jvc = jnp.zeros(vc.shape)
        for pos in range(n):
            tok = torch.from_numpy(tokens[:, pos])
            logits = port.step(tok, pos, kc, vc, xa_k, xa_v).numpy()
            _close(logits, full[:, pos])
            j_logits, jkc, jvc = jdec.apply(params, jnp.asarray(tokens[:, pos]), pos, jkc, jvc,
                                            j_k, j_v, method="step")
            _close(logits, np.asarray(j_logits))
        _close(kc.numpy(), np.asarray(jkc))


def _rules(use_timestamps=True):
    return jwd.GreedyRules(eot=3, timestamp_begin=100, no_timestamps=99, blank=98,
                           suppress=(0, 1, 2), max_initial_timestamp_index=50,
                           use_timestamps=use_timestamps)


def _prules(use_timestamps=True):
    return pwd.GreedyRules(**_rules(use_timestamps).__dict__)


@pytest.mark.parametrize("use_timestamps", [True, False])
def test_logit_filters_match_jax(use_timestamps):
    """Every position around the prompt's end, on buffers whose last two
    tokens are text or timestamps in every combination."""
    rng = np.random.default_rng(6)
    sample_begin, vocab = 3, TINY.n_vocab
    logits = (rng.standard_normal((8, vocab)) * 3).astype(np.float32)
    buf = rng.integers(4, 97, (8, 12))
    buf[:, :sample_begin] = [10, 11, 12]
    buf[1::2, 4] = rng.integers(100, vocab, 4)   # timestamps at 4 in odd rows
    buf[2::4, 5] = rng.integers(100, vocab, 2)   # and at 5 in some rows
    buf[3::4, 5] = rng.integers(100, vocab, 2)
    jr, pr = _rules(use_timestamps), _prules(use_timestamps)
    j_mask = np.zeros(vocab, np.float32)
    j_mask[list(jr.suppress)] = -np.inf
    if use_timestamps:
        j_mask[jr.no_timestamps] = -np.inf
    p_mask = pwd._suppress_mask(pr, vocab, "cpu")
    np.testing.assert_array_equal(p_mask.numpy(), j_mask)
    for pos in (2, 3, 4, 5, 6):
        want = np.asarray(jwd._apply_logit_filters(jnp.asarray(logits), jnp.asarray(buf), pos,
                                                   jr, sample_begin, jnp.asarray(j_mask)))
        got = pwd._apply_logit_filters(torch.from_numpy(logits), torch.from_numpy(buf), pos, pr,
                                       sample_begin, p_mask).numpy()
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


class _PromptTok:
    sot_prev = 42

    def encode(self, text):
        return [20 + (ord(c) % 60) for c in text]


def test_build_initial_tokens_matches_jax():
    tok, sot = _PromptTok(), (10, 11, 12)
    cases = [dict(prompt=list(range(100, 160)), n_ctx=64),
             dict(prefix=list(range(200, 230)), sample_len=10, n_ctx=64),
             dict(prefix=[7, 8], n_ctx=64),
             dict(prompt="ab ", n_ctx=64),
             dict(prompt=[5, 6], prefix=" x y", sample_len=4, n_ctx=32),
             dict(n_ctx=64)]
    for kw in cases:
        assert pwd.build_initial_tokens(sot, tokenizer=tok, **kw) == \
            jwd.build_initial_tokens(sot, tokenizer=tok, **kw), kw


def _sampled(row, sample_begin, eot):
    row = list(row[sample_begin:])
    return row[:row.index(eot)] if eot in row else row


@pytest.mark.parametrize("use_timestamps,prompt", [(True, None), (False, None),
                                                    (False, [30, 31, 32, 33])],
                         ids=["timestamps", "text", "prompted"])
def test_greedy_decode_matches_jax(pair, use_timestamps, prompt):
    port, jdec, params = pair
    xa = _xa(21)
    sot = (10, 11, 12)
    kw = dict(sample_len=10, prompt_text=prompt, tokenizer=_PromptTok())
    j_tok, j_lp = jwd.greedy_decode(jdec, params, jnp.asarray(xa), sot, _rules(use_timestamps),
                                    **kw)
    p_tok, p_lp = pwd.greedy_decode(port, torch.from_numpy(xa), sot, _prules(use_timestamps),
                                    **kw)
    np.testing.assert_array_equal(p_tok, j_tok)
    np.testing.assert_allclose(p_lp, j_lp, rtol=0, atol=LP_TOL)
    sample_begin = len(sot) + (len(prompt) + 1 if prompt else 0)
    assert any(len(_sampled(r, sample_begin, 3)) for r in p_tok)  # something was decoded
    if use_timestamps:
        assert (p_tok >= 100).any()  # the timestamp rules were exercised


@pytest.mark.parametrize("beam_size", [2, 5])
def test_beam_decode_matches_jax(pair, beam_size):
    port, jdec, params = pair
    xa = _xa(11, scale=0.5)
    sot = (10, 11, 12)
    j_tok, j_lp = jwd.beam_decode(jdec, params, jnp.asarray(xa), sot, _rules(False),
                                  beam_size=beam_size, sample_len=10)
    p_tok, p_lp = pwd.beam_decode(port, torch.from_numpy(xa), sot, _prules(False),
                                  beam_size=beam_size, sample_len=10)
    np.testing.assert_array_equal(p_tok, j_tok)
    np.testing.assert_allclose(p_lp, j_lp, rtol=0, atol=LP_TOL)


def test_beam_decode_with_timestamps_and_patience_matches_jax(pair):
    """Timestamp rules inside the search, and a finished pool smaller than
    the beam (patience 0.5: the live beams top it up)."""
    port, jdec, params = pair
    xa = _xa(12, b=1)
    sot = (10,)
    for patience in (0.5, 2.0):
        kw = dict(beam_size=3, sample_len=12, patience=patience)
        j_tok, j_lp = jwd.beam_decode(jdec, params, jnp.asarray(xa), sot, _rules(True), **kw)
        p_tok, p_lp = pwd.beam_decode(port, torch.from_numpy(xa), sot, _prules(True), **kw)
        np.testing.assert_array_equal(p_tok, j_tok)
        np.testing.assert_allclose(p_lp, j_lp, rtol=0, atol=LP_TOL)


def test_sampling_mechanics(pair):
    """t > 0 draws from a torch.Generator: the same seed gives the same
    tokens, the filters still hold, and the result has the greedy shape
    (the JAX PRNG's draws cannot be reproduced, so no parity)."""
    port, _, _ = pair
    xa = torch.from_numpy(_xa(31))
    rules = _prules(True)
    runs = [pwd.greedy_decode(port, xa, (10, 11, 12), rules, sample_len=10, temperature=1.0,
                              generator=torch.Generator().manual_seed(s)) for s in (7, 7, 8)]
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    tok, lp = runs[0]
    assert tok.shape == (2, 13) and tok.dtype == np.int32 and np.isfinite(lp).all()
    assert not np.isin(tok[:, 3:], [0, 1, 2, 99]).any()
    assert tok.max() < TINY.n_vocab


class _StubTok:
    timestamp_begin = 100
    eot = 3
    sot = 50

    def decode(self, toks):
        return " " + " ".join(f"w{t}" for t in toks)


@pytest.mark.parametrize("stream", [
    [50, 100, 7, 8, 125, 125, 9, 150, 3, 3],
    [50, 7, 8, 9, 3],
    [100, 101, 102, 7, 60, 130],
    [50, 100, 7, 8, 125, 9, 11, 3],
])
def test_tokens_to_segments_matches_jax(stream):
    tok = _StubTok()
    for offset in (0.0, 12.5):
        assert pwd.tokens_to_segments(np.asarray(stream), tok, segment_offset_sec=offset) == \
            jwd.tokens_to_segments(np.asarray(stream), tok, segment_offset_sec=offset)


def test_decodes_do_not_depend_on_when_they_stop(pair, monkeypatch):
    """The host reads "every row done?" only every CHECK_EVERY tokens; the
    steps run past that point change nothing. End of text is a token these
    weights often pick (70), so rows and pools finish early; the small
    finished pool (patience 0.5) is topped up from the live beams, which
    must be held as the JAX package's loop leaves them when it stops."""
    port, jdec, params = pair
    xa = _xa(13, scale=0.5)
    rules = dict(eot=70, timestamp_begin=100, no_timestamps=99, blank=98, suppress=(0, 1, 2),
                 use_timestamps=False)
    kw = dict(beam_size=4, sample_len=20, patience=0.5)
    want_g = jwd.greedy_decode(jdec, params, jnp.asarray(xa), (10,), jwd.GreedyRules(**rules),
                               sample_len=20)
    want_b = jwd.beam_decode(jdec, params, jnp.asarray(xa), (10,), jwd.GreedyRules(**rules), **kw)
    assert (want_g[0] == 70).any() and (want_b[0] == 70).any()
    for every in (1, 3, 100):
        monkeypatch.setattr(pwd, "CHECK_EVERY", every)
        got_g = pwd.greedy_decode(port, torch.from_numpy(xa), (10,), pwd.GreedyRules(**rules),
                                  sample_len=20)
        got_b = pwd.beam_decode(port, torch.from_numpy(xa), (10,), pwd.GreedyRules(**rules), **kw)
        for got, want in ((got_g, want_g), (got_b, want_b)):
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_allclose(got[1], want[1], rtol=0, atol=LP_TOL)
