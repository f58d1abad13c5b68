"""The port's tokenizer, transcriber and transcription CLI against the JAX package.

The tokenizer is held against ``transformers.GPT2TokenizerFast`` (what the
JAX package wraps) on a synthetic GPT-2 bundle written to ``tmp_path``:
the 256 byte symbols, merges learned here from a small mixed corpus
(contractions, digits, punctuation, accents, CJK, emoji, runs of white
space), with and without ``<|endoftext|>`` in ``vocab.json``. Ids must be
equal, special and timestamp ids included, and decoded strings too.

``WhisperTranscriber`` runs end to end on the CPU in float32 with tiny
models (random non-zero weights made by the port, carried into flax by the
JAX package's converters) and a stub tokenizer: the same segments as the
JAX package's transcriber on the same audio, the seek always advancing,
and the fallback ladder's gates. The CLI writes the same JSON as the JAX
package's ``make_transcriber`` gives on the same whisper-layout ``.pt`` and
vocab directory.
"""

import collections
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.audio import tokenizer as jtok
from latentsync_tpu.audio import transcribe as jtr
from latentsync_tpu.config import WhisperConfig as JWhisperConfig
from latentsync_tpu.models.whisper_decoder import convert_whisper_decoder
from latentsync_tpu.utils.convert import convert_whisper_encoder
from latentsync_tpu_torch import config as pcfg
from latentsync_tpu_torch.audio import tokenizer as ptok
from latentsync_tpu_torch.audio import transcribe as ptr
from latentsync_tpu_torch.models.whisper import WhisperEncoder
from latentsync_tpu_torch.models.whisper_decoder import WhisperTextDecoder
from latentsync_tpu_torch.scripts import transcribe as pcli
from latentsync_tpu_torch.utils.convert import init_random_

CORPUS = [
    "Hello world! It's a test, isn't it? We'll see: they're here, you've been, I'm done, he'd go.",
    "The year 2024 had 365 days; 3.14159 is pi and 1,000,000 is a million.",
    "  Two spaces,\tthen a tab.\nA new line\n\nand   three spaces at the end   ",
    "Ünïcödé façade naïve café — résumé “quotes” ‘single’ «guillemets»",
    "日本語のテキスト 中文字符 한국어 텍스트 emoji 🎉🎉 and ♪ music ♪",
    "speaker: [laughs] (applause) -- well... #hashtag @user ~tilde~ {braces} <angle>",
    "ALL CAPS 'S 'T 'RE quoted 'single' words ''double'' apostrophes",
]

PROBES = CORPUS + [
    "", " ", "   ", "\n", "a", " a", "a ", "it's", " 's", "''s", "x's y'all",
    "<|startoftranscript|><|en|><|transcribe|><|notimestamps|> Hello there",
    "text<|endoftext|>more<|nospeech|>", "<|en|>", "<|zz|>", "<|startofprev|> prompt text",
    "　ideographic space nbsp thin", "mixed123abc 456 ¼ ½ ²", "tabs\t\t\tand\r\n",
    "♪♪ ♪♪♪ -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }}", " -", " '",
]


def _train_merges(n_merges=120):
    """Byte-level BPE merges learned from CORPUS (most frequent pair first)."""
    benc = ptok.bytes_to_unicode()
    words = collections.Counter()
    for text in CORPUS:
        for w in ptok.pretokenize(text):
            words[tuple(benc[b] for b in w.encode("utf-8"))] += 1
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, c in words.items():
            for p in zip(w, w[1:]):
                pairs[p] += c
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        merged = collections.Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    return merges


def _write_bundle(root, with_eot: bool):
    root.mkdir(parents=True, exist_ok=True)
    benc = ptok.bytes_to_unicode()
    vocab = {benc[b]: b for b in range(256)}
    merges = _train_merges()
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    if with_eot:
        vocab["<|endoftext|>"] = len(vocab)
    (root / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    (root / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n", encoding="utf-8")
    return str(root)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    root = tmp_path_factory.mktemp("vocab")
    return {w: _write_bundle(root / f"eot_{w}", w) for w in (True, False)}


def test_pretokenize_matches_the_gpt2_pattern():
    regex = pytest.importorskip("regex")
    pat = regex.compile(r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
    for text in PROBES:
        assert ptok.pretokenize(text) == pat.findall(text), text


@pytest.mark.parametrize("with_eot", [True, False], ids=["eot_in_vocab", "eot_appended"])
def test_bpe_matches_gpt2_tokenizer_fast(bundles, with_eot):
    path = bundles[with_eot]
    hf = jtok.build_tokenizer(path)
    bpe = ptok.ByteLevelBPE(path)
    assert len(bpe) == len(hf)
    assert bpe.eos_token_id == hf.eos_token_id
    assert bpe.all_special_ids == list(hf.all_special_ids)
    for text in PROBES:
        ids = bpe.encode(text)
        assert ids == hf.encode(text), text
        assert bpe.decode(ids) == hf.decode(ids), text
    rng = np.random.default_rng(0)  # arbitrary id runs, split UTF-8 sequences included
    for _ in range(20):
        ids = rng.integers(0, len(hf), 12).tolist()
        assert bpe.decode(ids) == hf.decode(ids), ids


@pytest.mark.parametrize("language,task", [("en", "transcribe"), ("ja", "translate"),
                                           (None, None)])
def test_whisper_tokenizer_ids_match(bundles, language, task):
    kw = dict(vocab_path=bundles[True], language=language, task=task,
              multilingual=language is not None)
    j, p = jtok.get_tokenizer(**kw), ptok.get_tokenizer(**kw)
    assert p.sot_sequence == j.sot_sequence
    for name in ("eot", "sot", "no_speech", "no_timestamps", "sot_prev", "timestamp_begin",
                 "sot_sequence_including_notimestamps", "non_speech_tokens"):
        assert getattr(p, name) == getattr(j, name), name
    assert p.suppress_set() == j.suppress_set()
    assert p.timestamp_begin == p.no_timestamps + 1
    stream = [p.sot, 5, 66, p.timestamp_begin + 7, 70, p.timestamp_begin + 50]
    assert p.decode_with_timestamps(stream) == j.decode_with_timestamps(stream)


def test_get_tokenizer_without_vocab_raises(monkeypatch):
    monkeypatch.delenv("LATENTSYNC_WHISPER_VOCAB", raising=False)
    with pytest.raises(FileNotFoundError, match="LATENTSYNC_WHISPER_VOCAB"):
        ptok.get_tokenizer()
    with pytest.raises(ValueError, match="Unsupported language"):
        ptok.get_tokenizer(vocab_path="unused", language="xx")


# ---------------------------------------------------------------------------
# the transcriber
# ---------------------------------------------------------------------------

DIMS = dict(n_audio_state=64, n_audio_head=4, n_audio_layer=1, n_vocab=200, n_text_ctx=24,
            n_text_state=64, n_text_head=4, n_text_layer=1)


class _StubTok:
    """The whisper id layout in miniature: end of text 3, text below 50,
    specials 50..99, timestamps from 100."""

    timestamp_begin, eot, sot, no_timestamps, sot_prev = 100, 3, 50, 99, 42
    sot_sequence = (50, 51, 52)

    def encode(self, s):
        return [98] if s == " " else [20 + (ord(c) % 60) for c in s]

    def decode(self, toks):
        return " " + " ".join(f"w{t}" for t in toks)

    def suppress_set(self):
        return (0, 1, 2)


def _models(dims, seed=0):
    cfg = pcfg.WhisperConfig(**dims)
    enc = init_random_(WhisperEncoder(cfg), seed=seed + 1).eval()
    dec = init_random_(WhisperTextDecoder(cfg), seed=seed + 2).eval()
    return enc, dec


def _jax_transcriber(enc, dec, dims, tok, **kw):
    enc_p = convert_whisper_encoder({"encoder." + k: v.numpy()
                                     for k, v in enc.state_dict().items()})
    dec_p = convert_whisper_decoder({"decoder." + k: v.numpy()
                                     for k, v in dec.state_dict().items()})
    return jtr.WhisperTranscriber(JWhisperConfig(**dims), enc_p, dec_p, tok, **kw)


def _audio(sec, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * sec)) / 16000
    return (0.3 * np.sin(2 * np.pi * 180 * t) * (1 + np.sin(2 * np.pi * 2 * t))
            + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny_models():
    return _models(DIMS)


def test_encoder_features_match_jax(tiny_models):
    enc, dec = tiny_models
    tr = ptr.WhisperTranscriber(enc, dec, _StubTok())
    jt = _jax_transcriber(enc, dec, DIMS, _StubTok())
    mel = np.random.default_rng(1).standard_normal((80, 3000)).astype(np.float32)
    want = np.asarray(jt._encode(jt.encoder_params, jnp.asarray(mel)[None]))
    got = tr.encode(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("sec,beam_size", [(1.5, None), (34.0, None), (1.5, 2)],
                         ids=["one_window", "two_windows", "beam"])
def test_transcriber_matches_jax(tiny_models, sec, beam_size):
    """The same segments (two windows: the seek and the prompt carried from
    the first window into the second)."""
    enc, dec = tiny_models
    tok = _StubTok()
    kw = dict(beam_size=beam_size, logprob_threshold=None, compression_ratio_threshold=None)
    want = _jax_transcriber(enc, dec, DIMS, tok, **kw)(_audio(sec))
    got = ptr.WhisperTranscriber(enc, dec, tok, **kw)(_audio(sec))
    assert got == want
    assert got and all(set(s) == {"start", "end", "text", "words"} for s in got)


def test_transcriber_seek_always_advances(tiny_models, monkeypatch):
    """A last timestamp that rounds back to the window start must not decode
    the same window forever: a whole window is skipped instead."""
    enc, dec = tiny_models
    calls = []

    def stuck(tokens, tok, segment_offset_sec=0.0):
        calls.append(segment_offset_sec)
        return [{"start": segment_offset_sec, "end": segment_offset_sec + 0.004, "text": "x",
                 "words": []}]

    monkeypatch.setattr(ptr, "tokens_to_segments", stuck)
    segs = ptr.WhisperTranscriber(enc, dec, _StubTok())(np.zeros(65 * 16000, np.float32))
    assert len(segs) == len(calls) == 3
    assert calls == sorted(set(calls))


class _RepeatTok(_StubTok):
    def decode(self, toks):
        return "la " * 40  # compression ratio far above 2.4


@pytest.mark.parametrize("tok,thresholds,want_t", [
    (_StubTok(), dict(logprob_threshold=None, compression_ratio_threshold=None), 0.0),
    (_StubTok(), dict(logprob_threshold=10.0, compression_ratio_threshold=None), 0.8),
    (_RepeatTok(), dict(logprob_threshold=None, compression_ratio_threshold=2.4), 0.8),
    (_StubTok(), dict(logprob_threshold=-1e9, compression_ratio_threshold=2.4), 0.0),
], ids=["no_gates", "logprob_gate", "compression_gate", "gates_pass"])
def test_fallback_ladder(tiny_models, monkeypatch, tok, thresholds, want_t):
    """The ladder stops at the first decode that passes both gates and walks
    to its end when none does; where it stops at t = 0 (no sampling), the
    JAX package's stops there too."""
    enc, dec = tiny_models
    ladder = (0.0, 0.4, 0.8)
    tr = ptr.WhisperTranscriber(enc, dec, tok, temperature=ladder, **thresholds)
    jt = _jax_transcriber(enc, dec, DIMS, tok, temperature=ladder, **thresholds)
    walked = []
    greedy = ptr.greedy_decode
    monkeypatch.setattr(ptr, "greedy_decode",
                        lambda *a, **k: walked.append(k["temperature"]) or greedy(*a, **k))
    mel = np.random.default_rng(2).standard_normal((80, 3000)).astype(np.float32)
    feats = tr.encode(torch.from_numpy(mel))
    tokens, avg_lp, t = tr._decode_with_fallback(feats)
    assert t == want_t and walked == [x for x in ladder if x <= want_t]
    assert tokens.shape == (1, 3 + 12) and np.isfinite(avg_lp).all()
    if want_t == 0.0:
        _, _, jt_t = jt._decode_with_fallback(
            jt._encode(jt.encoder_params, jnp.asarray(mel)[None]))
        assert jt_t == want_t


def test_compression_ratio_matches_jax():
    for text in ("", "hello world", "la " * 40, "日本語のテキスト" * 3):
        assert ptr.compression_ratio(text) == jtr.compression_ratio(text)


def test_cli_json_matches_jax(bundles, tmp_path, monkeypatch, capsys):
    """``python -m latentsync_tpu_torch.scripts.transcribe --device cpu`` on a
    whisper-layout ``.pt`` (dims + model_state_dict) and a vocab directory:
    its JSON and VTT against the JAX package's ``make_transcriber`` on the
    same files."""
    vocab = bundles[True]
    n_vocab = ptok.get_tokenizer(vocab_path=vocab).timestamp_begin + 60
    dims = dict(DIMS, n_vocab=n_vocab)
    enc, dec = _models(dims, seed=4)
    sd = {"encoder." + k: v for k, v in enc.state_dict().items()}
    sd.update({"decoder." + k: v for k, v in dec.state_dict().items()})
    ckpt = tmp_path / "tiny.pt"
    torch.save({"dims": dict(dims, n_mels=80, n_audio_ctx=1500), "model_state_dict": sd}, ckpt)
    wav = tmp_path / "a.wav"
    from latentsync_tpu_torch.utils.media import write_audio

    write_audio(str(wav), _audio(2.0, seed=3))
    monkeypatch.setenv("LATENTSYNC_WHISPER_CKPT", str(ckpt))
    monkeypatch.setenv("LATENTSYNC_WHISPER_VOCAB", vocab)
    out, vtt = tmp_path / "t.json", tmp_path / "t.vtt"
    pcli.main(["--audio", str(wav), "--out", str(out), "--vtt", str(vtt), "--device", "cpu"])
    doc = json.loads(out.read_text())
    want = jtr.make_transcriber(JWhisperConfig(**dims), checkpoint_path=str(ckpt),
                                vocab_path=vocab)(str(wav))
    assert doc == {"segments": want}
    assert vtt.read_text().startswith("WEBVTT")
    pcli.main(["--audio", str(wav), "--device", "cpu"])  # JSON on stdout
    assert json.loads(capsys.readouterr().out) == doc
    assert os.path.getsize(out) > 0
