"""Whisper tokenizer: GPT-2 byte-level BPE and the special-token id layout.

Counterpart of ``latentsync_tpu/audio/tokenizer.py``. The JAX package
wraps ``transformers.GPT2TokenizerFast``; the port has no such dependency
(the card machine has no ``transformers``) and does the byte-level BPE
itself, over the same directory (``vocab.json`` + ``merges.txt``,
optionally ``added_tokens.json``; ``$LATENTSYNC_WHISPER_VOCAB``), with the
same ids:

- the vocabulary's ids, then ``added_tokens.json``'s, then
  ``<|endoftext|>`` (end of text, the eos token) at the next id when the
  vocabulary lacks it, then ``SPECIALS`` in order at the next ids, each
  token that is already known keeping its id (``add_special_tokens``);
- encoding splits the text on those special tokens first (leftmost,
  longest), then each piece into GPT-2's pre-tokens (contractions,
  letters, digits, other symbols, each with one optional leading space,
  and runs of white space; Unicode categories as the ``\\p{L}``/``\\p{N}``
  classes), maps each pre-token's UTF-8 bytes to GPT-2's printable byte
  alphabet and merges by rank;
- decoding joins the tokens, maps the byte alphabet back and decodes
  UTF-8 with replacement characters; no clean-up of spaces (the
  ``clean_up_tokenization_spaces`` default of the transformers release the
  parity tests hold it against).

``LANGUAGE_CODES`` is a numerical contract: the language token ids are
``sot + 1 + index`` in this exact order.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

LANGUAGE_CODES: Tuple[str, ...] = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl",
    "ca", "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "iw", "uk",
    "el", "ms", "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr",
    "bg", "lt", "la", "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn",
    "sr", "az", "sl", "kn", "et", "mk", "br", "eu", "is", "hy", "ne",
    "mn", "bs", "kk", "sq", "sw", "gl", "mr", "pa", "si", "km", "sn",
    "yo", "so", "af", "oc", "ka", "be", "tg", "sd", "gu", "am", "yi",
    "lo", "uz", "fo", "ht", "ps", "tk", "nn", "mt", "sa", "lb", "my",
    "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha", "ba", "jw", "su",
)

SPECIALS = (
    "<|startoftranscript|>",
    *[f"<|{code}|>" for code in LANGUAGE_CODES],
    "<|translate|>",
    "<|transcribe|>",
    "<|startoflm|>",
    "<|startofprev|>",
    "<|nospeech|>",
    "<|notimestamps|>",
)

EOT = "<|endoftext|>"
INF = float("inf")

# Unicode White_Space (what the pre-tokenizer's \s matches)
_WHITE = frozenset(map(chr, [*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680,
                             *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F, 0x205F, 0x3000]))
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's map from the 256 byte values to printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _kind(ch: str) -> str:
    """'s' white space, 'L' letter, 'N' number, 'o' anything else."""
    if ch in _WHITE:
        return "s"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "o"


def pretokenize(text: str) -> List[str]:
    """GPT-2's pre-tokens, as its pattern
    ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``
    splits `text` (leftmost-first alternation)."""
    kinds = [_kind(c) for c in text]
    n, i, out = len(text), 0, []
    while i < n:
        if text[i] == "'":
            c = next((c for c in _CONTRACTIONS if text.startswith(c, i + 1)), None)
            if c is not None:
                out.append(text[i:i + 1 + len(c)])
                i += 1 + len(c)
                continue
        j = i + 1 if text[i] == " " and i + 1 < n and kinds[i + 1] != "s" else i
        if kinds[j] != "s":  # ` ?` then a run of one class
            k = j + 1
            while k < n and kinds[k] == kinds[j]:
                k += 1
            out.append(text[i:k])
            i = k
            continue
        k = i + 1
        while k < n and kinds[k] == "s":
            k += 1
        if k < n and k - i > 1:  # \s+(?!\S): leave the last space to the next token
            k -= 1
        out.append(text[i:k])
        i = k
    return out


class ByteLevelBPE:
    """GPT-2 byte-level BPE over a ``vocab.json`` + ``merges.txt``
    directory, with Whisper's special tokens appended."""

    def __init__(self, vocab_dir: str):
        with open(os.path.join(vocab_dir, "vocab.json"), encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        added_path = os.path.join(vocab_dir, "added_tokens.json")
        if os.path.isfile(added_path):
            with open(added_path, encoding="utf-8") as f:
                for tok, idx in sorted(json.load(f).items(), key=lambda kv: kv[1]):
                    self.encoder.setdefault(tok, int(idx))
        with open(os.path.join(vocab_dir, "merges.txt"), encoding="utf-8") as f:
            lines = [ln for ln in f.read().split("\n") if ln and not ln.startswith("#version")]
        self.ranks = {tuple(ln.split(" ")): r for r, ln in enumerate(lines)}
        self.special_ids: List[int] = []
        for tok in (EOT, *SPECIALS):
            if tok not in self.encoder:
                self.encoder[tok] = len(self.encoder)
            if self.encoder[tok] not in self.special_ids:
                self.special_ids.append(self.encoder[tok])
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {c: b for b, c in self.byte_encoder.items()}
        self.eos_token_id = self.encoder[EOT]
        self.all_special_ids = self.special_ids
        specials_re = sorted((EOT, *SPECIALS), key=len, reverse=True)
        self._split = re.compile("(" + "|".join(map(re.escape, specials_re)) + ")")
        self._specials = frozenset((EOT, *SPECIALS))
        self._cache: Dict[str, List[str]] = {}

    def __len__(self) -> int:
        return len(self.encoder)

    def _bpe(self, word: str) -> List[str]:
        if word in self._cache:
            return self._cache[word]
        parts = list(word)
        while len(parts) > 1:
            rank, i = min((self.ranks.get(p, INF), i) for i, p in enumerate(zip(parts, parts[1:])))
            if rank == INF:
                break
            first, second = parts[i], parts[i + 1]
            merged, i = [], 0
            while i < len(parts):
                if i + 1 < len(parts) and parts[i] == first and parts[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._cache[word] = parts
        return parts

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in self._split.split(text):
            if not piece:
                continue
            if piece in self._specials:
                ids.append(self.encoder[piece])
                continue
            for word in pretokenize(piece):
                mapped = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
                ids.extend(self.encoder[t] for t in self._bpe(mapped))
        return ids

    def decode(self, token_ids) -> str:
        text = "".join(self.decoder[int(i)] for i in token_ids)
        data = b"".join(bytes([self.byte_decoder[c]]) if c in self.byte_decoder
                        else c.encode("utf-8") for c in text)
        return data.decode("utf-8", errors="replace")


@dataclass(frozen=True)
class WhisperTokenizer:
    """Special-token ids + encode/decode over the loaded BPE."""

    tokenizer: object  # ByteLevelBPE
    language: Optional[str]
    sot_sequence: Tuple[int, ...]

    def encode(self, text: str) -> List[int]:
        return self.tokenizer.encode(text)

    def decode(self, token_ids) -> str:
        return self.tokenizer.decode(token_ids)

    @property
    def eot(self) -> int:
        return self.tokenizer.eos_token_id

    def _one(self, text: str) -> int:
        toks = self.tokenizer.encode(text)
        if len(toks) != 1:
            raise ValueError(f"{text!r} is not a single token")
        return toks[0]

    @property
    def sot(self) -> int:
        return self._one("<|startoftranscript|>")

    @property
    def no_speech(self) -> int:
        return self._one("<|nospeech|>")

    @property
    def no_timestamps(self) -> int:
        return self._one("<|notimestamps|>")

    @property
    def sot_prev(self) -> int:
        """The previous-context marker put before prompt conditioning."""
        return self._one("<|startofprev|>")

    @property
    def timestamp_begin(self) -> int:
        return self.tokenizer.all_special_ids[-1] + 1

    @property
    def sot_sequence_including_notimestamps(self) -> Tuple[int, ...]:
        return tuple(self.sot_sequence) + (self.no_timestamps,)

    def decode_with_timestamps(self, tokens) -> str:
        """Timestamp tokens written as <|1.08|>."""
        out, cur = [], []
        for tok in tokens:
            if tok >= self.timestamp_begin:
                if cur:
                    out.append(self.tokenizer.decode(cur))
                    cur = []
                out.append(f"<|{(tok - self.timestamp_begin) * 0.02:.2f}|>")
            else:
                cur.append(tok)
        if cur:
            out.append(self.tokenizer.decode(cur))
        return "".join(out)

    @property
    def non_speech_tokens(self) -> Tuple[int, ...]:
        """Speaker-tag and annotation tokens to suppress."""
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
        symbols += "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
        miscellaneous = set("♩♪♫♬♭♮♯")
        result = {self.encode(" -")[0], self.encode(" '")[0]}
        for symbol in symbols + list(miscellaneous):
            for toks in [self.encode(symbol), self.encode(" " + symbol)]:
                if len(toks) == 1 or symbol in miscellaneous:
                    result.add(toks[0])
        return tuple(sorted(result))

    def suppress_set(self) -> Tuple[int, ...]:
        """The default suppression: non-speech tokens and the specials that
        are never sampled."""
        extra = [self.sot, self._one("<|startofprev|>"), self._one("<|startoflm|>"),
                 self.no_speech]
        langs = [self.sot + 1 + i for i in range(len(LANGUAGE_CODES))]
        trans = [self._one("<|translate|>"), self._one("<|transcribe|>")]
        return tuple(sorted(set(self.non_speech_tokens) | set(extra) | set(langs) | set(trans)))


@lru_cache(maxsize=None)
def build_tokenizer(vocab_path: str) -> ByteLevelBPE:
    return ByteLevelBPE(vocab_path)


def get_tokenizer(multilingual: bool = True, *, vocab_path: Optional[str] = None,
                  task: Optional[str] = "transcribe",
                  language: Optional[str] = "en") -> WhisperTokenizer:
    """The tokenizer of a local vocab directory (default
    ``$LATENTSYNC_WHISPER_VOCAB``): a GPT-2 tokenizer bundle such as the
    reference's ``whisper/assets/multilingual``."""
    vocab_path = vocab_path or os.environ.get("LATENTSYNC_WHISPER_VOCAB")
    if not vocab_path:
        raise FileNotFoundError(
            "No Whisper vocab configured: set $LATENTSYNC_WHISPER_VOCAB to a GPT-2 tokenizer "
            "directory (vocab.json + merges.txt), e.g. the reference's "
            "whisper/assets/multilingual.")
    if not multilingual:
        task, language = None, None
    if language is not None and language not in LANGUAGE_CODES:
        raise ValueError(f"Unsupported language: {language}")
    tok = build_tokenizer(vocab_path)
    sot = tok.encode("<|startoftranscript|>")[0]
    seq = [sot]
    if language is not None:
        seq.append(sot + 1 + LANGUAGE_CODES.index(language))
    if task is not None:
        seq.append(tok.encode("<|transcribe|>" if task == "transcribe" else "<|translate|>")[0])
    return WhisperTokenizer(tokenizer=tok, language=language, sot_sequence=tuple(seq))
