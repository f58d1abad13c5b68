"""In-repo Whisper transcription: waveform → segments with word times.

Counterpart of ``latentsync_tpu/audio/transcribe.py``: 30 s windows of
log-mel → the whisper encoder (``models/whisper.py``, its ``ln_post``
output) → the text decoder's greedy or beam decode
(``models/whisper_decoder.py``) → timestamp-token segments. The seek
follows the reference's timestamp-driven advance (to the last segment's
end, else a whole window; always forward), the fallback ladder walks the
temperatures while a decode fails the compression-ratio (> 2.4) or
average-log-probability (< −1.0) gate (beam search at t = 0 when
``beam_size`` is set, sampling above), and each window is conditioned on
the text decoded so far (reset after a fallback above t = 0.5).

The models run in f32 on their device (the card unless the caller asks
for the CPU). The encoder's convolutions run with TF32 off (cuDNN allows
it by default, and it moves the card's results off the f32 reference);
products follow the process's setting, PyTorch's default being off.
Sampling draws from a ``torch.Generator`` seeded per
temperature as the reference seeds its PRNG (``int(t * 10) + 7``); the
draws themselves differ from the JAX PRNG's.
"""

from __future__ import annotations

import os
import warnings
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import WhisperConfig
from ..models.whisper import WhisperEncoder
from ..models.whisper_decoder import (
    GreedyRules,
    WhisperTextDecoder,
    beam_decode,
    build_initial_tokens,
    greedy_decode,
    tokens_to_segments,
)
from ..ops.mel import WHISPER_N_FRAMES, pad_or_trim, whisper_log_mel

_SAMPLES_PER_FRAME = 160  # 16 kHz / 100 fps mel hop


def compression_ratio(text: str) -> float:
    """UTF-8 bytes over their zlib-compressed size: high ratios mean
    degenerate repetition loops."""
    data = text.encode("utf-8")
    return len(data) / max(len(zlib.compress(data)), 1)


def _no_tf32():
    """cuDNN without TF32, for the encoder's convolutions."""
    b = torch.backends.cudnn
    return b.flags(enabled=b.enabled, benchmark=b.benchmark, deterministic=b.deterministic,
                   allow_tf32=False)


class WhisperTranscriber:
    """Callable transcriber: audio path (or waveform) → [{start, end, text,
    words}], the structure ``generate_subtitles`` and ``last_word_end``
    consume. `encoder` / `decoder` are the port's modules (weights loaded,
    on their device); `tokenizer` is a ``WhisperTokenizer`` or anything with
    its ids and ``encode`` / ``decode``."""

    def __init__(self, encoder: WhisperEncoder, decoder: WhisperTextDecoder, tokenizer,
                 beam_size: Optional[int] = None, temperature=(0.0,),
                 compression_ratio_threshold: Optional[float] = 2.4,
                 logprob_threshold: Optional[float] = -1.0,
                 initial_prompt: Optional[str] = None,
                 condition_on_previous_text: bool = True):
        self.encoder = encoder.eval()
        self.decoder = decoder.eval()
        self.config = decoder.config
        self.tokenizer = tokenizer
        self.rules = GreedyRules(
            eot=tokenizer.eot, timestamp_begin=tokenizer.timestamp_begin,
            no_timestamps=tokenizer.no_timestamps, blank=tokenizer.encode(" ")[0],
            suppress=tokenizer.suppress_set())
        self.beam_size = beam_size
        self.temperature = ((temperature,) if isinstance(temperature, float)
                            else tuple(temperature))
        self.compression_ratio_threshold = compression_ratio_threshold
        self.logprob_threshold = logprob_threshold
        self.initial_prompt = initial_prompt
        self.condition_on_previous_text = condition_on_previous_text

    @property
    def device(self) -> torch.device:
        return self.decoder.token_embedding.weight.device

    def encode(self, mel_window: torch.Tensor) -> torch.Tensor:
        """(n_mels, 3000) log-mel → (1, n_audio_ctx, C) audio features."""
        with torch.inference_mode(), _no_tf32():
            return self.encoder(mel_window[None], include_embeddings=False)

    def _decode_with_fallback(self, feats, sot_sequence=None):
        """Walk the temperature ladder; retry while the decode fails the
        compression-ratio or average-log-probability gate, which look only
        at the sampled tokens past the forced ones. Returns (tokens,
        avg_lp, temperature used)."""
        sot = tuple(sot_sequence if sot_sequence is not None else self.tokenizer.sot_sequence)
        tokens = avg_lp = None
        t = 0.0
        for t in self.temperature:
            if t == 0.0 and self.beam_size:
                tokens, avg_lp = beam_decode(self.decoder, feats, sot, self.rules,
                                             beam_size=self.beam_size)
            else:
                gen = torch.Generator(device=feats.device).manual_seed(int(t * 10) + 7)
                tokens, avg_lp = greedy_decode(self.decoder, feats, sot, self.rules,
                                               temperature=float(t), generator=gen)
            needs_fallback = False
            if self.compression_ratio_threshold is not None:
                # sampled text tokens only: every special id is >= eot
                text = self.tokenizer.decode(
                    [int(tt) for tt in tokens[0][len(sot):] if tt < self.tokenizer.eot])
                if compression_ratio(text) > self.compression_ratio_threshold:
                    needs_fallback = True  # too repetitive
            if self.logprob_threshold is not None and float(avg_lp[0]) < self.logprob_threshold:
                needs_fallback = True  # average log probability too low
            if not needs_fallback:
                break
        return tokens, avg_lp, float(t)

    def __call__(self, audio_or_path) -> List[Dict]:
        if isinstance(audio_or_path, (str, os.PathLike)):
            from ..utils.media import read_audio

            audio = read_audio(os.fspath(audio_or_path))
        else:
            audio = np.asarray(audio_or_path, np.float32)
        mel = whisper_log_mel(torch.as_tensor(audio, dtype=torch.float32, device=self.device))
        num_frames = mel.shape[-1]
        segments: List[Dict] = []
        seek = 0
        prompt_tokens: List[int] = (self.tokenizer.encode(" " + self.initial_prompt.strip())
                                    if self.initial_prompt else [])
        while seek < num_frames:
            end = min(seek + WHISPER_N_FRAMES, num_frames)
            feats = self.encode(pad_or_trim(mel[:, seek:end], WHISPER_N_FRAMES))
            init = (build_initial_tokens(self.tokenizer.sot_sequence, tokenizer=self.tokenizer,
                                         prompt=prompt_tokens, n_ctx=self.config.n_text_ctx)
                    if prompt_tokens else tuple(self.tokenizer.sot_sequence))
            tokens, _, temp_used = self._decode_with_fallback(feats, sot_sequence=init)
            sampled = tokens[0][len(init):]
            if self.condition_on_previous_text and temp_used <= 0.5:
                prompt_tokens.extend(int(tt) for tt in sampled if tt < self.tokenizer.eot)
            else:
                prompt_tokens = []  # a high-temperature fallback resets the context
            offset = seek * _SAMPLES_PER_FRAME / 16000.0
            window_segs = tokens_to_segments(sampled, self.tokenizer, segment_offset_sec=offset)
            segments.extend(window_segs)
            if end >= num_frames:
                break
            if window_segs and window_segs[-1]["end"] > offset:
                new_seek = int(round(window_segs[-1]["end"] * 100))
            else:
                new_seek = end
            # a last timestamp that rounds back to the window start would
            # decode the same window forever: advance a whole window then
            seek = new_seek if new_seek > seek else end
        return segments


def _checkpoint_state_dicts(path: str):
    """OpenAI's whisper ``.pt`` → (WhisperConfig, encoder state dict,
    decoder state dict), prefixes stripped; the encoder's sinusoidal
    positions are recomputed, not loaded."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    dims = ckpt.get("dims", {})
    cfg = WhisperConfig(**{k: dims[k] for k in (
        "n_mels", "n_audio_ctx", "n_audio_state", "n_audio_head", "n_audio_layer", "n_vocab",
        "n_text_ctx", "n_text_state", "n_text_head", "n_text_layer") if k in dims})
    sd = ckpt["model_state_dict"]
    enc = {k.removeprefix("encoder."): v for k, v in sd.items()
           if k.startswith("encoder.") and k != "encoder.positional_embedding"}
    dec = {k.removeprefix("decoder."): v for k, v in sd.items() if k.startswith("decoder.")}
    return cfg, enc, dec


def make_transcriber(config: Optional[WhisperConfig] = None,
                     checkpoint_path: Optional[str] = None, vocab_path: Optional[str] = None,
                     language: str = "en", device=None) -> WhisperTranscriber:
    """The production factory: encoder and decoder weights from a whisper
    ``.pt`` (``$LATENTSYNC_WHISPER_CKPT``), the vocab from
    ``$LATENTSYNC_WHISPER_VOCAB``, on `device` (the card by default). Without
    a checkpoint the models get seeded random weights, with a warning:
    their transcripts are gibberish."""
    from ..utils.convert import init_random_
    from .tokenizer import get_tokenizer

    device = torch.device("cuda" if device is None else device)
    cfg = config or WhisperConfig.tiny()
    checkpoint_path = checkpoint_path or os.environ.get("LATENTSYNC_WHISPER_CKPT")
    enc_sd = dec_sd = None
    if checkpoint_path and os.path.isfile(checkpoint_path):
        cfg, enc_sd, dec_sd = _checkpoint_state_dicts(checkpoint_path)
    else:
        warnings.warn(
            "make_transcriber: no whisper checkpoint found (LATENTSYNC_WHISPER_CKPT="
            f"{checkpoint_path!r}): the encoder and decoder have RANDOM weights and the "
            "transcripts will be gibberish. Set it to a whisper .pt checkpoint "
            "(docs/weights.md).", stacklevel=2)
    encoder, decoder = WhisperEncoder(cfg), WhisperTextDecoder(cfg)
    if enc_sd is None:
        init_random_(encoder, seed=1)
        init_random_(decoder, seed=2)
    else:
        encoder.load_state_dict(enc_sd)
        decoder.load_state_dict(dec_sd)
    tok = get_tokenizer(multilingual=True, vocab_path=vocab_path, language=language)
    t = WhisperTranscriber(encoder.to(device), decoder.to(device), tok)
    t.random_weights = enc_sd is None
    return t
