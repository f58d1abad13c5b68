"""Whisper text decoder and its greedy and beam decodes, in torch.

Counterpart of ``latentsync_tpu/models/whisper_decoder.py``:
``WhisperTextDecoder`` (learned positions, causal self-attention,
cross-attention over the audio features, logits tied to the token
embedding; pre-LN blocks with f32 LayerNorms of eps 1e-6, the flax
default the reference uses), its one-token ``step`` against a fixed-size
KV cache (L, B, n_ctx, H, D) with the positions past the current one
masked, and ``audio_kv``, the cross-attention keys and values computed
once a clip. Parameter names are upstream whisper's ``TextDecoder``
(``token_embedding``, ``blocks.i.attn.query`` …, ``mlp.0``, ``ln``), so
the ``decoder.*`` entries of a whisper ``.pt`` load with the prefix
stripped.

The decodes keep the reference's semantics: the SOT prompt is forced
token by token through ``step`` (prefill and decode share one step), the
logit filters are SuppressTokens, SuppressBlank and ApplyTimestampRules
(``_apply_logit_filters``), and beam search keeps the reference's
candidate pool, finished pool, first-step dedup and length-normalised
ranking. The reference runs each decode as one ``lax.while_loop`` under
jit; here the loop is Python over device tensors. It reads a device value
on the host only every ``CHECK_EVERY`` tokens, to stop once every row is
done; the steps it runs past that point change nothing (finished rows
emit end-of-text at no log-probability, and a beam search whose pools
are full holds its state). Sampling at t > 0 takes a ``torch.Generator``:
the JAX PRNG's draws cannot be reproduced.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import WhisperConfig
from ..ops.attention import dot_product_attention
from .whisper import _layer_norm

# the decodes read "is every row done?" on the host once this many tokens
CHECK_EVERY = 8


class _DecoderMHA(nn.Module):
    """Whisper attention projections: q/v/out biased, k unbiased."""

    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_state, self.n_head = n_state, n_head
        self.query = nn.Linear(n_state, n_state)
        self.key = nn.Linear(n_state, n_state, bias=False)
        self.value = nn.Linear(n_state, n_state)
        self.out = nn.Linear(n_state, n_state)

    def _split(self, x):
        b, t, _ = x.shape
        return x.reshape(b, t, self.n_head, self.n_state // self.n_head)

    def forward(self, x, xa=None, mask=None):
        """Full-sequence attention (the teacher-forced path)."""
        ctx = x if xa is None else xa
        o = dot_product_attention(self._split(self.query(x)), self._split(self.key(ctx)),
                                  self._split(self.value(ctx)), mask=mask)
        return self.out(o.reshape(x.shape[0], x.shape[1], self.n_state))

    def kv(self, xa):
        return self._split(self.key(xa)), self._split(self.value(xa))

    def step(self, x1, pos: int, k_cache, v_cache, mask):
        """One token (B, 1, C) against the caches (B, n_ctx, H, D), which take
        its key and value at `pos` in place; `mask` hides the slots past it."""
        k_cache[:, pos] = self._split(self.key(x1))[:, 0]
        v_cache[:, pos] = self._split(self.value(x1))[:, 0]
        o = dot_product_attention(self._split(self.query(x1)), k_cache, v_cache, mask=mask)
        return self.out(o.reshape(x1.shape[0], 1, self.n_state))

    def cross_step(self, x1, xa_k, xa_v):
        o = dot_product_attention(self._split(self.query(x1)), xa_k, xa_v)
        return self.out(o.reshape(x1.shape[0], 1, self.n_state))


class _DecoderBlock(nn.Module):
    """Pre-LN block: self-attention, cross-attention, GELU MLP."""

    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.attn = _DecoderMHA(n_state, n_head)
        self.attn_ln = nn.LayerNorm(n_state, eps=1e-6)
        self.cross_attn = _DecoderMHA(n_state, n_head)
        self.cross_attn_ln = nn.LayerNorm(n_state, eps=1e-6)
        self.mlp = nn.Sequential(nn.Linear(n_state, 4 * n_state), nn.GELU(),
                                 nn.Linear(4 * n_state, n_state))
        self.mlp_ln = nn.LayerNorm(n_state, eps=1e-6)

    def forward(self, x, xa, mask):
        x = x + self.attn(_layer_norm(x, self.attn_ln), mask=mask)
        x = x + self.cross_attn(_layer_norm(x, self.cross_attn_ln), xa=xa)
        return x + self.mlp(_layer_norm(x, self.mlp_ln))

    def step(self, x1, pos, k_cache, v_cache, xa_k, xa_v, mask):
        x1 = x1 + self.attn.step(_layer_norm(x1, self.attn_ln), pos, k_cache, v_cache, mask)
        x1 = x1 + self.cross_attn.cross_step(_layer_norm(x1, self.cross_attn_ln), xa_k, xa_v)
        return x1 + self.mlp(_layer_norm(x1, self.mlp_ln))


class WhisperTextDecoder(nn.Module):
    """tokens (B, T) + audio features (B, Ta, C) → logits (B, T, vocab) in f32."""

    def __init__(self, config: WhisperConfig = WhisperConfig()):
        super().__init__()
        self.config = cfg = config
        self.token_embedding = nn.Embedding(cfg.n_vocab, cfg.n_text_state)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.n_text_ctx, cfg.n_text_state))
        self.blocks = nn.ModuleList([_DecoderBlock(cfg.n_text_state, cfg.n_text_head)
                                     for _ in range(cfg.n_text_layer)])
        self.ln = nn.LayerNorm(cfg.n_text_state, eps=1e-6)

    def _logits(self, x):
        """f32 LayerNorm, then the product with the f32 token embedding."""
        ln = self.ln
        h = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(),
                         ln.eps)
        return h @ self.token_embedding.weight.T.float()

    def forward(self, tokens, audio_features):
        t = tokens.shape[-1]
        x = self.token_embedding(tokens) + self.positional_embedding[:t]
        xa = audio_features.to(x.dtype)
        idx = torch.arange(t, device=tokens.device)
        causal = torch.zeros(t, t, device=tokens.device).masked_fill(
            idx[:, None] < idx[None, :], float("-inf"))
        for blk in self.blocks:
            x = blk(x, xa, causal)
        return self._logits(x)

    def audio_kv(self, audio_features):
        """Per-layer cross-attention keys and values, (L, B, Ta, H, D) each."""
        xa = audio_features.to(self.token_embedding.weight.dtype)
        ks, vs = zip(*(blk.cross_attn.kv(xa) for blk in self.blocks))
        return torch.stack(ks), torch.stack(vs)

    def new_cache(self, batch: int):
        """Zeroed self-attention caches (L, B, n_ctx, H, D), keys and values."""
        cfg = self.config
        w = self.token_embedding.weight
        shape = (cfg.n_text_layer, batch, cfg.n_text_ctx, cfg.n_text_head,
                 cfg.n_text_state // cfg.n_text_head)
        return (torch.zeros(shape, dtype=w.dtype, device=w.device),
                torch.zeros(shape, dtype=w.dtype, device=w.device))

    def step_masks(self) -> torch.Tensor:
        """(n_ctx, 1, 1, 1, n_ctx): row p is 0 up to slot p and -inf after."""
        n = self.config.n_text_ctx
        idx = torch.arange(n, device=self.token_embedding.weight.device)
        return torch.zeros(n, n, device=idx.device).masked_fill(
            idx[None, :] > idx[:, None], float("-inf"))[:, None, None, None, :]

    def step(self, token, pos: int, k_caches, v_caches, xa_k, xa_v, masks=None):
        """One decode step: token (B,) at position `pos`; the caches (L, B,
        n_ctx, H, D) are written in place. Returns logits (B, vocab) in f32.
        `masks` is ``step_masks()``, made once a decode."""
        masks = self.step_masks() if masks is None else masks
        x = self.token_embedding(token)[:, None, :] + self.positional_embedding[pos]
        for i, blk in enumerate(self.blocks):
            x = blk.step(x, pos, k_caches[i], v_caches[i], xa_k[i], xa_v[i], masks[pos])
        return self._logits(x)[:, 0]


# ---------------------------------------------------------------------------
# decoding with the reference's logit filters
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GreedyRules:
    """The ids the logit filters need."""

    eot: int
    timestamp_begin: int
    no_timestamps: int
    blank: int
    suppress: Tuple[int, ...]  # non-speech + special tokens
    max_initial_timestamp_index: Optional[int] = 50  # 1.0 s
    use_timestamps: bool = True


def _suppress_mask(rules: GreedyRules, vocab: int, device) -> torch.Tensor:
    mask = torch.zeros(vocab, device=device)
    mask[list(rules.suppress)] = float("-inf")
    if rules.use_timestamps:
        mask[rules.no_timestamps] = float("-inf")
    return mask


def _apply_logit_filters(logits, tokens_buf, pos: int, rules: GreedyRules, sample_begin: int,
                         suppress_mask):
    """SuppressTokens, SuppressBlank (at the first sampled position) and
    ApplyTimestampRules (pairing, the initial-timestamp cap, timestamps
    forced when their summed probability beats every text token) as masks
    on logits (N, vocab); tokens_buf (N, L) holds the tokens so far."""
    neg = float("-inf")
    logits = logits + suppress_mask
    first = pos == sample_begin - 1
    if first:
        logits[:, [rules.blank, rules.eot]] = neg
    if not rules.use_timestamps:
        return logits
    ts0 = rules.timestamp_begin
    idx = torch.arange(logits.shape[-1], device=logits.device)
    if pos >= sample_begin:
        last_ts = tokens_buf[:, pos] >= ts0
        pen_ts = (tokens_buf[:, pos - 1] >= ts0) if pos - 1 >= sample_begin \
            else torch.ones_like(last_ts)
        kill = ((last_ts & pen_ts)[:, None] & (idx >= ts0)[None, :]) \
            | ((last_ts & ~pen_ts)[:, None] & (idx < rules.eot)[None, :])
        logits = logits.masked_fill(kill, neg)
    if first and rules.max_initial_timestamp_index is not None:
        logits[:, ts0 + rules.max_initial_timestamp_index + 1:] = neg
    if pos >= sample_begin - 1:
        lp = torch.log_softmax(logits, dim=-1)
        is_ts = (idx >= ts0)[None, :]
        ts_lp = torch.logsumexp(lp.masked_fill(~is_ts, neg), dim=-1)
        text_lp = lp.masked_fill(is_ts, neg).amax(dim=-1)
        logits = logits.masked_fill((ts_lp > text_lp)[:, None] & ~is_ts, neg)
    return logits


def build_initial_tokens(
    sot_sequence: Sequence[int],
    *,
    tokenizer=None,
    prompt=None,
    prefix=None,
    sample_len: Optional[int] = None,
    n_ctx: int = 448,
) -> Tuple[int, ...]:
    """The forced tokens of a decode: `prefix` (text or tokens) after the SOT
    sequence, trimmed to the last n_ctx // 2 − sample_len when sample_len is
    given; `prompt` (text or tokens) before it as ``[sot_prev] + tokens``,
    trimmed to the last n_ctx // 2 − 1. Text goes through
    ``tokenizer.encode(" " + text.strip())``."""
    tokens = list(sot_sequence)
    if prefix:
        prefix_tokens = (tokenizer.encode(" " + prefix.strip())
                         if isinstance(prefix, str) else list(prefix))
        if sample_len is not None:
            max_prefix_len = n_ctx // 2 - sample_len
            prefix_tokens = prefix_tokens[-max_prefix_len:]
        tokens = tokens + prefix_tokens
    if prompt:
        prompt_tokens = (tokenizer.encode(" " + prompt.strip())
                         if isinstance(prompt, str) else list(prompt))
        tokens = [tokenizer.sot_prev] + prompt_tokens[-(n_ctx // 2 - 1):] + tokens
    return tuple(tokens)


def _setup(decoder, sot_sequence, sample_len, prompt_text, prefix_text, tokenizer):
    n_ctx = decoder.config.n_text_ctx
    if prompt_text or prefix_text:
        sot_sequence = build_initial_tokens(sot_sequence, tokenizer=tokenizer,
                                            prompt=prompt_text, prefix=prefix_text,
                                            sample_len=sample_len, n_ctx=n_ctx)
    sample_len = sample_len or n_ctx // 2
    prompt = list(sot_sequence)
    return prompt, len(prompt), min(n_ctx, len(prompt) + sample_len)


@torch.inference_mode()
def greedy_decode(
    decoder: WhisperTextDecoder,
    audio_features: torch.Tensor,
    sot_sequence: Sequence[int],
    rules: GreedyRules,
    sample_len: Optional[int] = None,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    prompt_text=None,
    prefix_text=None,
    tokenizer=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy transcription of (B, Ta, C) audio features on their device.

    Returns (tokens (B, L) int32 with the forced prompt and end-of-text
    padding, avg_logprob (B,)). temperature > 0 samples from logits / T
    with `generator` (on the features' device) instead of the argmax."""
    prompt, sample_begin, total_len = _setup(decoder, sot_sequence, sample_len, prompt_text,
                                             prefix_text, tokenizer)
    b, dev = audio_features.shape[0], audio_features.device
    suppress_mask = _suppress_mask(rules, decoder.config.n_vocab, dev)
    xa_k, xa_v = decoder.audio_kv(audio_features)
    kc, vc = decoder.new_cache(b)
    masks = decoder.step_masks()
    buf = torch.full((b, total_len), rules.eot, dtype=torch.long, device=dev)
    buf[:, :sample_begin] = torch.tensor(prompt, device=dev)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    sum_lp = torch.zeros(b, device=dev)
    for pos in range(total_len - 1):
        logits = decoder.step(buf[:, pos], pos, kc, vc, xa_k, xa_v, masks)
        if pos + 1 < sample_begin:
            continue  # inside the prompt: the next token is forced
        logits = _apply_logit_filters(logits, buf, pos, rules, sample_begin, suppress_mask)
        lp = torch.log_softmax(logits, dim=-1)
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = logits.argmax(dim=-1)
        nxt = nxt.masked_fill(finished, rules.eot)
        sum_lp += lp.gather(1, nxt[:, None])[:, 0].masked_fill(finished, 0.0)
        finished |= nxt == rules.eot
        buf[:, pos + 1] = nxt
        if (pos + 2 - sample_begin) % CHECK_EVERY == 0 and bool(finished.all()):
            break
    n_sampled = ((buf[:, sample_begin:] != rules.eot).sum(-1) + 1).clamp(min=1)
    return (buf.to(torch.int32).cpu().numpy(),
            (sum_lp / n_sampled).cpu().numpy().astype(np.float32))


@torch.inference_mode()
def beam_decode(
    decoder: WhisperTextDecoder,
    audio_features: torch.Tensor,
    sot_sequence: Sequence[int],
    rules: GreedyRules,
    beam_size: int = 5,
    sample_len: Optional[int] = None,
    patience: Optional[float] = None,
    length_penalty: Optional[float] = None,
    prompt_text=None,
    prefix_text=None,
    tokenizer=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Beam search with the reference's bookkeeping: each beam's top
    beam_size + 1 tokens, merged per audio in score order, the first
    beam_size that are not end-of-text become the new beams; end-of-text
    candidates met before the last of them join the finished pool, up to
    beam_size · patience; at the first sampled position only beam 0 counts
    (all beams are the same sequence); at the end an under-full pool is
    topped up with the live beams, and the best of it by sum_logprob over
    length (or the length penalty) is returned.

    Returns (tokens (B, L) int32 of the best sequence with the prompt,
    avg_logprob (B,))."""
    prompt, sample_begin, total_len = _setup(decoder, sot_sequence, sample_len, prompt_text,
                                             prefix_text, tokenizer)
    b, dev = audio_features.shape[0], audio_features.device
    nb = beam_size
    max_candidates = int(round(nb * (patience or 1.0)))
    pool = nb * (nb + 1)
    suppress_mask = _suppress_mask(rules, decoder.config.n_vocab, dev)
    xa_k, xa_v = decoder.audio_kv(audio_features.repeat_interleave(nb, dim=0))
    kc, vc = decoder.new_cache(b * nb)
    masks = decoder.step_masks()
    buf = torch.full((b, nb, total_len), rules.eot, dtype=torch.long, device=dev)
    buf[:, :, :sample_begin] = torch.tensor(prompt, device=dev)
    sum_lp = torch.zeros(b, nb, device=dev)
    fin_tok = torch.full((b, max_candidates, total_len), rules.eot, dtype=torch.long,
                         device=dev)
    fin_lp = torch.full((b, max_candidates), float("-inf"), device=dev)
    fin_cnt = torch.zeros(b, dtype=torch.long, device=dev)
    csrc = torch.arange(nb, device=dev).repeat_interleave(nb + 1).expand(b, pool)
    later_beams = (torch.arange(b * nb, device=dev) % nb > 0)[:, None]
    targets = torch.arange(1, nb + 1, device=dev).expand(b, nb).contiguous()
    rows = torch.arange(b, device=dev)[:, None]
    for pos in range(total_len - 1):
        flat = buf.reshape(b * nb, total_len)
        logits = decoder.step(flat[:, pos], pos, kc, vc, xa_k, xa_v, masks)
        if pos + 1 < sample_begin:
            continue  # inside the prompt: forced tokens, no reordering
        # once every pool is full the search has ended: hold the state
        done = (fin_cnt >= max_candidates).all()
        logits = _apply_logit_filters(logits, flat, pos, rules, sample_begin, suppress_mask)
        top_lp, top_tok = torch.log_softmax(logits, dim=-1).topk(nb + 1, dim=-1)
        cand = sum_lp.reshape(b * nb, 1) + top_lp
        if pos == sample_begin - 1:
            cand = cand.masked_fill(later_beams, float("-inf"))
        cand, ctok = cand.reshape(b, pool), top_tok.reshape(b, pool)
        order = torch.argsort(-cand, dim=-1, stable=True)
        cand_s, ctok_s, csrc_s = cand.gather(1, order), ctok.gather(1, order), csrc.gather(1, order)
        is_eot = ctok_s == rules.eot
        live_cum = (~is_eot).long().cumsum(-1)
        pick = torch.searchsorted(live_cum, targets, side="left")
        new_tok, new_src, new_lp = ctok_s.gather(1, pick), csrc_s.gather(1, pick), \
            cand_s.gather(1, pick)
        # finished candidates: end-of-text met before the last new beam
        keep_fin = is_eot & (live_cum < nb) & torch.isfinite(cand_s)
        slot = fin_cnt[:, None] + keep_fin.long().cumsum(-1) - 1
        ok = keep_fin & (slot < max_candidates)
        bi, ci = ok.nonzero(as_tuple=True)
        fin_lp[bi, slot[bi, ci]] = cand_s[bi, ci]
        fin_tok[bi, slot[bi, ci]] = buf[bi, csrc_s[bi, ci]]
        fin_cnt = (fin_cnt + keep_fin.sum(-1)).clamp(max=max_candidates)
        moved = buf.gather(1, new_src[:, :, None].expand(-1, -1, total_len))
        moved[:, :, pos + 1] = new_tok
        buf = torch.where(done, buf, moved)
        sum_lp = torch.where(done, sum_lp, new_lp)
        flat_src = (rows * nb + new_src).reshape(-1)
        kc, vc = kc[:, flat_src], vc[:, flat_src]
        if (pos + 2 - sample_begin) % CHECK_EVERY == 0 and bool(
                (fin_cnt >= max_candidates).all()):
            break
    buf, sum_lp = buf.cpu().numpy(), sum_lp.cpu().numpy()
    fin_tok, fin_lp, fin_cnt = fin_tok.cpu().numpy(), fin_lp.cpu().numpy(), fin_cnt.cpu().numpy()

    def length(seq):
        eots = np.nonzero(seq[sample_begin:] == rules.eot)[0]
        return int(eots[0]) if len(eots) else len(seq) - sample_begin

    out_tokens = np.full((b, total_len), rules.eot, np.int32)
    out_avg_lp = np.zeros((b,), np.float32)
    for i in range(b):
        seqs = [fin_tok[i, j] for j in range(int(fin_cnt[i]))]
        lps = [float(fin_lp[i, j]) for j in range(int(fin_cnt[i]))]
        if len(seqs) < beam_size:  # top up with the live beams (+ end-of-text)
            for j in np.argsort(-sum_lp[i]):
                seqs.append(buf[i, j])
                lps.append(float(sum_lp[i, j]))
                if len(seqs) >= beam_size:
                    break
        if length_penalty is None:
            scores = [lp / max(length(s), 1) for s, lp in zip(seqs, lps)]
        else:
            scores = [lp / (((5 + length(s)) / 6) ** length_penalty) for s, lp in zip(seqs, lps)]
        best = int(np.argmax(scores))
        out_tokens[i] = seqs[best]
        out_avg_lp[i] = lps[best] / (length(seqs[best]) + 1)
    return out_tokens, out_avg_lp


# ---------------------------------------------------------------------------
# segments and word timestamps
# ---------------------------------------------------------------------------


def tokens_to_segments(tokens, tokenizer, *, segment_offset_sec: float = 0.0,
                       precision: float = 0.02) -> List[Dict]:
    """Token stream → [{start, end, text, words}] from the timestamp tokens;
    word times split each segment by character length."""
    ts0 = tokenizer.timestamp_begin
    eot = tokenizer.eot
    segments: List[Dict] = []
    cur_text: List[int] = []
    cur_start: Optional[float] = None
    for tok in np.asarray(tokens).tolist():
        if tok == eot:
            continue
        if tok >= ts0:
            t = (tok - ts0) * precision + segment_offset_sec
            if cur_start is None:
                cur_start = t
            elif cur_text:
                segments.append(_with_words(tokenizer.decode(cur_text), cur_start, t))
                cur_text, cur_start = [], t
            else:
                cur_start = t
        elif not _is_special(tok, tokenizer):
            if cur_start is None:
                cur_start = segment_offset_sec
            cur_text.append(tok)
    if cur_text:
        end = (cur_start or 0.0) + 0.02 * len(cur_text)
        segments.append(_with_words(tokenizer.decode(cur_text), cur_start or 0.0, end))
    return segments


def _is_special(tok: int, tokenizer) -> bool:
    return tokenizer.sot <= tok < tokenizer.timestamp_begin


def _with_words(text: str, start: float, end: float) -> Dict:
    words = text.split()
    total_chars = max(sum(len(w) for w in words), 1)
    span = end - start
    out, t = [], start
    for w in words:
        dt = span * len(w) / total_chars
        out.append({"word": w, "start": round(t, 3), "end": round(t + dt, 3)})
        t += dt
    return {"start": round(start, 3), "end": round(end, 3), "text": text.strip(), "words": out}
