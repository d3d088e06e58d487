"""Vectorized CTC prefix beam search — batched, on device, jit-compiled.

Replaces ``tf.nn.ctc_beam_search_decoder`` (the reference's per-utterance
*sequential CPU* C++ decoder, SURVEY.md §2b row 2) with an on-device
design (SURVEY.md §7 M3, BASELINE.json:5 "on-device vectorized prefix
beam search"):

- Beam state is a fixed-shape struct of arrays ``[B, K, ...]`` living on
  device; the time loop is a ``lax.scan``; the batch dim is ``vmap``-ed.
- The control-flow-heavy hypothesis merge (identical prefixes produced
  by different parents) is expressed as *sort + segmented reduction*,
  not branches (SURVEY.md §7 hard parts: "express merge as sort/
  segment-max, not branches"): candidate prefixes carry two independent
  32-bit rolling hashes; a two-key lexicographic ``lax.sort`` groups
  equal prefixes; segment_max/segment_sum compute the log-sum-exp merge;
  ``lax.top_k`` keeps the best K.
- Blank/non-blank probability split (``p_b``/``p_nb``) follows the
  classic prefix-search recurrence exactly, so results match a Python
  oracle on small cases (tests/test_beam.py).
- Optional char n-gram LM shallow fusion (ops/lm.py): score =
  log P_ctc + lm_weight * log P_lm + word_bonus * n_words; the LM adds
  one [K, V] gather per step and an integer context-id update — no trie.

Candidate layout per step: K "stay" candidates (prefix unchanged; absorbs
the blank path AND the repeat-last-char path) + K*(C-1) "extend"
candidates. Total K*C rows, sorted/merged/topk'd per batch element.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..text import BLANK_ID, PAD_ID

NEG = -1.0e30

# Rolling-hash constants (two independent 32-bit lanes ~ one 64-bit hash).
_H1_MUL, _H1_ADD = jnp.uint32(1000003), jnp.uint32(0x9E3779B9)
_H2_MUL, _H2_ADD = jnp.uint32(69069), jnp.uint32(0x85EBCA6B)


class BeamState(NamedTuple):
    prefixes: jnp.ndarray   # [K, U] int32, PAD_ID beyond length
    lengths: jnp.ndarray    # [K] int32
    last: jnp.ndarray       # [K] int32, -1 for empty prefix
    p_b: jnp.ndarray        # [K] f32 log P(prefix, ends in blank)
    p_nb: jnp.ndarray       # [K] f32 log P(prefix, ends in non-blank)
    h1: jnp.ndarray         # [K] uint32 rolling hash lane 1
    h2: jnp.ndarray         # [K] uint32 rolling hash lane 2
    ctx: jnp.ndarray        # [K] int32 LM context id
    lm: jnp.ndarray         # [K] f32 accumulated LM log prob
    bonus: jnp.ndarray      # [K] f32 accumulated word-bonus count


def _logaddexp(a, b):
    m = jnp.maximum(a, b)
    m = jnp.maximum(m, NEG)
    return m + jnp.log(jnp.exp(a - m) + jnp.exp(b - m))


def _init_state(K: int, U: int, init_ctx: int) -> BeamState:
    return BeamState(
        prefixes=jnp.full((K, U), PAD_ID, jnp.int32),
        lengths=jnp.zeros((K,), jnp.int32),
        last=jnp.full((K,), -1, jnp.int32),
        p_b=jnp.full((K,), NEG, jnp.float32).at[0].set(0.0),
        p_nb=jnp.full((K,), NEG, jnp.float32),
        h1=jnp.full((K,), 17, jnp.uint32),
        h2=jnp.full((K,), 29, jnp.uint32),
        ctx=jnp.full((K,), init_ctx, jnp.int32),
        lm=jnp.zeros((K,), jnp.float32),
        bonus=jnp.zeros((K,), jnp.float32),
    )


def _step(state: BeamState, lp: jnp.ndarray, valid,
          K: int, C: int, blank_id: int, space_id: int,
          lm_table, lm_weight: float, word_bonus: float,
          lm_vocab: int, lm_ctx_size: int) -> BeamState:
    """One timestep of prefix beam search for one utterance.

    lp: [C] log-softmax frame posteriors; valid: scalar bool.
    ``lm_table`` may be a dense [n_ctx, V] array OR a callable
    ``ctx [K] -> rows [K, V]`` (e.g. the model-axis-sharded lookup in
    parallel/decode_dist.py, which assembles rows with a psum).
    """
    Cr = C - 1  # number of real (non-blank) characters
    N = K * C   # total candidates: K stay + K*(C-1) extend

    # ---- stay candidates (one per beam) --------------------------------
    total = _logaddexp(state.p_b, state.p_nb)            # [K]
    stay_pb = total + lp[blank_id]
    last_lp = jnp.where(state.last >= 0,
                        lp[jnp.maximum(state.last, 0)], NEG)
    stay_pnb = state.p_nb + last_lp

    # ---- extend candidates ([K, Cr]) -----------------------------------
    chars = jnp.arange(Cr, dtype=jnp.int32)              # [Cr]
    is_repeat = chars[None, :] == state.last[:, None]    # [K, Cr]
    base = jnp.where(is_repeat, state.p_b[:, None], total[:, None])
    ext_pnb = base + lp[None, :Cr]                       # [K, Cr]

    # hashes / LM for extend
    c1 = chars.astype(jnp.uint32)
    ext_h1 = state.h1[:, None] * _H1_MUL + (c1[None, :] + _H1_ADD)
    ext_h2 = state.h2[:, None] * _H2_MUL + (c1[None, :] + _H2_ADD)
    if lm_table is not None:
        if callable(lm_table):
            lm_rows = lm_table(state.ctx)                # pluggable lookup
        else:
            lm_rows = lm_table[state.ctx]                # [K, V]
        ext_lm = state.lm[:, None] + lm_rows[:, :Cr]
        ext_ctx = (state.ctx[:, None] * lm_vocab + chars[None, :]) \
            % lm_ctx_size
    else:
        ext_lm = jnp.zeros((K, Cr), jnp.float32)
        ext_ctx = jnp.zeros((K, Cr), jnp.int32)
    ext_bonus = state.bonus[:, None] + \
        (chars[None, :] == space_id).astype(jnp.float32)

    # ---- flatten candidates [N] ----------------------------------------
    cand_pb = jnp.concatenate([stay_pb, jnp.full((K * Cr,), NEG)], 0)
    cand_pnb = jnp.concatenate([stay_pnb, ext_pnb.reshape(-1)], 0)
    cand_h1 = jnp.concatenate([state.h1, ext_h1.reshape(-1)], 0)
    cand_h2 = jnp.concatenate([state.h2, ext_h2.reshape(-1)], 0)
    cand_parent = jnp.concatenate(
        [jnp.arange(K, dtype=jnp.int32),
         jnp.repeat(jnp.arange(K, dtype=jnp.int32), Cr)], 0)
    cand_char = jnp.concatenate(
        [jnp.full((K,), -1, jnp.int32),
         jnp.tile(chars, K)], 0)
    cand_lm = jnp.concatenate([state.lm, ext_lm.reshape(-1)], 0)
    cand_ctx = jnp.concatenate([state.ctx, ext_ctx.reshape(-1)], 0)
    cand_bonus = jnp.concatenate([state.bonus, ext_bonus.reshape(-1)], 0)

    # Dead-parent candidates (score NEG on both lanes) must not merge
    # with live ones by hash: poison their hashes with the row index.
    dead = (cand_pb <= NEG / 2) & (cand_pnb <= NEG / 2)
    row = jax.lax.broadcasted_iota(jnp.uint32, (N, 1), 0)[:, 0]
    cand_h1 = jnp.where(dead, row + jnp.uint32(0xDEAD0000), cand_h1)
    cand_h2 = jnp.where(dead, row, cand_h2)

    # ---- sort by (h1, h2) and merge equal prefixes ---------------------
    (s_h1, s_h2, s_pb, s_pnb, s_parent, s_char, s_lm, s_ctx, s_bonus) = \
        jax.lax.sort((cand_h1, cand_h2, cand_pb, cand_pnb, cand_parent,
                      cand_char, cand_lm, cand_ctx, cand_bonus),
                     num_keys=2)
    head = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_),
         (s_h1[1:] != s_h1[:-1]) | (s_h2[1:] != s_h2[:-1])], 0)
    seg = jnp.cumsum(head.astype(jnp.int32)) - 1         # [N] segment ids

    def seg_lse(vals):
        smax = jax.ops.segment_max(vals, seg, num_segments=N)
        smax = jnp.maximum(smax, NEG)
        ssum = jax.ops.segment_sum(jnp.exp(vals - smax[seg]), seg,
                                   num_segments=N)
        return smax + jnp.log(jnp.maximum(ssum, 1e-38))

    merged_pb = seg_lse(s_pb)[seg]                       # broadcast back
    merged_pnb = seg_lse(s_pnb)[seg]
    # Representative = first row of each segment; others get score NEG.
    score = _logaddexp(merged_pb, merged_pnb) \
        + lm_weight * s_lm + word_bonus * s_bonus
    score = jnp.where(head, score, NEG)

    # ---- top-K ----------------------------------------------------------
    _top_scores, top_idx = jax.lax.top_k(score, K)
    new_pb = merged_pb[top_idx]
    new_pnb = merged_pnb[top_idx]
    parent = s_parent[top_idx]
    char = s_char[top_idx]
    is_ext = char >= 0

    # ---- rebuild beam arrays -------------------------------------------
    par_prefix = state.prefixes[parent]                  # [K, U]
    par_len = state.lengths[parent]
    U = par_prefix.shape[1]
    pos = jnp.arange(U, dtype=jnp.int32)[None, :]
    write = is_ext[:, None] & (pos == par_len[:, None])
    new_prefixes = jnp.where(write, char[:, None], par_prefix)
    # clamp at U: once the prefix buffer is full the write above is a
    # no-op, and an unclamped length would exceed the ids array width
    # (callers slice ids[:length])
    new_lengths = jnp.minimum(par_len + is_ext.astype(jnp.int32), U)
    new_last = jnp.where(is_ext, char, state.last[parent])
    new_state = BeamState(
        prefixes=new_prefixes,
        lengths=new_lengths,
        last=new_last,
        p_b=new_pb,
        p_nb=new_pnb,
        h1=s_h1[top_idx],
        h2=s_h2[top_idx],
        ctx=s_ctx[top_idx],
        lm=s_lm[top_idx],
        bonus=s_bonus[top_idx],
    )

    # Invalid frames (t >= logit_length) leave the beam untouched.
    return jax.tree_util.tree_map(
        lambda new, old: jnp.where(
            jnp.reshape(valid, (1,) * new.ndim), new, old),
        new_state, state)


def _decode_one(log_probs, logit_len, K, C, U, blank_id, space_id,
                lm_table, lm_weight, word_bonus, lm_vocab, lm_ctx_size,
                init_ctx):
    """log_probs [T, C] -> (prefix [U], length, score) for one utterance."""
    T = log_probs.shape[0]
    state = _init_state(K, U, init_ctx)

    def body(st, inp):
        lp, t = inp
        st = _step(st, lp, t < logit_len, K, C, blank_id, space_id,
                   lm_table, lm_weight, word_bonus, lm_vocab, lm_ctx_size)
        return st, None

    state, _ = jax.lax.scan(body, state,
                            (log_probs, jnp.arange(T, dtype=jnp.int32)))
    score = _logaddexp(state.p_b, state.p_nb) \
        + lm_weight * state.lm + word_bonus * state.bonus
    # Full beam, best-first (N-best surface for host rescoring).
    order = jnp.argsort(-score)
    return (state.prefixes[order], state.lengths[order], score[order])


def beam_search_decode(logits: jnp.ndarray, logit_lengths: jnp.ndarray,
                       beam_width: int = 64,
                       blank_id: int = BLANK_ID, space_id: int = 0,
                       lm_table=None, lm_weight: float = 0.0,
                       word_bonus: float = 0.0,
                       init_ctx: int = 0, lm_vocab: int = 28,
                       max_decode_len: int | None = None,
                       lm_ctx_size: int | None = None,
                       return_nbest: bool = False):
    """[B, T, C] logits -> (ids [B, U], lengths [B]), or with
    ``return_nbest`` the whole best-first beam
    (ids [B, K, U], lengths [B, K], scores [B, K]) for host-side
    N-best rescoring (ops.lm.rescore_nbest).

    The blank must be the last class (``blank_id == C - 1``): the extend
    candidates are the classes before it. ``max_decode_len`` caps the
    emitted prefix length (defaults to min(T, 256)).
    """
    B, T, C = logits.shape
    if blank_id != C - 1:
        raise ValueError(f"beam search needs the blank as the last class "
                         f"(blank_id={blank_id}, C={C})")
    # one char max per frame: min(max_decode_len, T) is exact, not a cap
    U = min(max_decode_len, max(T, 1)) if max_decode_len else min(T, 256)
    log_probs = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    if lm_ctx_size is None:
        lm_ctx_size = int(lm_table.shape[0]) \
            if lm_table is not None and not callable(lm_table) else 1

    fn = functools.partial(
        _decode_one, K=beam_width, C=C, U=U, blank_id=blank_id,
        space_id=space_id, lm_table=lm_table, lm_weight=lm_weight,
        word_bonus=word_bonus, lm_vocab=lm_vocab,
        lm_ctx_size=lm_ctx_size, init_ctx=init_ctx)
    prefixes, lengths, scores = jax.vmap(fn)(log_probs, logit_lengths)
    if return_nbest:
        return prefixes, lengths, scores
    return prefixes[:, 0], lengths[:, 0]


# Conservative upper bound on English character rate (incl. spaces);
# ~12 chars/s is typical fast speech, 16 leaves headroom. Used to derive
# the decode-buffer length from data.max_audio_seconds so long-audio
# configs fail loudly (or grow the buffer) instead of truncating.
MAX_CHARS_PER_SECOND = 16.0


def derive_max_decode_len(decode_cfg, data_cfg) -> int:
    """Decode-buffer length for a Config: explicit override or
    ``ceil(max_audio_seconds * MAX_CHARS_PER_SECOND)``."""
    if getattr(decode_cfg, "max_decode_len", 0):
        return int(decode_cfg.max_decode_len)
    import math
    return max(8, math.ceil(
        float(data_cfg.max_audio_seconds) * MAX_CHARS_PER_SECOND))


def make_beam_decoder(beam_width: int, lm=None, lm_weight: float = 0.0,
                      word_bonus: float = 0.0,
                      max_decode_len: int | None = None):
    """Build a jitted ``(logits, logit_lens) -> (ids, lens)`` decoder.

    When ``lm`` (a dict from ops.lm) is given, shallow fusion is enabled;
    without it the decoder is pure-acoustic (lm_weight forced to 0).
    """
    if lm is not None:
        from . import lm as lm_mod
        table = jnp.asarray(lm["table"])
        init_ctx = lm_mod.initial_context(int(lm["order"]))
        lm_vocab = lm_mod.V
    else:
        table, init_ctx, lm_vocab = None, 0, 28
        lm_weight = 0.0
        word_bonus = 0.0

    @jax.jit
    def decode(logits, logit_lens):
        return beam_search_decode(
            logits, logit_lens, beam_width=beam_width, lm_table=table,
            lm_weight=lm_weight, word_bonus=word_bonus,
            init_ctx=init_ctx, lm_vocab=lm_vocab,
            max_decode_len=max_decode_len)

    return decode
