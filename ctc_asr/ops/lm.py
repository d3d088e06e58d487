"""Character n-gram language model for CTC shallow fusion.

Capability parity with the reference's optional LM rescoring (SURVEY.md
§0 stage chain: "optionally LM-rescored"; BASELINE.json:10 "beam search
with n-gram LM shallow-fusion rescoring"), re-designed for on-device
decode:

- **Training** (host, numpy): count character n-grams of order N over a
  transcript corpus with Witten-Bell-smoothed interpolation down to the
  unigram, then *materialize a dense table* ``log P(c | ctx)`` of shape
  [V^(N-1), V]. All backoff happens at build time.
- **Inference** (device): scoring inside the beam-search kernel is a
  single gather per step; the context id updates with one multiply-add:
  ``ctx' = (ctx * V + c) % V**(N-1)``. No tries, no pointer chasing —
  the on-device analog of a KenLM trie (SURVEY.md §2b note).

Vocabulary: the 28 label symbols (a-z, space, apostrophe). Positions
before the start of the prefix are BOS, folded in by seeding the context
id with V-based BOS digits at build time (BOS reuses the space symbol's
id — word boundaries and utterance starts behave alike for a char LM).
"""

from __future__ import annotations

import numpy as np

from ..text import ALPHABET, encode

V = len(ALPHABET)  # 28 (no blank in the LM vocab)
BOS = 0            # space id doubles as BOS: start-of-utterance ~ word start


def _context_size(order: int) -> int:
    return V ** (order - 1)


def train_char_lm(transcripts, order: int = 4) -> dict:
    """Count-based Witten-Bell interpolated char LM -> dense arrays.

    Returns {"table": [V^(N-1), V] float32 log-probs, "order": N}.
    """
    if order < 2:
        raise ValueError("order must be >= 2")
    # counts[k] maps context-tuple (len k) -> np.ndarray[V] of counts
    counts = [dict() for _ in range(order)]
    for text in transcripts:
        ids = encode(text)
        padded = [BOS] * (order - 1) + list(map(int, ids))
        for i in range(order - 1, len(padded)):
            c = padded[i]
            for k in range(order):
                ctx = tuple(padded[i - k:i])
                vec = counts[k].get(ctx)
                if vec is None:
                    vec = np.zeros(V, np.float64)
                    counts[k][ctx] = vec
                vec[c] += 1.0

    # Interpolated Witten-Bell: p_k(c|ctx) = lam * ml + (1-lam) * p_{k-1},
    # lam = n(ctx) / (n(ctx) + types(ctx)).
    uni = counts[0][()]
    p_uni = (uni + 1.0) / (uni.sum() + V)

    def smoothed(ctx: tuple) -> np.ndarray:
        p = p_uni
        for k in range(1, order):
            sub = ctx[len(ctx) - k:]
            vec = counts[k].get(sub)
            if vec is None:
                continue
            n = vec.sum()
            types = float((vec > 0).sum())
            lam = n / (n + max(types, 1.0))
            p = lam * (vec / n) + (1.0 - lam) * p
        return p

    # Materialize EVERY context row exactly (V^(N-1) rows: 22k at order 4,
    # 614k at order 5 — build-time enumerable, so backoff is fully folded
    # into the dense table and device scoring is one gather).
    n_ctx = _context_size(order)
    table = np.empty((n_ctx, V), np.float32)
    ctx_digits = [0] * (order - 1)
    for idx in range(n_ctx):
        table[idx] = np.log(np.maximum(smoothed(tuple(ctx_digits)), 1e-12))
        # increment base-V counter (most-significant digit first)
        for d in range(order - 2, -1, -1):
            ctx_digits[d] += 1
            if ctx_digits[d] < V:
                break
            ctx_digits[d] = 0
    return {"table": table, "order": np.int32(order)}


def save_lm(path: str, lm: dict) -> None:
    np.savez_compressed(path, **lm)


def load_lm(path: str) -> dict:
    with np.load(path) as z:
        return {"table": z["table"].astype(np.float32),
                "order": int(z["order"])}


def initial_context(order: int) -> int:
    """Context id for an empty prefix: (BOS,)*(order-1) in base V."""
    idx = 0
    for _ in range(order - 1):
        idx = idx * V + BOS
    return idx


def next_context(ctx: int, c: int, order: int) -> int:
    """Host-side context update (device version lives in beam search)."""
    return (ctx * V + int(c)) % _context_size(order)


def score_text(lm: dict, text: str) -> float:
    """Total log P(text) under the LM (host-side; used in tests)."""
    order = int(lm["order"])
    table = lm["table"]
    ctx = initial_context(order)
    total = 0.0
    for c in encode(text):
        total += float(table[ctx, int(c)])
        ctx = next_context(ctx, int(c), order)
    return total


# ---------------------------------------------------------------------------
# Word-level n-gram LM: host-side N-best rescoring (the reference's
# second LM mode; SURVEY.md §7 M4 "word-level rescoring of final beams
# on host as fallback")
# ---------------------------------------------------------------------------

UNK = "<unk>"


def train_word_lm(transcripts, order: int = 2) -> dict:
    """Witten-Bell interpolated word n-gram LM as nested count dicts.

    Kept sparse (vocab is unbounded); scoring backs off to the unigram
    and an OOV floor. Returns {"order", "vocab", "counts"} (counts[k]
    maps a context tuple of length k to {word: count}).
    """
    if order < 1:
        raise ValueError("order must be >= 1")
    counts = [dict() for _ in range(order)]
    vocab = set()
    bos = ("<s>",) * (order - 1)
    for text in transcripts:
        words = tuple(text.split())
        vocab.update(words)
        seq = bos + words + ("</s>",)
        for i in range(order - 1, len(seq)):
            w = seq[i]
            for k in range(order):
                ctx = seq[i - k:i]
                d = counts[k].setdefault(ctx, {})
                d[w] = d.get(w, 0) + 1
    return {"order": order, "vocab": vocab, "counts": counts}


def _prepare_word_lm(lm: dict) -> dict:
    """Precompute Witten-Bell stats once (VERDICT r1 weak #3 fix).

    The naive scorer recomputed ``sum(uni.values())`` (O(|V|)) and the
    per-context total/type counts on EVERY word lookup — that, not the
    n-gram math, was the 10-30x host-rescoring RTF cliff. Here each
    context's ``(lam, 1/n)`` pair is computed once; scoring becomes a
    couple of dict gets and multiply-adds per word. Idempotent; called
    lazily from the scorers so pickles from either version work.
    """
    if "_prepared" in lm:
        return lm
    uni = lm["counts"][0].get((), {})
    lm["_uni_total"] = float(sum(uni.values()) or 1)
    lm["_ctx"] = []
    for k in range(1, lm["order"]):
        stats = {}
        for ctx, d in lm["counts"][k].items():
            n = float(sum(d.values()))
            lam = n / (n + len(d))
            stats[ctx] = (lam, lam / n, d)
        lm["_ctx"].append(stats)
    lm["_prepared"] = True
    return lm


def word_logprob(lm: dict, ctx: tuple, word: str) -> float:
    """log P(word | ctx) with Witten-Bell interpolation to unigram and
    a uniform-over-(|V|+1) OOV floor."""
    _prepare_word_lm(lm)
    v = max(len(lm["vocab"]), 1)
    uni = lm["counts"][0].get((), {})
    p = (uni.get(word, 0) + 1.0) / (lm["_uni_total"] + v + 1)
    for k in range(1, lm["order"]):
        sub = tuple(ctx[len(ctx) - k:]) if k <= len(ctx) else None
        entry = lm["_ctx"][k - 1].get(sub) if sub is not None else None
        if entry is None:
            continue
        lam, lam_over_n, d = entry
        p = lam_over_n * d.get(word, 0) + (1.0 - lam) * p
    return float(np.log(max(p, 1e-12)))


def score_words(lm: dict, text: str) -> float:
    """Total log P(text) under the word LM (includes </s>)."""
    order = lm["order"]
    ctx = ("<s>",) * (order - 1)
    total = 0.0
    for w in text.split() + ["</s>"]:
        total += word_logprob(lm, ctx, w)
        ctx = (ctx + (w,))[-(order - 1):] if order > 1 else ()
    return total


def rescore_nbest(nbest_texts, am_scores, word_lm: dict,
                  alpha: float = 1.0, beta: float = 0.0) -> int:
    """Pick the best hypothesis index: am + alpha*logP_lm + beta*#words.

    ``nbest_texts``: list of hypothesis strings for ONE utterance;
    ``am_scores``: matching acoustic(+char-LM) scores.
    """
    best_i, best_s = 0, -float("inf")
    for i, (text, am) in enumerate(zip(nbest_texts, am_scores)):
        s = float(am) + alpha * score_words(word_lm, text) \
            + beta * len(text.split())
        if s > best_s:
            best_i, best_s = i, s
    return best_i


def rescore_nbest_batch(texts, am_scores, word_lm: dict,
                        alpha: float = 1.0, beta: float = 0.0,
                        cache: dict | None = None) -> np.ndarray:
    """Batched N-best rescoring: ``texts`` is a [B][K] nested list of
    hypothesis strings, ``am_scores`` a [B, K] array. Returns the [B]
    argmax indices of ``am + alpha*logP_lm + beta*#words``.

    Identical hypothesis strings (beam N-best lists are full of them
    after CTC collapsing, and across a batch short phrases repeat) are
    scored ONCE via ``cache`` — pass a dict to persist it across
    batches. Entries are keyed by hypothesis TEXT only, so a cache
    dict must never be shared across different word LMs (it would
    silently return the wrong LM's scores); keep one cache per
    (LM, alpha-independent) scoring context, as evaluate.py does. With _prepare_word_lm this removes the host-rescoring RTF
    cliff (VERDICT r1 weak #3): scoring is now a handful of dict ops
    per unique hypothesis word instead of O(|V|) per word.
    """
    _prepare_word_lm(word_lm)
    if cache is None:
        cache = {}
    out = np.zeros(len(texts), np.int64)
    for b, hyps in enumerate(texts):
        best_i, best_s = 0, -float("inf")
        for i, text in enumerate(hyps):
            lp = cache.get(text)
            if lp is None:
                lp = score_words(word_lm, text)
                cache[text] = lp
            s = float(am_scores[b][i]) + alpha * lp \
                + beta * len(text.split())
            if s > best_s:
                best_i, best_s = i, s
        out[b] = best_i
    return out


def save_word_lm(path: str, lm: dict) -> None:
    import pickle
    with open(path, "wb") as f:
        pickle.dump({"order": lm["order"], "vocab": sorted(lm["vocab"]),
                     "counts": [{k: v for k, v in c.items()}
                                for c in lm["counts"]]}, f)


def load_word_lm(path: str) -> dict:
    import pickle
    with open(path, "rb") as f:
        d = pickle.load(f)
    d["vocab"] = set(d["vocab"])
    return d
