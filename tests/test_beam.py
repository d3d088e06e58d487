"""Prefix beam search vs a slow Python oracle (SURVEY.md §4.1)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ctc_asr.ops.beam import beam_search_decode, make_beam_decoder
from ctc_asr.ops.greedy import greedy_decode


def _logaddexp(a, b):
    return np.logaddexp(a, b)


def oracle_prefix_beam(log_probs, K, blank):
    """Textbook dict-based prefix beam search. log_probs [T, C] numpy."""
    T, C = log_probs.shape
    NEG = -1e30
    beams = {(): (0.0, NEG)}  # prefix -> (p_b, p_nb)
    for t in range(T):
        lp = log_probs[t]
        new = {}

        def upd(prefix, pb=None, pnb=None):
            cpb, cpnb = new.get(prefix, (NEG, NEG))
            if pb is not None:
                cpb = _logaddexp(cpb, pb)
            if pnb is not None:
                cpnb = _logaddexp(cpnb, pnb)
            new[prefix] = (cpb, cpnb)

        for prefix, (pb, pnb) in beams.items():
            total = _logaddexp(pb, pnb)
            # stay: blank path
            upd(prefix, pb=total + lp[blank])
            # stay: repeat-collapse path
            if prefix:
                upd(prefix, pnb=pnb + lp[prefix[-1]])
            # extend
            for c in range(C - 1):
                p = (pb + lp[c]) if (prefix and c == prefix[-1]) \
                    else (total + lp[c])
                upd(prefix + (c,), pnb=p)
        beams = dict(sorted(new.items(),
                            key=lambda kv: -_logaddexp(*kv[1]))[:K])
    best = max(beams.items(), key=lambda kv: _logaddexp(*kv[1]))
    return list(best[0]), _logaddexp(*best[1])


@pytest.mark.parametrize("seed,T,C,K", [(0, 8, 5, 4), (1, 12, 6, 8),
                                        (2, 15, 4, 16), (3, 10, 8, 8)])
def test_matches_oracle(seed, T, C, K):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((1, T, C)).astype(np.float32) * 2.0
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits[0]), -1))
    want_ids, want_score = oracle_prefix_beam(lp, K, blank=C - 1)
    ids, lens = beam_search_decode(jnp.asarray(logits), jnp.asarray([T]),
                                   beam_width=K, blank_id=C - 1,
                                   space_id=0)
    got = list(np.asarray(ids)[0, :int(lens[0])])
    assert got == want_ids, (got, want_ids)


def test_respects_logit_lengths():
    rng = np.random.default_rng(5)
    C, T = 5, 10
    logits = rng.standard_normal((2, T, C)).astype(np.float32) * 2.0
    # batch 0 full length; batch 1 truncated to 4 frames
    ids, lens = beam_search_decode(jnp.asarray(logits),
                                   jnp.asarray([T, 4]), beam_width=6,
                                   blank_id=C - 1)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits[1, :4]), -1))
    want_ids, _ = oracle_prefix_beam(lp, 6, blank=C - 1)
    got = list(np.asarray(ids)[1, :int(lens[1])])
    assert got == want_ids


def test_peaked_logits_match_greedy():
    """With near-one-hot posteriors, beam must equal greedy collapse."""
    rng = np.random.default_rng(7)
    B, T, C = 3, 20, 29
    path = rng.integers(0, C, (B, T))
    logits = np.full((B, T, C), -8.0, np.float32)
    for b in range(B):
        for t in range(T):
            logits[b, t, path[b, t]] = 8.0
    lens = jnp.asarray([T, T, T])
    g_ids, g_lens = greedy_decode(jnp.asarray(logits), lens)
    b_ids, b_lens = beam_search_decode(jnp.asarray(logits), lens,
                                       beam_width=8)
    for b in range(B):
        assert list(np.asarray(b_ids)[b, :int(b_lens[b])]) == \
            list(np.asarray(g_ids)[b, :int(g_lens[b])])


def test_beam_improves_on_greedy_score():
    """Beam's best path posterior sum >= greedy's (on soft posteriors)."""
    rng = np.random.default_rng(11)
    T, C, K = 14, 5, 16
    logits = rng.standard_normal((1, T, C)).astype(np.float32)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits[0]), -1))
    _, beam_score = oracle_prefix_beam(lp, K, C - 1)
    ids, lens = beam_search_decode(jnp.asarray(logits), jnp.asarray([T]),
                                   beam_width=K, blank_id=C - 1)
    got = list(np.asarray(ids)[0, :int(lens[0])])
    want_ids, _ = oracle_prefix_beam(lp, K, C - 1)
    assert got == want_ids


def test_lm_fusion_biases_decode():
    """An LM that loves one char must flip a near-tie toward it."""
    from ctc_asr.ops import lm as lm_mod
    # train a tiny LM that has only ever seen "bbbb..."
    lm = lm_mod.train_char_lm(["bbbbbb bbbb", "bbb bbbbb"], order=2)
    C = 29
    T = 6
    a_id, b_id = 1, 2  # 'a', 'b'
    logits = np.full((1, T, C), -5.0, np.float32)
    # acoustically near-tied between 'a' and 'b' every frame
    logits[0, :, a_id] = 2.0
    logits[0, :, b_id] = 1.9
    no_lm = make_beam_decoder(beam_width=8)
    with_lm = make_beam_decoder(beam_width=8, lm=lm, lm_weight=3.0)
    ids0, l0 = no_lm(jnp.asarray(logits), jnp.asarray([T]))
    ids1, l1 = with_lm(jnp.asarray(logits), jnp.asarray([T]))
    dec0 = list(np.asarray(ids0)[0, :int(l0[0])])
    dec1 = list(np.asarray(ids1)[0, :int(l1[0])])
    # acoustics slightly prefer 'a'; the b-only LM must push decode to 'b'
    assert dec0.count(a_id) >= dec0.count(b_id), dec0
    assert dec1.count(b_id) > dec1.count(a_id), dec1


def test_batch_vectorization_consistent():
    """Batched decode == per-utterance decode."""
    rng = np.random.default_rng(13)
    B, T, C, K = 4, 10, 6, 8
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    lens = np.array([10, 7, 10, 3], np.int32)
    ids_b, lens_b = beam_search_decode(jnp.asarray(logits),
                                       jnp.asarray(lens), beam_width=K,
                                       blank_id=C - 1)
    for b in range(B):
        ids_1, lens_1 = beam_search_decode(jnp.asarray(logits[b:b + 1]),
                                           jnp.asarray(lens[b:b + 1]),
                                           beam_width=K, blank_id=C - 1)
        assert list(np.asarray(ids_b)[b, :int(lens_b[b])]) == \
            list(np.asarray(ids_1)[0, :int(lens_1[0])])


# ---------------------------------------------------------------------------
# The XLA beam against an oracle that also fuses a char LM: batches with
# per-utterance lengths, LM fusion, N-best lists, merging, ties and the
# decode buffer.
# ---------------------------------------------------------------------------

def oracle_nbest(log_probs, K, blank, lm_table=None, lm_weight=0.0,
                 word_bonus=0.0, init_ctx=0, lm_vocab=28, space=0):
    """Dict-based prefix beam search with char-LM shallow fusion:
    rank = log P_ctc + lm_weight * log P_lm + word_bonus * n_spaces.
    Returns [(prefix, score)] best first (the final beam)."""
    T, C = log_probs.shape
    NEG = -1e30
    n_ctx = lm_table.shape[0] if lm_table is not None else 1
    # prefix -> [p_b, p_nb, lm, bonus, ctx]
    beams = {(): [0.0, NEG, 0.0, 0.0, init_ctx]}

    def rank(v):
        return _logaddexp(v[0], v[1]) + lm_weight * v[2] + word_bonus * v[3]

    for t in range(T):
        lp = log_probs[t]
        new = {}

        def upd(prefix, meta, pb=None, pnb=None):
            cur = new.setdefault(prefix, [NEG, NEG] + list(meta))
            if pb is not None:
                cur[0] = _logaddexp(cur[0], pb)
            if pnb is not None:
                cur[1] = _logaddexp(cur[1], pnb)

        for prefix, (pb, pnb, lm, bonus, ctx) in beams.items():
            total = _logaddexp(pb, pnb)
            upd(prefix, (lm, bonus, ctx), pb=total + lp[blank])
            if prefix:
                upd(prefix, (lm, bonus, ctx), pnb=pnb + lp[prefix[-1]])
            for c in range(C - 1):
                p = (pb + lp[c]) if (prefix and c == prefix[-1]) \
                    else (total + lp[c])
                if lm_table is not None:
                    meta = (lm + float(lm_table[ctx, c]),
                            bonus + (c == space),
                            (ctx * lm_vocab + c) % n_ctx)
                else:
                    meta = (0.0, bonus + (c == space), 0)
                upd(prefix + (c,), meta, pnb=p)
        beams = dict(sorted(new.items(), key=lambda kv: -rank(kv[1]))[:K])
    return sorted(((list(p), rank(v)) for p, v in beams.items()),
                  key=lambda pv: -pv[1])


def _tiny_lm(order):
    from ctc_asr.ops import lm as lm_mod
    texts = ["the cat sat on the mat", "a quick brown fox",
             "hello world how are you",
             "this is a test of the language model fusion path"]
    lm = lm_mod.train_char_lm(texts * 3, order=order)
    return lm, lm_mod.initial_context(order)


def _lists(ids, lens):
    ids, lens = np.asarray(ids), np.asarray(lens)
    return [list(ids[b, :int(lens[b])]) for b in range(ids.shape[0])]


@pytest.mark.parametrize("seed,B,T,C,K", [
    (0, 2, 8, 6, 8),
    (1, 1, 12, 6, 8),
    (2, 3, 10, 5, 16),
])
def test_batch_with_lengths_matches_oracle(seed, B, T, C, K):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, C)).astype(np.float32) * 2.0
    lens = rng.integers(T // 2, T + 1, B).astype(np.int32)
    ids, got_lens = beam_search_decode(jnp.asarray(logits),
                                       jnp.asarray(lens), beam_width=K,
                                       blank_id=C - 1)
    for b in range(B):
        lp = np.asarray(jax.nn.log_softmax(
            jnp.asarray(logits[b, :lens[b]]), -1))
        assert _lists(ids, got_lens)[b] == \
            oracle_nbest(lp, K, C - 1)[0][0], b


@pytest.mark.parametrize("seed,B,T,K,order,w,bonus", [
    (0, 2, 16, 8, 2, 0.5, 0.0),
    (1, 3, 24, 8, 3, 0.6, 0.5),
    (2, 1, 30, 16, 3, 1.2, 1.0),
])
def test_lm_fusion_matches_oracle(seed, B, T, K, order, w, bonus):
    lm, init_ctx = _tiny_lm(order)
    table = np.asarray(lm["table"])
    rng = np.random.default_rng(seed)
    C = 29
    logits = rng.standard_normal((B, T, C)).astype(np.float32) * 2.0
    lens = rng.integers(T // 2, T + 1, B).astype(np.int32)
    ids, got_lens = beam_search_decode(
        jnp.asarray(logits), jnp.asarray(lens), beam_width=K,
        lm_table=jnp.asarray(table), lm_weight=w, word_bonus=bonus,
        init_ctx=init_ctx)
    for b in range(B):
        lp = np.asarray(jax.nn.log_softmax(
            jnp.asarray(logits[b, :lens[b]]), -1))
        want = oracle_nbest(lp, K, C - 1, table, w, bonus, init_ctx)
        assert _lists(ids, got_lens)[b] == want[0][0], b


def test_lm_fusion_changes_output():
    """With a heavy LM weight the fused decode must differ from the
    acoustic-only decode on ambiguous posteriors (the LM terms reach
    the ranking)."""
    lm, init_ctx = _tiny_lm(3)
    rng = np.random.default_rng(7)
    B, T, C = 4, 40, 29
    logits = jnp.asarray(rng.standard_normal((B, T, C)).astype(np.float32))
    lens = jnp.asarray(np.full(B, T, np.int32))
    plain = beam_search_decode(logits, lens, beam_width=8)
    fused = beam_search_decode(logits, lens, beam_width=8,
                               lm_table=jnp.asarray(lm["table"]),
                               lm_weight=3.0, init_ctx=init_ctx)
    assert _lists(*plain) != _lists(*fused)


def test_blank_not_last_raises():
    with pytest.raises(ValueError, match="last class"):
        beam_search_decode(jnp.zeros((1, 4, 6)), jnp.asarray([4]),
                           blank_id=2)


def test_no_duplicate_beams():
    """Equal prefixes reached from different parents merge into ONE
    beam (sort + segment reduction), never two live copies."""
    for seed in (106, 1, 9):
        rng = np.random.default_rng(seed)
        T = 16
        lg = jnp.asarray(rng.standard_normal((1, T, 29)).astype(np.float32)
                         * 2)
        ids, lens, scores = beam_search_decode(
            lg, jnp.asarray([T]), beam_width=8, return_nbest=True)
        live = [tuple(int(x) for x in np.asarray(ids[0, k, :int(lens[0, k])]))
                for k in range(8) if float(scores[0, k]) > -1e29]
        assert len(live) == len(set(live)), f"duplicate beams at seed {seed}"


def test_nbest_matches_oracle():
    """The whole final beam, best first, with its scores."""
    rng = np.random.default_rng(5)
    B, T, C, K = 2, 14, 29, 8
    logits = rng.standard_normal((B, T, C)).astype(np.float32) * 2
    lens = np.full(B, T, np.int32)
    ids, nlens, scores = beam_search_decode(
        jnp.asarray(logits), jnp.asarray(lens), beam_width=K,
        return_nbest=True)
    for b in range(B):
        lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits[b]), -1))
        want = oracle_nbest(lp, K, C - 1)
        for k, (prefix, score) in enumerate(want):
            assert list(np.asarray(ids[b, k, :int(nlens[b, k])])) == \
                prefix, (b, k)
            assert abs(float(scores[b, k]) - score) < 1e-3


def test_tied_scores_same_beam_set():
    """Exact cross-beam score ties (common with quantized logits): the
    tie-break is part of the algorithm, so decoding each utterance alone
    must give the batch's N-best exactly, the list must be sorted best
    first, and its live beams distinct."""
    for seed in (0, 3, 11):
        rng = np.random.default_rng(seed)
        B, T, C, K = 2, 10, 6, 8
        lg = np.round(rng.standard_normal((B, T, C)) * 2) / 2.0
        lg = jnp.asarray(lg.astype(np.float32))
        lens = jnp.asarray(np.full(B, T, np.int32))
        ids, nl, xs = beam_search_decode(lg, lens, beam_width=K,
                                         blank_id=C - 1, return_nbest=True)
        xs = np.asarray(xs)
        for b in range(B):
            one = beam_search_decode(lg[b:b + 1], lens[b:b + 1],
                                     beam_width=K, blank_id=C - 1,
                                     return_nbest=True)
            np.testing.assert_array_equal(np.asarray(one[0])[0],
                                          np.asarray(ids)[b])
            np.testing.assert_array_equal(np.asarray(one[2])[0], xs[b])
            assert np.all(np.diff(xs[b]) <= 0), (seed, b)
            live = [tuple(np.asarray(ids)[b, k, :int(nl[b, k])])
                    for k in range(K) if xs[b, k] > -1e29]
            assert len(live) == len(set(live)), (seed, b)


def test_long_decode_buffer_from_config():
    """Long-audio configs must grow the decode buffer (or fail loudly),
    never silently truncate at a fixed 256-character clamp."""
    from ctc_asr.config import Config, DataConfig, DecodeConfig
    from ctc_asr.ops.beam import derive_max_decode_len

    cfg = Config(data=DataConfig(max_audio_seconds=30.0),
                 decode=DecodeConfig(method="beam"))
    derived = derive_max_decode_len(cfg.decode, cfg.data)
    assert derived == 480  # 30 s * 16 chars/s

    # a >256-char transcript decodes fully through the config-derived
    # buffer (peaked logits alternating char/blank emit T//2 chars)
    n_chars = 300
    T, C = 2 * n_chars, 29
    logits = np.full((1, T, C), -10.0, np.float32)
    want = [(i % 27) + 1 for i in range(n_chars)]
    for i, c in enumerate(want):
        logits[0, 2 * i, c] = 10.0
        logits[0, 2 * i + 1, C - 1] = 10.0
    ids, lens = beam_search_decode(
        jnp.asarray(logits), jnp.asarray([T], np.int32), beam_width=2,
        max_decode_len=derived)
    assert int(lens[0]) == n_chars
    assert list(np.asarray(ids[0, :n_chars])) == want

    # explicit override wins
    assert derive_max_decode_len(DecodeConfig(max_decode_len=123),
                                 cfg.data) == 123


def test_decode_buffer_clamps_length():
    """A transcript longer than max_decode_len fills the buffer and
    stops; the reported length never exceeds the ids width."""
    n_chars, cap = 40, 16
    T, C = 2 * n_chars, 29
    logits = np.full((1, T, C), -10.0, np.float32)
    want = [(i % 27) + 1 for i in range(n_chars)]
    for i, c in enumerate(want):
        logits[0, 2 * i, c] = 10.0
        logits[0, 2 * i + 1, C - 1] = 10.0
    ids, lens = beam_search_decode(
        jnp.asarray(logits), jnp.asarray([T], np.int32), beam_width=2,
        max_decode_len=cap)
    assert ids.shape[1] == cap and int(lens[0]) == cap
    assert list(np.asarray(ids[0])) == want[:cap]
