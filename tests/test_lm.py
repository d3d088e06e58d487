import numpy as np

from ctc_asr.ops import lm as lm_mod
from ctc_asr.text import encode


def test_table_shape_and_normalization():
    lm = lm_mod.train_char_lm(["the cat sat", "the dog ran"], order=3)
    table = lm["table"]
    assert table.shape == (lm_mod.V ** 2, lm_mod.V)
    # every row is a (log) distribution
    sums = np.exp(table).sum(axis=1)
    np.testing.assert_allclose(sums, 1.0, atol=1e-3)


def test_seen_ngram_scores_higher():
    lm = lm_mod.train_char_lm(["abab abab abab"] * 5, order=3)
    # after context "ab", 'a' (seen: "aba") must beat 'q' (unseen)
    ctx = lm_mod.initial_context(3)
    for c in encode("ab"):
        ctx = lm_mod.next_context(ctx, int(c), 3)
    a, q = int(encode("a")[0]), int(encode("q")[0])
    assert lm["table"][ctx, a] > lm["table"][ctx, q]


def test_score_text_prefers_in_domain():
    corpus = ["the quick brown fox", "the lazy dog", "the quick dog"]
    lm = lm_mod.train_char_lm(corpus * 3, order=3)
    good = lm_mod.score_text(lm, "the quick fox")
    bad = lm_mod.score_text(lm, "zqx jvk wpf")
    assert good > bad


def test_save_load_roundtrip(tmp_path):
    lm = lm_mod.train_char_lm(["hello world"], order=2)
    p = str(tmp_path / "lm.npz")
    lm_mod.save_lm(p, lm)
    lm2 = lm_mod.load_lm(p)
    assert lm2["order"] == 2
    np.testing.assert_allclose(lm["table"], lm2["table"], rtol=1e-6)


def test_context_rolls():
    order = 3
    ctx = lm_mod.initial_context(order)
    assert ctx == 0  # BOS == space == id 0
    c1 = lm_mod.next_context(ctx, 5, order)
    c2 = lm_mod.next_context(c1, 7, order)
    assert c2 == (5 * lm_mod.V + 7)
    # rolls off old history
    c3 = lm_mod.next_context(c2, 1, order)
    assert c3 == (7 * lm_mod.V + 1)
