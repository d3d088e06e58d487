import numpy as np
import pytest

from ctc_asr import text
from ctc_asr.metrics import (ErrorRateAccumulator, cer, levenshtein,
                             paired_bootstrap, wer)


def test_charset_size():
    assert text.NUM_CLASSES == 29
    assert text.BLANK_ID == 28
    assert len(text.ALPHABET) == 28


def test_roundtrip():
    s = "hello world's end"
    ids = text.encode(s)
    assert text.decode_ids(ids) == s


def test_normalize():
    assert text.normalize_transcript("Hello,  World!") == "hello world"
    assert text.normalize_transcript("IT'S ME") == "it's me"
    assert text.normalize_transcript("a-b_c") == "a b c"
    assert text.normalize_transcript("  x  ") == "x"


def test_encode_batch_padding():
    batch, lens = text.encode_batch(["ab", "a"], max_len=4)
    assert batch.shape == (2, 4)
    np.testing.assert_array_equal(lens, [2, 1])
    assert batch[1, 1] == text.PAD_ID
    assert batch[0, 0] == text.encode("a")[0]


def test_levenshtein():
    assert levenshtein("kitten", "sitting") == 3
    assert levenshtein("", "abc") == 3
    assert levenshtein("abc", "abc") == 0
    assert levenshtein(["a", "b"], ["a", "c", "b"]) == 1


def test_wer_cer():
    assert wer("the cat sat", "the cat sat") == 0.0
    assert wer("the cat sat", "the bat sat") == 1 / 3
    assert wer("", "") == 0.0
    assert wer("", "x") == 1.0
    assert cer("abc", "axc") == 1 / 3


def test_corpus_accumulator():
    acc = ErrorRateAccumulator()
    acc.add("the cat", "the cat")
    acc.add("a b c d", "a x c d")
    # corpus WER = total edits / total ref words = 1/6
    assert abs(acc.wer - 1 / 6) < 1e-9
    assert acc.utterances == 2
    assert acc.utt_records == [(0, 2, 0, 7), (1, 4, 1, 7)]


def test_bootstrap_ci():
    rng = np.random.default_rng(0)
    acc = ErrorRateAccumulator()
    # 200 utterances, ~20% of them carrying one word error out of five
    for i in range(200):
        ref = "a b c d e"
        hyp = "a b c d x" if rng.random() < 0.2 else ref
        acc.add(ref, hyp)
    ci = acc.bootstrap_ci(seed=1)
    lo, hi = ci["wer_ci95"]
    # point estimate inside the interval, interval brackets the truth,
    # deterministic for a fixed seed
    assert lo <= acc.wer <= hi
    assert lo < 0.2 / 5 < hi or abs(acc.wer - 0.2 / 5) > 0.01
    assert hi - lo < 0.05
    assert acc.bootstrap_ci(seed=1) == ci
    assert "cer_ci95" in ci
    # degenerate: fewer than 2 utterances -> no CI
    one = ErrorRateAccumulator()
    one.add("a", "a")
    assert one.bootstrap_ci() == {}


def test_paired_bootstrap():
    # System A strictly better than B on the same refs: 0 errors vs 1
    # error on half the utterances -> delta < 0 with p_a_better ~ 1.
    ra = [(0, 4, 0, 10)] * 100
    rb = [((1 if i % 2 else 0), 4, 1, 10) for i in range(100)]
    out = paired_bootstrap(ra, rb, seed=0)
    assert out["wer_delta"] == -0.125
    assert out["wer_delta_ci95"][1] < 0
    assert out["p_a_better"] > 0.99
    # identical systems -> delta 0, CI spans 0-width at exactly 0
    same = paired_bootstrap(ra, ra, seed=0)
    assert same["wer_delta"] == 0.0
    assert same["wer_delta_ci95"] == [0.0, 0.0]
    with pytest.raises(ValueError):
        paired_bootstrap(ra, rb[:-1])
