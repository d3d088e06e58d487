"""Hard synthetic corpus (data/synth.py) + batched word-LM rescoring:
the round-2 WER-discrimination assets (VERDICT r1 next #1, #5)."""

import numpy as np

from ctc_asr.data.manifest import read_manifest
from ctc_asr.data.synth import (build_vocabulary, generate_hard_corpus,
                                render_transcript_hard, speaker_params)
from ctc_asr.ops import lm as lm_mod
from ctc_asr.text import ALPHABET


def test_vocabulary_deterministic_and_charset_clean():
    v1 = build_vocabulary(128, seed=5)
    v2 = build_vocabulary(128, seed=5)
    assert v1 == v2
    assert len(v1) == 128
    assert len(set(v1)) == 128
    for w in v1:
        assert all(c in ALPHABET for c in w), w
        assert " " not in w


def test_speaker_params_vary_and_are_deterministic():
    a, b = speaker_params(3), speaker_params(4)
    assert a == speaker_params(3)
    assert a["fscale"] != b["fscale"]
    assert 0.85 <= a["fscale"] <= 1.15
    assert 0.8 <= a["speed"] <= 1.25


def test_render_hard_deterministic_and_bounded():
    s1 = render_transcript_hard("hello world", speaker=2, snr_db=8.0,
                                seed=11)
    s2 = render_transcript_hard("hello world", speaker=2, snr_db=8.0,
                                seed=11)
    np.testing.assert_array_equal(s1, s2)
    assert s1.dtype == np.float32
    assert np.abs(s1).max() <= 0.8 + 1e-6
    # different speaker -> different audio for the same text
    s3 = render_transcript_hard("hello world", speaker=9, snr_db=8.0,
                                seed=11)
    assert len(s3) != len(s1) or not np.allclose(s1, s3)


def test_noise_levels_scale_with_snr():
    # same seed => identical tones/babble/durations, only noise_std
    # differs; the noisier signal correlates less with the near-clean one
    clean = render_transcript_hard("abc", speaker=0, snr_db=60.0, seed=3)
    quiet = render_transcript_hard("abc", speaker=0, snr_db=20.0, seed=3)
    loud = render_transcript_hard("abc", speaker=0, snr_db=0.0, seed=3)
    c_quiet = np.corrcoef(clean, quiet)[0, 1]
    c_loud = np.corrcoef(clean, loud)[0, 1]
    assert c_loud < c_quiet < 1.0


def test_hard_corpus_disjoint_splits(tmp_path):
    m = generate_hard_corpus(str(tmp_path), n_train=10, n_dev=4,
                             n_test=4, seed=3)
    seen = {}
    for split, count in (("train", 10), ("dev", 4), ("test", 4)):
        utts = read_manifest(m[split])
        assert len(utts) == count
        seen[split] = {u.transcript for u in utts}
        for u in utts:
            assert 0.1 < u.duration < 20.0
    assert not (seen["train"] & seen["dev"])
    assert not (seen["train"] & seen["test"])
    assert not (seen["dev"] & seen["test"])


def test_rescore_batch_matches_per_utterance():
    texts = ["the cat sat", "the bat sat", "a dog ran", "a dog can"]
    wlm = lm_mod.train_word_lm(["the cat sat on the mat",
                                "a dog ran far"], order=2)
    nbest = [[texts[0], texts[1]], [texts[2], texts[3]],
             [texts[1], texts[0]]]
    am = np.array([[0.0, 0.1], [0.0, 0.0], [-1.0, 0.0]], np.float32)
    got = lm_mod.rescore_nbest_batch(nbest, am, wlm, alpha=1.0, beta=0.0)
    want = [lm_mod.rescore_nbest(h, a, wlm, alpha=1.0, beta=0.0)
            for h, a in zip(nbest, am)]
    assert list(got) == want


def test_rescore_batch_cache_hits_duplicates():
    wlm = lm_mod.train_word_lm(["one two three"], order=2)
    cache = {}
    nbest = [["one two", "one two"], ["one two", "three"]]
    am = np.zeros((2, 2), np.float32)
    lm_mod.rescore_nbest_batch(nbest, am, wlm, cache=cache)
    # 2 unique hypotheses -> 2 cache entries despite 4 scores
    assert len(cache) == 2


def test_oov_vocabulary_disjoint_and_prefix_stable():
    """build_vocabulary is prefix-stable, so the OOV inventory is the
    exact continuation of the base distribution with zero shared word
    types (the open-vocab axis, VERDICT r4 next #1)."""
    from ctc_asr.data.synth import build_oov_vocabulary
    base = build_vocabulary(384)
    assert build_vocabulary(768)[:384] == base
    oov = build_oov_vocabulary(384, 384)
    assert len(oov) == 384
    assert not set(oov) & set(base)
    # same charset and syllable-ish length profile
    assert all(set(w) <= set(ALPHABET.replace(" ", "")) for w in oov)
    assert abs(np.mean([len(w) for w in oov])
               - np.mean([len(w) for w in base])) < 1.5


def test_generate_hard_split_matches_corpus_distribution(tmp_path):
    """generate_hard_split reproduces generate_hard_corpus's recipe:
    disjoint transcripts vs an exclude set, requested speaker pool,
    wav lengths in the corpus's range, all words from the given
    vocabulary."""
    from ctc_asr.data.synth import generate_hard_split
    vocab = build_vocabulary(64)
    exclude = {"aa bb", " ".join([str(vocab[0])] * 2)}
    path = generate_hard_split(str(tmp_path), "extra", vocab, 12,
                               seed=11, spk_base=1000, n_speakers=12,
                               split_id=5, exclude_transcripts=exclude)
    man = read_manifest(path)
    assert len(man) == 12
    trs = [u.transcript for u in man]
    assert len(set(trs)) == 12 and not (set(trs) & exclude)
    for u in man:
        assert all(w in vocab for w in u.transcript.split())
        assert 0.1 < u.duration < 12.0


def test_generate_lm_text_covers_vocab_without_audio():
    from ctc_asr.data.synth import generate_lm_text
    vocab = build_vocabulary(64)
    texts = generate_lm_text(vocab, 500, seed=3)
    assert len(texts) == 500
    seen = set(w for t in texts for w in t.split())
    assert len(seen) > 50  # near-full coverage at 500 sentences
    assert seen <= set(map(str, vocab))
