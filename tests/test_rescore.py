"""Word-LM N-best rescoring (host-side, reference's 2nd LM mode)."""


import numpy as np
import pytest

from ctc_asr.ops import lm as lm_mod


CORPUS = ["the cat sat on the mat", "the dog sat on the rug",
          "a cat and a dog", "the cat ran"] * 3


def test_word_lm_prefers_seen_bigrams():
    wlm = lm_mod.train_word_lm(CORPUS, order=2)
    good = lm_mod.score_words(wlm, "the cat sat")
    bad = lm_mod.score_words(wlm, "mat the a")
    assert good > bad


def test_word_logprob_backoff():
    wlm = lm_mod.train_word_lm(CORPUS, order=2)
    # seen bigram beats unseen bigram with same unigram
    p_seen = lm_mod.word_logprob(wlm, ("the",), "cat")
    p_unseen = lm_mod.word_logprob(wlm, ("rug",), "cat")
    assert p_seen > p_unseen
    # OOV floor is finite
    assert np.isfinite(lm_mod.word_logprob(wlm, ("the",), "zebra"))


def test_rescore_nbest_flips_to_fluent():
    wlm = lm_mod.train_word_lm(CORPUS, order=2)
    nbest = ["the cat sat", "the cat sab", "tha cat sat"]
    # acoustics slightly prefer the misspelled hyp
    am = [-10.2, -10.0, -10.4]
    i = lm_mod.rescore_nbest(nbest, am, wlm, alpha=1.0, beta=0.0)
    assert i == 0


def test_rescore_alpha_zero_keeps_am_best():
    wlm = lm_mod.train_word_lm(CORPUS, order=2)
    nbest = ["the cat sat", "the cat sab"]
    am = [-10.2, -10.0]
    assert lm_mod.rescore_nbest(nbest, am, wlm, alpha=0.0) == 1


def test_word_lm_roundtrip(tmp_path):
    wlm = lm_mod.train_word_lm(CORPUS, order=2)
    p = str(tmp_path / "wlm.pkl")
    lm_mod.save_word_lm(p, wlm)
    wlm2 = lm_mod.load_word_lm(p)
    assert abs(lm_mod.score_words(wlm, "the cat sat")
               - lm_mod.score_words(wlm2, "the cat sat")) < 1e-9


def test_nbest_evaluate_path(tmp_path):
    """evaluate() with word_lm_path wired end-to-end (tiny model)."""
    import jax
    from ctc_asr.config import (Config, DataConfig, DecodeConfig,
                                FeatureConfig, ModelConfig)
    from ctc_asr.data import DataLoader, read_manifest
    from ctc_asr.data.synth import generate_corpus
    from ctc_asr.evaluate import evaluate
    from ctc_asr.train import init_train_state

    mp = generate_corpus(str(tmp_path / "c"), num_utterances=6, seed=2,
                         min_words=1, max_words=2)
    manifest = read_manifest(mp)
    wlm = lm_mod.train_word_lm([u.transcript for u in manifest], order=2)
    wlm_path = str(tmp_path / "wlm.pkl")
    lm_mod.save_word_lm(wlm_path, wlm)
    cfg = Config(
        features=FeatureConfig(feature_type="mfcc", n_mfcc=13, n_mels=26),
        model=ModelConfig(frontend="dense", dense_layers=1, dense_units=32,
                          rnn_layers=1, rnn_units=32, dropout=0.0,
                          compute_dtype="float32"),
        data=DataConfig(batch_size=3, num_buckets=1, num_workers=1,
                        min_audio_seconds=0.05),
        decode=DecodeConfig(method="beam", beam_width=8, nbest=4,
                            word_lm_path=wlm_path),
    )
    state = init_train_state(cfg)
    loader = DataLoader(manifest, cfg.data, cfg.features, drop_last=False)
    res = evaluate(cfg, state["params"], loader=loader, log_samples=0)
    assert res["utterances"] == 6
    assert 0 <= res["wer"]  # untrained model; we only check the plumbing


def test_nbest_evaluate_path_lm_fusion(tmp_path):
    """Same plumbing with char-LM fusion inside the N-best beam, then
    word-LM rescoring of its list."""
    from ctc_asr.config import (Config, DataConfig, DecodeConfig,
                                FeatureConfig, ModelConfig)
    from ctc_asr.data import DataLoader, read_manifest
    from ctc_asr.data.synth import generate_corpus
    from ctc_asr import evaluate as ev
    from ctc_asr.train import init_train_state

    mp = generate_corpus(str(tmp_path / "c"), num_utterances=4, seed=3,
                         min_words=1, max_words=2)
    manifest = read_manifest(mp)
    texts = [u.transcript for u in manifest]
    wlm = lm_mod.train_word_lm(texts, order=2)
    wlm_path = str(tmp_path / "wlm.pkl")
    lm_mod.save_word_lm(wlm_path, wlm)
    clm = lm_mod.train_char_lm(texts, order=2)
    clm_path = str(tmp_path / "clm.npz")
    lm_mod.save_lm(clm_path, clm)

    cfg = Config(
        features=FeatureConfig(feature_type="mfcc", n_mfcc=13, n_mels=26),
        model=ModelConfig(frontend="dense", dense_layers=1, dense_units=32,
                          rnn_layers=1, rnn_units=32, dropout=0.0,
                          compute_dtype="float32"),
        data=DataConfig(batch_size=2, num_buckets=1, num_workers=1,
                        min_audio_seconds=0.05),
        decode=DecodeConfig(method="beam", beam_width=8, nbest=4,
                            lm_path=clm_path, lm_weight=0.4,
                            word_lm_path=wlm_path),
    )
    state = init_train_state(cfg)
    loader = DataLoader(manifest, cfg.data, cfg.features, drop_last=False)

    res = ev.evaluate(cfg, state["params"], loader=loader, log_samples=0)
    assert res["utterances"] == 4
    assert 0 <= res["wer"]
