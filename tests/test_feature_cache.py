"""Precomputed-feature cache (data/feature_cache.py): build/read parity,
loader cache mode, train-step passthrough, stale-cache rejection."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from ctc_asr import features as feat_mod
from ctc_asr.config import (Config, DataConfig, FeatureConfig,
                            ModelConfig, TrainConfig)
from ctc_asr.data import DataLoader, read_manifest
from ctc_asr.data.feature_cache import (FeatureCache,
                                        build_feature_cache,
                                        feature_key)
from ctc_asr.data.synth import generate_corpus

DATA_CFG = DataConfig(batch_size=4, num_buckets=2, num_workers=2,
                      min_audio_seconds=0.1, max_audio_seconds=10.0)
FEAT_CFG = FeatureConfig()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    out = tmp_path_factory.mktemp("fc_corpus")
    return read_manifest(generate_corpus(str(out), num_utterances=12,
                                         seed=1))


@pytest.fixture(scope="module")
def cache_dir(corpus, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("fc_cache"))
    build_feature_cache(corpus, DATA_CFG, FEAT_CFG, out,
                        progress_every=0)
    return out


def test_cache_matches_extract_features(corpus, cache_dir):
    from ctc_asr import audio as audio_mod
    cache = FeatureCache(cache_dir, FEAT_CFG)
    for u in list(corpus)[:4]:
        assert u.path in cache
        got = cache.read(u.path)
        s, _ = audio_mod.read_wav(u.path, FEAT_CFG.sample_rate)
        feats, flens = feat_mod.extract_features(
            jnp.asarray(s[None, :]), jnp.asarray([len(s)]), FEAT_CFG)
        want = np.asarray(feats[0, :int(flens[0])])
        assert got.shape == want.shape
        np.testing.assert_allclose(np.asarray(got, np.float32), want,
                                   atol=2e-3, rtol=2e-2)


def test_loader_cache_mode_batches(corpus, cache_dir):
    dcfg = dataclasses.replace(DATA_CFG, feature_cache=cache_dir)
    loader = DataLoader(corpus, dcfg, FEAT_CFG, drop_last=False)
    raw_loader = DataLoader(corpus, DATA_CFG, FEAT_CFG, drop_last=False)
    batches = list(loader.iter_epoch(0))
    raw_batches = list(raw_loader.iter_epoch(0))
    assert len(batches) == len(raw_batches)
    for b, rb in zip(batches, raw_batches):
        T = loader.bucket_frames(b.bucket_id)
        F = FEAT_CFG.feature_dim
        assert b.samples.shape == (dcfg.batch_size, T, F)
        assert b.samples.dtype == np.float16
        np.testing.assert_array_equal(b.labels, rb.labels)
        # frame lengths match the on-the-fly pipeline's
        feats, flens = feat_mod.extract_features(
            jnp.asarray(rb.samples), jnp.asarray(rb.sample_lengths),
            FEAT_CFG)
        np.testing.assert_array_equal(b.sample_lengths,
                                      np.asarray(flens))
        np.testing.assert_allclose(
            np.asarray(b.samples[:, :feats.shape[1]], np.float32),
            np.asarray(feats), atol=2e-3, rtol=2e-2)
        assert b.audio_seconds > 0


def test_train_step_accepts_cached_features(corpus, cache_dir):
    from ctc_asr.train import init_train_state, make_train_step
    dcfg = dataclasses.replace(DATA_CFG, feature_cache=cache_dir)
    cfg = Config(
        features=FEAT_CFG,
        model=ModelConfig(frontend="dense", dense_layers=1, dense_units=32,
                          rnn_layers=1, rnn_units=16, dropout=0.0,
                          compute_dtype="float32"),
        data=dcfg,
        train=TrainConfig(learning_rate=1e-3, seed=0))
    loader = DataLoader(corpus, dcfg, FEAT_CFG, drop_last=False)
    state = init_train_state(cfg)
    step = make_train_step(cfg, donate=False)
    b = next(iter(loader.iter_epoch(0)))
    state, m = step(state, jnp.asarray(b.samples),
                    jnp.asarray(b.sample_lengths), jnp.asarray(b.labels),
                    jnp.asarray(b.label_lengths))
    assert np.isfinite(float(m["loss"]))


def test_stale_cache_rejected(cache_dir):
    other = dataclasses.replace(FEAT_CFG, n_mels=40)
    assert feature_key(other) != feature_key(FEAT_CFG)
    with pytest.raises(ValueError, match="different FeatureConfig"):
        FeatureCache(cache_dir, other)
    # an equal config maps to the same key
    assert feature_key(dataclasses.replace(FEAT_CFG)) \
        == feature_key(FEAT_CFG)


def test_batch_dependent_normalization_rejected(corpus, tmp_path):
    fc = dataclasses.replace(FEAT_CFG, normalization="global",
                             stats_path="")
    with pytest.raises(ValueError, match="stats_path"):
        build_feature_cache(corpus, DATA_CFG, fc, str(tmp_path / "c"))


def test_build_ignores_length_filters(corpus, tmp_path):
    """prepare-features caches the WHOLE manifest: a builder invoked
    with tighter length bounds than the eventual train config must not
    produce 'utterance not in cache' at train time (hit on the r4big
    ladder: the preset default min_audio_seconds=0.7 silently dropped
    0.3-0.7 s utterances from the cache)."""
    durations = [u.duration for u in corpus]
    lo, hi = min(durations), max(durations)
    tight = dataclasses.replace(DATA_CFG, min_audio_seconds=lo + 1e-4,
                                max_audio_seconds=hi - 1e-4)
    out = str(tmp_path / "cache")
    build_feature_cache(corpus, tight, FEAT_CFG, out, progress_every=0)
    cache = FeatureCache(out, FEAT_CFG)
    for u in corpus:
        assert u.path in cache, u.path


def test_int8_cache_roundtrip_and_train(corpus, tmp_path):
    """int8 cache wire (VERDICT r4 next #8): fixed-scale quantized
    features dequantize on device to within the quantization step of
    the float pipeline, the loader serves int8 batches (half the f16
    wire bytes), and a train step runs on them."""
    from ctc_asr.data.feature_cache import FEATURE_INT8_SCALE
    out = str(tmp_path / "cache8")
    build_feature_cache(corpus, DATA_CFG, FEAT_CFG, out,
                        progress_every=0, dtype="int8")
    cache = FeatureCache(out, FEAT_CFG)
    assert cache.dtype == "int8" and cache.np_dtype == np.int8

    # per-utterance parity vs the float pipeline within the quant step
    from ctc_asr import audio as audio_mod
    u = corpus[0]
    samples, sr = audio_mod.read_wav(u.path)
    ref, flens = feat_mod.extract_features(
        jnp.asarray(samples)[None], jnp.asarray([len(samples)]), FEAT_CFG)
    got = cache.read(u.path)
    n = int(flens[0])
    assert got.dtype == np.int8
    deq = got[:n].astype(np.float32) / FEATURE_INT8_SCALE
    np.testing.assert_allclose(deq, np.asarray(ref[0, :n]),
                               atol=0.6 / FEATURE_INT8_SCALE)

    # device-side dequant path (extract_features on a 3-D int8 batch)
    feats, lens = feat_mod.extract_features(
        jnp.asarray(got[None, :n]), jnp.asarray([n]), FEAT_CFG)
    np.testing.assert_allclose(np.asarray(feats[0]), deq, rtol=1e-6)

    # loader + train step end-to-end on the int8 wire
    dcfg = dataclasses.replace(DATA_CFG, feature_cache=out)
    loader = DataLoader(corpus, dcfg, FEAT_CFG)
    b = next(iter(loader.iter_epoch(0)))
    assert b.samples.dtype == np.int8
    from ctc_asr.train import init_train_state, make_train_step
    cfg = Config(features=FEAT_CFG,
                 model=ModelConfig(frontend="dense", dense_layers=1,
                                   dense_units=32, rnn_layers=1,
                                   rnn_units=32, dropout=0.0,
                                   compute_dtype="float32"),
                 data=dcfg,
                 train=TrainConfig())
    state = init_train_state(cfg)
    state, m = make_train_step(cfg, donate=False)(
        state, jnp.asarray(b.samples), jnp.asarray(b.sample_lengths),
        jnp.asarray(b.labels), jnp.asarray(b.label_lengths))
    assert np.isfinite(float(m["loss"]))


def test_int8_cache_scale_mismatch_rejected(corpus, tmp_path):
    import json
    import os
    out = str(tmp_path / "cache8")
    build_feature_cache(corpus, DATA_CFG, FEAT_CFG, out,
                        progress_every=0, dtype="int8")
    idx_path = os.path.join(out, "index.json")
    with open(idx_path) as f:
        idx = json.load(f)
    idx["int8_scale"] = 8.0
    with open(idx_path, "w") as f:
        json.dump(idx, f)
    with pytest.raises(ValueError, match="scale"):
        FeatureCache(out, FEAT_CFG)
