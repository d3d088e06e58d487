import jax.numpy as jnp
import numpy as np
import pytest

from ctc_asr import features
from ctc_asr import features as feat_mod
from ctc_asr.config import FeatureConfig


@pytest.fixture(scope="module")
def cfg():
    return FeatureConfig()


def _tone(freq, seconds=0.5, sr=16000):
    t = np.arange(int(seconds * sr)) / sr
    return np.sin(2 * np.pi * freq * t).astype(np.float32)


def test_dft_matmul_matches_numpy_rfft(cfg):
    """rFFT-as-matmul must equal numpy's rfft of the zero-padded frame."""
    rng = np.random.default_rng(0)
    frame = rng.standard_normal(cfg.win_length).astype(np.float32)
    cos_m, msin_m = features.dft_matrices(cfg.win_length, cfg.n_fft)
    re = frame @ cos_m
    im = frame @ msin_m
    ref = np.fft.rfft(frame, n=cfg.n_fft)
    np.testing.assert_allclose(re, ref.real, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(im, ref.imag, rtol=1e-3, atol=1e-3)


def test_frame_count(cfg):
    sr = cfg.sample_rate
    assert features.num_frames(sr, cfg) == 1 + (sr - cfg.win_length) // cfg.hop_length
    assert features.num_frames(cfg.win_length, cfg) == 1
    assert features.num_frames(10, cfg) == 0
    lens = features.frame_lengths_from_sample_lengths(
        np.array([sr, cfg.win_length, 10]), cfg)
    np.testing.assert_array_equal(
        lens, [features.num_frames(sr, cfg), 1, 0])


def test_logmel_peak_bin(cfg):
    """A pure tone's energy must land in the mel band containing its freq."""
    sig = _tone(1000.0)
    logmel = np.asarray(features.log_mel_spectrogram(jnp.asarray(sig), cfg))
    assert logmel.shape[1] == cfg.n_mels
    mean_spec = logmel.mean(axis=0)
    peak_mel = mean_spec.argmax()
    # Find which mel filter is centered nearest 1 kHz.
    fb = features.mel_filterbank(cfg.n_fft, cfg.n_mels, cfg.sample_rate,
                                 cfg.fmin, cfg.fmax)
    bin_freqs = np.arange(cfg.n_fft // 2 + 1) * cfg.sample_rate / cfg.n_fft
    centers = np.asarray([bin_freqs[fb[:, m].argmax()] for m in range(cfg.n_mels)])
    expected = np.abs(centers - 1000.0).argmin()
    assert abs(int(peak_mel) - int(expected)) <= 1


def test_mfcc_shape_and_finite():
    cfg = FeatureConfig(feature_type="mfcc", n_mfcc=13)
    sig = _tone(440.0, seconds=0.3)
    out = np.asarray(features.mfcc(jnp.asarray(sig), cfg))
    T = features.num_frames(len(sig), cfg)
    assert out.shape == (T, 13)
    assert np.isfinite(out).all()


def test_batched_extract_and_normalize(cfg):
    rng = np.random.default_rng(0)
    b0 = rng.standard_normal(int(0.4 * cfg.sample_rate)).astype(np.float32)
    b1 = _tone(2000.0, 0.25)
    S = len(b0)
    batch = np.zeros((2, S), np.float32)
    batch[0] = b0
    batch[1, :len(b1)] = b1
    lens = np.array([len(b0), len(b1)], np.int32)
    feats, flens = features.extract_features(jnp.asarray(batch),
                                             jnp.asarray(lens), cfg)
    feats = np.asarray(feats)
    assert feats.shape[0] == 2 and feats.shape[2] == cfg.n_mels
    np.testing.assert_array_equal(
        np.asarray(flens),
        features.frame_lengths_from_sample_lengths(lens, cfg))
    # padded frames are zeroed
    assert np.allclose(feats[1, int(flens[1]):], 0.0)
    # valid frames are (approximately) standardized per utterance/feature
    valid = feats[0, : int(flens[0])]
    assert np.abs(valid.mean(axis=0)).max() < 0.05
    np.testing.assert_allclose(valid.std(axis=0), 1.0, atol=0.05)


def test_normalize_modes(cfg):
    x = jnp.asarray(np.random.default_rng(1).standard_normal((2, 10, 4)),
                    dtype=jnp.float32)
    lens = jnp.asarray([10, 7])
    for mode in ("utterance", "global", "none"):
        out = features.normalize_features(x, lens, mode)
        assert out.shape == x.shape
    with pytest.raises(ValueError):
        features.normalize_features(x, lens, "bogus")


def test_dataset_stats_global_normalization(tmp_path):
    """compute_dataset_stats + stats_path drives 'global' normalization."""
    from ctc_asr.config import DataConfig, FeatureConfig
    from ctc_asr.data import read_manifest
    from ctc_asr.data.synth import generate_corpus
    mp = generate_corpus(str(tmp_path / "c"), num_utterances=6, seed=4)
    manifest = read_manifest(mp)
    fc = FeatureConfig(n_mels=32, normalization="global")
    dc = DataConfig(batch_size=3, num_buckets=1, num_workers=1,
                    min_audio_seconds=0.05)
    stats_path = str(tmp_path / "stats.npz")
    res = features.compute_dataset_stats(manifest, dc, fc, stats_path)
    assert res["frames"] > 0
    assert res["mean"].shape == (32,)

    fc2 = FeatureConfig(n_mels=32,
                        normalization="global", stats_path=stats_path)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 16000)).astype(np.float32))
    lens = jnp.asarray([16000, 8000])
    feats, flens = features.extract_features(x, lens, fc2)
    assert np.isfinite(np.asarray(feats)).all()
    # differs from the batch-stats fallback (no stats file)
    fc3 = FeatureConfig(n_mels=32,
                        normalization="global")
    feats3, _ = features.extract_features(x, lens, fc3)
    assert not np.allclose(np.asarray(feats), np.asarray(feats3))


def test_spec_augment_masks_and_bounds():
    """SpecAugment: spans only zero values, time masks stay inside each
    utterance's valid region, and widths respect the config bounds."""
    import jax
    from ctc_asr.features import spec_augment
    rng = np.random.default_rng(0)
    B, T, F = 4, 60, 20
    feats = jnp.asarray(np.abs(rng.standard_normal((B, T, F))) + 1.0)
    lens = jnp.asarray([60, 40, 10, 60], jnp.int32)
    out = np.asarray(spec_augment(jax.random.PRNGKey(3), feats, lens,
                                  n_time_masks=2, time_ratio=0.2,
                                  n_freq_masks=2, freq_width=5))
    orig = np.asarray(feats)
    assert out.shape == orig.shape
    # every element is either untouched or exactly zeroed
    changed = out != orig
    assert np.all(out[changed] == 0.0)
    assert changed.any()  # masks actually fire at these settings
    for b in range(B):
        L = int(lens[b])
        # time-masked rows (fully zero rows) only inside [0, len)
        row_zeroed = np.all(changed[b], axis=1)
        assert not row_zeroed[L:].any()
        # per-axis width bounds: time <= 2 masks * ceil(0.2*L),
        # freq <= 2 masks * 5 columns
        assert row_zeroed.sum() <= 2 * int(np.ceil(0.2 * L))
        col_zeroed = np.all(changed[b, :L], axis=0)
        assert col_zeroed.sum() <= 2 * 5


def test_spec_augment_disabled_in_step_is_identity():
    """The train step with specaugment off must be bit-identical to the
    pre-flag behavior (the sa rng is fold_in-derived, so streams don't
    shift), and with it on the loss must stay finite."""
    import jax
    from ctc_asr.config import (Config, DataConfig, FeatureConfig,
                                ModelConfig, TrainConfig)
    from ctc_asr.train import init_train_state, make_step_fn
    rng = np.random.default_rng(0)
    model = ModelConfig(frontend="dense", dense_layers=1, dense_units=16,
                        rnn_layers=1, rnn_units=16, dropout=0.1,
                        compute_dtype="float32")
    mk = lambda sa: Config(  # noqa: E731
        features=FeatureConfig(),
        model=model, data=DataConfig(batch_size=2),
        train=TrainConfig(seed=0, specaugment=sa, sa_time_ratio=0.3))
    B, S, U = 2, 16000, 8
    samples = (rng.standard_normal((B, S)) * 0.1).astype(np.float32)
    slens = np.full((B,), S, np.int32)
    labels = rng.integers(0, 28, (B, U)).astype(np.int32)
    llens = np.full((B,), U, np.int32)
    losses = {}
    for sa in (False, True):
        cfg = mk(sa)
        state = init_train_state(cfg)
        _, m = make_step_fn(cfg)(state, samples, slens, labels, llens)
        losses[sa] = float(m["loss"])
    assert np.isfinite(losses[True])
    # off-path loss must match a second off-path run exactly
    cfg = mk(False)
    state = init_train_state(cfg)
    _, m2 = make_step_fn(cfg)(state, samples, slens, labels, llens)
    assert losses[False] == float(m2["loss"])


# ---------------------------------------------------------------------------
# The matmul feature pipeline against an independent NumPy/SciPy oracle:
# framing -> Hann window -> rFFT power -> HTK mel triangles -> log (->
# orthonormal DCT-II).
# ---------------------------------------------------------------------------

def _signal(B, seconds, sr, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    return np.stack([np.sin(2 * np.pi * (300 + 200 * b) * t)
                     + 0.3 * rng.standard_normal(len(t))
                     for b in range(B)]).astype(np.float32)


def _oracle_features(x, cfg):
    import scipy.fft
    win, hop = cfg.win_length, cfg.hop_length
    T = 1 + (x.shape[-1] - win) // hop
    frames = np.stack([x[..., t * hop:t * hop + win] for t in range(T)], -2)
    n = np.arange(win)
    window = 0.5 - 0.5 * np.cos(2 * np.pi * n / win)
    power = np.abs(np.fft.rfft(frames.astype(np.float64) * window,
                               n=cfg.n_fft)) ** 2
    mel = lambda f: 2595.0 * np.log10(1.0 + f / 700.0)      # noqa: E731
    hz = lambda m: 700.0 * (10.0 ** (m / 2595.0) - 1.0)      # noqa: E731
    edges = hz(np.linspace(mel(cfg.fmin), mel(cfg.fmax), cfg.n_mels + 2))
    freqs = np.arange(cfg.n_fft // 2 + 1) * cfg.sample_rate / cfg.n_fft
    fb = np.zeros((len(freqs), cfg.n_mels))
    for m in range(cfg.n_mels):
        lo, ctr, hi = edges[m:m + 3]
        fb[:, m] = np.clip(np.minimum((freqs - lo) / (ctr - lo),
                                      (hi - freqs) / (hi - ctr)), 0, None)
    logmel = np.log(np.maximum(power @ fb, 1e-6))
    if cfg.feature_type == "mfcc":
        return scipy.fft.dct(logmel, type=2, norm="ortho",
                             axis=-1)[..., :cfg.n_mfcc]
    return logmel


@pytest.mark.parametrize("name,kw,seconds", [
    ("mel", dict(feature_type="mel", n_mels=40), 1.5),
    ("mfcc", dict(feature_type="mfcc", n_mels=40, n_mfcc=13), 1.5),
    ("fmax_nyquist", dict(feature_type="mel", n_mels=40, fmax=8000.0), 1.0),
    ("odd_frames", dict(feature_type="mel", n_mels=80), 0.71),
    ("long_window", dict(feature_type="mel", n_mels=40, win_ms=32.0,
                         hop_ms=3.0), 1.0),
])
def test_features_match_numpy_oracle(name, kw, seconds):
    cfg = FeatureConfig(**kw)
    x = _signal(2, seconds, cfg.sample_rate, seed=len(name))
    got = np.asarray(feat_mod._jnp_features(jnp.asarray(x), cfg))
    want = _oracle_features(x, cfg)
    assert got.shape == want.shape, name
    if name == "odd_frames":
        assert got.shape[1] % 2 == 1
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-3)
