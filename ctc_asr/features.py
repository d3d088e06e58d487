"""Feature extraction: framing -> window -> rFFT -> mel -> log (-> DCT).

Capability parity with the reference's ``asr/load_sample.py`` (SURVEY.md
§2a: 25 ms window / 10 ms hop MFCC or log-mel via python_speech_features,
per-feature normalization) — re-designed rather than ported:

- The whole pipeline is **matmul-formulated** (SURVEY.md §7 M2a): the
  real FFT is computed as two matmuls against precomputed DFT
  cosine/sine matrices, the mel filterbank is a matmul, and the MFCC
  DCT-II is a matmul. No complex dtypes, no jnp.fft; XLA hands the
  matmuls to the GPU's BLAS and fuses the window and log around them.
- Framing is a static gather (index matrix computed at trace time); all
  shapes are static under jit.

Runs batched on device: [B, S] padded samples -> [B, T, F] features.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .config import FeatureConfig


# ---------------------------------------------------------------------------
# Precomputed constant matrices (host-side numpy, cached per-geometry)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def dft_matrices(win_length: int, n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT as matmul: returns (cos, -sin) matrices [win, n_fft//2+1].

    power_spectrum(frame) == (frame @ cos)**2 + (frame @ msin)**2 for a
    frame zero-padded to n_fft (zero-padding is folded in by truncating
    the DFT basis rows to win_length).
    """
    n_bins = n_fft // 2 + 1
    n = np.arange(win_length)[:, None]          # [win, 1]
    k = np.arange(n_bins)[None, :]              # [1, bins]
    ang = 2.0 * np.pi * n * k / float(n_fft)
    return (np.cos(ang).astype(np.float32),
            (-np.sin(ang)).astype(np.float32))


@functools.lru_cache(maxsize=8)
def hann_window(win_length: int) -> np.ndarray:
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_fft: int, n_mels: int, sample_rate: int,
                   fmin: float, fmax: float) -> np.ndarray:
    """Triangular mel filterbank matrix [n_fft//2+1, n_mels] (HTK scale)."""
    n_bins = n_fft // 2 + 1
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    bin_freqs = np.arange(n_bins) * sample_rate / float(n_fft)
    fb = np.zeros((n_bins, n_mels), dtype=np.float32)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (bin_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - bin_freqs) / max(hi - ctr, 1e-9)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


@functools.lru_cache(maxsize=8)
def dct_matrix(n_mels: int, n_mfcc: int) -> np.ndarray:
    """Orthonormal DCT-II matrix [n_mels, n_mfcc]."""
    n = np.arange(n_mels)[:, None]
    k = np.arange(n_mfcc)[None, :]
    mat = np.cos(np.pi * (2.0 * n + 1.0) * k / (2.0 * n_mels))
    mat *= np.sqrt(2.0 / n_mels)
    mat[:, 0] *= np.sqrt(0.5) if n_mfcc > 0 else 1.0
    return mat.astype(np.float32)


# ---------------------------------------------------------------------------
# Shape helpers
# ---------------------------------------------------------------------------

def num_frames(n_samples: int, cfg: FeatureConfig) -> int:
    """Frame count for ``n_samples`` samples (no centering/padding)."""
    if n_samples < cfg.win_length:
        return 0
    return 1 + (n_samples - cfg.win_length) // cfg.hop_length


def frame_lengths_from_sample_lengths(sample_lengths, cfg: FeatureConfig):
    """Vector version of num_frames (jnp or np), clipped at >= 0."""
    xp = jnp if isinstance(sample_lengths, jax.Array) else np
    return xp.maximum(
        0, 1 + (sample_lengths - cfg.win_length) // cfg.hop_length
    ).astype(xp.int32)


# ---------------------------------------------------------------------------
# Feature pipeline
# ---------------------------------------------------------------------------

def frame_signal(samples: jnp.ndarray, cfg: FeatureConfig) -> jnp.ndarray:
    """[..., S] samples -> [..., T, win] frames via static gather."""
    S = samples.shape[-1]
    T = max(1, num_frames(S, cfg))
    idx = (np.arange(T)[:, None] * cfg.hop_length
           + np.arange(cfg.win_length)[None, :])  # [T, win]
    idx = np.minimum(idx, S - 1)
    return samples[..., idx]


def log_mel_spectrogram(samples: jnp.ndarray, cfg: FeatureConfig,
                        log_floor: float = 1e-6) -> jnp.ndarray:
    """[..., S] float32 samples -> [..., T, n_mels] log-mel features."""
    frames = frame_signal(samples, cfg)                      # [..., T, W]
    frames = frames * jnp.asarray(hann_window(cfg.win_length))
    cos_m, msin_m = dft_matrices(cfg.win_length, cfg.n_fft)
    re = frames @ jnp.asarray(cos_m)                         # [..., T, bins]
    im = frames @ jnp.asarray(msin_m)
    power = re * re + im * im
    fb = jnp.asarray(mel_filterbank(cfg.n_fft, cfg.n_mels, cfg.sample_rate,
                                    cfg.fmin, cfg.fmax))
    mel = power @ fb                                         # [..., T, mels]
    return jnp.log(jnp.maximum(mel, log_floor))


def mfcc(samples: jnp.ndarray, cfg: FeatureConfig) -> jnp.ndarray:
    """[..., S] samples -> [..., T, n_mfcc] MFCCs (DCT-II of log-mel)."""
    logmel = log_mel_spectrogram(samples, cfg)
    return logmel @ jnp.asarray(dct_matrix(cfg.n_mels, cfg.n_mfcc))


def normalize_features(feats: jnp.ndarray, frame_lengths: jnp.ndarray,
                       mode: str = "utterance", stats=None) -> jnp.ndarray:
    """Per-utterance (masked) or dataset-level mean/variance
    normalization (the reference supported both, SURVEY.md §2a).

    ``feats``: [B, T, F]; ``frame_lengths``: [B]. Padding frames are
    excluded from the statistics and zeroed on output so downstream
    padding is deterministic. ``stats``: optional (mean [F], var [F])
    dataset-level arrays used by "global" mode; without them, "global"
    falls back to whole-batch statistics.
    """
    B, T, F = feats.shape
    mask = (jnp.arange(T)[None, :] < frame_lengths[:, None])  # [B, T]
    maskf = mask[..., None].astype(feats.dtype)
    n = jnp.maximum(frame_lengths.astype(feats.dtype), 1.0)[:, None, None]
    if mode == "none":
        # Zero pad frames even without normalization: conv SAME receptive
        # fields pull pad frames into valid outputs, so pad content must
        # be mode-independent (and match the zero-filled feature cache).
        out = feats
    elif mode == "utterance":
        mean = jnp.sum(feats * maskf, axis=1, keepdims=True) / n
        var = jnp.sum(jnp.square(feats - mean) * maskf, axis=1,
                      keepdims=True) / n
        out = (feats - mean) * jax.lax.rsqrt(var + 1e-8)
    elif mode == "global":
        if stats is not None:
            mean = jnp.asarray(stats[0]).reshape(1, 1, -1)
            var = jnp.asarray(stats[1]).reshape(1, 1, -1)
        else:
            # whole-batch fallback when no dataset stats are provided
            total = jnp.sum(maskf)
            mean = jnp.sum(feats * maskf, axis=(0, 1),
                           keepdims=True) / total
            var = jnp.sum(jnp.square(feats - mean) * maskf, axis=(0, 1),
                          keepdims=True) / total
        out = (feats - mean) * jax.lax.rsqrt(var + 1e-8)
    else:
        raise ValueError(f"unknown normalization mode {mode!r}")
    return out * maskf


def extract_features(samples: jnp.ndarray, sample_lengths: jnp.ndarray,
                     cfg: FeatureConfig) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Batched end-to-end frontend: [B, S], [B] -> ([B, T, F], [B]).

    The single entry point used by the data pipeline and the transcribe
    CLI.

    Accepts int16 *wire* samples (the loader's default transport — half
    the host->device bytes of f32, exact for int16-PCM sources) and
    rescales on device; see audio.float_to_wire16.

    A 3-D input is a precomputed-feature batch from the feature cache
    (data/feature_cache.py): [B, T, F] float16 post-normalization
    features with ``sample_lengths`` already holding frame counts —
    passed through (cast to f32) with no DSP or re-normalization.
    """
    if samples.ndim == 3:
        if samples.dtype == jnp.int8:
            # int8 feature-cache wire: fixed-scale quantized
            # post-normalization features (data/feature_cache.py
            # FEATURE_INT8_SCALE) — dequantize on device
            from .data.feature_cache import FEATURE_INT8_SCALE
            return (samples.astype(jnp.float32)
                    * (1.0 / FEATURE_INT8_SCALE),
                    sample_lengths.astype(jnp.int32))
        return (samples.astype(jnp.float32),
                sample_lengths.astype(jnp.int32))
    if samples.dtype == jnp.int16:
        from .audio import WIRE_SCALE
        samples = samples.astype(jnp.float32) * (1.0 / WIRE_SCALE)
    elif samples.dtype == jnp.uint8:
        from .audio import ULAW_MU
        y = samples.astype(jnp.float32) * (1.0 / 127.5) - 1.0
        samples = jnp.sign(y) * (
            jnp.exp(jnp.abs(y) * np.log1p(ULAW_MU)) - 1.0) / ULAW_MU
    feats = _jnp_features(samples, cfg)
    flens = frame_lengths_from_sample_lengths(sample_lengths, cfg)
    stats = _load_stats(cfg.stats_path) if cfg.stats_path else None
    feats = normalize_features(feats, flens, cfg.normalization, stats)
    return feats, flens


@functools.lru_cache(maxsize=8)
def _load_stats(path: str):
    """(mean [F], var [F]) numpy arrays from a compute-stats npz."""
    with np.load(path) as z:
        return np.asarray(z["mean"], np.float32), \
            np.asarray(z["var"], np.float32)


def compute_dataset_stats(manifest, data_cfg, feat_cfg, out_path: str,
                          max_batches: int | None = None) -> dict:
    """Accumulate masked per-feature mean/var over a manifest (on
    device, batched via the loader) and save to ``out_path``."""
    from .data.loader import DataLoader
    import dataclasses as _dc
    fc = _dc.replace(feat_cfg, normalization="none")
    loader = DataLoader(manifest, data_cfg, fc, drop_last=False)
    s = None
    ss = None
    n = 0.0
    for bi, batch in enumerate(loader.iter_epoch(0)):
        if max_batches is not None and bi >= max_batches:
            break
        feats, flens = extract_features(
            jnp.asarray(batch.samples[:batch.valid]),
            jnp.asarray(batch.sample_lengths[:batch.valid]), fc)
        T = feats.shape[1]
        mask = (jnp.arange(T)[None, :] <
                flens[:, None]).astype(jnp.float32)[..., None]
        fsum = np.asarray(jnp.sum(feats * mask, axis=(0, 1)))
        fsq = np.asarray(jnp.sum(jnp.square(feats) * mask, axis=(0, 1)))
        cnt = float(np.asarray(jnp.sum(mask)))
        s = fsum if s is None else s + fsum
        ss = fsq if ss is None else ss + fsq
        n += cnt
    mean = s / max(n, 1.0)
    var = np.maximum(ss / max(n, 1.0) - mean * mean, 1e-8)
    np.savez(out_path, mean=mean.astype(np.float32),
             var=var.astype(np.float32), frames=n)
    return {"mean": mean, "var": var, "frames": n}


def _jnp_features(samples: jnp.ndarray, cfg: FeatureConfig) -> jnp.ndarray:
    if cfg.feature_type == "mfcc":
        return mfcc(samples, cfg)
    if cfg.feature_type == "mel":
        return log_mel_spectrogram(samples, cfg)
    raise ValueError(f"unknown feature_type {cfg.feature_type!r}")


# ---------------------------------------------------------------------------
# SpecAugment (Park et al. 2019): train-only time/frequency masking on
# the normalized features. Beyond the reference's capability surface
# (it predates SpecAugment) — a WER lever for the "match or beat"
# target; off by default (TrainConfig.specaugment). Fully static-shape
# and vectorized: mask counts/max-widths are config constants, per-
# utterance widths/starts are sampled on-device, and time masks are
# confined to each utterance's valid [0, len) region.
# ---------------------------------------------------------------------------

def _axis_masks(rng, n_masks: int, length: int, max_width, limit,
                pos_start=0):
    """[B, length] bool: union of ``n_masks`` random spans per row.

    max_width/limit: [B] (or scalar-broadcastable) per-row maximum mask
    width and exclusive upper bound for span placement. Width 0 spans
    mask nothing, so rows with limit 0 are no-ops. ``pos_start`` offsets
    the positions compared against the spans (the SP time-shard case).
    """
    import jax
    k1, k2 = jax.random.split(rng)
    B = limit.shape[0]
    u_w = jax.random.uniform(k1, (B, n_masks))
    u_s = jax.random.uniform(k2, (B, n_masks))
    maxw = jnp.minimum(max_width, limit).astype(jnp.float32)[:, None]
    w = jnp.floor(u_w * (maxw + 1.0))                     # [B, n] in [0, maxw]
    lim = limit.astype(jnp.float32)[:, None]
    s = jnp.floor(u_s * jnp.maximum(lim - w + 1.0, 1.0))  # [B, n]
    pos = (jnp.asarray(pos_start, jnp.float32)
           + jnp.arange(length, dtype=jnp.float32))[None, None, :]
    spans = (pos >= s[..., None]) & (pos < (s + w)[..., None])
    return jnp.any(spans, axis=1)                         # [B, length]


def spec_augment(rng, feats: jnp.ndarray, frame_lengths: jnp.ndarray,
                 n_time_masks: int, time_ratio: float,
                 n_freq_masks: int, freq_width: int,
                 t_start: int | jnp.ndarray = 0) -> jnp.ndarray:
    """feats [B, T, F] -> masked copy (zeros inside masked spans).

    Time-mask width is bounded by ``time_ratio * len`` per utterance
    (the adaptive rule); frequency masks use the absolute
    ``freq_width`` bound. Normalized features are ~zero-mean, so zero
    fill matches the mean-fill convention.

    ``t_start``: global frame index of feats[:, 0] — the
    sequence-parallel path passes its time-shard offset so every device
    draws the SAME span parameters (same rng, [B]-level draws) and
    applies its own slice of the GLOBAL mask; devices then tile the
    exact unsharded augmentation (parallel/seqpar.py).
    """
    import jax
    B, T, F = feats.shape
    kt, kf = jax.random.split(rng)
    keep = jnp.ones((B, T, 1), feats.dtype)
    if n_time_masks > 0:
        lens = frame_lengths.astype(jnp.float32)
        tm = _axis_masks(kt, n_time_masks, T,
                         jnp.floor(time_ratio * lens), lens,
                         pos_start=t_start)
        keep = keep * (1.0 - tm.astype(feats.dtype))[..., None]
    feats = feats * keep
    if n_freq_masks > 0:
        full = jnp.full((B,), F, jnp.int32)
        fm = _axis_masks(kf, n_freq_masks, F,
                         jnp.full((B,), freq_width, jnp.float32), full)
        feats = feats * (1.0 - fm.astype(feats.dtype))[:, None, :]
    return feats
