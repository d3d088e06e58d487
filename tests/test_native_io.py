"""Native C++ wav decoder vs the scipy reference path."""

import numpy as np
import pytest

from ctc_asr import audio as audio_mod
from ctc_asr.data import native_io


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    paths, signals = [], []
    for i, n in enumerate([1600, 8000, 400]):
        sig = (rng.standard_normal(n) * 0.3).astype(np.float32)
        p = str(d / f"w{i}.wav")
        audio_mod.write_wav(p, sig, 16000)
        paths.append(p)
        signals.append(sig)
    return paths, signals


def test_native_builds():
    assert native_io.available(), "native io failed to build"


def test_decode_batch_matches_scipy(wavs):
    paths, signals = wavs
    S = 8192
    out, lens, rates = native_io.decode_batch(paths, S)
    assert out.shape == (3, S)
    for i, (p, sig) in enumerate(zip(paths, signals)):
        ref, sr = audio_mod.read_wav(p, 16000)
        n = min(len(ref), S)
        assert lens[i] == n
        assert rates[i] == 16000
        np.testing.assert_allclose(out[i, :n], ref[:n], atol=1e-6)
        assert np.allclose(out[i, n:], 0.0)


def test_decode_truncates(wavs):
    paths, _ = wavs
    out, lens, _ = native_io.decode_batch(paths, 1000)
    assert lens[1] == 1000  # 8000-sample file capped
    assert out.shape[1] == 1000


def test_decode_failure_reported(tmp_path, wavs):
    bad = str(tmp_path / "nope.wav")
    with open(bad, "wb") as f:
        f.write(b"not a wav file at all")
    paths = [wavs[0][0], bad]
    out, lens, rates = native_io.decode_batch(paths, 2048)
    assert lens[0] > 0
    assert lens[1] == 0 and rates[1] == 0


def test_wav_info(wavs):
    paths, signals = wavs
    info = native_io.wav_info(paths[1])
    assert info == (8000, 16000)


def test_loader_uses_native(tmp_path):
    """End-to-end: loader batches decoded natively match transcripts."""
    from ctc_asr.config import DataConfig, FeatureConfig
    from ctc_asr.data import DataLoader, read_manifest
    from ctc_asr.data.synth import generate_corpus
    mp = generate_corpus(str(tmp_path), num_utterances=8, seed=5)
    loader = DataLoader(read_manifest(mp),
                        DataConfig(batch_size=4, num_buckets=1,
                                   num_workers=2, min_audio_seconds=0.05),
                        FeatureConfig(), drop_last=False)
    batches = list(loader.iter_epoch(0))
    assert sum(b.valid for b in batches) == 8
    for b in batches:
        assert (b.sample_lengths > 0).all()
        # native decode must match the scipy path bit-for-bit here
        # (batch samples are int16 wire — undo the wire scale)
        ref, _ = audio_mod.read_wav(b.paths[0], 16000)
        n = min(len(ref), b.samples.shape[1])
        got = b.samples[0, :n].astype(np.float32) / audio_mod.WIRE_SCALE
        np.testing.assert_allclose(got, ref[:n], atol=1e-6)
