"""First-party native FLAC decoder (native/flac_decode.cc) round-trip
tests against the pure-Python test encoder (tests/flac_writer.py).

LibriSpeech ships as 16-bit 16 kHz FLAC and this environment has no
ffmpeg/sox (SURVEY.md §2a dataset-generators row, §3.4; VERDICT r2 next
#6): the manifest pipeline must consume .flac with zero external tools.
Coverage matrix: every subframe type the subset uses (CONSTANT /
VERBATIM / FIXED 0-2 / LPC), Rice residuals incl. the escape/raw
partition form, mono + independent-stereo + mid/side decorrelation,
wasted bits, multi-frame streams, and the prepare-librispeech ->
DataLoader integration path.
"""

import os

import numpy as np
import pytest

from ctc_asr.data import native_io

from flac_writer import write_flac


needs_native = pytest.mark.skipif(not native_io.available(),
                                  reason="native io unavailable")


def _mono(n, seed=0, smooth=True):
    rng = np.random.default_rng(seed)
    if smooth:  # LPC/fixed predictors like correlated signals
        t = np.arange(n)
        x = (8000 * np.sin(t / 23.0) + 3000 * np.sin(t / 7.1)
             + rng.integers(-200, 200, n))
    else:
        x = rng.integers(-30000, 30000, n)
    return np.clip(x, -32768, 32767).astype(np.int16)


def _decode(path, max_samples=1 << 20):
    out, lens, rates = native_io.decode_batch([path], max_samples)
    return out[0, :lens[0]], int(lens[0]), int(rates[0])


@needs_native
@pytest.mark.parametrize("mode", ["verbatim", "fixed0", "fixed1",
                                  "fixed2", "lpc2", "fixed1_escape"])
def test_mono_roundtrip_modes(tmp_path, mode):
    x = _mono(1000, seed=1, smooth=(mode != "verbatim"))
    p = str(tmp_path / f"{mode}.flac")
    write_flac(p, x, blocksize=256, mode=mode)
    got, n, rate = _decode(p)
    assert n == len(x) and rate == 16000
    np.testing.assert_allclose(got, x.astype(np.float32) / 32768.0,
                               atol=1e-6)


@needs_native
def test_constant_subframe(tmp_path):
    x = np.full(512, -1234, np.int16)
    p = str(tmp_path / "const.flac")
    write_flac(p, x, blocksize=256, mode="constant")
    got, n, _ = _decode(p)
    assert n == 512
    np.testing.assert_allclose(got, x.astype(np.float32) / 32768.0,
                               atol=1e-6)


@needs_native
def test_partial_final_frame(tmp_path):
    x = _mono(300, seed=2)  # 256 + 44: last frame is short
    p = str(tmp_path / "partial.flac")
    write_flac(p, x, blocksize=256, mode="fixed2")
    got, n, _ = _decode(p)
    assert n == 300
    np.testing.assert_allclose(got, x.astype(np.float32) / 32768.0,
                               atol=1e-6)


@needs_native
@pytest.mark.parametrize("stereo_mode", ["independent", "mid_side"])
def test_stereo_downmix(tmp_path, stereo_mode):
    left = _mono(700, seed=3)
    right = _mono(700, seed=4)
    x = np.stack([left, right], axis=1)
    p = str(tmp_path / f"stereo_{stereo_mode}.flac")
    write_flac(p, x, blocksize=256, mode="fixed2",
               stereo_mode=stereo_mode)
    got, n, _ = _decode(p)
    assert n == 700
    want = (left.astype(np.float32) + right.astype(np.float32)) \
        / 2.0 / 32768.0
    np.testing.assert_allclose(got, want, atol=1e-4)


@needs_native
def test_wasted_bits(tmp_path):
    x = (_mono(500, seed=5) & ~0x3).astype(np.int16)  # 2 low zero bits
    p = str(tmp_path / "wasted.flac")
    write_flac(p, x, blocksize=256, mode="verbatim", wasted=2)
    got, n, _ = _decode(p)
    assert n == 500
    np.testing.assert_allclose(got, x.astype(np.float32) / 32768.0,
                               atol=1e-6)


@needs_native
def test_max_samples_cap(tmp_path):
    x = _mono(1024, seed=6)
    p = str(tmp_path / "cap.flac")
    write_flac(p, x, blocksize=256, mode="fixed1")
    got, n, _ = _decode(p, max_samples=400)
    assert n == 400
    np.testing.assert_allclose(got, x[:400].astype(np.float32) / 32768.0,
                               atol=1e-6)


@needs_native
def test_corrupt_flac_reported(tmp_path):
    p = str(tmp_path / "bad.flac")
    with open(p, "wb") as f:
        f.write(b"fLaC" + b"\x12" * 40)
    out, lens, rates = native_io.decode_batch([p], 1024)
    assert lens[0] == 0 and rates[0] == 0


@needs_native
def test_audio_info_on_flac(tmp_path):
    x = _mono(777, seed=7)
    p = str(tmp_path / "info.flac")
    write_flac(p, x, blocksize=256, mode="fixed2")
    n, sr = native_io.wav_info(p)
    assert n == 777 and sr == 16000


@needs_native
def test_audio_info_uses_streaminfo_not_decode(tmp_path):
    """ADVICE r3: the info probe answers from the STREAMINFO header in
    O(1). Proof: truncate the stream after STREAMINFO (no frames at
    all) — a decoding probe would fail, the header probe still answers."""
    x = _mono(512, seed=8)
    p = str(tmp_path / "hdr_only.flac")
    write_flac(p, x, blocksize=256, mode="fixed2")
    with open(p, "rb") as f:
        head = f.read(42)   # fLaC + block header + 34-byte STREAMINFO
    p2 = str(tmp_path / "truncated.flac")
    with open(p2, "wb") as f:
        f.write(head)
    n, sr = native_io.wav_info(p2)
    assert n == 512 and sr == 16000


@needs_native
def test_crc_mismatch_rejected(tmp_path):
    """ADVICE r3: frame CRCs are verified, not parsed-over. Corrupting
    the stored CRC-16 (stream otherwise fully valid) must fail the
    decode; same for the header CRC-8."""
    x = _mono(256, seed=11)
    p = str(tmp_path / "good.flac")
    write_flac(p, x, blocksize=256, mode="fixed2")
    data = bytearray(open(p, "rb").read())
    # the single frame's CRC-16 is the last two bytes of the stream
    bad16 = str(tmp_path / "bad16.flac")
    d16 = bytearray(data)
    d16[-1] ^= 0xFF
    open(bad16, "wb").write(bytes(d16))
    _, lens, _ = native_io.decode_batch([bad16], 1024)
    assert lens[0] == 0
    # frame starts right after 4 magic + 4 block header + 34 STREAMINFO
    # = offset 42; header = sync/flags 2 + codes 2 + UTF8 1 + 16-bit
    # blocksize 2 = bytes [42..49), stored CRC-8 at offset 49
    bad8 = bytearray(data)
    bad8[49] ^= 0x55
    p8 = str(tmp_path / "bad8.flac")
    open(p8, "wb").write(bytes(bad8))
    _, lens, _ = native_io.decode_batch([p8], 1024)
    assert lens[0] == 0
    # sanity: the untouched file still round-trips under verification
    got, n, _ = _decode(p)
    assert n == 256


@needs_native
def test_loader_resamples_rate_mismatched_flac(tmp_path):
    """ADVICE r3: a FLAC at the wrong sample rate that the native path
    decoded fine must be RESAMPLED from those samples — the old redo
    path re-read the file with the scipy wav parser, which cannot
    parse FLAC."""
    from ctc_asr.config import DataConfig, FeatureConfig
    from ctc_asr.data import DataLoader, read_manifest
    from ctc_asr.data.manifest import write_manifest, Manifest, Utterance

    sr_src = 32000
    x = _mono(sr_src, seed=13)           # 1 s at 32 kHz
    p = str(tmp_path / "u0.flac")
    write_flac(p, x, sample_rate=sr_src, blocksize=4096, mode="fixed2")
    man_path = str(tmp_path / "m.csv")
    write_manifest(man_path, Manifest([Utterance(p, 1.0, "one second")]))

    dcfg = DataConfig(batch_size=1, num_buckets=1,
                      min_audio_seconds=0.1, max_audio_seconds=5.0,
                      num_workers=1)
    loader = DataLoader(read_manifest(man_path), dcfg,
                        FeatureConfig(), drop_last=False)
    batch = next(iter(loader.iter_epoch(0)))
    # resampled to the target 16 kHz: ~16000 samples, non-silent
    assert abs(int(batch.sample_lengths[0]) - 16000) <= 16
    assert np.abs(batch.samples.astype(np.float32)).max() > 1.0


@needs_native
def test_loader_corrupt_flac_clear_error(tmp_path):
    """A FLAC the native decoder rejects must fail with a message that
    names the file and the missing-fallback cause, not a wav-parse
    traceback (ADVICE r3)."""
    from ctc_asr.config import DataConfig, FeatureConfig
    from ctc_asr.data import DataLoader, read_manifest
    from ctc_asr.data.manifest import write_manifest, Manifest, Utterance

    p = str(tmp_path / "corrupt.flac")
    with open(p, "wb") as f:
        f.write(b"fLaC" + b"\x00" * 60)
    man_path = str(tmp_path / "m.csv")
    write_manifest(man_path, Manifest([Utterance(p, 1.0, "bad file")]))
    dcfg = DataConfig(batch_size=1, num_buckets=1,
                      min_audio_seconds=0.1, max_audio_seconds=5.0,
                      num_workers=1)
    loader = DataLoader(read_manifest(man_path), dcfg,
                        FeatureConfig(), drop_last=False)
    with pytest.raises(RuntimeError, match="FLAC"):
        next(iter(loader.iter_epoch(0)))


@needs_native
def test_librispeech_flac_pipeline(tmp_path):
    """SURVEY §3.4 end-to-end: a LibriSpeech-shaped tree of .flac files
    -> prepare_librispeech -> manifest -> DataLoader batch, with no
    ffmpeg/sox anywhere (VERDICT r2 'Done =' criterion)."""
    from ctc_asr.data.generate import prepare_librispeech
    from ctc_asr.data import DataLoader, read_manifest
    from ctc_asr.config import DataConfig, FeatureConfig

    root = tmp_path / "LibriSpeech" / "dev-clean"
    utts = {"1272-128104-0000": "HELLO WORLD",
            "1272-128104-0001": "THE QUICK BROWN FOX"}
    d = root / "1272" / "128104"
    os.makedirs(d)
    with open(d / "1272-128104.trans.txt", "w") as f:
        for uid, text in utts.items():
            f.write(f"{uid} {text}\n")
            n = 16000 + 4096 * (uid.endswith("1"))
            write_flac(str(d / f"{uid}.flac"), _mono(n, seed=hash(uid) % 97),
                       blocksize=4096, mode="fixed2")

    out = tmp_path / "prepared"
    man_paths = prepare_librispeech(str(tmp_path / "LibriSpeech"),
                                    str(out), subsets=["dev-clean"])
    man = read_manifest(man_paths[0])
    assert len(man) == 2
    assert {u.transcript for u in man} == {"hello world",
                                           "the quick brown fox"}

    dcfg = DataConfig(batch_size=2, num_buckets=1,
                      min_audio_seconds=0.1, max_audio_seconds=5.0)
    loader = DataLoader(man, dcfg, FeatureConfig(),
                        drop_last=False)
    batch = next(iter(loader.iter_epoch(0)))
    assert batch.samples.shape[0] == 2
    assert batch.sample_lengths.min() > 0
    # decoded audio is finite, non-silent
    assert np.isfinite(batch.samples).all()
    assert np.abs(batch.samples.astype(np.float32)).max() > 1.0


@needs_native
def test_librispeech_direct_flac_manifest(tmp_path):
    """prepare-librispeech --no-convert: the manifest points at the
    original .flac files (no wav copies); the loader's native batch
    decoder reads them transparently."""
    from ctc_asr.data.generate import prepare_librispeech
    from ctc_asr.data import DataLoader, read_manifest
    from ctc_asr.config import DataConfig, FeatureConfig

    root = tmp_path / "LibriSpeech" / "test-clean"
    d = root / "7-8"
    os.makedirs(d)
    with open(d / "7-8.trans.txt", "w") as f:
        f.write("7-8-0000 DIRECT FLAC ROWS\n")
    write_flac(str(d / "7-8-0000.flac"), _mono(24000, seed=9),
               blocksize=4096, mode="lpc2")

    man_paths = prepare_librispeech(str(tmp_path / "LibriSpeech"),
                                    str(tmp_path / "out"),
                                    subsets=["test-clean"], convert=False)
    man = read_manifest(man_paths[0])
    assert len(man) == 1
    assert man[0].path.endswith(".flac")
    assert abs(man[0].duration - 1.5) < 1e-3  # 24000 samples @ 16 kHz
    # no wav copies were written
    assert not os.path.exists(tmp_path / "out" / "test-clean" / "wav")

    dcfg = DataConfig(batch_size=1, num_buckets=1,
                      min_audio_seconds=0.1, max_audio_seconds=5.0)
    loader = DataLoader(man, dcfg, FeatureConfig(),
                        drop_last=False)
    batch = next(iter(loader.iter_epoch(0)))
    assert batch.sample_lengths[0] == 24000
    assert np.abs(batch.samples.astype(np.float32)).max() > 1.0
