import numpy as np
import pytest

from ctc_asr import text
from ctc_asr.config import DataConfig, FeatureConfig
from ctc_asr.data import (DataLoader, read_manifest)
from ctc_asr.data.loader import BatchSpec
from ctc_asr.data.synth import generate_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    out = tmp_path_factory.mktemp("corpus")
    manifest_path = generate_corpus(str(out), num_utterances=24, seed=0)
    return read_manifest(manifest_path)


DATA_CFG = DataConfig(batch_size=4, num_buckets=3, num_workers=2,
                      min_audio_seconds=0.1, max_audio_seconds=10.0)
FEAT_CFG = FeatureConfig()


def test_manifest_roundtrip(corpus, tmp_path):
    from ctc_asr.data import write_manifest
    p = str(tmp_path / "m.csv")
    write_manifest(p, corpus)
    m2 = read_manifest(p)
    assert len(m2) == len(corpus)
    assert m2[0].transcript == corpus[0].transcript
    assert abs(m2[0].duration - corpus[0].duration) < 1e-3


def test_shard_partition(corpus):
    parts = [corpus.shard(i, 3) for i in range(3)]
    assert sum(len(p) for p in parts) == len(corpus)
    all_paths = sorted(u.path for p in parts for u in p)
    assert all_paths == sorted(u.path for u in corpus)


def test_batch_spec_static_shapes(corpus):
    spec = BatchSpec.from_manifest(corpus, DATA_CFG, FEAT_CFG)
    assert len(spec.buckets) == 3
    for b in spec.buckets:
        assert b.max_samples % (FEAT_CFG.hop_length * 8) == 0
        assert b.max_label_len % 8 == 0
    # every utterance fits its bucket
    for u in corpus:
        bs = spec.buckets[spec.bucket_of(u.duration)]
        assert u.duration * spec.sample_rate <= bs.max_samples + 1
        assert len(u.transcript) <= bs.max_label_len


def test_epoch_plan_deterministic(corpus):
    l1 = DataLoader(corpus, DATA_CFG, FEAT_CFG)
    l2 = DataLoader(corpus, DATA_CFG, FEAT_CFG)
    assert l1.epoch_plan(1) == l2.epoch_plan(1)
    assert l1.epoch_plan(1) != l1.epoch_plan(2)  # reshuffled per epoch


def test_sortagrad_first_epoch(corpus):
    loader = DataLoader(corpus, DATA_CFG, FEAT_CFG)
    plan = loader.epoch_plan(0)
    # With sortagrad, the stream order is duration-sorted, so within each
    # batch the max duration should be non-decreasing over the plan when
    # restricted to one bucket.
    per_bucket = {}
    for b, idxs, _ in plan:
        dmax = max(loader.shard[i].duration for i in idxs)
        per_bucket.setdefault(b, []).append(dmax)
    for durs in per_bucket.values():
        assert durs == sorted(durs)


def test_batch_contents(corpus):
    loader = DataLoader(corpus, DATA_CFG, FEAT_CFG, drop_last=False)
    batches = list(loader.iter_epoch(0))
    # all utterances covered exactly once (valid counts sum to shard size)
    assert sum(b.valid for b in batches) == len(loader.shard)
    for b in batches:
        bs = loader.spec.buckets[b.bucket_id]
        assert b.samples.shape == (4, bs.max_samples)
        assert b.labels.shape == (4, bs.max_label_len)
        assert b.samples.dtype == np.int16  # wire format (cfg.wire_dtype)
        assert (b.sample_lengths > 0).all()
        for i in range(b.valid):
            dec = text.decode_ids(b.labels[i, :b.label_lengths[i]])
            assert dec == b.transcripts[i]
        # padding is PAD_ID
        i0 = 0
        assert (b.labels[i0, b.label_lengths[i0]:] == text.PAD_ID).all()


def test_prefetch_iterator_and_resume_cursor(corpus):
    loader = DataLoader(corpus, DATA_CFG, FEAT_CFG)
    it = iter(loader)
    seen = [next(it) for _ in range(3)]
    it.close()
    assert [b.position for b in seen] == [0, 1, 2]
    # resume from cursor: a fresh loader at (epoch, position+1) yields the
    # same 4th batch as continuing would
    loader2 = DataLoader(corpus, DATA_CFG, FEAT_CFG)
    loader2.load_state_dict({"epoch": seen[-1].epoch,
                             "position": seen[-1].position + 1, "seed": 0})
    it2 = iter(loader2)
    b4 = next(it2)
    it2.close()
    plan = loader.epoch_plan(seen[-1].epoch)
    if seen[-1].position + 1 < len(plan):
        assert b4.position == seen[-1].position + 1


def test_loader_rejects_empty():
    from ctc_asr.data.manifest import Manifest
    with pytest.raises(ValueError):
        DataLoader(Manifest([]), DATA_CFG, FEAT_CFG)


def test_producer_failure_raises_not_hangs(corpus, tmp_path):
    """A bad wav path must surface as an error in the consumer; the
    pre-fix behavior was a silently dead producer thread and an
    eternal queue.get()."""
    from ctc_asr.data.manifest import Manifest, Utterance
    bad = Manifest([Utterance(str(tmp_path / "missing.wav"), 1.0,
                              "ghost utterance")] * 4)
    loader = DataLoader(bad, DATA_CFG, FEAT_CFG)
    it = iter(loader)
    with pytest.raises(RuntimeError, match="producer failed"):
        next(it)
    it.close()


def test_state_dict_tracks_consumed_not_prefetched(corpus):
    """With prefetch in flight the internal cursor runs ahead;
    state_dict() must resume from the last CONSUMED batch + 1."""
    cfg = DataConfig(batch_size=4, num_buckets=3, num_workers=2,
                     prefetch=2, min_audio_seconds=0.1,
                     max_audio_seconds=10.0)
    loader = DataLoader(corpus, cfg, FEAT_CFG)
    it = iter(loader)
    b = next(it)
    import time
    time.sleep(0.3)  # let the producer run ahead
    st = loader.state_dict()
    it.close()
    assert st["epoch"] == b.epoch
    assert st["position"] == b.position + 1


def test_load_state_dict_rejects_seed_mismatch(corpus):
    loader = DataLoader(corpus, DATA_CFG, FEAT_CFG)
    with pytest.raises(ValueError, match="seed"):
        loader.load_state_dict({"epoch": 0, "position": 1, "seed": 999})


def test_wire16_roundtrip_exact():
    """int16 wire transport must be EXACT for int16-PCM sources:
    v -> v/32768 (read_wav) -> float_to_wire16 -> /32768 == v/32768."""
    from ctc_asr import audio as audio_mod
    v = np.array([-32768, -12345, -1, 0, 1, 31999, 32767], np.int16)
    f = v.astype(np.float32) / 32768.0
    wire = audio_mod.float_to_wire16(f)
    np.testing.assert_array_equal(wire, v)
    back = wire.astype(np.float32) / audio_mod.WIRE_SCALE
    np.testing.assert_array_equal(back, f)


def test_loader_float32_wire_flag(corpus):
    import dataclasses as dc
    cfg = dc.replace(DATA_CFG, wire_dtype="float32")
    loader = DataLoader(corpus, cfg, FEAT_CFG, drop_last=False)
    b = next(iter(loader.iter_epoch(0)))
    assert b.samples.dtype == np.float32


def test_features_accept_wire16(corpus):
    """extract_features on int16 wire samples must match the f32 path."""
    import jax.numpy as jnp
    from ctc_asr import audio as audio_mod
    from ctc_asr import features as feat_mod
    rng = np.random.default_rng(0)
    f32 = (rng.standard_normal((2, 8000)) * 0.1).astype(np.float32)
    f32 = np.clip(f32, -1, 1)
    # quantize the reference input too: parity should be exact
    f32 = audio_mod.float_to_wire16(f32).astype(np.float32) / 32768.0
    wire = audio_mod.float_to_wire16(f32)
    lens = np.array([8000, 5000], np.int32)
    a, la = feat_mod.extract_features(jnp.asarray(f32), jnp.asarray(lens),
                                      FEAT_CFG)
    b, lb = feat_mod.extract_features(jnp.asarray(wire), jnp.asarray(lens),
                                      FEAT_CFG)
    np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-5, atol=1e-5)


def test_ulaw_wire_roundtrip_and_features(corpus):
    """uint8 mu-law wire: round trip within companded quantization
    error, and the on-device decode in extract_features matches the
    host-side inverse exactly."""
    import jax.numpy as jnp
    from ctc_asr import audio as audio_mod
    from ctc_asr import features as feat_mod
    rng = np.random.default_rng(1)
    x = np.clip(rng.standard_normal((2, 8000)) * 0.3, -1, 1) \
        .astype(np.float32)
    wire = audio_mod.float_to_ulaw(x)
    back = audio_mod.ulaw_to_float(wire)
    # companded quantization: fine near zero, <=2.3% of full scale at 1
    err = np.abs(back - x)
    assert err.max() <= 0.023
    assert np.abs(back[np.abs(x) < 0.05] - x[np.abs(x) < 0.05]).max() \
        <= 2e-3
    lens = np.array([8000, 5000], np.int32)
    a, _ = feat_mod.extract_features(jnp.asarray(back), jnp.asarray(lens),
                                     FEAT_CFG)
    b, _ = feat_mod.extract_features(jnp.asarray(wire), jnp.asarray(lens),
                                     FEAT_CFG)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-4, atol=1e-4)


def test_loader_ulaw_wire_flag(corpus):
    import dataclasses as dc
    cfg = dc.replace(DATA_CFG, wire_dtype="ulaw")
    loader = DataLoader(corpus, cfg, FEAT_CFG, drop_last=False)
    b = next(iter(loader.iter_epoch(0)))
    assert b.samples.dtype == np.uint8


def test_state_dict_before_first_consume(corpus):
    """A checkpoint taken after iter() but before the first next() must
    record the cursor at iterator start, not the producer's prefetch-
    advanced internal position."""
    import time
    cfg = DataConfig(batch_size=4, num_buckets=3, num_workers=2,
                     prefetch=2, min_audio_seconds=0.1,
                     max_audio_seconds=10.0)
    loader = DataLoader(corpus, cfg, FEAT_CFG)
    it = iter(loader)
    time.sleep(0.3)  # let the producer run ahead
    st = loader.state_dict()
    it.close()
    assert (st["epoch"], st["position"]) == (0, 0)


def test_load_state_dict_resets_stale_cursor(corpus):
    loader = DataLoader(corpus, DATA_CFG, FEAT_CFG)
    it = iter(loader)
    next(it)
    it.close()
    loader.load_state_dict({"epoch": 0, "position": 2,
                            "seed": DATA_CFG.seed})
    st = loader.state_dict()
    assert (st["epoch"], st["position"]) == (0, 2)


def test_producer_failure_raises_every_call(corpus, tmp_path):
    """After the producer dies, EVERY subsequent next() must fail fast
    (not just the first)."""
    from ctc_asr.data.manifest import Manifest, Utterance
    bad = Manifest([Utterance(str(tmp_path / "missing.wav"), 1.0,
                              "ghost utterance")] * 4)
    loader = DataLoader(bad, DATA_CFG, FEAT_CFG)
    it = iter(loader)
    for _ in range(3):
        with pytest.raises(RuntimeError, match="producer failed"):
            next(it)
    it.close()


def test_wire_dtype_validated(corpus):
    import dataclasses as dc
    with pytest.raises(ValueError, match="wire_dtype"):
        DataLoader(corpus, dc.replace(DATA_CFG, wire_dtype="in16"),
                   FEAT_CFG)


def test_device_batches_repins_consumed(corpus):
    """train.device_batches pulls one batch ahead; with loader= it must
    re-pin loader.consumed to the batch actually yielded so
    state_dict() stays an exact resume point."""
    from ctc_asr.train import device_batches
    loader = DataLoader(corpus, DATA_CFG, FEAT_CFG)
    it = iter(loader)
    dev_it = device_batches(it, loader=loader)
    b0, _ = next(dev_it)
    st = loader.state_dict()
    assert (st["epoch"], st["position"]) == (b0.epoch, b0.position + 1)
    b1, _ = next(dev_it)
    st = loader.state_dict()
    assert (st["epoch"], st["position"]) == (b1.epoch, b1.position + 1)
    it.close()
