"""Integration: end-to-end training on the synthetic corpus (SURVEY.md
§4.2): loss decreases, decode improves, checkpoint save->restore->bitwise
match, transcribe round-trips a wav."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ctc_asr import checkpoint as ckpt_mod
from ctc_asr.config import (MeshConfig, Config, DataConfig, DecodeConfig,
                            FeatureConfig, ModelConfig, TrainConfig)
from ctc_asr.data import DataLoader, read_manifest
from ctc_asr.data.synth import generate_corpus
from ctc_asr.evaluate import evaluate
from ctc_asr.train import (init_train_state, make_train_step, train)
from ctc_asr.transcribe import Transcriber


@pytest.fixture(scope="module")
def tiny_setup(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_corpus")
    manifest_path = generate_corpus(str(out), num_utterances=16, seed=3,
                                    min_words=1, max_words=2)
    cfg = Config(
        features=FeatureConfig(feature_type="mfcc", n_mfcc=13, n_mels=26),
        model=ModelConfig(frontend="dense", dense_layers=1, dense_units=64,
                          rnn_layers=1, rnn_units=64, dropout=0.0,
                          compute_dtype="float32"),
        data=DataConfig(train_manifest=manifest_path,
                        eval_manifest=manifest_path,
                        batch_size=4, num_buckets=1, num_workers=2,
                        min_audio_seconds=0.05, max_audio_seconds=10.0),
        train=TrainConfig(learning_rate=3e-3, total_steps=60,
                          log_every=20, eval_every=1000,
                          checkpoint_every=1000, grad_clip_norm=5.0,
                          train_dir=str(tmp_path_factory.mktemp("trdir"))),
        decode=DecodeConfig(method="greedy"),
        mesh=MeshConfig(data_axis=1),
    )
    return cfg, manifest_path


def test_loss_decreases_and_decode_improves(tiny_setup):
    cfg, manifest_path = tiny_setup
    manifest = read_manifest(manifest_path)
    loader = DataLoader(manifest, cfg.data, cfg.features)
    state = init_train_state(cfg)
    step_fn = make_train_step(cfg, donate=False)
    losses = []
    it = iter(loader)
    for i in range(120):
        b = next(it)
        state, m = step_fn(state, b.samples, b.sample_lengths,
                           b.labels, b.label_lengths)
        losses.append(float(m["loss"]))
    it.close()
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    assert np.isfinite(losses).all()
    assert last < 0.6 * first, (first, last)

    # decode: WER must be < 100% after this much overfitting on 16 utts
    eval_loader = DataLoader(manifest, cfg.data, cfg.features,
                             drop_last=False)
    res = evaluate(cfg, state["params"], loader=eval_loader, log_samples=0)
    assert res["utterances"] == 16
    assert res["wer"] < 1.0, res
    assert res["rtf"] > 0

    # transcribe round-trip: returns a string, hopefully close to ref
    tr = Transcriber(cfg, state["params"])
    hyp = tr.transcribe_file(manifest[0].path)
    assert isinstance(hyp, str)

    # stash for checkpoint test via module attr
    test_loss_decreases_and_decode_improves.state = state


def test_checkpoint_roundtrip(tiny_setup, tmp_path):
    cfg, _ = tiny_setup
    state = init_train_state(cfg)
    d = str(tmp_path / "ckpt")
    ckpt_mod.save_checkpoint(d, 7, state, metadata={"loader": {
        "epoch": 1, "position": 2, "seed": 0}}, keep=2)
    restored, meta = ckpt_mod.restore_latest(d, state)
    assert meta["step"] == 7
    assert meta["loader"]["position"] == 2
    for (ka, a), (kb, b) in zip(
            jax.tree_util.tree_flatten_with_path(state)[0],
            jax.tree_util.tree_flatten_with_path(restored)[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(ka))


def test_checkpoint_retention_and_best(tiny_setup, tmp_path):
    cfg, _ = tiny_setup
    state = init_train_state(cfg)
    d = str(tmp_path / "ckpt2")
    for s in (1, 2, 3, 4):
        ckpt_mod.save_checkpoint(d, s, state, keep=2, is_best=(s == 2))
    import glob, os
    steps = sorted(glob.glob(os.path.join(d, "step_*.npz")))
    assert len(steps) == 2
    assert steps[-1].endswith("step_00000004.npz")
    assert os.path.exists(os.path.join(d, "best.npz"))
    restored, meta = ckpt_mod.load_checkpoint(os.path.join(d, "best.npz"),
                                              state)
    assert meta["step"] == 2


def test_train_loop_with_resume(tiny_setup, tmp_path_factory):
    """The train() loop runs, checkpoints, and resumes exactly."""
    cfg, manifest_path = tiny_setup
    tdir = str(tmp_path_factory.mktemp("loop_dir"))
    cfg2 = Config(features=cfg.features, model=cfg.model,
                  data=cfg.data,
                  train=TrainConfig(learning_rate=1e-3, total_steps=6,
                                    log_every=3, eval_every=1000,
                                    checkpoint_every=3, train_dir=tdir),
                  decode=cfg.decode, mesh=cfg.mesh)
    state = train(cfg2, max_steps=6)
    assert int(state["step"]) == 6
    # resume: raising total_steps continues from 6 (checkpoint at 6)
    state2 = train(cfg2, max_steps=8)
    assert int(state2["step"]) == 8


def test_train_single_process_spans_local_devices(tiny_setup,
                                                 tmp_path_factory):
    """One process on a multi-device host trains data-parallel over
    ``mesh.data_axis`` local devices (-1 = all) instead of silently
    using device 0 alone, and refuses a batch that does not split."""
    import dataclasses as dc
    cfg, _ = tiny_setup
    tdir = str(tmp_path_factory.mktemp("dp_dir"))
    cfg4 = dc.replace(cfg, mesh=MeshConfig(data_axis=4),
                      train=dc.replace(cfg.train, train_dir=tdir,
                                       log_every=0, checkpoint_every=0))
    state = train(cfg4, max_steps=2)
    assert int(state["step"]) == 2
    leaf = jax.tree_util.tree_leaves(state["params"])[0]
    assert len(leaf.sharding.device_set) == 4
    cfg_all = dc.replace(cfg4, mesh=MeshConfig(data_axis=-1))
    with pytest.raises(ValueError, match="does not split"):
        train(cfg_all, max_steps=1)


def test_evaluate_max_batches_caps_work(tiny_setup):
    """max_batches must bound exactly how many batches are decoded
    (the device prefetch slices BEFORE pulling ahead)."""
    cfg, manifest_path = tiny_setup
    state = init_train_state(cfg)
    loader = DataLoader(read_manifest(manifest_path), cfg.data,
                        cfg.features, drop_last=False)
    out = evaluate(cfg, state["params"], loader=loader, max_batches=2,
                   log_samples=0)
    assert out["utterances"] == 2 * cfg.data.batch_size


def test_seq_axis_with_multiprocess_is_loud(tiny_setup, monkeypatch):
    """mesh.seq_axis > 1 + process_count > 1 is an unbuilt regime
    combination; train() must refuse loudly instead of silently
    training pure-DP with seq_axis ignored."""
    import dataclasses as dc
    from ctc_asr.config import MeshConfig
    cfg, _ = tiny_setup
    cfg2 = dc.replace(cfg, mesh=MeshConfig(seq_axis=2))
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="seq_axis.*multi-process"):
        train(cfg2, max_steps=1)


def test_train_loop_nan_traps(tiny_setup, tmp_path_factory):
    """The sync-point host scalar fetch doubles as a NaN trap: NaN
    state must abort the loop with FloatingPointError, not silently
    keep training (SURVEY.md §5 race-detection row). The canary is
    grad_norm — the log-space CTC masking maps NaN logits to a FINITE
    loss, but NaN params always poison the backward pass."""
    import dataclasses as dc
    cfg, _ = tiny_setup
    tdir = str(tmp_path_factory.mktemp("nan_dir"))
    cfg2 = dc.replace(cfg, train=dc.replace(
        cfg.train, total_steps=4, sync_every=1, log_every=0,
        checkpoint_every=0, train_dir=tdir))
    # NaN-poisoned checkpoint: train() resumes from it and the first
    # sync-point fetch must trip (deterministic, unlike waiting for a
    # high-LR divergence to produce NaN rather than saturate)
    state = init_train_state(cfg2)
    state["params"] = jax.tree.map(
        lambda x: jnp.full_like(x, jnp.nan), state["params"])
    ckpt_mod.save_checkpoint(tdir + "/ckpt", 0, state)
    with pytest.raises(FloatingPointError, match="NaN"):
        train(cfg2, max_steps=4)
