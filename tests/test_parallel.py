"""Distributed-without-a-cluster tests (SURVEY.md §4.3): 8 virtual CPU
devices from conftest's --xla_force_host_platform_device_count."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ctc_asr.config import (Config, DataConfig, FeatureConfig,
                            MeshConfig, ModelConfig, TrainConfig)
from ctc_asr.parallel.dist import (make_distributed_beam_decoder,
                                   make_sharded_eval_step,
                                   make_sharded_train_step)
from ctc_asr.parallel.mesh import (batch_sharding, build_mesh,
                                   param_shardings, state_shardings)
from ctc_asr.train import init_train_state, make_train_step


def _tiny_cfg(shard_model=False, model_axis=1, units=64):
    return Config(
        features=FeatureConfig(feature_type="mfcc", n_mfcc=13, n_mels=26),
        model=ModelConfig(frontend="dense", dense_layers=1,
                          dense_units=units, rnn_layers=1, rnn_units=units,
                          dropout=0.0, compute_dtype="float32"),
        data=DataConfig(batch_size=8),
        train=TrainConfig(learning_rate=1e-3, seed=0),
        mesh=MeshConfig(shard_model=shard_model, model_axis=model_axis),
    )


def _fake_batch(B=8, seconds=0.5, sr=16000, U=8, seed=0):
    rng = np.random.default_rng(seed)
    S = int(seconds * sr)
    samples = rng.standard_normal((B, S)).astype(np.float32) * 0.1
    slens = np.full((B,), S, np.int32)
    labels = rng.integers(0, 28, (B, U)).astype(np.int32)
    llens = np.full((B,), U, np.int32)
    return samples, slens, labels, llens


def test_mesh_shapes():
    assert len(jax.devices()) == 8
    mesh = build_mesh(MeshConfig(model_axis=2))
    assert mesh.devices.shape == (4, 2)
    assert mesh.axis_names == ("data", "model")
    mesh1 = build_mesh(MeshConfig(model_axis=1))
    assert mesh1.devices.shape == (8, 1)
    with pytest.raises(ValueError):
        build_mesh(MeshConfig(model_axis=3))


def test_param_shardings_rules():
    cfg = _tiny_cfg(shard_model=True, units=512)
    mesh = build_mesh(MeshConfig(model_axis=2))
    state = init_train_state(cfg)
    sh = param_shardings(state["params"], mesh, shard_model=True)
    # wide lstm wx sharded on last dim
    assert sh["rnn"][0]["wx"].spec == P(None, "model")
    # head replicated
    assert sh["head"]["w"].spec == P()
    # without shard_model: all replicated
    sh2 = param_shardings(state["params"], mesh, shard_model=False)
    assert sh2["rnn"][0]["wx"].spec == P()


def test_dp_step_matches_single_device():
    """The sharded step over mesh('data'=8) must equal the single-device
    step numerically (same batch, same seed) — the psum gradient math."""
    cfg = _tiny_cfg()
    mesh = build_mesh(MeshConfig(model_axis=1))
    state_a = init_train_state(cfg)
    state_b = jax.tree.map(jnp.copy, state_a)
    batch = _fake_batch()

    single = make_train_step(cfg, donate=False)
    sharded = make_sharded_train_step(cfg, mesh, state_b, donate=False)

    out_a, m_a = single(state_a, *batch)
    out_b, m_b = sharded(state_b, *batch)
    np.testing.assert_allclose(float(m_a["loss"]), float(m_b["loss"]),
                               rtol=1e-5)
    flat_a = jax.tree_util.tree_leaves(out_a["params"])
    flat_b = jax.tree_util.tree_leaves(out_b["params"])
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-5)


def test_tp_step_matches_single_device():
    """data=4 x model=2 with sharded wide matmuls: same numerics."""
    cfg = _tiny_cfg(shard_model=True, model_axis=2, units=512)
    mesh = build_mesh(MeshConfig(model_axis=2))
    state_a = init_train_state(cfg)
    state_b = jax.tree.map(jnp.copy, state_a)
    batch = _fake_batch(B=8, U=4)

    single = make_train_step(cfg, donate=False)
    sharded = make_sharded_train_step(cfg, mesh, state_b, donate=False)
    out_a, m_a = single(state_a, *batch)
    out_b, m_b = sharded(state_b, *batch)
    np.testing.assert_allclose(float(m_a["loss"]), float(m_b["loss"]),
                               rtol=1e-4)


def test_hybrid_tp_step_runs_pallas_ctc_island(monkeypatch):
    """The dp x tp hybrid step must run the Pallas (Triton) CTC kernel
    inside its shard_map island (interpret mode on CPU) while GSPMD
    shards the wide matmuls over 'model' — and match single-device
    numerics on the scan reference."""
    from ctc_asr.ops import ctc_ref, ctc_triton

    cfg = _tiny_cfg(shard_model=True, model_axis=2, units=512)
    mesh = build_mesh(MeshConfig(model_axis=2))
    state_a = init_train_state(cfg)
    state_b = jax.tree.map(jnp.copy, state_a)
    batch = _fake_batch(B=8, U=4)

    # single-device reference on the scan CTC (the golden numerics)
    single = make_train_step(cfg, donate=False)
    calls = []

    def kernel_nll(*args, **kw):
        calls.append(1)
        return ctc_triton.ctc_loss_triton(*args, interpret=True, **kw)

    monkeypatch.setattr(ctc_ref, "ctc_nll", kernel_nll)
    out_a, m_a = single(state_a, *batch)
    sharded = make_sharded_train_step(cfg, mesh, state_b, donate=False)
    out_b, m_b = sharded(state_b, *batch)
    assert calls, "the island did not trace the kernel"
    np.testing.assert_allclose(float(m_a["loss"]), float(m_b["loss"]),
                               rtol=1e-4)
    flat_a = jax.tree_util.tree_leaves(out_a["params"])
    flat_b = jax.tree_util.tree_leaves(out_b["params"])
    for a, b in zip(flat_a, flat_b):
        # atol 1e-4: Pallas-vs-XLA CTC backward differ by f32 logsumexp
        # ordering (~7e-5 worst-case post-Adam at step 1)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=1e-4)


def test_multi_step_training_under_mesh():
    """Loss decreases over sharded steps (end-to-end SPMD sanity)."""
    cfg = _tiny_cfg()
    mesh = build_mesh(MeshConfig(model_axis=1))
    state = init_train_state(cfg)
    step = make_sharded_train_step(cfg, mesh, state, donate=False)
    batch = _fake_batch(U=4, seed=1)
    losses = []
    for _ in range(10):
        state, m = step(state, *batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_sharded_eval_and_decode():
    cfg = _tiny_cfg()
    mesh = build_mesh(MeshConfig(model_axis=1))
    state = init_train_state(cfg)
    samples, slens, _, _ = _fake_batch()
    eval_step = make_sharded_eval_step(cfg, mesh)
    logits, logit_lens = eval_step(state["params"], samples, slens)
    assert logits.shape[0] == 8
    decoder = make_distributed_beam_decoder(cfg, mesh)
    ids, lens = decoder(logits, logit_lens)
    assert np.asarray(ids).shape[0] == 8
    assert (np.asarray(lens) >= 0).all()


def test_loader_shards_align_with_mesh(tmp_path):
    """Per-host loader shards partition the manifest (multi-host data
    path, simulated by instantiating shards explicitly)."""
    from ctc_asr.data import DataLoader, read_manifest
    from ctc_asr.data.synth import generate_corpus
    mp = generate_corpus(str(tmp_path), num_utterances=12, seed=1)
    manifest = read_manifest(mp)
    dc = DataConfig(batch_size=2, num_buckets=2, num_workers=1,
                    min_audio_seconds=0.05)
    fc = FeatureConfig()
    loaders = [DataLoader(manifest, dc, fc, shard_idx=i, num_shards=2)
               for i in range(2)]
    seen = set()
    for ld in loaders:
        for u in ld.shard:
            assert u.path not in seen
            seen.add(u.path)
    assert len(seen) == 12
    # bucket geometry identical across shards (computed pre-shard)
    assert loaders[0].spec == loaders[1].spec
