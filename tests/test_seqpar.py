"""Sequence-parallel (time-axis sharding) parity tests — SURVEY.md §5
"long-context / SP" optional capability, built in parallel/seqpar.py.

Exactness is the whole contract here: the sharded frontend must equal
the unsharded pipeline bit-for-near-bit (same math, different device
layout + halo exchange + psum moments), and the wavefront BiLSTM must
equal models/rnn.birnn_apply. Runs on the virtual 8-device CPU mesh
(conftest)."""

import dataclasses as dc

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ctc_asr.config import FeatureConfig
from ctc_asr import features as feat_mod
from ctc_asr.models.rnn import birnn_apply, lstm_init
from ctc_asr.parallel import seqpar


def _seq_mesh(n):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} devices")
    return Mesh(np.array(devs[:n]), ("seq",))


@pytest.mark.parametrize("norm", ["utterance", "none", "global"])
def test_sp_features_match_unsharded(norm):
    n = 4
    mesh = _seq_mesh(n)
    cfg = FeatureConfig(normalization=norm)
    hop, win = cfg.hop_length, cfg.win_length
    S = n * 10 * hop                      # chunk = 10 hops per device
    B = 3
    rng = np.random.default_rng(0)
    samples = jnp.asarray(rng.standard_normal((B, S)).astype(np.float32)
                          * 0.2)
    slens = jnp.asarray([S, S - 3 * hop - 17, 2 * win], jnp.int32)

    ref_feats, ref_flens = feat_mod.extract_features(samples, slens, cfg)
    sp_fn = seqpar.make_sp_feature_fn(cfg, mesh)
    sp_feats, sp_flens = sp_fn(samples, slens)
    sp_feats, sp_flens = np.asarray(sp_feats), np.asarray(sp_flens)

    np.testing.assert_array_equal(sp_flens, np.asarray(ref_flens))
    T_ref = ref_feats.shape[1]
    assert sp_feats.shape[1] >= T_ref     # S/hop >= 1+(S-win)/hop
    np.testing.assert_allclose(sp_feats[:, :T_ref], np.asarray(ref_feats),
                               rtol=2e-5, atol=2e-5)
    # frames past every row's frame length are exactly zero
    for b in range(B):
        assert np.all(sp_feats[b, sp_flens[b]:] == 0.0)


def test_sp_features_int16_wire():
    n = 2
    mesh = _seq_mesh(n)
    cfg = FeatureConfig()
    S = n * 8 * cfg.hop_length
    rng = np.random.default_rng(1)
    wire = jnp.asarray(
        (rng.standard_normal((2, S)) * 3000).astype(np.int16))
    slens = jnp.asarray([S, S // 2], jnp.int32)
    ref_feats, _ = feat_mod.extract_features(wire, slens, cfg)
    sp_feats, _ = seqpar.make_sp_feature_fn(cfg, mesh)(wire, slens)
    T_ref = ref_feats.shape[1]
    np.testing.assert_allclose(np.asarray(sp_feats)[:, :T_ref],
                               np.asarray(ref_feats), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("n,lens", [
    (4, [24, 17, 5]),
    (8, [24, 24, 1]),
])
def test_sp_bilstm_matches_birnn(n, lens):
    mesh = _seq_mesh(n)
    T, B, F, H = 24, 3, 5, 8
    params = {"fwd": lstm_init(jax.random.PRNGKey(0), F, H),
              "bwd": lstm_init(jax.random.PRNGKey(1), F, H)}
    x = jax.random.normal(jax.random.PRNGKey(2), (T, B, F))
    lengths = jnp.asarray(lens, jnp.int32)

    want = np.asarray(birnn_apply(params, x, lengths, "lstm",
                                  jnp.float32))
    sp_fn = seqpar.make_sp_birnn_fn(params, mesh)
    got = np.asarray(sp_fn(x, lengths))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sp_bilstm_output_sharded():
    """The output really is laid out over the 'seq' axis (memory-
    scaling is the point of SP: each device holds [T/n, ...])."""
    n = 4
    mesh = _seq_mesh(n)
    T, B, F, H = 16, 2, 4, 8
    params = {"fwd": lstm_init(jax.random.PRNGKey(0), F, H),
              "bwd": lstm_init(jax.random.PRNGKey(1), F, H)}
    x = jax.random.normal(jax.random.PRNGKey(3), (T, B, F))
    out = seqpar.make_sp_birnn_fn(params, mesh)(
        x, jnp.full((B,), T, jnp.int32))
    shard_shapes = {s.data.shape for s in out.addressable_shards}
    assert shard_shapes == {(T // n, B, 2 * H)}


@pytest.mark.parametrize("cell", ["gru", "rnn"])
def test_sp_birnn_other_cells(cell):
    """rnn_type parity for the SP path: GRU and plain-tanh cells match
    models/rnn.birnn_apply exactly through the wavefront."""
    from ctc_asr.models.rnn import gru_init, vanilla_init
    n = 4
    mesh = _seq_mesh(n)
    T, B, F, H = 16, 2, 5, 8
    init = gru_init if cell == "gru" else vanilla_init
    params = {"fwd": init(jax.random.PRNGKey(0), F, H),
              "bwd": init(jax.random.PRNGKey(1), F, H)}
    x = jax.random.normal(jax.random.PRNGKey(2), (T, B, F))
    lengths = jnp.asarray([16, 9], jnp.int32)
    want = np.asarray(birnn_apply(params, x, lengths, cell, jnp.float32))
    got = np.asarray(
        seqpar.make_sp_birnn_fn(params, mesh, cell=cell)(x, lengths))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _sp_train_cfg(manifest="", bidirectional=True, seq_axis=1):
    from ctc_asr.config import (Config, DataConfig, FeatureConfig,
                                MeshConfig, ModelConfig, TrainConfig)
    return Config(
        features=FeatureConfig(feature_type="mfcc", n_mfcc=13),
        model=ModelConfig(frontend="dense", dense_layers=1,
                          dense_units=32, rnn_layers=2, rnn_units=16,
                          bidirectional=bidirectional, dropout=0.0,
                          compute_dtype="float32"),
        data=DataConfig(train_manifest=manifest, batch_size=2,
                        num_buckets=1, num_workers=1,
                        min_audio_seconds=0.05, max_audio_seconds=10.0),
        train=TrainConfig(learning_rate=1e-3,
                          total_steps=3, log_every=1, checkpoint_every=3,
                          eval_every=0, precompile=False),
        mesh=MeshConfig(seq_axis=seq_axis),
    )


@pytest.mark.parametrize("bidirectional", [True, False])
def test_sp_train_step_matches_unsharded(bidirectional):
    """The full config-driven SP train step (features -> dense frontend
    -> wavefront stack -> head -> CTC -> backward -> Adam) reproduces
    the unsharded single-device step: same loss and same updated params
    after two steps (VERDICT r3 weak #3)."""
    from ctc_asr.train import init_train_state, make_train_step

    n = 4
    mesh = _seq_mesh(n)
    cfg = _sp_train_cfg(bidirectional=bidirectional)
    hop = cfg.features.hop_length
    B, S, U = 2, n * 8 * hop, 12
    rng = np.random.default_rng(0)
    samples = (rng.standard_normal((B, S)) * 0.2).astype(np.float32)
    slens = np.asarray([S, S - 5 * hop - 13], np.int32)
    labels = rng.integers(0, 28, (B, U)).astype(np.int32)
    llens = np.asarray([U, 7], np.int32)

    ref_state = init_train_state(cfg)
    ref_step = make_train_step(cfg, donate=False)
    sp_state = jax.device_get(ref_state)
    sp_step = seqpar.make_sp_train_step(cfg, mesh, sp_state,
                                        donate=False)
    from jax.sharding import NamedSharding, PartitionSpec
    sp_state = jax.device_put(sp_state,
                              NamedSharding(mesh, PartitionSpec()))
    arrs = seqpar.sp_batch_put(mesh, (samples, slens, labels, llens))

    for step in range(2):
        ref_state, ref_m = ref_step(ref_state, samples, slens,
                                    labels, llens)
        sp_state, sp_m = sp_step(sp_state, *arrs)
        np.testing.assert_allclose(float(sp_m["loss"]),
                                   float(ref_m["loss"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(sp_m["grad_norm"]),
                                   float(ref_m["grad_norm"]),
                                   rtol=1e-4, atol=1e-5)
    for ref_leaf, sp_leaf in zip(jax.tree.leaves(ref_state["params"]),
                                 jax.tree.leaves(sp_state["params"])):
        np.testing.assert_allclose(np.asarray(sp_leaf),
                                   np.asarray(ref_leaf),
                                   rtol=2e-4, atol=2e-5)


def test_sp_train_config_driven(tmp_path):
    """mesh.seq_axis=4 routes train() through the SP step end-to-end
    (loader -> sp_batch_put -> wavefront step -> checkpoint): a user
    can turn SP on from the config alone."""
    import dataclasses as dcm
    from ctc_asr.data.synth import generate_corpus
    from ctc_asr.train import train

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    out = tmp_path / "sp_corpus"
    manifest = generate_corpus(str(out), num_utterances=8, seed=5,
                               min_words=1, max_words=2)
    cfg = _sp_train_cfg(manifest=manifest, seq_axis=4)
    cfg = dcm.replace(cfg, train=dcm.replace(
        cfg.train, train_dir=str(tmp_path / "sp_dir")))
    state = train(cfg)
    assert int(np.asarray(state["step"])) == 3
    import os
    assert os.path.exists(str(tmp_path / "sp_dir" / "ckpt" /
                              "step_00000003.npz"))


def _conv_cfg(cfg, specaugment=False, conv_as_matmul=False):
    """Small DS2-style conv config on top of _sp_train_cfg.

    conv_as_matmul=False pins the unsharded reference to the NHWC
    dilated-conv formulation the SP path uses, so parity asserts the
    HALO math at tight tolerance (the banded-matmul default differs
    from NHWC by reduction order alone — covered by the convergence
    trajectory test, which runs the production default)."""
    from ctc_asr.config import ModelConfig
    return dc.replace(
        cfg,
        model=ModelConfig(frontend="conv", conv_channels=(8, 8),
                          conv_kernels=((11, 11), (11, 5)),
                          conv_strides=((2, 2), (1, 2)),
                          rnn_layers=1, rnn_units=16,
                          bidirectional=True, dropout=0.0,
                          compute_dtype="float32",
                          conv_as_matmul=conv_as_matmul),
        train=dc.replace(cfg.train, specaugment=specaugment))


@pytest.mark.parametrize("specaugment", [False, True])
def test_sp_train_step_conv_matches_unsharded(specaugment):
    """The SP step now serves the PRODUCTION (conv/DS2) family
    (VERDICT r4 next #3): per-conv-layer time-halo exchange + strided
    chunk tiling + global-frame-indexed SpecAugment reproduce the
    unsharded step — same loss/grad_norm/params after two steps.
    SpecAugment parity works because every device draws the same span
    parameters from the replicated sa_rng and masks its own global
    slice."""
    from ctc_asr.train import init_train_state, make_train_step

    n = 4
    mesh = _seq_mesh(n)
    cfg = _conv_cfg(_sp_train_cfg(), specaugment=specaugment)
    hop = cfg.features.hop_length
    B, S, U = 2, n * 32 * hop, 12
    rng = np.random.default_rng(0)
    samples = (rng.standard_normal((B, S)) * 0.2).astype(np.float32)
    slens = np.asarray([S, S - 5 * hop - 13], np.int32)
    labels = rng.integers(0, 28, (B, U)).astype(np.int32)
    llens = np.asarray([U, 7], np.int32)

    ref_state = init_train_state(cfg)
    ref_step = make_train_step(cfg, donate=False)
    sp_state = jax.device_get(ref_state)
    sp_step = seqpar.make_sp_train_step(cfg, mesh, sp_state,
                                        donate=False)
    from jax.sharding import NamedSharding, PartitionSpec
    sp_state = jax.device_put(sp_state,
                              NamedSharding(mesh, PartitionSpec()))
    arrs = seqpar.sp_batch_put(mesh, (samples, slens, labels, llens))
    for step in range(2):
        ref_state, ref_m = ref_step(ref_state, samples, slens,
                                    labels, llens)
        sp_state, sp_m = sp_step(sp_state, *arrs)
        np.testing.assert_allclose(float(sp_m["loss"]),
                                   float(ref_m["loss"]),
                                   rtol=1e-5, atol=1e-6)
    for ref_leaf, sp_leaf in zip(jax.tree.leaves(ref_state["params"]),
                                 jax.tree.leaves(sp_state["params"])):
        np.testing.assert_allclose(np.asarray(sp_leaf),
                                   np.asarray(ref_leaf),
                                   rtol=2e-4, atol=2e-5)


def test_sp_eval_step_matches_unsharded():
    """make_sp_eval_step == make_eval_step on the conv config: same
    logits (replicated) and output lengths."""
    from ctc_asr.train import init_train_state, make_eval_step

    n = 4
    mesh = _seq_mesh(n)
    cfg = _conv_cfg(_sp_train_cfg())
    hop = cfg.features.hop_length
    B, S = 3, n * 32 * hop
    rng = np.random.default_rng(2)
    samples = (rng.standard_normal((B, S)) * 0.2).astype(np.float32)
    slens = np.asarray([S, S - 3 * hop - 5, S // 2], np.int32)
    params = jax.device_get(init_train_state(cfg))["params"]

    ref_logits, ref_lens = make_eval_step(cfg)(params, samples, slens)
    sp_step = seqpar.make_sp_eval_step(cfg, mesh)
    arrs = seqpar.sp_batch_put(mesh, (samples, slens))
    sp_logits, sp_lens = sp_step(params, *arrs)
    np.testing.assert_array_equal(np.asarray(sp_lens),
                                  np.asarray(ref_lens))
    T_ref = ref_logits.shape[1]
    np.testing.assert_allclose(np.asarray(sp_logits)[:, :T_ref],
                               np.asarray(ref_logits),
                               rtol=2e-5, atol=2e-5)


def test_sp_conv_convergence_trajectory(tmp_path):
    """Multi-step SP convergence (VERDICT r4 weak #2): 50 steps of the
    conv+SpecAugment config under seq:4 track the unsharded loss
    trajectory — not just a 2-step match. Same data order (one bucket,
    same loader seed), dropout 0; per-step losses must agree within
    accumulated-f32-drift tolerance and the final loss must have
    dropped."""
    from ctc_asr.data import DataLoader, read_manifest
    from ctc_asr.data.synth import generate_corpus
    from ctc_asr.train import init_train_state, make_train_step

    n = 4
    mesh = _seq_mesh(n)
    manifest = generate_corpus(str(tmp_path / "c"), num_utterances=8,
                               seed=5, min_words=1, max_words=2)
    cfg = _conv_cfg(_sp_train_cfg(manifest=manifest), specaugment=True)
    steps = 50

    def run(step_fn, put, state):
        loader = DataLoader(read_manifest(manifest), cfg.data,
                            cfg.features)
        losses = []
        it = iter(loader)
        for _ in range(steps):
            b = next(it)
            arrs = put((b.samples, b.sample_lengths, b.labels,
                        b.label_lengths))
            state, m = step_fn(state, *arrs)
            losses.append(float(m["loss"]))
        it.close()
        return np.asarray(losses)

    state0 = jax.device_get(init_train_state(cfg))
    ref_step = make_train_step(cfg, donate=False)
    ref_losses = run(ref_step, lambda a: a, state0)

    sp_step = seqpar.make_sp_train_step(cfg, mesh, state0, donate=False)
    from jax.sharding import NamedSharding, PartitionSpec
    sp_state = jax.device_put(state0, NamedSharding(mesh,
                                                    PartitionSpec()))
    import functools
    sp_losses = run(sp_step, functools.partial(seqpar.sp_batch_put,
                                               mesh), sp_state)

    # identical math modulo reduction order: trajectories must track
    np.testing.assert_allclose(sp_losses, ref_losses, rtol=5e-3,
                               atol=5e-3)
    assert sp_losses[-1] < 0.5 * sp_losses[0]


def test_sp_birnn_stack_two_layers():
    """Layers chain with no resharding: output of layer 1 ('seq'-
    sharded) feeds layer 2 directly; parity vs the stacked unsharded
    reference."""
    n = 4
    mesh = _seq_mesh(n)
    T, B, F, H = 16, 2, 6, 8
    p1 = {"fwd": lstm_init(jax.random.PRNGKey(0), F, H),
          "bwd": lstm_init(jax.random.PRNGKey(1), F, H)}
    p2 = {"fwd": lstm_init(jax.random.PRNGKey(2), 2 * H, H),
          "bwd": lstm_init(jax.random.PRNGKey(3), 2 * H, H)}
    x = jax.random.normal(jax.random.PRNGKey(4), (T, B, F))
    lengths = jnp.asarray([16, 11], jnp.int32)

    ref1 = birnn_apply(p1, x, lengths, "lstm", jnp.float32)
    want = np.asarray(birnn_apply(p2, ref1, lengths, "lstm",
                                  jnp.float32))
    f1 = seqpar.make_sp_birnn_fn(p1, mesh)
    f2 = seqpar.make_sp_birnn_fn(p2, mesh)
    got = np.asarray(f2(f1(x, lengths), lengths))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sp_rejects_feature_cache_batches():
    """SP shards RAW audio samples over time; a feature-cache batch
    ([B, T, F] precomputed features) must be rejected loudly rather
    than mis-sharded as samples."""
    mesh = _seq_mesh(2)
    feats = np.zeros((2, 32, 13), np.float16)
    with pytest.raises(NotImplementedError, match="feature-cache"):
        seqpar.sp_batch_put(mesh, (feats, np.array([32, 32], np.int32)))
