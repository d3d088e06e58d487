import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ctc_asr.config import ModelConfig
from ctc_asr.models import apply_encoder, init_params, output_lengths
from ctc_asr.models.rnn import (gru_apply, gru_init, lstm_apply,
                                lstm_init, reverse_sequence,
                                vanilla_apply, vanilla_init)


def test_reverse_sequence():
    x = jnp.asarray(np.arange(12, dtype=np.float32).reshape(4, 3, 1))
    lens = jnp.asarray([4, 2, 0])
    out = np.asarray(reverse_sequence(x, lens))
    # batch 0: full reverse of [0,3,6,9] -> [9,6,3,0]
    np.testing.assert_array_equal(out[:, 0, 0], [9, 6, 3, 0])
    # batch 1: first 2 reversed, tail in place
    np.testing.assert_array_equal(out[:, 1, 0], [4, 1, 7, 10])
    # batch 2: untouched
    np.testing.assert_array_equal(out[:, 2, 0], [2, 5, 8, 11])
    # double reverse = identity
    out2 = np.asarray(reverse_sequence(jnp.asarray(out), lens))
    np.testing.assert_array_equal(out2, np.asarray(x))


@pytest.mark.parametrize("init_fn,apply_fn", [(lstm_init, lstm_apply),
                                              (gru_init, gru_apply),
                                              (vanilla_init, vanilla_apply)])
def test_rnn_shapes_and_masking(init_fn, apply_fn):
    rng = jax.random.PRNGKey(0)
    T, B, F, H = 7, 3, 5, 8
    params = init_fn(rng, F, H)
    x = jax.random.normal(jax.random.PRNGKey(1), (T, B, F))
    lens = jnp.asarray([7, 4, 0])
    out = np.asarray(apply_fn(params, x, lens, compute_dtype=jnp.float32))
    assert out.shape == (T, B, H)
    # outputs at/after length are zero
    assert np.allclose(out[4:, 1], 0.0)
    assert np.allclose(out[:, 2], 0.0)
    assert not np.allclose(out[:4, 1], 0.0)


def test_rnn_padding_invariance():
    """Changing garbage beyond a sequence's length must not change its
    valid outputs (state carry is masked)."""
    rng = jax.random.PRNGKey(0)
    T, B, F, H = 6, 2, 4, 8
    params = lstm_init(rng, F, H)
    x = jax.random.normal(jax.random.PRNGKey(1), (T, B, F))
    lens = jnp.asarray([6, 3])
    out1 = np.asarray(lstm_apply(params, x, lens, jnp.float32))
    x2 = x.at[3:, 1].set(99.0)
    out2 = np.asarray(lstm_apply(params, x2, lens, jnp.float32))
    np.testing.assert_allclose(out1[:3, 1], out2[:3, 1], rtol=1e-6)


def _run_encoder(cfg, B=2, T=20, F=13):
    params = init_params(jax.random.PRNGKey(0), cfg, F)
    feats = jax.random.normal(jax.random.PRNGKey(1), (B, T, F))
    lens = jnp.asarray([T, T // 2])
    logits, out_lens = apply_encoder(params, feats, lens, cfg)
    return np.asarray(logits), np.asarray(out_lens)


def test_dense_encoder():
    cfg = ModelConfig(frontend="dense", dense_layers=2, dense_units=32,
                      rnn_layers=2, rnn_units=16, bidirectional=False,
                      compute_dtype="float32")
    logits, lens = _run_encoder(cfg)
    assert logits.shape == (2, 20, 29)
    np.testing.assert_array_equal(lens, [20, 10])
    assert np.isfinite(logits).all()


def test_conv_encoder_downsamples():
    cfg = ModelConfig(frontend="conv", conv_channels=(4, 4),
                      conv_kernels=((5, 5), (3, 3)),
                      conv_strides=((2, 2), (1, 2)),
                      rnn_layers=1, rnn_units=16, bidirectional=True,
                      compute_dtype="float32")
    logits, lens = _run_encoder(cfg, T=21, F=16)
    # SAME padding: T' = ceil(21/2) = 11
    assert logits.shape == (2, 11, 29)
    np.testing.assert_array_equal(lens, [11, 5])


def test_output_lengths():
    cfg = ModelConfig(frontend="conv", conv_strides=((2, 2), (1, 2)))
    lens = output_lengths(jnp.asarray([20, 21, 1, 0]), cfg)
    np.testing.assert_array_equal(np.asarray(lens), [10, 11, 1, 0])
    cfg2 = ModelConfig(frontend="dense")
    np.testing.assert_array_equal(
        np.asarray(output_lengths(jnp.asarray([7]), cfg2)), [7])


def test_bidirectional_doubles_and_uses_future():
    cfg_uni = ModelConfig(frontend="dense", dense_layers=1, dense_units=8,
                          rnn_layers=1, rnn_units=8, bidirectional=False,
                          compute_dtype="float32")
    cfg_bi = ModelConfig(frontend="dense", dense_layers=1, dense_units=8,
                         rnn_layers=1, rnn_units=8, bidirectional=True,
                         compute_dtype="float32")
    F = 5
    p_bi = init_params(jax.random.PRNGKey(0), cfg_bi, F)
    feats = jax.random.normal(jax.random.PRNGKey(1), (1, 10, F))
    lens = jnp.asarray([10])
    logits, _ = apply_encoder(p_bi, feats, lens, cfg_bi)
    # perturb the LAST frame: with a BiRNN, the FIRST output must change
    feats2 = feats.at[0, -1].set(5.0)
    logits2, _ = apply_encoder(p_bi, feats2, lens, cfg_bi)
    assert not np.allclose(np.asarray(logits[0, 0]), np.asarray(logits2[0, 0]))
    # with a uni RNN it must NOT change
    p_uni = init_params(jax.random.PRNGKey(0), cfg_uni, F)
    l1, _ = apply_encoder(p_uni, feats, lens, cfg_uni)
    l2, _ = apply_encoder(p_uni, feats2, lens, cfg_uni)
    np.testing.assert_allclose(np.asarray(l1[0, 0]), np.asarray(l2[0, 0]),
                               rtol=1e-5)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_vanilla_rnn_encoder(bidirectional):
    """rnn_type='rnn' (the reference's BasicRNNCell option): encoder
    runs end-to-end and gradients are finite."""
    cfg = ModelConfig(frontend="dense", dense_layers=1, dense_units=8,
                      rnn_type="rnn", rnn_layers=2, rnn_units=8,
                      bidirectional=bidirectional, compute_dtype="float32")
    F = 5
    params = init_params(jax.random.PRNGKey(0), cfg, F)
    feats = jax.random.normal(jax.random.PRNGKey(1), (2, 10, F))
    lens = jnp.asarray([10, 6])
    logits, out_lens = apply_encoder(params, feats, lens, cfg)
    assert logits.shape == (2, 10, 29)
    np.testing.assert_array_equal(np.asarray(out_lens), [10, 6])
    assert np.isfinite(np.asarray(logits)).all()

    def loss(p):
        lg, _ = apply_encoder(p, feats, lens, cfg)
        return jnp.sum(lg ** 2)

    g = jax.grad(loss)(params)
    for leaf in jax.tree_util.tree_leaves(g):
        assert np.isfinite(np.asarray(leaf)).all()
    # the bidirectional stack must see the future, the uni stack must not
    feats2 = feats.at[0, -1].set(5.0)
    logits2, _ = apply_encoder(params, feats2, lens, cfg)
    changed = not np.allclose(np.asarray(logits[0, 0]),
                              np.asarray(logits2[0, 0]))
    assert changed == bidirectional


def test_dropout_train_vs_eval():
    cfg = ModelConfig(frontend="dense", dense_layers=1, dense_units=16,
                      rnn_layers=1, rnn_units=8, dropout=0.5,
                      compute_dtype="float32")
    params = init_params(jax.random.PRNGKey(0), cfg, 4)
    feats = jax.random.normal(jax.random.PRNGKey(1), (1, 6, 4))
    lens = jnp.asarray([6])
    e1, _ = apply_encoder(params, feats, lens, cfg, train=False)
    e2, _ = apply_encoder(params, feats, lens, cfg, train=False)
    np.testing.assert_allclose(np.asarray(e1), np.asarray(e2))
    t1, _ = apply_encoder(params, feats, lens, cfg, train=True,
                          dropout_rng=jax.random.PRNGKey(2))
    t2, _ = apply_encoder(params, feats, lens, cfg, train=True,
                          dropout_rng=jax.random.PRNGKey(3))
    assert not np.allclose(np.asarray(t1), np.asarray(t2))


def test_bf16_compute_close_to_f32():
    cfg32 = ModelConfig(frontend="dense", dense_layers=1, dense_units=32,
                        rnn_layers=1, rnn_units=32, compute_dtype="float32")
    cfg16 = ModelConfig(frontend="dense", dense_layers=1, dense_units=32,
                        rnn_layers=1, rnn_units=32, compute_dtype="bfloat16")
    params = init_params(jax.random.PRNGKey(0), cfg32, 8)
    feats = jax.random.normal(jax.random.PRNGKey(1), (2, 12, 8))
    lens = jnp.asarray([12, 12])
    l32, _ = apply_encoder(params, feats, lens, cfg32)
    l16, _ = apply_encoder(params, feats, lens, cfg16)
    assert np.asarray(l16).dtype == np.float32  # f32 accumulate/output
    np.testing.assert_allclose(np.asarray(l32), np.asarray(l16),
                               rtol=0.15, atol=0.15)


def test_fused_birnn_matches_two_scans():
    """The single-scan bidirectional must equal running each direction
    separately (the definitional implementation)."""
    from ctc_asr.models.rnn import (birnn_apply, lstm_init,
                                    rnn_apply, reverse_sequence)
    rng = jax.random.PRNGKey(0)
    T, B, F, H = 9, 3, 6, 8
    params = {"fwd": lstm_init(jax.random.PRNGKey(1), F, H),
              "bwd": lstm_init(jax.random.PRNGKey(2), F, H)}
    x = jax.random.normal(jax.random.PRNGKey(3), (T, B, F))
    lens = jnp.asarray([9, 5, 2])
    got = np.asarray(birnn_apply(params, x, lens, "lstm", jnp.float32))
    fwd = rnn_apply(params["fwd"], x, lens, "lstm", jnp.float32)
    x_rev = reverse_sequence(x, lens)
    bwd = rnn_apply(params["bwd"], x_rev, lens, "lstm", jnp.float32)
    bwd = reverse_sequence(bwd, lens)
    want = np.asarray(jnp.concatenate([fwd, bwd], axis=-1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_fused_bigru_matches_two_scans():
    from ctc_asr.models.rnn import (birnn_apply, gru_init,
                                    rnn_apply, reverse_sequence)
    T, B, F, H = 7, 2, 4, 6
    params = {"fwd": gru_init(jax.random.PRNGKey(1), F, H),
              "bwd": gru_init(jax.random.PRNGKey(2), F, H)}
    x = jax.random.normal(jax.random.PRNGKey(3), (T, B, F))
    lens = jnp.asarray([7, 4])
    got = np.asarray(birnn_apply(params, x, lens, "gru", jnp.float32))
    fwd = rnn_apply(params["fwd"], x, lens, "gru", jnp.float32)
    x_rev = reverse_sequence(x, lens)
    bwd = rnn_apply(params["bwd"], x_rev, lens, "gru", jnp.float32)
    bwd = reverse_sequence(bwd, lens)
    want = np.asarray(jnp.concatenate([fwd, bwd], axis=-1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_conv_matmul_matches_conv():
    """Banded-matmul conv == lax conv (values and gradients)."""
    from ctc_asr.models.layers import (conv2d_apply, conv2d_init,
                                       conv2d_matmul_apply)
    rng = jax.random.PRNGKey(0)
    for (kt, kf, cin, cout, st, sf, T, F) in [
            (5, 7, 1, 4, 2, 2, 21, 16),
            (3, 5, 4, 8, 1, 2, 10, 12),
            (11, 21, 2, 4, 2, 2, 30, 40)]:
        params = conv2d_init(rng, kt, kf, cin, cout)
        x = jax.random.normal(jax.random.PRNGKey(1), (2, T, F, cin))
        want = conv2d_apply(params, x, (st, sf), jnp.float32)
        got = conv2d_matmul_apply(params, x, (st, sf), jnp.float32)
        assert got.shape == want.shape, (got.shape, want.shape)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)
        gw = jax.grad(lambda p: jnp.sum(
            conv2d_apply(p, x, (st, sf), jnp.float32) ** 2))(params)
        gm = jax.grad(lambda p: jnp.sum(
            conv2d_matmul_apply(p, x, (st, sf), jnp.float32) ** 2))(params)
        np.testing.assert_allclose(np.asarray(gm["w"]), np.asarray(gw["w"]),
                                   rtol=2e-3, atol=2e-3)


def test_conv_blocked_matches_conv():
    """Blocked-band conv == lax conv (values AND gradients, both by
    autodiff through the blocked formulation — must match plain
    conv2d_apply). Includes cases that tile onto 128 lanes, the
    no-tiling fallback, and grads wrt the INPUT (the dx path exercised
    by conv2 of a stacked frontend)."""
    from ctc_asr.models.layers import (_pick_gfo, _same_pad,
                                       conv2d_apply,
                                       conv2d_blocked_apply,
                                       conv2d_init)
    rng = jax.random.PRNGKey(0)
    for (kt, kf, cin, cout, st, sf, T, F) in [
            (11, 21, 2, 32, 2, 2, 30, 40),   # gfo=4 -> 128 lanes
            (3, 5, 4, 16, 1, 2, 10, 32),     # gfo=8 -> 128 lanes
            (5, 7, 1, 4, 2, 2, 21, 16)]:     # no tiling -> fallback
        f_out, _, _ = _same_pad(F, kf, sf)
        params = conv2d_init(rng, kt, kf, cin, cout)
        x = jax.random.normal(jax.random.PRNGKey(1), (2, T, F, cin))
        want = conv2d_apply(params, x, (st, sf), jnp.float32)
        got = conv2d_blocked_apply(params, x, (st, sf), jnp.float32)
        assert got.shape == want.shape, (got.shape, want.shape)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)

        def loss(fn):
            return lambda p, xx: jnp.sum(fn(p, xx, (st, sf),
                                            jnp.float32) ** 2)

        gw, gx = jax.grad(loss(conv2d_apply), argnums=(0, 1))(params, x)
        bw, bx = jax.grad(loss(conv2d_blocked_apply),
                          argnums=(0, 1))(params, x)
        np.testing.assert_allclose(np.asarray(bw["w"]), np.asarray(gw["w"]),
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(np.asarray(bw["b"]), np.asarray(gw["b"]),
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(np.asarray(bx), np.asarray(gx),
                                   rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_encoder_birnn_matches_reversed_sequence(rnn_type):
    """apply_encoder's fused BiRNN (static flip + shifted mask, both
    directions in one scan) must equal the textbook form — a forward
    pass plus a pass over the per-utterance reversed valid prefix —
    in values and gradients, across layers, the head projection and
    ragged lengths."""
    from ctc_asr.models import rnn as rnn_mod
    from ctc_asr.models.layers import dense_apply

    cfg = ModelConfig(frontend="dense", dense_layers=0,
                      rnn_type=rnn_type, rnn_layers=2, rnn_units=8,
                      bidirectional=True, dropout=0.0,
                      compute_dtype="float32")
    params = init_params(jax.random.PRNGKey(0), cfg, 10)
    feats = jax.random.normal(jax.random.PRNGKey(1), (2, 12, 10))
    flens = jnp.asarray([12, 7])

    def textbook(p):
        x = jnp.swapaxes(feats, 0, 1) * (
            jnp.arange(12)[:, None] < flens[None, :])[..., None]
        for layer in p["rnn"]:
            fwd = rnn_mod.rnn_apply(layer["fwd"], x, flens, rnn_type,
                                    jnp.float32)
            bwd = rnn_mod.reverse_sequence(rnn_mod.rnn_apply(
                layer["bwd"], rnn_mod.reverse_sequence(x, flens), flens,
                rnn_type, jnp.float32), flens)
            x = jnp.concatenate([fwd, bwd], axis=-1)
        return jnp.swapaxes(dense_apply(p["head"], x, jnp.float32), 0, 1)

    def fused(p):
        return apply_encoder(p, feats, flens, cfg)[0]

    valid = (jnp.arange(12)[None, :] < flens[:, None])[..., None]
    np.testing.assert_allclose(np.asarray(fused(params) * valid),
                               np.asarray(textbook(params) * valid),
                               rtol=1e-4, atol=1e-5)
    g_fused = jax.grad(lambda p: jnp.sum((fused(p) * valid) ** 2))(params)
    g_text = jax.grad(lambda p: jnp.sum((textbook(p) * valid) ** 2))(params)
    for a, b in zip(jax.tree_util.tree_leaves(g_fused),
                    jax.tree_util.tree_leaves(g_text)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_remat_matches_no_remat(bidirectional):
    """model.remat wraps each RNN layer in jax.checkpoint; the forward
    values are identical and the gradients match (recomputation changes
    scheduling, not math)."""
    import dataclasses
    cfg = ModelConfig(frontend="conv", conv_channels=(4, 4),
                      conv_kernels=((5, 5), (3, 3)),
                      conv_strides=((2, 2), (1, 2)),
                      rnn_layers=2, rnn_units=8,
                      bidirectional=bidirectional,
                      dropout=0.1, compute_dtype="float32")
    cfg_r = dataclasses.replace(cfg, remat=True)
    params = init_params(jax.random.PRNGKey(0), cfg, 10)
    feats = jax.random.normal(jax.random.PRNGKey(1), (2, 16, 10))
    flens = jnp.asarray([16, 9])
    drng = jax.random.PRNGKey(7)

    def loss(p, c, train):
        logits, _ = apply_encoder(p, feats, flens, c, train=train,
                                  dropout_rng=drng if train else None)
        return jnp.sum(logits ** 2)

    for train in (False, True):
        np.testing.assert_allclose(
            np.asarray(loss(params, cfg, train)),
            np.asarray(loss(params, cfg_r, train)), rtol=1e-6)
        g0 = jax.grad(loss)(params, cfg, train)
        g1 = jax.grad(loss)(params, cfg_r, train)
        for a, b in zip(jax.tree_util.tree_leaves(g0),
                        jax.tree_util.tree_leaves(g1)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-5, atol=1e-6)
