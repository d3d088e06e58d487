"""The lax.scan recurrences (models/rnn.py) against a NumPy step loop:
values for LSTM, GRU and the plain tanh cell, uni- and bidirectional
with ragged lengths; gradients against finite differences; and no
gradient from past each utterance's length."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ctc_asr.models import rnn as rnn_mod

INIT = {"lstm": rnn_mod.lstm_init, "gru": rnn_mod.gru_init,
        "rnn": rnn_mod.vanilla_init}


def _sig(x):
    return 1.0 / (1.0 + np.exp(-x))


def oracle(params, x, lengths, rnn_type):
    """Per-utterance, per-step loop in float64. x [T, B, F] -> [T, B, H];
    zero output and frozen state at t >= length."""
    wx, wh, b = (np.asarray(params[k], np.float64) for k in ("wx", "wh", "b"))
    T, B, _ = x.shape
    H = wh.shape[0]
    out = np.zeros((T, B, H))
    for n in range(B):
        h, c = np.zeros(H), np.zeros(H)
        for t in range(int(lengths[n])):
            xp = np.asarray(x[t, n], np.float64) @ wx + b
            hp = h @ wh
            if rnn_type == "lstm":
                i, f, g, o = np.split(xp + hp, 4)
                c = _sig(f) * c + _sig(i) * np.tanh(g)
                h = _sig(o) * np.tanh(c)
            elif rnn_type == "gru":
                xr, xz, xn = np.split(xp, 3)
                hr, hz, hn = np.split(hp, 3)
                r, z = _sig(xr + hr), _sig(xz + hz)
                h = (1 - z) * np.tanh(xn + r * hn) + z * h
            else:
                h = np.tanh(xp + hp)
            out[t, n] = h
    return out


def oracle_bi(params, x, lengths, rnn_type):
    fwd = oracle(params["fwd"], x, lengths, rnn_type)
    xr = np.zeros_like(x)
    for n, L in enumerate(lengths):
        xr[:L, n] = x[:L, n][::-1]
    bwd_r = oracle(params["bwd"], xr, lengths, rnn_type)
    bwd = np.zeros_like(bwd_r)
    for n, L in enumerate(lengths):
        bwd[:L, n] = bwd_r[:L, n][::-1]
    return np.concatenate([fwd, bwd], -1)


def _layer(rnn_type, F, H, seed, bias=True):
    p = INIT[rnn_type](jax.random.PRNGKey(seed), F, H)
    if bias:  # non-zero biases exercise the bias path
        p["b"] = 0.3 * jax.random.normal(jax.random.PRNGKey(seed + 50),
                                         p["b"].shape)
    return p


@pytest.mark.parametrize("rnn_type", ["lstm", "gru", "rnn"])
@pytest.mark.parametrize("T,B,F,H,lens", [
    (6, 2, 4, 8, [6, 3]),
    (9, 3, 5, 8, [9, 5, 1]),
])
def test_uni_matches_numpy_oracle(rnn_type, T, B, F, H, lens):
    params = _layer(rnn_type, F, H, 0)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (T, B, F)))
    got = rnn_mod.rnn_apply(params, jnp.asarray(x), jnp.asarray(lens),
                            rnn_type, jnp.float32)
    np.testing.assert_allclose(np.asarray(got),
                               oracle(params, x, lens, rnn_type),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_bi_matches_numpy_oracle(rnn_type):
    T, B, F, H = 8, 3, 4, 8
    params = {"fwd": _layer(rnn_type, F, H, 0),
              "bwd": _layer(rnn_type, F, H, 1)}
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (T, B, F)))
    lens = [8, 5, 2]
    got = rnn_mod.birnn_apply(params, jnp.asarray(x), jnp.asarray(lens),
                              rnn_type, jnp.float32)
    np.testing.assert_allclose(np.asarray(got),
                               oracle_bi(params, x, lens, rnn_type),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_gradient_matches_finite_differences(rnn_type):
    """Directional derivatives of a BiRNN loss w.r.t. every weight and
    the input, autodiff vs central differences."""
    T, B, F, H = 6, 2, 3, 5
    params = {"fwd": _layer(rnn_type, F, H, 3),
              "bwd": _layer(rnn_type, F, H, 4)}
    x = jax.random.normal(jax.random.PRNGKey(5), (T, B, F))
    lens = jnp.asarray([6, 4])
    w = jax.random.normal(jax.random.PRNGKey(6), (T, B, 2 * H))

    def loss(p, xx):
        return jnp.sum(rnn_mod.birnn_apply(p, xx, lens, rnn_type,
                                           jnp.float32) * w)

    g = jax.grad(loss, argnums=(0, 1))(params, x)
    for k in range(3):
        d = jax.tree.map(lambda a, i=k: jax.random.normal(
            jax.random.PRNGKey(100 + i), a.shape), (params, x))
        norm = jnp.sqrt(sum(jnp.sum(v * v) for v in jax.tree.leaves(d)))
        d = jax.tree.map(lambda v: v / norm, d)   # unit direction
        eps = 1e-3
        plus = jax.tree.map(lambda a, b: a + eps * b, (params, x), d)
        minus = jax.tree.map(lambda a, b: a - eps * b, (params, x), d)
        fd = (loss(*plus) - loss(*minus)) / (2 * eps)
        ad = sum(jnp.vdot(a, b) for a, b in zip(jax.tree.leaves(g),
                                                jax.tree.leaves(d)))
        # float32 loss: central differences carry ~1e-3 roundoff
        np.testing.assert_allclose(float(ad), float(fd), rtol=5e-3,
                                   atol=2e-3)


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_grad_zero_beyond_length(rnn_type):
    """Padding frames past a length neither affect the outputs nor get
    gradient, in both directions."""
    T, B, F, H = 8, 2, 4, 8
    params = {"fwd": _layer(rnn_type, F, H, 0),
              "bwd": _layer(rnn_type, F, H, 1)}
    x = jax.random.normal(jax.random.PRNGKey(1), (T, B, F))
    lens = jnp.asarray([5, 8])
    g = np.asarray(jax.grad(lambda xx: jnp.sum(rnn_mod.birnn_apply(
        params, xx, lens, rnn_type, jnp.float32) ** 2))(x))
    assert np.allclose(g[5:, 0], 0.0)
    assert not np.allclose(g[:5, 0], 0.0)
    assert not np.allclose(g[:, 1], 0.0)
