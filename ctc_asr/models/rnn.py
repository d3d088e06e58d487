"""Recurrent layers: LSTM / GRU / vanilla-tanh via lax.scan, uni- and
bidirectional.

An XLA-native design (SURVEY.md §7 "BiLSTM throughput" hard part):

- **Input projections hoisted out of the recurrence**: ``x @ Wx`` for all
  T steps runs as ONE large [T*B, F] x [F, 4H] matmul before the scan;
  the scan body only does the unavoidable ``h @ Wh`` per step.
- **All 4 gates in one matmul** per step ([B, H] x [H, 4H]).
- Time-major [T, B, H] layout so the scan carries contiguous blocks.
- bf16 matmul inputs / f32 accumulation; the recurrent state itself is
  kept in f32 for stability over long utterances.
- Length masking: steps past a sequence's length pass state through
  unchanged and emit zeros, so bucket padding never contaminates state.
- Bidirectional = static-flip + shifted-mask (NOT a per-batch gather;
  see birnn_apply) with both directions fused into one scan.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .layers import glorot


def lstm_init(rng, in_dim: int, hidden: int) -> dict:
    k1, k2 = jax.random.split(rng)
    b = jnp.zeros((4 * hidden,), jnp.float32)
    # forget-gate bias = 1 (gate order: i, f, g, o)
    b = b.at[hidden:2 * hidden].set(1.0)
    return {"wx": glorot(k1, (in_dim, 4 * hidden)),
            "wh": glorot(k2, (hidden, 4 * hidden)),
            "b": b}


def gru_init(rng, in_dim: int, hidden: int) -> dict:
    k1, k2 = jax.random.split(rng)
    return {"wx": glorot(k1, (in_dim, 3 * hidden)),
            "wh": glorot(k2, (hidden, 3 * hidden)),
            "b": jnp.zeros((3 * hidden,), jnp.float32)}


def vanilla_init(rng, in_dim: int, hidden: int) -> dict:
    """Plain tanh RNN cell (the reference's BasicRNNCell option —
    SURVEY.md §2a "RNN type" flag alongside LSTM/GRU)."""
    k1, k2 = jax.random.split(rng)
    return {"wx": glorot(k1, (in_dim, hidden)),
            "wh": glorot(k2, (hidden, hidden)),
            "b": jnp.zeros((hidden,), jnp.float32)}


def reverse_sequence(x: jnp.ndarray, lengths: jnp.ndarray) -> jnp.ndarray:
    """Reverse the valid prefix of each sequence; padding stays in place.

    x: [T, B, ...] time-major; lengths: [B].
    """
    T = x.shape[0]
    t = jnp.arange(T)[:, None]                      # [T, 1]
    src = jnp.where(t < lengths[None, :], lengths[None, :] - 1 - t, t)  # [T,B]
    src = src.reshape((T, x.shape[1]) + (1,) * (x.ndim - 2))
    return jnp.take_along_axis(x, jnp.broadcast_to(src, x.shape), axis=0)


def _mask_tb(lengths: jnp.ndarray, T: int) -> jnp.ndarray:
    """[T, B] float mask of valid steps."""
    return (jnp.arange(T)[:, None] < lengths[None, :]).astype(jnp.float32)


def lstm_apply(params: dict, x: jnp.ndarray, lengths: jnp.ndarray,
               compute_dtype=jnp.bfloat16, unroll: int = 8) -> jnp.ndarray:
    """x: [T, B, F] -> [T, B, H]."""
    T, B, _ = x.shape
    H = params["wh"].shape[0]
    # One big matmul for all input projections.
    xproj = jnp.dot(x.astype(compute_dtype),
                    params["wx"].astype(compute_dtype),
                    preferred_element_type=jnp.float32) + params["b"]
    mask = _mask_tb(lengths, T)[..., None]          # [T, B, 1]
    wh = params["wh"].astype(compute_dtype)

    def step(carry, inp):
        h, c = carry
        xp, m = inp
        gates = xp + jnp.dot(h.astype(compute_dtype), wh,
                             preferred_element_type=jnp.float32)
        i, f, g, o = jnp.split(gates, 4, axis=-1)
        i, f, o = jax.nn.sigmoid(i), jax.nn.sigmoid(f), jax.nn.sigmoid(o)
        g = jnp.tanh(g)
        c_new = f * c + i * g
        h_new = o * jnp.tanh(c_new)
        c = m * c_new + (1.0 - m) * c
        h = m * h_new + (1.0 - m) * h
        return (h, c), h * m

    init = (jnp.zeros((B, H), jnp.float32), jnp.zeros((B, H), jnp.float32))
    # unroll amortizes XLA's per-iteration while-loop overhead.
    _, out = jax.lax.scan(step, init, (xproj, mask), unroll=unroll)
    return out


def gru_apply(params: dict, x: jnp.ndarray, lengths: jnp.ndarray,
              compute_dtype=jnp.bfloat16, unroll: int = 8) -> jnp.ndarray:
    """x: [T, B, F] -> [T, B, H]. Gate order: r, z, n."""
    T, B, _ = x.shape
    H = params["wh"].shape[0]
    xproj = jnp.dot(x.astype(compute_dtype),
                    params["wx"].astype(compute_dtype),
                    preferred_element_type=jnp.float32) + params["b"]
    mask = _mask_tb(lengths, T)[..., None]
    wh = params["wh"].astype(compute_dtype)

    def step(carry, inp):
        h = carry
        xp, m = inp
        hproj = jnp.dot(h.astype(compute_dtype), wh,
                        preferred_element_type=jnp.float32)
        xr, xz, xn = jnp.split(xp, 3, axis=-1)
        hr, hz, hn = jnp.split(hproj, 3, axis=-1)
        r = jax.nn.sigmoid(xr + hr)
        z = jax.nn.sigmoid(xz + hz)
        n = jnp.tanh(xn + r * hn)
        h_new = (1.0 - z) * n + z * h
        h = m * h_new + (1.0 - m) * h
        return h, h * m

    init = jnp.zeros((B, H), jnp.float32)
    _, out = jax.lax.scan(step, init, (xproj, mask), unroll=unroll)
    return out


def vanilla_apply(params: dict, x: jnp.ndarray, lengths: jnp.ndarray,
                  compute_dtype=jnp.bfloat16,
                  unroll: int = 8) -> jnp.ndarray:
    """x: [T, B, F] -> [T, B, H]; h' = tanh(x@wx + h@wh + b)."""
    T, B, _ = x.shape
    H = params["wh"].shape[0]
    xproj = jnp.dot(x.astype(compute_dtype),
                    params["wx"].astype(compute_dtype),
                    preferred_element_type=jnp.float32) + params["b"]
    mask = _mask_tb(lengths, T)[..., None]
    wh = params["wh"].astype(compute_dtype)

    def step(h, inp):
        xp, m = inp
        h_new = jnp.tanh(xp + jnp.dot(h.astype(compute_dtype), wh,
                                      preferred_element_type=jnp.float32))
        h = m * h_new + (1.0 - m) * h
        return h, h * m

    init = jnp.zeros((B, H), jnp.float32)
    _, out = jax.lax.scan(step, init, (xproj, mask), unroll=unroll)
    return out


def rnn_apply(params: dict, x: jnp.ndarray, lengths: jnp.ndarray,
              rnn_type: str, compute_dtype=jnp.bfloat16,
              unroll: int = 8) -> jnp.ndarray:
    if rnn_type == "lstm":
        return lstm_apply(params, x, lengths, compute_dtype, unroll)
    if rnn_type == "gru":
        return gru_apply(params, x, lengths, compute_dtype, unroll)
    if rnn_type == "rnn":
        return vanilla_apply(params, x, lengths, compute_dtype, unroll)
    raise ValueError(f"unknown rnn_type {rnn_type!r}")


def stack_bi_params(params: dict) -> dict:
    """{"fwd": ..., "bwd": ...} -> direction-stacked [2, ...] weights."""
    return {
        "wx": jnp.concatenate([params["fwd"]["wx"][None],
                               params["bwd"]["wx"][None]], 0),
        "wh": jnp.concatenate([params["fwd"]["wh"][None],
                               params["bwd"]["wh"][None]], 0),
        "b": jnp.concatenate([params["fwd"]["b"][None],
                              params["bwd"]["b"][None]], 0),
    }


def birnn_apply(params: dict, x: jnp.ndarray, lengths: jnp.ndarray,
                rnn_type: str, compute_dtype=jnp.bfloat16,
                unroll: int = 8) -> jnp.ndarray:
    """params = {"fwd": ..., "bwd": ...}; output [T, B, 2H].

    Bidirectionality, two tricks deep:

    1. **No gathers.** A per-batch ``reverse_sequence`` is a dynamic
       gather along time. Instead the backward direction sees the
       STATIC ``jnp.flip`` of the input (a layout view); the valid
       region then sits left-padded at [T-len, T), which the masked
       carry handles with the shifted mask ``t >= T - len`` (leading pad
       steps keep h=0 and emit 0, so the final states and valid outputs
       are identical to a true reversed sequence). The output
       un-reverses with another static flip.
    2. **One scan for both directions**: input and flipped input stack
       on a direction axis, so each step amortizes loop overhead and
       doubles the rows of the recurrent matmul; weights stay
       per-direction via a batched dot_general."""
    T, B, _ = x.shape
    x_rev = jnp.flip(x, axis=0)
    stacked = stack_bi_params(params)
    both = jnp.concatenate([x, x_rev], axis=1)       # [T, 2B, F]
    t_idx = jnp.arange(T)[:, None]
    mask_fwd = (t_idx < lengths[None, :]).astype(jnp.float32)
    mask_bwd = (t_idx >= (T - lengths)[None, :]).astype(jnp.float32)
    mask = jnp.stack([mask_fwd, mask_bwd], axis=1)[..., None]
    out = _stacked_rnn_apply(stacked, both, mask, rnn_type,
                             compute_dtype, unroll)   # [T, 2B, H]
    fwd, bwd = out[:, :B], out[:, B:]
    bwd = jnp.flip(bwd, axis=0)
    return jnp.concatenate([fwd, bwd], axis=-1)


def _stacked_rnn_apply(stacked: dict, x: jnp.ndarray, mask: jnp.ndarray,
                       rnn_type: str, compute_dtype, unroll: int):
    """Two directions as one scan. x: [T, 2B, F]; mask: [T, 2, B, 1]
    per-direction validity; stacked weights have a leading direction
    axis [2, ...]; the input/hidden projections are batched matmuls
    (dot_general with a batch dim) so each direction keeps its own
    weights."""
    T, B2, F = x.shape
    B = B2 // 2
    H = stacked["wh"].shape[1]
    G = stacked["wh"].shape[2]  # 4H (lstm) or 3H (gru)
    xd = x.reshape(T, 2, B, F).astype(compute_dtype)
    # xproj[t, d, b, :] = x[t, d, b] @ wx[d]
    xproj = jax.lax.dot_general(
        xd, stacked["wx"].astype(compute_dtype),
        dimension_numbers=(((3,), (1,)), ((1,), (0,))),
        preferred_element_type=jnp.float32)              # [2, T, B, G]
    xproj = jnp.moveaxis(xproj, 0, 1) + stacked["b"][None, :, None, :]
    wh = stacked["wh"].astype(compute_dtype)             # [2, H, G]

    if rnn_type == "lstm":
        def cell(h, c, gates):
            i, f, g, o = jnp.split(gates, 4, axis=-1)
            i, f, o = (jax.nn.sigmoid(i), jax.nn.sigmoid(f),
                       jax.nn.sigmoid(o))
            g = jnp.tanh(g)
            c_new = f * c + i * g
            return jnp.tanh(c_new) * o, c_new

        def step(carry, inp):
            h, c = carry
            xp, m = inp                                  # [2, B, G], [2,B,1]
            hproj = jax.lax.dot_general(
                h.astype(compute_dtype), wh,
                dimension_numbers=(((2,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32)
            h_new, c_new = cell(h, c, xp + hproj)
            c = m * c_new + (1.0 - m) * c
            h = m * h_new + (1.0 - m) * h
            return (h, c), h * m

        init = (jnp.zeros((2, B, H), jnp.float32),
                jnp.zeros((2, B, H), jnp.float32))
        _, out = jax.lax.scan(step, init, (xproj, mask), unroll=unroll)
    elif rnn_type == "gru":
        def step(carry, inp):
            h = carry
            xp, m = inp
            hproj = jax.lax.dot_general(
                h.astype(compute_dtype), wh,
                dimension_numbers=(((2,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32)
            xr, xz, xn = jnp.split(xp, 3, axis=-1)
            hr, hz, hn = jnp.split(hproj, 3, axis=-1)
            r = jax.nn.sigmoid(xr + hr)
            z = jax.nn.sigmoid(xz + hz)
            n = jnp.tanh(xn + r * hn)
            h_new = (1.0 - z) * n + z * h
            h = m * h_new + (1.0 - m) * h
            return h, h * m

        init = jnp.zeros((2, B, H), jnp.float32)
        _, out = jax.lax.scan(step, init, (xproj, mask), unroll=unroll)
    elif rnn_type == "rnn":
        def step(carry, inp):
            h = carry
            xp, m = inp
            hproj = jax.lax.dot_general(
                h.astype(compute_dtype), wh,
                dimension_numbers=(((2,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32)
            h_new = jnp.tanh(xp + hproj)
            h = m * h_new + (1.0 - m) * h
            return h, h * m

        init = jnp.zeros((2, B, H), jnp.float32)
        _, out = jax.lax.scan(step, init, (xproj, mask), unroll=unroll)
    else:
        raise ValueError(rnn_type)
    return out.reshape(T, 2 * B, H)
