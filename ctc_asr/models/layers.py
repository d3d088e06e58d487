"""Primitive functional layers: dense, conv2d, dropout.

Numerics policy (SURVEY.md §7 M3): parameters are stored in float32;
matmuls/convs run in the configured compute dtype (bfloat16 by default)
with float32 accumulation via ``preferred_element_type``, so the matrix
units run at their bf16 rate without losing the CTC loss's f32
precision.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def glorot(rng, shape, dtype=jnp.float32):
    fan_in, fan_out = shape[-2], shape[-1]
    if len(shape) > 2:  # conv kernels: receptive field multiplies fan
        rf = int(np.prod(shape[:-2]))
        fan_in, fan_out = fan_in * rf, fan_out * rf
    scale = jnp.sqrt(6.0 / (fan_in + fan_out))
    return jax.random.uniform(rng, shape, dtype, -scale, scale)


def dense_init(rng, in_dim: int, out_dim: int) -> dict:
    return {"w": glorot(rng, (in_dim, out_dim)),
            "b": jnp.zeros((out_dim,), jnp.float32)}


def dense_apply(params: dict, x: jnp.ndarray,
                compute_dtype=jnp.bfloat16) -> jnp.ndarray:
    """y = x @ w + b with bf16 inputs, f32 accumulation. Output f32."""
    y = jnp.dot(x.astype(compute_dtype), params["w"].astype(compute_dtype),
                preferred_element_type=jnp.float32)
    return y + params["b"]


def conv2d_init(rng, kh: int, kw: int, cin: int, cout: int) -> dict:
    return {"w": glorot(rng, (kh, kw, cin, cout)),
            "b": jnp.zeros((cout,), jnp.float32)}


def conv2d_apply(params: dict, x: jnp.ndarray, strides,
                 compute_dtype=jnp.bfloat16) -> jnp.ndarray:
    """NHWC conv with SAME padding, bf16 compute, f32 accumulation.

    For the DS2-style frontend H = time and W = frequency; SAME padding
    keeps output length = ceil(in_len / stride) (see
    ``encoder.output_lengths``).
    """
    # No preferred_element_type here: conv's transpose (grad) rule
    # requires operand/cotangent dtypes to match, so we keep the conv
    # uniformly in compute dtype and upcast after (the bf16 products
    # still accumulate in f32 inside the matrix unit).
    y = jax.lax.conv_general_dilated(
        x.astype(compute_dtype), params["w"].astype(compute_dtype),
        window_strides=tuple(strides), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return y.astype(jnp.float32) + params["b"]


def clipped_relu(x: jnp.ndarray, clip: float = 20.0) -> jnp.ndarray:
    """min(max(x, 0), clip) — the reference's frontend nonlinearity."""
    return jnp.clip(x, 0.0, clip)


def dropout(rng, x: jnp.ndarray, rate: float, train: bool) -> jnp.ndarray:
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = jax.random.bernoulli(rng, keep, x.shape)
    return jnp.where(mask, x / keep, 0.0).astype(x.dtype)


# ---------------------------------------------------------------------------
# Conv-as-matmul: the DS2 frontend convs have tiny channel counts (1 and
# 32). Reformulation: fold the FREQUENCY kernel into a dense banded
# matrix [F*cin -> f_out*cout] (one zero-padded shifted kernel copy per
# output-frequency column), which turns the 2-D conv into a 1-D TIME
# conv over wide channels (1280-wide for the DS2 shapes). More FLOPs on
# paper (F/kf overlap waste ~1.9x), but every product is a dense matmul
# and nothing replicates in device memory.
# Gradients flow through the pad/stack that builds the banded matrix.
# ---------------------------------------------------------------------------

def _same_pad(in_size: int, k: int, s: int):
    out = -(-in_size // s)
    total = max((out - 1) * s + k - in_size, 0)
    return out, total // 2, total - total // 2


def _band_matrices(w: jnp.ndarray, F: int, sf: int) -> jnp.ndarray:
    """[kt, kf, cin, cout] -> per-time-tap banded [kt, F*cin, f_out*cout]."""
    kt, kf, cin, cout = w.shape
    f_out, pf_lo, _pf_hi = _same_pad(F, kf, sf)
    cols = []
    for fo in range(f_out):
        lo = fo * sf - pf_lo
        k_lo = max(0, -lo)
        k_hi = min(kf, F - lo)
        wk = w[:, k_lo:k_hi]                          # [kt, keff, cin, cout]
        cols.append(jnp.pad(wk, ((0, 0), (lo + k_lo, F - (lo + k_hi)),
                                 (0, 0), (0, 0))))
    Wb = jnp.stack(cols, axis=3)                      # [kt, F, cin, fo, co]
    return Wb.reshape(kt, F * cin, f_out * cout)


def conv2d_matmul_apply(params: dict, x: jnp.ndarray, strides,
                        compute_dtype=jnp.bfloat16) -> jnp.ndarray:
    """Equivalent of conv2d_apply (NHWC, SAME) as a 1-D banded conv."""
    w = params["w"]                                   # [kt, kf, cin, cout]
    cout = w.shape[3]
    B, T, F, C = x.shape
    st, sf = strides
    Wb = _band_matrices(w, F, sf)                     # [kt, F*cin, fo*co]
    f_out = Wb.shape[2] // cout
    y = jax.lax.conv_general_dilated(
        x.reshape(B, T, F * C).astype(compute_dtype),
        Wb.astype(compute_dtype),
        window_strides=(st,), padding="SAME",
        dimension_numbers=("NHC", "HIO", "NHC"))
    t_out = y.shape[1]
    return y.astype(jnp.float32).reshape(B, t_out, f_out, cout) \
        + params["b"]


# ---------------------------------------------------------------------------
# Frequency-blocked banded conv.
#
# The full band matrix carries F/kf ~ 1.9x the true conv FLOPs. Blocking
# the OUTPUT frequency axis into groups of gfo columns (gfo*cout a
# multiple of 128) shrinks each block's contraction to its receptive slab
# (gin_f = (gfo-1)*sf + kf input rows), cutting the inflation to
# gin_f/kf ~ 1.2-1.3x while every matmul stays dense. The blocked dx
# pays overlapping-slab adds back in the backward pass.
# ---------------------------------------------------------------------------

def _pick_gfo(f_out: int, cout: int):
    """Smallest output-freq group with f_out % gfo == 0 and a full
    128-wide tile (gfo*cout % 128 == 0); None = no valid tiling."""
    for gfo in range(1, f_out + 1):
        if f_out % gfo == 0 and (gfo * cout) % 128 == 0:
            return gfo
    return None


def _blocked_bands(w: jnp.ndarray, F: int, sf: int, gfo: int):
    """Per-block slab starts + band matrices.

    Block g computes output freq columns [g*gfo, (g+1)*gfo) from input
    slab rows [starts[g], starts[g]+gin_f); starts are static ints."""
    kt, kf, cin, cout = w.shape
    f_out, pf_lo, _ = _same_pad(F, kf, sf)
    gin_f = min((gfo - 1) * sf + kf, F)
    Wb = _band_matrices(w, F, sf).reshape(kt, F, cin, f_out * cout)
    starts, mats = [], []
    for g in range(f_out // gfo):
        lo = g * gfo * sf - pf_lo
        s = max(0, min(lo, F - gin_f))
        starts.append(s)
        mats.append(Wb[:, s:s + gin_f, :,
                       g * gfo * cout:(g + 1) * gfo * cout]
                    .reshape(kt, gin_f * cin, gfo * cout))
    return starts, mats


def _conv_blocked_fwd_impl(w, b, x, strides, compute_dtype):
    kt, kf, cin, cout = w.shape
    B, T, F, C = x.shape
    st, sf = strides
    f_out, _, _ = _same_pad(F, kf, sf)
    gfo = _pick_gfo(f_out, cout)
    starts, mats = _blocked_bands(w, F, sf, gfo)
    gin_f = mats[0].shape[1] // cin
    xb = x.astype(compute_dtype)
    outs = []
    for s, Wg in zip(starts, mats):
        slab = xb[:, :, s:s + gin_f].reshape(B, T, gin_f * cin)
        outs.append(jax.lax.conv_general_dilated(
            slab, Wg.astype(compute_dtype),
            window_strides=(st,), padding="SAME",
            dimension_numbers=("NHC", "HIO", "NHC")))
    y = jnp.concatenate(outs, axis=-1)
    return y.astype(jnp.float32).reshape(B, y.shape[1], f_out, cout) + b


def conv2d_blocked_apply(params: dict, x: jnp.ndarray, strides,
                         compute_dtype=jnp.bfloat16) -> jnp.ndarray:
    """conv2d_matmul_apply with the blocked formulation where a
    128-lane output-freq tiling exists (falls back to fullband
    otherwise); gradients flow through the blocked form by autodiff."""
    kt, kf, cin, cout = params["w"].shape
    f_out, _, _ = _same_pad(x.shape[2], kf, strides[1])
    if _pick_gfo(f_out, cout) is None:
        return conv2d_matmul_apply(params, x, strides, compute_dtype)
    return _conv_blocked_fwd_impl(params["w"], params["b"], x,
                                  tuple(strides), compute_dtype)
