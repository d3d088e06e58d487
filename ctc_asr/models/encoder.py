"""DS1/DS2-style acoustic encoders.

Capability parity with the reference's ``asr/model.py`` graph builder
(SURVEY.md §2a): dense (DS1) or conv2d (DS2) frontend with clipped ReLU +
dropout, a multi-layer (bi)RNN stack, and a dense projection to the vocab.
Re-designed functional: ``init_params`` builds a pytree, ``apply_encoder``
is a pure function suitable for jit/pjit; all shapes static.

Signature contract (mirrors the reference's inference()/loss()/decode()
split, SURVEY.md §1 L3): apply_encoder returns *pre-softmax* logits
[B, T', C] plus logit_lengths [B]; CTC loss / decoding live in ops/.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import ModelConfig
from .layers import (clipped_relu, conv2d_apply, conv2d_blocked_apply,
                     conv2d_init, conv2d_matmul_apply, dense_apply,
                     dense_init, dropout)
from . import rnn as rnn_mod


def _cdiv(a, b):
    return -(-a // b)


def output_lengths(frame_lengths: jnp.ndarray, cfg: ModelConfig):
    """Map frontend input frame counts to encoder output lengths.

    The conv frontend uses SAME padding, so each stride-s conv maps
    length L -> ceil(L / s) on the time axis; the dense frontend is
    length-preserving.
    """
    lens = frame_lengths
    if cfg.frontend == "conv":
        for (st, _sf) in cfg.conv_strides:
            lens = _cdiv(lens, st)
    return lens.astype(jnp.int32)


def time_downsample_factor(cfg: ModelConfig) -> int:
    f = 1
    if cfg.frontend == "conv":
        for (st, _sf) in cfg.conv_strides:
            f *= st
    return f


def init_params(rng, cfg: ModelConfig, feat_dim: int) -> dict:
    """Build the parameter pytree for the configured encoder."""
    keys = iter(jax.random.split(rng, 64))
    params: dict = {}
    if cfg.frontend == "dense":
        layers = []
        d = feat_dim
        for _ in range(cfg.dense_layers):
            layers.append(dense_init(next(keys), d, cfg.dense_units))
            d = cfg.dense_units
        params["frontend"] = layers
        rnn_in = d
    elif cfg.frontend == "conv":
        convs = []
        cin = 1
        f = feat_dim
        for ch, (kt, kf), (st, sf) in zip(cfg.conv_channels,
                                          cfg.conv_kernels,
                                          cfg.conv_strides):
            convs.append(conv2d_init(next(keys), kt, kf, cin, ch))
            cin = ch
            f = _cdiv(f, sf)
        params["frontend"] = convs
        rnn_in = f * cin
    else:
        raise ValueError(f"unknown frontend {cfg.frontend!r}")

    init_fn = {"lstm": rnn_mod.lstm_init, "gru": rnn_mod.gru_init,
               "rnn": rnn_mod.vanilla_init}[cfg.rnn_type]
    stack = []
    d = rnn_in
    for _ in range(cfg.rnn_layers):
        if cfg.bidirectional:
            stack.append({"fwd": init_fn(next(keys), d, cfg.rnn_units),
                          "bwd": init_fn(next(keys), d, cfg.rnn_units)})
            d = 2 * cfg.rnn_units
        else:
            stack.append(init_fn(next(keys), d, cfg.rnn_units))
            d = cfg.rnn_units
    params["rnn"] = stack
    params["head"] = dense_init(next(keys), d, cfg.num_classes)
    return params


def apply_encoder(params: dict, feats: jnp.ndarray,
                  frame_lengths: jnp.ndarray, cfg: ModelConfig,
                  train: bool = False, dropout_rng=None):
    """feats [B, T, F], frame_lengths [B] -> (logits [B, T', C], lens [B]).

    ``train`` must be a static (Python) bool; dropout_rng is required when
    train and cfg.dropout > 0.
    """
    cdt = jnp.dtype(cfg.compute_dtype)
    B, T, F = feats.shape
    rngs = iter(jax.random.split(dropout_rng, 32)) if dropout_rng is not None \
        else iter([None] * 32)

    if cfg.frontend == "dense":
        x = feats
        for layer in params["frontend"]:
            x = dense_apply(layer, x, cdt)
            x = clipped_relu(x, cfg.relu_clip)
            if train:
                x = dropout(next(rngs), x, cfg.dropout, train)
        out_lens = frame_lengths.astype(jnp.int32)
    else:  # conv
        if cfg.conv_as_matmul:
            conv_fn = (conv2d_blocked_apply if cfg.conv_blocked_fwd
                       else conv2d_matmul_apply)
        else:
            conv_fn = conv2d_apply
        x = feats[..., None]                       # [B, T, F, 1] NHWC
        for layer, strides in zip(params["frontend"], cfg.conv_strides):
            x = conv_fn(layer, x, strides, cdt)
            x = clipped_relu(x, cfg.relu_clip)
            if train:
                x = dropout(next(rngs), x, cfg.dropout, train)
        Bc, Tc, Fc, Cc = x.shape
        x = x.reshape(Bc, Tc, Fc * Cc)
        out_lens = output_lengths(frame_lengths, cfg)

    # Mask frontend output beyond valid length (conv SAME padding smears
    # energy into pad frames; zero it so the RNN mask semantics hold).
    Tp = x.shape[1]
    vmask = (jnp.arange(Tp)[None, :] < out_lens[:, None])[..., None]
    x = x * vmask.astype(x.dtype)

    x = jnp.swapaxes(x, 0, 1)                      # [T', B, D] time-major
    for layer in params["rnn"]:
        def body(layer, inp, rng_key):
            if cfg.bidirectional:
                y = rnn_mod.birnn_apply(layer, inp, out_lens,
                                        cfg.rnn_type, cdt)
            else:
                y = rnn_mod.rnn_apply(layer, inp, out_lens,
                                      cfg.rnn_type, cdt)
            if train:
                y = dropout(rng_key, y, cfg.dropout, train)
            return y

        fn = jax.checkpoint(body) if cfg.remat else body
        x = fn(layer, x, next(rngs))
    logits = dense_apply(params["head"], x, cdt)   # [T', B, C] f32
    logits = jnp.swapaxes(logits, 0, 1)            # [B, T', C]
    return logits, out_lens
