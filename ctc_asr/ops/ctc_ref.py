"""CTC loss — pure-JAX log-space forward DP (lax.scan over time).

Replaces ``tf.nn.ctc_loss`` (the reference's C++/CUDA forward-backward
kernel, SURVEY.md §2b row 1). This is the numerically-trusted reference
implementation; gradients come from autodiff through the scan. On CUDA,
``ctc_loss`` runs the α/β kernel with an explicit custom VJP from
``ctc_triton.py`` instead, which is parity-tested against this module.

Conventions (match the TF semantics the reference relied on):
- ``logits`` are pre-softmax, [B, T, C]; blank is the LAST class.
- ``labels`` [B, U] contain ids in [0, C-1) padded with any value
  (padding beyond ``label_lengths`` is ignored).
- Returns the per-utterance negative log likelihood (total, not
  per-frame); infeasible alignments (label too long for the available
  frames) return +inf, as in TF.

Edge cases covered by tests (SURVEY.md §4.1): empty label, U == T,
repeated characters (mandatory blank between equal labels), all-blank,
U > T infeasibility, padding invariance in both T and U.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..text import BLANK_ID

# Large-but-finite negative for log-space masking: keeps -inf out of
# arithmetic (inf - inf = nan would poison grads) while acting as -inf
# under logaddexp at f32 precision.
NEG_INF = -1.0e30


def extended_labels(labels: jnp.ndarray, blank_id: int) -> jnp.ndarray:
    """[B, U] labels -> [B, 2U+1] blank-interleaved extended sequence
    (blank, l1, blank, l2, ..., blank)."""
    B, U = labels.shape
    z = jnp.full((B, 2 * U + 1), blank_id, dtype=labels.dtype)
    return z.at[:, 1::2].set(labels)


def ctc_loss_ref(logits: jnp.ndarray, logit_lengths: jnp.ndarray,
                 labels: jnp.ndarray, label_lengths: jnp.ndarray,
                 blank_id: int = BLANK_ID,
                 dtype=jnp.float32) -> jnp.ndarray:
    """Per-utterance CTC negative log likelihood, shape [B], in ``dtype``
    (float32; float64 under ``jax.enable_x64`` gives the yardstick the
    float32 implementations are held to)."""
    logits = logits.astype(dtype)
    B, T, C = logits.shape
    U = labels.shape[1]
    S = 2 * U + 1

    log_probs = jax.nn.log_softmax(logits, axis=-1)       # [B, T, C]
    z = extended_labels(labels, blank_id)                  # [B, S]

    # Static per-state transition structure.
    s_idx = jnp.arange(S)[None, :]                         # [1, S]
    is_label_state = (s_idx % 2) == 1
    z_prev2 = jnp.concatenate(
        [jnp.full((B, 2), blank_id, z.dtype), z[:, :-2]], axis=1)
    # Skip transition s-2 -> s allowed iff label state and z[s] != z[s-2].
    can_skip = is_label_state & (z != z_prev2) & (s_idx >= 2)  # [B, S]

    # Emission log-probs per (t, state): gather along class axis.
    # Time-major for the scan: [T, B, S].
    lp_z = jnp.take_along_axis(
        log_probs, z[:, None, :].astype(jnp.int32), axis=2)  # [B, T, S]
    lp_z = jnp.moveaxis(lp_z, 1, 0)

    # Init: alpha_0 = lp(0, blank) at s=0, lp(0, l1) at s=1.
    alpha0 = jnp.full((B, S), NEG_INF, dtype)
    alpha0 = alpha0.at[:, 0].set(lp_z[0, :, 0])
    if S > 1:
        alpha0 = alpha0.at[:, 1].set(lp_z[0, :, 1])
    # An empty label (U_b == 0) has no state 1: mask it.
    alpha0 = jnp.where((label_lengths[:, None] == 0) & (s_idx == 1),
                       NEG_INF, alpha0)

    def shift1(a):
        return jnp.concatenate([jnp.full((B, 1), NEG_INF, a.dtype),
                                a[:, :-1]], axis=1)

    def shift2(a):
        return jnp.concatenate([jnp.full((B, 2), NEG_INF, a.dtype),
                                a[:, :-2]], axis=1)

    def step(alpha, inp):
        lp_t, t = inp
        stay = alpha
        diag = shift1(alpha)
        skip = jnp.where(can_skip, shift2(alpha), NEG_INF)
        m = jnp.maximum(jnp.maximum(stay, diag), skip)
        m_safe = jnp.maximum(m, NEG_INF)
        summed = (jnp.exp(stay - m_safe) + jnp.exp(diag - m_safe)
                  + jnp.exp(skip - m_safe))
        new_alpha = m_safe + jnp.log(summed) + lp_t
        new_alpha = jnp.maximum(new_alpha, NEG_INF)  # clamp underflow
        # Frames at/after a sequence's length carry alpha unchanged.
        valid_t = (t < logit_lengths)[:, None]
        return jnp.where(valid_t, new_alpha, alpha), None

    ts = jnp.arange(1, T)
    alpha_final, _ = jax.lax.scan(step, alpha0, (lp_z[1:], ts)) \
        if T > 1 else (alpha0, None)

    # Final states: s = 2*U_b (last blank) and s = 2*U_b - 1 (last label).
    end = 2 * label_lengths                                # [B]
    a_end = jnp.take_along_axis(alpha_final, end[:, None], axis=1)[:, 0]
    a_end1 = jnp.take_along_axis(
        alpha_final, jnp.maximum(end - 1, 0)[:, None], axis=1)[:, 0]
    a_end1 = jnp.where(label_lengths > 0, a_end1, NEG_INF)
    m = jnp.maximum(a_end, a_end1)
    total = m + jnp.log(jnp.exp(a_end - m) + jnp.exp(a_end1 - m))
    nll = -total
    # Infeasible (likelihood underflowed to our -inf sentinel) -> +inf.
    return jnp.where(total <= NEG_INF / 2, jnp.inf, nll)


def ctc_nll(logits: jnp.ndarray, logit_lengths: jnp.ndarray,
            labels: jnp.ndarray, label_lengths: jnp.ndarray,
            blank_id: int = BLANK_ID) -> jnp.ndarray:
    """Per-utterance CTC NLL [B], chosen by platform when lowered: the
    Triton kernel (ctc_triton.py) on CUDA, ``ctc_loss_ref`` elsewhere."""
    from .ctc_triton import ctc_loss_triton
    return jax.lax.platform_dependent(
        logits, logit_lengths, labels, label_lengths,
        cuda=functools.partial(ctc_loss_triton, blank_id=blank_id),
        default=functools.partial(ctc_loss_ref, blank_id=blank_id))


def ctc_loss(logits: jnp.ndarray, logit_lengths: jnp.ndarray,
             labels: jnp.ndarray, label_lengths: jnp.ndarray,
             blank_id: int = BLANK_ID,
             average: str = "utterance", nll_fn=None) -> jnp.ndarray:
    """Batch-reduced CTC loss for training.

    average: "utterance" (mean NLL per utterance — TF/reference behavior),
    "label" (NLL normalized by label length, then meaned), or "sum".
    Infeasible utterances contribute 0 (masked) rather than inf so one
    pathological sample can't destroy a training step. ``nll_fn`` pins
    the per-utterance NLL (``ctc_loss_ref`` or the Triton kernel) where
    a caller compares the two; by default ``ctc_nll`` chooses by platform.
    """
    nll = (nll_fn or ctc_nll)(logits, logit_lengths, labels,
                              label_lengths, blank_id=blank_id)
    finite = jnp.isfinite(nll)
    nll = jnp.where(finite, nll, 0.0)
    n = jnp.maximum(jnp.sum(finite.astype(jnp.float32)), 1.0)
    if average == "utterance":
        return jnp.sum(nll) / n
    if average == "label":
        per = nll / jnp.maximum(label_lengths.astype(jnp.float32), 1.0)
        return jnp.sum(per) / n
    if average == "sum":
        return jnp.sum(nll)
    raise ValueError(f"unknown average mode {average!r}")
