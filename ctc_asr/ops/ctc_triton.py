"""CTC forward-backward (α/β) as a Pallas kernel through Triton, with a
custom VJP.

The plain version (``ctc_ref.ctc_loss_ref``) is autodiff through a
``lax.scan`` over time: on a GPU each of its T steps, forward and
backward, is a chain of small kernel launches. This kernel keeps the
whole time loop inside one program per utterance.

- Boundary: XLA computes ``log_softmax`` and the label gather
  ``lp_z[b, t, s] = log_probs[b, t, z_s]`` (and their gradients by
  autodiff). The custom VJP wraps only the sequential DP; its backward
  emits the posterior gradient
  ``d(-logP)/d lp_z[t, s] = -exp(α_t(s) + β_t(s) - logP)``.
- Grid: one program per utterance. The time recursion is a
  ``fori_loop`` inside the program, bounded by the utterance's own
  length, so bucket padding costs no steps.
- The extended-label axis S pads to a power of two (Triton's block
  rule). The α recursion needs the row shifted by one and two states,
  and Triton has no lane shift: each step stores the row into a
  per-utterance scratch row at an offset, waits at a block barrier, and
  loads it back at the shifted offsets. Guard cells of the scratch row
  hold the NEG sentinel, which is what a shift brings in.
- All log-space arithmetic uses the finite NEG sentinel of
  ``ctc_ref.py`` and a max-clamped log-sum-exp, so nothing computes
  ``inf - inf``.

``interpret=True`` runs the same kernels on the CPU (the barrier is a
no-op there, since the interpreter runs one program at a time).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..text import BLANK_ID
from .ctc_ref import NEG_INF, extended_labels

_COMPILER_PARAMS = plgpu.CompilerParams(num_warps=1, num_stages=1)


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _barrier(interpret: bool) -> None:
    if not interpret:
        plgpu.debug_barrier()


def _lse3(a, b, c):
    m = jnp.maximum(jnp.maximum(a, b), jnp.maximum(c, NEG_INF))
    out = m + jnp.log(jnp.exp(a - m) + jnp.exp(b - m) + jnp.exp(c - m))
    return jnp.maximum(out, NEG_INF)


def _end_mask(lane, end):
    """Final states of the lattice: s = 2U (last blank) and s = 2U - 1
    (last label, absent for the empty label)."""
    return (lane == end) | ((lane == end - 1) & (end > 0))


# ---------------------------------------------------------------------------
# Forward (alpha) kernel
# ---------------------------------------------------------------------------

def _alpha_kernel(lpz_ref, skip_ref, len_ref, end_ref,
                  alphas_ref, nll_ref, buf_ref, *, interpret):
    """One utterance. lpz/alphas [T, S]; skip/nll [S]; len/end [1];
    buf [2S] scratch: cells [0, 2) stay NEG, the row lives at [2, S+2),
    so loads at offsets 1 and 0 read it shifted right by 1 and 2."""
    S = skip_ref.shape[0]
    n = len_ref[0]
    end = end_ref[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (S,), 0)
    can_skip = skip_ref[...] > 0.5
    buf_ref[pl.ds(0, S)] = jnp.full((S,), NEG_INF, jnp.float32)

    lp0 = lpz_ref[0, :]
    alpha0 = jnp.where((lane == 0) | ((lane == 1) & (end > 0)), lp0,
                       NEG_INF)
    alphas_ref[0, :] = alpha0

    def step(t, alpha):
        _barrier(interpret)
        buf_ref[pl.ds(2, S)] = alpha
        _barrier(interpret)
        diag = buf_ref[pl.ds(1, S)]
        skip = jnp.where(can_skip, buf_ref[pl.ds(0, S)], NEG_INF)
        new = _lse3(alpha, diag, skip) + lpz_ref[t, :]
        new = jnp.maximum(new, NEG_INF)
        alphas_ref[t, :] = new
        return new

    alpha = jax.lax.fori_loop(1, n, step, alpha0)
    sel = jnp.where(_end_mask(lane, end), alpha, NEG_INF)
    m = jnp.maximum(jnp.max(sel), NEG_INF)
    total = jnp.maximum(m + jnp.log(jnp.sum(jnp.exp(sel - m))), NEG_INF)
    nll_ref[...] = jnp.full((S,), -total, jnp.float32)


# ---------------------------------------------------------------------------
# Backward (beta + gradient) kernel
# ---------------------------------------------------------------------------

def _beta_kernel(lpz_ref, alphas_ref, skipn_ref, len_ref, end_ref,
                 nll_ref, grad_ref, buf_ref, *, interpret):
    """One utterance, time reversed. skipn[s] = can_skip[s+2] (the
    s -> s+2 transition); buf [2S] scratch: the row lives at [0, S),
    cells [S, 2S) stay NEG, so loads at offsets 1 and 2 read it shifted
    left by 1 and 2. Writes grad [T, S], zero past the length."""
    T = lpz_ref.shape[0]
    S = skipn_ref.shape[0]
    n = len_ref[0]
    end = end_ref[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (S,), 0)
    can_skip = skipn_ref[...] > 0.5
    logp = -nll_ref[...]
    buf_ref[pl.ds(S, S)] = jnp.full((S,), NEG_INF, jnp.float32)
    zeros = jnp.zeros((S,), jnp.float32)

    def pad_rows(t, carry):
        grad_ref[t, :] = zeros
        return carry

    jax.lax.fori_loop(jnp.maximum(n, 0), T, pad_rows, 0)

    def grad_row(t, beta):
        g = -jnp.exp(jnp.maximum(alphas_ref[t, :] + beta, NEG_INF) - logp)
        grad_ref[t, :] = g

    def step(i, beta):
        t = n - 2 - i
        x = jnp.maximum(lpz_ref[t + 1, :] + beta, NEG_INF)
        _barrier(interpret)
        buf_ref[pl.ds(0, S)] = x
        _barrier(interpret)
        diag = buf_ref[pl.ds(1, S)]
        skip = jnp.where(can_skip, buf_ref[pl.ds(2, S)], NEG_INF)
        new = _lse3(x, diag, skip)
        grad_row(t, new)
        return new

    @pl.when(n > 0)
    def _():
        beta_last = jnp.where(_end_mask(lane, end), 0.0, NEG_INF)
        grad_row(n - 1, beta_last)
        jax.lax.fori_loop(0, n - 1, step, beta_last)


# ---------------------------------------------------------------------------
# Host-side wrappers
# ---------------------------------------------------------------------------

def _row_spec(S):
    return pl.BlockSpec((None, S), lambda b: (b, 0))


def _seq_spec(T, S):
    return pl.BlockSpec((None, T, S), lambda b: (b, 0, 0))


def _scalar_spec():
    return pl.BlockSpec((None, 1), lambda b: (b, 0))


def _run_alpha(lpz, skip, lens, ends, interpret):
    B, T, S = lpz.shape
    alphas, nll, _ = pl.pallas_call(
        functools.partial(_alpha_kernel, interpret=interpret),
        grid=(B,),
        in_specs=[_seq_spec(T, S), _row_spec(S), _scalar_spec(),
                  _scalar_spec()],
        out_specs=[_seq_spec(T, S), _row_spec(S), _row_spec(2 * S)],
        out_shape=[jax.ShapeDtypeStruct((B, T, S), jnp.float32),
                   jax.ShapeDtypeStruct((B, S), jnp.float32),
                   jax.ShapeDtypeStruct((B, 2 * S), jnp.float32)],
        backend="triton",
        compiler_params=_COMPILER_PARAMS,
        interpret=interpret,
        name="ctc_alpha",
    )(lpz, skip, lens, ends)
    return alphas, nll


def _run_beta(lpz, alphas, skipn, lens, ends, nll, interpret):
    B, T, S = lpz.shape
    grad, _ = pl.pallas_call(
        functools.partial(_beta_kernel, interpret=interpret),
        grid=(B,),
        in_specs=[_seq_spec(T, S), _seq_spec(T, S), _row_spec(S),
                  _scalar_spec(), _scalar_spec(), _row_spec(S)],
        out_specs=[_seq_spec(T, S), _row_spec(2 * S)],
        out_shape=[jax.ShapeDtypeStruct((B, T, S), jnp.float32),
                   jax.ShapeDtypeStruct((B, 2 * S), jnp.float32)],
        backend="triton",
        compiler_params=_COMPILER_PARAMS,
        interpret=interpret,
        name="ctc_beta",
    )(lpz, alphas, skipn, lens, ends, nll)
    return grad


@functools.partial(jax.custom_vjp, nondiff_argnums=(4,))
def _ctc_nll(lpz, can_skip, lens, ends, interpret=False):
    return _ctc_nll_fwd(lpz, can_skip, lens, ends, interpret)[0]


def _ctc_nll_fwd(lpz, can_skip, lens, ends, interpret=False):
    alphas, nll = _run_alpha(lpz, can_skip, lens, ends, interpret)
    return nll[:, 0], (lpz, alphas, can_skip, lens, ends, nll)


def _ctc_nll_bwd(interpret, res, g):
    lpz, alphas, can_skip, lens, ends, nll = res
    S = can_skip.shape[1]
    skipn = jnp.pad(can_skip[:, 2:], ((0, 0), (0, 2)))
    grad = _run_beta(lpz, alphas, skipn, lens, ends, nll, interpret)
    zero_int = np.zeros(lens.shape, jax.dtypes.float0)
    return (grad * g[:, None, None], jnp.zeros_like(can_skip),
            zero_int, zero_int)


_ctc_nll.defvjp(_ctc_nll_fwd, _ctc_nll_bwd)


def ctc_loss_triton(logits: jnp.ndarray, logit_lengths: jnp.ndarray,
                    labels: jnp.ndarray, label_lengths: jnp.ndarray,
                    blank_id: int = BLANK_ID,
                    interpret: bool = False) -> jnp.ndarray:
    """Per-utterance CTC NLL [B]; same contract as
    ``ctc_ref.ctc_loss_ref`` (infeasible -> +inf)."""
    logits = logits.astype(jnp.float32)
    B, T, C = logits.shape
    U = labels.shape[1]
    S = 2 * U + 1
    Sp = max(_pow2(S), 16)
    log_probs = jax.nn.log_softmax(logits, axis=-1)
    z = extended_labels(labels, blank_id)                   # [B, S]
    lp_z = jnp.take_along_axis(log_probs, z[:, None, :].astype(jnp.int32),
                               axis=2)                       # [B, T, S]
    lp_z = jnp.pad(lp_z, ((0, 0), (0, 0), (0, Sp - S)),
                   constant_values=NEG_INF)

    s_idx = jnp.arange(S)[None, :]
    z_prev2 = jnp.concatenate(
        [jnp.full((B, 2), blank_id, z.dtype), z[:, :-2]], axis=1)
    can_skip = (((s_idx % 2) == 1) & (z != z_prev2) & (s_idx >= 2)
                ).astype(jnp.float32)
    can_skip = jnp.pad(can_skip, ((0, 0), (0, Sp - S)))

    lens = jnp.minimum(logit_lengths.astype(jnp.int32), T).reshape(B, 1)
    ends = (2 * label_lengths).astype(jnp.int32).reshape(B, 1)
    nll = _ctc_nll(lp_z, can_skip, lens, ends, interpret)
    # infeasible -> +inf (parity with ctc_ref)
    return jnp.where(nll >= -NEG_INF / 2, jnp.inf, nll)
