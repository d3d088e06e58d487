import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ctc_asr.ops.ctc_ref import ctc_loss, ctc_loss_ref
from ctc_asr.text import BLANK_ID


def oracle_ctc_nll(log_probs, label, blank):
    """Slow numpy forward DP for one utterance. log_probs [T, C]."""
    T, C = log_probs.shape
    z = [blank]
    for l in label:
        z += [l, blank]
    S = len(z)
    alpha = np.full((T, S), -np.inf)
    alpha[0, 0] = log_probs[0, blank]
    if S > 1:
        alpha[0, 1] = log_probs[0, z[1]]
    for t in range(1, T):
        for s in range(S):
            cands = [alpha[t - 1, s]]
            if s >= 1:
                cands.append(alpha[t - 1, s - 1])
            if s >= 2 and z[s] != blank and z[s] != z[s - 2]:
                cands.append(alpha[t - 1, s - 2])
            m = max(cands)
            if m == -np.inf:
                alpha[t, s] = -np.inf
            else:
                alpha[t, s] = m + np.log(sum(np.exp(c - m) for c in cands)) \
                    + log_probs[t, z[s]]
    ends = [alpha[T - 1, S - 1]]
    if S > 1:
        ends.append(alpha[T - 1, S - 2])
    m = max(ends)
    if m == -np.inf:
        return np.inf
    return -(m + np.log(sum(np.exp(e - m) for e in ends)))


def _random_case(rng, B, T, C, U):
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    labels = rng.integers(0, C - 1, size=(B, U)).astype(np.int32)
    return logits, labels


def test_matches_oracle_random():
    rng = np.random.default_rng(0)
    B, T, C, U = 4, 12, 6, 4
    blank = C - 1
    logits, labels = _random_case(rng, B, T, C, U)
    logit_lens = np.array([12, 10, 7, 12], np.int32)
    label_lens = np.array([4, 3, 2, 1], np.int32)
    nll = np.asarray(ctc_loss_ref(jnp.asarray(logits), jnp.asarray(logit_lens),
                                  jnp.asarray(labels), jnp.asarray(label_lens),
                                  blank_id=blank))
    for b in range(B):
        lp = jax.nn.log_softmax(jnp.asarray(logits[b, :logit_lens[b]]), -1)
        want = oracle_ctc_nll(np.asarray(lp), labels[b, :label_lens[b]], blank)
        np.testing.assert_allclose(nll[b], want, rtol=1e-4, atol=1e-4)


def test_repeated_labels_oracle():
    """Repeats force mandatory blanks: z[s]==z[s-2] disables skip."""
    rng = np.random.default_rng(1)
    B, T, C = 2, 10, 5
    blank = C - 1
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    labels = np.array([[2, 2, 2], [1, 1, 3]], np.int32)
    lens = np.array([T, T], np.int32)
    llens = np.array([3, 3], np.int32)
    nll = np.asarray(ctc_loss_ref(jnp.asarray(logits), jnp.asarray(lens),
                                  jnp.asarray(labels), jnp.asarray(llens),
                                  blank_id=blank))
    for b in range(B):
        lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits[b]), -1))
        want = oracle_ctc_nll(lp, labels[b], blank)
        np.testing.assert_allclose(nll[b], want, rtol=1e-4, atol=1e-4)


def test_empty_label():
    """U=0: the only path is all-blank; nll = -sum log p(blank)."""
    rng = np.random.default_rng(2)
    T, C = 6, 4
    logits = rng.standard_normal((1, T, C)).astype(np.float32)
    labels = np.zeros((1, 3), np.int32)
    nll = ctc_loss_ref(jnp.asarray(logits), jnp.asarray([T]),
                       jnp.asarray(labels), jnp.asarray([0]),
                       blank_id=C - 1)
    lp = jax.nn.log_softmax(jnp.asarray(logits[0]), -1)
    want = -float(jnp.sum(lp[:, C - 1]))
    np.testing.assert_allclose(float(nll[0]), want, rtol=1e-5)


def test_label_len_equals_T():
    """U == T leaves no room for blanks: single forced path."""
    rng = np.random.default_rng(3)
    T, C = 4, 5
    logits = rng.standard_normal((1, T, C)).astype(np.float32)
    labels = np.array([[0, 1, 2, 3]], np.int32)  # distinct, U == T
    nll = ctc_loss_ref(jnp.asarray(logits), jnp.asarray([T]),
                       jnp.asarray(labels), jnp.asarray([4]), blank_id=C - 1)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits[0]), -1))
    want = -sum(lp[t, labels[0, t]] for t in range(T))
    np.testing.assert_allclose(float(nll[0]), want, rtol=1e-4)


def test_infeasible_inf():
    """U > T (or repeats needing blanks beyond T) -> +inf."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 3, 5)).astype(np.float32)
    labels = np.array([[0, 1, 2, 3], [1, 1, 0, 0]], np.int32)
    nll = ctc_loss_ref(jnp.asarray(logits), jnp.asarray([3, 3]),
                       jnp.asarray(labels), jnp.asarray([4, 4]),
                       blank_id=4)
    assert np.isinf(np.asarray(nll)).all()


def test_padding_invariance():
    """Extra T padding and U padding must not change the loss."""
    rng = np.random.default_rng(5)
    logits, labels = _random_case(rng, 2, 8, 6, 3)
    lens = np.array([8, 6], np.int32)
    llens = np.array([3, 2], np.int32)
    base = np.asarray(ctc_loss_ref(jnp.asarray(logits), jnp.asarray(lens),
                                   jnp.asarray(labels), jnp.asarray(llens)
                                   if False else jnp.asarray(llens),
                                   blank_id=5))
    # pad T with garbage
    pad_t = np.concatenate([logits,
                            rng.standard_normal((2, 5, 6)).astype(np.float32)],
                           axis=1)
    # pad U with garbage ids
    pad_u = np.concatenate([labels,
                            rng.integers(0, 5, (2, 4)).astype(np.int32)],
                           axis=1)
    out = np.asarray(ctc_loss_ref(jnp.asarray(pad_t), jnp.asarray(lens),
                                  jnp.asarray(pad_u), jnp.asarray(llens),
                                  blank_id=5))
    np.testing.assert_allclose(out, base, rtol=1e-4, atol=1e-5)


def test_finite_difference_grad():
    rng = np.random.default_rng(6)
    B, T, C, U = 2, 6, 4, 2
    logits, labels = _random_case(rng, B, T, C, U)
    lens = np.array([6, 5], np.int32)
    llens = np.array([2, 2], np.int32)

    def f(lg):
        return jnp.sum(ctc_loss_ref(lg, jnp.asarray(lens),
                                    jnp.asarray(labels), jnp.asarray(llens),
                                    blank_id=C - 1))

    g = np.asarray(jax.grad(f)(jnp.asarray(logits)))
    eps = 1e-3
    rngc = np.random.default_rng(7)
    for _ in range(12):
        b, t, c = (rngc.integers(B), rngc.integers(T), rngc.integers(C))
        lp = logits.copy(); lp[b, t, c] += eps
        lm = logits.copy(); lm[b, t, c] -= eps
        fd = (float(f(jnp.asarray(lp))) - float(f(jnp.asarray(lm)))) / (2 * eps)
        np.testing.assert_allclose(g[b, t, c], fd, rtol=2e-2, atol=2e-3)


def test_grad_zero_beyond_length():
    rng = np.random.default_rng(8)
    logits, labels = _random_case(rng, 1, 8, 5, 2)
    lens = np.array([5], np.int32)
    llens = np.array([2], np.int32)

    g = np.asarray(jax.grad(lambda lg: jnp.sum(
        ctc_loss_ref(lg, jnp.asarray(lens), jnp.asarray(labels),
                     jnp.asarray(llens), blank_id=4)))(jnp.asarray(logits)))
    assert np.allclose(g[0, 5:], 0.0)
    assert not np.allclose(g[0, :5], 0.0)


def test_batch_loss_masks_infeasible():
    rng = np.random.default_rng(9)
    logits, labels = _random_case(rng, 2, 3, 5, 3)
    lens = np.array([3, 3], np.int32)
    llens = np.array([3, 3], np.int32)
    labels[0] = [1, 1, 1]  # infeasible: needs T >= 5
    labels[1] = [0, 1, 2]  # feasible
    loss = float(ctc_loss(jnp.asarray(logits), jnp.asarray(lens),
                          jnp.asarray(labels), jnp.asarray(llens),
                          blank_id=4))
    per = np.asarray(ctc_loss_ref(jnp.asarray(logits), jnp.asarray(lens),
                                  jnp.asarray(labels), jnp.asarray(llens),
                                  blank_id=4))
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, per[1], rtol=1e-5)


def test_blank_is_last_class():
    assert BLANK_ID == 28
