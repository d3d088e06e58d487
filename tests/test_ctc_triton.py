"""Triton CTC kernel vs the pure-JAX reference (SURVEY.md §4.1: "kernel
vs pure-JAX reference for every kernel"). Interpret mode keeps these
CPU-runnable; chip_smoke.py's ``ctc_parity`` runs the kernel compiled
for the card."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import functools

from ctc_asr.ops.ctc_triton import ctc_loss_triton
from ctc_asr.ops.ctc_ref import ctc_loss_ref


_kernel = functools.partial(ctc_loss_triton, interpret=True)


def _case(rng, B, T, C, U, full_lens=False):
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    labels = rng.integers(0, C - 1, size=(B, U)).astype(np.int32)
    if full_lens:
        lens = np.full((B,), T, np.int32)
        llens = np.full((B,), U, np.int32)
    else:
        lens = rng.integers(max(1, T // 2), T + 1, B).astype(np.int32)
        llens = rng.integers(1, U + 1, B).astype(np.int32)
    return (jnp.asarray(logits), jnp.asarray(lens), jnp.asarray(labels),
            jnp.asarray(llens))


@pytest.mark.parametrize("seed,B,T,C,U", [
    (0, 3, 12, 6, 4),
    (1, 8, 20, 29, 6),     # full charset
    (2, 5, 30, 29, 10),    # B not a multiple of 8 (padding path)
    (3, 9, 16, 10, 3),     # B > 8 (two tiles)
])
def test_forward_parity(seed, B, T, C, U):
    rng = np.random.default_rng(seed)
    args = _case(rng, B, T, C, U)
    want = np.asarray(ctc_loss_ref(*args, blank_id=C - 1))
    got = np.asarray(_kernel(*args, blank_id=C - 1))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_forward_parity_edge_cases():
    rng = np.random.default_rng(4)
    C, T = 6, 10
    logits = jnp.asarray(rng.standard_normal((4, T, C)).astype(np.float32))
    labels = jnp.asarray(np.array([
        [1, 1, 1, 0],     # repeats (mandatory blanks)
        [2, 3, 4, 1],     # distinct
        [0, 0, 0, 0],     # will use label_len=0 (empty)
        [1, 2, 1, 2],     # alternating
    ], np.int32))
    lens = jnp.asarray([T, 5, T, 4])
    llens = jnp.asarray([3, 4, 0, 4])
    want = np.asarray(ctc_loss_ref(logits, lens, labels, llens,
                                   blank_id=C - 1))
    got = np.asarray(_kernel(logits, lens, labels, llens,
                                     blank_id=C - 1))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_infeasible_inf():
    rng = np.random.default_rng(5)
    logits = jnp.asarray(rng.standard_normal((2, 3, 5)).astype(np.float32))
    labels = jnp.asarray(np.array([[0, 1, 2, 3], [1, 1, 0, 0]], np.int32))
    got = np.asarray(_kernel(logits, jnp.asarray([3, 3]), labels,
                                     jnp.asarray([4, 4]), blank_id=4))
    assert np.isinf(got).all()


@pytest.mark.parametrize("seed,B,T,C,U", [(6, 2, 8, 5, 3), (7, 8, 14, 29, 5)])
def test_gradient_parity(seed, B, T, C, U):
    """Kernel's custom-VJP gradient == autodiff through the reference."""
    rng = np.random.default_rng(seed)
    logits, lens, labels, llens = _case(rng, B, T, C, U)

    def loss_ref(lg):
        return jnp.sum(ctc_loss_ref(lg, lens, labels, llens,
                                    blank_id=C - 1))

    def loss_pal(lg):
        return jnp.sum(_kernel(lg, lens, labels, llens,
                                       blank_id=C - 1))

    g_ref = np.asarray(jax.grad(loss_ref)(logits))
    g_pal = np.asarray(jax.grad(loss_pal)(logits))
    np.testing.assert_allclose(g_pal, g_ref, rtol=1e-3, atol=1e-4)


def test_gradient_weighted_cotangent():
    """Per-sample cotangent scaling flows through the custom VJP."""
    rng = np.random.default_rng(8)
    logits, lens, labels, llens = _case(rng, 3, 10, 6, 3)
    w = jnp.asarray([0.5, 2.0, 0.0])

    def weighted(fn):
        def f(lg):
            return jnp.sum(w * fn(lg, lens, labels, llens, blank_id=5))
        return f

    from functools import partial
    g_ref = np.asarray(jax.grad(weighted(ctc_loss_ref))(logits))
    g_pal = np.asarray(jax.grad(weighted(
        partial(_kernel)))(logits))
    np.testing.assert_allclose(g_pal, g_ref, rtol=1e-3, atol=1e-4)
    # zero-weight sample gets exactly zero grad
    assert np.allclose(g_pal[2], 0.0)


def test_grad_zero_beyond_length():
    rng = np.random.default_rng(9)
    logits, _, labels, llens = _case(rng, 2, 12, 6, 3, full_lens=True)
    lens = jnp.asarray([7, 12])
    g = np.asarray(jax.grad(lambda lg: jnp.sum(_kernel(
        lg, lens, labels, llens, blank_id=5)))(logits))
    assert np.allclose(g[0, 7:], 0.0)
    assert not np.allclose(g[0, :7], 0.0)


def _lowered_kernels(platform, B=4, T=50, C=29, U=10, **kw):
    from ctc_asr.ops.ctc_ref import ctc_loss
    args = _case(np.random.default_rng(10), B, T, C, U)
    f = jax.jit(jax.value_and_grad(lambda lg: ctc_loss(lg, *args[1:], **kw)))
    txt = f.trace(args[0]).lower(lowering_platforms=(platform,)).as_text()
    return txt.count("custom_call @__gpu$xla.gpu.triton")


def test_ctc_loss_picks_kernel_by_platform():
    """ctc_loss lowers to the two Triton kernels (alpha forward, beta
    backward) for CUDA and to the scan reference for the CPU — chosen
    when lowered, with no switch. Lowering for CUDA also runs the
    kernels' Pallas-to-Triton lowering, here without a card."""
    assert _lowered_kernels("cuda") == 2
    assert _lowered_kernels("cpu") == 0


def test_ctc_loss_nll_fn_pins_the_implementation():
    """``nll_fn`` overrides the platform's choice (the step-time A/B
    script times the scan reference on CUDA this way) and leaves the
    batch reduction as it is."""
    assert _lowered_kernels("cuda", nll_fn=ctc_loss_ref) == 0
    from ctc_asr.ops.ctc_ref import ctc_loss
    args = _case(np.random.default_rng(12), 5, 16, 29, 4)
    np.testing.assert_allclose(
        float(ctc_loss(*args, average="label", nll_fn=_kernel)),
        float(ctc_loss(*args, average="label")), rtol=1e-5)


def test_states_pad_to_power_of_two():
    from ctc_asr.ops.ctc_triton import _pow2
    assert [_pow2(n) for n in (1, 2, 3, 17, 128, 129, 193)] == \
        [1, 2, 4, 32, 128, 256, 256]
