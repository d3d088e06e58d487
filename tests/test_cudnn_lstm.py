"""cuDNN's LSTM (``jax.experimental.rnn``, a library kernel) against one
bidirectional layer of the scan LSTM in models/rnn.py, with the scan's
weights packed into cuDNN's flat layout by ``pack_cudnn``. The CPU cases
hold the packing and gate order against JAX's own reference of that
layout (``lstm_ref``); the ``gpu`` case runs cuDNN itself at the width
of the ``deepspeech_beam`` preset, values and gradients. The training
step runs the scan; this keeps the evidence for a cuDNN route: cuDNN
agrees with the scan when its input is batch-major in memory, and
jaxlib's custom call does not make it so (see the ``gpu`` case)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental import rnn as jrnn

from ctc_asr.models import rnn as rnn_mod


def pack_cudnn(params: dict) -> jnp.ndarray:
    """{"fwd", "bwd"} scan LSTM weights -> cuDNN's flat vector for one
    bidirectional layer: W_ih, W_hh per direction ([4H, in], gate order
    i, f, g, o as in the scan), then b_ih, b_hh per direction; the
    scan's one bias goes to b_ih and b_hh is zero."""
    H = params["fwd"]["wh"].shape[0]
    mats = [params[d][k].T.reshape(-1) for d in ("fwd", "bwd")
            for k in ("wx", "wh")]
    biases = [b for d in ("fwd", "bwd")
              for b in (params[d]["b"], jnp.zeros((4 * H,), jnp.float32))]
    return jnp.concatenate(mats + biases)


def _case(T, B, F, H, lens, seed=0):
    k = jax.random.split(jax.random.PRNGKey(seed), 5)
    params = {d: rnn_mod.lstm_init(kd, F, H)
              for d, kd in (("fwd", k[0]), ("bwd", k[1]))}
    for d, kd in (("fwd", k[2]), ("bwd", k[3])):  # exercise the biases
        params[d]["b"] = 0.3 * jax.random.normal(kd, (4 * H,))
    x = jax.random.normal(k[4], (T, B, F))
    return params, x, jnp.asarray(lens, jnp.int32)


def _scan(params, x, lens):
    """[T, B, F] -> [B, T, 2H], float32 throughout."""
    y = rnn_mod.birnn_apply(params, x, lens, "lstm", jnp.float32)
    return jnp.swapaxes(y, 0, 1)


def _zeros_state(B, H):
    return jnp.zeros((2, B, H)), jnp.zeros((2, B, H))


@pytest.mark.parametrize("T,B,F,H,lens", [
    (7, 3, 5, 8, [7, 7, 7]),       # uniform lengths
    (9, 3, 6, 4, [9, 4, 1]),       # ragged lengths
])
def test_packing_matches_jax_reference_layout(T, B, F, H, lens):
    params, x, lens = _case(T, B, F, H, lens)
    w = jrnn.unpack_lstm_weights(pack_cudnn(params), F, H, 1, True)
    with jax.default_matmul_precision("highest"):
        want = _scan(params, x, lens)
        got, _, _ = jrnn.lstm_ref(jnp.swapaxes(x, 0, 1), *_zeros_state(B, H),
                                  *w, lens, F, H, 1, 0.0, True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("ragged", [False, True])
def test_cudnn_matches_scan_on_card(ragged):
    """One BiLSTM-800 layer at the ds3 training shape (B=16, T'=179, the
    conv frontend's 32 x 20 = 640 features), float32 on both sides
    with TF32 off: outputs and the gradients of a random projection of
    them, with respect to the input and the packed weights. The input
    reaches cuDNN as a batch-major argument of the jitted function."""
    T, B, F, H = 179, 16, 640, 800
    lens = ([T] * B if not ragged else
            list(np.random.default_rng(1).integers(T // 2, T + 1, B)))
    params, x, lens = _case(T, B, F, H, lens)
    xb = jnp.asarray(np.swapaxes(np.asarray(x), 0, 1))   # [B, T, F]
    proj = jax.random.normal(jax.random.PRNGKey(2), (B, T, 2 * H))

    def cudnn(p, xb):
        return jrnn.lstm(xb, *_zeros_state(B, H), pack_cudnn(p), lens, F,
                         H, 1, 0.0, True, jax.lax.Precision.HIGHEST)[0]

    def scan(p, xb):
        return _scan(p, jnp.swapaxes(xb, 0, 1), lens)

    def run(fn):
        def loss(p, xb):
            y = fn(p, xb)
            return jnp.sum(y * proj), y
        with jax.default_matmul_precision("highest"):
            return jax.jit(jax.value_and_grad(loss, (0, 1), has_aux=True))(
                params, xb)

    (l_want, y_want), g_want = run(scan)
    (l_got, y_got), g_got = run(cudnn)
    err = {"y": float(jnp.max(jnp.abs(y_got - y_want))),
           "loss_rel": abs(float(l_got - l_want)) / abs(float(l_want))}
    rel = jax.tree.map(lambda a, b: float(jnp.max(jnp.abs(a - b))
                                          / jnp.max(jnp.abs(b))), g_got, g_want)
    for path, v in jax.tree_util.tree_leaves_with_path(rel):
        err["d" + jax.tree_util.keystr(path)] = v
    # Reported, not asserted (it depends on XLA's layout choice): the
    # cuDNN custom call pins no operand layouts, so under jit XLA may
    # fold a transpose in front of it into a layout change, and cuDNN
    # then reads time-major memory as batch-major.
    with jax.default_matmul_precision("highest"):
        y_t = jax.jit(lambda p, x: cudnn(p, jnp.swapaxes(x, 0, 1)))(params, x)
    err["y_transpose_in_jit"] = float(jnp.max(jnp.abs(y_t - y_want)))
    print(f"cudnn vs scan (ragged={ragged}): {err}")
    assert err["y"] < 1e-5 and err["loss_rel"] < 1e-5, err
    assert max(v for k, v in err.items() if k.startswith("d")) < 1e-4, err

