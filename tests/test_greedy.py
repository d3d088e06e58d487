import jax.numpy as jnp
import numpy as np

from ctc_asr.ops.greedy import greedy_decode
from ctc_asr.text import BLANK_ID, PAD_ID, decode_ids


def _logits_from_ids(ids, C=29, hot=10.0):
    """Build logits whose argmax path is exactly `ids` (list of lists)."""
    B = len(ids)
    T = max(len(r) for r in ids)
    out = np.zeros((B, T, C), np.float32)
    for b, row in enumerate(ids):
        for t, c in enumerate(row):
            out[b, t, c] = hot
    return jnp.asarray(out)


def oracle_collapse(ids, blank):
    out, prev = [], None
    for c in ids:
        if c != blank and c != prev:
            out.append(c)
        prev = c
    return out


def test_collapse_and_blank_removal():
    bl = BLANK_ID
    paths = [
        [1, 1, bl, 1, 2, 2, bl, bl, 3],
        [bl, bl, bl, bl, bl, bl, bl, bl, bl],
        [5, 5, 5, 5, 5, 5, 5, 5, 5],
    ]
    logits = _logits_from_ids(paths)
    lens = jnp.asarray([9, 9, 9])
    ids, out_lens = greedy_decode(logits, lens)
    ids, out_lens = np.asarray(ids), np.asarray(out_lens)
    for b, p in enumerate(paths):
        want = oracle_collapse(p, bl)
        assert list(ids[b, :out_lens[b]]) == want
        assert (ids[b, out_lens[b]:] == PAD_ID).all()


def test_respects_lengths():
    bl = BLANK_ID
    paths = [[1, 2, 3, 4, 5, 6]]
    logits = _logits_from_ids(paths)
    ids, lens = greedy_decode(logits, jnp.asarray([3]))
    assert list(np.asarray(ids)[0, :int(lens[0])]) == [1, 2, 3]


def test_random_vs_oracle():
    rng = np.random.default_rng(0)
    B, T, C = 8, 40, 29
    logits = jnp.asarray(rng.standard_normal((B, T, C)).astype(np.float32))
    lens_np = rng.integers(1, T + 1, B).astype(np.int32)
    ids, out_lens = greedy_decode(logits, jnp.asarray(lens_np))
    ids, out_lens = np.asarray(ids), np.asarray(out_lens)
    arg = np.asarray(jnp.argmax(logits, -1))
    for b in range(B):
        want = oracle_collapse(list(arg[b, :lens_np[b]]), BLANK_ID)
        assert list(ids[b, :out_lens[b]]) == want


def test_decode_to_text():
    # "ab" with repeats/blanks
    a, b = 1, 2
    path = [[a, a, BLANK_ID, b, b]]
    ids, lens = greedy_decode(_logits_from_ids(path), jnp.asarray([5]))
    assert decode_ids(np.asarray(ids)[0, :int(lens[0])]) == "ab"
