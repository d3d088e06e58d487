"""Distributed (sharded-LM) beam decode vs the replicated-LM decoder,
on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ctc_asr.config import Config, DecodeConfig, MeshConfig
from ctc_asr.ops import lm as lm_mod
from ctc_asr.ops.beam import make_beam_decoder
from ctc_asr.parallel.decode_dist import make_sharded_lm_beam_decoder
from ctc_asr.parallel.mesh import build_mesh


@pytest.fixture(scope="module")
def lm():
    corpus = ["the quick brown fox jumps", "she sells sea shells",
              "a lazy dog sleeps all day"] * 3
    return lm_mod.train_char_lm(corpus, order=2)  # 28 rows: shards over 2/4


def _decode_lists(ids, lens):
    ids, lens = np.asarray(ids), np.asarray(lens)
    return [list(ids[b, :int(lens[b])]) for b in range(ids.shape[0])]


@pytest.mark.parametrize("model_axis", [2, 4])
def test_sharded_lm_matches_replicated(lm, model_axis):
    mesh = build_mesh(MeshConfig(model_axis=model_axis))
    cfg = Config(decode=DecodeConfig(method="beam", beam_width=8,
                                     lm_weight=1.5, word_bonus=0.5))
    rng = np.random.default_rng(0)
    B, T, C = mesh.shape["data"], 12, 29
    logits = jnp.asarray(rng.standard_normal((B, T, C)).astype(np.float32))
    lens = jnp.asarray(np.full(B, T, np.int32))

    ref = make_beam_decoder(beam_width=8, lm=lm, lm_weight=1.5,
                            word_bonus=0.5)
    want_ids, want_lens = ref(logits, lens)

    decode, place = make_sharded_lm_beam_decoder(cfg, mesh, lm)
    table = place()
    got_ids, got_lens = decode(logits, lens, table)
    assert _decode_lists(got_ids, got_lens) == \
        _decode_lists(want_ids, want_lens)


def test_lm_rows_not_divisible_raises(lm):
    mesh = build_mesh(MeshConfig(model_axis=8))  # 28 rows % 8 != 0
    cfg = Config(decode=DecodeConfig(beam_width=4))
    with pytest.raises(ValueError):
        make_sharded_lm_beam_decoder(cfg, mesh, lm)
