"""Distributed beam decode: sharded utterances + model-sharded LM fusion.

SURVEY.md §2c "distributed decode" / BASELINE.json:11: beam/posterior
state exchanged via collectives during multi-chip decode. Two
composable mechanisms:

1. **Utterance sharding** (primary): the batch dim shards over the
   ``data`` axis — each chip runs the full on-device beam search for its
   utterances (dist.make_distributed_beam_decoder).
2. **Model-axis-sharded LM fusion** (this module): the dense char-LM
   table ``[n_ctx, V]`` (79 MB at order 5) is *row-sharded over the
   ``model`` axis*. Each step of beam search needs the rows for the K
   live contexts; every shard gathers the rows it owns (zeros
   elsewhere) and a single ``psum`` assembles the full [K, V]
   score block. Memory per chip drops by the model-axis size and the
   decode-state exchange is an explicit XLA collective, overlapping
   with the candidate expansion.

Built on shard_map so the collective is explicit (scaling-book recipe);
tested against the replicated-LM decoder on the virtual 8-device CPU
mesh (tests/test_decode_dist.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from jax import shard_map  # requires JAX >= 0.6 (env pins 0.9)

from ..config import Config
from ..ops import beam as beam_mod
from ..ops import lm as lm_mod


def _sharded_lm_lookup(table_local: jnp.ndarray, ctx: jnp.ndarray,
                       axis: str, rows_per_shard: int) -> jnp.ndarray:
    """ctx [K] global context ids -> [K, V] LM rows, assembled by psum.

    ``table_local`` is this shard's [rows_per_shard, V] slice. Each
    shard contributes the rows it owns; the psum over ``axis`` is the
    exchange that reunites the block.
    """
    rank = jax.lax.axis_index(axis)
    local_idx = ctx - rank * rows_per_shard
    owned = (local_idx >= 0) & (local_idx < rows_per_shard)
    safe_idx = jnp.clip(local_idx, 0, rows_per_shard - 1)
    rows = table_local[safe_idx]                        # [K, V]
    rows = jnp.where(owned[:, None], rows, 0.0)
    return jax.lax.psum(rows, axis)


def make_sharded_lm_beam_decoder(cfg: Config, mesh, lm: dict,
                                 data_axis: str = "data",
                                 model_axis: str = "model"):
    """jitted ``(logits, logit_lens) -> (ids, lens)``:

    - batch sharded over ``data`` (each chip decodes its utterances);
    - the LM table row-sharded over ``model``; every beam step's LM
      lookup runs the psum exchange above.

    Returns (decode_fn, place_table) where ``place_table()`` device_puts
    the table with the row sharding (callers do this once).
    """
    order = int(lm["order"])
    init_ctx = lm_mod.initial_context(order)
    n_ctx, V = lm["table"].shape
    n_model = mesh.shape[model_axis]
    if n_ctx % n_model != 0:
        raise ValueError(f"LM rows {n_ctx} not divisible by model axis "
                         f"{n_model}")
    rows_per = n_ctx // n_model
    K = cfg.decode.beam_width

    table_sharding = NamedSharding(mesh, P(model_axis, None))

    def place_table():
        return jax.device_put(jnp.asarray(lm["table"]), table_sharding)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(data_axis, None, None), P(data_axis),
                  P(model_axis, None)),
        out_specs=(P(data_axis, None), P(data_axis)),
        check_vma=False)
    def _decode(logits, logit_lens, table_local):
        lookup = functools.partial(_sharded_lm_lookup,
                                   table_local, axis=model_axis,
                                   rows_per_shard=rows_per)

        def lm_lookup(ctx):
            return lookup(ctx=ctx)

        ids, lens = beam_mod.beam_search_decode(
            logits, logit_lens, beam_width=K,
            lm_table=lm_lookup, lm_weight=cfg.decode.lm_weight,
            word_bonus=cfg.decode.word_bonus, init_ctx=init_ctx,
            lm_vocab=lm_mod.V, lm_ctx_size=n_ctx)
        return ids, lens

    @jax.jit
    def decode(logits, logit_lens, table):
        return _decode(logits, logit_lens, table)

    return decode, place_table
