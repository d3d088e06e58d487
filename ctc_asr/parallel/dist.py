"""Multi-host initialization and sharded train/decode steps.

SURVEY.md §5 "Distributed communication backend" (new vs reference):
``jax.distributed.initialize()`` builds the process group; inside
jit, XLA collectives (NCCL on GPUs) carry gradient psums and
decode-state exchange. The sharded train step here is the SAME step function as
single-chip (train.py) — only the in/out shardings differ, which is the
point of the SPMD design.
"""

from __future__ import annotations

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from jax import shard_map  # requires JAX >= 0.6 (env pins 0.9)

from ..config import Config, MeshConfig
from .mesh import batch_sharding, state_shardings


def initialize_distributed(cfg: MeshConfig) -> None:
    """Multi-host process-group init (no-op for single-process runs).

    On the CPU backend, cross-process collectives need an explicit
    implementation (the default is none — each process would come up as
    an isolated 1-process group); gloo ships with jaxlib, so enable it
    before the backend instantiates. Executed + asserted by
    tests/test_multiprocess.py (2 real OS processes, local coordinator).

    ``cfg.local_device_ids`` pins the cards this process claims (one
    process per card on a multi-card host); empty claims every visible
    device.

    Each process autotunes its own GPU kernels. With XLA's default,
    which splits autotuning across the processes, four one-card ``cli
    train`` processes on four H100s abort while compiling the train
    step ("Sharding autotuning failed: no config found" for a Triton
    GEMM fusion of the BiLSTM input projection), with an empty compile
    cache as with a warm one; with the split turned off they train.
    """
    if cfg.coordinator_address and cfg.num_processes > 1:
        import os
        os.environ.setdefault("JAX_CPU_COLLECTIVES_IMPLEMENTATION", "gloo")
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_gpu_shard_autotuning" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_gpu_shard_autotuning=false").strip()
        jax.distributed.initialize(
            coordinator_address=cfg.coordinator_address,
            num_processes=cfg.num_processes,
            process_id=cfg.process_id,
            local_device_ids=list(cfg.local_device_ids) or None)
        if jax.process_count() != cfg.num_processes:
            raise RuntimeError(
                f"jax.distributed came up with {jax.process_count()} "
                f"processes, expected {cfg.num_processes} (was the "
                "backend already initialized before "
                "initialize_distributed?)")


def process_local_batch(mesh, arrays):
    """Per-process LOCAL batch shards -> global batch-sharded jax.Arrays.

    Each process passes the arrays its own loader shard produced
    (``DataLoader(shard_idx=jax.process_index(), ...)``); the global
    array's 'data'-axis shard layout matches the strided manifest
    sharding, so the global batch is the concatenation of per-process
    batches in mesh order. Works identically for the 1-process case
    (local == global).
    """
    import numpy as np
    bsh = batch_sharding(mesh)
    return tuple(
        jax.make_array_from_process_local_data(bsh, np.asarray(a))
        for a in arrays)


def shard_tree(mesh, tree, shardings):
    """Host pytree (identical on every process) -> global jax.Arrays
    laid out per ``shardings`` (a matching pytree of NamedShardings).
    Multi-process safe: every process supplies its addressable shards
    through the callback, so 'model'-sharded leaves (the TP regime's
    state_shardings) come up correctly partitioned across processes."""
    import numpy as np

    def put(x, sh):
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, sh,
                                            lambda idx: x[idx])
    return jax.tree.map(put, tree, shardings)


def replicate_tree(mesh, tree):
    """Host pytree (identical on every process) -> fully-replicated
    global jax.Arrays on ``mesh``. The multi-process analog of a plain
    device_put: every process supplies its local replicas' data."""
    rep = NamedSharding(mesh, P())
    return shard_tree(mesh, tree, jax.tree.map(lambda _: rep, tree))


def _ctc_island(mesh):
    """shard_map-wrapped CTC loss for the hybrid DP+TP step: full-manual
    over BOTH mesh axes (a Pallas call cannot be auto-partitioned, even
    over a size-1 auto axis), batch split over 'data', compute
    replicated over 'model'. Matches the make_step_fn ``ctc_fn`` hook."""
    from ..ops.ctc_ref import ctc_loss

    def _ctc(logits, logit_lens, labels, label_lens):
        # per-shard mean -> global mean (equal-size shards, loader
        # contract); replicated over 'model' by construction
        loss = ctc_loss(logits, logit_lens, labels, label_lens)
        return jax.lax.pmean(loss, "data")

    return shard_map(
        _ctc, mesh=mesh, axis_names=set(mesh.axis_names),
        in_specs=(P("data"), P("data"), P("data"), P("data")),
        out_specs=P(), check_vma=False)


def make_sharded_train_step(cfg: Config, mesh, state_template,
                            donate: bool = True):
    """jit the train step over the mesh. Two regimes:

    - **DP (shard_model=False, the primary strategy)**: shard_map fully
      manual over the mesh — a ``pallas_call`` (the CTC kernel) cannot
      be auto-partitioned by the SPMD partitioner, so each device runs
      the step on its LOCAL batch shard and gradients pmean over 'data'
      inside the step.
    - **DP+TP (shard_model=True, hybrid)**: GSPMD auto-partitioning for
      the encoder so ``state_shardings``'s 'model'-axis TP of wide
      matmuls applies, while the CTC loss runs inside a full-manual
      shard_map island over ('data','model'). Gradient psums are
      inserted by XLA; the island differentiates through shard_map.
    """
    from ..train import make_step_fn

    st_shard = state_shardings(state_template, mesh,
                               cfg.mesh.shard_model)
    bsh = batch_sharding(mesh)
    rep = NamedSharding(mesh, P())
    metrics_shard = {"loss": rep, "grad_norm": rep, "lr": rep}

    if cfg.mesh.shard_model:
        step_fn = make_step_fn(cfg, ctc_fn=_ctc_island(mesh))
        return jax.jit(
            step_fn,
            in_shardings=(st_shard, bsh, bsh, bsh, bsh),
            out_shardings=(st_shard, metrics_shard),
            donate_argnums=(0,) if donate else ())

    step_fn = make_step_fn(cfg, data_axis="data")
    st_spec = jax.tree.map(lambda _: P(), state_template)
    metrics_spec = {"loss": P(), "grad_norm": P(), "lr": P()}
    sharded = shard_map(
        step_fn, mesh=mesh, axis_names=set(mesh.axis_names),
        in_specs=(st_spec, P("data"), P("data"), P("data"), P("data")),
        out_specs=(st_spec, metrics_spec), check_vma=False)
    return jax.jit(
        sharded,
        in_shardings=(st_shard, bsh, bsh, bsh, bsh),
        out_shardings=(st_shard, metrics_shard),
        donate_argnums=(0,) if donate else ())


def make_sharded_eval_step(cfg: Config, mesh):
    """Sharded (params, samples, lens) -> (logits, logit_lens): GSPMD
    over the mesh (the encoder has no Pallas call), batch over 'data';
    params keep the shardings the caller placed them with (e.g.
    ``state_shardings``'s 'model'-axis rule)."""
    from .. import features as feat_mod
    from ..models import apply_encoder

    bsh = batch_sharding(mesh)

    def eval_fn(params, samples, sample_lengths):
        feats, flens = feat_mod.extract_features(
            samples, sample_lengths, cfg.features)
        return apply_encoder(params, feats, flens, cfg.model,
                             train=False)

    return jax.jit(eval_fn, in_shardings=(None, bsh, bsh),
                   out_shardings=(bsh, bsh))


def make_distributed_beam_decoder(cfg: Config, mesh, lm=None):
    """Data-sharded beam decode: each device decodes its batch shard
    on-device (beam state never leaves its device); outputs stay
    sharded over 'data' and host reads gather them."""
    from ..ops import beam as beam_mod

    decoder = beam_mod.make_beam_decoder(
        beam_width=cfg.decode.beam_width, lm=lm,
        lm_weight=cfg.decode.lm_weight,
        word_bonus=cfg.decode.word_bonus,
        max_decode_len=beam_mod.derive_max_decode_len(cfg.decode,
                                                      cfg.data))
    bsh = batch_sharding(mesh)

    sharded = shard_map(
        decoder, mesh=mesh, axis_names=set(mesh.axis_names),
        in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data")), check_vma=False)
    return jax.jit(sharded, in_shardings=(bsh, bsh),
                   out_shardings=(bsh, bsh))
