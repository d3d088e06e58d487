"""Training driver: jitted train step + loop with checkpoint/eval hooks.

Capability parity with the reference's ``asr/train.py`` (SURVEY.md §2a:
Adam + optional exponential LR decay, gradient clipping,
MonitoredTrainingSession loop with checkpoint & summary hooks):

- The WHOLE step — device-side feature extraction, encoder, CTC loss,
  backward, optimizer — is one jitted function; the host loop only feeds
  raw padded audio and reads back a scalar loss (one dispatch per step,
  SURVEY.md §3.1's per-step Python->runtime crossing minimized).
- One compilation per length bucket (static shapes from the loader).
- Data parallelism comes from input shardings (parallel/), not from a
  different step function: under a mesh the same jitted step runs SPMD
  with XLA-inserted psums.
- State (params, opt state, step, rng, loader cursor) checkpoints
  atomically; restart resumes bit-exact data order (SURVEY.md §5).
"""

from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import optax

from . import checkpoint as ckpt_mod
from . import features as feat_mod
from .config import Config
from .data import DataLoader, read_manifest
from .metrics import MetricsWriter, NullMetricsWriter, ThroughputMeter
from .models import apply_encoder, init_params
from .ops.ctc_ref import ctc_loss


def build_lr_schedule(cfg) -> optax.Schedule:
    if cfg.lr_schedule == "constant":
        return optax.constant_schedule(cfg.learning_rate)
    if cfg.lr_schedule == "exponential":
        return optax.exponential_decay(
            cfg.learning_rate, transition_steps=cfg.lr_decay_steps,
            decay_rate=cfg.lr_decay_rate, staircase=True)
    if cfg.lr_schedule == "warmup_cosine":
        return optax.warmup_cosine_decay_schedule(
            0.0, cfg.learning_rate, cfg.warmup_steps,
            max(cfg.total_steps, cfg.warmup_steps + 1))
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")


def build_optimizer(cfg) -> optax.GradientTransformation:
    tx = [optax.clip_by_global_norm(cfg.grad_clip_norm)] \
        if cfg.grad_clip_norm > 0 else []
    if cfg.weight_decay > 0:
        tx.append(optax.adamw(build_lr_schedule(cfg), b1=cfg.adam_b1,
                              b2=cfg.adam_b2, eps=cfg.adam_eps,
                              weight_decay=cfg.weight_decay))
    else:
        tx.append(optax.adam(build_lr_schedule(cfg), b1=cfg.adam_b1,
                             b2=cfg.adam_b2, eps=cfg.adam_eps))
    return optax.chain(*tx)


def init_train_state(cfg: Config, feat_dim: int | None = None) -> dict:
    """{"params", "opt_state", "step", "rng"} pytree."""
    if feat_dim is None:
        feat_dim = cfg.features.feature_dim
    rng = jax.random.PRNGKey(cfg.train.seed)
    prng, rng = jax.random.split(rng)
    params = init_params(prng, cfg.model, feat_dim)
    tx = build_optimizer(cfg.train)
    return {"params": params, "opt_state": tx.init(params),
            "step": jnp.zeros((), jnp.int32), "rng": rng}


def make_step_fn(cfg: Config, data_axis: str | None = None,
                 feature_fn=None, ctc_fn=None):
    """The bare (unjitted) train step ``(state, samples, sample_lens,
    labels, label_lens) -> (state, metrics)``.

    Shared by the single-chip path (make_train_step jits it directly)
    and the mesh path (parallel/dist.py wraps it in shard_map) — the
    SPMD design means one step function for every topology.

    ``data_axis``: when set, the step runs manually sharded over that
    mesh axis (inside shard_map): per-shard loss/grads are pmean'd over
    the axis before the optimizer (every shard then applies the same
    update), and the dropout rng folds in the shard index so masks
    decorrelate across shards.

    ``feature_fn`` / ``ctc_fn``: optional substitutes for the feature
    frontend ``(samples, slens) -> (feats, flens)`` and the loss
    ``(logits, logit_lens, labels, label_lens) -> scalar``. The hybrid
    DP+TP regime (parallel/dist.py) passes shard_map-wrapped islands
    here so the batch-parallel CTC kernel keeps running while GSPMD
    auto-partitions the encoder matmuls over 'model'.
    """
    tx = build_optimizer(cfg.train)
    sched = build_lr_schedule(cfg.train)
    if feature_fn is None:
        def feature_fn(samples, slens):
            return feat_mod.extract_features(samples, slens, cfg.features)
    if ctc_fn is None:
        ctc_fn = ctc_loss

    def step_fn(state, samples, sample_lengths, labels, label_lengths):
        rng, dropout_rng = jax.random.split(state["rng"])
        if data_axis is not None:
            dropout_rng = jax.random.fold_in(
                dropout_rng, jax.lax.axis_index(data_axis))
        feats, flens = feature_fn(samples, sample_lengths)
        if cfg.train.specaugment:
            # fold_in keeps the dropout stream identical whether or not
            # augmentation is enabled (and across restarts)
            sa_rng = jax.random.fold_in(dropout_rng, 7)
            feats = feat_mod.spec_augment(
                sa_rng, feats, flens,
                cfg.train.sa_time_masks, cfg.train.sa_time_ratio,
                cfg.train.sa_freq_masks, cfg.train.sa_freq_width)

        def loss_fn(params):
            logits, logit_lens = apply_encoder(
                params, feats, flens, cfg.model, train=True,
                dropout_rng=dropout_rng)
            return ctc_fn(logits, logit_lens, labels, label_lengths)

        loss, grads = jax.value_and_grad(loss_fn)(state["params"])
        if data_axis is not None:
            # equal-size shards (loader contract) => pmean == global mean
            grads = jax.lax.pmean(grads, data_axis)
            loss = jax.lax.pmean(loss, data_axis)
        gnorm = optax.global_norm(grads)
        updates, opt_state = tx.update(grads, state["opt_state"],
                                       state["params"])
        params = optax.apply_updates(state["params"], updates)
        new_state = {"params": params, "opt_state": opt_state,
                     "step": state["step"] + 1, "rng": rng}
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": sched(state["step"])}
        return new_state, metrics

    return step_fn


def make_train_step(cfg: Config, donate: bool = True):
    """Single-device jitted train step (see make_step_fn)."""
    step_fn = make_step_fn(cfg)
    return jax.jit(step_fn, donate_argnums=(0,) if donate else ())


def make_eval_step(cfg: Config):
    """Jitted ``(params, samples, slens) -> (logits, logit_lens)``."""

    def eval_fn(params, samples, sample_lengths):
        feats, flens = feat_mod.extract_features(
            samples, sample_lengths, cfg.features)
        return apply_encoder(params, feats, flens, cfg.model, train=False)

    return jax.jit(eval_fn)


def device_batches(src, loader=None, with_labels: bool = True, put=None):
    """Yield (batch, device_arrays) with the NEXT batch's
    jax.device_put already in flight: the host->device transfer of
    batch k+1 overlaps step k's compute (device_put is async), so the
    step never waits on the host->device upload except for the first
    batch.
    Keeps exactly one extra batch resident. Used by the train loop and
    evaluate().

    Pulling one ahead advances the prefetch iterator's consumed-cursor
    past the batch actually being trained; passing ``loader`` re-pins
    ``loader.consumed`` to each YIELDED batch so state_dict() stays an
    exact resume point. ``with_labels=False`` skips uploading
    labels/label_lengths (eval never uses them). ``put`` overrides the
    host->device transfer (default jax.device_put) — the multi-process
    train path passes parallel.dist.process_local_batch so each
    process's LOCAL batch becomes its shard of the global array."""
    if put is None:
        put = jax.device_put
    pending = None
    for b in src:
        arrs = (b.samples, b.sample_lengths) if not with_labels else \
            (b.samples, b.sample_lengths, b.labels, b.label_lengths)
        dev = put(arrs)
        if pending is not None:
            if loader is not None:
                loader.consumed = (pending[0].epoch, pending[0].position)
            yield pending
        pending = (b, dev)
    if pending is not None:
        if loader is not None:
            loader.consumed = (pending[0].epoch, pending[0].position)
        yield pending


def precompile_bucket_shapes(step_fn, state, loader, cfg: Config) -> None:
    """Compile every length-bucket's step shape concurrently.

    Each bucket is a distinct static shape, i.e. a distinct XLA
    program; the default lazy behavior pays one full trace+compile the
    first time each bucket appears in the stream. XLA compilation
    releases the GIL, so a thread pool compiles all buckets in parallel
    (measured ~3x wall-clock on 3 shapes). Each thread runs one step on
    an all-zeros device-side state copy (the jitted step donates its
    state, so the warm-up must not pass the real one) and zero-filled
    dummy batches of the bucket's exact shapes — arrays are created
    on-device, nothing crosses the host link. Failures fall back to
    lazy compilation."""
    import concurrent.futures as cf
    buckets = loader.spec.buckets
    if len(buckets) <= 1:
        return
    # shapes come from the LOADER (a caller-supplied loader may differ
    # from cfg.data — warming the wrong shapes doubles compile cost)
    sdtype = {"int16": jnp.int16, "ulaw": jnp.uint8}.get(
        loader.cfg.wire_dtype, jnp.float32)
    B = loader.spec.batch_size
    zeros_state = jax.jit(lambda s: jax.tree.map(jnp.zeros_like, s))

    def one(bucket_id):
        bspec = buckets[bucket_id]
        st = zeros_state(state)
        if loader.cache is not None:
            samples = jnp.zeros((B, loader.bucket_frames(bucket_id),
                                 loader.cache.dim),
                                loader.cache.np_dtype)
        else:
            samples = jnp.zeros((B, bspec.max_samples), sdtype)
        slens = jnp.ones((B,), jnp.int32)
        labels = jnp.zeros((B, bspec.max_label_len), jnp.int32)
        llens = jnp.ones((B,), jnp.int32)
        out = step_fn(st, samples, slens, labels, llens)
        jax.block_until_ready(out[1]["loss"])

    t0 = time.perf_counter()
    try:
        # pool of 4 bounds the transient HBM spike: each in-flight
        # warm-up holds one zeros train-state (params + Adam moments)
        # plus a compile workspace alongside the live state
        with cf.ThreadPoolExecutor(min(4, len(buckets))) as ex:
            list(ex.map(one, range(len(buckets))))
        print(f"[train] precompiled {len(buckets)} bucket shapes in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    except Exception as e:  # pragma: no cover - defensive
        print(f"[train] precompile failed ({e!r}); compiling lazily",
              flush=True)


def _loader_sharding_for_mesh(mesh) -> tuple[int, int]:
    """(shard_idx, num_shards) for THIS process's loader on a
    ('data','model') mesh.

    The global batch shards over 'data' only; with TP (model axis > 1)
    several processes hold REPLICAS of the same batch shard, so the
    loader must be sharded by the process's data-row coordinate — not by
    process index, which would feed nproc distinct shards where the mesh
    expects data-size replicated ones (make_array_from_process_local_data
    would assemble inconsistent replicas). Pure-DP (model axis == 1)
    reduces to the familiar (process_index, process_count)."""
    devs = mesh.devices  # ndarray [data, model]
    if devs.shape[1] == 1:
        return jax.process_index(), jax.process_count()
    local_ids = {d.id for d in jax.local_devices()}
    rows = sorted({r for r in range(devs.shape[0])
                   if any(d.id in local_ids for d in devs[r])})
    if len(rows) != 1:
        raise ValueError(
            f"this process's devices span data rows {rows} of the "
            f"{devs.shape[0]}x{devs.shape[1]} mesh; with model_axis>1 "
            "each process's devices must sit within ONE data row so its "
            "loader shard maps to one batch shard")
    return rows[0], devs.shape[0]


def train(cfg: Config, max_steps: int | None = None,
          loader: DataLoader | None = None,
          eval_fn=None, writer: MetricsWriter | None = None) -> dict:
    """Run the training loop; returns the final state.

    ``eval_fn(state) -> dict`` is called every cfg.train.eval_every steps
    (the evaluate driver wires in WER); ``max_steps`` overrides
    cfg.train.total_steps (tests use small values).
    """
    tcfg = cfg.train
    total = max_steps if max_steps is not None else tcfg.total_steps
    # Data-parallel regime: the mesh spans every process's devices
    # (multi-host: cli.cmd_train -> initialize_distributed forms the
    # group) or, in one process, ``mesh.data_axis`` local devices (-1 =
    # all). The SAME loop runs the mesh-sharded step: per-process loader
    # shards become shards of the global batch, the gradient pmean
    # crosses devices and processes, and only process 0 writes
    # metrics/checkpoints. Executed for real (2 OS processes) by
    # tests/test_multiprocess.py.
    nproc = jax.process_count()
    mesh = put = sp_mesh = None
    if cfg.mesh.seq_axis > 1:
        if nproc > 1:
            # SP shards the TIME axis of one batch across local devices;
            # the multi-process regime shards the BATCH axis across
            # processes. Combining them needs a (data, seq) process-level
            # mesh that is not built — refuse loudly rather than
            # silently training pure-DP with seq_axis ignored.
            raise ValueError(
                f"mesh.seq_axis={cfg.mesh.seq_axis} is not supported "
                f"with multi-process training (process_count={nproc}); "
                "run SP single-process over local devices, or unset "
                "mesh.seq_axis for the multi-process DP/DPxTP regimes")
        # sequence parallelism (config-driven): time-sharded activations
        # over a ('seq',) mesh of local devices — parallel/seqpar.py
        from jax.sharding import Mesh
        import numpy as _np
        from .parallel import seqpar
        devs = jax.devices()
        if len(devs) < cfg.mesh.seq_axis:
            raise ValueError(
                f"mesh.seq_axis={cfg.mesh.seq_axis} needs that many "
                f"local devices, have {len(devs)}")
        sp_mesh = Mesh(_np.array(devs[:cfg.mesh.seq_axis]), ("seq",))
        put = functools.partial(seqpar.sp_batch_put, sp_mesh)
    else:
        from .parallel.mesh import mesh_devices
        devs = mesh_devices(cfg.mesh)
        if len(devs) > 1:
            from .parallel.dist import process_local_batch
            from .parallel.mesh import build_mesh
            mesh = build_mesh(cfg.mesh, devices=devs)
            put = functools.partial(process_local_batch, mesh)
            loader_shard, loader_nshards = _loader_sharding_for_mesh(mesh)
            n_data = mesh.devices.shape[0]
            if cfg.data.batch_size * loader_nshards % n_data:
                raise ValueError(
                    f"global batch {cfg.data.batch_size}x{loader_nshards} "
                    f"does not split over the {n_data}-wide 'data' axis "
                    "of the mesh; set mesh.data_axis=1 to train on one "
                    "device")
    if loader is None:
        if mesh is None:
            loader_shard, loader_nshards = jax.process_index(), nproc
        manifest = read_manifest(cfg.data.train_manifest)
        loader = DataLoader(manifest, cfg.data, cfg.features,
                            shard_idx=loader_shard,
                            num_shards=loader_nshards)
    if writer is None:
        writer = MetricsWriter(tcfg.train_dir) if jax.process_index() == 0 \
            else NullMetricsWriter()
    state = init_train_state(cfg)

    # Resume if a checkpoint exists.
    restored, meta = ckpt_mod.restore_latest(tcfg.train_dir + "/ckpt", state)
    if restored is not None:
        state = restored
        if "loader" in meta:
            loader.load_state_dict(meta["loader"])
        print(f"[train] resumed from step {int(state['step'])}", flush=True)

    if mesh is not None:
        from .parallel.dist import make_sharded_train_step, shard_tree
        from .parallel.mesh import state_shardings
        step_fn = make_sharded_train_step(cfg, mesh, state)
        # leaf-wise shardings: fully replicated under pure DP; the wide
        # params/moments partition over 'model' in the TP regime
        state = shard_tree(mesh, jax.device_get(state),
                           state_shardings(state, mesh,
                                           cfg.mesh.shard_model))
    elif sp_mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        from .parallel import seqpar
        step_fn = seqpar.make_sp_train_step(cfg, sp_mesh, state)
        state = jax.device_put(
            state, NamedSharding(sp_mesh, PartitionSpec()))
    else:
        step_fn = make_train_step(cfg)
        if tcfg.precompile:
            precompile_bucket_shapes(step_fn, state, loader, cfg)
    meter = ThroughputMeter()
    best_wer = meta.get("best_wer", float("inf")) if meta else float("inf")

    heartbeat = None
    if tcfg.heartbeat_seconds > 0:
        from .utils.heartbeat import Heartbeat
        heartbeat = Heartbeat(tcfg.heartbeat_seconds).start()
    from .utils.profiling import maybe_trace

    it = iter(loader)
    dev_it = device_batches(it, loader=loader, put=put)
    start_step = int(state["step"])
    # Async dispatch with bounded runahead: the loop tracks the step
    # counter on the host (it advances by exactly 1 per step_fn call)
    # instead of fetching int(state["step"]) every iteration, and blocks
    # on a result only every sync_every steps (log/eval/ckpt hooks also
    # sync), keeping <= sync_every steps' input batches in flight.
    sync_every = max(1, tcfg.sync_every)
    t_last = time.perf_counter()
    try:
      with maybe_trace(tcfg.profile_dir):
        for i in range(start_step, total):
            batch, (d_samples, d_slens, d_labels, d_llens) = next(dev_it)
            state, m = step_fn(state, d_samples, d_slens,
                               d_labels, d_llens)
            meter.update(batch.audio_seconds)
            step = i + 1
            if step % sync_every == 0 or step == total:
                # barrier (see above). grad_norm, not loss, is the
                # NaN canary: the log-space CTC masking maps NaN/inf
                # logits to a finite loss, but a NaN anywhere in params
                # or activations propagates into the backward pass and
                # the global grad norm.
                gn = float(m["grad_norm"])
                if gn != gn:
                    raise FloatingPointError(
                        f"grad_norm is NaN at step {step} "
                        f"(loss={float(m['loss'])})")
            if heartbeat is not None:
                heartbeat.beat(step)

            # interval 0 disables a hook (matches the CLI help text)
            if tcfg.log_every > 0 and (step % tcfg.log_every == 0
                                       or step == total):
                now = time.perf_counter()
                writer.write(step, loss=float(m["loss"]),
                             grad_norm=float(m["grad_norm"]),
                             lr=float(m["lr"]),
                             audio_s_per_s=meter.audio_seconds_per_second,
                             step_time_s=(now - t_last) / tcfg.log_every,
                             epoch=batch.epoch, bucket=batch.bucket_id)
                t_last = now

            if eval_fn is not None and tcfg.eval_every > 0 \
                    and step % tcfg.eval_every == 0:
                eval_metrics = eval_fn(state)
                writer.write(step, **{f"eval_{k}": v
                                      for k, v in eval_metrics.items()})
                wer = eval_metrics.get("wer", float("inf"))
                if wer < best_wer:
                    best_wer = wer
                    ckpt_mod.save_checkpoint(
                        tcfg.train_dir + "/ckpt", step, state,
                        metadata={"loader": {"epoch": batch.epoch,
                                             "position": batch.position + 1,
                                             "seed": cfg.data.seed},
                                  "best_wer": best_wer},
                        keep=tcfg.keep_checkpoints, is_best=True)

            if (tcfg.checkpoint_every > 0
                    and step % tcfg.checkpoint_every == 0) or step == total:
                ckpt_mod.save_checkpoint(
                    tcfg.train_dir + "/ckpt", step, state,
                    metadata={"loader": {"epoch": batch.epoch,
                                         "position": batch.position + 1,
                                         "seed": cfg.data.seed},
                              "best_wer": best_wer},
                    keep=tcfg.keep_checkpoints)
    finally:
        if hasattr(it, "close"):
            it.close()
        if heartbeat is not None:
            heartbeat.stop()
    return state
