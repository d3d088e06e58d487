"""Worker process for tests/test_multiprocess.py.

Runs the REAL multi-process path (SURVEY.md §5 comm-backend row): each
OS process calls ``initialize_distributed`` against a local coordinator,
builds its own strided loader shard, assembles global batch arrays from
process-local data, and runs the sharded DP train step — gradients
pmean over the 'data' axis cross PROCESS boundaries (gloo on CPU).

Modes (selected by --num-processes):
- N > 1: one of N coordinated processes, 1 CPU device each.
- N == 1: the single-process reference — a 2-virtual-device mesh fed by
  the SAME two loader shards concatenated host-side, so per-device
  batch shards are identical to the multi-process run and losses must
  match bitwise.

Emits ``<out>/result_p<process_id>.json`` with per-step losses, the
save_checkpoint return (None on non-zero processes — the write gate
under test), a params digest, and the loader cursor.

Not a pytest module (no ``test_`` prefix); launched via subprocess.
"""

import argparse
import hashlib
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--train-dir", required=True)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--ckpt-at", type=int, default=0,
                    help="save a checkpoint after this step (0 = never)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint + loader cursor "
                         "before stepping")
    ap.add_argument("--model-axis", type=int, default=1,
                    help=">1 = hybrid DP x TP regime over a "
                         "(data, model) mesh (GSPMD-sharded encoder "
                         "matmuls + shard_map CTC/feature islands)")
    ap.add_argument("--global-devices", type=int, default=2,
                    help="global device count (= virtual CPU devices "
                         "in the single-process reference mode)")
    ap.add_argument("--dense-units", type=int, default=32,
                    help=">=256 makes the dense frontend actually "
                         "shard over 'model' (mesh._param_spec rule)")
    args = ap.parse_args()

    # environment must be pinned BEFORE jax imports: CPU platform, gloo
    # cross-process collectives
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["JAX_CPU_COLLECTIVES_IMPLEMENTATION"] = "gloo"
    if args.num_processes == 1:
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count="
            f"{args.global_devices}").strip()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    import numpy as np
    import jax

    from ctc_asr import checkpoint as ckpt_mod
    from ctc_asr.config import (Config, DataConfig, FeatureConfig,
                                MeshConfig, ModelConfig, TrainConfig)
    from ctc_asr.data import DataLoader, read_manifest
    from ctc_asr.parallel.dist import (initialize_distributed,
                                       make_sharded_train_step,
                                       process_local_batch,
                                       shard_tree)
    from ctc_asr.parallel.mesh import (batch_sharding, build_mesh,
                                       state_shardings)
    from ctc_asr.train import init_train_state

    initialize_distributed(MeshConfig(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes, process_id=args.process_id))
    mesh_cfg = MeshConfig(model_axis=args.model_axis,
                          shard_model=args.model_axis > 1)
    # batch shards over 'data' only; with TP the same shard is
    # replicated across the model axis
    n_shards = args.global_devices // args.model_axis

    cfg = Config(
        features=FeatureConfig(feature_type="mfcc", n_mfcc=13),
        model=ModelConfig(frontend="dense", dense_layers=1,
                          dense_units=args.dense_units,
                          rnn_layers=1, rnn_units=32, dropout=0.0,
                          compute_dtype="float32"),
        data=DataConfig(train_manifest=args.manifest, batch_size=2,
                        num_buckets=1, num_workers=1,
                        min_audio_seconds=0.05, max_audio_seconds=10.0),
        train=TrainConfig(learning_rate=3e-3, total_steps=args.steps,
                          train_dir=args.train_dir),
        mesh=mesh_cfg,
    )

    manifest = read_manifest(args.manifest)
    mesh = build_mesh(mesh_cfg, jax.devices())
    state = init_train_state(cfg)
    step_fn = make_sharded_train_step(cfg, mesh, state)

    if args.num_processes > 1:
        # data-row-aware sharding (train._loader_sharding_for_mesh):
        # under TP, processes sharing a data row load the SAME shard
        from ctc_asr.train import _loader_sharding_for_mesh
        shard_idx, num_shards = _loader_sharding_for_mesh(mesh)
        loaders = [DataLoader(manifest, cfg.data, cfg.features,
                              shard_idx=shard_idx,
                              num_shards=num_shards)]
    else:
        # single-process reference: the same shard streams,
        # concatenated host-side in mesh data-row order
        loaders = [DataLoader(manifest, cfg.data, cfg.features,
                              shard_idx=s, num_shards=n_shards)
                   for s in range(n_shards)]

    start_step = 0
    restored, meta = ckpt_mod.restore_latest(
        os.path.join(args.train_dir, "ckpt"), state)
    if args.resume:
        assert restored is not None, "resume requested but no checkpoint"
        state = jax.device_get(restored)
        start_step = int(np.asarray(state["step"]))
        for ld in loaders:
            ld.load_state_dict(meta["loader"])

    gstate = shard_tree(mesh, state,
                        state_shardings(state, mesh,
                                        mesh_cfg.shard_model))
    iters = [iter(ld) for ld in loaders]
    losses, ckpt_path = [], None
    for k in range(start_step, args.steps):
        bs = [next(it) for it in iters]
        if args.num_processes > 1:
            arrs = process_local_batch(
                mesh, (bs[0].samples, bs[0].sample_lengths,
                       bs[0].labels, bs[0].label_lengths))
        else:
            bsh = batch_sharding(mesh)
            arrs = tuple(
                jax.device_put(np.concatenate([getattr(b, f) for b in bs]),
                               bsh)
                for f in ("samples", "sample_lengths", "labels",
                          "label_lengths"))
        gstate, m = step_fn(gstate, *arrs)
        losses.append(float(np.asarray(m["loss"])))
        if args.ckpt_at and k + 1 == args.ckpt_at:
            ckpt_path = ckpt_mod.save_checkpoint(
                os.path.join(args.train_dir, "ckpt"), k + 1, gstate,
                metadata={"loader": loaders[0].state_dict()})
    for it in iters:
        it.close()

    # under TP the state is 'model'-sharded (not fully addressable per
    # process): all-gather to replicated before reading it back
    from jax.sharding import NamedSharding, PartitionSpec
    rep = NamedSharding(mesh, PartitionSpec())
    gstate = jax.jit(
        lambda s: s,
        out_shardings=jax.tree.map(lambda _: rep, gstate))(gstate)
    host = jax.device_get(gstate)
    digest = hashlib.sha256()
    for leaf in jax.tree.leaves(host["params"]):
        digest.update(np.ascontiguousarray(np.asarray(leaf)).tobytes())
    out = {
        "process_id": args.process_id,
        "process_count": jax.process_count(),
        "global_devices": len(jax.devices()),
        "losses": losses,
        "ckpt_path": ckpt_path,
        "params_sha": digest.hexdigest(),
        "final_step": int(np.asarray(host["step"])),
        "loader_cursor": loaders[0].state_dict(),
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out,
                           f"result_p{args.process_id}.json"), "w") as f:
        json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
