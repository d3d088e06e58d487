"""Time the full train step with the GPU kernel against the plain XLA
version it replaces, on the card.

    python scripts/step_ab.py [--preset deepspeech_beam] [--batch 16]
        [--utterances 128] [--steps 20] [--out chiprun_out/step_ab]

The batch is the first batch of a seeded synthetic corpus
(``data/synth.py``, one length bucket), so T' and U are the shapes the
one-card smoke run trains at. Variants, each a fresh state on the same
batch:

- ``xla``: the scan CTC reference (``ops/ctc_ref.ctc_loss_ref``);
- ``ctc_triton``: the Triton CTC kernel (``ops/ctc_triton.py``).

They run in the order given, then in reverse, so drift on the card
shows up as a difference between the two passes. Each timed window
starts after two warm-up steps and ends in ``block_until_ready``.
Printed per variant: compile seconds, step seconds of both passes and
the loss at every step; then peak device memory. Also printed: the feature extraction's time
alone at the same batch, and a profiler trace of three ``xla`` steps is
written under ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

VARIANTS = ("xla", "ctc_triton")


def make_step(cfg, variant: str):
    """The jitted train step with the CTC loss pinned to the variant's
    NLL, through ``make_step_fn``'s ``ctc_fn`` hook."""
    import jax
    from ctc_asr.ops.ctc_ref import ctc_loss, ctc_loss_ref
    from ctc_asr.ops.ctc_triton import ctc_loss_triton
    from ctc_asr.train import make_step_fn
    nll = ctc_loss_triton if variant == "ctc_triton" else ctc_loss_ref
    return jax.jit(make_step_fn(cfg, ctc_fn=partial(ctc_loss, nll_fn=nll)),
                   donate_argnums=(0,))


def first_batch(preset: str, batch: int, n_utts: int, workdir: str):
    from ctc_asr import config as cfg_mod
    from ctc_asr.data import DataLoader, read_manifest
    from ctc_asr.data.synth import generate_corpus
    cfg = cfg_mod.apply_overrides(cfg_mod.preset(preset), {
        "data.batch_size": batch, "data.num_buckets": 1})
    manifest = generate_corpus(os.path.join(workdir, "corpus"),
                               num_utterances=n_utts, seed=0)
    loader = DataLoader(read_manifest(manifest), cfg.data, cfg.features)
    it = iter(loader)
    b = next(it)
    it.close()
    return cfg, (b.samples, b.sample_lengths, b.labels, b.label_lengths)


def time_variant(cfg, batch, variant: str, steps: int):
    import jax
    import numpy as np
    from ctc_asr.train import init_train_state

    step = make_step(cfg, variant)
    state = init_train_state(cfg)
    t0 = time.perf_counter()
    compiled = step.lower(state, *batch).compile()
    compile_s = time.perf_counter() - t0
    losses = []
    for _ in range(2):
        state, m = compiled(state, *batch)
        losses.append(m["loss"])
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = compiled(state, *batch)
        losses.append(m["loss"])
    jax.block_until_ready(state)
    step_s = (time.perf_counter() - t0) / steps
    return {"compile_s": compile_s, "step_s": step_s,
            "losses": [float(x) for x in np.asarray(jax.device_get(
                losses))]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="deepspeech_beam")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--utterances", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default="chiprun_out/step_ab")
    ap.add_argument("--workdir", default=".smoke_work/step_ab",
                    help="corpus location (kept out of --out)")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    from ctc_asr.utils.compile_cache import setup_compile_cache
    setup_compile_cache()
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"needs a GPU, JAX found {dev.platform}", file=sys.stderr)
        return 2
    from ctc_asr.utils.profiling import card_line
    smi = card_line()
    print(f"card: {smi} | jax {jax.__version__} | "
          f"{dev.device_kind}", flush=True)

    cfg, host_batch = first_batch(args.preset, args.batch,
                                  args.utterances, args.workdir)
    batch = tuple(jax.device_put(x) for x in host_batch)
    print(f"batch: samples {host_batch[0].shape} labels "
          f"{host_batch[2].shape}", flush=True)

    from ctc_asr import features as feat_mod
    feat = jax.jit(lambda s, sl: feat_mod.extract_features(
        s, sl, cfg.features))
    jax.block_until_ready(feat(*batch[:2]))
    t0 = time.perf_counter()
    for _ in range(args.steps):
        out = feat(*batch[:2])
    jax.block_until_ready(out)
    feat_s = (time.perf_counter() - t0) / args.steps
    print(f"features alone: {feat_s * 1e3:.3f} ms", flush=True)

    variants = args.variants.split(",")
    results = {v: {"step_s": []} for v in variants}
    for v in variants + variants[::-1]:
        try:
            r = time_variant(cfg, batch, v, args.steps)
        except Exception as e:  # report and go on: one variant's failure
            import traceback   # must not hide the others' numbers
            traceback.print_exc()
            results[v]["error"] = f"{type(e).__name__}: {e}"[:400]
            continue
        results[v]["step_s"].append(r["step_s"])
        results[v]["compile_s"] = r["compile_s"]
        results[v]["losses"] = r["losses"]
        print(f"{v}: compile {r['compile_s']:.1f} s, step "
              f"{r['step_s'] * 1e3:.3f} ms, loss {r['losses'][0]:.4f} -> "
              f"{r['losses'][-1]:.4f}", flush=True)
    results["features_s"] = feat_s
    results["peak_bytes_in_use"] = dev.memory_stats().get(
        "peak_bytes_in_use")
    results["card"] = smi
    results["batch_shapes"] = [list(x.shape) for x in host_batch]

    # one short trace of the plain step, for the layer breakdown
    from ctc_asr.train import init_train_state
    step = make_step(cfg, "xla")
    state = init_train_state(cfg)
    state, m = step(state, *batch)
    jax.block_until_ready(state)
    jax.profiler.start_trace(os.path.join(args.out, "trace_xla"))
    for _ in range(3):
        state, m = step(state, *batch)
    jax.block_until_ready(state)
    jax.profiler.stop_trace()
    with open(os.path.join(args.out, "step_ab.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({k: (v if k != "losses" else None)
                      for k, v in results.items()}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
