"""Smoke run of the main path on one CUDA GPU, in one process.

    python chip_smoke.py            # one card: the phases below
    python chip_smoke.py --four     # four cards: the DP path only

Phases of the one-card run, each an importable function:

1. ``device_check``: JAX's first device must be a GPU, or the run exits
   non-zero before printing any result. Prints the card's name and
   power limit (``nvidia-smi``), the jax/jaxlib versions, ``XLA_FLAGS``
   and the compile-cache directory.
2. ``main_path``: through ``ctc_asr.cli`` as a user calls it, with
   the full-width ``deepspeech_beam`` preset (conv 32/32 + 5x
   BiLSTM-800, 29 classes, beam 64) and random weights from the seed:
   ``prepare-synth`` (a seeded synthetic corpus), ``train`` (30 steps at
   B=16, one length bucket; the loss must be finite and fall),
   ``train-lm`` (order-4 char LM), ``evaluate`` (beam 64 with char-LM
   fusion) and ``transcribe`` (one wav). Prints compile seconds apart
   from step seconds, peak device memory, the first and last loss and
   the eval WER.
3. ``ctc_parity``: the one hand-written kernel the card runs, the
   Triton CTC kernel, against the scan CTC reference in float64, NLL
   and gradient, at the ds3 training shape (B=16, T' and U of the
   corpus) and at the contract shape B=128, T'=400, U=96, C=29.
4. ``gpu_tests``: ``pytest -m gpu`` in this process.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``,
printed only when every phase passed. Work files (corpus, checkpoints)
go under ``.smoke_work/chip_smoke`` in the checkout; each run trains
from a fresh train directory, never from an earlier run's checkpoint.

``--four`` runs the data-parallel path of ``configs/multihost_dp.json``
(docs/MULTIHOST.md): four ``cli train`` processes, one per card, joined
through a localhost coordinator at global batch 64 (16 per card), and,
after they exit, the same global batches on one card in this process,
which stays off JAX until then. The loss at every step must match
within ``FOUR_LOSS_RTOL``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import time
from functools import partial

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from ctc_asr import cli  # noqa: E402
from ctc_asr.utils.compile_cache import setup_compile_cache  # noqa: E402

WORKDIR = os.path.join(REPO, ".smoke_work", "chip_smoke")
PRESET = "deepspeech_beam"
# Triton kernel vs the scan reference in float64, counted in float32
# rounding units (2^-23): each utterance's NLL within CTC_ULPS units,
# relative; the gradient within CTC_ULPS units of the largest NLL,
# absolute, since the α/β log-sums it comes from carry values of that
# size. On the CPU, the float32 scan reference reads <= 6 units on
# both at B=128, T'=400, U=96; the same reference fed bf16-rounded
# log-probabilities reads >= 150 on the gradient and >= 1800 on the NLL.
EPS32, CTC_ULPS = 2.0 ** -23, 32
# 4-card DP vs one card at the same global batch: bf16 matmuls of other
# shapes and NCCL's reduction order change the last bits of each step.
FOUR_LOSS_RTOL = 2e-3


def device_check(require_gpu: bool = True) -> dict:
    """The device JAX reports; exits non-zero unless it is a GPU."""
    import jax
    import jaxlib
    dev = jax.devices()[0]
    if require_gpu and dev.platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX's first device is "
                         f"{dev.platform!r} ({dev.device_kind})")
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    if dev.platform == "gpu":
        from ctc_asr.utils.profiling import card_line
        print(f"[device] card: {card_line()}", flush=True)
    print(f"[device] {info} jax {jax.__version__} jaxlib "
          f"{jaxlib.__version__}", flush=True)
    print(f"[device] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
          f"compile cache {jax.config.jax_compilation_cache_dir!r}",
          flush=True)
    return info


class CompileClock:
    """Sums JAX's compile-phase durations (trace, lowering, backend
    compile) reported while it is active."""

    def __init__(self):
        self.seconds = 0.0
        self.active = False
        import jax
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event: str, duration: float, **_) -> None:
        if self.active and event.startswith("/jax/core/compile/"):
            self.seconds += duration

    @contextlib.contextmanager
    def measure(self):
        self.seconds, self.active = 0.0, True
        try:
            yield self
        finally:
            self.active = False


def _cli(args: list[str]) -> str:
    """Run one cli command in this process; returns its stdout (also
    echoed). A non-zero return code is a failed phase."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    out = buf.getvalue()
    sys.stdout.write(out)
    sys.stdout.flush()
    if rc != 0:
        raise RuntimeError(f"cli {args[0]} returned {rc}")
    return out


def train_shape(preset: str, manifest: str, args: list) -> tuple:
    """(T', U) of the training batches: encoder frames and label width
    of the one length bucket the loader pads to."""
    from ctc_asr import config as cfg_mod
    from ctc_asr.data import read_manifest
    from ctc_asr.data.loader import BatchSpec
    from ctc_asr.features import num_frames
    from ctc_asr.models.encoder import time_downsample_factor
    flags = dict(a[2:].split("=", 1) for a in args
                 if a.startswith("--") and "=" in a)
    cfg = cfg_mod.apply_overrides(cfg_mod.preset(preset), flags)
    bucket = BatchSpec.from_manifest(read_manifest(manifest), cfg.data,
                                     cfg.features).buckets[0]
    f = time_downsample_factor(cfg.model)
    T = -(-num_frames(bucket.max_samples, cfg.features) // f)
    return T, bucket.max_label_len


def main_path(workdir: str, preset: str = PRESET, utterances: int = 128,
              steps: int = 30, batch: int = 16,
              overrides: tuple = ()) -> dict:
    """prepare-synth -> train -> train-lm -> evaluate -> transcribe."""
    import jax
    corpus = os.path.join(workdir, "corpus")
    train_dir = os.path.join(workdir, "train")
    lm_path = os.path.join(workdir, "char_lm.npz")
    # cli train resumes from a checkpoint and appends to metrics.jsonl
    shutil.rmtree(train_dir, ignore_errors=True)
    manifest = _cli(["prepare-synth", "--out", corpus, "--n",
                     str(utterances), "--seed", "0"]).strip().splitlines()[-1]
    common = ["--preset", preset, f"--data.train_manifest={manifest}",
              f"--data.eval_manifest={manifest}",
              f"--data.batch_size={batch}", "--data.num_buckets=1",
              "--mesh.data_axis=1", *overrides]
    clock = CompileClock()
    with clock.measure():
        _cli(["train", *common, f"--train.total_steps={steps}",
              "--train.log_every=1", "--train.eval_every=0",
              f"--train.checkpoint_every={steps}",
              f"--train.train_dir={train_dir}"])
    frames, label_len = train_shape(preset, manifest, common)
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss"] for r in recs if "loss" in r]
    step_s = statistics.median(r["step_time_s"] for r in recs[2:]
                               if "step_time_s" in r)
    peak = jax.devices()[0].memory_stats() or {}
    out = {"loss_first": losses[0], "loss_last": losses[-1],
           "train_compile_s": clock.seconds, "train_step_s": step_s,
           "peak_bytes_in_use": peak.get("peak_bytes_in_use"),
           "train_frames": frames, "train_label_len": label_len}
    if not all(math.isfinite(x) for x in losses) or len(losses) != steps:
        raise RuntimeError(f"train losses not finite/complete: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not fall: {losses[0]} -> "
                           f"{losses[-1]}")

    _cli(["train-lm", "--manifest", manifest, "--out", lm_path,
          "--order", "4"])
    with clock.measure():
        ev = _cli(["evaluate", *common, "--ckpt", train_dir,
                   "--decode.method=beam", "--decode.beam_width=64",
                   f"--decode.lm_path={lm_path}"])
    res = json.loads(ev[ev.rindex("\n{") + 1:])
    out.update(eval_wer=res["wer"], eval_compile_s=clock.seconds,
               eval_rtf=res["rtf"])
    if not (math.isfinite(res["wer"]) and res["utterances"] > 0):
        raise RuntimeError(f"evaluate returned {res}")

    wav = os.path.join(corpus, "wav", "utt00000.wav")
    tr = _cli(["transcribe", *common, "--ckpt", train_dir,
               "--decode.method=beam", f"--decode.lm_path={lm_path}", wav])
    # "<wav>\t<text>"; a barely trained model may well emit no text
    line = tr.rstrip("\n").splitlines()[-1]
    if not line.startswith(wav + "\t"):
        raise RuntimeError(f"transcribe printed {tr!r}")
    out["transcript"] = line.split("\t", 1)[1]
    print(f"[main_path] {json.dumps(out)}", flush=True)
    return out


def ctc_parity(shapes, interpret: bool = False, seed: int = 0) -> list:
    """Triton CTC kernel against ``ctc_loss_ref`` in float64 for each
    (B, T, U) with C=29: per-utterance NLL and its gradient. The float32
    reference and a control (that reference fed bf16-rounded
    log-probabilities) are read against the same limits; the first must
    pass them and the control must not, or the limits tell nothing."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ctc_asr.ops.ctc_ref import ctc_loss_ref
    from ctc_asr.ops.ctc_triton import ctc_loss_triton

    def bf16_control(lg, *args):
        # reduce_precision: XLA may drop a bf16 round trip of astypes
        lp = jax.lax.reduce_precision(jax.nn.log_softmax(lg), 8, 7)
        return ctc_loss_ref(lp, *args)

    rows = []
    for B, T, U in shapes:
        rng = np.random.default_rng(seed)
        logits = rng.standard_normal((B, T, 29)).astype(np.float32)
        args = (jnp.asarray(rng.integers(T // 2, T + 1, B), jnp.int32),
                jnp.asarray(rng.integers(0, 28, (B, U)), jnp.int32),
                jnp.asarray(rng.integers(U // 2, U + 1, B), jnp.int32))

        def nll_grad(fn, x):
            nll, vjp = jax.vjp(lambda lg: fn(lg, *args), x)
            return nll, vjp(jnp.ones_like(nll))[0]

        with jax.enable_x64(True):
            want = [np.asarray(a, np.float64) for a in jax.jit(
                lambda x: nll_grad(partial(ctc_loss_ref, dtype=jnp.float64),
                                   x))(jnp.asarray(logits, jnp.float64))]
        lim = {"nll_rel": CTC_ULPS * EPS32,
               "grad_abs": CTC_ULPS * EPS32 * float(np.max(want[0]))}

        def read(fn):
            nll, grad = (np.asarray(a, np.float64) for a in jax.jit(
                lambda x: nll_grad(fn, x))(jnp.asarray(logits)))
            return {"nll_rel": float(np.max(np.abs(nll - want[0]) / want[0])),
                    "grad_abs": float(np.max(np.abs(grad - want[1])))}

        with jax.default_matmul_precision("highest"):
            ref32, control = read(ctc_loss_ref), read(bf16_control)
        row = {"B": B, "T": T, "U": U, "limit": lim,
               "kernel": read(partial(ctc_loss_triton, interpret=interpret)),
               "ref_f32": ref32, "control_bf16": control}
        print(f"[ctc_parity] {json.dumps(row)}", flush=True)

        def within(r):  # NaN (an infeasible utterance) is never within
            return all(r[m] <= lim[m] for m in lim)
        if not within(ref32) or within(control):
            raise RuntimeError("CTC limits do not separate float32 from "
                               f"bf16 rounding: {row}")
        if not within(row["kernel"]):
            raise RuntimeError(f"CTC kernel off the float64 reference: {row}")
        rows.append(row)
    return rows


def gpu_tests() -> None:
    """The tests only the card can run (``pytest -m gpu``), in this
    process, since a second JAX process could not claim the card."""
    import pytest
    os.environ["CTC_ASR_GPU_TESTS"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests")])
    if rc != 0:
        raise RuntimeError(f"pytest -m gpu exited {rc}")


# ---------------------------------------------------------------------------
# --four: data parallelism over four cards vs one card
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


FOUR_COMMON = ["--preset", "multihost_dp", "--data.batch_size=16",
               "--data.num_buckets=1", "--model.dropout=0.0",
               "--train.log_every=1", "--train.eval_every=0"]


def run_four_processes(workdir: str, manifest: str, steps: int,
                       n: int = 4, extra: tuple = (),
                       timeout: int = 300) -> list:
    """``cli train`` in ``n`` processes, one card each, joined through a
    localhost coordinator; returns process 0's per-step losses."""
    port = _free_port()
    train_dir = os.path.join(workdir, "dp_train")
    shutil.rmtree(train_dir, ignore_errors=True)  # no resume, no append
    procs = []
    for pid in range(n):
        cmd = [sys.executable, "-m", "ctc_asr.cli", "train",
               *FOUR_COMMON, *extra, f"--data.train_manifest={manifest}",
               f"--train.total_steps={steps}",
               f"--train.checkpoint_every={steps}",
               f"--train.train_dir={train_dir}",
               f"--mesh.coordinator_address=localhost:{port}",
               f"--mesh.num_processes={n}", f"--mesh.process_id={pid}",
               f"--mesh.local_device_ids=[{pid}]"]
        log = open(os.path.join(workdir, f"dp_p{pid}.log"), "w")
        procs.append((subprocess.Popen(cmd, cwd=REPO, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    try:
        for p, _ in procs:
            p.wait(timeout=timeout)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for pid, (p, _) in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(workdir, f"dp_p{pid}.log")) as f:
                lines = f.read().splitlines()
            # the first lines that name an error, then the end of the log
            errs = [ln for ln in lines
                    if "rror" in ln or "failed" in ln or "WARN" in ln][:20]
            raise RuntimeError(f"DP process {pid} exited {p.returncode}:\n"
                               + "\n".join(errs + ["..."] + lines[-15:]))
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f
                if '"loss"' in line]


def one_card_losses(manifest: str, steps: int, n_shards: int = 4,
                    extra: tuple = ()) -> list:
    """The same global batches on one card: each step concatenates the
    batches of the ``n_shards`` per-process loader shards, in mesh
    order, and runs the single-device step."""
    import jax
    import numpy as np
    from ctc_asr import config as cfg_mod
    from ctc_asr.data import DataLoader, read_manifest
    from ctc_asr.train import init_train_state, make_train_step

    flags = dict(a[2:].split("=", 1) for a in (*FOUR_COMMON, *extra)
                 if a.startswith("--") and "=" in a)
    cfg = cfg_mod.apply_overrides(cfg_mod.preset("multihost_dp"), flags)
    man = read_manifest(manifest)
    iters = [iter(DataLoader(man, cfg.data, cfg.features, shard_idx=s,
                             num_shards=n_shards))
             for s in range(n_shards)]
    step = make_train_step(cfg)
    state = init_train_state(cfg)
    losses = []
    try:
        for _ in range(steps):
            bs = [next(it) for it in iters]
            arrs = [np.concatenate([getattr(b, f) for b in bs])
                    for f in ("samples", "sample_lengths", "labels",
                              "label_lengths")]
            state, m = step(state, *arrs)
            losses.append(m["loss"])
    finally:
        for it in iters:
            it.close()
    return [float(x) for x in jax.device_get(losses)]


def four_cards(workdir: str, steps: int = 5, n: int = 4,
               utterances: int = 256, extra: tuple = ()) -> dict:
    """DP over ``n`` processes (one card each), then the same global
    batches on one card; returns both loss curves. The caller must not
    have touched a device before: the children need the cards."""
    manifest = _cli(["prepare-synth", "--out",
                     os.path.join(workdir, "corpus"), "--n",
                     str(utterances), "--seed", "0"]
                    ).strip().splitlines()[-1]
    t0 = time.perf_counter()
    dp = run_four_processes(workdir, manifest, steps, n, extra)
    dp_s = time.perf_counter() - t0
    one = one_card_losses(manifest, steps, n, extra)
    rel = [abs(a - b) / abs(b) for a, b in zip(dp, one)]
    out = {"dp_losses": dp, "one_card_losses": one, "max_rel_diff":
           max(rel), "rtol": FOUR_LOSS_RTOL, "dp_wall_s": dp_s}
    print(f"[four] {json.dumps(out)}", flush=True)
    if len(dp) != steps or not max(rel) <= FOUR_LOSS_RTOL:
        raise RuntimeError(f"{n}-card DP loss off the one-card run: {out}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="four cards: the DP path and its one-card "
                         "comparison, no other phase")
    args = ap.parse_args(argv)
    workdir = os.path.join(WORKDIR, "four" if args.four else "one")
    os.makedirs(workdir, exist_ok=True)
    setup_compile_cache()
    if args.four:
        four_cards(workdir)
        # JAX touches a device only now: the children released the cards
        info = device_check()
    else:
        info = device_check()
        res = main_path(workdir)
        ctc_parity([(16, res["train_frames"], res["train_label_len"]),
                    (128, 400, 96)])
        gpu_tests()
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
