"""Benchmark harness: train throughput + decode RTF on one CUDA GPU.

    python bench.py [--model ds2|ds3|tiny] [--steps 10] [--warmup 3]
                    [--batch N] [--seconds S] [--no-decode] [--no-ds3]
                    [--decode-ckpt CKPT --decode-manifest CSV]

Prints ONE JSON line:
  {"metric": "train_throughput", "value": N, "unit": "audio-s/s/card",
   "step_time_s": ..., "step_mfu": ..., "decode_rtf": R, ...,
   "platform": "gpu", "device_kind": ..., "n_devices": ...,
   "card": "<nvidia-smi name>, <power limit>"}

Train throughput: a fixed batch of random audio (``--seconds`` long)
resident on the device; ``--warmup`` steps (compilation included), then
a window of ``--steps`` steps that ends in ``block_until_ready``.
``step_mfu`` is the model's algorithmic matmul FLOPs per step over the
step time and the card's published bf16 peak (utils/profiling.PEAKS; a
card not in that table is an error). Decode RTF: beam 64 (and 16) on
posteriors of the same model after a few training steps on rendered
synthetic utterances; ``--decode-ckpt``/``--decode-manifest`` (or the
CTC_ASR_BENCH_CKPT/CTC_ASR_BENCH_MANIFEST env vars) add the RTF and WER
of a trained checkpoint on real utterances.

Needs a GPU: on any other device it exits non-zero and prints no
result.
"""

import argparse
import json
import os
import sys

import numpy as np


def build_cfg(arm: str):
    from ctc_asr.config import (Config, DataConfig, FeatureConfig,
                                ModelConfig, TrainConfig)
    if arm == "tiny":
        model = ModelConfig(frontend="conv", conv_channels=(8, 8),
                            conv_kernels=((5, 5), (3, 3)),
                            conv_strides=((2, 2), (1, 2)), rnn_layers=1,
                            rnn_units=128, bidirectional=True, dropout=0.0)
        batch, seconds = 4, 2.0
    elif arm == "ds3":
        # flagship: conv frontend + 5x BiLSTM-800
        model = ModelConfig(frontend="conv", rnn_layers=5, rnn_units=800,
                            bidirectional=True, dropout=0.0)
        batch, seconds = 128, 8.0
    else:  # "ds2": conv frontend + 3x BiLSTM-512
        model = ModelConfig(frontend="conv", rnn_layers=3, rnn_units=512,
                            bidirectional=True, dropout=0.0)
        batch, seconds = 128, 8.0
    cfg = Config(
        features=FeatureConfig(feature_type="mel", n_mels=80),
        model=model,
        data=DataConfig(batch_size=batch),
        train=TrainConfig(learning_rate=1e-4, seed=0),
    )
    return cfg, batch, seconds


def model_step_flops(cfg, batch: int, seconds: float) -> float:
    """Analytic ALGORITHMIC matmul FLOPs of one train step (fwd ~x3 for
    fwd+bwd, the standard MFU convention — counts the math the model
    defines, not the banded/padded formulation actually executed).
    Elementwise/DSP work is excluded (<2% of the dot FLOPs here)."""
    fcfg, m = cfg.features, cfg.model
    T = int(seconds * 1000 / fcfg.hop_ms)          # feature frames
    F = fcfg.feature_dim
    fwd = 0.0
    if m.frontend == "conv":
        t, f, cin = T, F, 1
        for ch, (kt, kf), (st, sf) in zip(m.conv_channels, m.conv_kernels,
                                          m.conv_strides):
            t, f = -(-t // st), -(-f // sf)
            fwd += 2.0 * t * f * ch * kt * kf * cin
            cin = ch
        d, Tp = f * cin, t
    else:
        d, Tp = F, T
        for _ in range(m.dense_layers):
            fwd += 2.0 * Tp * d * m.dense_units
            d = m.dense_units
    H = m.rnn_units
    gates = {"lstm": 4, "gru": 3, "rnn": 1}[m.rnn_type]
    nd = 2 if m.bidirectional else 1
    for _ in range(m.rnn_layers):
        fwd += nd * 2.0 * Tp * (d * gates * H + H * gates * H)
        d = nd * H
    fwd += 2.0 * Tp * d * m.num_classes
    return 3.0 * fwd * batch


def make_batch(cfg, batch, seconds, rng):
    sr = cfg.features.sample_rate
    S = int(seconds * sr)
    U = max(16, int(seconds * 12))  # ~12 chars/s of speech
    samples = (rng.standard_normal((batch, S)) * 0.1).astype(np.float32)
    slens = np.full((batch,), S, np.int32)
    labels = rng.integers(0, 28, (batch, U)).astype(np.int32)
    llens = np.full((batch,), U, np.int32)
    return (samples, slens, labels, llens), batch * seconds


def make_synth_batch(cfg, batch, seconds, rng):
    """Rendered synth utterances with REAL transcripts, shaped exactly
    like make_batch's random batch so the already-compiled train step
    is reused. Training a few steps on this gives peaked, structured
    posteriors — decoding random-logit posteriors under-exercises the
    beam's merge path."""
    from ctc_asr.data.synth import build_vocabulary, render_transcript
    from ctc_asr.text import encode
    sr = cfg.features.sample_rate
    S = int(seconds * sr)
    U = max(16, int(seconds * 12))
    vocab = build_vocabulary(64)
    # leave headroom: rendering is ~0.09 s/char with jittered envelopes;
    # clamp so sub-second --seconds still yields non-empty transcripts
    max_chars = min(U, max(4, int(seconds / 0.09) - 4))
    samples = np.zeros((batch, S), np.float32)
    slens = np.empty((batch,), np.int32)
    labels = np.zeros((batch, U), np.int32)
    llens = np.empty((batch,), np.int32)
    for i in range(batch):
        words = []
        n = 0
        while True:
            w = str(vocab[int(rng.integers(len(vocab)))])
            if n + len(w) + (1 if words else 0) > max_chars:
                break
            n += len(w) + (1 if words else 0)
            words.append(w)
        tr = " ".join(words)
        sig = render_transcript(tr, sr=sr, seed=1000 + i)
        ln = min(len(sig), S)
        samples[i, :ln] = sig[:ln]
        slens[i] = ln
        ids = encode(tr)
        labels[i, :len(ids)] = ids
        llens[i] = len(ids)
    return (samples, slens, labels, llens), float(slens.sum()) / sr


def bench_train(cfg, batch, seconds, steps, warmup):
    """(audio_s_per_s, step_time_s, step_fn, state) on one device."""
    import jax
    from ctc_asr.train import init_train_state, make_train_step
    from ctc_asr.utils.profiling import time_fn

    rng = np.random.default_rng(0)
    box = {"state": init_train_state(cfg)}
    step_fn = make_train_step(cfg, donate=False)
    b, audio_s = make_batch(cfg, batch, seconds, rng)
    b = tuple(jax.device_put(x) for x in b)

    def one():
        box["state"], m = step_fn(box["state"], *b)
        return m["loss"]

    dt = time_fn(one, iters=steps, warmup=warmup)
    return audio_s / dt, dt, step_fn, box["state"]


def bench_decode(cfg, batch, seconds, steps, warmup, step_fn, state,
                 train_steps=40, beam_widths=(64, 16)):
    """Decode RTF per beam width on posteriors trained for
    ``train_steps`` on a rendered synth batch (same shapes as the train
    batch, so the compiled step is reused)."""
    import jax
    from ctc_asr.ops.beam import make_beam_decoder
    from ctc_asr.train import make_eval_step
    from ctc_asr.utils.profiling import time_fn

    rng = np.random.default_rng(0)
    b, audio_s = make_synth_batch(cfg, batch, seconds, rng)
    b = tuple(jax.device_put(x) for x in b)
    for _ in range(train_steps):
        state, _ = step_fn(state, *b)
    eval_step = make_eval_step(cfg)
    out = {}
    for bw in beam_widths:
        decoder = make_beam_decoder(beam_width=bw)

        def one():
            logits, logit_lens = eval_step(state["params"], b[0], b[1])
            return decoder(logits, logit_lens)

        # RTF: wall seconds per audio second (<1 = faster than real time)
        out[bw] = time_fn(one, iters=steps, warmup=warmup) / audio_s
    return out


def bench_converged_decode(cfg, batch: int, ckpt: str, manifest_path: str):
    """Beam-64 (and greedy) decode RTF and WER of a trained checkpoint
    on real manifest utterances, by evaluate()'s steady-state rule
    (each length bucket's first batch, which compiles, excluded)."""
    import dataclasses as dc
    from ctc_asr import checkpoint as ckpt_mod
    from ctc_asr.config import DataConfig, DecodeConfig, from_json
    from ctc_asr.data import DataLoader, read_manifest
    from ctc_asr.evaluate import evaluate
    from ctc_asr.train import init_train_state

    # an assets dir may pin the checkpoint's own model/feature geometry
    # (config.json, written by the run that left the checkpoint)
    if not ckpt.endswith(".npz"):
        cj = os.path.join(ckpt, "config.json")
        if os.path.exists(cj):
            with open(cj) as f:
                acfg = from_json(f.read())
            cfg = dc.replace(cfg, model=acfg.model,
                             features=acfg.features)
    cfg = dc.replace(
        cfg,
        data=dc.replace(DataConfig(), batch_size=batch, num_buckets=2,
                        min_audio_seconds=0.3, max_audio_seconds=12.0),
        decode=dc.replace(DecodeConfig(), method="beam", beam_width=64))
    path = ckpt
    if not path.endswith(".npz"):
        path = ckpt_mod.latest_checkpoint(path.rstrip("/") + "/ckpt") \
            or path
    state, _ = ckpt_mod.load_checkpoint(path, init_train_state(cfg))
    man = read_manifest(manifest_path)
    out = {}
    for name, dcfg in (("beam64", cfg.decode),
                       ("greedy", dc.replace(cfg.decode,
                                             method="greedy"))):
        c = dc.replace(cfg, decode=dcfg)
        loader = DataLoader(man, c.data, c.features, drop_last=False)
        r = evaluate(c, state["params"], loader=loader, log_samples=0)
        out[f"decode_rtf_converged_{name}"] = r["rtf"]
        out[f"decode_wer_converged_{name}"] = r["wer"]
    out["decode_converged_ckpt"] = path
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--tiny", action="store_true",
                    help="small model/batch")
    ap.add_argument("--no-decode", action="store_true",
                    help="skip the beam-decode RTF measurement")
    ap.add_argument("--batch", type=int, default=0,
                    help="override batch size")
    ap.add_argument("--seconds", type=float, default=0,
                    help="override utterance seconds")
    ap.add_argument("--decode-train-steps", type=int, default=40,
                    help="train steps on the synth batch before the "
                         "decode-RTF measurement (0 = random init)")
    ap.add_argument("--model", default="ds2",
                    choices=["ds2", "ds3", "tiny"],
                    help="bench arm: ds2 (conv+3xBiLSTM-512, default) "
                         "or the ds3 flagship (conv+5xBiLSTM-800)")
    ap.add_argument("--decode-ckpt", default="",
                    help="trained checkpoint (.npz or train dir) for the "
                         "converged decode RTF")
    ap.add_argument("--decode-manifest", default="",
                    help="manifest of real utterances for the converged "
                         "decode (pairs with --decode-ckpt)")
    ap.add_argument("--no-ds3", action="store_true",
                    help="skip the ds3 flagship secondary record")
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ctc_asr.utils.compile_cache import setup_compile_cache
    from ctc_asr.utils.profiling import card_line, device_peaks
    setup_compile_cache()
    import jax
    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        print(f"bench.py measures a GPU; JAX's first device is "
              f"{dev.platform!r} ({dev.device_kind})", file=sys.stderr)
        return 2
    peak = device_peaks(dev.device_kind)["bf16_flops"]
    arm = "tiny" if args.tiny else args.model
    cfg, batch, seconds = build_cfg(arm)
    batch = args.batch or batch
    seconds = args.seconds or seconds

    throughput, step_time, step_fn, state = bench_train(
        cfg, batch, seconds, args.steps, args.warmup)
    rec = {
        "metric": "train_throughput",
        "value": throughput,
        "unit": "audio-s/s/card",
        "step_time_s": step_time,
        "step_mfu": model_step_flops(cfg, batch, seconds)
        / (step_time * peak),
        "batch": batch,
        "utterance_seconds": seconds,
        "model": arm,
    }
    if not args.no_decode:
        rtfs = bench_decode(cfg, batch, seconds, max(args.steps // 2, 2),
                            args.warmup, step_fn, state,
                            train_steps=args.decode_train_steps)
        rec.update(decode_rtf=rtfs[64], decode_rtf_beam16=rtfs[16],
                   decode_beam_width=64,
                   decode_trained_steps=args.decode_train_steps)
    ckpt = args.decode_ckpt or os.environ.get("CTC_ASR_BENCH_CKPT", "")
    man = args.decode_manifest or os.environ.get(
        "CTC_ASR_BENCH_MANIFEST", "")
    if ckpt and man:
        rec.update(bench_converged_decode(cfg, batch, ckpt, man))
    if not args.no_ds3 and arm == "ds2":
        cfg3, batch3, seconds3 = build_cfg("ds3")
        throughput3, step3, _, _ = bench_train(cfg3, batch3, seconds3,
                                         max(args.steps // 2, 3),
                                         args.warmup)
        rec.update(ds3_value=throughput3, ds3_step_time_s=step3,
                   ds3_batch=batch3,
                   ds3_step_mfu=model_step_flops(cfg3, batch3, seconds3)
                   / (step3 * peak))
    rec.update(platform=dev.platform, device_kind=dev.device_kind,
               n_devices=len(devs), card=card_line())
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
