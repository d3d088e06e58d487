"""End-to-end smoke/benchmark: train on the synthetic corpus, eval WER.

The PR1 measured-baseline run (BASELINE.md): with no LibriSpeech in this
environment, the synthetic corpus (data/synth.py) provides a learnable
audio->text task. Trains the PR1-style model, then reports greedy WER,
XLA-beam WER and Pallas-beam WER + RTF as one JSON line.

Usage: python scripts/run_synth_e2e.py [--steps 500] [--n 96] [--out DIR]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--out", default="/tmp/ctc_asr_e2e")
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()

    from ctc_asr.config import (Config, DataConfig, DecodeConfig,
                                FeatureConfig, ModelConfig, TrainConfig)
    from ctc_asr.data import DataLoader, read_manifest
    from ctc_asr.data.synth import generate_corpus
    from ctc_asr.evaluate import evaluate
    from ctc_asr.train import train

    corpus_dir = os.path.join(args.out, "corpus")
    manifest_path = os.path.join(corpus_dir, "manifest.csv")
    if not os.path.exists(manifest_path):
        manifest_path = generate_corpus(corpus_dir, num_utterances=args.n,
                                        seed=0, min_words=1, max_words=3)
    cfg = Config(
        features=FeatureConfig(feature_type="mfcc", n_mfcc=26, n_mels=40),
        model=ModelConfig(frontend="dense", dense_layers=2,
                          dense_units=256, rnn_layers=2, rnn_units=256,
                          bidirectional=False, dropout=0.0),
        data=DataConfig(train_manifest=manifest_path,
                        eval_manifest=manifest_path,
                        batch_size=args.batch, num_buckets=2,
                        num_workers=4, min_audio_seconds=0.05,
                        max_audio_seconds=10.0),
        train=TrainConfig(learning_rate=2e-3, total_steps=args.steps,
                          log_every=50, eval_every=10 ** 9,
                          checkpoint_every=args.steps,
                          train_dir=os.path.join(args.out, "train")),
        decode=DecodeConfig(method="greedy"),
    )

    t0 = time.time()
    state = train(cfg)
    train_wall = time.time() - t0

    manifest = read_manifest(manifest_path)
    results = {"train_steps": int(state["step"]),
               "train_wall_s": round(train_wall, 1)}

    def eval_with(decode_cfg, tag):
        c = Config(features=cfg.features, model=cfg.model, data=cfg.data,
                   train=cfg.train, decode=decode_cfg, mesh=cfg.mesh)
        loader = DataLoader(manifest, c.data, c.features, drop_last=False)
        r = evaluate(c, state["params"], loader=loader, log_samples=1)
        results[f"{tag}_wer"] = round(r["wer"], 4)
        results[f"{tag}_cer"] = round(r["cer"], 4)
        results[f"{tag}_rtf"] = round(r["rtf"], 5)

    eval_with(DecodeConfig(method="greedy"), "greedy")
    eval_with(DecodeConfig(method="beam", beam_width=16), "beam16")
    print(json.dumps(results))


if __name__ == "__main__":
    main()
