"""Config-ladder rung 2 on the synth corpus: conv frontend + 3x BiLSTM
(BASELINE.json:8 family), trained on the default JAX device, then
greedy + beam eval. Emits one JSON line."""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--out", default="/tmp/ctc_asr_ds2")
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
                                        seed=1, min_words=2, max_words=5)
    cfg = Config(
        features=FeatureConfig(feature_type="mel", n_mels=80),
        model=ModelConfig(frontend="conv", rnn_layers=3, rnn_units=256,
                          bidirectional=True, dropout=0.0),
        data=DataConfig(train_manifest=manifest_path,
                        eval_manifest=manifest_path,
                        batch_size=16, num_buckets=2, num_workers=4,
                        min_audio_seconds=0.05, max_audio_seconds=10.0),
        train=TrainConfig(learning_rate=1e-3, total_steps=args.steps,
                          log_every=100, eval_every=10 ** 9,
                          checkpoint_every=args.steps,
                          train_dir=os.path.join(args.out, "train")),
        decode=DecodeConfig(method="greedy"),
    )
    t0 = time.time()
    state = train(cfg)
    wall = time.time() - t0
    manifest = read_manifest(manifest_path)
    res = {"train_steps": int(state["step"]),
           "train_wall_s": round(wall, 1)}
    for tag, dec in [("greedy", DecodeConfig(method="greedy")),
                     ("beam16", DecodeConfig(method="beam",
                                                  beam_width=16))]:
        c = Config(features=cfg.features, model=cfg.model, data=cfg.data,
                   train=cfg.train, decode=dec)
        loader = DataLoader(manifest, c.data, c.features, drop_last=False)
        r = evaluate(c, state["params"], loader=loader, log_samples=0)
        res[f"{tag}_wer"] = round(r["wer"], 4)
        res[f"{tag}_rtf"] = round(r["rtf"], 5)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
