"""Held-out synth evaluation: train/eval on DISJOINT utterances.

The per-rung scripts (run_synth_*.py) evaluate on the training
manifest, so their 0% WER demonstrates convergence, not
generalization. Here the model must transcribe WORD SEQUENCES it never
saw (the char->chord audio mapping is shared, so a model that truly
learns frame->char alignment generalizes; one that memorizes
utterances does not). Emits one JSON line.
"""

import argparse, json, os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--n-train", type=int, default=256)
    ap.add_argument("--n-eval", type=int, default=64)
    ap.add_argument("--out", default="/tmp/ctc_asr_holdout")
    ap.add_argument("--specaugment", action="store_true",
                    help="train with SpecAugment (features.spec_augment)")
    args = ap.parse_args()

    from ctc_asr.config import (Config, DataConfig, DecodeConfig,
                                FeatureConfig, ModelConfig,
                                TrainConfig)
    from ctc_asr.data import DataLoader, read_manifest
    from ctc_asr.data.synth import generate_corpus
    from ctc_asr.evaluate import evaluate
    from ctc_asr.train import train

    corpus = os.path.join(args.out, "corpus")
    manifest_path = os.path.join(corpus, "manifest.csv")
    n_total = args.n_train + args.n_eval
    if not os.path.exists(manifest_path):
        manifest_path = generate_corpus(corpus, num_utterances=n_total,
                                        seed=7, min_words=2, max_words=6)
    # Disjoint split: strided so duration distributions match.
    lines = open(manifest_path).read().strip().split("\n")
    train_lines = [ln for i, ln in enumerate(lines) if i % 5 != 4]
    eval_lines = [ln for i, ln in enumerate(lines) if i % 5 == 4]
    train_manifest = os.path.join(corpus, "train.csv")
    eval_manifest = os.path.join(corpus, "eval.csv")
    open(train_manifest, "w").write("\n".join(train_lines) + "\n")
    open(eval_manifest, "w").write("\n".join(eval_lines) + "\n")

    cfg = Config(
        features=FeatureConfig(feature_type="mel", n_mels=80),
        model=ModelConfig(frontend="conv", rnn_layers=3, rnn_units=512,
                          bidirectional=True, dropout=0.05),
        data=DataConfig(train_manifest=train_manifest,
                        eval_manifest=eval_manifest,
                        batch_size=16, num_buckets=1,
                        min_audio_seconds=0.05, max_audio_seconds=10.0),
        train=TrainConfig(learning_rate=5e-4, total_steps=args.steps,
                          log_every=100, eval_every=0,
                          checkpoint_every=args.steps,
                          specaugment=args.specaugment,
                          train_dir=os.path.join(args.out, "train")),
        decode=DecodeConfig(method="beam", beam_width=16),
    )
    t0 = time.time()
    state = train(cfg)
    wall = time.time() - t0
    ev_manifest = read_manifest(eval_manifest)
    loader = DataLoader(ev_manifest, cfg.data, cfg.features,
                        drop_last=False)
    r = evaluate(cfg, state["params"], loader=loader, log_samples=3)
    print(json.dumps({
        "train_steps": int(state["step"]),
        "train_wall_s": round(wall, 1),
        "train_utts": len(train_lines),
        "heldout_utts": r["utterances"],
        "heldout_wer": round(r["wer"], 4),
        "heldout_cer": round(r["cer"], 4),
        "beam_rtf": round(r["rtf"], 5),
        "specaugment": args.specaugment,
    }))


if __name__ == "__main__":
    main()
