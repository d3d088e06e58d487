"""Config-ladder rung 3 proxy (BASELINE.json:9): full DeepSpeech-style
model (conv + 5x BiLSTM-800) + prefix beam search (beam=64), trained on
the synth corpus on the default JAX device. Emits one JSON line."""

import argparse, json, os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--out", default="/tmp/ctc_asr_ds3")
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
        manifest_path = generate_corpus(corpus_dir, num_utterances=96,
                                        seed=2, min_words=2, max_words=5)
    cfg = Config(
        features=FeatureConfig(feature_type="mel", n_mels=80),
        model=ModelConfig(frontend="conv", rnn_layers=5, rnn_units=800,
                          bidirectional=True, dropout=0.0),
        data=DataConfig(train_manifest=manifest_path,
                        eval_manifest=manifest_path,
                        batch_size=8, num_buckets=1, num_workers=4,
                        min_audio_seconds=0.05, max_audio_seconds=10.0),
        train=TrainConfig(learning_rate=5e-4, total_steps=args.steps,
                          log_every=50, eval_every=10 ** 9,
                          checkpoint_every=args.steps,
                          train_dir=os.path.join(args.out, "train")),
        decode=DecodeConfig(method="beam", beam_width=64),
    )
    t0 = time.time()
    state = train(cfg)
    wall = time.time() - t0
    manifest = read_manifest(manifest_path)
    loader = DataLoader(manifest, cfg.data, cfg.features, drop_last=False)
    r = evaluate(cfg, state["params"], loader=loader, log_samples=0)
    print(json.dumps({"train_steps": int(state["step"]),
                      "train_wall_s": round(wall, 1),
                      "beam64_wer": round(r["wer"], 4),
                      "beam64_rtf": round(r["rtf"], 5)}))


if __name__ == "__main__":
    main()
