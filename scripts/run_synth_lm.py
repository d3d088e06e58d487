"""Config-ladder rung 4 proxy (BASELINE.json:10): beam search with char
n-gram LM shallow fusion + word-LM N-best rescoring, evaluated on the
DS2 checkpoint from run_synth_ds2.py. Emits one JSON line."""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="/tmp/ctc_asr_ds2")
    args = ap.parse_args()

    from ctc_asr import checkpoint as ckpt_mod
    from ctc_asr.config import (Config, DataConfig, DecodeConfig,
                                FeatureConfig, ModelConfig, TrainConfig)
    from ctc_asr.data import DataLoader, read_manifest
    from ctc_asr.evaluate import evaluate
    from ctc_asr.ops import lm as lm_mod
    from ctc_asr.train import init_train_state

    manifest_path = os.path.join(args.dir, "corpus", "manifest.csv")
    manifest = read_manifest(manifest_path)
    texts = [u.transcript for u in manifest]

    char_lm_path = os.path.join(args.dir, "char_lm.npz")
    word_lm_path = os.path.join(args.dir, "word_lm.pkl")
    lm_mod.save_lm(char_lm_path, lm_mod.train_char_lm(texts, order=3))
    lm_mod.save_word_lm(word_lm_path, lm_mod.train_word_lm(texts, order=2))

    base = Config(
        features=FeatureConfig(feature_type="mel", n_mels=80),
        model=ModelConfig(frontend="conv", rnn_layers=3, rnn_units=256,
                          bidirectional=True, dropout=0.0),
        data=DataConfig(eval_manifest=manifest_path, batch_size=16,
                        num_buckets=2, num_workers=4,
                        min_audio_seconds=0.05, max_audio_seconds=10.0),
        train=TrainConfig(train_dir=os.path.join(args.dir, "train")),
    )
    template = init_train_state(base)
    path = ckpt_mod.latest_checkpoint(base.train.train_dir + "/ckpt")
    state, _ = ckpt_mod.load_checkpoint(path, template)

    res = {}
    for tag, dec in [
        ("beam", DecodeConfig(method="beam", beam_width=16)),
        ("beam_charlm", DecodeConfig(method="beam", beam_width=16,
                                     lm_path=char_lm_path, lm_weight=0.6,
                                     word_bonus=0.5)),
        ("beam_rescored", DecodeConfig(method="beam", beam_width=16,
                                       lm_path=char_lm_path,
                                       lm_weight=0.6, word_bonus=0.5,
                                       word_lm_path=word_lm_path,
                                       rescore_alpha=0.8, nbest=8)),
    ]:
        cfg = Config(features=base.features, model=base.model,
                     data=base.data, train=base.train, decode=dec)
        loader = DataLoader(manifest, cfg.data, cfg.features,
                            drop_last=False)
        r = evaluate(cfg, state["params"], loader=loader, log_samples=0)
        res[f"{tag}_wer"] = round(r["wer"], 4)
        res[f"{tag}_cer"] = round(r["cer"], 4)
        res[f"{tag}_rtf"] = round(r["rtf"], 5)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
