"""Open-vocabulary (OOV) generalization rung + the n=4096 settler
(VERDICT r4 next #1 and #6).

Reuses the surviving round-4 "r4big" artifacts (4096/256/1024 corpus,
8000-step ds2+SA and ds3+SA checkpoints, train-text LMs) — no
retraining. Two measurements:

1. **Settler**: a fresh n=4096 in-vocab test split (same recipe:
   seed-7 vocabulary, held-out speakers 1000.., SNR 5-20 dB,
   transcripts disjoint from every existing split) large enough to
   resolve the last open ranking — ds3+SA+charLM vs ds2+SA at the
   8000-step convergence limit (r4: delta -0.28 pts, p=0.913 at
   n=1024; the builder's power analysis said n>=4096 resolves 0.28).

2. **OOV rung**: dev/test splits whose transcripts draw from a
   DISJOINT 384-word inventory (same syllable structure/charset —
   data/synth.build_oov_vocabulary), so every WER measures unseen-WORD
   generalization. The decode chain (greedy / beam / char-LM fusion /
   word-LM rescoring) runs with TWO LM text conditions:
     - train-only: LMs trained on the 4096 acoustic-train transcripts
       (zero OOV coverage) — the chain as the ladder always ran it;
     - full-text: LMs trained on text over base+OOV vocabulary (the
       realistic asymmetry: text corpora cover words the acoustic
       model never heard). This is where word-LM rescoring — which dev
       has declined three times on closed-vocab data — either earns
       its place or is honestly retired.

All fusion weights / rescore alphas are selected on the OOV DEV split
(train-speaker pool), reported on the OOV TEST split (held-out
speakers). Per-utterance sidecars + paired bootstraps included.

Usage:
    python scripts/run_oov.py --r4big /tmp/ladder_hard_r4big \
        --out /tmp/oov_r5 [--archive docs/results/oov_r5]
"""

import argparse
import dataclasses as dc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CORPUS_SEED = 7  # the r4big generation seed (run_ladder_hard.py)


def eval_split(cfg, params, manifest_path, log_samples=0):
    from ctc_asr.data import DataLoader, read_manifest
    from ctc_asr.evaluate import evaluate
    loader = DataLoader(read_manifest(manifest_path), cfg.data,
                        cfg.features, drop_last=False)
    return evaluate(cfg, params, loader=loader, log_samples=log_samples)


def arm_cfg(preset_name, eval_manifest, batch=32):
    from ctc_asr.config import preset
    cfg = preset(preset_name)
    return dc.replace(
        cfg,
        data=dc.replace(cfg.data, eval_manifest=eval_manifest,
                        batch_size=batch, num_buckets=2,
                        min_audio_seconds=0.3, max_audio_seconds=12.0),
        model=dc.replace(cfg.model, dropout=0.1))


def load_params(cfg, ckpt_path):
    from ctc_asr import checkpoint as ckpt_mod
    from ctc_asr.train import init_train_state
    state, _ = ckpt_mod.load_checkpoint(ckpt_path, init_train_state(cfg))
    return state["params"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--r4big", default="/tmp/ladder_hard_r4big")
    ap.add_argument("--out", default="/tmp/oov_r5")
    ap.add_argument("--archive", default="")
    ap.add_argument("--n-bigtest", type=int, default=4096)
    ap.add_argument("--n-oov-dev", type=int, default=256)
    ap.add_argument("--n-oov-test", type=int, default=1024)
    ap.add_argument("--lm-sentences", type=int, default=16384)
    ap.add_argument("--skip-settler", action="store_true")
    ap.add_argument("--skip-oov", action="store_true")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    from ctc_asr.data import read_manifest
    from ctc_asr.data.synth import (build_oov_vocabulary,
                                    build_vocabulary,
                                    generate_hard_split,
                                    generate_lm_text)
    from ctc_asr.metrics import paired_bootstrap
    from ctc_asr.ops import lm as lm_mod

    results_path = os.path.join(args.out, "oov_results.jsonl")
    utt_dir = os.path.join(args.out, "per_utt")
    os.makedirs(utt_dir, exist_ok=True)
    sidecars = {}

    def emit(rec):
        with open(results_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print("[oov] " + json.dumps(rec), flush=True)

    def record(tag, r):
        sidecars[tag] = r["per_utt"]
        with open(os.path.join(utt_dir, tag + ".json"), "w") as f:
            json.dump({"tag": tag, "per_utt": r["per_utt"]}, f)
        return {"test_wer": round(r["wer"], 4),
                "test_cer": round(r["cer"], 4),
                "test_wer_ci95": [round(x, 4) for x in r["wer_ci95"]],
                "rtf": round(r["rtf"], 5)}

    def compare(tag_a, tag_b, label):
        out = paired_bootstrap(sidecars[tag_a], sidecars[tag_b])
        lo, hi = out["wer_delta_ci95"]
        verdict = "A better" if hi < 0 else \
            "B better" if lo > 0 else "tied"
        emit({"compare": label, "a": tag_a, "b": tag_b,
              "wer_delta": round(out["wer_delta"], 4),
              "ci95": [round(lo, 4), round(hi, 4)],
              "p_a_better": round(out["p_a_better"], 3),
              "verdict": verdict})

    # --- corpus assembly -------------------------------------------------
    base_vocab = build_vocabulary(384, seed=CORPUS_SEED + 1234)
    oov_vocab = build_oov_vocabulary(384, 384, seed=CORPUS_SEED + 1234)
    exclude = set()
    for split in ("train", "dev", "test"):
        p = os.path.join(args.r4big, "corpus", f"{split}.csv")
        exclude.update(u.transcript for u in read_manifest(p))
    print(f"[oov] {len(exclude)} existing transcripts excluded",
          flush=True)

    def gen(split, vocab, n, seed, spk_base, n_speakers, split_id):
        path = os.path.join(args.out, f"{split}.csv")
        if os.path.exists(path):
            return path
        t0 = time.time()
        p = generate_hard_split(args.out, split, vocab, n, seed=seed,
                                spk_base=spk_base, n_speakers=n_speakers,
                                split_id=split_id,
                                exclude_transcripts=exclude)
        print(f"[oov] {split}: {n} utts in {time.time()-t0:.1f}s",
              flush=True)
        return p

    bigtest = gen("bigtest", base_vocab, args.n_bigtest, seed=7001,
                  spk_base=1000, n_speakers=12, split_id=10)
    oov_dev = gen("oov_dev", oov_vocab, args.n_oov_dev, seed=7002,
                  spk_base=0, n_speakers=32, split_id=11)
    oov_test = gen("oov_test", oov_vocab, args.n_oov_test, seed=7003,
                   spk_base=1000, n_speakers=12, split_id=12)

    # --- LMs -------------------------------------------------------------
    charlm_train = os.path.join(args.r4big, "charlm.npz")
    wordlm_train = os.path.join(args.r4big, "wordlm.pkl")
    charlm_full = os.path.join(args.out, "charlm_full.npz")
    wordlm_full = os.path.join(args.out, "wordlm_full.pkl")
    if not os.path.exists(charlm_full):
        texts = generate_lm_text(base_vocab + oov_vocab,
                                 args.lm_sentences, seed=7004)
        lm_mod.save_lm(charlm_full, lm_mod.train_char_lm(texts, order=4))
        lm_mod.save_word_lm(wordlm_full,
                            lm_mod.train_word_lm(texts, order=2))
        print("[oov] full-text LMs trained", flush=True)

    # --- checkpoints (8000-step convergence arms from r4big) -------------
    ds2_ckpt = os.path.join(args.r4big, "train_ds2_specaug", "ckpt",
                            "step_00008000.npz")
    ds3_ckpt = os.path.join(args.r4big, "train_ds3sa", "ckpt",
                            "step_00008000.npz")
    cfg2 = arm_cfg("conv_bilstm3", bigtest)
    cfg3 = arm_cfg("deepspeech_beam", bigtest)
    params2 = load_params(cfg2, ds2_ckpt)
    params3 = load_params(cfg3, ds3_ckpt)

    # --- 1) settler: n=4096 in-vocab head-to-head at 8000 steps ----------
    if not args.skip_settler:
        g2 = dc.replace(cfg2, decode=dc.replace(cfg2.decode,
                                                method="greedy"))
        r = eval_split(g2, params2, bigtest)
        emit({"arm": "ds2+SA@8000", "decode": "greedy",
              "split": "bigtest4096", **record("settler_ds2sa", r)})

        g3 = dc.replace(cfg3, decode=dc.replace(cfg3.decode,
                                                method="greedy"))
        r = eval_split(g3, params3, bigtest)
        emit({"arm": "ds3+SA@8000", "decode": "greedy",
              "split": "bigtest4096", **record("settler_ds3sa_greedy", r)})

        b3 = dc.replace(cfg3, decode=dc.replace(
            cfg3.decode, method="beam", beam_width=64))
        r = eval_split(b3, params3, bigtest)
        emit({"arm": "ds3+SA@8000", "decode": "beam64",
              "split": "bigtest4096", **record("settler_ds3sa_beam", r)})

        # the r4 8000-step dev-selected fusion weight (w=0.4) — reused,
        # not re-tuned: the settler changes the TEST set only
        f3 = dc.replace(cfg3, decode=dc.replace(
            cfg3.decode, method="beam", beam_width=64,
            lm_path=charlm_train, lm_weight=0.4, word_bonus=0.5))
        r = eval_split(f3, params3, bigtest)
        emit({"arm": "ds3+SA@8000", "decode": "beam64+charlm(w=0.4)",
              "split": "bigtest4096", **record("settler_ds3sa_chain", r)})

        compare("settler_ds3sa_chain", "settler_ds2sa",
                "SETTLER ds3-chain vs ds2+SA @8000, n=4096")
        compare("settler_ds3sa_beam", "settler_ds2sa",
                "ds3+SA beam vs ds2+SA greedy @8000, n=4096")
        compare("settler_ds3sa_chain", "settler_ds3sa_beam",
                "fusion delta @8000, n=4096")

    # --- 2) OOV rung -----------------------------------------------------
    if args.skip_oov:
        return 0

    def oov_chain(name, cfg, params):
        gcfg = dc.replace(cfg,
                          data=dc.replace(cfg.data,
                                          eval_manifest=oov_test),
                          decode=dc.replace(cfg.decode, method="greedy"))
        r = eval_split(gcfg, params, oov_test, log_samples=2)
        emit({"arm": name, "decode": "greedy", "split": "oov_test",
              **record(f"oov_{name}_greedy", r)})

        bcfg = dc.replace(gcfg, decode=dc.replace(
            cfg.decode, method="beam", beam_width=64))
        r = eval_split(bcfg, params, oov_test)
        emit({"arm": name, "decode": "beam64", "split": "oov_test",
              **record(f"oov_{name}_beam", r)})

        chains = {}
        for lm_tag, char_path, word_path in (
                ("trainlm", charlm_train, wordlm_train),
                ("fulllm", charlm_full, wordlm_full)):
            # char-LM fusion: select w on OOV-dev. w=0 IS in the grid
            # (added after the round-5 run): dev can decline fusion
            # outright — which it would have for the train-only LM,
            # whose best nonzero w still lost to the plain beam.
            best_w, best_dev = 0.0, float("inf")
            for w in (0.0, 0.2, 0.4, 0.6):
                lcfg = dc.replace(bcfg, decode=dc.replace(
                    bcfg.decode, lm_path=char_path, lm_weight=w,
                    word_bonus=0.5))
                rd = eval_split(lcfg, params, oov_dev)
                print(f"[oov] {name}/{lm_tag} dev w={w}: "
                      f"{rd['wer']:.4f}", flush=True)
                if rd["wer"] < best_dev:
                    best_dev, best_w = rd["wer"], w
            lcfg = dc.replace(bcfg, decode=dc.replace(
                bcfg.decode, lm_path=char_path, lm_weight=best_w,
                word_bonus=0.5))
            r = eval_split(lcfg, params, oov_test)
            tag = f"oov_{name}_fusion_{lm_tag}"
            chains[lm_tag] = (lcfg, word_path)
            emit({"arm": name,
                  "decode": f"beam64+charlm[{lm_tag}](w={best_w})",
                  "split": "oov_test", "dev_wer": round(best_dev, 4),
                  **record(tag, r)})

            # word-LM N-best rescore on top (alpha=0 in grid: dev can
            # decline)
            best_a, best_dev_a = 0.0, float("inf")
            for a in (0.0, 0.3, 0.6, 1.0, 2.0):
                acfg = dc.replace(lcfg, decode=dc.replace(
                    lcfg.decode, word_lm_path=word_path,
                    rescore_alpha=a))
                rd = eval_split(acfg, params, oov_dev)
                print(f"[oov] {name}/{lm_tag} dev alpha={a}: "
                      f"{rd['wer']:.4f}", flush=True)
                if rd["wer"] < best_dev_a:
                    best_dev_a, best_a = rd["wer"], a
            acfg = dc.replace(lcfg, decode=dc.replace(
                lcfg.decode, word_lm_path=word_path,
                rescore_alpha=best_a))
            r = eval_split(acfg, params, oov_test)
            emit({"arm": name,
                  "decode": f"beam64+charlm[{lm_tag}]"
                            f"+wordlm[{lm_tag}](a={best_a})",
                  "split": "oov_test", "dev_wer": round(best_dev_a, 4),
                  **record(f"oov_{name}_rescore_{lm_tag}", r)})

        compare(f"oov_{name}_fusion_trainlm", f"oov_{name}_beam",
                f"{name}: train-only char-LM fusion vs beam on OOV")
        compare(f"oov_{name}_fusion_fulllm", f"oov_{name}_beam",
                f"{name}: full-text char-LM fusion vs beam on OOV")
        compare(f"oov_{name}_rescore_fulllm",
                f"oov_{name}_fusion_fulllm",
                f"{name}: full-text word-LM rescore delta on OOV")
        compare(f"oov_{name}_rescore_trainlm",
                f"oov_{name}_fusion_trainlm",
                f"{name}: train-only word-LM rescore delta on OOV")

    oov_chain("ds3sa8000", cfg3, params3)
    # ds2 control: greedy only (its chain has no beam in the contract
    # ladder; this anchors how much of the OOV gap is model-independent)
    g2 = dc.replace(cfg2, decode=dc.replace(cfg2.decode,
                                            method="greedy"))
    r = eval_split(g2, params2, oov_test)
    emit({"arm": "ds2sa8000", "decode": "greedy", "split": "oov_test",
          **record("oov_ds2sa8000_greedy", r)})
    compare("oov_ds3sa8000_greedy", "oov_ds2sa8000_greedy",
            "ds3+SA vs ds2+SA greedy on OOV")

    if args.archive:
        import shutil
        os.makedirs(args.archive, exist_ok=True)
        shutil.copy(results_path, args.archive)
        dst = os.path.join(args.archive, "per_utt")
        os.makedirs(dst, exist_ok=True)
        for fn in os.listdir(utt_dir):
            shutil.copy(os.path.join(utt_dir, fn), dst)
        print(f"[oov] archived to {args.archive}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
