"""Judge config ladder on the HARD synthetic corpus (VERDICT r1 #1).

The round-1 corpus saturated at 0.0% WER on every rung, so the
acceptance axis could not discriminate. This script re-runs the
BASELINE.json config ladder on data/synth.py's hard corpus (speaker
formant/speed perturbation, additive noise at SNR, tone babble,
disjoint train/dev/test splits, held-out test speakers) and emits the
per-rung WER table for BASELINE.md. Expected ordering:

    pr1 (MFCC + uni-RNN + greedy)  >  ds2 (conv+3xBiLSTM, greedy)
    >  ds3 (5xBiRNN-800, beam 64)  >=  ds3 + char-LM fusion
    >=  + word-LM N-best rescoring

The char-LM fusion weight is selected on DEV (never test), then the
chosen weight is reported on TEST — the standard protocol.

Usage (GPU or CPU):
    python scripts/run_ladder_hard.py --out /tmp/ladder_hard \
        [--rungs pr1,ds2,ds3] [--steps-scale 1.0]
"""

import argparse
import dataclasses as dc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def get_corpus(out, args):
    from ctc_asr.data.synth import generate_hard_corpus
    corpus = os.path.join(out, "corpus")
    marker = os.path.join(corpus, "test.csv")
    if not os.path.exists(marker):
        t0 = time.time()
        generate_hard_corpus(corpus, n_train=args.n_train,
                             n_dev=args.n_dev, n_test=args.n_test,
                             seed=7, snr_db=(args.snr_low, args.snr_high))
        print(f"[ladder] corpus generated in {time.time()-t0:.1f}s",
              flush=True)
    return {k: os.path.join(corpus, f"{k}.csv")
            for k in ("train", "dev", "test")}


def train_lms(out, train_manifest):
    """Char 4-gram (fusion) + word bigram (rescoring) from TRAIN text."""
    from ctc_asr.data import read_manifest
    from ctc_asr.ops import lm as lm_mod
    char_path = os.path.join(out, "charlm.npz")
    word_path = os.path.join(out, "wordlm.pkl")
    if not (os.path.exists(char_path) and os.path.exists(word_path)):
        texts = [u.transcript for u in read_manifest(train_manifest)]
        lm_mod.save_lm(char_path, lm_mod.train_char_lm(texts, order=4))
        lm_mod.save_word_lm(word_path, lm_mod.train_word_lm(texts, order=2))
        print("[ladder] LMs trained", flush=True)
    return char_path, word_path


def rung_cfg(preset_name, man, out, rung, steps, batch, lr,
             wire="int16", fcache=""):
    from ctc_asr.config import preset
    cfg = preset(preset_name)
    return dc.replace(
        cfg,
        data=dc.replace(cfg.data, train_manifest=man["train"],
                        eval_manifest=man["test"], batch_size=batch,
                        num_buckets=2, min_audio_seconds=0.3,
                        max_audio_seconds=12.0, wire_dtype=wire,
                        feature_cache=fcache),
        model=dc.replace(cfg.model, dropout=0.1),
        train=dc.replace(cfg.train, learning_rate=lr, total_steps=steps,
                         log_every=200, eval_every=0,
                         checkpoint_every=steps,
                         train_dir=os.path.join(out, f"train_{rung}")))


def eval_split(cfg, params, manifest_path, log_samples=2):
    from ctc_asr.data import DataLoader, read_manifest
    from ctc_asr.evaluate import evaluate
    loader = DataLoader(read_manifest(manifest_path), cfg.data,
                        cfg.features, drop_last=False)
    return evaluate(cfg, params, loader=loader, log_samples=log_samples)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/ladder_hard")
    ap.add_argument("--rungs", default="pr1,ds2,ds3")
    ap.add_argument("--n-train", type=int, default=512)
    ap.add_argument("--n-dev", type=int, default=64)
    ap.add_argument("--n-test", type=int, default=96)
    ap.add_argument("--snr-low", type=float, default=5.0)
    ap.add_argument("--snr-high", type=float, default=20.0)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps-scale", type=float, default=1.0)
    ap.add_argument("--lm-weights", default="0.2,0.4,0.6")
    ap.add_argument("--wire", default="int16",
                    choices=("int16", "ulaw", "float32"),
                    help="loader wire dtype: ulaw (uint8 companded) "
                         "halves host->device upload")
    ap.add_argument("--feature-cache", default="",
                    help="precomputed-feature cache dir (cli "
                         "prepare-features over train+dev+test): f16 "
                         "features on the wire instead of int16 audio "
                         "- halves upload like ulaw but lossless-grade "
                         "(no companding)")
    ap.add_argument("--specaug-ab", action="store_true",
                    help="re-train the ds2 rung with SpecAugment at "
                         "equal steps (VERDICT r2 next #5: first corpus "
                         "with noise/held-out speakers where it can "
                         "show a delta)")
    ap.add_argument("--archive", default=None,
                    help="directory (e.g. docs/results/ladder_hard_r3) "
                         "to copy ladder_results.jsonl + per-rung loss "
                         "curves into, so results live in the repo, "
                         "not /tmp (VERDICT r2 missing #2)")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    man = get_corpus(args.out, args)
    char_lm_path, word_lm_path = train_lms(args.out, man["train"])
    rungs = args.rungs.split(",")
    results = []
    results_path = os.path.join(args.out, "ladder_results.jsonl")

    from ctc_asr.train import train

    def emit(rec):
        results.append(rec)
        with open(results_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print("[ladder] " + json.dumps(rec), flush=True)

    utt_dir = os.path.join(args.out, "per_utt")
    os.makedirs(utt_dir, exist_ok=True)

    def test_fields(rung, decode_name, r):
        """Shared emit fields for a TEST eval: WER/CER with bootstrap 95%
        CIs (VERDICT r3 next #1), plus a per-utterance (we,wc,ce,cc)
        sidecar so any two rungs can be compared with the PAIRED
        bootstrap (metrics.paired_bootstrap) post-hoc."""
        slug = f"{rung}__{decode_name}".replace("/", "_").replace(" ", "")
        with open(os.path.join(utt_dir, slug + ".json"), "w") as f:
            json.dump({"rung": rung, "decode": decode_name,
                       "per_utt": r["per_utt"]}, f)
        out = {"test_wer": round(r["wer"], 4),
               "test_cer": round(r["cer"], 4)}
        if "wer_ci95" in r:
            out["test_wer_ci95"] = [round(x, 4) for x in r["wer_ci95"]]
            out["test_cer_ci95"] = [round(x, 4) for x in r["cer_ci95"]]
        return out

    sc = args.steps_scale

    def train_and_eval(cfg, rung, decode_name):
        """Train, then eval DEV + TEST (dev gives the generalization
        context VERDICT r2 weak #4 asked for; single-point test WER
        alone cannot distinguish model limit from step budget)."""
        t0 = time.time()
        state = train(cfg)
        wall = round(time.time() - t0, 1)
        rd = eval_split(cfg, state["params"], man["dev"], log_samples=0)
        r = eval_split(cfg, state["params"], man["test"])
        emit({"rung": rung, "decode": decode_name,
              "steps": int(state["step"]), "train_wall_s": wall,
              "dev_wer": round(rd["wer"], 4),
              **test_fields(rung, decode_name, r),
              "rtf": round(r["rtf"], 5)})
        return state

    if "pr1" in rungs:
        cfg = rung_cfg("pr1_mfcc_uni", man, args.out, "pr1",
                       int(2500 * sc), args.batch, 5e-4, args.wire,
                       args.feature_cache)
        train_and_eval(cfg, "pr1_mfcc_uni", "greedy")

    if "ds2" in rungs:
        cfg = rung_cfg("conv_bilstm3", man, args.out, "ds2",
                       int(2000 * sc), args.batch, 5e-4, args.wire,
                       args.feature_cache)
        train_and_eval(cfg, "conv_bilstm3", "greedy")
        if args.specaug_ab:
            sa = dc.replace(cfg, train=dc.replace(
                cfg.train, specaugment=True,
                train_dir=os.path.join(args.out, "train_ds2_specaug")))
            train_and_eval(sa, "conv_bilstm3+specaug", "greedy")

    if "ds2sa" in rungs:
        # SpecAugment arm alone (skip retraining plain ds2 when its
        # ranking is already settled — r4 paired bootstrap was decisive)
        cfg = rung_cfg("conv_bilstm3", man, args.out, "ds2_specaug",
                       int(2000 * sc), args.batch, 5e-4, args.wire,
                       args.feature_cache)
        cfg = dc.replace(cfg, train=dc.replace(cfg.train,
                                               specaugment=True))
        train_and_eval(cfg, "conv_bilstm3+specaug", "greedy")

    def run_ds3_chain(rung, specaug):
        """One ds3 training run serves the greedy-diagnostic, beam,
        +charLM and +wordLM rungs. ``specaug`` arms the r3-measured WER
        lever (ds2: 18.5%->12.9% at equal steps) on the big model."""
        cfg = rung_cfg("deepspeech_beam", man, args.out, rung,
                       int(2000 * sc), args.batch, 3e-4, args.wire,
                       args.feature_cache)
        if specaug:
            cfg = dc.replace(cfg, train=dc.replace(cfg.train,
                                                   specaugment=True))
        name = "deepspeech_beam" + ("+specaug" if specaug else "")
        t0 = time.time()
        state = train(cfg)
        wall = round(time.time() - t0, 1)
        params = state["params"]

        gcfg = dc.replace(cfg, decode=dc.replace(cfg.decode,
                                                 method="greedy"))
        r = eval_split(gcfg, params, man["test"], log_samples=0)
        emit({"rung": name, "decode": "greedy(diagnostic)",
              "steps": int(state["step"]), "train_wall_s": wall,
              **test_fields(name, "greedy", r),
              "rtf": round(r["rtf"], 5)})

        r = eval_split(cfg, params, man["test"])
        emit({"rung": name, "decode": "beam64",
              "steps": int(state["step"]),
              **test_fields(name, "beam64", r),
              "rtf": round(r["rtf"], 5)})

        # char-LM fusion: select weight on DEV, report on TEST
        best_w, best_dev = None, float("inf")
        for w in [float(x) for x in args.lm_weights.split(",")]:
            lcfg = dc.replace(cfg, decode=dc.replace(
                cfg.decode, lm_path=char_lm_path, lm_weight=w,
                word_bonus=0.5))
            rd = eval_split(lcfg, params, man["dev"], log_samples=0)
            print(f"[ladder] dev sweep lm_weight={w}: "
                  f"wer={rd['wer']:.4f}", flush=True)
            if rd["wer"] < best_dev:
                best_dev, best_w = rd["wer"], w
        lcfg = dc.replace(cfg, decode=dc.replace(
            cfg.decode, lm_path=char_lm_path, lm_weight=best_w,
            word_bonus=0.5))
        r = eval_split(lcfg, params, man["test"])
        emit({"rung": name + "+lm_fusion",
              "decode": f"beam64+charlm(w={best_w})",
              "dev_wer": round(best_dev, 4),
              **test_fields(name + "+lm_fusion", "beam64+charlm", r),
              "rtf": round(r["rtf"], 5)})

        # + word-LM N-best rescoring on top of the fused beam. The
        # rescore interpolation weight alpha is DEV-selected per model
        # (like the fusion weight): a fixed alpha tuned on a weaker
        # model over-rides correct beams once the acoustic+fusion
        # scores sharpen (measured: fixed alpha=1.0 took the specaug
        # ds3 model from 11.1% to 12.2% — backwards). alpha=0 is in
        # the grid, so rescoring can never look worse than the fused
        # beam on dev. Cheap sweep: alpha is host-side only, the
        # on-device N-best decode jit is reused across values.
        best_a, best_dev_a = None, float("inf")
        for a in (0.0, 0.3, 0.6, 1.0, 2.0):
            acfg = dc.replace(lcfg, decode=dc.replace(
                lcfg.decode, word_lm_path=word_lm_path,
                rescore_alpha=a))
            rd = eval_split(acfg, params, man["dev"], log_samples=0)
            print(f"[ladder] dev sweep rescore_alpha={a}: "
                  f"wer={rd['wer']:.4f}", flush=True)
            if rd["wer"] < best_dev_a:
                best_dev_a, best_a = rd["wer"], a
        # Run the TEST eval TWICE with ONE metric definition (VERDICT r3
        # weak #5: the old table mixed compile-excluded "rtf" on pass 1
        # with wall-incl-compile on pass 2, so warm read HIGHER than
        # cold). Both passes now report evaluate()'s steady-state rtf —
        # first-batch excluded, host rescore included — so pass 2
        # ("rtf_warm", fully-warm jit cache AND warm rescore memo) is
        # directly comparable and must come out <= pass 1.
        wcfg = dc.replace(lcfg, decode=dc.replace(
            lcfg.decode, word_lm_path=word_lm_path,
            rescore_alpha=best_a))
        r = eval_split(wcfg, params, man["test"], log_samples=0)
        r2 = eval_split(wcfg, params, man["test"], log_samples=0)
        emit({"rung": name + "+lm_fusion+rescore",
              "decode": f"beam64+charlm(w={best_w})"
                        f"+wordlm(a={best_a})",
              "dev_wer": round(best_dev_a, 4),
              **test_fields(name + "+lm_fusion+rescore", "rescore", r),
              "rtf": round(r["rtf"], 5),
              "rtf_warm": round(r2["rtf"], 5)})

    if "ds3" in rungs:
        run_ds3_chain("ds3", specaug=False)
    if "ds3sa" in rungs:
        run_ds3_chain("ds3sa", specaug=True)

    print(json.dumps({"ladder": results}))

    if args.archive:
        import shutil
        os.makedirs(args.archive, exist_ok=True)
        shutil.copy(results_path, args.archive)
        # per-utterance sidecars ride along: they are the inputs to the
        # paired-bootstrap comparisons (cli compare / analyze_ladder)
        if os.path.isdir(utt_dir):
            dst = os.path.join(args.archive, "per_utt")
            os.makedirs(dst, exist_ok=True)
            for f in os.listdir(utt_dir):
                shutil.copy(os.path.join(utt_dir, f), dst)
        for d in sorted(os.listdir(args.out)):
            mj = os.path.join(args.out, d, "metrics.jsonl")
            if d.startswith("train_") and os.path.exists(mj):
                shutil.copy(mj, os.path.join(args.archive,
                                             f"{d}_metrics.jsonl"))
        print(f"[ladder] archived results to {args.archive}", flush=True)


if __name__ == "__main__":
    main()
