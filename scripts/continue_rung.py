"""Continue a ladder rung's training from its checkpoint and re-eval.

The ladder trains each arm once (run_ladder_hard.py); this script
resumes a rung's train_dir to a LARGER step budget (exact data-order
resume via the checkpointed loader cursor) and emits the same
record shape — appended to ladder_results.jsonl with a "continued"
marker — plus the per-utterance sidecar for paired comparisons.

Usage:
  python scripts/continue_rung.py --out /tmp/ladder_hard_r4 \
      --rung ds3sa --steps 8000 [--specaugment] [--decode greedy|chain]
"""

import argparse
import dataclasses as dc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RUNG_PRESETS = {
    "pr1": ("pr1_mfcc_uni", 5e-4, False),
    "ds2": ("conv_bilstm3", 5e-4, False),
    "ds2_specaug": ("conv_bilstm3", 5e-4, True),
    "ds3": ("deepspeech_beam", 3e-4, False),
    "ds3sa": ("deepspeech_beam", 3e-4, True),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/ladder_hard_r4")
    ap.add_argument("--rung", required=True, choices=sorted(RUNG_PRESETS))
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lm-weights", default="0.2,0.4,0.6")
    ap.add_argument("--chain", action="store_true",
                    help="also run beam64 + dev-selected char-LM fusion")
    ap.add_argument("--archive", default=None)
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import run_ladder_hard as lh
    from ctc_asr.train import train

    preset_name, lr, specaug = RUNG_PRESETS[args.rung]
    man = {k: os.path.join(args.out, "corpus", f"{k}.csv")
           for k in ("train", "dev", "test")}
    cfg = lh.rung_cfg(preset_name, man, args.out, args.rung, args.steps,
                      args.batch, lr)
    if specaug:
        cfg = dc.replace(cfg, train=dc.replace(cfg.train,
                                               specaugment=True))
    results_path = os.path.join(args.out, "ladder_results.jsonl")
    utt_dir = os.path.join(args.out, "per_utt")
    os.makedirs(utt_dir, exist_ok=True)

    def emit(rec):
        with open(results_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print("[continue] " + json.dumps(rec), flush=True)

    def test_fields(rung, decode_name, r):
        slug = f"{rung}__{decode_name}@{args.steps}".replace("/", "_")
        with open(os.path.join(utt_dir, slug + ".json"), "w") as f:
            json.dump({"rung": rung, "decode": decode_name,
                       "per_utt": r["per_utt"]}, f)
        out = {"test_wer": round(r["wer"], 4),
               "test_cer": round(r["cer"], 4)}
        if "wer_ci95" in r:
            out["test_wer_ci95"] = [round(x, 4) for x in r["wer_ci95"]]
            out["test_cer_ci95"] = [round(x, 4) for x in r["cer_ci95"]]
        return out

    t0 = time.time()
    state = train(cfg)
    wall = round(time.time() - t0, 1)
    params = state["params"]
    name = preset_name + ("+specaug" if specaug else "")

    gcfg = dc.replace(cfg, decode=dc.replace(cfg.decode, method="greedy"))
    rd = lh.eval_split(gcfg, params, man["dev"], log_samples=0)
    r = lh.eval_split(gcfg, params, man["test"], log_samples=0)
    emit({"rung": name, "decode": "greedy", "steps": int(state["step"]),
          "continued": True, "train_wall_s": wall,
          "dev_wer": round(rd["wer"], 4),
          **test_fields(name, "greedy", r),
          "rtf": round(r["rtf"], 5)})

    if args.chain and cfg.decode.method == "beam":
        r = lh.eval_split(cfg, params, man["test"], log_samples=0)
        emit({"rung": name, "decode": "beam64", "steps": int(state["step"]),
              "continued": True, **test_fields(name, "beam64", r),
              "rtf": round(r["rtf"], 5)})
        char_lm_path = os.path.join(args.out, "charlm.npz")
        best_w, best_dev = None, float("inf")
        for w in [float(x) for x in args.lm_weights.split(",")]:
            lcfg = dc.replace(cfg, decode=dc.replace(
                cfg.decode, lm_path=char_lm_path, lm_weight=w,
                word_bonus=0.5))
            rdw = lh.eval_split(lcfg, params, man["dev"], log_samples=0)
            print(f"[continue] dev lm_weight={w}: wer={rdw['wer']:.4f}",
                  flush=True)
            if rdw["wer"] < best_dev:
                best_dev, best_w = rdw["wer"], w
        lcfg = dc.replace(cfg, decode=dc.replace(
            cfg.decode, lm_path=char_lm_path, lm_weight=best_w,
            word_bonus=0.5))
        r = lh.eval_split(lcfg, params, man["test"], log_samples=0)
        emit({"rung": name + "+lm_fusion",
              "decode": f"beam64+charlm(w={best_w})",
              "steps": int(state["step"]), "continued": True,
              "dev_wer": round(best_dev, 4),
              **test_fields(name + "+lm_fusion", "beam64+charlm", r),
              "rtf": round(r["rtf"], 5)})

    if args.archive:
        import shutil
        os.makedirs(args.archive, exist_ok=True)
        shutil.copy(results_path, args.archive)


if __name__ == "__main__":
    main()
