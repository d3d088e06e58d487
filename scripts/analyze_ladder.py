"""Ladder post-processing: markdown WER table with bootstrap CIs +
paired-bootstrap ranking of the best rungs (VERDICT r3 next #1).

Reads a run_ladder_hard.py output directory (ladder_results.jsonl +
per_utt/*.json sidecars) and emits:

1. a BASELINE.md-ready markdown table — one row per emitted record,
   with the 95% CI columns;
2. pairwise PAIRED bootstrap comparisons among the N best rungs (same
   test utterances, shared-difficulty cancellation — far tighter than
   comparing two independent CIs), each labeled decisive or tied.

Usage: python scripts/analyze_ladder.py --dir /tmp/ladder_hard_r4 [--top 4]
"""

import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load(dirpath):
    rows = []
    with open(os.path.join(dirpath, "ladder_results.jsonl")) as f:
        for line in f:
            rows.append(json.loads(line))
    utts = {}
    for p in glob.glob(os.path.join(dirpath, "per_utt", "*.json")):
        with open(p) as f:
            d = json.load(f)
        utts[(d["rung"], d["decode"])] = d["per_utt"]
    return rows, utts


def fmt_ci(ci):
    if not ci:
        return "—"
    return f"[{100*ci[0]:.1f}, {100*ci[1]:.1f}]"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="/tmp/ladder_hard_r4")
    ap.add_argument("--top", type=int, default=4)
    args = ap.parse_args()
    rows, utts = load(args.dir)

    print("| Rung | decode | steps | dev WER | test WER | 95% CI | "
          "test CER | eval RTF |")
    print("|---|---|---|---|---|---|---|---|")
    for r in rows:
        dev = f"{100*r['dev_wer']:.1f}%" if "dev_wer" in r else "—"
        rtf = f"{r.get('rtf', 0):.3f}"
        if "rtf_warm" in r:
            rtf += f" ({r['rtf_warm']:.3f} warm)"
        print(f"| {r['rung']} | {r['decode']} | {r.get('steps', '—')} | "
              f"{dev} | **{100*r['test_wer']:.2f}%** | "
              f"{fmt_ci(r.get('test_wer_ci95'))} | "
              f"{100*r['test_cer']:.2f}% | {rtf} |")

    # paired ranking of the best rungs that have sidecars
    from ctc_asr.metrics import paired_bootstrap
    scored = [r for r in rows if "test_wer" in r]
    scored.sort(key=lambda r: r["test_wer"])
    best, seen = [], set()
    for r in scored:
        # sidecar key: same rung; decode slug must prefix the record's
        # decode string (greedy(diagnostic) -> greedy, beam64+charlm(w=..)
        # -> beam64+charlm) or be the rescore slug for +rescore rungs
        match = None
        for (rung, dec), pu in utts.items():
            if rung != r["rung"]:
                continue
            decstr = r.get("decode", "")
            if decstr.startswith(dec) or (
                    dec == "rescore" and rung.endswith("+rescore")):
                match = ((rung, dec), pu)
                break
        if match and match[0] not in seen:
            seen.add(match[0])
            best.append((r, *match))
        if len(best) >= args.top:
            break

    print("\n## Paired bootstrap among the top rungs (A vs B = "
          "delta, CI95, p(A better))\n")
    for i in range(len(best)):
        for j in range(i + 1, len(best)):
            (ra, ka, pa), (rb, kb, pb) = best[i], best[j]
            if len(pa) != len(pb):
                continue
            out = paired_bootstrap(pa, pb)
            lo, hi = out["wer_delta_ci95"]
            verdict = "A better" if hi < 0 else \
                "B better" if lo > 0 else "TIED"
            print(f"- {ka[0]}/{ka[1]} vs {kb[0]}/{kb[1]}: "
                  f"delta={out['wer_delta']:+.4f} "
                  f"CI[{lo:+.4f},{hi:+.4f}] "
                  f"p={out['p_a_better']:.3f} -> {verdict}")


if __name__ == "__main__":
    main()
