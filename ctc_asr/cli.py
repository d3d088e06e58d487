"""Command-line entry points.

Replaces the reference's script surface (SURVEY.md §3: asr/train.py,
asr/evaluate.py, asr/predict.py, asr/dataset/generate_dataset.py) with
one CLI:

    python -m ctc_asr.cli train --preset pr1_mfcc_uni \
        --data.train_manifest=... [--section.key=value ...]
    python -m ctc_asr.cli evaluate --preset ... --ckpt ... \
        [--dump-utts a.json]
    python -m ctc_asr.cli compare a.json b.json   # paired bootstrap
    python -m ctc_asr.cli transcribe --preset ... --ckpt ... wav...
    python -m ctc_asr.cli prepare-synth --out DIR [--n 64]
    python -m ctc_asr.cli prepare-librispeech --root DIR --out DIR
    python -m ctc_asr.cli train-lm --manifest ... --out lm.npz
    python -m ctc_asr.cli prepare-features --manifest ... --out DIR

Config: ``--preset`` picks a judge-ladder preset (config.py), ``--config
file.json`` loads a full config, and any ``--section.key=value`` args
override (the FLAGS replacement, SURVEY.md §5 config row).
"""

from __future__ import annotations

import argparse
import sys

from . import config as cfg_mod


def _split_args(argv):
    """Separate --section.key=value overrides from plain args."""
    overrides, rest = {}, []
    for a in argv:
        if a.startswith("--") and "=" in a and "." in a.split("=", 1)[0]:
            k, v = a[2:].split("=", 1)
            overrides[k] = v
        else:
            rest.append(a)
    return overrides, rest


def _load_cfg(args, overrides) -> cfg_mod.Config:
    if args.config:
        with open(args.config) as f:
            cfg = cfg_mod.from_json(f.read())
    elif args.preset:
        cfg = cfg_mod.preset(args.preset)
    else:
        cfg = cfg_mod.Config()
    if overrides:
        cfg = cfg_mod.apply_overrides(cfg, overrides)
    return cfg


def _common(p: argparse.ArgumentParser):
    p.add_argument("--preset", default="",
                   help="named preset (config.preset)")
    p.add_argument("--config", default="", help="config json file")


def cmd_train(argv):
    overrides, rest = _split_args(argv)
    p = argparse.ArgumentParser(prog="train")
    _common(p)
    p.add_argument("--max-steps", type=int, default=None)
    args = p.parse_args(rest)
    cfg = _load_cfg(args, overrides)

    from .parallel.dist import initialize_distributed
    initialize_distributed(cfg.mesh)

    import jax

    from .evaluate import evaluate
    from .train import train

    eval_fn = None
    if cfg.data.eval_manifest:
        def eval_fn(state):
            params = state["params"]
            if len(jax.tree.leaves(params)[0].sharding.device_set) > 1:
                # the train state is replicated over the mesh; eval
                # decodes each process's shard with a one-device jit,
                # so re-commit the replica to the default device
                params = jax.device_put(jax.device_get(params))
            res = evaluate(cfg, params, log_samples=2)
            # raw per-utterance records are for offline paired-bootstrap
            # analysis, not the metrics stream
            res.pop("per_utt", None)
            return res
    state = train(cfg, max_steps=args.max_steps, eval_fn=eval_fn)
    print(f"[train] done at step {int(state['step'])}")
    return 0


def cmd_evaluate(argv):
    overrides, rest = _split_args(argv)
    p = argparse.ArgumentParser(prog="evaluate")
    _common(p)
    p.add_argument("--ckpt", required=True,
                   help="checkpoint .npz (or train dir)")
    p.add_argument("--dump-utts", default="",
                   help="write per-utterance (we,wc,ce,cc) records to "
                        "this JSON for `cli compare` paired bootstraps")
    args = p.parse_args(rest)
    cfg = _load_cfg(args, overrides)

    from .parallel.dist import initialize_distributed
    initialize_distributed(cfg.mesh)

    import jax

    from . import checkpoint as ckpt_mod
    from .evaluate import evaluate
    from .train import init_train_state

    template = init_train_state(cfg)
    path = args.ckpt
    if not path.endswith(".npz"):
        path = ckpt_mod.latest_checkpoint(path + "/ckpt") or path
    state, _ = ckpt_mod.load_checkpoint(path, template)
    res = evaluate(cfg, state["params"])
    import json
    # evaluate() allgathers per-utt records across processes, so the
    # process-0 dump describes the FULL corpus — same file either way
    per_utt = res.pop("per_utt", None)
    if args.dump_utts and per_utt is not None \
            and jax.process_index() == 0:
        with open(args.dump_utts, "w") as f:
            json.dump({"ckpt": path, "per_utt": per_utt}, f)
    print(json.dumps(res, indent=2, default=float))
    return 0


def cmd_compare(argv):
    """Paired-bootstrap comparison of two systems evaluated on the SAME
    manifest: `cli compare a.json b.json` where each file is an
    `evaluate --dump-utts` dump (or a ladder per_utt sidecar). Reports
    the corpus-WER delta (A − B), its 95% CI, and p(A better) — the
    honest way to call a winner between adjacent WER rows
    (metrics.paired_bootstrap; VERDICT r3 next #1)."""
    p = argparse.ArgumentParser(prog="compare")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--resamples", type=int, default=2000)
    args = p.parse_args(argv)
    import json
    from .metrics import paired_bootstrap
    recs = []
    for path in (args.a, args.b):
        with open(path) as f:
            recs.append(json.load(f)["per_utt"])
    out = paired_bootstrap(recs[0], recs[1], n_resamples=args.resamples)
    print(json.dumps(out, indent=2))
    lo, hi = out["wer_delta_ci95"]
    verdict = "A better" if hi < 0 else \
        "B better" if lo > 0 else "statistically tied"
    print(f"# {verdict} (delta={out['wer_delta']:+.4f}, "
          f"CI95=[{lo:+.4f}, {hi:+.4f}], "
          f"p_a_better={out['p_a_better']:.3f})")
    return 0


def cmd_transcribe(argv):
    overrides, rest = _split_args(argv)
    p = argparse.ArgumentParser(prog="transcribe")
    _common(p)
    p.add_argument("--ckpt", required=True)
    p.add_argument("wavs", nargs="+")
    args = p.parse_args(rest)
    cfg = _load_cfg(args, overrides)

    from . import checkpoint as ckpt_mod
    from .train import init_train_state
    from .transcribe import Transcriber

    template = init_train_state(cfg)
    path = args.ckpt
    if not path.endswith(".npz"):
        path = ckpt_mod.latest_checkpoint(path + "/ckpt") or path
    state, _ = ckpt_mod.load_checkpoint(path, template)
    tr = Transcriber(cfg, state["params"])
    for wav in args.wavs:
        print(f"{wav}\t{tr.transcribe_file(wav)}")
    return 0


def cmd_prepare_synth(argv):
    p = argparse.ArgumentParser(prog="prepare-synth")
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--min-words", type=int, default=2)
    p.add_argument("--max-words", type=int, default=7)
    args = p.parse_args(argv)
    from .data.synth import generate_corpus
    path = generate_corpus(args.out, num_utterances=args.n, seed=args.seed,
                           min_words=args.min_words,
                           max_words=args.max_words)
    print(path)
    return 0


def cmd_prepare_synth_hard(argv):
    p = argparse.ArgumentParser(
        prog="prepare-synth-hard",
        description="Discriminating synthetic corpus: speaker formant/"
                    "speed perturbation, additive noise at SNR, tone "
                    "babble, disjoint train/dev/test splits with "
                    "held-out test speakers.")
    p.add_argument("--out", required=True)
    p.add_argument("--n-train", type=int, default=512)
    p.add_argument("--n-dev", type=int, default=64)
    p.add_argument("--n-test", type=int, default=96)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--vocab-size", type=int, default=384)
    p.add_argument("--snr-low", type=float, default=5.0)
    p.add_argument("--snr-high", type=float, default=20.0)
    args = p.parse_args(argv)
    from .data.synth import generate_hard_corpus
    m = generate_hard_corpus(
        args.out, n_train=args.n_train, n_dev=args.n_dev,
        n_test=args.n_test, seed=args.seed, vocab_size=args.vocab_size,
        snr_db=(args.snr_low, args.snr_high))
    for k in ("train", "dev", "test"):
        print(f"{k}\t{m[k]}")
    return 0


def cmd_prepare_librispeech(argv):
    p = argparse.ArgumentParser(prog="prepare-librispeech")
    p.add_argument("--root", required=True,
                   help="extracted LibriSpeech root (contains e.g. "
                        "train-clean-100/)")
    p.add_argument("--out", required=True)
    p.add_argument("--subsets", nargs="*", default=None)
    p.add_argument("--no-convert", action="store_true",
                   help="manifest points straight at the original "
                        ".flac files (native decoder reads them in "
                        "the loader; no wav copies on disk)")
    args = p.parse_args(argv)
    from .data.generate import prepare_librispeech
    for path in prepare_librispeech(args.root, args.out, args.subsets,
                                    convert=not args.no_convert):
        print(path)
    return 0


def cmd_prepare_corpus(argv):
    """Per-corpus dataset generation + merge — the reference's
    generate_dataset.py entry point (SURVEY.md §3.4)."""
    p = argparse.ArgumentParser(prog="prepare-corpus")
    p.add_argument("corpus",
                   choices=["common-voice", "tedlium", "timit", "tatoeba",
                            "merge"])
    p.add_argument("--root", help="extracted corpus root (not for merge)")
    p.add_argument("--out", required=True)
    p.add_argument("--split", default=None,
                   help="corpus split (tedlium: train/dev/test; timit: "
                        "TRAIN/TEST; common-voice: a .tsv name)")
    p.add_argument("--lang", default="eng", help="tatoeba language code")
    p.add_argument("--manifests", nargs="*", default=[],
                   help="input manifest CSVs (merge only)")
    args = p.parse_args(argv)
    from .data import generate as gen
    if args.corpus == "merge":
        if not args.manifests:
            p.error("merge requires --manifests")
        print(gen.merge_manifests(args.manifests, args.out))
        return 0
    if not args.root:
        p.error(f"{args.corpus} requires --root")
    if args.corpus == "common-voice":
        kw = {"split_tsv": args.split} if args.split else {}
        print(gen.prepare_common_voice(args.root, args.out, **kw))
    elif args.corpus == "tedlium":
        kw = {"split": args.split} if args.split else {}
        print(gen.prepare_tedlium(args.root, args.out, **kw))
    elif args.corpus == "timit":
        kw = {"split": args.split} if args.split else {}
        print(gen.prepare_timit(args.root, args.out, **kw))
    elif args.corpus == "tatoeba":
        print(gen.prepare_tatoeba(args.root, args.out, lang=args.lang))
    return 0


def cmd_train_lm(argv):
    p = argparse.ArgumentParser(prog="train-lm")
    p.add_argument("--manifest", required=True, nargs="+")
    p.add_argument("--out", required=True)
    p.add_argument("--order", type=int, default=4)
    p.add_argument("--words", action="store_true",
                   help="train a word-level LM (for N-best rescoring) "
                        "instead of the char LM (for shallow fusion)")
    args = p.parse_args(argv)
    from .data.manifest import read_manifest
    from .ops import lm as lm_mod
    texts = []
    for m in args.manifest:
        texts.extend(u.transcript for u in read_manifest(m))
    if args.words:
        wlm = lm_mod.train_word_lm(texts, order=max(args.order, 1))
        lm_mod.save_word_lm(args.out, wlm)
        print(f"wrote {args.out} (word LM, order={wlm['order']}, "
              f"|V|={len(wlm['vocab'])})")
    else:
        lm = lm_mod.train_char_lm(texts, order=args.order)
        lm_mod.save_lm(args.out, lm)
        print(f"wrote {args.out} (char LM, order={args.order}, "
              f"table={lm['table'].shape})")
    return 0


def cmd_compute_stats(argv):
    overrides, rest = _split_args(argv)
    p = argparse.ArgumentParser(prog="compute-stats")
    _common(p)
    p.add_argument("--manifest", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--max-batches", type=int, default=None)
    args = p.parse_args(rest)
    cfg = _load_cfg(args, overrides)
    from .data.manifest import read_manifest
    from .features import compute_dataset_stats
    res = compute_dataset_stats(read_manifest(args.manifest), cfg.data,
                                cfg.features, args.out,
                                max_batches=args.max_batches)
    print(f"wrote {args.out} ({int(res['frames'])} frames)")
    return 0


def cmd_prepare_features(argv):
    """Precompute the feature cache for a manifest (data/feature_cache.py);
    train/evaluate consume it via --data.feature_cache=DIR."""
    overrides, rest = _split_args(argv)
    p = argparse.ArgumentParser(prog="prepare-features")
    _common(p)
    p.add_argument("--manifest", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--dtype", default="float16",
                   choices=("float16", "int8"),
                   help="cache wire dtype; int8 halves upload bytes "
                        "again (fixed-scale quantization)")
    args = p.parse_args(rest)
    cfg = _load_cfg(args, overrides)
    from .data.feature_cache import build_feature_cache
    from .data.manifest import read_manifest
    build_feature_cache(read_manifest(args.manifest), cfg.data,
                        cfg.features, args.out, dtype=args.dtype)
    print(args.out)
    return 0


COMMANDS = {
    "train": cmd_train,
    "evaluate": cmd_evaluate,
    "compare": cmd_compare,
    "transcribe": cmd_transcribe,
    "prepare-synth": cmd_prepare_synth,
    "prepare-synth-hard": cmd_prepare_synth_hard,
    "prepare-librispeech": cmd_prepare_librispeech,
    "prepare-corpus": cmd_prepare_corpus,
    "train-lm": cmd_train_lm,
    "compute-stats": cmd_compute_stats,
    "prepare-features": cmd_prepare_features,
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("commands:", ", ".join(COMMANDS))
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; have {sorted(COMMANDS)}",
              file=sys.stderr)
        return 2
    from .utils.compile_cache import setup_compile_cache
    setup_compile_cache()
    return COMMANDS[cmd](rest)


if __name__ == "__main__":
    sys.exit(main())
