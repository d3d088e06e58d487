"""CLI surface end-to-end (subprocess, CPU): prepare-synth -> train ->
evaluate -> transcribe -> train-lm (char + word)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(*args, timeout=240):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run([sys.executable, "-m", "ctc_asr.cli"]
                       + list(args), capture_output=True, text=True,
                       cwd=REPO, env=env, timeout=timeout)
    assert p.returncode == 0, f"{args}\nSTDOUT:{p.stdout}\nSTDERR:{p.stderr}"
    return p.stdout


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("cli"))


def test_full_cli_flow(workdir):
    # prepare
    out = run_cli("prepare-synth", "--out", f"{workdir}/corpus",
                  "--n", "8", "--min-words", "1", "--max-words", "2")
    manifest = out.strip().splitlines()[-1]
    assert os.path.exists(manifest)

    common = [
        "--preset", "pr1_mfcc_uni",
        f"--data.train_manifest={manifest}",
        f"--data.eval_manifest={manifest}",
        "--data.batch_size=4", "--data.num_buckets=1",
        "--data.min_audio_seconds=0.05",
        "--model.dense_units=32", "--model.rnn_units=32",
        "--model.dense_layers=1", "--model.rnn_layers=1",
        f"--train.train_dir={workdir}/run",
        "--train.checkpoint_every=5", "--train.log_every=5",
        "--mesh.data_axis=1",
    ]
    # train 5 steps
    out = run_cli("train", *common, "--max-steps", "5")
    assert "done at step 5" in out
    assert os.path.exists(f"{workdir}/run/ckpt/step_00000005.npz")

    # evaluate from the train dir
    out = run_cli("evaluate", *common, "--ckpt", f"{workdir}/run")
    res = json.loads(out[out.index("{"):])
    assert res["utterances"] == 8

    # transcribe a wav
    wav = os.path.join(os.path.dirname(manifest), "wav", "utt00000.wav")
    out = run_cli("transcribe", *common, "--ckpt", f"{workdir}/run", wav)
    assert wav in out

    # char + word LMs
    out = run_cli("train-lm", "--manifest", manifest,
                  "--out", f"{workdir}/char.npz", "--order", "2")
    assert "char LM" in out
    out = run_cli("train-lm", "--manifest", manifest, "--words",
                  "--out", f"{workdir}/word.pkl", "--order", "2")
    assert "word LM" in out


def test_cli_help_and_unknown():
    out = run_cli("--help")
    assert "commands:" in out
    env = dict(os.environ)
    p = subprocess.run([sys.executable, "-m", "ctc_asr.cli", "bogus"],
                       capture_output=True, text=True, cwd=REPO, env=env)
    assert p.returncode == 2


def test_cli_prepare_corpus_merge(tmp_path):
    """prepare-corpus merge: combine two manifests through the CLI."""
    from ctc_asr.cli import main as cli_main
    from ctc_asr.data import read_manifest
    from ctc_asr.data.synth import generate_corpus
    m1 = generate_corpus(str(tmp_path / "a"), num_utterances=4, seed=0)
    m2 = generate_corpus(str(tmp_path / "b"), num_utterances=3, seed=1)
    out = str(tmp_path / "merged.csv")
    assert cli_main(["prepare-corpus", "merge", "--out", out,
                     "--manifests", m1, m2]) == 0
    man = read_manifest(out)
    assert len(man) == 7
    # merged manifest is duration-sorted (_finalize contract)
    durs = [u.duration for u in man.utterances]
    assert durs == sorted(durs)


def test_cli_prepare_corpus_tedlium(tmp_path):
    """prepare-corpus tedlium end-to-end through the CLI (pre-converted
    talk wav, as in tests/test_generate.py)."""
    from ctc_asr.cli import main as cli_main
    from ctc_asr.data import read_manifest
    import numpy as np
    from ctc_asr import audio as audio_mod
    root = tmp_path / "TEDLIUM"
    out = tmp_path / "out"
    (root / "train" / "stm").mkdir(parents=True)
    (root / "train" / "sph").mkdir(parents=True)
    (out / "train" / "wav").mkdir(parents=True)
    rng = np.random.default_rng(0)
    audio_mod.write_wav(str(out / "train" / "wav" / "TalkA.wav"),
                        (rng.standard_normal(3 * 16000) * 0.1)
                        .astype(np.float32), 16000)
    (root / "train" / "stm" / "TalkA.stm").write_text(
        "TalkA 1 spk 0.50 1.20 <o> hello world\n")
    assert cli_main(["prepare-corpus", "tedlium", "--root", str(root),
                     "--out", str(out)]) == 0
    man = read_manifest(str(out / "tedlium_train.csv"))
    assert len(man) == 1 and man[0].transcript == "hello world"


def test_cli_compare_paired_bootstrap(tmp_path, capsys):
    """`cli compare` on two per-utterance dumps: decisive winner and
    the tied case both report correctly."""
    import json
    from ctc_asr.cli import main as cli_main
    a = tmp_path / "a.json"
    b = tmp_path / "b.json"
    a.write_text(json.dumps(
        {"per_utt": [[0, 4, 0, 10]] * 50}))
    b.write_text(json.dumps(
        {"per_utt": [[1, 4, 2, 10]] * 50}))
    assert cli_main(["compare", str(a), str(b)]) == 0
    out = capsys.readouterr().out
    assert "A better" in out
    assert cli_main(["compare", str(a), str(a)]) == 0
    out = capsys.readouterr().out
    assert "statistically tied" in out
