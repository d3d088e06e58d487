"""chip_smoke.py's phases at tiny size on the CPU (the card runs them at
full width), its refusal to run without a GPU, and the compile-cache
placement every entry point shares."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TINY = ("--model.rnn_layers=1", "--model.rnn_units=16",
        "--model.conv_channels=[4,4]", "--model.dropout=0.0",
        "--train.learning_rate=3e-3", "--decode.beam_width=4",
        "--data.min_audio_seconds=0.05")


def test_main_path_tiny(tmp_path):
    out = chip_smoke.main_path(str(tmp_path), utterances=6, steps=4,
                               batch=2, overrides=TINY)
    assert out["loss_last"] < out["loss_first"]
    assert 0.0 <= out["eval_wer"]
    assert isinstance(out["transcript"], str)
    assert out["train_frames"] > 0 and out["train_label_len"] > 0
    assert out["train_compile_s"] > 0


def test_main_path_trains_afresh_each_run(tmp_path, capsys):
    """A second run in the same work directory trains every step again,
    where cli train would resume from the first run's last checkpoint
    and leave that run's metrics to be read back as this run's."""
    for _ in range(2):
        out = chip_smoke.main_path(str(tmp_path), utterances=6, steps=4,
                                   batch=2, overrides=TINY)
        log = capsys.readouterr().out
        assert all(f"[metrics] step={i} " in log for i in range(1, 5))
        assert out["train_compile_s"] > 0


def test_ctc_parity_phase_interpret():
    rows = chip_smoke.ctc_parity([(3, 20, 5), (2, 9, 3)], interpret=True)
    assert [(r["B"], r["T"], r["U"]) for r in rows] == \
        [(3, 20, 5), (2, 9, 3)]


def test_train_shape_matches_loader(tmp_path):
    from ctc_asr import config as cfg_mod
    from ctc_asr.data import DataLoader, read_manifest
    from ctc_asr.data.synth import generate_corpus
    man = generate_corpus(str(tmp_path), num_utterances=5, seed=1)
    args = ["--data.batch_size=2", "--data.num_buckets=1"]
    T, U = chip_smoke.train_shape("deepspeech_beam", man, args)
    cfg = cfg_mod.apply_overrides(cfg_mod.preset("deepspeech_beam"),
                                  {"data.batch_size": 2,
                                   "data.num_buckets": 1})
    it = iter(DataLoader(read_manifest(man), cfg.data, cfg.features))
    b = next(it)
    it.close()
    assert U == b.labels.shape[1]
    n_frames = 1 + (b.samples.shape[1] - cfg.features.win_length) \
        // cfg.features.hop_length
    assert T == -(-n_frames // 2)


def test_device_check_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.device_check()


def test_script_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=240)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    import jax
    from ctc_asr.utils import compile_cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    import jax
    from ctc_asr.utils import compile_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.setup_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
