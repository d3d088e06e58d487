"""bench.py measures a GPU: on the CPU it must refuse (non-zero exit, no
result line), and its device metrics divide only by a published peak
of a known card."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), "--tiny",
         "--steps", "2", "--warmup", "1", "--no-decode"],
        env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert "measures a GPU" in out.stderr
    assert "train_throughput" not in out.stdout


def test_unknown_device_has_no_peak():
    from ctc_asr.utils.profiling import device_peaks
    pk = device_peaks("NVIDIA H100 80GB HBM3")
    assert pk["bf16_flops"] == 989e12 and pk["tf32_flops"] == 495e12
    assert pk["hbm_bytes_s"] == 3.35e12 and pk["source"]
    with pytest.raises(ValueError, match="no published peaks"):
        device_peaks("cpu")


def test_step_flops_scale_with_batch_and_layers():
    sys.path.insert(0, REPO)
    import dataclasses as dc
    import bench
    cfg, _, _ = bench.build_cfg("ds3")
    one = bench.model_step_flops(cfg, 1, 8.0)
    assert bench.model_step_flops(cfg, 16, 8.0) == pytest.approx(16 * one)
    fewer = dc.replace(cfg, model=dc.replace(cfg.model, rnn_layers=4))
    assert bench.model_step_flops(fewer, 1, 8.0) < one
