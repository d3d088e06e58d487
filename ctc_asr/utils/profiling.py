"""Tracing/profiling (SURVEY.md §5 tracing row).

The reference had nothing beyond TensorBoard summaries; the build
provides: ``jax.profiler`` trace capture (viewable in perfetto /
tensorboard-profile), a wall-clock timer that ends in
``block_until_ready``, the card's name and power limit that every
device number is printed beside, and the one table of published device
peaks that every device metric divides by.
"""

from __future__ import annotations

import contextlib
import subprocess
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace for the enclosed block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def maybe_trace(log_dir: str):
    """trace(log_dir) when non-empty, else a no-op context."""
    return trace(log_dir) if log_dir else contextlib.nullcontext()


def time_fn(fn, *args, iters: int = 20, warmup: int = 3) -> float:
    """Seconds per call of ``fn(*args)``: ``warmup`` calls (compilation
    included), then a window of ``iters`` calls that ends in
    ``block_until_ready`` on the last output."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def card_line() -> str:
    """``name, power.limit`` of the first card, as ``nvidia-smi`` gives
    them: a card set below its maximum power runs slower under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# Published dense peaks per device, keyed by JAX's ``device_kind``.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM part, dense rates
# without sparsity, at the full 700 W power limit; a card set lower
# (``nvidia-smi`` power.limit) cannot hold them under a matrix-heavy
# load, so every device number is printed beside the card's limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12, "tf32_flops": 495e12,
        "hbm_bytes_s": 3.35e12,
        "source": "NVIDIA H100 SXM data sheet (dense)"},
}


def device_peaks(device_kind: str) -> dict:
    """Peaks of ``device_kind``; a device not in the table is an error
    for any device metric, never a default."""
    if device_kind not in PEAKS:
        raise ValueError(f"no published peaks for device {device_kind!r}; "
                         f"known: {sorted(PEAKS)}")
    return PEAKS[device_kind]
