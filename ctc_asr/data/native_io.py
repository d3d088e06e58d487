"""ctypes binding for the native batched wav decoder (native/ctcasr_io.cc).

The loader's host-side hot path — read + decode + pad a whole batch of
wavs — runs as ONE C call with an internal thread pool, replacing
per-utterance Python I/O (the reference's classic input bottleneck,
SURVEY.md §3.1). Auto-builds the .so from the sources in ``native/``
with g++ on first use (the library is never committed: it is built for
the host it runs on); callers fall back to the scipy path (audio.py)
when unavailable (``available()``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libctcasr_io.so")

_lib = None
_lock = threading.Lock()
_build_failed = False


def _ensure_built() -> bool:
    global _build_failed
    srcs = [os.path.join(_NATIVE_DIR, f)
            for f in ("ctcasr_io.cc", "flac_decode.cc", "flac_decode.h")]
    have_so = os.path.exists(_SO_PATH)
    if have_so and all(not os.path.exists(s) or
                       os.path.getmtime(s) <= os.path.getmtime(_SO_PATH)
                       for s in srcs):
        return True  # up-to-date, or deployed without sources
    if _build_failed:
        return have_so  # stale-but-working .so beats scipy fallback
    # build under a per-process name and rename into place: concurrent
    # first users (test workers, loader processes) never load a
    # half-written library
    tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, "-B",
                        f"TARGET={os.path.basename(tmp)}"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO_PATH)
        return True
    except (subprocess.SubprocessError, OSError):
        _build_failed = True
        if os.path.exists(tmp):
            os.remove(tmp)
        return have_so


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not _ensure_built():
            return None
        lib = ctypes.CDLL(_SO_PATH)
        lib.ctcasr_decode_batch.restype = ctypes.c_int
        lib.ctcasr_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        lib.ctcasr_wav_info.restype = ctypes.c_int
        lib.ctcasr_wav_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode_batch(paths: list, max_samples: int, n_threads: int = 4):
    """Decode wavs into a zero-padded [B, max_samples] float32 array.

    Returns (samples, lengths, sample_rates); a failed file gets
    length 0 (callers decide whether to raise).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native io library unavailable")
    n = len(paths)
    out = np.zeros((n, max_samples), dtype=np.float32)
    lengths = np.zeros((n,), dtype=np.int32)
    rates = np.zeros((n,), dtype=np.int32)
    c_paths = (ctypes.c_char_p * n)(
        *[p.encode() for p in paths])
    lib.ctcasr_decode_batch(
        c_paths, n, max_samples,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_threads)
    return out, lengths, rates


def wav_info(path: str):
    """(n_samples, sample_rate) via the native parser; None on failure."""
    lib = _load()
    if lib is None:
        return None
    n = ctypes.c_int64()
    sr = ctypes.c_int32()
    if lib.ctcasr_wav_info(path.encode(), ctypes.byref(n),
                           ctypes.byref(sr)) != 0:
        return None
    return int(n.value), int(sr.value)
