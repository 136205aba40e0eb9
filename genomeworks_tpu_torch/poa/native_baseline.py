"""ctypes binding to the native scalar CPU POA baseline
(native/spoa_cpu.cpp): the single-core "CPU SPOA" reference a benchmark
compares the card's kernels against.

The counterpart of genomeworks_tpu/poa/native_baseline.py, sharing its
library: bit-identical to ``cpu_reference.poa_consensus`` with unit weights
(tests/test_torch_native_spoa.py). When ``native/libgwspoa.so`` is not
there, ``make -C native`` builds it once, at first use, under a temporary
name that is then renamed into place, so a concurrent loader never opens a
half-written library; :func:`available` says whether it loaded.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libgwspoa.so"
_lib = None
_tried = False


def _build() -> bool:
    """``make -C native`` of libgwspoa.so under a temporary name, renamed
    into place; False when the build fails."""
    tmp = f"libgwspoa.so.{os.getpid()}.tmp"
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR), tmp, f"SPOALIB={tmp}"],
                       check=True, capture_output=True, timeout=120)
        os.replace(_NATIVE_DIR / tmp, _LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        (_NATIVE_DIR / tmp).unlink(missing_ok=True)
        return False
    return True


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB_PATH.exists() and not _build():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.gw_spoa_consensus.restype = ctypes.c_int32
    lib.gw_spoa_consensus.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def poa_consensus_native(
    window: list[str], gap: int = -8, mismatch: int = -6, match: int = 8
) -> tuple[str, np.ndarray]:
    """Consensus + coverage of one window via the native baseline."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native baseline not built")
    blob = "".join(window).encode("latin1")
    lens = (ctypes.c_int32 * len(window))(*[len(s) for s in window])
    cap = 4 * max(len(s) for s in window) + 16
    cons = ctypes.create_string_buffer(cap)
    cov = (ctypes.c_int32 * cap)()
    rc = lib.gw_spoa_consensus(
        blob, lens, len(window), gap, mismatch, match, cons, cov, cap
    )
    if rc < 0:
        raise RuntimeError(f"native POA failed: status {-rc}")
    return cons.raw[:rc].decode("latin1"), np.ctypeslib.as_array(cov)[:rc].copy()
