"""ctypes bindings to the native IO/runtime library (native/gwio.cpp).

The counterpart of genomeworks_tpu/io/native.py, sharing its library: the
data-loader path the reference implements in C++ (kseq++-based FASTA/FASTQ
parsing, common/io) plus parallel 2-bit read packing (reference analogue:
cudamapper host read gathering, index_gpu.cuh:832-890). When
``native/libgwio.so`` has not been built, ``make -C native`` builds it once,
at first use, under a temporary name that is then renamed into place, so a
concurrent loader never opens a half-written library; callers learn from
:func:`native_available` whether it loaded.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libgwio.so"
_lib = None
_tried = False


def _build() -> bool:
    """``make -C native`` of libgwio.so under a temporary name, renamed into
    place; False when the build fails."""
    tmp = f"libgwio.so.{os.getpid()}.tmp"
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR), tmp, f"LIB={tmp}"],
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
    lib.gw_fasta_parse.restype = ctypes.c_void_p
    lib.gw_fasta_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
    lib.gw_fasta_num_seqs.restype = ctypes.c_int64
    lib.gw_fasta_num_seqs.argtypes = [ctypes.c_void_p]
    lib.gw_fasta_max_len.restype = ctypes.c_int64
    lib.gw_fasta_max_len.argtypes = [ctypes.c_void_p]
    lib.gw_fasta_seq_len.restype = ctypes.c_int64
    lib.gw_fasta_seq_len.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.gw_fasta_seq.restype = ctypes.c_char_p
    lib.gw_fasta_seq.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.gw_fasta_name.restype = ctypes.c_char_p
    lib.gw_fasta_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.gw_fasta_free.restype = None
    lib.gw_fasta_free.argtypes = [ctypes.c_void_p]
    lib.gw_fasta_pack_2bit.restype = None
    lib.gw_fasta_pack_2bit.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
    ]
    if hasattr(lib, "gw_codes_pack_2bit"):
        lib.gw_codes_pack_2bit.restype = ctypes.c_int
        lib.gw_codes_pack_2bit.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
    _lib = lib
    return _lib


def codes_pack_2bit(seqs: np.ndarray) -> tuple[np.ndarray, bool] | None:
    """2-bit-pack a zero-padded uint8 base matrix whose last axis is a
    multiple of 4, in one native pass, with the reference's encoding
    ``0b11 & (c >> 2 ^ c >> 1)`` (minimizer.cu:197): A=0 C=1 G=2 T=3, the
    pad byte 0 to 0; base 4 i + k goes to bits 2 k of byte i. Returns
    (packed last-axis/4 uint8 array, all bytes in {0, A, C, G, T}) or None
    when the native library is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "gw_codes_pack_2bit"):
        return None
    if seqs.dtype != np.uint8 or not seqs.flags.c_contiguous or seqs.shape[-1] % 4:
        raise ValueError("seqs must be a C-contiguous uint8 array whose last axis is a "
                         "multiple of 4")
    out = np.empty(seqs.shape[:-1] + (seqs.shape[-1] // 4,), dtype=np.uint8)
    ok = lib.gw_codes_pack_2bit(
        seqs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out, bool(ok)


def native_available() -> bool:
    return _load() is not None


class NativeFastaHandle:
    """Owns a native FastaSet; exposes lazy record access and parallel
    fixed-shape 2-bit packing."""

    def __init__(self, path: str, min_sequence_length: int = 0, shuffle: bool = False):
        lib = _load()
        if lib is None:
            raise RuntimeError("native gwio library unavailable")
        self._lib = lib
        self._h = lib.gw_fasta_parse(
            str(path).encode(), int(min_sequence_length), int(bool(shuffle))
        )
        if not self._h:
            raise FileNotFoundError(path)

    def __len__(self) -> int:
        return int(self._lib.gw_fasta_num_seqs(self._h))

    def max_len(self) -> int:
        return int(self._lib.gw_fasta_max_len(self._h))

    def name(self, i: int) -> str:
        return self._lib.gw_fasta_name(self._h, i).decode()

    def seq(self, i: int) -> str:
        return self._lib.gw_fasta_seq(self._h, i).decode()

    def seq_len(self, i: int) -> int:
        return int(self._lib.gw_fasta_seq_len(self._h, i))

    def pack_2bit(
        self, first: int, n: int, max_len: int | None = None, num_threads: int = 0
    ) -> tuple[np.ndarray, np.ndarray]:
        """Pack reads [first, first+n) into ((n, max_len) uint8 codes A=0 C=1
        G=2 T=3, one a byte, zero-padded; (n,) int32 lengths) in parallel
        native threads."""
        if max_len is None:
            max_len = self.max_len()
        if first < 0 or n < 0 or first + n > len(self):
            raise IndexError(f"reads [{first}, {first + n}) outside 0..{len(self)}")
        codes = np.zeros((n, max_len), dtype=np.uint8)
        lens = np.zeros((n,), dtype=np.int32)
        self._lib.gw_fasta_pack_2bit(
            self._h, first, n, max_len,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            num_threads,
        )
        return codes, lens

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.gw_fasta_free(self._h)
            self._h = None
