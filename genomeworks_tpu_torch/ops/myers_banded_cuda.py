"""CUDA kernel for the bit-parallel banded Myers forward pass, one warp per
alignment — the counterpart of genomeworks_tpu/ops/myers_banded_pallas.py
(``myers_banded_forward_pallas``). It writes the row-major (B, M16, W)
plane directly; there is no repack. A row warp holds the window in
registers (the library's ``myers_banded_words_per_lane(M, W)`` words a
lane) and stashes each row's code words in shared memory; 1-4 flush warps
transpose each 8 rows into the plane while the row warp runs the next 8.

The kernel source is ``csrc/myers_banded.cu``; its plain PyTorch version is
``aligner/myers_banded_model.myers_banded_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from genomeworks_tpu_torch.aligner.banded_nw import num_words
from genomeworks_tpu_torch.aligner.myers_banded_model import WBITS, myers_banded_plain
from genomeworks_tpu_torch.ops import _build
from genomeworks_tpu_torch.ops._pairs import check_pairs

SOURCE = "myers_banded.cu"
#: the widest band the kernel takes (csrc/myers_banded.cu: at most 33 window
#: words a lane, the window being W/32 + 4 words)
MAX_BAND = (33 * 32 - 4) * 32
#: shared memory a block can use on Hopper
MAX_SMEM = 232448

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built kernel library."""
    lib.myers_banded_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.myers_banded_launch.restype = ctypes.c_int
    lib.myers_banded_words_per_lane.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.myers_banded_words_per_lane.restype = ctypes.c_int
    lib.myers_banded_stats.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    lib.myers_banded_stats.restype = ctypes.c_int
    return lib


def load_library():
    """Build (at first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        _lib = bind(_build.load(SOURCE))
    return _lib


def smem_bytes(M: int, W: int) -> int:
    """Shared memory of one alignment (csrc/myers_banded.cu Geometry): four
    per-base masks of the target over (M + W + 64) / 32 words and one more,
    and the stash, two groups of 8 rows x 2 code bits x the window words 0
    to W/32 + 1 (rounded up to an odd count)."""
    NW = (M + W + 2 * WBITS + WBITS - 1) // WBITS
    S = (W // WBITS + 2) | 1
    return 4 * (4 * (NW + 1) + 2 * 8 * 2 * S)


def myers_banded_cuda(q, t, qlen, tlen, band_width: int):
    """Banded Myers of B pairs: q uint8 (B, M), t uint8 (B, N) base codes,
    qlen, tlen int32 (B,), W a multiple of 32 -> (codes int32
    (B, ceil(M/16), W), fits bool (B,)); rows past qlen are 0.

    CUDA tensors go to the kernel, launched on the current stream; tensors
    on the CPU go to the plain version. Inputs the kernel does not take
    raise: a band that is not a multiple of 32 or over MAX_BAND, or a shape
    whose shared memory is over MAX_SMEM."""
    B, M, _ = check_pairs(q, t, qlen, tlen, band_width)
    if band_width % WBITS or band_width > MAX_BAND:
        raise ValueError(f"band_width must be a multiple of {WBITS} up to {MAX_BAND}, "
                         f"got {band_width}")
    if smem_bytes(M, band_width) > MAX_SMEM:
        raise ValueError(f"M={M}, W={band_width} needs {smem_bytes(M, band_width)} bytes of "
                         f"shared memory, over {MAX_SMEM}")
    if q.device.type == "cpu":
        return myers_banded_plain(q, t, qlen, tlen, band_width)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(load_library(), q, t, qlen, tlen, band_width)


myers_banded_cuda.launches = 0


def _launch(lib, q, t, qlen, tlen, W):
    """Allocate the outputs and launch ``lib``'s kernel on the current
    stream."""
    B, M = q.shape
    codes = torch.empty((B, num_words(M), W), dtype=torch.int32, device=q.device)
    fits = torch.empty(B, dtype=torch.bool, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.myers_banded_launch(q.data_ptr(), t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
                                 codes.data_ptr(), fits.data_ptr(), B, M, t.shape[1], W, stream)
    if rc != 0:
        raise RuntimeError(f"myers_banded_kernel launch failed: CUDA error {rc}")
    myers_banded_cuda.launches += 1
    return codes, fits
