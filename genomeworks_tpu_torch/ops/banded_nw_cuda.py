"""CUDA kernels for the banded unit-cost DP with 2-bit traceback codes — the
counterpart of genomeworks_tpu/ops/banded_nw_pallas.py
(``banded_nw_forward_pallas``): one warp per alignment for bands up to
the library's ``banded_nw_warp_max_band()`` (``banded_nw_warp_kernel``),
one thread block per alignment past it (``banded_nw_kernel``: up to 32
warps, ``banded_nw_block_cols(W)`` band columns a lane), chosen by the
launcher.

The kernel source is ``csrc/banded_nw.cu``; its plain PyTorch version is
``aligner/banded_nw.banded_nw_forward_plain``, and with the distance output
``banded_nw_final_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from genomeworks_tpu_torch.aligner.banded_nw import (
    banded_nw_final_plain,
    banded_nw_forward_plain,
    num_words,
)
from genomeworks_tpu_torch.ops import _build
from genomeworks_tpu_torch.ops._pairs import check_pairs

SOURCE = "banded_nw.cu"
#: the widest band the kernel takes (csrc/banded_nw.cu: the block kernel's
#: 16 warps of 32 lanes of 32 columns past band 8192)
MAX_BAND = 16 * 32 * 32

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built kernel library."""
    lib.banded_nw_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.banded_nw_launch.restype = ctypes.c_int
    lib.banded_nw_warp_max_band.argtypes = []
    lib.banded_nw_warp_max_band.restype = ctypes.c_int
    lib.banded_nw_block_cols.argtypes = [ctypes.c_int]
    lib.banded_nw_block_cols.restype = ctypes.c_int
    lib.banded_nw_stats.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    lib.banded_nw_stats.restype = ctypes.c_int
    return lib


def load_library():
    """Build (at first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        _lib = bind(_build.load(SOURCE))
    return _lib


def banded_nw_cuda(q, t, qlen, tlen, band_width: int, with_dist: bool = False):
    """Banded DP of B pairs: q uint8 (B, M), t uint8 (B, N) base codes,
    qlen, tlen int32 (B,) -> (codes int32 (B, ceil(M/16), W), fits bool (B,)),
    and with ``with_dist`` (dist int32 (B,), codes, fits): the edit distance,
    INF where the pair does not fit the band.

    CUDA tensors go to the kernel, launched on the current stream; tensors
    on the CPU go to the plain version. Inputs the kernel does not take
    raise, a band over MAX_BAND among them."""
    check_pairs(q, t, qlen, tlen, band_width)
    if band_width > MAX_BAND:
        raise ValueError(f"band_width {band_width} is over the kernel's {MAX_BAND}")
    if q.device.type == "cpu":
        plain = banded_nw_final_plain if with_dist else banded_nw_forward_plain
        return plain(q, t, qlen, tlen, band_width)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(load_library(), q, t, qlen, tlen, band_width, with_dist)


banded_nw_cuda.launches = 0


def _launch(lib, q, t, qlen, tlen, W, with_dist=False):
    """Allocate the outputs and launch ``lib``'s kernel on the current
    stream; (codes, fits), or (dist, codes, fits) ``with_dist``."""
    B, M = q.shape
    codes = torch.empty((B, num_words(M), W), dtype=torch.int32, device=q.device)
    fits = torch.empty(B, dtype=torch.bool, device=q.device)
    dist = torch.empty(B, dtype=torch.int32, device=q.device) if with_dist else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.banded_nw_launch(q.data_ptr(), t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
                              codes.data_ptr(), fits.data_ptr(),
                              dist.data_ptr() if with_dist else None, B, M, t.shape[1], W, stream)
    if rc != 0:
        raise RuntimeError(f"banded_nw_kernel launch failed: CUDA error {rc}")
    banded_nw_cuda.launches += 1
    return (dist, codes, fits) if with_dist else (codes, fits)
