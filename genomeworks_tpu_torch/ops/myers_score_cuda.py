"""CUDA kernel for the batched Myers edit distance, a warp per alignment:
the card path of ``aligner.myers.myers_edit_distance_batched``.

It replaces no TPU kernel: the JAX package runs this scan as XLA ops
(genomeworks_tpu/aligner/myers.py ``_myers_scan``). The source is
``csrc/myers_score.cu``; the plain PyTorch version is
``aligner/myers.myers_score_plain``, which the wrapper runs for tensors on
the CPU.
"""

from __future__ import annotations

import ctypes

import torch

# a module import: aligner/myers.py imports this module at its top, and
# Python resolves a module import while that cycle is open
from genomeworks_tpu_torch.aligner import myers as _myers
from genomeworks_tpu_torch.ops import _build

SOURCE = "myers_score.cu"
#: query words a lane at most (the kernel's MAX_NPL); longer queries run in
#: chunks of 32 x MAX_WORDS_PER_LANE words
MAX_WORDS_PER_LANE = 16

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built kernel library."""
    lib.myers_score_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.myers_score_launch.restype = ctypes.c_int
    lib.myers_score_words_per_lane.argtypes = [ctypes.c_int]
    lib.myers_score_words_per_lane.restype = ctypes.c_int
    lib.myers_score_stats.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.myers_score_stats.restype = ctypes.c_int
    return lib


def load_library():
    """Build (at first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        _lib = bind(_build.load(SOURCE))
    return _lib


def myers_score_cuda(peq, t_codes, qlen, tlen):
    """Per alignment, qlen plus the carries out of its last query word over
    its target (``myers_score_plain``): peq int32 (B, 4, n_words), t_codes
    uint8 (B, T) codes 0-3, qlen and tlen int32 (B,) with qlen <= 32 n_words
    and tlen <= T -> int32 (B,).

    CUDA tensors go to the kernel, launched on the current stream; tensors
    on the CPU go to the plain version."""
    if peq.dim() != 3 or peq.shape[1] != 4 or t_codes.dim() != 2:
        raise ValueError(f"peq must be (B, 4, n_words) and t_codes (B, T), got "
                         f"{tuple(peq.shape)}, {tuple(t_codes.shape)}")
    B, _, n_words = peq.shape
    T = t_codes.shape[1]
    for name, x, dtype, shape in (("peq", peq, torch.int32, (B, 4, n_words)),
                                  ("t_codes", t_codes, torch.uint8, (B, T)),
                                  ("qlen", qlen, torch.int32, (B,)),
                                  ("tlen", tlen, torch.int32, (B,))):
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise TypeError(f"{name} must be {dtype} {shape}, got {x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous() or x.device != peq.device:
            raise ValueError(f"{name} must be contiguous on {peq.device}")
    if B and (int(qlen.min()) < 0 or int(qlen.max()) > 32 * n_words
              or int(tlen.min()) < 0 or int(tlen.max()) > T):
        raise ValueError("qlen must lie in [0, 32 n_words] and tlen in [0, T]")
    if t_codes.numel() and int(t_codes.max()) > 3:
        raise ValueError("t_codes must be 2-bit base codes 0-3")
    if peq.device.type == "cpu":
        return _myers.myers_score_plain(peq, t_codes, qlen, tlen)
    if peq.device.type != "cuda":
        raise ValueError(f"unsupported device {peq.device}")
    return _launch(load_library(), peq, t_codes, qlen, tlen)


def chunked(n_words: int) -> bool:
    """Whether a launch over ``n_words`` query words runs its longest
    queries in chunks (and needs the carry scratch)."""
    return n_words > 32 * MAX_WORDS_PER_LANE


def _launch(lib, peq, t_codes, qlen, tlen):
    """One launch of ``lib`` (this source or a build of another version of
    it) on checked CUDA tensors: the carry planes of a chunked query, 2 bits
    a target position, in a scratch allocated here."""
    B, _, n_words = peq.shape
    T = t_codes.shape[1]
    out = torch.empty(B, dtype=torch.int32, device=peq.device)
    carries = (torch.empty((B, 2 * ((T + 31) // 32)), dtype=torch.int32, device=peq.device)
               if chunked(n_words) else None)
    stream = torch.cuda.current_stream(peq.device).cuda_stream
    rc = lib.myers_score_launch(
        peq.data_ptr(), t_codes.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
        None if carries is None else carries.data_ptr(), out.data_ptr(), B, T, n_words,
        stream)
    if rc != 0:
        raise RuntimeError(f"myers_score_kernel launch failed: CUDA error {rc}")
    myers_score_cuda.launches += 1
    return out


myers_score_cuda.launches = 0
