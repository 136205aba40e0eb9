"""CUDA kernels of the ungapped X-drop extender: the extension of both
directions of a batch of seeds in one launch, a warp a seed (a lane scores
``LANE_POSITIONS`` consecutive positions of a tile), and the A/C/G/T match
counts of the final segments that the entropy reads (``COUNT_LANES`` lanes
a seed, four seeds a warp).

They replace no TPU kernel: the JAX package runs the extension as XLA ops
(genomeworks_tpu/extender/xdrop.py, ``_extend_direction`` and
``_count_matches``). The source is ``csrc/xdrop.cu``; the plain PyTorch
versions are ``extender/xdrop_plain.py`` (``xdrop_extend_plain``,
``count_matches_plain``), which the wrappers run for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from genomeworks_tpu_torch.extender.xdrop_plain import count_matches_plain, xdrop_extend_plain
from genomeworks_tpu_torch.ops import _build

SOURCE = "xdrop.cu"
#: positions a lane scores a tile of xdrop_extend_kernel (the source's
#: ``constexpr int K``): a tile is 32 of them
LANE_POSITIONS = 8
#: lanes a seed of xdrop_count_kernel (the source's ``constexpr int
#: COUNT_LANES``), each counting LANE_POSITIONS positions a pass
COUNT_LANES = 8

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built kernel library."""
    lib.xdrop_extend_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.xdrop_extend_launch.restype = ctypes.c_int
    lib.xdrop_count_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.xdrop_count_launch.restype = ctypes.c_int
    lib.xdrop_stats.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.xdrop_stats.restype = ctypes.c_int
    return lib


def load_library():
    """Build (at first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        _lib = bind(_build.load(SOURCE))
    return _lib


def _check(query, target, named):
    """query, target uint8 (Lq,), (Lt,), non-empty; every tensor of
    ``named`` int32 (n,) of one length; all contiguous on one device."""
    for name, x in (("query", query), ("target", target)):
        if x.dtype != torch.uint8 or x.dim() != 1:
            raise TypeError(f"{name} must be a uint8 vector, got {x.dtype} {tuple(x.shape)}")
        if x.numel() == 0:
            raise ValueError(f"{name} is empty")
    n = next(iter(named.values())).shape[0]
    for name, x in named.items():
        if x.dtype != torch.int32 or tuple(x.shape) != (n,):
            raise TypeError(f"{name} must be int32 ({n},), got {x.dtype} {tuple(x.shape)}")
    for name, x in (("query", query), ("target", target), *named.items()):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != query.device:
            raise ValueError(f"{name} is on {x.device}, query on {query.device}")
    if query.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {query.device}")
    return n


def xdrop_extend_cuda(query, target, qpos, tpos, sub, xdrop: int):
    """Both directions of S seeds -> int32 (S, 4) of (right max score, right
    max position, left max score, left max position), as
    ``xdrop_extend_plain``. sub int32 (64,): target code a against query
    code b at 8 a + b; codes 0-7.

    CUDA tensors go to the kernel, launched on the current stream; tensors
    on the CPU go to the plain version."""
    S = _check(query, target, {"qpos": qpos, "tpos": tpos})
    if sub.dtype != torch.int32 or tuple(sub.shape) != (64,) or sub.device != query.device \
            or not sub.is_contiguous():
        raise TypeError("sub must be a contiguous int32 (64,) on the sequences' device")
    if query.device.type == "cpu":
        return xdrop_extend_plain(query, target, qpos, tpos, sub, xdrop)
    out = torch.empty((S, 4), dtype=torch.int32, device=query.device)
    stream = torch.cuda.current_stream(query.device).cuda_stream
    rc = load_library().xdrop_extend_launch(
        query.data_ptr(), target.data_ptr(), qpos.data_ptr(), tpos.data_ptr(),
        sub.data_ptr(), out.data_ptr(), S, query.numel(), target.numel(),
        int(xdrop), stream)
    if rc != 0:
        raise RuntimeError(f"xdrop_extend_kernel launch failed: CUDA error {rc}")
    xdrop_extend_cuda.launches += 1
    return out


xdrop_extend_cuda.launches = 0


def xdrop_count_cuda(query, target, qpos, tpos, left, right):
    """A/C/G/T match counts of n final segments -> int32 (n, 4), as
    ``count_matches_plain``: left and right are the extension's left and
    right max positions.

    CUDA tensors go to the kernel, launched on the current stream; tensors
    on the CPU go to the plain version."""
    n = _check(query, target, {"qpos": qpos, "tpos": tpos, "left": left, "right": right})
    if query.device.type == "cpu":
        return count_matches_plain(query, target, qpos, tpos, left, right)
    counts = torch.empty((n, 4), dtype=torch.int32, device=query.device)
    stream = torch.cuda.current_stream(query.device).cuda_stream
    rc = load_library().xdrop_count_launch(
        query.data_ptr(), target.data_ptr(), qpos.data_ptr(), tpos.data_ptr(),
        left.data_ptr(), right.data_ptr(), counts.data_ptr(), n, query.numel(),
        target.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"xdrop_count_kernel launch failed: CUDA error {rc}")
    xdrop_count_cuda.launches += 1
    return counts


xdrop_count_cuda.launches = 0
