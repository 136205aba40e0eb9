"""CUDA kernels of the lockstep POA tier — the counterparts of the five
Pallas kernels of genomeworks_tpu/ops/poa_lockstep_pallas.py.

The source is ``csrc/poa_lockstep.cu``; the plain PyTorch versions are in
``poa/lockstep_plain.py``. Each wrapper takes the graph state dict of
``torch_poa.init_graph_state`` (updated in place) and the bucket's tensors,
checks their types, shapes, devices and contiguity (metadata only: no host
sync), and on CUDA tensors launches its kernel on the current stream, or
raises; on CPU tensors it runs the plain version. ``act`` is a (B,) bool
tensor: the windows that have this read. Each wrapper counts its launches
in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from genomeworks_tpu_torch.ops import _build
from genomeworks_tpu_torch.poa import lockstep_plain as plain
from genomeworks_tpu_torch.poa.torch_poa import STATE_KEYS

SOURCE = "poa_lockstep.cu"
#: priority codes are stored as uint8 and reach 3E + 1
MAX_EDGES = 84

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built kernel library."""
    P, I = ctypes.c_void_p, ctypes.c_int
    st = [ctypes.POINTER(ctypes.c_void_p)] + [I] * 4
    for name, rest in (
        ("lk_nw_launch", [P, I, P, P, P, I, P, P, I, I, I, I, P]),
        ("lk_tb_launch", [P, I, P, P, P, P, P, P, I, P]),
        ("lk_add_launch", [P, P, P, I, P, P, I, P, P]),
        ("lk_topsort_launch", [P, P, P]),
        ("lk_consensus_launch", [P, P, P, P, P, P, P]),
    ):
        fn = getattr(lib, name)
        fn.argtypes = st + rest
        fn.restype = ctypes.c_int
    return lib


def load_library():
    """Build (at first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        _lib = bind(_build.load(SOURCE))
    return _lib


def _check(name, t, dtype, shape, dev):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the state on {dev}")


def _check_state(state, act):
    """(B, N, E, A, device) of a valid state and act; raises otherwise."""
    B, N = state["nodes"].shape
    E, A = state["in_edges"].shape[2], state["al"].shape[2]
    dev = state["nodes"].device
    shapes = {"in_edges": (B, N, E), "in_w": (B, N, E), "out_edges": (B, N, E),
              "al": (B, N, A), "node_count": (B,), "error": (B,)}
    for k in STATE_KEYS:
        _check(f"state[{k!r}]", state[k], torch.int32, shapes.get(k, (B, N)), dev)
    _check("act", act, torch.bool, (B,), dev)
    if not 1 <= E <= MAX_EDGES or A < 2 or B < 1 or N < 1:
        raise ValueError(f"unsupported caps or sizes: B={B} N={N} E={E} A={A}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return B, N, E, A, dev


def _ptrs(state):
    return (ctypes.c_void_p * len(STATE_KEYS))(*(state[k].data_ptr() for k in STATE_KEYS))


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(rc, kernel):
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")


def nw_lockstep(state, read, read_len, act, codes, D: int, gap: int, mismatch: int,
                match: int):
    """Full-band NW of ``read`` (B, Lr) uint8 against each window's graph:
    priority codes into ``codes`` (B, N, Lp) uint8, Lp > Lr; returns best_i
    (B,) int32; sets errors 5 and 6 (``lockstep_plain.nw_lockstep_plain``).
    On CUDA the kernel keeps its ring of D + 1 score rows a window in
    scratch this wrapper allocates."""
    B, N, E, A, dev = _check_state(state, act)
    Lr = read.shape[1] if read.dim() == 2 else -1
    Lp = codes.shape[2] if codes.dim() == 3 else -1
    _check("read", read, torch.uint8, (B, Lr), dev)
    _check("read_len", read_len, torch.int32, (B,), dev)
    _check("codes", codes, torch.uint8, (B, N, Lp), dev)
    if Lp < Lr + 1 or not 1 <= D <= 255:
        raise ValueError(f"codes need Lp > Lr and D in [1, 255]: Lp={Lp} Lr={Lr} D={D}")
    if dev.type == "cpu":
        return plain.nw_lockstep_plain(state, read, read_len, act, codes, D, gap, mismatch,
                                       match)
    best_i = torch.empty(B, dtype=torch.int32, device=dev)
    ring = torch.empty((B, D + 1, Lp), dtype=torch.int32, device=dev)
    rc = load_library().lk_nw_launch(
        _ptrs(state), B, N, E, A, read.data_ptr(), Lr, read_len.data_ptr(), act.data_ptr(),
        codes.data_ptr(), Lp, best_i.data_ptr(), ring.data_ptr(), D, gap, mismatch, match,
        _stream(dev))
    _raise_on(rc, "lk_nw_kernel")
    nw_lockstep.launches += 1
    return best_i


def tb_lockstep(state, codes, best_i, read_len, act, K: int):
    """Traceback over ``codes`` from (best_i, read_len): (ag, ar (B, K)
    int32, klen (B,) int32); sets error 3 (``lockstep_plain.tb_lockstep_plain``)."""
    B, N, E, A, dev = _check_state(state, act)
    Lp = codes.shape[2] if codes.dim() == 3 else -1
    _check("codes", codes, torch.uint8, (B, N, Lp), dev)
    _check("best_i", best_i, torch.int32, (B,), dev)
    _check("read_len", read_len, torch.int32, (B,), dev)
    if K < 1:
        raise ValueError(f"K must be positive, got {K}")
    if dev.type == "cpu":
        return plain.tb_lockstep_plain(state, codes, best_i, read_len, act, K)
    ag = torch.full((B, K), -1, dtype=torch.int32, device=dev)
    ar = torch.full((B, K), -1, dtype=torch.int32, device=dev)
    klen = torch.empty(B, dtype=torch.int32, device=dev)
    rc = load_library().lk_tb_launch(
        _ptrs(state), B, N, E, A, codes.data_ptr(), Lp, best_i.data_ptr(), read_len.data_ptr(),
        act.data_ptr(), ag.data_ptr(), ar.data_ptr(), klen.data_ptr(), K, _stream(dev))
    _raise_on(rc, "lk_tb_kernel")
    tb_lockstep.launches += 1
    return ag, ar, klen


def add_lockstep(state, ag, ar, klen, read, weights, act):
    """Add the alignments to the graphs in place; ``weights`` (B, Lr) int32
    or None for unit weights; sets errors 1 and 6
    (``lockstep_plain.add_lockstep_plain``). Returns the state."""
    B, N, E, A, dev = _check_state(state, act)
    K = ag.shape[1] if ag.dim() == 2 else -1
    Lr = read.shape[1] if read.dim() == 2 else -1
    _check("ag", ag, torch.int32, (B, K), dev)
    _check("ar", ar, torch.int32, (B, K), dev)
    _check("klen", klen, torch.int32, (B,), dev)
    _check("read", read, torch.uint8, (B, Lr), dev)
    if weights is not None:
        _check("weights", weights, torch.int32, (B, Lr), dev)
    if dev.type == "cpu":
        return plain.add_lockstep_plain(state, ag, ar, klen, read, weights, act)
    rc = load_library().lk_add_launch(
        _ptrs(state), B, N, E, A, ag.data_ptr(), ar.data_ptr(), klen.data_ptr(), K,
        read.data_ptr(), None if weights is None else weights.data_ptr(), Lr, act.data_ptr(),
        _stream(dev))
    _raise_on(rc, "lk_add_kernel")
    add_lockstep.launches += 1
    return state


def topsort_lockstep(state, act):
    """Kahn's sort of each graph in place; sets error 100
    (``lockstep_plain.topsort_lockstep_plain``). Returns the state."""
    B, N, E, A, dev = _check_state(state, act)
    if dev.type == "cpu":
        return plain.topsort_lockstep_plain(state, act)
    local = torch.empty((B, N), dtype=torch.int32, device=dev)
    rc = load_library().lk_topsort_launch(_ptrs(state), B, N, E, A, act.data_ptr(),
                                          local.data_ptr(), _stream(dev))
    _raise_on(rc, "lk_topsort_kernel")
    topsort_lockstep.launches += 1
    return state


def consensus_lockstep(state, act):
    """(cons (B, N) uint8 backward, cov (B, N) int32, length (B,), err (B,))
    (``lockstep_plain.consensus_lockstep_plain``)."""
    B, N, E, A, dev = _check_state(state, act)
    if dev.type == "cpu":
        return plain.consensus_lockstep_plain(state, act)
    cons = torch.zeros((B, N), dtype=torch.uint8, device=dev)
    cov = torch.zeros((B, N), dtype=torch.int32, device=dev)
    length = torch.empty(B, dtype=torch.int32, device=dev)
    err = torch.empty(B, dtype=torch.int32, device=dev)
    scratch = torch.empty((B, 2, N), dtype=torch.int32, device=dev)
    rc = load_library().lk_consensus_launch(
        _ptrs(state), B, N, E, A, act.data_ptr(), cons.data_ptr(), cov.data_ptr(),
        length.data_ptr(), err.data_ptr(), scratch.data_ptr(), _stream(dev))
    _raise_on(rc, "lk_consensus_kernel")
    consensus_lockstep.launches += 1
    return cons, cov, length, err


#: the wrappers, in chain order
KERNELS = (nw_lockstep, tb_lockstep, add_lockstep, topsort_lockstep, consensus_lockstep)
for _k in KERNELS:
    _k.launches = 0
