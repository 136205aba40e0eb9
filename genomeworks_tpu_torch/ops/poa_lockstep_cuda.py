"""CUDA kernels of the lockstep POA tier — the counterparts of the five
Pallas kernels of genomeworks_tpu/ops/poa_lockstep_pallas.py.

The source is ``csrc/poa_lockstep.cu``; the plain PyTorch versions are in
``poa/lockstep_plain.py``. A read on the main path is two launches:
:func:`nw_lockstep` and :func:`read_lockstep` (the traceback, add and
topsort fused in ``lk_read_kernel``); :func:`tb_lockstep`,
:func:`add_lockstep` and :func:`topsort_lockstep` launch that kernel's
single-phase instantiations, so that each phase can be held to its plain
version. Each wrapper takes the graph state dict of
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

#: lk_read_kernel's phases (its template parameter): traceback, add,
#: topsort, or all three
PH_TB, PH_ADD, PH_SORT, PH_ALL = 1, 2, 4, 7
#: lk_read_kernel keeps node ids and positions in 16 bits
MAX_READ_NODES = 32767
#: lk_consensus_kernel keeps a window's scores and predecessors (8 N bytes)
#: in shared memory, within the 227 KB a block may have
MAX_CONSENSUS_NODES = 28672

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built kernel library."""
    P, I = ctypes.c_void_p, ctypes.c_int
    st = [ctypes.POINTER(ctypes.c_void_p)] + [I] * 4
    for name, rest in (
        ("lk_nw_launch", [P, I, P, P, P, I, P, P, I, I, I, I, P]),
        ("lk_read_launch", [I, P, I, P, P, P, P, P, P, I, P, P, I, P]),
        ("lk_consensus_launch", [P, P, P, P, P, P]),
    ):
        fn = getattr(lib, name)
        fn.argtypes = st + rest
        fn.restype = ctypes.c_int
    for name, args in (("lk_nw_ring_width", [I]), ("lk_read_windows_in_flight", [I] * 4),
                       ("lk_consensus_windows_in_flight", [I]),
                       ("lk_read_stats", [ctypes.POINTER(ctypes.c_ulonglong), I])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = ctypes.c_int
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
    On CUDA the kernel runs a warp per window and takes reads of at most
    639 bases; the rows it reads from farther than its shared-memory ring
    go to a ring of D + 1 rows a window in scratch this wrapper allocates."""
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
    lib = load_library()
    width = lib.lk_nw_ring_width(Lr)
    if width == 0:
        raise ValueError(f"the NW kernel takes reads of at most 639 bases, got Lr={Lr}")
    best_i = torch.empty(B, dtype=torch.int32, device=dev)
    ring = torch.empty((B, D + 1, width), dtype=torch.int32, device=dev)
    rc = lib.lk_nw_launch(
        _ptrs(state), B, N, E, A, read.data_ptr(), Lr, read_len.data_ptr(), act.data_ptr(),
        codes.data_ptr(), Lp, best_i.data_ptr(), ring.data_ptr(), D, gap, mismatch, match,
        _stream(dev))
    _raise_on(rc, "lk_nw_kernel")
    nw_lockstep.launches += 1
    return best_i


def _ptr(t):
    return None if t is None else t.data_ptr()


def _read_launch(state, phases, K, codes=None, best_i=None, read_len=None, act=None, ag=None,
                 ar=None, klen=None, read=None, weights=None):
    """Launch lk_read_kernel<phases> on checked CUDA tensors, or raise."""
    B, N = state["nodes"].shape
    E, A = state["in_edges"].shape[2], state["al"].shape[2]
    if N > MAX_READ_NODES:
        raise ValueError(f"lk_read_kernel takes at most {MAX_READ_NODES} nodes, got N={N}")
    Lp = codes.shape[2] if codes is not None else 0
    Lr = read.shape[1] if read is not None else 0
    rc = load_library().lk_read_launch(
        _ptrs(state), B, N, E, A, phases, _ptr(codes), Lp, _ptr(best_i), _ptr(read_len),
        _ptr(act), _ptr(ag), _ptr(ar), _ptr(klen), K, _ptr(read), _ptr(weights), Lr,
        _stream(act.device))
    _raise_on(rc, f"lk_read_kernel<{phases}>")


def _check_tb(state, codes, best_i, read_len, act, K):
    B, N, E, A, dev = _check_state(state, act)
    Lp = codes.shape[2] if codes.dim() == 3 else -1
    _check("codes", codes, torch.uint8, (B, N, Lp), dev)
    _check("best_i", best_i, torch.int32, (B,), dev)
    _check("read_len", read_len, torch.int32, (B,), dev)
    if K < 1:
        raise ValueError(f"K must be positive, got {K}")
    return B, dev


def _check_read(state, read, weights, act):
    B, N, E, A, dev = _check_state(state, act)
    Lr = read.shape[1] if read.dim() == 2 else -1
    _check("read", read, torch.uint8, (B, Lr), dev)
    if weights is not None:
        _check("weights", weights, torch.int32, (B, Lr), dev)


def tb_lockstep(state, codes, best_i, read_len, act, K: int):
    """Traceback over ``codes`` from (best_i, read_len): (ag, ar (B, K)
    int32, klen (B,) int32); sets error 3 (``lockstep_plain.tb_lockstep_plain``).
    On CUDA the traceback alone of ``lk_read_kernel``."""
    B, dev = _check_tb(state, codes, best_i, read_len, act, K)
    if dev.type == "cpu":
        return plain.tb_lockstep_plain(state, codes, best_i, read_len, act, K)
    ag = torch.full((B, K), -1, dtype=torch.int32, device=dev)
    ar = torch.full((B, K), -1, dtype=torch.int32, device=dev)
    klen = torch.empty(B, dtype=torch.int32, device=dev)
    _read_launch(state, PH_TB, K, codes, best_i, read_len, act, ag=ag, ar=ar, klen=klen)
    tb_lockstep.launches += 1
    return ag, ar, klen


def add_lockstep(state, ag, ar, klen, read, weights, act):
    """Add the alignments to the graphs in place; ``weights`` (B, Lr) int32
    or None for unit weights; sets errors 1 and 6
    (``lockstep_plain.add_lockstep_plain``). Returns the state. On CUDA the
    add alone of ``lk_read_kernel``."""
    B, N, E, A, dev = _check_state(state, act)
    K = ag.shape[1] if ag.dim() == 2 else -1
    _check("ag", ag, torch.int32, (B, K), dev)
    _check("ar", ar, torch.int32, (B, K), dev)
    _check("klen", klen, torch.int32, (B,), dev)
    _check_read(state, read, weights, act)
    if dev.type == "cpu":
        return plain.add_lockstep_plain(state, ag, ar, klen, read, weights, act)
    _read_launch(state, PH_ADD, K, act=act, ag=ag, ar=ar, klen=klen, read=read, weights=weights)
    add_lockstep.launches += 1
    return state


def topsort_lockstep(state, act):
    """Kahn's sort of each graph in place; sets error 100
    (``lockstep_plain.topsort_lockstep_plain``). Returns the state. On CUDA
    the topsort alone of ``lk_read_kernel``."""
    B, N, E, A, dev = _check_state(state, act)
    if dev.type == "cpu":
        return plain.topsort_lockstep_plain(state, act)
    _read_launch(state, PH_SORT, 0, act=act)
    topsort_lockstep.launches += 1
    return state


def read_lockstep(state, codes, best_i, read_len, read, weights, act, K: int):
    """The traceback, add and topsort of one read, in place: what
    :func:`tb_lockstep`, :func:`add_lockstep` and :func:`topsort_lockstep`
    do one after the other (``lockstep_plain.read_lockstep_plain``), with
    their errors 3, 1, 6 and 100. Returns klen (B,) int32, the traceback's
    lengths. On CUDA one launch of ``lk_read_kernel``, the moves handed
    from the traceback to the add in shared memory."""
    B, dev = _check_tb(state, codes, best_i, read_len, act, K)
    _check_read(state, read, weights, act)
    if dev.type == "cpu":
        return plain.read_lockstep_plain(state, codes, best_i, read_len, read, weights, act, K)
    klen = torch.empty(B, dtype=torch.int32, device=dev)
    _read_launch(state, PH_ALL, K, codes, best_i, read_len, act, klen=klen, read=read,
                 weights=weights)
    read_lockstep.launches += 1
    return klen


def read_windows_in_flight(phases: int, N: int, E: int, K: int) -> int:
    """Windows of ``lk_read_kernel<phases>`` the card holds at once for a
    graph cap of N nodes, E edges a list and K moves (needs the card)."""
    return load_library().lk_read_windows_in_flight(phases, N, E, K)


def consensus_windows_in_flight(N: int) -> int:
    """Windows of ``lk_consensus_kernel`` the card holds at once for a node
    cap of N (needs the card)."""
    return load_library().lk_consensus_windows_in_flight(N)


def consensus_lockstep(state, act):
    """(cons (B, N) uint8 backward, cov (B, N) int32, length (B,), err (B,))
    (``lockstep_plain.consensus_lockstep_plain``). On CUDA a warp per
    window, its scores in shared memory: N up to MAX_CONSENSUS_NODES."""
    B, N, E, A, dev = _check_state(state, act)
    if dev.type == "cpu":
        return plain.consensus_lockstep_plain(state, act)
    if N > MAX_CONSENSUS_NODES:
        raise ValueError(f"lk_consensus_kernel takes at most {MAX_CONSENSUS_NODES} nodes, "
                         f"got N={N}")
    cons = torch.zeros((B, N), dtype=torch.uint8, device=dev)
    cov = torch.zeros((B, N), dtype=torch.int32, device=dev)
    length = torch.empty(B, dtype=torch.int32, device=dev)
    err = torch.empty(B, dtype=torch.int32, device=dev)
    rc = load_library().lk_consensus_launch(
        _ptrs(state), B, N, E, A, act.data_ptr(), cons.data_ptr(), cov.data_ptr(),
        length.data_ptr(), err.data_ptr(), _stream(dev))
    _raise_on(rc, "lk_consensus_kernel")
    consensus_lockstep.launches += 1
    return cons, cov, length, err


#: the wrappers, in chain order, then the fused traceback, add and topsort
KERNELS = (nw_lockstep, tb_lockstep, add_lockstep, topsort_lockstep, consensus_lockstep,
           read_lockstep)
for _k in KERNELS:
    _k.launches = 0
