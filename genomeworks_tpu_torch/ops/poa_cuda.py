"""CUDA kernels for the full POA chain of each window — the counterpart of
genomeworks_tpu/ops/poa_pallas.py (``poa_consensus_pallas``) in all its
modes: full band, static band and adaptive band, each with consensus or MSA
output, and the full-band graph export behind ``PoaBatch.get_graphs``; every
mode runs a warp per window.

The kernel source is ``csrc/poa_consensus.cu``, a template per kernel
instantiated per mode. Its plain PyTorch versions are
``poa/torch_poa.poa_consensus_plain``, ``poa_msa_plain`` and
``poa_graph_plain`` (full band) and
``poa/banded_plain.poa_banded_plain`` and ``poa_msa_banded_plain`` (static
and adaptive band). The kernel runs at the caller's full caps (node caps,
E edges and A aligned nodes per node) and, in the banded modes, with room
for the widest band a window can reach, so a nonzero status is final:
there is no reduced-cap plan and no host re-run.
"""

from __future__ import annotations

import ctypes

import torch

from genomeworks_tpu_torch.ops import _build
from genomeworks_tpu_torch.poa import banded_plain, torch_poa
from genomeworks_tpu_torch.poa.banded import (
    BANDED_MATRIX_RIGHT_PADDING, CELLS_PER_THREAD, MAX_ADAPTIVE_BAND_WIDTH,
)

SOURCE = "poa_consensus.cu"
#: scratch the wrapper may hold at once, at most: half the card's free
#: memory up to this cap; a batch runs in chunks of windows whose slabs fit
#: in it. 16 GiB holds every covid bin in one launch (5448 windows of 1.8
#: MB), so the card's thousands of warps fill from one launch and a launch's
#: ragged end comes once.
SCRATCH_BYTES = 16 << 30
#: the full-band priority codes reach 3E + 1 and are stored in 16 bits past
#: E = 84 (8 bits up to it), so E can reach (65535 - 1) / 3
MAX_EDGES = 21844
#: the kernel's band kinds and outputs (csrc/poa_consensus.cu)
BANDS = {"full": 0, "static": 1, "adaptive": 2}
OUTPUTS = {"consensus": 0, "msa": 1, "graph": 2}
#: launches per instantiation ("static_msa", ...); the wrappers' own
#: ``launches`` count them all
launches_by_mode: dict[str, int] = {}
#: windows per launch of the last call (the chunk size)
last_chunk = 0

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built kernel library."""
    lib.poa_slab_bytes.argtypes = [ctypes.c_int] * 4
    lib.poa_slab_bytes.restype = ctypes.c_longlong
    lib.poa_consensus_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    )
    lib.poa_consensus_launch.restype = ctypes.c_int
    lib.poa_mode_slab_bytes.argtypes = [ctypes.c_int] * 8
    lib.poa_mode_slab_bytes.restype = ctypes.c_longlong
    lib.poa_mode_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 12 + [ctypes.c_longlong]
        + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    )
    lib.poa_mode_launch.restype = ctypes.c_int
    lib.poa_windows_in_flight.argtypes = [ctypes.c_int] * 2
    lib.poa_windows_in_flight.restype = ctypes.c_int
    lib.poa_window_ring_rows.argtypes = [ctypes.c_int]
    lib.poa_window_ring_rows.restype = ctypes.c_int
    lib.poa_window_paths.argtypes = [ctypes.c_int] * 3
    lib.poa_window_paths.restype = ctypes.c_int
    lib.poa_banded_windows_in_flight.argtypes = [ctypes.c_int] * 3
    lib.poa_banded_windows_in_flight.restype = ctypes.c_int
    lib.poa_banded_paths.argtypes = [ctypes.c_int] * 2
    lib.poa_banded_paths.restype = ctypes.c_int
    return lib


def load_library():
    """Build (at first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        _lib = bind(_build.load(SOURCE))
    return _lib


def band_alloc(band_width: int, adaptive: bool) -> int:
    """Width of a banded score row in the kernel's slab: the widest band the
    mode can reach (a static band is fixed; adaptive rules 1-3 and 5-6 stop
    at 1536), plus the right padding (``band_alloc`` in the source)."""
    if band_width <= 0:
        return 0
    return (MAX_ADAPTIVE_BAND_WIDTH if adaptive else band_width) + BANDED_MATRIX_RIGHT_PADDING


def _check(seqs, wts, lens, nseqs, N, E, A, band_width=0, adaptive=False, caps=None,
           gap=-8, mismatch=-6, match=8):
    if seqs.dim() != 3:
        raise ValueError(f"seqs must be (B, S, L), got {tuple(seqs.shape)}")
    B, S, L = seqs.shape
    checks = [
        ("seqs", seqs, torch.uint8, (B, S, L)),
        ("wts", wts, torch.int32, (B, S, L)),
        ("lens", lens, torch.int32, (B, S)),
        ("nseqs", nseqs, torch.int32, (B,)),
    ]
    if caps is not None:
        checks.append(("caps", caps, torch.int32, (B,)))
    for name, t, dtype, shape in checks:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != seqs.device:
            raise ValueError(f"{name} is on {t.device}, seqs on {seqs.device}")
    if not 1 <= E <= MAX_EDGES:
        raise ValueError(f"max_edges must be in [1, {MAX_EDGES}], got {E}")
    if A < 1 or N < 1 or B < 1 or S < 1 or L < 1:
        raise ValueError(f"empty shape or cap: B={B} S={S} L={L} N={N} A={A}")
    if caps is not None and band_width <= 0:
        raise ValueError("per-window node caps are taken in the banded modes only")
    if band_width > 0:
        if band_width % CELLS_PER_THREAD:
            raise ValueError(f"band_width must be a multiple of {CELLS_PER_THREAD}, "
                             f"got {band_width}")
        if gap >= 0:
            raise ValueError(f"the banded modes take a negative gap score, got {gap}")
        # scores are int32; values that start at MIN_SCORE = -2^30 fall by
        # at most this much over the rows and the band
        reach = (abs(gap) + abs(mismatch) + abs(match)) * (N + band_alloc(band_width, adaptive) + 8)
        if reach >= 1 << 30:
            raise ValueError(f"scores ({gap}, {mismatch}, {match}) at N={N} and band "
                             f"{band_width} could leave int32")
    # the first read starts the graph: an empty one leaves the NW nothing to
    # align to and the traceback no sink row to start from
    bad = [(nseqs < 1).any(), (nseqs > S).any(), (lens < 0).any(), (lens > min(L, N)).any(),
           (lens[:, 0] < 1).any()]
    if caps is not None:
        bad += [(caps < 1).any(), (caps > N).any()]
    if bool(torch.stack(bad).cpu().any()):
        raise ValueError(
            "every window needs 1 <= nseqs <= S reads of length <= min(L, max_nodes), "
            "the first of them non-empty" + (", and 1 <= cap <= N" if caps is not None else "")
        )
    return B, S, L


def _device_of(seqs):
    if seqs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {seqs.device}")
    return seqs.device.type


def _band(band_width, adaptive):
    return "full" if band_width <= 0 else ("adaptive" if adaptive else "static")


def poa_consensus_cuda(seqs, wts, lens, nseqs, N: int, E: int, A: int,
                       gap: int = -8, mismatch: int = -6, match: int = 8,
                       band_width: int = 0, adaptive: bool = False, caps=None):
    """POA consensus of B windows, full band (``band_width`` 0) or static /
    adaptive band of ``band_width`` (a multiple of 4).

    seqs uint8 (B, S, L) ASCII bases (0 = pad), wts int32 (B, S, L), lens
    int32 (B, S), nseqs int32 (B,), and in the banded modes ``caps`` int32
    (B,), each window's node cap (default N) -> (cons uint8 (B, N) in
    BACKWARD order, cov int32 (B, N), length int32 (B,), err int32 (B,));
    err is 0 ok, 1 node overflow, 2 edge/aligned-node overflow, 3 traceback
    or branch completion failure, 100 not a DAG. Full band keeps the XLA
    chain's status precedence, the banded modes cpu_reference's (the first
    error wins).

    CUDA tensors go to the kernel, launched on the current stream; tensors on
    the CPU go to the plain chain. Inputs the kernel does not take raise,
    among them a window whose first read is empty. The checks read the
    counts and lengths back to the host once per call."""
    _check(seqs, wts, lens, nseqs, N, E, A, band_width, adaptive, caps, gap, mismatch, match)
    if _device_of(seqs) == "cpu":
        if band_width <= 0:
            return torch_poa.poa_consensus_plain(seqs, wts, lens, nseqs, N, E, A, gap,
                                                 mismatch, match)
        return banded_plain.poa_banded_plain(seqs, wts, lens, nseqs, _caps(caps, nseqs, N), E,
                                             A, gap, mismatch, match, band_width, adaptive)
    return _launch(load_library(), seqs, wts, lens, nseqs, N, E, A, gap, mismatch, match,
                   band_width=band_width, adaptive=adaptive, caps=caps)


poa_consensus_cuda.launches = 0


def poa_msa_cuda(seqs, wts, lens, nseqs, N: int, E: int, A: int,
                 gap: int = -8, mismatch: int = -6, match: int = 8,
                 band_width: int = 0, adaptive: bool = False, caps=None):
    """POA MSA of B windows, inputs as :func:`poa_consensus_cuda` -> (msa
    uint8 (B, S, N): row s of window b holds sequence s's gapped row in its
    first msa_len[b] columns, '-' everywhere else; msa_len int32 (B,), 0 for
    a window that failed; err int32 (B,), the status of the graph build).
    The kernel runs no consensus in this mode."""
    _check(seqs, wts, lens, nseqs, N, E, A, band_width, adaptive, caps, gap, mismatch, match)
    if _device_of(seqs) == "cpu":
        if band_width <= 0:
            return torch_poa.poa_msa_plain(seqs, wts, lens, nseqs, N, E, A, gap, mismatch,
                                           match)
        return banded_plain.poa_msa_banded_plain(seqs, wts, lens, nseqs,
                                                 _caps(caps, nseqs, N), E, A, gap, mismatch,
                                                 match, band_width, adaptive)
    return _launch(load_library(), seqs, wts, lens, nseqs, N, E, A, gap, mismatch, match,
                   band_width=band_width, adaptive=adaptive, caps=caps, output="msa")


poa_msa_cuda.launches = 0


def poa_graph_cuda(seqs, wts, lens, nseqs, N: int, E: int, A: int,
                   gap: int = -8, mismatch: int = -6, match: int = 8):
    """The full-band graph each window ends with (what ``get_graphs``
    exports), inputs as :func:`poa_consensus_cuda` -> (nodes (B, N),
    in_count (B, N), in_edges (B, N, E), in_w (B, N, E), node_count (B,),
    err (B,)), int32, as ``torch_poa.export_graph`` gives them."""
    _check(seqs, wts, lens, nseqs, N, E, A)
    if _device_of(seqs) == "cpu":
        return torch_poa.poa_graph_plain(seqs, wts, lens, nseqs, N, E, A, gap, mismatch, match)
    return _launch(load_library(), seqs, wts, lens, nseqs, N, E, A, gap, mismatch, match,
                   output="graph")


poa_graph_cuda.launches = 0

_WRAPPER = {"consensus": poa_consensus_cuda, "msa": poa_msa_cuda, "graph": poa_graph_cuda}


def _caps(caps, nseqs, N):
    return torch.full_like(nseqs, N) if caps is None else caps


def instance_name(band: str, output: str) -> str:
    """The name chip_smoke.py and PERF.md give an instantiation."""
    return band if output == "consensus" else f"{band}_{output}"


def code_bytes(E: int) -> int:
    """Bytes of a full-band priority code (``code_bytes`` in the source)."""
    return 1 if 3 * E + 1 <= 255 else 2


def chunk_windows(B: int, slab: int, dev) -> int:
    """Windows a launch takes: as many of B as the scratch holds slabs of
    ``slab`` bytes (half the card's free memory, at most SCRATCH_BYTES), at
    least one."""
    free = torch.cuda.mem_get_info(dev)[0]
    return max(1, min(B, min(SCRATCH_BYTES, free // 2) // slab))


def _launch(lib, seqs, wts, lens, nseqs, N, E, A, gap, mismatch, match, band_width=0,
            adaptive=False, caps=None, output="consensus"):
    """Allocate outputs and scratch and launch ``lib``'s kernel for the
    mode on the current stream, in chunks of windows whose slabs fit the
    scratch (:func:`chunk_windows`)."""
    global last_chunk
    B, S, L = seqs.shape
    dev = seqs.device
    band = _band(band_width, adaptive)
    u8, i32 = torch.uint8, torch.int32
    if output == "consensus":
        outs = [torch.empty((B, N), dtype=u8, device=dev),
                torch.empty((B, N), dtype=i32, device=dev),
                torch.empty(B, dtype=i32, device=dev), torch.empty(B, dtype=i32, device=dev)]
    elif output == "msa":
        outs = [torch.empty((B, S, N), dtype=u8, device=dev),
                torch.empty(B, dtype=i32, device=dev), torch.empty(B, dtype=i32, device=dev)]
    else:
        outs = [torch.empty((B, N), dtype=i32, device=dev),
                torch.empty((B, N), dtype=i32, device=dev),
                torch.empty((B, N, E), dtype=i32, device=dev),
                torch.empty((B, N, E), dtype=i32, device=dev),
                torch.empty(B, dtype=i32, device=dev), torch.empty(B, dtype=i32, device=dev)]
    if band != "full":
        caps = _caps(caps, nseqs, N)
    slice1 = band == "full" and output == "consensus"  # slice 1's entry points
    if slice1:
        slab = lib.poa_slab_bytes(N, L, E, A)
    else:
        slab = lib.poa_mode_slab_bytes(BANDS[band], OUTPUTS[output], N, L, E, A, S,
                                       band_alloc(band_width, adaptive))
    chunk = chunk_windows(B, slab, dev)
    last_chunk = chunk
    scratch = torch.empty(chunk * slab, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in outs] + [0] * (6 - len(outs))
    name = instance_name(band, output)
    for w0 in range(0, B, chunk):
        if slice1:
            rc = lib.poa_consensus_launch(
                seqs.data_ptr(), wts.data_ptr(), lens.data_ptr(), nseqs.data_ptr(),
                *ptrs[:4], scratch.data_ptr(), slab, w0, min(chunk, B - w0), S, L, N, E, A,
                gap, mismatch, match, stream,
            )
        else:
            rc = lib.poa_mode_launch(
                BANDS[band], OUTPUTS[output], seqs.data_ptr(), wts.data_ptr(),
                lens.data_ptr(), nseqs.data_ptr(), 0 if caps is None else caps.data_ptr(),
                *ptrs, scratch.data_ptr(), slab, w0, min(chunk, B - w0), S, L, N, E, A,
                gap, mismatch, match, band_width, stream,
            )
        if rc != 0:
            raise RuntimeError(f"POA kernel <{name}> launch failed: CUDA error {rc}")
        _WRAPPER[output].launches += 1
        launches_by_mode[name] = launches_by_mode.get(name, 0) + 1
    return tuple(outs)
