"""The lockstep POA tier: many windows advance through the POA chain one
read at a time, each phase one kernel launch over the whole bucket — the
port of genomeworks_tpu/poa/lockstep.py.

Per length bucket of windows, :func:`poa_batch_consensus_lockstep`

  backbone (torch ops) -> [ nw -> (tb -> add -> topsort) ] per read -> consensus

on a CUDA device two kernel launches a read (``ops/poa_lockstep_cuda.py``:
``nw_lockstep``, then ``read_lockstep``, the traceback, add and topsort in
one), on the CPU their plain versions (``poa/lockstep_plain.py``). The
graph state is ``torch_poa``'s (B, N) dict at the lockstep caps (E = 7,
A = 8, N from :func:`lockstep_plan`). Windows that hit a cap or the ring
distance D end with a nonzero status and are re-run by the caller
(``torch_poa.poa_batch_consensus``) at the caller's full caps.

The plan (N, D, Lp), the length buckets and the tiny-tail rule are the JAX
package's, kept as pure functions so that this tier serves exactly the
windows the JAX tier serves, and so counts the same in :data:`tier_stats`.
Its TPU devices (one window per vector lane in a plane layout, packed
per-node fields, the packed uploads and downloads, grid padding, compile
caches and asynchronous bucket dispatch) are not carried over.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from genomeworks_tpu_torch.core.device import resolve_device
from genomeworks_tpu_torch.ops import poa_lockstep_cuda as lk
from genomeworks_tpu_torch.poa import torch_poa
from genomeworks_tpu_torch.poa.lockstep_plain import A_LK, E_LK

#: how many windows the tier served (status 0), flagged for the re-run
#: (an in-kernel status other than 0), or did not serve (status 99: no
#: plan, more than 255 reads, or the tiny long tail of the buckets)
tier_stats = {
    "lockstep_windows": 0,
    "lockstep_overflow_windows": 0,
    "lockstep_unserved_windows": 0,
}

#: status of a window the tier did not serve
UNSERVED = 99
#: most reads a served window may have (the JAX tier's byte-wide coverage)
MAX_READS = 255


def reset_tier_stats():
    for k in tier_stats:
        tier_stats[k] = 0


# N, D and Lp below are the JAX package's plan for the TPU's 16 MB of VMEM
# per core, kept so that routing matches; caps chosen for the GPU are later
# work. EO = 8 enters only the budget, as there (the out-edge lists hold E).
_EO_BUDGET = 8
_W = 128  # windows per TPU group in the budget formula
_VMEM_BUDGET = 15_000_000


def _chain_vmem(N: int, D: int, Lp: int, K: int, weighted: bool = False) -> int:
    """The JAX package's VMEM bytes of its largest lockstep kernel."""
    E, EO, A = E_LK, _EO_BUDGET, A_LK
    nw = N * (3 + E) + 2 * (Lp + 3) + D * Lp // 2 + D + 5 * Lp + 16
    tb = N * (3 + E) + 2 * (2 * K + 4) + 4 * Lp + 16
    add = N * (1 + 2 * E + EO + A) + 2 * K + Lp + (Lp if weighted else 1) + 2 * 16
    ts = N * (4 + EO) + 2 * 8
    cons = N * (7 + 2 * E + EO + A) + 2 * 8
    return 4 * _W * max(nw, tb, add, ts, cons)


def lockstep_plan(L: int, max_nodes: int | None = None):
    """(N, D, Lp) for windows of at most L bases, or None: N the node cap
    (the smallest candidate >= 2 L, else the largest that fits, never over
    ``max_nodes``), D the predecessor-distance ring, Lp the row width."""
    Lp = 8 * ((L + 1 + 7) // 8)
    cands = (128, 160, 192, 224, 256, 320, 384, 448, 512, 576, 640)

    def fits(N):
        if N < L + 2 or (max_nodes is not None and N > max_nodes):
            return None
        K = walk_len(N, L)
        for D in (128, 64, 32):
            if _chain_vmem(N, D, Lp, K) <= _VMEM_BUDGET:
                return N, D, Lp
        return None

    for N in cands:
        if N >= 2 * L:
            r = fits(N)
            if r is not None:
                return r
    for N in reversed(cands):
        r = fits(N)
        if r is not None:
            return r
    return None


def walk_len(N: int, L: int) -> int:
    """K, the traceback's room: N + L + 2 rounded up to 8."""
    return ((N + L + 2 + 7) // 8) * 8


def chain_len(lens) -> int:
    """The bucket's chain length: its longest window, rounded up to 32."""
    return max(32, ((max(lens) + 31) // 32) * 32)


def bucket_plan(windows, max_nodes: int | None = None):
    """(N, D, Lp, K) for a bucket of windows, or None where the tier does
    not serve it (no plan, or more than ``MAX_READS`` reads once the read
    count is made even, as the JAX tier sizes it)."""
    L = chain_len([max(len(s) for s in w) for w in windows])
    plan = lockstep_plan(L, max_nodes)
    S = max(2, max(len(w) for w in windows))
    if plan is None or S + (S & 1) > MAX_READS:
        return None
    N, D, Lp = plan
    return N, D, Lp, walk_len(N, L)


def _bucket_windows(lens_w, min_bucket=2 * _W):
    """Window indices in length buckets (edges at multiples of 64) as
    (edge, indices); buckets under ``min_bucket`` windows merge into the
    next larger one, and a last bucket under 16 windows, when there is
    another, becomes (None, indices): the tier does not serve it."""
    by_edge = collections.defaultdict(list)
    for i, lw in enumerate(lens_w):
        by_edge[max(64, ((lw + 63) // 64) * 64)].append(i)
    edges = sorted(by_edge)
    out = []
    carry: list[int] = []
    for j, e in enumerate(edges):
        idxs = carry + by_edge[e]
        carry = []
        if len(idxs) < min_bucket and j + 1 < len(edges):
            carry = idxs
        else:
            out.append((e, idxs))
    if carry:
        out.append((edges[-1], carry))
    if len(out) >= 2 and len(out[-1][1]) < 16:
        e, idxs = out.pop()
        out.append((None, idxs))
    return out


def start_bucket(seqs, wts, lens, nseqs, N: int):
    """A bucket's reads one after the other: (seqs_t uint8 (S, B, Lr),
    wts_t int32 (S, B, Lr) or None, lens_t int32 (S, B)), each read s a
    contiguous (B, ...) slice; and the graph state at the lockstep caps with
    every window's backbone built from its first read."""
    B, S, Lr = seqs.shape
    seqs_t = seqs.transpose(0, 1).contiguous()
    lens_t = lens.t().contiguous()
    wts_t = None if wts is None else wts.transpose(0, 1).contiguous()
    state = torch_poa.init_graph_state(B, N, E_LK, A_LK, device=seqs.device)
    wb = torch.ones_like(lens_t[0])[:, None].expand(B, Lr) if wts is None else wts_t[0]
    torch_poa.build_backbone_batched(state, seqs_t[0].to(torch.int32), lens_t[0], wb, nseqs > 0)
    return (seqs_t, wts_t, lens_t), state


def run_bucket(seqs, wts, lens, nseqs, N: int, D: int, Lp: int, K: int, gap: int,
               mismatch: int, match: int):
    """The lockstep chain of one bucket on the device of its tensors: seqs
    uint8 (B, S, Lr), wts int32 (B, S, Lr) or None for unit weights, lens
    int32 (B, S), nseqs int32 (B,). Returns (cons uint8 (B, N) backward,
    cov int32 (B, N), length (B,), status (B,)), statuses being the tier's
    own codes (``lockstep_plain``). No host sync until the caller reads."""
    B, S, _ = seqs.shape
    dev = seqs.device
    (seqs_t, wts_t, lens_t), state = start_bucket(seqs, wts, lens, nseqs, N)
    codes = torch.empty((B, N, Lp), dtype=torch.uint8, device=dev)
    for s in range(1, S):
        act = nseqs > s
        best_i = lk.nw_lockstep(state, seqs_t[s], lens_t[s], act, codes, D, gap, mismatch,
                                match)
        lk.read_lockstep(state, codes, best_i, lens_t[s], seqs_t[s],
                         None if wts_t is None else wts_t[s], act, K)
    return lk.consensus_lockstep(state, nseqs > 0)


def poa_batch_consensus_lockstep(windows, gap=-8, mismatch=-6, match=8, weights=None,
                                 max_nodes=None, device=None):
    """Consensus of ``windows`` (lists of sequences) through the lockstep
    tier. Returns (cons, cov, status) lists; a nonzero status is the tier's
    own code (1, 3, 5, 6, 100; 99 for a window the tier did not serve), for
    the caller to re-run. ``weights`` as for ``torch_poa.poa_batch_consensus``
    (None: unit weights). ``device=None`` means CUDA; on ``device="cpu"``
    the plain phases run. Raises for a window whose first read is empty,
    as the per-window tier does."""
    dev = resolve_device(device)
    if any(not w[0] for w in windows):
        raise ValueError("every window needs a non-empty first read")
    B0 = len(windows)
    lens_w = [max(len(s) for s in w) for w in windows]
    o_cons = [""] * B0
    o_cov = [np.zeros(0, np.int32)] * B0
    o_st = [UNSERVED] * B0
    for edge, idxs in _bucket_windows(lens_w):
        sub = [windows[i] for i in idxs]
        plan = None if edge is None else bucket_plan(sub, max_nodes)
        if plan is None:
            continue
        N, D, Lp, K = plan
        packed = torch_poa.pack_windows(sub, [weights[i] for i in idxs] if weights else None, N)
        seqs, wts, lens, nseqs = (torch.from_numpy(a).to(dev) for a in packed[:4])
        cons, cov, length, err = run_bucket(seqs, wts if weights else None, lens, nseqs, N, D,
                                            Lp, K, gap, mismatch, match)
        cons, cov = cons.cpu().numpy(), cov.cpu().numpy()
        length, err = length.cpu().numpy(), err.cpu().numpy()
        for j, i in enumerate(idxs):
            if err[j] != 0:
                o_st[i] = int(err[j])
            else:
                k = int(length[j])
                o_cons[i] = cons[j, :k][::-1].tobytes().decode("latin1")
                o_cov[i] = cov[j, :k][::-1].copy()
                o_st[i] = 0
    return o_cons, o_cov, o_st
