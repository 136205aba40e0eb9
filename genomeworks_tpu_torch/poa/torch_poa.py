"""Batched full-band POA in plain PyTorch — the port of
genomeworks_tpu/poa/jax_poa.py for consensus.

This is the plain version that the CUDA kernel (``ops/poa_cuda.py``) is
held against, and the chain that runs when the tensors lie on the CPU. As
jax_poa does, it advances a batch of windows in lockstep through

  backbone -> [ NW align -> traceback -> add alignment -> topological sort ]*
  -> consensus

with each phase written as tensor ops vectorized over the batch:

- :func:`nw_batched` is the full-matrix sequence-vs-graph NW
  (cudapoa_nw.cuh): one (B, N+1, L+1) int32 score matrix, each row the max
  over its predecessor rows of the diagonal/vertical candidates, closed
  horizontally by a prefix max of ``row - j*gap``; per cell it records the
  reference's traceback PRIORITY CODE (diagonal by edge order < vertical by
  edge order < horizontal), and the traceback is a pointer walk over them;
- :func:`add_alignment_batched_seq` is the sequential alignment-to-graph
  walk (cudapoa_add_alignment.cuh);
- :func:`topsort_batched` is Kahn's sort (cudapoa_topsort.cuh:46);
- :func:`consensus_batched` is the heaviest-edge pass, branch completion and
  backward emission (cudapoa_generate_consensus.cuh).

Scores are int32 throughout. Sequences are ASCII bytes with 0 as the
never-matching pad. The graph state is the dict of :func:`init_graph_state`,
the same arrays under the same names as jax_poa's; the phase functions
update it IN PLACE and return it (:func:`state_from_numpy` copies a state in).

Error codes (``state["error"]``, and the ``err`` output) are jax_poa's:
0 ok; 1 node count already >= N before an NW step, or node overflow while
adding; 2 edge or aligned-node list overflow (2 overrides a 1 raised in the
same add step); 3 traceback or branch-completion failure; 100 the graph is
not a DAG (never expected).
"""

from __future__ import annotations

import numpy as np
import torch

from genomeworks_tpu_torch.core.device import resolve_device
from genomeworks_tpu_torch.poa.cpu_reference import MAX_NODE_ALIGNMENTS, MAX_NODE_EDGES

NEG = -(1 << 30)

STATE_KEYS = (
    "nodes", "in_edges", "in_count", "in_w", "out_edges", "out_count",
    "al", "al_count", "cov", "sorted", "pos_of", "node_count", "error",
)


def init_graph_state(B: int, N: int, E: int = MAX_NODE_EDGES,
                     A: int = MAX_NODE_ALIGNMENTS, device="cpu", max_seqs: int | None = None):
    """Zeroed graph state for B windows of at most N nodes (jax_poa:47).
    With ``max_seqs`` it also keeps the MSA bookkeeping of jax_poa's
    ``msa=True`` state: ``seq_next`` (B, N, max_seqs), the node after each
    node on each sequence's path (-1 where none), and ``begin`` (B,
    max_seqs), each sequence's first node. A sequence passes a node at most
    once, so this is the reference's per-edge coverage lists
    (cudapoa_add_alignment.cuh:239-272) in another encoding."""

    def z(*s):
        return torch.zeros(s, dtype=torch.int32, device=device)

    state = {
        "nodes": z(B, N),
        "in_edges": z(B, N, E),
        "in_count": z(B, N),
        "in_w": z(B, N, E),
        "out_edges": z(B, N, E),
        "out_count": z(B, N),
        "al": z(B, N, A),
        "al_count": z(B, N),
        "cov": z(B, N),
        "sorted": z(B, N),
        "pos_of": z(B, N),
        "node_count": z(B),
        "error": z(B),
    }
    if max_seqs is not None:
        state["seq_next"] = torch.full((B, N, max_seqs), -1, dtype=torch.int32, device=device)
        state["begin"] = z(B, max_seqs)
    return state


def state_from_numpy(state_np, device="cpu"):
    """A graph state given as numpy arrays (e.g. a jax_poa state passed
    through ``np.asarray``) -> the port's int32 tensors on ``device``."""
    return {
        k: torch.from_numpy(np.array(state_np[k], dtype=np.int32)).to(device)
        for k in STATE_KEYS
    }


def state_to_numpy(state):
    """The port's graph state -> int32 numpy arrays."""
    return {k: state[k].cpu().numpy() for k in STATE_KEYS}


def _set(arr, idx, val, mask):
    """arr[idx][mask] = val[mask] for a tuple of index tensors (masked
    scatter; entries outside the mask are dropped)."""
    arr[tuple(i[mask] for i in idx)] = val[mask]


def _add(arr, idx, val, mask):
    """arr[idx][mask] += val[mask] (indices under the mask are distinct)."""
    arr.index_put_(tuple(i[mask] for i in idx), val[mask], accumulate=True)


# ---------------------------------------------------------------------------
# backbone (cudapoa_kernels.cuh:200-238)
# ---------------------------------------------------------------------------


def build_backbone_batched(state, seq, seq_len, weights, active):
    """seq (B, L) int32 bases, seq_len (B,), weights (B, L), active (B,)
    bool. The backbone edge i-1 -> i weighs w[i-1] + w[i]; node 0's
    (virtual) in-weight is w[0] (jax_poa:87)."""
    B, N = state["nodes"].shape
    L = seq.shape[1]
    dev = seq.device
    n_idx = torch.arange(N, device=dev, dtype=torch.int32)[None, :]
    upd = active[:, None] & (n_idx < seq_len[:, None])

    m = min(L, N)  # seq_len <= N, so columns past N are padding
    padseq = torch.zeros((B, N), dtype=torch.int32, device=dev)
    padseq[:, :m] = seq[:, :m]
    padw = torch.zeros((B, N), dtype=torch.int32, device=dev)
    padw[:, :m] = weights[:, :m]

    st = state
    st["nodes"] = torch.where(upd, padseq, st["nodes"])
    st["sorted"] = torch.where(upd, n_idx, st["sorted"])
    st["pos_of"] = torch.where(upd, n_idx, st["pos_of"])
    zero, one = torch.zeros_like(n_idx), torch.ones_like(n_idx)
    st["in_count"] = torch.where(upd, torch.where(n_idx == 0, zero, one), st["in_count"])
    st["out_count"] = torch.where(
        upd, torch.where(n_idx == seq_len[:, None] - 1, zero, one), st["out_count"]
    )
    st["al_count"] = torch.where(upd, zero, st["al_count"])
    st["cov"] = torch.where(upd, one, st["cov"])
    st["in_edges"][:, :, 0] = torch.where(upd, n_idx - 1, st["in_edges"][:, :, 0])
    st["out_edges"][:, :, 0] = torch.where(upd, n_idx + 1, st["out_edges"][:, :, 0])
    prev_w = torch.cat([torch.zeros_like(padw[:, :1]), padw[:, :-1]], dim=1)
    w0 = torch.where(n_idx == 0, padw, prev_w + padw)
    st["in_w"][:, :, 0] = torch.where(upd, w0, st["in_w"][:, :, 0])
    st["node_count"] = torch.where(active, seq_len, st["node_count"])
    if "seq_next" in st:
        # the backbone is sequence 0's path, from node 0 (kernels.cuh:212-234)
        nxt = upd & (n_idx < seq_len[:, None] - 1)
        st["seq_next"][:, :, 0] = torch.where(nxt, n_idx + 1, st["seq_next"][:, :, 0])
        st["begin"][:, 0] = torch.where(active, 0, st["begin"][:, 0])
    return st


# ---------------------------------------------------------------------------
# topological sort (cudapoa_topsort.cuh:46 topologicalSortDeviceUtil)
# ---------------------------------------------------------------------------


def topsort_batched(state, active):
    """Kahn's sort: seeds in ascending node id, then FIFO expansion in
    out-edge order. Writes ``sorted``/``pos_of`` of active windows (-1
    past the node count, as jax_poa:142 does)."""
    st = state
    B, N = st["in_count"].shape
    dev = st["in_count"].device
    bi = torch.arange(B, device=dev)
    nc = st["node_count"]
    n_idx = torch.arange(N, device=dev, dtype=torch.int32)[None, :]
    local = torch.where(n_idx < nc[:, None], st["in_count"], 1 << 20)
    is_seed = local == 0
    seed_rank = torch.cumsum(is_seed.to(torch.int32), dim=1, dtype=torch.int32) - 1
    tail = is_seed.sum(dim=1, dtype=torch.int32)
    bb = bi[:, None].expand(B, N)
    sorted_poa = torch.full((B, N), -1, dtype=torch.int32, device=dev)
    _set(sorted_poa, (bb, seed_rank.long()), n_idx.expand(B, N), is_seed)
    pos_of = torch.where(is_seed, seed_rank, -1)

    R = int(torch.where(active, nc, 0).max()) if B else 0
    live = active[:, None] & (n_idx < nc[:, None])
    eo = min(st["out_edges"].shape[2],
             max(1, int(torch.where(live, st["out_count"], 0).max()))) if R else 1
    out_edges = st["out_edges"][:, :, :eo]
    e_idx = torch.arange(eo, device=dev, dtype=torch.int32)[None, :]
    bbe = bi[:, None].expand(B, eo)
    for i in range(R):
        node = sorted_poa[:, i]
        valid = active & (i < tail) & (node >= 0)
        node_c = node.clamp(0, N - 1).long()
        outs_c = out_edges[bi, node_c].clamp(0, N - 1).long()
        oc = st["out_count"][bi, node_c]
        emask = valid[:, None] & (e_idx < oc[:, None])
        _add(local, (bbe, outs_c), torch.full_like(outs_c, -1, dtype=torch.int32), emask)
        newly = emask & (local[bbe, outs_c] == 0)
        rank = tail[:, None] + torch.cumsum(newly.to(torch.int32), dim=1, dtype=torch.int32) - 1
        _set(sorted_poa, (bbe, rank.long()), outs_c.to(torch.int32), newly)
        _set(pos_of, (bbe, outs_c), rank, newly)
        tail = tail + newly.sum(dim=1, dtype=torch.int32)
    st["sorted"] = torch.where(active[:, None], sorted_poa, st["sorted"])
    st["pos_of"] = torch.where(active[:, None], pos_of, st["pos_of"])
    st["error"] = torch.where(active & (tail != nc), 100, st["error"])
    return st


# ---------------------------------------------------------------------------
# sequence-vs-graph NW, full band (cudapoa_nw.cuh), and its traceback
# ---------------------------------------------------------------------------


def nw_batched(state, read, read_len, active, gap: int, mismatch: int,
               match: int, work: dict | None = None):
    """Full-matrix NW of ``read`` (B, L) int32 vs each window's graph
    (jax_poa:447). Returns (ag (B, K), ar (B, K), aln_len (B,), failed (B,))
    with K = N + L: the alignment in BACKWARD order (index 0 = last move),
    graph node / read position per move, -1 for a gap.

    ``work``, when given, accumulates the cells this call's data needs:
    ``cells`` (graph rows x read columns) and ``pred_cells`` (the same,
    counted once per predecessor row read)."""
    codes, best_i = nw_forward(state, read, read_len, active, gap, mismatch, match, work)
    B, R, C = codes.shape
    bi = torch.arange(B, device=codes.device)

    def code_at(i, j):
        return codes[bi, i.clamp(0, R - 1).long(), j.clamp(0, C - 1).long()].to(torch.int32)

    return traceback(state, code_at, best_i, read_len, active, (R - 1) + (C - 1))


def nw_forward(state, read, read_len, active, gap: int, mismatch: int,
               match: int, work: dict | None = None):
    """The forward pass of :func:`nw_batched`: returns (codes (B, N+1, L+1)
    int16 (int32 past E = 10922), the priority code of every cell, row 0
    unused; best_i (B,), the first sink row with the highest score at
    column ``read_len``)."""
    st = state
    B, N = st["nodes"].shape
    E = st["in_edges"].shape[2]
    L = read.shape[1]
    dev = read.device
    HORIZ, BIGP = 2 * E, 3 * E + 1
    bi = torch.arange(B, device=dev)
    slope = gap * torch.arange(L + 1, device=dev, dtype=torch.int32)

    nc = torch.where(active, st["node_count"], 0)
    max_nc = int(nc.max()) if B else 0
    n_idx = torch.arange(N, device=dev)[None, :]
    in_graph = n_idx < nc[:, None]
    emax = max(1, int(torch.where(in_graph, st["in_count"], 0).max())) if max_nc else 1
    if work is not None:
        npred = torch.where(in_graph, st["in_count"].clamp(min=1), 0).sum(dim=1)
        cols = (read_len + 1).to(torch.int64)
        work["cells"] = work.get("cells", 0) + int((nc.to(torch.int64) * cols).sum())
        work["pred_cells"] = work.get("pred_cells", 0) + int((npred * cols).sum())

    scores = torch.empty((B, N + 1, L + 1), dtype=torch.int32, device=dev)
    codes = torch.empty((B, N + 1, L + 1), dtype=torch.int16 if BIGP < 1 << 15 else torch.int32,
                        device=dev)
    scores[:, 0, :] = slope
    e_idx = torch.arange(emax, device=dev, dtype=torch.int32)
    bb = bi[:, None]

    for gp in range(max_nc):
        nid = st["sorted"][:, gp].clamp(0, N - 1).long()
        pc = st["in_count"][bi, nid]
        gbase = st["nodes"][bi, nid]
        preds = st["in_edges"][bi, nid, :emax].clamp(0, N - 1).long()
        ppos = torch.where(pc[:, None] == 0, 0, st["pos_of"][bb, preds] + 1)
        use = (e_idx == 0)[None, :] | (e_idx[None, :] < pc[:, None])
        ppos = torch.where(use, ppos.clamp(0, N), 0)
        prow = scores[bb, ppos.long()]  # (B, emax, L+1)
        sub = torch.where(read == gbase[:, None], match, mismatch).to(torch.int32)
        diag = prow[:, :, :-1] + sub[:, None, :]
        vert = prow[:, :, 1:] + gap
        base = torch.maximum(diag, vert).masked_fill(~use[:, :, None], NEG).amax(dim=1)
        c0 = (prow[:, :, 0] + gap).masked_fill(~use, NEG)
        row = torch.cat([c0.amax(dim=1, keepdim=True), base], dim=1)
        row = torch.cummax(row - slope, dim=1).values + slope

        # priority codes against the closed row (cudapoa_nw.cuh:340-430)
        tgt = row[:, None, 1:]
        ecode = e_idx[None, :, None]
        cand = torch.where(diag == tgt, ecode, torch.where(vert == tgt, E + ecode, BIGP))
        best = cand.masked_fill(~use[:, :, None], BIGP).amin(dim=1)
        horiz = row[:, 1:] == row[:, :-1] + gap
        best = torch.minimum(best, torch.where(horiz, HORIZ, BIGP))
        code0 = torch.where(use & (c0 == row[:, :1]), E + e_idx[None, :], BIGP).amin(dim=1)
        scores[:, gp + 1] = row
        codes[:, gp + 1, 0] = code0.to(codes.dtype)
        codes[:, gp + 1, 1:] = best.to(codes.dtype)

    # traceback start: first max at column read_len among sink rows
    col = scores.gather(2, read_len.long()[:, None, None].expand(B, N + 1, 1))[:, 1:, 0]
    sorted_oc = st["out_count"].gather(1, st["sorted"].clamp(0, N - 1).long())
    sink = (sorted_oc == 0) & (n_idx + 1 <= st["node_count"][:, None])
    best_i = torch.where(sink, col, NEG).argmax(dim=1).to(torch.int32) + 1
    return codes, best_i


def traceback(state, code_at, best_i, read_len, active, K: int):
    """Pointer walk over priority codes from (best_i, read_len) to (0, 0),
    for the windows in ``active``; ``code_at(i, j)`` gives the (B,) int32
    codes of graph row i (1-based, topological order) at column j. Returns
    (ag (B, K), ar (B, K), aln_len (B,), failed (B,)) as :func:`nw_batched`
    does; a walk longer than K keeps its first K moves."""
    st = state
    B, N = st["nodes"].shape
    E = st["in_edges"].shape[2]
    HORIZ = 2 * E
    dev = best_i.device
    bi = torch.arange(B, device=dev)
    ag = torch.full((B, K), -1, dtype=torch.int32, device=dev)
    ar = torch.full((B, K), -1, dtype=torch.int32, device=dev)
    i = torch.where(active, best_i, 0)
    j = torch.where(active, read_len, 0)
    k = torch.zeros(B, dtype=torch.int32, device=dev)
    for _ in range(K + 2):
        a_t = active & ((i != 0) | (j != 0))
        if not bool(a_t.any()):
            break
        code = torch.where(i == 0, HORIZ, code_at(i, j))
        is_horiz = code == HORIZ
        is_diag = code < E
        e = torch.where(is_horiz, 0, code % E).long()
        nid = st["sorted"][bi, (i - 1).clamp(0, N - 1).long()].clamp(0, N - 1).long()
        pc = st["in_count"][bi, nid]
        pred = st["in_edges"][bi, nid, e].clamp(0, N - 1).long()
        pi = torch.where(pc == 0, 0, st["pos_of"][bi, pred] + 1)
        prev_i = torch.where(is_horiz, i, pi)
        prev_j = torch.where(is_horiz | is_diag, j - 1, j)
        kk = k.clamp(0, K - 1).long()
        w_ok = a_t & (k < K)
        _set(ag, (bi, kk), torch.where(prev_i == i, -1, nid.to(torch.int32)), w_ok)
        _set(ar, (bi, kk), torch.where(prev_j == j, -1, j - 1), w_ok)
        i = torch.where(a_t, prev_i, i)
        j = torch.where(a_t, prev_j, j)
        k = k + a_t.to(torch.int32)
    failed = active & ((i != 0) | (j != 0))
    return ag, ar, k, failed


# ---------------------------------------------------------------------------
# add alignment to graph (cudapoa_add_alignment.cuh addAlignmentToGraph)
# ---------------------------------------------------------------------------


def _join_clique(st, al_list, na, gid_c, cur, new_aligned, act, err):
    """The new node ``cur`` joins the aligned clique of ``gid`` (windows in
    ``new_aligned``): every member lists cur, cur lists [members..., gid].
    Returns the error with 2 where cur's list overflows."""
    B, N = st["nodes"].shape
    A = st["al"].shape[2]
    dev = cur.device
    bba = torch.arange(B, device=dev)[:, None].expand(B, A)
    bi = bba[:, 0]
    a_idx = torch.arange(A, device=dev, dtype=torch.int32)[None, :]
    cur_l = cur.long()
    amask = new_aligned[:, None] & (a_idx < na[:, None])
    aid_c = al_list.clamp(0, N - 1).long()
    aid_counts = st["al_count"][bba, aid_c]
    app_ok = amask & (aid_counts < A)
    _set(st["al"], (bba, aid_c, aid_counts.long()), cur[:, None].expand(B, A), app_ok)
    _add(st["al_count"], (bba, aid_c), torch.ones_like(aid_counts), amask)
    _set(st["al"], (bba, cur_l[:, None].expand(B, A), a_idx.long().expand(B, A)),
         al_list, amask)
    na_l = na.clamp(0, A - 1).long()
    _set(st["al"], (bi, gid_c, na_l), cur, new_aligned)
    _set(st["al_count"], (bi, gid_c), na + 1, new_aligned)
    _set(st["al"], (bi, cur_l, na_l), gid_c.to(torch.int32), new_aligned)
    _set(st["al_count"], (bi, cur_l), na + 1, new_aligned)
    err = torch.where(act & new_aligned & (na + 1 > A - 1), 2, err)
    return err


def clique_conflict(state, ag, ar, active):
    """(B,) bool: two columns of the walk touch the same aligned clique of
    the pre-walk graph (jax_poa.add_alignment_batched's test; a clique is
    named by its least node id)."""
    N = state["nodes"].shape[1]
    B, K = ag.shape
    A = state["al"].shape[2]
    dev = ag.device
    valid = active[:, None] & (ar != -1) & (ag != -1)
    gid_c = ag.clamp(0, N - 1).long()
    bb = torch.arange(B, device=dev)[:, None]
    al_list = state["al"][bb, gid_c]  # (B, K, A)
    na = state["al_count"][bb, gid_c]
    a_idx = torch.arange(A, device=dev)[None, None, :]
    clique = torch.minimum(
        gid_c.to(torch.int32),
        torch.where(a_idx < na[:, :, None], al_list, N).amin(dim=2),
    )
    clique = torch.where(valid, clique, N + torch.arange(K, device=dev, dtype=torch.int32))
    cs = torch.sort(clique, dim=1).values
    return ((cs[:, 1:] == cs[:, :-1]) & (cs[:, 1:] < N)).any(dim=1)


def add_alignment_batched_seq(state, ag, ar, aln_len, read, weights, active,
                              seq_id: int | None = None, first_error_wins: bool = False,
                              caps=None):
    """Sequential alignment-to-graph walk, one step per alignment column for
    all windows at once (jax_poa:618): reuse the graph node or an aligned
    node of the same base, else create a node (joining the aligned clique
    when the column had a graph node); add or reweigh the edge from the
    previous node; bump coverage. With ``seq_id`` (a state of
    ``init_graph_state(max_seqs=...)``) it records sequence ``seq_id``'s
    path in ``seq_next`` and its first node in ``begin``, as jax_poa does.

    Error precedence is that of jax_poa's chain, which runs the vectorized
    walk (jax_poa:795) and falls back to this sequential one only for walks
    with a :func:`clique_conflict`: a conflicted walk stops after the step
    that sets an error (2 overrides a 1 of the same step); any other walk
    goes on after a node overflow (1), and an edge or aligned-node overflow
    (2) later in it replaces the 1. Every write of an erring step lands, as
    in jax_poa. ``first_error_wins`` gives cpu_reference.add_alignment's
    order instead (the banded chain's): every walk stops after its first
    erring step, and a node overflow (1) there wins over a 2. ``caps``
    ((B,) int32) gives each window its own node cap in place of N."""
    st = state
    B, N = st["nodes"].shape
    E = st["in_edges"].shape[2]
    A = st["al"].shape[2]
    L = read.shape[1]
    K = ag.shape[1]
    dev = read.device
    bi = torch.arange(B, device=dev)
    bba = bi[:, None].expand(B, A)
    bbe = bi[:, None].expand(B, E)
    a_idx = torch.arange(A, device=dev, dtype=torch.int32)[None, :]
    e_idx = torch.arange(E, device=dev, dtype=torch.int32)[None, :]

    max_len = int(torch.where(active, aln_len, 0).max()) if B else 0
    if first_error_wins:
        go_on_after_1 = torch.zeros_like(active)
    else:
        go_on_after_1 = active & ~clique_conflict(st, ag, ar, active)
    head = torch.full((B,), -1, dtype=torch.int32, device=dev)
    prev_w = torch.zeros(B, dtype=torch.int32, device=dev)
    for t in range(max_len):
        pos = (aln_len - 1 - t).clamp(0, K - 1).long()
        err0 = st["error"]
        act_t = active & (t < aln_len) & ((err0 == 0) | ((err0 == 1) & go_on_after_1))
        read_pos = ar[bi, pos]
        gid = ag[bi, pos]
        act = act_t & (read_pos != -1)
        if not bool(act.any()):
            continue
        rp = read_pos.clamp(0, L - 1).long()
        w = weights[bi, rp]
        base = read[bi, rp]

        gid_c = gid.clamp(0, N - 1).long()
        gbase = st["nodes"][bi, gid_c]
        al_list = st["al"][bi, gid_c]  # (B, A), a copy
        na = st["al_count"][bi, gid_c]
        al_bases = st["nodes"][bba, al_list.clamp(0, N - 1).long()]
        match_mask = (a_idx < na[:, None]) & (al_bases == base[:, None])
        has_aligned = match_mask.any(dim=1)
        first_aligned = al_list[bi, match_mask.to(torch.uint8).argmax(dim=1)]

        reuse_graph = (gid != -1) & (gbase == base)
        reuse_aligned = (gid != -1) & (gbase != base) & has_aligned
        new_node = act & ~reuse_graph & ~reuse_aligned
        new_aligned = new_node & (gid != -1)
        cur = torch.where(
            reuse_graph, gid_c.to(torch.int32),
            torch.where(reuse_aligned, first_aligned, st["node_count"]),
        ).clamp(0, N - 1)
        cur_l = cur.long()
        node_count = st["node_count"] + new_node.to(torch.int32)
        node_overflow = act & (node_count >= (N if caps is None else caps)) & new_node
        err = torch.where(node_overflow, 1, st["error"])

        # a new node starts empty
        for key, val in (("nodes", base), ("out_count", 0), ("in_count", 0),
                         ("al_count", 0), ("cov", 0)):
            val = val if torch.is_tensor(val) else torch.full_like(cur, val)
            _set(st[key], (bi, cur_l), val, new_node)

        # join the aligned clique of gid: every member lists cur, cur lists
        # [members..., gid]
        if bool(new_aligned.any()):
            err = _join_clique(st, al_list, na, gid_c, cur, new_aligned, act, err)

        # edge head -> cur: reweigh if present, else append
        has_head = act & (head != -1)
        head_c = head.clamp(0, N - 1).long()
        in_list = st["in_edges"][bi, cur_l]
        ic = st["in_count"][bi, cur_l]
        exist_mask = has_head[:, None] & (e_idx < ic[:, None]) & (in_list == head[:, None])
        exists = exist_mask.any(dim=1)
        dw = (prev_w + w)[:, None].expand(B, E)
        _add(st["in_w"], (bbe, cur_l[:, None].expand(B, E), e_idx.long().expand(B, E)),
             dw, exist_mask)
        app = has_head & ~exists
        ic_l = ic.clamp(0, E - 1).long()
        _set(st["in_edges"], (bi, cur_l, ic_l), head_c.to(torch.int32), app)
        _set(st["in_w"], (bi, cur_l, ic_l), prev_w + w, app)
        _add(st["in_count"], (bi, cur_l), torch.ones_like(ic), app)
        oc = st["out_count"][bi, head_c]
        _set(st["out_edges"], (bi, head_c, oc.clamp(0, E - 1).long()), cur, app)
        _add(st["out_count"], (bi, head_c), torch.ones_like(oc), app)
        err = torch.where(app & ((oc + 1 >= E) | (ic + 1 >= E)), 2, err)
        if first_error_wins:
            err = torch.where(node_overflow, 1, err)
        if seq_id is not None:
            _set(st["seq_next"], (bi, head_c, torch.full_like(head_c, seq_id)), cur, has_head)
            _set(st["begin"], (bi, torch.full_like(bi, seq_id)), cur, act & (read_pos == 0))

        _add(st["cov"], (bi, cur_l), torch.ones_like(cur), act)
        st["node_count"] = torch.where(act, node_count, st["node_count"])
        st["error"] = err
        head = torch.where(act, cur, head)
        prev_w = torch.where(act, w, prev_w)
    return st


# ---------------------------------------------------------------------------
# consensus (cudapoa_generate_consensus.cuh)
# ---------------------------------------------------------------------------


def _consensus_row_update(st, scores, nid, row_act, skip_cleared, emax):
    """One row of the heaviest-edge predecessor pass with the reference's
    tie-breaks (jax_poa:1051). Returns (score, predecessor)."""
    B, N = st["nodes"].shape
    bi = torch.arange(B, device=nid.device)
    pc = st["in_count"][bi, nid]
    edges = st["in_edges"][bi, nid, :emax]
    ws = st["in_w"][bi, nid, :emax]
    if skip_cleared:
        s = torch.full((B,), -1, dtype=torch.int32, device=nid.device)
    else:
        s = scores[bi, nid]
    p = torch.full((B,), -1, dtype=torch.int32, device=nid.device)
    for e in range(emax):
        begin = edges[:, e].clamp(0, N - 1)
        ew = ws[:, e]
        sc_begin = scores[bi, begin.long()]
        use = row_act & (e < pc)
        if skip_cleared:
            use = use & (sc_begin != -1)
        sc_pred = scores[bi, p.clamp(0, N - 1).long()]
        take = use & ((s < ew) | ((s == ew) & (p != -1) & (sc_pred <= sc_begin)))
        s = torch.where(take, ew, s)
        p = torch.where(take, begin, p)
    sc_p = scores[bi, p.clamp(0, N - 1).long()]
    return torch.where(p != -1, s + sc_p, s), p


def consensus_batched(state, active):
    """Returns (consensus (B, N) int32 bases in BACKWARD order, coverage
    (B, N) int32, length (B,), err (B,)) (jax_poa:1094). Coverage of a base
    is its node's plus its aligned nodes' coverage."""
    st = state
    B, N = st["nodes"].shape
    A = st["al"].shape[2]
    dev = st["nodes"].device
    bi = torch.arange(B, device=dev)
    nc = st["node_count"]
    scores = torch.full((B, N), -1, dtype=torch.int32, device=dev)
    preds = torch.full((B, N), -1, dtype=torch.int32, device=dev)
    act0 = active & (st["error"] == 0)
    max_nc = int(torch.where(act0, nc, 0).max()) if B else 0
    in_graph = torch.arange(N, device=dev)[None, :] < torch.where(act0, nc, 0)[:, None]
    emax = int(torch.where(in_graph, st["in_count"], 0).max()) if max_nc else 0

    def write(row_act, nid, s, p):
        scores[bi, nid] = torch.where(row_act, s, scores[bi, nid])
        preds[bi, nid] = torch.where(row_act, p, preds[bi, nid])

    max_score = torch.full((B,), -1, dtype=torch.int32, device=dev)
    max_id = torch.zeros(B, dtype=torch.int32, device=dev)
    for gp in range(max_nc):
        nid = st["sorted"][:, gp].clamp(0, N - 1).long()
        row_act = act0 & (gp < nc)
        s, p = _consensus_row_update(st, scores, nid, row_act, False, emax)
        write(row_act, nid, s, p)
        upd = row_act & (max_score <= s)
        max_score = torch.where(upd, s, max_score)
        max_id = torch.where(upd, nid.to(torch.int32), max_id)

    # branch completion while the heaviest node is not a sink
    loops = torch.zeros(B, dtype=torch.int32, device=dev)
    E = st["in_edges"].shape[2]
    e_idx = torch.arange(E, device=dev, dtype=torch.int32)
    while True:
        mid = max_id.long()
        oc = st["out_count"][bi, mid]
        br_act = act0 & (oc != 0) & (loops < nc)
        if not bool(br_act.any()):
            break
        pos = st["pos_of"][bi, mid]
        # clear the scores of the out-neighbours' other predecessors
        outs = st["out_edges"][bi, mid].clamp(0, N - 1).long()  # (B, E)
        ins = st["in_edges"][bi[:, None], outs]  # (B, E, E)
        out_ic = st["in_count"][bi[:, None], outs]
        m = (
            (br_act[:, None] & (e_idx[None, :] < oc[:, None]))[:, :, None]
            & (e_idx[None, None, :] < out_ic[:, :, None])
            & (ins != max_id[:, None, None])
        )
        _set(scores, (bi[:, None, None].expand_as(ins), ins.clamp(0, N - 1).long()),
             torch.full_like(ins, -1), m)
        # rescan the rows after the heaviest node
        mxs = torch.zeros(B, dtype=torch.int32, device=dev)
        mxi = torch.zeros(B, dtype=torch.int32, device=dev)
        start = int(torch.where(br_act, pos, max_nc).min()) + 1
        for gp in range(start, max_nc):
            nid = st["sorted"][:, gp].clamp(0, N - 1).long()
            row_act = br_act & (gp > pos) & (gp < nc)
            s, p = _consensus_row_update(st, scores, nid, row_act, True, emax)
            write(row_act, nid, s, p)
            upd = row_act & (mxs <= s)
            mxs = torch.where(upd, s, mxs)
            mxi = torch.where(upd, nid.to(torch.int32), mxi)
        max_id = torch.where(br_act, mxi, max_id)
        loops = loops + br_act.to(torch.int32)
    err = torch.where(act0 & (loops >= nc) & (loops > 0), 3, st["error"])

    # backward emission from the heaviest sink
    cons = torch.zeros((B, N), dtype=torch.int32, device=dev)
    cov = torch.zeros((B, N), dtype=torch.int32, device=dev)
    a_idx = torch.arange(A, device=dev, dtype=torch.int32)[None, :]
    done = ~act0 | (err != 0)
    cur = max_id
    k = torch.zeros(B, dtype=torch.int32, device=dev)
    while not bool(done.all()):
        act = ~done
        cur_c = cur.clamp(0, N - 1).long()
        cv = st["cov"][bi, cur_c]
        als = st["al"][bi, cur_c].clamp(0, N - 1).long()
        al_cov = st["cov"][bi[:, None], als]
        cv = cv + torch.where(a_idx < st["al_count"][bi, cur_c][:, None], al_cov, 0).sum(
            dim=1, dtype=torch.int32)
        kc = k.clamp(0, N - 1).long()
        _set(cons, (bi, kc), st["nodes"][bi, cur_c], act)
        _set(cov, (bi, kc), cv, act)
        p = preds[bi, cur_c]
        newly = act & (p == -1)
        cur = torch.where(act & ~newly, p, cur)
        k = k + act.to(torch.int32)
        done = done | newly
    return cons, cov, k, err


# ---------------------------------------------------------------------------
# batched POA iteration
# ---------------------------------------------------------------------------


def poa_step_batched(state, read, read_len, weights, active, gap: int,
                     mismatch: int, match: int, work: dict | None = None,
                     seq_id: int | None = None):
    """One POA iteration for the windows in ``active``: NW + traceback, add
    alignment, topological sort (generatePOAKernel's per-sequence body,
    cudapoa_kernels.cuh:243-330; jax_poa:1242). ``seq_id`` records the
    read's path for the MSA (:func:`add_alignment_batched_seq`)."""
    st = state
    N = st["nodes"].shape[1]
    st["error"] = torch.where(
        active & (st["node_count"] >= N) & (st["error"] == 0), 1, st["error"]
    )
    act = active & (st["error"] == 0)
    ag, ar, aln_len, failed = nw_batched(st, read, read_len, act, gap, mismatch, match, work)
    st["error"] = torch.where(act & failed, 3, st["error"])
    act = act & (st["error"] == 0)
    add_alignment_batched_seq(st, ag, ar, aln_len, read, weights, act, seq_id)
    act = act & (st["error"] == 0)
    return topsort_batched(st, act)


def build_graphs(seqs, wts, lens, nseqs, N: int, E: int, A: int, gap: int,
                 mismatch: int, match: int, work: dict | None = None, msa: bool = False):
    """Backbone + per-sequence NW/add/topsort for packed windows (seqs
    (B, S, L) bases, wts (B, S, L), lens (B, S), nseqs (B,)); returns the
    graph state, with the MSA bookkeeping when ``msa``. ``work``
    accumulates the NW cell counts (:func:`nw_batched`)."""
    B, S, _ = seqs.shape
    seqs_i = seqs.to(torch.int32)
    state = init_graph_state(B, N, E, A, device=seqs.device, max_seqs=S if msa else None)
    all_active = torch.ones(B, dtype=torch.bool, device=seqs.device)
    build_backbone_batched(state, seqs_i[:, 0], lens[:, 0], wts[:, 0], all_active)
    for s in range(1, S):
        active = nseqs > s
        if not bool(active.any()):
            break
        poa_step_batched(state, seqs_i[:, s], lens[:, s], wts[:, s], active,
                         gap, mismatch, match, work, s if msa else None)
    return state


def poa_consensus_plain(seqs, wts, lens, nseqs, N: int, E: int, A: int,
                        gap: int, mismatch: int, match: int,
                        work: dict | None = None):
    """The whole chain on tensors — the plain version of the CUDA kernel,
    with its contract (``ops/poa_cuda.poa_consensus_cuda``): seqs uint8
    (B, S, L), wts int32 (B, S, L), lens int32 (B, S), nseqs int32 (B,) ->
    (cons uint8 (B, N) backward, cov int32 (B, N), length int32 (B,),
    err int32 (B,)). Runs on whatever device the tensors lie on.
    ``work`` accumulates the NW cell counts (see :func:`nw_batched`)."""
    poa_consensus_plain.calls += 1
    state = build_graphs(seqs, wts, lens, nseqs, N, E, A, gap, mismatch, match, work)
    all_active = torch.ones(seqs.shape[0], dtype=torch.bool, device=seqs.device)
    cons, cov, length, err = consensus_batched(state, all_active)
    return cons.to(torch.uint8), cov, length, err


poa_consensus_plain.calls = 0


# ---------------------------------------------------------------------------
# MSA (cudapoa_generate_msa.cuh) and graph export, on the host
# ---------------------------------------------------------------------------

GAP_CHAR = ord("-")


def racon_sort_host(n, in_edges, in_count, al, al_count):
    """raconTopologicalSortDeviceUtil (cudapoa_topsort.cuh:104) fused with
    getNodeIDToMSAPosDevice (cudapoa_generate_msa.cuh:35), a copy of
    jax_poa._racon_sort_host: the SPOA-exact DFS that places each node
    right before its aligned nodes, one MSA column per aligned clique.
    Returns (node -> column (n,) int32, MSA length, the stack's peak depth).

    A node is expanded once, and an expansion pushes each unfinished
    predecessor and aligned node, so the stack never holds more than
    n + sum(in_count) + sum(al_count) entries: the bound the CUDA kernel
    sizes its stack by (``MSA_STACK`` in csrc/poa_consensus.cu)."""
    node_to_col = np.zeros(n, dtype=np.int32)
    marks = np.zeros(n, dtype=np.int8)
    check_aligned = np.ones(n, dtype=bool)
    stack: list[int] = []
    col = peak = 0
    for i in range(n):
        if marks[i] != 0:
            continue
        stack.append(i)
        while stack:
            peak = max(peak, len(stack))
            nid = stack[-1]
            valid = True
            if marks[nid] != 2:
                for e in range(in_count[nid]):
                    b = in_edges[nid, e]
                    if marks[b] != 2:
                        stack.append(int(b))
                        valid = False
                if check_aligned[nid]:
                    for a in range(al_count[nid]):
                        aid = al[nid, a]
                        if marks[aid] != 2:
                            stack.append(int(aid))
                            check_aligned[aid] = False
                            valid = False
                if valid:
                    marks[nid] = 2
                    if check_aligned[nid]:
                        node_to_col[nid] = col
                        for a in range(al_count[nid]):
                            node_to_col[al[nid, a]] = col
                        col += 1
            if valid:
                stack.pop()
    return node_to_col, col, peak


def emit_msa_rows(n, nodes, seq_next, begin, ns, node_to_col, msa_len):
    """generateMSADevice (cudapoa_generate_msa.cuh:56) as jax_poa's host
    walk does it: ``ns`` rows of ``msa_len`` gaps, each sequence's path
    (from ``begin`` along ``seq_next``) writing its bases at their nodes'
    columns. (ns, msa_len) uint8."""
    cur = begin[:ns].copy()
    rows = np.full((ns, msa_len), GAP_CHAR, dtype=np.uint8)
    live = np.ones(ns, dtype=bool)
    sidx = np.arange(ns)
    while live.any():
        c = np.clip(cur, 0, n - 1)
        rows[live, node_to_col[c[live]]] = nodes[c[live]]
        nxt = seq_next[c, sidx]
        cur = np.where(live, nxt, cur)
        live = live & (cur != -1)
    return rows


def msa_from_state(state, nseqs):
    """The MSA of every error-free window of a graph state built with the
    bookkeeping: (msa (B, S, N) uint8, gaps past each row's end and in the
    rows of failed windows; msa_len (B,) int32, 0 for those; err (B,))."""
    B, N = state["nodes"].shape
    S = state["begin"].shape[1]
    host = {k: state[k].cpu().numpy() for k in (
        "nodes", "in_edges", "in_count", "al", "al_count", "seq_next", "begin",
        "node_count", "error")}
    ns = nseqs.cpu().numpy()
    msa = np.full((B, S, N), GAP_CHAR, dtype=np.uint8)
    msa_len = np.zeros(B, dtype=np.int32)
    for b in range(B):
        if host["error"][b] != 0:
            continue
        n = int(host["node_count"][b])
        node_to_col, k, _ = racon_sort_host(n, host["in_edges"][b], host["in_count"][b],
                                            host["al"][b], host["al_count"][b])
        msa[b, : ns[b], :k] = emit_msa_rows(n, host["nodes"][b], host["seq_next"][b],
                                            host["begin"][b], int(ns[b]), node_to_col, k)
        msa_len[b] = k
    dev = state["nodes"].device
    return (torch.from_numpy(msa).to(dev), torch.from_numpy(msa_len).to(dev),
            state["error"].clone())


def poa_msa_plain(seqs, wts, lens, nseqs, N: int, E: int, A: int, gap: int,
                  mismatch: int, match: int, work: dict | None = None):
    """Full-band MSA, the plain version of the kernel's MSA mode
    (``ops/poa_cuda.poa_msa_cuda``): the graph build with the bookkeeping,
    then :func:`msa_from_state`. The status is the build's (no consensus
    is run)."""
    poa_msa_plain.calls += 1
    state = build_graphs(seqs, wts, lens, nseqs, N, E, A, gap, mismatch, match, work, msa=True)
    return msa_from_state(state, nseqs)


poa_msa_plain.calls = 0


def export_graph(state):
    """The graph a window ends with, as the kernel's export writes it:
    (nodes (B, N), in_count (B, N), in_edges (B, N, E), in_w (B, N, E),
    node_count (B,), err (B,)), int32, zero past each window's node count
    and each node's in-count, and all zero but ``err`` in windows that
    failed."""
    B, N = state["nodes"].shape
    E = state["in_edges"].shape[2]
    dev = state["nodes"].device
    ok = state["error"] == 0
    live = ok[:, None] & (torch.arange(N, device=dev)[None, :] < state["node_count"][:, None])
    in_count = torch.where(live, state["in_count"], 0)
    edge = torch.arange(E, device=dev)[None, None, :] < in_count[:, :, None]
    return (torch.where(live, state["nodes"], 0), in_count,
            torch.where(edge, state["in_edges"], 0), torch.where(edge, state["in_w"], 0),
            torch.where(ok, state["node_count"], 0), state["error"].clone())


def poa_graph_plain(seqs, wts, lens, nseqs, N: int, E: int, A: int, gap: int,
                    mismatch: int, match: int, work: dict | None = None):
    """Full-band graph build, the plain version of the kernel's graph
    export (``ops/poa_cuda.poa_graph_cuda``): :func:`export_graph` of
    :func:`build_graphs`."""
    poa_graph_plain.calls += 1
    return export_graph(build_graphs(seqs, wts, lens, nseqs, N, E, A, gap, mismatch, match,
                                     work))


poa_graph_plain.calls = 0


def build_windows_graphs(windows, gap=-8, mismatch=-6, match=8, max_nodes=None,
                         max_edges=MAX_NODE_EDGES,
                         max_alignments=MAX_NODE_ALIGNMENTS, weights=None,
                         device=None, msa: bool = False):
    """Pack windows and build their graphs with the plain chain
    (jax_poa:1274). Returns the final graph ``state`` (with the MSA
    bookkeeping when ``msa``) plus nseqs (numpy)."""
    dev = resolve_device(device)
    packed = pack_windows(windows, weights, max_nodes)
    seqs, wts, lens, nseqs = (torch.from_numpy(a).to(dev) for a in packed[:4])
    state = build_graphs(seqs, wts, lens, nseqs, packed[4], max_edges, max_alignments,
                         gap, mismatch, match, msa=msa)
    return state, packed[3]


def pack_windows(windows, weights, max_nodes):
    """(B, S, L) uint8 bases (0 = pad), int32 weights (1 where none were
    given), lengths, read counts, and N (``max_nodes``, default 3 * L)."""
    B = len(windows)
    S = max(len(w) for w in windows)
    L = max(max(len(s) for s in w) for w in windows)
    N = 3 * L if max_nodes is None else max_nodes
    if N < L:
        # the reference rejects such groups at add time with
        # StatusType::exceeded_maximum_sequence_size (cudapoa_batch.cuh)
        raise ValueError(
            f"max_nodes={N} is smaller than the longest window sequence "
            f"({L}); exceeded_maximum_sequence_size"
        )
    lens = np.zeros((B, S), dtype=np.int32)
    nseqs = np.zeros(B, dtype=np.int32)
    for b, w in enumerate(windows):
        nseqs[b] = len(w)
        lens[b, : len(w)] = [len(s) for s in w]
    mask = np.arange(L)[None, None, :] < lens[:, :, None]
    seqs = np.zeros((B, S, L), dtype=np.uint8)
    seqs[mask] = np.frombuffer("".join(s for w in windows for s in w).encode("latin1"),
                               dtype=np.uint8)
    wts = np.ones((B, S, L), dtype=np.int32)
    if weights is not None:
        flat = [np.asarray(x, dtype=np.int32) for wb in weights for x in wb]
        if flat:
            wts[mask] = np.concatenate(flat)
    return seqs, wts, lens, nseqs, N


def poa_batch_consensus(
    windows: list[list[str]],
    gap: int = -8,
    mismatch: int = -6,
    match: int = 8,
    max_nodes: int | None = None,
    max_edges: int = MAX_NODE_EDGES,
    max_alignments: int = MAX_NODE_ALIGNMENTS,
    weights: list[list[np.ndarray]] | None = None,
    device=None,
    use_lockstep: bool | None = None,
) -> tuple[list[str], list[np.ndarray], list[int]]:
    """Batched full-band POA consensus over windows (lists of sequences).
    Returns (consensus list, coverage list, status list; 0 = success) like
    jax_poa:1609. ``device=None`` means CUDA.

    With ``use_lockstep`` the windows first go through the lockstep tier
    (``poa/lockstep.py``); every window it does not finish with status 0 is
    re-run here without it. ``None`` chooses the tier as jax_poa:1630-1640
    does, with the CUDA card in the TPU's place: on a CUDA device, for 64
    windows or more, when ``max_edges >= 7`` and ``max_alignments >= 8``.
    Without it the windows go through the per-window CUDA kernel at the
    caller's full caps (N = ``max_nodes``, default 3 * longest sequence;
    E, A), whose nonzero status is final. On ``device="cpu"`` each tier
    runs its plain version. A failed build or launch raises."""
    from genomeworks_tpu_torch.ops.poa_cuda import poa_consensus_cuda

    dev = resolve_device(device)
    if use_lockstep is None:
        use_lockstep = lockstep_by_default(dev, len(windows), max_edges, max_alignments)
    if use_lockstep:
        return _consensus_lockstep_tier(windows, gap, mismatch, match, max_nodes, max_edges,
                                        max_alignments, weights, dev)
    seqs, wts, lens, nseqs, N = pack_windows(windows, weights, max_nodes)
    cons, cov, length, err = poa_consensus_cuda(
        torch.from_numpy(seqs).to(dev), torch.from_numpy(wts).to(dev),
        torch.from_numpy(lens).to(dev), torch.from_numpy(nseqs).to(dev),
        N=N, E=max_edges, A=max_alignments, gap=gap, mismatch=mismatch, match=match,
    )
    return decode_consensus(cons, cov, length, err)


def decode_consensus(cons, cov, length, err):
    """Kernel outputs -> (consensus list, coverage list, status list)."""
    cons = cons.cpu().numpy()
    cov = cov.cpu().numpy()
    length = length.cpu().numpy()
    err = err.cpu().numpy()
    out_cons: list[str] = []
    out_cov: list[np.ndarray] = []
    out_status: list[int] = []
    for b in range(len(err)):
        if err[b] != 0:
            out_cons.append("")
            out_cov.append(np.zeros(0, np.int32))
            out_status.append(int(err[b]))
        else:
            k = int(length[b])
            out_cons.append(cons[b, :k][::-1].tobytes().decode("latin1"))
            out_cov.append(cov[b, :k][::-1].copy())
            out_status.append(0)
    return out_cons, out_cov, out_status


def decode_msa(windows, msa, msa_len, err):
    """Kernel outputs -> (per-window lists of MSA rows, status list)."""
    msa = msa.cpu().numpy()
    msa_len = msa_len.cpu().numpy()
    err = err.cpu().numpy()
    out_msa: list[list[str]] = []
    out_status: list[int] = []
    for b, w in enumerate(windows):
        if err[b] != 0:
            out_msa.append([])
        else:
            k = int(msa_len[b])
            out_msa.append([msa[b, s, :k].tobytes().decode("latin1") for s in range(len(w))])
        out_status.append(int(err[b]))
    return out_msa, out_status


def poa_batch_msa(
    windows: list[list[str]],
    gap: int = -8,
    mismatch: int = -6,
    match: int = 8,
    max_nodes: int | None = None,
    max_edges: int = MAX_NODE_EDGES,
    max_alignments: int = MAX_NODE_ALIGNMENTS,
    weights: list[list[np.ndarray]] | None = None,
    device=None,
) -> tuple[list[list[str]], list[int]]:
    """Batched full-band multiple sequence alignment (jax_poa:2053): the
    kernel's MSA mode at the caller's full caps (N = ``max_nodes``, default
    3 * longest sequence of the batch, as the XLA chain), one gapped row per
    sequence. Returns (per-window row lists, status list; 0 = success, the
    graph build's status). ``device=None`` means CUDA; on ``device="cpu"``
    the plain chain runs."""
    from genomeworks_tpu_torch.ops.poa_cuda import poa_msa_cuda

    dev = resolve_device(device)
    seqs, wts, lens, nseqs, N = pack_windows(windows, weights, max_nodes)
    out = poa_msa_cuda(*(torch.from_numpy(a).to(dev) for a in (seqs, wts, lens, nseqs)),
                       N=N, E=max_edges, A=max_alignments, gap=gap, mismatch=mismatch,
                       match=match)
    return decode_msa(windows, *out)


#: cpu_reference's PoaError messages -> the chain's status codes (the
#: mapping of jax_poa.poa_batch_consensus_banded's host chain)
HOST_STATUS = {
    "node_count_exceeded_maximum_graph_size": 1,
    "edge_count_exceeded_maximum_graph_size": 2,
    "loop_count_exceeded_upper_bound": 3,
}
BANDED_MODES = ("static_band", "adaptive_band", "static_band_traceback",
                "adaptive_band_traceback")


def _banded_inputs(windows, weights, max_nodes, dev):
    """Packed tensors for the banded modes, with each window's node cap:
    ``max_nodes``, or 3 * the window's own longest sequence (the host
    chain's default, cpu_reference.py)."""
    caps = np.array([3 * max(len(s) for s in w) if max_nodes is None else max_nodes
                     for w in windows], dtype=np.int32)
    L = max(max(len(s) for s in w) for w in windows)
    seqs, wts, lens, nseqs, N = pack_windows(windows, weights, max(int(caps.max()), L))
    return [torch.from_numpy(a).to(dev) for a in (seqs, wts, lens, nseqs, caps)], N


def _host_banded(windows, weights, fn, empty, gap, mismatch, match, max_nodes,
                 band_width, band_mode):
    """The host chain per window (cpu_reference with ``band_mode``):
    results and statuses as jax_poa.poa_batch_consensus_banded maps them."""
    from genomeworks_tpu_torch.poa.cpu_reference import PoaError

    out, status = [], []
    for b, w in enumerate(windows):
        try:
            out.append(fn(w, weights[b] if weights else None, gap, mismatch, match,
                          max_nodes, band_mode=band_mode, band_width=band_width))
            status.append(0)
        except PoaError as e:
            out.append(empty)
            status.append(HOST_STATUS.get(str(e), 3))
    return out, status


def poa_batch_consensus_banded(
    windows: list[list[str]],
    gap: int = -8,
    mismatch: int = -6,
    match: int = 8,
    max_nodes: int | None = None,
    band_width: int = 256,
    weights: list[list[np.ndarray]] | None = None,
    device=None,
    band_mode: str = "static_band",
) -> tuple[list[str], list[np.ndarray], list[int]]:
    """Banded POA consensus (jax_poa:1765), equal to the host chain
    ``cpu_reference.poa_consensus(band_mode=...)`` window by window.
    ``static_band`` and ``adaptive_band`` run the kernel's banded modes at
    full caps (E = A = 50, each window's node cap ``max_nodes`` or 3 * its
    own longest sequence) with no host re-run: a nonzero status is final.
    The ``*_traceback`` modes run the host chain per window, as the JAX
    package does: it has no device kernel for them. Returns (consensus,
    coverage, status) with the chain's codes (0 ok)."""
    from genomeworks_tpu_torch.ops.poa_cuda import poa_consensus_cuda
    from genomeworks_tpu_torch.poa.cpu_reference import poa_consensus

    if band_mode not in BANDED_MODES:
        raise ValueError(f"unknown band_mode {band_mode!r}")
    dev = resolve_device(device)
    if band_mode.endswith("_traceback"):
        out, status = _host_banded(windows, weights, poa_consensus, ("", np.zeros(0, np.int32)),
                                   gap, mismatch, match, max_nodes, band_width, band_mode)
        return [o[0] for o in out], [o[1] for o in out], status
    (seqs, wts, lens, nseqs, caps), N = _banded_inputs(windows, weights, max_nodes, dev)
    out = poa_consensus_cuda(seqs, wts, lens, nseqs, N=N, E=MAX_NODE_EDGES,
                             A=MAX_NODE_ALIGNMENTS, gap=gap, mismatch=mismatch, match=match,
                             band_width=band_width, adaptive=band_mode == "adaptive_band",
                             caps=caps)
    return decode_consensus(*out)


def poa_batch_msa_banded(
    windows: list[list[str]],
    gap: int = -8,
    mismatch: int = -6,
    match: int = 8,
    max_nodes: int | None = None,
    band_width: int = 256,
    weights: list[list[np.ndarray]] | None = None,
    device=None,
    band_mode: str = "static_band",
) -> tuple[list[list[str]], list[int]]:
    """Banded POA with MSA output (jax_poa:1965), equal to
    ``cpu_reference.poa_msa(band_mode=...)`` window by window: the kernel's
    banded MSA modes, or the host chain for the ``*_traceback`` modes, as
    :func:`poa_batch_consensus_banded`."""
    from genomeworks_tpu_torch.ops.poa_cuda import poa_msa_cuda
    from genomeworks_tpu_torch.poa.cpu_reference import poa_msa

    if band_mode not in BANDED_MODES:
        raise ValueError(f"unknown band_mode {band_mode!r}")
    dev = resolve_device(device)
    if band_mode.endswith("_traceback"):
        return _host_banded(windows, weights, poa_msa, [], gap, mismatch, match, max_nodes,
                            band_width, band_mode)
    (seqs, wts, lens, nseqs, caps), N = _banded_inputs(windows, weights, max_nodes, dev)
    out = poa_msa_cuda(seqs, wts, lens, nseqs, N=N, E=MAX_NODE_EDGES, A=MAX_NODE_ALIGNMENTS,
                       gap=gap, mismatch=mismatch, match=match, band_width=band_width,
                       adaptive=band_mode == "adaptive_band", caps=caps)
    return decode_msa(windows, *out)


def lockstep_by_default(dev, n_windows: int, max_edges: int, max_alignments: int) -> bool:
    """``use_lockstep=None``'s choice (jax_poa:1634-1640, the CUDA card in
    the TPU's place)."""
    return (torch.device(dev).type == "cuda" and n_windows >= 64 and max_edges >= 7
            and max_alignments >= 8)


def _consensus_lockstep_tier(windows, gap, mismatch, match, max_nodes, max_edges,
                             max_alignments, weights, dev):
    """The lockstep tier, then the per-window tier for every window it did
    not finish with status 0 (jax_poa:1641-1674, without its fallback on a
    failed tier); counts the windows in ``lockstep.tier_stats``. The
    default node cap is fixed from the whole batch first, so that neither
    the plan nor the re-run of a subset sees another N than the per-window
    tier would give these windows."""
    from genomeworks_tpu_torch.poa import lockstep

    if max_nodes is None:
        max_nodes = 3 * max(len(s) for w in windows for s in w)
    out_cons, out_cov, out_status = lockstep.poa_batch_consensus_lockstep(
        windows, gap, mismatch, match, weights=weights, max_nodes=max_nodes, device=dev)
    redo = [b for b, st in enumerate(out_status) if st != 0]
    unserved = sum(out_status[b] == lockstep.UNSERVED for b in redo)
    lockstep.tier_stats["lockstep_windows"] += len(windows) - len(redo)
    lockstep.tier_stats["lockstep_overflow_windows"] += len(redo) - unserved
    lockstep.tier_stats["lockstep_unserved_windows"] += unserved
    if redo:
        r_cons, r_cov, r_st = poa_batch_consensus(
            [windows[b] for b in redo], gap, mismatch, match, max_nodes, max_edges,
            max_alignments, [weights[b] for b in redo] if weights else None, device=dev,
            use_lockstep=False)
        for i, b in enumerate(redo):
            out_cons[b], out_cov[b], out_status[b] = r_cons[i], r_cov[i], r_st[i]
    return out_cons, out_cov, out_status
