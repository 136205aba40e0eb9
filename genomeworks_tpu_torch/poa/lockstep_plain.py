"""Plain PyTorch versions of the five lockstep POA phases — what the CUDA
kernels of ``csrc/poa_lockstep.cu`` compute, batched over windows, on
whatever device the tensors lie on.

The lockstep tier (``poa/lockstep.py``) builds every window's graph at
small caps: N nodes from its plan, E = 7 in- and out-edges and A = 8
aligned nodes per node (``init_graph_state(B, N, 7, 8)``). Its phases are
those of the per-window chain (``poa/torch_poa.py``) with the lockstep
tier's own error codes in ``state["error"]``:

- 1: the add walk overflows the node cap N;
- 3: the traceback does not reach (0, 0);
- 5: a predecessor row lies at a topological distance outside [1, D]
  (the ring of D rows that the TPU kernel kept; the port keeps the same
  limit so that it serves the same windows);
- 6: an in-count over E at the NW, or an edge list or aligned list that
  would overflow its cap at the add;
- 100: the topological sort does not place every node.

``read_lockstep_plain`` is the traceback, add and topsort one after the
other, the function of the fused kernel the main path launches a read.

Each phase runs only on windows that are active and have no error, and
sets an error only where there is none: the first error wins. A window
with an error keeps it to the end and is re-run by the caller through the
per-window tier at the caller's full caps; these codes are never returned
to the user. Scores are int32.
"""

from __future__ import annotations

import torch

from genomeworks_tpu_torch.poa import torch_poa
from genomeworks_tpu_torch.poa.torch_poa import _add, _set

#: the lockstep caps: in- and out-edges, aligned nodes per node
E_LK, A_LK = 7, 8


def _ok(state, act):
    return act & (state["error"] == 0)


def _first_error(codes):
    """(B, R) int codes -> (B,) the first nonzero code of each row, or 0."""
    hit = codes != 0
    first = hit.to(torch.uint8).argmax(dim=1)
    return torch.where(hit.any(dim=1), codes.gather(1, first[:, None])[:, 0], 0)


def nw_lockstep_plain(state, read, read_len, act, codes, D: int, gap: int,
                      mismatch: int, match: int):
    """Full-band NW of ``read`` (B, Lr) uint8 against each window's graph,
    rows in topological order. Writes the priority code of every cell of
    rows 0..node_count-1 and columns 0..read_len into ``codes`` (B, N, Lp)
    uint8 (row r is graph row r + 1; other cells are left as they were) and
    returns best_i (B,) int32, the first sink row (1-based) with the highest
    score at column ``read_len``, 0 where the window does not run.

    A row's predecessors are read by topological distance; a distance
    outside [1, D] sets error 5 and an in-count over E sets 6, the first
    such row deciding (6 before 5 within a row). A window with an error
    writes no codes."""
    nw_lockstep_plain.calls += 1
    st = state
    B, N = st["nodes"].shape
    E = st["in_edges"].shape[2]
    dev = read.device
    ok = _ok(st, act)
    gp = torch.arange(N, device=dev)
    rows = ok[:, None] & (gp[None, :] < st["node_count"][:, None])
    nid = st["sorted"].clamp(0, N - 1).long()
    pc = st["in_count"].gather(1, nid)
    pe = st["in_edges"].gather(1, nid[:, :, None].expand(B, N, E)).clamp(0, N - 1).long()
    dist = gp[None, :, None] - st["pos_of"].gather(1, pe.view(B, N * E)).view(B, N, E)
    use = torch.arange(E, device=dev)[None, None, :] < pc.clamp(max=E)[:, :, None]
    bad = (use & ((dist < 1) | (dist > D))).any(dim=2)
    err = _first_error(torch.where(rows, torch.where(pc > E, 6, torch.where(bad, 5, 0)), 0))
    st["error"] = torch.where(err != 0, err, st["error"]).to(torch.int32)
    ok = ok & (err == 0)

    full, best_i = torch_poa.nw_forward(st, read.to(torch.int32), read_len, ok, gap,
                                        mismatch, match)
    n_sink = ((st["out_count"].gather(1, nid) == 0) & rows).sum(dim=1)
    best_i = torch.where(ok & (n_sink > 0), best_i, 0)
    C = full.shape[2]
    keep = (ok[:, None, None] & (gp[None, :, None] < st["node_count"][:, None, None])
            & (torch.arange(C, device=dev)[None, None, :] <= read_len[:, None, None]))
    view = codes[:, :, :C]
    view.copy_(torch.where(keep, full[:, 1:, :].to(torch.uint8), view))
    return best_i


def tb_lockstep_plain(state, codes, best_i, read_len, act, K: int):
    """Walk ``codes`` (B, N, Lp) back from (best_i, read_len). Returns (ag,
    ar (B, K) int32, the alignment in backward order, -1 for a gap; klen
    (B,) int32, 0 where the window did not run or failed). A walk that does
    not reach (0, 0) within K + 2 steps sets error 3."""
    tb_lockstep_plain.calls += 1
    st = state
    B, N, Lp = codes.shape
    ok = _ok(st, act)
    bi = torch.arange(B, device=codes.device)

    def code_at(i, j):
        return codes[bi, (i - 1).clamp(0, N - 1).long(), j.clamp(0, Lp - 1).long()].to(
            torch.int32)

    ag, ar, k, failed = torch_poa.traceback(st, code_at, best_i, read_len, ok, K)
    st["error"] = torch.where(failed, 3, st["error"]).to(torch.int32)
    return ag, ar, torch.where(ok & ~failed, k, 0).to(torch.int32)


def add_lockstep_plain(state, ag, ar, klen, read, weights, act):
    """Add each window's alignment (``ag``/``ar`` backward, ``klen`` moves)
    of ``read`` (B, Lr) uint8 to its graph in place: the sequential walk of
    ``torch_poa.add_alignment_batched_seq`` at the lockstep caps.
    ``weights`` (B, Lr) int32, or None for unit weights.

    Errors: 1 when a new node makes the count reach N; 6 when a new aligned
    node would make a clique list longer than A - 1, or a new edge would
    overflow an in- or out-list of E (the list is then left alone). The
    first error wins and the walk stops after the step that set it (the
    rest of that step's writes land)."""
    add_lockstep_plain.calls += 1
    st = state
    B, N = st["nodes"].shape
    E = st["in_edges"].shape[2]
    A = st["al"].shape[2]
    Lr = read.shape[1]
    K = ag.shape[1]
    dev = read.device
    bi = torch.arange(B, device=dev)
    bba = bi[:, None].expand(B, A)
    a_idx = torch.arange(A, device=dev, dtype=torch.int32)[None, :]
    e_idx = torch.arange(E, device=dev, dtype=torch.int32)[None, :]
    read = read.to(torch.int32)
    ok = _ok(st, act)
    klen = torch.where(ok, klen, 0)

    head = torch.full((B,), -1, dtype=torch.int32, device=dev)
    prev_w = torch.zeros(B, dtype=torch.int32, device=dev)
    for t in range(int(klen.max()) if B else 0):
        pos = (klen - 1 - t).clamp(0, K - 1).long()
        read_pos = ar[bi, pos]
        act_t = ok & (t < klen) & (st["error"] == 0) & (read_pos != -1)
        if not bool(act_t.any()):
            continue
        err = st["error"]
        gid = ag[bi, pos]
        rp = read_pos.clamp(0, Lr - 1).long()
        base = read[bi, rp]
        w = torch.ones_like(base) if weights is None else weights[bi, rp]

        gid_c = gid.clamp(0, N - 1).long()
        has_gid = act_t & (gid != -1)
        na = torch.where(has_gid, st["al_count"][bi, gid_c], 0)
        reuse_graph = has_gid & (st["nodes"][bi, gid_c] == base)
        al_list = st["al"][bi, gid_c]  # (B, A), a copy
        match_mask = ((a_idx < na[:, None])
                      & (st["nodes"][bba, al_list.clamp(0, N - 1).long()] == base[:, None]))
        reuse_al = has_gid & ~reuse_graph & match_mask.any(dim=1)
        first_al = al_list[bi, match_mask.to(torch.uint8).argmax(dim=1)]
        new_node = act_t & ~reuse_graph & ~reuse_al
        new_al = new_node & has_gid
        cur = torch.where(reuse_graph, gid_c.to(torch.int32),
                          torch.where(reuse_al, first_al, st["node_count"])).clamp(0, N - 1)
        cur_l = cur.long()
        node_count = st["node_count"] + new_node.to(torch.int32)
        err = torch.where(new_node & (node_count >= N) & (err == 0), 1, err)
        st["node_count"] = torch.where(act_t, node_count, st["node_count"])

        # a new node starts empty
        for key, val in (("nodes", base), ("out_count", 0), ("in_count", 0),
                         ("al_count", 0), ("cov", 0)):
            val = val if torch.is_tensor(val) else torch.full_like(cur, val)
            _set(st[key], (bi, cur_l), val, new_node)

        # cur joins gid's aligned clique: every member lists cur, cur lists
        # [members..., gid]; a list longer than A - 1 is error 6 instead
        ok_cap = new_al & (na + 1 <= A - 1)
        err = torch.where(new_al & ~ok_cap & (err == 0), 6, err)
        if bool(ok_cap.any()):
            for a in range(int(na[ok_cap].max())):
                m = ok_cap & (a < na)
                aid = al_list[:, a].clamp(0, N - 1).long()
                acnt = st["al_count"][bi, aid]
                _set(st["al"], (bi, aid, acnt.clamp(max=A - 1).long()), cur, m)
                _set(st["al_count"], (bi, aid), acnt + 1, m)
                _set(st["al"], (bi, cur_l, torch.full_like(aid, a)), aid.to(torch.int32), m)
            na_l = na.clamp(0, A - 1).long()
            _set(st["al"], (bi, gid_c, na_l), cur, ok_cap)
            _set(st["al"], (bi, cur_l, na_l), gid_c.to(torch.int32), ok_cap)
            _set(st["al_count"], (bi, gid_c), na + 1, ok_cap)
            _set(st["al_count"], (bi, cur_l), na + 1, ok_cap)

        # edge head -> cur: reweigh every slot that holds it, else append
        has_head = act_t & (head != -1)
        head_c = head.clamp(0, N - 1).long()
        dw = prev_w + w
        ic = torch.where(has_head, st["in_count"][bi, cur_l], 0)
        exist = (has_head[:, None] & (e_idx < ic.clamp(max=E)[:, None])
                 & (st["in_edges"][bi, cur_l] == head[:, None]))
        _add(st["in_w"], (bi[:, None].expand(B, E), cur_l[:, None].expand(B, E),
                          e_idx.long().expand(B, E)), dw[:, None].expand(B, E), exist)
        app = has_head & ~exist.any(dim=1)
        oc = torch.where(app, st["out_count"][bi, head_c], 0)
        cap_bad = app & ((ic >= E) | (oc >= E))
        err = torch.where(cap_bad & (err == 0), 6, err)
        app = app & ~cap_bad
        ic_l = ic.clamp(0, E - 1).long()
        _set(st["in_edges"], (bi, cur_l, ic_l), head_c.to(torch.int32), app)
        _set(st["in_w"], (bi, cur_l, ic_l), dw, app)
        _set(st["out_edges"], (bi, head_c, oc.clamp(0, E - 1).long()), cur, app)
        _add(st["in_count"], (bi, cur_l), torch.ones_like(ic), app)
        _add(st["out_count"], (bi, head_c), torch.ones_like(oc), app)
        _add(st["cov"], (bi, cur_l), torch.ones_like(cur), act_t)

        st["error"] = err.to(torch.int32)
        head = torch.where(act_t, cur, head)
        prev_w = torch.where(act_t, w, prev_w)
    return st


def topsort_lockstep_plain(state, act):
    """Kahn's sort of each window's graph (``torch_poa.topsort_batched``):
    positions 0..node_count-1 of ``sorted`` and ``pos_of`` are rewritten
    (-1 where a node is not placed), the rest are left as they were; a sort
    that does not place every node sets error 100."""
    topsort_lockstep_plain.calls += 1
    st = state
    ok = _ok(st, act)
    old = st["sorted"], st["pos_of"]
    torch_poa.topsort_batched(st, ok)
    N = st["nodes"].shape[1]
    inside = torch.arange(N, device=ok.device)[None, :] < st["node_count"][:, None]
    st["sorted"] = torch.where(inside, st["sorted"], old[0])
    st["pos_of"] = torch.where(inside, st["pos_of"], old[1])
    return st


def read_lockstep_plain(state, codes, best_i, read_len, read, weights, act, K: int):
    """The traceback, add and topsort of one read, one after the other:
    ``tb_lockstep_plain`` -> ``add_lockstep_plain`` ->
    ``topsort_lockstep_plain``, in place. Returns klen (B,) int32."""
    read_lockstep_plain.calls += 1
    ag, ar, klen = tb_lockstep_plain(state, codes, best_i, read_len, act, K)
    add_lockstep_plain(state, ag, ar, klen, read, weights, act)
    topsort_lockstep_plain(state, act)
    return klen


def consensus_lockstep_plain(state, act):
    """Heaviest path, branch completion and backward emission
    (``torch_poa.consensus_batched``). Returns (cons (B, N) uint8 backward,
    cov (B, N) int32, length (B,), err (B,)); err is the window's error, or
    3 where branch completion does not end."""
    consensus_lockstep_plain.calls += 1
    cons, cov, length, err = torch_poa.consensus_batched(state, act)
    return cons.to(torch.uint8), cov, length, err


for _f in (nw_lockstep_plain, tb_lockstep_plain, add_lockstep_plain, topsort_lockstep_plain,
           consensus_lockstep_plain, read_lockstep_plain):
    _f.calls = 0
