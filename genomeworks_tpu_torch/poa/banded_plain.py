"""The static- and adaptive-band POA chain in plain PyTorch, batched over
windows — the plain version that the banded modes of the CUDA kernel
(``ops/poa_cuda.py``, ``csrc/poa_consensus.cu``) are held against, and the
chain that runs when the tensors lie on the CPU.

It computes what the host oracle computes per window
(``poa/banded.py`` ``nw_align_banded_with_rerun`` inside
``cpu_reference.poa_consensus`` / ``poa_msa`` with ``band_mode``
``static_band`` or ``adaptive_band``), for B windows at once:

  backbone -> [ banded NW (+ the shift re-run) -> add alignment ->
  topological sort ]* -> consensus or MSA

- band rows of ``band_width + 8`` int32 slots; slot 0 holds the merged
  "column -1" boundary, slot k column ``band_start + k``, and ``get_score``
  maps column ``band_start`` to slot 0 too (the reference's conflation,
  reproduced);
- the band start of a row from the f32 gradient (``_band_start_for_row``);
  adaptive rules 1-3 in f64, the re-run rules 5-6, the give-up at 1536;
- predecessor reads in chunks of 4 under the reference's conservative
  guard ``min(pbs + bw - 4, max_column)``: a chunk outside it reads
  MIN_SCORE;
- the horizontal closure seeded from the boundary value, over every lane;
- the traceback by score re-derivation (diagonal over predecessors in edge
  order, then vertical, then horizontal; none found ends the walk at
  (0, 0)), with the band-shift rules 7-8 on the first pass of the adaptive
  mode.

Statuses are ``cpu_reference``'s, the first error of a window winning:
1 node count (before a read, or a new node past the cap), 2 edge list,
3 traceback (loop cap, or a re-run that reached 1536) or branch completion.
Each window has its own node cap (``caps``, (B,) int32).
"""

from __future__ import annotations

import torch

from genomeworks_tpu_torch.poa import torch_poa
from genomeworks_tpu_torch.poa.banded import (
    BANDED_MATRIX_RIGHT_PADDING,
    CELLS_PER_THREAD,
    MAX_ADAPTIVE_BAND_WIDTH,
    MIN_BAND_WIDTH,
    MIN_SCORE,
    SHIFT_LEFT,
    SHIFT_RIGHT,
)

LOOP_FAILED = -1  # banded.BACKTRACKING_LOOP_FAILED


def band_params(nc, rl, band_width: int, adaptive: bool, rerun):
    """Per-window band of one NW pass (nw_align_banded :69-113): (gradient
    f32, max_column, band width, band shift, give_up) as (B,) tensors;
    ``give_up`` marks a re-run whose band reached 1536 (the pass returns
    its re-run code)."""
    gradient = (rl + 1).to(torch.float32) / (nc + 1).to(torch.float32)
    max_column = rl + 1
    bw = torch.full_like(nc, band_width)
    give_up = torch.zeros_like(nc, dtype=torch.bool)
    if adaptive:
        g = gradient.to(torch.float64)
        mc = max_column.to(torch.float64)

        def align_up(x):
            return (x + MIN_BAND_WIDTH - 1) // MIN_BAND_WIDTH * MIN_BAND_WIDTH

        r1 = align_up((mc * 0.08 * g).to(torch.int64)).to(nc.dtype)
        bw = torch.where(g > 1.1, torch.maximum(bw, r1), bw)  # rule 1
        r2 = align_up((mc * 0.1 / g).to(torch.int64)).to(nc.dtype)
        bw = torch.where(g < 0.8, torch.maximum(bw, r2), bw)  # rule 2
        bw = bw.clamp(max=MAX_ADAPTIVE_BAND_WIDTH)  # rule 3
        give_up = (bw == MAX_ADAPTIVE_BAND_WIDTH) & (rerun != 0)
    shift = bw // 2  # rule 4
    if adaptive:
        grow = bw <= MAX_ADAPTIVE_BAND_WIDTH // 2
        left = grow & (rerun == SHIFT_LEFT)
        right = grow & (rerun == SHIFT_RIGHT)
        shift = torch.where(left, (shift.to(torch.float64) * 2.5).to(nc.dtype), shift)
        shift = torch.where(right, (shift.to(torch.float64) * 1.5).to(nc.dtype), shift)
        bw = torch.where(left | right, bw * 2, bw)  # rules 5-6
    return gradient, max_column, bw, shift, give_up


def band_start(row, gradient, bw, shift, max_column):
    """get_band_start_for_row (banded._band_start_for_row), per window."""
    diag = (row.to(torch.float32) * gradient).to(row.dtype)
    start = (diag - shift).clamp(min=0)
    start = torch.where(max_column < start + bw,
                        (max_column - bw + CELLS_PER_THREAD).clamp(min=0), start)
    return start - start % CELLS_PER_THREAD


def nw_banded(state, read, read_len, active, gap: int, mismatch: int, match: int,
              band_width: int, adaptive: bool, rerun, work: dict | None = None):
    """One banded NW pass of ``read`` (B, L) int32 against each active
    window's graph. Returns (ag (B, K), ar (B, K), aln_len (B,), code (B,))
    with K = N + L, the alignment backward as ``torch_poa.nw_batched``
    gives it; ``code`` is 0, SHIFT_LEFT / SHIFT_RIGHT (rules 7-8 fired), a
    re-run's own code (its band reached 1536) or LOOP_FAILED. ``work``
    accumulates the band cells the pass computes (``cells``, graph rows x
    band lanes) and ``pred_cells`` (the same, once per predecessor row),
    and what the pass met: ``band_widths`` (the set of its windows' bands),
    ``guard_other_start`` (chunks of 4 lanes inside the band whose guard
    failed on a predecessor row with another band start), ``shift_left``
    and ``shift_right`` (windows whose rules 7 or 8 fired) and ``moves``
    (the moves of the walks that ended, code 0)."""
    st = state
    B, N = st["nodes"].shape
    L = read.shape[1]
    K = N + L
    dev = read.device
    bi = torch.arange(B, device=dev)
    bb = bi[:, None]
    i32 = torch.int32

    nc = torch.where(active, st["node_count"], 0)
    rl = torch.where(active, read_len, 0)
    gradient, max_column, bw, shift, give_up = band_params(nc, rl, band_width, adaptive, rerun)
    run = active & ~give_up
    nc = torch.where(run, nc, 0)
    max_nc = int(nc.max()) if B else 0
    BW = int(torch.where(run, bw, 0).max()) if B else 0
    W = BW + BANDED_MATRIX_RIGHT_PADDING
    in_graph = torch.arange(N, device=dev)[None, :] < nc[:, None]
    emax = max(1, int(torch.where(in_graph, st["in_count"], 0).max())) if max_nc else 1
    if work is not None:
        lanes = torch.where(run, bw, 0).to(torch.int64)
        npred = torch.where(in_graph, st["in_count"].clamp(min=1), 0).sum(dim=1)
        work["cells"] = work.get("cells", 0) + int((nc.to(torch.int64) * lanes).sum())
        work["pred_cells"] = work.get("pred_cells", 0) + int((npred * lanes).sum())
        work["band_widths"] = work.get("band_widths", set()) | set(bw[run].tolist())

    lane = torch.arange(max(BW, 1), device=dev, dtype=i32)[None, :]
    slot = torch.arange(W, device=dev, dtype=i32)
    scores = torch.full((B, max_nc + 1, W), MIN_SCORE, dtype=i32, device=dev)
    scores[:, 0, :] = slot * gap
    bstart = torch.zeros((B, max_nc + 1), dtype=i32, device=dev)
    read_pad = torch.cat([read, torch.zeros((B, W + CELLS_PER_THREAD), dtype=i32, device=dev)], 1)
    read_pad = torch.where(torch.arange(read_pad.shape[1], device=dev)[None, :] < rl[:, None],
                           read_pad, 0)
    e_idx = torch.arange(emax, device=dev, dtype=i32)[None, :]

    def pred_rows(nid):
        """Predecessor rows of node ``nid`` in edge order (row 0 for a
        source), and which of the emax entries are used."""
        pc = st["in_count"][bi, nid]
        preds = st["in_edges"][bi, nid, :emax].clamp(0, N - 1).long()
        ppos = torch.where(pc[:, None] == 0, 0, st["pos_of"][bb, preds] + 1)
        use = e_idx < pc.clamp(min=1)[:, None]
        return torch.where(use, ppos.clamp(0, max_nc), 0).long(), use, pc

    def get_score(row, col):
        """get_score (banded.py :126-133): (B,) rows and columns, or (B, E)
        rows and (B, 1) columns."""
        row = row.long()
        b, w_, mc = (bi, bw, max_column) if row.dim() == 1 else \
            (bb, bw[:, None], max_column[:, None])
        bs = bstart[b, row]
        be = torch.minimum(bs + w_, mc)
        out = ((col > be) | (col < bs)) & (col != -1)
        s = torch.where(col == -1, 0, col - bs).clamp(0, W - 1).long()
        return torch.where(out, MIN_SCORE, scores[b, row, s])

    for gp in range(max_nc):
        row = gp + 1
        ract = run & (gp < nc)
        nid = st["sorted"][:, gp].clamp(0, N - 1).long()
        ppos, use, pc = pred_rows(nid)
        er = max(1, int(torch.where(ract, pc, 0).max()))  # this row's predecessors
        ppos, use = ppos[:, :er], use[:, :er]
        bs = band_start(torch.full_like(nc, row), gradient, bw, shift, max_column)
        # the column -1 boundary (:147-161)
        slot0 = scores[bb, ppos, 0].masked_fill(~use, MIN_SCORE).amax(dim=1).clamp(min=MIN_SCORE)
        fe_prev = torch.where(pc == 0, gap,
                              torch.where((bs > CELLS_PER_THREAD) & (pc == 1), MIN_SCORE + gap,
                                          slot0 + gap))
        # predecessor reads in chunks of 4 under the conservative guard
        k0 = lane - lane % CELLS_PER_THREAD
        rp = (bs[:, None] + k0)[:, None, :]  # (B, 1, BW)
        pbs = bstart[bb, ppos][:, :, None]  # (B, emax, 1)
        pbe = torch.minimum(pbs + bw[:, None, None] - CELLS_PER_THREAD,
                            max_column[:, None, None])
        guard = use[:, :, None] & (rp <= pbe) & (rp >= pbs)
        if work is not None:
            other = use[:, :, None] & ~guard & (pbs != bs[:, None, None]) & \
                (lane % CELLS_PER_THREAD == 0) & (lane < bw[:, None])[:, None, :]
            work["guard_other_start"] = work.get("guard_other_start", 0) + int(
                (other & ract[:, None, None]).sum())
        sd = (bs[:, None, None] + lane[:, None, :] - pbs).clamp(0, W - 2).long()
        prow = scores[bb, ppos]  # (B, emax, W)
        vd = torch.where(guard, prow.gather(2, sd), MIN_SCORE)
        vv = torch.where(guard, prow.gather(2, sd + 1), MIN_SCORE)
        gbase = st["nodes"][bi, nid]
        col_base = read_pad.gather(1, (bs[:, None] + lane).long())
        prof = torch.where(col_base == gbase[:, None], match, mismatch).to(i32)
        cand = torch.maximum(vd + prof[:, None, :], vv + gap)
        base = cand.masked_fill(~use[:, :, None], MIN_SCORE).amax(dim=1).clamp(min=MIN_SCORE)
        # horizontal closure seeded from the boundary (:187-193)
        slope = lane * gap
        v = torch.maximum(torch.cummax(base - slope, dim=1).values, (fe_prev + gap)[:, None])
        v = torch.where(lane < bw[:, None], v + slope, MIN_SCORE)
        new = torch.cat([fe_prev[:, None], v, scores[:, row, BW + 1:]], dim=1)
        scores[:, row] = torch.where(ract[:, None], new, scores[:, row])
        bstart[:, row] = torch.where(ract, bs, bstart[:, row])

    # traceback start: the first strict maximum at column rl over sink rows
    sorted_oc = st["out_count"].gather(1, st["sorted"][:, :max(max_nc, 1)].clamp(0, N - 1).long())
    rows = torch.arange(1, max_nc + 1, device=dev)
    if max_nc:
        col = torch.stack([get_score(torch.full_like(nc, r), rl) for r in range(1, max_nc + 1)], 1)
        sink = (sorted_oc[:, :max_nc] == 0) & (rows[None, :] <= nc[:, None])
        col = torch.where(sink, col, MIN_SCORE)
        best = col.amax(dim=1)
        i = torch.where(run & (best > MIN_SCORE), col.argmax(dim=1).to(i32) + 1, 0)
    else:
        i = torch.zeros_like(nc)
    j = torch.where(run, rl, 0)

    ag = torch.full((B, K), -1, dtype=i32, device=dev)
    ar = torch.full((B, K), -1, dtype=i32, device=dev)
    k = torch.zeros_like(nc)
    code = torch.where(active & give_up, rerun, 0)
    cap = rl + nc + 2
    loops = torch.zeros_like(nc)
    thr = (max_column // 1024).clamp(min=1)
    rules_78 = adaptive and bool(((rerun == 0) & run).any())
    while True:
        live = run & (code == 0) & ((i != 0) | (j != 0)) & (loops < cap)
        if not bool(live.any()):
            break
        loops = loops + live.to(i32)
        sij = get_score(i, j)
        inner = (i != 0) & (j != 0)
        if rules_78:
            near = live & inner & (rerun == 0) & (bw < MAX_ADAPTIVE_BAND_WIDTH) & \
                (thr < j) & (j < max_column - thr)
            bs_i = band_start(i, gradient, bw, shift, max_column)
            left = near & (j <= bs_i + thr)
            right = near & ~left & (j >= bs_i + bw - thr)
            code = torch.where(left, SHIFT_LEFT, torch.where(right, SHIFT_RIGHT, code))
            live = live & ~left & ~right
        nid = st["sorted"][bi, (i - 1).clamp(0, N - 1).long()].clamp(0, N - 1).long()
        ppos, use, _ = pred_rows(nid)
        mcost = torch.where(st["nodes"][bi, nid] == read[bi, (j - 1).clamp(0, L - 1).long()],
                            match, mismatch)
        # the first predecessor in edge order whose diagonal, else vertical,
        # move gives the cell's score; else the horizontal move; else (0, 0)
        diag = (live & inner)[:, None] & use & \
            (sij[:, None] == get_score(ppos, (j - 1)[:, None]) + mcost[:, None])
        vert = (live & (i != 0))[:, None] & use & \
            (sij[:, None] == get_score(ppos, j[:, None]) + gap)
        is_d = diag.any(dim=1)
        is_v = ~is_d & vert.any(dim=1)
        is_h = live & ~is_d & ~is_v & (sij == get_score(i, j - 1) + gap)
        p_d = ppos.gather(1, diag.to(torch.uint8).argmax(dim=1, keepdim=True))[:, 0].to(i32)
        p_v = ppos.gather(1, vert.to(torch.uint8).argmax(dim=1, keepdim=True))[:, 0].to(i32)
        prev_i = torch.where(is_d, p_d, torch.where(is_v, p_v, torch.where(is_h, i, 0)))
        prev_j = torch.where(is_d | is_h, j - 1, torch.where(is_v, j, 0))
        kk = k.clamp(0, K - 1).long()
        w_ok = live & (k < K)
        torch_poa._set(ag, (bi, kk), torch.where(prev_i == i, -1, nid.to(i32)), w_ok)
        torch_poa._set(ar, (bi, kk), torch.where(prev_j == j, -1, j - 1), w_ok)
        i = torch.where(live, prev_i, i)
        j = torch.where(live, prev_j, j)
        k = k + live.to(i32)
    code = torch.where(run & (code == 0) & (loops >= cap), LOOP_FAILED, code)
    if work is not None:
        for key, c in (("shift_left", SHIFT_LEFT), ("shift_right", SHIFT_RIGHT)):
            work[key] = work.get(key, 0) + int((run & (code == c)).sum())
        work["moves"] = work.get("moves", 0) + int(torch.where(run & (code == 0), k, 0).sum())
    return ag, ar, k, code


def nw_banded_with_rerun(state, read, read_len, active, gap, mismatch, match,
                         band_width: int, adaptive: bool, work: dict | None = None):
    """The re-run protocol (banded.nw_align_banded_with_rerun): a pass, and
    for the windows whose walk hit a band limit a second pass with the
    shift code. Returns (ag, ar, aln_len, failed (B,) bool)."""
    zero = torch.zeros_like(read_len)
    ag, ar, k, code = nw_banded(state, read, read_len, active, gap, mismatch, match,
                                band_width, adaptive, zero, work)
    shifted = active & ((code == SHIFT_LEFT) | (code == SHIFT_RIGHT))
    if bool(shifted.any()):
        ag2, ar2, k2, code2 = nw_banded(state, read, read_len, shifted, gap, mismatch, match,
                                        band_width, adaptive, torch.where(shifted, code, 0),
                                        work)
        ag = torch.where(shifted[:, None], ag2, ag)
        ar = torch.where(shifted[:, None], ar2, ar)
        k = torch.where(shifted, k2, k)
        code = torch.where(shifted, code2, code)
    return ag, ar, k, active & (code != 0)


def build_graphs_banded(seqs, wts, lens, nseqs, caps, E: int, A: int, gap: int,
                        mismatch: int, match: int, band_width: int, adaptive: bool,
                        msa: bool = False, work: dict | None = None):
    """Backbone + per-read banded NW / add / sort for packed windows (as
    ``torch_poa.build_graphs``), node caps per window. The graph arrays are
    as wide as the largest cap or the longest read. ``work`` accumulates
    the band cells (:func:`nw_banded`)."""
    B, S, L = seqs.shape
    dev = seqs.device
    N = max(int(caps.max()), L)
    seqs_i = seqs.to(torch.int32)
    st = torch_poa.init_graph_state(B, N, E, A, device=dev, max_seqs=S if msa else None)
    ok0 = lens[:, 0] <= caps  # cpu_reference.build_backbone's check
    torch_poa.build_backbone_batched(st, seqs_i[:, 0], lens[:, 0], wts[:, 0], ok0)
    st["error"] = torch.where(ok0, 0, 1).to(torch.int32)
    for s in range(1, S):
        active = nseqs > s
        if not bool(active.any()):
            break
        st["error"] = torch.where(active & (st["node_count"] >= caps) & (st["error"] == 0), 1,
                                  st["error"])
        act = active & (st["error"] == 0)
        ag, ar, k, failed = nw_banded_with_rerun(st, seqs_i[:, s], lens[:, s], act, gap,
                                                 mismatch, match, band_width, adaptive, work)
        st["error"] = torch.where(failed, 3, st["error"])
        act = act & ~failed
        torch_poa.add_alignment_batched_seq(st, ag, ar, k, seqs_i[:, s], wts[:, s], act,
                                            s if msa else None, first_error_wins=True,
                                            caps=caps)
        act = act & (st["error"] == 0)
        torch_poa.topsort_batched(st, act)
    return st


def poa_banded_plain(seqs, wts, lens, nseqs, caps, E: int, A: int, gap: int, mismatch: int,
                     match: int, band_width: int, adaptive: bool, work: dict | None = None):
    """Banded consensus, the plain version of the kernel's static / adaptive
    consensus modes (``ops/poa_cuda.poa_consensus_cuda`` with
    ``band_width``): (cons uint8 (B, N) backward, cov (B, N), length (B,),
    err (B,)), N the graph arrays' width."""
    poa_banded_plain.calls += 1
    st = build_graphs_banded(seqs, wts, lens, nseqs, caps, E, A, gap, mismatch, match,
                             band_width, adaptive, work=work)
    every = torch.ones_like(nseqs, dtype=torch.bool)
    cons, cov, length, err = torch_poa.consensus_batched(st, every)
    return cons.to(torch.uint8), cov, length, err


poa_banded_plain.calls = 0


def poa_msa_banded_plain(seqs, wts, lens, nseqs, caps, E: int, A: int, gap: int,
                         mismatch: int, match: int, band_width: int, adaptive: bool,
                         work: dict | None = None):
    """Banded MSA, the plain version of the kernel's static / adaptive MSA
    modes (``ops/poa_cuda.poa_msa_cuda`` with ``band_width``): (msa uint8
    (B, S, N), msa_len (B,), err (B,)) as ``torch_poa.msa_from_state``
    gives them."""
    poa_msa_banded_plain.calls += 1
    st = build_graphs_banded(seqs, wts, lens, nseqs, caps, E, A, gap, mismatch, match,
                             band_width, adaptive, msa=True, work=work)
    return torch_poa.msa_from_state(st, nseqs)


poa_msa_banded_plain.calls = 0
