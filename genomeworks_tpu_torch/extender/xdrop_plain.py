"""Plain PyTorch versions of the extender's two device functions: the
ungapped X-drop extension of every seed in one direction, and the A/C/G/T
match counts of the final segments that the entropy reads.

They compute what genomeworks_tpu/extender/xdrop.py computes
(``_make_chunk_body`` / ``_init_state`` / ``_extend_direction`` and
``_count_matches``), as a host loop over chunks of ``width`` positions
until every seed is done; the seeds still running are the only rows of a
chunk. The JAX package's fixed first sweep and its power-of-two compaction
of stragglers are TPU workarounds and are not copied: the answer does not
depend on the chunk schedule or the width (an out-of-bounds position
scores 0 and the maximum never moves onto it). The CPU path of the port
runs them; on the card they are the kernels' yardstick
(``ops/xdrop_cuda.py``). int32 throughout, as the reference.
"""

from __future__ import annotations

import torch

#: the JAX package's chunk width
WIDTH = 128
#: positions a chunk may grow to as seeds finish (both functions' default)
CELLS = 1 << 20


def _chunk(live: int, width: int, cells: int | None) -> int:
    """The next chunk's width: ``width``, or with ``cells`` the largest
    power-of-two multiple of it whose chunk over the ``live`` seeds holds at
    most ``cells`` positions, so that long extensions take few chunks."""
    if cells is None:
        return width
    while live * width * 2 <= cells:
        width *= 2
    return width


def _earliest_running_max(cum: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Running maximum along dim 1 and the EARLIEST column where it is
    reached. ``torch.cummax`` returns the later index on ties, so the
    maximum is taken over int64 keys ``value * W + (W - 1 - column)``: the
    larger key of two equal values is the earlier column."""
    W = cum.shape[1]
    col = torch.arange(W, device=cum.device, dtype=torch.int64)
    key = cum.to(torch.int64) * W + (W - 1 - col)
    best = torch.cummax(key, dim=1).values
    value = torch.div(best, W, rounding_mode="floor")
    return value.to(torch.int32), (W - 1 - torch.remainder(best, W)).to(torch.int32)


def extend_direction_plain(query, target, qpos, tpos, sub, xdrop: int, is_left: bool,
                           width: int = WIDTH, cells: int | None = None):
    """X-drop extension of every seed in one direction.

    query, target: uint8 codes 0-7 (Lq,), (Lt,); qpos, tpos int32 (S,);
    sub int32 (64,), the score of target code a against query code b at
    8 a + b. Right: positions seed + o for o = 0, 1, ...; left: seed - o for
    o = 1, 2, .... Returns (max_score, max_pos) int32 (S,): the running
    maximum of the cumulative score (0 to start, the earliest position on
    ties, the carried maximum winning ties with a chunk) at the last
    position before the first where it exceeds the cumulative score by more
    than ``xdrop``, or where a chunk's last position left the sequences;
    max_pos is o at that maximum, -1 (right) / 0 (left) when no prefix
    scores above 0. Reads are clamped to the sequences and out-of-bounds
    positions score 0; the right direction checks only the upper bounds and
    the left only the lower ones. Chunks are ``width`` positions, or grow as
    seeds finish up to ``cells`` positions a chunk: the answer is the same."""
    extend_direction_plain.calls += 1
    dev = qpos.device
    S = qpos.shape[0]
    Lq, Lt = query.shape[0], target.shape[0]
    q = query.to(torch.int64)
    t = target.to(torch.int64)
    sub = sub.to(torch.int32)
    xd = torch.tensor(xdrop, dtype=torch.int32, device=dev)

    score = torch.zeros(S, dtype=torch.int32, device=dev)
    best = torch.zeros(S, dtype=torch.int32, device=dev)
    best_pos = torch.full((S,), 0 if is_left else -1, dtype=torch.int32, device=dev)
    live = torch.arange(S, device=dev)
    base = 0
    while live.numel():
        W = _chunk(live.numel(), width, cells)
        qp0, tp0 = qpos[live], tpos[live]
        o = torch.arange(W, device=dev, dtype=torch.int32) + (base + (1 if is_left else 0))
        if is_left:
            tp = tp0[:, None] - o
            qp = qp0[:, None] - o
            inb = (tp >= 0) & (qp >= 0)
        else:
            tp = tp0[:, None] + o
            qp = qp0[:, None] + o
            inb = (tp < Lt) & (qp < Lq)
        tch = t[tp.clamp(0, Lt - 1).to(torch.int64)]
        qch = q[qp.clamp(0, Lq - 1).to(torch.int64)]
        sc = torch.where(inb, sub[tch * 8 + qch], 0)
        cum = score[live][:, None] + torch.cumsum(sc, dim=1, dtype=torch.int32)
        mc, mcol = _earliest_running_max(cum)
        prev, prev_pos = best[live][:, None], best_pos[live][:, None]
        better = mc > prev
        rm = torch.where(better, mc, prev)
        rmpos = torch.where(better, o[mcol.to(torch.int64)], prev_pos)
        drop = (rm - cum) > xd
        n_ok = torch.where(drop.any(dim=1), drop.to(torch.int8).argmax(dim=1), W)
        last = (n_ok - 1).clamp(min=0)[:, None]
        stop_best = torch.where(n_ok > 0, rm.gather(1, last)[:, 0], prev[:, 0])
        stop_pos = torch.where(n_ok > 0, rmpos.gather(1, last)[:, 0], prev_pos[:, 0])
        done = (n_ok < W) | ~inb[:, -1]
        best[live] = torch.where(done, stop_best, rm[:, -1])
        best_pos[live] = torch.where(done, stop_pos, rmpos[:, -1])
        score[live] = cum[:, -1]
        live = live[~done]
        base += W
    return best, best_pos


extend_direction_plain.calls = 0


def xdrop_extend_plain(query, target, qpos, tpos, sub, xdrop: int, width: int = WIDTH,
                       cells: int | None = CELLS):
    """Both directions of every seed: int32 (S, 4) of (right max score,
    right max position, left max score, left max position), the layout of
    ``ops.xdrop_cuda.xdrop_extend_cuda``."""
    xdrop_extend_plain.calls += 1
    r = extend_direction_plain(query, target, qpos, tpos, sub, xdrop, False, width, cells)
    l = extend_direction_plain(query, target, qpos, tpos, sub, xdrop, True, width, cells)
    return torch.stack([*r, *l], dim=1)


xdrop_extend_plain.calls = 0


def count_matches_plain(query, target, qpos, tpos, left, right, width: int = WIDTH,
                        cells: int | None = CELLS):
    """counts int32 (n, 4): per seed, the positions o = 0 .. left + right
    (inclusive) of its final segment, target seed - left + o against query
    seed - left + o, at which both lie in their sequences and hold the same
    base c in A/C/G/T, counted by c. left, right int32 (n,): the left and
    right max positions of the extension. Chunks as in
    ``extend_direction_plain``."""
    count_matches_plain.calls += 1
    dev = qpos.device
    n = qpos.shape[0]
    Lq, Lt = query.shape[0], target.shape[0]
    q = query.to(torch.int64)
    t = target.to(torch.int64)
    counts = torch.zeros((n, 4), dtype=torch.int32, device=dev)
    span = (left.to(torch.int64) + right.to(torch.int64))
    t0 = tpos.to(torch.int64) - left.to(torch.int64)
    q0 = qpos.to(torch.int64) - left.to(torch.int64)
    live = torch.nonzero(span >= 0).squeeze(1)
    base = 0
    while live.numel():
        W = _chunk(live.numel(), width, cells)
        off = base + torch.arange(W, device=dev, dtype=torch.int64)
        tp = t0[live][:, None] + off
        qp = q0[live][:, None] + off
        inb = (off <= span[live][:, None]) & (tp >= 0) & (qp >= 0) & (tp < Lt) & (qp < Lq)
        tch = t[tp.clamp(0, Lt - 1)]
        qch = q[qp.clamp(0, Lq - 1)]
        m = inb & (tch == qch) & (tch < 4)
        counts[live] += torch.stack([(m & (tch == c)).sum(dim=1) for c in range(4)],
                                    dim=1).to(torch.int32)
        base += W
        live = live[span[live] >= base]
    return counts


count_matches_plain.calls = 0
