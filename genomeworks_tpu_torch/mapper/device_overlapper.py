"""Device-side anchor chaining on PyTorch: the counterpart of
genomeworks_tpu/mapper/device_overlapper.py (reference: cudamapper's
OverlapperTriggered, cudamapper/src/overlapper_triggered.cu:250-441).

The reference chains anchors with CUB RunLengthEncode -> exclusive scan ->
copy_if -> ReduceByKey -> transform. Here every segment operation is a carry
of flagged indices: the flagged positions in order, indexed by a prefix
count of the flags, give each anchor the most recent flagged one at or
before it (or the first at or after it), and one gather per carried field
reads the values there. Per-chain and per-group sums are differences of
prefix sums.
The rows that pass the filter are kept by a boolean mask, which keeps
their anchor order.

The result equals the host :func:`get_overlaps` (same chain RLE rule,
>= 3 tail, fuse rule, CreateOverlap fields, FilterOverlapOp), with the
anchors on the device throughout: only the overlap rows come back. The
tensors are exactly the anchors' length (the JAX package pads them to a
power of two and downloads a window of rows).
"""

from __future__ import annotations

import torch

from genomeworks_tpu_torch.mapper.overlapper import (
    TAIL_LENGTH_FOR_CHAIN,
    Overlap,
    OverlapArrays,
)


def _carry(flag: torch.Tensor, reverse: bool = False, exclusive: bool = False):
    """Last-valid carry: for each i, the index of the most recent flagged
    position <= i (or the first >= i when ``reverse``); ``exclusive`` makes
    it strictly < (>) i. Returns (found, index); where nothing is found the
    index is some flagged position, or 0 when none is flagged.

    The flagged positions in order (one count read back) indexed by a prefix
    count of the flags: a cumsum and a gather, where ``torch.cummax`` with
    its indices is a slow scan on the card."""
    n = flag.shape[0]
    pos = flag.nonzero().squeeze(1)
    if pos.numel() == 0:
        return torch.zeros_like(flag), torch.zeros(n, dtype=torch.int64, device=flag.device)
    upto = torch.cumsum(flag, 0)  # flagged positions <= i
    before = upto - flag.to(torch.int64)  # flagged positions < i
    if not reverse:
        k = (before if exclusive else upto) - 1
        found = k >= 0
    else:
        k = upto if exclusive else before
        found = k < pos.numel()
    return found, pos[k.clamp(0, pos.numel() - 1)]


def chain_and_filter(
    qrid, trid, qpos, tpos,  # (n,) int32, anchors sorted by the compound key
    all_to_all: bool,
    min_residues: int,
    min_overlap_len: int,
    min_bases_per_residue: int,
    min_overlap_fraction: float,
):
    """Sorted anchors -> the overlap rows that pass the filter, in anchor
    order: (qrid, trid, qstart, qend, tstart, tend, reverse, residues), each
    an int32 tensor on the anchors' device. Reads a count back for each
    carry and for the final compaction."""
    n = qrid.shape[0]
    dev = qrid.device

    def prev(v):
        return torch.cat([v[:1], v[:-1]])

    # 1. chain RLE (overlapper_triggered.cu:47-60)
    same = (
        (qrid == prev(qrid)) & (trid == prev(trid))
        & ((qpos - prev(qpos)) < 150) & ((tpos - prev(tpos)).abs() < 150)
    )
    same[:1] = False
    f = ~same  # chain-start flag

    # chain start and the next chain's start of each element
    _, start_i = _carry(f)
    has_next, nxt = _carry(f, reverse=True, exclusive=True)
    next_start = torch.where(has_next, nxt, n)
    clen = next_start - start_i

    # 2. surviving chains (>= 3 anchors), flagged at their start element
    s = f & (clen >= TAIL_LENGTH_FOR_CHAIN)

    # 3. fuse with the previous surviving chain (cuOverlapKey ==,
    # overlapper_triggered.cu:89-103)
    pv, p = _carry(s, exclusive=True)
    dq = (qpos - qpos[p]).abs()
    dt = (tpos - tpos[p]).abs()
    fuse = s & pv & (qrid == qrid[p]) & (trid == trid[p]) & ((dq - dt).abs() < 300)
    gs = s & ~fuse  # group (overlap) start flag

    # residues prefix over surviving chains
    sl = torch.where(s, clen, 0)
    cum_incl = torch.cumsum(sl, 0)
    cum_excl = cum_incl - sl

    # last surviving start of each group: the next surviving start either
    # does not exist or starts a new group (~fuse)
    has_ns, ns = _carry(s, reverse=True, exclusive=True)
    ls = s & (~has_ns | ~fuse[ns])

    # the group's last chain, carried back to the group start; its last
    # anchor (the chain's next start less one) gives the end fields
    _, g = _carry(ls, reverse=True)
    g_end = next_start[g] - 1

    # 4. overlap fields at group starts (CreateOverlap,
    # overlapper_triggered.cu:196-238)
    residues = cum_incl[g] - cum_excl
    o_qr, o_tr = qrid[g_end], trid[g_end]  # ids from the end anchor
    o_qs, o_qe = qpos, qpos[g_end]
    o_ts, o_te = tpos, tpos[g_end]
    reverse_s = o_ts > o_te
    t_lo = torch.where(reverse_s, o_te, o_ts)
    t_hi = torch.where(reverse_s, o_ts, o_te)

    # 5. FilterOverlapOp (overlapper_triggered.cu:151-190), the fractions in
    # float32 as the JAX device path computes them
    t_len = t_hi - t_lo
    q_len = o_qe - o_qs
    ov_len = torch.maximum(t_len, q_len)
    ov_safe = ov_len.clamp(min=1).to(torch.float32)
    frac = torch.tensor(min_overlap_fraction, dtype=torch.float32, device=dev)
    ok = (
        gs
        & (residues >= min_residues)
        & ((ov_len // residues.clamp(min=1)) < min_bases_per_residue)
        & (q_len >= min_overlap_len)
        & (t_len >= min_overlap_len)
        & ((t_len.to(torch.float32) / ov_safe) > frac)
        & ((q_len.to(torch.float32) / ov_safe) > frac)
    )
    if all_to_all:
        ok &= o_qr != o_tr

    rows = ok.nonzero().squeeze(1)
    return tuple(
        v[rows].to(torch.int32)
        for v in (o_qr, o_tr, o_qs, o_qe, t_lo, t_hi, reverse_s, residues)
    )


def overlap_arrays(rows) -> OverlapArrays:
    """The eight overlap columns of :func:`chain_and_filter` on the host, as
    int32 :class:`OverlapArrays` (``rev`` as bool)."""
    o_qr, o_tr, o_qs, o_qe, t_lo, t_hi, rev, res = (r.cpu().numpy() for r in rows)
    return OverlapArrays(
        query_read_id=o_qr, target_read_id=o_tr,
        query_start=o_qs, query_end=o_qe,
        target_start=t_lo, target_end=t_hi,
        rev=rev != 0, num_residues=res,
    )


def get_overlaps_device(
    anchors_dev: tuple,   # (qrid, trid, qpos, tpos) device tensors, sorted
    n_anchors: int,
    all_to_all: bool,
    min_residues: int = 3,
    min_overlap_len: int = 250,
    min_bases_per_residue: int = 1000,
    min_overlap_fraction: float = 0.8,
) -> list[Overlap]:
    """Chain device-resident anchors into overlaps on their device; equal to
    :func:`genomeworks_tpu_torch.mapper.overlapper.get_overlaps`. The first
    ``n_anchors`` entries of each tensor are the anchors (anything past them
    is ignored)."""
    if n_anchors == 0:
        return []
    fields = (torch.as_tensor(a)[:n_anchors].to(torch.int32) for a in anchors_dev)
    return overlap_arrays(chain_and_filter(
        *fields, all_to_all, min_residues, min_overlap_len,
        min_bases_per_residue, min_overlap_fraction,
    )).to_overlaps()
