"""Anchor chaining into overlaps — re-design of cudamapper's
OverlapperTriggered (cudamapper/src/overlapper_triggered.cu) and the host
post-processing (cudamapper/src/overlapper.cpp).

Pipeline (reference CUB calls -> vectorized segment ops):
1. run-length "chains": adjacent sorted anchors belong to one chain iff
   same (query_read, target_read) and q-distance < 150 and |t-distance| <
   150 (overlapper_triggered.cu:47-60);
2. keep chains with >= 3 anchors (tail_length_for_chain,
   overlapper_triggered.cu:259);
3. fuse adjacent surviving chains whose START anchors satisfy
   | |dq| - |dt| | < 300 on the same read pair (cuOverlapKey ==,
   overlapper_triggered.cu:89-103); fused overlap spans min start / max end
   anchor and sums residues (FuseOverlapOp);
4. overlap fields from the start/end anchors; reverse strand iff target
   start > target end, in which case target coordinates swap
   (CreateOverlap, overlapper_triggered.cu:196-238);
5. filter (FilterOverlapOp, overlapper_triggered.cu:151-190).

Host post-processing: Overlapper::post_process_overlaps
(overlapper.cpp:136-236) appends fused copies of mergeable runs.

A copy of genomeworks_tpu/mapper/overlapper.py (NumPy): the host path's
chaining, post-processing and rescue (``OverlapArrays.to_overlaps`` reads
each column once).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from genomeworks_tpu_torch.mapper.matcher import Anchors


@dataclasses.dataclass
class Overlap:
    """reference: cudamapper types.hpp Overlap"""

    query_read_id: int
    target_read_id: int
    query_start_position_in_read: int
    query_end_position_in_read: int
    target_start_position_in_read: int
    target_end_position_in_read: int
    relative_strand: str  # '+' or '-'
    num_residues: int


TAIL_LENGTH_FOR_CHAIN = 3  # overlapper_triggered.cu:259


def get_overlaps(
    anchors: Anchors,
    all_to_all: bool,
    min_residues: int = 3,
    min_overlap_len: int = 250,
    min_bases_per_residue: int = 1000,
    min_overlap_fraction: float = 0.8,
) -> list[Overlap]:
    n = len(anchors)
    if n == 0:
        return []
    qrid = anchors.query_read_ids.astype(np.int64)
    trid = anchors.target_read_ids.astype(np.int64)
    qpos = anchors.query_positions.astype(np.int64)
    tpos = anchors.target_positions.astype(np.int64)

    # 1. chain RLE: same read pair && dq < 150 && |dt| < 150
    # (dq is unsigned in the reference; anchors are sorted by qpos within a
    # read pair so dq >= 0 whenever ids match)
    same = (
        (qrid[1:] == qrid[:-1])
        & (trid[1:] == trid[:-1])
        & ((qpos[1:] - qpos[:-1]) < 150)
        & (np.abs(tpos[1:] - tpos[:-1]) < 150)
    )
    chain_id = np.concatenate([[0], np.cumsum(~same)])
    n_chains = int(chain_id[-1]) + 1
    chain_length = np.bincount(chain_id, minlength=n_chains)
    chain_start = np.concatenate([[0], np.cumsum(chain_length)[:-1]])

    # 2. keep chains with length >= 3, in chain order
    keep = chain_length >= TAIL_LENGTH_FOR_CHAIN
    c_start = chain_start[keep]
    c_len = chain_length[keep]
    if len(c_start) == 0:
        return []

    # 3. fuse adjacent surviving chains (ReduceByKey with adjacent-key ==)
    a_q = qpos[c_start]
    a_t = tpos[c_start]
    a_qr = qrid[c_start]
    a_tr = trid[c_start]
    dq = np.abs(a_q[1:] - a_q[:-1])
    dt = np.abs(a_t[1:] - a_t[:-1])
    fuse = (a_qr[1:] == a_qr[:-1]) & (a_tr[1:] == a_tr[:-1]) & (np.abs(dq - dt) < 300)
    group = np.concatenate([[0], np.cumsum(~fuse)])
    n_groups = int(group[-1]) + 1
    num_residues = np.bincount(group, weights=c_len, minlength=n_groups).astype(np.int64)
    # segment min of starts / max of ends (chains are in anchor order so
    # the first chain of a group has the min start and the last the max end)
    first_of_group = np.concatenate([[0], np.nonzero(~fuse)[0] + 1])
    last_of_group = np.concatenate([np.nonzero(~fuse)[0], [len(c_start) - 1]])
    ov_start = c_start[first_of_group]
    ov_end = c_start[last_of_group] + c_len[last_of_group]

    # 4. overlap fields
    s_idx = ov_start
    e_idx = ov_end - 1
    o_qr = qrid[e_idx]
    o_tr = trid[e_idx]
    o_qs = qpos[s_idx]
    o_qe = qpos[e_idx]
    o_ts = tpos[s_idx]
    o_te = tpos[e_idx]
    reverse = o_ts > o_te
    t_lo = np.where(reverse, o_te, o_ts)
    t_hi = np.where(reverse, o_ts, o_te)

    # 5. filter (FilterOverlapOp)
    t_len = t_hi - t_lo
    q_len = o_qe - o_qs
    ov_len = np.maximum(t_len, q_len)
    self_map = (o_qr == o_tr) & all_to_all
    with np.errstate(divide="ignore", invalid="ignore"):
        ok = (
            (num_residues >= min_residues)
            & ((ov_len // num_residues) < min_bases_per_residue)
            & (q_len >= min_overlap_len)
            & (t_len >= min_overlap_len)
            & (~self_map)
            & ((t_len.astype(np.float32) / np.maximum(ov_len, 1)) > min_overlap_fraction)
            & ((q_len.astype(np.float32) / np.maximum(ov_len, 1)) > min_overlap_fraction)
        )

    out = []
    for i in np.nonzero(ok)[0]:
        out.append(
            Overlap(
                query_read_id=int(o_qr[i]),
                target_read_id=int(o_tr[i]),
                query_start_position_in_read=int(o_qs[i]),
                query_end_position_in_read=int(o_qe[i]),
                target_start_position_in_read=int(t_lo[i]),
                target_end_position_in_read=int(t_hi[i]),
                relative_strand="-" if reverse[i] else "+",
                num_residues=int(num_residues[i]),
            )
        )
    return out


def _overlaps_mergable(o1: Overlap, o2: Overlap) -> bool:
    """reference: overlapper.cpp:38-100 overlaps_mergable."""
    if o1.relative_strand != o2.relative_strand:
        return False
    if (o1.query_read_id != o2.query_read_id) or (o1.target_read_id != o2.target_read_id):
        return False
    query_gap = abs(o2.query_start_position_in_read - o1.query_end_position_in_read)
    if o1.relative_strand == "-":
        target_gap = abs(o1.target_start_position_in_read - o2.target_end_position_in_read)
    else:
        target_gap = abs(o2.target_start_position_in_read - o1.target_end_position_in_read)

    if query_gap < 500 and target_gap < 500:
        return True
    mx = max(query_gap, target_gap)
    if mx > 0 and (min(query_gap, target_gap) / mx) > 0.8:
        return True
    total_q = (o1.query_end_position_in_read - o1.query_start_position_in_read) + (
        o2.query_end_position_in_read - o2.query_start_position_in_read
    )
    total_t = (o1.target_end_position_in_read - o1.target_start_position_in_read) + (
        o2.target_end_position_in_read - o2.target_start_position_in_read
    )
    return (
        total_q > 0
        and total_t > 0
        and (query_gap / total_q) < 0.2
        and (target_gap / total_t) < 0.2
    )


@dataclasses.dataclass
class OverlapArrays:
    """Struct-of-arrays overlaps — the production-path result format (one
    numpy column per Overlap field; ``rev`` True = '-' strand). The
    reference moves AoS Overlap structs D2H (overlapper.hpp:73); at covid
    scale (~200k overlaps) Python object materialization costs more than
    the device pipeline, so the bench/CLI hot paths stay columnar."""

    query_read_id: np.ndarray
    target_read_id: np.ndarray
    query_start: np.ndarray
    query_end: np.ndarray
    target_start: np.ndarray
    target_end: np.ndarray
    rev: np.ndarray
    num_residues: np.ndarray

    def __len__(self) -> int:
        return int(self.query_read_id.shape[0])

    def to_overlaps(self) -> "list[Overlap]":
        # each column to Python ints at once (the JAX package converts one
        # element at a time)
        cols = [np.asarray(getattr(self, f.name)).tolist() for f in dataclasses.fields(self)]
        return [
            Overlap(qr, tr, qs, qe, ts, te, "-" if rev else "+", res)
            for qr, tr, qs, qe, ts, te, rev, res in zip(*cols)
        ]


def post_process_overlaps_arrays(
    a: OverlapArrays, drop_fused_overlaps: bool = False
) -> OverlapArrays:
    """Vectorized post_process_overlaps over OverlapArrays — identical
    fuse/drop semantics (overlapper.cpp:136-236), numpy segment ops
    instead of a 200k-iteration Python loop."""
    n = len(a)
    if n < 2:
        return a
    qs, qe = a.query_start.astype(np.int64), a.query_end.astype(np.int64)
    ts, te = a.target_start.astype(np.int64), a.target_end.astype(np.int64)
    # mergable[i]: rows i-1 and i (overlapper.cpp:38-100)
    p = slice(0, n - 1)
    c = slice(1, n)
    same = (
        (a.rev[p] == a.rev[c])
        & (a.query_read_id[p] == a.query_read_id[c])
        & (a.target_read_id[p] == a.target_read_id[c])
    )
    query_gap = np.abs(qs[c] - qe[p])
    target_gap = np.where(
        a.rev[c], np.abs(ts[p] - te[c]), np.abs(ts[c] - te[p])
    )
    short = (query_gap < 500) & (target_gap < 500)
    mx = np.maximum(query_gap, target_gap)
    mn = np.minimum(query_gap, target_gap)
    ratio = (mx > 0) & (mn / np.maximum(mx, 1) > 0.8)
    total_q = (qe[p] - qs[p]) + (qe[c] - qs[c])
    total_t = (te[p] - ts[p]) + (te[c] - ts[c])
    rel = (
        (total_q > 0)
        & (total_t > 0)
        & (query_gap / np.maximum(total_q, 1) < 0.2)
        & (target_gap / np.maximum(total_t, 1) < 0.2)
    )
    m = np.zeros(n, dtype=bool)
    m[1:] = same & (short | ratio | rel)

    # maximal runs of consecutive True in m: run [i0..i1] fuses rows
    # i0-1..i1 into one appended overlap inheriting row i1's identity
    starts = np.flatnonzero(m & ~np.concatenate(([False], m[:-1])))
    ends = np.flatnonzero(m & ~np.concatenate((m[1:], [False])))
    if starts.size:
        first = starts - 1
        last = ends
        cres = np.concatenate(([0], np.cumsum(a.num_residues.astype(np.int64))))
        res = cres[last + 1] - cres[first]
        rev_run = a.rev[last]
        fused = OverlapArrays(
            query_read_id=a.query_read_id[last],
            target_read_id=a.target_read_id[last],
            query_start=a.query_start[first],
            query_end=a.query_end[last],
            target_start=np.where(
                rev_run, a.target_start[last], a.target_start[first]
            ),
            target_end=np.where(
                rev_run, a.target_end[first], a.target_end[last]
            ),
            rev=rev_run,
            num_residues=res.astype(a.num_residues.dtype),
        )
    else:
        fused = None

    if drop_fused_overlaps:
        keep = ~(m | np.concatenate((m[1:], [False])))
    else:
        keep = np.ones(n, dtype=bool)

    def cat(f):
        base = getattr(a, f)[keep]
        if fused is None:
            return base
        return np.concatenate((base, getattr(fused, f)))

    return OverlapArrays(**{
        f.name: cat(f.name) for f in dataclasses.fields(OverlapArrays)
    })


def post_process_overlaps(overlaps: list[Overlap], drop_fused_overlaps: bool = False) -> list[Overlap]:
    """Fuse runs of mergeable adjacent overlaps, appending the fused copies
    (reference: Overlapper::post_process_overlaps, overlapper.cpp:136-236).
    Returns a new list; with drop_fused_overlaps the constituent overlaps
    are removed."""
    overlaps = list(overlaps)
    num = len(overlaps)
    in_fuse = False
    fused_q_start = fused_q_end = fused_t_start = fused_t_end = None
    num_residues = 0
    drop_mask = [False] * num
    appended: list[Overlap] = []
    prev = None
    for i in range(1, num):
        prev = overlaps[i - 1]
        cur = overlaps[i]
        if _overlaps_mergable(prev, cur):
            drop_mask[i] = True
            drop_mask[i - 1] = True
            if not in_fuse:
                num_residues = prev.num_residues + cur.num_residues
                in_fuse = True
                fused_q_start = prev.query_start_position_in_read
                fused_q_end = cur.query_end_position_in_read
                if cur.relative_strand == "+":
                    fused_t_start = prev.target_start_position_in_read
                    fused_t_end = cur.target_end_position_in_read
                else:
                    fused_t_start = cur.target_start_position_in_read
                    fused_t_end = prev.target_end_position_in_read
            else:
                num_residues += cur.num_residues
                fused_q_end = cur.query_end_position_in_read
                if cur.relative_strand == "+":
                    fused_t_end = cur.target_end_position_in_read
                else:
                    fused_t_start = cur.target_start_position_in_read
        else:
            if in_fuse:
                in_fuse = False
                appended.append(
                    dataclasses.replace(
                        prev,
                        query_start_position_in_read=fused_q_start,
                        query_end_position_in_read=fused_q_end,
                        target_start_position_in_read=fused_t_start,
                        target_end_position_in_read=fused_t_end,
                        num_residues=num_residues,
                    )
                )
                num_residues = 0
    if in_fuse:
        appended.append(
            dataclasses.replace(
                prev,
                query_start_position_in_read=fused_q_start,
                query_end_position_in_read=fused_q_end,
                target_start_position_in_read=fused_t_start,
                target_end_position_in_read=fused_t_end,
                num_residues=num_residues,
            )
        )
    result = overlaps + appended
    if drop_fused_overlaps:
        result = [o for i, o in enumerate(result) if i >= num or not drop_mask[i]]
    return result


def filter_overlaps(
    overlaps: list[Overlap],
    min_residues: int = 20,
    min_overlap_len: int = 50,
) -> list[Overlap]:
    """Drop overlaps unlikely to be real (reference:
    Overlapper::filter_overlaps, overlapper.hpp:92 + overlapper.cpp)."""
    out = []
    for o in overlaps:
        if o.num_residues < min_residues:
            continue
        if (o.query_end_position_in_read - o.query_start_position_in_read) < min_overlap_len:
            continue
        out.append(o)
    return out


def extend_overlap_by_sequence_similarity(
    overlap: Overlap,
    query_sequence: str,
    target_sequence: str,
    extension: int,
    required_similarity: float,
) -> Overlap:
    """Extend one overlap's head/tail when the flanking query and target
    sequence windows are kmer-Jaccard similar (reference:
    details::overlapper::extend_overlap_by_sequence_similarity,
    overlapper.cpp:263-302). Returns the (possibly) extended overlap."""
    from genomeworks_tpu_torch.mapper.kmers import sequence_jaccard_similarity

    qs = overlap.query_start_position_in_read
    qe = overlap.query_end_position_in_read
    ts = overlap.target_start_position_in_read
    te = overlap.target_end_position_in_read

    head = min(min(qs, extension), min(ts, extension))
    if head > 0:
        q_head = query_sequence[qs - head : qs]
        t_head = target_sequence[ts - head : ts]
        if sequence_jaccard_similarity(q_head, t_head, 15, 1) >= required_similarity:
            qs -= head
            ts -= head

    tail = min(
        min(extension, len(query_sequence) - qe),
        min(extension, len(target_sequence) - te),
    )
    if tail > 0:
        q_tail = query_sequence[qe : qe + tail]
        t_tail = target_sequence[te : te + tail]
        if sequence_jaccard_similarity(q_tail, t_tail, 15, 1) >= required_similarity:
            qe += tail
            te += tail

    return dataclasses.replace(
        overlap,
        query_start_position_in_read=qs,
        query_end_position_in_read=qe,
        target_start_position_in_read=ts,
        target_end_position_in_read=te,
    )


def _reverse_overlap(o: Overlap, target_len: int) -> Overlap:
    """Flip an overlap's strand, mirroring target coordinates
    (overlapper.cpp:310-316)."""
    return dataclasses.replace(
        o,
        relative_strand="-" if o.relative_strand == "+" else "+",
        target_start_position_in_read=target_len - o.target_end_position_in_read,
        target_end_position_in_read=target_len - o.target_start_position_in_read,
    )


def rescue_overlap_ends(
    overlaps: list[Overlap],
    query_parser,
    target_parser,
    extension: int = 50,
    required_similarity: float = 0.9,
) -> list[Overlap]:
    """Extend overlap ends by flanking-sequence similarity, up to 3 rounds
    per overlap (reference: Overlapper::rescue_overlap_ends,
    overlapper.cpp:304-373). Reverse-strand overlaps are rescued in
    forward orientation against the reverse-complemented target."""
    from genomeworks_tpu_torch.core.sequence import reverse_complement

    out: list[Overlap] = []
    for o in overlaps:
        query_sequence = query_parser.get_sequence_by_id(o.query_read_id).seq
        target_sequence = target_parser.get_sequence_by_id(o.target_read_id).seq
        reversed_ = False
        if o.relative_strand == "-":
            o = _reverse_overlap(o, len(target_sequence))
            target_sequence = reverse_complement(target_sequence)
            reversed_ = True

        for _ in range(3):  # max_rescue_rounds (overlapper.cpp:345)
            prev = (
                o.query_start_position_in_read,
                o.query_end_position_in_read,
                o.target_start_position_in_read,
                o.target_end_position_in_read,
            )
            o = extend_overlap_by_sequence_similarity(
                o, query_sequence, target_sequence, extension, required_similarity
            )
            if prev == (
                o.query_start_position_in_read,
                o.query_end_position_in_read,
                o.target_start_position_in_read,
                o.target_end_position_in_read,
            ):
                break

        if reversed_:
            o = _reverse_overlap(o, len(target_sequence))
        out.append(o)
    return out
