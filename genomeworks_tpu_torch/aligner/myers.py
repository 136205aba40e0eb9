"""Myers bit-vector edit distance.

Reference: cudaaligner/src/myers_cpu.hpp (CPU oracle) and myers_gpu.cu
(warp-cooperative PV/MV word chains). The bit-parallel recurrence packs 32
DP cells per machine word, advancing one target character per step with a
carry rippling across the query's word blocks (myers_advance_block,
myers_cpu.hpp:36-66).

The counterpart of genomeworks_tpu/aligner/myers.py:
- ``myers_edit_distance_cpu``: NumPy port of the reference CPU oracle,
  bit-exact semantics, used as the golden reference in tests (a copy);
- ``myers_edit_distance_batched``: the batched variant, edit distance
  only. On the card each alignment is one thread of ``myers_score_kernel``
  (``ops/myers_score_cuda.py``, ``csrc/myers_score.cu``); on the CPU its
  plain version ``myers_score_plain`` runs, the recurrence of the JAX
  package's ``_myers_scan`` as a loop over target positions and query
  words on (B,) tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from genomeworks_tpu_torch.core.device import resolve_device
from genomeworks_tpu_torch.core.sequence import encode_bases, pack_reads
from genomeworks_tpu_torch.ops import myers_score_cuda as _score

WORD = 32
M32 = (1 << 32) - 1


def _preprocess_peq(query: str) -> np.ndarray:
    """peq[c, w] = bitmask of query positions in word w equal to base c
    (myers_preprocess, myers_cpu.hpp:68-80). Rows indexed by 2-bit code."""
    q = encode_bases(query)
    n_words = (len(q) + WORD - 1) // WORD
    peq = np.zeros((4, n_words), dtype=np.uint32)
    for i, code in enumerate(q):
        peq[code, i // WORD] |= np.uint32(1) << np.uint32(i % WORD)
    return peq


def myers_edit_distance_cpu(target: str, query: str) -> int:
    """Edit distance via the reference's word-chain recurrence
    (myers_compute_edit_distance, myers_cpu.hpp:82-134)."""
    query_size = len(query)
    if query_size == 0:
        return len(target)
    n_words = (query_size + WORD - 1) // WORD
    peq = _preprocess_peq(query)
    t_codes = encode_bases(target)

    pv = np.full(n_words, 0xFFFFFFFF, dtype=np.uint32)
    mv = np.zeros(n_words, dtype=np.uint32)
    score = np.array(
        [min((i + 1) * WORD, query_size) for i in range(n_words)], dtype=np.int64
    )
    hmask = np.array(
        [
            np.uint32(1)
            << np.uint32(
                WORD - 1 if i < n_words - 1 else query_size - (n_words - 1) * WORD - 1
            )
            for i in range(n_words)
        ],
        dtype=np.uint32,
    )

    one = np.uint32(1)
    with np.errstate(over="ignore"):  # uint32 wraparound is the algorithm
        for tc in t_codes:
            # carry 1 = global alignment: the implicit first row is 0,1,2,...
            # (myers_gpu.cu:414-416; the reference's CPU oracle passes 0
            # there, i.e. the semi-global matching variant — we keep global
            # semantics to match the Aligner contract)
            carry = 1
            for i in range(n_words):
                eq = peq[tc, i]
                p, m = pv[i], mv[i]
                xv = eq | m
                if carry < 0:
                    eq = eq | one
                xh = (((eq & p) + p) ^ p) | eq
                ph = m | ~(xh | p)
                mh = p & xh
                carry_out = (1 if (ph & hmask[i]) else 0) - (
                    1 if (mh & hmask[i]) else 0
                )
                ph = np.uint32((int(ph) << 1) & 0xFFFFFFFF)
                mh = np.uint32((int(mh) << 1) & 0xFFFFFFFF)
                if carry < 0:
                    mh |= one
                if carry > 0:
                    ph |= one
                pv[i] = mh | ~(xv | ph)
                mv[i] = ph & xv
                carry = carry_out
                score[i] += carry
    return int(score[-1])


def myers_score_plain(peq, t_codes, qlen, tlen):
    """The batched word chain of genomeworks_tpu/aligner/myers.py
    ``_myers_scan``: peq int32 (B, 4, n_words), the bits of each query's
    uint32 Peq words (row = 2-bit base code); t_codes uint8 (B, T) codes
    0-3; qlen, tlen int32 (B,) -> int32 (B,): per alignment, qlen plus the
    carries out of its last word (bit qlen - 1) over target positions t <
    tlen; each step's carry into word 0 is 1 (the global top row). Words
    past the last are not computed. Words are uint32 values in int64."""
    myers_score_plain.calls += 1
    B, _, n_words = peq.shape
    T = t_codes.shape[1]
    dev = peq.device
    peq = peq.to(torch.int64) & M32
    qlen = qlen.to(torch.int64)
    tlen = tlen.to(torch.int64)
    last = torch.clamp(torch.div(qlen - 1, WORD, rounding_mode="floor"), min=0)
    w = torch.arange(n_words, device=dev)
    hbit = torch.where(w[None, :] < last[:, None], WORD - 1,
                       (qlen[:, None] - 1 - last[:, None] * WORD).clamp(0, WORD - 1))
    hmask = torch.ones_like(hbit) << hbit
    active = w[None, :] <= last[:, None]
    pv = torch.full((B, n_words), M32, dtype=torch.int64, device=dev)
    mv = torch.zeros((B, n_words), dtype=torch.int64, device=dev)
    score = qlen.clone()
    codes = t_codes.to(torch.int64)
    for t in range(T):
        eq_all = peq.gather(1, codes[:, t, None, None].expand(B, 1, n_words))[:, 0, :]
        cin = torch.ones(B, dtype=torch.int64, device=dev)
        step = t < tlen
        for i in range(n_words):
            eq, p, m = eq_all[:, i], pv[:, i], mv[:, i]
            xv = eq | m
            eq = torch.where(cin < 0, eq | 1, eq)
            xh = ((((eq & p) + p) & M32) ^ p) | eq
            ph = (m | ~(xh | p)) & M32
            mh = p & xh
            hm = hmask[:, i]
            cout = (ph & hm != 0).to(torch.int64) - (mh & hm != 0).to(torch.int64)
            ph = ((ph << 1) & M32) | (cin > 0).to(torch.int64)
            mh = ((mh << 1) & M32) | (cin < 0).to(torch.int64)
            act = active[:, i] & step
            pv[:, i] = torch.where(act, (mh | ~(xv | ph)) & M32, p)
            mv[:, i] = torch.where(act, ph & xv, m)
            score += torch.where(act & (last == i), cout, 0)
            cin = torch.where(act, cout, 0)
    return score.to(torch.int32)


myers_score_plain.calls = 0


def myers_inputs(queries: list[str], targets: list[str]):
    """The batch of ``myers_edit_distance_batched`` as NumPy arrays: peq
    uint32 (B, 4, n_words) (an empty query's words zero), t_codes uint8
    (B, tmax), qlen and tlen int32 (B,)."""
    B = len(queries)
    if len(targets) != B:
        raise ValueError(f"{B} queries but {len(targets)} targets")
    qmax = max((len(q) for q in queries), default=1)
    tmax = max((len(t) for t in targets), default=1)
    n_words = max(1, (qmax + WORD - 1) // WORD)

    peq = np.zeros((B, 4, n_words), dtype=np.uint32)
    qlen = np.zeros(B, dtype=np.int32)
    for b, q in enumerate(queries):
        # _preprocess_peq's words, set in one pass: bit i % 32 of word i // 32
        # in the row of base i's code
        i = np.arange(len(q))
        np.bitwise_or.at(peq[b], (encode_bases(q), i // WORD),
                         np.left_shift(np.uint32(1), (i % WORD).astype(np.uint32)))
        qlen[b] = len(q)
    t_codes, tlen = pack_reads(list(targets), max_len=tmax)
    return peq, t_codes, qlen, tlen


def myers_edit_distance_batched(queries: list[str], targets: list[str],
                                device: str | torch.device | None = None) -> np.ndarray:
    """Batched bit-parallel edit distances. Returns (B,) int32.
    ``device=None`` is the CUDA card and raises without one."""
    dev = resolve_device(device)
    peq, t_codes, qlen, tlen = myers_inputs(queries, targets)
    out = _score.myers_score_cuda(
        torch.from_numpy(peq.view(np.int32)).to(dev), torch.from_numpy(t_codes).to(dev),
        torch.from_numpy(qlen).to(dev), torch.from_numpy(tlen).to(dev))
    dist = out.cpu().numpy()
    # empty-query convention (myers_cpu.hpp:88-89)
    for b, q in enumerate(queries):
        if len(q) == 0:
            dist[b] = len(targets[b])
    return dist
