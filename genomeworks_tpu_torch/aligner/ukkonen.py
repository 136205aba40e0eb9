"""Ukkonen banded global alignment (CPU).

A copy of genomeworks_tpu/aligner/ukkonen.py (NumPy only).

Reference: cudaaligner/src/ukkonen_cpu.cpp / ukkonen_gpu.cu — the legacy
banded aligner where the band is sized from the query/target length
difference plus an extra radius ``p`` (aligner_global_ukkonen.cpp). The
reference stores the matrix in interleaved diagonal-band coordinates as a
GPU-memory optimization; this implementation keeps the same band
semantics (cells with |j - i - (n - m)/...| outside the band are never
computed; results equal full NW whenever the optimal path stays in band)
in plain banded row storage.

State codes follow cudaaligner.hpp AlignmentState: 0 match, 1 mismatch,
2 insertion (consumes target), 3 deletion (consumes query).
"""

from __future__ import annotations

import numpy as np

BIG = np.iinfo(np.int32).max // 2


def ukkonen_cpu(query: str, target: str, p: int = 16) -> np.ndarray:
    """Banded edit-distance alignment; returns forward-order state codes.
    Band half-width = |len(target) - len(query)| + p diagonals around the
    main diagonal (ukkonen band sizing, aligner_global_ukkonen.cpp)."""
    m, n = len(query), len(target)
    if m == 0:
        return np.full(n, 2, dtype=np.int8)
    if n == 0:
        return np.full(m, 3, dtype=np.int8)

    bw = abs(n - m) + 2 * p + 1  # diagonals j - i in [lo, lo + bw)
    lo = min(0, n - m) - p

    # scores[i, d] = D[i][j] with d = j - i - lo
    scores = np.full((m + 1, bw), BIG, dtype=np.int32)
    q = np.frombuffer(query.encode("latin1"), dtype=np.uint8)
    t = np.frombuffer(target.encode("latin1"), dtype=np.uint8)

    for d in range(bw):
        j = 0 + d + lo
        if 0 <= j <= n:
            scores[0, d] = j
    for i in range(1, m + 1):
        dlo = max(0, -(i + lo))
        dhi = min(bw, n - i - lo + 1)
        for d in range(dlo, dhi):
            j = i + d + lo
            if j == 0:
                scores[i, d] = i
                continue
            best = BIG
            # diagonal: D[i-1][j-1] is the SAME band column of row i-1
            if scores[i - 1, d] < BIG:
                best = scores[i - 1, d] + (0 if q[i - 1] == t[j - 1] else 1)
            # deletion: D[i-1][j] is band column d+1 of row i-1
            if d + 1 < bw and scores[i - 1, d + 1] < BIG:
                best = min(best, scores[i - 1, d + 1] + 1)
            # insertion: D[i][j-1] is band column d-1 of row i
            if d - 1 >= 0 and scores[i, d - 1] < BIG:
                best = min(best, scores[i, d - 1] + 1)
            scores[i, d] = best

    # backtrace (ukkonen_backtrace, ukkonen_cpu.cpp:95-150: prefers
    # diagonal, then vertical (deletion), then horizontal (insertion))
    states = []
    i, j = m, n
    while i > 0 and j > 0:
        d = j - i - lo
        cur = scores[i, d]
        sub = 0 if q[i - 1] == t[j - 1] else 1
        if scores[i - 1, d] < BIG and cur == scores[i - 1, d] + sub:
            states.append(sub)  # 0 match / 1 mismatch
            i -= 1
            j -= 1
        elif d + 1 < bw and scores[i - 1, d + 1] < BIG and cur == scores[i - 1, d + 1] + 1:
            states.append(3)  # deletion (consumes query)
            i -= 1
        else:
            states.append(2)  # insertion (consumes target)
            j -= 1
    while i > 0:
        states.append(3)
        i -= 1
    while j > 0:
        states.append(2)
        j -= 1
    return np.array(states[::-1], dtype=np.int8)


def ukkonen_edit_distance_cpu(query: str, target: str, p: int = 16) -> int:
    """Banded edit distance (exact when the optimal distance <= band)."""
    states = ukkonen_cpu(query, target, p)
    return int(np.count_nonzero(states != 0))
