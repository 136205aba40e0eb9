"""Banded global alignment (unit-cost edit distance): band coordinates, the
plain PyTorch forward pass, and the packed code planes.

Counterpart of genomeworks_tpu/aligner/banded_nw.py (the XLA scan) and of
the plane layout of genomeworks_tpu/ops/banded_nw_pallas.py. The CUDA
kernel is ``ops/banded_nw_cuda.py`` (``csrc/banded_nw.cu``);
:func:`banded_nw_forward_plain` is its plain version, and
:func:`banded_nw_final_plain` that of its launch with the distance output.
:func:`banded_nw_forward` is the public counterpart of the JAX
``banded_nw_forward`` (distance, move codes in the JAX layout, fits).

Band coordinates: k = j - i - dlo, with the per-alignment lowest diagonal
``dlo = min(0, tlen - qlen) - (W - 1 - |tlen - qlen|) // 2``, so both ends of
the global path are in the band whenever W >= |tlen - qlen| + 1 (``fits``).

Code planes: int32 (B, M16, W) with M16 = ceil(M / 16). The 2-bit
AlignmentState code (0 match, 1 mismatch, 2 insertion, 3 deletion) of DP row
i (1-based) and band column k sits in word (i - 1) // 16, column k, at bits
2 * ((i - 1) % 16). Row 16 of a word reaches the sign bit.
"""

from __future__ import annotations

import numpy as np
import torch

ROWS_PER_WORD = 16
INF = 1 << 24


def band_offset(qlen, tlen, band_width: int):
    """Per-alignment lowest band diagonal dlo (banded_nw.py:45). Takes and
    returns NumPy arrays or torch tensors alike."""
    diff = tlen - qlen
    extra = (band_width - 1 - abs(diff)) // 2
    if isinstance(diff, torch.Tensor):
        return torch.minimum(torch.zeros_like(diff), diff) - extra
    return np.minimum(0, diff) - extra


def num_words(M: int) -> int:
    """Plane words per band column for M DP rows."""
    return (M + ROWS_PER_WORD - 1) // ROWS_PER_WORD


def banded_nw_forward_plain(q, t, qlen, tlen, band_width: int):
    """The banded DP of banded_nw.py:53-133 over all M rows, batched over
    alignments: q uint8 (B, M), t uint8 (B, N) base codes (padded); qlen,
    tlen int32 (B,) -> (codes int32 (B, M16, W), fits bool (B,)).

    Same math and tie-breaks: INF outside j in [0, tlen] before the
    insertion closure ``cur[k] = k + cummin(base[k] - k)`` (clamped to
    INF); j == 0 is i; insertion before deletion before match/mismatch.
    Rows past qlen are computed like any other (from the padded query), as
    the JAX scan does, so the whole tensor is defined. Target bases are
    read at the clipped column t[clip(j - 1, 0, N - 1)]."""
    banded_nw_forward_plain.calls += 1
    return _forward_plain(q, t, qlen, tlen, band_width)[1:]


banded_nw_forward_plain.calls = 0


def banded_nw_final_plain(q, t, qlen, tlen, band_width: int):
    """:func:`banded_nw_forward_plain` with the edit distance: -> (final
    int32 (B,), codes, fits). ``final`` is the JAX scan's: D(qlen, tlen),
    tlen where qlen == 0, INF where the pair does not fit the band (or
    qlen > M)."""
    banded_nw_final_plain.calls += 1
    return _forward_plain(q, t, qlen, tlen, band_width)


banded_nw_final_plain.calls = 0


def _forward_plain(q, t, qlen, tlen, band_width: int):
    B, M = q.shape
    N = t.shape[1]
    W = band_width
    dev = q.device
    qlen = qlen.to(torch.int64)
    tlen = tlen.to(torch.int64)
    dlo = band_offset(qlen, tlen, W)
    fits = W >= (tlen - qlen).abs() + 1
    k = torch.arange(W, device=dev, dtype=torch.int64)[None, :]
    inf = torch.tensor(INF, device=dev, dtype=torch.int64)
    q64 = q.to(torch.int64)
    t64 = t.to(torch.int64)
    # the final cell's band column (inside the band wherever the pair fits)
    k_end = (tlen - qlen - dlo).clamp(0, W - 1)[:, None]
    final = torch.where(qlen == 0, tlen, inf)

    j0 = dlo[:, None] + k
    prev = torch.where((j0 >= 0) & (j0 <= tlen[:, None]), j0, inf)
    codes = torch.zeros((B, num_words(M), W), dtype=torch.int32, device=dev)
    pad_inf = torch.full((B, 1), INF, device=dev, dtype=torch.int64)
    for i in range(1, M + 1):
        j = i + dlo[:, None] + k
        tj = torch.gather(t64, 1, (j - 1).clamp(0, N - 1))
        sub = (q64[:, i - 1 : i] != tj).to(torch.int64)
        up = torch.cat([prev[:, 1:], pad_inf], dim=1) + 1
        base = torch.minimum(prev + sub, up)
        base = torch.where(j == 0, torch.full_like(base, i), base)
        base = torch.where((j < 0) | (j > tlen[:, None]), inf, base)
        cur = torch.minimum(k + torch.cummin(base - k, dim=1).values, inf)
        left_p1 = torch.cat([pad_inf, cur[:, :-1]], dim=1) + 1
        code = torch.where(cur == left_p1, 2, torch.where(cur == up, 3, sub))
        r = (i - 1) % ROWS_PER_WORD
        codes[:, (i - 1) // ROWS_PER_WORD, :] |= code.to(torch.int32) << (2 * r)
        final = torch.where(qlen == i, torch.gather(cur, 1, k_end)[:, 0], final)
        prev = cur
    final = torch.where(fits, final, inf).to(torch.int32)
    return final, codes, fits


def unpack_codes(codes, M: int):
    """Code planes int32 (B, M16, W) -> the JAX scan's move codes, uint8
    (M, B, W) (row i - 1 of the DP first), on the planes' device."""
    B, M16, W = codes.shape
    shifts = 2 * torch.arange(ROWS_PER_WORD, device=codes.device, dtype=torch.int32)
    rows = (codes[:, :, None, :] >> shifts[None, None, :, None]) & 3
    return rows.reshape(B, M16 * ROWS_PER_WORD, W)[:, :M].permute(1, 0, 2).to(torch.uint8)


def banded_nw_forward(q, t, qlen, tlen, band_width: int, device=None):
    """The banded DP of genomeworks_tpu/aligner/banded_nw.py:53-133 on
    ``device`` (``None`` = the CUDA card): q uint8 (B, M), t uint8 (B, N)
    base codes (padded), qlen, tlen int32 (B,), as tensors or NumPy arrays
    -> (final int32 (B,), codes uint8 (M, B, W), fits bool (B,)), the JAX
    triple: ``final`` the edit distance (INF where the pair does not fit),
    ``codes`` each cell's AlignmentState move code. On the card it runs
    the banded NW kernel (``ops/banded_nw_cuda.py``) with its distance
    output; on the CPU its plain version."""
    from genomeworks_tpu_torch.core.device import resolve_device
    from genomeworks_tpu_torch.ops import banded_nw_cuda as nw_op

    dev = resolve_device(device)
    q, t = (torch.as_tensor(x, dtype=torch.uint8).to(dev).contiguous() for x in (q, t))
    qlen, tlen = (torch.as_tensor(x, dtype=torch.int32).to(dev).contiguous()
                  for x in (qlen, tlen))
    final, codes, fits = nw_op.banded_nw_cuda(q, t, qlen, tlen, band_width, with_dist=True)
    return final, unpack_codes(codes, q.shape[1]), fits


def planes_from_numpy(codes_np: np.ndarray, device) -> torch.Tensor:
    """A (B, M16, W) int32 plane of the JAX package (``myers_banded_codes``,
    ``banded_nw_forward_pallas``, or the packed ``banded_nw_forward``
    codes) as a contiguous tensor on ``device``, bit for bit."""
    a = np.asarray(codes_np)
    if a.ndim != 3:
        raise ValueError(f"code planes must be (B, M16, W), got shape {a.shape}")
    if a.dtype not in (np.int32, np.uint32):
        raise TypeError(f"code planes must be int32, got {a.dtype}")
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


def planes_to_numpy(codes: torch.Tensor) -> np.ndarray:
    """The inverse of :func:`planes_from_numpy`: int32 (B, M16, W) on the
    host."""
    if codes.dim() != 3:
        raise ValueError(f"code planes must be (B, M16, W), got {tuple(codes.shape)}")
    if codes.dtype != torch.int32:
        raise TypeError(f"code planes must be int32, got {codes.dtype}")
    return codes.detach().cpu().contiguous().numpy()

