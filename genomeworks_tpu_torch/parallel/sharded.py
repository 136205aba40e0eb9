"""Multi-device execution of the compute pipelines, one rank per device.

Counterpart of genomeworks_tpu/parallel/sharded.py. The reference scales
out with one CPU worker thread per GPU pulling work from a shared queue
(cudamapper/src/main.cu:453-594). Here every rank of a
``torch.distributed`` group (``parallel.mesh.Mesh``) holds the whole input,
takes its contiguous slice of the batch, runs the kernel on its own device
and gathers the results in rank order, so every rank returns the whole
batch's answer, equal to one device's:

- POA: the per-window kernel (``ops/poa_cuda.poa_consensus_cuda``) on the
  rank's windows;
- the aligner's forward step: the banded NW kernel with its distance output
  (``aligner.banded_nw.banded_nw_forward``);
- the mapper's anchor counts: ``torch.searchsorted`` on the rank's shard
  and an all-reduce.

With no group the mesh is one rank and no collective runs.
"""

from __future__ import annotations

import numpy as np
import torch

from genomeworks_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    all_reduce_sum,
    make_mesh,
    shard_batch,
    shard_range,
)


def _pad_windows(windows, n_shards):
    """Pad the window list so the batch splits evenly over the ranks.
    Padding windows (``["A"]``) are masked out: their read count is zeroed,
    and no kernel slot runs them."""
    pad = (-len(windows)) % n_shards
    return windows + [["A"]] * pad, len(windows)


def poa_batch_consensus_sharded(
    windows: list[list[str]],
    mesh: Mesh | None = None,
    gap: int = -8,
    mismatch: int = -6,
    match: int = 8,
) -> tuple[list[str], list, list[int]]:
    """Data-parallel full-band POA consensus: each rank runs the per-window
    kernel on its slice of the window batch (the plain chain on the CPU),
    and the outputs are gathered to every rank.

    The caps are the JAX package's, computed from the whole list on every
    rank so that the ranks' tensors agree in shape: L the longest read
    rounded up to 64, S the most reads rounded up to even (at least 2),
    N = 3 L, E = A = 50. Returns (consensus list, coverage list, status
    list; 0 = success)."""
    from genomeworks_tpu_torch.ops.poa_cuda import poa_consensus_cuda
    from genomeworks_tpu_torch.poa.torch_poa import decode_consensus, pack_windows

    if mesh is None:
        mesh = make_mesh()
    windows_p, n_real = _pad_windows(windows, mesh.size)
    Lmax = max(max(len(s) for s in w) for w in windows_p)
    Smax = max(len(w) for w in windows_p)
    L = ((Lmax + 63) // 64) * 64
    S = max(2, ((Smax + 1) // 2) * 2)
    N = 3 * L

    lo, hi = shard_range(mesh, len(windows_p))
    # the pads lie past n_real: a rank launches only its real windows (the
    # kernel takes no window without reads) and leaves the pads' rows zero
    n_mine = max(0, min(hi, n_real) - lo)
    dev = mesh.device
    cons = torch.zeros((hi - lo, N), dtype=torch.uint8, device=dev)
    cov = torch.zeros((hi - lo, N), dtype=torch.int32, device=dev)
    length = torch.zeros(hi - lo, dtype=torch.int32, device=dev)
    err = torch.zeros(hi - lo, dtype=torch.int32, device=dev)
    if n_mine:
        seqs, wts, lens, nseqs, _ = pack_windows(windows_p[lo : lo + n_mine], None, N)
        b, s, l_ = seqs.shape
        seqs = np.pad(seqs, ((0, 0), (0, S - s), (0, L - l_)))
        wts = np.pad(wts, ((0, 0), (0, S - s), (0, L - l_)), constant_values=1)
        lens = np.pad(lens, ((0, 0), (0, S - s)))
        out = poa_consensus_cuda(
            *(torch.from_numpy(a).to(dev) for a in (seqs, wts, lens, nseqs)),
            N=N, E=50, A=50, gap=gap, mismatch=mismatch, match=match,
        )
        for dst, src in zip((cons, cov, length, err), out):
            dst[:n_mine] = src
    gathered = [all_gather_rows(mesh, x) for x in (cons, cov, length, err)]
    return decode_consensus(*(x[:n_real] for x in gathered))


def aligner_step_sharded(mesh: Mesh, q, t, qlen, tlen, band_width: int):
    """The aligner's banded forward step with the batch split over the
    ranks (its batch a multiple of the mesh size): each rank runs
    ``banded_nw_forward`` on its slice, and every rank gets the whole
    batch's (final int32 (B,), codes uint8 (M, B, W), fits bool (B,)) on
    ``mesh.device``, the batch dim where the JAX package has it."""
    from genomeworks_tpu_torch.aligner.banded_nw import banded_nw_forward

    q, t, qlen, tlen = shard_batch(mesh, q, t, qlen, tlen)
    final, codes, fits = banded_nw_forward(q, t, qlen, tlen, band_width, device=mesh.device)
    final = all_gather_rows(mesh, final)
    fits = all_gather_rows(mesh, fits.to(torch.uint8)).to(torch.bool)
    codes = all_gather_rows(mesh, codes.permute(1, 0, 2).contiguous()).permute(1, 0, 2)
    return final, codes, fits


def _my_shard(mesh: Mesh, x):
    x = torch.as_tensor(x)
    lo, hi = shard_range(mesh, x.shape[0])
    return x[lo:hi].to(mesh.device)


def anchor_count_allreduce(mesh: Mesh, per_shard_counts):
    """The sum of a count array over the ranks, shaped (1,): each rank sums
    its slice of the (global) array and the sums are all-reduced, so every
    rank holds the total."""
    x = _my_shard(mesh, per_shard_counts)
    return all_reduce_sum(mesh, x.sum(dtype=x.dtype).reshape(1))


def matcher_sharded_counts(mesh: Mesh, q_reps, t_reps):
    """Sharded anchor-match counting: each rank searchsorts its slice of the
    query representations in the (whole, sorted) target representations,
    and the match counts are all-reduced: int64, shaped (1,). (The
    multi-device analogue of find_query_target_matches_kernel,
    cudamapper/src/matcher_gpu.cuh:204.)"""
    q = _my_shard(mesh, q_reps)
    t = torch.as_tensor(t_reps).to(mesh.device)
    q = q.to(t.dtype)
    lo = torch.searchsorted(t, q, side="left")
    hi = torch.searchsorted(t, q, side="right")
    return all_reduce_sum(mesh, (hi - lo).sum().reshape(1))
