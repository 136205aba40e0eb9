"""(k,w)-minimizer sketching on PyTorch: the counterpart of
genomeworks_tpu/mapper/minimizers.py (reference: cudamapper/src/minimizer.cu).

Reference semantics reproduced exactly (bit parity with the reference unit
tests in cudamapper/tests/Test_CudamapperMinimizer.cpp):

- base codes A=0 C=1 G=2 T=3 (minimizer.cu:197), complement = 3-code;
- forward k-mer packs bases MSB-first, reverse complement packs complement
  codes LSB-first (minimizer.cu:232-233);
- optional wang_hash64 with a 32-bit mask (minimizer.cu:67-78);
- representation = min(forward, reverse), direction = 1 iff reverse < fwd
  (minimizer.cu:242-250);
- windows: front-end windows over k-mer prefixes of lengths 1..w-1, all
  central windows of w k-mers, back-end windows over suffixes of the last
  w-1..1 k-mers, unified as one sliding w-window over the k-mer array
  padded with w-1 sentinels on each side;
- per window the *rightmost* minimal representation wins
  (minimizer.cu:280-286 uses <=);
- consecutive windows sharing the same minimizer position emit one sketch
  element (minimizer.cu:293-335).

Representations are uint32 values held in int64 tensors, masked to 32 bits
after every step of the hash (PyTorch has few uint32 ops on CUDA). In int64
the sentinel ``INVALID_REP`` = 0xFFFFFFFF already sorts after every other
value, so no order-preserving map to int32 is needed.
"""

from __future__ import annotations

import numpy as np
import torch

#: sentinel for invalid/padding representations
INVALID_REP = np.uint32(0xFFFFFFFF)

_MASK32 = 0xFFFFFFFF


def wang_hash32(key: torch.Tensor) -> torch.Tensor:
    """wang_hash64 with 32-bit mask (minimizer.cu:67-78) on uint32 values held
    in int64: every step reduced mod 2^32, no step past 2^63."""
    key = key.to(torch.int64) & _MASK32
    key = ((~key) + (key << 21)) & _MASK32
    key = key ^ (key >> 24)
    key = ((key + (key << 3)) + (key << 8)) & _MASK32
    key = key ^ (key >> 14)
    key = ((key + (key << 2)) + (key << 4)) & _MASK32
    key = key ^ (key >> 28)
    # key << 31 mod 2^32 is bit 0 of key moved to bit 31
    return (key + ((key & 1) << 31)) & _MASK32


def pack_2bit(reads: np.ndarray) -> np.ndarray:
    """(B, L) uint8 base codes -> (B, ceil(L/4)) packed bytes (base i at bits
    2*(i%4)); :func:`compute_sketch` unpacks them on the device."""
    B, L = reads.shape
    if L % 4:
        reads = np.pad(reads, ((0, 0), (0, 4 - L % 4)))
    r = reads.reshape(B, -1, 4).astype(np.uint16)
    return (
        r[:, :, 0] | (r[:, :, 1] << 2) | (r[:, :, 2] << 4) | (r[:, :, 3] << 6)
    ).astype(np.uint8)


def compute_sketch(
    reads,  # (B, L) uint8 base codes, or (B, L/4) packed 2-bit
    lengths,  # (B,) int32
    k: int,
    w: int,
    hash_representations: bool = True,
    packed: bool = False,
    device: str | torch.device | None = None,
):
    """Compute minimizer sketch elements for a batch of reads on ``device``
    (``None`` = the CUDA card; arrays or tensors in).

    Returns per-read tensors of length Pw = L-k+1 + (w-1):
      reps (B, Pw) int64 (uint32 values), positions (B, Pw) int32,
      directions (B, Pw) int32, emit (B, Pw) bool: one slot per window, True
      where that window emits a (deduplicated) sketch element.

    Reads shorter than w+k-1 emit nothing (reference skips them,
    index_gpu.cuh:835).
    """
    from genomeworks_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    reads = torch.as_tensor(reads).to(dev)
    lengths = torch.as_tensor(lengths).to(dev, torch.int64)
    if packed:
        B, L4 = reads.shape
        r8 = reads.to(torch.int64)
        reads = torch.stack([(r8 >> (2 * i)) & 3 for i in range(4)], dim=2).reshape(B, 4 * L4)
    B, L = reads.shape
    P = L - k + 1  # number of k-mer start positions (padded)
    if P <= 0:
        raise ValueError(f"reads too short for k={k}")
    n_kmers = lengths - (k - 1)  # valid k-mers per read

    r64 = reads.to(torch.int64)
    fwd = torch.zeros((B, P), dtype=torch.int64, device=dev)
    rev = torch.zeros((B, P), dtype=torch.int64, device=dev)
    for i in range(k):
        base = r64[:, i:i + P]
        fwd |= base << (2 * (k - 1 - i))
        rev |= (3 - base) << (2 * i)
    fwd &= _MASK32
    rev &= _MASK32

    if hash_representations:
        fwd = wang_hash32(fwd)
        rev = wang_hash32(rev)

    use_fwd = fwd <= rev
    rep = torch.where(use_fwd, fwd, rev)
    direction = (~use_fwd).to(torch.int32)
    del fwd, rev, use_fwd

    kmer_valid = torch.arange(P, device=dev)[None, :] < n_kmers[:, None]
    rep = torch.where(kmer_valid, rep, int(INVALID_REP))

    # pad w-1 sentinel k-mers at each side; window ω covers padded positions
    # [ω, ω+w-1], i.e. k-mer positions [ω-(w-1), ω]
    if w > 1:
        rep_p = torch.nn.functional.pad(rep, (w - 1, w - 1), value=int(INVALID_REP))
        dir_p = torch.nn.functional.pad(direction, (w - 1, w - 1), value=0)
    else:
        rep_p, dir_p = rep, direction
    Pw = P + w - 1  # number of windows (padded)

    win_idx = torch.arange(Pw, dtype=torch.int32, device=dev)[None, :]
    best_rep = torch.full((B, Pw), int(INVALID_REP), dtype=torch.int64, device=dev)
    best_pos = torch.full((B, Pw), -1, dtype=torch.int32, device=dev)
    best_dir = torch.zeros((B, Pw), dtype=torch.int32, device=dev)
    for i in range(w):
        cand = rep_p[:, i:i + Pw]
        take = cand <= best_rep  # rightmost tie-break
        best_rep = torch.where(take, cand, best_rep)
        best_pos = torch.where(take, win_idx + (i - (w - 1)), best_pos)
        best_dir = torch.where(take, dir_p[:, i:i + Pw], best_dir)

    # a window is valid if its index < n_kmers + w - 1 and the read is long
    # enough for one full window; the chosen position must be a valid k-mer
    read_ok = lengths[:, None] >= (w + k - 1)
    win_valid = read_ok & (win_idx < (n_kmers[:, None] + w - 1))
    win_valid &= (best_pos >= 0) & (best_pos < n_kmers[:, None])

    # dedupe consecutive windows with the same minimizer position
    prev_pos = torch.nn.functional.pad(best_pos[:, :-1], (1, 0), value=-2)
    emit = win_valid & (best_pos != prev_pos)

    positions = best_pos.clamp(0, P - 1)
    return best_rep, positions, best_dir, emit


def sketch_to_numpy(reps, positions, directions, emit, first_read_id: int = 0):
    """Flatten a sketch to host arrays in (read, window) order, the order the
    reference's generate_sketch_elements emits before sorting. Returns
    (reps uint32, read_ids uint32, positions uint32, directions uint8)."""
    reps, positions, directions, emit = (
        x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in (reps, positions, directions, emit)
    )
    B, Pw = reps.shape
    rid = np.broadcast_to(
        np.arange(B, dtype=np.uint32)[:, None] + np.uint32(first_read_id), (B, Pw)
    )
    m = emit.reshape(-1)
    return (
        reps.reshape(-1)[m].astype(np.uint32),
        rid.reshape(-1)[m],
        positions.reshape(-1)[m].astype(np.uint32),
        directions.reshape(-1)[m].astype(np.uint8),
    )
