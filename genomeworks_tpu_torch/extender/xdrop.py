"""Ungapped X-drop seed extension (reference: cudaextender,
ungapped_xdrop.cu and ungapped_xdrop_kernels.cu).

The counterpart of genomeworks_tpu/extender/xdrop.py, with its semantics
(bit parity with find_high_scoring_segment_pairs):
- per seed, extend right from (qpos, tpos) inclusive and left from
  (qpos-1, tpos-1), accumulating substitution scores along the diagonal;
- the running maximum prefers the EARLIEST position on ties;
- extension stops at the first position where
  (running_max - cumulative) > xdrop_threshold, or when the current tile's
  last position crosses a sequence boundary; the reported extent is the
  position of the running maximum at the stop point;
- total score = right max + left max; if the total is within
  [score_threshold, 3*score_threshold] and entropy is enabled, an entropy
  factor over the matched A/C/G/T pairs inside the final segment rescales
  the score (kernels.cu:455-474; computed in float64 on the host);
- SSPs below score_threshold are dropped; survivors are sorted by
  (diagonal, target_start, -length, -score) (scored_segment_pair_comp) and
  consecutive same-diagonal containments are deduplicated
  (scored_segment_pair_diagonal_overlap, thrust::unique_copy semantics).

On the card the extension and the match counts are hand-written kernels, a
warp per seed as in the reference (``ops/xdrop_cuda.py``, ``csrc/xdrop.cu``);
on the CPU their plain versions run (``extender/xdrop_plain.py``). The
scores, the sort and the deduplication stay on the device as tensors; only
the entropy's inputs (the integer counts of the seeds that need it) come
to the host, where it is computed in NumPy float64 as the JAX package does.

Sequence encoding: A=0 C=1 G=2 T=3 L(a/c/g/t)=4 N=5 X=6 E(&)=7
(cudaextender utils.hpp:36-48).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from genomeworks_tpu_torch.core.device import resolve_device
from genomeworks_tpu_torch.ops import xdrop_cuda

NUC = 8
NUC2 = 64

#: scoring matrix used by the reference sample & end-to-end test
#: (samples/sample_cudaextender.cpp:102-110)
DEFAULT_SCORE_MATRIX = np.array(
    [
        [91, -114, -31, -123, -1000, -1000, -100, -9100],
        [-114, 100, -125, -31, -1000, -1000, -100, -9100],
        [-31, -125, 100, -114, -1000, -1000, -100, -9100],
        [-123, -31, -114, 91, -1000, -1000, -100, -9100],
        [-1000, -1000, -1000, -1000, -1000, -1000, -1000, -9100],
        [-1000, -1000, -1000, -1000, -1000, -1000, -1000, -9100],
        [-100, -100, -100, -100, -1000, -1000, -100, -9100],
        [-9100, -9100, -9100, -9100, -9100, -9100, -9100, -9100],
    ],
    dtype=np.int32,
)

_ENC = np.full(256, 6, dtype=np.int8)  # X_NT default
for _c, _v in [("A", 0), ("C", 1), ("G", 2), ("T", 3), ("&", 7), ("N", 5), ("n", 5)]:
    _ENC[ord(_c)] = _v
for _c in "acgt":
    _ENC[ord(_c)] = 4  # L_NT


def encode_sequence(seq: str | bytes) -> np.ndarray:
    """cudaextender 8-letter encoding (utils.hpp:108-146)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _ENC[np.frombuffer(seq, dtype=np.uint8)]


@dataclasses.dataclass
class ScoredSegmentPair:
    """reference: extender.hpp:45."""

    target_position_in_read: int
    query_position_in_read: int
    length: int
    score: int

    def astuple(self):
        return (
            self.target_position_in_read,
            self.query_position_in_read,
            self.length,
            self.score,
        )


_U32 = (1 << 32) - 1


def sort_and_dedup_order(t: torch.Tensor, q: torch.Tensor, length: torch.Tensor,
                         score: torch.Tensor) -> torch.Tensor:
    """Indices of the SSPs (int64 tensors of their target and query starts,
    lengths and scores) that survive, in their output order:
    scored_segment_pair_comp's sort by (diagonal, target start, -length,
    -score), starts and diagonal as uint32 (ungapped_xdrop_kernels.cuh:65-120),
    stable as NumPy's lexsort; then, on each diagonal, an SSP contained in
    the last one kept is dropped (ungapped_xdrop.cu:158-170).

    After the sort an SSP's start is at or past the last kept one's, and
    past it or equally long, so containment is ``end <= the last kept end``;
    and the last kept end on a diagonal is the largest end before it there.
    So an SSP survives when its end is above every earlier end of its
    diagonal: one running maximum over keys (diagonal rank, end)."""
    n = t.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=t.device)
    if int(length.min()) < -1 or int(length.max()) >= 1 << 32:
        raise ValueError("SSP lengths must lie in [-1, 2**32), as the extension's do")
    tu = t & _U32
    diag = (tu - (q & _U32)) & _U32
    order = torch.arange(n, device=t.device)
    for key in (-score, -length, tu, diag):  # least significant key first
        order = order[torch.sort(key[order], stable=True).indices]
    d = diag[order]
    end = tu[order] + length[order]  # at least -1, below 2**33
    rank = torch.cumsum(torch.ne(d[1:], d[:-1]), 0)
    key = torch.cat([rank.new_zeros(1), rank]) * (1 << 34) + (end + 1)
    above = torch.ones(n, dtype=torch.bool, device=t.device)
    above[1:] = key[1:] > torch.cummax(key, 0).values[:-1]
    return order[above]


def _sort_and_dedup(ssps: list[ScoredSegmentPair]) -> list[ScoredSegmentPair]:
    """``sort_and_dedup_order`` over a list of SSPs (the JAX package's
    ``_sort_and_dedup``)."""
    if not ssps:
        return []
    cols = torch.tensor([s.astuple() for s in ssps], dtype=torch.int64)
    keep = sort_and_dedup_order(cols[:, 0], cols[:, 1], cols[:, 2], cols[:, 3])
    return [ssps[i] for i in keep.tolist()]


class UngappedXDrop:
    """Batched ungapped X-drop extender (reference: UngappedXDrop,
    ungapped_xdrop.cuh:39; lifecycle extend_async -> sync ->
    get_scored_segment_pairs, extender.hpp:62-154).

    ``device=None`` is the CUDA card and raises without one; pass
    ``device="cpu"`` for the plain PyTorch versions on the host."""

    def __init__(
        self,
        score_matrix: np.ndarray = DEFAULT_SCORE_MATRIX,
        xdrop_threshold: int = 910,
        no_entropy: bool = False,
        batch_max_extensions: int = 1 << 22,
        device: str | torch.device | None = None,
    ):
        m = np.asarray(score_matrix, dtype=np.int32)
        if m.size != NUC2:
            raise ValueError("score matrix must have 64 entries")
        self.device = resolve_device(device)
        self.sub_flat = m.reshape(-1)
        self._sub = torch.from_numpy(self.sub_flat.copy()).to(self.device)
        self.xdrop = int(xdrop_threshold)
        self.no_entropy = no_entropy
        self.batch_max = batch_max_extensions
        self._ssps: list[ScoredSegmentPair] = []
        #: seeds of the last extend_async whose score the entropy rescaled
        self.rescored = 0

    # -- public API ---------------------------------------------------------
    def extend_async(
        self,
        query,
        target,
        score_threshold: int,
        seed_pairs: list[tuple[int, int]] | np.ndarray | torch.Tensor,
    ) -> None:
        """query, target: codes 0-7 (``encode_sequence``) as NumPy arrays or
        tensors; a tensor already on the extender's device is used there
        without a copy through the host. seed_pairs: (query_position,
        target_position) pairs."""
        q = self._codes(query, "query")
        t = self._codes(target, "target")
        if isinstance(seed_pairs, torch.Tensor):
            seed_pairs = seed_pairs.cpu().numpy()
        seeds = np.ascontiguousarray(np.asarray(seed_pairs, dtype=np.int64).reshape(-1, 2))
        self._ssps = []
        self.rescored = 0
        for start in range(0, len(seeds), self.batch_max):
            chunk = seeds[start : start + self.batch_max]
            self._ssps.extend(self._extend_batch(q, t, int(score_threshold), chunk))

    def sync(self) -> None:
        pass  # _extend_batch reads its results back to the host

    def get_scored_segment_pairs(self) -> list[ScoredSegmentPair]:
        return self._ssps

    def reset(self) -> None:
        self._ssps = []
        self.rescored = 0

    # -- internals ----------------------------------------------------------
    def _codes(self, seq, name: str) -> torch.Tensor:
        """Codes 0-7 as a contiguous uint8 tensor on the extender's device."""
        x = seq if isinstance(seq, torch.Tensor) else torch.from_numpy(np.asarray(seq))
        if x.dim() != 1 or x.numel() == 0:
            raise ValueError(f"{name} must be a non-empty vector of codes")
        if x.dtype.is_floating_point or x.dtype == torch.bool:
            raise TypeError(f"{name} codes must be integers, got {x.dtype}")
        x = x.to(self.device)
        if int(x.min()) < 0 or int(x.max()) >= NUC:
            raise ValueError(f"{name} codes must lie in 0-{NUC - 1}")
        return x.to(torch.uint8).contiguous()

    def _extend_batch(self, q, t, score_threshold, seeds):
        dev = self.device
        seeds_d = torch.from_numpy(seeds).to(dev)
        qpos = seeds_d[:, 0].to(torch.int32).contiguous()
        tpos = seeds_d[:, 1].to(torch.int32).contiguous()

        ext = xdrop_cuda.xdrop_extend_cuda(q, t, qpos, tpos, self._sub, self.xdrop)
        r_score, r_pos, l_score, l_pos = ext.to(torch.int64).unbind(1)
        total = r_score + l_score
        extent = r_pos + l_pos  # reported length (kernels.cu:401,452)
        keep = total >= score_threshold
        out_score = total.clone()

        if not self.no_entropy:
            need = (total >= score_threshold) & (total <= 3 * score_threshold)
            nz = torch.nonzero(need).squeeze(1)
            if nz.numel():
                # the entropy of the seeds that need it, in NumPy float64 on
                # the host from the kernel's integer counts (:378-389); for
                # every other seed it is 1.0, and total * 1.0 == total
                counts_d = xdrop_cuda.xdrop_count_cuda(q, t, qpos[nz], tpos[nz], ext[nz, 3],
                                                       ext[nz, 1])
                counts = counts_d.cpu().numpy().astype(np.float64)
                tot = total[nz].cpu().numpy()
                ext1 = (extent[nz] + 1).cpu().numpy()
                csum = counts.sum(axis=1)
                with np.errstate(divide="ignore", invalid="ignore"):
                    p = counts / ext1[:, None].astype(np.float64)
                    ln = np.where(counts > 0, p * np.log(p, where=counts > 0), 0.0)
                    ent = -ln.sum(axis=1) / math.log(4.0)
                entropy = np.where(csum >= 20, ent, 1.0)
                self.rescored += int((csum >= 20).sum())
                final = (tot.astype(np.float64) * entropy).astype(np.int64)
                scaled = np.where(entropy > 0, (tot * entropy), 0).astype(np.int64)
                keep[nz] = torch.from_numpy(final >= score_threshold).to(dev)
                out_score[nz] = torch.from_numpy(scaled).to(dev)

        idx = torch.nonzero(keep).squeeze(1)
        t0 = seeds_d[idx, 1] - l_pos[idx]
        q0 = seeds_d[idx, 0] - l_pos[idx]
        length, score = extent[idx], out_score[idx]
        order = sort_and_dedup_order(t0, q0, length, score)
        cols = torch.stack([t0[order], q0[order], length[order], score[order]], 1).cpu()
        return [ScoredSegmentPair(*row) for row in cols.tolist()]


def create_extender(
    score_matrix=DEFAULT_SCORE_MATRIX,
    xdrop_threshold: int = 910,
    no_entropy: bool = False,
    device: str | torch.device | None = None,
) -> UngappedXDrop:
    """Factory (reference: create_extender, cudaextender/src/extender.cpp).
    ``device=None`` is the CUDA card and raises without one."""
    return UngappedXDrop(score_matrix, xdrop_threshold, no_entropy, device=device)


def parse_seed_pairs(path: str) -> np.ndarray:
    """CSV rows 'target_position,query_position' (utils.hpp:55-70).
    Returns (query_position, target_position) pairs."""
    raw = np.loadtxt(path, delimiter=",", dtype=np.int64).reshape(-1, 2)
    return raw[:, ::-1]  # file order is target,query; we return query,target


def parse_scored_segment_pairs(path: str) -> list[ScoredSegmentPair]:
    raw = np.loadtxt(path, delimiter=",", dtype=np.int64).reshape(-1, 4)
    return [ScoredSegmentPair(int(a), int(b), int(c), int(d)) for a, b, c, d in raw]
