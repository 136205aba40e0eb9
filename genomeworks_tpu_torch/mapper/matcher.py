"""Anchor matching (reference: cudamapper's MatcherGPU,
cudamapper/src/matcher_gpu.cu). Counterpart of
genomeworks_tpu/mapper/matcher.py.

For every unique query representation, find the equal target representation
(binary search over the target's unique representations,
find_query_target_matches_kernel, matcher_gpu.cuh:204), count the
(query occurrences x target occurrences) cross product (prefix sum,
compute_anchor_starting_indices, matcher_gpu.cuh:117), then materialize all
anchors ordered by query-representation index with query occurrence outer /
target occurrence inner (generate_anchors_kernel, matcher_gpu.cu:176-249),
and finally sort anchors by (query_read_id, target_read_id,
query_position, target_position), the reference's compound-key sort.

:func:`generate_anchors` is the NumPy host version (a copy of the JAX
package's); :func:`generate_anchors_device` runs the same steps as PyTorch
ops on the device, the device pipeline's own stages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from genomeworks_tpu_torch.mapper.index import Index


@dataclasses.dataclass
class Anchors:
    """SoA anchor arrays (reference: Anchor POD, cudamapper types.hpp:36)."""

    query_read_ids: np.ndarray  # uint32
    target_read_ids: np.ndarray  # uint32
    query_positions: np.ndarray  # uint32
    target_positions: np.ndarray  # uint32

    def __len__(self) -> int:
        return len(self.query_read_ids)


def _no_anchors() -> Anchors:
    z = np.zeros(0, np.uint32)
    return Anchors(z, z, z, z)


def generate_anchors(query_index: Index, target_index: Index) -> Anchors:
    """All (query occurrence, target occurrence) pairs of equal
    representations, sorted by (qrid, trid, qpos, tpos)."""
    q_uniq = query_index.unique_representations
    t_uniq = target_index.unique_representations
    q_first = query_index.first_occurrence_of_representations.astype(np.int64)
    t_first = target_index.first_occurrence_of_representations.astype(np.int64)

    if len(q_uniq) == 0 or len(t_uniq) == 0:
        return _no_anchors()

    # binary search each query unique representation in the target uniques
    found = np.searchsorted(t_uniq, q_uniq)
    found_c = np.clip(found, 0, len(t_uniq) - 1)
    matched = t_uniq[found_c] == q_uniq
    found_c[~matched] = 0

    q_counts = np.diff(q_first)
    t_counts = np.diff(t_first)
    n_pairs = np.where(matched, q_counts * t_counts[found_c], 0)
    starts = np.concatenate([[0], np.cumsum(n_pairs)])
    total = int(starts[-1])
    if total == 0:
        return _no_anchors()

    # expand: for each anchor slot, which representation does it belong to
    rep_idx = np.repeat(np.arange(len(q_uniq)), n_pairs)
    rel = np.arange(total, dtype=np.int64) - starts[rep_idx]
    n_t = t_counts[found_c][rep_idx]
    q_idx = q_first[rep_idx] + rel // n_t
    t_idx = t_first[found_c[rep_idx]] + rel % n_t

    qrid = query_index.read_ids[q_idx]
    trid = target_index.read_ids[t_idx]
    qpos = query_index.positions_in_reads[q_idx]
    tpos = target_index.positions_in_reads[t_idx]

    # compound-key sort (matcher_gpu.cuh:176 sort by query_read ->
    # target_read -> query_pos -> target_pos); the four u32 keys packed
    # into two u64
    key_hi = (qrid.astype(np.uint64) << np.uint64(32)) | trid.astype(np.uint64)
    key_lo = (qpos.astype(np.uint64) << np.uint64(32)) | tpos.astype(np.uint64)
    order = np.lexsort((key_lo, key_hi))
    return Anchors(qrid[order], trid[order], qpos[order], tpos[order])


def generate_anchors_device(
    query_index: Index,
    target_index: Index,
    device: str | torch.device | None = None,
) -> Anchors:
    """:func:`generate_anchors` with the indexes staged on ``device``
    (``None`` = the CUDA card) and the matching, the expansion and the
    compound-key sort run there as the device pipeline runs them; only the
    final anchor arrays come back. Equal to :func:`generate_anchors`."""
    from genomeworks_tpu_torch.mapper.device_pipeline import (
        DeviceIndex,
        _expand_sort,
        _match_counts,
    )

    q = DeviceIndex.from_index(query_index, device)
    t = q if target_index is query_index else DeviceIndex.from_index(target_index, device)
    if q.u == 0 or t.u == 0:
        return _no_anchors()
    t_first_m, t_counts, total = _match_counts(q, t)
    total = int(total)
    if total == 0:
        return _no_anchors()
    fields = _expand_sort(q, t, t_first_m, t_counts, total)
    return Anchors(*(f.cpu().numpy().astype(np.uint32) for f in fields))
