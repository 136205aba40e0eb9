"""Index descriptors and two-level index batching for out-of-core mapping.

A copy of genomeworks_tpu/mapper/batcher.py (NumPy and the standard library only).

Reference: cudamapper's IndexDescriptor (include/.../index.hpp:40-81,
src/index_descriptor.cpp — unit of index batching/caching), the read
grouping helper group_reads_into_indices (src/utils.cpp:319-353), and
IndexBatcher (src/index_batcher.cu: host-memory-sized batches subdivided
into device-memory-sized sub-batches, exploiting all-to-all symmetry to
emit only the upper triangle of the query x target tile matrix,
group_into_batches :104-137).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class IndexDescriptor:
    """(first read, number of reads) — the unit of index batching/caching
    (index.hpp:40)."""

    first_read: int
    number_of_reads: int

    def __hash__(self):  # index_descriptor.cpp hash: combine both fields
        return hash((self.first_read, self.number_of_reads))


def group_reads_into_indices(parser, max_basepairs_per_index: int) -> list[IndexDescriptor]:
    """Greedy grouping of consecutive reads into indices of at most
    max_basepairs_per_index total bases (utils.cpp:319-353)."""
    descriptors: list[IndexDescriptor] = []
    total = parser.get_num_seqences()
    first = 0
    n_reads = 0
    n_bp = 0
    for read_id in range(total):
        bp = len(parser.get_sequence_by_id(read_id).seq)
        if bp + n_bp > max_basepairs_per_index and n_reads > 0:
            descriptors.append(IndexDescriptor(first, n_reads))
            first = read_id
            n_reads = 1
            n_bp = bp
        else:
            n_reads += 1
            n_bp += bp
    if n_reads > 0:
        descriptors.append(IndexDescriptor(first, n_reads))
    return descriptors


@dataclasses.dataclass
class IndexBatch:
    """One batch: lists of query and target index descriptors
    (index_batcher.cuh:37)."""

    query_indices: list[IndexDescriptor]
    target_indices: list[IndexDescriptor]


@dataclasses.dataclass
class BatchOfIndices:
    """A host batch and its device sub-batches (index_batcher.cuh:48)."""

    host_batch: IndexBatch
    device_batches: list[IndexBatch]


def group_into_batches(
    query_indices: list[IndexDescriptor],
    target_indices: list[IndexDescriptor],
    query_indices_per_batch: int,
    target_indices_per_batch: int,
    same_query_and_target: bool,
) -> list[IndexBatch]:
    """group_into_batches (index_batcher.cu:104-137): tile the descriptor
    lists; with same_query_and_target only the upper triangle is emitted."""
    if same_query_and_target and query_indices_per_batch != target_indices_per_batch:
        raise ValueError(
            "same_query_and_target is true, but indices_per_batch not the same"
        )
    batches: list[IndexBatch] = []
    for q0 in range(0, len(query_indices), query_indices_per_batch):
        t_start = q0 if same_query_and_target else 0
        for t0 in range(t_start, len(target_indices), target_indices_per_batch):
            batches.append(
                IndexBatch(
                    query_indices[q0 : q0 + query_indices_per_batch],
                    target_indices[t0 : t0 + target_indices_per_batch],
                )
            )
    return batches


def generate_batches_of_indices(
    query_indices_per_host_batch: int,
    query_indices_per_device_batch: int,
    target_indices_per_host_batch: int,
    target_indices_per_device_batch: int,
    query_parser,
    target_parser,
    query_basepairs_per_index: int,
    target_basepairs_per_index: int,
    same_query_and_target: bool,
) -> list[BatchOfIndices]:
    """Two-level batching (index_batcher.cu:40-96): host batches subdivided
    into device batches, with the symmetry skip re-evaluated per host batch
    (device batches are only symmetric when the host batch is diagonal)."""
    if same_query_and_target and (
        query_indices_per_host_batch != target_indices_per_host_batch
        or query_indices_per_device_batch != target_indices_per_device_batch
        or query_basepairs_per_index != target_basepairs_per_index
    ):
        raise ValueError(
            "same_query_and_target is true, but query and target parameters differ"
        )
    query_descs = group_reads_into_indices(query_parser, query_basepairs_per_index)
    target_descs = group_reads_into_indices(target_parser, target_basepairs_per_index)

    host_batches = group_into_batches(
        query_descs, target_descs,
        query_indices_per_host_batch, target_indices_per_host_batch,
        same_query_and_target,
    )
    all_batches: list[BatchOfIndices] = []
    for hb in host_batches:
        same_in_batch = same_query_and_target and hb.query_indices == hb.target_indices
        device_batches = group_into_batches(
            hb.query_indices, hb.target_indices,
            query_indices_per_device_batch, target_indices_per_device_batch,
            same_in_batch,
        )
        all_batches.append(BatchOfIndices(hb, device_batches))
    return all_batches
