"""Multi-device overlap mapping: the query reads split over the ranks.

Counterpart of genomeworks_tpu/parallel/sharded_mapper.py, the
re-design of the reference's multi-GPU worker loop
(cudamapper/src/main.cu:453-594: one CPU thread and stream pair per GPU
pulling index pairs off a shared queue). Each rank of the group
(``parallel.mesh.Mesh``) builds the whole target index (the build from the
same parser is deterministic) and the index of its own contiguous,
ascending range of query reads, and runs the port's device pipeline
(``mapper.device_pipeline.get_overlaps_device_pipeline``) on the pair.
Overlap chains never span query reads, so the ranks' outputs are
independent, and their concatenation in rank order is the single-device
run's, byte for byte (ranges ascend with the rank, and anchors sort
query-read major). The eight overlap columns are gathered as int64: the
counts first, then the rows padded to the largest count.
"""

from __future__ import annotations

import numpy as np
import torch

from genomeworks_tpu_torch.mapper.device_pipeline import (
    DeviceIndex,
    build_index_device,
    get_overlaps_device_pipeline,
)
from genomeworks_tpu_torch.mapper.overlapper import Overlap
from genomeworks_tpu_torch.parallel.mesh import Mesh, gather_ragged_rows


def split_read_ranges(n_reads: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous, ascending query-read ranges, one per device."""
    bounds = np.linspace(0, n_reads, n_shards + 1).astype(int)
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(n_shards)]


def map_reads_sharded(
    query_parser,
    target_parser,
    mesh: Mesh,
    all_to_all: bool,
    kmer_size: int = 15,
    window_size: int = 10,
    hash_representations: bool = True,
    filtering_parameter: float = 1.0,
    min_residues: int = 3,
    min_overlap_len: int = 250,
    min_bases_per_residue: int = 1000,
    min_overlap_fraction: float = 0.8,
    target_index: DeviceIndex | None = None,
) -> list[Overlap]:
    """Overlap query reads against target reads across the ranks of
    ``mesh``, each on ``mesh.device``; every rank returns the whole list,
    equal to the single-device pipeline's (and so to the host
    pipeline's)."""
    n_q = len(query_parser)
    sketch = dict(kmer_size=kmer_size, window_size=window_size,
                  hash_representations=hash_representations,
                  filtering_parameter=filtering_parameter, device=mesh.device)
    if target_index is None:
        target_index = build_index_device(target_parser, 0, len(target_parser), **sketch)
    if target_index.n == 0 or n_q == 0:
        return []

    first, past = split_read_ranges(n_q, mesh.size)[mesh.rank]
    rows = torch.zeros((0, 8), dtype=torch.int64)
    if past > first:
        q_index = build_index_device(query_parser, first, past, **sketch)
        arrs = get_overlaps_device_pipeline(
            q_index, target_index, all_to_all, min_residues, min_overlap_len,
            min_bases_per_residue, min_overlap_fraction, as_arrays=True,
        )
        if len(arrs):
            rows = torch.from_numpy(np.stack([
                arrs.query_read_id, arrs.target_read_id, arrs.query_start, arrs.query_end,
                arrs.target_start, arrs.target_end, arrs.rev, arrs.num_residues,
            ], axis=1).astype(np.int64))
    merged = torch.cat(gather_ragged_rows(mesh, rows.to(mesh.device))).tolist()
    return [
        Overlap(qr, tr, qs, qe, ts, te, "-" if rev else "+", res)
        for qr, tr, qs, qe, ts, te, rev, res in merged
    ]
