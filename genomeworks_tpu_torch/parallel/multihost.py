"""Multi-process overlap mapping: one process per card, on one host or
many.

Counterpart of genomeworks_tpu/parallel/multihost.py. The reference scales
to N GPUs in one host with worker threads and device caches
(cudamapper/src/main.cu:453-594) and has no multi-node story. Here each
process owns one device and joins a ``torch.distributed`` group
(:func:`initialize_distributed`: NCCL between cards, gloo when the ranks
compute on the CPU or when it is named):

- **Work decomposition**: the (query range x target range) index pairs of
  ``map_reads`` go round-robin over the ranks; each rank runs exactly its
  share through the device pipeline, building its indexes from its own copy
  of the input.
- **Traffic**: only the final overlap rows, each carrying its global pair
  index: the counts are gathered first, then the rows padded to the
  largest count (``mesh.gather_ragged_rows``).
- **Determinism**: the merge is a stable sort by the pair index, and within
  a pair the pipeline is deterministic, so every rank holds the
  single-process result, byte for byte.

With one process it is plain ``map_reads``.
"""

from __future__ import annotations

from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from genomeworks_tpu_torch.core.device import resolve_device


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device=None,
    timeout: timedelta | None = None,
) -> bool:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``, rendezvous at ``tcp://{coordinator_address}``
    (``host:port``). Returns True when a group is active (more than one
    process); with one process or fewer it does nothing and returns False.

    ``backend=None`` is NCCL when this process computes on CUDA (``device``,
    ``None`` = the card, which raises without one) and gloo on the CPU. On
    CUDA the process first takes card ``process_id % device_count``. A
    failed initialisation raises; nothing falls back to another backend."""
    if not num_processes or num_processes <= 1:
        return False
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kw)
    return True


def map_reads_multihost(
    query_parser,
    target_parser,
    params=None,
    all_to_all: bool | None = None,
    device=None,
):
    """Overlap mapping across processes: each rank maps its round-robin
    share of the (query-range x target-range) pairs through the device
    pipeline on ``device`` (``None`` = its CUDA card), the rows gather over
    the group, and the merge restores the single-process order. Every rank
    returns the same list, equal to ``map_reads``'s.

    With one process (no group, or a group of one) it is ``map_reads``."""
    from genomeworks_tpu_torch.mapper.overlapper import Overlap
    from genomeworks_tpu_torch.mapper.pipeline import (
        MapperParams,
        _map_reads_device,
        group_reads_into_index_ranges,
        map_reads,
    )
    from genomeworks_tpu_torch.parallel.mesh import gather_ragged_rows, make_mesh

    params = params or MapperParams()
    if all_to_all is None:
        all_to_all = query_parser is target_parser
    mesh = make_mesh(device=device)
    if mesh.size == 1:
        return map_reads(query_parser, target_parser, params, all_to_all, device=mesh.device)

    q_ranges = group_reads_into_index_ranges(query_parser, params.index_size_mb * 1_000_000)
    t_ranges = group_reads_into_index_ranges(
        target_parser, params.target_index_size_mb * 1_000_000
    )
    pairs = [
        (i, qr, tr)
        for i, (qr, tr) in enumerate(
            (q, t) for q in q_ranges for t in t_ranges if not (all_to_all and t[0] < q[0])
        )
    ]
    mine = pairs[mesh.rank :: mesh.size]
    local, pair_ids = _map_reads_device(
        query_parser, target_parser, params, all_to_all,
        params.filtering_parameter or 1e-5, None, None, mesh.device,
        pairs=mine, return_pair_ids=True,
    )
    fields = np.array(
        [
            [
                o.query_read_id, o.target_read_id,
                o.query_start_position_in_read, o.query_end_position_in_read,
                o.target_start_position_in_read, o.target_end_position_in_read,
                1 if o.relative_strand == "-" else 0, o.num_residues, g,
            ]
            for o, g in zip(local, pair_ids)
        ],
        dtype=np.int64,
    ).reshape(-1, 9)
    parts = gather_ragged_rows(mesh, torch.from_numpy(fields).to(mesh.device))
    rows = torch.cat(parts).numpy()
    rows = rows[np.argsort(rows[:, 8], kind="stable")]
    return [
        Overlap(r[0], r[1], r[2], r[3], r[4], r[5], "-" if r[6] else "+", r[7])
        for r in rows.tolist()
    ]
