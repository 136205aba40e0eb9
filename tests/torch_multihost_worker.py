"""Worker of the port's multi-process tests (tests/test_torch_multihost.py).

    python torch_multihost_worker.py <pid> <nproc> <port> <fasta> <out_prefix>

Each process joins a gloo group of ``nproc`` ranks on the CPU (none for one
process), then runs, in this order: ``map_reads_multihost`` on the reads of
``fasta`` (a tiny index budget, so the round-robin splits the pairs), and
on the same ranks ``map_reads_sharded``, ``poa_batch_consensus_sharded``
on an uneven window batch, ``aligner_step_sharded``,
``matcher_sharded_counts`` and ``anchor_count_allreduce``. It writes the
merged overlaps as text to ``<out_prefix>.p<pid>.txt`` and everything to
``<out_prefix>.p<pid>.pt``, and prints the overlap count. Every rank holds
the whole result, so the files must be equal across ranks and to those of
one process. Imports neither JAX nor the JAX package.
"""

import os
import sys
from datetime import timedelta

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
torch.set_num_threads(1)

from genomeworks_tpu_torch.io import create_fasta_parser  # noqa: E402
from genomeworks_tpu_torch.mapper import MapperParams  # noqa: E402
from genomeworks_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from genomeworks_tpu_torch.parallel.multihost import (  # noqa: E402
    initialize_distributed,
    map_reads_multihost,
)
from genomeworks_tpu_torch.parallel.sharded import (  # noqa: E402
    aligner_step_sharded,
    anchor_count_allreduce,
    matcher_sharded_counts,
    poa_batch_consensus_sharded,
)
from genomeworks_tpu_torch.parallel.sharded_mapper import map_reads_sharded  # noqa: E402
from genomeworks_tpu_torch.simulators import generate_random_genome, mutate_sequence  # noqa: E402


def overlap_lines(overlaps):
    return "".join(
        f"{o.query_read_id}\t{o.target_read_id}\t"
        f"{o.query_start_position_in_read}\t{o.query_end_position_in_read}\t"
        f"{o.target_start_position_in_read}\t{o.target_end_position_in_read}\t"
        f"{o.relative_strand}\t{o.num_residues}\n"
        for o in overlaps
    )


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    fasta, out_prefix = sys.argv[4], sys.argv[5]
    active = initialize_distributed(f"localhost:{port}", nproc, pid, backend="gloo",
                                    device="cpu", timeout=timedelta(seconds=60))
    assert active == (nproc > 1)
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size) == (pid, nproc)

    parser = create_fasta_parser(fasta)
    params = MapperParams(index_size_mb=0.01, target_index_size_mb=0.01,
                          filtering_parameter=1.0)
    overlaps = map_reads_multihost(parser, parser, params, device="cpu")
    sharded = map_reads_sharded(parser, parser, mesh, all_to_all=True)

    rng = np.random.default_rng(0)
    windows = []
    for _ in range(11):  # 11 windows: the ranks' slices differ, one pad
        t = generate_random_genome(40, rng)
        windows.append([t] + [mutate_sequence(t, rng, 0.06, 0.06) for _ in range(3)])
    poa = poa_batch_consensus_sharded(windows, mesh)

    rng = np.random.default_rng(2)
    B, M, W = 16, 64, 32
    q = rng.integers(0, 4, size=(B, M)).astype(np.uint8)
    t = rng.integers(0, 4, size=(B, M + 8)).astype(np.uint8)
    ql = rng.integers(0, M + 1, B).astype(np.int32)
    tl = np.clip(ql + rng.integers(-40, 9, B), 0, M + 8).astype(np.int32)
    step = aligner_step_sharded(mesh, q, t, ql, tl, W)

    qr = np.sort(rng.integers(0, 500, 64)).astype(np.int32)
    tr = np.sort(rng.integers(0, 500, 256)).astype(np.int32)
    counts = (matcher_sharded_counts(mesh, qr, tr),
              anchor_count_allreduce(mesh, np.arange(32, dtype=np.int32)))

    with open(f"{out_prefix}.p{pid}.txt", "w") as f:
        f.write(overlap_lines(overlaps))
    torch.save({"sharded": overlap_lines(sharded), "poa": (poa[0], [c.tolist() for c in poa[1]],
                                                          poa[2]),
                "step": step, "counts": counts}, f"{out_prefix}.p{pid}.pt")
    print(f"OVERLAPS {len(overlaps)} SHARDED {len(sharded)}")


if __name__ == "__main__":
    main()
