"""The port's multi-device layer (genomeworks_tpu_torch/parallel) against
the JAX package's, on the CPU, in one process with no process group (one
rank): the padding and read ranges, the sharded POA against jax_poa's XLA
chain at the same caps and the host reference, ``banded_nw_forward``
against the JAX scan, the match counts and the all-reduce against NumPy,
``map_reads_sharded`` against the JAX device pipeline, and
``map_reads_multihost`` against ``map_reads``. The two-process runs are
in test_torch_multihost.py. Every comparison is exact."""

import random
import types

import numpy as np
import pytest
import torch

import genomeworks_tpu.parallel.mesh as jmesh
import genomeworks_tpu.parallel.sharded_mapper as jsm
import genomeworks_tpu_torch.parallel as tpar
from genomeworks_tpu.aligner.banded_nw import banded_nw_forward as jax_banded_nw_forward
from genomeworks_tpu.poa.cpu_reference import poa_consensus
from genomeworks_tpu.poa.jax_poa import poa_batch_consensus
from genomeworks_tpu.simulators.genomesim import generate_random_genome, mutate_sequence
from genomeworks_tpu_torch.aligner import banded_nw_forward
from genomeworks_tpu_torch.parallel.mesh import make_mesh, shard_range
from genomeworks_tpu_torch.parallel.sharded import (
    aligner_step_sharded,
    anchor_count_allreduce,
    matcher_sharded_counts,
    poa_batch_consensus_sharded,
)
from genomeworks_tpu_torch.parallel.sharded_mapper import map_reads_sharded, split_read_ranges

CPU = "cpu"


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(device=CPU)


def test_mesh_is_one_rank_without_a_group(mesh):
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    assert mesh.device == mesh.comm_device == torch.device(CPU)
    assert shard_range(mesh, 12) == tpar.batch_sharding(mesh, 12) == (0, 12)
    a = np.arange(12).reshape(6, 2)
    (x,) = tpar.shard_batch(mesh, a)
    assert torch.equal(x, torch.from_numpy(a))
    with pytest.raises(ValueError):
        make_mesh(2, device=CPU)


@pytest.mark.parametrize("multiple", [1, 3, 4, 8])
def test_pad_batch_to_multiple_matches_jax(multiple):
    rng = np.random.default_rng(multiple)
    arrays = [rng.integers(0, 9, (5, 3)).astype(np.int32), rng.random(5), np.arange(5)]
    got = tpar.pad_batch_to_multiple(arrays, multiple)
    ref = jmesh.pad_batch_to_multiple(arrays, multiple)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("n_reads,n_shards", [(0, 1), (7, 1), (7, 3), (24, 4), (3, 8), (2500, 8)])
def test_split_read_ranges_matches_jax(n_reads, n_shards):
    assert split_read_ranges(n_reads, n_shards) == jsm.split_read_ranges(n_reads, n_shards)


def uneven_windows():
    """tests/test_sharded.py's batch: 8 + 3 windows of a 40-base template
    and 3 reads at 6 % substitutions and 6 % indels."""
    rng = np.random.default_rng(0)
    windows = []
    for _ in range(8 + 3):
        t = generate_random_genome(40, rng)
        windows.append([t] + [mutate_sequence(t, rng, 0.06, 0.06) for _ in range(3)])
    return windows


def test_sharded_poa_matches_jax_chain_and_reference(mesh):
    windows = uneven_windows()
    cons, cov, st = poa_batch_consensus_sharded(windows, mesh)
    # the sharded path's caps: L = 64 (the longest read rounded up to 64),
    # so N = 192; E = A = 50
    L = ((max(len(s) for w in windows for s in w) + 63) // 64) * 64
    rc, rv, rs = poa_batch_consensus(windows, max_nodes=3 * L, max_edges=50,
                                     max_alignments=50, use_pallas=False,
                                     use_lockstep=False)
    assert st == [0] * len(windows) == list(rs)
    assert cons == list(rc)
    for b, w in enumerate(windows):
        np.testing.assert_array_equal(cov[b], rv[b])
        hc, hv = poa_consensus(w)
        assert cons[b] == hc
        np.testing.assert_array_equal(cov[b], hv)


def nw_inputs(B=16, M=64, W=32, seed=2):
    """test_sharded.py:87-105's shapes (B pairs of M random bases, band W),
    with a few lengths changed: a pair that does not fit the band, an empty
    query, an empty target and a short pair."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, size=(B, M)).astype(np.uint8)
    t = rng.integers(0, 4, size=(B, M + 8)).astype(np.uint8)
    ql = np.full(B, M, np.int32)
    tl = np.full(B, M, np.int32)
    ql[1], tl[1] = M, M - W - 4  # |tlen - qlen| >= W: does not fit
    ql[2], tl[2] = 0, 9
    ql[3], tl[3] = 17, 0
    ql[4], tl[4] = 33, 40
    tl[5] = M + 8
    return q, t, ql, tl, W


def test_banded_nw_forward_matches_jax():
    q, t, ql, tl, W = nw_inputs()
    final, codes, fits = banded_nw_forward(q, t, ql, tl, W, device=CPU)
    jf, jc, jfits = (np.asarray(x) for x in jax_banded_nw_forward(q, t, ql, tl, band_width=W))
    assert codes.dtype == torch.uint8 and final.dtype == torch.int32
    assert not jfits[1] and jf[1] == 1 << 24
    np.testing.assert_array_equal(final.numpy(), jf)
    np.testing.assert_array_equal(codes.numpy(), jc.astype(np.uint8))
    np.testing.assert_array_equal(fits.numpy(), jfits)


def test_aligner_step_sharded_matches_jax(mesh):
    q, t, ql, tl, W = nw_inputs(seed=3)
    final, codes, fits = aligner_step_sharded(mesh, q, t, ql, tl, W)
    jf, jc, jfits = (np.asarray(x) for x in jax_banded_nw_forward(q, t, ql, tl, band_width=W))
    np.testing.assert_array_equal(final.numpy(), jf)
    np.testing.assert_array_equal(codes.numpy(), jc.astype(np.uint8))
    np.testing.assert_array_equal(fits.numpy(), jfits)


def test_matcher_counts_and_allreduce_match_numpy(mesh):
    rng = np.random.default_rng(1)
    q = np.sort(rng.integers(0, 500, 64)).astype(np.int32)
    t = np.sort(rng.integers(0, 500, 256)).astype(np.int32)
    got = matcher_sharded_counts(mesh, q, t)
    lo = np.searchsorted(t, q, "left")
    hi = np.searchsorted(t, q, "right")
    assert got.shape == (1,) and int(got[0]) == int((hi - lo).sum())
    n = 32
    total = anchor_count_allreduce(mesh, np.arange(n, dtype=np.int32))
    assert total.shape == (1,) and int(total[0]) == n * (n - 1) // 2


def graft_reads():
    """__graft_entry__.py:93-99's reads: 4 reads of about 400 bases of a
    3000-base genome (the JAX package's simulators)."""
    from genomeworks_tpu.simulators.readsim import NoisyReadSimulator

    random.seed(0)
    genome = generate_random_genome(3000, np.random.default_rng(0))
    sim = NoisyReadSimulator()
    reads = [sim.generate_read(genome, 400)[0] for _ in range(8)]

    class Parser:
        def __len__(self):
            return len(reads)

        def get_sequence_by_id(self, rid):
            return types.SimpleNamespace(name=f"r{rid}", seq=reads[rid])

    return Parser()


def test_map_reads_sharded_matches_jax_pipeline(mesh):
    from genomeworks_tpu.mapper.device_pipeline import (
        build_index_device,
        get_overlaps_device_pipeline,
    )

    parser = graft_reads()
    got = map_reads_sharded(parser, parser, mesh, all_to_all=True, min_overlap_len=100)
    idx = build_index_device(parser, 0, len(parser))
    ref = get_overlaps_device_pipeline(idx, idx, all_to_all=True, min_overlap_len=100)
    jax_sharded = jsm.map_reads_sharded(parser, parser, jmesh.make_mesh(1), all_to_all=True,
                                        min_overlap_len=100)
    assert len(ref) > 0
    as_tuples = [(o.query_read_id, o.target_read_id, o.query_start_position_in_read,
                  o.query_end_position_in_read, o.target_start_position_in_read,
                  o.target_end_position_in_read, o.relative_strand, o.num_residues)
                 for o in ref]
    assert [tuple(vars(o).values()) for o in got] == as_tuples
    assert jax_sharded == ref


def test_map_reads_multihost_one_process_is_map_reads(tmp_path):
    from torch_mapper_inputs import tuples, write_fastas

    import genomeworks_tpu_torch.mapper as tmap
    from genomeworks_tpu_torch.io import create_fasta_parser
    from genomeworks_tpu_torch.parallel.multihost import (
        initialize_distributed,
        map_reads_multihost,
    )

    assert initialize_distributed("localhost:1", 1, 0) is False
    p = create_fasta_parser(write_fastas(tmp_path)["reads"])
    params = tmap.MapperParams(index_size_mb=0.025, filtering_parameter=1.0)
    ref = tmap.map_reads(p, p, params, device=CPU)
    got = map_reads_multihost(p, p, params, device=CPU)
    assert len(ref) > 0 and tuples(got) == tuples(ref)
