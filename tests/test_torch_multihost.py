"""The port's multi-process paths in real process groups on the CPU: two
ranks of gloo (tests/torch_multihost_worker.py, which imports no JAX)
against one process, as tests/test_multihost.py holds the JAX package's.
The merged overlaps of ``map_reads_multihost`` must be byte-identical on
both ranks and equal to the one-process run, on 24 reads of 1200 bases of a
6000-base genome with a 0.01 MB index budget; the two ranks'
``map_reads_sharded``, sharded POA, aligner step and counts must equal one
rank's. The workers start once, together, and each process group has a
timeout of a minute."""

import os
import random
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multihost_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _write_fasta(path, n_reads=24, L=1200, seed=0):
    from genomeworks_tpu_torch.simulators import NoisyReadSimulator, generate_random_genome

    random.seed(seed)
    genome = generate_random_genome(6000, np.random.default_rng(seed))
    sim = NoisyReadSimulator()
    with open(path, "w") as f:
        for i in range(n_reads):
            read, _, _ = sim.generate_read(genome, L)
            f.write(f">r{i}\n{read}\n")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One process and two gloo ranks, started together: {nproc: (the
    workers' stdout, their output prefix)}."""
    tmp = tmp_path_factory.mktemp("multihost")
    fasta = str(tmp / "reads.fasta")
    _write_fasta(fasta)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = {}
    for nproc in (1, 2):
        port = str(_free_port())
        procs[nproc] = [subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(nproc), port, fasta, str(tmp / f"n{nproc}")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
            for pid in range(nproc)]
    out = {}
    try:
        for nproc, ps in procs.items():
            outs = []
            for p in ps:
                o, e = p.communicate(timeout=120)
                assert p.returncode == 0, e[-3000:]
                outs.append(o)
            out[nproc] = (outs, str(tmp / f"n{nproc}"))
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return out


def test_two_process_mapping_matches_single_process(runs):
    (out1, single), (out2, multi) = runs[1], runs[2]
    ref = open(f"{single}.p0.txt").read()
    assert ref.count("\n") > 10  # the workload must give real overlaps
    # every rank holds the same merged result, equal to one process's
    assert open(f"{multi}.p0.txt").read() == ref
    assert open(f"{multi}.p1.txt").read() == ref
    n1 = int(out1[0].split()[1])
    assert [int(o.split()[1]) for o in out2] == [n1, n1]


def test_one_process_mapping_matches_jax(runs, tmp_path):
    """The port's one-process result equals the JAX package's map_reads on
    the same reads and parameters."""
    from genomeworks_tpu.io.fasta import create_fasta_parser
    from genomeworks_tpu.mapper.pipeline import MapperParams, map_reads

    single = runs[1][1]
    p = create_fasta_parser(os.path.join(os.path.dirname(single), "reads.fasta"))
    ref = map_reads(p, p, MapperParams(index_size_mb=0.01, target_index_size_mb=0.01,
                                       filtering_parameter=1.0))
    lines = "".join(
        f"{o.query_read_id}\t{o.target_read_id}\t"
        f"{o.query_start_position_in_read}\t{o.query_end_position_in_read}\t"
        f"{o.target_start_position_in_read}\t{o.target_end_position_in_read}\t"
        f"{o.relative_strand}\t{o.num_residues}\n"
        for o in ref
    )
    assert open(f"{single}.p0.txt").read() == lines


@pytest.mark.parametrize("what", ["sharded", "poa", "step", "counts"])
def test_two_ranks_equal_one_rank(runs, what):
    single, multi = runs[1][1], runs[2][1]
    ref = torch.load(f"{single}.p0.pt")[what]
    for pid in (0, 1):
        got = torch.load(f"{multi}.p{pid}.pt")[what]
        if what in ("step", "counts"):
            assert all(torch.equal(g, r) for g, r in zip(got, ref, strict=True))
        else:
            assert got == ref
    if what == "sharded":
        assert ref.count("\n") > 10
    if what == "poa":
        assert ref[2] == [0] * 11
