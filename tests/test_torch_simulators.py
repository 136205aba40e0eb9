"""The port's simulators and PAF I/O against the JAX package's: the same seeds
give the same genomes, reads and truth overlaps, and PAF files are read and
written to the same bytes. Every comparison is exact."""

import dataclasses
import random

import numpy as np
import pytest

import genomeworks_tpu.io.paf as jpaf
import genomeworks_tpu.simulators as jsim
import genomeworks_tpu_torch.io.paf as tpaf
import genomeworks_tpu_torch.simulators as tsim


def test_presets_and_nucleotides_match():
    assert tsim.NUCLEOTIDES == jsim.NUCLEOTIDES
    assert tsim.HIGH_GC_HOMOPOLYMERIC_TRANSITIONS == jsim.HIGH_GC_HOMOPOLYMERIC_TRANSITIONS
    assert tsim.HOMOGENOUS_TRANSITIONS == jsim.HOMOGENOUS_TRANSITIONS


@pytest.mark.parametrize("seed", [0, 5])
def test_genomesim_matches_jax(seed):
    assert tsim.generate_random_genome(3000, np.random.default_rng(seed)) == \
        jsim.generate_random_genome(3000, np.random.default_rng(seed))
    backbone = jsim.generate_random_genome(500, np.random.default_rng(seed + 1))
    assert tsim.mutate_sequence(backbone, np.random.default_rng(seed), 0.05, 0.05, 4) == \
        jsim.mutate_sequence(backbone, np.random.default_rng(seed), 0.05, 0.05, 4)
    assert tsim.generate_random_sequences(backbone, 6, np.random.default_rng(seed), 3, 2, 2) == \
        jsim.generate_random_sequences(backbone, 6, np.random.default_rng(seed), 3, 2, 2)
    assert tsim.PoissonGenomeSimulator(seed).build_reference(2000) == \
        jsim.PoissonGenomeSimulator(seed).build_reference(2000)
    for transitions in (None, "HIGH_GC_HOMOPOLYMERIC_TRANSITIONS", "HOMOGENOUS_TRANSITIONS"):
        t = transitions and getattr(tsim, transitions)
        assert tsim.MarkovGenomeSimulator(seed).build_reference(600, t) == \
            jsim.MarkovGenomeSimulator(seed).build_reference(600, t)


def test_generate_random_sequence_rejects_negative_counts():
    for mod in (tsim, jsim):
        with pytest.raises(ValueError):
            mod.generate_random_sequence("ACGT", np.random.default_rng(0), -1, 0, 0)
        with pytest.raises(ValueError):
            mod.generate_random_sequences("", 2, np.random.default_rng(0))


def _reads(mod, genome, seed, n=12):
    random.seed(seed)
    sim = mod.NoisyReadSimulator()
    out = []
    for i in range(n):
        read, start, end = sim.generate_read(genome, 700 + 37 * i)
        out.append((f"read{i}", read, start, end))
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_readsim_and_truth_overlaps_match_jax(seed):
    genome = tsim.generate_random_genome(6000, np.random.default_rng(seed))
    reads_t = _reads(tsim, genome, seed)
    reads_j = _reads(jsim, genome, seed)
    assert reads_t == reads_j
    with pytest.raises(NotImplementedError):
        tsim.ReadSimulator().generate_read(genome, 10)
    truth_t = tsim.generate_overlaps(reads_t)
    truth_j = jsim.generate_overlaps(reads_j)
    assert len(truth_t) > 0
    assert [dataclasses.astuple(r) for r in truth_t] == [dataclasses.astuple(r) for r in truth_j]
    assert [r.to_line() for r in truth_t] == [r.to_line() for r in truth_j]


def test_paf_read_write_same_bytes(tmp_path):
    genome = tsim.generate_random_genome(5000, np.random.default_rng(3))
    records = tsim.generate_overlaps(_reads(tsim, genome, 3))
    records[0].tags = {"cg": "10M2I5M", "tp": "P"}
    path_t, path_j = tmp_path / "t.paf", tmp_path / "j.paf"
    tpaf.write_paf(records, path_t)
    jpaf.write_paf([jpaf.PafRecord(**dataclasses.asdict(r)) for r in records], path_j)
    assert path_t.read_bytes() == path_j.read_bytes()
    back_t, back_j = tpaf.read_paf(path_t), jpaf.read_paf(path_j)
    assert [dataclasses.astuple(r) for r in back_t] == [dataclasses.astuple(r) for r in back_j]
    assert [dataclasses.astuple(r) for r in back_t] == [dataclasses.astuple(r) for r in records]
    args = ("q", 1000, 10, 900, "-", "t", 2000, 50, 930, 40, 15)
    assert tpaf.overlap_to_paf_line(*args) == jpaf.overlap_to_paf_line(*args)
    assert tpaf.overlap_to_paf_line(*args, "5M") == jpaf.overlap_to_paf_line(*args, "5M")
