"""Genome/read simulators (reference: pygenomeworks/genomeworks/simulators).

A copy of genomeworks_tpu/simulators/__init__.py (NumPy and the standard library only).
"""

from genomeworks_tpu_torch.simulators.genomesim import (
    generate_random_genome,
    generate_random_sequence,
    generate_random_sequences,
    mutate_sequence,
    PoissonGenomeSimulator,
    MarkovGenomeSimulator,
)
from genomeworks_tpu_torch.simulators.readsim import (
    NoisyReadSimulator,
    ReadSimulator,
    generate_overlaps,
)

NUCLEOTIDES = {"A", "C", "G", "T"}

# Markov transition presets (pygenomeworks simulators/__init__.py:22-59)
HIGH_GC_HOMOPOLYMERIC_TRANSITIONS = {
    "A": {"A": 0.25 * 3, "C": 0.25 * 1.25, "G": 0.25 * 1.25, "T": 0.25},
    "C": {"A": 0.25, "C": 0.25 * 3, "G": 0.25 * 1.25, "T": 0.25},
    "G": {"A": 0.25, "C": 0.25 * 1.25, "G": 0.25 * 1.25, "T": 0.25 * 3},
    "T": {"A": 0.25, "C": 0.25 * 3, "G": 0.25 * 3, "T": 0.25 * 1.25},
}

HOMOGENOUS_TRANSITIONS = {
    a: {b: 0.25 for b in "ACGT"} for a in "ACGT"
}
