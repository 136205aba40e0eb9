"""Genome/sequence simulators for tests and benchmarks.

A copy of genomeworks_tpu/simulators/genomesim.py (NumPy and the standard library only).

Reference: common/base/include/.../utils/genomeutils.hpp:33-144
(generate_random_genome / generate_random_sequence: mutate, insert, delete
off a backbone) and pygenomeworks/genomeworks/simulators/genomesim.py
(Poisson/Markov genome simulators).
"""

from __future__ import annotations

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def generate_random_genome(length: int, rng: np.random.Generator | None = None) -> str:
    """Uniform random ACGT genome (genomeutils.hpp:33)."""
    rng = rng or np.random.default_rng(0)
    return _BASES[rng.integers(0, 4, size=length)].tobytes().decode("ascii")


def mutate_sequence(
    backbone: str,
    rng: np.random.Generator | None = None,
    snv_rate: float = 0.02,
    indel_rate: float = 0.02,
    max_indel_len: int = 3,
) -> str:
    """Derive a mutated sequence from a backbone with substitutions and
    short indels (genomeutils.hpp:45 generate_random_sequence semantics)."""
    rng = rng or np.random.default_rng(0)
    out = []
    for ch in backbone:
        r = rng.random()
        if r < indel_rate / 2:
            # deletion: skip this base
            continue
        if r < indel_rate:
            # insertion: add 1..max_indel_len random bases then the base
            n = int(rng.integers(1, max_indel_len + 1))
            out.append(_BASES[rng.integers(0, 4, size=n)].tobytes().decode("ascii"))
        if rng.random() < snv_rate:
            out.append(chr(_BASES[rng.integers(0, 4)]))
        else:
            out.append(ch)
    return "".join(out)


class PoissonGenomeSimulator:
    """Uniform-base genome simulator
    (pygenomeworks genomesim.py:38 PoissonGenomeSimulator)."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)

    def build_reference(self, reference_length: int) -> str:
        return generate_random_genome(reference_length, self._rng)


class MarkovGenomeSimulator:
    """First-order Markov-chain genome simulator
    (pygenomeworks genomesim.py:59 MarkovGenomeSimulator)."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)

    def build_reference(
        self, reference_length: int, transitions: dict[str, dict[str, float]] | None = None
    ) -> str:
        bases = "ACGT"
        if transitions is None:
            probs = np.full((4, 4), 0.25)
        else:
            probs = np.array(
                [[transitions[a][b] for b in bases] for a in bases], dtype=np.float64
            )
            probs /= probs.sum(axis=1, keepdims=True)
        out = np.empty(reference_length, dtype=np.uint8)
        state = int(self._rng.integers(0, 4))
        for i in range(reference_length):
            state = int(self._rng.choice(4, p=probs[state]))
            out[i] = _BASES[state]
        return out.tobytes().decode("ascii")


def generate_random_sequence(
    backbone: str,
    rng: np.random.Generator,
    max_mutations: int,
    max_insertions: int,
    max_deletions: int,
) -> str:
    """Randomly mutated copy of ``backbone``: up to max_deletions single
    deletions, max_insertions single insertions, max_mutations
    substitutions, each applied with probability 1/2 like the reference
    (common/base/include/.../utils/genomeutils.hpp:45-110)."""
    if min(max_mutations, max_insertions, max_deletions) < 0:
        raise ValueError("mutation counts cannot be negative")
    seq = list(backbone)
    bases = "ACGT"
    for _ in range(min(max_deletions, len(seq))):
        if len(seq) and rng.random() < 0.5:
            del seq[int(rng.integers(0, len(seq)))]
    for _ in range(max_insertions):
        if rng.random() < 0.5:
            seq.insert(int(rng.integers(0, len(seq) + 1)), bases[int(rng.integers(4))])
    for _ in range(min(max_mutations, len(seq))):
        if len(seq) and rng.random() < 0.5:
            seq[int(rng.integers(0, len(seq)))] = bases[int(rng.integers(4))]
    return "".join(seq)


def generate_random_sequences(
    backbone: str,
    n: int,
    rng: np.random.Generator,
    max_mutations: int = 1,
    max_insertions: int = 1,
    max_deletions: int = 1,
) -> list[str]:
    """n random variations of a backbone; the first entry is the backbone
    itself (genomeutils.hpp:127-141)."""
    if not backbone:
        raise ValueError("backbone cannot be empty")
    sequences = [backbone]
    for _ in range(n - 1):
        sequences.append(
            generate_random_sequence(
                backbone, rng, max_mutations, max_insertions, max_deletions
            )
        )
    return sequences
