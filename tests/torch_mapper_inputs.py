"""Inputs and helpers shared by the port's mapper tests (CPU): simulated
reads on both strands from the port's simulators, written as FASTA files,
and the conversions that compare the port's overlaps with the JAX
package's."""

import dataclasses
import os
import random

import genomeworks_tpu.io as jio
import genomeworks_tpu.mapper.overlapper as jov
import genomeworks_tpu_torch.io as tio
from genomeworks_tpu_torch.core.sequence import reverse_complement
from genomeworks_tpu_torch.simulators import NoisyReadSimulator, PoissonGenomeSimulator


def simulated_reads(genome, n, length, seed, prefix):
    """n noisy reads of about ``length`` bases, every other one reverse
    complemented."""
    random.seed(seed)
    sim = NoisyReadSimulator()
    out = []
    for i in range(n):
        read, _, _ = sim.generate_read(
            genome, length + 40 * (i % 7), snv_error_rate=0.01,
            insertion_error_rate=0.005, deletion_error_rate=0.005)
        out.append((f"{prefix}{i}", reverse_complement(read) if i % 2 else read))
    return out


def write_fastas(directory) -> dict:
    """FASTA files in ``directory``: "reads" (40 reads of about 1.5 kb from a
    24-kb genome), "targets" (16 of about 1.8 kb from it), "align" (8 of
    about 500 bases), "short" (reads shorter than a window, k + w - 1) and
    "empty" (no read)."""
    genome = PoissonGenomeSimulator(4).build_reference(24000)
    paths = {}
    for name, n, length, seed, g in (("reads", 40, 1500, 1, genome),
                                     ("targets", 16, 1800, 2, genome),
                                     ("align", 8, 500, 3, genome[:2000])):
        paths[name] = os.path.join(directory, f"{name}.fa")
        tio.write_fasta(simulated_reads(g, n, length, seed, name[0]), paths[name])
    paths["short"] = os.path.join(directory, "short.fa")
    tio.write_fasta([("s0", "ACGTACGTAC"), ("s1", "ACGTAC")], paths["short"])
    paths["empty"] = os.path.join(directory, "empty.fa")
    open(paths["empty"], "w").close()
    return paths


def parsers(path):
    """The port's and the JAX package's parsers of one file."""
    return tio.create_fasta_parser(path), jio.create_fasta_parser(path)


def tuples(overlaps):
    return [dataclasses.astuple(o) for o in overlaps]


def to_jax(overlaps):
    return [jov.Overlap(*dataclasses.astuple(o)) for o in overlaps]
