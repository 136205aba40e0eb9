"""gw-genome-simulator — simulate a reference, noisy reads, and truth PAF.

The port of genomeworks_tpu/tools/genome_simulator.py, on the port's io
and simulators. Reference: pygenomeworks/bin/genome_simulator (Markov
genome + noisy read simulation + ground-truth overlap PAF).
"""

from __future__ import annotations

import argparse
import random

from genomeworks_tpu_torch.io.fasta import write_fasta
from genomeworks_tpu_torch.io.paf import write_paf
from genomeworks_tpu_torch.simulators.genomesim import MarkovGenomeSimulator
from genomeworks_tpu_torch.simulators.readsim import NoisyReadSimulator, generate_overlaps


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="gw-genome-simulator",
        description="create a reference, noisy reads, and a truth overlap PAF",
    )
    p.add_argument("--reference-length", type=int, default=1_000_000)
    p.add_argument("--reference-filepath", default="ref.fasta")
    p.add_argument("--reads-filepath", default="reads.fasta")
    p.add_argument("--paf-filepath", default="overlaps.paf")
    p.add_argument("--random-seed", type=int, default=0)
    p.add_argument("--median-read-length", type=int, default=10000)
    p.add_argument("--snv-error-rate", type=float, default=0.025)
    p.add_argument("--insertion-error-rate", type=float, default=0.0125)
    p.add_argument("--deletion-error-rate", type=float, default=0.0125)
    p.add_argument("--num-reads", type=int, default=100)
    args = p.parse_args(argv)

    random.seed(args.random_seed)
    reference = MarkovGenomeSimulator(seed=args.random_seed).build_reference(
        args.reference_length
    )
    write_fasta([("ref", reference)], args.reference_filepath)

    simulator = NoisyReadSimulator()
    reads: list[tuple[str, str, int, int]] = []
    for i in range(args.num_reads):
        read, start, end = simulator.generate_read(
            reference,
            median_length=args.median_read_length,
            snv_error_rate=args.snv_error_rate,
            insertion_error_rate=args.insertion_error_rate,
            deletion_error_rate=args.deletion_error_rate,
        )
        reads.append((f"read_{i}", read, start, end))

    write_fasta([(r[0], r[1]) for r in reads], args.reads_filepath)
    write_paf(generate_overlaps(reads), args.paf_filepath)
    print(
        f"wrote {args.reference_filepath} ({len(reference)} bp), "
        f"{args.reads_filepath} ({len(reads)} reads), {args.paf_filepath}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
