"""Sample: ungapped X-drop seed extension of a genome against itself.

The port of samples/sample_extender.py (reference analogue:
cudaextender/samples/sample_cudaextender.cpp: FASTA + seed-pair CSV ->
extend -> scored segment pairs), on the CUDA card by default:

    python -m genomeworks_tpu_torch.samples.sample_extender [FASTA [SEEDS_CSV]] [--device cpu]

The seed CSV's rows are ``target_position,query_position``. The defaults
are the files the JAX sample reads, the reference's sample data, here
relative to a GenomeWorks checkout as the working directory. Prints the
first 10 scored segment pairs and their count.
"""

from __future__ import annotations

import argparse

from genomeworks_tpu_torch.extender import create_extender, encode_sequence, parse_seed_pairs
from genomeworks_tpu_torch.io import create_fasta_parser

DATA = "cudaextender/data"


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("fasta", nargs="?", default=f"{DATA}/sample.fa")
    ap.add_argument("seeds", nargs="?", default=f"{DATA}/sample_seed_pairs.csv")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    target = create_fasta_parser(args.fasta).get_sequence_by_id(0).seq
    query = target  # the sample extends the genome against itself

    seeds = parse_seed_pairs(args.seeds)
    extender = create_extender(device=args.device)
    extender.extend_async(encode_sequence(query), encode_sequence(target), 3000, seeds)
    extender.sync()
    ssps = extender.get_scored_segment_pairs()
    for s in ssps[:10]:
        print(s)
    print(f"{len(ssps)} scored segment pairs")


if __name__ == "__main__":
    main()
