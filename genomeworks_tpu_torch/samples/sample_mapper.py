"""Sample: all-vs-all overlap mapping to PAF.

The port of samples/sample_mapper.py (reference analogue:
cudamapper/samples/sample_cudamapper.cpp: index -> matcher -> overlapper
-> PAF), on the CUDA card by default:

    python -m genomeworks_tpu_torch.samples.sample_mapper [FASTA] [--device cpu]

The default FASTA is the one the JAX sample reads, the reference's sample
data, here relative to a GenomeWorks checkout as the working directory.
Prints the PAF lines, and the overlap count to standard error.
"""

from __future__ import annotations

import argparse
import sys

from genomeworks_tpu_torch.io import create_fasta_parser
from genomeworks_tpu_torch.mapper import MapperParams, map_reads, overlaps_to_paf


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("fasta", nargs="?", default="cudamapper/data/covid-reads.fasta.gz")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    parser = create_fasta_parser(args.fasta, min_sequence_length=24)
    # the reference sample's parameters: k=15, w=5
    params = MapperParams(kmer_size=15, window_size=5)
    overlaps = map_reads(parser, parser, params, all_to_all=True, device=args.device)
    for line in overlaps_to_paf(overlaps, parser, parser, params.kmer_size):
        print(line)
    print(f"{len(overlaps)} overlaps", file=sys.stderr)


if __name__ == "__main__":
    main()
