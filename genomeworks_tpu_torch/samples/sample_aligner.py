"""Sample: batched pairwise global alignment with CIGARs.

The port of samples/sample_aligner.py (reference analogue:
cudaaligner/samples/sample_cudaaligner.cpp: create_aligner ->
add_alignment -> align_all -> print alignments), on the CUDA card by
default:

    python -m genomeworks_tpu_torch.samples.sample_aligner [--device cpu]
"""

from __future__ import annotations

import argparse

from genomeworks_tpu_torch.aligner import CigarFormat, create_aligner

PAIRS = [
    ("AAAAAAAAA", "AAATAAAAA"),
    ("ACGTACGTACGT", "ACGTACTTACGGT"),
    ("GATTACA", "GATCA"),
]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    aligner = create_aligner(max_bandwidth=256, device=args.device)
    for query, target in PAIRS:
        aligner.add_alignment(query, target)
    aligner.align_all()

    for (query, target), aln in zip(PAIRS, aligner.get_alignments()):
        print(f"{query} x {target}")
        print(f"  cigar: {aln.convert_to_cigar()}  "
              f"extended: {aln.convert_to_cigar(CigarFormat.extended)}  "
              f"edit distance: {aln.get_edit_distance()}")
        q_row, pairing, t_row = aln.format_alignment()
        print(f"  {q_row}\n  {pairing}\n  {t_row}")


if __name__ == "__main__":
    main()
