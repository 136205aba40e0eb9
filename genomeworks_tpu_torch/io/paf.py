"""PAF reading/writing.

A copy of genomeworks_tpu/io/paf.py (NumPy and the standard library only).

Reference: cudamapper/src/utils.cpp:41-120 (print_paf column layout:
qname qlen qstart qend strand tname tlen tstart tend
residues*kmer_size max(span_q, span_t) 255 [cg:Z:cigar]) and
pygenomeworks/genomeworks/io/pafio.py:150-164 (reader/writer records).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterable


@dataclasses.dataclass
class PafRecord:
    query_sequence_name: str
    query_sequence_length: int
    query_start: int
    query_end: int
    relative_strand: str  # '+' or '-'
    target_sequence_name: str
    target_sequence_length: int
    target_start: int
    target_end: int
    num_residue_matches: int
    alignment_block_length: int
    mapping_quality: int
    tags: dict[str, str] = dataclasses.field(default_factory=dict)

    def to_line(self) -> str:
        cols = [
            self.query_sequence_name,
            str(self.query_sequence_length),
            str(self.query_start),
            str(self.query_end),
            self.relative_strand,
            self.target_sequence_name,
            str(self.target_sequence_length),
            str(self.target_start),
            str(self.target_end),
            str(self.num_residue_matches),
            str(self.alignment_block_length),
            str(self.mapping_quality),
        ]
        for k, v in self.tags.items():
            cols.append(f"{k}:Z:{v}")
        return "\t".join(cols)


def parse_paf_line(line: str) -> PafRecord:
    cols = line.rstrip("\n").split("\t")
    tags = {}
    for tag in cols[12:]:
        parts = tag.split(":", 2)
        if len(parts) == 3:
            tags[parts[0]] = parts[2]
    return PafRecord(
        query_sequence_name=cols[0],
        query_sequence_length=int(cols[1]),
        query_start=int(cols[2]),
        query_end=int(cols[3]),
        relative_strand=cols[4],
        target_sequence_name=cols[5],
        target_sequence_length=int(cols[6]),
        target_start=int(cols[7]),
        target_end=int(cols[8]),
        num_residue_matches=int(cols[9]),
        alignment_block_length=int(cols[10]),
        mapping_quality=int(cols[11]),
        tags=tags,
    )


def read_paf(path: str | Path) -> list[PafRecord]:
    with open(path) as fh:
        return [parse_paf_line(l) for l in fh if l.strip()]


def write_paf(records: Iterable[PafRecord], path: str | Path) -> None:
    with open(path, "w") as fh:
        for r in records:
            fh.write(r.to_line() + "\n")


def overlap_to_paf_line(
    query_name: str,
    query_length: int,
    query_start: int,
    query_end: int,
    relative_strand: str,
    target_name: str,
    target_length: int,
    target_start: int,
    target_end: int,
    num_residues: int,
    kmer_size: int,
    cigar: str | None = None,
) -> str:
    """Format one overlap exactly as the reference's print_paf
    (cudamapper/src/utils.cpp:88-110): residue matches are reported as
    num_residues * kmer_size, alignment length as the larger of the query
    and target spans, and mapping quality fixed at 255.
    """
    aln_len = max(abs(target_start - target_end), abs(query_start - query_end))
    line = (
        f"{query_name}\t{query_length}\t{query_start}\t{query_end}\t{relative_strand}\t"
        f"{target_name}\t{target_length}\t{target_start}\t{target_end}\t"
        f"{num_residues * kmer_size}\t{aln_len}\t255"
    )
    if cigar is not None:
        line += f"\tcg:Z:{cigar}"
    return line
