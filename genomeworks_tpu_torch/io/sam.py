"""SAM output for overlaps.

A copy of genomeworks_tpu/io/sam.py (NumPy and the standard library only).

Reference: cudamapper/src/utils.cpp:190-316 print_sam (htslib-backed,
behind GW_BUILD_HTSLIB). This build writes spec-conformant plain-text SAM
directly — no htslib dependency — and by default fixes two reference
quirks: FLAG reflects the overlap strand (0/16 instead of always 0) and
POS is the 1-based target start (the reference stores the query start).
``reference_quirks=True`` reproduces the reference's exact FLAG/POS
behavior for byte-compatibility with cudamapper's SAM output.
"""

from __future__ import annotations

from typing import IO, Sequence

from genomeworks_tpu_torch.mapper.overlapper import Overlap


def write_sam(
    overlaps: Sequence[Overlap],
    cigars: Sequence[str] | None,
    query_parser,
    target_parser,
    out: IO[str],
    command_line: str | None = None,
    version: str = "0.1.0",
    reference_quirks: bool = False,
) -> None:
    """Write overlaps as SAM records (header: @HD, @SQ per referenced
    target, @PG; record: QNAME FLAG RNAME POS MAPQ CIGAR RNEXT PNEXT TLEN
    SEQ QUAL)."""
    out.write("@HD\tVN:1.6\tSO:unknown\n")
    seen: set[int] = set()
    for o in overlaps:
        if o.target_read_id not in seen:
            seen.add(o.target_read_id)
            t = target_parser.get_sequence_by_id(o.target_read_id)
            out.write(f"@SQ\tSN:{t.name}\tLN:{len(t.seq)}\n")
    pg = f"@PG\tID:gw-mapper\tPN:gw-mapper\tVN:{version}"
    if command_line:
        pg += f"\tCL:{command_line}"
    out.write(pg + "\n")

    for i, o in enumerate(overlaps):
        q = query_parser.get_sequence_by_id(o.query_read_id)
        t = target_parser.get_sequence_by_id(o.target_read_id)
        if reference_quirks:
            # cudamapper utils.cpp: FLAG always 0, POS = query start
            flag = 0
            pos = o.query_start_position_in_read + 1
        else:
            flag = 0 if o.relative_strand == "+" else 16
            pos = o.target_start_position_in_read + 1
        cigar = cigars[i] if cigars and i < len(cigars) and cigars[i] else "*"
        out.write(
            "\t".join(
                (
                    q.name,
                    str(flag),
                    t.name,
                    str(pos),
                    "255",
                    cigar,
                    "*",
                    "0",
                    "0",
                    q.seq,
                    "*",
                )
            )
            + "\n"
        )
