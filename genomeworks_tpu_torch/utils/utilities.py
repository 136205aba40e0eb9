"""Small utility functions; a copy of genomeworks_tpu/utils/utilities.py
(the standard library only).

Reference: pygenomeworks/genomeworks/utilities/utilities.py (gfa2fa via an
awk pipeline, quast error-report parsing). gfa2fa here is pure Python.
"""

from __future__ import annotations


def gfa2fa(gfa_filepath: str, fa_filepath: str, line_width: int = 80) -> None:
    """Convert a GFA file's S (segment) lines into FASTA records
    (utilities.py:28-42)."""
    with open(gfa_filepath) as gfa, open(fa_filepath, "w") as fa:
        for line in gfa:
            if not line.startswith("S"):
                continue
            cols = line.rstrip("\n").split("\t")
            name, seq = cols[1], cols[2]
            fa.write(f">{name}\n")
            for i in range(0, len(seq), line_width):
                fa.write(seq[i : i + line_width] + "\n")


def calculate_error(report_filepath: str) -> float:
    """Error rate (%) from a quast report.txt — mismatches + indels per
    100 kbp (utilities.py:44-56)."""
    with open(report_filepath) as f:
        lines = [line.rstrip("\n") for line in f]
    mismatch = next(l for l in lines if l.startswith("# mismatches")).split()
    indels = next(l for l in lines if l.startswith("# indels")).split()
    return (float(mismatch[-1]) + float(indels[-1])) / 10**5 * 100
