"""gw-alignment-visualizer — render alignment paths through the DP matrix.

A copy of genomeworks_tpu/tools/alignment_visualizer.py (NumPy, and
matplotlib for a PNG). Reference: pygenomeworks/bin/alignment_visualizer
(expand_cigar, fill_alignment_matrix_with_cigar, matplotlib matshow). This
build renders with matplotlib when available and falls back to ASCII art
otherwise.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def expand_cigar(cigar: str) -> list[str]:
    """Expand '3M1I2M' -> ['M','M','M','I','M','M']
    (alignment_visualizer:28-43)."""
    out: list[str] = []
    num = ""
    for c in cigar:
        if c.isdigit():
            num += c
        else:
            out.extend([c] * int(num))
            num = ""
    return out


def fill_alignment_matrix_with_cigar(
    alignment_matrix: np.ndarray, cigar: str, val: int
) -> None:
    """Trace the CIGAR path from the matrix origin, storing ``val`` at each
    visited cell (alignment_visualizer:46-71). Query consumes rows, target
    consumes columns; '=' and 'X' behave like 'M'."""
    i = j = 0
    alignment_matrix[i, j] = val
    for op in expand_cigar(cigar):
        if op in ("M", "=", "X"):
            i += 1
            j += 1
        elif op == "I":
            j += 1
        elif op == "D":
            i += 1
        else:
            raise RuntimeError(f"Unknown operation type - {op}")
        alignment_matrix[i, j] = val


def alignment_matrix(query: str, target: str, cigars: list[str]) -> np.ndarray:
    m = np.zeros((len(query) + 1, len(target) + 1))
    for i, cigar in enumerate(cigars):
        fill_alignment_matrix_with_cigar(m, cigar, i + 1)
    return m


def render_ascii(query: str, target: str, cigars: list[str]) -> str:
    m = alignment_matrix(query, target, cigars)
    header = "   " + " ".join(list(" " + target))
    lines = [header]
    qlabels = " " + query
    for i in range(m.shape[0]):
        row = " ".join("*" if m[i, j] else "." for j in range(m.shape[1]))
        lines.append(f"{qlabels[i]}  {row}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="gw-alignment-visualizer",
        description="visualize CIGAR alignment paths through the DP matrix",
    )
    p.add_argument("query")
    p.add_argument("target")
    p.add_argument("cigars", nargs="+")
    p.add_argument("-o", "--output", help="write a PNG (requires matplotlib)")
    args = p.parse_args(argv)

    if args.output:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib not available; use ASCII mode", file=sys.stderr)
            return 1
        fig, axes = plt.subplots()
        cax = axes.matshow(alignment_matrix(args.query, args.target, args.cigars))
        fig.colorbar(cax)
        axes.set_xticks(range(len(args.target) + 1))
        axes.set_yticks(range(len(args.query) + 1))
        axes.set_xticklabels([""] + list(args.target))
        axes.set_yticklabels([""] + list(args.query))
        fig.savefig(args.output, dpi=150, bbox_inches="tight")
        print(f"wrote {args.output}")
    else:
        print(render_ascii(args.query, args.target, args.cigars))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
