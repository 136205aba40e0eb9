"""FASTA/FASTQ parsing.

Reference: common/io/include/.../io/fasta_parser.hpp:34-68 (``FastaSequence``,
``FastaParser``, ``create_kseq_fasta_parser``) and
common/io/src/kseqpp_fasta_parser.cpp:40-72 (eager whole-file parse, drops
reads shorter than ``min_sequence_length``, optional deterministic shuffle
for load balance).

A copy of genomeworks_tpu/io/fasta.py: a pure-Python eager parser
supporting FASTA and FASTQ, plain or gzip-compressed, multi-line records,
and ``NativeFastaParser`` over the native C++ parser (``io/native.py``,
native/gwio.cpp), which ``create_fasta_parser`` takes when it is built.
"""

from __future__ import annotations

import dataclasses
import gzip
from pathlib import Path


@dataclasses.dataclass
class FastaSequence:
    """One record: name + sequence (reference: fasta_parser.hpp:34)."""

    name: str
    seq: str


class FastaParser:
    """Random-access in-memory view of a FASTA/FASTQ file.

    Mirrors the reference interface (fasta_parser.hpp:45): number of reads,
    get-by-id, and largest-read query.
    """

    def __init__(self, sequences: list[FastaSequence]):
        self._sequences = sequences

    def get_num_seqences(self) -> int:  # reference spelling kept in spirit
        return len(self._sequences)

    def __len__(self) -> int:
        return len(self._sequences)

    def get_sequence_by_id(self, read_id: int) -> FastaSequence:
        return self._sequences[read_id]

    def get_max_sequence_length(self) -> int:
        return max((len(s.seq) for s in self._sequences), default=0)

    def sequences(self) -> list[FastaSequence]:
        return self._sequences


def _open_maybe_gz(path: str | Path):
    path = Path(path)
    if path.suffix == ".gz":
        return gzip.open(path, "rt")
    return open(path, "rt")


def _parse_records(fh) -> list[FastaSequence]:
    records: list[FastaSequence] = []
    name = None
    seq_parts: list[str] = []
    line_iter = iter(fh)
    for line in line_iter:
        line = line.rstrip("\n\r")
        if not line:
            continue
        if line[0] == ">":
            if name is not None:
                records.append(FastaSequence(name, "".join(seq_parts)))
            name = line[1:].split()[0] if len(line) > 1 else ""
            seq_parts = []
        elif line[0] == "@" and name is None and not seq_parts:
            # FASTQ: 4-line records (kseq handles both formats)
            qname = line[1:].split()[0]
            seq = next(line_iter).rstrip("\n\r")
            next(line_iter)  # '+'
            next(line_iter)  # quality
            records.append(FastaSequence(qname, seq))
        elif line[0] == "@" and name is None:
            qname = line[1:].split()[0]
            seq = next(line_iter).rstrip("\n\r")
            next(line_iter)
            next(line_iter)
            records.append(FastaSequence(qname, seq))
        else:
            seq_parts.append(line)
    if name is not None:
        records.append(FastaSequence(name, "".join(seq_parts)))
    return records


class NativeFastaParser(FastaParser):
    """FastaParser backed by the native C++ parser (native/gwio.cpp) —
    records are materialized lazily; bulk 2-bit packing runs in native
    threads via :meth:`pack_2bit`."""

    def __init__(self, handle):
        self._handle = handle
        self._cache: dict[int, FastaSequence] = {}

    def get_num_seqences(self) -> int:
        return len(self._handle)

    def __len__(self) -> int:
        return len(self._handle)

    def get_sequence_by_id(self, read_id: int) -> FastaSequence:
        rec = self._cache.get(read_id)
        if rec is None:
            rec = FastaSequence(self._handle.name(read_id), self._handle.seq(read_id))
            self._cache[read_id] = rec
        return rec

    def get_max_sequence_length(self) -> int:
        return self._handle.max_len()

    def sequences(self) -> list[FastaSequence]:
        return [self.get_sequence_by_id(i) for i in range(len(self))]

    def pack_2bit(self, first: int = 0, n: int | None = None, max_len: int | None = None):
        if n is None:
            n = len(self) - first
        return self._handle.pack_2bit(first, n, max_len)


def create_fasta_parser(
    path: str | Path,
    min_sequence_length: int = 0,
    shuffle: bool = False,
    seed: int = 0,
    use_native: bool | None = None,
) -> FastaParser:
    """Parse a FASTA/FASTQ(.gz) file eagerly.

    ``min_sequence_length`` drops short reads and ``shuffle`` applies a
    deterministic permutation for load balance, mirroring
    kseqpp_fasta_parser.cpp:40-72 (which uses std::mt19937(0); we use a
    seeded permutation — the *set* of reads is identical).

    The native C++ parser (native/gwio.cpp, the counterpart of the
    reference's kseq++ path) is used when built; ``use_native=False``
    takes the pure-Python parser, and ``use_native=True`` raises when the
    native one is unavailable. Both are host parsers: this is not a device
    fallback.
    """
    import numpy as np

    if use_native is None or use_native:
        from genomeworks_tpu_torch.io.native import NativeFastaHandle, native_available

        if native_available():
            return NativeFastaParser(
                NativeFastaHandle(str(path), min_sequence_length, shuffle)
            )
        if use_native:
            raise RuntimeError("native gwio library unavailable")

    with _open_maybe_gz(path) as fh:
        records = _parse_records(fh)
    records = [r for r in records if len(r.seq) >= min_sequence_length]
    if shuffle:
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(records))
        records = [records[i] for i in order]
    return FastaParser(records)


def write_fasta(sequences: list[tuple[str, str]], path: str | Path, line_width: int = 80) -> None:
    """Write (name, seq) pairs as FASTA (reference: pygenomeworks fastaio.py:22)."""
    with open(path, "w") as fh:
        for name, seq in sequences:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), line_width):
                fh.write(seq[i : i + line_width] + "\n")
