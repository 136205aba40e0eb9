"""Minimizer index (reference: cudamapper's IndexGPU,
cudamapper/src/index_gpu.cuh). Counterpart of genomeworks_tpu/mapper/index.py.

An Index holds sketch elements sorted by (representation, read_id,
position) (the reference's stable sort by representation over read-grouped
input, index_gpu.cuh:926-935, is the same order), plus the unique
representations, their first occurrences
(find_first_occurrences_of_representations, index_gpu.cuh:226), and optional
filtering of over-frequent representations
(filter_out_most_common_representations, index_gpu.cuh:438: drop
representations with count >= total * filtering_parameter + 0.001).

The host-side object holds NumPy arrays; the sketch runs on the given
device and NumPy does the rest, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from genomeworks_tpu_torch.core.sequence import pack_reads
from genomeworks_tpu_torch.io.fasta import FastaParser
from genomeworks_tpu_torch.mapper.minimizers import compute_sketch, sketch_to_numpy


@dataclasses.dataclass
class Index:
    """Sorted sketch-element index (reference: Index interface,
    cudamapper/include/.../index.hpp:84-177)."""

    representations: np.ndarray  # (N,) uint32, sorted
    read_ids: np.ndarray  # (N,) uint32
    positions_in_reads: np.ndarray  # (N,) uint32
    directions_of_reads: np.ndarray  # (N,) uint8 (0=forward, 1=reverse)
    unique_representations: np.ndarray  # (U,) uint32
    first_occurrence_of_representations: np.ndarray  # (U+1,) uint32
    number_of_reads: int
    first_read_id: int
    kmer_size: int
    window_size: int
    number_of_basepairs_in_longest_read: int
    read_id_to_read_names: list[str] = dataclasses.field(default_factory=list)
    read_id_to_read_lengths: np.ndarray | None = None

    def number_of_sketch_elements(self) -> int:
        return len(self.representations)


def index_from_numpy(other) -> Index:
    """The port's Index holding copies of the arrays of any object with the
    Index fields: the JAX package's ``Index``, or the host index its
    ``DeviceIndex.to_host()`` gives."""
    kw = {}
    for f in dataclasses.fields(Index):
        v = getattr(other, f.name)
        kw[f.name] = np.array(v) if isinstance(v, np.ndarray) else v
    kw["read_id_to_read_names"] = list(other.read_id_to_read_names)
    return Index(**kw)


def _unique_and_first_occurrence(reps: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """unique reps + first occurrence indices with total appended
    (reference: find_first_occurrences_of_representations)."""
    if len(reps) == 0:
        return np.zeros(0, np.uint32), np.zeros(1, np.uint32)
    flag = np.empty(len(reps), dtype=bool)
    flag[0] = True
    np.not_equal(reps[1:], reps[:-1], out=flag[1:])
    first = np.nonzero(flag)[0].astype(np.uint32)
    uniq = reps[first]
    first = np.concatenate([first, np.array([len(reps)], np.uint32)])
    return uniq, first


def filter_most_common(
    reps, rids, poss, dirs, filtering_parameter: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Drop sketch elements whose representation count >= total *
    filtering_parameter + 0.001 (index_gpu.cuh:438-470)."""
    total = len(reps)
    if total == 0 or filtering_parameter >= 1.0:
        return reps, rids, poss, dirs
    uniq, first = _unique_and_first_occurrence(reps)
    counts = np.diff(first.astype(np.int64))
    # reference formula (index_gpu.cuh:468), truncated to an integer
    threshold = int(total * filtering_parameter + 0.001)
    keep_rep = counts < threshold
    keep = np.repeat(keep_rep, counts)
    return reps[keep], rids[keep], poss[keep], dirs[keep]


def read_range(parser: FastaParser, first_read_id: int, past_the_last_read_id: int):
    """(names, lengths, sequences) of reads [first, past_last)."""
    names, lengths, seqs = [], [], []
    for rid in range(first_read_id, past_the_last_read_id):
        s = parser.get_sequence_by_id(rid)
        names.append(s.name)
        lengths.append(len(s.seq))
        seqs.append(s.seq)
    return names, lengths, seqs


def build_index(
    parser: FastaParser,
    first_read_id: int,
    past_the_last_read_id: int,
    kmer_size: int = 15,
    window_size: int = 10,
    hash_representations: bool = True,
    filtering_parameter: float = 1.0,
    batch_size: int = 2048,
    device: str | torch.device | None = None,
) -> Index:
    """Build an index over reads [first_read_id, past_the_last_read_id):
    the sketch on ``device`` (``None`` = the CUDA card), the sort, filter
    and unique in NumPy.

    Reads shorter than window_size + kmer_size - 1 are skipped
    (index_gpu.cuh:835) but keep their global read ids.
    """
    names, lengths_all, seqs = read_range(parser, first_read_id, past_the_last_read_id)

    all_reps, all_rids, all_poss, all_dirs = [], [], [], []
    longest = 0
    min_len = window_size + kmer_size - 1
    for start in range(0, len(seqs), batch_size):
        chunk = seqs[start : start + batch_size]
        longest = max(longest, max((len(s) for s in chunk), default=0))
        # padding past a read's length emits nothing, so the chunk is packed
        # at its longest read (the JAX package pads to a power of two)
        max_len = max(max((len(s) for s in chunk), default=1), min_len)
        mat, lens = pack_reads(chunk, max_len=max_len)
        reps, poss, dirs, emit = compute_sketch(
            mat, lens, kmer_size, window_size, hash_representations, device=device,
        )
        r, i, p, d = sketch_to_numpy(reps, poss, dirs, emit, first_read_id + start)
        all_reps.append(r)
        all_rids.append(i)
        all_poss.append(p)
        all_dirs.append(d)

    reps = np.concatenate(all_reps) if all_reps else np.zeros(0, np.uint32)
    rids = np.concatenate(all_rids) if all_rids else np.zeros(0, np.uint32)
    poss = np.concatenate(all_poss) if all_poss else np.zeros(0, np.uint32)
    dirs = np.concatenate(all_dirs) if all_dirs else np.zeros(0, np.uint8)

    # lexicographic sort by (rep, read_id, position)
    order = np.lexsort((poss, rids, reps))
    reps, rids, poss, dirs = reps[order], rids[order], poss[order], dirs[order]

    if filtering_parameter < 1.0:
        reps, rids, poss, dirs = filter_most_common(
            reps, rids, poss, dirs, filtering_parameter
        )

    uniq, first = _unique_and_first_occurrence(reps)

    return Index(
        representations=reps,
        read_ids=rids,
        positions_in_reads=poss,
        directions_of_reads=dirs,
        unique_representations=uniq,
        first_occurrence_of_representations=first,
        number_of_reads=past_the_last_read_id - first_read_id,
        first_read_id=first_read_id,
        kmer_size=kmer_size,
        window_size=window_size,
        number_of_basepairs_in_longest_read=longest,
        read_id_to_read_names=names,
        read_id_to_read_lengths=np.array(lengths_all, dtype=np.int64),
    )
