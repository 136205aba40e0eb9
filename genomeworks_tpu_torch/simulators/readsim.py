"""Noisy read simulation + ground-truth overlap generation.

A copy of genomeworks_tpu/simulators/readsim.py (NumPy and the standard library only).

Reference: pygenomeworks/genomeworks/simulators/readsim.py
(NoisyReadSimulator :112 with SNV/insertion/deletion/homopolymer-clip
error channels; generate_overlaps :30 building truth PAF records from
read placements on the reference).
"""

from __future__ import annotations

import random

from genomeworks_tpu_torch.io.paf import PafRecord

NUCLEOTIDES = {"A", "C", "G", "T"}


def generate_overlaps(seqs: list[tuple[str, str, int, int]]) -> list[PafRecord]:
    """Ground-truth overlaps from read placements. ``seqs`` holds
    (read_id, sequence, reference_start, reference_end) tuples; any two
    reads whose reference intervals intersect yield one PAF record
    (readsim.py:30-101)."""
    overlaps: list[PafRecord] = []
    sorted_seqs = sorted(seqs, key=lambda read: read[2])
    for query_index, query in enumerate(sorted_seqs):
        query_name, query_seq, query_ref_start, query_ref_end = query
        query_seq_len = len(query_seq)
        for target in sorted_seqs[query_index + 1 :]:
            target_name, target_seq, target_ref_start, target_ref_end = target
            if query_ref_end > target_ref_start:
                target_seq_len = len(target_seq)
                query_start = target_ref_start - query_ref_start
                target_start = 0
                if target_ref_end > query_ref_end:
                    query_end = query_seq_len
                    target_end = query_ref_end - target_ref_start
                else:
                    target_end = target_seq_len
                    query_end = query_start + target_seq_len
                overlaps.append(
                    PafRecord(
                        query_sequence_name=query_name,
                        query_sequence_length=query_seq_len,
                        query_start=query_start,
                        query_end=query_end,
                        relative_strand="+",
                        target_sequence_name=target_name,
                        target_sequence_length=target_seq_len,
                        target_start=target_start,
                        target_end=target_end,
                        num_residue_matches=1,
                        alignment_block_length=-1,
                        mapping_quality=255,
                    )
                )
    return overlaps


class ReadSimulator:
    """Base class for read simulators (readsim.py:104)."""

    def generate_read(self, reference, median_length, **kwargs):
        raise NotImplementedError


class NoisyReadSimulator(ReadSimulator):
    """Simulates sequencing errors: SNVs, insertions, deletions, and
    homopolymer clipping (readsim.py:112)."""

    def _add_snv_errors(self, read: str, error_rate: float) -> str:
        out = []
        for r in read:
            if random.uniform(0, 1) > error_rate:
                out.append(r)
            else:
                out.append(random.choice(tuple(NUCLEOTIDES ^ {r})))
        return "".join(out)

    def _add_deletion_errors(self, read: str, error_rate: float) -> str:
        return "".join(r for r in read if random.uniform(0, 1) > error_rate)

    def _add_insertion_errors(self, read: str, error_rate: float) -> str:
        out = []
        for r in read:
            out.append(r)
            if random.uniform(0, 1) <= error_rate:
                out.append(random.choice(tuple(NUCLEOTIDES)))
        return "".join(out)

    def _add_homopolymer_clipping(
        self, read: str, homopolymer_survival_length: int, clip_rate: float
    ) -> str:
        if not read:
            return read
        homopolymer_len = 1
        prev = read[0]
        out = [prev]
        for r in read[1:]:
            if r == prev:
                homopolymer_len += 1
                if homopolymer_len > homopolymer_survival_length:
                    if random.uniform(0, 1) > clip_rate:
                        out.append(r)
                else:
                    out.append(r)
            else:
                prev = r
                homopolymer_len = 1
                out.append(r)
        return "".join(out)

    def generate_read(
        self,
        reference: str,
        median_length: int,
        snv_error_rate: float = 2.5e-2,
        insertion_error_rate: float = 1.25e-2,
        deletion_error_rate: float = 1.25e-2,
        homopolymer_survival_length: int = 4,
        homopolymer_clip_rate: float = 0.5,
    ) -> tuple[str, int, int]:
        """Sample a window around a random position, then apply the error
        channels. Returns (read, reference_start, reference_end)."""
        reference_length = len(reference)
        pos = random.randint(0, reference_length - 1)

        def clamp(x):
            return max(0, min(x, reference_length - 1))

        start = clamp(pos - median_length // 2)
        end = clamp(pos + median_length // 2) + median_length % 2
        substring = reference[start:end]
        substring = self._add_snv_errors(substring, snv_error_rate)
        substring = self._add_insertion_errors(substring, insertion_error_rate)
        substring = self._add_deletion_errors(substring, deletion_error_rate)
        read = self._add_homopolymer_clipping(
            substring, homopolymer_survival_length, homopolymer_clip_rate
        )
        return read, start, end
