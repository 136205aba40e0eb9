"""K-mer similarity utilities for overlap rescue.

A copy of genomeworks_tpu/mapper/kmers.py (NumPy and the standard library only).

Reference: cudamapper/src/cudamapper_utils.cpp:36-96 (split_into_kmers,
count_shared_elements, sequence_jaccard_similarity). Used by
Overlapper.rescue_overlap_ends to decide whether to extend overlap ends.
"""

from __future__ import annotations


def split_into_kmers(s: str, kmer_size: int = 15, stride: int = 1) -> list[str]:
    """All (strided) kmers of ``s``; a too-short string yields [s]
    (cudamapper_utils.cpp:36-52)."""
    if len(s) < kmer_size:
        return [s]
    return [s[i : i + kmer_size] for i in range(0, len(s) - kmer_size + 1, stride)]


def count_shared_elements(a: list[str], b: list[str]) -> int:
    """Shared elements of two SORTED lists, counting multiplicity the way
    the reference's merge walk does (cudamapper_utils.cpp:55-79)."""
    ai = bi = shared = 0
    while ai < len(a) and bi < len(b):
        if a[ai] == b[bi]:
            shared += 1
            ai += 1
            bi += 1
        elif a[ai] < b[bi]:
            ai += 1
        else:
            bi += 1
    return shared


def sequence_jaccard_similarity(
    a: str, b: str, kmer_size: int = 15, stride: int = 1
) -> float:
    """Jaccard similarity of the kmer multisets of a and b
    (cudamapper_utils.cpp:81-93)."""
    a_kmers = sorted(split_into_kmers(a, kmer_size, stride))
    b_kmers = sorted(split_into_kmers(b, kmer_size, stride))
    shared = count_shared_elements(a_kmers, b_kmers)
    union = len(a_kmers) + len(b_kmers) - shared
    return shared / union if union else 0.0
