"""End-to-end overlap mapping pipeline (reference: the cudamapper tool,
cudamapper/src/main.cu:536-622). Counterpart of
genomeworks_tpu/mapper/pipeline.py.

The reference tiles the query x target index matrix into host/device-sized
batches and processes them with one worker thread + two CUDA streams per
GPU. This module is the single-process pipeline: index chunking (by
basepair budget, mirroring index_size MB), pair iteration with all-to-all
symmetry skipping (main.cu:226-227), matching, chaining, host
post-processing, and PAF emission; the next index pair is built on one
worker thread while the current pair runs.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from genomeworks_tpu_torch.core.device import resolve_device
from genomeworks_tpu_torch.io.fasta import FastaParser
from genomeworks_tpu_torch.io.paf import overlap_to_paf_line
from genomeworks_tpu_torch.mapper.index import build_index
from genomeworks_tpu_torch.mapper.matcher import generate_anchors
from genomeworks_tpu_torch.mapper.overlapper import (
    Overlap,
    get_overlaps,
    post_process_overlaps,
    post_process_overlaps_arrays,
)


@dataclasses.dataclass
class MapperParams:
    """reference: cudamapper ApplicationParameters defaults
    (application_parameters.hpp:47-71)."""

    kmer_size: int = 15
    window_size: int = 10
    index_size_mb: int = 30
    target_index_size_mb: int = 30
    #: None = automatic (reference set_filtering_parameter,
    #: application_parameters.cpp:225-250: 1e-5, but disabled entirely when
    #: query+target hold under 0.5 Mbp); a float = user-specified.
    filtering_parameter: float | None = None
    min_residues: int = 3
    min_overlap_len: int = 250
    min_bases_per_residue: int = 1000
    min_overlap_fraction: float = 0.8
    drop_fused_overlaps: bool = False
    alignment_band_width: int = 0  # >0 enables CIGAR alignment of overlaps
    hash_representations: bool = True
    #: run the device-resident pipeline (sketch, sort, match and chain on
    #: the device, reference: the all-GPU path of main.cu); False = the host
    #: NumPy matcher/overlapper over the device sketch. Both give the same
    #: overlaps.
    device_pipeline: bool = True


def group_reads_into_index_ranges(
    parser: FastaParser, basepairs_per_index: int
) -> list[tuple[int, int]]:
    """Split reads into [first, past_last) ranges holding roughly
    basepairs_per_index bases (reference: group_reads_into_indices,
    cudamapper utils.hpp:91)."""
    ranges = []
    first = 0
    acc = 0
    n = len(parser)
    for rid in range(n):
        acc += len(parser.get_sequence_by_id(rid).seq)
        if acc >= basepairs_per_index:
            ranges.append((first, rid + 1))
            first = rid + 1
            acc = 0
    if first < n:
        ranges.append((first, n))
    return ranges


def map_reads(
    query_parser: FastaParser,
    target_parser: FastaParser,
    params: MapperParams | None = None,
    all_to_all: bool | None = None,
    device: str | torch.device | None = None,
) -> list[Overlap]:
    """Run the full overlap pipeline on ``device`` (``None`` = the CUDA card,
    which raises without one); returns post-processed overlaps."""
    dev = resolve_device(device)
    params = params or MapperParams()
    if all_to_all is None:
        all_to_all = query_parser is target_parser

    filtering = params.filtering_parameter
    if filtering is None:
        # automatic filtering (application_parameters.cpp:225-250): 1e-5,
        # unless the inputs hold under 0.5 Mbp of sequence
        total = 0
        for p in (query_parser, target_parser):
            for s in p.sequences():
                total += len(s.seq)
                if total >= 500_000:
                    break
            if total >= 500_000:
                break
        filtering = 1e-5 if total >= 500_000 else 1.0

    q_ranges = group_reads_into_index_ranges(query_parser, params.index_size_mb * 1_000_000)
    t_ranges = group_reads_into_index_ranges(
        target_parser, params.target_index_size_mb * 1_000_000
    )

    if params.device_pipeline:
        return _map_reads_device(
            query_parser, target_parser, params, all_to_all, filtering,
            q_ranges, t_ranges, dev,
        )

    from genomeworks_tpu_torch.mapper.batcher import IndexDescriptor
    from genomeworks_tpu_torch.mapper.cache import CacheType, HostIndexCache

    def make_index(parser):
        def build(desc):
            return build_index(
                parser,
                desc.first_read,
                desc.number_of_reads,
                kmer_size=params.kmer_size,
                window_size=params.window_size,
                hash_representations=params.hash_representations,
                filtering_parameter=filtering,
                device=dev,
            )
        return build

    q_cache = HostIndexCache(CacheType.query_cache, make_index(query_parser))
    t_cache = HostIndexCache(CacheType.target_cache, make_index(target_parser))

    overlaps_all: list[Overlap] = []
    for q_rng in q_ranges:
        for t_rng in t_ranges:
            # all-to-all symmetry skip (main.cu:226-227)
            if all_to_all and t_rng[0] < q_rng[0]:
                continue
            # the descriptor's second field carries past_the_last, as the
            # JAX package's host path passes it
            q_index = q_cache.get_index(IndexDescriptor(q_rng[0], q_rng[1]))
            if all_to_all and q_rng == t_rng:
                t_index = q_index
            else:
                t_index = t_cache.get_index(IndexDescriptor(t_rng[0], t_rng[1]))

            anchors = generate_anchors(q_index, t_index)
            overlaps = get_overlaps(
                anchors,
                all_to_all,
                params.min_residues,
                params.min_overlap_len,
                params.min_bases_per_residue,
                params.min_overlap_fraction,
            )
            overlaps = post_process_overlaps(overlaps, params.drop_fused_overlaps)
            overlaps_all.extend(overlaps)
    return overlaps_all


def _map_reads_device(
    query_parser, target_parser, params, all_to_all, filtering,
    q_ranges, t_ranges, dev, pairs=None, return_pair_ids=False,
):
    """Device-resident pipeline loop (see mapper.device_pipeline).

    ``pairs`` (optional) is an explicit [(global_idx, q_rng, t_rng)] work
    list in place of the ranges' pairs: the multi-process path passes its
    round-robin share, so only those pairs run here. With
    ``return_pair_ids`` the global pair index of each overlap is returned
    too, so that the multi-process merge can restore the single-process
    pair order."""
    from concurrent.futures import ThreadPoolExecutor

    from genomeworks_tpu_torch.mapper.device_pipeline import (
        build_index_device,
        get_overlaps_device_pipeline,
    )

    # the worker's launches go to the main thread's current stream, so every
    # index is ordered before the pair that reads it
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

    def build(parser, rng):
        return build_index_device(
            parser, rng[0], rng[1],
            kmer_size=params.kmer_size, window_size=params.window_size,
            hash_representations=params.hash_representations,
            filtering_parameter=filtering, device=dev,
        )

    q_cache: dict = {}
    t_cache: dict = {}

    def get_indexes(q_rng, t_rng):
        if stream is not None:
            torch.cuda.set_stream(stream)
        if q_rng not in q_cache:
            q_cache[q_rng] = build(query_parser, q_rng)
        q_index = q_cache[q_rng]
        if all_to_all and q_rng == t_rng:
            t_index = q_index
        elif t_rng in t_cache:
            t_index = t_cache[t_rng]
        else:
            t_index = t_cache[t_rng] = build(target_parser, t_rng)
        return q_index, t_index

    if pairs is None:
        pairs = [
            (i, q_rng, t_rng)
            for i, (q_rng, t_rng) in enumerate(
                (q, t) for q in q_ranges for t in t_ranges
                if not (all_to_all and t[0] < q[0])
            )
        ]
    overlaps_all: list[Overlap] = []
    pair_ids: list[int] = []
    if not pairs:
        return (overlaps_all, pair_ids) if return_pair_ids else overlaps_all

    # copy/compute overlap (the reference double-buffers the next index's
    # H2D copy against the current batch's compute, main.cu:319-365): one
    # worker thread parses, packs and launches pair k+1's index while the
    # main thread waits on pair k's counts. All builds go through the
    # worker, so the caches are single-threaded.
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(get_indexes, *pairs[0][1:])
        for k in range(len(pairs)):
            q_index, t_index = fut.result()
            if k + 1 < len(pairs):
                fut = ex.submit(get_indexes, *pairs[k + 1][1:])
            arrs = get_overlaps_device_pipeline(
                q_index, t_index, all_to_all,
                params.min_residues, params.min_overlap_len,
                params.min_bases_per_residue, params.min_overlap_fraction,
                as_arrays=True,
            )
            arrs = post_process_overlaps_arrays(arrs, params.drop_fused_overlaps)
            ovs = arrs.to_overlaps()
            overlaps_all.extend(ovs)
            if return_pair_ids:
                pair_ids.extend([pairs[k][0]] * len(ovs))
    return (overlaps_all, pair_ids) if return_pair_ids else overlaps_all


def align_overlaps(
    overlaps: list[Overlap],
    query_parser: FastaParser,
    target_parser: FastaParser,
    max_bandwidth: int = 512,
    device: str | torch.device | None = None,
) -> list[str]:
    """Compute CIGARs for overlaps through the port's aligner on ``device``
    (``None`` = the CUDA card) (reference: main.cu:54-188
    align_overlaps/run_alignment_batch: query slice vs target slice,
    target reverse-complemented for '-' overlaps)."""
    from genomeworks_tpu_torch.aligner import create_aligner

    aligner = create_aligner(max_bandwidth=max_bandwidth, device=device)
    for o in overlaps:
        q = query_parser.get_sequence_by_id(o.query_read_id).seq[
            o.query_start_position_in_read : o.query_end_position_in_read
        ]
        t = target_parser.get_sequence_by_id(o.target_read_id).seq[
            o.target_start_position_in_read : o.target_end_position_in_read
        ]
        aligner.add_alignment(q, t, reverse_complement_target=o.relative_strand == "-")
    aligner.align_all()
    return [a.convert_to_cigar() for a in aligner.get_alignments()]


def overlaps_to_paf(
    overlaps: list[Overlap],
    query_parser: FastaParser,
    target_parser: FastaParser,
    kmer_size: int,
    cigars: list[str] | None = None,
) -> Iterator[str]:
    """Format overlaps as PAF lines (reference: print_paf, utils.cpp:41)."""
    for i, o in enumerate(overlaps):
        q = query_parser.get_sequence_by_id(o.query_read_id)
        t = target_parser.get_sequence_by_id(o.target_read_id)
        yield overlap_to_paf_line(
            q.name,
            len(q.seq),
            o.query_start_position_in_read,
            o.query_end_position_in_read,
            o.relative_strand,
            t.name,
            len(t.seq),
            o.target_start_position_in_read,
            o.target_end_position_in_read,
            o.num_residues,
            kmer_size,
            cigars[i] if cigars else None,
        )
