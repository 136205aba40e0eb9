"""Device-resident mapper pipeline on PyTorch: sketch -> index sort, filter
and unique -> match counts -> anchor expansion -> compound-key sort ->
chaining, all on the device. Counterpart of
genomeworks_tpu/mapper/device_pipeline.py.

The reference's device mapper path:

- index sort/filter/unique: IndexGPU's CUB ``sort_by_two_keys`` +
  ``find_first_occurrences_of_representations`` +
  ``filter_out_most_common_representations``
  (cudamapper/src/index_gpu.cuh:226,438,931);
- matcher: ``find_query_target_matches_kernel`` binary search +
  ``generate_anchors_dispatcher`` + compound-key sort
  (cudamapper/src/matcher_gpu.cuh:117-249);
- overlapper: OverlapperTriggered's RLE -> scan -> reduce chain
  (cudamapper/src/overlapper_triggered.cu:250-441), shared with
  :mod:`genomeworks_tpu_torch.mapper.device_overlapper`.

Every stage is eager PyTorch on exactly sized tensors. A lexicographic
multi-key sort is one ``torch.sort`` of the keys packed into one int64 when
their bit widths (known from the read ids and lengths) sum to 63 or less,
else stable one-key passes from the least significant key. Host <-> device
traffic: the reads' base codes up, a few counts down (the sketch's size per
chunk, the match total, the mask compactions' sizes) and the final overlap
rows down.

Output equals the host pipeline (``build_index`` + ``generate_anchors`` +
``get_overlaps``): the same sort keys, the same filtering threshold (the
reference's ``int(total * fp + 0.001)`` in float64 on the host), the same
chain, fuse and filter rules.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from genomeworks_tpu_torch.core.device import resolve_device
from genomeworks_tpu_torch.core.profiling import annotate
from genomeworks_tpu_torch.core.sequence import pack_reads
from genomeworks_tpu_torch.io.fasta import FastaParser
from genomeworks_tpu_torch.mapper.device_overlapper import _carry, chain_and_filter, overlap_arrays
from genomeworks_tpu_torch.mapper.index import Index, read_range
from genomeworks_tpu_torch.mapper.minimizers import compute_sketch
from genomeworks_tpu_torch.mapper.overlapper import Overlap, OverlapArrays


@dataclasses.dataclass
class DeviceIndex:
    """Sorted, filtered sketch-element index whose tensors live on a device.

    ``first_occurrence`` holds the first index of each unique representation
    and the element count ``n`` after them, as the host Index does."""

    representations: torch.Tensor  # (n,) int64 (uint32 values), sorted
    read_ids: torch.Tensor  # (n,) int32
    positions_in_reads: torch.Tensor  # (n,) int32
    directions_of_reads: torch.Tensor  # (n,) int32
    unique_representations: torch.Tensor  # (u,) int64
    first_occurrence: torch.Tensor  # (u+1,) int64, [u] == n
    n: int
    u: int
    number_of_reads: int
    first_read_id: int
    kmer_size: int
    window_size: int
    number_of_basepairs_in_longest_read: int
    read_id_to_read_names: list[str] = dataclasses.field(default_factory=list)
    read_id_to_read_lengths: np.ndarray | None = None

    def to_host(self) -> Index:
        """The same index as a host :class:`Index` of NumPy arrays."""
        def host(t, dtype):
            return t.cpu().numpy().astype(dtype)

        return Index(
            representations=host(self.representations, np.uint32),
            read_ids=host(self.read_ids, np.uint32),
            positions_in_reads=host(self.positions_in_reads, np.uint32),
            directions_of_reads=host(self.directions_of_reads, np.uint8),
            unique_representations=host(self.unique_representations, np.uint32),
            first_occurrence_of_representations=host(self.first_occurrence, np.uint32),
            number_of_reads=self.number_of_reads,
            first_read_id=self.first_read_id,
            kmer_size=self.kmer_size,
            window_size=self.window_size,
            number_of_basepairs_in_longest_read=self.number_of_basepairs_in_longest_read,
            read_id_to_read_names=self.read_id_to_read_names,
            read_id_to_read_lengths=self.read_id_to_read_lengths,
        )

    @classmethod
    def from_index(cls, index: Index, device: str | torch.device | None = None) -> "DeviceIndex":
        """Stage a host :class:`Index` on ``device`` (``None`` = the CUDA card)."""
        dev = resolve_device(device)

        def up(a, dtype):
            return torch.from_numpy(np.asarray(a).astype(np.int64)).to(dev, dtype)

        return cls(
            representations=up(index.representations, torch.int64),
            read_ids=up(index.read_ids, torch.int32),
            positions_in_reads=up(index.positions_in_reads, torch.int32),
            directions_of_reads=up(index.directions_of_reads, torch.int32),
            unique_representations=up(index.unique_representations, torch.int64),
            first_occurrence=up(index.first_occurrence_of_representations, torch.int64),
            n=len(index.representations),
            u=len(index.unique_representations),
            number_of_reads=index.number_of_reads,
            first_read_id=index.first_read_id,
            kmer_size=index.kmer_size,
            window_size=index.window_size,
            number_of_basepairs_in_longest_read=index.number_of_basepairs_in_longest_read,
            read_id_to_read_names=index.read_id_to_read_names,
            read_id_to_read_lengths=index.read_id_to_read_lengths,
        )


def _bits(max_value: int) -> int:
    """Bits that hold every value in [0, max_value]."""
    return max(1, int(max_value).bit_length())


def sort_fields(fields: list[torch.Tensor], bits: list[int]) -> list[torch.Tensor]:
    """Sort non-negative int64 fields lexicographically, the first the most
    significant, field i below 2**bits[i]; returns the sorted fields.

    The keys packed into one int64 when they fit 63 bits (the sign bit stays
    clear); else a stable one-key sort a field, the least significant first."""
    if sum(bits) <= 63:
        key = fields[0]
        for f, b in zip(fields[1:], bits[1:]):
            key = (key << b) | f
        key = torch.sort(key).values
        out = []
        for b in reversed(bits[1:]):
            out.append(key & ((1 << b) - 1))
            key = key >> b
        return [key, *reversed(out)]
    perm = torch.arange(fields[0].shape[0], device=fields[0].device)
    for f in reversed(fields):
        perm = perm[torch.sort(f[perm], stable=True).indices]
    return [f[perm] for f in fields]


def build_index_device(
    parser: FastaParser,
    first_read_id: int,
    past_the_last_read_id: int,
    kmer_size: int = 15,
    window_size: int = 10,
    hash_representations: bool = True,
    filtering_parameter: float = 1.0,
    batch_size: int = 2048,
    device: str | torch.device | None = None,
) -> DeviceIndex:
    """Build an index over reads [first, past_last) on ``device`` (``None`` =
    the CUDA card).

    Same semantics as :func:`genomeworks_tpu_torch.mapper.index.build_index`
    (reads shorter than w+k-1 skipped, lexicographic (rep, rid, pos) order,
    reference filtering formula) with the sketch, sort, filter and unique
    stages on the device (reference: generate_index,
    index_gpu.cuh:803-981)."""
    dev = resolve_device(device)
    names, lengths_all, seqs = read_range(parser, first_read_id, past_the_last_read_id)
    lengths_np = np.array(lengths_all, dtype=np.int64)
    longest = int(lengths_np.max()) if len(seqs) else 0

    min_len = window_size + kmer_size - 1
    parts = []
    for start in range(0, len(seqs), batch_size):
        chunk = seqs[start : start + batch_size]
        max_len = max(max(len(s) for s in chunk), min_len)
        # one byte a base up: the JAX package packs 2 bits a base for its
        # host link, which costs more host time here than it saves
        mat, lens = pack_reads(chunk, max_len=max_len)
        reps, poss, dirs, emit = compute_sketch(
            mat, lens, kmer_size, window_size, hash_representations, device=dev,
        )
        rid = torch.arange(first_read_id + start, first_read_id + start + len(chunk),
                           device=dev)[:, None].expand_as(reps)
        parts.append((reps[emit], rid[emit], poss[emit].long(), dirs[emit].long()))
        del reps, poss, dirs, emit, rid

    if parts:
        reps, rids, poss, dirs = (torch.cat(col) for col in zip(*parts))
    else:
        reps = rids = poss = dirs = torch.zeros(0, dtype=torch.int64, device=dev)
    del parts
    total = reps.shape[0]

    with annotate("mapper/index_sort"):
        # (rep, rid, pos) is unique and fixes the direction: it rides as the
        # lowest key bit
        reps, rids, poss, dirs = sort_fields(
            [reps, rids, poss, dirs],
            [32, _bits(max(past_the_last_read_id - 1, 0)), _bits(max(longest - 1, 0)), 1],
        )
    # the reference threshold formula, in float64 on the host as the host
    # index computes it (index_gpu.cuh:468)
    apply_filter = filtering_parameter < 1.0 and total > 0
    threshold = int(total * filtering_parameter + 0.001) if apply_filter else 0
    with annotate("mapper/index_filter_unique"):
        if apply_filter:
            firstf = torch.ones(total, dtype=torch.bool, device=dev)
            firstf[1:] = reps[1:] != reps[:-1]
            _, seg_start = _carry(firstf)
            has_next, nxt = _carry(firstf, reverse=True, exclusive=True)
            seg_len = torch.where(has_next, nxt, total) - seg_start
            rows = (seg_len < threshold).nonzero().squeeze(1)
            reps, rids, poss, dirs = (x[rows] for x in (reps, rids, poss, dirs))
        n = reps.shape[0]
        firstf = torch.ones(n, dtype=torch.bool, device=dev)
        firstf[1:] = reps[1:] != reps[:-1]
        first = firstf.nonzero().squeeze(1)
        uniq = reps[first]
        first = torch.cat([first, torch.tensor([n], device=dev)])
    return DeviceIndex(
        representations=reps,
        read_ids=rids.to(torch.int32),
        positions_in_reads=poss.to(torch.int32),
        directions_of_reads=dirs.to(torch.int32),
        unique_representations=uniq,
        first_occurrence=first,
        n=n,
        u=uniq.shape[0],
        number_of_reads=past_the_last_read_id - first_read_id,
        first_read_id=first_read_id,
        kmer_size=kmer_size,
        window_size=window_size,
        number_of_basepairs_in_longest_read=longest,
        read_id_to_read_names=names,
        read_id_to_read_lengths=lengths_np,
    )


def _match_counts(q: DeviceIndex, t: DeviceIndex):
    """Binary-search each query unique rep in the target uniques and count
    the anchor cross products (find_query_target_matches_kernel +
    compute_anchor_starting_indices, matcher_gpu.cuh:117-249). Returns each
    query rep's first matched target occurrence and target count (0 when
    unmatched) and the total anchor count (a device scalar)."""
    found = torch.searchsorted(t.unique_representations, q.unique_representations)
    found_c = found.clamp(max=t.u - 1)
    matched = (found < t.u) & (t.unique_representations[found_c] == q.unique_representations)
    found_c = torch.where(matched, found_c, 0)
    t_counts = torch.where(matched, t.first_occurrence.diff()[found_c], 0)
    t_first_m = torch.where(matched, t.first_occurrence[found_c], 0)
    total = (q.first_occurrence.diff() * t_counts).sum()
    return t_first_m, t_counts, total


def _expand_sort(q: DeviceIndex, t: DeviceIndex, t_first_m, t_counts, total: int):
    """Materialize all anchors (query occurrence outer, target occurrence
    inner, matcher_gpu.cu:176-249) and sort them by the compound key
    (qrid, trid, qpos, tpos) (matcher_gpu.cuh:176). Returns four int32
    tensors of ``total`` anchors."""
    dev = q.read_ids.device
    # per query occurrence: its rep, then its target count and first target
    rep_of_occ = torch.repeat_interleave(
        torch.arange(q.u, device=dev), q.first_occurrence.diff(), output_size=q.n)
    n_t_occ = t_counts[rep_of_occ]
    tfm_occ = t_first_m[rep_of_occ]
    bases_occ = torch.cumsum(n_t_occ, 0) - n_t_occ
    # per anchor: its query occurrence and its offset among the targets
    occ_idx = torch.repeat_interleave(
        torch.arange(q.n, device=dev), n_t_occ, output_size=total)
    t_idx = tfm_occ[occ_idx] + (torch.arange(total, device=dev) - bases_occ[occ_idx])
    del rep_of_occ, n_t_occ, tfm_occ, bases_occ
    fields = [q.read_ids[occ_idx].long(), t.read_ids[t_idx].long(),
              q.positions_in_reads[occ_idx].long(), t.positions_in_reads[t_idx].long()]
    del occ_idx, t_idx
    id_bits = _bits(max(q.first_read_id + q.number_of_reads,
                        t.first_read_id + t.number_of_reads) - 1)
    pos_bits = _bits(max(q.number_of_basepairs_in_longest_read,
                         t.number_of_basepairs_in_longest_read) - 1)
    return [f.to(torch.int32) for f in sort_fields(
        fields, [id_bits, id_bits, pos_bits, pos_bits])]


def get_overlaps_device_pipeline(
    q_index: DeviceIndex,
    t_index: DeviceIndex,
    all_to_all: bool,
    min_residues: int = 3,
    min_overlap_len: int = 250,
    min_bases_per_residue: int = 1000,
    min_overlap_fraction: float = 0.8,
    as_arrays: bool = False,
) -> "list[Overlap] | OverlapArrays":
    """Anchors + overlaps for one index pair on the indexes' device; equal to
    generate_anchors + get_overlaps on the host copies. ``as_arrays``
    returns the columnar OverlapArrays (int32 columns) instead of Overlap
    objects."""
    empty = (
        OverlapArrays(*(np.zeros(0, np.int64) for _ in range(8)))
        if as_arrays else []
    )
    if q_index.n == 0 or t_index.n == 0:
        return empty
    with annotate("mapper/match_counts"):
        t_first_m, t_counts, total = _match_counts(q_index, t_index)
        total = int(total)
    if total == 0:
        return empty
    with annotate("mapper/expand_sort_chain"):
        rows = chain_and_filter(
            *_expand_sort(q_index, t_index, t_first_m, t_counts, total),
            all_to_all, min_residues, min_overlap_len, min_bases_per_residue,
            min_overlap_fraction,
        )
    if rows[0].shape[0] == 0:
        return empty
    arrays = overlap_arrays(rows)
    return arrays if as_arrays else arrays.to_overlaps()
