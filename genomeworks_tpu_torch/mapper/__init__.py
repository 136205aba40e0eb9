"""Minimizer-based all-vs-all read overlapping (reference: cudamapper), on
PyTorch. Counterpart of genomeworks_tpu.mapper, with the same exports.

Pipeline: minimizer sketch -> sorted index -> anchor matching -> chaining
into overlaps -> host post-processing -> PAF/SAM/BAM output. The
device-resident pipeline runs every stage through the index, the anchors
and the chains as PyTorch ops on the card; the host pipeline runs the
sketch there and NumPy after it.
"""

from genomeworks_tpu_torch.mapper.minimizers import compute_sketch, wang_hash32
from genomeworks_tpu_torch.mapper.index import Index, build_index
from genomeworks_tpu_torch.mapper.matcher import Anchors, generate_anchors
from genomeworks_tpu_torch.mapper.overlapper import Overlap, get_overlaps, post_process_overlaps
from genomeworks_tpu_torch.mapper.pipeline import (
    MapperParams,
    map_reads,
    align_overlaps,
    overlaps_to_paf,
    group_reads_into_index_ranges,
)
from genomeworks_tpu_torch.mapper.batcher import (
    IndexDescriptor,
    IndexBatch,
    BatchOfIndices,
    group_reads_into_indices,
    group_into_batches,
    generate_batches_of_indices,
)
from genomeworks_tpu_torch.mapper.overlapper import (
    filter_overlaps,
    rescue_overlap_ends,
)
from genomeworks_tpu_torch.mapper.kmers import (
    split_into_kmers,
    sequence_jaccard_similarity,
)
