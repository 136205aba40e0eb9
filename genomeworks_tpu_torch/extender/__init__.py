"""Ungapped X-drop seed extension (reference: cudaextender)."""

from genomeworks_tpu_torch.extender.xdrop import (
    UngappedXDrop,
    ScoredSegmentPair,
    create_extender,
    encode_sequence,
    parse_seed_pairs,
    parse_scored_segment_pairs,
    DEFAULT_SCORE_MATRIX,
)
