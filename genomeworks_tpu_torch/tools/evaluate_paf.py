"""gw-evaluate-paf — precision/recall/F1 of a test PAF vs a truth PAF.

The port of genomeworks_tpu/tools/evaluate_paf.py, on the port's
io/paf.py. Reference: pygenomeworks/bin/evaluate_paf (interval-dictionary
candidate lookup, records_equal with position slop, reciprocal-overlap
fallback, reversed query/target handling). The interval trees there are a
lookup optimization; this build indexes candidates per read-name, which is
exact for the same matching semantics.
"""

from __future__ import annotations

import argparse
import dataclasses
from collections import defaultdict

from genomeworks_tpu_torch.io.paf import PafRecord, read_paf


def points_equal(fixed: int, point: int, slop: int) -> bool:
    return max(0, int(fixed) - slop) <= int(point) <= (int(fixed) + slop)


def calculate_reciprocal_overlap(record: PafRecord, other: PafRecord) -> float:
    """evaluate_paf:38-45 — shared span over positional spread, query +
    target combined."""
    q_overlap = min(record.query_end, other.query_end) - max(record.query_start, other.query_start)
    q_total = max(record.query_start, other.query_start) - min(record.query_start, other.query_start)
    t_overlap = min(record.target_end, other.target_end) - max(record.target_start, other.target_start)
    t_total = max(record.target_end, other.target_end) - min(record.target_start, other.target_start)
    denom = q_total + t_total
    if denom <= 0:
        # identical placements: full reciprocal overlap
        return 1.0 if (q_overlap > 0 or t_overlap > 0) else 0.0
    return float(q_overlap + t_overlap) / float(denom)


def records_equal(record: PafRecord, other: PafRecord, pos_tolerance: int) -> bool:
    return (
        points_equal(record.query_start, other.query_start, pos_tolerance)
        and points_equal(record.query_end, other.query_end, pos_tolerance)
        and points_equal(record.target_start, other.target_start, pos_tolerance)
        and points_equal(record.target_end, other.target_end, pos_tolerance)
        and record.relative_strand == other.relative_strand
    )


def match_overlaps(
    record: PafRecord, other: PafRecord, pos_tolerance: int, min_reciprocal: float
) -> bool:
    """A test overlap matches a truth overlap when all four endpoints agree
    within slop (and strands match), or when the reciprocal overlap
    exceeds the threshold (evaluate_paf:84-113)."""
    if records_equal(record, other, pos_tolerance):
        return True
    return calculate_reciprocal_overlap(record, other) > min_reciprocal


def reverse_record(record: PafRecord) -> PafRecord:
    return dataclasses.replace(
        record,
        query_sequence_name=record.target_sequence_name,
        target_sequence_name=record.query_sequence_name,
        query_sequence_length=record.target_sequence_length,
        target_sequence_length=record.query_sequence_length,
        query_start=record.target_start,
        target_start=record.query_start,
        query_end=record.target_end,
        target_end=record.query_end,
    )


def evaluate_paf(
    truth_paf_filepath: str,
    test_paf_filepath: str,
    pos_tolerance: int = 400,
    min_reciprocal: float = 0.9,
    skip_self_mappings: bool = True,
) -> tuple[int, int, int, int]:
    """Returns (true_positives, false_positives, false_negatives,
    num_truth_records); tp/fp are per test record, fn per truth record."""
    truth_by_pair: dict[tuple[str, str], list[tuple[int, PafRecord]]] = defaultdict(list)
    num_true = 0
    for t in read_paf(truth_paf_filepath):
        if skip_self_mappings and t.query_sequence_name == t.target_sequence_name:
            continue
        truth_by_pair[(t.query_sequence_name, t.target_sequence_name)].append((num_true, t))
        num_true += 1

    # tp/fp are per test record (reference semantics); fn counts truth
    # records never matched by any test record — the reference's
    # ``num_true - tp`` can go negative when several test overlaps (e.g.
    # both orientations of one pair) match the same truth record.
    matched_truth: set[int] = set()
    tp = fp = 0
    for test in read_paf(test_paf_filepath):
        if skip_self_mappings and test.query_sequence_name == test.target_sequence_name:
            continue
        key = (test.query_sequence_name, test.target_sequence_name)
        rkey = (test.target_sequence_name, test.query_sequence_name)
        found = False
        for ti, t in truth_by_pair.get(key, ()):
            if match_overlaps(t, test, pos_tolerance, min_reciprocal):
                found = True
                matched_truth.add(ti)
        if rkey in truth_by_pair:
            rev = reverse_record(test)
            for ti, t in truth_by_pair[rkey]:
                if match_overlaps(t, rev, pos_tolerance, min_reciprocal):
                    found = True
                    matched_truth.add(ti)
        if found:
            tp += 1
        else:
            fp += 1

    fn = num_true - len(matched_truth)
    return tp, fp, fn, num_true


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="gw-evaluate-paf",
        description="precision/recall of a test PAF vs a truth PAF",
    )
    p.add_argument("-T", "--truth", required=True)
    p.add_argument("-i", "--test", required=True)
    p.add_argument("-s", "--slop", type=int, default=400, help="endpoint tolerance (bp)")
    p.add_argument("-r", "--min-reciprocal", type=float, default=0.9)
    p.add_argument(
        "--keep-self-mappings", action="store_true",
        help="count overlaps where query == target",
    )
    args = p.parse_args(argv)
    tp, fp, fn, num_true = evaluate_paf(
        args.truth, args.test, args.slop, args.min_reciprocal,
        skip_self_mappings=not args.keep_self_mappings,
    )
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = (num_true - fn) / num_true if num_true else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    print(f"True positives: {tp}")
    print(f"False positives: {fp}")
    print(f"False negatives: {fn}")
    print(f"Precision: {precision:.4f}")
    print(f"Recall: {recall:.4f}")
    print(f"F1: {f1:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
