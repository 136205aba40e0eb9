#!/usr/bin/env python3
"""Where the time of the port's mapper goes on one GPU, on chip_smoke.py's
phase-10 workload (a 2 Mbp random genome, 2,500 reads of 8-12 kb at about
12.5x, half reverse complemented, 1.5 % substitutions, 1 % insertions, 1 %
deletions, the same seed), all-vs-all with the tool's defaults (k = 15,
w = 10, one index, automatic filtering).

    python3 experiments/torch_mapper_profile.py [runs] [--reads N]   # default 3, 2500

1. ``runs`` warm runs of ``map_reads(device="cuda")`` on the device
   pipeline and on the host pipeline, host clock around each after a
   synchronize: min and median wall.
2. One run of each pipeline with its stages wrapped in a synchronize and a
   host clock: reading and packing the reads, the sketch (upload included),
   the index sorts, filter and unique, the match counts, the anchor
   expansion and sort, the chaining, post-processing and the Overlap
   objects; on the host pipeline the sketch's copy back, the NumPy index,
   anchors and chains. The synchronizes cost time of their own, so the
   staged wall is above the plain one.
3. One run of the device pipeline under ``torch.profiler``: device time by
   kernel name (the events on the card) and the device's busy share of the
   wall; the peak device memory of a run.

Prints the card's name and power limit first and one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from genomeworks_tpu_torch.io import create_fasta_parser, write_fasta  # noqa: E402
from genomeworks_tpu_torch.mapper import MapperParams, map_reads  # noqa: E402
from genomeworks_tpu_torch.mapper import device_pipeline, index, overlapper, pipeline  # noqa: E402


def timed(stages, name, fn):
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        s = stages.setdefault(name, [0.0, 0])
        s[0] += time.perf_counter() - t0
        s[1] += 1
        return out
    return wrapper


#: (module, attribute, stage name); nested stages are marked "in ..."
DEVICE_STAGES = [
    (device_pipeline, "read_range", "read the reads from the parser"),
    (device_pipeline, "pack_reads", "pack the reads to codes (host)"),
    (device_pipeline, "compute_sketch", "upload and sketch"),
    (device_pipeline, "sort_fields", "sorts (index; anchors in expand)"),
    (device_pipeline, "_match_counts", "match counts"),
    (device_pipeline, "_expand_sort", "expand and sort the anchors"),
    (device_pipeline, "chain_and_filter", "chain and filter"),
    (pipeline, "post_process_overlaps_arrays", "post-process (host)"),
    (overlapper.OverlapArrays, "to_overlaps", "Overlap objects (host)"),
]
HOST_STAGES = [
    (index, "read_range", "read the reads from the parser"),
    (index, "pack_reads", "pack the reads to codes (host)"),
    (index, "compute_sketch", "upload and sketch"),
    (index, "sketch_to_numpy", "sketch to the host"),
    (index, "filter_most_common", "filter (host)"),
    (pipeline, "generate_anchors", "anchors (host)"),
    (pipeline, "get_overlaps", "chain and filter (host)"),
    (pipeline, "post_process_overlaps", "post-process (host)"),
]


def staged(parser, device_pipeline_on):
    stages: dict = {}
    table = DEVICE_STAGES if device_pipeline_on else HOST_STAGES
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in table]
    for mod, attr, name in table:
        setattr(mod, attr, timed(stages, name, getattr(mod, attr)))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        map_reads(parser, parser, MapperParams(device_pipeline=device_pipeline_on),
                  device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return wall, {k: [round(v[0], 4), v[1]] for k, v in stages.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("runs", type=int, nargs="?", default=3)
    ap.add_argument("--reads", type=int, default=chip_smoke.MAPPER_READS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mapper_profile: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    reads, _ = chip_smoke.mapper_reads(np.random.default_rng(2026), chip_smoke.MAPPER_GENOME,
                                       args.reads, chip_smoke.MAPPER_LENGTHS,
                                       chip_smoke.MAPPER_ERRORS)
    result = {"device": smi, "reads": len(reads), "bases": sum(len(s) for _, s in reads)}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reads.fa")
        write_fasta(reads, path)
        parser = create_fasta_parser(path, min_sequence_length=24)

        for label, on in (("device", True), ("host", False)):
            walls = []
            for _ in range(args.runs + 1):  # the first run warms up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = map_reads(parser, parser, MapperParams(device_pipeline=on), device="cuda")
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            result[f"{label}_walls_s"] = walls[1:]
            print(f"{label} pipeline: {len(out)} overlaps; walls (s) {walls[1:]} (first "
                  f"{walls[0]:.4f}); min {min(walls[1:]):.4f}, median "
                  f"{statistics.median(walls[1:]):.4f}")

        for label, on in (("device", True), ("host", False)):
            wall, stages = staged(parser, on)
            result[f"{label}_staged"] = {"wall_s": round(wall, 4), "stages": stages}
            print(f"{label} pipeline staged: {wall:.4f} s; " + "; ".join(
                f"{k} {v[0]:.4f} s ({v[1]} calls)" for k, v in stages.items()))

        torch.cuda.reset_peak_memory_stats()
        map_reads(parser, parser, MapperParams(), device="cuda")
        result["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        busy_ms, wall, by_name = chip_smoke.profiled(
            lambda: map_reads(parser, parser, MapperParams(), device="cuda"))
        top = sorted(chip_smoke.by_kernel(by_name).items(), key=lambda kv: -kv[1])[:15]
        result["profiled"] = {"wall_ms": round(wall * 1e3, 3), "busy_ms": round(busy_ms, 3),
                              "top": [[k[:80], round(v, 3)] for k, v in top]}
        print(f"profiled device pipeline: {wall * 1e3:.3f} ms wall, device busy "
              f"{busy_ms:.3f} ms ({100 * busy_ms / (wall * 1e3):.2f} %); peak device memory "
              f"{result['peak_memory_bytes'] / 2**30:.3f} GiB")
        for k, v in top:
            print(f"  {v:9.3f} ms  {k[:120]}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
