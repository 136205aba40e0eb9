#!/usr/bin/env python3
"""Walls of the covid POA main paths on one GPU, this checkout against
another's in one call.

    python3 experiments/torch_poa_walls.py [--parent DIR] [--reps N]

Each run takes all 5776 covid windows (tests/data) through the two paths
that chip_smoke.py's phase 3 drives, binned by ``get_multi_batch_sizes``:
- the default path: ``PoaBatch(device="cuda")`` (the lockstep tier, with
  the per-window kernel for small bins and the tier's re-runs);
- ``poa_batch_consensus(..., use_lockstep=False)``: the per-window kernel
  alone.
Every consensus must equal its golden line. A path's wall is the median of
``--reps`` runs (default 3) after one warm-up, each ended by a device sync.

With ``--parent DIR`` (another checkout's package unpacked there, e.g. by
``git archive <commit> genomeworks_tpu_torch | tar -x -C DIR``), the two
packages run in turns parent, this, this, parent, each in a process of its
own that builds its own kernels, so that both are timed on one card in one
call. The last line is one JSON object with every number printed.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")


def walls(root: str, reps: int) -> dict:
    """The two paths' walls with the package found under ``root``."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from genomeworks_tpu_torch.poa import BandMode, OutputType, PoaBatch, StatusType
    from genomeworks_tpu_torch.poa.torch_poa import poa_batch_consensus
    from genomeworks_tpu_torch.poa.windows import (
        get_multi_batch_sizes, load_golden_lines, load_window_file,
    )

    covid = load_window_file(os.path.join(DATA, "poa_windows_covid.txt.gz"))
    golden = load_golden_lines(os.path.join(DATA, "poa_golden_covid.txt"))

    def default(cfg, ws):
        batch = PoaBatch(cfg, OutputType.consensus, device="cuda")
        for w in ws:
            batch.add_poa_group(w)
        batch.generate_poa()
        cons, _, sts = batch.get_consensus()
        return cons, [0 if s == StatusType.success else s for s in sts]

    def per_window(cfg, ws):
        ones = [[np.ones(len(s), np.int32) for s in w] for w in ws]
        cons, _, sts = poa_batch_consensus(ws, max_nodes=cfg.max_nodes_per_graph, weights=ones,
                                           device="cuda", use_lockstep=False)
        return cons, sts

    cfgs, groups = get_multi_batch_sizes(covid, band_mode=BandMode.full_band)

    def timed(run):
        out = [None] * len(covid)
        t0 = time.perf_counter()
        for cfg, wids in zip(cfgs, groups):
            for wid, c, s in zip(wids, *run(cfg, [covid[i] for i in wids])):
                out[wid] = (c, s)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bad = sum(s != 0 or c != g for (c, s), g in zip(out, golden))
        if bad:
            raise SystemExit(f"{root}: {bad} covid windows not success or not the golden")
        return wall

    res = {}
    for name, run in (("default", default), ("use_lockstep=False", per_window)):
        timed(run)  # warm: kernels built and loaded, allocator primed
        w = [timed(run) for _ in range(reps)]
        res[name] = {"walls_s": w, "median_s": statistics.median(w)}
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a directory holding another checkout's package")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--root", help=argparse.SUPPRESS)  # one turn, in a process of its own
    args = ap.parse_args()
    if args.root:
        print(json.dumps(walls(args.root, args.reps)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    turns = [("this", ROOT)]
    if args.parent:
        parent = os.path.abspath(args.parent)
        turns = [("parent", parent), ("this", ROOT), ("this", ROOT), ("parent", parent)]
    out = {"card": smi, "turns": []}
    for label, root in turns:
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root,
                            "--reps", str(args.reps)], capture_output=True, text=True)
        if p.returncode:
            sys.stderr.write(p.stderr[-4000:])
            return p.returncode
        res = json.loads(p.stdout.strip().splitlines()[-1])
        out["turns"].append({"package": label, **res})
        print(f"{label}: " + "; ".join(f"{k} median {v['median_s']:.4f} s of "
                                       f"{', '.join(f'{x:.4f}' for x in v['walls_s'])}"
                                       for k, v in res.items()), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
