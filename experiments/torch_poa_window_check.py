#!/usr/bin/env python3
"""The per-window POA kernel's full-band chain (csrc/poa_consensus.cu) on
the covid workload, on one GPU: where its time goes, and this checkout's
kernel against another checkout's.

    python3 experiments/torch_poa_window_check.py [--parent DIR] [--reps N]
        [--min-blocks K ...]

Sets, each packed per bin as PoaBatch packs them (E = A = 50, unit
weights):
- the re-runs: the windows the lockstep tier leaves to the per-window
  kernel on the default path (run here through the tier's kernels);
- the chunks of ``use_lockstep=False``: each bin cut into the chunks the
  wrapper launches, one launch each;
- covid 0-63.

It prints ptxas' lines for every build, then:
- the phase split: the kernel built with ``-DPOA_PHASE_CLOCKS=1`` (where
  the source has that debug build) sums clock64() cycles per phase over its
  windows (NW, traceback, add, topsort, and the final consensus), on the
  re-runs and on the chunks, with the NW rows and alignment moves, the NW
  row's segments and cells, and each set's bound (a source without those
  counters reads 0 there);
- with ``--parent DIR``: ``DIR/genomeworks_tpu_torch/csrc/poa_consensus.cu``
  (e.g. unpacked there by ``git archive <commit> genomeworks_tpu_torch/csrc/
  poa_consensus.cu | tar -x -C DIR``) is built beside this one, and each set
  is timed with CUDA events in turns parent, this, this, parent (``--reps``
  rounds, default 3), with both builds' outputs required equal;
- with ``--min-blocks K``: this source built with ``-DPOA_WIN_MIN_BLOCKS=K``
  (the full-band kernel's launch bound: at least K blocks an SM for the
  consensus) joins the turns as "this@K".
The last line is one JSON object with every number printed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from genomeworks_tpu_torch.ops import _build, poa_cuda  # noqa: E402
from genomeworks_tpu_torch.poa import BandMode, lockstep  # noqa: E402
from genomeworks_tpu_torch.poa.torch_poa import pack_windows  # noqa: E402
from genomeworks_tpu_torch.poa.windows import (  # noqa: E402
    get_multi_batch_sizes, load_window_file,
)

PHASES = ("nw", "traceback", "add", "topsort", "consensus")
SEGMENTS = ("predecessors", "closure", "codes", "copies", "best")
CLOCKS = {"POA_PHASE_CLOCKS": 1}


def _absent(*_):
    return 0


def build(source, defines=None):
    """(bound library, ptxas lines) of ``source`` built with ``defines``. An
    older source's library lacks the full band's occupancy queries; they
    read 0 there."""
    lib = _build.load(source, defines)
    for name in ("poa_windows_in_flight", "poa_window_ring_rows"):
        try:
            getattr(lib, name)
        except AttributeError:
            setattr(lib, name, _absent)
    lib = poa_cuda.bind(lib)
    log = _build.build_log.get(_build.library_path(source, defines), "")
    lines = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    return lib, lines


def packed(windows, N, dev):
    ones = [[np.ones(len(s), np.int32) for s in w] for w in windows]
    seqs, wts, lens, nseqs, _ = pack_windows(windows, ones, N)
    return [torch.from_numpy(a).to(dev) for a in (seqs, wts, lens, nseqs)]


def covid_sets(dev):
    """{set name: (packed tensors, N)}."""
    windows = load_window_file(os.path.join(ROOT, "tests", "data", "poa_windows_covid.txt.gz"))
    cfgs, groups = get_multi_batch_sizes(windows, band_mode=BandMode.full_band)
    sets = {}
    for cfg, wids in zip(cfgs, groups):
        ws = [windows[i] for i in wids]
        N, size = cfg.max_nodes_per_graph, cfg.max_sequence_size
        if len(ws) >= 64:  # the default path's lockstep tier, then its re-runs
            _, _, st = lockstep.poa_batch_consensus_lockstep(ws, max_nodes=N, device=dev)
            redo = [w for w, s in zip(ws, st) if s != 0]
            if redo:
                sets[f"re-runs bin {size}"] = (packed(redo, N, dev), N)
        args = packed(ws, N, dev)
        slab = poa_cuda.load_library().poa_slab_bytes(N, args[0].shape[2], 50, 50)
        chunk = poa_cuda.chunk_windows(len(ws), slab, dev)
        for k, w0 in enumerate(range(0, len(ws), chunk)):
            sets[f"chunk {k} bin {size}"] = (packed(ws[w0:w0 + chunk], N, dev), N)
    first = windows[:64]
    cfgs, groups = get_multi_batch_sizes(first, band_mode=BandMode.full_band)
    for cfg, wids in zip(cfgs, groups):
        sets[f"covid 0-63 bin {cfg.max_sequence_size}"] = (
            packed([first[i] for i in wids], cfg.max_nodes_per_graph, dev),
            cfg.max_nodes_per_graph)
    return sets


def timed(lib, args, N):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = poa_cuda._launch(lib, *args, N, 50, 50, -8, -6, 8)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def phase_split(lib, sets):
    """Cycles per phase summed over each set's windows."""
    buf = (ctypes.c_ulonglong * 15)()
    out = {}
    for name, (args, N) in sets.items():
        if name.startswith("covid"):
            continue
        lib.poa_phase_clocks(buf)  # zero
        _, out_t = timed(lib, args, N)
        if lib.poa_phase_clocks(buf) != 0:
            raise RuntimeError("reading the phase clocks failed")
        cyc = dict(zip(PHASES, (int(x) for x in buf[:5])))
        total = sum(cyc.values())
        windows, rows, moves = (int(x) for x in buf[5:8])
        segs = dict(zip(SEGMENTS, (int(x) for x in buf[8:13])))
        cells, pred_cells = int(buf[13]), int(buf[14])
        # the bound: each input and output byte once at 3.35 TB/s, or the
        # NW's int32 operations (chip_smoke.nw_ops) at 67 T op/s
        t_bytes = sum(t.numel() * t.element_size() for t in (*args, *out_t)) / 3.35e12 * 1e3
        t_ops = (4 * pred_cells + 3 * cells) / 67e12 * 1e3
        out[name] = {"windows": windows, "rows": rows, "moves": moves, "cycles": cyc,
                     "total": total, "nw_row_segments": segs, "cells": cells,
                     "pred_cells": pred_cells, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        print(f"  bound {name}: {cells} NW cells, {pred_cells} predecessor cells -> "
              f"{t_ops:.6f} ms; bytes -> {t_bytes:.6f} ms", flush=True)
        per = (f"; {cyc['nw'] / rows:.0f} cycles an NW row, {cyc['traceback'] / moves:.0f} a "
               f"traceback move, {cyc['add'] / moves:.0f} an add move" if rows and moves else "")
        print(f"phase split {name}: {windows} windows, {rows} NW rows, {moves} moves, {total} "
              f"cycles summed; " + ", ".join(f"{p} {100 * c / max(total, 1):.1f} %"
                                             for p, c in cyc.items()) + per, flush=True)
        if rows:
            print(f"  NW row segments {name}: " + ", ".join(
                f"{k} {c / rows:.0f}" for k, c in segs.items()) + " cycles a row", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout (or archive) of another commit")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--min-blocks", type=int, nargs="*", default=[])
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    dev = torch.device("cuda")
    builds = {"this": poa_cuda.SOURCE}
    if a.parent:
        builds["parent"] = os.path.abspath(
            os.path.join(a.parent, "genomeworks_tpu_torch", "csrc", poa_cuda.SOURCE))
    with open(os.path.join(_build.CSRC, poa_cuda.SOURCE)) as f:
        has_clocks = "POA_PHASE_CLOCKS" in f.read()
    variants = {f"this@{k}": {"POA_WIN_MIN_BLOCKS": k} for k in a.min_blocks}
    with ThreadPoolExecutor() as ex:  # one nvcc each, started together
        jobs = [ex.submit(_build.build, src) for src in builds.values()]
        jobs += [ex.submit(_build.build, poa_cuda.SOURCE, d) for d in variants.values()]
        if has_clocks:
            jobs.append(ex.submit(_build.build, poa_cuda.SOURCE, CLOCKS))
        for j in jobs:
            j.result()
    libs = {}
    for name, src in builds.items():
        libs[name], lines = build(src)
        for ln in lines:
            print(f"ptxas {name}: {ln}")
    for name, d in variants.items():
        libs[name], lines = build(poa_cuda.SOURCE, d)
        for ln in lines:
            if "poa_window_kernel" in ln or "registers" in ln or "spill" in ln:
                print(f"ptxas {name}: {ln}")
    sets = covid_sets(dev)
    for name, (args, N) in sets.items():
        L = args[0].shape[2]
        print(f"set {name}: {args[0].shape[0]} windows, N={N}, L={L}; this kernel holds "
              f"{libs['this'].poa_windows_in_flight(0, L)} windows at once, a ring of "
              f"{libs['this'].poa_window_ring_rows(L)} rows")
    result = {"device": smi, "sets": {n: int(s[0][0].shape[0]) for n, s in sets.items()}}

    if has_clocks:
        clk, _ = build(poa_cuda.SOURCE, CLOCKS)
        clk.poa_phase_clocks.argtypes = [ctypes.c_void_p]
        clk.poa_phase_clocks.restype = ctypes.c_int
        result["phase_split"] = phase_split(clk, sets)

    if len(libs) > 1:
        names = list(libs)  # this, parent, this@K ...
        order = names[1:] + [names[0]] + [names[0]] + names[1:][::-1]
        ms = {n: {k: [] for k in sets} for n in names}
        ref = {}
        for k, (args, N) in sets.items():  # warm each, and hold them equal
            outs = {n: timed(libs[n], args, N)[1] for n in names}
            for n in names[1:]:
                if not all(torch.equal(x, y) for x, y in zip(outs[n], outs["this"])):
                    raise RuntimeError(f"{k}: {n}'s outputs differ from this build's")
            ref[k] = outs["this"]
        for _ in range(a.reps):
            for n in order:
                for k, (args, N) in sets.items():
                    t, out = timed(libs[n], args, N)
                    if not all(torch.equal(x, y) for x, y in zip(out, ref[k])):
                        raise RuntimeError(f"{k}: {n}'s outputs changed between runs")
                    ms[n][k].append(t)
        result["ms"] = ms
        for k in sets:
            print(f"time {k}: " + "; ".join(
                f"{n} median {np.median(ms[n][k]):.4f} ms (runs "
                f"{', '.join(f'{x:.4f}' for x in ms[n][k])})" for n in names)
                + "; outputs equal", flush=True)
        for group in ("re-runs", "chunk", "covid 0-63"):
            keys = [k for k in sets if k.startswith(group)]
            tot = {n: sum(float(np.median(ms[n][k])) for k in keys) for n in ms}
            print(f"sum of medians, {group}: "
                  + ", ".join(f"{n} {t:.4f} ms" for n, t in tot.items()))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
