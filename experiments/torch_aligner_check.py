"""Old against new for the aligner's kernels (the Myers forward, the banded
NW and the RLE traceback) on one card.

    python3 experiments/torch_aligner_check.py [--parent DIR]
        [--myers NAME=SOURCE[:MACRO~VALUE...]] ...
        [--nw NAME=SOURCE[:MACRO~VALUE...]] ... [--scan]

1. Builds csrc/myers_banded.cu, csrc/banded_nw.cu and csrc/rle_traceback.cu,
   their debug builds (``-DMYERS_STATS=1``: clock64 cycles of a Myers row
   warp over its rows and at its barriers, and of its first flush warp
   between barriers;
   ``-DNW_STATS=1``: clock64 cycles over a warp kernel's rows;
   ``-DRLE_TB_STATS=1``: a walk's cycles, steps, moves and tile loads) and,
   with ``--parent DIR`` (a directory holding another checkout's
   genomeworks_tpu_torch/csrc/myers_banded.cu, banded_nw.cu and
   rle_traceback.cu, e.g. the parent commit unpacked with ``git archive``),
   those three sources too, and each ``--myers`` version of
   ``csrc/myers_banded.cu`` and ``--nw`` version of ``csrc/banded_nw.cu``
   (SOURCE an absolute or relative path, built with ``-DMACRO=VALUE`` for
   each ``:MACRO~VALUE``), through ``_build.build``
   with an absolute source path, one nvcc a library, started together (the
   same source and macros are one library). Prints each build's registers,
   shared memory and spills of every instantiation as ptxas reports them.
   The parent and the versions must have this checkout's launch functions
   (``myers_banded_launch``, ``banded_nw_launch``, ``rle_traceback_launch``),
   or, for the parent's NW, the ``banded_nw_launch`` before its ``dist``
   output (the script binds either).
2. The main path's first-pass pairs (``chip_smoke`` phase 5's seed: 512
   pairs of 2 kb, 32 of 10 kb, W = 64): the Myers kernel on the 2-kb pairs
   at W = 64 and at bands 128 to 1024, and at the ``myers_full`` shape (the
   first 128 of those pairs at W = 4096, as phase 5's engine run packs
   them); the NW on the 10-kb pairs, and the traceback on both buckets'
   planes (the 2-kb planes from this checkout's Myers kernel, the 10-kb ones
   from the NW), at the rows and columns the aligner packs a chunk at
   (``pack_shape``) and at the power-of-two shapes it packed at before
   (M = N = 2048 and 16384), then the NW at bands 128 to 1024 on the 10-kb
   pairs. Each build in turns (parent, this, the ``--myers`` versions, then
   in reverse; the versions on the Myers shapes only; in each of this
   build's turns the NW also with its distance output, "this+dist", whose
   codes and fits must equal the others' and whose distances must equal
   ``banded_nw_final_plain``'s), every launch timed
   with CUDA events (median of 5); every turn's outputs must equal the
   first turn's at the same shape, the two shapes' traceback outputs must be
   equal, and this build's Myers outputs must equal ``myers_banded_plain``
   at every Myers shape.
3. The debug builds' counters on the same inputs (and those of each
   ``--myers`` version built with ``MYERS_STATS~1``): cycles a Myers row
   (the row warp, barrier waits included, and those waits alone) and the
   flush warp's cycles a 16-row plane word row (lane 0's clock, over the
   alignments), a NW row (warp kernel, lane 0's clock), a traceback step,
   steps against moves inside the matrix, and the tile loads the walks
   waited for.
4. With ``--scan``: the Myers debug build's cycles a row at W = 64 and 1024
   with 1, 4, 128 and 512 of the 2-kb pairs launched (does one alignment
   alone take as long a row as many?).
5. The block NW (bands past the warp kernel's 512) on ``chip_smoke``'s 32
   SV pairs (10 kb, each target lacking 600-900 bases of its query, band
   1024 on the aligner's path) at W = 1024, 2048, 4096 and 16384, in the
   same turns (every turn's outputs equal the first's; this build's at
   1024 equal ``banded_nw_final_plain``), with each ``--nw`` version in
   the same turns (the SV shapes only), and the debug build's block
   counters there (and those of each ``--nw`` version built with
   ``NW_STATS~1``): thread 0's cycles a step and lane 0's cycles waiting
   for the neighbouring warps' words, a warp.

Prints the card's name and power limit first. Needs CUDA and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from genomeworks_tpu_torch.aligner.aligner import pack_pairs, pack_shape  # noqa: E402
from genomeworks_tpu_torch.aligner.banded_nw import (  # noqa: E402
    band_offset,
    banded_nw_final_plain,
)
from genomeworks_tpu_torch.aligner.myers_banded_model import myers_banded_plain  # noqa: E402
from genomeworks_tpu_torch.ops import _build  # noqa: E402
from genomeworks_tpu_torch.ops import banded_nw_cuda as nw  # noqa: E402
from genomeworks_tpu_torch.ops import myers_banded_cuda as myers  # noqa: E402
from genomeworks_tpu_torch.ops import rle_traceback_cuda as tb  # noqa: E402

#: the debug builds' counters, in the order of the sources' MS_* / NS_* / TS_*
#: enums
MYERS_STATS = ("pairs", "rows", "cycles", "wait_cycles", "flush_cycles", "groups")
NW_STATS = ("pairs", "rows", "cycles", "block_pairs", "block_rows", "block_cycles",
            "block_warps", "block_wait")
SV_BANDS = (1024, 2048, 4096, 16384)  # the block NW's bands on the SV pairs
TB_STATS = ("walks", "cycles", "steps", "moves", "loads", "prefetched")
W = 64  # the main path's first band
LAUNCH = {"myers": "myers_banded_launch", "nw": "banded_nw_launch", "tb": "rle_traceback_launch"}


def ptxas(path, label):
    for ln in _build.build_log.get(path, "").splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print(f"  ptxas {label}: {ln.strip()}")


def median_ms(fn, reps=5):
    times = []
    out = None
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times)), out


def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def myers_counters(lib, inputs, wide):
    """The Myers debug counters of one launch, or None for a normal build."""
    ctr = (ctypes.c_ulonglong * len(MYERS_STATS))()
    if lib.myers_banded_stats(ctr, 1) != 0:
        return None
    myers._launch(lib, *inputs, wide)
    torch.cuda.synchronize()
    lib.myers_banded_stats(ctr, 1)
    return dict(zip(MYERS_STATS, (int(x) for x in ctr)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default="")
    ap.add_argument("--myers", action="append", default=[],
                    help="NAME=SOURCE[:MACRO~VALUE...], a version of the Myers kernel")
    ap.add_argument("--nw", action="append", default=[],
                    help="NAME=SOURCE[:MACRO~VALUE...], a version of the banded NW")
    ap.add_argument("--scan", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    jobs = {("nw", "this"): (nw.SOURCE, None), ("tb", "this"): (tb.SOURCE, None),
            ("nw", "debug"): (nw.SOURCE, {"NW_STATS": 1}),
            ("tb", "debug"): (tb.SOURCE, {"RLE_TB_STATS": 1}),
            ("myers", "this"): (myers.SOURCE, None),
            ("myers", "debug"): (myers.SOURCE, {"MYERS_STATS": 1})}
    if args.parent:
        for key, mod in (("myers", myers), ("nw", nw), ("tb", tb)):
            jobs[(key, "parent")] = (os.path.abspath(os.path.join(
                args.parent, "genomeworks_tpu_torch", "csrc", mod.SOURCE)), None)
    versions, nw_versions, nw_debug = [], [], []
    for key, given, found in (("myers", args.myers, versions), ("nw", args.nw, nw_versions)):
        for arg in given:
            name, rest = arg.split("=", 1)
            path, *defs = rest.split(":")
            defs = {d.split("~")[0]: d.split("~")[1] for d in defs} or None
            (nw_debug if defs and "NW_STATS" in defs else found).append(name)
            jobs[(key, name)] = (os.path.abspath(path), defs)
    # one nvcc a library, started together (a parent source equal to this
    # checkout's is the same library)
    paths = {key: _build.library_path(*job) for key, job in jobs.items()}
    uniq = {path: jobs[key] for key, path in reversed(paths.items())}
    with ThreadPoolExecutor(len(uniq)) as pool:
        list(pool.map(lambda j: _build.build(*j), uniq.values()))
    libs, printed = {}, set()
    for (key, name), path in paths.items():
        if path not in printed:
            printed.add(path)
            ptxas(path, f"{os.path.basename(jobs[(key, name)][0])} ({name})")
        lib = ctypes.CDLL(path)
        if name in ("this", "debug"):
            lib = {"nw": nw, "tb": tb, "myers": myers}[key].bind(lib)
        else:  # the parent's or a version's launch function, as this checkout binds it
            ref = libs[(key, "this")]
            for fn in (LAUNCH[key], "myers_banded_stats", "banded_nw_stats"):
                if hasattr(lib, fn) and hasattr(ref, fn):
                    getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
                    getattr(lib, fn).restype = ctypes.c_int
        libs[(key, name)] = lib
    print(f"the warp NW takes bands up to {libs[('nw', 'this')].banded_nw_warp_max_band()}")
    # a parent NW without the dist output takes one pointer less
    old_nw = set()
    if args.parent:
        with open(jobs[("nw", "parent")][0]) as f:
            if "void* dist" not in f.read():
                old_nw.add("parent")
                libs[("nw", "parent")].banded_nw_launch.argtypes = \
                    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

    def nw_launch(name, q, t, qlen, tlen, wide, with_dist=False):
        lib = libs[("nw", name)]
        if name not in old_nw:
            return nw._launch(lib, q, t, qlen, tlen, wide, with_dist)
        B, M = q.shape
        codes = torch.empty((B, nw.num_words(M), wide), dtype=torch.int32, device=q.device)
        fits = torch.empty(B, dtype=torch.bool, device=q.device)
        rc = lib.banded_nw_launch(q.data_ptr(), t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
                                  codes.data_ptr(), fits.data_ptr(), B, M, t.shape[1], wide,
                                  torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the parent's banded_nw_launch failed: CUDA error {rc}")
        return codes, fits

    sv = chip_smoke.sv_pairs(np.random.default_rng(15))
    sv_M, sv_N = pack_shape(sv, 16384)
    sv_in = pack_pairs(sv, sv_M, sv_N, dev)
    ok_sv = all(torch.equal(a, b) for a, b in zip(
        nw_launch("this", *sv_in, 1024, True), banded_nw_final_plain(*sv_in, 1024)))
    print(f"nw (block) SV pairs W=1024: this build == banded_nw_final_plain: {ok_sv}", flush=True)
    if not ok_sv:
        print("SOME RUN DIFFERS")
        return 1
    rng = np.random.default_rng(2025)
    short = chip_smoke.random_pairs(rng, 1024, 2000, 0.04, 0.01, 0.01)[:512]
    long = chip_smoke.random_pairs(rng, 32, 10000, 0.04, 0.01, 0.01)
    cases = {}  # (bucket, shape) -> inputs
    for bucket, pairs, s in (("2 kb", short, 2048), ("10 kb", long, 16384)):
        for shape, (M, N) in (("new", pack_shape(pairs, s)), ("old", (s, s))):
            q, t, qlen, tlen = pack_pairs(pairs, M, N, dev)
            cases[(bucket, shape)] = (q, t, qlen, tlen, band_offset(qlen, tlen, W), M, N)
    # the 2-kb planes come from this checkout's Myers kernel
    planes = {k: myers._launch(libs[("myers", "this")], *v[:4], W)[0]
              for k, v in cases.items() if k[0] == "2 kb"}
    # the Myers shapes: the 2-kb pairs at the main path's band and wider, and
    # the first 128 at the band myers_full gives them (qlen + tlen + 1, to a
    # power of two: 4096)
    myers_cases = {}
    for wide in (W, 128, 256, 512, 1024):
        myers_cases[("2 kb", wide)] = cases[("2 kb", "new")][:4]
    full = short[:128]
    myers_cases[("myers_full", 4096)] = pack_pairs(full, *pack_shape(full, 2048), dev)
    for (label, wide), inputs in myers_cases.items():
        ok = same(myers._launch(libs[("myers", "this")], *inputs, wide),
                  myers_banded_plain(*inputs, wide))
        print(f"myers {label} W={wide}: this build == myers_banded_plain: {ok}", flush=True)
        if not ok:
            print("SOME RUN DIFFERS")
            return 1

    names = (["parent"] if args.parent else []) + ["this"] + versions + nw_versions
    order = names + names[::-1]
    ref, times, ok = {}, {}, True
    dists = {}  # this build's distances on the 10-kb pairs, by shape

    def timed(name, kernel, key, fn):
        nonlocal ok
        ms, out = median_ms(fn)
        ok &= same(out, ref.setdefault((kernel, key), out))
        times.setdefault((kernel, key), {}).setdefault(name, []).append(ms)
        return out

    for turn, name in enumerate(order):
        for (label, wide), (q, t, qlen, tlen) in (myers_cases.items()
                                                  if name not in nw_versions else ()):
            timed(name, "myers", (label, "new", q.shape[1], t.shape[1], wide),
                  lambda: myers._launch(libs[("myers", name)], q, t, qlen, tlen, wide))
        # a Myers version: the Myers shapes only; a NW version: the SV shapes
        all_kernels = name not in versions and name not in nw_versions
        for (bucket, shape), (q, t, qlen, tlen, dlo, M, N) in \
                (cases.items() if all_kernels else ()):
            if bucket == "10 kb":
                codes = timed(name, "nw", (bucket, shape, M, N, W),
                              lambda: nw_launch(name, q, t, qlen, tlen, W))[0]
                if name == "this":
                    timed("this+dist", "nw", (bucket, shape, M, N, W),
                          lambda: nw_launch(name, q, t, qlen, tlen, W, True)[1:])
                    dists[(bucket, shape, W)] = nw_launch(name, q, t, qlen, tlen, W, True)[0]
            else:
                codes = planes[(bucket, shape)]
            cap = int((qlen + tlen).max())
            out = timed(name, "tb", (bucket, shape, M, N, W),
                        lambda: tb._launch(libs[("tb", name)], codes, qlen, tlen, dlo, cap))
            ok &= same(out, ref.setdefault(("tb", bucket), out))  # the same at both shapes
        q, t, qlen, tlen, _, M, N = cases[("10 kb", "new")]
        for wide in (128, 256, 512, 1024) if all_kernels else ():
            timed(name, "nw", ("10 kb", "new", M, N, wide),
                  lambda: nw_launch(name, q, t, qlen, tlen, wide))
            if name == "this":
                timed("this+dist", "nw", ("10 kb", "new", M, N, wide),
                      lambda: nw_launch(name, q, t, qlen, tlen, wide, True)[1:])
        for wide in SV_BANDS if name not in versions else ():
            timed(name, "nw-block", ("SV", "new", sv_M, sv_N, wide),
                  lambda: nw_launch(name, *sv_in, wide))
        print(f"turn {turn + 1} ({name}) done; outputs {'equal' if ok else 'DIFFER'}", flush=True)
    # the distance output against its plain version (on the card) at the main
    # path's shape; the shape before gives the same distances
    q, t, qlen, tlen, _, M, N = cases[("10 kb", "new")]
    p_dist = banded_nw_final_plain(q, t, qlen, tlen, W)[0]
    for key, d in dists.items():
        eq = torch.equal(d, p_dist)
        ok &= eq
        print(f"nw dist {key}: == banded_nw_final_plain: {eq}")
    for (kernel, (bucket, shape, M, N, w)), by_name in times.items():
        print(f"time {kernel} {bucket} M={M} N={N} W={w}: " + "; ".join(
            f"{name} " + ", ".join(f"{x:.4f}" for x in ts) for name, ts in by_name.items())
            + " ms (median of 5 launches a turn)")
    for shape in ("new", "old"):
        sums = {name: sum(np.mean(by_name[name]) for (k, key), by_name in times.items()
                          if k == "tb" and key[1] == shape)
                for name in set(order) - set(versions) - set(nw_versions)}
        print(f"traceback on both buckets' planes, {shape} shapes, turns averaged: "
              + ", ".join(f"{n} {v:.4f} ms" for n, v in sums.items()))

    # the debug builds' counters
    ctr = (ctypes.c_ulonglong * len(TB_STATS))()
    nw_ctr = (ctypes.c_ulonglong * len(NW_STATS))()
    dbg_my, dbg_nw, dbg_tb = libs[("myers", "debug")], libs[("nw", "debug")], libs[("tb", "debug")]
    for name in ["debug"] + versions:
        for (label, wide), inputs in myers_cases.items():
            c = myers_counters(libs[("myers", name)], inputs, wide)
            if c is None and name == "debug":
                print("the Myers debug build's counters could not be read")
                return 1
            if c is None:  # a version's normal build
                break
            print(f"{name} myers {label} M={inputs[0].shape[1]} N={inputs[1].shape[1]} "
                  f"W={wide}: {c}; {c['cycles'] / c['rows']:.1f} cycles a row, of which "
                  f"{c['wait_cycles'] / c['rows']:.1f} at the barriers; a flush warp "
                  f"{2 * c['flush_cycles'] / c['groups']:.1f} cycles a 16-row plane word row "
                  f"(lane 0's clock, the mean over the {c['pairs']} alignments)")
    for shape in ("new", "old"):
        q, t, qlen, tlen, dlo, M, N = cases[("10 kb", shape)]
        dbg_nw.banded_nw_stats(nw_ctr, 1)
        codes = nw._launch(dbg_nw, q, t, qlen, tlen, W)[0]
        torch.cuda.synchronize()
        if dbg_nw.banded_nw_stats(nw_ctr, 1) != 0:
            print("the NW debug build's counters could not be read")
            return 1
        c = dict(zip(NW_STATS, (int(x) for x in nw_ctr)))
        print(f"debug NW 10 kb M={M} N={N} W={W}: {c}; {c['cycles'] / c['rows']:.1f} cycles a "
              f"row (lane 0's clock, the mean over the {c['pairs']} warps)")
        for bucket in ("2 kb", "10 kb"):
            q, t, qlen, tlen, dlo, M, N = cases[(bucket, shape)]
            plane = planes[(bucket, shape)] if bucket == "2 kb" else codes
            dbg_tb.rle_traceback_stats(ctr, 1)
            tb._launch(dbg_tb, plane, qlen, tlen, dlo, int((qlen + tlen).max()))
            torch.cuda.synchronize()
            dbg_tb.rle_traceback_stats(ctr, 1)
            c = dict(zip(TB_STATS, (int(x) for x in ctr)))
            print(f"debug traceback {bucket} M={M} N={N}: {c}; {c['steps'] / c['walks']:.1f} "
                  f"steps a walk for {c['moves'] / c['walks']:.1f} moves in the matrix "
                  f"({c['moves'] / c['steps']:.2f} moves a step); {c['cycles'] / c['steps']:.1f} "
                  f"cycles a step; {c['loads'] / c['walks']:.1f} tile loads waited for and "
                  f"{c['prefetched'] / c['walks']:.1f} prefetched rows a walk")
    for name, wide in [(n, w) for n in ["debug"] + nw_debug for w in SV_BANDS]:
        lib = libs[("nw", name)]
        lib.banded_nw_stats(nw_ctr, 1)
        nw._launch(lib, *sv_in, wide)
        torch.cuda.synchronize()
        lib.banded_nw_stats(nw_ctr, 1)
        c = dict(zip(NW_STATS, (int(x) for x in nw_ctr)))
        cols = lib.banded_nw_block_cols(wide)
        steps = sv_M + 31 + 32 * (-(-wide // (32 * cols)) - 1)  # the block's global steps
        print(f"{name} NW (block, {cols} columns a lane) SV M={sv_M} N={sv_N} W={wide}: {c}; "
              f"{c['block_cycles'] / c['block_pairs'] / steps:.1f} cycles a step (thread 0's "
              f"clock over {steps} steps, the mean over the {c['block_pairs']} blocks); a warp "
              f"spends {c['block_wait'] / c['block_warps'] / steps:.1f} of them waiting for its "
              f"neighbours' words")
    if args.scan:
        for wide in (W, 1024):
            for n in (1, 4, 128, 512):
                c = myers_counters(dbg_my, pack_pairs(short[:n], *pack_shape(short[:n], 2048),
                                                      dev), wide)
                print(f"scan myers W={wide}, {n} alignments: {c['cycles'] / c['rows']:.1f} cycles "
                      f"a row ({c['wait_cycles'] / c['rows']:.1f} at the barriers)", flush=True)
    print("ALL EQUAL" if ok else "SOME RUN DIFFERS")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
