"""Old against new for the extender's X-drop extension and match-count
kernels and the batched Myers distance kernel on one card.

    python3 experiments/torch_extender_check.py [--parent DIR]
        [--xdrop NAME=SOURCE[:MACRO~VALUE...]] ... [--myers NAME=SOURCE] ...

1. Builds csrc/xdrop.cu and its debug build ``-DXDROP_STATS=1`` (seeds,
   tiles over both directions and lane 0's clock64 cycles a seed, summed),
   csrc/myers_score.cu and its debug build ``-DMYERS_SCORE_STATS=1``
   (alignments, chunks, steps and cycles), and, with ``--parent DIR`` (a
   directory holding another checkout's genomeworks_tpu_torch/csrc/xdrop.cu
   and myers_score.cu, e.g. the parent commit unpacked with ``git
   archive``), those two sources too: one nvcc a library, started together.
   Prints each build's registers and spills as ptxas reports them. The
   parent's ``xdrop_extend_launch`` must have this checkout's arguments; its
   ``myers_score_launch`` may be this one's or the one before it, which took
   two (n_words, B) scratch words (PV and MV). Each ``--xdrop`` or
   ``--myers`` version (SOURCE an absolute or relative path, built with
   ``-DMACRO=VALUE`` for each ``:MACRO~VALUE``; another lane width is a
   patched copy of the source) is built and bound as the parent is, and
   timed in the same turns; a version built with ``XDROP_STATS~1`` or
   ``MYERS_SCORE_STATS~1`` is not timed but read as a debug build.
2. The main path's inputs (``chip_smoke`` phase 11's seed): the extension
   kernel over the first batch of 4,194,304 seeds, over the seeds of that
   batch that extend fewer than 64 positions in all (random pairs, mostly)
   and over the others, and over the 10 Mbp genome against itself from a
   seed on the main diagonal; the Myers kernel over phase 5's 1,024 pairs of
   2 kb and over 128 pairs of 20 kb (queries of 625 words: two chunks).
   The match-count kernel over the first batch's seeds that need the
   entropy (total score in [3000, 9000], as the extender selects them).
   Each build in turns (parent, this, the versions, then the same in
   reverse), every
   launch timed with CUDA events (median of 5). Every build's outputs must
   equal this build's, this build's extension of the first 65,536 seeds
   ``xdrop_extend_plain``'s on the card, and its counts of the first 4,000
   entropy seeds ``count_matches_plain``'s (``chip_smoke.py`` and the card
   tests hold the Myers kernel to its plain version; its plain word chain is
   a host loop over target positions and words, minutes at these shapes).
   A version of the count kernel is a copy of the source (16 lanes a seed:
   ``constexpr int COUNT_LANES = 16``).
3. With ``--parent``: the extender's main path (phase 11b's seeds, the
   entropy on) and ``myers_edit_distance_batched`` over the 1,024 pairs,
   through the parent's kernels and this checkout's in turns (parent, this,
   this, parent): warm walls, the extender's device busy share, and equal
   SSP lists and distances.
4. The debug builds' counters on the same inputs: tiles a seed-direction
   and cycles a tile (the extension), and cycles a step and steps an
   alignment (Myers).

Prints the card's name and power limit first. Needs CUDA and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from genomeworks_tpu_torch.aligner.myers import myers_inputs  # noqa: E402
from genomeworks_tpu_torch.extender import DEFAULT_SCORE_MATRIX  # noqa: E402
from genomeworks_tpu_torch.extender.xdrop_plain import (  # noqa: E402
    count_matches_plain,
    xdrop_extend_plain,
)
from genomeworks_tpu_torch.ops import _build  # noqa: E402
from genomeworks_tpu_torch.ops import myers_score_cuda as ms  # noqa: E402
from genomeworks_tpu_torch.ops import xdrop_cuda as xd  # noqa: E402

XDROP = 910
XDROP_STATS = ("seeds", "tiles", "cycles")
MYERS_STATS = ("alignments", "chunks", "steps", "cycles")


def ptxas(path, label):
    for line in _build.build_log.get(path, "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas {label}: {line.strip()}")


def median_ms(fn, reps=5):
    """fn() reps times, each between two CUDA events: (median ms, last output)."""
    fn()  # warm
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times)), out


def xdrop_run(lib, qd, td, qp, tp, sd):
    out = torch.empty((qp.shape[0], 4), dtype=torch.int32, device=qd.device)
    rc = lib.xdrop_extend_launch(qd.data_ptr(), td.data_ptr(), qp.data_ptr(), tp.data_ptr(),
                                 sd.data_ptr(), out.data_ptr(), qp.shape[0], qd.numel(),
                                 td.numel(), XDROP, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"xdrop_extend_launch failed: CUDA error {rc}")
    return out


def count_run(lib, qd, td, qp, tp, left, right):
    out = torch.empty((qp.shape[0], 4), dtype=torch.int32, device=qd.device)
    rc = lib.xdrop_count_launch(qd.data_ptr(), td.data_ptr(), qp.data_ptr(), tp.data_ptr(),
                                left.data_ptr(), right.data_ptr(), out.data_ptr(), qp.shape[0],
                                qd.numel(), td.numel(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"xdrop_count_launch failed: CUDA error {rc}")
    return out


#: the wrapper's launch function (``walls`` swaps ``ms._launch`` for a build's)
MS_LAUNCH = ms._launch


def myers_run(lib, old, peq, tc, ql, tl):
    if not old:
        return MS_LAUNCH(lib, peq, tc, ql, tl)
    B, _, n_words = peq.shape
    out = torch.empty(B, dtype=torch.int32, device=peq.device)
    scratch = torch.empty((2, n_words, B), dtype=torch.int32, device=peq.device)
    rc = lib.myers_score_launch(peq.data_ptr(), tc.data_ptr(), ql.data_ptr(), tl.data_ptr(),
                                scratch[0].data_ptr(), scratch[1].data_ptr(), out.data_ptr(), B,
                                tc.shape[1], n_words, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the parent's myers_score_launch failed: CUDA error {rc}")
    return out


def walls(libs, old_myers, query, target, seeds, pairs):
    """The extender's main path (phase 11b: all seeds, threshold 3000, the
    entropy on) and ``myers_edit_distance_batched`` over the 1,024 pairs of
    2 kb, through the parent's kernels and this checkout's in turns (parent,
    this, this, parent): warm walls (the least of 3) and, once a build, the
    extender's device busy share under ``torch.profiler``."""
    from genomeworks_tpu_torch.aligner.myers import myers_edit_distance_batched
    from genomeworks_tpu_torch.extender import create_extender

    def extend():
        ex = create_extender(device="cuda")
        ex.extend_async(query, target, chip_smoke.EXT_THRESHOLD, seeds)
        ex.sync()
        return ex.get_scored_segment_pairs()

    def timed(fn):
        best = None
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            best = wall if best is None else min(best, wall)
        return best, out

    this_launch = MS_LAUNCH
    qs, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    ref = None
    for name in ("parent", "this", "this", "parent"):
        xd._lib = libs[("xdrop", name)]
        ms._launch = this_launch if name == "this" else (
            lambda lib, *a: myers_run(libs[("myers", "parent")], old_myers, *a))
        ext_wall, ssps = timed(extend)
        busy_ms, prof_wall, _ = chip_smoke.profiled(extend)
        myers_wall, dist = timed(lambda: myers_edit_distance_batched(qs, ts, device="cuda"))
        out = ([a.astuple() for a in ssps], dist.tolist())
        if ref is None:
            ref = out
        elif out != ref:
            print(f"FAIL: the {name} kernels' SSP list or distances differ from the parent's")
            raise SystemExit(1)
        print(f"walls ({name}): extender main path {ext_wall:.4f} s ({len(ssps)} SSPs), "
              f"profiled {1e3 * prof_wall:.3f} ms with the device busy {busy_ms:.3f} ms "
              f"({100 * busy_ms / (1e3 * prof_wall):.2f} %); myers_edit_distance_batched "
              f"{myers_wall:.4f} s")
    xd._lib = libs[("xdrop", "this")]
    ms._launch = this_launch


def counters(lib, fn_name, names, run):
    """A debug build's counters over one run()."""
    ctr = (ctypes.c_ulonglong * len(names))()
    getattr(lib, fn_name)(ctr, 1)
    run()
    torch.cuda.synchronize()
    getattr(lib, fn_name)(ctr, 1)
    return dict(zip(names, (int(x) for x in ctr)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default="")
    ap.add_argument("--xdrop", action="append", default=[],
                    help="NAME=SOURCE[:MACRO~VALUE...], a version of the extension kernel")
    ap.add_argument("--myers", action="append", default=[],
                    help="NAME=SOURCE, a version of the Myers kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    jobs = {("xdrop", "this"): (xd.SOURCE, None),
            ("xdrop", "debug"): (xd.SOURCE, {"XDROP_STATS": 1}),
            ("myers", "this"): (ms.SOURCE, None),
            ("myers", "debug"): (ms.SOURCE, {"MYERS_SCORE_STATS": 1})}
    if args.parent:
        for key, mod in (("xdrop", xd), ("myers", ms)):
            jobs[(key, "parent")] = (os.path.abspath(os.path.join(
                args.parent, "genomeworks_tpu_torch", "csrc", mod.SOURCE)), None)
    versions = []
    for key, arg in [("xdrop", a) for a in args.xdrop] + [("myers", a) for a in args.myers]:
        name, rest = arg.split("=", 1)
        path, *defs = rest.split(":")
        versions.append(name)
        jobs[(key, name)] = (os.path.abspath(path),
                             {d.split("~")[0]: d.split("~")[1] for d in defs} or None)
    paths = {key: _build.library_path(*job) for key, job in jobs.items()}
    uniq = {path: jobs[key] for key, path in reversed(paths.items())}
    with ThreadPoolExecutor(len(uniq)) as pool:
        list(pool.map(lambda j: _build.build(*j), uniq.values()))
    libs = {}
    old_myers = False
    for (key, name), path in paths.items():
        ptxas(path, f"{os.path.basename(jobs[(key, name)][0])} ({name})")
        lib = ctypes.CDLL(path)
        if name == "parent" or name in versions:
            ref = libs[(key, "this")]
            for fn in ("xdrop_extend_launch", "xdrop_count_launch", "xdrop_stats",
                       "myers_score_launch", "myers_score_stats"):
                if hasattr(ref, fn) and hasattr(lib, fn):
                    getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            with open(jobs[(key, name)][0]) as f:
                if key == "myers" and "void* pv" in f.read():
                    old_myers = True
                    lib.myers_score_launch.argtypes = [ctypes.c_void_p] * 7 + [
                        ctypes.c_int] * 3 + [ctypes.c_void_p]
        else:
            lib = (xd if key == "xdrop" else ms).bind(lib)
        libs[(key, name)] = lib
    debug = {key: name for key, name in [(("xdrop", "debug"), "debug"),
                                         (("myers", "debug"), "debug")]}
    for key, name in jobs:
        defines = jobs[(key, name)][1] or {}
        if name in versions and ("XDROP_STATS" in defines or "MYERS_SCORE_STATS" in defines):
            debug[(key, name)] = name

    # -- inputs --------------------------------------------------------------------
    rng = np.random.default_rng(2027)
    query, target, seeds = chip_smoke.extender_inputs(rng, chip_smoke.EXT_GENOME,
                                                      *chip_smoke.EXT_ERRORS, chip_smoke.EXT_SEEDS)
    batch = seeds[: 1 << 22]
    qd = torch.from_numpy(query).to(dev)
    td = torch.from_numpy(target).to(dev)
    sd = torch.from_numpy(np.asarray(DEFAULT_SCORE_MATRIX, np.int32).reshape(-1).copy()).to(dev)
    qp = torch.from_numpy(batch[:, 0].astype(np.int32)).to(dev)
    tp = torch.from_numpy(batch[:, 1].astype(np.int32)).to(dev)
    ref = xdrop_run(libs[("xdrop", "this")], qd, td, qp, tp, sd)
    span = ref[:, 1].to(torch.int64) + 1 + ref[:, 3]
    short = torch.nonzero(span < 64).squeeze(1)
    long_ = torch.nonzero(span >= 64).squeeze(1)
    sets = {"batch": (qd, td, qp, tp), "short": (qd, td, qp[short], tp[short]),
            "long": (qd, td, qp[long_], tp[long_])}
    s = chip_smoke.EXT_GENOME // 3
    one = torch.tensor([s], dtype=torch.int32, device=dev)
    sets["10 Mbp self"] = (td, td, one, one)
    print(f"extension inputs: the first batch of {len(batch)} seeds, {len(short)} of them extend "
          f"fewer than 64 positions, {len(long_)} 64 or more; {int(span.sum())} positions to the "
          f"maxima; the 10 Mbp self seed at {s}")
    n = chip_smoke.EXT_CHECK
    plain = xdrop_extend_plain(qd, td, qp[:n], tp[:n], sd, XDROP)
    if not torch.equal(ref[:n], plain):
        print(f"FAIL: this build's extension differs from xdrop_extend_plain on the first {n} "
              f"seeds")
        return 1
    print(f"this build == xdrop_extend_plain on the first {n} seeds (on the card)")
    total = ref[:, 0].to(torch.int64) + ref[:, 2]
    nz = torch.nonzero((total >= chip_smoke.EXT_THRESHOLD)
                       & (total <= 3 * chip_smoke.EXT_THRESHOLD)).squeeze(1)
    cargs = (qd, td, qp[nz], tp[nz], ref[nz, 3].contiguous(), ref[nz, 1].contiguous())
    this_counts = count_run(libs[("xdrop", "this")], *cargs)
    sub = (qd, td, *(a[:4000] for a in cargs[2:]))
    if not torch.equal(this_counts[:4000], count_matches_plain(*sub)):
        print("FAIL: this build's counts differ from count_matches_plain")
        return 1
    print(f"counts: {len(nz)} seeds of the batch need the entropy; this build == "
          f"count_matches_plain on the first 4000 (on the card)")

    prng = np.random.default_rng(2025)
    pairs = {"1024 x 2 kb": chip_smoke.random_pairs(prng, 1024, 2000, 0.04, 0.01, 0.01),
             "128 x 20 kb": chip_smoke.random_pairs(prng, 128, 20000, 0.04, 0.01, 0.01)}
    myers_sets = {}
    for label, ps in pairs.items():
        peq, tc, ql, tl = myers_inputs([p[0] for p in ps], [p[1] for p in ps])
        margs = [torch.from_numpy(a).to(dev) for a in (peq.view(np.int32), tc, ql, tl)]
        myers_sets[label] = margs
        print(f"Myers {label}: n_words {peq.shape[2]}, "
              f"{libs[('myers', 'this')].myers_score_words_per_lane(peq.shape[2])} words a lane")

    # -- in turns ------------------------------------------------------------------
    names = [name for name in ("parent", "this", *dict.fromkeys(versions))
             if (("xdrop", name) in libs and ("xdrop", name) not in debug)
             or (("myers", name) in libs and ("myers", name) not in debug)]
    order = names + names[::-1]
    this_out = {label: xdrop_run(libs[("xdrop", "this")], *inputs, sd)
                for label, inputs in sets.items()}
    times: dict = {}
    for name in order:
        for label, inputs in sets.items():
            if ("xdrop", name) not in libs or ("xdrop", name) in debug:
                continue
            ms_, out = median_ms(lambda: xdrop_run(libs[("xdrop", name)], *inputs, sd))
            if not torch.equal(out, this_out[label]):
                print(f"FAIL: xdrop ({name}) differs from this build on {label}")
                return 1
            times.setdefault(("xdrop", label, name), []).append(ms_)
        if ("xdrop", name) in libs and ("xdrop", name) not in debug:
            ms_, out = median_ms(lambda: count_run(libs[("xdrop", name)], *cargs))
            if not torch.equal(out, this_counts):
                print(f"FAIL: xdrop_count ({name}) differs from this build")
                return 1
            times.setdefault(("count", "entropy seeds", name), []).append(ms_)
        if ("myers", name) in libs and ("myers", name) not in debug:
            for label, margs in myers_sets.items():
                lib = libs[("myers", name)]
                ms_, out = median_ms(lambda: myers_run(lib, name == "parent" and old_myers,
                                                       *margs))
                this = ms._launch(libs[("myers", "this")], *margs)
                if not torch.equal(out, this):
                    print(f"FAIL: Myers ({name}) differs from this build on {label}")
                    return 1
                times.setdefault(("myers", label, name), []).append(ms_)
    print(f"in turns ({', '.join(order)}), median of 5 launches each, ms:")
    for (kernel, label, name), ts in times.items():
        print(f"  {kernel} {label} {name}: {' / '.join(f'{t:.4f}' for t in ts)}")

    # -- walls -----------------------------------------------------------------------
    if args.parent:
        walls(libs, old_myers, query, target, seeds, pairs["1024 x 2 kb"])

    # -- debug builds ------------------------------------------------------------------
    for (key, name) in debug:
        if key != "xdrop":
            continue
        lib = libs[("xdrop", name)]
        for label, inputs in sets.items():
            c = counters(lib, "xdrop_stats", XDROP_STATS,
                         lambda: xdrop_run(lib, *inputs, sd))
            print(f"xdrop {name} {label}: {c}; {c['tiles'] / max(c['seeds'], 1) / 2:.3f} tiles a "
                  f"seed-direction, {c['cycles'] / max(c['tiles'], 1):.1f} cycles a tile "
                  f"(lane 0's clock over a seed, both directions)")
    for (key, name) in debug:
        if key != "myers":
            continue
        lib = libs[("myers", name)]
        for label, margs in myers_sets.items():
            c = counters(lib, "myers_score_stats", MYERS_STATS, lambda: ms._launch(lib, *margs))
            print(f"myers {name} {label}: {c}; {c['cycles'] / max(c['steps'], 1):.1f} cycles a "
                  f"step, {c['steps'] / max(c['alignments'], 1):.1f} steps an alignment")
    return 0


if __name__ == "__main__":
    sys.exit(main())
