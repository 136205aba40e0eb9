#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (genomeworks_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA card, nvcc

Phases, each of which fails the run (nonzero exit, no result line):

1. device: CUDA present; print the card's name and power limit
   (nvidia-smi); build every kernel of the port from csrc/, one nvcc per
   source, all started together, and print each kernel's registers and
   spills.
2. POA kernel vs plain version on the card: ``poa_consensus_cuda`` and
   ``torch_poa.poa_consensus_plain`` on the same CUDA tensors must give
   exactly equal cons, cov, length and err, on seeded random windows (unit
   and weighted, 2-16 reads, some driven into status 1 and 2 by small caps,
   some with empty later reads) and on the first 64 covid windows packed as
   PoaBatch packs them; a window with an empty first read is refused before
   any launch. Kernel times are CUDA events around the launch alone, not the
   wrapper's input checks.
2b. the five lockstep kernels (``ops/poa_lockstep_cuda.py``) vs their
   plain versions (``poa/lockstep_plain.py``) on the card, read by read:
   each phase's kernel and plain version on clones of one graph state must
   leave equal outputs (codes, best_i, ag/ar/klen, cons/cov/length/err)
   and equal whole states; sets: random unit and weighted windows, a ring
   of D = 4 (status 5), 16 reads at high error (edge lists, 6), the node
   cap (1), and the first 256 windows of the largest covid bucket in their
   first 4 reads.
3. POA main paths, each with every count set to 0 just before and read just
   after: (a) the default path, all covid windows through
   ``get_multi_batch_sizes`` and ``PoaBatch(device="cuda")``, which takes
   the lockstep tier for bins of 64 windows or more and the per-window
   kernel for the rest and for the tier's re-runs: every status success,
   every consensus equal to its golden line, all six kernels launched, no
   plain version called; it prints the tier counts (served / overflow /
   unserved), the wall and windows/s; (b) slice 1's path, the same windows
   through ``poa_batch_consensus(..., use_lockstep=False)`` per bin: golden,
   the per-window kernel alone, its wall and windows/s; then each path once
   under ``torch.profiler``: the device's busy share of the wall and the
   device time by kernel.
4. aligner kernels vs plain versions on the card, bit for bit: the Myers
   and banded NW forward passes and the RLE traceback (normal and small
   rcap) on seeded pairs at bands 32 to 1024; every walk consumes its
   query and target, and every pair flagged optimal equals ``align_cpu``.
5. aligner main path: 1024 pairs of 2 kb and 32 pairs of 10 kb (4 %
   substitutions, 1 % insertions, 1 % deletions) through
   ``create_aligner(max_bandwidth=1024, device="cuda")``, then 128 of the
   2-kb pairs under the engines nw, ukkonen and myers_full. Every path
   consumes its query and target; 8 optimal 2-kb paths equal ``align_cpu``;
   every 10-kb path flagged optimal has the exact edit distance; an
   alignment optimal under two engines has one path; each kernel was
   launched by the default-engine run alone, and the engine runs launch
   kernels too, and neither called a plain version.
6. each aligner kernel alone at the main path's first-pass shapes, against
   its plain version (bit for bit) and its bound.
6b. each lockstep kernel at the largest covid bucket's shapes: CUDA events
   around every launch of the bucket's chain and device time by kernel
   under ``torch.profiler``, with the work the run's data needs for the
   bound; the plain versions against the kernels on the bucket's first 256
   windows at read 1 (consensus after the whole build).
7. a ``kernels`` JSON line with each kernel's launches, error against its
   plain version, times and bound.
8. the last line: ``{"ok": true, "device": {...}}``.

It imports nothing of genomeworks_tpu or JAX.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
SOURCE = "genomeworks_tpu_torch/csrc/poa_consensus.cu"
REPLACES = "genomeworks_tpu/ops/poa_pallas.py:1895"
# H100 SXM published peaks: HBM bytes/s, and
# the non-tensor-core float32 rate, used as the rate of the int32 ALU ops
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def mutate(t: bytes, rng, sub: float, indel: float) -> str:
    out = bytearray()
    for c in t:
        r = rng.random()
        if r < sub:
            out.append(b"ACGT"[(b"ACGT".index(c) + rng.integers(1, 4)) % 4])
        elif r < sub + indel / 2:
            continue
        elif r < sub + indel:
            out.append(c)
            out.append(b"ACGT"[rng.integers(0, 4)])
        else:
            out.append(c)
    return out.decode()


def random_windows(rng, n, length, sub, indel, reads=(2, 16)):
    windows = []
    for _ in range(n):
        t = bytes(b"ACGT"[i] for i in rng.integers(0, 4, size=int(rng.integers(*length))))
        k = int(rng.integers(reads[0], reads[1] + 1))
        windows.append([t.decode()] + [mutate(t, rng, sub, indel) for _ in range(k - 1)])
    return windows


def packed(windows, weights, max_nodes, dev):
    from genomeworks_tpu_torch.poa.torch_poa import pack_windows

    seqs, wts, lens, nseqs, N = pack_windows(windows, weights, max_nodes)
    t = [torch.from_numpy(a).to(dev) for a in (seqs, wts, lens, nseqs)]
    return t, N


def cuda_ms(fn, reps=1):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def profiled(fn):
    """fn() once under torch.profiler: (device busy ms, wall s, device ms by
    event name)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    return sum(by_name.values()), wall, by_name


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def nw_ops(work):
    """int32 ops the NW needs on this data: per predecessor row per cell a
    diagonal and a vertical add and two max; per cell the closure's
    subtract, max and add. The pointer-chasing phases are not counted."""
    return 4 * work["pred_cells"] + 3 * work["cells"]


def compare(name, kernel_out, plain_out):
    err = 0
    for k, p in zip(kernel_out, plain_out):
        d = (k.to(torch.int64) - p.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    if err != 0:
        fail(f"{name}: kernel differs from its plain version (max |diff| {err})")
    return err


# -- the aligner ----------------------------------------------------------------

ALIGNER_REPLACES = {
    "myers_banded_cuda": "genomeworks_tpu/ops/myers_banded_pallas.py:264",
    "banded_nw_cuda": "genomeworks_tpu/ops/banded_nw_pallas.py:170",
    "rle_traceback_cuda": "genomeworks_tpu/ops/rle_traceback_pallas.py:376, "
                          "genomeworks_tpu/ops/rle_traceback_pallas.py:462",
}
# int32 operations each kernel's algorithm needs, for its bound:
# per 32-cell word of the band and query row, the Myers step: Eq (6), the
# add (2), Xh (2), Ph (3), Mh (1), the two shifts (4), Xv (1), PV (3), MV (1)
# and the two code bits (5)
MYERS_WORD_OPS = 28
# per band cell of the NW: the base compare, two adds, a min, the two
# boundary selects, the prefix min with its subtract and add, the INF clamp,
# and the code's two compares and select
NW_CELL_OPS = 13
# per traceback step: the band column and row, the word address and load,
# the code's shift and mask, the run update, the edge test and two moves
TB_STEP_OPS = 12
BASES = np.frombuffer(b"ACGT", np.uint8)


def mutated(rng, codes, sub, ins, dele):
    """A copy of base codes with each base substituted, deleted, or followed
    by a random inserted base with probabilities sub, dele and ins."""
    r = rng.random(len(codes))
    out = codes.copy()
    s = r < sub
    out[s] = (out[s] + rng.integers(1, 4, int(s.sum()))) % 4
    counts = np.where((r >= sub) & (r < sub + dele), 0, 1)
    grow = (r >= sub + dele) & (r < sub + dele + ins)
    counts[grow] = 2
    out = np.repeat(out, counts)
    out[np.cumsum(counts)[grow] - 1] = rng.integers(0, 4, int(grow.sum()))
    return out


def random_pairs(rng, n, length, sub, ins, dele):
    pairs = []
    for q in rng.integers(0, 4, (n, length)).astype(np.uint8):
        t = mutated(rng, q, sub, ins, dele)
        pairs.append((BASES[q].tobytes().decode(), BASES[t].tobytes().decode()))
    return pairs


def check_pairs(rng, M):
    """Pairs of at most M bases at 12 % substitutions, insertions and
    deletions; at index DRIFT one whose path leaves a band of 32
    (a + x + b against a + b + y); an empty query, an empty target, and both
    empty."""
    pairs = random_pairs(rng, 20, M * 3 // 4, 0.12, 0.12, 0.12)
    a, b, x, y = (BASES[rng.integers(0, 4, n)].tobytes().decode() for n in (60, 60, 20, 20))
    return [(a + x + b, a + b + y)] + pairs + [("", pairs[0][1]), (pairs[1][0], ""), ("", "")]


DRIFT = 0


def oracle(pairs, fn=None):
    """``fn`` (default align_cpu) of every pair, in one process per core."""
    from genomeworks_tpu_torch.aligner.cpu_reference import align_cpu

    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(fn or align_cpu, *zip(*pairs)))


def edit_distance(q: str, t: str) -> int:
    """Unit-cost edit distance, row by row of the full matrix, each row's
    insertion closure a running minimum: ``edit_distance_cpu``'s value in
    linear memory and fast enough for 10-kb pairs."""
    a, b = (np.frombuffer(s.encode(), np.uint8) for s in (q, t))
    k = np.arange(len(b) + 1)
    row = k
    for i, c in enumerate(a, 1):
        base = np.empty_like(row)
        base[0] = i
        base[1:] = np.minimum(row[1:] + 1, row[:-1] + (b != c))
        row = k + np.minimum.accumulate(base - k)
    return int(row[-1])


def consumed(path, q, t):
    return (path != 2).sum() == len(q) and (path != 3).sum() == len(t)


def walk_words(paths, qlen, tlen, dlo, W):
    """Distinct code-plane words the walks of ``paths`` read."""
    total = 0
    for path, ql, tl, d in zip(paths, qlen, tlen, dlo):
        rev = np.asarray(path[::-1], np.int64)
        i = ql - np.concatenate(([0], np.cumsum(rev != 2)[:-1]))
        j = tl - np.concatenate(([0], np.cumsum(rev != 3)[:-1]))
        main = (i > 0) & (j > 0)
        k = np.clip(j - i - d, 0, W - 1)
        total += len(np.unique(((i - 1) // 16 * W + k)[main]))
    return total


def aligner_phases(dev, ops):
    """Phases 4-6; returns the kernels line's entries of the aligner."""
    from genomeworks_tpu_torch.aligner import create_aligner
    from genomeworks_tpu_torch.aligner.aligner import pack_pairs
    from genomeworks_tpu_torch.aligner.banded_nw import band_offset, banded_nw_forward_plain
    from genomeworks_tpu_torch.aligner.myers_banded_model import myers_banded_plain
    from genomeworks_tpu_torch.aligner.rle_traceback import (
        RUN_MASK, rle_traceback_plain, runs_to_states,
    )

    from genomeworks_tpu_torch.aligner.cpu_reference import edit_distance_cpu

    kern = {name: getattr(mod, name) for name, mod in ops.items()}
    libs = {name: mod.load_library() for name, mod in ops.items()}
    plain = {"myers_banded_cuda": myers_banded_plain, "banded_nw_cuda": banded_nw_forward_plain,
             "rle_traceback_cuda": rle_traceback_plain}
    err = dict.fromkeys(kern, 0)
    TB = "rle_traceback_cuda"

    def paths_of(runs, nruns):
        runs, nruns = runs.cpu().numpy(), nruns.cpu().numpy()
        return [runs_to_states(r, int(n)) for r, n in zip(runs, nruns)]

    # -- 4. kernels vs plain versions, paths vs the oracle --------------------
    rng = np.random.default_rng(7)
    M = 256
    pairs = check_pairs(rng, M)
    ref = oracle(pairs)
    q, t, qlen, tlen = pack_pairs(pairs, M, dev)
    rcap = int((qlen + tlen).max())
    seen = {"edge": 0, "ovf": 0, "optimal": 0}
    for W in (32, 64, 256, 1024):
        dlo = band_offset(qlen, tlen, W)
        for fwd in ("myers_banded_cuda", "banded_nw_cuda"):
            codes, fits = kern[fwd](q, t, qlen, tlen, W)
            err[fwd] = max(err[fwd], compare(f"{fwd} W={W}", (codes, fits),
                                             plain[fwd](q, t, qlen, tlen, W)))
            for cap in (rcap, 4):
                out = kern[TB](codes, qlen, tlen, dlo, W, cap)
                err[TB] = max(err[TB], compare(f"{TB} on {fwd} W={W} rcap={cap}", out,
                                               plain[TB](codes, qlen, tlen, dlo, W, cap)))
                seen["ovf"] += int(out[4].sum())
            runs, nruns, _, edge, _ = kern[TB](codes, qlen, tlen, dlo, W, rcap)
            optimal = (fits & ~edge).cpu().numpy()
            if fwd == "banded_nw_cuda":
                # INF outside the band keeps the NW's path of the drifting
                # pair off the band edge, so it is called optimal at W=32
                # when it is not (the JAX package's banded NW does the same);
                # it is held to the plain version only
                optimal[DRIFT] = False
            n_opt = 0
            for b, path in enumerate(paths_of(runs, nruns)):
                if not consumed(path, *pairs[b]):
                    fail(f"{fwd} W={W} pair {b}: the walk did not consume its pair")
                if optimal[b]:
                    n_opt += 1
                    if not np.array_equal(path, ref[b]):
                        fail(f"{fwd} W={W} pair {b}: optimal path differs from align_cpu")
            seen["edge"] += int(edge.sum())
            seen["optimal"] += n_opt
            print(f"check {fwd} W={W}: {len(pairs)} pairs of <= {M} bp, kernel == plain; "
                  f"traceback == plain at rcap {rcap} and 4; {n_opt} optimal paths == "
                  f"align_cpu; {int(edge.sum())} walks touch the band edge")
    if not all(seen.values()):
        fail(f"the check sets missed a case: {seen}")
    if any(edit_distance(*p) != edit_distance_cpu(*p) for p in pairs):
        fail("edit_distance differs from edit_distance_cpu on the check set")

    # -- 5. main path -----------------------------------------------------------
    rng = np.random.default_rng(2025)
    short = random_pairs(rng, 1024, 2000, 0.04, 0.01, 0.01)
    long = random_pairs(rng, 32, 10000, 0.04, 0.01, 0.01)
    every = short + long

    def run(pairs, **kw):
        a = create_aligner(max_bandwidth=1024, device="cuda", **kw)
        for qs, ts in pairs:
            if a.add_alignment(qs, ts) != 0:
                fail("add_alignment refused a pair")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.align_all()
        alns = a.get_alignments()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if len(alns) != len(pairs):
            fail(f"{len(alns)} alignments for {len(pairs)} pairs")
        for (qs, ts), aln in zip(pairs, alns):
            if not consumed(np.asarray(aln.states), qs, ts):
                fail(f"a main-path path ({kw}) does not consume its pair")
        n_opt = sum(aln.is_optimal for aln in alns)
        print(f"main path {kw or 'engine=myers (default)'}: {len(pairs)} alignments in "
              f"{wall:.4f} s wall, {len(pairs) / wall:.1f} alignments/s, {n_opt} optimal; "
              f"alignments per band (the retry ladder): {dict(sorted(a.band_counts.items()))}")
        return alns, wall, a.band_counts

    def counted(fn):
        """fn() with every count set to 0 just before; the launches and
        plain-version calls it made."""
        for k in kern.values():
            k.launches = 0
        for p in plain.values():
            p.calls = 0
        out = fn()
        return out, {n: k.launches for n, k in kern.items()}, \
            sum(p.calls for p in plain.values())

    (main_alns, main_wall, _), launches, plain_calls = counted(lambda: run(every))
    if min(launches.values()) <= 0:
        fail(f"the aligner main path did not launch every kernel: {launches}")
    if plain_calls:
        fail(f"the aligner main path called a plain version {plain_calls} times")
    engines, eng_launches, eng_plain = counted(
        lambda: {eng: run(short[:128], engine=eng) for eng in ("nw", "ukkonen", "myers_full")})
    if min(eng_launches.values()) <= 0 or eng_plain:
        fail(f"the engine runs launched {eng_launches} and called a plain version "
             f"{eng_plain} times")
    sample = [b for b in range(len(short)) if main_alns[b].is_optimal][:8]
    for b, path in zip(sample, oracle([short[b] for b in sample])):
        if not np.array_equal(main_alns[b].states, path):
            fail(f"main-path pair {b}: optimal path differs from align_cpu")
    # the long pairs ran the banded NW, whose is_optimal can be a false
    # positive (ROADMAP queue 3): each one flagged optimal must have the
    # least edit distance
    flagged = [b for b, aln in enumerate(main_alns[len(short):]) if aln.is_optimal]
    for b, d in zip(flagged, oracle([long[b] for b in flagged], edit_distance)):
        if int((np.asarray(main_alns[len(short) + b].states) != 0).sum()) != d:
            fail(f"main-path 10-kb pair {b}: flagged optimal, but its distance is not {d}")
    for eng, (alns, _, _) in engines.items():
        for b, aln in enumerate(alns):
            if aln.is_optimal and main_alns[b].is_optimal and \
                    not np.array_equal(aln.states, main_alns[b].states):
                fail(f"pair {b}: engines myers and {eng} give two optimal paths")
    print(f"main path checks: every path consumes its pair; {len(sample)} optimal 2-kb paths "
          f"== align_cpu; {len(flagged)} of {len(long)} 10-kb paths flagged optimal, each at "
          f"the exact edit distance; optimal paths agree across engines; main path: launches "
          f"{launches}, {plain_calls} plain-version calls; engine runs: launches "
          f"{eng_launches}, {eng_plain} plain-version calls")

    # -- 6. kernels alone at the main path's first-pass shapes ------------------
    timed = {n: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0} for n in kern}
    shapes = {TB: "the planes of both buckets"}
    W = 64  # the first-pass band of the main path's pairs
    for fwd, pairs in (("myers_banded_cuda", short[:512]), ("banded_nw_cuda", long)):
        s = 2048 if fwd == "myers_banded_cuda" else 16384
        q, t, qlen, tlen = pack_pairs(pairs, s, dev)
        dlo = band_offset(qlen, tlen, W)
        ms, out = cuda_ms(lambda: ops[fwd]._launch(libs[fwd], q, t, qlen, tlen, W), reps=3)
        p_ms, p_out = cuda_ms(lambda: plain[fwd](q, t, qlen, tlen, W))
        err[fwd] = max(err[fwd], compare(f"{fwd} at the main path's shape", out, p_out))
        # what this run's data needs: the bases up to qlen and tlen, the
        # lengths, the code words of the rows up to qlen, fits; the work of
        # the rows up to qlen
        ql = qlen.cpu().numpy().astype(np.int64)
        tl = tlen.cpu().numpy().astype(np.int64)
        fbytes = int(ql.sum() + tl.sum()) + nbytes((qlen, tlen, out[1])) \
            + 4 * W * int(((ql + 15) // 16).sum())
        ops_n = (MYERS_WORD_OPS * (W // 32) if fwd == "myers_banded_cuda"
                 else NW_CELL_OPS * W) * int(ql.sum())
        timed[fwd] = {"ms": ms, "plain_ms": p_ms, "bytes": fbytes, "ops": ops_n}
        shapes[fwd] = f"{len(pairs)} main-path pairs, M={s}, W={W}"
        codes = out[0]
        cap = int((qlen + tlen).max())
        tb_ms, tb = cuda_ms(lambda: ops[TB]._launch(libs[TB], codes, qlen, tlen, dlo, cap),
                            reps=3)
        tp_ms, tp = cuda_ms(lambda: plain[TB](codes, qlen, tlen, dlo, W, cap))
        err[TB] = max(err[TB], compare(f"{TB} at the main path's shape ({fwd})", tb, tp))
        words = walk_words(paths_of(tb[0], tb[1]), ql, tlen.cpu().numpy(),
                           dlo.cpu().numpy(), W)
        steps = int((tb[0].to(torch.int64) & RUN_MASK).sum())
        # the words the walks read, the lengths and offsets, the runs they
        # wrote (4 bytes each) and the four per-walk results
        tbytes = 4 * words + nbytes((qlen, tlen, dlo, *tb[1:])) + 4 * int(tb[1].sum())
        timed[TB] = {k: timed[TB][k] + v for k, v in
                     (("ms", tb_ms), ("plain_ms", tp_ms), ("bytes", tbytes),
                      ("ops", TB_STEP_OPS * steps))}
        print(f"time {fwd}: {len(pairs)} pairs, M={s}, W={W}: kernel {ms:.3f} ms, plain "
              f"{p_ms:.1f} ms; traceback kernel {tb_ms:.3f} ms, plain {tp_ms:.1f} ms "
              f"({steps} steps, {int(tb[1].sum())} runs, {words} distinct words read)")

    entries = []
    for name, tm in timed.items():
        t_bytes = tm["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = tm["ops"] / SCALAR_OPS_PER_S * 1e3
        print(f"{name} bound: {tm['bytes']} bytes -> {t_bytes:.6f} ms; {tm['ops']} int32 ops "
              f"-> {t_ops:.6f} ms")
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"genomeworks_tpu_torch/csrc/{ops[name].SOURCE}",
            "replaces": ALIGNER_REPLACES[name],
            "state": "ported",
            "launches": launches[name],
            "max_abs_err": err[name],
            "ms": tm["ms"],
            "plain_ms": tm["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "timed_on": shapes[name],
            "main_path_s": main_wall,
            "alignments_per_s": len(every) / main_wall,
        })
    return entries


# -- the lockstep tier ------------------------------------------------------------

LK_SOURCE = "genomeworks_tpu_torch/csrc/poa_lockstep.cu"
LK_REPLACES = {
    "nw_lockstep": "genomeworks_tpu/ops/poa_lockstep_pallas.py:365",
    "tb_lockstep": "genomeworks_tpu/ops/poa_lockstep_pallas.py:538",
    "add_lockstep": "genomeworks_tpu/ops/poa_lockstep_pallas.py:820",
    "topsort_lockstep": "genomeworks_tpu/ops/poa_lockstep_pallas.py:960",
    "consensus_lockstep": "genomeworks_tpu/ops/poa_lockstep_pallas.py:1206",
}
LK_DEVICE_NAME = {"nw_lockstep": "lk_nw_kernel", "tb_lockstep": "lk_tb_kernel",
                  "add_lockstep": "lk_add_kernel", "topsort_lockstep": "lk_topsort_kernel",
                  "consensus_lockstep": "lk_consensus_kernel"}
# Bytes the walks touch, per step or node (each read once, each write once):
# a traceback step reads a code byte and a row's node id, in-count, in-edge
# and position and writes ag and ar (25 bytes); an add step reads ag and ar,
# the read's base and weight, the node's base and five counts and one
# in-list word, and writes about as much back (40); the sort reads a node's
# in-count and writes its local count, position and rank (16) and per
# out-edge reads the target and updates its count (12); consensus reads a
# node's rank, in-count, score and writes score and predecessor (16), per
# in-edge the source, weight and score (12), per emitted base its node,
# coverage and counts and writes base and coverage (13). Each step or edge
# costs about 12 int32 operations; the NW counts as nw_ops.
TB_STEP_BYTES, ADD_STEP_BYTES = 25, 40
NODE_BYTES, EDGE_BYTES, EMIT_BYTES = 16, 12, 13
WALK_OPS = 12


def lockstep_modules():
    from genomeworks_tpu_torch.ops import poa_lockstep_cuda as lk
    from genomeworks_tpu_torch.poa import lockstep, lockstep_plain

    plains = {"nw_lockstep": lockstep_plain.nw_lockstep_plain,
              "tb_lockstep": lockstep_plain.tb_lockstep_plain,
              "add_lockstep": lockstep_plain.add_lockstep_plain,
              "topsort_lockstep": lockstep_plain.topsort_lockstep_plain,
              "consensus_lockstep": lockstep_plain.consensus_lockstep_plain}
    kernels = {k.__name__: k for k in lk.KERNELS}
    return lockstep, kernels, plains


def clone_state(state):
    return {k: v.clone() for k, v in state.items()}


def bucket_tensors(windows, weights, N, dev):
    from genomeworks_tpu_torch.poa.torch_poa import pack_windows

    seqs, wts, lens, nseqs, _ = pack_windows(windows, weights, N)
    return [torch.from_numpy(a).to(dev) for a in (seqs, wts, lens, nseqs)]


def lockstep_compare(name, windows, weights, dev, max_nodes=None, D=None, reads=None):
    """The chain of one bucket, read by read: each phase's kernel and plain
    version on clones of one state must give equal outputs and equal whole
    states (codes prefilled alike, so every byte compares). Returns the
    statuses the kernels left."""
    lockstep, kernels, plains = lockstep_modules()
    N, D0, Lp, K = lockstep.bucket_plan(windows, max_nodes)
    D = D or D0
    seqs, wts, lens, nseqs = bucket_tensors(windows, weights, N, dev)
    (seqs_t, wts_t, lens_t), state = lockstep.start_bucket(
        seqs, wts if weights else None, lens, nseqs, N)
    B, S, _ = seqs.shape
    gap, mismatch, match = -8, -6, 8
    last = S if reads is None else min(S, reads + 1)

    def same(phase, k_out, p_out, ks, ps):
        from genomeworks_tpu_torch.poa.torch_poa import STATE_KEYS

        compare(f"{phase} on {name}", (*k_out, *(ks[k] for k in STATE_KEYS)),
                (*p_out, *(ps[k] for k in STATE_KEYS)))

    for s in range(1, last):
        act = nseqs > s
        w = None if wts_t is None else wts_t[s]
        ks, ps = clone_state(state), clone_state(state)
        ck = torch.full((B, N, Lp), 255, dtype=torch.uint8, device=dev)
        cp = ck.clone()
        bk = kernels["nw_lockstep"](ks, seqs_t[s], lens_t[s], act, ck, D, gap, mismatch, match)
        bp = plains["nw_lockstep"](ps, seqs_t[s], lens_t[s], act, cp, D, gap, mismatch, match)
        same("nw_lockstep", (ck, bk), (cp, bp), ks, ps)
        tk = kernels["tb_lockstep"](ks, ck, bk, lens_t[s], act, K)
        tp = plains["tb_lockstep"](ps, cp, bp, lens_t[s], act, K)
        same("tb_lockstep", tk, tp, ks, ps)
        kernels["add_lockstep"](ks, *tk, seqs_t[s], w, act)
        plains["add_lockstep"](ps, *tp, seqs_t[s], w, act)
        same("add_lockstep", (), (), ks, ps)
        kernels["topsort_lockstep"](ks, act)
        plains["topsort_lockstep"](ps, act)
        same("topsort_lockstep", (), (), ks, ps)
        state = ks
    act = nseqs > 0
    out = kernels["consensus_lockstep"](state, act)
    compare(f"consensus_lockstep on {name}", out, plains["consensus_lockstep"](state, act))
    statuses = sorted(set(out[3].tolist()))
    print(f"check lockstep {name}: {B} windows, {last - 1} of {S - 1} reads, N={N} D={D} "
          f"Lp={Lp} K={K}: every phase == plain, state and outputs; statuses {statuses}")
    return set(statuses)


def largest_covid_bucket(covid):
    """The largest bucket the lockstep tier runs on the covid workload as
    PoaBatch bins it: (windows, plan, bin config)."""
    from genomeworks_tpu_torch.poa import BandMode, get_multi_batch_sizes

    lockstep = lockstep_modules()[0]
    best = None
    for cfg, wids in zip(*get_multi_batch_sizes(covid, band_mode=BandMode.full_band)):
        if len(wids) < 64:
            continue
        ws = [covid[i] for i in wids]
        for edge, idxs in lockstep._bucket_windows([max(len(s) for s in w) for w in ws]):
            sub = [ws[i] for i in idxs]
            plan = None if edge is None else lockstep.bucket_plan(sub, cfg.max_nodes_per_graph)
            if plan is not None and (best is None or len(sub) > len(best[0])):
                best = (sub, plan, cfg)
    return best


def lockstep_work(t, plan, dev):
    """The chain of a bucket through the kernels, counting what each phase's
    data needs and timing each launch with CUDA events. Returns (work
    counts, event ms per kernel, launches per kernel, consensus outputs)."""
    lockstep, kernels, _ = lockstep_modules()
    seqs, wts, lens, nseqs = t
    N, D, Lp, K = plan
    B, S, _ = seqs.shape
    (seqs_t, wts_t, lens_t), st = lockstep.start_bucket(seqs, wts, lens, nseqs, N)
    codes = torch.empty((B, N, Lp), dtype=torch.uint8, device=dev)
    n_idx = torch.arange(N, device=dev)[None, :]
    c: dict = {}
    ms = dict.fromkeys(kernels, 0.0)
    launches = dict.fromkeys(kernels, 0)

    def add(key, val):
        c[key] = c.get(key, 0) + int(val)

    def timed(name, fn):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        ms[name] += e0.elapsed_time(e1)
        launches[name] += 1
        return out

    def graph_counts(ok, prefix):
        nc = torch.where(ok, st["node_count"], 0).to(torch.int64)
        in_graph = n_idx < nc[:, None]
        add(f"{prefix}_nodes", nc.sum())
        add(f"{prefix}_in_edges", torch.where(in_graph, st["in_count"], 0).sum())
        add(f"{prefix}_out_edges", torch.where(in_graph, st["out_count"], 0).sum())
        return nc, in_graph

    for s in range(1, S):
        act = nseqs > s
        ok = act & (st["error"] == 0)
        nc, in_graph = graph_counts(ok, "nw")
        rl1 = torch.where(ok, lens_t[s] + 1, 0).to(torch.int64)
        npred = torch.where(in_graph, st["in_count"].clamp(min=1), 0).sum(dim=1)
        add("cells", (nc * rl1).sum())
        add("pred_cells", (npred * rl1).sum())
        add("read_bytes", torch.where(ok, lens_t[s], 0).sum())
        w = None if wts_t is None else wts_t[s]
        best = timed("nw_lockstep", lambda: kernels["nw_lockstep"](
            st, seqs_t[s], lens_t[s], act, codes, D, -8, -6, 8))
        ag, ar, klen = timed("tb_lockstep", lambda: kernels["tb_lockstep"](
            st, codes, best, lens_t[s], act, K))
        add("walk_steps", klen.sum())
        timed("add_lockstep", lambda: kernels["add_lockstep"](st, ag, ar, klen, seqs_t[s], w, act))
        graph_counts(act & (st["error"] == 0), "sort")
        timed("topsort_lockstep", lambda: kernels["topsort_lockstep"](st, act))
    graph_counts((nseqs > 0) & (st["error"] == 0), "cons")
    out = timed("consensus_lockstep", lambda: kernels["consensus_lockstep"](st, nseqs > 0))
    add("emitted", out[2].sum())
    return c, ms, launches, out


def lockstep_bounds(c):
    """(bytes, int32 ops) each kernel's work needs, from the run's counts."""
    return {
        "nw_lockstep": (c["cells"] + c["read_bytes"] + 16 * c["nw_nodes"]
                        + 8 * c["nw_in_edges"],
                        nw_ops({"cells": c["cells"], "pred_cells": c["pred_cells"]})),
        "tb_lockstep": (TB_STEP_BYTES * c["walk_steps"], WALK_OPS * c["walk_steps"]),
        "add_lockstep": (ADD_STEP_BYTES * c["walk_steps"], WALK_OPS * c["walk_steps"]),
        "topsort_lockstep": (NODE_BYTES * c["sort_nodes"] + EDGE_BYTES * c["sort_out_edges"],
                             WALK_OPS * (c["sort_nodes"] + c["sort_out_edges"])),
        "consensus_lockstep": (NODE_BYTES * c["cons_nodes"] + EDGE_BYTES * c["cons_in_edges"]
                               + EMIT_BYTES * c["emitted"],
                               WALK_OPS * (c["cons_nodes"] + c["cons_in_edges"])),
    }


def lockstep_timing(covid, dev):
    """Each lockstep kernel at the shapes of the largest covid bucket: CUDA
    events around every launch of the bucket's chain, and the device time
    by kernel under torch.profiler; the plain versions on the first 256
    windows of the bucket at read 1 (and consensus after the whole build),
    with the kernels on the same inputs. Returns the kernels line's timing
    fields by name."""
    lockstep, kernels, plains = lockstep_modules()
    windows, plan, cfg = largest_covid_bucket(covid)
    N, D, Lp, K = plan
    ones = [[np.ones(len(s), np.int32) for s in w] for w in windows]
    t = bucket_tensors(windows, ones, N, dev)
    B, S, _ = t[0].shape
    shape = f"the largest covid bucket: {B} windows, {S} reads, N={N} D={D} Lp={Lp} K={K}"
    lockstep_work(t, plan, dev)  # warm
    c, ev_ms, launches, out = lockstep_work(t, plan, dev)
    busy, prof_wall, by_name = profiled(lambda: lockstep.run_bucket(*t, N, D, Lp, K, -8, -6, 8))
    dev_ms = {name: sum(ms for key, ms in by_name.items() if kname in key)
              for name, kname in LK_DEVICE_NAME.items()}
    print(f"time lockstep chain on {shape} (bin {cfg.max_sequence_size}): statuses "
          f"{sorted(set(out[3].tolist()))}; profiled run {prof_wall * 1e3:.3f} ms wall, device "
          f"busy {busy:.3f} ms; work {c}")

    # the plain versions (and the kernels again) on a subset at read 1
    sub = [x[:256].contiguous() for x in t]
    (seqs_t, wts_t, lens_t), st0 = lockstep.start_bucket(*sub, N)
    act = sub[3] > 1
    plain_ms, sub_ms = {}, {}

    def both(name, st_in, run):
        """Kernel and plain version on clones of ``st_in``, timed and
        compared; returns the kernel's outputs and state."""
        ks, ps = clone_state(st_in), clone_state(st_in)
        sub_ms[name], k_out = cuda_ms(lambda: run(kernels[name], ks))
        plain_ms[name], p_out = cuda_ms(lambda: run(plains[name], ps))
        compare(f"{name} timed on the subset", (*k_out, *ks.values()), (*p_out, *ps.values()))
        return k_out, ks

    def nw(fn, st):
        codes = torch.full((256, N, Lp), 255, dtype=torch.uint8, device=dev)
        return codes, fn(st, seqs_t[1], lens_t[1], act, codes, D, -8, -6, 8)

    (codes, best), st1 = both("nw_lockstep", st0, nw)
    tb, st2 = both("tb_lockstep", st1, lambda fn, st: fn(st, codes, best, lens_t[1], act, K))
    _, st3 = both("add_lockstep", st2,
                  lambda fn, st: (fn(st, *tb, seqs_t[1], wts_t[1], act), ())[1])
    both("topsort_lockstep", st3, lambda fn, st: (fn(st, act), ())[1])
    st = clone_state(st0)
    for s in range(1, S):
        a = sub[3] > s
        b_i = kernels["nw_lockstep"](st, seqs_t[s], lens_t[s], a, codes, D, -8, -6, 8)
        kernels["add_lockstep"](st, *kernels["tb_lockstep"](st, codes, b_i, lens_t[s], a, K),
                                seqs_t[s], wts_t[s], a)
        kernels["topsort_lockstep"](st, a)
    both("consensus_lockstep", st, lambda fn, st_: fn(st_, sub[3] > 0))
    print("time lockstep kernels vs plain on the first 256 windows of the bucket (read 1; "
          "consensus after the whole build): " + "; ".join(
              f"{n} kernel {sub_ms[n]:.3f} ms, plain {plain_ms[n]:.1f} ms" for n in kernels))

    fields = {}
    for name, (nbytes_, ops) in lockstep_bounds(c).items():
        n = launches[name]
        t_bytes = nbytes_ / HBM_BYTES_PER_S * 1e3 / n
        t_ops = ops / SCALAR_OPS_PER_S * 1e3 / n
        ms = (dev_ms[name] or ev_ms[name]) / n
        print(f"{name}: {n} launches on the bucket; device {dev_ms[name]:.3f} ms, events "
              f"{ev_ms[name]:.3f} ms in all; bound {nbytes_} bytes -> {t_bytes * n:.6f} ms, "
              f"{ops} int32 ops -> {t_ops * n:.6f} ms in all")
        fields[name] = {
            "ms": ms, "plain_ms": plain_ms[name], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "timed_on": f"{shape}: ms and bound_ms per launch (mean of the bucket's "
                        f"{n}); plain_ms on its first 256 windows at read 1",
            "subset_ms": sub_ms[name], "bucket_ms": dev_ms[name] or ev_ms[name],
            "bucket_launches": n,
        }
    return fields


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from genomeworks_tpu_torch.ops import (
        _build, banded_nw_cuda, myers_banded_cuda, poa_cuda, poa_lockstep_cuda,
        rle_traceback_cuda,
    )

    aligner_ops = {m.__name__.rsplit(".", 1)[1]: m
                   for m in (myers_banded_cuda, banded_nw_cuda, rle_traceback_cuda)}
    from genomeworks_tpu_torch.ops.poa_cuda import poa_consensus_cuda
    from genomeworks_tpu_torch.poa import BandMode, OutputType, PoaBatch, StatusType
    from genomeworks_tpu_torch.poa.torch_poa import poa_batch_consensus, poa_consensus_plain
    from genomeworks_tpu_torch.poa.windows import (
        get_multi_batch_sizes, load_golden_lines, load_window_file,
    )

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)  # the card's name and power limit, as nvidia-smi prints them
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 1. build -------------------------------------------------------------
    sources = [poa_cuda.SOURCE, poa_lockstep_cuda.SOURCE,
               *(m.SOURCE for m in aligner_ops.values())]
    t0 = time.perf_counter()
    _build.build_all(sources)
    print(f"build: {', '.join(sources)} in {time.perf_counter() - t0:.1f} s (in parallel)")
    for source in sources:
        for line in _build.build_log.get(_build.library_path(source), "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {source}: {line.strip()}")
    lib = poa_cuda.load_library()

    # -- 2. kernel vs plain version ------------------------------------------
    rng = np.random.default_rng(2024)
    unit = random_windows(rng, 24, (60, 200), 0.05, 0.05)
    weighted = random_windows(rng, 24, (60, 200), 0.05, 0.05)
    wts = [[rng.integers(1, 9, size=len(s)).astype(np.int32) for s in w] for w in weighted]
    nodecap = random_windows(rng, 8, (80, 110), 0.15, 0.15, reads=(8, 16))
    edgecap = random_windows(rng, 8, (80, 120), 0.2, 0.2, reads=(12, 16))
    # both caps small: walks that overflow the node cap and then a list,
    # where jax_poa's status precedence applies (torch_poa.clique_conflict)
    bothcap = random_windows(rng, 16, (70, 90), 0.08, 0.08, reads=(6, 12))
    # an empty later read aligns as vertical moves only and adds nothing
    gaps = [w[:1] + [""] + w[1:-1] + [""] for w in random_windows(rng, 8, (60, 120), 0.05, 0.05)]
    cases = [
        ("random unit", unit, None, None, 50, 50),
        ("random weighted", weighted, wts, None, 50, 50),
        ("random small max_nodes", nodecap, None, 170, 50, 50),
        ("random small E/A", edgecap, None, None, 4, 4),
        ("random small max_nodes and E/A", bothcap, None, 110, 4, 4),
        ("random with empty later reads", gaps, None, None, 50, 50),
    ]
    covid = load_window_file(os.path.join(DATA, "poa_windows_covid.txt.gz"))
    golden = load_golden_lines(os.path.join(DATA, "poa_golden_covid.txt"))
    if len(covid) != len(golden):
        fail(f"{len(covid)} windows but {len(golden)} golden lines")
    first = covid[:64]
    cfgs, groups = get_multi_batch_sizes(first, band_mode=BandMode.full_band)
    for cfg, wids in zip(cfgs, groups):
        ws = [first[i] for i in wids]
        ones = [[np.ones(len(s), np.int32) for s in w] for w in ws]
        cases.append((f"covid 0-63 bin {cfg.max_sequence_size}", ws, ones,
                      cfg.max_nodes_per_graph, 50, 50))

    max_err = 0
    statuses = set()
    timed = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0, "cells": 0, "pred_cells": 0}
    for name, ws, wt, max_nodes, E, A in cases:
        (seqs, wts_t, lens, nseqs), N = packed(ws, wt, max_nodes, dev)
        args = (seqs, wts_t, lens, nseqs)
        kw = dict(N=N, E=E, A=A, gap=-8, mismatch=-6, match=8)
        k_out = poa_consensus_cuda(*args, **kw)  # also warms
        k_ms, _ = cuda_ms(lambda: poa_cuda._launch(lib, *args, **kw), reps=3)
        work: dict = {}
        p_ms, p_out = cuda_ms(lambda: poa_consensus_plain(*args, **kw, work=work))
        max_err = max(max_err, compare(name, k_out, p_out))
        st = sorted(set(k_out[3].tolist()))
        statuses.update(st)
        slab = poa_cuda.load_library().poa_slab_bytes(N, seqs.shape[2], E, A)
        print(f"check {name}: {len(ws)} windows, N={N} L={seqs.shape[2]} E={E} A={A} "
              f"({slab} scratch bytes a window): kernel == plain (statuses {st}); "
              f"kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms")
        if name.startswith("covid"):
            timed["ms"] += k_ms
            timed["plain_ms"] += p_ms
            timed["bytes"] += nbytes((*args, *k_out))
            timed["ops"] += nw_ops(work)
            timed["cells"] += work["cells"]
            timed["pred_cells"] += work["pred_cells"]
    if not {0, 1, 2} <= statuses:
        fail(f"the check sets did not reach statuses 0, 1 and 2 (got {sorted(statuses)})")
    (seqs, wts_t, lens, nseqs), N = packed([["ACGT", "ACGA"], ["", "ACGT"]], None, None, dev)
    launches = poa_cuda.poa_consensus_cuda.launches
    try:
        poa_consensus_cuda(seqs, wts_t, lens, nseqs, N=N, E=50, A=50)
        refused = False
    except ValueError:
        refused = True
    if not refused or poa_cuda.poa_consensus_cuda.launches != launches:
        fail("a window with an empty first read reached the kernel")
    print("check empty first read: refused before any launch")

    # -- 2b. the lockstep kernels vs their plain versions ------------------------
    lockstep, lk_kernels, lk_plains = lockstep_modules()
    rng = np.random.default_rng(2026)
    lk_unit = random_windows(rng, 32, (60, 200), 0.05, 0.05)
    lk_weighted = random_windows(rng, 32, (60, 200), 0.05, 0.05)
    lk_wts = [[rng.integers(1, 9, size=len(s)).astype(np.int32) for s in w] for w in lk_weighted]
    big, _, big_cfg = largest_covid_bucket(covid)
    lk_statuses = set()
    for name, ws, wt, kw in (
        ("random unit", lk_unit, None, {}),
        ("random weighted", lk_weighted, lk_wts, {}),
        # a ring of 4 rows: predecessors farther away are code 5
        ("random, D = 4", random_windows(rng, 32, (60, 120), 0.05, 0.05), None, {"D": 4}),
        # 16 reads at about 30 % error: edge lists overflow, code 6
        ("16 reads at 30 % error", random_windows(rng, 16, (40, 50), 0.15, 0.15, reads=(16, 16)),
         None, {}),
        # the node cap N = 128 against 12-16 reads at 25 % error: code 1
        ("random, N = 128", random_windows(rng, 16, (45, 60), 0.15, 0.1, reads=(12, 16)), None,
         {}),
        (f"covid bin {big_cfg.max_sequence_size}, largest bucket, first 256 windows", big[:256],
         [[np.ones(len(s), np.int32) for s in w] for w in big[:256]],
         {"max_nodes": big_cfg.max_nodes_per_graph, "reads": 4}),
    ):
        lk_statuses |= lockstep_compare(name, ws, wt, dev, **kw)
    if not {0, 1, 5, 6} <= lk_statuses:
        fail(f"the lockstep check sets did not reach statuses 0, 1, 5 and 6 "
             f"(got {sorted(lk_statuses)})")

    # -- 3. the main paths --------------------------------------------------------
    poa_kernels = {"poa_consensus_cuda": poa_consensus_cuda, **lk_kernels}
    poa_plains = (poa_consensus_plain, *lk_plains.values())

    def counted(fn):
        """fn() with every count set to 0 just before: (its result, wall s,
        launches by kernel, plain-version calls, tier counts)."""
        for k in poa_kernels.values():
            k.launches = 0
        for p in poa_plains:
            p.calls = 0
        lockstep.reset_tier_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return (out, wall, {n: k.launches for n, k in poa_kernels.items()},
                sum(p.calls for p in poa_plains), dict(lockstep.tier_stats))

    def by_bin(windows, run):
        cfgs, groups = get_multi_batch_sizes(windows, band_mode=BandMode.full_band)
        out = {}
        for cfg, wids in zip(cfgs, groups):
            for wid, c, s in zip(wids, *run(cfg, [windows[i] for i in wids])):
                out[wid] = (c, s)
        return [out[i] for i in range(len(windows))]

    def poa_batch(cfg, ws):
        """The default path: PoaBatch, the lockstep tier for bins of 64
        windows or more, the per-window kernel for the rest and the re-runs."""
        batch = PoaBatch(cfg, OutputType.consensus, device="cuda")
        for w in ws:
            if batch.add_poa_group(w)[0] != StatusType.success:
                fail("add_poa_group refused a covid window")
        batch.generate_poa()
        cons, _, sts = batch.get_consensus()
        return cons, [0 if s == StatusType.success else s for s in sts]

    def per_window(cfg, ws):
        """Slice 1's path: every window through the per-window kernel."""
        ones = [[np.ones(len(s), np.int32) for s in w] for w in ws]
        cons, _, sts = poa_batch_consensus(ws, max_nodes=cfg.max_nodes_per_graph, weights=ones,
                                           device="cuda", use_lockstep=False)
        return cons, sts

    def check_golden(label, results):
        bad = [i for i, (c, s) in enumerate(results) if s != 0]
        if bad:
            fail(f"{label}: {len(bad)} covid windows without success, first {bad[:5]}")
        diff = [i for i, ((c, _), g) in enumerate(zip(results, golden)) if c != g]
        if diff:
            fail(f"{label}: {len(diff)} covid windows differ from the golden, first {diff[:5]}")

    by_bin(covid[:1024], poa_batch)  # warm: libraries loaded, allocator primed
    by_bin(covid[:64], per_window)
    results, wall, launches, plain_calls, tiers = counted(lambda: by_bin(covid, poa_batch))
    check_golden("default path", results)
    if min(launches.values()) <= 0:
        fail(f"the default path did not launch every kernel: {launches}")
    if plain_calls:
        fail(f"the default path called a plain version {plain_calls} times")
    print(f"main path (default: lockstep tier): {len(covid)} covid windows through "
          f"PoaBatch(device='cuda'): all success, all equal the golden; {wall:.3f} s wall, "
          f"{len(covid) / wall:.1f} windows/s; tier counts {tiers}; launches {launches} (the "
          f"per-window kernel's are its bins under 64 windows and the re-runs); "
          f"{plain_calls} plain-version calls")
    results, wall1, launches1, plain1, tiers1 = counted(lambda: by_bin(covid, per_window))
    check_golden("use_lockstep=False path", results)
    if launches1["poa_consensus_cuda"] <= 0 or sum(launches1.values()) != \
            launches1["poa_consensus_cuda"] or plain1 or sum(tiers1.values()):
        fail(f"the use_lockstep=False path launched {launches1}, called a plain version "
             f"{plain1} times, counted tiers {tiers1}")
    print(f"main path (use_lockstep=False, slice 1's): {len(covid)} covid windows through "
          f"poa_batch_consensus per bin: all success, all equal the golden; {wall1:.3f} s "
          f"wall, {len(covid) / wall1:.1f} windows/s; launches {launches1}; {plain1} "
          f"plain-version calls")
    for label, run in (("default path", poa_batch), ("use_lockstep=False path", per_window)):
        busy_ms, prof_wall, by_name = profiled(lambda: by_bin(covid, run))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(f"profiled {label}: {prof_wall * 1e3:.3f} ms wall under torch.profiler, device "
              f"busy {busy_ms:.3f} ms ({100 * busy_ms / (prof_wall * 1e3):.2f} % of the wall); "
              + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top))

    # kernel alone on the whole workload, packed per bin as the main path does
    cfgs, groups = get_multi_batch_sizes(covid, band_mode=BandMode.full_band)
    covid_ms = 0.0
    for cfg, wids in zip(cfgs, groups):
        ws = [covid[i] for i in wids]
        ones = [[np.ones(len(s), np.int32) for s in w] for w in ws]
        (seqs, wts_t, lens, nseqs), N = packed(ws, ones, cfg.max_nodes_per_graph, dev)
        ms, _ = cuda_ms(lambda: poa_cuda._launch(lib, seqs, wts_t, lens, nseqs, N=N, E=50, A=50,
                                                 gap=-8, mismatch=-6, match=8))
        print(f"kernel on covid bin {cfg.max_sequence_size}: {len(ws)} windows, N={N}, "
              f"{ms:.3f} ms")
        covid_ms += ms
    print(f"kernel on the whole covid workload: {covid_ms:.3f} ms")

    # -- 4-6. the aligner -----------------------------------------------------
    aligner_entries = aligner_phases(dev, aligner_ops)

    # -- 6b. the lockstep kernels alone at the largest covid bucket's shapes -----
    lk_fields = lockstep_timing(covid, dev)

    # -- 7. kernels line ------------------------------------------------------
    t_bytes = timed["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = timed["ops"] / SCALAR_OPS_PER_S * 1e3
    print(f"covid 0-63 bound: {timed['bytes']} bytes -> {t_bytes:.6f} ms; "
          f"{timed['ops']} int32 ops ({timed['cells']} NW cells, "
          f"{timed['pred_cells']} predecessor cells) -> {t_ops:.6f} ms")
    kernels = {"kernels": [{
        "name": "poa_consensus_cuda",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "state": "ported",
        "launches": launches["poa_consensus_cuda"],
        "max_abs_err": max_err,
        "ms": timed["ms"],
        "plain_ms": timed["plain_ms"],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "timed_on": "covid windows 0-63, packed per bin as PoaBatch packs them",
        "covid_kernel_ms": covid_ms,
        "main_path_s": wall1,
        "windows_per_s": len(covid) / wall1,
        "launches_use_lockstep_false": launches1["poa_consensus_cuda"],
    }, *({
        "name": name,
        "route": "cuda",
        "source": LK_SOURCE,
        "replaces": LK_REPLACES[name],
        "state": "ported",
        "launches": launches[name],
        "max_abs_err": 0,
        "library_ms": None,
        **lk_fields[name],
        "main_path_s": wall,
        "windows_per_s": len(covid) / wall,
        "tier_counts": tiers,
    } for name in LK_REPLACES), *aligner_entries]}
    print(json.dumps(kernels))
    # -- 8. result --------------------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
