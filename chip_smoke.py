#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (genomeworks_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA card, nvcc

Phases, each of which fails the run (nonzero exit, no result line):

1. device: CUDA present; print the card's name and power limit
   (nvidia-smi); build every kernel of the port from csrc/, one nvcc per
   source, all started together, and print each kernel's registers and
   spills.
2. the full-band kernel (a warp per window) vs its plain versions:
   ``poa_consensus_cuda`` and ``torch_poa.poa_consensus_plain`` on the same
   inputs (the plain version on the card for the covid sets, where it is
   timed, and on the host CPU for the others, one process per core) must
   give exactly equal cons, cov, length and err, on
   seeded random windows (unit and weighted, 2-16 reads, some driven into
   status 1 and 2 by small caps, some with empty later reads), on the edge
   sets of its warp layout (``window_edge_sets``: read lengths at a lane's
   and a tile's edges, reads of 640 bases in two tiles, predecessors at the
   shared ring's last distance and past it, lists past 32 slots, weights
   0-9 with an empty later read, E = A = 100 and 130 with 16-bit codes,
   reads of 2000 bases whose graph's sort and consensus scores do not fit
   the shared memory, and of 2600 bases, where no score ring fits), each
   of which must reach what it names, and on the first 64 covid windows
   packed as PoaBatch packs them; its MSA and graph instantiations
   (``poa_msa_cuda``, ``poa_graph_cuda``) on every one of those sets against
   their plain versions run on the host CPU (one process per core); a window
   with an empty first read is refused before any launch. Kernel times are
   CUDA events around the launch alone, not the wrapper's input checks,
   printed beside the block-per-window kernel's on the same covid windows.
2b. the lockstep kernels (``ops/poa_lockstep_cuda.py``) vs their plain
   versions (``poa/lockstep_plain.py``) on the card, read by read: each
   phase's kernel (the NW, the single-phase traceback, add and topsort of
   ``lk_read_kernel``, the consensus) and plain version on clones of one
   graph state must leave equal outputs (codes, best_i, ag/ar/klen,
   cons/cov/length/err) and equal whole states, and the fused
   ``read_lockstep`` on a third clone of the state the NW left must leave
   the state and klen of the plain traceback, add and topsort; sets:
   random unit and weighted windows, a ring of D = 4 (status 5), 16 reads
   at high error (edge lists, 6), the node cap (1), and the first 256
   windows of the largest covid bucket in their first 4 reads; and the
   edge cases of the warp layouts (``lockstep_edge_sets``: read lengths at
   the edges of a lane's columns, the widest plan (N = 640), predecessors
   at the shared-memory ring's last distance and past it, at D and past
   it, a clique and in- and out-edge lists filled to their caps and past
   them, an empty later read, weights 0-9; walks whose speculation misses
   at once and never misses; a short K, whose walks end past K or fail
   (status 3) and whose graphs then get a cycle (100); a bucket larger
   than the windows the fused kernel holds at once; the consensus's ties on
   weight and on the sources' scores, in-lists past 32, branch completion
   over several loops and its status 3, replayed on the host by
   ``consensus_facts``), each of which must reach the statuses, distances,
   full lists and facts it names.
3. POA main paths, each with every count set to 0 just before and read just
   after: (a) the default path, all covid windows through
   ``get_multi_batch_sizes`` and ``PoaBatch(device="cuda")``, which takes
   the lockstep tier for bins of 64 windows or more and the per-window
   kernel for the rest and for the tier's re-runs: every status success,
   every consensus equal to its golden line; each of the tier's reads one
   NW and one fused ``read_lockstep`` launch (45 each), the single-phase
   traceback, add and topsort none, the per-window kernel and the
   consensus launched; no plain version called; it prints the tier counts
   (served / overflow / unserved), the wall and windows/s; (b) slice 1's path, the same windows
   through ``poa_batch_consensus(..., use_lockstep=False)`` per bin: golden,
   the per-window kernel alone, its wall and windows/s; then each path once
   under ``torch.profiler``: the device's busy share of the wall and the
   device time by kernel (a kernel's template instantiations summed).
4. aligner kernels vs plain versions on the card, bit for bit: the Myers
   and banded NW forward passes (the NW also with its distance output,
   against ``banded_nw_final_plain``) and the RLE traceback (normal and
   small rcap) on seeded pairs at bands 32 to 1024; every walk consumes its
   query and target, and every pair flagged optimal equals ``align_cpu``;
   then the edge sets of the warp layouts (``aligner_edge_sets``: NW bands
   1, 31, 33 and 100, the warp NW's widest band and the block kernel's
   past it, W = 16384 at M = 48, an identical 2-kb pair, diagonal runs
   that end at i = 0 or j = 0 inside a word, qlen at a word's edges, indel
   runs past the traceback's 32-column tile, the drifting pair, empty
   sequences, rcap 1 and 4, 64 indel-dense 10-kb pairs; and the Myers
   kernel's layouts: the bands where its words a lane change, qlen across
   the window's first moves (rows 63 and 95) and its 8-row groups, a
   window wider than the target's words, pairs that do not fit the band,
   W = 32768 at M = 48; and the block NW's, ``block_edge_set``, at bands
   640, 1024, 2048, 4096, 8192 and 16384, each with one that is not a
   multiple of a warp's columns: walks along the band's edge, across warp
   boundaries and in the last warp, pairs that do not fit, qlen 0, M not a
   multiple of 16), each of which must reach what it names (``walk_words``,
   ``myers_facts`` and ``block_walk_facts`` facts from the plain outputs,
   the block kernel's columns a lane from the library; the plain versions
   run on the host CPU, one process per core, from phase 3 on).
5. aligner main path: 1024 pairs of 2 kb and 32 pairs of 10 kb (4 %
   substitutions, 1 % insertions, 1 % deletions) through
   ``create_aligner(max_bandwidth=1024, device="cuda")``, then 128 of the
   2-kb pairs under the engines nw, ukkonen and myers_full. Every path
   consumes its query and target; 8 optimal 2-kb paths equal ``align_cpu``;
   every 10-kb path flagged optimal has the exact edit distance; an
   alignment optimal under two engines has one path; the default-engine
   run alone launched Myers 2, NW 1 and the traceback 3 times, the engine
   runs launch kernels too, and neither called a plain version.
6. each aligner kernel alone at the main path's first-pass shapes (the
   rows and columns the aligner packs a chunk at), against its plain
   version (bit for bit) and its bound (the NW also timed and checked with
   its distance output, the sharded aligner step's launch); and at the power-of-two shapes it
   packed at before (M = N = 2048 and 16384), whose outputs must equal
   those at the new shapes; the Myers kernel also at the ``myers_full``
   shape (phase 5's 128 engine pairs at the band that run gave them, W =
   4096) against its plain version and its bound, with the inputs of its
   cycles a row (ms, the longest query's rows).
6c. the block NW (slice 15) on 32 pairs of 10 kb whose targets lack one
   600-900-base stretch of their query (``sv_pairs``: a deletion
   structural variant, band 1024): ``create_aligner(max_bandwidth=1024,
   device="cuda")`` with the counts set to 0 just before runs every pair at
   band 1024 in one NW launch and no plain version, and every optimal path
   equals ``align_cpu``'s (``align_rows`` on the host, one process per
   core; ``align_cpu`` itself on the first pair); the kernel alone against
   ``banded_nw_final_plain`` at W = 1024, timed with its bound and cycles a
   step; at W = 2048, 4096 and 16384 timed, its distances equal to the
   exact edit distance where the pair is optimal at 1024.
6b. each lockstep kernel at the largest covid bucket's shapes: CUDA events
   around every launch of the bucket's chain, once with the fused
   ``read_lockstep`` (the main path's) and once with the single-phase
   traceback, add and topsort, and device time by kernel under
   ``torch.profiler`` for both, with the work the run's data needs for the
   bound; the windows the fused kernel and the consensus (a warp per
   window) hold on the card at once and the waves each covid bucket takes;
   the plain versions against the kernels
   on the bucket's first 256 windows at read 1 (consensus after the whole
   build).
9. the banded and MSA modes of the per-window kernel (slice 4: the static-
   and adaptive-band instantiations with consensus and MSA output, full-band
   MSA and the full-band graph export):
   (a) each instantiation (on the card) against its plain version (on the
   host CPU, same inputs), bit for bit: seeded random windows (weights unit, non-unit and negative, an
   empty later read, a read that leaves the band, adaptive rules 1-2, a
   deep racon DFS, per-window node caps, E = A = 4), statuses 0-3; the
   edge sets of the banded warp layout (``band_edge_sets``, at their own
   band widths: a lane's last chunk alone, partial and whole tiles, guards
   failing on a predecessor with another band start, rules 7 and 8 and
   the re-run, adaptive bands up to 1536, caps too small, an empty later
   read), each of which must reach what it names (``band_facts``, from the
   plain chain's counts); and covid windows 0-31 (0-7 for the banded MSA and graph modes), which time
   each instantiation (alone on the card) and its plain version (the plain
   versions run first, on the host CPU in one worker process per core, on
   the same inputs);
   (c) the main paths, counts set to 0 just before each: all covid windows
   through ``PoaBatch(device="cuda")`` with consensus and MSA output in
   static and adaptive band 256 (every status success, every MSA row its
   read without gaps, no plain version and no host chain called; how many
   consensuses equal the full-band golden is printed, not gated), then
   under ``torch.profiler``: each banded instantiation's device ms over the
   whole file, its launches and a lower bound of its work, the device's
   busy share of the wall, and per covid bin the windows a launch and in
   flight and the shared-memory paths; in full
   band (every consensus equal to the golden, every MSA row its read); and
   ``get_graphs`` on 256 covid windows;
   (e) 256 windows of 2000 bp x 8 reads (3 % substitutions, 3 % indels)
   through both banded modes: windows/s and statuses;
   (b) the port's host oracle (``cpu_reference`` with ``band_mode``, one
   process per core) against the main paths' results: 16 covid windows per
   banded mode (8 of them for the MSA), 2 windows of 2000 bp x 6 reads per
   mode, and 256 covid windows' full-band MSA.
10. the mapper (slice 11; no kernel of its own): a 2 Mbp random genome and
   2,500 reads of 8-12 kb (about 12.5x; half reverse complemented; 1.5 %
   substitutions, 1 % insertions, 1 % deletions), made with NumPy from a
   seed, written to a FASTA in a temporary directory and run through
   ``gw_mapper`` in this process with its defaults (k = 15, w = 10, one
   30 MB index, automatic filtering): the device pipeline's PAF must equal
   the host pipeline's byte for byte, also at ``-i 8`` (several index
   pairs), and its SAM the host pipeline's (``map_reads`` and ``write_sam``,
   as the tool writes it); two device runs must give the same bytes; every PAF
   field must lie within its reads; ``--align`` over the overlaps among
   the first 300 reads must give CIGARs that consume their spans, with the
   aligner's Myers and traceback kernels launched and no plain version
   called. Printed, not gated: recall against the simulated truth (pairs
   whose genome intervals share 250 bases), the sketch, anchor and overlap
   counts, the warm walls of ``map_reads`` on both pipelines,
   ``phase_times()``, the peak device memory and the device's busy share.
11. the extender and the batched Myers distance (slices 12 and 14): (a) the
   extender's two kernels (``xdrop_extend_cuda``, a warp per seed, both
   directions in one launch, K positions a lane a tile, as the library and
   the wrapper must agree;
   ``xdrop_count_cuda``, the entropy's match counts) against their plain
   versions (``extender/xdrop_plain.py``, on the card), bit for bit, on
   seeded random seeds of a simulated 20 kb pair and on edge sets
   (``xdrop_edge_sets``: seeds at 0, at L-1 and out of range; extensions
   that end at a sequence end mid-tile and on a tile edge; a drop of exactly
   xdrop that goes on and one of xdrop + 1 that stops; the maximum tied in a
   tile and across tiles; every code 0-7; xdrop 0; a 1 Mbp genome against
   itself from a seed on the main diagonal; and the kernel's lanes and tiles,
   ``xdrop_lane_sets``: drops at a lane's first and last positions and at
   the first position of tiles 1 and 2, ties across lanes and tiles, walks
   that end inside a lane and on a lane's edge in the first and a later
   tile, homologous runs over 4 tiles, a score that wraps int32), each of
   which must reach what it names (``xdrop_facts``: a NumPy replay of every
   seed, which must also equal the plain version); the count kernel's own
   sets with crafted extents (``xdrop_count_sets``: segment ends at every
   byte of a word with query and target misaligned, sequences as odd-offset
   views of lengths not multiples of 4, codes 4-7, segments across position
   0 and the ends, spans 0, -1 and over 1,000, more seeds than the card
   runs at once; ``count_facts``); a 10 Mbp genome against
   itself from a main-diagonal seed through the kernel alone, against its
   closed form (the maxima at the sequence ends, the scores the diagonal's
   sums); (b) the main path: a 10 Mbp random genome (the port's
   genomesim) against a copy with 8 % substitutions and 0.5 % indels,
   4,194,304 + 65,536 seeds (three quarters at true homologous positions
   from the edit map, a quarter random pairs), so two batches, through
   ``create_extender(device="cuda")``, ``extend_async`` at threshold 3000,
   ``sync`` and ``get_scored_segment_pairs`` with the entropy on, counts set
   to 0 just before: two device runs give the same list, every SSP lies
   within both sequences and scores at least 3000, the extension kernel
   launched once a batch and the count kernel ran, no plain version was
   called, and a device run of the first 65,536 seeds equals
   ``create_extender(device="cpu")`` on them; printed: the SSP count, the
   seeds the entropy rescored, the warm wall and seeds/s, each kernel's
   device ms, the busy share (``profiled``), the peak memory; (c) the port's
   ``samples/sample_extender.py`` on the card, on that genome written to a
   FASTA and a CSV of the first 65,536 seeds: its lines equal those of the
   CPU path on the genome against itself with those seeds; (d)
   ``myers_score_cuda`` (a warp per alignment) against its plain version
   on the card and ``myers_edit_distance_batched(device="cuda")`` against
   ``myers_edit_distance_cpu``, on empty queries, queries at a word's edges
   and phase 5's 1,024 pairs of 2 kb (the oracle on the first 32, on the
   host, one process per core); the kernel against its plain version (on
   the host, one process per core) on its edge sets
   (``myers_score_edge_sets``: one launch at each words-a-lane step 1-16
   and one past 32 x 16 words, which runs in chunks; queries 0, 1 and 32 j
   +- 1 bases long, short targets, an empty one in each); the 1,024 pairs
   through ``myers_edit_distance_batched`` are its main path (one launch,
   no plain call). The extender's warm wall and busy share and the batched
   distance's wall are printed beside slice 12's.
12. the multi-device layer (slice 13, ``genomeworks_tpu_torch.parallel``;
   no new kernel): (a) a one-rank NCCL group on this card (loopback
   rendezvous), the collectives on the card: all covid windows through
   ``poa_batch_consensus_sharded`` (golden, every status 0, equal to
   ``poa_batch_consensus(use_lockstep=False)`` at the same caps), phase 5's
   1024 pairs of 2 kb through ``aligner_step_sharded`` (codes and fits equal
   to ``banded_nw_cuda``'s, the first 32 distances to the plain version's
   and to ``align_cpu``'s wherever the pair fits and its path stays off
   the band edge), the match counts and the all-reduce against NumPy,
   ``map_reads_sharded`` on phase 10's 2,500 reads against
   ``get_overlaps_device_pipeline`` and ``map_reads_multihost`` against
   ``map_reads``; (b) two gloo ranks in two processes of this script
   (``--multi-device-rank``), both on this card, gathering through host
   tensors: the first 1024 covid windows, the aligner step and both
   mappers on the first 500 reads (1 MB index ranges, so the index pairs
   split over the ranks), each rank's results equal to run (a)'s on the
   same inputs. Both runs launch the per-window POA kernel and the NW, call
   no plain version, and print their walls beside the card's name and power
   limit.
7. a ``kernels`` JSON line with each kernel's launches, error against its
   plain version, times and bound (the mapper adds no entry; phase 11 adds
   ``xdrop_extend_cuda`` and ``myers_score_cuda``, redesigned in slice 14,
   and ``xdrop_count_cuda``, redesigned in slice 15; phase 6c adds the
   NW's ``block_kernel``: its launches, times and bound on the SV pairs;
   phase 12 adds ``launches_multi_device`` to the per-window POA kernel's
   and the NW's, and the NW's ``dist_ms``).
8. the last line: ``{"ok": true, "device": {...}}``.

It imports nothing of genomeworks_tpu or JAX.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import re
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


def nvidia_smi(field):
    """One field of the first card, as ``nvidia-smi --query-gpu`` prints it
    without units."""
    return subprocess.run(["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader,nounits"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]


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
    event name) of the events that ran on the card (kernels and copies).
    The self device time of ``key_averages()`` also counts the aten ops and
    the ``cudaLaunchKernel`` calls that launched a kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return sum(by_name.values()), wall, by_name


def by_kernel(by_name):
    """Device ms by kernel, each kernel's template instantiations summed."""
    out: dict = {}
    for key, ms in by_name.items():
        name = key.replace("(anonymous namespace)::", "").split("(")[0]
        name = re.sub(r"<.*>$", "", name.removeprefix("void ").strip())
        out[name] = out.get(name, 0.0) + ms
    return out


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


# -- the full band's warp layout (csrc/poa_consensus.cu poa_window_kernel) -------

#: the full-band kernel's earlier version (a block of 128 threads per window),
#: on the same sets: median ms of experiments/torch_poa_window_check.py on an
#: H100 80GB HBM3 at 700 W, and its time on the whole covid workload
EARLIER_FULL_MS = {"covid 0-63 bin 256": 18.9885, "covid 0-63 bin 512": 17.7690}
EARLIER_COVID_MS = 141.367


def window_cols(L):
    """(columns a lane, columns a tile) of the full-band kernel for reads up
    to L bases (launch_full in the source)."""
    cpl = 9 if L + 1 <= 32 * 9 else 11
    return cpl, 32 * cpl


def graph_prefix_facts(job):
    """Over the graphs a set's later reads align to (every window's read
    prefixes, built by the plain chain on the CPU, in a worker process):
    (key, the topological distances of predecessor rows, the longest
    in-list, out-list and aligned list, the most nodes a graph that was
    sorted after an add holds)."""
    from genomeworks_tpu_torch.poa.torch_poa import build_windows_graphs

    key, windows, N, E, A = job
    prefixes = [w[:k] for w in windows for k in range(1, len(w))]
    st, _ = build_windows_graphs(prefixes, max_nodes=N, max_edges=E, max_alignments=A,
                                 device="cpu")
    ok = st["error"] == 0
    added = torch.tensor([len(p) > 1 for p in prefixes])  # a read was added and sorted
    n = torch.arange(N)[None, :] < st["node_count"][:, None]
    live = ok[:, None] & n
    ic = torch.where(live, st["in_count"], 0)
    e = torch.arange(E)[None, None, :] < ic[:, :, None]
    pos = st["pos_of"]
    src = st["in_edges"].clamp(0, N - 1).long()
    d = pos[:, :, None] - pos.gather(1, src.flatten(1)).view(src.shape)
    return (key, set(d[e].unique().tolist()), int(ic.max()),
            int(torch.where(live, st["out_count"], 0).max()),
            int(torch.where(live, st["al_count"], 0).max()),
            int(torch.where(ok & added, st["node_count"], 0).max()))


def consensus_plain_job(job):
    """The full-band consensus's plain version on the host CPU, one thread,
    in a worker process: (key, its outputs)."""
    from genomeworks_tpu_torch.poa.torch_poa import pack_windows, poa_consensus_plain

    key, ws, wt, max_nodes, E, A = job
    seqs, wts, lens, nseqs, N = pack_windows(ws, wt, max_nodes)
    args = [torch.from_numpy(a) for a in (seqs, wts, lens, nseqs)]
    return key, list(poa_consensus_plain(*args, N, E, A, -8, -6, 8))


#: the kernel's shared-memory paths a window takes (poa_window_paths bits)
WINDOW_PATHS = {1: "no ring", 2: "an unstaged add", 4: "topsort on one lane",
                8: "consensus scores in device memory"}


def window_facts(ws, N, E, lib, prefix):
    """What a set drives the full-band kernel through (its graph_prefix_facts
    in ``prefix``; the ring rows and shared-memory paths the library gives
    its L, N and graphs): lane and tile edges of the read lengths, tiles a
    row, ring distances, lists past 32 slots, the code width, and the paths
    taken where a window's ring or working set does not fit the shared
    memory (WINDOW_PATHS)."""
    from genomeworks_tpu_torch.ops import poa_cuda

    L = max(len(r) for w in ws for r in w)
    cpl, tw = window_cols(L)
    R = lib.poa_window_ring_rows(L)
    dist, ins, outs, als, nodes = prefix
    paths = lib.poa_window_paths(L, N, nodes) if nodes else 0
    facts = {f"{poa_cuda.code_bytes(E)}-byte codes"}
    facts |= {name for bit, name in WINDOW_PATHS.items() if paths & bit}
    for w in ws:
        for r in w[1:]:
            rl = len(r)
            if rl % tw % cpl == cpl - 1:
                facts.add("a lane's last column")
            if rl % tw % cpl == 0 and rl:
                facts.add("a lane's first column")
            if rl + 1 == tw:
                facts.add("a tile's last column")
            if rl + 1 > tw:
                facts.add("two tiles")
            if rl >= 512:
                facts.add("past 512 columns")
    if R and R in dist:
        facts.add("d = R")
    if R + 1 in dist:
        facts.add("d = R + 1")
    for name, n in (("an in-list", ins), ("an out-list", outs), ("an aligned list", als)):
        if n > 32:
            facts.add(f"{name} past 32")
    return facts


def window_edge_sets(rng):
    """The full-band kernel's edge cases for phase 2 and the card tests:
    {key: (label, windows, weights, max_nodes, E, A, the window_facts the
    set must reach)}."""
    def rand(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))

    def subst(s, rate):
        return "".join("ACGT"[rng.integers(0, 4)] if rng.random() < rate else c for c in s)

    sets = {}
    # 9 columns a lane up to L = 287, where a tile of 288 columns is full:
    # read lengths whose column rl is a lane's last or first
    t = rand(287)
    sets["lane-edges"] = (
        "read lengths at a lane's edges, L = 287 (9 columns a lane, one full tile)",
        [[t, subst(t[:k], 0.03), subst(t[:k], 0.03)] for k in (8, 9, 17, 18, 143, 144, 286, 287)],
        None, None, 50, 50, {"a lane's last column", "a lane's first column",
                             "a tile's last column"})
    # 11 columns a lane past L = 287, tiles of 352: rows of one tile, a full
    # one, and two
    t = rand(353)
    sets["tile-edges"] = (
        "read lengths 350-353 at L = 353 (tiles of 352 columns)",
        [[t, subst(t[:k], 0.03), subst(t[:k], 0.03)] for k in (350, 351, 352, 353)],
        None, None, 50, 50, {"a tile's last column", "two tiles"})
    # an insertion of k bases that match nothing puts the backbone edge
    # around it at distance k + 1: the ring's last distance and past it
    ring = []
    for k in (1, 3, 4, 7, 8, 9):
        t = rand(200)
        ring.append([t, t[:100] + "N" * k + t[100:], t, subst(t, 0.03)])
    sets["ring"] = ("predecessors at distances 2-10 at L = 209",
                    ring, None, None, 50, 50, {"d = R", "d = R + 1"})
    # reads of 640 bases, past the earlier kernel's tile of 512 columns, in
    # two tiles, with a smaller ring and predecessors at its edge
    long = []
    for k in (1, 2, 3, 4, 5):
        t = rand(640 - k)
        long.append([t, t[:300] + "N" * k + t[300:], subst(t, 0.04), subst(t, 0.04)])
    sets["long"] = ("reads of 635-640 bases: two tiles, past 512 columns",
                    long, None, None, 50, 50, {"two tiles", "past 512 columns", "d = R",
                                               "d = R + 1"})
    # lists past 32 slots: 40 one-base insertions before one base (an
    # in-list of 41 and an out-list of 41), a column of 41 bases (a clique
    # past 32) at E = A = 48
    t = rand(60)
    wide = [t[:30] + chr(100 + i) + t[30:] for i in range(40)]
    col = [t[:29] + "x" + chr(100 + i) + "y" + t[32:] for i in range(41)]
    sets["wide-lists"] = ("lists past 32 slots at E = A = 48",
                          [[t] + wide + wide[3:4], [t] + col + [t]], None, None, 48, 48,
                          {"an in-list past 32", "an out-list past 32",
                           "an aligned list past 32"})
    # weights from 0 to 9, and an empty later read
    ws = random_windows(rng, 8, (60, 160), 0.05, 0.05, reads=(4, 8))
    ws = [w[:2] + [""] + w[2:] for w in ws]
    wts = [[rng.integers(0, 10, size=len(x)).astype(np.int32) for x in w] for w in ws]
    sets["empty-weighted"] = ("an empty later read, weights 0-9", ws, wts, None, 50, 50,
                              {"1-byte codes"})
    # 16-bit codes: every code from E = 85, a horizontal move's 2E from 128
    sets["E100"] = ("random, E = A = 100", random_windows(rng, 8, (60, 200), 0.1, 0.1), None,
                    None, 100, 100, {"2-byte codes"})
    sets["E130"] = ("random, E = A = 130", random_windows(rng, 8, (60, 200), 0.1, 0.1), None,
                    None, 130, 130, {"2-byte codes"})
    # reads of 2000-2003 bases (N = 6009): a ring of 2 rows, too small for
    # the graph's sort (more than 1206 nodes) and for N consensus scores;
    # insertions of 1 and 2 bases put predecessors at distances R and R + 1
    t = [rand(2000) for _ in range(2)]
    sets["2kb"] = ("reads of 2000-2003 bases: topsort and consensus scores past the ring",
                   [[x, x[:700] + "N" + x[700:1400] + "NN" + x[1400:], subst(x, 0.04)]
                    for x in t], None, None, 50, 50,
                   {"topsort on one lane", "consensus scores in device memory", "d = R",
                    "d = R + 1"})
    # reads of 2600 bases, past the 2463 that a ring of 2 rows takes: no
    # ring, every row to the slab, and every phase without shared memory
    t = [rand(2600) for _ in range(2)]
    sets["no-ring"] = ("reads of 2594-2600 bases: no ring",
                       [[x, subst(x[:k], 0.04), x[:1300] + "N" * 3 + x[1300:k]]
                        for x, k in zip(t, (2594, 2597))], None, None, 50, 50,
                       {"no ring", "an unstaged add", "topsort on one lane",
                        "consensus scores in device memory"})
    return sets


# -- the aligner ----------------------------------------------------------------

ALIGNER_REPLACES = {
    "myers_banded_cuda": "genomeworks_tpu/ops/myers_banded_pallas.py:264",
    "banded_nw_cuda": "genomeworks_tpu/ops/banded_nw_pallas.py:170",
    "rle_traceback_cuda": "genomeworks_tpu/ops/rle_traceback_pallas.py:376, "
                          "genomeworks_tpu/ops/rle_traceback_pallas.py:462",
}
ALIGNER_STATE = {"myers_banded_cuda": "redesigned in slice 10",
                 "banded_nw_cuda": "redesigned in slice 9 (the warp kernel) and slice 15 (the "
                                   "block kernel)",
                 "rle_traceback_cuda": "redesigned in slice 9"}
#: the kernels before their redesign, ms (PERF.md's table, an H100 80GB HBM3
#: at 700 W): the NW a block per alignment and the traceback a thread per
#: alignment at the power-of-two shapes the aligner packed at then; the
#: Myers kernel with its state in shared memory at the packed shape; printed
#: beside this run's times, never in the kernels line (not measured here)
EARLIER_ALIGNER_MS = {"myers_banded_cuda": 0.8144, "banded_nw_cuda": 7.327,
                      "rle_traceback_cuda": 4.439}
#: the default-engine run's launches: Myers for the two chunks of 2-kb pairs,
#: the NW for the 10-kb bucket, a traceback for each of the three
MAIN_LAUNCHES = {"myers_banded_cuda": 2, "banded_nw_cuda": 1, "rle_traceback_cuda": 3}
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


def sv_pairs(rng, n=32, length=10000):
    """``n`` pairs of ``length``-base queries against targets that lack one
    stretch of 600-900 bases of the query (a deletion structural variant,
    at a random place in its middle 80 %), then take phase 5's noise: 4 %
    substitutions, 1 % insertions, 1 % deletions. Their length difference
    (600-900 bases) starts them at band 1024, the block NW's."""
    pairs = []
    for q in rng.integers(0, 4, (n, length)).astype(np.uint8):
        cut = int(rng.integers(600, 901))
        at = int(rng.integers(length // 10, length * 9 // 10 - cut))
        t = mutated(rng, np.concatenate([q[:at], q[at + cut:]]), 0.04, 0.01, 0.01)
        pairs.append((BASES[q].tobytes().decode(), BASES[t].tobytes().decode()))
    return pairs


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


def align_rows(q: str, t: str) -> np.ndarray:
    """``align_cpu``'s path: its backtrace (``nw_backtrace``) of the full
    score matrix, whose rows are computed as ``edit_distance`` computes them
    (the insertion closure a running minimum) in place of
    ``nw_score_matrix``'s loop over cells: the same matrix, for 10-kb pairs
    in about a second (``align_cpu`` takes a minute)."""
    from genomeworks_tpu_torch.aligner.cpu_reference import nw_backtrace

    a, b = (np.frombuffer(s.encode(), np.uint8) for s in (q, t))
    k = np.arange(len(b) + 1)
    scores = np.empty((len(a) + 1, len(b) + 1), np.int32)
    scores[0] = k
    base = np.empty(len(b) + 1, np.int64)
    for i, c in enumerate(a, 1):
        base[0] = i
        base[1:] = np.minimum(scores[i - 1, 1:] + 1, scores[i - 1, :-1] + (b != c))
        scores[i] = k + np.minimum.accumulate(base - k)
    return nw_backtrace(scores)


def consumed(path, q, t):
    return (path != 2).sum() == len(q) and (path != 3).sum() == len(t)


def walk_words(paths, qlen, tlen, dlo, W, codes=None, facts=None):
    """Distinct code-plane words the walks of ``paths`` read. With a set
    ``facts`` (and the walks' planes ``codes``, (B, M16, W) on the host),
    adds what the walks reach that the traceback kernel's layout must get
    right: where a diagonal run (the kernel's skip) ends, indel runs that
    leave its 32-column tile, a clamped band column, and the lengths at a
    word's edges."""
    total = 0
    for b, (path, ql, tl, d) in enumerate(zip(paths, qlen, tlen, dlo)):
        rev = np.asarray(path[::-1], np.int64)
        i = ql - np.concatenate(([0], np.cumsum(rev != 2)[:-1]))
        j = tl - np.concatenate(([0], np.cumsum(rev != 3)[:-1]))
        main = (i > 0) & (j > 0)
        k = np.clip(j - i - d, 0, W - 1)
        total += len(np.unique(((i - 1) // 16 * W + k)[main]))
        if facts is None:
            continue
        if ql == 0 or tl == 0:
            facts.add({(0, 0): "both empty", (0, 1): "an empty query",
                       (1, 0): "an empty target"}[(int(ql > 0), int(tl > 0))])
            continue
        if codes is not None and ql == 16 * codes.shape[1]:
            facts.add("a walk from the plane's last row")
        if ql % 16 in (1, 15):
            facts.add("qlen one off a multiple of 16")
        if ql >= 10000:
            facts.add("a 10-kb walk")
        raw = (j - i - d)[main]
        if ((raw < 0) | (raw >= W)).any():
            facts.add("k clamped outside the band")
        starts = np.concatenate(([0], np.flatnonzero(np.diff(rev)) + 1))
        for s, e in zip(starts, np.concatenate((starts[1:], [len(rev)]))):
            c, inside = int(rev[s]), int(main[s:e].sum())
            if c == 0 and inside >= 125 * 16:
                facts.add("a match run across 125 word rows")
            if c >= 2 and inside > 32:
                facts.add(f"{'an insertion' if c == 2 else 'a deletion'} run past the tile")
            if c < 2:
                ie, je = int(i[e - 1]) - 1, int(j[e - 1]) - 1  # after the run
                if ie == 0 and je > 0:
                    facts.add("a diagonal run ending at i = 0")
                if je == 0 and ie % 16 and codes is not None and \
                        (int(codes[b, (ie - 1) // 16, k[e - 1]]) >> 2 * ((ie - 1) % 16)) & 3 == c:
                    # the word's next row has the run's code: only the clip stops it
                    facts.add("a diagonal run clipped at j = 0 mid-word")
    return total


def aligner_edge_sets(rng, warp_max_band):
    """The edge cases of the aligner kernels' warp layouts, for phase 4 and
    the card tests: key -> dict(label, pairs, bands, forwards, rcaps,
    planes, want). ``pairs`` are packed as the aligner packs a chunk
    (``pack_shape``); ``planes`` are code planes (codes, qlen, tlen, W) for
    the traceback alone; each set must reach the facts ``want`` names
    (``aligner_edge_compare``: from the bands and the plain outputs)."""
    def rnd(n):
        return BASES[rng.integers(0, 4, n)].tobytes().decode()

    def noisy(n, length, rate):
        return random_pairs(rng, n, length, rate, rate, rate)

    def mutated_str(s):
        q = np.frombuffer(s.encode(), np.uint8)
        codes = np.searchsorted(BASES, q).astype(np.uint8)
        return BASES[mutated(rng, codes, 0.08, 0.02, 0.02)].tobytes().decode()

    both, nw = ("myers_banded_cuda", "banded_nw_cuda"), ("banded_nw_cuda",)
    myers = ("myers_banded_cuda",)
    a, b, x, y = (rnd(n) for n in (60, 60, 20, 20))
    drift = (a + x + b, a + b + y)
    c1, c2 = rnd(100), rnd(100)
    # an indel of G and T between A and C: it matches nothing, so it is one run
    ac, ac2, gt = (BASES[[0, 1]][rng.integers(0, 2, 100)].tobytes().decode() for _ in range(3))
    gt = gt.replace("A", "G").replace("C", "T")
    ident = rnd(2000)
    # planes the forwards do not make: all matches, so that a diagonal run
    # reaches i = 0 or j = 0 inside a word whose next row is a match too,
    # and random codes
    ql = np.array([37, 20, 53, 90, 0, 31], np.int32)
    tl = np.array([20, 37, 90, 53, 9, 0], np.int32)
    zeros = np.zeros((len(ql), 6, 64), np.int32)
    noise = rng.integers(-2 ** 31, 2 ** 31, (len(ql), 6, 64), dtype=np.int64).astype(np.int32)

    def spec(label, pairs, bands, forwards=both, rcaps=(), planes=(), want=()):
        return dict(label=label, pairs=pairs, bands=bands, forwards=forwards, rcaps=rcaps,
                    planes=list(planes), want=set(want))

    def block_set(W, Wp):
        return block_edge_set(rng, W, Wp)

    return {
        "bands": spec("NW bands 1, 31, 33 and 100", [drift] + noisy(12, 120, 0.12),
                      (1, 31, 33, 100), nw, want={"a band not a multiple of 32",
                                                  "k clamped outside the band"}),
        "widest": spec(f"the warp kernel's widest band ({warp_max_band}) and the block "
                       f"kernel's ({2 * warp_max_band})", noisy(6, 300, 0.15),
                       (warp_max_band, 2 * warp_max_band),
                       want={"the warp kernel's widest band", "the block kernel"}),
        "w16384": spec("W = 16384 at M = 48", [(drift[0][:40], drift[1][:45])]
                       + noisy(3, 40, 0.1), (16384,), want={"W = 16384"}),
        "identical": spec("an identical 2-kb pair", [(ident, ident)] + noisy(3, 2000, 0.04),
                          (64,), want={"a match run across 125 word rows"}),
        "diagonal-ends": spec(
            "diagonal runs that end at i = 0 or j = 0 inside a word",
            [(rnd(int(n)) + c1, c1) for n in rng.integers(1, 40, 4)]
            + [(c1, rnd(int(n)) + c1) for n in rng.integers(1, 40, 4)], (64,),
            planes=[(zeros, ql, tl, 64), (noise, ql, tl, 64), (noise[:, :, :33], ql, tl, 33)],
            want={"a diagonal run ending at i = 0", "a diagonal run clipped at j = 0 mid-word"}),
        "qlen16": spec("qlen a multiple of 16, and one off",
                       [(rnd(n), rnd(n - 3)) for n in (160, 159, 145, 144)], (32, 64),
                       want={"a walk from the plane's last row",
                             "qlen one off a multiple of 16"}),
        "long-indels": spec("indel runs longer than 32 at W 128 and 256",
                            [(ac + ac2, ac + gt[:40] + ac2), (ac + gt[:40] + ac2, ac + ac2),
                             (ac + ac2, ac + gt[:70] + ac2), (ac + gt[:70] + ac2, ac + ac2)],
                            (128, 256), want={"an insertion run past the tile",
                                              "a deletion run past the tile"}),
        "drift": spec("the drifting pair at W 32", [drift] * 2, (32,),
                      want={"k clamped outside the band"}),
        "empty": spec("an empty query, an empty target, both empty",
                      [("", c1), (c2, ""), ("", ""), (c1, c2)], (32, 64),
                      want={"an empty query", "an empty target", "both empty"}),
        "rcap": spec("rcap 1 and 4", noisy(8, 200, 0.12), (64,), rcaps=(1, 4),
                     want={"overflow at rcap 1", "overflow at rcap 4", "more than 32 runs"}),
        "dense-10kb": spec("64 indel-dense 10-kb pairs (12 % each)", noisy(64, 10000, 0.12),
                           (256,), nw, want={"a 10-kb walk", "more than 4096 runs"}),
        # the Myers kernel's layouts (myers_facts); new sets go last, so the
        # sets above keep their random draws
        "myers-layouts": spec("the bands where the Myers layouts meet (1 | 2 | 3 | 5 | 9 | 17 | "
                              "33 window words a lane)", noisy(4, 60, 0.1),
                              MYERS_LAYOUT_BANDS, myers,
                              want={f"Myers, {n} words a lane" for n in (1, 2, 3, 5, 9, 17, 33)}),
        "myers-rows": spec("qlen across the Myers window's first moves and its row groups",
                           [(x, mutated_str(x)) for x in
                            (rnd(n) for n in (20, 31, 63, 64, 95, 96, 97, 104, 113))],
                           (32, 64, 128), want={
                               "a query under 32 rows: the window never moves",
                               "qlen 63: the window moves after the last row",
                               "rows past the window's first move (row 63)",
                               "rows past its second move (row 95)",
                               "a last 8-row group cut short",
                               "a last plane word of 1-8 rows", "a last plane word of 9-15 rows"}),
        "myers-narrow": spec("a Myers window wider than the target's words (M <= 32)",
                             [(rnd(28), rnd(25)), (c1[:16], c1[:16]), (rnd(30), rnd(12)),
                              (rnd(9), c2[:30])], (64, 128),
                             want={"a Myers window wider than the target's words"}),
        "myers-unfit": spec("|qlen - tlen| >= W: fits is false",
                            [(rnd(100), rnd(20)), (rnd(20), rnd(100)), (c1, c1[:70])], (32, 64),
                            want={"a pair that does not fit the band"}),
        "myers-w32768": spec("W = 32768 at M = 48", [(drift[0][:40], drift[1][:45])]
                             + noisy(3, 40, 0.1), (32768,), myers,
                             want={"W = 32768", "Myers, 33 words a lane"}),
        **{f"block-{W}": block_set(W, Wp) for W, Wp in BLOCK_SET_BANDS},
    }


#: the block NW's edge sets: each band with one near it that is neither a
#: multiple of the columns a warp holds nor of a lane's (one lane partial)
BLOCK_SET_BANDS = ((640, 702), (1024, 1004), (2048, 2004), (4096, 4004), (8192, 8004),
                   (16384, 16004))


def block_cols(W):
    """The block NW's band columns a lane at band W (csrc/banded_nw.cu
    block_cols; the edge sets check that the library agrees)."""
    return 4 if W <= 768 else 8 if W <= 2048 else 16 if W <= 4096 else 32


def block_edge_set(rng, W, Wp):
    """The block NW's edge set at band W and at Wp near it, which is a
    multiple neither of the columns a warp holds nor of a lane's: for each
    band a pair whose target is longer by the band less 3 (one column of
    slack each side: the path runs from the band's first warp to its last,
    on its edge), a pair that fits neither band, an empty query, a pair
    with an insertion of a warp's columns and 40 more (its path crosses a
    warp boundary in the band's middle), two short noisy pairs and one of
    two warps' columns and 200 more (whose warps in the band's middle run
    steps with every column inside the target, the kernel's path without
    the band's bounds); packed at M = the longest query (not a multiple of
    16: rows past most queries)."""
    def rnd(n):
        return BASES[rng.integers(0, 4, n)].tobytes().decode()

    warp_cols = 32 * block_cols(W)
    a, b = rnd(61), rnd(60)
    q1, q2 = rnd(100), rnd(90)
    pairs = [(q1, q1 + rnd(W - 3)), (q2, q2 + rnd(Wp - 3)), (rnd(10), rnd(W + 20)),
             ("", rnd(50)), (a + rnd(warp_cols + 40) + b, a + b)]
    pairs += random_pairs(rng, 2, 150, 0.1, 0.1, 0.1)
    pairs += random_pairs(rng, 1, 2 * warp_cols + 200, 0.04, 0.01, 0.01)
    want = {f"the block kernel, {block_cols(w)} columns a lane" for w in (W, Wp)}
    want |= {"a last warp with partial columns", "a lane with partial columns",
             "M not a multiple of 16", "rows past qlen",
             "qlen 0", "a pair that does not fit the band", "k clamped outside the band",
             "a walk across a warp boundary", "a walk in the last warp",
             "a warp step with a column at j <= 0 or past tlen",
             "a warp step with every column inside the target"}
    return dict(label=f"the block NW at W = {W} and {Wp}", pairs=pairs, bands=(W, Wp),
                forwards=("banded_nw_cuda",), rcaps=(), planes=[], want=want, rows="exact")


def edge_pack(spec, dev):
    """An edge set's pairs packed as the aligner packs a chunk
    (``pack_shape``), or with M = the longest query where the set says
    ``rows="exact"``."""
    from genomeworks_tpu_torch.aligner.aligner import pack_pairs, pack_shape
    from genomeworks_tpu_torch.core.bucketing import next_pow2

    s = next_pow2(max(len(x) for pair in spec["pairs"] for x in pair))
    M, N = pack_shape(spec["pairs"], s)
    if spec.get("rows") == "exact":
        M = max(1, max(len(p[0]) for p in spec["pairs"]))
    return pack_pairs(spec["pairs"], M, N, dev)


def block_step_facts(qlen, tlen, dlo, M, W, cols):
    """Which of the block NW's two step paths its warps take on these pairs
    (``banded_nw_kernel``: the general one where a lane that commits a row
    has a column at j <= 0 or past tlen, or past the band; the other where
    every such lane's columns are inside the target). Lane l of warp w
    computes row s - l at the warp's step s over band columns
    (32 w + l) cols ..."""
    facts = set()
    warps = -(-W // (32 * cols))
    s = np.arange(1, M + 32)[:, None]
    lane = np.arange(32)[None, :]
    for ql, tl, d in zip(qlen, tlen, dlo):
        for w in range(warps):
            k0 = (32 * w + lane) * cols
            i = s - lane
            active = (i >= 1) & (i <= M) & (k0 < W)
            jb = i + int(d) + k0
            gen = active & ((jb <= 0) | (jb + cols - 1 > int(tl)) | (W - k0 < cols))
            general = gen.any(axis=1)
            if general.any():
                facts.add("a warp step with a column at j <= 0 or past tlen")
            if (~general & active.any(axis=1)).any():
                facts.add("a warp step with every column inside the target")
    return facts


def block_walk_facts(paths, qlen, tlen, dlo, W, cols):
    """What the walks of a block-NW plane reach of its warps (32 lanes of
    ``cols`` band columns each): a walk whose band columns lie in two
    warps, and one in the last warp."""
    facts = set()
    per = 32 * cols
    last = (W - 1) // per
    for path, ql, tl, d in zip(paths, qlen, tlen, dlo):
        if ql == 0 or tl == 0:
            continue
        rev = np.asarray(path[::-1], np.int64)
        i = ql - np.concatenate(([0], np.cumsum(rev != 2)[:-1]))
        j = tl - np.concatenate(([0], np.cumsum(rev != 3)[:-1]))
        main = (i > 0) & (j > 0)
        warp = np.clip(j - i - d, 0, W - 1)[main] // per
        if len(np.unique(warp)) > 1:
            facts.add("a walk across a warp boundary")
        if (warp == last).any():
            facts.add("a walk in the last warp")
    return facts


#: the bands on either side of each change of the Myers kernel's words a lane
#: (csrc/myers_banded.cu myers_banded_launch: a window of W/32 + 4 words)
MYERS_LAYOUT_BANDS = (896, 928, 1920, 1952, 2944, 2976, 4992, 5024, 9088, 9120, 17280, 17312)


def myers_facts(M, W, qlen, fits, words_per_lane=None):
    """What a Myers plane at (M, W) of pairs of these query lengths and fits
    reaches of the kernel's layout (csrc/myers_banded.cu): its instantiation
    (``words_per_lane``, the library's ``myers_banded_words_per_lane(M, W)``,
    where the library is at hand), a window wider than the target's words,
    pairs that do not fit, where the window moves (after rows 63, 95, ...),
    and how the last 8-row stash group and plane word end."""
    facts = set() if words_per_lane is None else {f"Myers, {words_per_lane} words a lane"}
    if W // 32 + 4 > -(-(M + W + 64) // 32):
        facts.add("a Myers window wider than the target's words")
    if not np.asarray(fits).all():
        facts.add("a pair that does not fit the band")
    if W == 32768:
        facts.add("W = 32768")
    for ql in np.asarray(qlen).tolist():
        if ql == 0:
            continue
        if ql < 32:
            facts.add("a query under 32 rows: the window never moves")
        if ql == 63:
            facts.add("qlen 63: the window moves after the last row")
        if ql > 63:
            facts.add("rows past the window's first move (row 63)")
        if ql > 95:
            facts.add("rows past its second move (row 95)")
        if ql % 8:
            facts.add("a last 8-row group cut short")
        if 1 <= ql % 16 <= 8:
            facts.add("a last plane word of 1-8 rows")
        elif ql % 16 > 8:
            facts.add("a last plane word of 9-15 rows")
    return facts


def aligner_edge_plain(spec, dev):
    """The plain versions on one aligner edge set, on ``dev``: for each
    plane (a forward at a band, or a given plane), (its name, W, the
    forward's outputs or None, {rcap: the traceback's outputs}) at the
    set's rcaps and at one that holds every run. The NW's outputs are those
    of its launch with the distance: (dist, codes, fits)."""
    from genomeworks_tpu_torch.aligner.banded_nw import band_offset, banded_nw_final_plain
    from genomeworks_tpu_torch.aligner.myers_banded_model import myers_banded_plain
    from genomeworks_tpu_torch.aligner.rle_traceback import rle_traceback_plain

    # the NW's plain version with the distance output: (dist, codes, fits)
    plain = {"myers_banded_cuda": myers_banded_plain, "banded_nw_cuda": banded_nw_final_plain}
    planes = []
    if spec["pairs"]:
        q, t, qlen, tlen = edge_pack(spec, dev)
        for W in spec["bands"]:
            for fwd in spec["forwards"]:
                out = plain[fwd](q, t, qlen, tlen, W)
                planes.append((f"{fwd} W={W}", W, out, out[-2], qlen, tlen))
    for codes, ql, tl, W in spec["planes"]:
        planes.append((f"a given plane, W={W}", W, None,
                       *(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (codes, ql, tl))))
    result = []
    for name, W, fwd_out, codes, qlen, tlen in planes:
        dlo = band_offset(qlen, tlen, W)
        full = max(int((qlen + tlen).max()), 1)
        result.append((name, W, fwd_out, {rcap: rle_traceback_plain(codes, qlen, tlen, dlo, W, rcap)
                                          for rcap in (*spec["rcaps"], full)}))
    return result


def sv_align_cpu_job():
    """``align_cpu`` of the first of phase 6c's SV pairs (a worker's job)."""
    from genomeworks_tpu_torch.aligner.cpu_reference import align_cpu

    return align_cpu(*sv_pairs(np.random.default_rng(15))[0])


def aligner_edge_plain_job(key, warp_max_band):
    """``aligner_edge_plain`` of one edge set on the host CPU, as numpy (a
    worker's job: the sets are made again from their seed)."""
    torch.set_num_threads(1)
    spec = aligner_edge_sets(np.random.default_rng(8), warp_max_band)[key]
    as_np = lambda out: None if out is None else tuple(x.numpy() for x in out)  # noqa: E731
    return [(name, W, as_np(fwd_out), {r: as_np(o) for r, o in tb.items()})
            for name, W, fwd_out, tb in aligner_edge_plain(spec, torch.device("cpu"))]


def aligner_edge_compare(spec, dev, warp_max_band, err=None, plain=None):
    """One aligner edge set on the card: each forward kernel and the
    traceback (on every forward's plane, at the set's rcaps and at one that
    holds every run) against its plain version, bit for bit (``compare``
    fails the run). ``plain``: the plain outputs (``aligner_edge_plain_job``),
    else they are computed on ``dev``. Returns the facts the set reached;
    adds each kernel's largest error to ``err``."""
    from genomeworks_tpu_torch.aligner.banded_nw import band_offset
    from genomeworks_tpu_torch.aligner.rle_traceback import runs_to_states
    from genomeworks_tpu_torch.ops import banded_nw_cuda, myers_banded_cuda, rle_traceback_cuda

    err = {} if err is None else err
    block = {}  # plane index -> the block NW's columns a lane
    kern = {"myers_banded_cuda": myers_banded_cuda.myers_banded_cuda,
            "banded_nw_cuda": banded_nw_cuda.banded_nw_cuda}
    on_dev = lambda out: tuple(torch.as_tensor(x).to(dev) for x in out)  # noqa: E731
    plain = aligner_edge_plain(spec, dev) if plain is None else plain
    label, facts, planes = spec["label"], set(), []
    if spec["pairs"]:
        q, t, qlen, tlen = edge_pack(spec, dev)
        for W in spec["bands"]:
            for fwd in spec["forwards"]:
                out = kern[fwd](q, t, qlen, tlen, W)
                planes.append((out[0], qlen, tlen))
                name, pW, ref, _ = plain[len(planes) - 1]
                if (name, pW) != (f"{fwd} W={W}", W):
                    fail(f"{label}: the plain outputs are of {name}, not {fwd} W={W}")
                ref = on_dev(ref)
                err[fwd] = max(err.get(fwd, 0), compare(f"{fwd} on {label}, W={W}", out,
                                                        ref[-2:]))
                if fwd == "banded_nw_cuda":
                    # the launch with the distance output: the same codes and
                    # fits, and the plain version's distance
                    err[fwd] = max(err[fwd], compare(
                        f"{fwd} with dist on {label}, W={W}",
                        kern[fwd](q, t, qlen, tlen, W, with_dist=True), ref))
                    facts.add("a band not a multiple of 32" if W % 32 else "a band of 32s")
                    facts.add("the warp kernel's widest band" if W == warp_max_band else
                              "the block kernel" if W > warp_max_band else "the warp kernel")
                    if W > warp_max_band:
                        cols = banded_nw_cuda.load_library().banded_nw_block_cols(W)
                        facts.add(f"the block kernel, {cols} columns a lane")
                        block[len(planes) - 1] = cols
                        if W % (32 * cols):
                            facts.add("a last warp with partial columns")
                        if W % cols:
                            facts.add("a lane with partial columns")
                        facts |= block_step_facts(
                            qlen.cpu().numpy(), tlen.cpu().numpy(),
                            band_offset(qlen, tlen, W).cpu().numpy(), q.shape[1], W, cols)
                    if q.shape[1] % 16:
                        facts.add("M not a multiple of 16")
                    if bool((qlen < q.shape[1]).any()):
                        facts.add("rows past qlen")
                    if bool((qlen == 0).any()):
                        facts.add("qlen 0")
                    if not bool(out[1].all()):
                        facts.add("a pair that does not fit the band")
                if fwd == "myers_banded_cuda":
                    M = q.shape[1]
                    facts |= myers_facts(
                        M, W, qlen.cpu().numpy(), out[1].cpu().numpy(),
                        myers_banded_cuda.load_library().myers_banded_words_per_lane(M, W))
                if W == 16384:
                    facts.add("W = 16384")
    for codes, ql, tl, W in spec["planes"]:
        planes.append(tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                            for a in (codes, ql, tl)))
    TB = "rle_traceback_cuda"
    for p, ((codes, qlen, tlen), (name, W, _, tb_ref)) in enumerate(zip(planes, plain,
                                                                        strict=True)):
        dlo = band_offset(qlen, tlen, W)
        for rcap, ref in tb_ref.items():
            out = rle_traceback_cuda.rle_traceback_cuda(codes, qlen, tlen, dlo, W, rcap)
            err[TB] = max(err.get(TB, 0), compare(f"{TB} on {label}, {name}, rcap={rcap}",
                                                  out, on_dev(ref)))
            if bool(torch.as_tensor(ref[4]).any()):
                facts.add(f"overflow at rcap {rcap}")
        runs, nruns = (torch.as_tensor(x).cpu().numpy() for x in ref[:2])  # every run
        if (nruns > 32).any():
            facts.add("more than 32 runs")
        if (nruns > 4096).any():
            facts.add("more than 4096 runs")
        paths = [runs_to_states(r, int(n)) for r, n in zip(runs, nruns)]
        walk_words(paths, qlen.cpu().numpy(), tlen.cpu().numpy(), dlo.cpu().numpy(), W,
                   codes.cpu().numpy(), facts)
        if p in block:
            facts |= block_walk_facts(paths, qlen.cpu().numpy(), tlen.cpu().numpy(),
                                      dlo.cpu().numpy(), W, block[p])
    return facts


def aligner_phases(dev, ops, edge_plain, sv_oracle=None):
    """Phases 4-6; returns the kernels line's entries of the aligner.
    ``edge_plain``: for each aligner edge set, a future of its plain
    outputs (``aligner_edge_plain_job``); ``sv_oracle``: a future of
    ``sv_align_cpu_job``, or None."""
    from genomeworks_tpu_torch.aligner import create_aligner
    from genomeworks_tpu_torch.aligner.aligner import pack_pairs, pack_shape
    from genomeworks_tpu_torch.aligner.banded_nw import (
        band_offset, banded_nw_final_plain, banded_nw_forward_plain,
    )
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
    q, t, qlen, tlen = pack_pairs(pairs, M, M, dev)
    rcap = int((qlen + tlen).max())
    seen = {"edge": 0, "ovf": 0, "optimal": 0}
    for W in (32, 64, 256, 1024):
        dlo = band_offset(qlen, tlen, W)
        for fwd in ("myers_banded_cuda", "banded_nw_cuda"):
            codes, fits = kern[fwd](q, t, qlen, tlen, W)
            err[fwd] = max(err[fwd], compare(f"{fwd} W={W}", (codes, fits),
                                             plain[fwd](q, t, qlen, tlen, W)))
            if fwd == "banded_nw_cuda":
                err[fwd] = max(err[fwd], compare(
                    f"{fwd} with dist W={W}", kern[fwd](q, t, qlen, tlen, W, with_dist=True),
                    banded_nw_final_plain(q, t, qlen, tlen, W)))
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
    # the edge cases of the warp layouts, each of which must reach what it
    # names; their plain versions ran on the host CPU meanwhile
    warp_max = libs["banded_nw_cuda"].banded_nw_warp_max_band()
    t0 = time.perf_counter()
    for key, spec in aligner_edge_sets(np.random.default_rng(8), warp_max).items():
        facts = aligner_edge_compare(spec, dev, warp_max, err, edge_plain[key].result())
        if not spec["want"] <= facts:
            fail(f"the aligner edge set {key!r} did not reach {sorted(spec['want'] - facts)}")
        print(f"check {spec['label']}: every kernel == plain; reaches {sorted(spec['want'])}")
    print(f"aligner edge sets: {time.perf_counter() - t0:.1f} s", flush=True)

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
        for p in (*plain.values(), banded_nw_final_plain):
            p.calls = 0
        out = fn()
        return out, {n: k.launches for n, k in kern.items()}, \
            sum(p.calls for p in (*plain.values(), banded_nw_final_plain))

    (main_alns, main_wall, _), launches, plain_calls = counted(lambda: run(every))
    if launches != MAIN_LAUNCHES:
        fail(f"the aligner main path launched {launches}, not {MAIN_LAUNCHES}")
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
    # at the rows and columns the aligner packs a chunk at (pack_shape), and
    # at the power-of-two shapes it packed at before (M = N = s), whose
    # outputs must be the same: the rows both planes hold, fits and the walks
    timed = {n: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0, "old_ms": 0.0} for n in kern}
    shapes = {TB: "the planes of both buckets"}
    W = 64  # the first-pass band of the main path's pairs
    for fwd, pairs in (("myers_banded_cuda", short[:512]), ("banded_nw_cuda", long)):
        s = 2048 if fwd == "myers_banded_cuda" else 16384
        M, N = pack_shape(pairs, s)
        q, t, qlen, tlen = pack_pairs(pairs, M, N, dev)
        dlo = band_offset(qlen, tlen, W)
        ms, out = cuda_ms(lambda: ops[fwd]._launch(libs[fwd], q, t, qlen, tlen, W), reps=3)
        if fwd == "banded_nw_cuda":
            # the plain version with the distance (its codes and fits are
            # banded_nw_forward_plain's); the kernel with the distance output
            # (the sharded aligner step's launch) against it, and timed
            p_ms, p_dist = cuda_ms(lambda: banded_nw_final_plain(q, t, qlen, tlen, W))
            p_out = p_dist[1:]
            dist_ms, k_dist = cuda_ms(
                lambda: ops[fwd]._launch(libs[fwd], q, t, qlen, tlen, W, True), reps=3)
            err[fwd] = max(err[fwd], compare(f"{fwd} with dist at the main path's shape",
                                             k_dist, p_dist))
            timed_dist = {"dist_ms": dist_ms, "dist_timed_on": f"{len(pairs)} main-path pairs, "
                          f"M={M}, N={N}, W={W}, the launch with the distance output"}
            print(f"time {fwd} with dist: {dist_ms:.4f} ms (without: {ms:.4f} ms); dist == "
                  f"plain", flush=True)
        else:
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
        codes = out[0]
        cap = int((qlen + tlen).max())
        tb_ms, tb = cuda_ms(lambda: ops[TB]._launch(libs[TB], codes, qlen, tlen, dlo, cap),
                            reps=3)
        tp_ms, tp = cuda_ms(lambda: plain[TB](codes, qlen, tlen, dlo, W, cap))
        err[TB] = max(err[TB], compare(f"{TB} at the main path's shape ({fwd})", tb, tp))
        # the shape before: the same pairs at M = N = s
        q2, t2, _, _ = pack_pairs(pairs, s, s, dev)
        old_ms, old = cuda_ms(lambda: ops[fwd]._launch(libs[fwd], q2, t2, qlen, tlen, W), reps=3)
        tb_old_ms, tb_old = cuda_ms(
            lambda: ops[TB]._launch(libs[TB], old[0], qlen, tlen, dlo, cap), reps=3)
        compare(f"{fwd} at M = N = {s} against M = {M}, N = {N}",
                (old[0][:, :codes.shape[1]], old[1], *tb_old), (codes, out[1], *tb))
        words = walk_words(paths_of(tb[0], tb[1]), ql, tlen.cpu().numpy(),
                           dlo.cpu().numpy(), W)
        steps = int((tb[0].to(torch.int64) & RUN_MASK).sum())
        # the words the walks read, the lengths and offsets, the runs they
        # wrote (4 bytes each) and the four per-walk results
        tbytes = 4 * words + nbytes((qlen, tlen, dlo, *tb[1:])) + 4 * int(tb[1].sum())
        timed[fwd] = {"ms": ms, "plain_ms": p_ms, "bytes": fbytes, "ops": ops_n,
                      "old_ms": old_ms, "max_qlen": int(ql.max()), "pairs": len(pairs)}
        shapes[fwd] = f"{len(pairs)} main-path pairs, M={M}, N={N}, W={W}"
        timed[TB] = {k: timed[TB][k] + v for k, v in
                     (("ms", tb_ms), ("plain_ms", tp_ms), ("bytes", tbytes),
                      ("ops", TB_STEP_OPS * steps), ("old_ms", tb_old_ms))}
        print(f"time {fwd}: {len(pairs)} pairs, W={W}, at M={M}, N={N}: kernel {ms:.4f} ms, "
              f"plain {p_ms:.1f} ms; traceback kernel {tb_ms:.4f} ms, plain {tp_ms:.1f} ms "
              f"({steps} moves, {int(tb[1].sum())} runs, {words} distinct words read); at "
              f"M = N = {s}: kernel {old_ms:.4f} ms, traceback {tb_old_ms:.4f} ms, outputs "
              f"equal", flush=True)

    # the Myers kernel alone at the myers_full shape: phase 5's 128 engine
    # pairs, packed as that run packs them, at the band it gave them all
    MY = "myers_banded_cuda"
    bands = engines["myers_full"][2]
    if len(bands) != 1:
        fail(f"the myers_full run used several bands: {bands}")
    Wf = next(iter(bands))
    full = short[:128]
    M, N = pack_shape(full, 2048)
    q, t, qlen, tlen = pack_pairs(full, M, N, dev)
    f_ms, f_out = cuda_ms(lambda: ops[MY]._launch(libs[MY], q, t, qlen, tlen, Wf), reps=3)
    fp_ms, fp_out = cuda_ms(lambda: plain[MY](q, t, qlen, tlen, Wf))
    err[MY] = max(err[MY], compare(f"{MY} at the myers_full shape", f_out, fp_out))
    ql = qlen.cpu().numpy().astype(np.int64)
    f_bytes = int(ql.sum() + tlen.cpu().numpy().astype(np.int64).sum()) \
        + nbytes((qlen, tlen, f_out[1])) + 4 * Wf * int(((ql + 15) // 16).sum())
    f_ops = MYERS_WORD_OPS * (Wf // 32) * int(ql.sum())
    f_bound = max(f_bytes / HBM_BYTES_PER_S, f_ops / SCALAR_OPS_PER_S) * 1e3
    print(f"time {MY} at the myers_full shape: 128 pairs, W={Wf}, M={M}, N={N}: kernel "
          f"{f_ms:.4f} ms, plain {fp_ms:.1f} ms; bound {f_bytes} bytes, {f_ops} int32 ops -> "
          f"{f_bound:.6f} ms", flush=True)
    # the inputs of cycles a row (the debug build in experiments/
    # torch_aligner_check.py counts them): a row warp an alignment, so a
    # launch lasts about its longest query's rows
    print(f"{MY} cycles a row, inputs: main path {timed[MY]['ms']:.4f} ms over "
          f"{timed[MY]['max_qlen']} rows (the longest query of {timed[MY]['pairs']} alignments), "
          f"myers_full {f_ms:.4f} ms over {int(ql.max())} rows (128 alignments)")
    myers_full = {"timed_on": f"128 myers_full pairs, M={M}, N={N}, W={Wf}", "ms": f_ms,
                  "plain_ms": fp_ms, "bound_ms": f_bound,
                  "bound_by": "bytes" if f_bytes / HBM_BYTES_PER_S >= f_ops / SCALAR_OPS_PER_S
                  else "operations"}

    # -- 6c. the block NW on pairs with a deletion structural variant ----------
    # 32 pairs of 10 kb whose targets lack 600-900 bases start at band 1024:
    # create_aligner's default path for them is one block-NW launch
    NW = "banded_nw_cuda"
    sv = sv_pairs(np.random.default_rng(15))
    sv_ref = sv_oracle.result() if sv_oracle is not None else None
    sv_paths = oracle(sv, align_rows)
    if sv_ref is not None and not np.array_equal(sv_ref, sv_paths[0]):
        fail("align_rows differs from align_cpu on the first SV pair")
    (sv_alns, sv_wall, sv_bands), sv_launches, sv_plain = counted(lambda: run(sv))
    if dict(sv_bands) != {1024: len(sv)} or sv_launches[NW] != 1 or sv_plain:
        fail(f"the SV pairs ran bands {dict(sv_bands)}, launches {sv_launches}, "
             f"{sv_plain} plain-version calls")
    n_opt = 0
    for b, aln in enumerate(sv_alns):
        if aln.is_optimal:
            n_opt += 1
            if not np.array_equal(aln.states, sv_paths[b]):
                fail(f"SV pair {b}: optimal path differs from align_cpu's")
    if not n_opt:
        fail("no SV pair was flagged optimal")
    M, N = pack_shape(sv, 16384)
    q, t, qlen, tlen = pack_pairs(sv, M, N, dev)
    cols = libs[NW].banded_nw_block_cols(1024)
    sv_ms, sv_out = cuda_ms(lambda: ops[NW]._launch(libs[NW], q, t, qlen, tlen, 1024), reps=3)
    svp_ms, svp_out = cuda_ms(lambda: banded_nw_final_plain(q, t, qlen, tlen, 1024))
    err[NW] = max(err[NW], compare(f"{NW} (block) on the SV pairs, W=1024", sv_out, svp_out[1:]),
                  compare(f"{NW} (block) with dist on the SV pairs, W=1024",
                          ops[NW]._launch(libs[NW], q, t, qlen, tlen, 1024, True), svp_out))
    # wider bands on the same pairs: the launch alone; the distances of the
    # pairs optimal at 1024 are their exact edit distances at every band
    exact = torch.tensor([int((np.asarray(p) != 0).sum()) for p in sv_paths], device=dev)
    opt = torch.tensor([aln.is_optimal for aln in sv_alns], device=dev)
    sv_wide = {}
    for W in (2048, 4096, 16384):
        sv_wide[W], _ = cuda_ms(lambda: ops[NW]._launch(libs[NW], q, t, qlen, tlen, W), reps=3)
        d = ops[NW]._launch(libs[NW], q, t, qlen, tlen, W, True)[0]
        if not torch.equal(d[opt], exact[opt]):
            fail(f"{NW} (block) at W={W}: a distance differs from the exact edit distance")
    ql = qlen.cpu().numpy().astype(np.int64)
    sv_bytes = int(ql.sum() + tlen.cpu().numpy().astype(np.int64).sum()) \
        + nbytes((qlen, tlen, sv_out[1])) + 4 * 1024 * int(((ql + 15) // 16).sum())
    sv_ops = NW_CELL_OPS * 1024 * int(ql.sum())
    sv_tb, sv_to = sv_bytes / HBM_BYTES_PER_S * 1e3, sv_ops / SCALAR_OPS_PER_S * 1e3
    clock = float(nvidia_smi("clocks.max.sm").split()[0])
    sv_cycles = sv_ms * 1e-3 * clock * 1e6 / (M + 31 + 32 * (-(-1024 // (32 * cols)) - 1))
    print(f"time {NW} (block, {cols} columns a lane, {-(-1024 // (32 * cols))} warps) on 32 SV "
          f"pairs of 10 kb, M={M}, N={N}, W=1024: create_aligner {sv_wall:.4f} s wall, bands "
          f"{dict(sv_bands)}, launches {sv_launches}, {n_opt} optimal paths == align_cpu's; "
          f"kernel {sv_ms:.4f} ms (the launch alone), plain {svp_ms:.1f} ms; bound {sv_bytes} "
          f"bytes -> {sv_tb:.6f} ms, {sv_ops} int32 ops -> {sv_to:.6f} ms; "
          f"{sv_cycles:.1f} cycles a step at the card's max SM clock ({clock:.0f} MHz); at W = "
          + ", ".join(f"{W}: {v:.4f} ms" for W, v in sv_wide.items())
          + " (distances == the exact edit distance)", flush=True)
    block_kernel = {
        "timed_on": f"32 pairs of 10 kb lacking 600-900 bases, M={M}, N={N}, W=1024",
        "columns_a_lane": cols, "launches": sv_launches[NW], "ms": sv_ms, "plain_ms": svp_ms,
        "bound_ms": max(sv_tb, sv_to), "bound_by": "bytes" if sv_tb >= sv_to else "operations",
        "cycles_a_step_at_max_clock": sv_cycles,
        "ms_at_band": {str(W): v for W, v in sv_wide.items()}, "main_path_s": sv_wall,
    }

    entries = []
    for name, tm in timed.items():
        t_bytes = tm["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = tm["ops"] / SCALAR_OPS_PER_S * 1e3
        print(f"{name} bound: {tm['bytes']} bytes -> {t_bytes:.6f} ms; {tm['ops']} int32 ops "
              f"-> {t_ops:.6f} ms")
        print(f"{name} before its redesign: {EARLIER_ALIGNER_MS[name]} ms (PERF.md's table, not "
              f"measured in this run); now {tm['ms']:.4f} ms, {tm['old_ms']:.4f} ms at M = N = s")
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"genomeworks_tpu_torch/csrc/{ops[name].SOURCE}",
            "replaces": ALIGNER_REPLACES[name],
            "state": ALIGNER_STATE[name],
            "launches": launches[name],
            "max_abs_err": err[name],
            "ms": tm["ms"],
            "plain_ms": tm["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "timed_on": shapes[name],
            "ms_at_pow2_shape": tm["old_ms"],
            **({"myers_full": myers_full} if name == MY else {}),
            **(timed_dist if name == "banded_nw_cuda" else {}),
            **({"block_kernel": block_kernel} if name == "banded_nw_cuda" else {}),
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
    # the traceback, add and topsort of a read in one launch: rows 2, 3 and 4
    "read_lockstep": "genomeworks_tpu/ops/poa_lockstep_pallas.py:538",
}
LK_ALSO_REPLACES = ["genomeworks_tpu/ops/poa_lockstep_pallas.py:820",
                    "genomeworks_tpu/ops/poa_lockstep_pallas.py:960"]
LK_DEVICE_NAME = {"nw_lockstep": "lk_nw_kernel", "tb_lockstep": "lk_read_kernel<1>",
                  "add_lockstep": "lk_read_kernel<2>", "topsort_lockstep": "lk_read_kernel<4>",
                  "consensus_lockstep": "lk_consensus_kernel",
                  "read_lockstep": "lk_read_kernel<7>"}
#: the single-phase instantiations: off the main path, which runs them fused
LK_ALONE = ("tb_lockstep", "add_lockstep", "topsort_lockstep")
#: the covid default path's reads through the lockstep tier: one NW and one
#: fused launch each
LK_MAIN_READS = 45
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
# costs about 12 int32 operations; the NW counts as nw_ops. The consensus
# keeps its scores and predecessors in shared memory: of a node it reads its
# rank and in-count from device memory (8), of an in-edge the source and
# weight (8), and its emission moves EMIT_BYTES a base. The fused read
# hands the moves from its traceback to its add in shared memory, so a walk
# step of it moves the two phases' bytes less the ag/ar writes of the one
# and the ag/ar reads of the other (MOVE_BYTES each): 25 - 8 + 40 - 8 = 49.
TB_STEP_BYTES, ADD_STEP_BYTES, MOVE_BYTES = 25, 40, 8
NODE_BYTES, EDGE_BYTES, EMIT_BYTES = 16, 12, 13
CONS_NODE_BYTES, CONS_EDGE_BYTES = 8, 8
WALK_OPS = 12
#: the one-thread-per-window consensus's time a launch at the largest covid
#: bucket (profiler), ms, an H100 80GB HBM3 at 700 W, before the warp per
#: window
EARLIER_CONSENSUS_MS = 0.8646


def lockstep_modules():
    from genomeworks_tpu_torch.ops import poa_lockstep_cuda as lk
    from genomeworks_tpu_torch.poa import lockstep, lockstep_plain

    plains = {"nw_lockstep": lockstep_plain.nw_lockstep_plain,
              "tb_lockstep": lockstep_plain.tb_lockstep_plain,
              "add_lockstep": lockstep_plain.add_lockstep_plain,
              "topsort_lockstep": lockstep_plain.topsort_lockstep_plain,
              "consensus_lockstep": lockstep_plain.consensus_lockstep_plain,
              "read_lockstep": lockstep_plain.read_lockstep_plain}
    kernels = {k.__name__: k for k in lk.KERNELS}
    return lockstep, kernels, plains


def clone_state(state):
    return {k: v.clone() for k, v in state.items()}


def bucket_tensors(windows, weights, N, dev):
    from genomeworks_tpu_torch.poa.torch_poa import pack_windows

    seqs, wts, lens, nseqs, _ = pack_windows(windows, weights, N)
    return [torch.from_numpy(a).to(dev) for a in (seqs, wts, lens, nseqs)]


def pred_distances(state, act):
    """The topological distances at which the next NW reads predecessor
    rows, over the rows of the windows in ``act`` without an error."""
    N = state["nodes"].shape[1]
    E = state["in_edges"].shape[2]
    ok = act & (state["error"] == 0)
    r = torch.arange(N, device=act.device)
    rows = ok[:, None] & (r[None, :] < state["node_count"][:, None])
    nid = state["sorted"].clamp(0, N - 1).long()
    pc = state["in_count"].gather(1, nid).clamp(max=E)
    pe = state["in_edges"].gather(1, nid[:, :, None].expand(-1, N, E)).clamp(0, N - 1).long()
    d = r[None, :, None] - state["pos_of"].gather(1, pe.flatten(1)).view(pe.shape)
    use = rows[:, :, None] & (torch.arange(E, device=act.device)[None, None, :] < pc[:, :, None])
    return set(d[use].unique().tolist())


#: NW_C of csrc/poa_lockstep.cu: the NW reads predecessor rows at distances
#: 2..NW_C from shared memory and farther ones from device memory
NW_RING_ROWS = 4


def tb_spec_facts(state, codes, best_i, read_len, act):
    """What the fused traceback's speculation meets on these walks (the
    state the NW left, its codes and best_i): "tb misses at once" where a
    walk's first move is not the one guessed (the move to the row's first
    predecessor, diagonally; vertically in column 0; horizontally in row
    0), "tb never misses" where every move of a walk of 32 or more is."""
    st = {k: v.cpu().numpy() for k, v in state.items()}
    codes, best_i, read_len = codes.cpu().numpy(), best_i.cpu().numpy(), read_len.cpu().numpy()
    act = act.cpu().numpy()
    B, N = st["nodes"].shape
    E = st["in_edges"].shape[2]
    facts = set()
    for b in range(B):
        if not act[b] or st["error"][b] != 0:
            continue

        def pred(i, e):  # the row a move from graph row i through slot e reaches
            nid = min(max(st["sorted"][b, i - 1], 0), N - 1)
            if st["in_count"][b, nid] == 0:
                return 0
            return st["pos_of"][b, min(max(st["in_edges"][b, nid, e], 0), N - 1)] + 1

        i, j, k, misses = int(best_i[b]), int(read_len[b]), 0, []
        while (i or j) and k < 4 * N:
            guess = (0, j - 1) if i == 0 else (pred(i, 0), max(j - 1, 0))
            code = 2 * E if i == 0 else int(
                codes[b, min(max(i - 1, 0), N - 1), min(max(j, 0), codes.shape[2] - 1)])
            if code == 2 * E:
                i, j = i, j - 1
            else:
                i, j = pred(i, code % E), j - 1 if code < E else j
            misses.append((i, j) != guess)
            k += 1
        if misses and misses[0]:
            facts.add("tb misses at once")
        if len(misses) >= 32 and not any(misses):
            facts.add("tb never misses")
    return facts


def consensus_facts(state, act, err):
    """What the heaviest-path consensus meets on the graphs of ``state``
    for the windows in ``act`` without an error, replayed on the host
    (consensus_row's scan and the branch completion, as the plain version
    runs them) with ``err``, the consensus's codes: "a tie on weight" where
    a row's heaviest in-edge weight is on two or more counted edges, "a tie
    on weight and score" where two of those have sources of the same
    score, "an in-list past 32", "branch completion over several loops",
    "consensus status 3"."""
    st = {k: v.cpu().numpy() for k, v in state.items()}
    err = err.cpu().numpy()
    facts = set()
    for b in np.flatnonzero(act.cpu().numpy() & (st["error"] == 0)):
        if err[b] == 3:
            facts.add("consensus status 3")
        nc = int(st["node_count"][b])
        ic, ie, iw = st["in_count"][b], st["in_edges"][b], st["in_w"][b]
        srt, pos, oc, oe = st["sorted"][b], st["pos_of"][b], st["out_count"][b], st["out_edges"][b]
        if (ic[:nc] > 32).any():
            facts.add("an in-list past 32")
        cs = np.full(nc, -1, np.int64)

        def run(start, skip):
            best, at = (0, 0) if skip else (-1, 0)
            for g in range(start, nc):
                nid = srt[g]
                s, p, sp = (-1 if skip else cs[nid]), -1, 0
                edges = [(int(ie[nid, e]), int(iw[nid, e])) for e in range(ic[nid])
                         if not (skip and cs[ie[nid, e]] == -1)]
                if len(edges) > 1:
                    m = max(w for _, w in edges)
                    tied = [cs[x] for x, w in edges if w == m]
                    if len(tied) > 1:
                        facts.add("a tie on weight")
                        if tied.count(max(tied)) > 1:
                            facts.add("a tie on weight and score")
                for x, w in edges:
                    if s < w or (s == w and p != -1 and sp <= cs[x]):
                        s, p, sp = w, x, cs[x]
                cs[nid] = s + sp if p != -1 else s
                if best <= cs[nid]:
                    best, at = cs[nid], nid
            return at

        max_id, loops = run(0, False), 0
        while oc[max_id] != 0 and loops < nc:
            for o in oe[max_id, :oc[max_id]]:
                for x in ie[o, :ic[o]]:
                    if x != max_id:
                        cs[x] = -1
            max_id = run(pos[max_id] + 1, True)
            loops += 1
        if loops > 1:
            facts.add("branch completion over several loops")
    return facts


def lockstep_edge_sets(rng):
    """The lockstep kernels' edge cases, for phase 2b and the card tests:
    {key: (label, windows, weights, lockstep_compare kwargs, what the
    chain must reach: the marks lockstep_compare adds to ``seen``)}."""
    from genomeworks_tpu_torch.poa import lockstep

    def rand(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))

    def subst(s, rate):
        return "".join("ACGT"[rng.integers(0, 4)] if rng.random() < rate else c for c in s)

    def copies(lens, n=3):
        return [[t] + [subst(t, 0.04) for _ in range(n)] for t in (rand(k) for k in lens)]

    sets = {}
    # a lane holds 7 columns at Lr = 199: read lengths at the edges of a
    # lane's columns and of 32 columns, and Lp - 1 at Lp = 200
    sets["lane-edges"] = (
        "read lengths 6-8, 13-15, 31-33, 63-65 and 199 at Lp = 200",
        copies((6, 7, 8, 13, 14, 15, 31, 32, 33, 63, 64, 65, 199)), None,
        {"plan": (512, 128, 200, lockstep.walk_len(512, 199))}, {"status 0"})
    # 223 = 32 x 7 - 1: the last column of the last lane; rows of 229
    # bytes, which do not start on a word
    sets["warp-edge"] = ("read lengths 216, 222 and 223 at Lp = 229",
                         copies((216, 222, 223)), None,
                         {"plan": (640, 128, 229, lockstep.walk_len(640, 223))},
                         {"status 0"})
    # the widest plan the covid-like reads of 320 bases get: N = 640, D = 64,
    # Lp = 328, 11 columns a lane
    wide = copies((320, 300, 310, 290), n=4)
    sets["widest"] = ("reads of 290-320 bases, the plan of L = 320", wide, None,
                      {"plan": lockstep.bucket_plan(wide)}, {"status 0", "N = 640"})
    # an insertion of k bases that match nothing puts the backbone edge
    # around it at distance k + 1, a deletion of k the read's edge over it:
    # distances C, C + 1, D and D + 1 (status 5) at D = 8
    C, D = NW_RING_ROWS, 8
    dist = []
    for k in (C - 1, C, D - 1, D):
        t = rand(80)
        dist.append([t, t[:40] + "N" * k + t[40:], t, t[:30] + t[30 + k:], t])
    sets["distances"] = (f"predecessors at distances {C}, {C + 1}, {D} and {D + 1} at D = {D}",
                         dist, None, {"D": D},
                         {"status 0", "status 5", f"d = {C}", f"d = {C + 1}", f"d = {D}"})
    # a clique filled to A - 1 = 7 (eight bases in one column, its two
    # neighbour columns two bases each, so that no edge list fills), then a
    # ninth base (6); one-base insertions before one base: its in-list and
    # its predecessor's out-list filled to E = 7, then an eighth (6); the
    # last read of each reuses a clique member (the lane-parallel scan)
    t = rand(60)
    letters = [x for x in "ACGTNRYKMSWB" if x != t[30]]

    def column(i, x):  # odd reads take "x" and "y", which match nothing else
        return t[:29] + (t[29] + x + t[31] if i % 2 == 0 else "x" + x + "y") + t[32:]

    clique = [t] + [column(i, x) for i, x in enumerate(letters[:7], 1)] + [column(3, letters[2])]
    ins = [t] + [t[:30] + x + t[30:] for x in "NRYKMS"] + [t[:30] + "R" + t[30:]]
    caps = [clique, clique[:8] + [column(8, letters[7])] + clique[8:], ins,
            ins[:7] + [t[:30] + "W" + t[30:]] + ins[7:]]
    sets["caps"] = ("a clique filled to A - 1 and past it, edge lists filled to E and past it",
                    caps, None, {}, {"status 0", "status 6", "A - 1 full", "E full",
                                     "out E full"})
    # caps past the lockstep tier's: 40 one-base insertions before one base
    # (an in-list of 41 slots), then a column of 41 bases (a clique past A - 1
    # = 39, status 6) at E = 48, A = 40: in-edge slots past 8 in the NW's
    # prologue, list scans past 32 slots in the add
    wide = [t[:30] + chr(100 + i) + t[30:] for i in range(40)]
    wide_clique = [column(i, chr(100 + i)) for i in range(1, 42)]
    sets["wide-lists"] = ("lists past 32 slots at E = 48, A = 40",
                          [[t] + wide + wide[3:4], [t] + wide_clique], None,
                          {"caps": (48, 40)}, {"status 0", "status 6"})
    # an empty later read, and weights from 0 to 9
    ws = random_windows(rng, 8, (60, 120), 0.05, 0.05, reads=(4, 8))
    ws = [w[:2] + [""] + w[2:] for w in ws]
    wts = [[rng.integers(0, 10, size=len(x)).astype(np.int32) for x in w] for w in ws]
    sets["empty-weighted"] = ("an empty later read, weights 0-9", ws, wts, {}, {"status 0"})
    # the traceback's speculation: reads equal to the backbone walk along
    # first predecessors only; bases inserted at a read's end make the
    # walk's first move horizontal, where a diagonal was guessed; at its
    # start, the last moves (in row 0, where a horizontal move is guessed)
    spec = []
    for k in (40, 90, 150):
        t = rand(k)
        spec.append([t, t, t, t])
        spec.append([t, t + "GATTACA", "CAT" + t, t + "AC", t])
    sets["spec"] = ("walks whose speculation misses at once and never misses", spec, None,
                    {"spec": True}, {"status 0", "tb misses at once", "tb never misses"})
    # K = 58 against walks of 56-62 moves (reads equal to backbones of
    # 56-62 bases): walks past K (klen K + 1 and K + 2: the add reads move
    # K - 1 again, its edge to itself makes a cycle, status 100) and walks
    # that do not end within K + 2 moves (status 3)
    short = [[t, t, t] for t in (rand(k) for k in range(56, 63))]
    sets["short-walk"] = ("K = 58 against walks of 56-62 moves", short, None,
                          {"plan": (128, 128, 64, 58)},
                          {"status 0", "status 3", "status 100", "klen past K"})
    # more windows than the fused kernel holds on the card at once at the
    # widest plan (N = 640: 1584 windows at 24 N bytes each)
    many = copies([int(x) for x in rng.integers(30, 60, 2000)], n=2)
    sets["waves"] = ("2000 windows at N = 640, more than one wave", many, None,
                     {"plan": (640, 128, 64, lockstep.walk_len(640, 60))},
                     {"status 0", "more than one wave"})
    # the consensus: reads that differ in one base between equal halves
    # (ties on weight and on the sources' scores), an in-list of 41 (41
    # reads each inserting a base before one base, at E = 48), noisy reads
    # with weights 0-9, weights that fall in steps along a read, and weights
    # of +5 on a read's first half and -5 on its second (the heaviest score
    # ends mid-graph and no later row reaches 0: branch completion loops
    # until its cap, status 3)
    ties = []
    for k in range(4):
        x, y = rand(30), rand(30)
        ties.append([x + "A" + y, x + "C" + y] + ([x + "G" + y] if k % 2 else []))
    t = rand(60)
    fan = [[t] + [t[:30] + chr(100 + i) + t[30:] for i in range(40)]]
    noisy = random_windows(rng, 24, (40, 80), 0.1, 0.1, reads=(4, 8))
    steps = random_windows(rng, 8, (60, 80), 0.03, 0.03, reads=(3, 5))
    halves = random_windows(rng, 2, (40, 60), 0.05, 0.05, reads=(3, 3))
    wts = [[np.ones(len(x), np.int32) for x in w] for w in ties + fan]
    wts += [[rng.integers(0, 10, len(x)).astype(np.int32) for x in w] for w in noisy]
    wts += [[np.array([9 - 10 * i // len(x) for i in range(len(x))], np.int32) for x in w]
            for w in steps]
    wts += [[np.where(np.arange(len(x)) < len(x) // 2, 5, -5).astype(np.int32) for x in w]
            for w in halves]
    sets["consensus"] = ("the consensus's ties, long in-lists, branch completion, status 3",
                         ties + fan + noisy + steps + halves, wts,
                         {"caps": (48, 40), "consensus": True},
                         {"status 0", "consensus status 3", "a tie on weight",
                          "a tie on weight and score", "an in-list past 32",
                          "branch completion over several loops"})
    return sets


def lockstep_compare(name, windows, weights, dev, max_nodes=None, D=None, reads=None, plan=None,
                     seen=None, caps=None, spec=False, consensus=False):
    """The chain of one bucket, read by read: each phase's kernel and plain
    version on clones of one state must give equal outputs and equal whole
    states (codes prefilled alike, so every byte compares), and the fused
    ``read_lockstep`` on a clone of the state the NW left must give the
    state and klen of the plain traceback, add and topsort. Returns the
    statuses the kernels left. Adds to ``seen`` what the chain reached:
    "d = k" for each predecessor distance an NW read, "status s" for each
    status, "E full", "out E full" and "A - 1 full" where a window ends
    without an error with a full in-edge, out-edge or clique list, "N = n"
    for the plan's N, "klen past K" where a walk ended after more than K
    moves, "more than one wave" where the bucket has more windows than the
    fused kernel holds on the card at once, with ``spec`` the facts of
    ``tb_spec_facts`` and with ``consensus`` those of ``consensus_facts``. ``plan`` (N, D, Lp, K) replaces the bucket's own,
    ``caps`` (E, A) the lockstep tier's."""
    lockstep, kernels, plains = lockstep_modules()
    N, D0, Lp, K = plan or lockstep.bucket_plan(windows, max_nodes)
    D = D or D0
    seqs, wts, lens, nseqs = bucket_tensors(windows, weights, N, dev)
    (seqs_t, wts_t, lens_t), state = lockstep.start_bucket(
        seqs, wts if weights else None, lens, nseqs, N)
    B, S, _ = seqs.shape
    if caps:
        from genomeworks_tpu_torch.poa import torch_poa

        state = torch_poa.init_graph_state(B, N, *caps, device=dev)
        wb = wts_t[0] if weights else torch.ones_like(seqs_t[0], dtype=torch.int32)
        torch_poa.build_backbone_batched(state, seqs_t[0].to(torch.int32), lens_t[0], wb,
                                         nseqs > 0)
    gap, mismatch, match = -8, -6, 8
    last = S if reads is None else min(S, reads + 1)

    def same(phase, k_out, p_out, ks, ps):
        from genomeworks_tpu_torch.poa.torch_poa import STATE_KEYS

        compare(f"{phase} on {name}", (*k_out, *(ks[k] for k in STATE_KEYS)),
                (*p_out, *(ps[k] for k in STATE_KEYS)))

    for s in range(1, last):
        act = nseqs > s
        w = None if wts_t is None else wts_t[s]
        if seen is not None:
            seen |= {f"d = {d}" for d in pred_distances(state, act)}
        ks, ps = clone_state(state), clone_state(state)
        ck = torch.full((B, N, Lp), 255, dtype=torch.uint8, device=dev)
        cp = ck.clone()
        bk = kernels["nw_lockstep"](ks, seqs_t[s], lens_t[s], act, ck, D, gap, mismatch, match)
        bp = plains["nw_lockstep"](ps, seqs_t[s], lens_t[s], act, cp, D, gap, mismatch, match)
        same("nw_lockstep", (ck, bk), (cp, bp), ks, ps)
        fs = clone_state(ks)  # the fused read's input: the state the NW left
        if spec and seen is not None:
            seen |= tb_spec_facts(ps, cp, bp, lens_t[s], act)
        tk = kernels["tb_lockstep"](ks, ck, bk, lens_t[s], act, K)
        tp = plains["tb_lockstep"](ps, cp, bp, lens_t[s], act, K)
        same("tb_lockstep", tk, tp, ks, ps)
        if seen is not None and bool((tp[2] > K).any()):
            seen.add("klen past K")
        kernels["add_lockstep"](ks, *tk, seqs_t[s], w, act)
        plains["add_lockstep"](ps, *tp, seqs_t[s], w, act)
        same("add_lockstep", (), (), ks, ps)
        kernels["topsort_lockstep"](ks, act)
        plains["topsort_lockstep"](ps, act)
        same("topsort_lockstep", (), (), ks, ps)
        fk = kernels["read_lockstep"](fs, ck, bk, lens_t[s], seqs_t[s], w, act, K)
        same("read_lockstep", (fk,), (tp[2],), fs, ps)
        state = ks
    act = nseqs > 0
    out = kernels["consensus_lockstep"](state, act)
    compare(f"consensus_lockstep on {name}", out, plains["consensus_lockstep"](state, act))
    statuses = sorted(set(out[3].tolist()))
    if seen is not None and consensus:
        seen |= consensus_facts(state, act, out[3])
    if seen is not None:
        ok = state["error"] == 0
        E, A = state["in_edges"].shape[2], state["al"].shape[2]
        seen |= {f"status {s}" for s in statuses} | {f"N = {N}"}
        seen |= {"E full"} if bool((state["in_count"][ok] == E).any()) else set()
        seen |= {"out E full"} if bool((state["out_count"][ok] == E).any()) else set()
        seen |= {"A - 1 full"} if bool((state["al_count"][ok] == A - 1).any()) else set()
        if dev.type == "cuda":
            from genomeworks_tpu_torch.ops import poa_lockstep_cuda as lk

            if B > lk.read_windows_in_flight(lk.PH_ALL, N, E, K):
                seen.add("more than one wave")
    print(f"check lockstep {name}: {B} windows, {last - 1} of {S - 1} reads, N={N} D={D} "
          f"Lp={Lp} K={K}: every phase == plain, state and outputs; statuses {statuses}")
    return set(statuses)


def covid_buckets(covid):
    """The buckets the lockstep tier runs on the covid workload as PoaBatch
    bins it: [(windows, plan, bin config)], the largest first."""
    from genomeworks_tpu_torch.poa import BandMode, get_multi_batch_sizes

    lockstep = lockstep_modules()[0]
    out = []
    for cfg, wids in zip(*get_multi_batch_sizes(covid, band_mode=BandMode.full_band)):
        if len(wids) < 64:
            continue
        ws = [covid[i] for i in wids]
        for edge, idxs in lockstep._bucket_windows([max(len(s) for s in w) for w in ws]):
            sub = [ws[i] for i in idxs]
            plan = None if edge is None else lockstep.bucket_plan(sub, cfg.max_nodes_per_graph)
            if plan is not None:
                out.append((sub, plan, cfg))
    return sorted(out, key=lambda x: -len(x[0]))


def largest_covid_bucket(covid):
    """The largest bucket the lockstep tier runs on the covid workload as
    PoaBatch bins it: (windows, plan, bin config)."""
    return covid_buckets(covid)[0]


def lockstep_work(t, plan, dev, fused):
    """The chain of a bucket through the kernels, the traceback, add and
    topsort fused (``read_lockstep``, the main path's) or each alone,
    counting what each phase's data needs and timing each launch with CUDA
    events. Returns (work counts, event ms per kernel, launches per
    kernel, consensus outputs)."""
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
        if fused:
            klen = timed("read_lockstep", lambda: kernels["read_lockstep"](
                st, codes, best, lens_t[s], seqs_t[s], w, act, K))
            graph_counts(act & (st["error"] == 0), "sort")
        else:
            ag, ar, klen = timed("tb_lockstep", lambda: kernels["tb_lockstep"](
                st, codes, best, lens_t[s], act, K))
            timed("add_lockstep", lambda: kernels["add_lockstep"](
                st, ag, ar, klen, seqs_t[s], w, act))
            graph_counts(act & (st["error"] == 0), "sort")
            timed("topsort_lockstep", lambda: kernels["topsort_lockstep"](st, act))
        add("walk_steps", klen.sum())
    graph_counts((nseqs > 0) & (st["error"] == 0), "cons")
    out = timed("consensus_lockstep", lambda: kernels["consensus_lockstep"](st, nseqs > 0))
    add("emitted", out[2].sum())
    return c, ms, launches, out


def lockstep_bounds(c):
    """(bytes, int32 ops) each kernel's work needs, from the run's counts;
    the fused read's, its three phases' together less the moves it keeps
    in shared memory."""
    b = {
        "nw_lockstep": (c["cells"] + c["read_bytes"] + 16 * c["nw_nodes"]
                        + 8 * c["nw_in_edges"],
                        nw_ops({"cells": c["cells"], "pred_cells": c["pred_cells"]})),
        "tb_lockstep": (TB_STEP_BYTES * c["walk_steps"], WALK_OPS * c["walk_steps"]),
        "add_lockstep": (ADD_STEP_BYTES * c["walk_steps"], WALK_OPS * c["walk_steps"]),
        "topsort_lockstep": (NODE_BYTES * c["sort_nodes"] + EDGE_BYTES * c["sort_out_edges"],
                             WALK_OPS * (c["sort_nodes"] + c["sort_out_edges"])),
        "consensus_lockstep": (CONS_NODE_BYTES * c["cons_nodes"]
                               + CONS_EDGE_BYTES * c["cons_in_edges"] + EMIT_BYTES * c["emitted"],
                               WALK_OPS * (c["cons_nodes"] + c["cons_in_edges"])),
    }
    b["read_lockstep"] = (
        (TB_STEP_BYTES - MOVE_BYTES + ADD_STEP_BYTES - MOVE_BYTES) * c["walk_steps"]
        + b["topsort_lockstep"][0],
        sum(b[n][1] for n in LK_ALONE))
    return b


def lockstep_timing(covid, dev):
    """Each lockstep kernel at the shapes of the largest covid bucket: CUDA
    events around every launch of the bucket's chain, once fused (the main
    path's) and once with the single-phase traceback, add and topsort, and
    the device time by kernel of both under torch.profiler; the windows the
    fused kernel holds on the card at once, and the waves of every covid
    bucket; the plain versions on the first 256 windows of the bucket at
    read 1 (and consensus after the whole build), with the kernels on the
    same inputs. Returns the kernels line's timing fields by name."""
    lockstep, kernels, plains = lockstep_modules()
    from genomeworks_tpu_torch.ops import poa_lockstep_cuda as lk

    for ws, (N, D, Lp, K), cfg in covid_buckets(covid):
        fly = lk.read_windows_in_flight(lk.PH_ALL, N, lk.plain.E_LK, K)
        cfly = lk.consensus_windows_in_flight(N)
        print(f"lk_read_kernel<7> on the covid bucket of bin {cfg.max_sequence_size}, {len(ws)} "
              f"windows, N={N} K={K}: {fly} windows in flight on the card, so "
              f"{-(-len(ws) // fly)} wave(s); lk_consensus_kernel {cfly}, so "
              f"{-(-len(ws) // cfly)} wave(s)")
    windows, plan, cfg = largest_covid_bucket(covid)
    N, D, Lp, K = plan
    ones = [[np.ones(len(s), np.int32) for s in w] for w in windows]
    t = bucket_tensors(windows, ones, N, dev)
    B, S, _ = t[0].shape
    shape = f"the largest covid bucket: {B} windows, {S} reads, N={N} D={D} Lp={Lp} K={K}"
    ev_ms = dict.fromkeys(kernels, 0.0)
    launches = dict.fromkeys(kernels, 0)
    for fused in (True, False):
        lockstep_work(t, plan, dev, fused)  # warm
        c_run, ms_run, n_run, out = lockstep_work(t, plan, dev, fused)
        for name in LK_ALONE + ("read_lockstep",):
            ev_ms[name] += ms_run[name]
            launches[name] += n_run[name]
        if fused:
            for name in ("nw_lockstep", "consensus_lockstep"):
                ev_ms[name], launches[name] = ms_run[name], n_run[name]
            fused_out = out
        else:
            c = c_run
            compare("the fused chain against the single-phase chain", fused_out, out)
    busy, prof_wall, by_name = profiled(lambda: lockstep.run_bucket(*t, N, D, Lp, K, -8, -6, 8))
    _, _, by_name_alone = profiled(lambda: lockstep_work(t, plan, dev, False))
    dev_ms = {name: sum(ms for key, ms in (by_name_alone if name in LK_ALONE else by_name).items()
                        if kname in key)
              for name, kname in LK_DEVICE_NAME.items()}
    print(f"time lockstep chain on {shape} (bin {cfg.max_sequence_size}): statuses "
          f"{sorted(set(fused_out[3].tolist()))}; profiled run {prof_wall * 1e3:.3f} ms wall, "
          f"device busy {busy:.3f} ms; work {c}")

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
        k_out = k_out if isinstance(k_out, tuple) else (k_out,)
        p_out = p_out if isinstance(p_out, tuple) else (p_out,)
        compare(f"{name} timed on the subset", (*k_out, *ks.values()), (*p_out, *ps.values()))
        return k_out, ks

    def nw(fn, st):
        codes = torch.full((256, N, Lp), 255, dtype=torch.uint8, device=dev)
        return codes, fn(st, seqs_t[1], lens_t[1], act, codes, D, -8, -6, 8)

    (codes, best), st1 = both("nw_lockstep", st0, nw)
    both("read_lockstep", st1,
         lambda fn, st: fn(st, codes, best, lens_t[1], seqs_t[1], wts_t[1], act, K))
    tb, st2 = both("tb_lockstep", st1, lambda fn, st: fn(st, codes, best, lens_t[1], act, K))
    _, st3 = both("add_lockstep", st2,
                  lambda fn, st: (fn(st, *tb, seqs_t[1], wts_t[1], act), ())[1])
    both("topsort_lockstep", st3, lambda fn, st: (fn(st, act), ())[1])
    st = clone_state(st0)
    for s in range(1, S):
        a = sub[3] > s
        b_i = kernels["nw_lockstep"](st, seqs_t[s], lens_t[s], a, codes, D, -8, -6, 8)
        kernels["read_lockstep"](st, codes, b_i, lens_t[s], seqs_t[s], wts_t[s], a, K)
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
        print(f"{name} ({LK_DEVICE_NAME[name]}): {n} launches on the bucket; device "
              f"{dev_ms[name]:.3f} ms, events {ev_ms[name]:.3f} ms in all, {ms:.4f} ms a launch"
              + (f" (one thread per window: {EARLIER_CONSENSUS_MS:.4f} ms)"
                 if name == "consensus_lockstep" else "")
              + f"; bound {nbytes_} bytes -> {t_bytes * n:.6f} ms, {ops} int32 ops -> "
              f"{t_ops * n:.6f} ms in all")
        fields[name] = {
            "ms": ms, "plain_ms": plain_ms[name], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "timed_on": f"{shape}: ms and bound_ms per launch (mean of the bucket's "
                        f"{n}); plain_ms on its first 256 windows at read 1",
            "subset_ms": sub_ms[name], "bucket_ms": dev_ms[name] or ev_ms[name],
            "bucket_launches": n,
        }
    return fields


# -- slice 4: the banded and MSA modes of the per-window kernel ------------------

MODE_REPLACES = "genomeworks_tpu/ops/poa_pallas.py:1895"
#: each instantiation's earlier time on the same covid windows, ms, an H100
#: 80GB HBM3 at 700 W: the banded ones the block-per-window kernel's (its
#: last run, before the warp per window), the full band's a block per
#: window too (before its warp per window)
EARLIER_MODE_MS = {"static": 11.150, "adaptive": 11.564, "static_msa": 12.371,
                   "adaptive_msa": 12.107, "full_msa": 17.160, "full_graph": 16.450}
#: the banded kernel's geometry (csrc/poa_consensus.cu): band lanes a lane
#: holds (two chunks of CELLS_PER_THREAD) and a tile's
BAND_CPL, BAND_TILE = 8, 256
# the instantiations of csrc/poa_consensus.cu this slice adds, by the name
# ops/poa_cuda.instance_name gives them
MODES = {
    "static": dict(band_width=256, adaptive=False, output="consensus"),
    "static_msa": dict(band_width=256, adaptive=False, output="msa"),
    "adaptive": dict(band_width=256, adaptive=True, output="consensus"),
    "adaptive_msa": dict(band_width=256, adaptive=True, output="msa"),
    "full_msa": dict(band_width=0, adaptive=False, output="msa"),
    "full_graph": dict(band_width=0, adaptive=False, output="graph"),
}


def host_oracle(job):
    """One window through the port's host chain (cpu_reference with a band
    mode), in a worker process: (key, result or the PoaError's message)."""
    from genomeworks_tpu_torch.poa import cpu_reference

    key, window, kind, band_mode, max_nodes = job
    fn = cpu_reference.poa_msa if kind == "msa" else cpu_reference.poa_consensus
    try:
        out = fn(window, max_nodes=max_nodes, band_mode=band_mode, band_width=256)
    except cpu_reference.PoaError as e:
        return key, str(e)
    return key, out if kind == "msa" else (out[0], out[1].tolist())


def long_windows(rng, n, length, reads, sub, indel):
    """n windows of ``reads`` reads around a random template of ``length``
    bases, each read with substitutions at ``sub`` and insertions and
    deletions at ``indel / 2`` each."""
    out = []
    for t in rng.integers(0, 4, (n, length)).astype(np.uint8):
        w = [BASES[t].tobytes().decode()]
        for _ in range(reads - 1):
            w.append(BASES[mutated(rng, t, sub, indel / 2, indel / 2)].tobytes().decode())
        out.append(w)
    return out


def mode_sets(rng):
    """The sets each new instantiation is held against its plain version on:
    seeded random windows (unit and non-unit weights, negative weights for
    status 3, an empty later read, a read that leaves the band, reads that
    fire adaptive rules 1 and 2, a first read at the graph's end for a deep
    racon DFS, each window's own node cap, which one window's new letters
    overflow for status 1) and
    noisy windows at E = A = 4 for status 2."""
    mixed = random_windows(rng, 12, (60, 200), 0.05, 0.05, reads=(2, 8))
    wts = [[rng.integers(1, 6, len(s)).astype(np.int32) for s in w] for w in mixed]
    t = mixed[0][0]
    extra = [[t, t[:40] + t[120:]], [t[-8:], t, t], [mixed[1][0], "", *mixed[1][1:]],
             [t[:50], t, t[:20] + t[60:]], [t[:60], t[:60] + t + t[:60]]]
    extra += random_windows(rng, 2, (40, 60), 0.1, 0.1, reads=(6, 6))
    # 11 reads that each insert three new letters: past its own cap of 39
    letters = [c for c in map(chr, range(66, 123)) if c.isalpha() and c not in "ACGT"]
    extra.append([t[:10]] + [t[:5] + "".join(letters[3 * i:3 * i + 3]) + t[5:10]
                             for i in range(11)])
    mixed += extra
    for i, w in enumerate(extra):
        neg = i in (5, 6)  # the two noisy windows get negative weights
        wts.append([rng.integers(-3, 3, len(s)).astype(np.int32) if neg
                    else np.ones(len(s), np.int32) for s in w])
    caps = [3 * max(len(s) for s in w) for w in mixed]
    edge = random_windows(rng, 8, (80, 120), 0.2, 0.2, reads=(12, 16))
    return [("random mixed", mixed, wts, caps, 50),
            ("random small E/A", edge, None, [3 * max(len(s) for s in w) for w in edge], 4)]


def band_edge_sets(rng):
    """The banded warp layout's edge cases, for phase 9a, the card tests and
    the CPU test against the JAX host chain: {key: (label, windows, weights,
    node caps (None: 3 x each window's longest read), band width, kinds
    ("static", "adaptive" or both), what the plain chain must meet: the
    marks of ``band_facts``)}. The give-up at 1536 is not among them: the
    chain cannot reach it (a first pass at 1536 skips rules 7-8, so there is
    no re-run; a re-run's rules 1-3 give its first pass's band)."""

    def rand(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))

    sets = {}
    # reads longer than the band, so that band starts move from row to row
    # and a chunk past its predecessor's band fails its guard: bands of 252
    # (a lane's last chunk alone), 260 (a second tile of one chunk) and 512
    # (two whole tiles)
    ws = random_windows(rng, 4, (380, 420), 0.04, 0.04, reads=(3, 4))
    sets["lane-edge"] = ("static band 252", ws, None, None, 252, ("static",),
                         {"a lane's last chunk alone", "a guard fails on another start"})
    sets["tile-edge"] = ("static band 260", ws, None, None, 260, ("static",),
                         {"a lane's last chunk alone", "a partial tile",
                          "a guard fails on another start"})
    sets["two-tiles"] = ("static band 512", ws, None, None, 512, ("static",),
                         {"whole tiles", "several tiles"})
    # 10 bases in, 120 or 150 deleted (the walk meets the band's left edge:
    # rule 7) or inserted (its right edge: rule 8), then the re-run
    shift = []
    for k in (120, 150):
        t = rand(300)
        shift += [[t, t[:10] + t[10 + k:]], [t, t[:10] + rand(k) + t[10:], t]]
    sets["shift"] = ("reads that leave an adaptive band of 128", shift, None, None, 128,
                     ("adaptive",), {"rule 7", "rule 8", "a re-run"})
    # adaptive rules 1-2: reads far longer than the graph (500 bases against
    # 10: band 1536, six tiles; 300 against 20: 384), one far shorter
    t = rand(500)
    wide = [[t[:10], t], [t[:20], t[:300]], [t[:60], t[:400], t[:300]], [t, t[:60]]]
    sets["wide"] = ("adaptive bands of several tiles", wide, None, None, 256, ("adaptive",),
                    {"band 1536", "a partial tile", "several tiles"})
    # a first read past its cap and reads that overflow theirs (status 1),
    # an empty later read
    t = rand(120)
    capped = [[t, t], [t[:40], t[:20] + "N" * 30 + t[20:40]], [t, "", t[:100]], [t[:80]] * 3]
    sets["caps"] = ("caps too small, an empty later read", capped, None, [100, 60, 360, 240],
                    256, ("static", "adaptive"), {"status 1", "an empty later read"})
    return sets


def band_facts(work, statuses, windows):
    """What a banded chain met, as marks, from the plain chain's ``work``
    (``banded_plain.nw_banded``), its statuses and its windows."""
    bws = work.get("band_widths", set())
    marks = {f"status {s}" for s in statuses}
    for mark, hit in (
            ("a lane's last chunk alone", any(b % BAND_CPL for b in bws)),
            ("a partial tile", any(b > BAND_TILE and b % BAND_TILE for b in bws)),
            ("whole tiles", any(b > BAND_TILE and not b % BAND_TILE for b in bws)),
            ("several tiles", any(b > BAND_TILE for b in bws)),
            ("band 1536", 1536 in bws),
            ("a guard fails on another start", work.get("guard_other_start", 0) > 0),
            ("rule 7", work.get("shift_left", 0) > 0),
            ("rule 8", work.get("shift_right", 0) > 0),
            ("a re-run", work.get("shift_left", 0) + work.get("shift_right", 0) > 0),
            ("an empty later read", any(not r for w in windows for r in w[1:]))):
        if hit:
            marks.add(mark)
    return marks


def bin_nodes(window):
    """max_nodes_per_graph of the bin get_multi_batch_sizes puts a window in."""
    from genomeworks_tpu_torch.poa import get_multi_batch_sizes

    return get_multi_batch_sizes([window])[0][0].max_nodes_per_graph


def mode_args(ws, wt, caps, E, mode, dev, band_width=None):
    """Packed CUDA tensors and keywords of one instantiation's wrapper
    (``band_width`` in place of the mode's)."""
    from genomeworks_tpu_torch.ops import poa_cuda
    from genomeworks_tpu_torch.poa.torch_poa import pack_windows

    m = MODES[mode]
    N = max(max(caps), max(len(s) for w in ws for s in w))
    seqs, wts, lens, nseqs, _ = pack_windows(ws, wt, N)
    args = [torch.from_numpy(a).to(dev) for a in (seqs, wts, lens, nseqs)]
    kw = dict(N=N, E=E, A=E, gap=-8, mismatch=-6, match=8)
    if m["band_width"]:
        kw.update(band_width=band_width or m["band_width"], adaptive=m["adaptive"],
                  caps=torch.tensor(caps, dtype=torch.int32, device=dev))
    fn = {"consensus": poa_cuda.poa_consensus_cuda, "msa": poa_cuda.poa_msa_cuda,
          "graph": poa_cuda.poa_graph_cuda}[m["output"]]
    return fn, args, kw


def mode_plain(mode, args, kw, work=None):
    """The plain version of an instantiation on the same tensors."""
    from genomeworks_tpu_torch.poa import banded_plain, torch_poa

    m = MODES[mode]
    base = (kw["N"], kw["E"], kw["A"], kw["gap"], kw["mismatch"], kw["match"])
    if m["band_width"]:
        fn = banded_plain.poa_banded_plain if m["output"] == "consensus" else \
            banded_plain.poa_msa_banded_plain
        return fn(*args, kw["caps"], *base[1:], kw["band_width"], m["adaptive"], work=work)
    fn = torch_poa.poa_msa_plain if m["output"] == "msa" else torch_poa.poa_graph_plain
    return fn(*args, *base, work=work)


def plain_job(job):
    """One instantiation's plain version on the host's CPU, one thread, in a
    worker process: (key, its outputs, its ms, the NW work it counted)."""
    torch.set_num_threads(1)
    key, mode, ws, wt, caps, E, *bw = job
    fn, args, kw = mode_args(ws, wt, caps, E, mode, torch.device("cpu"), *bw)
    work: dict = {}
    t0 = time.perf_counter()
    out = mode_plain(mode, args, kw, work)
    return key, list(out), (time.perf_counter() - t0) * 1e3, work


def msa_rows_ok(windows, msa, label):
    """Every row without its gaps is its read, and all rows of a window are
    as long as each other."""
    for b, (w, rows) in enumerate(zip(windows, msa)):
        if len(rows) != len(w) or len({len(r) for r in rows}) != 1:
            fail(f"{label}: window {b} has {len(rows)} MSA rows of lengths "
                 f"{sorted({len(r) for r in rows})}")
        for s, r in zip(w, rows):
            if r.replace("-", "") != s:
                fail(f"{label}: window {b} row {s} is not its read without gaps")


def slice4_phases(dev, covid, golden, n_long=256):
    """Phases 9a-9e. Returns the kernels line's entries of the six new
    instantiations."""
    from genomeworks_tpu_torch.ops import poa_cuda
    from genomeworks_tpu_torch.poa import (
        BandMode, BatchConfig, OutputType, PoaBatch, StatusType, banded_plain, cpu_reference,
        get_multi_batch_sizes, torch_poa,
    )

    lib = poa_cuda.load_library()
    t_phase = time.perf_counter()

    # -- 9a. each instantiation == its plain version, bit for bit -------------
    # The plain versions are host-bound (a Python call per op, each far
    # slower on the card than on the CPU, and processes sharing the card
    # time-slice it), so they run on the CPU, in one worker process per
    # core, on the same inputs; the kernels run after them, alone on the
    # card, and are timed then.
    jobs = []
    for name, ws, wt, caps, E in mode_sets(np.random.default_rng(2027)):
        for mode in MODES:
            if mode == "full_graph" and name != "random mixed":
                continue
            c = caps if MODES[mode]["band_width"] else [max(caps)] * len(caps)
            jobs.append(((mode, name), mode, ws, wt, c, E))
    cut = {"static": 32, "adaptive": 32, "full_msa": 32, "static_msa": 8, "adaptive_msa": 8,
           "full_graph": 8}
    for mode, n in cut.items():
        ws = covid[:n]
        cfgs, groups = get_multi_batch_sizes(ws, band_mode=BandMode.static_band)
        for cfg, wids in zip(cfgs, groups):
            sub = [ws[i] for i in wids]
            jobs.append(((mode, f"covid 0-{n - 1} bin {cfg.max_sequence_size}"), mode, sub, None,
                         [cfg.max_nodes_per_graph] * len(sub), 50))
    # the warp layout's edge sets, at their own band widths
    band_sets = band_edge_sets(np.random.default_rng(2028))
    for key, (label, ws, wt, caps, bw, kinds, want) in band_sets.items():
        caps = caps or [3 * max(len(s) for s in w) for w in ws]
        for mode in (m for kind in kinds for m in (kind, f"{kind}_msa")):
            jobs.append(((mode, label), mode, ws, wt, caps, 50, bw))
    jobs.sort(key=lambda j: not j[0][1].startswith("covid"))  # the long ones first
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=multiprocessing.get_context("spawn")) as ex:
        plain_out = {key: rest for key, *rest in ex.map(plain_job, jobs)}
    print(f"plain versions: {len(jobs)} runs on the host CPU in {time.perf_counter() - t0:.1f} "
          f"s (one process per core, one thread each)", flush=True)
    err = dict.fromkeys(MODES, 0)
    statuses = set()
    timed = {m: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0} for m in MODES}
    reached = {v[0]: set() for v in band_sets.values()}
    for key, mode, ws, wt, c, E, *bw in jobs:
        fn, args, kw = mode_args(ws, wt, c, E, mode, dev, *bw)
        k_out = fn(*args, **kw)
        p_out, p_ms, work = plain_out[key]
        err[mode] = max(err[mode], compare(f"{mode} on {key[1]}", k_out,
                                           [t.to(dev) for t in p_out]))
        st = sorted(set(k_out[-1].tolist()))
        statuses.update(st)
        line = (f"check {mode} on {key[1]}: {len(ws)} windows, N={kw['N']} E={E}: kernel == "
                f"plain (statuses {st})")
        if key[1] in reached:
            reached[key[1]] |= band_facts(work, st, ws)
        if key[1].startswith("covid"):
            m = MODES[mode]
            k_ms, _ = cuda_ms(lambda: poa_cuda._launch(
                lib, *args, kw["N"], 50, 50, -8, -6, 8, band_width=m["band_width"],
                adaptive=m["adaptive"], caps=kw.get("caps"), output=m["output"]), reps=3)
            tm = timed[mode]
            tm["ms"] += k_ms
            tm["plain_ms"] += p_ms
            tm["bytes"] += nbytes((*args, *k_out))
            tm["ops"] += nw_ops(work)
            line += (f"; kernel {k_ms:.3f} ms ({poa_cuda.last_chunk} windows a launch), plain "
                     f"{p_ms:.1f} ms")
        print(line, flush=True)
    if not {0, 1, 2, 3} <= statuses:
        fail(f"the slice-4 check sets did not reach statuses 0-3 (got {sorted(statuses)})")
    for key, (label, *_, want) in band_sets.items():
        if not want <= reached[label]:
            fail(f"the banded edge set {key!r} did not reach {sorted(want - reached[label])}")
        print(f"banded edge set {key!r} ({label}) reaches {sorted(reached[label])}")
    for mode, tm in timed.items():
        print(f"{mode}: kernel {tm['ms']:.3f} ms on covid 0-{cut[mode] - 1} (earlier "
              f"{EARLIER_MODE_MS[mode]:.3f} ms)")
    print(f"phase 9a: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- 9c-9e: the main paths, counts set to 0 just before each ---------------
    plains = (torch_poa.poa_consensus_plain, torch_poa.poa_msa_plain,
              torch_poa.poa_graph_plain, banded_plain.poa_banded_plain,
              banded_plain.poa_msa_banded_plain)
    host_calls = [0]
    build_window_graph = cpu_reference._build_window_graph

    def counting_build(*a, **k):
        host_calls[0] += 1
        return build_window_graph(*a, **k)

    cpu_reference._build_window_graph = counting_build

    def counted(fn):
        poa_cuda.launches_by_mode.clear()
        for p in plains:
            p.calls = 0
        host_calls[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return (out, wall, dict(poa_cuda.launches_by_mode), sum(p.calls for p in plains),
                host_calls[0])

    def run_batches(windows, band_mode, mask, graphs=0):
        cfgs, groups = get_multi_batch_sizes(windows, band_width=256, band_mode=band_mode)
        res = {}
        for cfg, wids in zip(cfgs, groups):
            batch = PoaBatch(cfg, mask, device="cuda")
            for i in wids:
                if batch.add_poa_group(windows[i])[0] != StatusType.success:
                    fail("add_poa_group refused a window")
            batch.generate_poa()
            cons = batch.get_consensus() if mask & OutputType.consensus else None
            msa = batch.get_msa() if mask & OutputType.msa else None
            if graphs:
                g, gs = batch.get_graphs() if len(wids) <= graphs else (None, [])
                res.setdefault("graph_status", []).extend(gs)
            for j, i in enumerate(wids):
                res[i] = (cons[0][j] if cons else None, cons[2][j] if cons else None,
                          msa[0][j] if msa else None, msa[1][j] if msa else None)
        return [res[i] for i in range(len(windows))], res.get("graph_status", [])

    both = OutputType.consensus | OutputType.msa
    results, walls, launches, covid_dev = {}, {}, {}, {}
    for mode, bm in (("static", BandMode.static_band), ("adaptive", BandMode.adaptive_band)):
        run_batches(covid[:256], bm, both)  # warm
        (out, _), wall, lc, pc, hc = counted(lambda: run_batches(covid, bm, both))
        bad = [i for i, o in enumerate(out) if o[1] != StatusType.success or
               o[3] != StatusType.success]
        if bad:
            fail(f"{mode}-band main path: {len(bad)} covid windows without success, "
                 f"first {bad[:5]}")
        if lc.get(mode, 0) <= 0 or lc.get(f"{mode}_msa", 0) <= 0 or pc or hc:
            fail(f"{mode}-band main path launched {lc}, called a plain version {pc} times and "
                 f"the host chain {hc} times")
        msa_rows_ok(covid, [o[2] for o in out], f"{mode}-band main path")
        same = sum(o[0] == g for o, g in zip(out, golden))
        results[mode], walls[mode], walls[f"{mode}_msa"] = out, wall, wall
        launches[mode], launches[f"{mode}_msa"] = lc[mode], lc[f"{mode}_msa"]
        print(f"main path ({mode} band 256, consensus + MSA): {len(covid)} covid windows "
              f"through PoaBatch(device='cuda'): all success; {wall:.3f} s wall, "
              f"{len(covid) / wall:.1f} windows/s; launches {lc}; {pc} plain-version calls, "
              f"{hc} host-chain windows; every MSA row is its read without gaps; "
              f"{same} of {len(covid)} consensuses equal the full-band golden", flush=True)
        # the same path under torch.profiler: each instantiation's device ms
        # over the whole file, against a lower bound of its work: every read
        # after the first aligns to a graph of at least the first read's
        # nodes over a band of at least 256 lanes, 7 int32 ops a cell
        # (nw_ops with one predecessor), and reads its bases and weights
        busy, prof_wall, by_name = profiled(lambda: run_batches(covid, bm, both))
        cfgs, groups = get_multi_batch_sizes(covid, band_width=256, band_mode=bm)
        for cfg, wids in zip(cfgs, groups):
            N, L = cfg.max_nodes_per_graph, max(len(r) for i in wids for r in covid[i])
            S = max(len(covid[i]) for i in wids)
            for out in (0, 1):
                slab = lib.poa_mode_slab_bytes(1 + (mode == "adaptive"), out, N, L, 50, 50, S,
                                               poa_cuda.band_alloc(256, mode == "adaptive"))
                print(f"{mode} band, {'MSA' if out else 'consensus'}, covid bin "
                      f"{cfg.max_sequence_size}: {len(wids)} windows, N={N} L={L}, "
                      f"{slab} scratch bytes a window, "
                      f"{poa_cuda.chunk_windows(len(wids), slab, dev)} windows a launch, "
                      f"{lib.poa_banded_windows_in_flight(1 + (mode == 'adaptive'), out, L)} "
                      f"in flight on the card; window_paths {lib.poa_banded_paths(N, N)} at "
                      f"nc = N")
        cells = sum(len(w[0]) * 256 * (len(w) - 1) for w in covid)
        in_bytes = sum(5 * len(r) for w in covid for r in w)
        for out in (0, 1):
            name = mode if out == 0 else f"{mode}_msa"
            band = 1 if mode == "static" else 2
            ms = sum(v for k, v in by_name.items() if f"poa_banded_kernel<{band}, {out}>" in k)
            bound = max(7 * cells / SCALAR_OPS_PER_S, in_bytes / HBM_BYTES_PER_S) * 1e3
            covid_dev[name] = (ms, lc[name], bound)
            print(f"profiled {mode}-band main path: poa_banded_kernel<{band}, {out}> {ms:.3f} "
                  f"device ms over the whole covid file in {lc[name]} launches "
                  f"({ms / max(lc[name], 1):.3f} ms a launch); bound at least {bound:.6f} ms "
                  f"({7 * cells} int32 ops over {cells} cells, {in_bytes} input bytes)")
        print(f"profiled {mode}-band main path: {prof_wall * 1e3:.3f} ms wall under "
              f"torch.profiler, device busy {busy:.3f} ms ({100 * busy / (prof_wall * 1e3):.2f} "
              f"% of the wall); " + "; ".join(
                  f"{k} {v:.3f} ms" for k, v in sorted(by_kernel(by_name).items(),
                                                       key=lambda kv: -kv[1])[:6]), flush=True)
    (out, _), wall, lc, pc, hc = counted(lambda: run_batches(covid, BandMode.full_band, both))
    bad = [i for i, (o, g) in enumerate(zip(out, golden)) if o[0] != g or o[1] != 0 or o[3] != 0]
    if bad:
        fail(f"full-band consensus + MSA main path: {len(bad)} covid windows fail or differ "
             f"from the golden, first {bad[:5]}")
    msa_rows_ok(covid, [o[2] for o in out], "full-band main path")
    if lc.get("full_msa", 0) <= 0 or pc or hc:
        fail(f"full-band MSA main path launched {lc}, plain {pc}, host {hc}")
    walls["full_msa"] = wall
    launches["full_msa"] = lc["full_msa"]
    results["full_msa"] = out
    print(f"main path (full band, consensus + MSA): {len(covid)} covid windows: consensus == "
          f"golden, every MSA row is its read without gaps; {wall:.3f} s wall, "
          f"{len(covid) / wall:.1f} windows/s; launches {lc}; {pc} plain-version calls",
          flush=True)
    (out, gst), gwall, lc, pc, hc = counted(
        lambda: run_batches(covid[:256], BandMode.full_band, OutputType.consensus, graphs=256))
    if lc.get("full_graph", 0) <= 0 or pc or any(s != StatusType.success for s in gst):
        fail(f"get_graphs path launched {lc}, plain {pc}, statuses {set(gst)}")
    launches["full_graph"] = lc["full_graph"]
    walls["full_graph"] = gwall
    print(f"main path (get_graphs, full band): 256 covid windows, all success; {gwall:.3f} s "
          f"wall; launches {lc}", flush=True)

    # (e) long windows
    rng = np.random.default_rng(2000)
    long_set = long_windows(rng, n_long, 2000, 8, 0.03, 0.03)
    for mode, bm in (("static", BandMode.static_band), ("adaptive", BandMode.adaptive_band)):
        (out, _), wall, lc, pc, hc = counted(
            lambda: run_batches(long_set, bm, OutputType.consensus))
        st = {}
        for o in out:
            st[int(o[1])] = st.get(int(o[1]), 0) + 1
        if pc or hc or lc.get(mode, 0) <= 0:
            fail(f"long windows ({mode}): launched {lc}, plain {pc}, host {hc}")
        print(f"long windows ({mode} band 256): {n_long} windows of 2000 bp x 8 reads: "
              f"{wall:.3f} s wall, {n_long / wall:.2f} windows/s; statuses {st}; launches {lc} "
              f"(chunk {poa_cuda.last_chunk} windows a launch)", flush=True)
        if mode == "static":
            walls["long_static"] = wall
        else:
            walls["long_adaptive"] = wall
    cpu_reference._build_window_graph = build_window_graph
    print(f"phases 9c-9e: {time.perf_counter() - t_phase:.1f} s since 9a began", flush=True)

    # -- 9b. against the host oracle, in one process per core --------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(4)
    longs = long_windows(rng, 2, 2000, 6, 0.03, 0.03)
    first16 = [w for w in covid if max(len(s) for s in w) <= 256][:16]
    jobs = []
    for mode in ("static_band", "adaptive_band"):
        jobs += [((mode, "consensus", i), w, "consensus", mode, 768)
                 for i, w in enumerate(first16)]
        jobs += [((mode, "msa", i), w, "msa", mode, 768) for i, w in enumerate(first16[:8])]
        jobs += [((mode, "long", i), w, "consensus", mode, None) for i, w in enumerate(longs)]
    msa_check = list(range(0, len(covid), max(1, len(covid) // 256)))[:256]
    jobs += [(("full_band", "msa", i), covid[i], "msa", "full_band", bin_nodes(covid[i]))
             for i in msa_check]
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=multiprocessing.get_context("spawn")) as ex:
        oracle_out = dict(ex.map(host_oracle, jobs))
    print(f"host oracle: {len(jobs)} windows in {time.perf_counter() - t0:.1f} s", flush=True)
    for mode, key in (("static_band", "static"), ("adaptive_band", "adaptive")):
        got = {i: results[key][covid.index(w)] for i, w in enumerate(first16)}
        for i, w in enumerate(first16):
            ref = oracle_out[(mode, "consensus", i)]
            if isinstance(ref, str) or got[i][0] != ref[0]:
                fail(f"{mode}: covid window {covid.index(w)} differs from the host oracle")
            if i < 8 and got[i][2] != oracle_out[(mode, "msa", i)]:
                fail(f"{mode}: covid window {covid.index(w)} MSA differs from the host oracle")
        cons, _, st = torch_poa.poa_batch_consensus_banded(longs, band_width=256, band_mode=mode)
        for i in range(len(longs)):
            ref = oracle_out[(mode, "long", i)]
            want = (ref[0], 0) if not isinstance(ref, str) else ("", torch_poa.HOST_STATUS[ref])
            if (cons[i], st[i]) != want:
                fail(f"{mode}: 2-kb window {i} differs from the host oracle")
        print(f"check {mode} against the host oracle: 16 covid windows (consensus), 8 (MSA) "
              f"and 2 windows of 2000 bp x 6 reads equal cpu_reference", flush=True)
    for i in msa_check:
        if results["full_msa"][i][2] != oracle_out[("full_band", "msa", i)]:
            fail(f"full band: covid window {i} MSA differs from cpu_reference.poa_msa")
    print(f"check full-band MSA against cpu_reference.poa_msa: {len(msa_check)} covid windows "
          f"equal; phases 9a-9e {time.perf_counter() - t_phase:.1f} s", flush=True)

    entries = []
    for mode, tm in timed.items():
        t_bytes = tm["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = tm["ops"] / SCALAR_OPS_PER_S * 1e3
        print(f"{mode} bound: {tm['bytes']} bytes -> {t_bytes:.6f} ms; {tm['ops']} int32 ops "
              f"-> {t_ops:.6f} ms")
        entries.append({
            "name": f"poa_consensus_cuda[{mode}]",
            "route": "cuda",
            "source": SOURCE,
            "replaces": MODE_REPLACES,
            "state": "ported",
            "launches": launches[mode],
            "max_abs_err": err[mode],
            "ms": tm["ms"],
            "plain_ms": tm["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "timed_on": f"covid windows 0-{cut[mode] - 1}, packed per bin; plain_ms on the "
                        f"host CPU, one thread, one process per core",
            "main_path_s": walls[mode],
            "windows_per_s": (256 if mode == "full_graph" else len(covid)) / walls[mode],
        })
        if mode in covid_dev:
            ms, n, bound = covid_dev[mode]
            entries[-1].update(covid_device_ms=ms, covid_launches=n,
                               covid_bound_ms_at_least=bound)
    entries[0]["long_windows_s"] = walls["long_static"]
    entries[2]["long_windows_s"] = walls["long_adaptive"]
    return entries


# -- slice 11: the mapper -----------------------------------------------------------

#: a bacterial genome's all-vs-all overlaps: reads of 8-12 kb at about 12.5x
#: over 2 Mbp, half reverse complemented, 1.5 % substitutions, 1 % insertions
#: and 1 % deletions
MAPPER_GENOME = 2_000_000
MAPPER_READS = 2500
MAPPER_LENGTHS = (8000, 12000)
MAPPER_ERRORS = (0.015, 0.01, 0.01)
#: the reads whose overlaps ``--align`` aligns
MAPPER_ALIGN_READS = 300
#: a true overlap: genome intervals that share this many bases (the tool's
#: minimum overlap length)
MAPPER_TRUE_OVERLAP = 250


def mapper_reads(rng, genome_len, n, lengths, errors):
    """A random genome and ``n`` reads of it, made in bulk with NumPy: each of
    a uniform length in ``lengths`` at a uniform start, its substitutions,
    deletions and insertions at the rates ``errors``, every other read
    reverse complemented. Returns [(name, read)] and each read's genome
    interval."""
    sub, ins, dele = errors
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    reads, intervals = [], []
    for i in range(n):
        length = int(rng.integers(lengths[0], lengths[1] + 1))
        start = int(rng.integers(0, genome_len - length + 1))
        seg = genome[start:start + length].copy()
        r = rng.random(length)
        subst = r < sub
        seg[subst] = (seg[subst] + rng.integers(1, 4, int(subst.sum()), dtype=np.uint8)) % 4
        seg = seg[(r < sub) | (r >= sub + dele)]
        n_ins = int(rng.binomial(len(seg), ins))
        seg = np.insert(seg, rng.integers(0, len(seg) + 1, n_ins),
                        rng.integers(0, 4, n_ins, dtype=np.uint8))
        if i % 2:
            seg = 3 - seg[::-1]
        reads.append((f"read{i}", acgt[seg].tobytes().decode()))
        intervals.append((start, start + length))
    return reads, intervals


def run_gw_mapper(args):
    """The port's gw_mapper in this process, as a shell runs it (``sys.argv``,
    so SAM and BAM headers carry no command line): its standard output's
    bytes."""
    import io

    from genomeworks_tpu_torch.tools import gw_mapper

    argv, stdout = sys.argv, sys.stdout
    sys.argv = ["gw-mapper", *args]
    sys.stdout = io.TextIOWrapper(io.BytesIO(), encoding="ascii")
    try:
        gw_mapper.main()
        sys.stdout.flush()
        return sys.stdout.buffer.getvalue()
    finally:
        sys.argv, sys.stdout = argv, stdout


def paf_fields_ok(paf: bytes, lengths: dict) -> int:
    """Every PAF line's names, lengths, strand and spans lie within its reads;
    returns the line count."""
    n = 0
    for line in paf.decode().splitlines():
        c = line.split("\t")
        qn, ql, qs, qe, strand, tn, tl, ts, te = c[0], *map(int, c[1:4]), c[4], c[5], \
            *map(int, c[6:9])
        if lengths.get(qn) != ql or lengths.get(tn) != tl or strand not in "+-" or \
                not (0 <= qs < qe <= ql and 0 <= ts < te <= tl):
            fail(f"mapper: a PAF line outside its reads: {line[:200]}")
        n += 1
    return n


def cigar_consumes(cigar: str, qspan: int, tspan: int) -> bool:
    """An insertion is a target base absent from the query, a deletion the
    reverse (aligner/types.py)."""
    ops = re.findall(r"(\d+)([MID=X])", cigar)
    return "".join(n + op for n, op in ops) == cigar and \
        sum(int(n) for n, op in ops if op in "MD=X") == qspan and \
        sum(int(n) for n, op in ops if op in "MI=X") == tspan


def mapper_phase(dev, n_reads=MAPPER_READS, genome_len=MAPPER_GENOME, align_reads=MAPPER_ALIGN_READS):
    """Phase 10: the port's mapper through ``gw_mapper`` and ``map_reads`` on
    simulated reads of a bacterial genome; every gate fails the run.
    Returns the reads, [(name, read)]."""
    import io
    import tempfile

    from genomeworks_tpu_torch.aligner.banded_nw import banded_nw_forward_plain
    from genomeworks_tpu_torch.aligner.myers_banded_model import myers_banded_plain
    from genomeworks_tpu_torch.aligner.rle_traceback import rle_traceback_plain
    from genomeworks_tpu_torch.core.profiling import phase_times, reset_phase_times
    from genomeworks_tpu_torch.io import create_fasta_parser, write_fasta
    from genomeworks_tpu_torch.io.sam import write_sam
    from genomeworks_tpu_torch.mapper import MapperParams, map_reads
    from genomeworks_tpu_torch.mapper.device_pipeline import _match_counts, build_index_device
    from genomeworks_tpu_torch.ops.banded_nw_cuda import banded_nw_cuda
    from genomeworks_tpu_torch.ops.myers_banded_cuda import myers_banded_cuda
    from genomeworks_tpu_torch.ops.rle_traceback_cuda import rle_traceback_cuda

    t_phase = time.perf_counter()
    reads, intervals = mapper_reads(np.random.default_rng(2026), genome_len, n_reads,
                                    MAPPER_LENGTHS, MAPPER_ERRORS)
    lengths = {name: len(seq) for name, seq in reads}
    bases = sum(lengths.values())
    print(f"mapper: {len(reads)} reads, {bases} bases ({bases / genome_len:.2f}x over "
          f"{genome_len} bp) made in {time.perf_counter() - t_phase:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        path, path_align = os.path.join(tmp, "reads.fa"), os.path.join(tmp, "align.fa")
        write_fasta(reads, path)
        write_fasta(reads[:align_reads], path_align)
        dv = ["--device", dev.type]

        walls = {}

        def tool(label, *args):
            t0 = time.perf_counter()
            out = run_gw_mapper([*args, *dv])
            walls[label] = time.perf_counter() - t0
            return out

        # -- 10a. the tool: device pipeline against the host pipeline ----------
        paf = tool("paf", path)
        if tool("paf again", path) != paf:
            fail("mapper: two device-pipeline runs gave different PAF bytes")
        if tool("paf host", path, "--host-pipeline") != paf:
            fail("mapper: the device pipeline's PAF differs from the host pipeline's")
        paf8 = tool("paf -i 8", path, "-i", "8")
        if tool("paf -i 8 host", path, "-i", "8", "--host-pipeline") != paf8:
            fail("mapper: at --index-size 8 the device pipeline's PAF differs from the host's")
        sam = tool("sam", path, "--format", "sam")
        n_paf, n_paf8 = paf_fields_ok(paf, lengths), paf_fields_ok(paf8, lengths)
        print(f"mapper tool: PAF {n_paf} lines (-i 8: {n_paf8}), device == host pipeline "
              f"byte for byte at both index sizes, two device runs equal; every field within "
              f"its read; SAM {len(sam)} bytes; walls (s, one process, parse and output "
              f"included): " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))

        # recall against the simulated truth: pairs whose genome intervals
        # share at least MAPPER_TRUE_OVERLAP bases
        order = sorted(range(len(reads)), key=lambda i: intervals[i][0])
        truth = set()
        for a, i in enumerate(order):
            for j in order[a + 1:]:
                if intervals[j][0] > intervals[i][1] - MAPPER_TRUE_OVERLAP:
                    break
                if min(intervals[i][1], intervals[j][1]) - intervals[j][0] >= \
                        MAPPER_TRUE_OVERLAP:
                    truth.add((min(i, j), max(i, j)))
        found = set()
        for line in paf.decode().splitlines():
            q, t = line.split("\t", 6)[0:6:5]
            i, j = int(q[4:]), int(t[4:])
            found.add((min(i, j), max(i, j)))
        print(f"mapper recall: {len(found & truth)} of {len(truth)} true pairs "
              f"({100 * len(found & truth) / max(len(truth), 1):.2f} %); {len(found - truth)} "
              f"of {len(found)} pairs found are not true")

        # -- 10b. the library: counts, warm walls, phases, memory, profile ------
        parser = create_fasta_parser(path, min_sequence_length=24)
        filtering = 1e-5 if bases >= 500_000 else 1.0
        index = build_index_device(parser, 0, len(parser), filtering_parameter=filtering,
                                   device=dev)
        anchors = int(_match_counts(index, index)[2])
        print(f"mapper index: {index.n} sketch elements, {index.u} representations after "
              f"filtering at {filtering}; {anchors} anchors (self pairs included)")
        del index

        def mapped(device_pipeline):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = map_reads(parser, parser, MapperParams(device_pipeline=device_pipeline),
                            device=dev)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        host, host_wall = mapped(False)
        # the host pipeline's SAM, written as the tool writes it
        host_sam = io.StringIO()
        write_sam(host, None, parser, parser, host_sam)
        if host_sam.getvalue().encode() != sam:
            fail("mapper: the device pipeline's SAM differs from the host pipeline's")
        torch.cuda.reset_peak_memory_stats()
        reset_phase_times()
        overlaps, dev_wall = mapped(True)
        peak = torch.cuda.max_memory_allocated()
        if overlaps != host:
            fail("mapper: map_reads on the device pipeline differs from the host pipeline")
        print(f"mapper map_reads (warm, after torch.cuda.synchronize()): {len(overlaps)} "
              f"overlaps, the host pipeline's SAM == the tool's device SAM; device pipeline {dev_wall:.4f} s, {len(reads) / dev_wall:.1f} "
              f"reads/s; host pipeline {host_wall:.4f} s; peak device memory "
              f"{peak / 2**30:.3f} GiB; phases {json.dumps(phase_times())}")
        busy_ms, prof_wall, by_name = profiled(lambda: mapped(True))
        top = sorted(by_kernel(by_name).items(), key=lambda kv: -kv[1])[:10]
        print(f"mapper profiled: {prof_wall * 1e3:.3f} ms wall under torch.profiler, device "
              f"busy {busy_ms:.3f} ms ({100 * busy_ms / (prof_wall * 1e3):.2f} % of the wall); "
              + "; ".join(f"{k} {v:.3f} ms" for k, v in top))

        # -- 10c. --align on the overlaps among the first reads ------------------
        kernels = (myers_banded_cuda, banded_nw_cuda, rle_traceback_cuda)
        plains = (myers_banded_plain, banded_nw_forward_plain, rle_traceback_plain)
        for k in kernels:
            k.launches = 0
        for p in plains:
            p.calls = 0
        t0 = time.perf_counter()
        aligned = run_gw_mapper([path_align, "--align", *dv]).decode().splitlines()
        align_wall = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels}
        calls = sum(p.calls for p in plains)
        for line in aligned:
            c = line.split("\t")
            if not cigar_consumes(c[12].removeprefix("cg:Z:"), int(c[3]) - int(c[2]),
                                  int(c[8]) - int(c[7])):
                fail(f"mapper --align: a CIGAR does not consume its spans: {line[:200]}")
        if not aligned or launches["myers_banded_cuda"] <= 0 or \
                launches["rle_traceback_cuda"] <= 0 or calls:
            fail(f"mapper --align: {len(aligned)} lines, launches {launches}, {calls} "
                 f"plain-version calls")
        print(f"mapper --align on the first {align_reads} reads: {len(aligned)} overlaps, "
              f"every CIGAR consumes its spans; launches {launches}, {calls} plain-version "
              f"calls; {align_wall:.3f} s")
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return reads


# -- slice 12: the extender and the batched Myers distance --------------------------

XDROP_SOURCE = "genomeworks_tpu_torch/csrc/xdrop.cu"
MYERS_SCORE_SOURCE = "genomeworks_tpu_torch/csrc/myers_score.cu"
#: a 10 Mbp genome (a bacterium's scale) against a copy with 8 % substitutions
#: and 0.5 % insertions and deletions
EXT_GENOME = 10_000_000
EXT_ERRORS = (0.08, 0.005)
#: two batches at the default batch_max_extensions (1 << 22)
EXT_SEEDS = (1 << 22) + 65_536
#: the seeds the CPU path and the sample check
EXT_CHECK = 65_536
EXT_THRESHOLD = 3000
#: int32 ops a position extended: the clamped reads' indices and bounds, the
#: score's index, the prefix sum's and the running max's steps, the drop test
XDROP_POS_OPS = 16
#: int32 ops a position of a final segment counted: indices, bounds, the
#: comparisons and the four ballots' predicates
XCOUNT_POS_OPS = 10
#: int32 ops a query word a target position in myers_score_kernel
MYERS_SCORE_WORD_OPS = 22
#: PERF.md's figures for the slice-12 kernels (a warp a seed with one
#: position a lane; a thread an alignment) at these shapes, and the main
#: paths' walls through them (``experiments/torch_extender_check.py
#: --parent``, two turns, H100 80GB HBM3 at 700 W). Printed for reading
#: beside this run's numbers; this script does not measure them.
SLICE12_PERF_MD = ("xdrop_extend 7.2876 ms a batch of 4,194,304 seeds, myers_score 12.552 "
                   "ms at 1,024 pairs of 2 kb; walls: the extender 0.1742 / 0.2060 s, "
                   "busy 17.65 / 8.41 %; myers_edit_distance_batched 0.1000 / 0.1047 s")


def extender_inputs(rng, length, sub, indel, n_seeds, homologous=0.75):
    """A random genome of ``length`` (the target, codes 0-3), a query made
    from it in bulk with NumPy (each base substituted with probability
    ``sub``, deleted with ``indel / 2``, followed by an inserted random base
    with ``indel / 2``), and ``n_seeds`` (query, target) seeds: the first
    ``homologous`` share at true homologous positions from that edit map,
    the rest random pairs, in a random order. Returns (query, target, seeds
    int64 (n, 2))."""
    from genomeworks_tpu_torch.extender import encode_sequence
    from genomeworks_tpu_torch.simulators.genomesim import generate_random_genome

    target = encode_sequence(generate_random_genome(length, rng)).astype(np.uint8)
    r = rng.random(length)
    dele = r < indel / 2
    ins = (r >= indel / 2) & (r < indel)
    base = target.copy()
    subst = rng.random(length) < sub
    base[subst] = (base[subst] + rng.integers(1, 4, int(subst.sum()), dtype=np.uint8)) % 4
    kept = ~dele
    n_out = kept.astype(np.int64) + ins
    start = np.cumsum(n_out) - n_out
    query = np.empty(int(n_out.sum()), np.uint8)
    query[start[kept]] = base[kept]
    query[start[ins] + kept[ins]] = rng.integers(0, 4, int(ins.sum()), dtype=np.uint8)
    n_h = int(round(n_seeds * homologous))
    j = np.flatnonzero(kept)[rng.integers(0, int(kept.sum()), n_h)]
    seeds = np.empty((n_seeds, 2), np.int64)
    seeds[:n_h, 0] = start[j]
    seeds[:n_h, 1] = j
    seeds[n_h:, 0] = rng.integers(0, len(query), n_seeds - n_h)
    seeds[n_h:, 1] = rng.integers(0, length, n_seeds - n_h)
    return query, target, seeds[rng.permutation(n_seeds)]


def wrap32(x):
    """int64 values as int32 arithmetic leaves them (two's complement wrap)."""
    return (np.asarray(x, np.int64) + (1 << 31)) % (1 << 32) - (1 << 31)


def xdrop_walk(q, t, qs, ts, sub, xdrop, left):
    """One direction of one seed replayed in NumPy over its whole diagonal,
    as the reference defines it (no tiles): the positions in the sequences
    score sub[target, query] (reads clamped), the cumulative score wraps as
    int32 does, the running maximum starts at 0, and the walk stops before
    the first position whose deficit (running max - cumulative, wrapped)
    exceeds ``xdrop``. Returns a dict: best, pos (the earliest offset of the
    best, -1 right / 0 left when it is 0), n (the positions in the
    sequences), stop (positions walked), the offsets, deficits and
    cumulative scores walked, whether the cumulative score wrapped before
    the stop, and the codes read."""
    Lq, Lt = len(q), len(t)
    n = max(0, min(ts, qs)) if left else max(0, min(Lt - ts, Lq - qs))
    o = np.arange(1, n + 1) if left else np.arange(n)
    tp, qp = (ts - o, qs - o) if left else (ts + o, qs + o)
    tc, qc = t[np.clip(tp, 0, Lt - 1)], q[np.clip(qp, 0, Lq - 1)]
    exact = np.cumsum(sub[tc, qc].astype(np.int64))
    cum = wrap32(exact)
    run = np.maximum.accumulate(np.maximum(cum, 0))
    deficit = wrap32(run - cum)
    over = np.flatnonzero(deficit > xdrop)
    stop = int(over[0]) if len(over) else n
    best = int(run[stop - 1]) if stop else 0
    pos = int(o[np.flatnonzero(cum[:stop] == best)[0]]) if best > 0 else (0 if left else -1)
    return {"best": best, "pos": pos, "n": n, "stop": stop, "o": o, "deficit": deficit,
            "cum": cum, "wraps": bool((exact[: stop + 1] != cum[: stop + 1]).any()),
            "codes": set(tc[: stop + 1].tolist()) | set(qc[: stop + 1].tolist())}


def xdrop_layout(i):
    """Where walk index i (an array) lies in ``xdrop_extend_kernel``'s tiles:
    (tile, lane, position in the lane, positions a lane), with K =
    ``xdrop_cuda.LANE_POSITIONS`` positions a lane and 32 K a tile."""
    from genomeworks_tpu_torch.ops.xdrop_cuda import LANE_POSITIONS as K

    i = np.asarray(i, np.int64)
    return i // (32 * K), i % (32 * K) // K, i % K, K


def xdrop_facts(q, t, seeds, sub, xdrop, out):
    """What a set reaches, read from the plain version's outputs ``out``
    (S, 4) and the NumPy replays of its seeds, which must agree with them.
    "tile" alone is a 32-position tile (the first kernel's, and the plain
    width of the sets that name it); "lane" and "kernel tile" are those of
    ``xdrop_extend_kernel`` (``xdrop_layout``)."""
    sub8 = np.asarray(sub, np.int64).reshape(8, 8)
    facts = set()
    if xdrop == 0:
        facts.add("xdrop 0")
    codes = set()
    for (qs, ts), row in zip(seeds.tolist(), out.tolist()):
        for left, side in ((False, "right"), (True, "left")):
            w = xdrop_walk(q, t, qs, ts, sub8, xdrop, left)
            got = (row[2], row[3]) if left else (row[0], row[1])
            if got != (w["best"], w["pos"]):
                fail(f"xdrop plain version {got} differs from the replay "
                     f"{(w['best'], w['pos'])} at seed {(qs, ts)} {side}")
            codes |= w["codes"]
            n, stop = w["n"], w["stop"]
            if stop == n and n:
                facts.add(f"{side} ends at a sequence end "
                          + ("on a tile edge" if n % 32 == 0 else "mid-tile"))
            if stop < n and w["deficit"][stop] == xdrop + 1:
                facts.add("stops at a drop of xdrop + 1")
            if stop and w["deficit"][:stop].max() == xdrop and xdrop > 0:
                facts.add("passes a drop of exactly xdrop")
            if w["best"] > 0:
                at = w["o"][np.flatnonzero(w["cum"][:stop] == w["best"])]
                tiles = (at - 1 if left else at) // 32
                if len(at) > 1:
                    facts.add("tie in a tile" if tiles[1] == tiles[0] else "tie across tiles")
                    if tiles[-1] != tiles[0]:
                        facts.add("tie across tiles")
            if w["best"] > 0 and w["pos"] == (ts if left else len(t) - 1 - ts) and \
                    n == (ts if left else len(t) - ts):
                facts.add(f"{side} reaches its sequence end")
            # the kernel's lanes and tiles, by walk index (offset - 1 on the left)
            if stop < n and stop:
                tile, lane, j, width = xdrop_layout(stop)
                if j == 0:
                    facts.add("drop at a lane's first position")
                if j == width - 1:
                    facts.add("drop at a lane's last position")
                if j == 0 and lane == 0:
                    facts.add(f"drop at the first position of kernel tile {min(tile, 2)}")
            if stop == n and n:
                j, width = xdrop_layout(n - 1)[2:]
                facts.add(f"{side} ends at a sequence end "
                          + ("on a lane's edge" if j == width - 1 else "inside a lane")
                          + (" of a later tile" if xdrop_layout(n - 1)[0] else ""))
            if stop < n and xdrop_layout(stop)[0] >= 4:
                facts.add("a run over 4 kernel tiles that drops")
            if w["wraps"]:
                facts.add("the score wraps int32")
            if w["best"] > 0:
                walk = w["o"][np.flatnonzero(w["cum"][:stop] == w["best"])] - (1 if left else 0)
                if len(walk) > 1:
                    tile, lane = xdrop_layout(walk)[:2]
                    if len(set(tile.tolist())) > 1:
                        facts.add("tie across kernel tiles")
                    if len(set(lane[tile == tile[0]].tolist())) > 1:
                        facts.add("tie across lanes of a kernel tile")
        if qs == 0 or ts == 0:
            facts.add("seed at 0")
        if qs == len(q) - 1 or ts == len(t) - 1:
            facts.add("seed at L-1")
        if not (0 <= qs < len(q) and 0 <= ts < len(t)):
            facts.add("seed out of range")
    if codes >= set(range(8)):
        facts.add("codes 0-7")
    return facts


def xdrop_edge_sets(rng):
    """The extender kernels' edge sets: label -> (query, target, seeds, sub,
    xdrop, plain width, what the set must reach)."""
    from genomeworks_tpu_torch.extender import DEFAULT_SCORE_MATRIX

    d = DEFAULT_SCORE_MATRIX
    g = rng.integers(0, 4, 1000).astype(np.uint8)
    L = len(g)
    ends = np.array([[0, 0], [L - 1, L - 1], [L - 64, L - 64], [L - 70, L - 70], [64, 64],
                     [70, 70], [-5, -5], [L + 3, L + 3], [-40, 10], [10, -40],
                     [L + 100, 5], [5, L + 100], [L - 1, 0], [0, L - 1]])
    # a drop of exactly xdrop = 20 that recovers, and one of 21
    exact = d.copy()
    exact[0, 0], exact[0, 1] = 10, -1
    dq = np.array([0] * 5 + [1] * 20 + [0] * 100 + [1] * 30 + [0] * 5 + [1] * 21 + [0] * 50
                  + [1] * 40, np.uint8)
    # +100 / -100 / +100: the maximum tied in a tile and across tiles
    ties = d.copy()
    ties[1, 1], ties[1, 2] = 100, -100
    tq = np.array([1] + [2, 1] * 30 + [2] * 20 + [1, 2, 1] + [2] * 20, np.uint8)
    codes = rng.integers(0, 8, 3000).astype(np.uint8)
    codes_t = rng.integers(0, 8, 3000).astype(np.uint8)
    rq, rt, rseeds = extender_inputs(rng, 20_000, *EXT_ERRORS, 3000)
    big = rng.integers(0, 4, 1_000_000).astype(np.uint8)
    mid = 500_007
    sets = xdrop_lane_sets(rng)
    return {
        "ends": (g, g, ends, d, 910, 128,
                 {"seed at 0", "seed at L-1", "seed out of range",
                  "right ends at a sequence end mid-tile",
                  "right ends at a sequence end on a tile edge",
                  "left ends at a sequence end mid-tile",
                  "left ends at a sequence end on a tile edge"}),
        "drop at xdrop": (dq, np.zeros(len(dq), np.uint8), np.array([[0, 0], [155, 155]]),
                          exact, 20, 32, {"passes a drop of exactly xdrop",
                                          "stops at a drop of xdrop + 1"}),
        "ties": (tq, np.ones(len(tq), np.uint8), np.array([[0, 0], [81, 81]]), ties, 910, 32,
                 {"tie in a tile", "tie across tiles"}),
        "codes 0-7": (codes, codes_t, np.stack([rng.integers(0, 3000, 400),
                                                rng.integers(0, 3000, 400)], 1), d, 910, 128,
                      {"codes 0-7"}),
        "xdrop 0": (rq, rt, rseeds[::10], d, 0, 128, {"xdrop 0"}),
        "random 20 kb": (rq, rt, rseeds, d, 910, 128, set()),
        "random 20 kb, xdrop 200": (rq, rt, rseeds, d, 200, 128, set()),
        "1 Mbp self": (big, big, np.array([[mid, mid]]), d, 910, 1 << 16,
                       {"right reaches its sequence end", "left reaches its sequence end"}),
        **sets,
    }


def xdrop_lane_sets(rng):
    """The edge sets of the kernel's lanes (K positions each) and tiles (32
    K): label -> (query, target, seeds, sub, xdrop, plain width, what the set
    must reach)."""
    from genomeworks_tpu_torch.extender import DEFAULT_SCORE_MATRIX
    from genomeworks_tpu_torch.ops.xdrop_cuda import LANE_POSITIONS as K

    d = DEFAULT_SCORE_MATRIX
    tile = 32 * K
    # two query mismatches (-114 each) among matches (+91): at xdrop 200 a
    # walk drops on the second, at walk index a + 1 for a matches first
    reach = 2 * tile + 8
    dq = np.zeros(2 * reach + 2, np.uint8)
    dq[reach:reach + 2] = 1
    a = np.arange(reach)
    drops = np.concatenate([np.stack([reach - a, np.full(reach, 1000)], 1),
                            np.stack([reach + 2 + a, np.full(reach, 1000)], 1)])
    # +100 / -100 alternating on both sides of the seed: the maximum tied at
    # every other position over more than a kernel tile, then a drop
    ties = d.copy()
    ties[1, 1], ties[1, 2] = 100, -100
    m = tile + 8
    tq = np.array([2] * 20 + [1] + [2, 1] * m + [1] + [2, 1] * m + [2] * 20, np.uint8)
    c = 21 + 2 * m  # the second lone 1: both walks start on a +100
    # identical sequences: walks that end at the sequence ends, n = 1 .. 2 tiles
    g = rng.integers(0, 4, 1000).astype(np.uint8)
    L = len(g)
    m_ = np.arange(1, 2 * tile + 9)
    ends = np.concatenate([np.stack([L - m_, L - m_], 1), np.stack([m_, m_], 1)])
    # a match near 2^30: the cumulative score wraps int32 after two, and the
    # wrapped deficit is negative (no drop) until it climbs past xdrop again
    wrap = d.copy()
    wrap[0, 0] = (1 << 30) - 1
    z = np.zeros(300, np.uint8)
    rq, rt, rseeds = extender_inputs(rng, 20_000, *EXT_ERRORS, 3000)
    return {
        "drops at lane edges": (dq, np.zeros(2000, np.uint8), drops, d, 200, 32,
                                {"drop at a lane's first position",
                                 "drop at a lane's last position",
                                 "drop at the first position of kernel tile 1",
                                 "drop at the first position of kernel tile 2"}),
        "ties over kernel tiles": (tq, np.ones(len(tq), np.uint8), np.array([[c, c]]), ties,
                                   910, 32, {"tie across lanes of a kernel tile",
                                             "tie across kernel tiles"}),
        "ends inside lanes": (g, g, ends, d, 910, 32,
                              {f"{side} ends at a sequence end {where}{later}"
                               for side in ("right", "left")
                               for where in ("inside a lane", "on a lane's edge")
                               for later in ("", " of a later tile")}),
        "homologous runs": (rq, rt, rseeds, d, 910, 128, {"a run over 4 kernel tiles that drops"}),
        "int32 wrap": (z, z, np.array([[0, 0], [100, 100], [150, 150], [299, 299]]), wrap, 910,
                       32, {"the score wraps int32"}),
    }


def xdrop_count_sets(rng):
    """The match-count kernel's edge sets, with left and right extents given
    (not the extension's): label -> dict(q, t, qoff, toff, seeds (n, 2) of
    (query, target) positions, left, right, want). The sequences lie on the
    card at byte offsets qoff and toff of their buffers (views, whose
    data_ptr is then odd or even as the offset is); ``count_facts`` reads
    what a set reaches."""
    def codes(n, top=8):
        return rng.integers(0, top, n).astype(np.uint8)

    def matched(q, t, seeds, left, right, share=2):
        """Copy the query into the target along every ``share``-th seed's
        segment, so that most of its positions match."""
        for (qs, ts), l, r in list(zip(seeds.tolist(), left.tolist(), right.tolist()))[::share]:
            o = np.arange(-l, min(r, 3000) + 1)
            ok = (qs + o >= 0) & (qs + o < len(q)) & (ts + o >= 0) & (ts + o < len(t))
            t[ts + o[ok]] = q[qs + o[ok]]
        return t

    sets = {}
    # segment ends at every byte offset of a word, query and target misaligned
    # (a view at offset 1 against one at 2), lengths not multiples of 4,
    # codes 0-7
    q, t = codes(5003), codes(4999)
    n = 3000
    ts = rng.integers(100, 4800, n)
    seeds = np.stack([np.clip(ts + rng.integers(-7, 8, n), 0, 4900), ts], 1)
    left, right = rng.integers(0, 70, n), rng.integers(-1, 130, n)
    sets["word ends"] = dict(q=q, t=matched(q, t, seeds, left, right), qoff=1, toff=2,
                             seeds=seeds, left=left, right=right,
                             want={*(f"a segment end at byte {b} of a word" for b in range(4)),
                                   "query and target misaligned", "codes 4-7",
                                   "a length not a multiple of 4", "an odd-offset view",
                                   "the word path"})
    # segments across position 0 and across the sequences' ends
    q, t = codes(2001, 4), codes(2003, 4)
    lo = rng.integers(0, 40, 200)
    hi = rng.integers(1950, 2001, 200)
    seeds = np.concatenate([np.stack([lo, lo + rng.integers(0, 3, 200)], 1),
                            np.stack([hi, np.minimum(hi + rng.integers(0, 3, 200), 2002)], 1)])
    left = np.concatenate([lo + rng.integers(0, 30, 200), rng.integers(0, 20, 200)])
    right = np.concatenate([rng.integers(0, 30, 200), 2003 - hi + rng.integers(0, 30, 200)])
    sets["sequence ends"] = dict(q=q, t=matched(q, t, seeds, left, right), qoff=3, toff=0,
                                 seeds=seeds, left=left, right=right,
                                 want={"a segment across position 0",
                                       "a segment across a sequence end", "the clamped path",
                                       "an odd-offset view"})
    # span 0, left + right = -1, spans over 1,000 positions
    q, t = codes(20_000, 4), codes(20_000, 4)
    n = 600
    ts = rng.integers(3000, 17_000, n)
    seeds = np.stack([ts + rng.integers(-2, 3, n), ts], 1)
    left = rng.integers(0, 1500, n)
    right = np.where(np.arange(n) % 3 == 0, -left, np.where(np.arange(n) % 3 == 1, -left - 1,
                                                            rng.integers(600, 1500, n)))
    sets["spans"] = dict(q=q, t=matched(q, t, seeds, left, right), qoff=0, toff=0, seeds=seeds,
                         left=left, right=right,
                         want={"span 0", "left + right = -1", "a span over 1,000 positions"})
    # more seeds than the card runs at once
    q = codes(1_000_000, 4)
    t = q.copy()
    n = 50_000
    ts = rng.integers(0, len(q), n)
    seeds = np.stack([ts, ts], 1)
    left, right = rng.integers(0, 80, n), rng.integers(0, 80, n)
    flip = rng.random(len(t)) < 0.1
    t[flip] = (t[flip] + 1) % 4
    sets["waves"] = dict(q=q, t=t, qoff=0, toff=0, seeds=seeds, left=left, right=right,
                         want={"more seeds than one wave"})
    for spec in sets.values():
        for k in ("left", "right"):
            spec[k] = spec[k].astype(np.int32)
        spec["seeds"] = spec["seeds"].astype(np.int32)
    return sets


def count_facts(spec, qaddr, taddr, wave):
    """What a count set reaches, from its inputs and the byte addresses mod 4
    of its sequences on the card (``qaddr``, ``taddr``): where segments end
    in a word, the kernel's two read paths (``xdrop_count_kernel``: words
    where the seed's window, 3 bytes before it and 4 after, lies in both
    sequences), spans, lengths, views, codes, and more seeds than ``wave``
    (the seeds the card runs at once)."""
    from genomeworks_tpu_torch.ops.xdrop_cuda import COUNT_LANES, LANE_POSITIONS

    q, t = spec["q"], spec["t"]
    Lq, Lt = len(q), len(t)
    qs, ts = (spec["seeds"][:, i].astype(np.int64) for i in (0, 1))
    left, right = spec["left"].astype(np.int64), spec["right"].astype(np.int64)
    span = left + right
    t0, q0 = ts - left, qs - left
    lo = np.maximum(0, np.maximum(-t0, -q0))
    hi = np.minimum(span, np.minimum(Lt - 1 - t0, Lq - 1 - q0))
    live = hi >= lo
    facts = set()
    npos = np.where(live, hi - lo + 1, 0)
    tlo, qlo = t0 + lo, q0 + lo
    for b in np.unique((taddr + tlo + npos - 1)[live] % 4).tolist():
        facts.add(f"a segment end at byte {b} of a word")
    if ((taddr + tlo - qaddr - qlo)[live] % 4 != 0).any():
        facts.add("query and target misaligned")
    passes = -(-npos // (COUNT_LANES * LANE_POSITIONS))
    words = (tlo >= 3) & (qlo >= 3) & (tlo + passes * COUNT_LANES * LANE_POSITIONS + 4 <= Lt) \
        & (qlo + passes * COUNT_LANES * LANE_POSITIONS + 4 <= Lq)
    if (words & live).any():
        facts.add("the word path")
    if (~words & live).any():
        facts.add("the clamped path")
    if ((t0 < 0) | (q0 < 0))[live].any():
        facts.add("a segment across position 0")
    if ((t0 + span >= Lt) | (q0 + span >= Lq))[live].any():
        facts.add("a segment across a sequence end")
    if (span == 0).any():
        facts.add("span 0")
    if (span == -1).any():
        facts.add("left + right = -1")
    if (span > 1000).any():
        facts.add("a span over 1,000 positions")
    if Lq % 4 or Lt % 4:
        facts.add("a length not a multiple of 4")
    if qaddr % 2 or taddr % 2:
        facts.add("an odd-offset view")
    for i in np.flatnonzero(live)[:2000]:
        o = np.arange(lo[i], hi[i] + 1)
        a, b = t[t0[i] + o], q[q0[i] + o]
        if ((a == b) & (a >= 4)).any():
            facts.add("codes 4-7")
            break
    if len(qs) > wave:
        facts.add("more seeds than one wave")
    return facts


def count_compare(spec, dev):
    """One count set on ``dev``: the sequences copied to the card at their
    offsets, the kernel against ``count_matches_plain`` bit for bit
    (``compare`` fails the run). Returns the facts it reached."""
    from genomeworks_tpu_torch.extender.xdrop_plain import count_matches_plain
    from genomeworks_tpu_torch.ops.xdrop_cuda import COUNT_LANES, xdrop_count_cuda

    def placed(a, off):
        buf = torch.zeros(len(a) + off, dtype=torch.uint8, device=dev)
        buf[off:] = torch.from_numpy(a).to(dev)
        return buf[off:]

    qd, td = placed(spec["q"], spec["qoff"]), placed(spec["t"], spec["toff"])
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (spec["seeds"][:, 0], spec["seeds"][:, 1], spec["left"], spec["right"])]
    compare("xdrop_count on a count set", (xdrop_count_cuda(qd, td, *args),),
            (count_matches_plain(qd, td, *args),))
    props = torch.cuda.get_device_properties(dev)
    wave = props.multi_processor_count * props.max_threads_per_multi_processor // COUNT_LANES
    return count_facts(spec, qd.data_ptr() % 4, td.data_ptr() % 4, wave)


def myers_score_edge_sets(rng, tmax=16):
    """The batched Myers kernel's edge sets, one launch each: label ->
    (queries, targets). Query lengths 0, 1 and 32 j +- 1 bases for j = 1 ..
    32 x 16 + 1 (up to 16,417 bases, 514 words), grouped by the words a lane
    of a launch over their words ("npl k": n_words in (32 (k - 1), 32 k]) and
    past 32 x 16 words ("chunked", two chunks of 32 x 16 words); then "3-4
    chunks": 0, 1 and the edges of the second, third and fourth chunks
    (32,767 to 49,153 bases, 40,000 among them), whose middle chunks read
    the carries of the chunk below while they store their own. Each launch
    has 0 and 1, and an empty target. Targets are at most ``tmax`` bases
    (the chunked launches' up to 100, over several 32-position groups of
    the carry scratch): the query's start with 10 % substitutions,
    or random."""
    from genomeworks_tpu_torch.ops.myers_score_cuda import MAX_WORDS_PER_LANE as MAX_NPL

    lengths = sorted({0, 1} | {32 * j + d for j in range(1, 32 * MAX_NPL + 2)
                               for d in (-1, 1)})

    def npl(n):
        words = max(1, -(-n // 32))
        return min(-(-words // 32), MAX_NPL + 1)

    def targets(qs, top):
        ts = []
        for i, q in enumerate(qs):
            m = top if i == len(qs) - 1 else int(rng.integers(1, top + 1))
            if i % 2 and q:
                t = np.frombuffer(q[:m].encode(), np.uint8).copy()
                flip = rng.random(len(t)) < 0.1
                t[flip] = BASES[rng.integers(0, 4, int(flip.sum()))]
                ts.append(t.tobytes().decode())
            else:
                ts.append("".join(BASES[rng.integers(0, 4, m)].astype("U1")))
        ts[len(ts) // 2] = ""
        return ts

    groups: dict = {}
    for n in lengths:
        groups.setdefault(npl(n), []).append(n)
    sets = {}
    for k, ns in sorted(groups.items()):
        ns = sorted(set(ns) | {0, 1})
        top = 100 if k > MAX_NPL else tmax
        qs = ["".join(BASES[rng.integers(0, 4, n)].astype("U1")) for n in ns]
        sets["chunked" if k > MAX_NPL else f"npl {k}"] = (qs, targets(qs, top))
    cw = 32 * 32 * MAX_NPL  # bases a chunk
    ns = [0, 1, 2 * cw - 1, 2 * cw, 2 * cw + 1, 40_000, 3 * cw, 3 * cw + 1]
    qs = ["".join(BASES[rng.integers(0, 4, n)].astype("U1")) for n in ns]
    sets["3-4 chunks"] = (qs, targets(qs, 100))
    return sets


def myers_chunks(qlen):
    """The chunks of 32 x MAX_WORDS_PER_LANE words that myers_score_kernel
    runs a query of ``qlen`` bases in (an array)."""
    from genomeworks_tpu_torch.ops.myers_score_cuda import MAX_WORDS_PER_LANE as MAX_NPL

    words = np.maximum(-(-np.asarray(qlen, np.int64) // 32), 1)
    return -(-words // (32 * MAX_NPL))


def ssp_lines(ssps):
    """The sample's lines for a list of SSPs."""
    return [str(s) for s in ssps[:10]] + [f"{len(ssps)} scored segment pairs"]


def myers_cpu_job(pair):
    from genomeworks_tpu_torch.aligner.myers import myers_edit_distance_cpu

    q, t = pair
    return myers_edit_distance_cpu(t, q)


def myers_plain_job(pairs):
    """myers_score_plain on the host CPU (one thread) over a chunk of pairs,
    as the batch packs them: (its output, seconds)."""
    from genomeworks_tpu_torch.aligner.myers import myers_inputs, myers_score_plain

    torch.set_num_threads(1)
    peq, tc, ql, tl = myers_inputs([p[0] for p in pairs], [p[1] for p in pairs])
    t0 = time.perf_counter()
    out = myers_score_plain(*(torch.from_numpy(a) for a in (peq.view(np.int32), tc, ql, tl)))
    return out, time.perf_counter() - t0


def extender_phase(dev):
    """Phase 11: the extender's kernels against their plain versions, its
    main path over a 10 Mbp pair, the sample, and the batched Myers
    distance. Every gate fails the run; returns the kernels line's entries."""
    import io
    import tempfile
    from contextlib import redirect_stdout

    from genomeworks_tpu_torch.aligner import myers as myers_mod
    from genomeworks_tpu_torch.core.sequence import encode_bases
    from genomeworks_tpu_torch.aligner.myers import (
        myers_edit_distance_batched, myers_edit_distance_cpu, myers_inputs, myers_score_plain,
    )
    from genomeworks_tpu_torch.extender import DEFAULT_SCORE_MATRIX, create_extender
    from genomeworks_tpu_torch.extender import xdrop_plain
    from genomeworks_tpu_torch.io import native
    from genomeworks_tpu_torch.ops import myers_score_cuda, xdrop_cuda
    from genomeworks_tpu_torch.samples import sample_extender

    t_phase = time.perf_counter()
    plains = (xdrop_plain.xdrop_extend_plain, xdrop_plain.extend_direction_plain,
              xdrop_plain.count_matches_plain, myers_score_plain)
    rng = np.random.default_rng(2025)
    short = random_pairs(rng, 1024, 2000, 0.04, 0.01, 0.01)  # phase 5's 2-kb pairs
    workers = min(8, os.cpu_count() or 1)
    pool = ProcessPoolExecutor(max_workers=workers,
                               mp_context=multiprocessing.get_context("spawn"))
    # the Myers kernel's edge sets (words a lane 1-16, two chunks, one to
    # four chunks), their plain word chains on the host CPU; the longest
    # chain (one to four chunks, some 30 s) first, beside the others
    myers_sets = myers_score_edge_sets(np.random.default_rng(14))
    longest = "3-4 chunks"
    longest_job = pool.submit(myers_plain_job, list(zip(*myers_sets[longest])))
    oracle_jobs = pool.map(myers_cpu_job, short[:32])
    # the plain word chain is a host loop of some 20 ops a word a target
    # position whatever the batch: on the card 2.6 M launches (93 s); on the
    # host CPU, meanwhile, one job on each other process
    step = -(-len(short) // max(1, workers - 1))
    pair_chunks = [short[i:i + step] for i in range(0, len(short), step)]
    plain_jobs = pool.map(myers_plain_job, pair_chunks)
    myers_set_jobs = pool.map(myers_plain_job, [list(zip(*v)) for k, v in myers_sets.items()
                                                if k != longest])

    def tensors(q, t, seeds, sub):
        return (torch.from_numpy(np.ascontiguousarray(q, np.uint8)).to(dev),
                torch.from_numpy(np.ascontiguousarray(t, np.uint8)).to(dev),
                torch.from_numpy(seeds[:, 0].astype(np.int32)).to(dev),
                torch.from_numpy(seeds[:, 1].astype(np.int32)).to(dev),
                torch.from_numpy(np.asarray(sub, np.int32).reshape(-1).copy()).to(dev))

    # -- 11a. the extender's kernels against their plain versions ------------------
    for label, (q, t, seeds, sub, xd, width, want) in xdrop_edge_sets(
            np.random.default_rng(12)).items():
        qd, td, qp, tp, sd = tensors(q, t, seeds, sub)
        k = xdrop_cuda.xdrop_extend_cuda(qd, td, qp, tp, sd, xd)
        p = xdrop_plain.xdrop_extend_plain(qd, td, qp, tp, sd, xd, width)
        compare(f"xdrop_extend on {label}", (k,), (p,))
        kc = xdrop_cuda.xdrop_count_cuda(qd, td, qp, tp, k[:, 3].contiguous(),
                                         k[:, 1].contiguous())
        pc = xdrop_plain.count_matches_plain(qd, td, qp, tp, p[:, 3].contiguous(),
                                             p[:, 1].contiguous(), width)
        compare(f"xdrop_count on {label}", (kc,), (pc,))
        facts = xdrop_facts(q, t, seeds, sub, xd, p.cpu().numpy())
        if not want <= facts:
            fail(f"the extender edge set {label!r} did not reach {sorted(want - facts)}")
        print(f"check xdrop {label}: {len(seeds)} seeds, both kernels == plain (width "
              f"{width}) == the NumPy replay; reaches {sorted(want)}")

    # the count kernel's own sets: crafted extents, views, ends and waves
    for label, spec in xdrop_count_sets(np.random.default_rng(15)).items():
        facts = count_compare(spec, dev)
        if not spec["want"] <= facts:
            fail(f"the count set {label!r} did not reach {sorted(spec['want'] - facts)}")
        print(f"check xdrop_count {label}: {len(spec['seeds'])} seeds, kernel == plain; reaches "
              f"{sorted(spec['want'])}")

    # a 10 Mbp genome against itself, a seed on the main diagonal: the maximum
    # sits at both sequence ends and each side's score is its diagonal's sum
    rng = np.random.default_rng(2027)
    query, target, seeds = extender_inputs(rng, EXT_GENOME, *EXT_ERRORS, EXT_SEEDS)
    sub_np = np.asarray(DEFAULT_SCORE_MATRIX, np.int64)
    s = EXT_GENOME // 3
    diag = sub_np[target, target]
    want = [int(diag[s:].sum()), EXT_GENOME - 1 - s, int(diag[:s].sum()), s]
    td, _, qp, tp, sd = tensors(target, target, np.array([[s, s]]), DEFAULT_SCORE_MATRIX)
    long_ms, k = cuda_ms(lambda: xdrop_cuda.xdrop_extend_cuda(td, td, qp, tp, sd, 910))
    if k[0].tolist() != want:
        fail(f"the 10 Mbp self seed gave {k[0].tolist()}, the closed form {want}")
    print(f"check xdrop 10 Mbp self seed: kernel == closed form {want}; {long_ms:.3f} ms")

    # -- 11b. the main path -------------------------------------------------------
    print(f"extender main path: {EXT_GENOME} bp target, {len(query)} bp query, "
          f"{len(seeds)} seeds (made in {time.perf_counter() - t_phase:.1f} s)", flush=True)
    kernels = (xdrop_cuda.xdrop_extend_cuda, xdrop_cuda.xdrop_count_cuda)

    def run(seed_pairs, device, q=query, t=target):
        ex = create_extender(device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.extend_async(q, t, EXT_THRESHOLD, seed_pairs)
        ex.sync()
        ssps = ex.get_scored_segment_pairs()
        if device == "cuda":
            torch.cuda.synchronize()
        return ssps, time.perf_counter() - t0, ex

    for k in kernels:
        k.launches = 0
    for p in plains:
        p.calls = 0
    torch.cuda.reset_peak_memory_stats()
    ssps, wall0, ex = run(seeds, "cuda")
    launches = {k.__name__: k.launches for k in kernels}
    calls = sum(p.calls for p in plains)
    peak = torch.cuda.max_memory_allocated()
    batches = -(-len(seeds) // ex.batch_max)
    if launches["xdrop_extend_cuda"] != batches or launches["xdrop_count_cuda"] <= 0 or calls:
        fail(f"the extender's main path launched {launches} for {batches} batches and called "
             f"a plain version {calls} times")
    again, wall, _ = run(seeds, "cuda")
    if [a.astuple() for a in again] != [a.astuple() for a in ssps]:
        fail("two device runs of the extender gave different lists")
    Lq, Lt = len(query), len(target)
    for a in ssps:
        if not (0 <= a.query_position_in_read and a.query_position_in_read + a.length < Lq
                and 0 <= a.target_position_in_read and a.target_position_in_read + a.length < Lt
                and a.score >= EXT_THRESHOLD):
            fail(f"an SSP outside the sequences or under the threshold: {a}")
    check = seeds[:EXT_CHECK]
    dev_check, _, _ = run(check, "cuda")
    cpu_check, cpu_wall, _ = run(check, "cpu")
    if [a.astuple() for a in dev_check] != [a.astuple() for a in cpu_check]:
        fail(f"the first {EXT_CHECK} seeds: the device list ({len(dev_check)}) differs from "
             f"the CPU path's ({len(cpu_check)})")
    busy_ms, prof_wall, by_name = profiled(lambda: run(seeds, "cuda"))
    dev_ms = by_kernel(by_name)
    print(f"extender main path: {len(ssps)} SSPs ({ex.rescored} seeds rescored by the entropy), "
          f"two device runs equal, every SSP within both sequences and at least "
          f"{EXT_THRESHOLD}; the first {EXT_CHECK} seeds: device == CPU path ({len(cpu_check)} "
          f"SSPs, CPU {cpu_wall:.3f} s); launches {launches}, {calls} plain-version calls; "
          f"warm wall {wall:.4f} s ({len(seeds) / wall:.1f} seeds/s; first run {wall0:.4f} "
          f"s); peak device memory {peak / 2**30:.3f} GiB; profiled: {prof_wall * 1e3:.3f} ms "
          f"wall, device busy {busy_ms:.3f} ms ({100 * busy_ms / (prof_wall * 1e3):.2f} %), "
          f"xdrop_extend_kernel {dev_ms.get('xdrop_extend_kernel', 0.0):.3f} ms, "
          f"xdrop_count_kernel {dev_ms.get('xdrop_count_kernel', 0.0):.3f} ms", flush=True)

    # -- 11c. the sample ------------------------------------------------------------
    from genomeworks_tpu_torch.simulators.genomesim import _BASES

    with tempfile.TemporaryDirectory() as tmp:
        fa, csv = os.path.join(tmp, "genome.fa"), os.path.join(tmp, "seeds.csv")
        with open(fa, "w") as f:
            f.write(">genome\n" + _BASES[target].tobytes().decode() + "\n")
        np.savetxt(csv, check[:, ::-1], fmt="%d", delimiter=",")
        out = io.StringIO()
        t0 = time.perf_counter()
        with redirect_stdout(out):
            sample_extender.main([fa, csv])
        sample_wall = time.perf_counter() - t0
    self_cpu, _, _ = run(check, "cpu", q=target, t=target)
    if out.getvalue().splitlines() != ssp_lines(self_cpu):
        fail("the sample's lines differ from the CPU path's on the same genome and seeds")
    print(f"sample_extender on the card: {out.getvalue().splitlines()[-1]}, its lines == the "
          f"CPU path's on the genome against itself; {sample_wall:.2f} s (FASTA through the "
          f"{'native' if native.native_available() else 'Python'} parser)")

    # the kernels at the main path's shapes, for the kernels line
    qd, td, qp, tp, sd = tensors(query, target, seeds[: ex.batch_max], DEFAULT_SCORE_MATRIX)
    ext_ms, ext = cuda_ms(lambda: xdrop_cuda.xdrop_extend_cuda(qd, td, qp, tp, sd, 910), 3)
    e = ext.to(torch.int64)
    total = e[:, 0] + e[:, 2]
    nz = torch.nonzero((total >= EXT_THRESHOLD) & (total <= 3 * EXT_THRESHOLD)).squeeze(1)
    cargs = (qd, td, qp[nz], tp[nz], ext[nz, 3].contiguous(), ext[nz, 1].contiguous())
    cnt_ms, _ = cuda_ms(lambda: xdrop_cuda.xdrop_count_cuda(*cargs), 3)
    extended = int((e[:, 1] + 1 + e[:, 3]).sum())
    counted = int((e[nz, 1] + e[nz, 3] + 1).clamp(min=0).sum())
    cq, ct, cqp, ctp, csd = tensors(query, target, check, DEFAULT_SCORE_MATRIX)
    ck_ms, ck = cuda_ms(lambda: xdrop_cuda.xdrop_extend_cuda(cq, ct, cqp, ctp, csd, 910))
    cp_ms, cp = cuda_ms(lambda: xdrop_plain.xdrop_extend_plain(cq, ct, cqp, ctp, csd, 910))
    compare("xdrop_extend on the check seeds", (ck,), (cp,))
    ctot = ck[:, 0].to(torch.int64) + ck[:, 2]
    cnz = torch.nonzero((ctot >= EXT_THRESHOLD) & (ctot <= 3 * EXT_THRESHOLD)).squeeze(1)
    cc = (cq, ct, cqp[cnz], ctp[cnz], ck[cnz, 3].contiguous(), ck[cnz, 1].contiguous())
    cck_ms, kc = cuda_ms(lambda: xdrop_cuda.xdrop_count_cuda(*cc))
    ccp_ms, pc = cuda_ms(lambda: xdrop_plain.count_matches_plain(*cc))
    compare("xdrop_count on the check seeds", (kc,), (pc,))
    seq_bytes = len(query) + len(target) + 256
    ext_bytes = seq_bytes + ex.batch_max * (8 + 16)
    cnt_bytes = seq_bytes + len(nz) * (16 + 16)
    print(f"xdrop kernels at the main path's first batch ({ex.batch_max} seeds): extend "
          f"{ext_ms:.4f} ms over {extended} positions to the maxima, count {cnt_ms:.4f} ms over "
          f"{len(nz)} seeds and {counted} positions; on the first {EXT_CHECK} seeds: extend "
          f"{ck_ms:.4f} ms (plain on the card {cp_ms:.1f} ms), count {cck_ms:.4f} ms (plain "
          f"{ccp_ms:.1f} ms)", flush=True)

    # -- 11d. the batched Myers distance ------------------------------------------
    edges_q = ["", "", "A", "ACGTACGTACGTACGTACGTACGTACGTACG"]
    lengths = [32, 33, 63, 64, 65, 95, 96, 97, 128, 129]
    erng = np.random.default_rng(13)
    edges_q += ["".join(erng.choice(list("ACGT"), n)) for n in lengths]
    edges_t = ["ACGT", "", "", "ACGTTCGTACGAACGTACGTTTACGTACGTACG"]
    edges_t += [BASES[mutated(erng, encode_bases(s), 0.1, 0.05, 0.05)].tobytes().decode()
                for s in edges_q[4:]]
    peq, tc, ql, tl = myers_inputs(edges_q, edges_t)
    margs = [torch.from_numpy(a).to(dev) for a in (peq.view(np.int32), tc, ql, tl)]
    mk = myers_score_cuda.myers_score_cuda(*margs)
    compare("myers_score on the empty queries and word edges", (mk,),
            (myers_score_plain(*margs),))
    got = myers_edit_distance_batched(edges_q, edges_t, device="cuda").tolist()
    if got != [myers_edit_distance_cpu(t, q) for q, t in zip(edges_q, edges_t)]:
        fail("myers_edit_distance_batched differs from myers_edit_distance_cpu on the empty "
             "queries and word edges")
    print("check myers_score on empty queries and word edges: kernel == plain (on the card); "
          "the batched distances == myers_edit_distance_cpu")
    # the Myers kernel's edge sets: every words-a-lane instantiation and the
    # chunked queries, one launch each, against the plain chains on the host
    mlib = myers_score_cuda.load_library()
    seen = set()
    set_plain = dict(zip([k for k in myers_sets if k != longest], myers_set_jobs))
    set_plain[longest] = longest_job.result()
    for label, (qs, ts) in myers_sets.items():
        want = set_plain[label][0]
        peq, tc, ql, tl = myers_inputs(qs, ts)
        margs = [torch.from_numpy(a).to(dev) for a in (peq.view(np.int32), tc, ql, tl)]
        compare(f"myers_score on {label}", (myers_score_cuda.myers_score_cuda(*margs),),
                (want.to(dev),))
        npl = mlib.myers_score_words_per_lane(peq.shape[2])
        chunks = set(myers_chunks(ql).tolist())
        seen.add("3-4 chunks" if chunks >= {1, 2, 3, 4} else
                 "chunked" if myers_score_cuda.chunked(peq.shape[2]) else f"npl {npl}")
    if seen != set(myers_sets):
        fail(f"the Myers edge sets reached {sorted(seen)}, not {sorted(myers_sets)}")
    print(f"check myers_score on its edge sets: {len(myers_sets)} launches (words a lane 1-"
          f"{myers_score_cuda.MAX_WORDS_PER_LANE}, two chunks, and one to four chunks with "
          f"queries up to {max(len(q) for q in myers_sets['3-4 chunks'][0])} bases, an empty "
          f"target in each): kernel == plain (on the host CPU)")
    peq, tc, ql, tl = myers_inputs([p[0] for p in short], [p[1] for p in short])
    margs = [torch.from_numpy(a).to(dev) for a in (peq.view(np.int32), tc, ql, tl)]
    mk = myers_score_cuda.myers_score_cuda(*margs)
    mk_ms, _ = cuda_ms(lambda: myers_score_cuda._launch(mlib, *margs), 3)
    plain_out = list(plain_jobs)
    mp_ms = 1e3 * sum(sec for _, sec in plain_out)
    compare("myers_score on phase 5's 1024 pairs of 2 kb", (mk,),
            (torch.cat([o for o, _ in plain_out]).to(dev),))
    print(f"check myers_score on phase 5's 1024 pairs of 2 kb: kernel == plain (on the host "
          f"CPU, {len(pair_chunks)} chunks of {step}, one process a core); kernel {mk_ms:.3f} ms, plain "
          f"{mp_ms:.1f} ms of host CPU in all", flush=True)
    words = np.maximum((ql.astype(np.int64) - 1) // 32, 0) + 1
    myers_ops = MYERS_SCORE_WORD_OPS * int((words * tl).sum())
    myers_bytes = peq.nbytes + tc.nbytes + ql.nbytes + tl.nbytes + 4 * len(ql)
    myers_score_cuda.myers_score_cuda.launches = 0
    myers_mod.myers_score_plain.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist = myers_edit_distance_batched([p[0] for p in short], [p[1] for p in short],
                                       device="cuda")
    myers_wall = time.perf_counter() - t0
    myers_launches = myers_score_cuda.myers_score_cuda.launches
    if myers_launches != 1 or myers_mod.myers_score_plain.calls:
        fail(f"myers_edit_distance_batched launched {myers_launches} times and called the "
             f"plain version {myers_mod.myers_score_plain.calls} times")
    oracle = list(oracle_jobs)
    pool.shutdown()
    if dist[:32].tolist() != oracle:
        fail("myers_edit_distance_batched differs from myers_edit_distance_cpu on the 2-kb "
             "pairs")
    print(f"myers_edit_distance_batched main path: 1024 pairs of 2 kb, {myers_wall:.4f} s "
          f"wall, {myers_launches} launch, no plain call; the first 32 == "
          f"myers_edit_distance_cpu (host, one process per core)")
    print(f"slice 12's kernels (PERF.md's figures, not measured in this run): "
          f"{SLICE12_PERF_MD}")

    def bound(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / SCALAR_OPS_PER_S * 1e3
        return {"bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to else "operations"}

    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s", flush=True)
    common = {"route": "cuda", "state": "added in slice 12", "max_abs_err": 0,
              "library_ms": None}
    redesigned = {**common, "state": "redesigned in slice 14"}
    return [{
        "name": "xdrop_extend_cuda", **redesigned, "source": XDROP_SOURCE,
        "lane_positions": xdrop_cuda.LANE_POSITIONS,
        "replaces": "none (XLA in the JAX package: genomeworks_tpu/extender/xdrop.py:220)",
        "launches": launches["xdrop_extend_cuda"], "ms": ext_ms, "plain_ms": cp_ms,
        **bound(ext_bytes, XDROP_POS_OPS * extended),
        "timed_on": f"the main path's first batch, {ex.batch_max} seeds",
        "plain_timed_on": f"the first {EXT_CHECK} seeds (kernel {ck_ms:.4f} ms)",
        "self_10mbp_ms": long_ms, "main_path_s": wall, "seeds_per_s": len(seeds) / wall,
        "device_ms_main_path": dev_ms.get("xdrop_extend_kernel", 0.0),
    }, {
        "name": "xdrop_count_cuda", **common, "state": "redesigned in slice 15",
        "source": XDROP_SOURCE, "count_lanes": xdrop_cuda.COUNT_LANES,
        "replaces": "none (XLA in the JAX package: genomeworks_tpu/extender/xdrop.py:257)",
        "launches": launches["xdrop_count_cuda"], "ms": cnt_ms, "plain_ms": ccp_ms,
        **bound(cnt_bytes, XCOUNT_POS_OPS * counted),
        "timed_on": f"the first batch's {len(nz)} seeds that need the entropy",
        "plain_timed_on": f"the first {EXT_CHECK} seeds' {len(cnz)} (kernel {cck_ms:.4f} ms)",
        "device_ms_main_path": dev_ms.get("xdrop_count_kernel", 0.0),
    }, {
        "name": "myers_score_cuda", **redesigned, "source": MYERS_SCORE_SOURCE,
        "replaces": "none (XLA in the JAX package: genomeworks_tpu/aligner/myers.py:106)",
        "launches": myers_launches, "ms": mk_ms, "plain_ms": mp_ms,
        **bound(myers_bytes, myers_ops),
        "timed_on": "phase 5's 1024 pairs of 2 kb, the launch alone (no input checks)",
        "plain_timed_on": f"the same pairs on the host CPU, {len(pair_chunks)} chunks of {step} "
                          "pairs, one thread each (the sum)", "main_path_s": myers_wall,
    }]


# -- slice 13: the multi-device layer ------------------------------------------------

#: run (b)'s subset of the main path: the first covid windows and mapper reads
MD_WINDOWS = 1024
MD_READS = 500
#: the multi-process mapping's index budget (MB) on the subset: 5 ranges, 15
#: index pairs, so the round robin splits them
MD_INDEX_MB = 1
#: the seconds a run (b) rank may take, and its process group's timeout
MD_TIMEOUT = 240


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def md_pairs():
    """Phase 5's 1024 pairs of 2 kb, packed (on the host) as the aligner
    packs their bucket, and the band ``create_aligner(max_bandwidth=1024)``
    gives them first (the largest over the pairs): (q, t, qlen, tlen, W,
    pairs)."""
    from genomeworks_tpu_torch.aligner import create_aligner
    from genomeworks_tpu_torch.aligner.aligner import pack_pairs, pack_shape
    from genomeworks_tpu_torch.core.bucketing import next_pow2

    pairs = random_pairs(np.random.default_rng(2025), 1024, 2000, 0.04, 0.01, 0.01)
    a = create_aligner(max_bandwidth=1024, device="cpu")
    for qs, ts in pairs:
        a.add_alignment(qs, ts)
    W = max(next_pow2(min(a._initial_band(e), a._full_band(e))) for e in a._entries)
    q, t, qlen, tlen = (x.numpy() for x in pack_pairs(pairs, *pack_shape(pairs, 2048), "cpu"))
    return q, t, qlen, tlen, W, pairs


def md_counted(fn):
    """fn() with the counts of the sharded paths' kernels and plain versions
    set to 0 just before: (its result, wall s, launches by kernel, plain
    calls)."""
    from genomeworks_tpu_torch.aligner.banded_nw import (
        banded_nw_final_plain, banded_nw_forward_plain,
    )
    from genomeworks_tpu_torch.ops.banded_nw_cuda import banded_nw_cuda
    from genomeworks_tpu_torch.ops.poa_cuda import poa_consensus_cuda
    from genomeworks_tpu_torch.poa.torch_poa import poa_consensus_plain

    kernels = (poa_consensus_cuda, banded_nw_cuda)
    plains = (poa_consensus_plain, banded_nw_forward_plain, banded_nw_final_plain)
    for k in kernels:
        k.launches = 0
    for p in plains:
        p.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {k.__name__: k.launches for k in kernels}, sum(p.calls for p in plains)


def md_subset(mesh, covid, small_fasta):
    """The sharded paths on run (b)'s subset on ``mesh``: POA on the first
    MD_WINDOWS covid windows, the aligner step on phase 5's 1024 pairs of
    2 kb, ``map_reads_sharded`` and ``map_reads_multihost`` (MD_INDEX_MB
    index ranges) on the first MD_READS reads. Returns (results, launches,
    plain calls); the move codes as a digest."""
    import dataclasses
    import hashlib

    from genomeworks_tpu_torch.io import create_fasta_parser
    from genomeworks_tpu_torch.mapper import MapperParams
    from genomeworks_tpu_torch.parallel.multihost import map_reads_multihost
    from genomeworks_tpu_torch.parallel.sharded import (
        aligner_step_sharded, poa_batch_consensus_sharded,
    )
    from genomeworks_tpu_torch.parallel.sharded_mapper import map_reads_sharded

    q, t, qlen, tlen, W, _ = md_pairs()
    parser = create_fasta_parser(small_fasta)
    # no filtering: at 1e-5 an index of 1 MB filters every representation
    params = MapperParams(index_size_mb=MD_INDEX_MB, target_index_size_mb=MD_INDEX_MB,
                          filtering_parameter=1.0)

    def run():
        poa = poa_batch_consensus_sharded(covid[:MD_WINDOWS], mesh)
        final, codes, fits = aligner_step_sharded(mesh, q, t, qlen, tlen, W)
        sharded = map_reads_sharded(parser, parser, mesh, all_to_all=True)
        multi = map_reads_multihost(parser, parser, params, device=mesh.device)
        return poa, (final, codes, fits), sharded, multi

    (poa, (final, codes, fits), sharded, multi), wall, launches, calls = md_counted(run)
    return {
        "poa": (poa[0], [c.tolist() for c in poa[1]], poa[2]),
        "final": final.cpu(), "fits": fits.cpu(), "codes_shape": tuple(codes.shape),
        "codes_sha256": hashlib.sha256(codes.cpu().numpy().tobytes()).hexdigest(),
        "sharded": [dataclasses.astuple(o) for o in sharded],
        "multi": [dataclasses.astuple(o) for o in multi],
        "wall": wall, "W": W,
    }, launches, calls


def multi_device_rank(rank, world, port, tmp) -> int:
    """One rank of phase 12's run (b): a gloo group of ``world`` ranks, every
    rank computing on card 0, gathering through host tensors; runs
    ``md_subset`` and writes its results to ``tmp``/rank<rank>.pt."""
    from datetime import timedelta

    import torch.distributed as dist

    from genomeworks_tpu_torch.parallel.mesh import make_mesh
    from genomeworks_tpu_torch.parallel.multihost import initialize_distributed
    from genomeworks_tpu_torch.poa.windows import load_window_file

    rank, world = int(rank), int(world)
    if not initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo",
                                  timeout=timedelta(seconds=MD_TIMEOUT)):
        raise RuntimeError("run (b) needs more than one rank")
    try:
        mesh = make_mesh()
        if (mesh.rank, mesh.size, mesh.device.type, mesh.comm_device.type) != \
                (rank, world, "cuda", "cpu"):
            raise RuntimeError(f"rank {rank}: unexpected mesh {mesh}")
        covid = load_window_file(os.path.join(DATA, "poa_windows_covid.txt.gz"))[:MD_WINDOWS]
        out, launches, calls = md_subset(mesh, covid, os.path.join(tmp, "small.fa"))
        torch.save({"out": out, "launches": launches, "calls": calls},
                   os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def multi_device_phase(dev, covid, golden, reads, smi):
    """Phase 12: the multi-device layer (slice 13). Run (a): a one-rank NCCL
    group on this card, every sharded path at full size against its
    single-device path; run (b): two gloo ranks in two processes on this
    card, on a subset, against run (a). Returns (run (a)'s launches on the
    full-size paths, its launches on the subset, run (b)'s by rank)."""
    import dataclasses
    import hashlib
    import shutil
    import tempfile
    from datetime import timedelta

    import torch.distributed as dist

    from genomeworks_tpu_torch.aligner.banded_nw import (
        band_offset, banded_nw_final_plain, unpack_codes,
    )
    from genomeworks_tpu_torch.aligner.cpu_reference import align_cpu
    from genomeworks_tpu_torch.aligner.rle_traceback import rle_traceback_plain
    from genomeworks_tpu_torch.io import create_fasta_parser, write_fasta
    from genomeworks_tpu_torch.mapper import MapperParams, map_reads
    from genomeworks_tpu_torch.mapper.device_pipeline import (
        build_index_device, get_overlaps_device_pipeline,
    )
    from genomeworks_tpu_torch.ops.banded_nw_cuda import banded_nw_cuda
    from genomeworks_tpu_torch.parallel.mesh import make_mesh
    from genomeworks_tpu_torch.parallel.multihost import map_reads_multihost
    from genomeworks_tpu_torch.parallel.sharded import (
        anchor_count_allreduce, matcher_sharded_counts, poa_batch_consensus_sharded,
    )
    from genomeworks_tpu_torch.parallel.sharded_mapper import map_reads_sharded
    from genomeworks_tpu_torch.poa.torch_poa import poa_batch_consensus

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="gw_md_")
    procs = []
    try:
        small, full = os.path.join(tmp, "small.fa"), os.path.join(tmp, "full.fa")
        write_fasta(reads[:MD_READS], small)
        write_fasta(reads, full)
        q, t, qlen, tlen, W, pairs = md_pairs()

        # -- 12a. one NCCL rank on this card ----------------------------------------
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                                world_size=1, rank=0, timeout=timedelta(seconds=60))
        try:
            mesh = make_mesh()
            if (mesh.size, mesh.comm_device.type, dist.get_backend()) != (1, "cuda", "nccl"):
                fail(f"run (a): unexpected mesh {mesh}")
            res_a, sub_launches, sub_calls = md_subset(mesh, covid, small)
            full_parser = create_fasta_parser(full)
            params = MapperParams(filtering_parameter=1.0)

            def full_paths():
                cons = poa_batch_consensus_sharded(covid, mesh)
                rq = np.sort(np.random.default_rng(5).integers(0, 1 << 30, 1 << 20))
                rt = np.sort(np.random.default_rng(6).integers(0, 1 << 30, 1 << 22))
                counts = (matcher_sharded_counts(mesh, rq, rt),
                          anchor_count_allreduce(mesh, np.arange(1 << 16, dtype=np.int64)),
                          rq, rt)
                return cons, counts

            (cons_a, counts), _, full_launches, full_calls = md_counted(full_paths)
            (sharded_full, sharded_wall, map_launches, map_calls) = md_counted(
                lambda: map_reads_sharded(full_parser, full_parser, mesh, all_to_all=True))
            multi_full = map_reads_multihost(full_parser, full_parser, params, device=dev)
            # walls: the sharded covid POA (a second, warm run) against the
            # single-device per-window path at the same caps
            _, poa_wall, poa_launches, poa_calls = md_counted(
                lambda: poa_batch_consensus_sharded(covid, mesh))
        finally:
            dist.destroy_process_group()
        launches_a = {k: sub_launches[k] + full_launches[k] + map_launches[k] + poa_launches[k]
                      for k in sub_launches}
        calls_a = sub_calls + full_calls + map_calls + poa_calls
        if calls_a or min(launches_a.values()) < 1:
            fail(f"run (a) launched {launches_a} and called a plain version {calls_a} times")

        # run (a)'s results against the single-device paths
        cons, cov, st = cons_a
        if any(st) or cons != golden:
            fail(f"run (a): sharded covid POA: {sum(1 for x in st if x)} statuses not 0, "
                 f"{sum(c != g for c, g in zip(cons, golden))} consensuses differ from the golden")
        L = ((max(len(r) for w in covid for r in w) + 63) // 64) * 64
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single = poa_batch_consensus(covid, max_nodes=3 * L, max_edges=50, max_alignments=50,
                                     device="cuda", use_lockstep=False)
        torch.cuda.synchronize()
        single_wall = time.perf_counter() - t0
        if single[0] != cons or single[2] != st or \
                any(not np.array_equal(a, b) for a, b in zip(single[1], cov)):
            fail("run (a): the sharded covid POA differs from poa_batch_consensus")
        if res_a["poa"][0] != cons[:MD_WINDOWS]:
            fail("run (a): the sharded POA on the first windows differs from the whole file's")
        mq, mt, ql_t, tl_t = (torch.from_numpy(x).to(dev) for x in (q, t, qlen, tlen))
        ref_codes, ref_fits = banded_nw_cuda(mq, mt, ql_t, tl_t, W)
        ref_codes = unpack_codes(ref_codes, q.shape[1])
        if hashlib.sha256(ref_codes.cpu().numpy().tobytes()).hexdigest() != \
                res_a["codes_sha256"] or not torch.equal(ref_fits.cpu(), res_a["fits"]):
            fail("run (a): the sharded aligner step's codes or fits differ from banded_nw_cuda")
        p_final, p_codes, _ = banded_nw_final_plain(mq[:32], mt[:32], ql_t[:32], tl_t[:32], W)
        if not torch.equal(p_final.cpu(), res_a["final"][:32]):
            fail("run (a): the sharded aligner step's distances differ from the plain version's")
        # the exact distance (align_cpu's path) where a pair fits and its
        # banded path stays off the band edge; never below it elsewhere
        edge = rle_traceback_plain(p_codes, ql_t[:32], tl_t[:32],
                                   band_offset(ql_t[:32], tl_t[:32], W), W,
                                   int((ql_t + tl_t).max()))[3].cpu().numpy()
        exact = [int((path != 0).sum()) for path in oracle(pairs[:32], align_cpu)]
        fits32 = res_a["fits"][:32].numpy()
        final32 = res_a["final"][:32].numpy()
        n_eq = 0
        for b in range(32):
            if final32[b] < exact[b] or (fits32[b] and not edge[b] and final32[b] != exact[b]):
                fail(f"run (a): pair {b}'s banded distance {final32[b]} against the exact "
                     f"{exact[b]} (fits {fits32[b]}, on the band edge {edge[b]})")
            n_eq += int(final32[b] == exact[b])
        matched, total, rq, rt = counts
        want = int((np.searchsorted(rt, rq, "right") - np.searchsorted(rt, rq, "left")).sum())
        if int(matched[0]) != want or int(total[0]) != (1 << 16) * ((1 << 16) - 1) // 2:
            fail(f"run (a): the counts {int(matched[0])}, {int(total[0])} against NumPy's")
        idx = build_index_device(full_parser, 0, len(full_parser), device=dev)
        single_ov = get_overlaps_device_pipeline(idx, idx, all_to_all=True)
        del idx
        if sharded_full != single_ov or not single_ov:
            fail("run (a): map_reads_sharded differs from get_overlaps_device_pipeline")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mapped = map_reads(full_parser, full_parser, params, device=dev)
        torch.cuda.synchronize()
        map_wall = time.perf_counter() - t0
        if multi_full != mapped:
            fail("run (a): map_reads_multihost differs from map_reads")
        small_parser = create_fasta_parser(small)
        small_params = MapperParams(index_size_mb=MD_INDEX_MB, target_index_size_mb=MD_INDEX_MB,
                                    filtering_parameter=1.0)
        if not res_a["multi"] or not res_a["sharded"] or res_a["multi"] != [
                dataclasses.astuple(o) for o in map_reads(small_parser, small_parser,
                                                          small_params, device=dev)]:
            fail(f"run (a): map_reads_multihost on the subset ({len(res_a['multi'])} overlaps) "
                 f"differs from map_reads, or a subset mapping is empty")
        print(f"{smi}: phase 12 run (a), a one-rank NCCL group on cuda:0: all {len(covid)} "
              f"covid windows through poa_batch_consensus_sharded == golden, every status 0, "
              f"== poa_batch_consensus(use_lockstep=False) at the same caps (N = {3 * L}, "
              f"E = A = 50); aligner_step_sharded on 1024 pairs of 2 kb at W = {W}: codes and "
              f"fits == banded_nw_cuda, the first 32 distances == the plain version's, "
              f"{n_eq} of 32 == align_cpu's (every fitting pair off the band edge); matcher "
              f"counts and all-reduce == NumPy; map_reads_sharded on {len(reads)} reads == "
              f"get_overlaps_device_pipeline ({len(single_ov)} overlaps); map_reads_multihost "
              f"== map_reads ({len(mapped)}); launches {launches_a}, no plain call", flush=True)
        print(f"{smi}: walls: sharded covid POA (one NCCL rank) {poa_wall:.4f} s, "
              f"{len(covid) / poa_wall:.1f} windows/s; poa_batch_consensus(use_lockstep=False) "
              f"{single_wall:.4f} s; map_reads_sharded {sharded_wall:.4f} s on {len(reads)} "
              f"reads; map_reads {map_wall:.4f} s; the subset's paths {res_a['wall']:.4f} s",
              flush=True)

        # -- 12b. two gloo ranks in two processes on this card -------------------------
        torch.cuda.empty_cache()
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--multi-device-rank", str(r), "2", str(port), tmp],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        logs = [p.communicate(timeout=MD_TIMEOUT)[0] for p in procs]
        wall_b = time.perf_counter() - t0
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                fail(f"run (b) rank {r} exited {p.returncode}:\n{log[-3000:]}")
        launches_b = []
        for r in range(2):
            got = torch.load(os.path.join(tmp, f"rank{r}.pt"))
            out = got["out"]
            if got["calls"] or min(got["launches"].values()) < 1:
                fail(f"run (b) rank {r} launched {got['launches']} and called a plain "
                     f"version {got['calls']} times")
            for key in ("poa", "codes_sha256", "codes_shape", "sharded", "multi", "W"):
                if out[key] != res_a[key]:
                    fail(f"run (b) rank {r}: {key} differs from run (a)'s")
            for key in ("final", "fits"):
                if not torch.equal(out[key], res_a[key]):
                    fail(f"run (b) rank {r}: {key} differs from run (a)'s")
            launches_b.append(got["launches"])
            print(f"{smi}: phase 12 run (b) rank {r} of 2 (gloo, cuda:0): the first "
                  f"{MD_WINDOWS} covid windows, the 1024 pairs' aligner step, "
                  f"map_reads_sharded and map_reads_multihost ({len(out['multi'])} overlaps) "
                  f"on the first {MD_READS} reads == run (a)'s; the paths {out['wall']:.4f} s; "
                  f"launches {got['launches']}, no plain call", flush=True)
        print(f"run (b): {wall_b:.1f} s with the processes' start; phase 12: "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches_a, sub_launches, launches_b


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--multi-device-rank"]:  # a rank of phase 12's run (b)
        return multi_device_rank(*sys.argv[2:6])
    from genomeworks_tpu_torch.ops import (
        _build, banded_nw_cuda, myers_banded_cuda, myers_score_cuda, poa_cuda,
        poa_lockstep_cuda, rle_traceback_cuda, xdrop_cuda,
    )

    aligner_ops = {m.__name__.rsplit(".", 1)[1]: m
                   for m in (myers_banded_cuda, banded_nw_cuda, rle_traceback_cuda)}
    from genomeworks_tpu_torch.ops.poa_cuda import poa_consensus_cuda
    from genomeworks_tpu_torch.poa import BandMode, OutputType, PoaBatch, StatusType
    from genomeworks_tpu_torch.poa.torch_poa import poa_batch_consensus, poa_consensus_plain
    from genomeworks_tpu_torch.poa.windows import (
        get_multi_batch_sizes, load_golden_lines, load_window_file,
    )

    t_start = time.perf_counter()
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
               *(m.SOURCE for m in aligner_ops.values()), xdrop_cuda.SOURCE,
               myers_score_cuda.SOURCE]
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
    # the full band's warp layout and 16-bit codes: each set must reach what
    # it names (window_facts, from the plain chain's graphs on the CPU)
    edge_sets = window_edge_sets(np.random.default_rng(6))
    for label, ws, wt, max_nodes, E, A, _ in edge_sets.values():
        cases.append((label, ws, wt, max_nodes, E, A))
    first = covid[:64]
    cfgs, groups = get_multi_batch_sizes(first, band_mode=BandMode.full_band)
    for cfg, wids in zip(cfgs, groups):
        ws = [first[i] for i in wids]
        ones = [[np.ones(len(s), np.int32) for s in w] for w in ws]
        cases.append((f"covid 0-63 bin {cfg.max_sequence_size}", ws, ones,
                      cfg.max_nodes_per_graph, 50, 50))
    # the full band's MSA and graph instantiations on every set, and the
    # consensus on every set but covid's, against their plain versions on
    # the host CPU (one process per core, as phase 9a), and the edge sets'
    # facts, while the card runs the covid checks: the plain chain on the
    # card, a few launches a row, took several times as long as on one host
    # core; covid's plain version is timed on the card for the kernels line
    from genomeworks_tpu_torch.poa.torch_poa import pack_windows

    pool = ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                               mp_context=multiprocessing.get_context("spawn"),
                               initializer=torch.set_num_threads, initargs=(1,))
    full_jobs = []
    for name, ws, wt, max_nodes, E, A in cases:
        N = pack_windows(ws, wt, max_nodes)[4]
        full_jobs += [((mode, name), mode, ws, wt, [N] * len(ws), E) for mode in
                      ("full_msa", "full_graph")]
    def cost(ws):  # the longest jobs first
        return -len(ws) * max(len(r) for w in ws for r in w) ** 1.5

    fact_jobs = pool.map(graph_prefix_facts, [
        (key, ws, pack_windows(ws, wt, max_nodes)[4], E, A)
        for key, (_, ws, wt, max_nodes, E, A, _) in edge_sets.items()])
    host_plain = pool.map(consensus_plain_job, sorted(
        [case for case in cases if not case[0].startswith("covid")], key=lambda c: cost(c[1])))
    full_plain = pool.map(plain_job, sorted(full_jobs, key=lambda j: cost(j[2])))
    edge_labels = {v[0] for v in edge_sets.values()}

    max_err = 0
    statuses = set()
    timed = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0, "cells": 0, "pred_cells": 0}
    for name, ws, wt, max_nodes, E, A in cases:
        if not name.startswith("covid"):
            continue  # below, against their plain versions on the host CPU
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
        L = seqs.shape[2]
        slab = lib.poa_slab_bytes(N, L, E, A)
        earlier = EARLIER_FULL_MS.get(name)
        print(f"check {name}: {len(ws)} windows, N={N} L={L} E={E} A={A} ({slab} scratch bytes "
              f"a window, {poa_cuda.code_bytes(E)}-byte codes, a ring of "
              f"{lib.poa_window_ring_rows(L)} rows, {lib.poa_windows_in_flight(0, L)} windows in flight "
              f"on the card): kernel == plain (statuses {st}); kernel {k_ms:.3f} ms"
              + (f" (the block-per-window kernel: {earlier:.3f} ms)" if earlier else "")
              + f", plain {p_ms:.1f} ms on the card")
        timed["ms"] += k_ms
        timed["plain_ms"] += p_ms
        timed["bytes"] += nbytes((*args, *k_out))
        timed["ops"] += nw_ops(work)
        timed["cells"] += work["cells"]
        timed["pred_cells"] += work["pred_cells"]
    prefix = {key: rest for key, *rest in fact_jobs}
    host_ref = dict(host_plain)
    edge_by_label = {v[0]: (key, v[6]) for key, v in edge_sets.items()}
    for name, ws, wt, max_nodes, E, A in cases:
        if name.startswith("covid"):
            continue
        (seqs, wts_t, lens, nseqs), N = packed(ws, wt, max_nodes, dev)
        k_out = poa_consensus_cuda(seqs, wts_t, lens, nseqs, N=N, E=E, A=A)
        max_err = max(max_err, compare(name, k_out, [t.to(dev) for t in host_ref[name]]))
        k_ms, _ = cuda_ms(lambda: poa_cuda._launch(lib, seqs, wts_t, lens, nseqs, N, E, A, -8,
                                                   -6, 8), reps=3)
        L = seqs.shape[2]
        R = lib.poa_window_ring_rows(L)
        st = sorted(set(k_out[3].tolist()))
        statuses.update(st)
        if name not in edge_labels:
            print(f"check {name}: {len(ws)} windows, N={N} L={L} E={E} A={A} "
                  f"({lib.poa_slab_bytes(N, L, E, A)} scratch bytes a window, "
                  f"{poa_cuda.code_bytes(E)}-byte codes, a ring of {R} rows): kernel == plain "
                  f"(on the host CPU; statuses {st}); kernel {k_ms:.3f} ms")
            continue
        key, want = edge_by_label[name]
        facts = window_facts(ws, N, E, lib, prefix[key])
        if not want <= facts:
            fail(f"the edge set {key!r} did not reach {sorted(want - facts)}")
        print(f"check {name}: {len(ws)} windows, N={N} L={L} E={E} A={A} "
              f"({poa_cuda.code_bytes(E)}-byte codes, a ring of {R} rows, "
              f"{lib.poa_windows_in_flight(0, L)} windows in flight on the card): kernel == plain (on "
              f"the host CPU; statuses {st}); kernel {k_ms:.3f} ms; reaches {sorted(facts)}")
    if not {0, 1, 2} <= statuses:
        fail(f"the check sets did not reach statuses 0, 1 and 2 (got {sorted(statuses)})")
    by_key = {}
    for key, out, _, _ in full_plain:
        by_key[key] = out
    for name, ws, wt, max_nodes, E, A in cases:
        for mode in ("full_msa", "full_graph"):
            fn, margs, mkw = mode_args(ws, wt, [pack_windows(ws, wt, max_nodes)[4]] * len(ws),
                                       E, mode, dev)
            max_err = max(max_err, compare(f"{mode} on {name}", fn(*margs, **mkw),
                                           [t.to(dev) for t in by_key[(mode, name)]]))
    pool.shutdown()
    print(f"check full_msa and full_graph: kernel == plain (on the host CPU) on all "
          f"{len(cases)} sets")
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
    print(f"phases 1-2: {time.perf_counter() - t_start:.1f} s")

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
    # the NW's and add's edge cases, each of which must reach what it names
    for key, (label, ws, wt, kw, want) in lockstep_edge_sets(np.random.default_rng(5)).items():
        seen: set = set()
        lk_statuses |= lockstep_compare(label, ws, wt, dev, seen=seen, **kw)
        if not want <= seen:
            fail(f"the lockstep edge set {key!r} did not reach {sorted(want - seen)}")
    if not {0, 1, 3, 5, 6, 100} <= lk_statuses:
        fail(f"the lockstep check sets did not reach statuses 0, 1, 3, 5, 6 and 100 "
             f"(got {sorted(lk_statuses)})")

    # the plain versions of the aligner's edge sets (phase 4), on the host CPU
    # in one process per core while the card runs phases 3-4
    edge_pool = ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                                    mp_context=multiprocessing.get_context("spawn"))
    warp_max = banded_nw_cuda.load_library().banded_nw_warp_max_band()
    sv_oracle = edge_pool.submit(sv_align_cpu_job)  # a minute of one core: first
    edge_plain = {key: edge_pool.submit(aligner_edge_plain_job, key, warp_max)
                  for key in aligner_edge_sets(np.random.default_rng(8), warp_max)}

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
    if min(v for n, v in launches.items() if n not in LK_ALONE) <= 0:
        fail(f"the default path did not launch every kernel: {launches}")
    if any(launches[n] for n in LK_ALONE) or not (
            launches["read_lockstep"] == launches["nw_lockstep"] == LK_MAIN_READS):
        fail(f"the default path's reads were not {LK_MAIN_READS} NW and {LK_MAIN_READS} fused "
             f"launches with no single-phase one: {launches}")
    if plain_calls:
        fail(f"the default path called a plain version {plain_calls} times")
    print(f"main path (default: lockstep tier): {len(covid)} covid windows through "
          f"PoaBatch(device='cuda'): all success, all equal the golden; {wall:.3f} s wall, "
          f"{len(covid) / wall:.1f} windows/s; tier counts {tiers}; launches {launches} (the "
          f"per-window kernel's are its bins under 64 windows and the re-runs; each read of the "
          f"tier one NW and one fused read_lockstep launch); "
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
        top = sorted(by_kernel(by_name).items(), key=lambda kv: -kv[1])[:10]
        print(f"profiled {label}: {prof_wall * 1e3:.3f} ms wall under torch.profiler, device "
              f"busy {busy_ms:.3f} ms ({100 * busy_ms / (prof_wall * 1e3):.2f} % of the wall); "
              + "; ".join(f"{k} {v:.3f} ms" for k, v in top))

    # kernel alone on the whole workload, packed per bin as the main path does
    cfgs, groups = get_multi_batch_sizes(covid, band_mode=BandMode.full_band)
    covid_ms = 0.0
    for cfg, wids in zip(cfgs, groups):
        ws = [covid[i] for i in wids]
        ones = [[np.ones(len(s), np.int32) for s in w] for w in ws]
        (seqs, wts_t, lens, nseqs), N = packed(ws, ones, cfg.max_nodes_per_graph, dev)
        ms, _ = cuda_ms(lambda: poa_cuda._launch(lib, seqs, wts_t, lens, nseqs, N=N, E=50, A=50,
                                                 gap=-8, mismatch=-6, match=8))
        chunk, fly = poa_cuda.last_chunk, lib.poa_windows_in_flight(0, seqs.shape[2])
        print(f"kernel on covid bin {cfg.max_sequence_size}: {len(ws)} windows, N={N}, "
              f"{ms:.3f} ms; {-(-len(ws) // chunk)} launches of up to {chunk} windows, "
              f"{fly} windows in flight on the card, so {-(-chunk // fly)} waves a launch")
        covid_ms += ms
    print(f"kernel on the whole covid workload: {covid_ms:.3f} ms (the block-per-window "
          f"kernel: {EARLIER_COVID_MS:.3f} ms)")

    # -- 4-6. the aligner -----------------------------------------------------
    aligner_entries = aligner_phases(dev, aligner_ops, edge_plain, sv_oracle)
    edge_pool.shutdown()

    # -- 6b. the lockstep kernels alone at the largest covid bucket's shapes -----
    lk_fields = lockstep_timing(covid, dev)
    print(f"phases 1-6b: {time.perf_counter() - t_start:.1f} s", flush=True)

    # -- 9. the banded and MSA modes (slice 4) -----------------------------------
    mode_entries = slice4_phases(dev, covid, golden)
    print(f"phases 1-9: {time.perf_counter() - t_start:.1f} s", flush=True)

    # -- 10. the mapper (slice 11) -------------------------------------------------
    mapper_read_list = mapper_phase(dev)
    print(f"phases 1-10: {time.perf_counter() - t_start:.1f} s", flush=True)

    # -- 11. the extender and the batched Myers distance (slice 12) ----------------
    extender_entries = extender_phase(dev)
    print(f"phases 1-11: {time.perf_counter() - t_start:.1f} s", flush=True)

    # -- 12. the multi-device layer (slice 13) ---------------------------------------
    md_full, md_sub, md_b = multi_device_phase(dev, covid, golden, mapper_read_list, smi)
    print(f"phases 1-12: {time.perf_counter() - t_start:.1f} s", flush=True)

    def md_launches(name):
        return {"run_a_full_size": md_full[name], "run_a_subset": md_sub[name],
                "run_b_by_rank": [r[name] for r in md_b]}

    for e in aligner_entries:
        if e["name"] == "banded_nw_cuda":
            e["launches_multi_device"] = md_launches("banded_nw_cuda")

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
        "launches_multi_device": md_launches("poa_consensus_cuda"),
    }, *({
        "name": name,
        "route": "cuda",
        "source": LK_SOURCE,
        "replaces": LK_REPLACES[name],
        "state": "ported",
        # a single phase is launched 0 times on the main path, which runs
        # it inside the fused read (runs_in)
        "launches": launches[name],
        "max_abs_err": 0,
        "library_ms": None,
        **lk_fields[name],
        "kernel": LK_DEVICE_NAME[name],
        **({"runs_in": "read_lockstep"} if name in LK_ALONE else {}),
        **({"also_replaces": LK_ALSO_REPLACES} if name == "read_lockstep" else {}),
        "main_path_s": wall,
        "windows_per_s": len(covid) / wall,
        "tier_counts": tiers,
    } for name in LK_REPLACES), *aligner_entries, *mode_entries, *extender_entries]}
    print(json.dumps(kernels))
    # -- 8. result --------------------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
