"""Old against new for the lockstep kernels on one card.

    python3 experiments/torch_lockstep_check.py [--parent DIR] [--nw-c 2,8]

1. Builds csrc/poa_lockstep.cu, its debug build (``-DLK_READ_STATS=1``:
   clock64 cycles and counts per phase of ``lk_read_kernel``) and, with
   ``--nw-c``, builds whose NW keeps other numbers of score rows a window
   in shared memory (``-DNW_C=c``), all through ``_build.build``, one nvcc
   each, started together, and prints each build's registers, shared
   memory and spills as ptxas reports them.
2. With ``--parent DIR`` (a directory holding another checkout's
   genomeworks_tpu_torch/csrc/poa_lockstep.cu, e.g. the parent commit
   unpacked with ``git archive``), builds that source too. The parent
   must have this checkout's C interface, or the one before it, whose
   one-thread consensus takes a device scratch (run through its own
   launcher).
3. For each covid bucket (the windows PoaBatch gives the lockstep tier,
   the largest first): the windows ``lk_read_kernel<7>`` holds on the card
   at once and the waves; then the bucket's chain once per build, in turns
   (parent, this, this, parent, then each --nw-c build): each build with
   its NW and the fused ``read_lockstep`` (the main path's), and this build
   also with its single-phase traceback, add and topsort.
   Every launch is timed with CUDA events; every run must end with the
   first run's whole state and consensus. Prints ms a launch per kernel,
   and the sum over the buckets of the traceback, add and topsort time
   (the default covid path's, one launch of each a read) and of the
   consensus time, with the windows the consensus holds on the card.
4. The debug build's counters over all buckets, fused: the share of
   traceback moves the speculation took without a round of their own,
   cycles a move, a window's table and jump tables, an add step and a
   sorted node.
5. How wide Kahn's queue is on the largest bucket's final graphs (a
   replay on the host of its first 256 windows): the share of pops that
   find more than one node ready, and the rounds a sort would take
   popping up to 4 ready nodes at once.

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
from genomeworks_tpu_torch.ops import _build  # noqa: E402
from genomeworks_tpu_torch.ops import poa_lockstep_cuda as lk  # noqa: E402
from genomeworks_tpu_torch.poa import lockstep  # noqa: E402
from genomeworks_tpu_torch.poa.windows import load_window_file  # noqa: E402

#: the debug build's counters, in the order of csrc/poa_lockstep.cu's RS_* enum
STATS = ("tb_windows", "tb_table_cycles", "tb_walk_cycles", "tb_steps", "tb_rounds",
         "add_windows", "add_cycles", "add_steps", "sort_windows", "sort_cycles", "sort_nodes")


def build(source, defines=None):
    """Build and bind one version of the source; prints its ptxas lines."""
    path = _build.build(source, defines)
    lib = ctypes.CDLL(path)
    if hasattr(lib, "lk_consensus_windows_in_flight"):
        lk.bind(lib)
    else:  # the interface before: the consensus takes a scratch argument
        P, I = ctypes.c_void_p, ctypes.c_int
        st = [ctypes.POINTER(ctypes.c_void_p)] + [I] * 4
        for name, args in (("lk_nw_launch", st + [P, I, P, P, P, I, P, P, I, I, I, I, P]),
                           ("lk_read_launch", st + [I, P, I, P, P, P, P, P, P, I, P, P, I, P]),
                           ("lk_consensus_launch", st + [P] * 7),
                           ("lk_nw_ring_width", [I]), ("lk_read_windows_in_flight", [I] * 4),
                           ("lk_read_stats", [ctypes.POINTER(ctypes.c_ulonglong), I])):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = I
    for ln in _build.build_log.get(path, "").splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print(f"  ptxas {os.path.basename(source)} {defines or ''}: {ln.strip()}")
    return lib


def run_chain(lib, t, plan, dev, alone=False):
    """The bucket's chain with ``lib``: (ms per launch by kernel, launches,
    final state, consensus outputs). ``alone``: this build's single-phase
    traceback, add and topsort instead of the fused read."""
    seqs, wts, lens, nseqs = t
    N, D, Lp, K = plan
    B, S, Lr = seqs.shape
    (seqs_t, wts_t, lens_t), st = lockstep.start_bucket(seqs, wts, lens, nseqs, N)
    codes = torch.empty((B, N, Lp), dtype=torch.uint8, device=dev)
    ms: dict = {}

    def timed(key, fn):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        ms[key] = ms.get(key, 0.0) + e0.elapsed_time(e1)
        return out

    lk._lib = lib  # the wrappers launch this build's kernels
    for s in range(1, S):
        act = nseqs > s
        w = None if wts_t is None else wts_t[s]
        best = timed("nw", lambda: lk.nw_lockstep(st, seqs_t[s], lens_t[s], act, codes, D,
                                                   -8, -6, 8))
        if alone:
            ag, ar, klen = timed("tb", lambda: lk.tb_lockstep(st, codes, best, lens_t[s],
                                                               act, K))
            timed("add", lambda: lk.add_lockstep(st, ag, ar, klen, seqs_t[s], w, act))
            timed("topsort", lambda: lk.topsort_lockstep(st, act))
        else:
            timed("read", lambda: lk.read_lockstep(st, codes, best, lens_t[s], seqs_t[s], w,
                                                    act, K))
    if hasattr(lib, "lk_consensus_windows_in_flight"):
        out = timed("consensus", lambda: lk.consensus_lockstep(st, nseqs > 0))
    else:  # the one-thread consensus, its scores in a device scratch
        act = nseqs > 0
        out = (torch.zeros((B, N), dtype=torch.uint8, device=dev),
               torch.zeros((B, N), dtype=torch.int32, device=dev),
               torch.empty(B, dtype=torch.int32, device=dev),
               torch.empty(B, dtype=torch.int32, device=dev))
        scratch = torch.empty((B, 2, N), dtype=torch.int32, device=dev)
        E, A = st["in_edges"].shape[2], st["al"].shape[2]
        stream = torch.cuda.current_stream(dev).cuda_stream
        timed("consensus", lambda: lib.lk_consensus_launch(
            lk._ptrs(st), B, N, E, A, act.data_ptr(), *(t.data_ptr() for t in out),
            scratch.data_ptr(), stream))
    lk._lib = None
    n = S - 1
    ms = {k: v / (1 if k == "consensus" else n) for k, v in ms.items()}
    return ms, n, st, out


def queue_width(st, windows=256):
    """Kahn's order replayed on the host over the first ``windows`` graphs
    of a state: (pops, pops with more than one node ready, rounds popping
    up to 4 ready nodes at once)."""
    h = {k: v[:windows].cpu().numpy() for k, v in st.items()}
    pops = wide = rounds = 0
    for b in range(h["nodes"].shape[0]):
        if h["error"][b] != 0:
            continue
        nc = int(h["node_count"][b])
        for batch in (1, 4):
            local = h["in_count"][b, :nc].copy()
            queue = [n for n in range(nc) if local[n] == 0]
            i = 0
            while i < len(queue):
                k = min(batch, len(queue) - i)
                if batch == 1:
                    pops += 1
                    wide += len(queue) - i > 1
                else:
                    rounds += 1
                for n in queue[i:i + k]:
                    for o in h["out_edges"][b, n, :h["out_count"][b, n]]:
                        local[o] -= 1
                        if local[o] == 0:
                            queue.append(int(o))
                i += k
    return pops, wide, rounds


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default="")
    ap.add_argument("--nw-c", default="", help="comma-separated NW_C values to build as well")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    jobs = {"this": (lk.SOURCE, None), "debug": (lk.SOURCE, {"LK_READ_STATS": 1})}
    if args.parent:
        jobs["parent"] = (os.path.abspath(os.path.join(
            args.parent, "genomeworks_tpu_torch", "csrc", lk.SOURCE)), None)
    for c in filter(None, args.nw_c.split(",")):
        jobs[f"NW_C={c}"] = (lk.SOURCE, {"NW_C": int(c)})
    with ThreadPoolExecutor(len(jobs)) as pool:  # one nvcc a build, started together
        for f in [pool.submit(_build.build, src, d) for src, d in jobs.values()]:
            f.result()
    libs = {name: build(src, d) for name, (src, d) in jobs.items()}

    covid = load_window_file(os.path.join(ROOT, "tests", "data", "poa_windows_covid.txt.gz"))
    order = ["parent", "this", "this", "parent"] if args.parent else ["this", "this"]
    order += [k for k in libs if k.startswith("NW_C")]
    ok = True
    total: dict = {}
    for bucket, (windows, plan, cfg) in enumerate(chip_smoke.covid_buckets(covid)):
        cfg_key = bucket
        N, D, Lp, K = plan
        ones = [[np.ones(len(s), np.int32) for s in w] for w in windows]
        t = chip_smoke.bucket_tensors(windows, ones, N, dev)
        lk._lib = libs["this"]
        fly = lk.read_windows_in_flight(lk.PH_ALL, N, lk.plain.E_LK, K)
        cfly = lk.consensus_windows_in_flight(N)
        lk._lib = None
        print(f"covid bucket (bin {cfg.max_sequence_size}): {len(windows)} windows, "
              f"{t[0].shape[1]} reads, (N, D, Lp, K) = {plan}; lk_read_kernel<7> holds {fly} "
              f"windows on the card at once: {-(-len(windows) // fly)} wave(s); "
              f"lk_consensus_kernel holds {cfly}")
        run_chain(libs["this"], t, plan, dev)  # warm
        ref = None
        for name in order:
            runs = [False, True] if name == "this" else [False]
            for alone in runs:
                ms, n, st, out = run_chain(libs[name], t, plan, dev, alone)
                same = True
                if ref is None:
                    ref = (st, out)
                else:
                    same = all(torch.equal(st[k], ref[0][k]) for k in st) and all(
                        torch.equal(a, b) for a, b in zip(out, ref[1]))
                ok &= same
                label = f"{name}{' (single phases)' if alone else ''}"
                walks = sum(ms.get(k, 0.0) for k in ("tb", "add", "topsort", "read"))
                turns = total.setdefault(label, {}).setdefault(cfg_key, [])
                turns.append(walks * n)
                cons_turns = total.setdefault(f"{label} consensus", {}).setdefault(cfg_key, [])
                cons_turns.append(ms["consensus"])
                print(f"time {label}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
                      + f" a launch ({n} reads); tb + add + topsort {walks:.4f} ms a read; state "
                      f"and consensus {'equal to the first run' if same else 'DIFFER'}",
                      flush=True)
    for label, by_bucket in total.items():
        v = sum(sum(t) / len(t) for t in by_bucket.values())
        what = "consensus" if label.endswith("consensus") else "tb + add + topsort"
        print(f"sum over the covid buckets, {label}: {what} {v:.3f} ms (a bucket's "
              f"turns averaged: the default covid path's)")

    # the debug build's counters, over every bucket's fused chain
    lib = libs["debug"]
    stats = (ctypes.c_ulonglong * len(STATS))()
    lib.lk_read_stats(stats, 1)
    for windows, plan, cfg in chip_smoke.covid_buckets(covid):
        ones = [[np.ones(len(s), np.int32) for s in w] for w in windows]
        t = chip_smoke.bucket_tensors(windows, ones, plan[0], dev)
        run_chain(lib, t, plan, dev)
    if lib.lk_read_stats(stats, 1) != 0:
        print("the debug build's counters could not be read")
        return 1
    c = dict(zip(STATS, (int(x) for x in stats)))
    print(f"debug build over the covid buckets: {c}")
    print(f"traceback: {c['tb_steps']} moves in {c['tb_rounds']} rounds: "
          f"{100 * (1 - c['tb_rounds'] / c['tb_steps']):.2f} % of the moves taken by the "
          f"speculation (no round of their own), {c['tb_steps'] / c['tb_rounds']:.2f} moves a "
          f"round; {c['tb_walk_cycles'] / c['tb_steps']:.1f} cycles a move, "
          f"{c['tb_table_cycles'] / c['tb_windows']:.0f} cycles a window's table and jump "
          f"tables; add "
          f"{c['add_cycles'] / max(1, c['add_steps']):.1f} cycles a step; topsort "
          f"{c['sort_cycles'] / max(1, c['sort_nodes']):.1f} cycles a node (lane 0's clock)")
    windows, plan, cfg = chip_smoke.largest_covid_bucket(covid)
    t = chip_smoke.bucket_tensors(windows, [[np.ones(len(s), np.int32) for s in w]
                                            for w in windows], plan[0], dev)
    pops, wide, rounds = queue_width(run_chain(libs["this"], t, plan, dev)[2])
    print(f"Kahn's queue on the largest bucket's final graphs (first 256 windows): {pops} pops, "
          f"{100 * wide / pops:.2f} % with more than one node ready; popping up to 4 at once "
          f"would take {rounds} rounds ({pops / rounds:.3f} nodes a round)")
    print("ALL EQUAL" if ok else "SOME RUN DIFFERS")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
