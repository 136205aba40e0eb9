"""Check the modes of the per-window POA kernel on one card, and time its
full-band instantiation against another build of csrc/poa_consensus.cu.

    python3 experiments/torch_poa_modes_check.py [--parent DIR]

1. Builds csrc/poa_consensus.cu (every instantiation) and prints each
   instantiation's registers and spills as ptxas reports them.
2. Runs each mode (full / static / adaptive band, consensus / MSA, and the
   full-band graph export) on seeded random windows through the kernel and
   through its plain version on the card, and prints whether they are equal.
   On those windows and on ``chip_smoke.band_edge_sets``, the banded
   traceback's moves (the debug build's count) must equal the plain
   chain's.
3. With ``--parent DIR`` (a directory holding another checkout's
   genomeworks_tpu_torch/csrc/poa_consensus.cu, e.g. the parent commit
   unpacked with ``git archive``), builds that source too and times the
   full-band consensus kernel of both on the whole covid workload, packed
   per bin as PoaBatch packs it, in the order parent, this, this, parent.
4. Times the four banded instantiations (static and adaptive band 256,
   consensus and MSA) on the whole covid workload, packed per bin as
   PoaBatch packs it, with the parent's too in the same turns; each run
   must give the first run's outputs. Prints the windows a launch and the
   windows the card holds at once.
5. The banded consensus kernels built with ``-DPOA_PHASE_CLOCKS=1`` on the
   same bins: cycles per phase (NW, traceback, add, topsort, consensus)
   summed over the windows (lane 0's clock), with the NW rows and moves of
   every pass: cycles an NW row (and its segments), a traceback move and
   an add move, and the moves the traceback's rounds of guesses took.

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

from genomeworks_tpu_torch.ops import _build, poa_cuda  # noqa: E402
from genomeworks_tpu_torch.poa import BandMode, torch_poa  # noqa: E402
from genomeworks_tpu_torch.poa.windows import get_multi_batch_sizes, load_window_file  # noqa: E402


def ptxas_lines(log):
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def build_parent(path):
    """nvcc of another poa_consensus.cu with the port's flags."""
    out = os.path.join(ROOT, "build", "kernels", "parent", "libpoa_consensus_parent.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", out, path],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(out)
    # the parent has slice 1's entry points only; _launch of the full-band
    # consensus uses just those
    lib.poa_slab_bytes.argtypes = [ctypes.c_int] * 4
    lib.poa_slab_bytes.restype = ctypes.c_longlong
    lib.poa_consensus_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    lib.poa_consensus_launch.restype = ctypes.c_int
    lib.poa_mode_slab_bytes.argtypes = [ctypes.c_int] * 8
    lib.poa_mode_slab_bytes.restype = ctypes.c_longlong
    lib.poa_mode_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 12 + [ctypes.c_longlong]
        + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    lib.poa_mode_launch.restype = ctypes.c_int
    return lib, proc.stdout + proc.stderr


def windows(rng, n, lo, hi, reads, rate):
    bases = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for _ in range(n):
        t = bases[rng.integers(0, 4, int(rng.integers(lo, hi)))]
        w = [t.tobytes().decode()]
        for _ in range(int(rng.integers(reads[0], reads[1] + 1)) - 1):
            r = rng.random(len(t))
            keep = t[r >= rate]
            keep = np.where(rng.random(len(keep)) < rate, bases[rng.integers(0, 4, len(keep))],
                            keep)
            ins = rng.integers(0, len(keep) + 1, int(rate * len(t)))
            w.append(np.insert(keep, ins, bases[rng.integers(0, 4, len(ins))]).tobytes().decode())
        out.append(w)
    return out


def check_modes(dev):
    """Each mode's kernel against its plain version, both on ``dev``."""
    from genomeworks_tpu_torch.poa import banded_plain

    rng = np.random.default_rng(5)
    ws = windows(rng, 24, 60, 160, (2, 8), 0.06)
    t = ws[0][0]
    ws[1] = [t, t[:40] + t[100:]]  # leaves a band of 128
    ws[2] = [t[-8:], t, t]  # the first read at the end: a deep racon DFS
    ws[3] = [ws[3][0], "", *ws[3][1:]]  # an empty later read
    wts = [[rng.integers(1, 6, len(s)).astype(np.int32) for s in w] for w in ws]
    caps = np.array([3 * max(len(s) for s in w) for w in ws], np.int32)
    caps[4] = 100  # a node cap that fails
    N = int(caps.max())
    args = [torch.from_numpy(a).to(dev) for a in torch_poa.pack_windows(ws, wts, N)[:4]]
    caps_t = torch.from_numpy(caps).to(dev)
    sc = (-8, -6, 8)
    ok = True
    runs = [("full consensus", poa_cuda.poa_consensus_cuda, {},
             lambda: torch_poa.poa_consensus_plain(*args, N, 50, 50, *sc)),
            ("full msa", poa_cuda.poa_msa_cuda, {},
             lambda: torch_poa.poa_msa_plain(*args, N, 50, 50, *sc)),
            ("full graph", poa_cuda.poa_graph_cuda, None,
             lambda: torch_poa.poa_graph_plain(*args, N, 50, 50, *sc))]
    for bw, ad in ((128, False), (256, True)):
        kw = dict(band_width=bw, adaptive=ad, caps=caps_t)
        runs += [(f"band {bw} adaptive {ad} consensus", poa_cuda.poa_consensus_cuda, kw,
                  lambda bw=bw, ad=ad: banded_plain.poa_banded_plain(
                      *args, caps_t, 50, 50, *sc, bw, ad)),
                 (f"band {bw} adaptive {ad} msa", poa_cuda.poa_msa_cuda, kw,
                  lambda bw=bw, ad=ad: banded_plain.poa_msa_banded_plain(
                      *args, caps_t, 50, 50, *sc, bw, ad))]
    for name, fn, kw, plain in runs:
        k = fn(*args, N=N, E=50, A=50) if kw is None else fn(*args, N=N, E=50, A=50, **kw)
        p = plain()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(k, p))
        ok &= same
        print(f"check {name}: {'kernel == plain' if same else 'DIFFERS'}; statuses "
              f"{sorted(set(k[-1].tolist()))}", flush=True)
    # the traceback's length: every move the walks took, the kernel's (the
    # debug build's count) against the plain chain's
    import chip_smoke

    sets = [("random", ws, wts, caps, bw, ad) for bw, ad in ((128, False), (256, True))]
    for key, (_, ews, _, ecaps, bw, kinds, _) in chip_smoke.band_edge_sets(
            np.random.default_rng(2028)).items():
        ecaps = ecaps or [3 * max(len(s) for s in w) for w in ews]
        sets += [(key, ews, None, np.array(ecaps, np.int32), bw, kind == "adaptive")
                 for kind in kinds]
    clk, buf = debug_library(), (ctypes.c_ulonglong * 15)()
    for key, sws, swts, scaps, bw, ad in sets:
        sN = max(int(scaps.max()), max(len(s) for w in sws for s in w))
        sargs = [torch.from_numpy(a).to(dev) for a in torch_poa.pack_windows(sws, swts, sN)[:4]]
        scaps_t = torch.from_numpy(scaps).to(dev)
        work: dict = {}
        banded_plain.poa_banded_plain(*sargs, scaps_t, 50, 50, *sc, bw, ad, work)
        clk.poa_phase_clocks(buf)  # zero
        poa_cuda._launch(clk, *sargs, sN, 50, 50, *sc, band_width=bw, adaptive=ad, caps=scaps_t)
        torch.cuda.synchronize()
        same = clk.poa_phase_clocks(buf) == 0 and int(buf[7]) == work["moves"]
        ok &= same
        print(f"check traceback moves, {key} band {bw} adaptive {ad}: kernel {int(buf[7])}, "
              f"plain {work['moves']}: {'equal' if same else 'DIFFER'}", flush=True)
    return ok


def debug_library():
    """The debug build (-DPOA_PHASE_CLOCKS=1), bound."""
    clk = poa_cuda.bind(ctypes.CDLL(_build.build(poa_cuda.SOURCE, {"POA_PHASE_CLOCKS": 1})))
    clk.poa_phase_clocks.argtypes = [ctypes.c_void_p]
    clk.poa_phase_clocks.restype = ctypes.c_int
    return clk


def covid_bins(band_mode):
    covid = load_window_file(os.path.join(ROOT, "tests", "data", "poa_windows_covid.txt.gz"))
    cfgs, groups = get_multi_batch_sizes(covid, band_mode=band_mode)
    for cfg, wids in zip(cfgs, groups):
        yield cfg, [covid[i] for i in wids]


def time_launch(fn):
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    with ThreadPoolExecutor() as ex:  # this build and its debug build, started together
        debug = ex.submit(_build.build, poa_cuda.SOURCE, {"POA_PHASE_CLOCKS": 1})
        path = _build.build(poa_cuda.SOURCE)
        debug.result()
    for ln in ptxas_lines(_build.build_log.get(path, "")):
        print(f"  ptxas this: {ln}")
    lib = poa_cuda.load_library()
    ok = check_modes(dev)
    libs = {"this": lib}
    if args.parent:
        plib, log = build_parent(os.path.join(args.parent, "genomeworks_tpu_torch", "csrc",
                                              poa_cuda.SOURCE))
        for ln in ptxas_lines(log):
            print(f"  ptxas parent: {ln}")
        libs["parent"] = plib
    packs = []
    for cfg, ws in covid_bins(BandMode.full_band):
        ones = [[np.ones(len(s), np.int32) for s in w] for w in ws]
        seqs, wts, lens, nseqs, N = torch_poa.pack_windows(ws, ones, cfg.max_nodes_per_graph)
        packs.append(([torch.from_numpy(a).to(dev) for a in (seqs, wts, lens, nseqs)], N))
    order = ["parent", "this", "this", "parent"] if args.parent else ["this", "this"]
    for name in order:
        ms = sum(time_launch(lambda: poa_cuda._launch(libs[name], *t, N, 50, 50, -8, -6, 8))
                 for t, N in packs)
        print(f"time full-band consensus kernel ({name}) on the covid workload: {ms:.3f} ms")
    for adaptive in (False, True):
        mode = BandMode.adaptive_band if adaptive else BandMode.static_band
        bins = []
        for cfg, ws in covid_bins(mode):
            bins.append(torch_poa._banded_inputs(ws, None, cfg.max_nodes_per_graph, dev))
            L = bins[-1][0][0].shape[2]
            for out in (0, 1):
                print(f"{mode.name} {'MSA' if out else 'consensus'}, bin "
                      f"{cfg.max_sequence_size} ({len(ws)} windows, N = {bins[-1][1]}): "
                      f"poa_banded_kernel holds "
                      f"{lib.poa_banded_windows_in_flight(1 + adaptive, out, L)} windows on the "
                      f"card at once; window_paths at nc = N "
                      f"{lib.poa_banded_paths(bins[-1][1], bins[-1][1])}")
        for output in ("consensus", "msa"):
            ref = None
            for name in order:
                ms, chunks, launches = 0.0, [], 0
                outs = []
                for (seqs, wts, lens, nseqs, caps), N in bins:
                    before = sum(poa_cuda.launches_by_mode.values())
                    ms += time_launch(lambda: outs.append(poa_cuda._launch(
                        libs[name], seqs, wts, lens, nseqs, N, 50, 50, -8, -6, 8,
                        band_width=256, adaptive=adaptive, caps=caps, output=output)))
                    launches += (sum(poa_cuda.launches_by_mode.values()) - before) // 2
                    chunks.append(poa_cuda.last_chunk)
                outs = outs[1::2]  # the timed run of each bin
                same = True
                if ref is None:
                    ref = outs
                else:
                    same = all(torch.equal(a, b) for x, y in zip(outs, ref) for a, b in zip(x, y))
                ok &= same
                print(f"time {mode.name} {output} kernel ({name}) on the covid workload (band "
                      f"256): {ms:.3f} ms, {launches} launches, windows a launch {chunks}; "
                      f"outputs {'equal to the first run' if same else 'DIFFER'}", flush=True)
    clk, buf = debug_library(), (ctypes.c_ulonglong * 15)()
    phases = ("nw", "traceback", "add", "topsort", "consensus")
    for adaptive in (False, True):
        mode = BandMode.adaptive_band if adaptive else BandMode.static_band
        clk.poa_phase_clocks(buf)  # zero
        for cfg, ws in covid_bins(mode):
            (seqs, wts, lens, nseqs, caps), N = torch_poa._banded_inputs(
                ws, None, cfg.max_nodes_per_graph, dev)
            poa_cuda._launch(clk, seqs, wts, lens, nseqs, N, 50, 50, -8, -6, 8, band_width=256,
                             adaptive=adaptive, caps=caps)
        torch.cuda.synchronize()
        if clk.poa_phase_clocks(buf) != 0:
            print("reading the phase clocks failed")
            return 1
        cyc = dict(zip(phases, (int(x) for x in buf[:5])))
        windows, rows, moves = (int(x) for x in buf[5:8])
        total = max(1, sum(cyc.values()))
        segs = [int(x) for x in buf[8:12]]
        rounds, guessed = int(buf[13]), int(buf[14])
        print(f"  NW row segments {mode.name}: " + ", ".join(
            f"{k} {c / max(rows, 1):.0f}" for k, c in zip(
                ("boundary", "predecessors", "closure and stores", "row end"), segs))
              + f" cycles a row; traceback: {rounds} rounds of guesses took {guessed} of "
              f"{moves} moves ({guessed / max(rounds, 1):.2f} a round)")
        print(f"phase split {mode.name} consensus on the covid workload: {windows} windows, "
              f"{rows} NW rows, {moves} moves; " + ", ".join(
                  f"{p} {100 * c / total:.1f} %" for p, c in cyc.items())
              + f"; {cyc['nw'] / max(rows, 1):.0f} cycles an NW row, "
              f"{cyc['traceback'] / max(moves, 1):.0f} a traceback move, "
              f"{cyc['add'] / max(moves, 1):.0f} an add move, "
              f"{total / max(windows, 1):.0f} a window", flush=True)
    print("ALL EQUAL" if ok else "SOME MODE DIFFERS")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
