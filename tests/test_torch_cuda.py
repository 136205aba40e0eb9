"""The CUDA kernels of the port on the card: exact equality with their plain
PyTorch versions (integer arithmetic, no tolerance).

These tests need an NVIDIA card and nvcc and skip elsewhere. The machine
with the card has no JAX, which tests/conftest.py imports, so run them as

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

This file imports nothing of JAX or genomeworks_tpu.
"""

import numpy as np
import pytest
import torch

from genomeworks_tpu_torch.aligner import create_aligner
from genomeworks_tpu_torch.aligner.banded_nw import band_offset, banded_nw_forward_plain
from genomeworks_tpu_torch.aligner.cpu_reference import align_cpu
from genomeworks_tpu_torch.aligner.myers_banded_model import myers_banded_plain
from genomeworks_tpu_torch.aligner.rle_traceback import rle_traceback_plain
from genomeworks_tpu_torch.ops.banded_nw_cuda import banded_nw_cuda
from genomeworks_tpu_torch.ops.myers_banded_cuda import myers_banded_cuda
from genomeworks_tpu_torch.ops.poa_cuda import poa_consensus_cuda
from genomeworks_tpu_torch.ops.rle_traceback_cuda import rle_traceback_cuda
from genomeworks_tpu_torch.poa import torch_poa


def _windows(B, Lb, seed, rate, reads):
    """B windows: a random template of Lb bases and mutated copies of it
    (substitution, deletion and insertion each at ``rate``), 2..reads reads."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    windows = []
    for b in range(B):
        t = bases[rng.integers(0, 4, Lb)]
        ws = [t.tobytes().decode()]
        for _ in range(1 + b % (reads - 1)):
            r = rng.random(Lb)
            keep = t[r >= 2 * rate]
            sub = np.where(r < rate, bases[rng.integers(0, 4, Lb)], t)[r >= rate]
            ins = np.insert(sub, rng.integers(0, len(sub) + 1, int(rate * Lb)),
                            bases[rng.integers(0, 4, int(rate * Lb))])
            ws.append((ins if len(ins) else keep).tobytes().decode())
        windows.append(ws)
    weights = [[rng.integers(1, 9, size=len(s)).astype(np.int32) for s in w] for w in windows]
    return windows, weights


@pytest.mark.cuda
@pytest.mark.parametrize(
    "weighted,max_nodes,E,A,empty",
    [(False, None, 50, 50, False), (True, None, 50, 50, False), (True, 110, 50, 50, False),
     (True, None, 4, 4, False), (True, 110, 4, 4, False), (True, None, 50, 50, True)],
    ids=["unit", "weighted", "node-cap", "edge-cap", "both-caps", "empty-later-reads"],
)
def test_kernel_matches_plain_on_gpu(weighted, max_nodes, E, A, empty):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    windows, weights = _windows(B=32, Lb=80, seed=7, rate=0.08, reads=12)
    if empty:  # every other window's second read is empty; first reads stay
        for b in range(1, len(windows), 2):
            windows[b][1] = ""
            weights[b][1] = np.zeros(0, np.int32)
    seqs, wts, lens, nseqs, N = torch_poa.pack_windows(
        windows, weights if weighted else None, max_nodes)
    args = [torch.from_numpy(a).cuda() for a in (seqs, wts, lens, nseqs)]
    launches = poa_consensus_cuda.launches
    out = poa_consensus_cuda(*args, N=N, E=E, A=A)
    ref = torch_poa.poa_consensus_plain(*args, N, E, A, -8, -6, 8)
    torch.cuda.synchronize()
    assert poa_consensus_cuda.launches > launches
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_rejects_empty_first_read_on_gpu():
    """A window whose first read is empty has no graph to align to: the
    wrapper raises before any launch, as it does on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    windows, _ = _windows(B=4, Lb=40, seed=3, rate=0.05, reads=4)
    windows[2][0] = ""
    seqs, wts, lens, nseqs, N = torch_poa.pack_windows(windows, None, None)
    args = [torch.from_numpy(a).cuda() for a in (seqs, wts, lens, nseqs)]
    launches = poa_consensus_cuda.launches
    with pytest.raises(ValueError, match="first of them non-empty"):
        poa_consensus_cuda(*args, N=N, E=50, A=50)
    assert poa_consensus_cuda.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize(
    "band_width,adaptive,msa",
    [(128, False, False), (128, True, False), (0, False, True), (128, False, True),
     (128, True, True)],
    ids=["static", "adaptive", "full-msa", "static-msa", "adaptive-msa"],
)
def test_banded_and_msa_modes_match_plain_on_gpu(band_width, adaptive, msa):
    """The static, adaptive and MSA instantiations of the per-window kernel
    against their plain versions (banded_plain, torch_poa.poa_msa_plain) on
    the card: weighted windows, one with a read that leaves the band, node
    caps of their own (one too small), and an empty later read."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    from genomeworks_tpu_torch.ops.poa_cuda import poa_msa_cuda

    windows, weights = _windows(B=24, Lb=120, seed=11, rate=0.06, reads=8)
    t = windows[0][0]
    windows[1] = [t, t[:30] + t[90:]]
    weights[1] = [np.ones(len(s), np.int32) for s in windows[1]]
    windows[2][1], weights[2][1] = "", np.zeros(0, np.int32)
    caps = np.array([3 * max(len(s) for s in w) for w in windows], np.int32)
    caps[3] = 130
    N = int(caps.max())
    seqs, wts, lens, nseqs, _ = torch_poa.pack_windows(windows, weights, N)
    args = [torch.from_numpy(a).cuda() for a in (seqs, wts, lens, nseqs)]
    kw = dict(N=N, E=50, A=50, band_width=band_width, adaptive=adaptive)
    if band_width:
        kw["caps"] = torch.from_numpy(caps).cuda()
    fn = poa_msa_cuda if msa else poa_consensus_cuda
    launches = fn.launches
    out = fn(*args, **kw)
    ref = fn(*(a.cpu() for a in args), **{k: (v.cpu() if torch.is_tensor(v) else v)
                                           for k, v in kw.items()})
    torch.cuda.synchronize()
    assert fn.launches == launches + 1
    for a, b in zip(out, ref):
        assert torch.equal(a.cpu(), b)
    assert 0 in out[-1].tolist()


BAND_EDGE_SETS = ["lane-edge", "tile-edge", "two-tiles", "shift", "wide", "caps"]


@pytest.mark.cuda
@pytest.mark.parametrize("output", ["consensus", "msa"])
@pytest.mark.parametrize("case", BAND_EDGE_SETS)
def test_banded_edge_sets_match_plain_on_gpu(case, output):
    """The banded kernel (a warp per window) in each of its instantiations
    against its plain version on the edge sets of its warp layout
    (``chip_smoke.band_edge_sets``): bands of 252 and 260 (a lane's last
    chunk alone, a partial second tile) and 512 (two tiles), chunks whose
    guard fails on a predecessor row with another band start, reads that
    leave an adaptive band (rules 7 and 8, the re-run), adaptive bands of
    384 and 1536 lanes, node caps too small and an empty later read; each
    set must reach what it names."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    import chip_smoke
    from genomeworks_tpu_torch.ops import poa_cuda
    from genomeworks_tpu_torch.poa import banded_plain

    label, windows, weights, caps, bw, kinds, want = chip_smoke.band_edge_sets(
        np.random.default_rng(2028))[case]
    caps = caps or [3 * max(len(s) for s in w) for w in windows]
    N = max(max(caps), max(len(s) for w in windows for s in w))
    seqs, wts, lens, nseqs, _ = torch_poa.pack_windows(windows, weights, N)
    cpu = [torch.from_numpy(a) for a in (seqs, wts, lens, nseqs)]
    caps_t = torch.tensor(caps, dtype=torch.int32)
    fn = poa_cuda.poa_consensus_cuda if output == "consensus" else poa_cuda.poa_msa_cuda
    plain = banded_plain.poa_banded_plain if output == "consensus" else \
        banded_plain.poa_msa_banded_plain
    facts = set()
    for kind in kinds:
        launches = fn.launches
        out = fn(*(a.cuda() for a in cpu), N=N, E=50, A=50, band_width=bw,
                 adaptive=kind == "adaptive", caps=caps_t.cuda())
        work = {}
        ref = plain(*cpu, caps_t, 50, 50, -8, -6, 8, bw, kind == "adaptive", work=work)
        torch.cuda.synchronize()
        assert fn.launches == launches + 1
        for a, b in zip(out, ref):
            assert torch.equal(a.cpu(), b)
        facts |= chip_smoke.band_facts(work, set(out[-1].tolist()), windows)
    assert want <= facts, sorted(want - facts)


WINDOW_EDGE_SETS = ["lane-edges", "tile-edges", "ring", "long", "wide-lists",
                    "empty-weighted", "E100", "E130", "2kb", "no-ring"]


@pytest.mark.cuda
@pytest.mark.parametrize("output", ["consensus", "msa", "graph"])
@pytest.mark.parametrize("case", WINDOW_EDGE_SETS)
def test_full_band_edge_sets_match_plain_on_gpu(case, output):
    """The full-band kernel (a warp per window) in each of its outputs
    against its plain version on the edge sets of its warp layout
    (``chip_smoke.window_edge_sets``): read lengths at a lane's and a tile's
    edges, reads of 640 bases in two tiles, predecessors at the shared
    ring's last distance and past it, lists past 32 slots, an empty later
    read with weights 0-9, E = A = 100 and 130 (16-bit codes), reads of
    2000 bases (the sort and the consensus scores past the shared memory)
    and of 2600 (no score ring, the add unstaged); each set must reach what
    it names."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    import chip_smoke
    from genomeworks_tpu_torch.ops import poa_cuda

    label, windows, weights, max_nodes, E, A, want = chip_smoke.window_edge_sets(
        np.random.default_rng(6))[case]
    seqs, wts, lens, nseqs, N = torch_poa.pack_windows(windows, weights, max_nodes)
    cpu = [torch.from_numpy(a) for a in (seqs, wts, lens, nseqs)]
    fn = {"consensus": poa_cuda.poa_consensus_cuda, "msa": poa_cuda.poa_msa_cuda,
          "graph": poa_cuda.poa_graph_cuda}[output]
    launches = fn.launches
    out = fn(*(a.cuda() for a in cpu), N=N, E=E, A=A)
    ref = fn(*cpu, N=N, E=E, A=A)
    torch.cuda.synchronize()
    assert fn.launches == launches + 1
    for a, b in zip(out, ref):
        assert torch.equal(a.cpu(), b)
    if output == "consensus":
        _, *prefix = chip_smoke.graph_prefix_facts((case, windows, N, E, A))
        facts = chip_smoke.window_facts(windows, N, E, poa_cuda.load_library(), prefix)
        assert want <= facts, sorted(want - facts)


@pytest.mark.cuda
@pytest.mark.parametrize("N,L", [(768, 256), (1536, 299), (64, 9)])
def test_slab_grows_only_by_the_codes(N, L):
    """The library's full-band slab: from E = 84 to 85, where the codes
    widen to two bytes, it grows by what each step of E adds (the (N, E)
    and (N, A) lists, steady for N a multiple of 64 in 256-byte aligned
    arrays) and by the code matrix's second byte alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    from genomeworks_tpu_torch.ops import poa_cuda

    slab = poa_cuda.load_library().poa_slab_bytes
    step = [slab(N, L, E + 1, E + 1) - slab(N, L, E, E) for E in (49, 50, 82, 83, 84, 85, 86)]
    assert len(set(step[:4])) == 1 and step[5] == step[6] == step[0]
    cells = (N + 1) * (L + 1)
    assert step[4] - step[0] == (2 * cells + 255) // 256 * 256 - (cells + 255) // 256 * 256


@pytest.mark.cuda
def test_graph_export_matches_plain_on_gpu():
    """The full-band graph export (what PoaBatch.get_graphs reads) against
    torch_poa.poa_graph_plain on the card, a node-capped window among them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    from genomeworks_tpu_torch.ops.poa_cuda import poa_graph_cuda

    windows, weights = _windows(B=16, Lb=80, seed=12, rate=0.08, reads=10)
    seqs, wts, lens, nseqs, N = torch_poa.pack_windows(windows, weights, 110)
    args = [torch.from_numpy(a).cuda() for a in (seqs, wts, lens, nseqs)]
    out = poa_graph_cuda(*args, N=N, E=50, A=50)
    ref = torch_poa.poa_graph_plain(*(a.cpu() for a in args), N, 50, 50, -8, -6, 8)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert torch.equal(a.cpu(), b)
    assert set(out[-1].tolist()) >= {0, 1}


def _lockstep_chain(windows, weights, D=None):
    """One bucket through the lockstep phases read by read, each kernel and
    its plain version on clones of one state, and the fused read_lockstep on
    a clone of the state the NW left; asserts every output and the whole
    state equal, and returns the statuses."""
    from genomeworks_tpu_torch.ops import poa_lockstep_cuda as lk
    from genomeworks_tpu_torch.poa import lockstep, lockstep_plain as lp

    N, D0, Lp, K = lockstep.bucket_plan(windows)
    D = D or D0
    seqs, wts, lens, nseqs, _ = torch_poa.pack_windows(windows, weights, N)
    seqs, wts, lens, nseqs = (torch.from_numpy(a).cuda() for a in (seqs, wts, lens, nseqs))
    (seqs_t, wts_t, lens_t), st = lockstep.start_bucket(
        seqs, wts if weights else None, lens, nseqs, N)
    B, S, _ = seqs.shape

    def same(a, b):
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        for k in torch_poa.STATE_KEYS:
            assert torch.equal(ks[k], ps[k]), k

    for s in range(1, S):
        act = nseqs > s
        w = None if wts_t is None else wts_t[s]
        ks = {k: v.clone() for k, v in st.items()}
        ps = {k: v.clone() for k, v in st.items()}
        ck = torch.full((B, N, Lp), 255, dtype=torch.uint8, device="cuda")
        cp = ck.clone()
        bk = lk.nw_lockstep(ks, seqs_t[s], lens_t[s], act, ck, D, -8, -6, 8)
        bp = lp.nw_lockstep_plain(ps, seqs_t[s], lens_t[s], act, cp, D, -8, -6, 8)
        same((ck, bk), (cp, bp))
        fs = {k: v.clone() for k, v in ks.items()}
        tk = lk.tb_lockstep(ks, ck, bk, lens_t[s], act, K)
        tp = lp.tb_lockstep_plain(ps, cp, bp, lens_t[s], act, K)
        same(tk, tp)
        lk.add_lockstep(ks, *tk, seqs_t[s], w, act)
        lp.add_lockstep_plain(ps, *tp, seqs_t[s], w, act)
        same((), ())
        lk.topsort_lockstep(ks, act)
        lp.topsort_lockstep_plain(ps, act)
        same((), ())
        fk = lk.read_lockstep(fs, ck, bk, lens_t[s], seqs_t[s], w, act, K)
        torch.cuda.synchronize()
        assert torch.equal(fk, tp[2])
        for k in torch_poa.STATE_KEYS:
            assert torch.equal(fs[k], ps[k]), f"read_lockstep {k}"
        st = ks
    out = lk.consensus_lockstep(st, nseqs > 0)
    ref = lp.consensus_lockstep_plain(st, nseqs > 0)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    return set(out[3].tolist())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case", ["unit", "weighted", "small-ring", "edge-cap", "node-cap", "lane-edges",
             "warp-edge", "widest", "distances", "caps", "wide-lists", "empty-weighted",
             "spec", "short-walk", "waves", "consensus"])
def test_lockstep_kernels_match_plain_on_gpu(case):
    """Each lockstep kernel (the NW, the single-phase traceback, add and
    topsort, the consensus) equals its plain version, outputs and whole
    state, read by read, and the fused read_lockstep equals the plain
    traceback, add and topsort; the capped sets reach their codes. The
    warp layouts' edge cases (``chip_smoke.lockstep_edge_sets``): read
    lengths at the edges of a lane's columns, the widest plan,
    predecessors at the shared ring's last distance and past it, at D and
    past it, lists filled to their caps and past them, lists past 32 slots
    at other caps, an empty later read and weights 0-9, walks whose
    speculation misses at once and never misses, a short K (walks past K,
    statuses 3 and 100), more windows than one wave, the consensus's ties
    on weight and on the sources' scores, in-lists past 32, branch
    completion over several loops and its status 3; each must reach what
    its set names."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    import chip_smoke

    edge = chip_smoke.lockstep_edge_sets(np.random.default_rng(5))
    if case in edge:
        label, windows, weights, kw, want = edge[case]
        seen = set()
        chip_smoke.lockstep_compare(label, windows, weights, torch.device("cuda"), seen=seen,
                                    **kw)
        assert want <= seen, sorted(want - seen)
        return
    rng = np.random.default_rng(11)
    windows, weights = {
        "unit": lambda: (_windows(B=32, Lb=80, seed=7, rate=0.05, reads=12)[0], None),
        "weighted": lambda: _windows(B=32, Lb=80, seed=8, rate=0.05, reads=12),
        "small-ring": lambda: (_windows(B=32, Lb=80, seed=9, rate=0.05, reads=8)[0], None),
        # 15 reads with distinct 1-4 base insertions at one place: the base
        # after it gets more in-edges than the lists hold
        "edge-cap": lambda: ([[x + y] + [x + _random(rng, 1 + i % 4) + y for i in range(15)]
                              for x, y in ((_random(rng, 20), _random(rng, 20))
                                           for _ in range(8))], None),
        # 15 reads with a quarter of their bases substituted: over 128 nodes
        "node-cap": lambda: ([[t] + [_substituted(rng, t, 0.25) for _ in range(15)]
                              for t in (_random(rng, 60) for _ in range(8))], None),
    }[case]()
    statuses = _lockstep_chain(windows, weights, D=4 if case == "small-ring" else None)
    want = {"small-ring": 5, "edge-cap": 6, "node-cap": 1}.get(case, 0)
    assert want in statuses


def _covid_like(B):
    """B windows of 12-16 reads of about 200 bp at 3 % error."""
    return _windows(B=B, Lb=200, seed=B, rate=0.03, reads=16)[0]


@pytest.mark.cuda
def test_poa_batch_on_gpu_takes_the_lockstep_tier():
    """PoaBatch(device="cuda") on 64 windows or more runs the lockstep tier,
    each read one NW and one fused read_lockstep launch (the single-phase
    traceback, add and topsort none), then the consensus, and calls no
    plain version; under 64 windows only the per-window kernel runs. Both
    equal the per-window kernel's path."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    from genomeworks_tpu_torch.ops import poa_lockstep_cuda as lk
    from genomeworks_tpu_torch.poa import BatchConfig, PoaBatch, lockstep, lockstep_plain as lp

    plains = (torch_poa.poa_consensus_plain, lp.nw_lockstep_plain, lp.tb_lockstep_plain,
              lp.add_lockstep_plain, lp.topsort_lockstep_plain, lp.consensus_lockstep_plain,
              lp.read_lockstep_plain)
    for B in (64, 63):
        windows = _covid_like(B)
        for k in (poa_consensus_cuda, *lk.KERNELS):
            k.launches = 0
        calls = [p.calls for p in plains]
        lockstep.reset_tier_stats()
        batch = PoaBatch(BatchConfig(max_sequence_size=256), device="cuda")
        for w in windows:
            batch.add_poa_group(w)
        batch.generate_poa()
        cons, _, _ = batch.get_consensus()
        torch.cuda.synchronize()
        assert [p.calls for p in plains] == calls
        if B >= 64:
            alone = (lk.tb_lockstep, lk.add_lockstep, lk.topsort_lockstep)
            assert all(k.launches > 0 for k in lk.KERNELS if k not in alone)
            assert sum(k.launches for k in alone) == 0
            assert lk.read_lockstep.launches == lk.nw_lockstep.launches
            assert lockstep.tier_stats["lockstep_windows"] > 0
        else:
            assert sum(k.launches for k in lk.KERNELS) == 0 and poa_consensus_cuda.launches > 0
            assert sum(lockstep.tier_stats.values()) == 0
        ones = [[np.ones(len(s), np.int32) for s in w] for w in windows]
        ref = torch_poa.poa_batch_consensus(windows, max_nodes=batch.batch_config.max_nodes_per_graph,
                                            weights=ones, device="cuda", use_lockstep=False)
        assert cons == ref[0]


def _mutate(rng, s, rate):
    """Substitutions, deletions and 1-base insertions, each at ``rate``."""
    out = []
    for c in s:
        r = rng.random()
        if r < rate:
            out.append("ACGT"[int(rng.integers(0, 4))])
        elif r < 2 * rate:
            continue
        elif r < 3 * rate:
            out += [c, "ACGT"[int(rng.integers(0, 4))]]
        else:
            out.append(c)
    return "".join(out)


def _random(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _substituted(rng, s, rate):
    return "".join("ACGT"[rng.integers(0, 4)] if rng.random() < rate else c for c in s)


def _pairs(B, M, seed, rate):
    """B pairs padded to M (query pad 1, target pad 2). The first is
    a + x + b against a + b + y with |x| = |y| = 20, whose path leaves a
    band of 32; the last three are an empty query, an empty target and both
    empty."""
    rng = np.random.default_rng(seed)
    q = np.ones((B, M), np.uint8)
    t = np.full((B, M), 2, np.uint8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    head, tail, gap_q, gap_t = (_random(rng, n) for n in (60, 60, 20, 20))
    for b in range(B - 3):
        qs = _random(rng, int(rng.integers(M // 4, M - 8)))
        ts = _mutate(rng, qs, rate)[:M]
        if b == 0:
            qs, ts = head + gap_q + tail, head + tail + gap_t
        # any 2-bit code of the four bases will do: the kernels compare codes
        q[b, :len(qs)] = np.frombuffer(qs.encode(), np.uint8) >> 1 & 3
        t[b, :len(ts)] = np.frombuffer(ts.encode(), np.uint8) >> 1 & 3
        qlen[b], tlen[b] = len(qs), len(ts)
    qlen[B - 3] = 0
    tlen[B - 2] = 0
    qlen[B - 1] = tlen[B - 1] = 0
    return [torch.from_numpy(a).cuda() for a in (q, t, qlen, tlen)]


BLOCK_NW_SETS = ["block-640", "block-1024", "block-2048", "block-4096", "block-8192",
                 "block-16384"]
ALIGNER_EDGE_SETS = ["bands", "widest", "w16384", "identical", "diagonal-ends", "qlen16",
                     "long-indels", "drift", "empty", "rcap", "dense-10kb", "myers-layouts",
                     "myers-rows", "myers-narrow", "myers-unfit", "myers-w32768", *BLOCK_NW_SETS]


@pytest.mark.cuda
@pytest.mark.parametrize("case", [32, 64, 256, 1024, *ALIGNER_EDGE_SETS])
def test_aligner_kernels_match_plain_on_gpu(case):
    """Both forward kernels and the traceback kernel against their plain
    versions on the same CUDA tensors. At W = 32 the first pair's walk on
    the Myers plane touches the band edge; a small rcap overflows. The
    named cases are the edge sets of the warp layouts
    (``chip_smoke.aligner_edge_sets``): NW bands that are not multiples of
    32, the warp NW's widest band and the block kernel's, W = 16384, an
    identical 2-kb pair, diagonal runs that end at i = 0 or j = 0 inside a
    word, qlen at a word's edges, indel runs past the traceback's tile, the
    drifting pair, empty sequences, rcap 1 and 4, 64 indel-dense 10-kb
    pairs; and the Myers kernel's layouts (the bands where its words a lane
    change, qlen across the window's first moves and its 8-row groups, a
    window wider than the target's words, pairs that do not fit, W =
    32768); and the block NW's (each band from 640 to 16384 with one that
    is not a multiple of a warp's columns: walks across warp boundaries and
    in the last warp, along the band's edge, pairs that do not fit, qlen 0,
    M not a multiple of 16); each must reach what it names."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    if isinstance(case, str):
        import chip_smoke
        from genomeworks_tpu_torch.ops import banded_nw_cuda as nw

        warp_max = nw.load_library().banded_nw_warp_max_band()
        spec = chip_smoke.aligner_edge_sets(np.random.default_rng(8), warp_max)[case]
        facts = chip_smoke.aligner_edge_compare(spec, torch.device("cuda"), warp_max)
        assert spec["want"] <= facts, sorted(spec["want"] - facts)
        return
    W = case
    q, t, qlen, tlen = _pairs(B=24, M=256, seed=W, rate=0.12)
    dlo = band_offset(qlen, tlen, W)
    touched = False
    for kernel, plain in ((myers_banded_cuda, myers_banded_plain),
                          (banded_nw_cuda, banded_nw_forward_plain)):
        launches = kernel.launches
        codes, fits = kernel(q, t, qlen, tlen, W)
        ref = plain(q, t, qlen, tlen, W)
        torch.cuda.synchronize()
        assert kernel.launches == launches + 1
        assert torch.equal(codes, ref[0]) and torch.equal(fits, ref[1])
        for rcap in (512, 4):
            out = rle_traceback_cuda(codes, qlen, tlen, dlo, W, rcap)
            ref_tb = rle_traceback_plain(codes, qlen, tlen, dlo, W, rcap)
            torch.cuda.synchronize()
            for a, b in zip(out, ref_tb):
                assert torch.equal(a, b)
            assert out[4].any() == (rcap == 4)
            touched |= bool(out[3].any())
    assert touched == (W == 32)


@pytest.mark.cuda
def test_create_aligner_on_gpu_runs_the_kernels():
    """create_aligner(device="cuda") launches each kernel, calls no plain
    version, and its optimal alignments equal the oracle."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    rng = np.random.default_rng(3)
    pairs = []
    for n in (30, 200, 700, 9000):
        qs = _random(rng, n)
        pairs.append((qs, _mutate(rng, qs, 0.03)))
    # a length difference of 45 starts at band 64, but the path runs along
    # diagonal -10 after a 10-base deletion: the Myers engine retries at 128
    a, b, x = (_random(rng, n) for n in (300, 300, 55))
    pairs.append((a + b, a[:100] + a[110:] + x + b))
    kernels = (myers_banded_cuda, banded_nw_cuda, rle_traceback_cuda)
    plains = (myers_banded_plain, banded_nw_forward_plain, rle_traceback_plain)
    launches = [k.launches for k in kernels]
    calls = [p.calls for p in plains]
    a = create_aligner(device="cuda")
    for qs, ts in pairs:
        a.add_alignment(qs, ts)
    a.align_all()
    torch.cuda.synchronize()
    assert all(k.launches > n for k, n in zip(kernels, launches))
    assert 128 in a.band_counts  # the retry ran
    assert [p.calls for p in plains] == calls
    for (qs, ts), aln in zip(pairs, a.get_alignments()):
        st = np.asarray(aln.states)
        assert (st != 2).sum() == len(qs) and (st != 3).sum() == len(ts)
        if aln.is_optimal and len(qs) < 1000:
            np.testing.assert_array_equal(st, align_cpu(qs, ts))
    dev = a.get_device_alignments()
    assert dev.metadata.device.type == "cuda" and dev.num_alignments() == len(pairs)


# -- the mapper -------------------------------------------------------------------


def _mapper_fasta(tmp_path, n=60, length=3000, seed=5):
    """n reads of about ``length`` bases from one 40-kb genome, every other
    one reverse complemented, 1 % substitutions and 0.5 % indels each (the
    port's simulators)."""
    import random

    from genomeworks_tpu_torch.core.sequence import reverse_complement
    from genomeworks_tpu_torch.io import write_fasta
    from genomeworks_tpu_torch.simulators import NoisyReadSimulator, PoissonGenomeSimulator

    genome = PoissonGenomeSimulator(seed).build_reference(40000)
    random.seed(seed)
    sim = NoisyReadSimulator()
    reads = []
    for i in range(n):
        r, _, _ = sim.generate_read(genome, length + 50 * (i % 5), snv_error_rate=0.01,
                                    insertion_error_rate=0.005, deletion_error_rate=0.005)
        reads.append((f"r{i}", reverse_complement(r) if i % 2 else r))
    path = str(tmp_path / "reads.fa")
    write_fasta(reads, path)
    return path


@pytest.mark.cuda
def test_mapper_sketch_on_gpu_equals_cpu():
    """compute_sketch on the card equals it on the CPU, packed and not, with
    reads shorter than a window."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from genomeworks_tpu_torch.mapper.minimizers import compute_sketch, pack_2bit

    rng = np.random.default_rng(21)
    reads = rng.integers(0, 4, size=(64, 3000)).astype(np.uint8)
    lens = rng.integers(1500, 3001, size=64).astype(np.int32)
    lens[:3] = (5, 20, 23)
    for k, w, hashed, packed in ((15, 10, True, False), (15, 10, True, True),
                                 (16, 1, True, False), (5, 7, False, True)):
        inp = pack_2bit(reads) if packed else reads
        gpu = compute_sketch(inp, lens, k, w, hashed, packed=packed, device="cuda")
        cpu = compute_sketch(inp, lens, k, w, hashed, packed=packed, device="cpu")
        assert gpu[0].device.type == "cuda"
        for a, b in zip(gpu, cpu):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("filtering", [1.0, 0.002])
def test_mapper_device_pipeline_on_gpu_equals_cpu(tmp_path, filtering):
    """build_index_device and get_overlaps_device_pipeline on the card equal
    the port's CPU run, as objects and as arrays."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from genomeworks_tpu_torch.io import create_fasta_parser
    from genomeworks_tpu_torch.mapper.device_pipeline import (
        build_index_device, get_overlaps_device_pipeline,
    )

    parser = create_fasta_parser(_mapper_fasta(tmp_path))
    out = {}
    for dev in ("cuda", "cpu"):
        q = build_index_device(parser, 0, 60, filtering_parameter=filtering, device=dev)
        t = build_index_device(parser, 20, 60, filtering_parameter=filtering, device=dev)
        assert q.representations.device.type == dev
        out[dev] = (q.to_host(), t.to_host(),
                    get_overlaps_device_pipeline(q, q, True),
                    get_overlaps_device_pipeline(q, t, False, as_arrays=True))
    for a, b in zip(out["cuda"][:2], out["cpu"][:2]):
        for name in ("representations", "read_ids", "positions_in_reads",
                     "directions_of_reads", "unique_representations",
                     "first_occurrence_of_representations"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert len(out["cpu"][2]) > 0 and out["cuda"][2] == out["cpu"][2]
    a, b = out["cuda"][3], out["cpu"][3]
    assert len(b) > 0
    for name in ("query_read_id", "target_read_id", "query_start", "query_end",
                 "target_start", "target_end", "rev", "num_residues"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.cuda
def test_map_reads_on_gpu_equals_host_pipeline(tmp_path):
    """map_reads(device="cuda") on the device pipeline equals the host
    pipeline (sketch on the card, NumPy after it) and the CPU run, over
    several index ranges; the mapper's phases are timed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from genomeworks_tpu_torch.core.profiling import phase_times, reset_phase_times
    from genomeworks_tpu_torch.io import create_fasta_parser
    from genomeworks_tpu_torch.mapper import MapperParams, map_reads

    parser = create_fasta_parser(_mapper_fasta(tmp_path))
    runs = {}
    for name, dev, device_pipeline in (("gpu", "cuda", True), ("host", "cuda", False),
                                       ("cpu", "cpu", True)):
        params = MapperParams(index_size_mb=0.05, target_index_size_mb=0.05,
                              filtering_parameter=0.001, device_pipeline=device_pipeline)
        reset_phase_times()
        runs[name] = map_reads(parser, parser, params, device=dev)
        if name == "gpu":
            assert phase_times()["mapper/expand_sort_chain"]["calls"] >= 3
    assert len(runs["host"]) > 0
    assert runs["gpu"] == runs["host"] == runs["cpu"]


XDROP_SETS = ["ends", "drop at xdrop", "ties", "codes 0-7", "xdrop 0", "random 20 kb",
              "drops at lane edges", "ties over kernel tiles", "ends inside lanes",
              "homologous runs", "int32 wrap"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", XDROP_SETS)
def test_xdrop_kernels_match_plain_on_gpu(case):
    """The extender's two kernels against their plain versions on the card,
    on a seeded random set and the tie, clamp and edge sets of
    ``chip_smoke.xdrop_edge_sets`` (drops at a lane's and a tile's first and
    last positions, ties across lanes and tiles, walks that end inside a
    lane, homologous runs over many tiles, int32 wrap), each of which must
    reach what it names at the kernel's lane width."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    import chip_smoke
    from genomeworks_tpu_torch.extender.xdrop_plain import count_matches_plain, xdrop_extend_plain
    from genomeworks_tpu_torch.ops.xdrop_cuda import xdrop_count_cuda, xdrop_extend_cuda

    q, t, seeds, sub, xd, width, want = chip_smoke.xdrop_edge_sets(np.random.default_rng(12))[case]
    dev = torch.device("cuda")
    qd, td = (torch.from_numpy(np.ascontiguousarray(a, np.uint8)).to(dev) for a in (q, t))
    qp, tp = (torch.from_numpy(seeds[:, i].astype(np.int32)).to(dev) for i in (0, 1))
    sd = torch.from_numpy(np.asarray(sub, np.int32).reshape(-1).copy()).to(dev)
    launches = xdrop_extend_cuda.launches
    k = xdrop_extend_cuda(qd, td, qp, tp, sd, xd)
    p = xdrop_extend_plain(qd, td, qp, tp, sd, xd, width)
    torch.cuda.synchronize()
    assert xdrop_extend_cuda.launches == launches + 1
    assert torch.equal(k, p)
    counts = xdrop_count_cuda.launches
    kc = xdrop_count_cuda(qd, td, qp, tp, k[:, 3].contiguous(), k[:, 1].contiguous())
    pc = count_matches_plain(qd, td, qp, tp, p[:, 3].contiguous(), p[:, 1].contiguous(), width)
    assert xdrop_count_cuda.launches == counts + 1
    assert torch.equal(kc, pc)
    assert want <= chip_smoke.xdrop_facts(q, t, seeds, sub, xd, p.cpu().numpy())


COUNT_SETS = ["word ends", "sequence ends", "spans", "waves"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", COUNT_SETS)
def test_xdrop_count_sets_match_plain_on_gpu(case):
    """The match-count kernel against ``count_matches_plain`` on its own
    sets (``chip_smoke.xdrop_count_sets``: crafted extents, sequences as
    views at odd and even offsets, lengths not multiples of 4, segments
    that end at every byte of a word and cross position 0 and the ends,
    spans 0, -1 and over 1,000, codes 4-7, 50,000 seeds), each of which
    must reach what it names (``chip_smoke.count_facts``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    import chip_smoke
    from genomeworks_tpu_torch.ops.xdrop_cuda import xdrop_count_cuda

    spec = chip_smoke.xdrop_count_sets(np.random.default_rng(15))[case]
    launches = xdrop_count_cuda.launches
    facts = chip_smoke.count_compare(spec, torch.device("cuda"))
    assert xdrop_count_cuda.launches == launches + 1
    assert spec["want"] <= facts, sorted(spec["want"] - facts)


@pytest.mark.cuda
def test_block_nw_runs_the_sv_pairs_on_gpu():
    """create_aligner(max_bandwidth=1024, device="cuda") on 32 pairs of 10
    kb whose targets lack 600-900 bases (``chip_smoke.sv_pairs``): every
    pair at band 1024 in one launch of the block NW, no plain call; the
    first eight optimal paths equal align_cpu's (``chip_smoke.align_rows``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    import chip_smoke

    sv = chip_smoke.sv_pairs(np.random.default_rng(15))
    launches, calls = banded_nw_cuda.launches, banded_nw_forward_plain.calls
    a = create_aligner(max_bandwidth=1024, device="cuda")
    for qs, ts in sv:
        assert a.add_alignment(qs, ts) == 0
    a.align_all()
    torch.cuda.synchronize()
    assert dict(a.band_counts) == {1024: len(sv)}
    assert banded_nw_cuda.launches == launches + 1 and banded_nw_forward_plain.calls == calls
    alns = a.get_alignments()
    optimal = [b for b, aln in enumerate(alns) if aln.is_optimal][:8]
    assert optimal
    for b in optimal:
        np.testing.assert_array_equal(alns[b].states, chip_smoke.align_rows(*sv[b]))


MYERS_SCORE_SETS = ["word edges", *(f"npl {k}" for k in range(1, 17)), "chunked",
                    "3-4 chunks", "1024 x 2 kb"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MYERS_SCORE_SETS)
def test_myers_score_kernel_matches_plain_on_gpu(case):
    """myers_score_kernel against its plain version (on the host: its word
    chain is a loop of launches a word a target position), one launch a set:
    empty queries, queries at a word's edges and mutated 300-bp pairs (and
    the batched distances against myers_edit_distance_cpu); the sets of
    ``chip_smoke.myers_score_edge_sets``, query lengths 0, 1 and 32 j +- 1 at
    every words-a-lane step and past the chunk edge, and queries of one to
    four chunks (to 49,153 bases: middle chunks that read the carries below
    while they store their own), short targets, an empty one in each; and
    phase 5's 1,024 pairs of 2 kb."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    import chip_smoke
    from genomeworks_tpu_torch.aligner.myers import (
        myers_edit_distance_batched, myers_edit_distance_cpu, myers_inputs, myers_score_plain,
    )
    from genomeworks_tpu_torch.ops.myers_score_cuda import (
        MAX_WORDS_PER_LANE, chunked, load_library, myers_score_cuda,
    )

    rng = np.random.default_rng(21)
    if case == "word edges":
        qs = [_random(rng, n) for n in (0, 1, 31, 32, 33, 63, 64, 65, 96, 97, 300, 300)] + [""]
        ts = [_mutate(rng, q, 0.1) if q else _random(rng, 9) for q in qs[:-1]] + [""]
    elif case == "1024 x 2 kb":
        pairs = chip_smoke.random_pairs(np.random.default_rng(2025), 1024, 2000, 0.04, 0.01,
                                        0.01)
        qs, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    else:
        qs, ts = chip_smoke.myers_score_edge_sets(np.random.default_rng(14))[case]
    peq, tc, ql, tl = myers_inputs(qs, ts)
    n_words = peq.shape[2]
    npl = load_library().myers_score_words_per_lane(n_words)
    if case.startswith("npl"):
        assert npl == int(case.split()[1]) and not chunked(n_words)
    if case == "chunked":
        assert npl == MAX_WORDS_PER_LANE and chunked(n_words)
    if case == "3-4 chunks":
        assert npl == MAX_WORDS_PER_LANE and set(chip_smoke.myers_chunks(ql)) == {1, 2, 3, 4}
    args = [torch.from_numpy(a) for a in (peq.view(np.int32), tc, ql, tl)]
    launches = myers_score_cuda.launches
    out = myers_score_cuda(*(a.cuda() for a in args))
    torch.cuda.synchronize()
    assert myers_score_cuda.launches == launches + 1
    assert torch.equal(out.cpu(), myers_score_plain(*args))
    if case == "word edges":
        got = myers_edit_distance_batched(qs, ts).tolist()
        assert myers_score_cuda.launches == launches + 2
        assert got == [myers_edit_distance_cpu(t, q) for q, t in zip(qs, ts)]


@pytest.mark.cuda
def test_create_extender_without_a_card_raises(monkeypatch):
    """The extender and the batched Myers distance default to the card and
    raise without one; the CPU is used only when named."""
    from genomeworks_tpu_torch.aligner.myers import myers_edit_distance_batched
    from genomeworks_tpu_torch.core.device import DeviceRuntimeError
    from genomeworks_tpu_torch.extender import create_extender

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceRuntimeError):
        create_extender()
    with pytest.raises(DeviceRuntimeError):
        myers_edit_distance_batched(["ACGT"], ["ACG"])
    assert create_extender(device="cpu").device.type == "cpu"


NW_DIST_SETS = [32, 1024, "bands", "widest", "w16384", "identical", "diagonal-ends", "qlen16",
                "long-indels", "drift", "empty", "rcap", "dense-10kb", "myers-rows",
                "myers-narrow", "myers-unfit", *BLOCK_NW_SETS]


@pytest.mark.cuda
@pytest.mark.parametrize("case", NW_DIST_SETS)
def test_nw_dist_output_matches_plain_on_gpu(case):
    """The banded NW kernel's distance output (``with_dist``, the sharded
    aligner step's launch) against ``banded_nw_final_plain`` on the same
    CUDA tensors, bit for bit, with the same codes and fits as the launch
    without it: on random pairs at W = 32 (the warp kernel) and 1024 (the
    block kernel), and on every edge set of the row-10 kernel
    (``chip_smoke.aligner_edge_sets`` with the NW among its forwards), whose
    bands reach both kernels, an empty query, an empty target and pairs
    that do not fit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    from genomeworks_tpu_torch.aligner.banded_nw import INF, banded_nw_final_plain
    from genomeworks_tpu_torch.ops import banded_nw_cuda as nw

    if isinstance(case, int):
        runs = [(_pairs(B=24, M=256, seed=case, rate=0.12), case)]
    else:
        import chip_smoke

        warp_max = nw.load_library().banded_nw_warp_max_band()
        spec = chip_smoke.aligner_edge_sets(np.random.default_rng(8), warp_max)[case]
        assert "banded_nw_cuda" in spec["forwards"]
        inputs = chip_smoke.edge_pack(spec, torch.device("cuda"))
        runs = [(inputs, W) for W in spec["bands"]]
    for (q, t, qlen, tlen), W in runs:
        launches = nw.banded_nw_cuda.launches
        dist, codes, fits = nw.banded_nw_cuda(q, t, qlen, tlen, W, with_dist=True)
        ref = banded_nw_final_plain(q, t, qlen, tlen, W)
        plain_codes, plain_fits = nw.banded_nw_cuda(q, t, qlen, tlen, W)
        torch.cuda.synchronize()
        assert nw.banded_nw_cuda.launches == launches + 2
        assert dist.dtype == torch.int32
        for a, b in zip((dist, codes, fits), ref, strict=True):
            assert torch.equal(a, b)
        assert torch.equal(codes, plain_codes) and torch.equal(fits, plain_fits)
        assert torch.equal(dist[~fits], torch.full_like(dist[~fits], INF))
        empty_q = fits & (qlen == 0)
        assert torch.equal(dist[empty_q], tlen[empty_q])


@pytest.mark.cuda
def test_sharded_poa_one_nccl_rank_on_gpu():
    """``poa_batch_consensus_sharded`` in a one-rank NCCL group on the card
    (loopback rendezvous): covid windows 0-63 equal their golden lines,
    through the per-window kernel, with no plain call; the group's
    collectives move tensors on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    import os
    import socket
    from datetime import timedelta

    import torch.distributed as dist

    from genomeworks_tpu_torch.parallel.mesh import make_mesh
    from genomeworks_tpu_torch.parallel.sharded import poa_batch_consensus_sharded
    from genomeworks_tpu_torch.poa.windows import load_golden_lines, load_window_file

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    covid = load_window_file(os.path.join(data, "poa_windows_covid.txt.gz"))[:64]
    golden = load_golden_lines(os.path.join(data, "poa_golden_covid.txt"))[:64]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0, timeout=timedelta(seconds=60))
    try:
        mesh = make_mesh()
        assert (mesh.size, mesh.comm_device.type) == (1, "cuda")
        launches, calls = poa_consensus_cuda.launches, torch_poa.poa_consensus_plain.calls
        cons, cov, st = poa_batch_consensus_sharded(covid, mesh)
        assert poa_consensus_cuda.launches > launches
        assert torch_poa.poa_consensus_plain.calls == calls
    finally:
        dist.destroy_process_group()
    assert st == [0] * 64 and cons == golden
    assert [len(c) for c in cov] == [len(c) for c in cons]
