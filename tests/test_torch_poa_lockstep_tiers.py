"""The port's lockstep tier and its re-run, end to end on window sets that
the tier flags (a small ring, overflowing edge lists and node caps) or does
not serve (the tiny long tail), held against jax_poa's XLA chain
(``use_pallas=False, use_lockstep=False``) and the covid golden.

A window the tier flags (its own codes 1, 5, 6) or does not serve (99) is
re-run through the per-window tier at the caller's caps; the final result
of every window must equal the XLA chain's, and ``tier_stats`` counts
served, flagged and unserved windows apart. Inputs are seeded numpy; every
comparison is exact (integer arithmetic, no tolerance). The phase-by-phase
parity of the tier is in tests/test_torch_poa_lockstep.py.
"""

import os

import numpy as np

from genomeworks_tpu.poa import jax_poa
from genomeworks_tpu.simulators.genomesim import generate_random_genome, mutate_sequence
from genomeworks_tpu_torch.poa import (
    BandMode,
    get_multi_batch_sizes,
    load_golden_lines,
    load_window_file,
    lockstep,
    torch_poa,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")


def _windows(B, S, Lb, seed, sub=0.05, indel=0.05):
    rng = np.random.default_rng(seed)
    windows = []
    for _ in range(B):
        t = generate_random_genome(Lb, rng)
        windows.append([t] + [mutate_sequence(t, rng, sub, indel) for _ in range(S - 1)])
    return windows


def _assert_same(ref, out):
    c1, v1, s1 = ref
    c2, v2, s2 = out
    assert list(s2) == list(s1)
    assert c2 == c1
    for a, b in zip(v1, v2):
        np.testing.assert_array_equal(b, a)


def _through_tier(monkeypatch, windows, **kw):
    """The port's tier + re-run on the CPU; returns (result, tier_stats, the
    statuses the tier itself gave, before the re-run)."""
    tier = lockstep.poa_batch_consensus_lockstep
    raw = []

    def spy(*a, **k):
        out = tier(*a, **k)
        raw.append(list(out[2]))
        return out

    with monkeypatch.context() as m:
        m.setattr(lockstep, "poa_batch_consensus_lockstep", spy)
        lockstep.reset_tier_stats()
        out = torch_poa.poa_batch_consensus(windows, device="cpu", use_lockstep=True, **kw)
    return out, dict(lockstep.tier_stats), raw[0]


def _stats(served, overflow, unserved):
    return {"lockstep_windows": served, "lockstep_overflow_windows": overflow,
            "lockstep_unserved_windows": unserved}


def _with_plan(monkeypatch, N=None, D=None):
    """Replace the tier's plan by one with the node cap N and/or ring D."""
    plan = lockstep.lockstep_plan

    def patched(L, max_nodes=None):
        n, d, lp = plan(L, max_nodes)
        return N or n, D or d, lp

    monkeypatch.setattr(lockstep, "lockstep_plan", patched)


def test_small_ring_windows_rerun_to_the_xla_chain(monkeypatch):
    """A ring of D = 4 flags windows as code 5; after the re-run every
    window equals the XLA chain, and they count as overflow."""
    windows = _windows(8, 5, 45, seed=13, sub=0.06, indel=0.06)
    _with_plan(monkeypatch, D=4)
    ref = jax_poa.poa_batch_consensus(windows, use_pallas=False, use_lockstep=False)
    out, stats, flagged = _through_tier(monkeypatch, windows)
    n5 = flagged.count(5)
    assert n5 > 0 and set(flagged) <= {0, 5}
    _assert_same(ref, out)
    assert stats == _stats(8 - n5, n5, 0)


def _capped_windows():
    """16 reads at about 20 % error: node counts and edge lists overflow.
    Window 21 has a 65-base read, which puts the bucket at N = 192, where
    edge lists overflow before the node cap in some windows."""
    w = _windows(24, 16, 45, seed=17, sub=0.2, indel=0.2)
    return w[:12] + w[21:22]


def test_edge_cap_windows_rerun_to_the_xla_chain(monkeypatch):
    """The tier flags edge-list overflows (code 6) and re-runs them at the
    caller's caps; every window equals the XLA chain."""
    windows = _capped_windows()
    ref = jax_poa.poa_batch_consensus(windows, use_pallas=False, use_lockstep=False)
    out, stats, direct = _through_tier(monkeypatch, windows)
    assert 6 in direct and set(direct) <= {0, 1, 6}
    _assert_same(ref, out)
    nz = sum(s != 0 for s in direct)
    assert stats == _stats(13 - nz, nz, 0)


def test_status_precedence_is_the_xla_chains(monkeypatch):
    """Windows that overflow both the node cap (code 1 at N = 128) and an
    edge list (code 6 once N is raised to 640) end with the XLA chain's
    status at those caps (its clique precedence, 1 or 2), as every window
    does: the tier's own code only routes a window to the re-run. The XLA
    lists are one slot wider (E = 8), so that they overflow where the
    tier's do."""
    windows = _capped_windows()[:8]  # at N = 128
    kw = dict(max_nodes=128, max_edges=8, max_alignments=8)
    ref = jax_poa.poa_batch_consensus(windows, use_pallas=False, use_lockstep=False, **kw)
    out, stats, direct = _through_tier(monkeypatch, windows, **kw)
    _assert_same(ref, out)
    with monkeypatch.context() as m:
        _with_plan(m, N=640)
        wide = lockstep.poa_batch_consensus_lockstep(windows, device="cpu")[2]
    both = [b for b in range(len(windows)) if direct[b] == 1 and wide[b] == 6]
    assert both, "the set must hold a window that overflows both caps"
    assert all(ref[2][b] in (1, 2) for b in both)
    nz = sum(s != 0 for s in direct)
    assert stats == _stats(8 - nz, nz, 0)


def test_tiny_long_tail_is_unserved_and_rerun(monkeypatch):
    """256 short windows and 3 long ones: the long tail is not served
    (status 99, counted apart from overflow) and is re-run."""
    windows = _windows(256, 2, 20, seed=19) + _windows(3, 2, 70, seed=23)
    ref = jax_poa.poa_batch_consensus(windows, use_pallas=False, use_lockstep=False)
    out, stats, direct = _through_tier(monkeypatch, windows)
    assert direct == [0] * 256 + [lockstep.UNSERVED] * 3
    _assert_same(ref, out)
    assert stats == _stats(256, 0, 3)


def test_covid_prefix_through_the_tier_equals_golden():
    """The first covid windows, binned and capped as PoaBatch bins them,
    through the tier: all served, all equal to the golden lines."""
    n_windows = 2
    windows = load_window_file(os.path.join(DATA, "poa_windows_covid.txt.gz"), limit=n_windows)
    golden = load_golden_lines(os.path.join(DATA, "poa_golden_covid.txt"), limit=n_windows)
    configs, groups = get_multi_batch_sizes(windows, band_mode=BandMode.full_band)
    got = {}
    lockstep.reset_tier_stats()
    for cfg, wids in zip(configs, groups):
        ws = [windows[i] for i in wids]
        ones = [[np.ones(len(s), np.int32) for s in w] for w in ws]
        cons, _, status = torch_poa.poa_batch_consensus(
            ws, max_nodes=cfg.max_nodes_per_graph, weights=ones, device="cpu",
            use_lockstep=True)
        assert status == [0] * len(ws)
        got.update(zip(wids, cons))
    assert [got[i] for i in range(len(windows))] == golden
    assert lockstep.tier_stats == _stats(n_windows, 0, 0)
