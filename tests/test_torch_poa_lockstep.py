"""The port's lockstep POA tier (genomeworks_tpu_torch.poa.lockstep and its
plain phases, poa/lockstep_plain.py) held against the JAX package.

Parity targets: jax_poa's XLA chain (``use_pallas=False,
use_lockstep=False``) end to end, and its phase functions
(``nw_batched_fast``, ``add_alignment_batched_seq``, ``topsort_batched``,
``consensus_batched``) phase by phase; the JAX package's ``lockstep_plan``
and length buckets for routing; ``cpu_reference`` and the covid golden.
Never a Pallas interpret-mode run. Inputs are seeded numpy. Every
comparison is EXACT equality: the chain is integer arithmetic (int32
scores, ASCII bases), so there is no tolerance to state.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomeworks_tpu.poa import jax_poa
from genomeworks_tpu.poa import lockstep as jax_lockstep
from genomeworks_tpu.simulators.genomesim import generate_random_genome, mutate_sequence
from genomeworks_tpu_torch.ops import poa_lockstep_cuda as lk
from genomeworks_tpu_torch.poa import (
    cpu_reference,
    lockstep,
    lockstep_plain,
    torch_poa,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_xla_add = jax.jit(jax_poa.add_alignment_batched_seq)


def _windows(B, S, Lb, seed, sub=0.05, indel=0.05):
    rng = np.random.default_rng(seed)
    windows = []
    for _ in range(B):
        t = generate_random_genome(Lb, rng)
        windows.append([t] + [mutate_sequence(t, rng, sub, indel) for _ in range(S - 1)])
    return windows, rng


def _assert_same(ref, out):
    c1, v1, s1 = ref
    c2, v2, s2 = out
    assert list(s2) == list(s1)
    assert c2 == c1
    for a, b in zip(v1, v2):
        np.testing.assert_array_equal(b, a)


def _through_tier(windows, **kw):
    """The port's tier + re-run on the CPU; returns (result, tier_stats)."""
    lockstep.reset_tier_stats()
    out = torch_poa.poa_batch_consensus(windows, device="cpu", use_lockstep=True, **kw)
    return out, dict(lockstep.tier_stats)


def _stats(served, overflow, unserved):
    return {"lockstep_windows": served, "lockstep_overflow_windows": overflow,
            "lockstep_unserved_windows": unserved}


# -- routing ----------------------------------------------------------------------


def test_lockstep_plan_matches_jax():
    for L in range(32, 769, 8):
        for max_nodes in (None, 128, 200, 320, 640, 1000):
            assert lockstep.lockstep_plan(L, max_nodes) == jax_lockstep.lockstep_plan(
                L, max_nodes), (L, max_nodes)
    # PoaBatch's max_nodes_per_graph clamps N (test_poa_lockstep.py:98-102)
    assert lockstep.lockstep_plan(60, max_nodes=128)[0] <= 128
    assert lockstep.lockstep_plan(200, max_nodes=128) is None


def test_length_buckets_match_jax():
    rng = np.random.default_rng(3)
    for n_short, n_long in ((300, 5), (300, 40), (20, 3), (600, 0)):
        lens = list(rng.integers(30, 200, n_short)) + list(rng.integers(300, 700, n_long))
        assert lockstep._bucket_windows(lens) == jax_lockstep._bucket_windows(lens)


def test_routing_rule_follows_jax():
    """use_lockstep=None takes the tier on the card for 64 windows or more
    at E >= 7 and A >= 8 (jax_poa.py:1634-1640), never on the CPU."""
    rule = torch_poa.lockstep_by_default
    assert rule("cuda", 64, 50, 50) and rule("cuda", 5776, 7, 8)
    assert not rule("cuda", 63, 50, 50)
    assert not rule("cuda", 64, 6, 50) and not rule("cuda", 64, 50, 7)
    assert not rule("cpu", 5776, 50, 50)
    windows, _ = _windows(64, 2, 20, seed=9)
    lockstep.reset_tier_stats()
    torch_poa.poa_batch_consensus(windows, device="cpu")
    assert sum(lockstep.tier_stats.values()) == 0


# -- phase by phase -----------------------------------------------------------------


def _pack(windows, weights):
    B = len(windows)
    S = max(len(w) for w in windows)
    L = max(len(s) for w in windows for s in w)
    seqs = np.zeros((B, S, L), np.uint8)
    wts = np.ones((B, S, L), np.int32)
    lens = np.zeros((B, S), np.int32)
    for b, w in enumerate(windows):
        for s, seq in enumerate(w):
            seqs[b, s, :len(seq)] = np.frombuffer(seq.encode(), np.uint8)
            if weights is not None:
                wts[b, s, :len(seq)] = weights[b][s]
            lens[b, s] = len(seq)
    return seqs, wts, lens, np.array([len(w) for w in windows], np.int32), L


def _mine(st_jax, E=lockstep_plain.E_LK):
    """A JAX state (lists one slot wider) as the port's lockstep state."""
    st = {k: np.asarray(v) for k, v in st_jax.items()}
    for k in ("in_edges", "in_w", "out_edges"):
        st[k] = st[k][:, :, :E]
    return torch_poa.state_from_numpy(st)


def _run_phases(windows, weights, D, N, fused=False):
    """Each read of ``windows`` through the port's plain phases and the XLA
    phases, both fed the same XLA graph state. The XLA state's lists are one
    slot wider (E = 8, A = 8), so that its list-overflow test (a list that
    reaches E) fires where the lockstep cap does (a list that would exceed
    7). With ``fused``, ``read_lockstep`` also runs on the state the port's
    NW left, and must leave the state the XLA add and topsort leave after
    the same traceback, with the same klen. Returns the errors seen: {xla
    code: {port codes}}."""
    seqs, wts, lens, nseqs, L = _pack(windows, weights)
    B, S = lens.shape
    Lp = 8 * ((L + 1 + 7) // 8)
    K = lockstep.walk_len(N, L)
    gap, mismatch, match = -8, -6, 8
    t = torch.from_numpy
    st = jax_poa.init_graph_state(B, N, 8, 8)
    st = jax_poa.build_backbone_batched(
        st, jnp.asarray(seqs[:, 0].astype(np.int32)), jnp.asarray(lens[:, 0]),
        jnp.asarray(wts[:, 0]), jnp.ones(B, bool))
    seen: dict = {}
    live = np.ones(B, bool)  # no error so far
    for s in range(1, S):
        active = (nseqs > s) & live
        read = seqs[:, s].astype(np.int32)
        # NW + traceback against nw_batched_fast; far <=> code 5
        ag, ar, k, failed, far = jax_poa.nw_batched_fast(
            st, jnp.asarray(read), jnp.asarray(lens[:, s]), jnp.asarray(active),
            gap=gap, mismatch=mismatch, match=match, max_dist=D, n_rows=N)
        ag, ar, k, far = (np.array(x) for x in (ag, ar, k, far))
        assert not np.asarray(failed).any()
        mine = _mine(st)
        codes = torch.full((B, N, Lp), 255, dtype=torch.uint8)
        act = t(active)
        best_i = lk.nw_lockstep(mine, t(seqs[:, s].copy()), t(lens[:, s].copy()), act, codes, D,
                                gap, mismatch, match)
        if fused:  # on the state the NW left
            fused_st = {k: v.clone() for k, v in mine.items()}
            w = None if weights is None else t(wts[:, s].copy())
            klen_f = lk.read_lockstep(fused_st, codes, best_i, t(lens[:, s].copy()),
                                      t(seqs[:, s].copy()), w, act, K)
            np.testing.assert_array_equal(klen_f.numpy(), k, err_msg=f"fused klen s={s}")
        ag2, ar2, klen = lk.tb_lockstep(mine, codes, best_i, t(lens[:, s].copy()), act, K)
        err = mine["error"].numpy()
        np.testing.assert_array_equal(err == 5, far, err_msg=f"far s={s}")
        np.testing.assert_array_equal(klen.numpy(), k, err_msg=f"klen s={s}")
        for b in np.flatnonzero(active & ~far):
            np.testing.assert_array_equal(ag2[b, :k[b]].numpy(), ag[b, :k[b]])
            np.testing.assert_array_equal(ar2[b, :k[b]].numpy(), ar[b, :k[b]])
        seen.setdefault("far", set()).update(set(err[far].tolist()))
        active &= ~far
        live &= ~far
        # add against add_alignment_batched_seq
        mine = _mine(st)
        ag_j, ar_j, k_j = jnp.asarray(ag), jnp.asarray(ar), jnp.asarray(k)
        st = _xla_add(st, ag_j, ar_j, k_j, jnp.asarray(read),
                                               jnp.asarray(wts[:, s]), jnp.asarray(active))
        w = None if weights is None else t(wts[:, s].copy())
        lk.add_lockstep(mine, t(ag), t(ar), t(k), t(seqs[:, s].copy()), w, t(active))
        x_err = np.asarray(st["error"])
        m_err = mine["error"].numpy()
        for b in np.flatnonzero(active):
            seen.setdefault(int(x_err[b]), set()).add(int(m_err[b]))
        ok = active & (x_err == 0)
        np.testing.assert_array_equal(m_err[ok], 0)
        ref = _mine(st)
        for key in torch_poa.STATE_KEYS:
            np.testing.assert_array_equal(mine[key].numpy()[ok], ref[key].numpy()[ok],
                                          err_msg=f"add {key} s={s}")
        live &= x_err == 0
        # topological sort against topsort_batched
        mine = _mine(st)
        mine["sorted"].fill_(-7)  # the port leaves positions past node_count
        lk.topsort_lockstep(mine, t(ok))
        st = jax_poa.topsort_batched(st, jnp.asarray(ok))
        ref = _mine(st)
        inside = np.arange(N)[None, :] < ref["node_count"].numpy()[:, None]
        for key in ("sorted", "pos_of", "error"):
            a, b = mine[key].numpy(), ref[key].numpy()
            sel = ok[:, None] & inside if a.ndim == 2 else ok
            np.testing.assert_array_equal(a[sel], b[sel], err_msg=f"topsort {key} s={s}")
        assert (mine["sorted"].numpy()[ok[:, None] & ~inside] == -7).all()
        if fused:  # the fused read against the XLA add + topsort
            f_err = fused_st["error"].numpy()
            for b in np.flatnonzero(active):
                seen.setdefault(("fused", int(x_err[b])), set()).add(int(f_err[b]))
            np.testing.assert_array_equal(f_err[ok], 0)
            for key in torch_poa.STATE_KEYS:
                a, b = fused_st[key].numpy(), ref[key].numpy()
                sel = ok[:, None] & inside if key in ("sorted", "pos_of") else ok
                np.testing.assert_array_equal(a[sel], b[sel], err_msg=f"fused {key} s={s}")
    # consensus against consensus_batched
    act = live
    out = lk.consensus_lockstep(_mine(st), torch.from_numpy(act))
    ref = jax_poa.consensus_batched(st, jnp.asarray(act))
    for name, a, b in zip(("cons", "cov", "length", "err"), ref, out):
        np.testing.assert_array_equal(b.numpy().astype(np.int32), np.asarray(a), err_msg=name)
    return seen


@pytest.mark.parametrize("case", ["unit", "weighted", "capped"])
def test_phases_match_xla(case):
    """nw + tb, add, topsort and consensus, each fed the XLA state, equal
    the XLA phases. unit/weighted: a small ring (D = 3) flags far windows as
    code 5 and nothing else errs. capped: 16 reads at 20 % error overflow an
    edge list where the XLA walk (lists one slot wider) reports 2, and the
    port reports 6 (or 1 where the same step overflowed the node cap: the
    first error wins)."""
    if case == "capped":
        windows, _ = _windows(8, 16, 30, seed=5, sub=0.2, indel=0.2)
        seen = _run_phases(windows, None, D=16, N=192)
        assert 6 in seen[2] and seen[2] <= {6, 1}
        assert seen.get(1, {1}) == {1} and seen[0] == {0}
        return
    windows, rng = _windows(12, 6, 40, seed=2)
    for b in range(0, 12, 3):
        windows[b] = windows[b][:2 + b % 4]
    weights = [[rng.integers(1, 5, size=len(s)).astype(np.int32) for s in w]
               for w in windows] if case == "weighted" else None
    seen = _run_phases(windows, weights, D=3, N=128)
    assert seen["far"] == {5}, "the set must reach a predecessor beyond D"
    assert set(seen) == {0, "far"} and seen[0] == {0}


@pytest.mark.parametrize("case", ["unit", "weighted", "capped"])
def test_read_lockstep_matches_xla_add_and_topsort(case):
    """read_lockstep (the fused traceback, add and topsort the main path
    launches a read) on the CPU, from the state the port's NW left, equals
    the XLA add_alignment_batched_seq + topsort_batched after the same
    traceback (nw_batched_fast's), state and klen, on the cases of
    test_phases_match_xla; where the XLA add errs, the fused read reports
    the port's codes as the add alone does."""
    if case == "capped":
        windows, _ = _windows(8, 16, 30, seed=5, sub=0.2, indel=0.2)
        seen = _run_phases(windows, None, D=16, N=192, fused=True)
        assert 6 in seen[("fused", 2)] and seen[("fused", 2)] <= {6, 1}
        assert seen[("fused", 0)] == {0}
        return
    windows, rng = _windows(12, 6, 40, seed=2)
    for b in range(0, 12, 3):
        windows[b] = windows[b][:2 + b % 4]
    weights = [[rng.integers(1, 5, size=len(s)).astype(np.int32) for s in w]
               for w in windows] if case == "weighted" else None
    seen = _run_phases(windows, weights, D=3, N=128, fused=True)
    assert seen["far"] == {5} and seen[("fused", 0)] == {0}


# -- end to end -----------------------------------------------------------------


def test_tier_equals_xla_chain_unit_weights():
    windows, _ = _windows(128, 5, 60, seed=7)
    for i in range(0, 128, 7):
        windows[i] = windows[i][: 2 + (i % 4)]
    ref = jax_poa.poa_batch_consensus(windows, use_pallas=False, use_lockstep=False)
    out, stats = _through_tier(windows)
    _assert_same(ref, out)
    assert stats == _stats(128, 0, 0)


def test_tier_equals_xla_chain_weighted():
    windows, rng = _windows(128, 4, 50, seed=11)
    weights = [[rng.integers(1, 5, size=len(s)).astype(np.int32) for s in w] for w in windows]
    ref = jax_poa.poa_batch_consensus(windows, weights=weights, use_pallas=False,
                                      use_lockstep=False)
    out, stats = _through_tier(windows, weights=weights)
    _assert_same(ref, out)
    assert stats == _stats(128, 0, 0)


def test_int32_scores_where_an_int16_ring_would_clip():
    """About 600 bp windows at gap = -30 (the i16 ring clip's case): the
    tier serves them (status 0) and equals cpu_reference.poa_consensus.
    Substitutions only, so predecessor distances stay under the plan's D."""
    windows, _ = _windows(3, 3, 600, seed=31, sub=0.015, indel=0.0)
    assert lockstep.lockstep_plan(lockstep.chain_len([600])) == (640, 32, 616)
    cons, cov, status = lockstep.poa_batch_consensus_lockstep(windows, gap=-30,
                                                              device="cpu")
    assert status == [0, 0, 0]
    for w, c, v in zip(windows, cons, cov):
        rc, rv = cpu_reference.poa_consensus(w, gap=-30)
        assert c == rc
        np.testing.assert_array_equal(v, rv)


# -- wrappers and imports ---------------------------------------------------------


def test_wrappers_on_cpu_run_the_plain_phases():
    """On CPU tensors each wrapper is its plain version (counted), and no
    kernel launch is counted; wrong types, shapes and layouts raise."""
    windows, _ = _windows(4, 3, 30, seed=37)
    calls = [f.calls for f in (lockstep_plain.nw_lockstep_plain,
                               lockstep_plain.tb_lockstep_plain,
                               lockstep_plain.add_lockstep_plain,
                               lockstep_plain.topsort_lockstep_plain,
                               lockstep_plain.consensus_lockstep_plain,
                               lockstep_plain.read_lockstep_plain)]
    launches = [k.launches for k in lk.KERNELS]
    assert lockstep.poa_batch_consensus_lockstep(windows, device="cpu")[2] == [0] * 4
    assert lockstep_plain.nw_lockstep_plain.calls == calls[0] + 2
    # each read's traceback, add and topsort: read_lockstep, the plain composition
    assert lockstep_plain.read_lockstep_plain.calls == calls[5] + 2
    assert [f.calls for f in (lockstep_plain.tb_lockstep_plain, lockstep_plain.add_lockstep_plain,
                              lockstep_plain.topsort_lockstep_plain)] == [c + 2 for c in calls[1:4]]
    assert lockstep_plain.consensus_lockstep_plain.calls == calls[4] + 1
    assert [k.launches for k in lk.KERNELS] == launches

    st = torch_poa.init_graph_state(4, 64, 7, 8)
    act = torch.ones(4, dtype=torch.bool)
    read, rl = torch.zeros((4, 30), dtype=torch.uint8), torch.zeros(4, dtype=torch.int32)
    codes = torch.zeros((4, 64, 32), dtype=torch.uint8)
    with pytest.raises(TypeError):
        lk.nw_lockstep(st, read.to(torch.int32), rl, act, codes, 8, -8, -6, 8)
    with pytest.raises(TypeError):
        lk.topsort_lockstep(st, act.to(torch.int32))
    with pytest.raises(ValueError):
        lk.nw_lockstep(st, read, rl, act, codes[:, :, :30], 8, -8, -6, 8)
    with pytest.raises(ValueError):
        bad = dict(st, in_w=st["in_w"].transpose(1, 2).contiguous().transpose(1, 2))
        lk.topsort_lockstep(bad, act)
    with pytest.raises(ValueError):
        lk.tb_lockstep(st, codes, rl[:3], rl, act, 100)
    with pytest.raises(ValueError):
        lk.read_lockstep(st, codes, rl, rl, read, None, act, 0)
    with pytest.raises(TypeError):
        lk.read_lockstep(st, codes, rl, rl, read.to(torch.int32), None, act, 100)
    with pytest.raises(ValueError):
        lk.read_lockstep(st, codes, rl, rl, read, torch.ones((4, 29), dtype=torch.int32), act,
                         100)
    with pytest.raises(ValueError, match="non-empty first read"):
        lockstep.poa_batch_consensus_lockstep([["", "ACGT"]], device="cpu")


def test_lockstep_modules_import_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import genomeworks_tpu_torch.poa.lockstep_plain\n"
        "import genomeworks_tpu_torch.ops.poa_lockstep_cuda\n"
        "import genomeworks_tpu_torch.poa.lockstep as lk\n"
        "import genomeworks_tpu_torch.poa as p\n"
        "w = [['ACGTACGTAC', 'ACGTTACGTAC', 'ACGACGTAC']] * 3\n"
        "c, v, s = p.poa_batch_consensus(w, max_nodes=128, device='cpu', use_lockstep=True)\n"
        "assert s == [0] * 3 and p.tier_stats['lockstep_windows'] == 3, (c, s)\n"
        "assert not any(m == 'genomeworks_tpu' or m.startswith(('genomeworks_tpu.', 'jax.'))"
        " for m in sys.modules), 'reference package imported'\n"
        "print(c[0])\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    expected, _ = cpu_reference.poa_consensus(["ACGTACGTAC", "ACGTTACGTAC", "ACGACGTAC"])
    assert proc.stdout.strip() == expected
