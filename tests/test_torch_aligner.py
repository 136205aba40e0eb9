"""The PyTorch/CUDA port of the banded aligner (genomeworks_tpu_torch.aligner)
held against the JAX package.

Parity targets: the NumPy word model ``myers_banded_codes(windowed=True)``,
the XLA scan ``banded_nw_forward``, the NumPy walk ``traceback_host_packed``,
``align_cpu``, and ``Aligner(use_pallas=False)``; never a Pallas kernel, not
even in interpret mode. Inputs are seeded numpy. Every comparison is EXACT
equality: the aligner is integer arithmetic throughout, so there is no
tolerance to state.
"""

import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomeworks_tpu.aligner import Aligner as JAligner
from genomeworks_tpu.aligner import banded_nw as jnw
from genomeworks_tpu.aligner import cpu_reference as jref
from genomeworks_tpu.aligner import types as jtypes
from genomeworks_tpu.aligner.myers_banded_model import myers_banded_codes
from genomeworks_tpu.core import bucketing as jbucketing
from genomeworks_tpu.core import sequence as jsequence
from genomeworks_tpu.ops.banded_nw_pallas import traceback_host_packed
from genomeworks_tpu.simulators.genomesim import generate_random_genome, mutate_sequence
from genomeworks_tpu_torch.aligner import (
    Aligner,
    CigarFormat,
    FixedBandAligner,
    align_cpu,
    create_aligner,
    states_to_cigar,
)
from genomeworks_tpu_torch.aligner import cpu_reference as tref
from genomeworks_tpu_torch.aligner import types as ttypes
from genomeworks_tpu_torch.aligner.banded_nw import (
    band_offset,
    banded_nw_final_plain,
    banded_nw_forward_plain,
    planes_from_numpy,
    planes_to_numpy,
)
from genomeworks_tpu_torch.aligner.myers_banded_model import myers_banded_plain
from genomeworks_tpu_torch.aligner.rle_traceback import rle_traceback_plain, runs_to_states
from genomeworks_tpu_torch.core import bucketing as tbucketing
from genomeworks_tpu_torch.core import sequence as tsequence
from genomeworks_tpu_torch.ops.banded_nw_cuda import banded_nw_cuda
from genomeworks_tpu_torch.ops.myers_banded_cuda import myers_banded_cuda
from genomeworks_tpu_torch.ops.rle_traceback_cuda import rle_traceback_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_batch(B, M, seed, lo=20, hi=None, rate=0.12):
    """The batches of tests/test_myers_banded.py: a random query of lo..hi
    bases and a mutated target cut to M, padded with 0."""
    rng = np.random.default_rng(seed)
    hi = hi or M - 16
    q = np.zeros((B, M), np.uint8)
    t = np.zeros((B, M), np.uint8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for b in range(B):
        qs = generate_random_genome(int(rng.integers(lo, hi)), rng)
        ts = mutate_sequence(qs, rng, rate, rate)[:M]
        qc, tc = jsequence.encode_bases(qs), jsequence.encode_bases(ts)
        q[b, : len(qc)] = qc
        t[b, : len(tc)] = tc
        qlen[b], tlen[b] = len(qc), len(tc)
    return q, t, qlen, tlen


def _with_edge_cases(q, t, qlen, tlen, W):
    """Adds an empty query, an empty target, both empty, and a length
    difference of at least W, as the last four pairs."""
    q, t, qlen, tlen = q.copy(), t.copy(), qlen.copy(), tlen.copy()
    M = q.shape[1]
    qlen[-4] = 0
    tlen[-3] = 0
    qlen[-2] = tlen[-2] = 0
    qlen[-1], tlen[-1] = M, max(0, M - W - 3)
    return q, t, qlen, tlen


def _pack(codes):
    """(M, B, W) int8 codes of the JAX scan -> the (B, M16, W) int32 plane."""
    M, B, W = codes.shape
    out = np.zeros((B, (M + 15) // 16, W), np.uint32)
    for i in range(M):
        out[:, i // 16, :] |= codes[i].astype(np.uint32) << np.uint32(2 * (i % 16))
    return out.view(np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- (a) the copies -----------------------------------------------------------


def test_copied_types_and_sequence_helpers_equal():
    for name in ("AlignmentState", "CigarFormat", "StatusType"):
        assert {m.name: int(m) for m in getattr(ttypes, name)} == {
            m.name: int(m) for m in getattr(jtypes, name)}
    rng = np.random.default_rng(0)
    for _ in range(5):
        states = rng.integers(0, 4, size=int(rng.integers(0, 40))).astype(np.int8)
        for fmt in (0, 1):
            assert ttypes.states_to_cigar(states, ttypes.CigarFormat(fmt)) == \
                jtypes.states_to_cigar(states, jtypes.CigarFormat(fmt))
    seq = generate_random_genome(200, rng) + "acgtNn"
    np.testing.assert_array_equal(tsequence.encode_bases(seq), jsequence.encode_bases(seq))
    assert tsequence.reverse_complement(seq) == jsequence.reverse_complement(seq)
    assert [tbucketing.next_pow2(n) for n in range(0, 3000, 7)] == \
        [jbucketing.next_pow2(n) for n in range(0, 3000, 7)]


def test_copied_oracle_equal():
    rng = np.random.default_rng(1)
    pairs = [("", ""), ("", "ACG"), ("ACG", ""), ("GATTACA", "GCATGCT")]
    for _ in range(6):
        g = generate_random_genome(int(rng.integers(1, 120)), rng)
        pairs.append((g, mutate_sequence(g, rng, 0.1, 0.1)))
    for q, t in pairs:
        np.testing.assert_array_equal(tref.align_cpu(q, t), jref.align_cpu(q, t))
        assert tref.edit_distance_cpu(q, t) == jref.edit_distance_cpu(q, t)


# -- (b) band_offset and the plain banded NW ----------------------------------


def test_band_offset_equal():
    rng = np.random.default_rng(2)
    qlen = rng.integers(0, 3000, 64).astype(np.int32)
    tlen = rng.integers(0, 3000, 64).astype(np.int32)
    for W in (1, 16, 64, 128, 1024):
        ref = np.asarray(jnw.band_offset(jnp.asarray(qlen), jnp.asarray(tlen), W))
        np.testing.assert_array_equal(band_offset(qlen, tlen, W), ref)
        got = band_offset(torch.from_numpy(qlen), torch.from_numpy(tlen), W)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("W", [16, 64, 128])
def test_banded_nw_plain_equals_jax_scan(W):
    q, t, qlen, tlen = _with_edge_cases(*_random_batch(10, 160, seed=W, lo=10, rate=0.08), W)
    _, codes, fits = jnw.banded_nw_forward(*map(jnp.asarray, (q, t, qlen, tlen)), W)
    planes, fits_t = banded_nw_forward_plain(*_t(q, t, qlen, tlen), W)
    np.testing.assert_array_equal(planes_to_numpy(planes), _pack(np.asarray(codes)))
    np.testing.assert_array_equal(fits_t.numpy(), np.asarray(fits))
    assert not fits_t[-1]


@pytest.mark.parametrize("W", [640, 1024])
def test_banded_nw_block_bands_equal_jax_scan(W):
    """The plain versions at the block kernel's bands (past 512) against the
    JAX scan, codes, fits and the distance: pairs whose targets are longer
    than their queries by W - 3 and W - 40 (the optimum drifts to the band's
    edge), empty targets, pairs that do not fit (a difference of W and
    of W + 20), an empty query and noisy pairs, at M = 90 rows (not a
    multiple of 16; rows past most queries)."""
    rng = np.random.default_rng(W)
    M, N = 90, W + 40
    lens = [(60, 60 + W - 3), (80, 80 + W - 40), (90, 0), (10, 10 + W), (15, 35 + W),
            (0, 50), (70, 66), (85, 90), (40, 0)]
    B = len(lens)
    q = rng.integers(0, 4, (B, M)).astype(np.uint8)
    t = rng.integers(0, 4, (B, N)).astype(np.uint8)
    qlen = np.array([a for a, _ in lens], np.int32)
    tlen = np.array([b for _, b in lens], np.int32)
    for b in (0, 1, 6, 7):  # the target starts with the query, noisy
        n = min(qlen[b], tlen[b])
        t[b, :n] = np.where(rng.random(n) < 0.1, rng.integers(0, 4, n), q[b, :n])
    want = jnw.banded_nw_forward(*map(jnp.asarray, (q, t, qlen, tlen)), W)
    final, planes, fits = banded_nw_final_plain(*_t(q, t, qlen, tlen), W)
    fplanes, ffits = banded_nw_forward_plain(*_t(q, t, qlen, tlen), W)
    np.testing.assert_array_equal(planes_to_numpy(planes), _pack(np.asarray(want[1])))
    np.testing.assert_array_equal(fits.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(final.numpy(), np.asarray(want[0]))
    assert torch.equal(fplanes, planes) and torch.equal(ffits, fits)
    assert fits.tolist() == [True, True, True, False, False, True, True, True, True]


def test_planes_round_trip_and_checks():
    a = np.arange(-6, 6, dtype=np.int32).reshape(1, 3, 4) << 28
    np.testing.assert_array_equal(planes_to_numpy(planes_from_numpy(a, "cpu")), a)
    np.testing.assert_array_equal(planes_from_numpy(a.view(np.uint32), "cpu").numpy(), a)
    with pytest.raises(ValueError):
        planes_from_numpy(a[0], "cpu")
    with pytest.raises(TypeError):
        planes_from_numpy(a.astype(np.int64), "cpu")
    with pytest.raises(TypeError):
        planes_to_numpy(torch.zeros((1, 2, 3), dtype=torch.int64))


# -- (c) the plain Myers against the word model -------------------------------


@pytest.mark.parametrize("W,batch", [
    (32, dict(B=12, M=96, seed=0)),
    (64, dict(B=8, M=384, seed=3, hi=340)),
    (128, dict(B=16, M=256, seed=0)),
    (128, dict(B=16, M=128, seed=2, hi=112)),
])
def test_myers_plain_equals_word_model(W, batch):
    q, t, qlen, tlen = _random_batch(**batch)
    if W == 32:
        q, t, qlen, tlen = _with_edge_cases(q, t, qlen, tlen, W)
    ref, fits = myers_banded_codes(q, t, qlen, tlen, W, windowed=True)
    planes, fits_t = myers_banded_plain(*_t(q, t, qlen, tlen), W)
    np.testing.assert_array_equal(planes_to_numpy(planes), ref)
    np.testing.assert_array_equal(fits_t.numpy(), fits)


# -- (d) the plain traceback fed the JAX package's planes ---------------------


def _check_walks(planes, q_len, t_len, W, rcap=None):
    dlo = np.asarray(band_offset(q_len, t_len, W)).astype(np.int32)
    paths, edge = traceback_host_packed(planes, q_len, t_len, dlo, W)
    rcap = rcap or int((q_len + t_len).max())
    runs, nruns, dist, edge_t, ovf = rle_traceback_plain(
        planes_from_numpy(planes, "cpu"), *_t(q_len, t_len, dlo), W, rcap)
    assert not ovf.any()
    np.testing.assert_array_equal(edge_t.numpy(), edge)
    for b in range(len(q_len)):
        path = runs_to_states(runs[b].numpy(), int(nruns[b]))
        np.testing.assert_array_equal(path, paths[b], err_msg=f"b={b}")
        assert int(dist[b]) == int((paths[b] != 0).sum())
        assert (runs[b, int(nruns[b]):] == 0).all()
        assert (path != 2).sum() == q_len[b] and (path != 3).sum() == t_len[b]
    return paths, edge


@pytest.mark.parametrize("W", [32, 128])
def test_traceback_plain_on_myers_planes(W):
    q, t, qlen, tlen = _with_edge_cases(*_random_batch(12, 128, seed=5, lo=10), W)
    planes, _ = myers_banded_codes(q, t, qlen, tlen, W, windowed=True)
    _, edge = _check_walks(planes, qlen, tlen, W)
    assert not edge.all()
    assert edge.any() == (W == 32)  # 12 % indels drift out of a 32-wide band


@pytest.mark.parametrize("W", [16, 64])
def test_traceback_plain_on_nw_planes(W):
    q, t, qlen, tlen = _with_edge_cases(*_random_batch(10, 96, seed=7, lo=10), W)
    _, codes, _ = jnw.banded_nw_forward(*map(jnp.asarray, (q, t, qlen, tlen)), W)
    _check_walks(_pack(np.asarray(codes)), qlen, tlen, W)


def test_traceback_plain_indel_dense_walk():
    """An indel-dense pair with qlen + tlen close to 2 M is walked to its
    end: the walk has no step cap."""
    M, W = 256, 512
    qs, ts = "A" * 126 + "C" * 126, "C" * 126 + "A" * 126
    q = np.zeros((1, M), np.uint8)
    t = np.zeros((1, M), np.uint8)
    q[0, :252], t[0, :252] = jsequence.encode_bases(qs), jsequence.encode_bases(ts)
    qlen = tlen = np.array([252], np.int32)
    planes, _ = myers_banded_codes(q, t, qlen, tlen, W, windowed=True)
    paths, edge = _check_walks(planes, qlen, tlen, W)
    np.testing.assert_array_equal(paths[0], jref.align_cpu(qs, ts))
    assert not edge[0] and (paths[0] >= 2).sum() == 252


def test_traceback_plain_overflow():
    """A small rcap sets ovf: the first rcap runs are kept and nruns counts
    them all (the alternating bases of tests/test_rle_traceback.py)."""
    B, M, W = 4, 256, 128
    q = np.full((B, M), 1, np.uint8)
    t = np.full((B, M), 2, np.uint8)
    q[:, :200] = jsequence.encode_bases("ACGT" * 50)
    t[:, :200] = jsequence.encode_bases("TGCA" * 50)
    qlen = tlen = np.full(B, 200, np.int32)
    _, codes, _ = jnw.banded_nw_forward(*map(jnp.asarray, (q, t, qlen, tlen)), W)
    planes = planes_from_numpy(_pack(np.asarray(codes)), "cpu")
    args = _t(qlen, tlen, band_offset(qlen, tlen, W).astype(np.int32))
    full = rle_traceback_plain(planes, *args, W, 400)
    runs, nruns, dist, edge, ovf = rle_traceback_plain(planes, *args, W, 16)
    assert ovf.all() and not full[4].any()
    assert torch.equal(nruns, full[1]) and (nruns > 16).all()
    assert torch.equal(runs, full[0][:, :16])
    assert torch.equal(dist, full[2]) and torch.equal(edge, full[3])


# -- (e) the Aligner end to end -----------------------------------------------


def _pairs(seed, n):
    """Seeded pairs of 10-900 bp at 5-12 % substitutions and indels, plus
    two whose paths leave the initial band."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        g = generate_random_genome(int(rng.integers(10, 900)), rng)
        rate = float(rng.uniform(0.05, 0.12))
        pairs.append((g, mutate_sequence(g, rng, rate, rate)))
    a, b, x = (generate_random_genome(n, rng) for n in (300, 300, 55))
    a2, b2 = (mutate_sequence(s, rng, 0.05, 0.0) for s in (a, b))
    # a length difference of 160 starts at band 256. The second pair differs
    # in length by 45 (band 64, diagonals -9..54), but its path runs along
    # diagonal -10 after a 10-base deletion: the Myers engines retry at 128
    pairs += [("A" * 200, "A" * 40), (a + b, a2[:100] + a2[110:] + x + b2)]
    return pairs


@functools.lru_cache(maxsize=None)
def _oracle(q, t):
    return align_cpu(q, t)


def _align(pairs, **kw):
    a = create_aligner(device="cpu", **kw)
    for q, t in pairs:
        assert a.add_alignment(q, t) == 0
    a.align_all()
    alns = a.get_alignments()
    assert len(alns) == len(pairs)
    for (q, t), aln in zip(pairs, alns):
        assert aln.query == q and aln.target == t
        st = np.asarray(aln.states)
        assert (st != 2).sum() == len(q) and (st != 3).sum() == len(t)
    return a, alns


def test_aligner_nw_equals_jax_aligner():
    pairs = _pairs(11, 10)
    ref = JAligner(max_bandwidth=256, engine="nw", use_pallas=False)
    for q, t in pairs:
        ref.add_alignment(q, t)
    ref.align_all()
    a, alns = _align(pairs, engine="nw", max_bandwidth=256)
    assert sorted(a.band_counts) == [64, 256]
    for r, aln in zip(ref.get_alignments(), alns):
        np.testing.assert_array_equal(aln.states, r.states)
        assert aln.is_optimal == r.is_optimal
    # the banded NW keeps the drifting pair inside the band and calls it
    # optimal; the JAX aligner does the same
    assert alns[-1].is_optimal and not np.array_equal(alns[-1].states, _oracle(*pairs[-1]))


@pytest.mark.parametrize("kw", [
    dict(engine="myers"), dict(engine="myers", max_bandwidth=128),
    dict(engine="ukkonen", ukkonen_p=16), dict(engine="ukkonen", ukkonen_p=4),
    dict(engine="myers_full"),
], ids=["myers", "myers-bw128", "ukkonen-p16", "ukkonen-p4", "myers_full"])
def test_aligner_optimal_alignments_equal_oracle(kw):
    pairs = _pairs(12, 8)
    a, alns = _align(pairs, **kw)
    n_opt = 0
    for (q, t), aln in zip(pairs, alns):
        if aln.is_optimal:
            ref = _oracle(q, t)
            np.testing.assert_array_equal(aln.states, ref)
            assert aln.get_edit_distance() == int((ref != 0).sum())
            n_opt += 1
    # a band of radius 4 (run 32 wide) misses the drifting pairs for good
    assert n_opt >= len(pairs) - (3 if kw.get("ukkonen_p") == 4 else 1)
    if kw["engine"] == "myers":
        assert a.band_counts[128] >= 1  # the drifting pair retried
    if kw["engine"] == "myers_full":
        assert n_opt == len(pairs)
    if kw.get("ukkonen_p") == 4:
        # the Myers plane holds whole words: a 9- or 16-wide band runs at 32
        assert min(a.band_counts) == 32


def test_aligner_small_cases_and_retry():
    pairs = [("ACGT", "ACGT"), ("AAAA", "TTAT"), ("ACGTACGT", "ACGT"), ("ACGT", "ACGTACGT"),
             ("GATTACA", "GCATGCT"), ("A", "T"), ("AAAAAAAAAA", "AAAAAAAAA"), ("", "ACG"),
             ("ACG", ""), ("", "")]
    for engine in ("myers", "nw"):
        _, alns = _align(pairs, engine=engine)
        for (q, t), aln in zip(pairs, alns):
            assert aln.is_optimal
            np.testing.assert_array_equal(aln.states, align_cpu(q, t))
    a, (aln,) = _align([("A" * 200, "A" * 40)], max_bandwidth=1024)
    assert aln.is_optimal and aln.get_edit_distance() == 160
    assert sorted(a.band_counts) == [256]


def test_aligner_surface_mirrors_jax():
    a = create_aligner(device="cpu")
    a.add_alignment("ACGTT", "AACGT", reverse_complement_query=True)
    a.align_all()
    aln = a.get_alignments()[0]
    assert aln.query == "AACGT" and aln.get_edit_distance() == 0

    states = np.array([0, 1, 2, 3, 3], dtype=np.int8)
    assert states_to_cigar(states, CigarFormat.basic) == "2M1I2D"
    assert states_to_cigar(states, CigarFormat.extended) == "1=1X1I2D"

    _, (aln,) = _align([("GATT", "GAT")])
    q_row, pair, t_row = aln.format_alignment()
    assert len(q_row) == len(t_row) == len(pair)
    assert q_row.replace("-", "") == "GATT" and t_row.replace("-", "") == "GAT"

    a = create_aligner(max_bandwidth=128, device="cpu")
    a.add_alignment("AAAA", "AATA")
    a.add_alignment("ACG", "ACGT")
    a.align_all()
    dev = a.get_device_alignments()
    assert dev.num_alignments() == 2
    assert all(x.device.type == "cpu" for x in (dev.cigar_ops, dev.cigar_runlengths,
                                                  dev.cigar_offsets, dev.metadata))
    offs = dev.cigar_offsets.tolist()
    assert dev.cigar_ops[offs[0]:offs[1]].tolist() == [0, 1, 0]
    assert dev.cigar_runlengths[offs[0]:offs[1]].tolist() == [2, 1, 1]
    assert dev.cigar_ops[offs[1]:offs[2]].tolist() == [0, 2]
    assert dev.cigar_runlengths[offs[1]:offs[2]].tolist() == [3, 1]
    assert dev.metadata.tolist() == [1, 1]


def test_aligner_raises_on_traceback_overflow(monkeypatch):
    """The aligner sizes rcap so that a walk cannot overflow; should one
    overflow all the same, align_all raises rather than walking the codes
    on the host."""
    from genomeworks_tpu_torch.ops import rle_traceback_cuda as mod

    real = mod.rle_traceback_cuda
    monkeypatch.setattr(mod, "rle_traceback_cuda",
                        lambda codes, ql, tl, dlo, w, rcap: real(codes, ql, tl, dlo, w, 1))
    a = create_aligner(device="cpu")
    a.add_alignment("GATTACA", "GCATGCT")
    with pytest.raises(RuntimeError, match="overflowed"):
        a.align_all()


def test_aligner_add_time_checks_and_fixed_band():
    a = create_aligner(device="cpu", max_query_length=5, max_target_length=40,
                       engine="ukkonen")
    assert a.add_alignment("ACGTAC", "ACG") == ttypes.StatusType.exceeded_max_length
    assert a.add_alignment("ACG", "A" * 41) == ttypes.StatusType.exceeded_max_length
    assert a.add_alignment("ACG", "A" * 8) == \
        ttypes.StatusType.exceeded_max_alignment_difference
    assert a.add_alignment("ACG", "ACGT") == ttypes.StatusType.success
    with pytest.raises(ValueError):
        create_aligner(device="cpu", engine="smith_waterman")
    f = FixedBandAligner(device="cpu")
    f.add_alignment("ACGT", "ACG")
    with pytest.raises(RuntimeError):
        f.reset_max_bandwidth(64)
    f.reset()
    f.reset_max_bandwidth(64)
    assert f.max_bandwidth == 64


# -- wrappers -----------------------------------------------------------------


def test_wrappers_on_cpu_run_the_plain_versions():
    q, t, qlen, tlen = _t(*_random_batch(4, 64, seed=9, lo=10))
    dlo = band_offset(qlen, tlen, 32)
    counts = (myers_banded_plain.calls, banded_nw_forward_plain.calls, rle_traceback_plain.calls)
    launches = (myers_banded_cuda.launches, banded_nw_cuda.launches,
                rle_traceback_cuda.launches)
    codes, fits = myers_banded_cuda(q, t, qlen, tlen, 32)
    ref = myers_banded_plain(q, t, qlen, tlen, 32)
    assert torch.equal(codes, ref[0]) and torch.equal(fits, ref[1])
    for a, b in zip(banded_nw_cuda(q, t, qlen, tlen, 32),
                    banded_nw_forward_plain(q, t, qlen, tlen, 32)):
        assert torch.equal(a, b)
    for a, b in zip(rle_traceback_cuda(codes, qlen, tlen, dlo, 32, 16),
                    rle_traceback_plain(codes, qlen, tlen, dlo, 32, 16)):
        assert torch.equal(a, b)
    assert (myers_banded_plain.calls, banded_nw_forward_plain.calls,
            rle_traceback_plain.calls) == tuple(c + 2 for c in counts)
    assert (myers_banded_cuda.launches, banded_nw_cuda.launches,
            rle_traceback_cuda.launches) == launches


def test_wrappers_reject_what_the_kernels_do_not_take():
    q, t, qlen, tlen = _t(*_random_batch(4, 64, seed=9, lo=10))
    dlo = band_offset(qlen, tlen, 32)
    for fn in (myers_banded_cuda, banded_nw_cuda):
        with pytest.raises(TypeError):
            fn(q.to(torch.int32), t, qlen, tlen, 32)
        with pytest.raises(TypeError):
            fn(q, t, qlen.to(torch.int64), tlen, 32)
        with pytest.raises(ValueError):
            fn(q, t[:2], qlen, tlen, 32)
        with pytest.raises(ValueError):
            fn(q.t().contiguous().t(), t, qlen, tlen, 32)
        with pytest.raises(ValueError):
            fn(q, t, qlen + 100, tlen, 32)
    with pytest.raises(ValueError):
        myers_banded_cuda(q, t, qlen, tlen, 48)
    with pytest.raises(ValueError):
        banded_nw_cuda(q, t, qlen, tlen, 1 << 15)
    codes, _ = myers_banded_cuda(q, t, qlen, tlen, 32)
    with pytest.raises(ValueError):
        rle_traceback_cuda(codes, qlen, tlen, dlo, 64, 16)
    with pytest.raises(TypeError):
        rle_traceback_cuda(codes, qlen, tlen, dlo.to(torch.int64), 32, 16)
    with pytest.raises(ValueError):
        rle_traceback_cuda(codes, qlen + 100, tlen, dlo, 32, 16)
    with pytest.raises(ValueError):
        rle_traceback_cuda(codes, qlen, tlen, dlo, 32, 0)


# -- (f) device and imports ---------------------------------------------------


def test_aligner_device_none_requires_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        Aligner()
    with pytest.raises(RuntimeError):
        create_aligner(engine="nw")
    assert Aligner(device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("first", [
    "genomeworks_tpu_torch.aligner", "genomeworks_tpu_torch.aligner.aligner",
    "genomeworks_tpu_torch.ops.myers_banded_cuda", "genomeworks_tpu_torch.ops.banded_nw_cuda",
    "genomeworks_tpu_torch.ops.rle_traceback_cuda",
])
def test_aligner_imports_without_jax(first):
    # the wrappers and the aligner import each other's modules: every module
    # imported first must leave both complete
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        f"import {first}\n"
        "import genomeworks_tpu_torch.aligner as al\n"
        "import genomeworks_tpu_torch.ops.myers_banded_cuda, genomeworks_tpu_torch.ops.banded_nw_cuda\n"
        "import genomeworks_tpu_torch.ops.rle_traceback_cuda\n"
        "a = al.create_aligner(device='cpu')\n"
        "a.add_alignment('GATTACA', 'GCATGCT')\n"
        "a.align_all()\n"
        "assert not any(m == 'genomeworks_tpu' or m.startswith(('genomeworks_tpu.', 'jax.'))"
        " for m in sys.modules), 'reference package imported'\n"
        "print(a.get_alignments()[0].convert_to_cigar(al.CigarFormat.extended))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == jtypes.states_to_cigar(
        jref.align_cpu("GATTACA", "GCATGCT"), jtypes.CigarFormat.extended)
