"""Full-band POA at edge caps past 84 (``max_edges`` / ``max_alignments`` of
85, 100, 128 and 130): the port against the JAX package, consensus and MSA.

The priority codes of the full-band NW reach 3E + 1: past 255 from E = 85
(the largest code), and every horizontal move's code 2E passes 255 from
E = 128. The JAX package serves any E (on the CPU through its XLA chain);
the port does too, with 16-bit codes in its kernel past E = 84. Parity
target: jax_poa's XLA chain (``use_pallas=False, use_lockstep=False``) on
the CPU; inputs are seeded numpy plus the first 16 covid windows; every
comparison is exact (integer arithmetic throughout).
"""

import os

import numpy as np
import pytest
import torch

from genomeworks_tpu.poa import jax_poa
from genomeworks_tpu_torch.ops import poa_cuda
from genomeworks_tpu_torch.poa import load_window_file, torch_poa

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _mutate(t: bytes, rng, sub: float, indel: float) -> str:
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


def _random_windows(seed: int, n: int = 12):
    """n windows of 2-16 reads around a random template of 30-70 bases, each
    read at 5-15 % substitutions and as many indels (chip_smoke's recipe)."""
    rng = np.random.default_rng(seed)
    windows = []
    for _ in range(n):
        t = bytes(b"ACGT"[i] for i in rng.integers(0, 4, size=int(rng.integers(30, 71))))
        err = float(rng.uniform(0.05, 0.15))
        k = int(rng.integers(2, 17))
        windows.append([t.decode()] + [_mutate(t, rng, err / 2, err / 2) for _ in range(k - 1)])
    return windows


def _assert_same(ref, out):
    assert list(out[2]) == list(ref[2])
    assert out[0] == ref[0]
    for a, b in zip(ref[1], out[1]):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("E", [85, 100, 128, 130])
def test_consensus_past_84_edges_matches_jax(E):
    """Consensus, coverage and status at E = A = 85, 100, 128 and 130 equal
    the JAX package's (85: the first E whose code 3E + 1 passes 255; 128:
    the first whose horizontal code 2E does), on the random windows of the
    MSA test below (which holds that they insert read bases against the
    graph) and, at E = 130, covid windows 0-15 too."""
    windows = _random_windows(E, n=8)
    if E == 130:
        windows += load_window_file(os.path.join(DATA, "poa_windows_covid.txt.gz"))[:16]
    kw = dict(max_edges=E, max_alignments=E)
    ref = jax_poa.poa_batch_consensus(windows, use_pallas=False, use_lockstep=False, **kw)
    out = torch_poa.poa_batch_consensus(windows, device="cpu", **kw)
    assert all(s == 0 for s in ref[2])
    _assert_same(ref, out)


@pytest.mark.parametrize("E", [85, 100, 128, 130])
def test_msa_past_84_edges_matches_jax(E):
    """MSA rows and statuses at E = A = 85, 100, 128 and 130 equal the JAX
    package's. The windows hold horizontal moves (read bases inserted
    against the graph: columns where the first read has a gap), whose code
    2E passes 255 from E = 128."""
    windows = _random_windows(E, n=8)
    kw = dict(max_edges=E, max_alignments=E)
    ref = jax_poa.poa_batch_msa(windows, use_pallas=False, **kw)
    out = torch_poa.poa_batch_msa(windows, device="cpu", **kw)
    assert all(s == 0 for s in ref[1])
    assert sum(rows[0].count("-") for rows in ref[0]) > 0
    assert out == ref


def test_edge_cap_past_the_codes_raises():
    """E past 21844, where 3E + 1 leaves the kernel's 16-bit codes, is
    refused on the CPU as on the card."""
    seqs, wts, lens, nseqs, N = torch_poa.pack_windows([["ACGT", "ACGA"]], None, None)
    args = [torch.from_numpy(a) for a in (seqs, wts, lens, nseqs)]
    poa_cuda.poa_consensus_cuda(*args, N=N, E=poa_cuda.MAX_EDGES, A=4)
    with pytest.raises(ValueError, match="max_edges"):
        poa_cuda.poa_consensus_cuda(*args, N=N, E=poa_cuda.MAX_EDGES + 1, A=4)


def test_plain_codes_past_16_bits_match_narrow_caps():
    """Past E = 16383 a horizontal move's code 2E leaves int16: the plain
    chain's codes widen to int32 (from E = 10923, where 3E + 1 does), and
    windows whose lists stay far below the caps give at E = A = 16400
    exactly what they give at E = A = 100. The windows hold horizontal
    moves (read bases inserted against the graph)."""
    windows = _random_windows(16400, n=4)
    ref = torch_poa.poa_batch_consensus(windows, device="cpu", max_edges=100,
                                        max_alignments=100)
    msa = torch_poa.poa_batch_msa(windows, device="cpu", max_edges=100, max_alignments=100)
    assert sum(rows[0].count("-") for rows in msa[0]) > 0
    out = torch_poa.poa_batch_consensus(windows, device="cpu", max_edges=16400,
                                        max_alignments=16400)
    assert all(s == 0 for s in ref[2])
    _assert_same(ref, out)
