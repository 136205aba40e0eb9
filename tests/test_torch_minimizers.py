"""The port's minimizer sketch (``genomeworks_tpu_torch.mapper.minimizers``):
the reference's hand-computed fixtures (cudamapper/tests/
Test_CudamapperMinimizer.cpp, as tests/test_minimizers.py holds the JAX
package to them) and exact equality with the JAX ``compute_sketch`` and
``wang_hash32`` on seeded inputs, run on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomeworks_tpu.mapper import minimizers as jmin
from genomeworks_tpu_torch.core.sequence import encode_bases
from genomeworks_tpu_torch.mapper import minimizers as tmin


def _sketch(seqs, k, w, hashed):
    L = max(len(s) for s in seqs)
    reads = np.zeros((len(seqs), L), dtype=np.uint8)
    lens = np.zeros(len(seqs), dtype=np.int32)
    for i, s in enumerate(seqs):
        c = encode_bases(s)
        reads[i, : len(c)] = c
        lens[i] = len(c)
    out = tmin.compute_sketch(reads, lens, k, w, hashed, device="cpu")
    return tmin.sketch_to_numpy(*out)


# (reads, k, w, hashed) -> (reps, read ids, positions, directions); None = not
# stated by the fixture
FIXTURES = {
    "gatt_4_1": ((["GATT"], 4, 1, False), ([0b00001101], [0], [0], [1])),
    "gatt_2_3": ((["GATT"], 2, 3, False), ([0b1000, 0b0011, 0b0000], None, [0, 1, 2], [0, 0, 1])),
    "gatt_2_3_hashed": ((["GATT"], 2, 3, True),
                        ([1023180699, 2797583197, 3255840626], None, [0, 1, 2], [0, 0, 0])),
    "cccatacc_2_7": ((["CCCATACC"], 2, 7, False),
                     ([0b0101, 0b0101, 0b0100, 0b0011, 0b0001, 0b0101], None,
                      [0, 1, 2, 3, 5, 6], [0, 0, 0, 0, 0, 0])),
    "cccatacc_2_7_hashed": ((["CCCATACC"], 2, 7, True),
                            ([2515151312, 2515151312, 1582582417, 2515151312], None,
                             [0, 1, 2, 6], None)),
    "catcaag_aagcta_3_2": ((["CATCAAG", "AAGCTA"], 3, 2, False),
                           ([0b001110, 0b001101, 0b010000, 0b000010, 0b000010, 0b001001,
                             0b011100], [0, 0, 0, 0, 1, 1, 1], [0, 1, 3, 4, 0, 2, 3],
                            [1, 0, 0, 0, 0, 1, 0])),
    "catcaag_aagcta_3_2_hashed": ((["CATCAAG", "AAGCTA"], 3, 2, True),
                                  ([549100223, 447855090, 1279515286, 1865025060, 1865025060,
                                    4103259927, 357458314], [0, 0, 0, 0, 1, 1, 1],
                                   [0, 1, 2, 4, 0, 2, 3], [0, 1, 0, 0, 0, 1, 0])),
}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_reference_fixtures(name):
    args, expected = FIXTURES[name]
    got = _sketch(*args)
    for g, e in zip(got, expected):
        if e is not None:
            np.testing.assert_array_equal(g, e)


def test_short_read_skipped():
    # a read shorter than w + k - 1 emits nothing (index_gpu.cuh:835)
    reps, rids, poss, dirs = _sketch(["GATTACA", "GAT"], k=3, w=4, hashed=False)
    assert (rids == 1).sum() == 0
    assert (rids == 0).sum() > 0


def test_wang_hash32_matches_jax():
    rng = np.random.default_rng(11)
    keys = np.concatenate([
        np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32),
        rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32),
    ])
    got = tmin.wang_hash32(torch.from_numpy(keys.astype(np.int64))).numpy()
    want = np.asarray(jmin.wang_hash32(jnp.asarray(keys)))
    assert got.min() >= 0 and got.max() <= 0xFFFFFFFF
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def _random_reads(seed, B, L, short):
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    lens = rng.integers(L // 2, L + 1, size=B).astype(np.int32)
    lens[:short] = rng.integers(0, 24, size=short)  # shorter than a window
    lens[short] = L
    for b in range(B):
        reads[b, lens[b]:] = 0
    return reads, lens


@pytest.mark.parametrize("k,w,hashed,packed", [
    (15, 10, True, False), (15, 10, True, True), (5, 3, False, False),
    (16, 1, True, False), (2, 7, False, True), (9, 24, True, False),
])
def test_compute_sketch_matches_jax(k, w, hashed, packed):
    reads, lens = _random_reads(k * 100 + w, B=24, L=160, short=4)
    inp = tmin.pack_2bit(reads) if packed else reads
    np.testing.assert_array_equal(tmin.pack_2bit(reads), jmin.pack_2bit(reads))
    got = tmin.compute_sketch(inp, lens, k, w, hashed, packed=packed, device="cpu")
    want = jmin.compute_sketch(jnp.asarray(inp), jnp.asarray(lens), k, w, hashed, packed)
    for name, g, j in zip(("reps", "positions", "directions", "emit"), got, want):
        j = np.asarray(j)
        assert tuple(g.shape) == j.shape, name
        np.testing.assert_array_equal(g.numpy().astype(j.dtype), j, err_msg=name)
    flat_t = tmin.sketch_to_numpy(*got, first_read_id=7)
    flat_j = jmin.sketch_to_numpy(*want, first_read_id=7)
    for g, j in zip(flat_t, flat_j):
        assert g.dtype == j.dtype
        np.testing.assert_array_equal(g, j)
    assert len(flat_t[0]) > 0


def test_compute_sketch_rejects_reads_shorter_than_k():
    with pytest.raises(ValueError):
        tmin.compute_sketch(np.zeros((1, 3), np.uint8), np.array([3], np.int32), 5, 2,
                            device="cpu")
