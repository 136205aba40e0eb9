"""The port's unbanded edit-distance helpers against the JAX package's on
the CPU, exactly: ``myers_edit_distance_cpu``, the batched Myers distance
(``myers_edit_distance_batched(device="cpu")`` and its plain word chain
``myers_score_plain`` against ``_myers_scan``, also on the query lengths of
the card kernel's edge sets) and ``ukkonen_cpu`` /
``ukkonen_edit_distance_cpu``, on the kinds of cases of tests/test_myers.py
and tests/test_ukkonen.py: empty, multi-word and mixed lengths."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genomeworks_tpu.aligner.myers as jm
import genomeworks_tpu.aligner.ukkonen as ju
import genomeworks_tpu_torch.aligner.myers as pm
import genomeworks_tpu_torch.aligner.ukkonen as pu
from genomeworks_tpu_torch.simulators.genomesim import generate_random_genome, mutate_sequence


def _cases(n, seed, lo=1, hi=200):
    """Random pairs, every other one a mutated copy (10 % substitutions,
    10 % indels), as tests/test_myers.py makes them."""
    rng = np.random.default_rng(seed)
    cases = []
    for i in range(n):
        q = generate_random_genome(int(rng.integers(lo, hi)), rng)
        t = (mutate_sequence(q, rng, 0.1, 0.1) if i % 2
             else generate_random_genome(int(rng.integers(lo, hi)), rng))
        cases.append((q, t))
    return cases


EDGES = [("", ""), ("", "ACG"), ("A", ""), ("A", "AA"), ("ACGT", "TACGT"), ("TTTT", "AAAA"),
         ("ACGT" * 8, "ACGT" * 8 + "A"), ("ACGT" * 8 + "A", "ACG" * 11)]


def test_myers_cpu_matches_jax():
    rng = np.random.default_rng(3)
    long = generate_random_genome(300, rng)
    cases = _cases(20, 7) + EDGES + [(long, mutate_sequence(long, rng, 0.05, 0.05))]
    for q, t in cases:
        assert pm.myers_edit_distance_cpu(t, q) == jm.myers_edit_distance_cpu(t, q)
    for q in ["", "A", "ACGT" * 8, "ACGT" * 8 + "C", generate_random_genome(100, rng)]:
        np.testing.assert_array_equal(pm._preprocess_peq(q), jm._preprocess_peq(q))


@pytest.mark.parametrize("kind", ["random", "edges", "multi-word mixed"])
def test_myers_batched_matches_jax(kind):
    if kind == "random":
        cases = _cases(20, 11)
    elif kind == "edges":
        cases = EDGES
    else:
        rng = np.random.default_rng(5)
        cases = []
        for n in (30, 31, 32, 33, 64, 65, 200, 399):
            q = generate_random_genome(n, rng)
            cases.append((q, mutate_sequence(q, rng, 0.08, 0.08)))
    qs, ts = [c[0] for c in cases], [c[1] for c in cases]
    got = pm.myers_edit_distance_batched(qs, ts, device="cpu")
    want = jm.myers_edit_distance_batched(qs, ts)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_myers_score_plain_matches_jax_scan():
    """The raw word chain, empty queries included (before the host sets
    their distance)."""
    cases = _cases(12, 13, 0, 150) + EDGES
    qs, ts = [c[0] for c in cases], [c[1] for c in cases]
    peq, tc, ql, tl = pm.myers_inputs(qs, ts)
    want = jm._myers_scan(jnp.asarray(peq), jnp.asarray(tc.astype(np.int32)), jnp.asarray(ql),
                          jnp.asarray(tl), n_words=peq.shape[2], t_steps=tc.shape[1])
    got = pm.myers_score_plain(torch.from_numpy(peq.view(np.int32)), torch.from_numpy(tc),
                               torch.from_numpy(ql), torch.from_numpy(tl))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("group", ["npl steps", "chunked", "3-4 chunks"])
def test_myers_score_edge_sets_match_jax_scan(group):
    """The query lengths of the card kernel's edge sets
    (``chip_smoke.myers_score_edge_sets``: 0, 1 and 32 j +- 1 at every
    words-a-lane step, past 32 x 16 words, and at the edges of three and
    four chunks of 32 x 16 words), their targets cut to 6 bases so the word
    chain stays small: the plain word chain against ``_myers_scan``, the
    words-a-lane sets in one batch."""
    import chip_smoke

    sets = chip_smoke.myers_score_edge_sets(np.random.default_rng(14))
    cases = [pair for label, (qs, ts) in sets.items()
             if (label if label in ("chunked", "3-4 chunks") else "npl steps") == group
             for pair in zip(qs, ts)]
    qs, ts = [c[0] for c in cases], [c[1][:6] for c in cases]
    peq, tc, ql, tl = pm.myers_inputs(qs, ts)
    want = jm._myers_scan(jnp.asarray(peq), jnp.asarray(tc.astype(np.int32)), jnp.asarray(ql),
                          jnp.asarray(tl), n_words=peq.shape[2], t_steps=tc.shape[1])
    got = pm.myers_score_plain(torch.from_numpy(peq.view(np.int32)), torch.from_numpy(tc),
                               torch.from_numpy(ql), torch.from_numpy(tl))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_myers_batched_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        pm.myers_edit_distance_batched(["A"], ["A"])
    with pytest.raises(ValueError):
        pm.myers_edit_distance_batched(["A"], [], device="cpu")


@pytest.mark.parametrize("p", [2, 4, 16, 32])
def test_ukkonen_matches_jax(p):
    rng = np.random.default_rng(8)
    cases = _cases(10, 21, 5, 150) + [("ACGTACGT", "ACGAACG"), ("", "ACG"), ("ACG", ""),
                                       ("A" * 30 + "C" * 30, "A" * 30 + "G" * 10 + "C" * 30),
                                       ("A" * 100 + "C" * 100, "C" * 100 + "A" * 100)]
    q = generate_random_genome(120, rng)
    cases.append((q, mutate_sequence(q, rng, 0.08, 0.08)))
    for q, t in cases:
        np.testing.assert_array_equal(pu.ukkonen_cpu(q, t, p), ju.ukkonen_cpu(q, t, p))
        assert pu.ukkonen_edit_distance_cpu(q, t, p) == ju.ukkonen_edit_distance_cpu(q, t, p)
    assert pu.ukkonen_cpu("", "ACG").dtype == np.int8
