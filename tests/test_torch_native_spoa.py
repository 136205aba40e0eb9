"""The port's binding of the native scalar CPU POA baseline
(genomeworks_tpu_torch/poa/native_baseline.py) against the JAX package's
binding and the Python reference (tests/test_native_spoa.py's cases):
consensus and coverage bit for bit."""

import numpy as np
import pytest

from genomeworks_tpu.poa import native_baseline as jnative
from genomeworks_tpu.poa.cpu_reference import poa_consensus
from genomeworks_tpu_torch.poa import native_baseline
from genomeworks_tpu_torch.simulators.genomesim import generate_random_genome, mutate_sequence


def test_native_baseline_loads():
    # the library is committed (or built from native/ at first use)
    assert native_baseline.available()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_native_matches_jax_binding_and_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(6):
        t = generate_random_genome(int(rng.integers(30, 260)), rng)
        n = int(rng.integers(1, 9))
        w = [t] + [mutate_sequence(t, rng, 0.08, 0.08) for _ in range(n)]
        nat_c, nat_v = native_baseline.poa_consensus_native(w)
        ref_c, ref_v = poa_consensus(w)
        jc, jv = jnative.poa_consensus_native(w)
        assert nat_c == ref_c == jc
        np.testing.assert_array_equal(nat_v, ref_v)
        np.testing.assert_array_equal(nat_v, jv)


def test_native_single_sequence():
    c, v = native_baseline.poa_consensus_native(["ACGTACGT"])
    assert c == "ACGTACGT"
    np.testing.assert_array_equal(v, np.ones(8, np.int32))


def test_native_scores_match_jax_binding():
    rng = np.random.default_rng(9)
    t = generate_random_genome(120, rng)
    w = [t] + [mutate_sequence(t, rng, 0.1, 0.1) for _ in range(5)]
    for scores in ((-4, -3, 5), (-8, -6, 8), (-2, -8, 3)):
        c, v = native_baseline.poa_consensus_native(w, *scores)
        jc, jv = jnative.poa_consensus_native(w, *scores)
        assert c == jc
        np.testing.assert_array_equal(v, jv)
