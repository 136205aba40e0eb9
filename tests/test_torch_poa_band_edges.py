"""The banded kernel's edge sets (``chip_smoke.band_edge_sets``) held to
the JAX package on the CPU.

The card tests hold the banded kernel to its plain version on these sets;
here the port's plain banded chain, through
``torch_poa.poa_batch_consensus_banded(device="cpu")``, must equal the JAX
host chain, ``jax_poa.poa_batch_consensus_banded(use_pallas=False)``, in
each band kind a set runs. Every comparison is EXACT equality (integer
scores, ASCII bases): there is no tolerance to state.
"""

import numpy as np
import pytest

import chip_smoke
from genomeworks_tpu.poa import jax_poa
from genomeworks_tpu_torch.poa import torch_poa

#: the fewest leading windows of a set that reach what it names (bands of
#: 252, 260 and 512 with a guard failing on another band start; rules 7
#: and 8 and the re-run; adaptive bands of several tiles up to 1536); the
#: caps set runs whole (caps too small, an empty later read)
WINDOWS = {"lane-edge": 1, "tile-edge": 1, "two-tiles": 1, "shift": 2, "wide": 2, "caps": 4}


@pytest.mark.parametrize("case", list(WINDOWS))
def test_band_edge_sets_match_jax(case):
    _, windows, weights, caps, bw, kinds, _ = chip_smoke.band_edge_sets(
        np.random.default_rng(2028))[case]
    cut = slice(0, WINDOWS[case])
    windows = windows[cut]
    weights = weights[cut] if weights else [[np.ones(len(s), np.int32) for s in w]
                                            for w in windows]
    caps = (caps or [None] * len(windows))[cut]
    for kind in kinds:
        mode = f"{kind}_band"
        got, ref = ([], [], []), ([], [], [])
        for cap in dict.fromkeys(caps):
            idx = [b for b in range(len(windows)) if caps[b] == cap]
            ws, wt = [windows[b] for b in idx], [weights[b] for b in idx]
            for out, fn, kw in ((got, torch_poa.poa_batch_consensus_banded, {"device": "cpu"}),
                                (ref, jax_poa.poa_batch_consensus_banded, {"use_pallas": False})):
                for a, x in zip(out, fn(ws, max_nodes=cap, band_width=bw, weights=wt,
                                        band_mode=mode, **kw)):
                    a.extend(x)
        assert got[2] == ref[2] and got[0] == ref[0]
        for a, b in zip(got[1], ref[1]):
            np.testing.assert_array_equal(a, b)
