"""The Myers kernel's edge sets (``chip_smoke.aligner_edge_sets``, the
``myers-*`` sets) held to the JAX package's NumPy word model.

On the shapes of each set, packed as the aligner packs a chunk
(``pack_shape``), the plain version ``myers_banded_plain`` must equal
``myers_banded_codes(windowed=True)`` exactly (integer arithmetic: no
tolerance), and the set must reach the layout facts it names
(``chip_smoke.myers_facts``), all but the kernel's words a lane, which
only the built library can say. The sets' rows stay at M <= 128 (M = 48 at
W = 32768). No Pallas kernel runs, not even in interpret mode. On the card
the same sets hold the CUDA kernel to the plain version
(``tests/test_torch_cuda.py::test_aligner_kernels_match_plain_on_gpu``).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from genomeworks_tpu.aligner.myers_banded_model import myers_banded_codes
from genomeworks_tpu_torch.aligner.aligner import pack_pairs, pack_shape
from genomeworks_tpu_torch.aligner.banded_nw import planes_to_numpy
from genomeworks_tpu_torch.aligner.myers_banded_model import myers_banded_plain
from genomeworks_tpu_torch.core.bucketing import next_pow2
from genomeworks_tpu_torch.ops.myers_banded_cuda import (
    MAX_BAND,
    MAX_SMEM,
    myers_banded_cuda,
    smem_bytes,
)

MYERS_SETS = ["myers-layouts", "myers-rows", "myers-narrow", "myers-unfit", "myers-w32768"]
#: the warp NW's widest band: it only names the NW sets, which these tests skip
WARP_MAX_BAND = 512


@pytest.mark.parametrize("key", MYERS_SETS)
def test_myers_edge_set_plain_equals_word_model(key):
    spec = chip_smoke.aligner_edge_sets(np.random.default_rng(8), WARP_MAX_BAND)[key]
    pairs = spec["pairs"]
    M, N = pack_shape(pairs, next_pow2(max(len(x) for pair in pairs for x in pair)))
    assert M <= (48 if 32768 in spec["bands"] else 128)
    q, t, qlen, tlen = pack_pairs(pairs, M, N, "cpu")
    facts = set()
    for W in spec["bands"]:
        ref, fits = myers_banded_codes(q.numpy(), t.numpy(), qlen.numpy(), tlen.numpy(), W,
                                       windowed=True)
        planes, fits_t = myers_banded_plain(q, t, qlen, tlen, W)
        np.testing.assert_array_equal(planes_to_numpy(planes), ref, err_msg=f"W={W}")
        np.testing.assert_array_equal(fits_t.numpy(), fits)
        facts |= chip_smoke.myers_facts(M, W, qlen.numpy(), fits)
    # the instantiation a band takes is the library's to say: only on the card
    want = {f for f in spec["want"] if not f.startswith("Myers, ")}
    assert want <= facts, sorted(want - facts)


def test_myers_wrapper_refuses_shared_memory_past_the_card():
    """A shape whose shared memory is over what a block can use raises
    before any launch, on the CPU too; the aligner's largest shape fits."""
    assert smem_bytes(8192, 32768) <= MAX_SMEM
    M = 170000
    assert smem_bytes(M, MAX_BAND) > MAX_SMEM
    q = torch.zeros((1, M), dtype=torch.uint8)
    lens = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        myers_banded_cuda(q, q, lens, lens, MAX_BAND)


@pytest.mark.parametrize("words_per_lane", [None, 1, 33])
def test_myers_facts_name_the_layout_only_from_the_library(words_per_lane):
    """The words-a-lane fact is the one the library gives, and no fact names
    a layout without it; the other facts come from the lengths alone."""
    facts = chip_smoke.myers_facts(48, 64, np.array([20, 0]), np.array([True, False]),
                                   words_per_lane)
    layout = {f for f in facts if f.startswith("Myers, ")}
    want = set() if words_per_lane is None else {f"Myers, {words_per_lane} words a lane"}
    assert layout == want
    assert {"a query under 32 rows: the window never moves", "a pair that does not fit the band",
            "a last 8-row group cut short", "a last plane word of 1-8 rows"} <= facts
