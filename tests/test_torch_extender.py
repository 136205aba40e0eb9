"""The port's extender (genomeworks_tpu_torch.extender) against the JAX
package's (genomeworks_tpu.extender) on the CPU: the encoding, each
direction's (score, position) against ``_extend_direction`` at plain widths
32, 128 and 256 and on the edge sets of the card kernel's lanes and tiles,
the match counts against ``_count_matches`` (also on the count kernel's
edge sets), the sort and
deduplication against ``_sort_and_dedup``, whole SSP lists of
``create_extender(device="cpu")`` under each setting, tensor inputs, the CSV
parsers and the sample. Every comparison is exact; inputs are simulated
with NumPy from a seed (``chip_smoke.extender_inputs``)."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import genomeworks_tpu.extender.xdrop as jx
import genomeworks_tpu_torch.extender.xdrop as px
from genomeworks_tpu_torch.extender import xdrop_plain


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tests run in several worker processes: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """A simulated 20 kb pair (8 % substitutions, 0.5 % indels) and 3,000
    seeds, three quarters at true homologous positions."""
    return chip_smoke.extender_inputs(np.random.default_rng(3), 20_000, 0.08, 0.005, 3000)


def _lists_equal(a, b):
    return [s.astuple() for s in a] == [s.astuple() for s in b]


def _special(rng, codes, rate=0.01):
    """A copy of ``codes`` with lowercase (4), N (5) and & (7) at ``rate`` each."""
    out = codes.copy()
    for c in (4, 5, 7):
        out[rng.random(len(out)) < rate] = c
    return out


def test_encoding_and_score_matrix():
    every = bytes(range(256))
    np.testing.assert_array_equal(px.encode_sequence(every), jx.encode_sequence(every))
    assert px.encode_sequence("ACGTacgtN&Z").tolist() == [0, 1, 2, 3, 4, 4, 4, 4, 5, 7, 6]
    np.testing.assert_array_equal(px.DEFAULT_SCORE_MATRIX, jx.DEFAULT_SCORE_MATRIX)
    assert px.DEFAULT_SCORE_MATRIX.dtype == jx.DEFAULT_SCORE_MATRIX.dtype


@pytest.mark.parametrize("width", [32, 128, 256])
@pytest.mark.parametrize("left", [False, True], ids=["right", "left"])
def test_direction_matches_jax(pair, width, left):
    """(score, position) per seed of each direction, at fixed plain widths,
    against the JAX package's 128-wide lockstep chunks; with seeds at 0,
    at L-1 and out of range, and codes 4-7 in the sequences."""
    q, t, seeds = pair
    rng = np.random.default_rng(4)
    q, t = _special(rng, q), _special(rng, t)
    Lq, Lt = len(q), len(t)
    extra = np.array([[0, 0], [Lq - 1, Lt - 1], [-5, -5], [Lq + 3, Lt + 3], [-40, 10],
                      [10, -40], [Lq + 100, 5], [5, Lt + 100]])
    seeds = np.concatenate([seeds[:600], extra])
    sub = px.DEFAULT_SCORE_MATRIX.reshape(-1)
    want = jx._extend_direction(jnp.asarray(q, jnp.int32), jnp.asarray(t, jnp.int32),
                                jnp.asarray(seeds[:, 0], jnp.int32),
                                jnp.asarray(seeds[:, 1], jnp.int32), jnp.asarray(sub),
                                jnp.int32(910), left)
    got = xdrop_plain.extend_direction_plain(
        torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(seeds[:, 0].astype(np.int32)),
        torch.from_numpy(seeds[:, 1].astype(np.int32)), torch.from_numpy(sub.copy()), 910, left,
        width)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


LANE_SETS = ["drops at lane edges", "ties over kernel tiles", "ends inside lanes",
             "homologous runs", "int32 wrap"]


@pytest.fixture(scope="module")
def edge_sets():
    return chip_smoke.xdrop_edge_sets(np.random.default_rng(12))


@pytest.mark.parametrize("case", LANE_SETS)
def test_lane_edge_sets_match_jax(edge_sets, case):
    """The edge sets of the extension kernel's lanes and tiles
    (``chip_smoke.xdrop_lane_sets``): both directions of the plain version, at
    the set's plain width, against the JAX package's ``_extend_direction``,
    and each set reaches what it names (``chip_smoke.xdrop_facts``, a NumPy
    replay of every seed that must agree with the plain version)."""
    q, t, seeds, sub, xd, width, want = edge_sets[case]
    sub = np.asarray(sub, np.int32).reshape(-1)
    args = [torch.from_numpy(np.ascontiguousarray(q, np.uint8)),
            torch.from_numpy(np.ascontiguousarray(t, np.uint8)),
            torch.from_numpy(seeds[:, 0].astype(np.int32)),
            torch.from_numpy(seeds[:, 1].astype(np.int32)), torch.from_numpy(sub.copy())]
    out = []
    for left in (False, True):
        want_dir = jx._extend_direction(jnp.asarray(q, jnp.int32), jnp.asarray(t, jnp.int32),
                                        jnp.asarray(seeds[:, 0], jnp.int32),
                                        jnp.asarray(seeds[:, 1], jnp.int32), jnp.asarray(sub),
                                        jnp.int32(xd), left)
        got = xdrop_plain.extend_direction_plain(*args, xd, left, width)
        np.testing.assert_array_equal(got[0].numpy(), want_dir[0])
        np.testing.assert_array_equal(got[1].numpy(), want_dir[1])
        out += [got[0].numpy(), got[1].numpy()]
    assert want <= chip_smoke.xdrop_facts(q, t, seeds, sub, xd, np.stack(out, 1))


def test_count_matches_matches_jax(pair):
    q, t, seeds = pair
    q = _special(np.random.default_rng(5), q)
    seeds = seeds[:500]
    rng = np.random.default_rng(6)
    left = rng.integers(0, 300, len(seeds)).astype(np.int32)
    right = rng.integers(-1, 300, len(seeds)).astype(np.int32)
    want = jx._count_matches(jnp.asarray(q, jnp.int32), jnp.asarray(t, jnp.int32),
                             jnp.asarray(seeds[:, 0], jnp.int32),
                             jnp.asarray(seeds[:, 1], jnp.int32), jnp.asarray(left),
                             jnp.asarray(right), int((left + right).max()))
    got = xdrop_plain.count_matches_plain(
        torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(seeds[:, 0].astype(np.int32)),
        torch.from_numpy(seeds[:, 1].astype(np.int32)), torch.from_numpy(left),
        torch.from_numpy(right), 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def count_sets():
    return chip_smoke.xdrop_count_sets(np.random.default_rng(15))


@pytest.mark.parametrize("case", ["word ends", "sequence ends", "spans", "waves"])
def test_count_sets_match_jax(count_sets, case):
    """The match-count kernel's edge sets (``chip_smoke.xdrop_count_sets``:
    crafted extents whose segments end at every byte of a word, cross
    position 0 and the sequences' ends, spans 0, -1 and over 1,000, codes
    4-7, 50,000 seeds): ``count_matches_plain`` against ``_count_matches``."""
    spec = count_sets[case]
    seeds, left, right = spec["seeds"], spec["left"], spec["right"]
    want = jx._count_matches(jnp.asarray(spec["q"], jnp.int32), jnp.asarray(spec["t"], jnp.int32),
                             jnp.asarray(seeds[:, 0]), jnp.asarray(seeds[:, 1]),
                             jnp.asarray(left), jnp.asarray(right),
                             int(max(0, (left.astype(np.int64) + right).max())))
    got = xdrop_plain.count_matches_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in
          (spec["q"], spec["t"], seeds[:, 0], seeds[:, 1], left, right)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum() > 0


def _crafted_ssps():
    S = jx.ScoredSegmentPair
    return [
        # one diagonal: containments either way, equal starts, equal ends
        S(100, 50, 40, 5000), S(110, 60, 10, 7000), S(100, 50, 60, 4000), S(100, 50, 60, 4500),
        S(120, 70, 40, 3000), S(130, 80, 40, 3100), S(90, 40, 70, 3200), S(200, 150, 5, 3300),
        # diagonals that wrap as uint32 (target start < query start)
        S(5, 100, 20, 6000), S(10, 105, 5, 6000), S(0, 4000, 50, 3000), S(30, 4030, 30, 3000),
        # other diagonals, ties on every key
        S(7, 7, 0, 3000), S(7, 7, 0, 3000), S(7, 6, -1, 3001), S(3000, 1, 9, 9000),
    ]


@pytest.mark.parametrize("which", ["crafted", "random"])
def test_sort_and_dedup_matches_jax(which):
    if which == "crafted":
        ssps = _crafted_ssps()
    else:
        rng = np.random.default_rng(7)
        n = 400
        t = rng.integers(0, 300, n)
        d = rng.integers(-3, 4, n)
        ssps = [jx.ScoredSegmentPair(int(a), int(max(a - b, 0)), int(c), int(s)) for a, b, c, s in
                zip(t, d, rng.integers(-1, 60, n), rng.integers(3000, 3010, n))]
    want = [s.astuple() for s in jx._sort_and_dedup(ssps)]
    got = [s.astuple() for s in px._sort_and_dedup(
        [px.ScoredSegmentPair(*s.astuple()) for s in ssps])]
    assert got == want
    assert len(got) < len(ssps)


SECOND_MATRIX = np.array([[2 if a == b else -3 for b in range(8)] for a in range(8)],
                         np.int32) * 50


@pytest.mark.parametrize("case", ["entropy", "no_entropy", "threshold 500", "xdrop 200",
                                  "second matrix", "three batches", "seed edges", "L N &",
                                  "ties"])
def test_ssp_lists_match_jax(pair, case):
    """Whole SSP lists, same SSPs in the same order, under each setting."""
    q, t, seeds = pair
    kw, thr, batch = {}, 3000, 1 << 22
    if case == "no_entropy":
        kw["no_entropy"] = True
    elif case == "threshold 500":
        thr = 500
    elif case == "xdrop 200":
        kw["xdrop_threshold"] = 200
    elif case == "second matrix":
        kw["score_matrix"] = SECOND_MATRIX
        thr = 1500
    elif case == "three batches":
        batch = 1100
    elif case == "seed edges":
        Lq, Lt = len(q), len(t)
        seeds = np.concatenate([seeds, [[0, 0], [Lq - 1, Lt - 1], [Lq + 3, Lt + 3], [-40, 10],
                                        [10, -40], [Lq + 100, 5], [5, Lt + 100], [Lq - 1, 0],
                                        [0, Lt - 1], [0, 0]]])
    elif case == "L N &":
        rng = np.random.default_rng(8)
        q, t = _special(rng, q, 0.003), _special(rng, t, 0.003)
        thr = 1000
    elif case == "ties":
        # +100 / -100 / +100: a maximum tied in a tile and across tiles
        sub = px.DEFAULT_SCORE_MATRIX.copy()
        sub[1, 1], sub[1, 2] = 100, -100
        kw["score_matrix"] = sub
        q = np.array([1] + [2, 1] * 30 + [2] * 20 + [1, 2, 1] + [2] * 20, np.uint8)
        t = np.ones(len(q), np.uint8)
        seeds = np.array([[0, 0], [81, 81], [2, 2], [60, 60]])
        thr = 50
    a = jx.UngappedXDrop(batch_max_extensions=batch, **kw)
    a.extend_async(q, t, thr, seeds)
    b = px.UngappedXDrop(batch_max_extensions=batch, device="cpu", **kw)
    b.extend_async(q, t, thr, seeds)
    b.sync()
    assert len(b.get_scored_segment_pairs()) > 0
    assert _lists_equal(b.get_scored_segment_pairs(), a.get_scored_segment_pairs())


def test_negative_start_sorts_as_uint32_where_jax_raises(pair):
    """A kept SSP that starts before 0 (a seed at a negative position): the
    JAX package raises (NumPy 2 refuses the uint32 conversion); the port
    keeps the reference's uint32 order, so it sorts after the SSPs that
    start at 0 on its diagonal and is not taken as containing them."""
    q, t, _ = pair
    seeds = np.array([[-5, -5], [0, 0]])
    with pytest.raises(OverflowError):
        jx.create_extender().extend_async(q, t, 500, seeds)
    b = px.create_extender(device="cpu")
    b.extend_async(q, t, 500, seeds)
    got = [s.astuple() for s in b.get_scored_segment_pairs()]
    j = jx.create_extender()
    j.extend_async(q, t, 500, seeds[1:])
    first = [s.astuple() for s in j.get_scored_segment_pairs()]
    assert got[0] == first[0] and got[1][:2] == (-5, -5) and len(got) == 2


def test_tensor_inputs(pair):
    """Tensors on the extender's device (here the CPU) give the NumPy
    inputs' list, seeds too."""
    q, t, seeds = pair
    a = px.create_extender(device="cpu")
    a.extend_async(q, t, 3000, seeds)
    b = px.create_extender(device="cpu")
    b.extend_async(torch.from_numpy(q), torch.from_numpy(t.astype(np.int64)), 3000,
                   torch.from_numpy(seeds))
    assert len(a.get_scored_segment_pairs()) > 0
    assert _lists_equal(a.get_scored_segment_pairs(), b.get_scored_segment_pairs())
    b.reset()
    assert b.get_scored_segment_pairs() == [] and b.rescored == 0
    with pytest.raises(ValueError):
        b.extend_async(q, np.full(10, 8, np.uint8), 3000, seeds)


def test_csv_parsers(tmp_path):
    rng = np.random.default_rng(9)
    seeds = tmp_path / "seeds.csv"
    np.savetxt(seeds, rng.integers(0, 10**6, (50, 2)), fmt="%d", delimiter=",")
    np.testing.assert_array_equal(px.parse_seed_pairs(str(seeds)), jx.parse_seed_pairs(str(seeds)))
    ssps = tmp_path / "ssps.csv"
    np.savetxt(ssps, rng.integers(0, 10**6, (50, 4)), fmt="%d", delimiter=",")
    assert [s.astuple() for s in px.parse_scored_segment_pairs(str(ssps))] == \
        [s.astuple() for s in jx.parse_scored_segment_pairs(str(ssps))]


def test_sample_matches_jax(tmp_path, pair):
    """The port's sample on a temporary FASTA and seed CSV prints the lines
    the JAX extender's SSPs give for the genome against itself. The genome
    is the pair's target and query end to end, and the seeds pair the query
    half with the target half, so most of them are homologous."""
    from genomeworks_tpu_torch.io import write_fasta
    from genomeworks_tpu_torch.samples import sample_extender

    q, t, seeds = pair
    genome = np.frombuffer(b"ACGT", np.uint8)[np.concatenate([t, q])].tobytes().decode()
    fa, csv = tmp_path / "genome.fa", tmp_path / "seeds.csv"
    write_fasta([("genome", genome)], fa)
    seeds = seeds[:1000] + [len(t), 0]
    np.savetxt(csv, seeds[:, ::-1], fmt="%d", delimiter=",")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        sample_extender.main([str(fa), str(csv), "--device", "cpu"])
    ex = jx.create_extender()
    codes = jx.encode_sequence(genome)
    ex.extend_async(codes, codes, 3000, jx.parse_seed_pairs(str(csv)))
    want = chip_smoke.ssp_lines(ex.get_scored_segment_pairs())
    assert len(want) == 11
    assert out.getvalue().splitlines() == want
