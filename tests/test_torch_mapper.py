"""The port's mapper (``genomeworks_tpu_torch.mapper``) against the JAX
package's, stage by stage, on the CPU: indexes, anchors, chains, the device
pipeline, post-processing, filtering and rescue
(``test_torch_mapper_pipeline.py`` holds ``map_reads`` and the output
bytes). The inputs are simulated reads on both strands (the port's
simulators) and seeded anchor sets. Every comparison is exact: the values
are integers and strings."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genomeworks_tpu.io as jio
import genomeworks_tpu.mapper as jmap
import genomeworks_tpu.mapper.device_overlapper as jdo
import genomeworks_tpu.mapper.device_pipeline as jdp
import genomeworks_tpu.mapper.matcher as jmatch
import genomeworks_tpu.mapper.overlapper as jov
import genomeworks_tpu_torch.mapper as tmap
import genomeworks_tpu_torch.mapper.device_overlapper as tdo
import genomeworks_tpu_torch.mapper.device_pipeline as tdp
import genomeworks_tpu_torch.mapper.matcher as tmatch
import genomeworks_tpu_torch.mapper.overlapper as tov
from genomeworks_tpu_torch.mapper.cache import CacheType, DeviceIndexCache, HostIndexCache
from genomeworks_tpu_torch.mapper.index import index_from_numpy
from torch_mapper_inputs import parsers, to_jax, tuples, write_fastas

CPU = "cpu"


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    return write_fastas(tmp_path_factory.mktemp("mapper"))


def assert_index_equal(port, ref):
    for f in dataclasses.fields(tmap.Index):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


# -- index ----------------------------------------------------------------------


@pytest.mark.parametrize("filtering", [1.0, 0.02])
@pytest.mark.parametrize("rng_", [(0, 40), (5, 31)])
def test_build_index_matches_jax(fastas, filtering, rng_):
    tp, jp = parsers(fastas["reads"])
    ref = jmap.build_index(jp, *rng_, 15, 10, True, filtering)
    port = tmap.build_index(tp, *rng_, 15, 10, True, filtering, device=CPU)
    assert_index_equal(port, ref)
    assert port.number_of_sketch_elements() == ref.number_of_sketch_elements() > 0
    # the converter keeps every field
    assert_index_equal(index_from_numpy(ref), ref)


@pytest.mark.parametrize("filtering", [1.0, 0.02])
def test_build_index_device_matches_jax(fastas, filtering):
    tp, jp = parsers(fastas["reads"])
    ref = jdp.build_index_device(jp, 3, 40, 15, 10, True, filtering)
    port = tdp.build_index_device(tp, 3, 40, 15, 10, True, filtering, device=CPU)
    assert (port.n, port.u) == (ref.n, ref.u)
    assert_index_equal(port.to_host(), ref.to_host())
    assert_index_equal(port.to_host(), tmap.build_index(tp, 3, 40, 15, 10, True, filtering,
                                                        device=CPU))
    # staged back from the host index: the same tensors
    staged = tdp.DeviceIndex.from_index(port.to_host(), CPU)
    assert_index_equal(staged.to_host(), ref.to_host())


@pytest.mark.parametrize("bits", [[20, 20, 20, 3], [20, 20, 20, 4]], ids=["one-key", "passes"])
def test_sort_fields_is_lexicographic(bits):
    # 63 bits pack into one key; 64 take stable passes
    rng = np.random.default_rng(3)
    fields = [torch.from_numpy(rng.integers(0, 1 << b, 5000)) for b in bits]
    fields[0][:2500] = 7  # ties on the leading keys
    order = np.lexsort([f.numpy() for f in reversed(fields)])
    for f, got in zip(fields, tdp.sort_fields(fields, bits)):
        np.testing.assert_array_equal(got.numpy(), f.numpy()[order])


# -- anchors ----------------------------------------------------------------------


@pytest.mark.parametrize("pair", ["self", "query_target"])
def test_generate_anchors_match_jax(fastas, pair):
    _, jp = parsers(fastas["reads"])
    _, jt = parsers(fastas["targets"])
    jq = jmap.build_index(jp, 0, 40, 15, 10, True, 1.0)
    jt_index = jq if pair == "self" else jmap.build_index(jt, 0, 16, 15, 10, True, 1.0)
    ref = jmatch.generate_anchors(jq, jt_index)
    q = index_from_numpy(jq)
    t = q if pair == "self" else index_from_numpy(jt_index)
    for got in (tmatch.generate_anchors(q, t), tmatch.generate_anchors_device(q, t, CPU)):
        assert len(got) == len(ref) > 0
        for f in dataclasses.fields(tmatch.Anchors):
            a, b = getattr(got, f.name), getattr(ref, f.name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def random_anchors(n, n_reads=6, seed=0):
    """Runs of nearby anchors on random read pairs (chains and fusions form),
    sorted by the compound key, as tests/test_device_overlapper.py makes them."""
    rng = np.random.default_rng(seed)
    qr, tr, qp, tp = [], [], [], []
    while sum(len(x) for x in qp) < n:
        a, b = sorted(rng.integers(0, n_reads, 2))
        ln = int(rng.integers(1, 12))
        qp.append(int(rng.integers(0, 5000)) + np.cumsum(rng.integers(1, 200, ln)))
        tp.append(np.abs(int(rng.integers(0, 5000)) + np.cumsum(rng.integers(-199, 200, ln))))
        qr.append(np.full(ln, a))
        tr.append(np.full(ln, b))
    qrid, trid, qpos, tpos = (np.concatenate(x)[:n] for x in (qr, tr, qp, tp))
    order = np.lexsort((tpos, qpos, trid, qrid))
    return jmatch.Anchors(*(x[order].astype(np.uint32) for x in (qrid, trid, qpos, tpos)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("a2a", [True, False])
def test_get_overlaps_and_chain_match_jax(seed, a2a):
    anchors = random_anchors(3000, seed=seed)
    ref = jov.get_overlaps(anchors, all_to_all=a2a, min_overlap_len=100)
    assert len(ref) > 0
    port_anchors = tmatch.Anchors(*dataclasses.astuple(anchors))
    assert tuples(tov.get_overlaps(port_anchors, all_to_all=a2a, min_overlap_len=100)) == \
        tuples(ref)
    cols = [torch.from_numpy(x.astype(np.int32)) for x in dataclasses.astuple(anchors)]
    # chain_and_filter on the anchors followed by padding, which is ignored
    padded = [torch.cat([c, torch.zeros(96, dtype=torch.int32)]) for c in cols]
    assert tuples(tdo.get_overlaps_device(padded, len(anchors), a2a, min_overlap_len=100)) == \
        tuples(ref)
    # the JAX device chain at its own padded shape
    cap = 4096
    jcols = tuple(jnp.asarray(np.concatenate([x.astype(np.int32),
                                              np.zeros(cap - len(anchors), np.int32)]))
                  for x in dataclasses.astuple(anchors))
    assert tuples(jdo.get_overlaps_device(jcols, len(anchors), a2a, min_overlap_len=100)) == \
        tuples(ref)


def test_chain_empty_and_no_survivor():
    assert tdo.get_overlaps_device((torch.zeros(16, dtype=torch.int32),) * 4, 0, True) == []
    assert tov.get_overlaps(tmatch.Anchors(*(np.zeros(0, np.uint32),) * 4), True) == []
    # two anchors: no chain of three survives
    two = [torch.tensor([0, 0], dtype=torch.int32), torch.tensor([1, 1], dtype=torch.int32),
           torch.tensor([5, 9], dtype=torch.int32), torch.tensor([5, 9], dtype=torch.int32)]
    assert tdo.get_overlaps_device(two, 2, False) == []


# -- the device pipeline --------------------------------------------------------


@pytest.mark.parametrize("as_arrays", [False, True])
@pytest.mark.parametrize("pair", ["self", "query_target"])
def test_device_pipeline_matches_jax(fastas, as_arrays, pair):
    tp, jp = parsers(fastas["reads"])
    tt, jt = parsers(fastas["targets"])
    a2a = pair == "self"
    jq = jdp.build_index_device(jp, 0, 40, filtering_parameter=0.02)
    jt_index = jq if a2a else jdp.build_index_device(jt, 0, 16, filtering_parameter=0.02)
    q = tdp.build_index_device(tp, 0, 40, filtering_parameter=0.02, device=CPU)
    t = q if a2a else tdp.build_index_device(tt, 0, 16, filtering_parameter=0.02, device=CPU)
    ref = jdp.get_overlaps_device_pipeline(jq, jt_index, a2a, as_arrays=as_arrays)
    got = tdp.get_overlaps_device_pipeline(q, t, a2a, as_arrays=as_arrays)
    if as_arrays:
        for f in dataclasses.fields(tov.OverlapArrays):
            a, b = getattr(got, f.name), getattr(ref, f.name)
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        got, ref = got.to_overlaps(), ref.to_overlaps()
    assert len(ref) > 0
    assert tuples(got) == tuples(ref)
    # the host path on the same indexes
    host = tov.get_overlaps(tmatch.generate_anchors(q.to_host(), t.to_host()), a2a)
    assert tuples(host) == tuples(ref)


def test_device_pipeline_empty_index(fastas):
    tp, _ = parsers(fastas["short"])
    empty = tdp.build_index_device(tp, 0, 2, device=CPU)
    assert (empty.n, empty.u) == (0, 0)
    assert_index_equal(empty.to_host(), jmap.build_index(jio.create_fasta_parser(
        fastas["short"]), 0, 2))
    none = tdp.build_index_device(tp, 0, 0, device=CPU)
    assert (none.n, none.u, none.number_of_reads) == (0, 0, 0)
    assert tdp.get_overlaps_device_pipeline(empty, empty, True) == []
    arrays = tdp.get_overlaps_device_pipeline(empty, none, False, as_arrays=True)
    assert len(arrays) == 0 and arrays.query_read_id.dtype == np.int64
    assert len(tmatch.generate_anchors_device(empty.to_host(), empty.to_host(), CPU)) == 0


def test_caches_stage_and_reuse(fastas):
    tp, _ = parsers(fastas["reads"])
    built = []

    def build(desc):
        built.append(desc)
        return tmap.build_index(tp, desc.first_read, desc.first_read + desc.number_of_reads,
                                device=CPU)

    host = HostIndexCache(CacheType.query_cache, build, capacity=1)
    dev = DeviceIndexCache(host, device=CPU)
    d0, d1 = tmap.IndexDescriptor(0, 10), tmap.IndexDescriptor(10, 10)
    a = dev.get_index(d0)
    assert dev.get_index(d0) is a and len(dev) == 1 and host.misses == 1
    dev.get_index(d1)
    dev.wait_for_data_to_be_ready()
    assert len(host) == 1 and built == [d0, d1]
    assert_index_equal(a.to_host(), tmap.build_index(tp, 0, 10, device=CPU))
    host.generate_content([d0])
    assert host.misses == 3


# -- post-processing, filtering, rescue -----------------------------------------


def mergeable_overlaps():
    """Runs of overlaps that the reference's post-processing fuses: short
    gaps, gaps in ratio, gaps small against the spans, both strands, and a
    break between runs."""
    O = tov.Overlap
    return [
        O(0, 1, 0, 900, 100, 1000, "+", 40), O(0, 1, 1200, 2000, 1250, 2050, "+", 30),
        O(0, 1, 2100, 2900, 2150, 2950, "+", 35), O(0, 2, 100, 800, 3000, 3700, "-", 20),
        O(0, 2, 900, 1500, 2300, 2900, "-", 25), O(0, 2, 4000, 9000, 400, 5000, "-", 90),
        O(1, 2, 0, 500, 0, 500, "+", 10), O(1, 2, 2600, 3000, 2700, 3100, "+", 12),
        O(1, 3, 0, 10, 0, 10, "+", 1), O(1, 3, 10, 10, 10, 10, "+", 1),
    ]


@pytest.mark.parametrize("drop", [False, True])
def test_post_process_matches_jax(fastas, drop):
    tp, jp = parsers(fastas["reads"])
    mapped = tmap.map_reads(tp, tp, tmap.MapperParams(device_pipeline=False), device=CPU)
    for overlaps in (mergeable_overlaps(), mapped, mapped[:1], []):
        ref = jov.post_process_overlaps(to_jax(overlaps), drop)
        got = tov.post_process_overlaps(overlaps, drop)
        assert tuples(got) == tuples(ref)
        cols = [np.array(c) for c in zip(*tuples(overlaps))] if overlaps else [[]] * 8
        arrs = dict(
            query_read_id=np.asarray(cols[0], np.int32), target_read_id=np.asarray(cols[1], np.int32),
            query_start=np.asarray(cols[2], np.int32), query_end=np.asarray(cols[3], np.int32),
            target_start=np.asarray(cols[4], np.int32), target_end=np.asarray(cols[5], np.int32),
            rev=np.asarray(cols[6]) == "-", num_residues=np.asarray(cols[7], np.int32))
        got_a = tov.post_process_overlaps_arrays(tov.OverlapArrays(**arrs), drop)
        ref_a = jov.post_process_overlaps_arrays(jov.OverlapArrays(**arrs), drop)
        assert tuples(got_a.to_overlaps()) == tuples(ref_a.to_overlaps()) == tuples(ref)
    assert len(tov.post_process_overlaps(mergeable_overlaps())) > len(mergeable_overlaps())


def test_filter_rescue_and_kmers_match_jax(fastas):
    tp, jp = parsers(fastas["reads"])
    mapped = tmap.map_reads(tp, tp, tmap.MapperParams(device_pipeline=False), device=CPU)
    assert any(o.relative_strand == "-" for o in mapped)
    for args in ((), (40, 600), (1, 1)):
        assert tuples(tov.filter_overlaps(mapped + mergeable_overlaps(), *args)) == \
            tuples(jov.filter_overlaps(to_jax(mapped + mergeable_overlaps()), *args))
    for ext, sim in ((50, 0.9), (120, 0.5)):
        got = tov.rescue_overlap_ends(mapped, tp, tp, ext, sim)
        ref = jov.rescue_overlap_ends(to_jax(mapped), jp, jp, ext, sim)
        assert tuples(got) == tuples(ref)
    assert tuples(tov.rescue_overlap_ends(mapped, tp, tp, 50, 0.0)) != tuples(mapped)
    a, b = tp.get_sequence_by_id(0).seq[:300], tp.get_sequence_by_id(2).seq[:280]
    for fn in ("split_into_kmers", "sequence_jaccard_similarity"):
        for args in ((a, 15, 1), (a[:10], 15, 1), (a, 7, 3)):
            if fn == "sequence_jaccard_similarity":
                args = (a, b, *args[1:])
            assert getattr(tmap, fn)(*args) == getattr(jmap, fn)(*args)
    assert tmap.kmers.count_shared_elements(sorted("abcab"), sorted("bcx")) == \
        jmap.kmers.count_shared_elements(sorted("abcab"), sorted("bcx"))
