"""The port's mapper end to end against the JAX package's, on the CPU:
``map_reads`` on the device and host paths over one and several index
ranges, all-to-all and query against target; the empty inputs; the PAF, SAM
and BAM bytes; the index batcher; ``device=None`` on a machine without CUDA;
and the imports without JAX. Every comparison is exact."""

import io
import os
import subprocess
import sys

import pytest
import torch

import genomeworks_tpu.io.bam as jbam
import genomeworks_tpu.io.sam as jsam
import genomeworks_tpu.mapper as jmap
import genomeworks_tpu_torch.io.bam as tbam
import genomeworks_tpu_torch.io.sam as tsam
import genomeworks_tpu_torch.mapper as tmap
import genomeworks_tpu_torch.mapper.device_pipeline as tdp
from torch_mapper_inputs import parsers, to_jax, tuples, write_fastas

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    return write_fastas(tmp_path_factory.mktemp("mapper"))


# -- map_reads -------------------------------------------------------------------


@pytest.mark.parametrize("device_pipeline", [True, False])
@pytest.mark.parametrize("case", ["one_index", "ranges_filtered", "query_target_ranges"])
def test_map_reads_matches_jax(fastas, device_pipeline, case):
    tp, jp = parsers(fastas["reads"])
    kw = dict(device_pipeline=device_pipeline)
    if case != "one_index":
        # several index ranges: the all-to-all symmetry skip and the caches run
        kw.update(index_size_mb=0.025, target_index_size_mb=0.02, filtering_parameter=0.002)
    if case == "query_target_ranges":
        tt, jt = parsers(fastas["targets"])
        kw.update(drop_fused_overlaps=True)
    else:
        tt, jt = tp, jp
        if case == "ranges_filtered":
            kw.update(target_index_size_mb=0.025)
    ref = jmap.map_reads(jp, jt, jmap.MapperParams(**kw))
    got = tmap.map_reads(tp, tt, tmap.MapperParams(**kw), device=CPU)
    assert len(ref) > 0
    assert tuples(got) == tuples(ref)
    if case != "one_index":
        assert len(tmap.group_reads_into_index_ranges(tp, 25_000)) > 2
        assert tmap.group_reads_into_index_ranges(tp, 25_000) == \
            jmap.group_reads_into_index_ranges(jp, 25_000)


@pytest.mark.parametrize("name", ["short", "empty"])
def test_map_reads_empty_inputs(fastas, name):
    tp, jp = parsers(fastas[name])
    for device_pipeline in (True, False):
        ref = jmap.map_reads(jp, jp, jmap.MapperParams(device_pipeline=device_pipeline))
        got = tmap.map_reads(tp, tp, tmap.MapperParams(device_pipeline=device_pipeline),
                             device=CPU)
        assert got == ref == []


def test_map_reads_requires_cuda_by_default(fastas, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tp, _ = parsers(fastas["reads"])
    with pytest.raises(RuntimeError):
        tmap.map_reads(tp, tp)
    with pytest.raises(RuntimeError):
        tdp.build_index_device(tp, 0, 4)
    with pytest.raises(RuntimeError):
        tmap.build_index(tp, 0, 4)


def test_batcher_matches_jax(fastas):
    tp, jp = parsers(fastas["reads"])
    assert tmap.group_reads_into_indices(tp, 9000) == \
        [tmap.IndexDescriptor(d.first_read, d.number_of_reads)
         for d in jmap.group_reads_into_indices(jp, 9000)]
    for same in (True, False):
        got = tmap.generate_batches_of_indices(2, 1, 2, 1, tp, tp, 9000, 9000, same)
        ref = jmap.generate_batches_of_indices(2, 1, 2, 1, jp, jp, 9000, 9000, same)
        assert repr(got).replace("genomeworks_tpu_torch", "") == \
            repr(ref).replace("genomeworks_tpu", "")


# -- output bytes -----------------------------------------------------------------


@pytest.mark.parametrize("quirks", [False, True])
def test_paf_sam_bam_bytes_match_jax(fastas, quirks):
    tp, jp = parsers(fastas["reads"])
    tt, jt = parsers(fastas["targets"])
    overlaps = tmap.map_reads(tp, tt, tmap.MapperParams(), device=CPU)
    assert overlaps
    cigars = [f"{o.query_end_position_in_read - o.query_start_position_in_read}M"
              if i % 3 else "" for i, o in enumerate(overlaps)]
    jo = to_jax(overlaps)
    for cg in (None, cigars):
        assert list(tmap.overlaps_to_paf(overlaps, tp, tt, 15, cg)) == \
            list(jmap.overlaps_to_paf(jo, jp, jt, 15, cg))
        s_t, s_j = io.StringIO(), io.StringIO()
        tsam.write_sam(overlaps, cg, tp, tt, s_t, "gw-mapper x.fa", reference_quirks=quirks)
        jsam.write_sam(jo, cg, jp, jt, s_j, "gw-mapper x.fa", reference_quirks=quirks)
        assert s_t.getvalue() == s_j.getvalue()
        b_t, b_j = io.BytesIO(), io.BytesIO()
        tbam.write_bam(overlaps, cg, tp, tt, b_t, None, reference_quirks=quirks)
        jbam.write_bam(jo, cg, jp, jt, b_j, None, reference_quirks=quirks)
        assert b_t.getvalue() == b_j.getvalue()
    # a BGZF stream past one block, and the encoders
    big_t, big_j = io.BytesIO(), io.BytesIO()
    w_t, w_j = tbam.BgzfWriter(big_t), jbam.BgzfWriter(big_j)
    payload = bytes(range(256)) * 600
    w_t.write(payload), w_j.write(payload)
    w_t.close(), w_j.close()
    assert big_t.getvalue() == big_j.getvalue()
    assert tbam.encode_cigar("12M3I4D1=2X") == jbam.encode_cigar("12M3I4D1=2X")
    assert tbam.encode_seq("ACGTNacgtn*") == jbam.encode_seq("ACGTNacgtn*")


# -- imports ------------------------------------------------------------------------


def test_mapper_imports_without_jax(fastas):
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['genomeworks_tpu'] = None\n"
        "import genomeworks_tpu_torch.mapper as m\n"
        "import genomeworks_tpu_torch.mapper.device_pipeline, genomeworks_tpu_torch.mapper.cache\n"
        "import genomeworks_tpu_torch.simulators, genomeworks_tpu_torch.io.bam\n"
        "import genomeworks_tpu_torch.io.sam, genomeworks_tpu_torch.core.profiling\n"
        "from genomeworks_tpu_torch.tools import gw_mapper\n"
        "from genomeworks_tpu_torch.io import create_fasta_parser\n"
        f"p = create_fasta_parser({fastas['reads']!r})\n"
        "ov = m.map_reads(p, p, device='cpu')\n"
        "assert not any(k == 'genomeworks_tpu' or k.startswith(('genomeworks_tpu.', 'jax.'))"
        " for k, v in sys.modules.items() if v is not None), 'reference package imported'\n"
        "print(len(ov))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    tp, jp = parsers(fastas["reads"])
    assert int(proc.stdout) == len(jmap.map_reads(jp, jp)) > 0


def test_profiling_phases_and_trace(fastas, tmp_path, monkeypatch):
    from genomeworks_tpu_torch.core import profiling

    tp, _ = parsers(fastas["reads"])
    profiling.reset_phase_times()
    tmap.map_reads(tp, tp, tmap.MapperParams(index_size_mb=0.025, target_index_size_mb=0.025),
                   device=CPU)
    times = profiling.phase_times()
    # the JAX package's phase names, one call per index or pair
    assert sorted(times) == ["mapper/expand_sort_chain", "mapper/index_filter_unique",
                             "mapper/index_sort", "mapper/match_counts"]
    ranges = len(tmap.group_reads_into_index_ranges(tp, 0.025 * 1_000_000))
    # the query and target caches are apart, as in the JAX package: the
    # diagonal's targets come from the query cache, the other ranges are
    # built once as targets and once as queries
    assert ranges == 3 and times["mapper/index_sort"]["calls"] == 2 * ranges - 1
    assert times["mapper/match_counts"]["calls"] == ranges * (ranges + 1) // 2
    profiling.reset_phase_times()
    assert profiling.phase_times() == {}
    monkeypatch.delenv("GW_PROFILE", raising=False)
    monkeypatch.setenv("GW_PROFILE_DIR", str(tmp_path / "off"))
    with profiling.trace():
        torch.ones(4).sum()
    assert not (tmp_path / "off").exists()
    with profiling.trace(str(tmp_path / "on")):
        with profiling.annotate("x"):
            torch.ones(4).sum()
    assert list((tmp_path / "on").iterdir())
    assert profiling.phase_times()["x"]["calls"] == 1
