"""The port's ``gw_mapper`` tool against the JAX package's on the CPU: the same
bytes of PAF, SAM and BAM on a temporary FASTA of simulated reads, on the
device and the host pipeline, with and without ``-R``. Both tools run as a
shell runs them (``main()`` reading ``sys.argv``, so the SAM and BAM headers
carry no command line); the port's adds ``--device cpu``.

The JAX tool is never run with ``--align`` (its aligner reaches the Pallas
kernels, in interpret mode on the CPU). The port's ``--align`` CIGARs are
held as tests/test_torch_aligner.py holds the aligner: each consumes exactly
its overlap's query and target spans, and the optimal ones equal
``align_cpu``."""

import re
import sys

import numpy as np
import pytest

from genomeworks_tpu.tools import gw_mapper as jtool
from genomeworks_tpu_torch.aligner import create_aligner
from genomeworks_tpu_torch.aligner.cpu_reference import align_cpu
from genomeworks_tpu_torch.aligner.types import states_to_cigar
from genomeworks_tpu_torch.core.sequence import reverse_complement
from genomeworks_tpu_torch.io import create_fasta_parser
from genomeworks_tpu_torch.tools import gw_mapper as ttool
from torch_mapper_inputs import write_fastas


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    return write_fastas(tmp_path_factory.mktemp("gw_mapper"))


def run(tool, args, monkeypatch, capsysbinary):
    monkeypatch.setattr(sys, "argv", ["gw-mapper", *args])
    capsysbinary.readouterr()
    tool.main()
    return capsysbinary.readouterr().out


@pytest.mark.parametrize("args", [
    ["--format", "paf"],
    ["--format", "paf", "--host-pipeline"],
    ["--format", "paf", "-R"],
    ["--format", "sam", "-R", "--host-pipeline"],
    ["--format", "sam", "-D", "-F", "0.002"],
    ["--format", "bam"],
    ["--format", "bam", "--host-pipeline", "-R"],
    ["--format", "paf", "-l", "400", "TARGETS"],
], ids=["paf", "paf-host", "paf-rescue", "sam-rescue-host", "sam-drop-filter", "bam",
        "bam-host-rescue", "paf-query-target"])
def test_tool_bytes_match_jax(fastas, monkeypatch, capsysbinary, args):
    args = [fastas["reads"], *(fastas["targets"] if a == "TARGETS" else a for a in args)]
    ref = run(jtool, args, monkeypatch, capsysbinary)
    got = run(ttool, [*args, "--device", "cpu"], monkeypatch, capsysbinary)
    assert len(ref) > 200
    assert got == ref


def test_tool_align_cigars_consume_spans(fastas, monkeypatch, capsysbinary):
    out = run(ttool, [fastas["align"], "--align", "--device", "cpu"], monkeypatch,
              capsysbinary).decode()
    lines = out.splitlines()
    assert len(lines) >= 4
    parser = create_fasta_parser(fastas["align"])
    seqs = {s.name: s.seq for s in parser.sequences()}
    pairs = []
    for line in lines:
        cols = line.split("\t")
        qs, qe, strand, ts, te = int(cols[2]), int(cols[3]), cols[4], int(cols[7]), int(cols[8])
        cigar = cols[12].removeprefix("cg:Z:")
        ops = [(int(n), op) for n, op in re.findall(r"(\d+)([MID=X])", cigar)]
        assert "".join(f"{n}{op}" for n, op in ops) == cigar
        # an insertion is a target base absent from the query, a deletion the
        # reverse (aligner/types.py)
        assert sum(n for n, op in ops if op in "MD=X") == qe - qs
        assert sum(n for n, op in ops if op in "MI=X") == te - ts
        t = seqs[cols[5]][ts:te]
        pairs.append((seqs[cols[0]][qs:qe], reverse_complement(t) if strand == "-" else t,
                      cigar))
    # the aligner the tool runs, on the same pairs: its optimal paths are the
    # oracle's
    aligner = create_aligner(max_bandwidth=512, device="cpu")
    for q, t, _ in pairs:
        aligner.add_alignment(q, t)
    aligner.align_all()
    alns = aligner.get_alignments()
    assert [a.convert_to_cigar() for a in alns] == [c for _, _, c in pairs]
    optimal = [i for i, a in enumerate(alns) if a.is_optimal]
    assert optimal
    for i in optimal[:3]:
        np.testing.assert_array_equal(alns[i].states, align_cpu(*pairs[i][:2]))
        assert states_to_cigar(align_cpu(*pairs[i][:2])) == pairs[i][2]
