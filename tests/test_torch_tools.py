"""The port's pygenomeworks-layer tools, utilities and samples against the
JAX package's, on the CPU (tests/test_tools.py's cases): ``evaluate_paf``
and its CLI, the ``genome_simulator`` CLI, ``expand_cigar`` and
``render_ascii``, ``gfa2fa`` and ``calculate_error``; and the three samples
with ``--device cpu``, whose lines must be the JAX samples' lines. Every
comparison is exact."""

import os
import runpy
import sys

import pytest

import genomeworks_tpu.tools.alignment_visualizer as jviz
import genomeworks_tpu.tools.evaluate_paf as jeval
import genomeworks_tpu.tools.genome_simulator as jsim
import genomeworks_tpu.utils.utilities as jutil
import genomeworks_tpu_torch.tools.alignment_visualizer as tviz
import genomeworks_tpu_torch.tools.evaluate_paf as teval
import genomeworks_tpu_torch.tools.genome_simulator as tsim
import genomeworks_tpu_torch.utils.utilities as tutil
from genomeworks_tpu_torch.io.paf import PafRecord, read_paf, write_paf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rec(qname="q", tname="t", qs=0, qe=100, ts=0, te=100, strand="+"):
    return PafRecord(qname, 1000, qs, qe, strand, tname, 1000, ts, te, 10, 100, 255)


def test_match_overlaps_slop_and_reciprocal():
    a = _rec()
    for b, slop in ((_rec(qs=10, qe=105, ts=5, te=95), 20), (_rec(qs=500, qe=900, ts=500,
                                                                  te=900), 20)):
        assert teval.match_overlaps(a, b, slop, 0.9) == jeval.match_overlaps(a, b, slop, 0.9)
    assert teval.match_overlaps(a, _rec(qs=10, qe=105, ts=5, te=95), 20, 0.9)
    assert teval.calculate_reciprocal_overlap(a, a) == jeval.calculate_reciprocal_overlap(a, a) \
        == 2.0
    assert teval.reverse_record(_rec(qname="x", qs=3)) == jeval.reverse_record(_rec(qname="x",
                                                                                  qs=3))


def _pafs(tmp_path):
    truth = [_rec(), _rec(qname="q2", ts=200, te=300, qs=200, qe=300)]
    test = [
        _rec(qs=5, qe=95, ts=5, te=95),  # TP
        _rec(qname="q3", tname="t3"),  # FP
        # reversed orientation of truth[1] -> still a TP
        _rec(qname="t", tname="q2", qs=200, qe=300, ts=200, te=300),
        _rec(qname="q", tname="q"),  # a self mapping
    ]
    write_paf(truth, tmp_path / "truth.paf")
    write_paf(test, tmp_path / "test.paf")
    return str(tmp_path / "truth.paf"), str(tmp_path / "test.paf")


@pytest.mark.parametrize("skip_self", [True, False])
def test_evaluate_paf_matches_jax(tmp_path, skip_self):
    truth, test = _pafs(tmp_path)
    got = teval.evaluate_paf(truth, test, 20, 0.9, skip_self_mappings=skip_self)
    assert got == jeval.evaluate_paf(truth, test, 20, 0.9, skip_self_mappings=skip_self)
    if skip_self:
        assert got == (2, 1, 0, 2)


def test_evaluate_paf_cli_matches_jax(tmp_path, capsys):
    truth, test = _pafs(tmp_path)
    argv = ["-T", truth, "-i", test, "-s", "20"]
    assert teval.main(argv) == 0
    got = capsys.readouterr().out
    assert jeval.main(argv) == 0
    assert got == capsys.readouterr().out
    assert "True positives: 2" in got


def test_genome_simulator_cli_matches_jax(tmp_path, capsys):
    outs = {}
    for name, mod in (("port", tsim), ("jax", jsim)):
        d = tmp_path / name
        d.mkdir()
        paths = [str(d / f) for f in ("ref.fasta", "reads.fasta", "truth.paf")]
        assert mod.main([
            "--reference-length", "3000", "--median-read-length", "700", "--num-reads", "12",
            "--reference-filepath", paths[0], "--reads-filepath", paths[1],
            "--paf-filepath", paths[2], "--random-seed", "7",
        ]) == 0
        outs[name] = [open(p).read() for p in paths]
        capsys.readouterr()
    assert outs["port"] == outs["jax"]
    assert len(read_paf(str(tmp_path / "port" / "truth.paf"))) > 0


@pytest.mark.parametrize("cigar", ["3M1I2D", "10M", "2=1X3I4D1M"])
def test_expand_cigar_matches_jax(cigar):
    assert tviz.expand_cigar(cigar) == jviz.expand_cigar(cigar)


def test_render_ascii_matches_jax(capsys):
    art = tviz.render_ascii("ACG", "ACG", ["3M"])
    assert art == jviz.render_ascii("ACG", "ACG", ["3M"])
    assert "*" in art and art.count("\n") == 4
    args = ["ACGTA", "ACTA", "2M1D2M", "4M1D"]
    assert tviz.main(args) == 0
    got = capsys.readouterr().out
    assert jviz.main(args) == 0
    assert got == capsys.readouterr().out
    with pytest.raises(RuntimeError):
        tviz.render_ascii("AC", "AC", ["1M1P"])


def test_gfa2fa_matches_jax(tmp_path):
    gfa = tmp_path / "g.gfa"
    gfa.write_text("H\tVN:Z:1.0\nS\t0\tACGTACGT\nL\t0\t+\t1\t+\t*\nS\t1\t" + "T" * 170 + "\n")
    tutil.gfa2fa(str(gfa), str(tmp_path / "port.fa"))
    jutil.gfa2fa(str(gfa), str(tmp_path / "jax.fa"))
    got = (tmp_path / "port.fa").read_text()
    assert got == (tmp_path / "jax.fa").read_text()
    assert got.startswith(">0\nACGTACGT\n>1\n" + "T" * 80 + "\n")


def test_calculate_error_matches_jax(tmp_path):
    report = tmp_path / "report.txt"
    report.write_text("All statistics are based on contigs of size >= 500 bp\n"
                      "# mismatches per 100 kbp        12.50\n"
                      "# indels per 100 kbp            3.25\n")
    got = tutil.calculate_error(str(report))
    assert got == jutil.calculate_error(str(report))
    assert got == pytest.approx(15.75e-3)


def _run(path_or_module, argv, capsys, monkeypatch):
    """A sample's standard output: a JAX sample (a script) by its path, a
    port sample by its main()."""
    if isinstance(path_or_module, str):
        monkeypatch.setattr(sys, "argv", [path_or_module, *argv])
        runpy.run_path(path_or_module, run_name="__main__")
    else:
        path_or_module.main(argv + ["--device", "cpu"])
    return capsys.readouterr().out


@pytest.mark.parametrize("name", ["sample_aligner", "sample_poa", "sample_mapper"])
def test_sample_prints_the_jax_samples_lines(name, tmp_path, capsys, monkeypatch):
    import importlib

    argv = []
    if name == "sample_mapper":
        from torch_mapper_inputs import write_fastas

        argv = [write_fastas(tmp_path)["reads"]]
    port = importlib.import_module(f"genomeworks_tpu_torch.samples.{name}")
    got = _run(port, argv, capsys, monkeypatch)
    ref = _run(os.path.join(ROOT, "samples", f"{name}.py"), argv, capsys, monkeypatch)
    assert got == ref and got.count("\n") >= 6
