"""The port's native FASTA path (genomeworks_tpu_torch.io.native and the
``NativeFastaParser`` of ``create_fasta_parser``) against its Python parser
and the JAX package's native parser, on a simulated multi-line FASTA and its
gzip: names, sequences and the longest length, ``min_sequence_length``, the
shuffle's set, ``pack_2bit`` and ``codes_pack_2bit``'s A=0 C=1 G=2 T=3.
Skips where the native library cannot be built, as tests/test_native_io.py
does."""

import gzip
import shutil

import numpy as np
import pytest

import genomeworks_tpu.io.fasta as jfasta
import genomeworks_tpu.io.native as jnative
from genomeworks_tpu_torch.core.sequence import encode_bases
from genomeworks_tpu_torch.io import fasta as pfasta
from genomeworks_tpu_torch.io import native as pnative
from genomeworks_tpu_torch.simulators.genomesim import generate_random_genome


@pytest.fixture(scope="module")
def native():
    if not pnative.native_available():
        pytest.skip("native gwio library not built")
    return pnative


@pytest.fixture(scope="module", params=["fasta", "fasta.gz"])
def path(request, tmp_path_factory):
    """40 reads of 0-3,000 bases (two of them empty and short), 60 bases a
    line, names with a description after them."""
    rng = np.random.default_rng(17)
    d = tmp_path_factory.mktemp("native")
    plain = d / "reads.fasta"
    records = [(f"read{i} desc {i}", generate_random_genome(int(n), rng))
               for i, n in enumerate(rng.integers(0, 3000, 40))]
    records[3] = ("read3", "ACG")
    pfasta.write_fasta(records, plain, line_width=60)
    if request.param == "fasta":
        return str(plain)
    gz = d / "reads.fasta.gz"
    with open(plain, "rb") as src, gzip.open(gz, "wb") as dst:
        shutil.copyfileobj(src, dst)
    return str(gz)


def _records(parser):
    return [(r.name, r.seq) for r in parser.sequences()]


def test_native_matches_python_and_jax(native, path):
    pn = pfasta.create_fasta_parser(path)
    assert isinstance(pn, pfasta.NativeFastaParser)
    pp = pfasta.create_fasta_parser(path, use_native=False)
    jn = jfasta.create_fasta_parser(path, use_native=True)
    assert type(pp) is pfasta.FastaParser
    assert len(pn) == len(pp) == len(jn) == 40
    assert _records(pn) == _records(pp) == _records(jn)
    assert pn.get_max_sequence_length() == pp.get_max_sequence_length() == \
        jn.get_max_sequence_length()


@pytest.mark.parametrize("min_len", [1, 4, 1500])
def test_native_min_length(native, path, min_len):
    pn = pfasta.create_fasta_parser(path, min_sequence_length=min_len, use_native=True)
    pp = pfasta.create_fasta_parser(path, min_sequence_length=min_len, use_native=False)
    jn = jfasta.create_fasta_parser(path, min_sequence_length=min_len, use_native=True)
    assert _records(pn) == _records(pp) == _records(jn)


def test_native_shuffle_set(native, path):
    base = pfasta.create_fasta_parser(path, use_native=True)
    shuf = pfasta.create_fasta_parser(path, shuffle=True, use_native=True)
    jshuf = jfasta.create_fasta_parser(path, shuffle=True, use_native=True)
    assert sorted(_records(shuf)) == sorted(_records(base))
    assert _records(shuf) == _records(jshuf)  # the same native permutation


def test_native_pack_2bit(native, path):
    pn = pfasta.create_fasta_parser(path)
    jn = jfasta.create_fasta_parser(path, use_native=True)
    codes, lens = pn.pack_2bit(first=2, n=30)
    jcodes, jlens = jn.pack_2bit(first=2, n=30)
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(lens, jlens)
    assert codes.shape == (30, pn.get_max_sequence_length())
    for i in range(30):
        seq = pn.get_sequence_by_id(2 + i).seq
        assert lens[i] == len(seq)
        np.testing.assert_array_equal(codes[i, : lens[i]], encode_bases(seq))
        assert not codes[i, lens[i]:].any()
    with pytest.raises(IndexError):
        pn.pack_2bit(first=30, n=20)


def test_codes_pack_2bit(native):
    """A=0 C=1 G=2 T=3, base 4 i + k at bits 2 k of byte i; the pad byte 0
    packs to 0 and keeps the flag; any other byte clears it."""
    seqs = np.frombuffer(b"ACGTTGCAAAAA\0\0\0\0", np.uint8).reshape(2, 8).copy()
    out, ok = native.codes_pack_2bit(seqs)
    assert ok
    assert out.tolist() == [[0b11100100, 0b00011011], [0, 0]]
    jout, jok = jnative.codes_pack_2bit(seqs)
    np.testing.assert_array_equal(out, jout)
    assert ok == jok
    bad, ok = native.codes_pack_2bit(np.frombuffer(b"ACGN", np.uint8).copy())
    assert not ok
    with pytest.raises(ValueError):
        native.codes_pack_2bit(np.zeros(6, np.uint8))


def test_missing_file_raises(native, tmp_path):
    with pytest.raises(FileNotFoundError):
        pfasta.create_fasta_parser(tmp_path / "absent.fa")
