"""The PyTorch/CUDA port of full-band POA consensus (genomeworks_tpu_torch)
held against the JAX package.

Parity target: jax_poa's XLA chain (``use_pallas=False,
use_lockstep=False``) and its phase functions, run on the CPU; never a
Pallas interpret-mode run. Inputs are seeded numpy. Every comparison is
EXACT equality: the chain is integer arithmetic throughout (int32 scores,
ASCII bases), so there is no tolerance to state.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomeworks_tpu.poa import jax_poa
from genomeworks_tpu.simulators.genomesim import generate_random_genome, mutate_sequence
from genomeworks_tpu_torch.core.device import resolve_device
from genomeworks_tpu_torch.ops.poa_cuda import poa_consensus_cuda
from genomeworks_tpu_torch.poa import (
    BandMode,
    BatchConfig,
    OutputType,
    PoaBatch,
    StatusType,
    get_multi_batch_sizes,
    load_golden_lines,
    load_window_file,
)
from genomeworks_tpu_torch.poa import cpu_reference, torch_poa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")


def _windows(B=16, Lb=40, seed=0, sub=0.05, indel=0.05, max_reads=8):
    """B windows of 2..max_reads reads (varying per window) around a random
    template of Lb bases, plus per-base weights in [1, 4]."""
    rng = np.random.default_rng(seed)
    windows = []
    for b in range(B):
        t = generate_random_genome(Lb, rng)
        n = 2 + b % (max_reads - 1)
        windows.append([t] + [mutate_sequence(t, rng, sub, indel) for _ in range(n - 1)])
    weights = [[rng.integers(1, 5, size=len(s)).astype(np.int32) for s in w] for w in windows]
    return windows, weights


def _assert_same(ref, out):
    c1, v1, s1 = ref
    c2, v2, s2 = out
    assert list(s2) == list(s1)
    assert c2 == c1
    for a, b in zip(v1, v2):
        np.testing.assert_array_equal(b, a)


def _empty_later_reads(windows, weights):
    """Every other window's second read made empty (the first read, which
    starts the graph, stays)."""
    windows = [list(w) for w in windows]
    weights = [list(w) for w in weights]
    for b in range(1, len(windows), 2):
        windows[b][1] = ""
        weights[b][1] = np.zeros(0, np.int32)
    return windows, weights


@pytest.mark.parametrize(
    "weighted,empty", [(False, False), (True, False), (True, True)],
    ids=["unit", "weighted", "weighted-empty-reads"],
)
def test_plain_chain_matches_jax(weighted, empty):
    """(a) port plain chain == jax_poa XLA chain on random windows, also
    where later reads are empty."""
    windows, weights = _windows()
    if empty:
        windows, weights = _empty_later_reads(windows, weights)
    w = weights if weighted else None
    ref = jax_poa.poa_batch_consensus(windows, weights=w, use_pallas=False, use_lockstep=False)
    out = torch_poa.poa_batch_consensus(windows, weights=w, device="cpu")
    assert all(s == 0 for s in ref[2])
    _assert_same(ref, out)


def test_cap_overflow_statuses_match_jax():
    """(b) statuses 1 (node count) and 2 (edge / aligned-node lists) equal
    JAX's on windows driven over small caps."""
    windows, weights = _windows(seed=1, sub=0.12, indel=0.12)
    kw = dict(max_nodes=60, max_edges=4, max_alignments=4, weights=weights)
    ref = jax_poa.poa_batch_consensus(windows, use_pallas=False, use_lockstep=False, **kw)
    out = torch_poa.poa_batch_consensus(windows, device="cpu", **kw)
    assert {1, 2} <= set(ref[2]) and 0 in ref[2]
    _assert_same(ref, out)


def test_build_windows_graphs_matches_jax():
    """The graph state after the whole build equals jax_poa's, array by
    array, on weighted windows that all succeed."""
    windows, weights = _windows(B=8, seed=4, max_reads=6)
    ref, ref_n = jax_poa.build_windows_graphs(windows, weights=weights)
    out, out_n = torch_poa.build_windows_graphs(windows, weights=weights, device="cpu")
    np.testing.assert_array_equal(out_n, ref_n)
    assert not np.asarray(ref["error"]).any()
    for key, v in torch_poa.state_to_numpy(out).items():
        np.testing.assert_array_equal(v, np.asarray(ref[key]), err_msg=key)


def _np(state):
    return {k: np.asarray(v) for k, v in state.items()}


def test_phases_match_jax_one_at_a_time():
    """(c) one JAX graph state through each port phase (NW + traceback,
    add, topsort, consensus); each output equals the JAX function's, and
    JAX's output state feeds the next phase of both."""
    windows, weights = _windows(B=8, seed=2, max_reads=5)
    B = len(windows)
    S = max(len(w) for w in windows)
    L = max(len(s) for w in windows for s in w)
    N = 3 * L
    seqs = np.zeros((B, S, L), np.int32)
    wts = np.ones((B, S, L), np.int32)
    lens = np.zeros((B, S), np.int32)
    for b, w in enumerate(windows):
        for s, seq in enumerate(w):
            seqs[b, s, : len(seq)] = np.frombuffer(seq.encode(), np.uint8)
            wts[b, s, : len(seq)] = weights[b][s]
            lens[b, s] = len(seq)
    nseqs = np.array([len(w) for w in windows], np.int32)
    t = torch.from_numpy
    gap, mismatch, match = -8, -6, 8
    add_j = jax.jit(jax_poa.add_alignment_batched_seq)

    st = jax_poa.init_graph_state(B, N)
    st = jax_poa.build_backbone_batched(
        st, jnp.asarray(seqs[:, 0]), jnp.asarray(lens[:, 0]), jnp.asarray(wts[:, 0]),
        jnp.ones(B, bool),
    )
    mine = torch_poa.init_graph_state(B, N)
    torch_poa.build_backbone_batched(
        mine, t(seqs[:, 0]), t(lens[:, 0]), t(wts[:, 0]), torch.ones(B, dtype=torch.bool)
    )
    for k, v in torch_poa.state_to_numpy(mine).items():
        np.testing.assert_array_equal(v, np.asarray(st[k]), err_msg=f"backbone {k}")

    for s in range(1, S):
        active = nseqs > s
        read, rl, wt = seqs[:, s], lens[:, s], wts[:, s]
        # NW + traceback
        ag, ar, k, failed, _, _ = jax_poa.nw_batched(
            st, jnp.asarray(read), jnp.asarray(rl),
            jnp.zeros((B, N + 1, L + 1), jnp.float32), jnp.zeros((B, N + 1, L + 1), jnp.int32),
            jnp.asarray(active), gap=gap, mismatch=mismatch, match=match,
        )
        mine = torch_poa.state_from_numpy(_np(st))
        ag2, ar2, k2, failed2 = torch_poa.nw_batched(
            mine, t(read), t(rl), t(active), gap, mismatch, match
        )
        np.testing.assert_array_equal(k2.numpy(), np.asarray(k), err_msg=f"aln_len s={s}")
        np.testing.assert_array_equal(ag2.numpy(), np.asarray(ag), err_msg=f"ag s={s}")
        np.testing.assert_array_equal(ar2.numpy(), np.asarray(ar), err_msg=f"ar s={s}")
        np.testing.assert_array_equal(failed2.numpy(), np.asarray(failed))
        # add alignment
        st = add_j(st, ag, ar, k, jnp.asarray(read), jnp.asarray(wt), jnp.asarray(active))
        torch_poa.add_alignment_batched_seq(mine, ag2, ar2, k2, t(read), t(wt), t(active))
        for key, v in torch_poa.state_to_numpy(mine).items():
            np.testing.assert_array_equal(v, np.asarray(st[key]), err_msg=f"add {key} s={s}")
        # topological sort
        act = active & (np.asarray(st["error"]) == 0)
        st = jax_poa.topsort_batched(st, jnp.asarray(act))
        torch_poa.topsort_batched(mine, t(act))
        for key, v in torch_poa.state_to_numpy(mine).items():
            np.testing.assert_array_equal(v, np.asarray(st[key]), err_msg=f"topsort {key} s={s}")

    ref = jax_poa.consensus_batched(st, jnp.ones(B, bool))
    out = torch_poa.consensus_batched(
        torch_poa.state_from_numpy(_np(st)), torch.ones(B, dtype=torch.bool)
    )
    for name, a, b in zip(("cons", "cov", "length", "err"), ref, out):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


def test_poa_batch_cpu_covid_golden_prefix():
    """(d) PoaBatch(device="cpu") over the first 16 covid windows gives the
    committed golden consensus lines."""
    windows = load_window_file(os.path.join(DATA, "poa_windows_covid.txt.gz"), limit=16)
    golden = load_golden_lines(os.path.join(DATA, "poa_golden_covid.txt"), limit=16)
    configs, groups = get_multi_batch_sizes(windows, band_mode=BandMode.full_band)
    got = {}
    for cfg, wids in zip(configs, groups):
        batch = PoaBatch(cfg, OutputType.consensus, device="cpu")
        for wid in wids:
            assert batch.add_poa_group(windows[wid])[0] == StatusType.success
        batch.generate_poa()
        cons, cov, status = batch.get_consensus()
        for wid, c, v, s in zip(wids, cons, cov, status):
            assert s == StatusType.success
            assert len(v) == len(c)
            got[wid] = c
    assert [got[i] for i in range(len(windows))] == golden


def test_imports_without_jax():
    """(e) the port imports and runs one window with JAX unimportable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import genomeworks_tpu_torch.poa as p\n"
        "c, v, s = p.poa_batch_consensus([['ACGTACGTAC', 'ACGTTACGTAC', 'ACGACGTAC']],"
        " device='cpu')\n"
        "assert s == [0] and len(c[0]) == len(v[0]) > 0, (c, s)\n"
        "assert not any(m == 'genomeworks_tpu' or m.startswith(('genomeworks_tpu.', 'jax.'))"
        " for m in sys.modules), 'reference package imported'\n"
        "print(c[0])\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    expected, _ = cpu_reference.poa_consensus(["ACGTACGTAC", "ACGTTACGTAC", "ACGACGTAC"])
    assert proc.stdout.strip() == expected


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_import_no_jax_or_reference():
    """(f) no module of the port, and not chip_smoke.py, imports jax or
    genomeworks_tpu."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "genomeworks_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "genomeworks_tpu"), f"{f} imports {mod}"


def test_device_none_requires_cuda(monkeypatch):
    """(g) device=None means CUDA: without it every entry point raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        PoaBatch(BatchConfig(max_sequence_size=64))
    with pytest.raises(RuntimeError):
        torch_poa.poa_batch_consensus([["ACGT", "ACGT"]])
    assert resolve_device("cpu") == torch.device("cpu")


def _tensors(windows, weights=None, max_nodes=None):
    seqs, wts, lens, nseqs, N = torch_poa.pack_windows(windows, weights, max_nodes)
    return [torch.from_numpy(a) for a in (seqs, wts, lens, nseqs)], N


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """(g) the wrapper checks dtype, shape, contiguity, caps and counts,
    and raises instead of falling back."""
    (seqs, wts, lens, nseqs), N = _tensors(_windows(B=2)[0])
    kw = dict(N=N, E=50, A=50)
    with pytest.raises(TypeError):
        poa_consensus_cuda(seqs.to(torch.int32), wts, lens, nseqs, **kw)
    with pytest.raises(TypeError):
        poa_consensus_cuda(seqs, wts.to(torch.int64), lens, nseqs, **kw)
    with pytest.raises(ValueError):
        poa_consensus_cuda(seqs, wts, lens[:, :1], nseqs, **kw)
    with pytest.raises(ValueError):
        poa_consensus_cuda(seqs.transpose(1, 2).contiguous().transpose(1, 2), wts, lens,
                           nseqs, **kw)
    with pytest.raises(ValueError):  # 3E + 1 past the kernel's 16-bit codes
        poa_consensus_cuda(seqs, wts, lens, nseqs, N=N, E=21845, A=50)
    with pytest.raises(ValueError):
        poa_consensus_cuda(seqs, wts, lens, torch.zeros_like(nseqs), **kw)
    with pytest.raises(ValueError):
        poa_consensus_cuda(seqs, wts, lens, nseqs, N=4, E=50, A=50)
    empty_first = lens.clone()
    empty_first[1, 0] = 0
    with pytest.raises(ValueError, match="first of them non-empty"):
        poa_consensus_cuda(seqs, wts, empty_first, nseqs, **kw)


def test_wrapper_on_cpu_runs_the_plain_chain():
    """On CPU tensors the wrapper is the plain chain (counted), and the
    kernel launch count does not move."""
    (seqs, wts, lens, nseqs), N = _tensors(_windows(B=4)[0])
    calls, launches = torch_poa.poa_consensus_plain.calls, poa_consensus_cuda.launches
    out = poa_consensus_cuda(seqs, wts, lens, nseqs, N=N, E=50, A=50)
    ref = torch_poa.poa_consensus_plain(seqs, wts, lens, nseqs, N, 50, 50, -8, -6, 8)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert torch_poa.poa_consensus_plain.calls == calls + 2
    assert poa_consensus_cuda.launches == launches


def test_poa_batch_skips_empty_reads():
    """A non-empty read whose weights are all zero is skipped at add time
    as zero_weighted_poa_sequence. An empty read is added with success
    wherever it stands, as in the JAX package: a leading one adds nothing
    (the graph starts at the first non-empty read), a later one aligns as
    vertical moves only; the group gives the consensus it gives without
    them. A group of empty reads only is empty_poa_group."""
    (w0, w1), _ = _windows(B=2, seed=5)
    batch = PoaBatch(BatchConfig(max_sequence_size=64), device="cpu")
    zero = (w0[1], np.zeros(len(w0[1]), np.int32))
    st, per_seq = batch.add_poa_group(["", *w0[:2], zero, ("", np.zeros(0, np.int32)),
                                       *w0[2:]])
    assert st == StatusType.success
    assert per_seq == [StatusType.success, StatusType.success,
                       StatusType.success, StatusType.zero_weighted_poa_sequence,
                       StatusType.success] + [StatusType.success] * (len(w0) - 2)
    assert batch.add_poa_group(["", ""])[0] == StatusType.empty_poa_group
    assert batch.add_poa_group(w1)[0] == StatusType.success
    batch.generate_poa()
    cons, _, status = batch.get_consensus()
    ref = torch_poa.poa_batch_consensus([w0, w1], max_nodes=192, device="cpu")
    assert status == [StatusType.success] * 2
    assert cons == ref[0]


def test_poa_batch_unported_modes_raise():
    """Every band mode, MSA output and get_graphs are ported now: none of
    them raises NotImplementedError any more, and each gives a success on
    an easy window."""
    w = _windows(B=1)[0][0]
    for cfg, mask in (
        *((BatchConfig(max_sequence_size=64, band_width=128, band_mode=m),
           OutputType.consensus | OutputType.msa) for m in BandMode),
        (BatchConfig(max_sequence_size=64), OutputType.msa),
    ):
        batch = PoaBatch(cfg, mask, device="cpu")
        batch.add_poa_group(w)
        batch.generate_poa()
        if mask & OutputType.consensus:
            assert batch.get_consensus()[2] == [StatusType.success]
        assert batch.get_msa()[1] == [StatusType.success]
        assert batch.get_graphs()[1] == [StatusType.success]
