"""PyTorch/CUDA port of genomeworks_tpu for NVIDIA Hopper (H100).

The JAX package ``genomeworks_tpu`` is the reference. This package imports
neither it nor JAX: plain tensor code is PyTorch, and each Pallas kernel of
the reference becomes a CUDA kernel written for ``sm_90a`` (sources under
``csrc/``, built at first use into ``build/kernels/``). Every kernel keeps a
plain PyTorch version beside it, which the wrapper runs for tensors on the
CPU; a CUDA tensor goes to the kernel or the call raises.

Ported, each path through its own CUDA kernels:

- POA through ``poa.PoaBatch`` and ``poa.torch_poa``: full-band consensus on
  the lockstep tier (``csrc/poa_lockstep.cu``) with its re-runs, or
  ``use_lockstep=False``, on the per-window kernel
  (``csrc/poa_consensus.cu``, a warp per window); static and adaptive band
  and MSA output (the per-window kernel's banded and MSA instantiations);
  ``get_graphs``; the traceback-banded modes through the host chain, as the
  reference; and the ``gw_poa`` tool (``tools/gw_poa.py``);
- the banded aligner through ``aligner.create_aligner`` (Myers, banded NW
  and the run-length traceback);
- the mapper through ``mapper.map_reads`` and the ``gw_mapper`` tool
  (``tools/gw_mapper.py``): its device stages are PyTorch ops on the card
  (the JAX package's are XLA ops, with no Pallas kernel), and ``--align``
  runs the aligner's kernels; with the simulators and PAF, SAM and BAM I/O;
- the extender through ``extender.create_extender`` and
  ``samples/sample_extender.py``: ungapped X-drop seed extension, a warp
  per seed (``csrc/xdrop.cu``), with the batched Myers edit distance
  (``aligner.myers_edit_distance_batched``, ``csrc/myers_score.cu``),
  ``aligner/ukkonen.py`` and the native FASTA parser (``io/native.py``);
- the multi-device layer (``parallel``): one process per card in a
  ``torch.distributed`` group (NCCL between cards, gloo where named or on
  the CPU), with the sharded POA (the per-window kernel on each rank's
  windows), the sharded aligner step (``aligner.banded_nw_forward``, the
  banded NW kernel with its distance output), the sharded match counts, and
  the sharded and multi-process mappers, each equal to one device's result;
- the tools ``evaluate_paf``, ``genome_simulator`` and
  ``alignment_visualizer``, the samples (``samples/``: aligner, POA,
  mapper, extender), ``utils`` (``gfa2fa``, ``calculate_error``) and the
  native scalar CPU POA baseline (``poa/native_baseline.py``).
"""

__version__ = "0.1.0"


def version() -> str:
    """Framework version (reference: common/base version.hpp)."""
    return __version__
