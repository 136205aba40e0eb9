"""Batched partial-order alignment, full-band consensus (reference: cudapoa).

The PyTorch counterpart of genomeworks_tpu.poa: the NumPy oracle, the
batched PyTorch chain with its CUDA kernel, the lockstep tier with its five
CUDA kernels, the ``PoaBatch`` surface and the window helpers.
"""

from genomeworks_tpu_torch.poa.cpu_reference import (
    poa_consensus,
    poa_msa,
    PoaGraph,
    PoaError,
    build_backbone,
    nw_align,
    add_alignment,
    topological_sort,
    racon_topological_sort,
    generate_consensus,
    generate_msa,
)
from genomeworks_tpu_torch.poa.torch_poa import poa_batch_consensus
from genomeworks_tpu_torch.poa.lockstep import (
    lockstep_plan,
    poa_batch_consensus_lockstep,
    reset_tier_stats,
    tier_stats,
)
from genomeworks_tpu_torch.poa.batch import (
    BandMode,
    BatchConfig,
    OutputType,
    PoaBatch,
    StatusType,
    create_batch,
    decode_error,
)
from genomeworks_tpu_torch.poa.windows import (
    get_multi_batch_sizes,
    load_golden_lines,
    load_window_file,
    parse_cudapoa_file,
    parse_fasta_files,
    parse_golden_value_file,
    resize_windows,
)
