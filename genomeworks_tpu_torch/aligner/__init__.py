"""Batched banded pairwise global alignment with CIGARs (reference:
GenomeWorks ``cudaaligner``).

The PyTorch counterpart of genomeworks_tpu.aligner: the result types, the
NumPy oracle, the plain PyTorch forward passes and traceback, the
``Aligner`` surface over the CUDA kernels, and the unbanded edit-distance
helpers: ``myers.py`` (the CPU oracle, and the batched distances through
``myers_score_kernel`` on the card) and ``ukkonen.py`` (NumPy).
"""

from genomeworks_tpu_torch.aligner.types import (
    Alignment,
    AlignmentState,
    CigarFormat,
    StatusType,
    states_to_cigar,
)
from genomeworks_tpu_torch.aligner.aligner import (
    Aligner,
    DeviceAlignments,
    FixedBandAligner,
    create_aligner,
)
from genomeworks_tpu_torch.aligner.banded_nw import (
    band_offset,
    banded_nw_forward,
    banded_nw_forward_plain,
)
from genomeworks_tpu_torch.aligner.cpu_reference import (
    align_cpu,
    edit_distance_cpu,
    nw_score_matrix,
    nw_backtrace,
)
from genomeworks_tpu_torch.aligner.myers import (
    myers_edit_distance_cpu,
    myers_edit_distance_batched,
)
from genomeworks_tpu_torch.aligner.ukkonen import ukkonen_cpu, ukkonen_edit_distance_cpu
