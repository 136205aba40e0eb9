"""I/O layer of the PyTorch port: FASTA/FASTQ parsing, PAF reading/writing.

Reference: GenomeWorks ``common/io`` (fasta_parser.hpp) and
``cudamapper/src/utils.cpp`` (PAF/SAM output), ``pygenomeworks/io``.
"""

from genomeworks_tpu_torch.io.fasta import (
    FastaSequence,
    FastaParser,
    create_fasta_parser,
    write_fasta,
)
from genomeworks_tpu_torch.io.paf import PafRecord, read_paf, write_paf, overlap_to_paf_line
