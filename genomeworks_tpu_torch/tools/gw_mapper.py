"""gw-mapper — all-vs-all / query-vs-target overlapper producing PAF, SAM or
BAM, on the PyTorch/CUDA port (a copy of genomeworks_tpu/tools/gw_mapper.py
over ``genomeworks_tpu_torch.mapper``).

Reference: the `cudamapper` tool (cudamapper/src/main.cu). It keeps the JAX
tool's flags and output and adds ``--device`` (default ``cuda``; ``cpu``
runs the same PyTorch stages on the host):

    python -m genomeworks_tpu_torch.tools.gw_mapper reads.fa > overlaps.paf
"""

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="gw-mapper", description="minimizer-based read overlapper (PAF output)"
    )
    p.add_argument("query", help="query FASTA/FASTQ(.gz)")
    p.add_argument("target", nargs="?", help="target FASTA (defaults to query: all-to-all)")
    p.add_argument("-k", "--kmer-size", type=int, default=15)
    p.add_argument("-w", "--window-size", type=int, default=10)
    p.add_argument("-i", "--index-size", type=int, default=30, help="MB of bases per index")
    p.add_argument("-t", "--target-index-size", type=int, default=None,
                   help="MB of bases per target index (default: --index-size)")
    p.add_argument("-d", "--num-devices", type=int, default=1,
                   help="devices to spread batches over (reference: one worker "
                   "thread per GPU; accepted for compatibility, one device runs)")
    p.add_argument("-a", "--alignment-engines", type=int, default=0,
                   help="align overlaps and emit cg:Z CIGARs when > 0 "
                   "(one batched aligner replaces the reference's aligner threads)")
    p.add_argument("-Q", "--query-indices-in-host-memory", type=int, default=10,
                   help="host index-cache capacity (HostIndexCache)")
    p.add_argument("-C", "--target-indices-in-host-memory", type=int, default=None,
                   help="target host index-cache capacity (default: -Q)")
    p.add_argument("-v", "--version", action="version",
                   version=__import__("genomeworks_tpu_torch").__version__)
    p.add_argument(
        "-F", "--filtering-parameter", type=float, default=None,
        help="fraction threshold for filtering frequent minimizers "
        "(default: auto — 1e-5, or off for inputs under 0.5 Mbp, "
        "application_parameters.cpp:225-250)",
    )
    p.add_argument("-r", "--min-residues", type=int, default=3)
    p.add_argument("-l", "--min-overlap-len", type=int, default=250)
    p.add_argument("-b", "--min-bases-per-residue", type=int, default=1000)
    p.add_argument("-z", "--min-overlap-fraction", type=float, default=0.8)
    p.add_argument("-D", "--drop-fused-overlaps", action="store_true")
    p.add_argument("--align", action="store_true", help="emit cg:Z CIGARs")
    p.add_argument(
        "-R", "--rescue-overlap-ends", action="store_true",
        help="extend overlap ends by flanking-sequence similarity",
    )
    p.add_argument(
        "--format", choices=("paf", "sam", "bam"), default="paf",
        help="output format (reference: cudamapper -S/-B flags)",
    )
    p.add_argument(
        "--host-pipeline", action="store_true",
        help="use the host NumPy matcher/overlapper instead of the "
        "device-resident pipeline (both give the same overlaps)",
    )
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the same PyTorch stages on the host)")
    args = p.parse_args(argv)

    from genomeworks_tpu_torch.io import create_fasta_parser
    from genomeworks_tpu_torch.io.sam import write_sam
    from genomeworks_tpu_torch.mapper import MapperParams, map_reads, overlaps_to_paf, align_overlaps
    from genomeworks_tpu_torch.mapper.overlapper import rescue_overlap_ends

    if args.alignment_engines > 0:
        args.align = True
    min_len = args.kmer_size + args.window_size - 1
    query_parser = create_fasta_parser(args.query, min_sequence_length=min_len)
    if args.target and args.target != args.query:
        target_parser = create_fasta_parser(args.target, min_sequence_length=min_len)
        all_to_all = False
    else:
        target_parser = query_parser
        all_to_all = True

    params = MapperParams(
        kmer_size=args.kmer_size,
        window_size=args.window_size,
        index_size_mb=args.index_size,
        target_index_size_mb=args.target_index_size or args.index_size,
        filtering_parameter=args.filtering_parameter,
        min_residues=args.min_residues,
        min_overlap_len=args.min_overlap_len,
        min_bases_per_residue=args.min_bases_per_residue,
        min_overlap_fraction=args.min_overlap_fraction,
        drop_fused_overlaps=args.drop_fused_overlaps,
        device_pipeline=not args.host_pipeline,
    )
    overlaps = map_reads(query_parser, target_parser, params, all_to_all, device=args.device)
    if args.rescue_overlap_ends:
        # main.cu rescue path (50 bp extension, 0.9 required similarity)
        overlaps = rescue_overlap_ends(overlaps, query_parser, target_parser, 50, 0.9)
    cigars = (align_overlaps(overlaps, query_parser, target_parser, device=args.device)
              if args.align else None)
    if args.format == "sam":
        write_sam(overlaps, cigars, query_parser, target_parser, sys.stdout,
                  command_line=" ".join(argv) if argv else None)
    elif args.format == "bam":
        from genomeworks_tpu_torch.io.bam import write_bam

        write_bam(overlaps, cigars, query_parser, target_parser,
                  sys.stdout.buffer,
                  command_line=" ".join(argv) if argv else None)
    else:
        for line in overlaps_to_paf(overlaps, query_parser, target_parser, args.kmer_size, cigars):
            sys.stdout.write(line + "\n")


if __name__ == "__main__":
    main()
