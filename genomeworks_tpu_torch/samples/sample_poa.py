"""Sample: POA consensus and MSA through the batch API.

The port of samples/sample_poa.py (reference analogue:
cudapoa/samples/sample_cudapoa.cpp: windows -> create_batch ->
add_poa_group -> generate_poa -> get_consensus), on the CUDA card by
default:

    python -m genomeworks_tpu_torch.samples.sample_poa [--device cpu]
"""

from __future__ import annotations

import argparse

from genomeworks_tpu_torch.poa import BatchConfig, OutputType, PoaBatch, StatusType

WINDOWS = [
    ["ACGTACGTAA", "ACGCACGTAA", "ACGTACGTA", "ACGTTACGTAA"],
    ["TTGGCCAA", "TTGGCCAA", "TTGACCAA"],
]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    batch = PoaBatch(
        BatchConfig(max_sequence_size=1024),
        output_mask=OutputType.consensus | OutputType.msa,
        device=args.device,
    )
    for w in WINDOWS:
        status, _ = batch.add_poa_group(w)
        if status != StatusType.success:
            raise RuntimeError(f"add_poa_group refused a window: {status}")

    batch.generate_poa()

    consensus, coverage, _ = batch.get_consensus()
    for i, (c, cov) in enumerate(zip(consensus, coverage)):
        print(f"window {i} consensus: {c}  coverage: {[int(x) for x in cov]}")

    msa, _ = batch.get_msa()
    for i, rows in enumerate(msa):
        print(f"window {i} MSA:")
        for r in rows:
            print(f"  {r}")


if __name__ == "__main__":
    main()
