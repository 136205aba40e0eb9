"""BAM output for overlaps.

A copy of genomeworks_tpu/io/bam.py (NumPy and the standard library only).

Reference: cudamapper/src/utils.cpp:190-316 print_sam with
OutputFormat::BAM — htslib ``sam_open("-", "bwh")`` writes BGZF-compressed
binary BAM records (QNAME, FLAG=0, POS, MAPQ=255, CIGAR, 4-bit packed SEQ,
QUAL=0xff). This build has no htslib; it implements the two layers the
reference delegates to it:

- BGZF container (SAM spec §4.1): gzip members with the ``BC`` extra
  field carrying BSIZE, terminated by the fixed 28-byte EOF block. Any
  gzip reader can decompress the stream; BAM tools can seek it.
- BAM record encoding (SAM spec §4.2): little-endian core fields,
  NUL-terminated read name, uint32 CIGAR ops (len<<4|op), nibble-packed
  sequence (htslib ``bam_construct_seq`` table, mirrored from
  utils.cpp:140-160), 0xff quality sentinel.

Field semantics match :func:`genomeworks_tpu_torch.io.sam.write_sam`, including
its ``reference_quirks`` switch (FLAG always 0 + POS = query start, the
reference's exact behavior per utils.cpp:283-288).
"""

from __future__ import annotations

import struct
import zlib
from typing import IO, Sequence

from genomeworks_tpu_torch.mapper.overlapper import Overlap

# BGZF constants (SAM spec §4.1.1)
_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)
_BGZF_MAX_PAYLOAD = 65280  # htslib's per-block uncompressed budget

_CIGAR_OPS = "MIDNSHP=X"
# base -> nibble, the bam_construct_seq table (utils.cpp:140-160)
_SEQ_NIBBLE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
for _lc in list(_SEQ_NIBBLE):
    _SEQ_NIBBLE[_lc.lower()] = _SEQ_NIBBLE[_lc]


class BgzfWriter:
    """Minimal BGZF writer: buffers bytes, emits one gzip member with the
    BC/BSIZE extra field per <=64 KiB chunk, fixed EOF block on close."""

    def __init__(self, out: IO[bytes]):
        self._out = out
        self._buf = bytearray()

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= _BGZF_MAX_PAYLOAD:
            self._flush_block(bytes(self._buf[:_BGZF_MAX_PAYLOAD]))
            del self._buf[:_BGZF_MAX_PAYLOAD]

    def _flush_block(self, payload: bytes) -> None:
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        cdata = co.compress(payload) + co.flush()
        bsize = len(cdata) + 25 + 1  # header(12) + extra(6) + crc/isize(8)
        header = struct.pack(
            "<4BIBBHBBHH",
            0x1F, 0x8B, 0x08, 0x04,  # gzip magic + FLG.FEXTRA
            0,                        # MTIME
            0, 0xFF,                  # XFL, OS=unknown
            6,                        # XLEN
            0x42, 0x43, 2,            # 'B' 'C', SLEN=2
            bsize - 1,                # BSIZE - 1
        )
        self._out.write(header)
        self._out.write(cdata)
        self._out.write(struct.pack("<II", zlib.crc32(payload), len(payload)))

    def close(self) -> None:
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()
        self._out.write(_BGZF_EOF)


def _reg2bin(beg: int, end: int) -> int:
    """SAM spec §5.3 bin number for the [beg, end) interval."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def encode_cigar(cigar: str) -> bytes:
    """CIGAR string -> packed uint32 ops (len<<4 | op)."""
    out = bytearray()
    n = 0
    for ch in cigar:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            out += struct.pack("<I", (n << 4) | _CIGAR_OPS.index(ch))
            n = 0
    return bytes(out)


def encode_seq(seq: str) -> bytes:
    """Sequence -> 4-bit packed nibbles (utils.cpp encode_seq)."""
    nib = [_SEQ_NIBBLE.get(c, 15) for c in seq]
    if len(nib) % 2:
        nib.append(0)
    return bytes((nib[i] << 4) | nib[i + 1] for i in range(0, len(nib), 2))


def write_bam(
    overlaps: Sequence[Overlap],
    cigars: Sequence[str] | None,
    query_parser,
    target_parser,
    out: IO[bytes],
    command_line: str | None = None,
    version: str = "0.1.0",
    reference_quirks: bool = False,
) -> None:
    """Write overlaps as a BGZF-compressed BAM stream.

    Mirrors write_sam's header and per-record fields; RNEXT/PNEXT/TLEN are
    unset as in the reference (utils.cpp:295-296 "all left as blank").
    """
    # reference order: targets appear in first-overlap order (write_sam)
    ref_ids: dict[int, int] = {}
    ref_names: list[str] = []
    ref_lens: list[int] = []
    for o in overlaps:
        if o.target_read_id not in ref_ids:
            ref_ids[o.target_read_id] = len(ref_names)
            t = target_parser.get_sequence_by_id(o.target_read_id)
            ref_names.append(t.name)
            ref_lens.append(len(t.seq))

    text = "@HD\tVN:1.6\tSO:unknown\n"
    for name, ln in zip(ref_names, ref_lens):
        text += f"@SQ\tSN:{name}\tLN:{ln}\n"
    text += f"@PG\tID:gw-mapper\tPN:gw-mapper\tVN:{version}"
    if command_line:
        text += f"\tCL:{command_line}"
    text += "\n"

    w = BgzfWriter(out)
    tbytes = text.encode()
    w.write(b"BAM\x01" + struct.pack("<i", len(tbytes)) + tbytes)
    w.write(struct.pack("<i", len(ref_names)))
    for name, ln in zip(ref_names, ref_lens):
        nb = name.encode() + b"\x00"
        w.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln))

    for i, o in enumerate(overlaps):
        q = query_parser.get_sequence_by_id(o.query_read_id)
        if reference_quirks:
            flag = 0
            pos = o.query_start_position_in_read
        else:
            flag = 0 if o.relative_strand == "+" else 16
            pos = o.target_start_position_in_read
        cigar = cigars[i] if cigars and i < len(cigars) and cigars[i] else ""
        cig = encode_cigar(cigar)
        seq = encode_seq(q.seq)
        name = q.name.encode() + b"\x00"
        # end position for the bin: pos + reference-consumed length
        ref_span = 0
        n = 0
        for ch in cigar:
            if ch.isdigit():
                n = n * 10 + ord(ch) - 48
            else:
                if ch in "MDN=X":
                    ref_span += n
                n = 0
        rec = struct.pack(
            "<iiBBHHHiiii",
            ref_ids[o.target_read_id],        # refID
            pos,                              # POS (0-based)
            len(name),                        # l_read_name (incl NUL)
            255,                              # MAPQ (as print_paf)
            _reg2bin(pos, pos + max(ref_span, 1)),
            len(cig) // 4,                    # n_cigar_op
            flag,
            len(q.seq),                       # l_seq
            -1, -1, 0,                        # RNEXT, PNEXT, TLEN unset
        )
        body = rec + name + cig + seq + b"\xff" * len(q.seq)
        w.write(struct.pack("<i", len(body)) + body)
    w.close()
