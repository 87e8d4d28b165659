"""BAM / SAM input with tag passthrough.

Replaces the reference's htslib-based BAM reading (reference:
Input.h:296-388): reads are pulled from BAM records (sequence + qual +
original aux tags, re-emitted on output with --passthroughtag) without an
htslib dependency — BGZF is a stream of concatenated gzip members, which
Python's gzip module reads transparently; record parsing is pure struct
unpacking.  SAM text input is also supported.
"""

from __future__ import annotations

import gzip
import struct
from typing import Iterator

import numpy as np

from .fasta import SeqRecord

_SEQ_CODES = "=ACMGRSVTWYHKDBN"
_CIGAR_OPS = "MIDNSHP=X"


class BamRecord(SeqRecord):
    def __init__(self, name, seq, qual, passthrough, flag):
        super().__init__(name, seq, qual)
        self.passthrough = passthrough   # tab-joined SAM-format tags
        self.flag = flag


def _tags_to_text(buf: bytes) -> str:
    """Binary aux data -> tab-separated SAM tag text."""
    out = []
    i = 0
    n = len(buf)
    while i + 3 <= n:
        tag = buf[i:i + 2].decode("ascii", "replace")
        typ = chr(buf[i + 2])
        i += 3
        if typ == "A":
            out.append(f"{tag}:A:{chr(buf[i])}")
            i += 1
        elif typ in "cC":
            v = struct.unpack_from("b" if typ == "c" else "B", buf, i)[0]
            out.append(f"{tag}:i:{v}")
            i += 1
        elif typ in "sS":
            v = struct.unpack_from("<h" if typ == "s" else "<H", buf, i)[0]
            out.append(f"{tag}:i:{v}")
            i += 2
        elif typ in "iI":
            v = struct.unpack_from("<i" if typ == "i" else "<I", buf, i)[0]
            out.append(f"{tag}:i:{v}")
            i += 4
        elif typ == "f":
            v = struct.unpack_from("<f", buf, i)[0]
            out.append(f"{tag}:f:{v:g}")
            i += 4
        elif typ in "ZH":
            end = buf.index(b"\x00", i)
            out.append(f"{tag}:{typ}:{buf[i:end].decode('ascii', 'replace')}")
            i = end + 1
        elif typ == "B":
            sub = chr(buf[i])
            cnt = struct.unpack_from("<I", buf, i + 1)[0]
            i += 5
            fmt = {"c": "b", "C": "B", "s": "<h", "S": "<H",
                   "i": "<i", "I": "<I", "f": "<f"}[sub]
            size = struct.calcsize(fmt)
            vals = [struct.unpack_from(fmt, buf, i + j * size)[0]
                    for j in range(cnt)]
            i += cnt * size
            out.append(f"{tag}:B:{sub}," + ",".join(
                f"{v:g}" if sub == "f" else str(v) for v in vals))
        else:
            break  # unknown type: stop parsing, keep what we have
    return "\t".join(out)


def read_bam(path: str) -> Iterator[BamRecord]:
    """Yield primary records (flag & 0x900 == 0) from a BAM file."""
    with gzip.open(path, "rb") as f:
        magic = f.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        l_text = struct.unpack("<i", f.read(4))[0]
        f.read(l_text)
        n_ref = struct.unpack("<i", f.read(4))[0]
        for _ in range(n_ref):
            l_name = struct.unpack("<i", f.read(4))[0]
            f.read(l_name + 4)
        while True:
            szb = f.read(4)
            if len(szb) < 4:
                return
            block_size = struct.unpack("<i", szb)[0]
            rec = f.read(block_size)
            if len(rec) < block_size:
                return
            (ref_id, pos, l_read_name, mapq, bin_, n_cigar_op, flag,
             l_seq, next_ref, next_pos, tlen) = struct.unpack_from(
                "<iiBBHHHiiii", rec, 0)
            off = 32
            name = rec[off:off + l_read_name - 1].decode()
            off += l_read_name
            off += 4 * n_cigar_op
            nsb = (l_seq + 1) // 2
            seq4 = rec[off:off + nsb]
            off += nsb
            qual = rec[off:off + l_seq]
            off += l_seq
            tags = _tags_to_text(rec[off:])
            if flag & 0x900:
                continue  # skip secondary/supplementary
            # unpack 4-bit sequence
            arr = np.frombuffer(seq4, dtype=np.uint8)
            hi = arr >> 4
            lo = arr & 0xF
            inter = np.empty(2 * len(arr), np.uint8)
            inter[0::2] = hi
            inter[1::2] = lo
            seq = "".join(_SEQ_CODES[c] for c in inter[:l_seq]).encode()
            q = bytes((min(x, 93) + 33) for x in qual) if qual and \
                qual[0] != 0xFF else None
            if flag & 0x10:
                # store in original (unmapped) orientation like htslib users
                comp = bytes.maketrans(b"ACGTN", b"TGCAN")
                seq = seq.translate(comp)[::-1]
                q = q[::-1] if q else None
            yield BamRecord(name, seq, q, tags, flag)


def read_sam_text(path: str) -> Iterator[BamRecord]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        for line in f:
            if line.startswith("@"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 11:
                continue
            flag = int(fields[1])
            if flag & 0x900 or fields[9] == "*":
                continue
            seq = fields[9]
            qual = fields[10]
            if flag & 0x10:
                comp = str.maketrans("ACGTN", "TGCAN")
                seq = seq.translate(comp)[::-1]
                qual = qual[::-1] if qual != "*" else qual
            yield BamRecord(fields[0], seq.encode(),
                            qual.encode() if qual != "*" else None,
                            "\t".join(fields[11:]), flag)
