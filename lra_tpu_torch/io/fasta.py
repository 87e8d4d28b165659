"""Host-side FASTA/FASTQ reading.

Replaces the reference's htslib/kseq input layer (reference: Input.h:23-421,
Genome.h:115-138).  BAM input is handled separately (see io/bam.py) since
htslib is not a dependency of this build.
"""

from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from .. import seq as sequtils


@dataclass
class SeqRecord:
    name: str
    seq: bytes
    qual: bytes | None = None


def _open(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f))
    return f


def sniff_format(path: str) -> str:
    with _open(path) as f:
        first = f.read(4)
    if first[:1] == b">":
        return "fasta"
    if first == b"BAM\x01":
        return "bam"
    if first[:1] == b"@":
        # SAM headers start with @HD/@SQ/@RG/@PG/@CO; FASTQ names are free-form
        if first[1:3] in (b"HD", b"SQ", b"RG", b"PG", b"CO"):
            return "sam"
        return "fastq"
    raise ValueError(f"unrecognized sequence file format: {path}")


def read_fasta(path: str) -> Iterator[SeqRecord]:
    name = None
    chunks: list[bytes] = []
    with _open(path) as f:
        for line in f:
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(b">"):
                if name is not None:
                    yield SeqRecord(name, b"".join(chunks))
                name = line[1:].split()[0].decode()
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            yield SeqRecord(name, b"".join(chunks))


def read_fastq(path: str) -> Iterator[SeqRecord]:
    with _open(path) as f:
        while True:
            header = f.readline().rstrip()
            if not header:
                return
            sq = f.readline().rstrip()
            f.readline()  # '+'
            qual = f.readline().rstrip()
            yield SeqRecord(header[1:].split()[0].decode(), sq, qual)


def read_seqs(path: str) -> Iterator[SeqRecord]:
    fmt = sniff_format(path)
    if fmt == "fasta":
        return read_fasta(path)
    if fmt == "fastq":
        return read_fastq(path)
    from .bam import read_bam, read_sam_text
    return read_bam(path) if fmt == "bam" else read_sam_text(path)
