"""Alignment pipelines: the high-accuracy CCS / CONTIG pipeline
(highacc.py) and the low-accuracy ONT / CLR pipeline (lowacc.py)."""

from __future__ import annotations

import numpy as np

from .. import seq as sequtils
from ..index.global_index import GlobalIndex, build_global_index
from ..io.genome import Genome
from ..io.sam import (bed_record, paf_record, pairwise_record, sam_header,
                      sam_record, unmapped_record)
from ..device import resolve_device
from ..options import Options
from ..utils.timing import RECORDER
from .highacc import map_batch


def align_reads(reads, genome: Genome, index: GlobalIndex, opts: Options,
                use_device: bool = True, genome_li=None, timing=None,
                dots=None, device="cuda", batch_id=None):
    """Align a batch of reads; returns (states, sam_lines).

    reads: iterable of (name, seq) where seq is str/bytes/uint8-codes.
    device: where the device rounds run (use_device=True): "cuda" (the
    default; raises when no CUDA device is present) or "cpu", the
    explicit opt-in that runs every kernel's plain torch twin.
    batch_id: the batch's id in the span recorder (utils/timing.py)
    while it records; None takes the next free id.
    """
    import time as _time

    span = RECORDER.open_batch(batch_id) if RECORDER.on else None
    if use_device:
        device = resolve_device(device)

    t_batch0 = _time.perf_counter()
    prepared = []
    passthrough = {}
    for item in reads:
        name, s = item[0], item[1]
        qual = item[2] if len(item) > 2 else None
        if len(item) > 3 and item[3]:
            passthrough[name] = item[3]
        codes = s if isinstance(s, np.ndarray) else sequtils.encode(s)
        prepared.append((name, codes, qual))
    if opts.bypass_clustering:
        from .lowacc import map_batch_lowacc
        states = map_batch_lowacc(prepared, genome, index, opts, use_device,
                                  genome_li, dots, timing, device)
    else:
        states = map_batch(prepared, genome, index, opts, use_device,
                           genome_li, timing, dots, device)
    if opts.time_read and prepared:
        # batched execution has no per-read wall clock; RT:i reports the
        # amortized per-read share of the batch (reference: --timeRead,
        # Map_highacc.h:774-780 measures per read on the CPU)
        ms = int(1000 * (_time.perf_counter() - t_batch0) / len(prepared))
        for st in states:
            for group in st.groups:
                for seg in group.segments:
                    seg.runtime = ms
    lines = []
    for st in states:
        if st.unaligned or not st.groups:
            lines.append(unmapped_record(st.name, st.codes, st.qual))
            continue
        for a, group in enumerate(st.groups):
            if a >= opts.print_num_aln:
                break
            for s_i in range(len(group.segments) - 1, -1, -1):
                seg = group.segments[s_i]
                if opts.print_format in ("p", "pc"):
                    chrom_len = int(genome.ends[seg.chrom]
                                    - genome.starts()[seg.chrom])
                    lines.append(paf_record(seg, st.name, genome, chrom_len,
                                            opts.print_format == "pc"))
                elif opts.print_format == "b":
                    lines.append(bed_record(seg, st.name, genome))
                elif opts.print_format == "a":
                    starts = genome.starts()
                    chrom_codes = genome.codes[
                        starts[seg.chrom]:genome.ends[seg.chrom]]
                    read = st.rc if seg.strand == 1 else st.codes
                    lines.append(pairwise_record(seg, st.name, read,
                                                 chrom_codes, genome))
                else:
                    line = sam_record(seg, st.name, st.codes, st.rc,
                                      genome, opts, group, s_i, st.qual)
                    if opts.passthrough_tag and st.name in passthrough:
                        line += "\t" + passthrough[st.name]
                    lines.append(line)
    if span is not None:
        RECORDER.close_batch(span, reads=len(states),
                             bases=sum(len(st.codes) for st in states))
    return states, lines
