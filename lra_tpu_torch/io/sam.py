"""SAM output (reference: Alignment.h:658-808 ``PrintSAM``,
Alignment.h:811-905 ``SimplePrintSAM`` for unmapped, plus the @HD/@SQ/@PG
header written at lra.cpp:665-673).

Tag set matches the reference: NM MM NX ND TD NI TI NV AS AO N0 RT TP
SD ME LD SI MI LI, plus SA for split alignments.
"""

from __future__ import annotations

import numpy as np

from .. import seq as sequtils
from ..align.segment import Segment


def sam_header(genome, prog_args: str = "") -> str:
    lines = ["@HD\tVN:1.6\tSO:unknown"]
    starts = genome.starts()
    for i, name in enumerate(genome.names):
        lines.append(f"@SQ\tSN:{name}\tLN:{int(genome.ends[i] - starts[i])}")
    lines.append(f"@PG\tID:lra_tpu\tPN:lra_tpu\tVN:0.1.0\tCL:{prog_args}")
    return "\n".join(lines) + "\n"


def _cigar_with_clips(seg: Segment, hard_clip: bool) -> str:
    clip_op = "H" if (seg.is_supplementary and hard_clip) else "S"
    pre = f"{seg.pre_clip}{clip_op}" if seg.pre_clip > 0 else ""
    suf = f"{seg.suf_clip}{clip_op}" if seg.suf_clip > 0 else ""
    return pre + seg.stats.cigar + suf


def unmapped_record(name: str, read_codes: np.ndarray,
                    qual: bytes | None = None) -> str:
    seq = sequtils.decode(read_codes)
    q = qual.decode() if qual else "*"
    return f"{name}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq}\t{q}\tNM:i:0\tNV:f:0\tAS:i:0"


def sam_record(seg: Segment, name: str, read_fwd: np.ndarray,
               read_rc: np.ndarray, genome, opts, group=None,
               seg_index: int = 0, qual: bytes | None = None) -> str:
    """One SAM line; q coordinates/SEQ follow the segment's strand frame."""
    st = seg.stats
    chrom_name = genome.names[seg.chrom]
    read = read_rc if seg.strand == 1 else read_fwd
    if seg.is_supplementary and opts.hard_clip:
        seq = sequtils.decode(read[seg.qStart:seg.qEnd])
    else:
        seq = sequtils.decode(read)
    qstr = "*"
    if qual:
        q = qual[::-1] if seg.strand == 1 else qual
        if seg.is_supplementary and opts.hard_clip:
            qstr = q[seg.qStart:seg.qEnd].decode()
        else:
            qstr = q.decode()
    fields = [
        name, str(seg.flag()), chrom_name, str(seg.tStart + 1),
        str(seg.mapq), _cigar_with_clips(seg, opts.hard_clip),
        "*", "0", str(seg.tEnd - seg.tStart), seq, qstr,
        f"NM:i:{st.nmm + st.ndel + st.nins}",
        f"MM:i:{st.nmm + st.ndel + st.nins}",
        f"NX:i:{st.nmm}",
        f"ND:i:{st.ndel}",
        f"TD:i:{st.tdel}",
        f"NI:i:{st.nins}",
        f"TI:i:{st.tins}",
        f"NV:f:{seg.value:g}",
        f"AS:i:{int(seg.value)}",
        f"AO:i:{seg.order}",
        f"N0:i:{seg.num_anchors0}",
        f"RT:i:{seg.runtime}",
        "TP:A:" + ("P" if seg.typeofaln == 0 else
                   "S" if seg.typeofaln in (1, 2) else "I"),
        f"SD:i:{st.n_small_del}", f"ME:i:{st.n_med_del}",
        f"LD:i:{st.n_large_del}", f"SI:i:{st.n_small_ins}",
        f"MI:i:{st.n_med_ins}", f"LI:i:{st.n_large_ins}",
    ]
    if seg.md:
        fields.append(f"MD:Z:{seg.md}")
    if group is not None and len(group.segments) > 1:
        sa_parts = []
        for ag in range(len(group.segments) - 1, -1, -1):
            if ag == seg_index:
                continue
            o = group.segments[ag]
            sa_parts.append(
                f"{genome.names[o.chrom]},{o.tStart + 1},"
                f"{'+' if o.strand == 0 else '-'},"
                f"{_cigar_with_clips(o, False)},{o.mapq},{o.stats.nm};")
        fields.append("SA:Z:" + "".join(sa_parts))
    return "\t".join(fields)


def paf_record(seg: Segment, name: str, genome, chrom_len: int,
               print_cigar: bool = False) -> str:
    """PAF line (reference: Alignment.h:600-656 PrintPAF)."""
    st = seg.stats
    if seg.strand == 0:
        q0, q1 = seg.qStart, seg.qEnd
    else:
        q0, q1 = seg.read_len - seg.qEnd, seg.read_len - seg.qStart
    fields = [
        name, str(seg.read_len), str(q0), str(q1),
        "+" if seg.strand == 0 else "-",
        genome.names[seg.chrom], str(chrom_len),
        str(seg.tStart), str(seg.tEnd),
        str(st.nm), str(st.nm + st.nmm + st.ndel + st.nins),
        str(seg.mapq),
        f"OR:i:{seg.order}",
        f"NM:i:{st.nmm + st.ndel + st.nins}",
        f"NX:i:{st.nmm}", f"ND:i:{st.ndel}", f"TD:i:{st.tdel}",
        f"NI:i:{st.nins}", f"TI:i:{st.tins}",
        f"SD:i:{st.n_small_del}", f"ME:i:{st.n_med_del}",
        f"LD:i:{st.n_large_del}", f"SI:i:{st.n_small_ins}",
        f"MI:i:{st.n_med_ins}", f"LI:i:{st.n_large_ins}",
        f"N0:i:{seg.num_anchors0}",
        f"NV:f:{seg.value:g}", f"AS:i:{int(seg.value)}",
        "TP:A:" + ("P" if seg.typeofaln == 0 else
                   "S" if seg.typeofaln in (1, 2) else "I"),
    ]
    if seg.num_anchors1 > 0:
        fields.append(f"NA:i:{seg.num_anchors1}")
    if seg.md:
        fields.append(f"MD:Z:{seg.md}")
    if print_cigar:
        fields.append("CG:z:" + _cigar_with_clips(seg, False))
    return "\t".join(fields)


def pairwise_record(seg: Segment, name: str, read: np.ndarray,
                    chrom_codes: np.ndarray, genome) -> str:
    """Human-readable pairwise alignment (reference: PrintPairwise,
    Alignment.h:564-589; printFormat 'a'): 50-column q/align/t triplets
    with running coordinates; '|' match, '*' mismatch, '-' gap."""
    from ..align.cigar import blocks_to_ops

    if not seg.blocks:
        return name + "\n"
    ops = blocks_to_ops(seg.blocks, read, chrom_codes, True)
    q0, t0 = seg.blocks[0][0], seg.blocks[0][1]
    BASES = "ACGTN"
    qs, als, ts_ = [], [], []
    q, t = q0, t0
    for op, ln in ops:
        if op in ("=", "X", "M"):
            for i in range(ln):
                qc, tc = int(read[q + i]), int(chrom_codes[t + i])
                qs.append(BASES[qc])
                ts_.append(BASES[tc])
                als.append("|" if qc == tc else "*")
            q += ln
            t += ln
        elif op == "I":
            qs.extend(BASES[int(c)] for c in read[q:q + ln])
            ts_.extend("-" * ln)
            als.extend(" " * ln)
            q += ln
        elif op == "D":
            qs.extend("-" * ln)
            ts_.extend(BASES[int(c)] for c in chrom_codes[t:t + ln])
            als.extend(" " * ln)
            t += ln
    out = [name]
    out.append(f"Interval:\t{genome.names[seg.chrom]}:{t0}-{t}")
    qpos, tpos = q0, t0
    for i in range(0, len(qs), 50):
        qsub = "".join(qs[i:i + 50])
        tsub = "".join(ts_[i:i + 50])
        out.append(f"{qpos:>10} q: {qsub}")
        out.append("              " + "".join(als[i:i + 50]))
        out.append(f"{tpos:>10} t: {tsub}")
        out.append("")
        qpos += len(qsub) - qsub.count("-")
        tpos += len(tsub) - tsub.count("-")
    return "\n".join(out)


def bed_record(seg: Segment, name: str, genome) -> str:
    """BED line (reference: Alignment.h:591-598 PrintBed)."""
    st = seg.stats
    return "\t".join(str(x) for x in (
        genome.names[seg.chrom], seg.tStart, seg.tEnd, seg.mapq, name,
        seg.read_len, seg.qStart, seg.qEnd, st.nm, st.nmm, st.nins,
        st.ndel, seg.value, seg.flag(), seg.num_anchors1,
        seg.num_anchors1 / max(1.0, float(seg.read_len))))
