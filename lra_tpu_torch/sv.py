"""Assembly SV calling: SAM -> VCF, haplotype merging.

Port of the reference's ``call_assembly_SVs`` pipeline (reference:
call_assembly_SVs/SamToVCF.py, mergeSV.py, callassemblysv.snakefile):
walk each primary alignment's CIGAR, emit INS/DEL records >= min_length
with QNAME/QSTART/QSTRAND/SVTYPE/SVLEN info, and merge per-haplotype
call sets (nearby same-type calls of similar length collapse into one
record with a combined genotype).  No pysam dependency — our own SAM
parsing against the in-memory genome.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from . import seq as sequtils

_CIG_RE = re.compile(r"(\d+)([MIDNSHP=X])")

VCF_HEADER = """##fileformat=VCFv4.2
##source=lra_tpu_sv
##INFO=<ID=QNAME,Number=1,Type=String,Description="Name of query sequence">
##INFO=<ID=QSTART,Number=1,Type=Integer,Description="Position of query sequence">
##INFO=<ID=QSTRAND,Number=1,Type=String,Description="Contig strand">
##INFO=<ID=SVLEN,Number=.,Type=Integer,Description="Difference in length between REF and ALT alleles">
##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of structural variant">
##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">
"""


@dataclass
class SVCall:
    chrom: str
    pos: int            # 1-based VCF position
    ref: str
    alt: str
    svtype: str
    svlen: int
    qname: str
    qstart: int
    strand: str
    gt: str = "1/1"

    def to_vcf(self) -> str:
        info = (f"SVTYPE={self.svtype};SVLEN={self.svlen};"
                f"QNAME={self.qname};QSTART={self.qstart};"
                f"QSTRAND={self.strand}")
        return "\t".join([self.chrom, str(self.pos), ".", self.ref,
                          self.alt, "60", "PASS", info, "GT", self.gt])


def calls_from_sam(sam_path: str, genome, min_length: int = 1):
    """Yield SVCalls from primary alignments in a SAM file."""
    starts = genome.starts()
    name_to_ci = {nm: i for i, nm in enumerate(genome.names)}
    with open(sam_path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fld = line.rstrip("\n").split("\t")
            if len(fld) < 11 or int(fld[1]) & 0x904 or fld[5] == "*":
                continue
            ci = name_to_ci.get(fld[2])
            if ci is None:
                continue
            chrom_codes = genome.codes[starts[ci]:genome.ends[ci]]
            strand = "-" if int(fld[1]) & 0x10 else "+"
            yield from _walk_cigar(fld[0], fld[2], int(fld[3]) - 1,
                                   fld[5], fld[9], chrom_codes, strand,
                                   min_length)


def _walk_cigar(qname, chrom_name, tpos, cigar, seq, chrom_codes, strand,
                min_length):
    q = 0
    t = tpos
    for ln, op in _CIG_RE.findall(cigar):
        ln = int(ln)
        if op in "SH":
            if op == "S":
                q += ln
            continue
        if op in "M=X":
            q += ln
            t += ln
        elif op == "I":
            if ln >= min_length and q > 0 and t > 0:
                ref_base = sequtils.decode(chrom_codes[t - 1:t])
                alt = seq[q - 1:q + ln]
                yield SVCall(chrom_name, t, ref_base, alt, "INS", ln,
                             qname, q + 1, strand)
            q += ln
        elif op in "DN":
            if ln >= min_length and q > 0:
                ref_seq = sequtils.decode(chrom_codes[t - 1:t + ln])
                alt = seq[q - 1:q] if q > 0 else "N"
                yield SVCall(chrom_name, t, ref_seq, alt, "DEL", -ln,
                             qname, q + 1, strand)
            t += ln


def sam_to_vcf(sam_path: str, genome, out, sample: str = "unknown",
               min_length: int = 1) -> int:
    """Write a VCF of INS/DEL calls; returns the record count."""
    out.write(VCF_HEADER)
    for i, name in enumerate(genome.names):
        ln = int(genome.ends[i] - genome.starts()[i])
        out.write(f"##contig=<ID={name},length={ln}>\n")
    out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
              f"{sample}\n")
    n = 0
    calls = sorted(calls_from_sam(sam_path, genome, min_length),
                   key=lambda c: (c.chrom, c.pos))
    for c in calls:
        out.write(c.to_vcf() + "\n")
        n += 1
    return n


def merge_haplotypes(calls_h1: list, calls_h2: list, window: int = 1000,
                     len_ratio: float = 0.7) -> list:
    """Combine two haplotypes' call lists: same-type calls within
    ``window`` bp whose lengths agree within ``len_ratio`` merge into one
    1/1 record; unmatched calls become 0/1
    (reference: combinehapSV.snakefile + mergeSV.py semantics)."""
    used2 = [False] * len(calls_h2)
    out = []
    by_chrom: dict = {}
    for j, c in enumerate(calls_h2):
        by_chrom.setdefault((c.chrom, c.svtype), []).append(j)
    for c in calls_h1:
        best = -1
        for j in by_chrom.get((c.chrom, c.svtype), []):
            if used2[j]:
                continue
            d = calls_h2[j]
            if abs(d.pos - c.pos) <= window:
                a, b = abs(c.svlen), abs(d.svlen)
                if min(a, b) / max(1, max(a, b)) >= len_ratio:
                    best = j
                    break
        if best >= 0:
            used2[best] = True
            c.gt = "1/1"
        else:
            c.gt = "0/1"
        out.append(c)
    for j, d in enumerate(calls_h2):
        if not used2[j]:
            d.gt = "0/1"
            out.append(d)
    out.sort(key=lambda c: (c.chrom, c.pos))
    # dedupe near-identical records (mergeSV.py removes repeat intersects)
    deduped = []
    for c in out:
        if deduped and deduped[-1].chrom == c.chrom and \
           deduped[-1].svtype == c.svtype and \
           abs(deduped[-1].pos - c.pos) < 10 and \
           deduped[-1].svlen == c.svlen:
            continue
        deduped.append(c)
    return deduped
