"""Command-line interface.

Mirrors the reference binary's subcommands (reference: lra.cpp:1029-1068):

  index ref.fa [-CCS|-CLR|-ONT|-CONTIG]    build global+local indexes
  align ref.fa reads.fa -CCS ...           align reads -> SAM/PAF
  simulate ref.fa [-c COV|-n N] [--model aln.sam]  simulate reads
  callsv ref.fa aln.sam [--min-length 25]  SV calls -> VCF
  merge out.shard0 out.shard1 ... -o out   reassemble --nproc shards
  qti ref.fa reads.fa -CCS                 query-time benchmark

(`global` and `local` build each index separately, as in the reference.)

`align` and `qti` run their device rounds on a CUDA device by default
(`--device cuda`; it raises when there is none) or on the CPU with
`--device cpu` (every kernel's plain torch twin); `--cpu` runs the
host-only kernels instead.  `align -t N` streams batches through N
worker threads, each on its own CUDA stream.

Run as `python -m lra_tpu_torch.cli ...`.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from . import preset
from .device import resolve_device
from .index.global_index import GlobalIndex, build_global_index
from .index.local_index import LocalIndex, build_genome_local_index
from .io.fasta import read_seqs
from .io.genome import Genome
from .io.sam import sam_header, sam_record, unmapped_record
from .options import Options, ReadType


def _preset_from_args(argv):
    rt = "ccs"
    rest = []
    for a in argv:
        if a in ("-CCS", "-CLR", "-ONT", "-CONTIG"):
            rt = a[1:].lower()
        else:
            rest.append(a)
    return preset(rt), rest


def _parser(align: bool) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lra_tpu_torch")
    p.add_argument("ref")
    if align:
        p.add_argument("reads")
        p.add_argument("-o", "--out", default="-")
        p.add_argument("-p", "--printformat", default="s",
                       help="s=SAM p/pc=PAF a=pairwise b=BED "
                            "(reference -p flag)")
        p.add_argument("--printMD", action="store_true",
                       help="write the MD tag in SAM and PAF output")
        p.add_argument("--noMismatch", action="store_true",
                       help="use 'M' CIGAR ops instead of '='/'X'")
        p.add_argument("--batch", type=int, default=64)
        p.add_argument("--cpu", action="store_true",
                       help="host-only kernels (no device)")
        p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                       help="where the device rounds run: a CUDA device "
                            "(raises when there is none) or the CPU (the "
                            "kernels' plain torch twins)")
        p.add_argument("--passthrough", action="store_true",
                       help="re-emit input BAM/SAM tags on output records")
        p.add_argument("--timing", default="",
                       help="write per-stage timing report to this file")
        p.add_argument("--timeRead", action="store_true",
                       help="RT:i tag: amortized per-read runtime (ms)")
        p.add_argument("-d", "--dotplot", default="",
                       help="dump per-stage dots for --readname into this dir")
        p.add_argument("--readname", default="")
        p.add_argument("--start", type=int, default=0,
                       help="read index to start at (multi-job sharding, "
                            "reference lra.cpp:227-234)")
        p.add_argument("--stride", type=int, default=1,
                       help="read index stride (multi-job sharding)")
        p.add_argument("-t", "--threads", type=int, default=1,
                       help="batch pipeline depth: overlap host stages "
                            "of one batch with device rounds of another "
                            "(one CUDA stream per worker)")
        p.add_argument("--nproc", type=int, default=0,
                       help="multi-process/multi-host run: total process "
                            "count (each aligns reads procid::nproc and "
                            "writes OUT.shardID; merge with "
                            "`lra_tpu_torch merge`)")
        p.add_argument("--procid", type=int, default=0,
                       help="this process's index in a --nproc run")
        p.add_argument("--distributed", default="",
                       help="torch.distributed (gloo) coordinator "
                            "host:port (multi-host runs; optional — plain "
                            "--nproc runs are fully independent)")
        p.add_argument("-N", "--PrintNumAln", type=int, default=None,
                       help="max alignments to report per read")
        p.add_argument("--refineBreakpoints", action="store_true",
                       help="toggle breakpoint refinement (note the "
                            "reference's inverted default, "
                            "Map_highacc.h:723)")
        p.add_argument("-x", "--opt", action="append", default=[],
                       metavar="KEY=VALUE",
                       help="override any Options field by name "
                            "(the reference's ~120 tuning knobs, "
                            "Options.h:8-241)")
    return p


def _apply_overrides(opts: Options, args) -> None:
    if getattr(args, "PrintNumAln", None) is not None:
        opts.print_num_aln = args.PrintNumAln
    if getattr(args, "refineBreakpoints", False):
        opts.refine_breakpoint = True
    # type coercion uses the field's current value, not annotations
    for kv in getattr(args, "opt", []):
        key, _, val = kv.partition("=")
        if not hasattr(opts, key):
            raise SystemExit(f"unknown option {key!r}")
        cur = getattr(opts, key)
        if isinstance(cur, bool):
            setattr(opts, key, val.lower() in ("1", "true", "yes"))
        elif isinstance(cur, int):
            setattr(opts, key, int(val))
        elif isinstance(cur, float):
            setattr(opts, key, float(val))
        else:
            setattr(opts, key, val)


def cmd_index(argv, which: str = "index") -> int:
    """which: 'index' builds both, 'global'/'local' one tier only
    (reference subcommands, lra.cpp:1029-1068)."""
    opts, rest = _preset_from_args(argv)
    parser = _parser(False)
    parser.add_argument("--CalculateMinimizerStats", action="store_true",
                        help="report distinct/unique minimizer stats "
                             "(reference: MMIndex.h:46-67)")
    parser.add_argument("-t", "--threads", type=int, default=1,
                        help="parallel per-chromosome index build "
                             "(output identical at any thread count)")
    args = parser.parse_args(rest)
    genome = Genome.from_fasta(args.ref)
    if which in ("index", "global"):
        t0 = time.time()
        gi = build_global_index(genome, opts, threads=args.threads)
        gi.save(args.ref + ".gdx")
        print(f"global index: {len(gi)} minimizers (k={gi.k}) "
              f"in {time.time()-t0:.1f}s -> {args.ref}.gdx", file=sys.stderr)
        if args.CalculateMinimizerStats:
            s = gi.minimizer_stats()
            print(f"minimizer stats: total={s['total']} "
                  f"distinct={s['distinct']} unique={s['unique']} "
                  f"avg_freq={s['avg_freq']:.3f}", file=sys.stderr)
    if which in ("index", "local"):
        t0 = time.time()
        li = build_genome_local_index(genome, k=min(opts.local_k, 10),
                                      w=opts.local_w,
                                      window=opts.local_index_window,
                                      max_freq=opts.local_max_freq,
                                      threads=args.threads,
                                      exact=opts.exact_ref_minimizers)
        li.save(args.ref + ".ldx")
        print(f"local index: {len(li.tuples)} minimizers in "
              f"{time.time()-t0:.1f}s -> {args.ref}.ldx", file=sys.stderr)
    return 0


def cmd_align(argv) -> int:
    opts, rest = _preset_from_args(argv)
    args = _parser(True).parse_args(rest)
    opts.print_format = args.printformat
    opts.passthrough_tag = args.passthrough
    opts.print_md = args.printMD
    opts.show_mismatch = not args.noMismatch
    opts.time_read = args.timeRead
    _apply_overrides(opts, args)
    if args.nproc > 1:
        from .parallel.dist import init_process

        args.start, args.stride, args.out = init_process(
            args.nproc, args.procid, args.out, args.distributed)
    if not args.cpu:
        resolve_device(args.device)
    genome = Genome.from_fasta(args.ref)
    gdx, ldx = args.ref + ".gdx.npz", args.ref + ".ldx.npz"
    if os.path.exists(gdx):
        gi = GlobalIndex.load(gdx)
        if gi.k != opts.global_k:
            print(f"index k={gi.k} != preset k={opts.global_k}; rebuilding",
                  file=sys.stderr)
            gi = build_global_index(genome, opts)
    else:
        gi = build_global_index(genome, opts)
    li = LocalIndex.load(ldx) if os.path.exists(ldx) else \
        build_genome_local_index(genome, k=min(opts.local_k, 10),
                                 w=opts.local_w,
                                 window=opts.local_index_window,
                                 max_freq=opts.local_max_freq,
                                 exact=opts.exact_ref_minimizers)

    from .utils.dots import DotDumper
    from .utils.timing import Timing

    timing = Timing() if args.timing else None
    dots = None
    if args.dotplot and args.readname:
        dots = {args.readname: DotDumper(args.dotplot, args.readname)}

    out = sys.stdout if args.out == "-" else open(args.out, "w")
    if opts.print_format == "s":
        out.write(sam_header(genome, " ".join(sys.argv)))
    n = 0
    t0 = time.time()

    def gen_batches():
        batch = []
        prev_name = None
        for i, rec in enumerate(read_seqs(args.reads)):
            if i < args.start or (i - args.start) % args.stride != 0:
                continue
            if args.nproc > 1:
                # merge_shards delimits record groups by QNAME change;
                # two same-named reads adjacent in this shard would fuse
                # into one group and silently misalign the interleave
                if rec.name == prev_name:
                    raise SystemExit(
                        f"duplicate read name {rec.name!r} adjacent in "
                        "shard — --nproc runs need unique read names "
                        "(merge delimits record groups by QNAME)")
                prev_name = rec.name
            batch.append((rec.name, rec.seq, rec.qual,
                          getattr(rec, "passthrough", None)))
            if len(batch) >= args.batch:
                yield batch
                batch = []
        if batch:
            yield batch

    # -t N pipelines N batches through align_reads worker threads, each
    # on its own CUDA stream, so host stages of one batch overlap device
    # rounds of another (the reference's pthread fan-out analog,
    # lra.cpp:103-172); output stays in input order
    from .pipeline.stream import align_stream
    for states, lines in align_stream(gen_batches(), genome, gi, opts,
                                      use_device=not args.cpu,
                                      genome_li=li, timing=timing,
                                      dots=dots, workers=args.threads,
                                      device=args.device):
        for line in lines:
            out.write(line + "\n")
        n += len(states)
        print(f"aligned {n} reads ({n/(time.time()-t0):.1f} reads/s)",
              file=sys.stderr)
    print(f"done: {n} reads in {time.time()-t0:.1f}s", file=sys.stderr)
    if timing:
        timing.write(args.timing)
    if out is not sys.stdout:
        out.close()
    return 0


def cmd_simulate(argv) -> int:
    """alchemy2-equivalent model-based simulation."""
    p = argparse.ArgumentParser(prog="lra_tpu_torch simulate")
    p.add_argument("ref")
    p.add_argument("-c", "--coverage", type=float, default=None)
    p.add_argument("-n", "--nreads", type=int, default=None)
    p.add_argument("--bases", type=int, default=None)
    p.add_argument("--model", default="",
                   help="aligned SAM to learn the error model from")
    p.add_argument("--mismatch", type=float, default=0.002)
    p.add_argument("--ins", type=float, default=0.001)
    p.add_argument("--dele", type=float, default=0.001)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-o", "--out", default="-")
    args = p.parse_args(argv)
    from . import seq as sequtils
    from .sim_model import ErrorModel, learn_model

    genome = Genome.from_fasta(args.ref)
    if args.model:
        model = learn_model(args.model, genome)
    else:
        model = ErrorModel.uniform(mismatch=args.mismatch, ins=args.ins,
                                   dele=args.dele)
    rng = np.random.default_rng(args.seed)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    n = 0
    if args.coverage is None and args.nreads is None and args.bases is None:
        args.nreads = 100
    for name, codes in model.simulate(rng, genome.codes,
                                      coverage=args.coverage,
                                      total_bases=args.bases,
                                      n_reads=args.nreads):
        out.write(f">{name}\n{sequtils.decode(codes)}\n")
        n += 1
    print(f"simulated {n} reads", file=sys.stderr)
    if out is not sys.stdout:
        out.close()
    return 0


def cmd_callsv(argv) -> int:
    p = argparse.ArgumentParser(prog="lra_tpu_torch callsv")
    p.add_argument("ref")
    p.add_argument("sam", nargs="+",
                   help="one SAM (single sample) or two (hap1 hap2, merged)")
    p.add_argument("--min-length", type=int, default=25)
    p.add_argument("--sample", default="sample")
    p.add_argument("-o", "--out", default="-")
    args = p.parse_args(argv)
    from .sv import (VCF_HEADER, calls_from_sam, merge_haplotypes,
                     sam_to_vcf)

    genome = Genome.from_fasta(args.ref)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    if len(args.sam) == 1:
        n = sam_to_vcf(args.sam[0], genome, out, args.sample,
                       args.min_length)
    else:
        h1 = list(calls_from_sam(args.sam[0], genome, args.min_length))
        h2 = list(calls_from_sam(args.sam[1], genome, args.min_length))
        merged = merge_haplotypes(h1, h2)
        out.write(VCF_HEADER)
        for i, name in enumerate(genome.names):
            ln = int(genome.ends[i] - genome.starts()[i])
            out.write(f"##contig=<ID={name},length={ln}>\n")
        out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\t"
                  f"FORMAT\t{args.sample}\n")
        n = 0
        for c in merged:
            out.write(c.to_vcf() + "\n")
            n += 1
    print(f"wrote {n} SV records", file=sys.stderr)
    if out is not sys.stdout:
        out.close()
    return 0


def cmd_qti(argv) -> int:
    """Query-time benchmark harness (reference: QueryTime.cpp / the `qti`
    binary, Makefile:95-96): index + map with a per-stage timing report
    and a reads/s summary on stderr."""
    import io as _io

    from .pipeline import align_reads
    from .utils.timing import Timing

    opts, rest = _preset_from_args(argv)
    args = _parser(True).parse_args(rest)
    if not args.cpu:
        resolve_device(args.device)
    genome = Genome.from_fasta(args.ref)
    t0 = time.time()
    gi = build_global_index(genome, opts)
    t_index = time.time() - t0
    li = build_genome_local_index(genome, k=min(opts.local_k, 10),
                                  w=opts.local_w,
                                  window=opts.local_index_window,
                                  max_freq=opts.local_max_freq,
                                  exact=opts.exact_ref_minimizers)
    tm = Timing()
    n = 0
    t0 = time.time()
    batch = []
    for rec in read_seqs(args.reads):
        batch.append((rec.name, rec.seq, rec.qual))
        if len(batch) >= args.batch:
            align_reads(batch, genome, gi, opts, use_device=not args.cpu,
                        genome_li=li, timing=tm, device=args.device)
            n += len(batch)
            batch = []
    if batch:
        align_reads(batch, genome, gi, opts, use_device=not args.cpu,
                    genome_li=li, timing=tm, device=args.device)
        n += len(batch)
    dt = time.time() - t0
    buf = _io.StringIO()
    tm.write(buf)
    print(buf.getvalue(), file=sys.stderr)
    print(f"qti: index {t_index:.2f}s; mapped {n} reads in {dt:.2f}s "
          f"({n/max(dt,1e-9):.1f} reads/s)", file=sys.stderr)
    return 0


def cmd_merge(argv) -> int:
    """Merge --nproc SAM shards back into single-process order."""
    p = argparse.ArgumentParser(prog="lra_tpu_torch merge")
    p.add_argument("shards", nargs="+",
                   help="shard files ordered by procid")
    p.add_argument("-o", "--out", default="-")
    args = p.parse_args(argv)
    from .parallel.dist import merge_shards

    out = sys.stdout if args.out == "-" else open(args.out, "w")
    n = merge_shards(args.shards, out)
    if out is not sys.stdout:
        out.close()
    print(f"merged {n} reads from {len(args.shards)} shards",
          file=sys.stderr)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd in ("index", "global", "local"):
        return cmd_index(rest, which=cmd)
    if cmd == "align":
        return cmd_align(rest)
    if cmd == "merge":
        return cmd_merge(rest)
    if cmd == "qti":
        return cmd_qti(rest)
    if cmd == "simulate":
        return cmd_simulate(rest)
    if cmd == "callsv":
        return cmd_callsv(rest)
    print(f"unknown subcommand {cmd!r}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
