"""High-accuracy (CCS/CONTIG) batch alignment pipeline.

Orchestrates the stages of the reference's ``MapRead_highacc``
(reference: Map_highacc.h:37-798) over a *batch* of reads so the numeric
cores run as batched device kernels:

  host:   minimizers -> anchors -> fine clusters -> split clusters
  device: SDP-1 (chaining over split clusters), batched across reads
  host:   primary chains, switch to coarse clusters, t-rebasing,
          linear extension, same-diagonal merging
  device: SDP-2 (chaining over merged anchors), batched across chains
  host:   chain cleaning, strand segmentation
  device: banded gap alignment, batched across all gaps
  host:   block assembly, CIGAR/stats, MAPQ, SAM records

Refinement tier: when a genome local index is supplied and the read is
sparse (or the preset is not HighlyAccurate), clusters are reseeded from
the two-tier local index (pipeline/refine.py); gaps between chain
clusters and the read ends are reseeded via RefineBtwnSpace semantics
(batched: all boxes of the batch align in one device round, with
speculative reverse-strand boxes for inversion capture); strand-
discordant boundaries get two-block INV reseeds that grow inversion
segments to their breakpoints.  Captured reverse clusters insert into
the chain and emit typed supplementary segments via SPLITChain; big
inter-anchor gaps (>=300bp both sides) are reseeded and chained with
the forward-only 3rd SDP (pipeline/big_gap.py), with in-gap inversions
breaking the alignment into a supplementary segment.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import seq as sequtils
from ..align.extend import (linear_extend_cluster, merge_same_diag,
                            trim_overlapped_anchors)
from ..align.mapq import set_mapq
from ..align.segment import SegGroup, Segment, order_groups
from ..anchors import find_matches_batch
from ..chain.cleaners import (AnchorChain, remove_paired_indels,
                              remove_small_paired_indels,
                              remove_spurious_anchors)
from ..chain.driver import (ChainProblem, best_chain, chain_vmax,
                            decide_primary_chains,
                            make_sdp1_problem, solve_problems, switchindex)
from ..cluster.fine import matches_to_fine_clusters
from ..cluster.split import decide_split_values, split_clusters
from ..cluster.types import Cluster
from ..index.global_index import GlobalIndex
from ..io.genome import Genome
from ..ops.gapcost import from_options
from ..options import Options
from .gap_align import (GapJob, diag_gap_guard, solve_gap_jobs,
                        trivial_diag_gap)
from .refine import refine_btwn_clusters_chain, refine_clusters


@dataclass
class ReadState:
    name: str
    codes: np.ndarray
    qual: bytes | None = None
    rc: np.ndarray | None = None
    clusters: list = field(default_factory=list)
    split: list = field(default_factory=list)
    sdp1: object = None
    chains: list = field(default_factory=list)
    ext: list = field(default_factory=list)        # per chain: ext clusters
    sdp2: list = field(default_factory=list)       # per chain: ChainProblem
    groups: list = field(default_factory=list)
    unaligned: bool = False


@dataclass
class ExtCluster:
    qpos: np.ndarray
    tpos: np.ndarray          # chrom-local
    lengths: np.ndarray
    overlap: np.ndarray
    strand: int
    chrom: int
    g_start: np.ndarray = None   # merged-group slices
    g_end: np.ndarray = None


@dataclass
class SplitChainH:
    """One typed split of a high-acc chain (reference: SPLITChain,
    Mapping_ultility.h:266-385): indices into the chain's ExtClusters,
    boundary type ('N' none, 'T' translocation, 'D' duplication,
    'I' inversion), and the strand of the first cluster."""
    idx: list
    type: str
    strand: int


def _ext_bounds(ec: "ExtCluster"):
    if len(ec.qpos) == 0:
        return None
    qS = int(ec.qpos.min())
    qE = int((ec.qpos + ec.lengths).max())
    tS = int(ec.tpos.min())
    tE = int((ec.tpos + ec.lengths).max())
    return qS, qE, tS, tE


def _split_ext_chain(exts: list, link, opts: Options) -> list:
    """Split a chain's ExtClusters into typed SplitChainH groups
    (reference: SPLITChain, Mapping_ultility.h:266-360): break on
    t-distance > splitdist / chrom change ('T'), repetitive remap with
    >=0.6 mutual genome overlap ('D'), or strand flip ('I'); then merge
    TRA-flanked near pieces back (MergeSplitchainINS,
    Mapping_ultility.h:172-257)."""
    bounds = [_ext_bounds(e) for e in exts]
    live = [i for i in range(len(exts)) if bounds[i] is not None]
    if not live:
        return []
    groups: list = []
    onec = [live[0]]
    for pos in range(len(live) - 1):
        prev, cur = live[pos], live[pos + 1]
        pb, cb = bounds[prev], bounds[cur]
        # strand-flip parity between surviving clusters: when empty
        # ExtClusters in (prev, cur) were skipped, XOR-compose the
        # dropped intermediate edges so the 'D' (repetitive remap) test
        # reads the true parity of the prev->cur edge
        lk = False
        for e in range(prev, cur):
            if e < len(link):
                lk ^= bool(link[e])
        ps, cs = exts[prev].strand, exts[cur].strand
        # mutual genome-overlap rate (OverlaprateOnGenome)
        ovp = max(0, min(pb[3], cb[3]) - max(pb[2], cb[2]))
        rep_map = (((lk and cs == 0 and ps == 0)
                    or (not lk and cs == 1 and ps == 1))
                   and ovp / max(1, pb[3] - pb[2]) >= 0.6
                   and ovp / max(1, cb[3] - cb[2]) >= 0.6)
        if (cb[2] > pb[3] + opts.split_dist
                or cb[3] + opts.split_dist < pb[2]
                or exts[cur].chrom != exts[prev].chrom):
            groups.append(SplitChainH(onec, "T", ps))
            onec = [cur]
        elif rep_map:
            groups.append(SplitChainH(onec, "D", ps))
            onec = [cur]
        elif cs != ps:
            groups.append(SplitChainH(onec, "I", ps))
            onec = [cur]
        else:
            onec.append(cur)
    groups.append(SplitChainH(onec, "N", exts[live[-1]].strand))

    # MergeSplitchainINS: rejoin TRA-flanked pieces <=1500bp apart on the
    # genome (the in-between piece is the inserted sequence)
    if len(groups) >= 3:
        def gb(g):
            bs = [bounds[i] for i in g.idx]
            return (min(b[0] for b in bs), max(b[1] for b in bs),
                    min(b[2] for b in bs), max(b[3] for b in bs))
        # loop structure mirrors the reference (Mapping_ultility.h:175-240):
        # cur_ind redirects a merged-away slot back to its merge target so
        # `im = n` after a merge re-examines the grown chain for chained
        # merges, and a merge scan that exhausts all n terminates the
        # whole loop (im = n = len).  Delta: already-merged (keep=False)
        # slots are skipped in the scan — the reference re-reads their
        # stale data on a path its own debug assert rejects.
        keep = [True] * len(groups)
        cur_ind = list(range(len(groups)))
        im = 0
        while im <= len(groups) - 3:
            c = groups[cur_ind[im]]
            if c.type != "T":
                im += 1
                continue
            n = im + 2
            while n < len(groups):
                if not keep[n]:
                    n += 1
                    continue
                cn = groups[n]
                cbn, cbc = gb(cn), gb(c)
                tdist = abs(cbc[2] - cbn[3])
                if tdist > 1500 or c.strand != cn.strand or \
                        exts[c.idx[0]].chrom != exts[cn.idx[0]].chrom:
                    n += 1
                    continue
                c.idx.extend(cn.idx)
                c.type = cn.type
                cur_ind[n] = cur_ind[im]
                keep[n] = False
                break
            im = n
        groups = [g for i, g in enumerate(groups) if keep[i]]
    return groups


def _make_sdp2_problem(ext_clusters: list, bonus: float, indices=None):
    """One SDP-2 problem over the merged groups of the given clusters
    (reference: SparseDP.h:1766-1953, 2-point per-strand insertion;
    score = group q-span * second_anchorbonus).  indices: subset of
    cluster positions to include (a split chain); backref stores the
    original cluster index."""
    qS, qE, tS, tE, sc, l1, l2 = [], [], [], [], [], [], []
    backref = []   # (cluster_idx_in_chain, group_idx)
    pick = range(len(ext_clusters)) if indices is None else indices
    for ci in pick:
        ec = ext_clusters[ci]
        if len(ec.qpos) == 0:
            continue
        s, e = ec.g_start, ec.g_end
        q_first = ec.qpos[s]
        q_last = ec.qpos[e - 1] + ec.lengths[e - 1]
        span = np.maximum(q_last - q_first, 0)
        t0 = ec.tpos[s] if ec.strand == 0 else ec.tpos[e - 1]
        qS.append(q_first)
        qE.append(q_first + span)
        tS.append(t0)
        tE.append(t0 + span)
        sc.append(span.astype(np.float32) * bonus)
        l1.append(np.full(len(s), ec.strand == 0))
        l2.append(np.full(len(s), ec.strand == 1))
        backref.extend((ci, gi) for gi in range(len(s)))
    if not qS:
        return None, []
    qS = np.concatenate(qS).astype(np.int64)
    qE = np.concatenate(qE).astype(np.int64)
    tS = np.concatenate(tS).astype(np.int64)
    tE = np.concatenate(tE).astype(np.int64)
    sc = np.concatenate(sc)
    l1 = np.concatenate(l1)
    l2 = np.concatenate(l2)
    order = np.argsort(qS, kind="stable")
    tbase = int(tS.min())
    p = ChainProblem(qS[order], qE[order], tS[order] - tbase,
                     tE[order] - tbase, sc[order], l1[order], l2[order],
                     order, tbase)
    return p, backref


def _expand_chain(chain_frag_ids, backref, ext_clusters):
    """Merged-group chain -> original-anchor chain, end-first order
    (reference: SwitchToOriginalAnchors, LocalRefineAlignment.h:188-200).

    Vectorized: the chain's (cluster, group) pairs expand to per-anchor
    gathers against the concatenated cluster arrays — each group's anchor
    slice [s, e) is emitted reversed via a repeat/cumsum index build."""
    if not chain_frag_ids:
        return AnchorChain(np.zeros(0, np.int64), np.zeros(0, np.int64),
                           np.zeros(0, np.int64), np.zeros(0, np.uint8),
                           np.zeros(0, np.int64))
    f = np.asarray(chain_frag_ids, np.int64)     # already end-first
    br = np.asarray(backref, np.int64)           # [n_groups, 2] (ci, gi)
    ci, gi = br[f, 0], br[f, 1]
    counts = np.fromiter((len(ec.qpos) for ec in ext_clusters),
                         np.int64, len(ext_clusters))
    offs = np.concatenate([[0], np.cumsum(counts)])
    s = np.fromiter((ext_clusters[c].g_start[g]
                     for c, g in zip(ci, gi)), np.int64, len(f))
    e = np.fromiter((ext_clusters[c].g_end[g]
                     for c, g in zip(ci, gi)), np.int64, len(f))
    lens = e - s
    total = int(lens.sum())
    grp_off = np.repeat(np.cumsum(lens) - lens, lens)
    pos = np.arange(total, dtype=np.int64) - grp_off
    j = np.repeat(e - 1 + offs[ci], lens) - pos  # reversed within group
    allq = np.concatenate([ec.qpos for ec in ext_clusters]) \
        if len(ext_clusters) > 1 else ext_clusters[0].qpos
    allt = np.concatenate([ec.tpos for ec in ext_clusters]) \
        if len(ext_clusters) > 1 else ext_clusters[0].tpos
    alll = np.concatenate([ec.lengths for ec in ext_clusters]) \
        if len(ext_clusters) > 1 else ext_clusters[0].lengths
    strands = np.fromiter((ec.strand for ec in ext_clusters),
                          np.int64, len(ext_clusters))
    return AnchorChain(allq[j].astype(np.int64), allt[j].astype(np.int64),
                       alll[j].astype(np.int64),
                       np.repeat(strands[ci], lens).astype(np.uint8),
                       np.repeat(ci, lens))


def map_batch(reads, genome: Genome, index: GlobalIndex, opts: Options,
              use_device: bool = True, genome_li=None, timing=None,
              dots=None, device="cuda") -> list:
    """reads: list of (name, codes, qual|None).  Returns list of ReadState
    with .groups filled (SAM emission is io/sam.py's job).

    device: where the device rounds run when use_device is set ("cuda"
    launches the hand-written kernels; "cpu" runs their plain twins);
    timing: optional utils.timing.Timing ticked per batch stage, each
    device round a stage of its own;
    dots: optional {read_name: DotDumper} stage-dump hooks
    (the reference's -d --read debug system, SURVEY.md §4)."""
    gp = from_options(opts)
    states = [ReadState(n, c, q) for (n, c, q) in reads]
    if timing:
        timing.start()

    # ---- host: anchors -> clusters -> split clusters ----
    sdp1_problems = []
    batch_matches = find_matches_batch([st.codes for st in states], index,
                                       opts)
    for st, (fwd, rev) in zip(states, batch_matches):
        dd = dots.get(st.name) if dots else None
        if dd:
            dd.dump("all-matches", np.concatenate([fwd.qpos, rev.qpos]),
                    np.concatenate([fwd.tpos, rev.tpos]),
                    np.full(len(fwd) + len(rev), index.k))
        if len(fwd) == 0 and len(rev) == 0:
            st.unaligned = True
            continue
        st.clusters = (matches_to_fine_clusters(fwd.qpos, fwd.tpos, opts,
                                                genome, index.k, 0)
                       + matches_to_fine_clusters(rev.qpos, rev.tpos, opts,
                                                  genome, index.k, 1))
        if dd:
            dd.dump_clusters("fineclusters_byunique", st.clusters)
        if not st.clusters:
            st.unaligned = True
            continue
        st.split = split_clusters(st.clusters, opts)
        decide_split_values(st.clusters, st.split, opts)
        if not st.split:
            st.unaligned = True
            continue
        rate = opts.initial_anchorbonus
        if len(st.split) / len(st.clusters) > 20:
            rate /= 2.0   # repetitive region (reference: Map_highacc.h:227)
        st.sdp1 = make_sdp1_problem(st.split, rate, gp)
        sdp1_problems.append(st.sdp1)

    if timing:
        timing.tick("anchors+clusters")
    # ---- device: SDP-1 ----
    solve_problems(sdp1_problems, gp, use_device, device)
    if timing:
        timing.tick("SDP-1 (device)")

    # ---- host: chains -> extension -> SDP-2 problems ----
    sdp2_problems = []
    box_tasks: list = []     # deferred refine boxes, whole batch
    K = index.k
    starts = genome.starts()
    for st in states:
        if st.unaligned or st.sdp1 is None:
            st.unaligned = True
            continue
        chains = decide_primary_chains(st.sdp1, st.split, opts,
                                       len(st.codes))
        if not chains:
            st.unaligned = True
            continue
        switchindex(chains, st.split, st.clusters)
        chains = [c for c in chains if c.ch]
        if not chains:
            st.unaligned = True
            continue
        st.chains = chains
        st.rc = sequtils.revcomp(st.codes)
        # chrom-local copies of the chain clusters (reference rebases t
        # before refinement/extension, Map_highacc.h:448-460)
        local_clusters: dict = {}
        for ch in chains:
            for ci in ch.ch:
                if ci in local_clusters:
                    continue
                c = st.clusters[ci]
                off = int(starts[c.chrom])
                lc = Cluster(c.qpos.copy(), c.tpos - off, c.strand, c.k,
                             c.anchorfreq, c.chrom)
                lc.set_boundaries()
                local_clusters[ci] = lc

        # sparse check (reference: Map_highacc.h:415-418)
        sparse = any(
            len(c) / max(1, c.qEnd - c.qStart) <= 0.01
            for c in local_clusters.values()
        ) and len(st.codes) <= 50000
        K, W = index.k, opts.global_w
        if genome_li is not None and (not opts.highly_accurate or sparse):
            keys = list(local_clusters)
            refined = refine_clusters([local_clusters[k] for k in keys],
                                      genome, genome_li, st.codes, st.rc,
                                      opts)
            for k_, rc_ in zip(keys, refined):
                rc_.anchorfreq = local_clusters[k_].anchorfreq
                local_clusters[k_] = rc_
            K, W = genome_li.k, genome_li.w
            for ch in chains:
                keep_i = [i for i, ci in enumerate(ch.ch)
                          if len(local_clusters[ci])]
                # link between surviving neighbors = XOR of the dropped
                # intermediate edges (an even number of strand flips
                # composes to none)
                new_link = []
                for a, b in zip(keep_i, keep_i[1:]):
                    flip = False
                    for e in range(a, min(b, len(ch.link))):
                        flip ^= bool(ch.link[e])
                    new_link.append(flip)
                ch.ch = [ch.ch[i] for i in keep_i]
                ch.link = np.array(new_link, bool)

        # phase A: enumerate the refine boxes of every chain; the small
        # boxes of the whole batch align in one device round below.
        # rev_cls is the list the enqueued tasks write inversion clusters
        # into when solve_box_tasks finishes them.
        st._refine_ctx = []
        for ch in chains:
            chain_cls = [local_clusters[ci] for ci in ch.ch]
            rev_cls: list = []
            if chain_cls:
                rev_cls = refine_btwn_clusters_chain(
                    chain_cls, genome, st.codes, st.rc, opts, K, W,
                    box_tasks=box_tasks) or []
            st._refine_ctx.append((ch, local_clusters, rev_cls, K))

    # ---- device: batched refine-box alignment ----
    from .refine import solve_box_tasks
    if timing:
        timing.tick("chains+refine-plan")
    solve_box_tasks(box_tasks, opts, use_device, device)
    if timing:
        timing.tick("refine-boxes (device)")

    # phase B: harvest done inside solve_box_tasks; extend + split + SDP-2
    for st in states:
        if st.unaligned or not getattr(st, "_refine_ctx", None):
            continue
        for (ch, local_clusters, rev_cls, K) in st._refine_ctx:

            def extend_one(local, pos=None):
                chrom = local.chrom
                chrom_codes = genome.codes[starts[chrom]:genome.ends[chrom]]
                # overlap points from neighbor clusters (q/t boundaries)
                pts = []
                if pos is not None and local.anchorfreq <= 1.1:
                    for nb in (pos - 1, pos + 1):
                        if 0 <= nb < len(ch.ch):
                            nc = local_clusters[ch.ch[nb]]
                            for qb in (nc.qStart, nc.qEnd):
                                if local.qStart < qb < local.qEnd:
                                    pts.append((qb, False))
                            for tb in (nc.tStart, nc.tEnd):
                                if local.tStart < tb < local.tEnd:
                                    pts.append((tb, True))
                q, t, ln, ovp = linear_extend_cluster(
                    local, st.codes, chrom_codes, K, pts)
                trim_overlapped_anchors(q, t, ln, local.strand)
                keep = ln > 0
                q, t, ln, ovp = q[keep], t[keep], ln[keep], ovp[keep]
                gs, ge = merge_same_diag(q, t, ln, ovp, local.strand,
                                         opts.merge_dist)
                return ExtCluster(q, t, ln, ovp, local.strand, chrom,
                                  gs, ge)

            exts = [extend_one(local_clusters[ci], pos)
                    for pos, ci in enumerate(ch.ch)]
            linkv = list(ch.link) + [False] * max(0, len(exts) - 1
                                                  - len(ch.link))
            # insert captured inversion clusters by position (chain order
            # is end-first: descending q)
            for rc_ in rev_cls:
                if len(rc_.qpos) == 0:
                    continue
                e = extend_one(rc_)
                if len(e.qpos) == 0:
                    continue
                pos = 0
                eq = int(e.qpos.min())
                while pos < len(exts) and len(exts[pos].qpos) and \
                        int(exts[pos].qpos.min()) > eq:
                    pos += 1
                exts.insert(pos, e)
                linkv.insert(min(pos, len(linkv)), False)

            # typed split chains (SPLITChain semantics), one SDP-2 each
            sgroups = _split_ext_chain(exts, linkv, opts)
            per_sg = []
            for sg in sgroups:
                p, backref = _make_sdp2_problem(
                    exts, opts.second_anchorbonus, indices=sg.idx)
                per_sg.append((p, backref, sg))
                if p is not None:
                    sdp2_problems.append(p)
            st.ext.append(exts)
            st.sdp2.append(per_sg)

    if timing:
        timing.tick("refine+extend")
    # ---- device: SDP-2 ----
    solve_problems(sdp2_problems, gp, use_device, device)
    if timing:
        timing.tick("SDP-2 (device)")

    # ---- host: final chains -> segments + gap jobs ----
    gap_jobs = []
    big_gap_tasks = []
    for si, st in enumerate(states):
        if st.unaligned:
            continue
        for hi, ch in enumerate(st.chains):
            exts = st.ext[hi]
            group = SegGroup()
            for (p, backref, sg) in st.sdp2[hi]:
                if p is None:
                    continue
                frag_chain = best_chain(p)
                if not frag_chain:
                    continue
                ac = _expand_chain(frag_chain, backref, exts)
                if opts.remove_paired_indels:
                    remove_small_paired_indels(ac)
                    remove_paired_indels(ac, opts.refine_end)
                if opts.remove_spurious_anchors:
                    remove_spurious_anchors(ac)
                if len(ac) == 0:
                    continue
                ac.second_sdp_value = chain_vmax(p)
                _assemble_segments(st, ch, ac, exts, genome, opts, group,
                                   gap_jobs, si, len(st.groups), gp,
                                   big_gap_tasks)
            if group.segments:
                st.groups.append(group)

    if timing:
        timing.tick("chain+assemble")
    # ---- device: 3rd SDP over all big gaps of the batch ----
    from .big_gap import resolve_big_gaps
    resolve_big_gaps(big_gap_tasks, gap_jobs, gp, use_device, device)
    if timing:
        timing.tick("SDP-3 (device)")
    # ---- device: gap alignment + host finalize ----
    finalize_batch(states, gap_jobs, genome, opts, use_device, timing,
                   device)
    if dots:
        for st in states:
            dd = dots.get(st.name)
            if dd:
                for group in st.groups:
                    dd.dump_blocks("alignment", group.segments)
    return states


def finalize_batch(states, gap_jobs, genome, opts, use_device=True,
                   timing=None, device="cuda") -> None:
    """Shared final phase: solve gap jobs on device, splice blocks, run
    the indel-refine pass (second batched device round), compute
    CIGAR/stats, rank groups, assign MAPQ."""
    from ..align.indel_refine import (plan_end_extension,
                                      queue_indel_refine_jobs,
                                      splice_refined_blocks)

    solve_gap_jobs(gap_jobs, opts, use_device, device)
    if timing:
        timing.tick("gap-align (device)")
    by_key: dict = {}
    for job in gap_jobs:
        by_key.setdefault(job.key[:3], []).append(job)
    starts_g = genome.starts()

    # first pass: splice gap blocks, queue indel-refine regions
    ir_jobs = []
    for si, st in enumerate(states):
        if st.unaligned or not st.groups:
            st.unaligned = True
            st.groups = []
            continue
        for gi, group in enumerate(st.groups):
            for zi, seg in enumerate(group.segments):
                jobs = by_key.get((si, gi, zi), [])
                _insert_gap_blocks(seg, jobs)
                if opts.skip_banded_refine or not seg.blocks:
                    continue
                chrom_codes = genome.codes[
                    starts_g[seg.chrom]:genome.ends[seg.chrom]]
                read = st.rc if seg.strand == 1 else st.codes
                if opts.highly_accurate:
                    plan_end_extension(seg, len(read), len(chrom_codes))
                ir_jobs.extend(queue_indel_refine_jobs(
                    seg, read, chrom_codes, opts, (si, gi, zi)))

    # second device round: banded re-alignment of fragmented regions
    if timing:
        timing.tick("gap-splice+plan")
    solve_gap_jobs(ir_jobs, opts, use_device, device, tag="indel_refine")
    if timing:
        timing.tick("indel-refine (device)")
    ir_by_key: dict = {}
    for job in ir_jobs:
        ir_by_key.setdefault(job.key[:3], []).append(job)

    # breakpoint refinement between adjacent segments (note the
    # reference's inverted flag: high-acc runs it when --refineBreakpoints
    # is NOT set, low-acc when it IS; Map_highacc.h:723 vs Map_lowacc.h:585)
    run_bp = opts.refine_breakpoint == opts.bypass_clustering
    from ..align.breakpoint import refine_breakpoint

    for si, st in enumerate(states):
        if st.unaligned or not st.groups:
            continue
        for gi, group in enumerate(st.groups):
            for zi, seg in enumerate(group.segments):
                splice_refined_blocks(seg, ir_by_key.get((si, gi, zi), []))
            if run_bp and len(group.segments) > 1:
                for s_i in range(1, len(group.segments)):
                    left = group.segments[s_i]
                    right = group.segments[s_i - 1]
                    lc = genome.codes[starts_g[left.chrom]:
                                      genome.ends[left.chrom]]
                    rc_ = genome.codes[starts_g[right.chrom]:
                                       genome.ends[right.chrom]]
                    lread = st.rc if left.strand == 1 else st.codes
                    rread = st.rc if right.strand == 1 else st.codes
                    refine_breakpoint(left, right, len(st.codes),
                                      lread, rread, lc, rc_)
            for seg in group.segments:
                chrom_codes = genome.codes[
                    starts_g[seg.chrom]:genome.ends[seg.chrom]]
                read = st.rc if seg.strand == 1 else st.codes
                from ..align.cigar import blocks_to_op_arrays, \
                    score_op_arrays
                codes_a, lens_a = blocks_to_op_arrays(
                    seg.blocks, read, chrom_codes, opts.show_mismatch)
                seg.stats = score_op_arrays(codes_a, lens_a,
                                            opts.show_mismatch)
                seg.value = seg.stats.value
                if opts.print_md and seg.blocks:
                    from ..align.cigar import _OP_CHARS, _OP_CHARS_M, \
                        ops_to_md
                    chars = (_OP_CHARS if opts.show_mismatch
                             else _OP_CHARS_M)
                    ops = list(zip(chars[codes_a].tolist(),
                                   lens_a.tolist()))
                    seg.md = ops_to_md(ops, read, chrom_codes,
                                       seg.blocks[0][0], seg.blocks[0][1])
            type_inversions(group.segments)
            group.finalize()
        st.groups = order_groups(st.groups)
        set_mapq(st.groups, opts)
        # AO order per group (reference: OUTPUT, Mapping_ultility.h:465)
        for group in st.groups:
            nseg = len(group.segments)
            for s_i, seg in enumerate(group.segments):
                seg.order = nseg - 1 - s_i
    if timing:
        timing.tick("score+mapq")


def type_inversions(segs: list) -> None:
    """Inversion typing: +,-,+ / -,+,- strand patterns with t-proximity
    and length gates set TP:A:I on the middle segment (reference:
    LocalRefineAlignment.h:739-765).  Gates, exactly as the reference:
    the middle and right segments need >= 500 matched bases, the left
    segment 40..15000, each segment's tStart within 10kb of its left
    neighbor's tEnd, and the left segment must not itself be typed I."""
    for js in range(2, len(segs)):
        a, b, c = segs[js - 2], segs[js - 1], segs[js]
        if (a.strand, b.strand, c.strand) not in \
                ((0, 1, 0), (1, 0, 1)):
            continue
        if b.tStart > a.tEnd + 10000 or c.tStart > b.tEnd + 10000:
            continue
        if c.stats.nm < 500 or b.stats.nm < 500 or \
                a.stats.nm < 40 or a.stats.nm > 15000:
            continue
        if a.typeofaln != 3:
            b.typeofaln = 3


def _assemble_segments(st, ch, ac: AnchorChain, exts, genome, opts,
                       group: SegGroup, gap_jobs: list, si: int, gi: int,
                       gp=None, big_gap_tasks: list | None = None):
    """Walk the cleaned anchor chain, split by strand, emit anchor blocks,
    and queue gap jobs.  Anchors arrive end-first (descending q)."""
    n = len(ac)
    read_len = len(st.codes)
    # segment boundaries at strand flips (reference: SeparateChainByStrand)
    seg_bounds = [0]
    for i in range(1, n):
        if ac.strand[i] != ac.strand[i - 1]:
            seg_bounds.append(i)
    seg_bounds.append(n)

    zi = len(group.segments)    # continue numbering across split chains
    for bi in range(len(seg_bounds) - 1):
        lo, hi_ = seg_bounds[bi], seg_bounds[bi + 1]
        strand = int(ac.strand[lo])
        chrom = exts[ac.cluster[lo]].chrom
        chrom_codes = genome.codes[genome.starts()[chrom]:genome.ends[chrom]]
        q = ac.qpos[lo:hi_]
        t = ac.tpos[lo:hi_]
        ln = ac.length[lo:hi_]
        # walk order: ascending output coordinate
        if strand == 0:
            order = np.argsort(q, kind="stable")
        else:
            order = np.argsort(-q, kind="stable")
        q, t, ln = q[order], t[order], ln[order]
        seg = Segment([], strand, chrom, read_len)
        seg.num_anchors0 = ch.num_anchors
        seg.num_anchors1 = hi_ - lo
        seg.first_sdp_value = ch.value
        seg.second_sdp_value = ac.second_sdp_value
        seg.is_supplementary = bi > 0 or len(group.segments) > 0
        read = st.rc if strand == 1 else st.codes
        diag_ok = diag_gap_guard(opts)

        # vectorized pre-classification of trivial gaps (valid while no
        # overlap clip has occurred — clips change downstream ends):
        # equal-length inter-anchor gaps with <=1 mismatch emit as
        # diagonal blocks without a per-gap numpy round trip
        vq = (q.astype(np.int64) if strand == 0
              else read_len - q.astype(np.int64) - ln)
        vt = t.astype(np.int64)
        vl = ln.astype(np.int64)
        pe_q = vq + vl
        pe_t = vt + vl
        trivial_gap = np.zeros(max(0, len(q) - 1), bool)
        if diag_ok and len(q) > 1:
            r_arr = vq[1:] - pe_q[:-1]
            t_arr = vt[1:] - pe_t[:-1]
            eqg = (r_arr == t_arr) & (r_arr > 0)
            if opts.refine_by_sdp and gp is not None:
                # >=300bp gaps take the deferred big-gap branch and
                # never consult the mask; don't pay their base compares
                eqg &= r_arr < 300
            gidx = np.nonzero(eqg)[0]
            if len(gidx):
                lens = r_arr[gidx]
                tot = int(lens.sum())
                rep_base = np.cumsum(lens) - lens
                offs = np.arange(tot) - np.repeat(rep_base, lens)
                qf = np.repeat(pe_q[:-1][gidx], lens) + offs
                tf = np.repeat(pe_t[:-1][gidx], lens) + offs
                rep_ids = np.repeat(np.arange(len(gidx)), lens)
                mmc = np.bincount(rep_ids,
                                  weights=(read[qf] != chrom_codes[tf]),
                                  minlength=len(gidx))
                trivial_gap[gidx] = mmc <= 1

        # vectorized fast path: no overlap clips and no >=300bp deferred
        # gaps (the common case) — blocks and gap jobs emitted from the
        # precomputed arrays without the per-anchor python walk
        n_seg = len(q)
        if n_seg > 1:
            r_all = vq[1:] - pe_q[:-1]
            t_all = vt[1:] - pe_t[:-1]
            no_clip = bool(np.all((r_all >= 0) & (t_all >= 0)))
            big_any = (opts.refine_by_sdp and gp is not None
                       and bool(np.any(np.minimum(r_all, t_all) >= 300)))
        else:
            r_all = t_all = np.zeros(0, np.int64)
            no_clip, big_any = True, False
        if no_clip and not big_any:
            triv = trivial_gap if len(trivial_gap) else \
                np.zeros(max(0, n_seg - 1), bool)
            jobs_needed = (r_all > 0) & (t_all > 0) & ~triv
            ntriv = int(triv.sum())
            cum = np.cumsum(triv) if n_seg > 1 else np.zeros(0, np.int64)
            total = n_seg + ntriv
            arr = np.empty((total, 3), np.int64)
            apos = np.arange(n_seg)
            apos[1:] += cum
            arr[apos, 0] = vq
            arr[apos, 1] = vt
            arr[apos, 2] = vl
            if ntriv:
                tj = np.flatnonzero(triv)
                arr[apos[tj] + 1, 0] = pe_q[tj]
                arr[apos[tj] + 1, 1] = pe_t[tj]
                arr[apos[tj] + 1, 2] = r_all[tj]
            seg.blocks = list(map(tuple, arr.tolist()))
            for j in np.flatnonzero(jobs_needed):
                gap_jobs.append(GapJob(
                    read[pe_q[j]:vq[j + 1]],
                    chrom_codes[pe_t[j]:vt[j + 1]],
                    (si, gi, zi, int(pe_q[j]), int(pe_t[j])),
                    checked=True))
            group.segments.append(seg)
            zi += 1
            continue

        bq_l = vq.tolist()
        bt_l = vt.tolist()
        bl_l = vl.tolist()
        clipped = False
        prev_q_end = prev_t_end = None
        for i in range(len(q)):
            bq = bq_l[i]
            bt = bt_l[i]
            bl = bl_l[i]
            if prev_q_end is not None:
                # clip overlaps defensively (cleaners should prevent them)
                if bq < prev_q_end or bt < prev_t_end:
                    clipped = True   # precomputed gap masks now stale
                    shift = max(prev_q_end - bq, prev_t_end - bt)
                    bq += shift
                    bt += shift
                    bl -= shift
                    if bl <= 0:
                        continue
                rgap = bq - prev_q_end
                tgap = bt - prev_t_end
                deferred = False
                if (opts.refine_by_sdp and min(rgap, tgap) >= 300
                        and gp is not None):
                    # big gap: reseed now (host), defer the forward-only
                    # 3rd SDP to one batched device round
                    # (reference: LocalRefineAlignment.h:236-390)
                    from .big_gap import prepare_big_gap
                    task, inv = prepare_big_gap(
                        read, chrom_codes, opts,
                        prev_q_end, bq, prev_t_end, bt,
                        seg.blocks[-1][2], bl,
                        rc_strand=(st.codes if strand == 1 else st.rc))
                    if inv and seg.blocks:
                        # in-gap inversion: break the alignment and open
                        # a supplementary segment (reference:
                        # LocalRefineAlignment.h:292-352 breakalignment)
                        group.segments.append(seg)
                        zi += 1
                        seg = Segment([], strand, chrom, read_len)
                        seg.num_anchors0 = ch.num_anchors
                        seg.num_anchors1 = hi_ - lo
                        seg.first_sdp_value = ch.value
                        seg.second_sdp_value = ac.second_sdp_value
                        seg.is_supplementary = True
                        seg.blocks.append((bq, bt, bl))
                        prev_q_end = bq + bl
                        prev_t_end = bt + bl
                        continue
                    if task is not None and big_gap_tasks is not None:
                        task.seg = seg
                        task.key3 = (si, gi, zi)
                        task.prev_q_end = prev_q_end
                        task.prev_t_end = prev_t_end
                        task.next_q, task.next_t = bq, bt
                        task.read, task.chrom = read, chrom_codes
                        big_gap_tasks.append(task)
                        deferred = True
                if not deferred and rgap > 0 and tgap > 0:
                    # equal-length gap with <=1 mismatch: the diagonal
                    # path is provably optimal (2|indel| > |mismatch|) —
                    # emit the block inline, no device job (the bulk of
                    # SNP-separated anchor gaps).  The precomputed mask
                    # is valid until the first overlap clip.
                    if not clipped and trivial_gap[i - 1]:
                        seg.blocks.append((prev_q_end, prev_t_end, rgap))
                    elif clipped and diag_ok and trivial_diag_gap(
                            read[prev_q_end:bq],
                            chrom_codes[prev_t_end:bt]):
                        seg.blocks.append((prev_q_end, prev_t_end, rgap))
                    else:
                        gap_jobs.append(GapJob(
                            read[prev_q_end:bq],
                            chrom_codes[prev_t_end:bt],
                            (si, gi, zi, prev_q_end, prev_t_end),
                            checked=True))
            seg.blocks.append((bq, bt, bl))
            prev_q_end = bq + bl
            prev_t_end = bt + bl
        if seg.blocks:
            group.segments.append(seg)
            zi += 1


def _insert_gap_blocks(seg: Segment, jobs: list) -> None:
    """Splice solved gap blocks (relative coords) into the segment's block
    list and restore (q, t) order."""
    arr_parts = []
    for job in jobs:
        q_off, t_off = job.key[3], job.key[4]
        bl = job.blocks
        if bl is None or len(bl) == 0:
            continue
        if isinstance(bl, np.ndarray):
            # device-decode path: offset the int32[n,3] rows vectorized
            a = bl.astype(np.int64)
            a[:, 0] += q_off
            a[:, 1] += t_off
            arr_parts.append(a)
            continue
        for (bq, bt, ln) in bl:
            seg.blocks.append((q_off + bq, t_off + bt, ln))
    if arr_parts:
        own = np.asarray(seg.blocks, np.int64).reshape(-1, 3) \
            if seg.blocks else np.zeros((0, 3), np.int64)
        a = np.concatenate([own] + arr_parts)
    elif len(seg.blocks) > 1:
        a = np.asarray(seg.blocks, np.int64)
    else:
        return
    if len(a) <= 1:
        seg.blocks = list(map(tuple, a.tolist()))
        return
    # vectorized fast path: already sorted + q/t-monotone (the common
    # case) needs no work; one lexsort otherwise, and the defensive
    # drop-out-of-order scan only runs when a violation survives the sort
    q, t, ln = a[:, 0], a[:, 1], a[:, 2]
    if bool(np.all((q[1:] >= q[:-1] + ln[:-1])
                   & (t[1:] >= t[:-1] + ln[:-1]))):
        if arr_parts:
            seg.blocks = list(map(tuple, a.tolist()))
        return
    a = a[np.lexsort((t, q))]
    q, t, ln = a[:, 0], a[:, 1], a[:, 2]
    if bool(np.all((q[1:] >= q[:-1] + ln[:-1])
                   & (t[1:] >= t[:-1] + ln[:-1]))):
        seg.blocks = list(map(tuple, a.tolist()))
        return
    out = []
    pq = pt = -1
    for (bq, bt, bl) in a.tolist():
        if bq >= pq and bt >= pt:
            out.append((bq, bt, bl))
            pq, pt = bq + bl, bt + bl
    seg.blocks = out
