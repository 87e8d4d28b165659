"""Low-accuracy (CLR/ONT) batch alignment pipeline.

Stages of the reference's ``MapRead_lowacc`` (reference: Map_lowacc.h:69-632)
batched over reads:

  host:   clean matches -> clusters (with matches) -> raw linear extension
  device: SDP-1b over all extended anchors (4-point insertion only at
          cluster-boundary anchors, SparseDP.h:2157-2166), batched
  host:   <=NumAln UltimateChains (DecidePrimaryChains variant 2,
          SparseDP.h:1658-1760), typed SPLITChain (N/I/T) with
          MergeSplitchainINS + RemoveSpuriousSplitChain, local-index
          reseeding per segment, re-extension
  device: SDP-2' per segment, batched
  host:   cleaners, assembly (shared with the high-accuracy path)
  device: gap alignment (shared)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import seq as sequtils
from ..align.extend import (linear_extend_cluster, merge_same_diag,
                            trim_overlapped_anchors)
from ..align.segment import SegGroup
from ..chain.cleaners import (remove_paired_indels,
                              remove_spurious_anchors)
from ..chain.driver import (ChainProblem, best_chain, chain_vmax,
                            solve_problems)
from ..cluster.fine import clean_matches_to_clusters
from ..cluster.types import Cluster
from ..anchors import find_matches_batch
from ..index.global_index import GlobalIndex
from ..io.genome import Genome
from ..ops.gapcost import from_options
from ..options import Options
from .highacc import (ReadState, _assemble_segments, _expand_chain,
                      finalize_batch)
from .gap_align import GapTable
from .refine import refine_btwn_clusters_chain, refine_clusters


@dataclass
class UChain:
    """SDP-1b result chain: anchors end-first, with typed split segments."""
    qpos: np.ndarray
    tpos: np.ndarray          # global t
    length: np.ndarray
    strand: np.ndarray
    cluster: np.ndarray       # ext-cluster index
    value: float = 0.0
    num_anchors: int = 0
    # used by DecidePrimaryChains overlap rule
    TStart: int = 0
    TEnd: int = 0


def remove_spurious_jump(uc: UChain) -> None:
    """Drop short anchors between two adjacent opposite-sign diagonal
    jumps >100bp — a zigzag artifact, not a real SV pair (reference:
    RemoveSpuriousJump, Chain.h:897-961; called at Map_lowacc.h:190)."""
    n = len(uc.qpos)
    if n < 2:
        return
    from ..chain.cleaners import _sv_entries

    remove = np.zeros(n, bool)
    sv, svpos = _sv_entries(uc.qpos.astype(np.int64),
                            uc.tpos.astype(np.int64),
                            uc.length.astype(np.int64),
                            uc.strand.astype(np.int64),
                            100, np.iinfo(np.int64).max)
    for c in range(1, len(sv)):
        if (not remove[svpos[c - 1]] and np.sign(sv[c]) != np.sign(sv[c - 1])
                and sv[c] != 0 and sv[c - 1] != 0
                and svpos[c] - svpos[c - 1] == 1):
            for i in range(svpos[c - 1], svpos[c]):
                if uc.length[i] < 50:
                    remove[i] = True
    if remove.any():
        keep = ~remove
        uc.qpos = uc.qpos[keep]
        uc.tpos = uc.tpos[keep]
        uc.length = uc.length[keep]
        uc.strand = uc.strand[keep]
        uc.cluster = uc.cluster[keep]


@dataclass
class AnchorArrays:
    """Concatenated per-anchor arrays in original (pre-sort) order, so
    chain rows map back to anchors by plain fancy indexing."""
    q: np.ndarray
    t: np.ndarray
    ln: np.ndarray
    s: np.ndarray
    cluster: np.ndarray


def _make_sdp1b_problem(ext_clusters: list, rate: float):
    """All extended anchors, strand lane + both lanes at cluster-boundary
    anchors (reference: SparseDP.h:2157-2166)."""
    qS, qE, tS, tE, sc, l1, l2, cl, sa = [], [], [], [], [], [], [], [], []
    for ci, ec in enumerate(ext_clusters):
        n = len(ec.qpos)
        if n == 0:
            continue
        ln = ec.lengths
        boundary = np.zeros(n, bool)
        boundary[0] = boundary[-1] = True
        fwd = ec.strand == 0
        qS.append(ec.qpos)
        qE.append(ec.qpos + ln)
        if fwd:
            tS.append(ec.tpos)
            tE.append(ec.tpos + ln)
            l1.append(np.ones(n, bool))
            l2.append(boundary)
        else:
            # rev anchor (q, t, len): lane-2 events s2=(q, t+len), e2=(q+len, t)
            tS.append(ec.tpos)
            tE.append(ec.tpos + ln)
            l1.append(boundary)
            l2.append(np.ones(n, bool))
        sc.append(ln.astype(np.float32) * rate)
        cl.append(np.full(n, ci, np.int64))
        sa.append(np.full(n, ec.strand, np.int64))
    if not qS:
        return None, None
    qS = np.concatenate(qS).astype(np.int64)
    qE = np.concatenate(qE).astype(np.int64)
    tS = np.concatenate(tS).astype(np.int64)
    tE = np.concatenate(tE).astype(np.int64)
    sc = np.concatenate(sc)
    l1 = np.concatenate(l1)
    l2 = np.concatenate(l2)
    cl = np.concatenate(cl)
    anchors = AnchorArrays(qS, tS, qE - qS, np.concatenate(sa), cl)
    order = np.argsort(qS, kind="stable")
    tbase = int(tS.min())
    p = ChainProblem(qS[order], qE[order], tS[order] - tbase,
                     tE[order] - tbase, sc[order], l1[order], l2[order],
                     order, tbase)
    return p, anchors


def _decide_chains_1b(p: ChainProblem, anchors: AnchorArrays,
                      opts: Options, read_len: int) -> list:
    """reference: DecidePrimaryChains for pure matches
    (SparseDP.h:1658-1760)."""
    n = len(p.qS)
    if n == 0 or p.V is None:
        return []
    used = np.zeros(n, bool)
    by_val = np.argsort(-p.V, kind="stable")
    best_v = float(p.V[by_val[0]])
    thres = opts.aln_thres * best_v
    chains: list[UChain] = []
    fv = 0
    while (len(chains) < opts.num_aln and fv < n
           and p.V[by_val[fv]] >= thres):
        d = int(by_val[fv])
        rows = []
        i = d
        aborted = used[i]
        while not aborted and i >= 0:
            rows.append(i)
            used[i] = True
            j = int(p.bp[i])
            if j >= 0 and used[j]:
                aborted = True
                break
            i = j
        if aborted:
            for x in rows:
                used[x] = False
            fv += 1
            continue
        if rows:
            rr = np.asarray(rows, np.int64)
            q_lo = int(p.qS[rr].min())
            q_hi = int(p.qE[rr].max())
            t_lo = int(p.tS[rr].min()) + p.tbase
            t_hi = int(p.tE[rr].max()) + p.tbase
            qspan = q_hi - q_lo
            if (len(rows) >= 3 and qspan > 0
                    and qspan / read_len > 0.005 and qspan >= 200):
                overlaps = True
                if chains:
                    a = chains[0]
                    ov = min(a.TEnd, t_hi) - max(a.TStart, t_lo)
                    overlaps = ov > 0.05 * max(1, a.TEnd - a.TStart)
                if not chains or overlaps:
                    # sorted rows -> original anchor ids -> plain gathers
                    ids = p.order[rr].astype(np.int64)
                    uc = UChain(
                        anchors.q[ids].copy(), anchors.t[ids].copy(),
                        anchors.ln[ids].copy(), anchors.s[ids].copy(),
                        anchors.cluster[ids].copy(),
                        float(p.V[d]), len(rows), t_lo, t_hi)
                    chains.append(uc)
            else:
                break
        fv += 1
    return chains


@dataclass
class ExtRaw:
    qpos: np.ndarray
    tpos: np.ndarray       # global t
    lengths: np.ndarray
    strand: int
    chrom: int
    anchorfreq: float


def split_chain_typed(uc: UChain, ext_clusters, genome, opts: Options):
    """Typed segment split (reference: SPLITChain, Mapping_ultility.h:385-455
    + MergeSplitchainINS + RemoveSpuriousSplitChain, Map_lowacc.h:38-67).
    Anchors are end-first.  Returns list of (rows, type_char)."""
    n = len(uc.qpos)
    q = uc.qpos.astype(np.int64)
    t = uc.tpos.astype(np.int64)
    ln = uc.length.astype(np.int64)
    s = uc.strand.astype(np.int64)
    # vectorized per-adjacent-pair break typing (prev=im, cur=im+1)
    qp, qc = q[:-1], q[1:]
    tp, tc = t[:-1], t[1:]
    lp, lc = ln[:-1], ln[1:]
    sp, sc_ = s[:-1], s[1:]
    qdist = qp - (qc + lc)
    tdist = np.abs(tp - (tc + lc))
    dist = np.minimum(np.maximum(qdist, 0), tdist)
    diag = np.where(s == 0, t - q, q + t + ln)
    is_n = ((sc_ == sp) & (dist >= 1000)
            & (np.abs(diag[1:] - diag[:-1])
               <= np.ceil(0.15 * dist).astype(np.int64)))
    is_t = ((tc > tp + lp + opts.split_dist)
            | (tc + lc + opts.split_dist < tp))
    is_i = sc_ != sp
    ty = np.where(is_n, 0, np.where(is_t, 1, np.where(is_i, 2, -1)))
    breaks = np.flatnonzero(ty >= 0)
    bounds = np.concatenate([[0], breaks + 1, [n]])
    segs = [list(range(bounds[k], bounds[k + 1]))
            for k in range(len(bounds) - 1)]
    types = ["NTI"[ty[b]] for b in breaks] + ["N"]

    # chrom check per segment (rows are contiguous slices)
    out = []
    for k, (rows, ty) in enumerate(zip(segs, types)):
        lo, hi = bounds[k], bounds[k + 1]
        tlo = int(t[lo:hi].min())
        thi = int((t[lo:hi] + ln[lo:hi]).max())
        if int(genome.chrom_of(tlo + 1)) == int(genome.chrom_of(thi)):
            out.append((rows, ty))
    # RemoveSpuriousSplitChain
    total = sum(len(r) for r, _ in out)
    filt = max(int(0.02 * total), 2)
    filt_susp = max(int(0.03 * total), 2)
    kept = []
    for i, (rows, ty) in enumerate(out):
        if len(rows) < min(filt, 2):
            continue
        if i > 0 and out[i - 1][1] == "I" and len(rows) < min(filt_susp, 4):
            continue
        kept.append((rows, ty))
    return kept


def map_batch_lowacc(reads, genome: Genome, index: GlobalIndex,
                     opts: Options, use_device: bool = True,
                     genome_li=None, dots=None, timing=None,
                     device="cuda") -> list:
    """One batch through the low-accuracy pipeline; returns ReadStates.

    device: where the device rounds run when use_device is set ("cuda"
    launches the hand-written kernels; "cpu" runs their plain twins)."""
    gp = from_options(opts)
    states = [ReadState(n, c, q) for (n, c, q) in reads]
    starts = genome.starts()
    if timing:
        timing.start()

    # ---- host: clean matches -> clusters -> raw extension ----
    sdp1_problems = []
    per_state = []
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
            per_state.append(None)
            continue
        clusters = (clean_matches_to_clusters(fwd.qpos, fwd.tpos, opts,
                                              genome, index.k, 0)
                    + clean_matches_to_clusters(rev.qpos, rev.tpos, opts,
                                                genome, index.k, 1))
        if not clusters:
            st.unaligned = True
            per_state.append(None)
            continue
        st.rc = sequtils.revcomp(st.codes)
        repetitive = any(1.0 < c.anchorfreq <= 2.0 and len(c) >= 500
                         for c in clusters)
        exts = []
        for c in clusters:
            off = int(starts[c.chrom])
            local = Cluster(c.qpos, c.tpos - off, c.strand, c.k,
                            c.anchorfreq, c.chrom)
            chrom_codes = genome.codes[starts[c.chrom]:genome.ends[c.chrom]]
            q, t, ln, ovp = linear_extend_cluster(local, st.codes,
                                                  chrom_codes, index.k)
            keep = ln > 0
            exts.append(ExtRaw(q[keep], t[keep] + off, ln[keep],
                               c.strand, c.chrom, c.anchorfreq))
        rate = 3.0 if repetitive else opts.initial_anchorbonus
        p, anchors = _make_sdp1b_problem(exts, rate)
        if p is None:
            st.unaligned = True
            per_state.append(None)
            continue
        per_state.append((p, exts, anchors))
        sdp1_problems.append(p)

    if timing:
        timing.tick("anchors+clusters+extend")
    # ---- device: SDP-1b ----
    solve_problems(sdp1_problems, gp, use_device, device)
    if timing:
        timing.tick("SDP-1b (device)")

    # ---- host: chains -> typed split -> refine -> SDP-2' problems ----
    sdp2_problems = []
    box_tasks: list = []   # deferred refine boxes, whole batch
    work = []   # (si, chain_idx, seg_clusters list)
    for si, st in enumerate(states):
        if st.unaligned or per_state[si] is None:
            continue
        p, exts, anchors = per_state[si]
        chains = _decide_chains_1b(p, anchors, opts, len(st.codes))
        if not chains:
            st.unaligned = True
            continue
        for uc in chains:
            remove_spurious_jump(uc)
        chains = [uc for uc in chains if len(uc.qpos)]
        dd = dots.get(st.name) if dots else None
        if dd:
            for uc in chains:
                dd.dump("Chains", uc.qpos, uc.tpos, uc.length)
        if not chains:
            st.unaligned = True
            continue
        for pi, uc in enumerate(chains):
            segs = split_chain_typed(uc, exts, genome, opts)
            if not segs:
                continue
            # build a cluster per typed segment (chrom-local t)
            seg_clusters = []
            for rows, ty in segs:
                rows = np.array(rows, np.int64)
                chrom = int(genome.chrom_of(int(uc.tpos[rows[0]]) + 1))
                off = int(starts[chrom])
                c = Cluster(uc.qpos[rows].copy(),
                            uc.tpos[rows] - off,
                            int(uc.strand[rows[0]]), index.k, 1.0, chrom)
                c.lengths = uc.length[rows].copy()
                c.set_boundaries()
                seg_clusters.append((c, ty))
            # local-index reseeding per segment (Refine_splitchain)
            rev_cls: list = []
            if genome_li is not None:
                if getattr(st, "_read_li", None) is None:
                    from ..index.local_index import build_local_index
                    st._read_li = [
                        build_local_index(st.codes, genome_li.k,
                                          genome_li.w, genome_li.window,
                                          opts.local_max_freq,
                                          exact=opts.exact_ref_minimizers),
                        build_local_index(st.rc, genome_li.k,
                                          genome_li.w, genome_li.window,
                                          opts.local_max_freq,
                                          exact=opts.exact_ref_minimizers)]
                cls = [c for c, _ in seg_clusters]
                # lowacc reseed: sow=500 read-boundary widening + the
                # +-50 diagonal band (reference: ChainRefine.h:426-427,
                # 510-512 Refine_splitchain; highacc keeps 100/100)
                refined = refine_clusters(cls, genome, genome_li,
                                          st.codes, st.rc, opts,
                                          read_li=st._read_li,
                                          end_margin=500, diag_margin=50,
                                          lowacc_walk=True)
                seg_clusters = [
                    (r if len(r) else c, ty)
                    for r, (c, ty) in zip(refined, seg_clusters)]
                rev_cls = refine_btwn_clusters_chain(
                    [c for c, _ in seg_clusters], genome, st.codes,
                    st.rc, opts, genome_li.k, genome_li.w,
                    box_tasks=box_tasks) or []
            work.append((si, uc, seg_clusters, rev_cls))

    if timing:
        timing.tick("split+reseed")
    # ---- device: batched refine-box alignment ----
    from .refine import solve_box_tasks
    solve_box_tasks(box_tasks, opts, use_device, device)
    if timing:
        timing.tick("refine-boxes (device)")

    # extension + SDP-2' per segment
    from .highacc import ExtCluster, _make_sdp2_problem
    jobs2 = []
    for (si, uc, seg_clusters, rev_cls) in work:
        st = states[si]
        # insert inversion clusters captured by the reverse-strand box
        # retries (filled during solve_box_tasks), typed 'I', in chain
        # order (end-first: descending qStart)
        for rc_ in rev_cls:
            if len(rc_.qpos) == 0:
                continue
            pos = 0
            while pos < len(seg_clusters) and                     seg_clusters[pos][0].qStart > rc_.qStart:
                pos += 1
            seg_clusters.insert(pos, (rc_, "I"))
        seg_exts = []
        for (c, ty) in seg_clusters:
            if c.lengths is not None:
                # already-extended variable-length anchors (no local-index
                # refinement ran): use directly
                q, t, ln = c.qpos.copy(), c.tpos.copy(), c.lengths.copy()
                order = (np.lexsort((q, q - t)) if c.strand == 0
                         else np.lexsort((q, q + t)))
                q, t, ln = q[order], t[order], ln[order]
                ovp = np.zeros(len(q), bool)
            else:
                chrom_codes = genome.codes[
                    starts[c.chrom]:genome.ends[c.chrom]]
                q, t, ln, ovp = linear_extend_cluster(c, st.codes,
                                                      chrom_codes, c.k)
            trim_overlapped_anchors(q, t, ln, c.strand)
            keep = ln > 0
            q, t, ln, ovp = q[keep], t[keep], ln[keep], ovp[keep]
            # the lowacc SDP-2' chains RAW anchors, each scored
            # len * second_anchorbonus (reference: SparseDP.h:2287,
            # Value at :2355-2401 = matchesLengths[i] * bonus) — only
            # the highacc SDP-2 (:1766) runs over MergeMatchesSameDiag
            # groups.  Group-span scoring here let a dense same-diag
            # group outscore a longer off-diag anchor it overlapped
            # (measured bit-identity residual at read-start boxes)
            gs = np.arange(len(q), dtype=np.int64)
            ge = gs + 1
            seg_exts.append((ExtCluster(q, t, ln, ovp, c.strand, c.chrom,
                                        gs, ge), ty))
        # one SDP-2 problem per segment (reference runs per merged cluster)
        probs = []
        for (ec, ty) in seg_exts:
            p2, backref = _make_sdp2_problem([ec], opts.second_anchorbonus)
            probs.append((p2, backref, ec, ty))
            if p2 is not None:
                sdp2_problems.append(p2)
        jobs2.append((si, uc, probs))

    if timing:
        timing.tick("re-extend")
    solve_problems(sdp2_problems, gp, use_device, device)
    if timing:
        timing.tick("SDP-2' (device)")

    # ---- host: assemble ----
    gaps = GapTable()
    big_gap_tasks = []
    for (si, uc, probs) in jobs2:
        st = states[si]
        group = SegGroup()
        for (p2, backref, ec, ty) in probs:
            if p2 is None:
                continue
            frag_chain = best_chain(p2)
            if not frag_chain:
                continue
            ac = _expand_chain(frag_chain, backref, [ec])
            remove_paired_indels(ac, opts.refine_end)
            remove_spurious_anchors(ac)
            if len(ac) == 0:
                continue
            ac.second_sdp_value = chain_vmax(p2)

            class _Ch:   # minimal chain info for _assemble_segments
                num_anchors = uc.num_anchors
                value = uc.value
            n_before = len(group.segments)
            _assemble_segments(st, _Ch, ac, [ec], genome, opts, group,
                               gaps, si, len(st.groups), gp,
                               big_gap_tasks)
            if ty == "I":
                for seg in group.segments[n_before:]:
                    seg.typeofaln = 3
        if group.segments:
            # first segment of the group is the representative
            for k_, seg in enumerate(group.segments):
                seg.is_supplementary = k_ > 0
            st.groups.append(group)

    if timing:
        timing.tick("chain+assemble")
    # ---- device: 3rd SDP over all big gaps of the batch ----
    from .big_gap import resolve_big_gaps
    resolve_big_gaps(big_gap_tasks, gaps, gp, use_device, device)
    if timing:
        timing.tick("SDP-3 (device)")
    finalize_batch(states, gaps, genome, opts, use_device, timing,
                   device)
    return states
