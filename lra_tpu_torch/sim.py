"""Read and contig simulation for tests and benchmarks.

A lightweight stand-in for the reference's ``alchemy2`` model-based
simulator (reference: Alchemy2.cpp:32-63): random genomes, and reads
sampled from them with configurable SNP/indel/SV error processes and
strand.  Error positions are uniform rather than k-mer-context-conditioned;
the full empirical-model simulator is a later milestone.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import seq as sequtils


def random_genome(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 4, size=n, dtype=np.int64).astype(np.uint8)


@dataclass
class SimRead:
    codes: np.ndarray      # read 2-bit codes (as sequenced)
    chrom_pos: int         # true genome start of the aligned span
    genome_span: int       # true genome bases covered
    strand: int            # 0 fwd, 1 rev
    cigar_ops: list = field(default_factory=list)   # ground-truth edit list


def mutate(rng, codes: np.ndarray, snp=0.0, ins=0.0, dele=0.0,
           max_indel: int = 3) -> np.ndarray:
    """Apply uniform SNP/indel noise to a code array."""
    out = []
    i = 0
    n = len(codes)
    while i < n:
        r = rng.random()
        if r < dele:
            i += int(rng.integers(1, max_indel + 1))
            continue
        if r < dele + ins:
            ln = int(rng.integers(1, max_indel + 1))
            out.append(rng.integers(0, 4, size=ln, dtype=np.int64).astype(np.uint8))
        c = codes[i]
        if rng.random() < snp:
            c = np.uint8((int(c) + int(rng.integers(1, 4))) % 4)
        out.append(np.array([c], dtype=np.uint8))
        i += 1
    return np.concatenate(out) if out else np.zeros(0, np.uint8)


def sample_read(rng, genome_codes: np.ndarray, length: int,
                snp=0.0, ins=0.0, dele=0.0, rev_prob=0.5) -> SimRead:
    start = int(rng.integers(0, max(1, len(genome_codes) - length)))
    span = genome_codes[start:start + length]
    read = mutate(rng, span, snp=snp, ins=ins, dele=dele)
    strand = int(rng.random() < rev_prob)
    if strand:
        read = sequtils.revcomp(read)
    return SimRead(read, start, len(span), strand)


def draft_contig(rng, codes: np.ndarray, start: int, size: int,
                 dele: int = 5000, ins: int = 2000, snp: float = 0.001,
                 indel: float = 0.004) -> np.ndarray:
    """A draft-assembly contig of about `size` bases from codes[start:]:
    a `dele`-base DEL at size/3, `ins` random bases inserted at 2*size/3,
    then SNPs at rate `snp`, one-base deletions at rate `indel` and
    one-base insertions at rate `indel`.  At its defaults, the 2.5 Mb
    draft contig that lra_tpu holds bit-identical to lra through the
    windowed SDP (numpy seed 5): its chains break into ~5.8 k
    same-diagonal fragments per Mb."""
    seq = codes[start:start + size + dele].copy()
    dpos = size // 3
    seq = np.concatenate([seq[:dpos], seq[dpos + dele:]])
    ipos = 2 * size // 3
    insert = rng.integers(0, 4, ins).astype(np.uint8)
    seq = np.concatenate([seq[:ipos], insert, seq[ipos:]])
    snp_pos = np.nonzero(rng.random(len(seq)) < snp)[0]
    seq[snp_pos] = (seq[snp_pos] + 1 + rng.integers(0, 3, len(snp_pos))) % 4
    seq = seq[rng.random(len(seq)) >= indel]
    parts, prev = [], 0
    for p in np.nonzero(rng.random(len(seq)) < indel)[0]:
        parts.append(seq[prev:p])
        parts.append(rng.integers(0, 4, 1).astype(np.uint8))
        prev = p
    parts.append(seq[prev:])
    return np.concatenate(parts)


def contig_chain_arrays(rng, n: int, repeat_dense: bool = False) -> tuple:
    """One contig-like chaining problem, as ChainProblem's arguments
    (qS, qE, tS, tE, score, lane1, lane2, order, tbase): n fragments of
    15-60 bp at ~60 bp of q each (so the windowed SDP's density guard
    keeps W = 4096), near one diagonal with 1 % saturated t-jumps, 80 %
    on the forward lane.  With repeat_dense (n is ignored): a colinear
    chain of 400 fragments and a cloud of 1,200 weak decoys on far
    diagonals packed into one of its q-gaps, so that the windowed SDP's
    far term wins after the cloud (FAR sentinels)."""
    if repeat_dense:
        qT = np.arange(400, dtype=np.int64) * 60
        qD = qT[200] + 1 + rng.integers(0, 58, 1200)
        qS = np.sort(np.concatenate([qT, qD]))
        decoy = np.isin(qS, qD) & ~np.isin(qS, qT)
        tS = qS + 100
        tS[decoy] += 10 ** 6 + rng.integers(0, 10 ** 6, decoy.sum())
        ln = np.full(len(qS), 50)
        score = np.where(decoy, 10.0, 120.0).astype(np.float32)
        lane1 = np.ones(len(qS), bool)
    else:
        ln = rng.integers(15, 60, n)
        qS = np.sort(rng.integers(0, 60 * n, n)).astype(np.int64)
        tS = (qS + rng.integers(-1500, 1500, n)).clip(0)
        tS[rng.random(n) < 0.01] += 300000
        score = (ln * 2.0).astype(np.float32)
        lane1 = rng.random(n) < 0.8
    return (qS, qS + ln, tS, tS + ln, score, lane1, ~lane1,
            np.arange(len(qS), dtype=np.int64), 0)


def tie_dense_chain_arrays(rng, n_roots: int, n_coll: int) -> tuple:
    """A chaining problem made of exact ties, as ChainProblem's arguments:
    n_roots roots at one q (they overlap in q, so none precedes another:
    V = score = 8000 each), then n_coll collectors 60 bp apart on q, far
    from every root's diagonal (every PWL cost saturates at ceiling2)
    and unable to chain to each other.  A root is a lane-1 candidate of
    every collector when its t lies below the collectors' and a lane-2
    candidate when it lies above; roots have lane 1, lane 2 or both, in
    random order.  So every collector ties across all its candidates in
    both lanes: its predecessor is the first index, its lane is decided
    by the tie rule, and its far term ties with the near one."""
    low = rng.random(n_roots) < 0.5
    tS_root = np.where(low, rng.integers(0, 1000, n_roots),
                       10 ** 8 + rng.integers(0, 1000, n_roots))
    kind = rng.integers(0, 3, n_roots)        # lane 1, lane 2, both
    qS = np.concatenate([np.zeros(n_roots, np.int64),
                         100 + 60 * np.arange(n_coll, dtype=np.int64)])
    tS = np.concatenate([tS_root, np.full(n_coll, 5 * 10 ** 7)])
    score = np.concatenate([np.full(n_roots, 8000.0),
                            np.full(n_coll, 100.0)]).astype(np.float32)
    lane1 = np.concatenate([kind != 1, np.ones(n_coll, bool)])
    lane2 = np.concatenate([kind != 0, np.ones(n_coll, bool)])
    return (qS, qS + 50, tS, tS + 50, score, lane1, lane2,
            np.arange(len(qS), dtype=np.int64), 0)


def sdp_bucket(rng, B: int, N: int) -> tuple:
    """A [B, N] bucket of the blocked SDP's arguments (qS, qE, tS, tE
    int32; score f32; lane1, lane2, valid bool), fragments sorted by qS
    on two strands (lane 1, lane 2, both on 20 %), with the rows its
    exactness hinges on: each problem a valid prefix of random length
    whose invalid suffix keeps its lane bits (such a row can still take
    a predecessor); when B > 1, problem 1 all invalid with lane bits, and
    when B > 2, problem 2 empty (no valid row and no lane: the driver's
    padding of B)."""
    ln = rng.integers(15, 60, (B, N))
    qS = np.sort(rng.integers(0, 60 * N, (B, N)), axis=1)
    tS = (qS + rng.integers(-1500, 1500, (B, N))).clip(0)
    strand = rng.random((B, N)) < 0.7
    both = rng.random((B, N)) < 0.2
    lane1, lane2 = strand | both, ~strand | both
    valid = np.arange(N)[None, :] < rng.integers(1, N + 1, B)[:, None]
    if B > 1:
        valid[1] = False
    if B > 2:
        lane1[2] = lane2[2] = False
        valid[2] = False
    return (qS.astype(np.int32), (qS + ln).astype(np.int32),
            tS.astype(np.int32), (tS + ln).astype(np.int32),
            (ln * 2.0).astype(np.float32), lane1, lane2, valid)


def zero_slope_piece(slope, inter) -> tuple:
    """Copies of a GapParams' slope and inter (f32[24]) with piece 6, after
    sloped pieces, made a zero-slope piece of intercept 123: lra_tpu's
    pwl_jnp (and K8) take such a piece at face value, pwl_select_jnp (and
    K2's table of effective pieces) skip it."""
    slope = np.array(slope, np.float32)
    inter = np.array(inter, np.float32)
    slope[6], inter[6] = 0.0, 123.0
    return slope, inter


def negative_piece(slope, inter) -> tuple:
    """Copies of a GapParams' slope and inter (f32[24]) with piece 6 (x in
    [100, 200)) a zero-slope piece of intercept -50: a negative penalty,
    so that w = -PWL = +50 there and K8 may not prune
    (ops/sdp.py:scan_prune_np is false)."""
    slope = np.array(slope, np.float32)
    inter = np.array(inter, np.float32)
    slope[6], inter[6] = 0.0, -50.0
    return slope, inter


SCAN_KINDS = ("both_lanes", "one_lane", "invalid", "unsorted", "tie")


def scan_bucket(rng, B: int, N: int, kind: str) -> tuple:
    """A [B, N] bucket of the unblocked scan's arguments (ops/sdp.py:
    chain_scores, K8; qS, qE, tS, tE int32, score f32, lane1, lane2,
    valid bool) of one SCAN_KINDS kind: fragments sorted by qS on both
    lanes ("both_lanes") or one lane a strand ("one_lane"); "invalid":
    both lanes, 30 % of rows invalid, the last 8 rows of problem 0 and
    all of problem 1 (when B > 1) invalid, lane bits kept, so invalid
    rows still get bp and lane; "unsorted": the same in index order, not
    q order; "tie": tie-dense problems (tie_dense_chain_arrays) padded
    with invalid laneless rows.  Also "big_scores": both lanes, fragments
    whose t end lies before their t start (tE < tS, within 400 bp of
    each other: a pair can then be a predecessor on both lanes at once,
    at two different gaps) and scores near 2^25: V[j] + w1 and V[j] + w2
    round equal where w2 > w1, and the lane must come from the sums."""
    if kind == "big_scores":
        ln = rng.integers(15, 300, (B, N))
        qS = np.sort(rng.integers(0, 100 * N, (B, N)), axis=1)
        tS = rng.integers(5000, 5400, (B, N))
        return (qS.astype(np.int32), (qS + ln).astype(np.int32),
                tS.astype(np.int32), (tS - ln).astype(np.int32),
                (2.0 ** 25 + rng.integers(0, 64, (B, N))).astype(np.float32),
                np.ones((B, N), bool), np.ones((B, N), bool),
                np.ones((B, N), bool))
    if kind == "tie":
        cols = [np.zeros((B, N), np.int64) for _ in range(5)] + \
            [np.zeros((B, N), bool) for _ in range(3)]
        for b in range(B):
            roots = 3 + b % max(1, N // 8)
            arr = tie_dense_chain_arrays(rng, roots, N // 2 - roots)
            n = len(arr[0])
            for c, a in zip(cols, arr[:7]):
                c[b, :n] = a
            cols[7][b, :n] = True
        qS, qE, tS, tE, score, lane1, lane2, valid = cols
    else:
        ln = rng.integers(15, 300, (B, N))
        qS = rng.integers(0, 60 * N, (B, N))
        if kind != "unsorted":
            qS = np.sort(qS, axis=1)
        qE = qS + ln
        tS = (qS + rng.integers(-1500, 1500, (B, N)) + 5000).clip(0)
        tE = tS + ln
        score = ln * 2.0
        if kind == "one_lane":
            strand = rng.random((B, N)) < 0.5
            lane1, lane2 = ~strand, strand
        else:
            lane1 = np.ones((B, N), bool)
            lane2 = np.ones((B, N), bool)
        valid = np.ones((B, N), bool)
        if kind in ("invalid", "unsorted"):
            valid = rng.random((B, N)) < 0.7
            valid[0, max(0, N - 8):] = False
            if B > 1:
                valid[1] = False
    return (qS.astype(np.int32), qE.astype(np.int32), tS.astype(np.int32),
            tE.astype(np.int32), score.astype(np.float32), lane1, lane2,
            valid)


def mesh_step_inputs(B: int, N: int = 64, Q: int = 64, K: int = 30):
    """dryrun_multichip's arguments of the mesh's combined step
    (__graft_entry__.py:6-63, numpy seeds 0 and 1): chain arrays [B, N]
    (qS, qE, tS, tE int32, score f32, lane1, lane2, valid bool; sorted
    fragments of 20-300 bp near one diagonal, both lanes, all valid) and a
    gap bucket (gq, gt int8 [B, Q] with one SNP at 10, gql, gtl = Q,
    gkb = K int32 [B])."""
    rng = np.random.default_rng(0)
    qS = np.sort(rng.integers(0, 20000, (B, N)), axis=1).astype(np.int32)
    ln = rng.integers(20, 300, (B, N)).astype(np.int32)
    tS = (qS + rng.integers(-300, 300, (B, N)) + 5000).astype(np.int32)
    chain = [qS, qS + ln, tS, tS + ln, ln.astype(np.float32),
             np.ones((B, N), bool), np.ones((B, N), bool),
             np.ones((B, N), bool)]
    rng = np.random.default_rng(1)
    gt = rng.integers(0, 4, (B, Q)).astype(np.int8)
    gq = gt.copy()
    gq[:, 10] = (gq[:, 10] + 1) % 4
    gap = [gq, gt, np.full(B, Q, np.int32), np.full(B, Q, np.int32),
           np.full(B, K, np.int32)]
    return chain, gap


def refine_problems(rng, B: int, S: int, K: int) -> tuple:
    """A [B, S] bucket of indel-refine problems for K5 (q, t int8;
    qlen, tlen, kband int32): t random, q = t with SNPs and up to two
    indels of 1-6 bases (so the affine del/ins lanes open), lengths
    drifting within the band.  The first rows are the edges: the
    bucket's pad row (qlen = tlen = kband = 0); qlen = tlen = 1 with
    kband 0; qlen 1 against tlen 1 + K with kband K; a full S x S
    problem with kband K; tlen 1; kband exactly |qlen - tlen|.  The other
    rows mostly end below S, so plane rows above tlen are never
    written."""
    t = rng.integers(0, 4, (B, S)).astype(np.int8)
    q = t.copy()
    for b in range(B):
        for _ in range(int(rng.integers(0, max(2, S // 24)))):
            p = int(rng.integers(0, S))
            q[b, p] = (q[b, p] + 1) % 4
        for _ in range(int(rng.integers(0, 3))):
            p = int(rng.integers(0, S))
            q[b, p:] = np.roll(q[b, p:], int(rng.integers(-6, 7)))
    qlen = rng.integers(max(1, S // 2), S + 1, B)
    drift = min(K, 12)
    tlen = np.clip(qlen + rng.integers(-drift, drift + 1, B), 1, S)
    kb = np.minimum(np.abs(qlen - tlen) + rng.integers(0, K + 1, B), K)
    edges = [(0, 0, 0), (1, 1, 0), (1, min(S, 1 + K), K), (S, S, K),
             (min(S, 1 + K // 2), 1, K), (max(1, S // 2),
                                         min(S, S // 2 + min(K, 5)), 0)]
    for r, (ql, tl, k) in enumerate(edges[:B]):
        qlen[r], tlen[r], kb[r] = ql, tl, k
    kb = np.maximum(kb, np.abs(qlen - tlen))
    return (q, t, qlen.astype(np.int32), tlen.astype(np.int32),
            kb.astype(np.int32))


def shaped_region(rng, rows: int, indel: float = 0.01, snp: float = 0.01,
                  max_indel: int = 3, legs: int = 0, max_leg: int = 48,
                  reverse: bool = False) -> tuple:
    """A long indel-refine region for the shaped-band DP: (q, t, path).
    t is `rows` random codes; q is t with SNPs at rate `snp`, insertions
    and deletions of 1..max_indel bases at rate `indel` each (a 50:50
    mix), and `legs` gaps of up to `max_leg` bases (which widen the
    windows of the 2k + 1 rows around them).  path: the true alignment's
    (q, t, len) blocks, int64, from (0, 0) to (len(q), rows), as the
    indel-refine round passes a region's current path.  reverse: the
    region as a reverse-strand read gives it (both sequences and the
    path reversed)."""
    t = rng.integers(0, 4, rows).astype(np.int8)
    n_ev = int(rng.binomial(rows, 2 * indel)) + legs
    pos = np.sort(rng.choice(np.arange(1, rows), size=min(n_ev, rows - 1),
                             replace=False))
    big = np.zeros(len(pos), bool)
    big[rng.choice(len(pos), size=min(legs, len(pos)), replace=False)] = True
    q_parts, blocks = [], []
    qi = ti = 0
    for p, b in zip(pos.tolist(), big.tolist()):
        if p <= ti:
            continue
        run = p - ti
        blocks.append((qi, ti, run))
        q_parts.append(t[ti:p])
        qi += run
        ti = p
        g = int(rng.integers(1, (max_leg if b else max_indel) + 1))
        if rng.random() < 0.5:
            q_parts.append(rng.integers(0, 4, g).astype(np.int8))
            qi += g
        else:
            ti = min(rows, ti + g)
    blocks.append((qi, ti, rows - ti))
    q_parts.append(t[ti:])
    q = np.concatenate(q_parts).astype(np.int8)
    flip = rng.random(len(q)) < snp
    q[flip] = (q[flip] + rng.integers(1, 4, int(flip.sum()))) % 4
    path = np.array(blocks, np.int64)
    if reverse:
        q, t = q[::-1].copy(), t[::-1].copy()
        path = np.stack([len(q) - path[:, 0] - path[:, 2],
                         rows - path[:, 1] - path[:, 2], path[:, 2]],
                        1)[::-1].copy()
    return q, t, path


def rowsync_problems(rng, B: int, S: int, K: int) -> tuple:
    """A [B, S] bucket for P1's row walk (q, t int8; qlen, tlen, kband
    int32): refine_problems' rows, the first ones replaced by the walk's
    edges: the bucket's pad row; qlen 0 (DOWN along the i = 0 rail to
    row 0); tlen 0 (one LEFT run in row 0, up to its DONE cell); a start
    off the band on either side (|qlen - tlen| = K + 1 where S allows:
    no row written); kband 3 < K with the end on the kband edge; q = a
    few random bases, then t (the insertion's LEFT run reaches row 0)."""
    q, t, qlen, tlen, kb = refine_problems(rng, B, S, K)
    g = max(1, min(4, S // 4, K))
    edges = [(0, 0, 0), (0, min(S, K), K), (min(S, K), 0, K),
             (S, max(0, S - K - 1), K), (max(0, S - K - 1), S, K),
             (S, max(0, S - min(3, K)), min(3, K)), (S, S - g, g)]
    for r, (ql, tl, k) in enumerate(edges[:B]):
        qlen[r], tlen[r], kb[r] = ql, tl, k
    if B >= len(edges) and S > g:
        r = len(edges) - 1
        q[r] = np.concatenate([rng.integers(0, 4, g), t[r, :S - g]])
    return q, t, qlen, tlen, kb


def mask_problems(rng, B: int, N: int) -> tuple:
    """K3's inputs for B problems of N rows (V f32, bp int32, valid bool,
    each [B, N]): scores of small integers (many ties), backpointers to
    an earlier row or -1, a valid prefix a problem.  The first rows are
    the edges: no valid row; vmax < 0; vmax = 0 (no walk); vmax at
    several rows (the first wins); one chain of all N rows (bp[i] =
    i - 1, the best row last)."""
    V = rng.integers(-20, 60, (B, N)).astype(np.float32)
    bp = (np.floor(rng.random((B, N)) * np.arange(1, N + 1)) - 1
          ).astype(np.int32)
    valid = np.arange(N)[None, :] < rng.integers(1, N + 1, B)[:, None]
    if B > 0:               # no valid row
        valid[0] = False
    if B > 1:               # vmax < 0
        V[1] = -5.0
    if B > 2:               # vmax = 0 (row 0 is valid): no walk
        V[2] = np.minimum(V[2], 0.0)
        V[2, 0] = 0.0
    if B > 3:               # vmax at several rows
        valid[3] = True
        V[3, rng.choice(N, min(N, 5), replace=False)] = V[3].max() + 1.0
    if B > 4:               # one chain of all N rows
        V[4] = np.arange(N)
        bp[4] = np.arange(-1, N - 1)
        valid[4] = True
    return V, bp, valid


def _repeat_codes(rng, n: int) -> np.ndarray:
    """n codes of homopolymer runs (2-8 bases) and short tandem repeats
    (units of 2-3 bases of one alphabet pair, 2-5 copies)."""
    parts, have = [], 0
    while have < n:
        if rng.random() < 0.5:
            seg = np.full(int(rng.integers(2, 9)), int(rng.integers(0, 4)))
        else:
            unit = rng.integers(0, 2, int(rng.integers(2, 4))) + \
                2 * int(rng.integers(0, 2))
            seg = np.tile(unit, int(rng.integers(2, 6)))
        parts.append(seg)
        have += len(seg)
    return np.concatenate(parts)[:n].astype(np.int8)


def one_gap_problems(rng, B: int, K: int, D: int, query_longer: bool,
                     gaps: tuple, kind: str = "random",
                     pads: int = 1) -> tuple:
    """B one-long-gap problems of a (K, D) bucket for K6
    (ops/one_gap.py) and `pads` of gap_align's pad rows (qlen 1, tlen 4,
    kband 1): a short side of D/2..D-1 bases with 5 % substitutions and
    a one-base indel, the long side its two flanks around a gap of
    max(2k+1, gaps[0])..gaps[1] bases; kband k in 1..K-1.  kind "tie":
    the flanks and the gap are homopolymer runs and short tandem repeats
    (_repeat_codes), so that many arrows and both gap maxima tie.
    Returns the lists (qs, ts, kbands)."""
    qs, ts, kbs = [], [], []
    codes = (lambda n: rng.integers(0, 4, n).astype(np.int8)) \
        if kind == "random" else (lambda n: _repeat_codes(rng, n))
    for _ in range(B):
        mn = int(rng.integers(max(1, D // 2), D))
        k = int(min(rng.integers(1, K), mn))
        lo = max(2 * k + 1, gaps[0])
        gap = int(rng.integers(lo, max(lo + 1, gaps[1])))
        flank = codes(mn)
        longer = np.concatenate([flank[:mn // 2], codes(gap),
                                 flank[mn // 2:]])
        short = flank.copy()
        mut = rng.random(mn) < 0.05
        short[mut] = rng.integers(0, 4, int(mut.sum()))
        p = int(rng.integers(0, mn))
        short = np.delete(short, p) if rng.random() < 0.5 and mn > 2 \
            else np.insert(short, p, short[p])
        short = short[:D - 1]
        q, t = (longer, short) if query_longer else (short, longer)
        qs.append(q)
        ts.append(t)
        kbs.append(min(k, len(short)))
    for _ in range(pads):
        qs.append(np.zeros(1, np.int8))
        ts.append(np.zeros(4, np.int8))
        kbs.append(1)
    return qs, ts, kbs
