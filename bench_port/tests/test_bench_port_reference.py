"""The plain reference on tiny inputs with known answers."""

import numpy as np
import pytest

from bench_port.reference import dp, one_gap, sam, sdp

A, C, G, T = 0, 1, 2, 3
M, MM, IND = 4, -3, -4


def codes(s):
    return np.array(["ACGT".index(c) for c in s], np.int64)


def test_global_optimum_and_rescore():
    q = t = codes("ACGTAC")
    assert dp.optimum("global", q, t, 6, 6, 2, M, MM, IND) == 24
    assert dp.rescore("global", [dp.DIAG] * 6, q, t, 6, 6, 2, M, MM,
                      IND) == (24, True)
    # a detour through a gap pair scores less, and stays valid
    path = [dp.DIAG] * 2 + [dp.LEFT, dp.DOWN] + [dp.DIAG] * 3
    assert dp.rescore("global", path, q, t, 6, 6, 2, M, MM, IND) == (
        5 * 4 - 8, True)
    # a path that leaves the band is not valid
    path = [dp.LEFT] * 3 + [dp.DOWN] * 3 + [dp.DIAG] * 3
    assert not dp.rescore("global", path, q, t, 6, 6, 2, M, MM, IND)[1]
    # one that stops short of (0, 0) neither
    assert not dp.rescore("global", [dp.DIAG] * 5, q, t, 6, 6, 2, M, MM,
                          IND)[1]


def test_refine_takes_the_flat_lane_for_a_long_gap():
    q = codes("ACGTTG")
    t = codes("ACGCCCTTG")                     # three extra target bases
    # global: six matches and three gap bases; refine: the lane, 2 IND + 1
    assert dp.optimum("global", q, t, 6, 9, 4, M, MM, IND) == 24 - 12
    assert dp.optimum("refine", q, t, 6, 9, 4, M, MM, IND) == 24 - 7
    path = [dp.DIAG] * 3 + [dp.DOWN] * 3 + [dp.DIAG] * 3
    assert dp.rescore("refine", path, q, t, 6, 9, 4, M, MM, IND) == (17,
                                                                    True)
    assert dp.rescore("global", path, q, t, 6, 9, 4, M, MM, IND) == (12,
                                                                    True)


def test_refine_closes_column_zero():
    q, t = codes("A"), codes("CA")
    # global may start with a target gap down column 0; refine may not
    assert dp.optimum("global", q, t, 1, 2, 2, M, MM, IND) == IND + M
    assert not dp.rescore("refine", [dp.DIAG, dp.DOWN], q, t, 1, 2, 2, M,
                          MM, IND)[1]


def test_bf16_rounding():
    assert dp.bf16(np.array([1.0, 257.0, 259.0, -3000.5])).tolist() == [
        1.0, 256.0, 260.0, -3008.0]


def test_pwl_values():
    slope, inter = sdp.pwl_params(15.0, 1.5)
    x = np.array([0, 2, 19, 100, 10**7])
    pen = sdp.pwl(x, slope, inter, 2000.0, 3000.0)
    assert pen[0] == pen[1] == pen[2] == 0
    assert pen[3] == np.floor(np.float32(15.0 * 100 ** (1 / 1.5)))
    assert pen[4] == 3000.0


def test_sdp_chains_colinear_fragments():
    slope, inter = sdp.pwl_params(15.0, 1.5)
    gaps = (slope, inter, 2000.0, 3000.0)
    # 0 -> 1 on the forward lane (same diagonal); 2 overlaps 1 in q
    qS, qE = np.array([0, 100, 150]), np.array([50, 150, 160])
    tS, tE = np.array([1000, 1100, 5000]), np.array([1050, 1150, 5010])
    score = np.array([50, 50, 10], np.float32)
    one = np.ones(3, bool)
    ch = sdp.Chain(qS, qE, tS, tE, score, one, np.zeros(3, bool), gaps)
    V = ch.scores()
    assert V.tolist() == [50, 100, 10]
    assert ch.bad_rows(V, np.array([-1, 0, -1]), np.array([0, 1, 0])) == 0
    assert ch.bad_rows(V, np.array([-1, 2, -1]), np.array([0, 1, 0])) == 1
    assert ch.bad_rows(V + 1, np.array([-1, 0, -1]),
                       np.array([0, 1, 0])) == 3


def test_sam_record_checks():
    chroms = {"chr1": codes("ACGTACGTACGG")}
    read = codes("CGTTCGTAC")           # chr1 1..9 with one mismatch

    def line(pos, cigar, seq, tags):
        return "\t".join(["r", "0", "chr1", str(pos), "60", cigar, "*", "0",
                          "9", seq, "*"] + tags)

    good = ["NM:i:1", "NX:i:1", "ND:i:0", "TD:i:0", "NI:i:0", "TI:i:0",
            "AS:i:7"]
    rec = sam.parse(line(2, "3=1X5=", "CGTTCGTAC", good))
    assert sam.problems(rec, read, chroms) == []
    assert sam.placed(rec, "chr1", 0, 12, 0)
    assert not sam.placed(rec, "chr1", 0, 12, 1)
    shifted = sam.parse(line(3, "3=1X5=", "CGTTCGTAC", good))
    assert sam.problems(shifted, read, chroms)
    wrong_run = sam.parse(line(2, "4=5=", "CGTTCGTAC", good))
    assert sam.problems(wrong_run, read, chroms)
    wrong_tag = sam.parse(line(2, "3=1X5=", "CGTTCGTAC",
                               good[:-1] + ["AS:i:9"]))
    assert sam.problems(wrong_tag, read, chroms) == ["AS 9 != 7"]
    short = sam.parse(line(2, "3=1X4=", "CGTTCGTAC", good))
    assert sam.problems(short, read, chroms)


def test_run_score_gap_classes():
    assert sam.run_score([(10, "="), (2, "X"), (20, "D")]) == 10 - 2 - 20
    v = sam.run_score([(21, "I")])
    assert v == pytest.approx(-3 * np.log(1 + 5 * 4) - 1, rel=1e-6)
    assert sam.run_score([(20000, "D")]) == -1000


@pytest.mark.parametrize("longer", ["query", "target"])
def test_one_gap_joins_two_bands_with_a_free_gap(longer):
    rng = np.random.default_rng(4)
    head, tail = rng.integers(0, 4, 10), rng.integers(0, 4, 10)
    a = np.concatenate([head, rng.integers(0, 4, 40), tail])
    b = np.concatenate([head, tail])
    q, t = (a, b) if longer == "query" else (b, a)
    gap = one_gap.GAPLEFT if longer == "query" else one_gap.GAPDOWN
    # twenty matches; the 40-base gap is free here (the CIGAR scorer
    # charges it later)
    assert one_gap.optimum(q, t, M, MM, IND, 2) == 80
    path = [one_gap.DIAG] * 10 + [gap] + [one_gap.DIAG] * 10
    assert one_gap.rescore(path, 40, q, t, M, MM, IND, 2) == (80, True)
    # the gap one base short does not reach the end
    assert not one_gap.rescore(path, 39, q, t, M, MM, IND, 2)[1]
    # the gap on the other axis is not the one allowed
    other = one_gap.GAPDOWN if gap == one_gap.GAPLEFT else one_gap.GAPLEFT
    assert not one_gap.rescore([one_gap.DIAG] * 10 + [other] +
                               [one_gap.DIAG] * 10, 40, q, t, M, MM, IND,
                               2)[1]
    # a gap pair in the prefix band is valid and scores less
    detour = [one_gap.DIAG] * 4 + (
        [one_gap.LEFT, one_gap.DOWN] if gap == one_gap.GAPLEFT
        else [one_gap.DOWN, one_gap.LEFT]) + [one_gap.DIAG] * 5 + [gap] + \
        [one_gap.DIAG] * 10
    assert one_gap.rescore(detour, 40, q, t, M, MM, IND, 2) == (
        19 * M + 2 * IND, True)


def test_one_gap_path_leaving_the_band_is_not_valid():
    q, t = codes("ACGT" * 15), codes("ACGT" * 3)
    # three query gaps off row 0 run past k = 2
    path = [one_gap.LEFT] * 3 + [one_gap.DIAG] * 3 + [one_gap.GAPLEFT] + \
        [one_gap.DIAG] * 9
    assert not one_gap.rescore(path, 45, q, t, M, MM, IND, 2)[1]
    # outside the one-gap regime there is no valid path
    assert one_gap.bands(12, 10, 2) is None
    assert one_gap.optimum(codes("ACGT" * 3), codes("ACG" * 3), M, MM, IND,
                           2) is None


def test_sam_truth_of_a_record():
    rec = {"cigar": "5S90=5S", "pos": 101, "tspan": 90, "mapq": 60,
           "tags": {"AS": "90"}}
    got = sam.truth(rec, 100, 95, 100, 100)
    assert got == {"unaligned_pct": pytest.approx(10.0), "ends_off": 5,
                   "as_short_pct": pytest.approx(10.0), "mapq": 60}
