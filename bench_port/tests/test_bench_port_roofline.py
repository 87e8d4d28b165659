"""Each roofline/ file against counts made by hand on small calls."""

import math

import numpy as np
import pytest

from bench_port import peaks, registry

R = registry.rooflines()


def banded_call():
    q = np.zeros((2, 8), np.int8)
    t = np.zeros((2, 8), np.int8)
    qlen, tlen, kband = (np.array(v, np.int32) for v in
                         ([3, 0], [4, 0], [2, 0]))
    return (q, t, qlen, tlen, 5, 4, -3, -4), {"kband": kband}


@pytest.mark.parametrize("name, per_cell", [("k4_global", 10),
                                            ("k5_refine", 18),
                                            ("p1_rowsync", 10)])
def test_banded(name, per_cell):
    # the one real problem: rows 0..4 of a 5-cell band; 3 + 4 codes and
    # three int32 read, ceil((3 + 4 + 1) / 4) = 2 bytes of ops written;
    # the pad problem (qlen = tlen = 0) counts nothing
    args, kw = banded_call()
    assert R[name].bound(args, kw, None) == (25 * per_cell, 21)


def test_k2_counts_pairs_of_valid_rows():
    valid = np.array([[1, 1, 1, 0], [0, 0, 0, 0]], bool)
    args = [np.zeros((2, 4))] * 7 + [valid, None]
    assert R["k2_sdp"].bound(args, {}, None) == (3 * 40, 3 * 35)


def test_k3():
    valid = np.zeros((1, 64), bool)
    valid[0, :3] = True
    bits = np.array([[0b101, 0, 0]], np.int32)
    ops, nbytes = R["k3_mask"].bound((None, None, valid), {}, (None, bits))
    assert (ops, nbytes) == (3 * 3 + 2, 3 * 5 + 4 * 2 + 4 + 4 * 3)


def test_k6():
    K, D = 2, 4
    qh = np.zeros((2, D + K), np.int32)
    qt = np.zeros((2, D + K + 4), np.int32)
    qlen, tlen, kb = (np.array(v, np.int32) for v in ([2, 1], [10, 4],
                                                      [1, 1]))
    L = 2 * (D + K) + 8
    ops_out = np.full((2, L), -1, np.int8)
    ops_out[0, :7] = 3
    ops_out[1, :3] = 3                        # the pad row's ops: not counted
    args = (qh, qh, qt, qt, qlen, tlen, kb, K, D, 4, -3, -4, L)
    # prefix rows min(2 + 1 - 1, 10) = 2 of 5 cells, suffix rows
    # 10 - (10 - 2 - 1 - 2) = 5 of 8 cells: 50 cells at 20 + 2 * 3
    cells = 2 * 5 + 5 * 8
    nbytes = 4 * (6 + 6 + 10 + 10) + 12 + L + 8 + cells + 7
    assert R["k6_one_gap"].bound(args, {}, (ops_out, None, None)) == \
        (cells * (20 + 2 * math.ceil(math.log2(8))), nbytes)


def test_k7():
    valid = np.zeros((1, 128), bool)
    valid[0, :10] = True
    valid[0, 64:69] = True
    args = [None] * 7 + [valid]
    ops, nbytes = R["k7_windowed"].bound(args, {"W": 64}, None)
    # block 0: 10 rows, empty window, 45 in-block pairs; block 1: 5 rows
    # against the 10 of its window and 10 in-block pairs
    pairs = 45 + 5 * 10 + 10
    assert ops == pairs * 40 + 2 * 6 * 64 ** 3 * 2 + 2 * 2 * 2 * 15
    assert nbytes == 15 * 61 + 2 * 4


def test_every_roofline_names_sites_and_kernels():
    for name, mod in R.items():
        assert mod.SITES and mod.DEVICE, name


def test_peaks():
    assert peaks.roofline_s(67e12, 0) == pytest.approx(1.0)
    assert peaks.roofline_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.roofline_s(1e12, 3.35e12) == pytest.approx(1.0)
