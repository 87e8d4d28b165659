"""Each per-layer reader's arithmetic on a synthetic record."""

import numpy as np
import pytest

from bench_port import harness, registry


def rec(**kw):
    base = dict(window_s=10.0, bases=2_000_000, batches=5,
                latencies_ms=np.arange(1, 101, dtype=float),
                stage_totals={"anchors+clusters": 6.0,
                              "SDP-1 (device)": 1.0,
                              "gap-align (device)": 3.0,
                              "score+mapq": 10.0},
                devstats={"sdp": {"pack_s": 0.5}, "gap": {"pack_s": 1.5}},
                busy_s=0.25,
                hand_device_s={"k2_sdp": 0.02, "k5_refine": 0.03},
                hand_bound_s={"k2_sdp": 0.001, "k5_refine": 0.004})
    base.update(kw)
    return harness.Records(**base)


@pytest.mark.parametrize("name, want", [
    ("stream.overlap", 20.0 / 10.0),
    ("host.s_per_mb", 16.0 / 2.0),
    ("rounds.s_per_mb", 4.0 / 2.0),
    ("rounds.pack_s_per_mb", 2.0 / 2.0),
    ("kernels.roofline", 100 * 0.005 / 0.05),
    ("kernels.device_ms_per_mb", 50.0 / 2.0),
    ("device.idle", 100 * (1 - 0.025)),
    ("stream.batch_p90_ms", float(np.percentile(np.arange(1, 101), 90))),
])
def test_reader(name, want):
    assert registry.reader(name).read(rec()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["kernels.roofline",
                                  "kernels.device_ms_per_mb", "device.idle"])
def test_nothing_to_read_gives_none(name):
    r = rec(busy_s=0.0, hand_device_s={}, hand_bound_s={})
    assert registry.reader(name).read(r) is None


def test_union_counts_overlapping_streams_once():
    assert harness.union([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]


def test_breakdown_names_gaps_by_open_stages():
    ops = [("void k5(int)", 1.0, 2.0), ("Memcpy DtoH", 4.0, 4.5)]
    spans = [(1, "anchors", 0.0, 3.5), (2, "score+mapq", 2.5, 6.0)]
    b = harness.breakdown(ops, (0.0, 6.0), spans)
    assert b["device_ops"][0] == ["k5", 1.0]
    gaps = {round(g, 3): name for name, g in b["idle_gaps"]}
    assert set(gaps) == {1.0, 2.0, 1.5}
    assert gaps[2.0].startswith("anchors + score+mapq")   # 2.0..4.0


def test_hand_kernel_names_match_whole_words():
    assert harness.device_name_matches("void one_gap_kernel<16>(x)",
                                       ["one_gap_kernel"])
    assert not harness.device_name_matches("void one_gap_warp_kernel<16>",
                                           ["one_gap_kernel"])


@pytest.mark.parametrize("raw, short", [
    ("void (anonymous namespace)::banded_refine_kernel<2, 1>(signed char "
     "const*, int (*)[4])", "banded_refine_kernel<2, 1>"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
    ("sdp_blocked_warp_kernel", "sdp_blocked_warp_kernel"),
])
def test_short_names_of_device_operations(raw, short):
    assert harness.short_name(raw) == short
