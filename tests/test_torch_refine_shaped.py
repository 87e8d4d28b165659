"""The shaped-band refine DP split in two (native refine_windows, then
refine_dp_windowed) and the indel-refine round's route for long
path-bearing regions (ops/refine_shaped.py), on the CPU: the split DP
against lra_tpu's native shaped DP, the exported windows against the
window rule written out here, and solve_gap_jobs sending long regions
through the wrapper's twin with the blocks of the host DP."""

import numpy as np
import pytest

from lra_tpu import native as ref_native
from lra_tpu_torch import native, preset
from lra_tpu_torch.ops import _ext
from lra_tpu_torch.ops import refine_shaped as rs
from lra_tpu_torch.pipeline import gap_align as ga
from lra_tpu_torch.pipeline.gap_align import GapJob
from lra_tpu_torch.sim import shaped_region
from lra_tpu_torch.utils import devstats

pytestmark = pytest.mark.skipif(
    not ref_native.available(),
    reason="lra_tpu's native library not built")

M, MM, IND = 4, -3, -4


def regions(seed, n, rows=(40, 400)):
    rng = np.random.default_rng(seed)
    for r in range(n):
        k = int(rng.choice([3, 7, 20]))
        q, t, path = shaped_region(
            rng, int(rng.integers(*rows)), indel=0.03, snp=0.03,
            max_indel=3, legs=int(rng.integers(0, 2)), max_leg=12,
            reverse=bool(r % 2))
        yield q, t, path, k


def windows_plain(path, qlen, tlen, k):
    """The window rule, a row at a time: own-row path extent dilated
    k + 1 in q, with the bare extents of the rows within +-k one wider,
    clipped to [0, qlen]; then qlo made non-decreasing from the end and
    qhi from the start, qlo[0] = 0 and qhi[tlen] = qlen."""
    cells = {}
    for b, (bq, bt, ln) in enumerate(path.tolist()):
        pts = [(bq + p, bt + p) for p in range(ln + 1)]
        if b + 1 < len(path):
            qn, tn = int(path[b + 1][0]), int(path[b + 1][1])
            pts += [(p, bt + ln) for p in range(bq + ln, qn + 1)]
            pts += [(qn, p) for p in range(bt + ln, tn + 1)]
        for i, j in pts:
            cells.setdefault(j, []).append(i)
    cells.setdefault(0, []).append(0)
    cells.setdefault(tlen, []).append(qlen)
    lo = np.zeros(tlen + 1, np.int64)
    hi = np.zeros(tlen + 1, np.int64)
    for j in range(tlen + 1):
        near = [i for jj in range(j - k, j + k + 1) for i in cells.get(jj, [])
                if 0 <= jj <= tlen]
        a, b = [], []
        if j in cells:
            a.append(min(cells[j]) - (k + 1))
            b.append(max(cells[j]) + (k + 1))
        if near:
            a.append(min(near) - 1)
            b.append(max(near) + 1)
        lo[j], hi[j] = (max(0, min(a)), min(qlen, max(b))) if a else (0, qlen)
    for j in range(tlen, 0, -1):
        lo[j - 1] = min(lo[j - 1], lo[j])
    for j in range(tlen):
        hi[j + 1] = max(hi[j + 1], hi[j])
    lo[0], hi[tlen] = 0, max(hi[tlen], qlen)
    return lo, hi


def test_split_dp_equals_lra_tpu():
    """50 small regions, both strands' path shapes: the port's shaped DP
    (windows, then the windowed DP) gives lra_tpu's native blocks."""
    for q, t, path, k in regions(11, 50):
        got = native.refine_dp_shaped(q, t, path, k, M, MM, IND)
        want = ref_native.refine_dp_shaped(q, t, path, k, M, MM, IND)
        assert got.tolist() == [list(b) for b in want]


def test_exported_windows_are_the_dp_windows():
    """refine_windows gives the window rule's windows, and the windowed
    DP over them is refine_dp_shaped."""
    for q, t, path, k in regions(12, 12, rows=(30, 160)):
        lo, hi = native.refine_windows(path, len(q), len(t), k)
        plo, phi = windows_plain(path, len(q), len(t), k)
        np.testing.assert_array_equal(lo, plo)
        np.testing.assert_array_equal(hi, phi)
        np.testing.assert_array_equal(
            native.refine_dp_windowed(q, t, lo, hi, M, MM, IND),
            native.refine_dp_shaped(q, t, path, k, M, MM, IND))


def test_twin_round_trip_and_cap():
    """pack / solve on the CPU (the twin) / fetch_blocks give each
    region's blocks, inside its cap: the C wrapper's qlen + tlen + 2."""
    made = list(regions(13, 6))
    packed = rs.pack([(q, t) + native.refine_windows(p, len(q), len(t), k)
                      for q, t, p, k in made])
    assert packed.caps.tolist() == [len(q) + len(t) + 2
                                    for q, t, _, _ in made]
    counts, out = rs.solve(packed, M, MM, IND, "cpu")
    assert ((counts.numpy() > 0) & (counts.numpy() <= packed.caps)).all()
    got = rs.fetch_blocks(packed, counts.numpy(), out)
    for (q, t, p, k), bl in zip(made, got):
        np.testing.assert_array_equal(
            bl, native.refine_dp_shaped(q, t, p, k, M, MM, IND))


def test_fetch_blocks_raises_on_a_region_given_up():
    """A count of -2 (the kernel's: a score past f32's exact integers)
    raises; no region's blocks are dropped or solved elsewhere."""
    made = list(regions(14, 3))
    packed = rs.pack([(q, t) + native.refine_windows(p, len(q), len(t), k)
                      for q, t, p, k in made])
    counts, out = rs.solve(packed, M, MM, IND, "cpu")
    counts = counts.numpy().copy()
    counts[1] = -2
    with pytest.raises(RuntimeError, match="region 1"):
        rs.fetch_blocks(packed, counts, out)


def refine_jobs(seed, n, rows):
    rng = np.random.default_rng(seed)
    jobs = []
    for r in range(n):
        q, t, path = shaped_region(rng, rows, indel=0.01, snp=0.01,
                                   max_indel=2, reverse=bool(r % 2))
        jobs.append(GapJob(q, t, (r,), band=20, refine=True))
        jobs[-1].path = path
    return jobs


@pytest.mark.parametrize("kind", ["ont", "contig"])
def test_round_routes_long_regions_to_the_twin(monkeypatch, kind):
    """With refine_dev_max lowered, the long path-bearing refine rows of
    a round on device="cpu" go through refine_shaped.solve (the twin: no
    launch) with the host DP's blocks; a row without a path stays on the
    host.  The round counts them, and the window rows of every long
    refine row (long_rows)."""
    opts = preset(kind)
    opts.refine_dev_max = 150
    jobs = refine_jobs(21, 5, 400)
    pathless = refine_jobs(22, 1, 400)[0]
    pathless.path = None
    want = [native.refine_dp_shaped(j.q, j.t, j.path, opts.refine_band,
                                    opts.local_match, opts.local_mismatch,
                                    opts.local_indel) for j in jobs]
    calls = []
    orig = rs.solve
    monkeypatch.setattr(rs, "solve",
                        lambda *a: calls.append(a[-1]) or orig(*a))
    monkeypatch.setattr(devstats, "ENABLED", True)
    devstats.reset()
    _ext.reset_launches()
    ga.solve_gap_jobs(jobs + [pathless], opts, True, "cpu",
                      tag="indel_refine")
    rep = devstats.report()["indel_refine"]
    devstats.reset()
    assert calls == ["cpu"] and not any(_ext.LAUNCHES.values())
    for job, w in zip(jobs, want):
        np.testing.assert_array_equal(np.asarray(job.blocks), w)
    assert pathless.blocks is not None and len(pathless.blocks)
    assert rep["shaped_jobs"] == 5
    assert rep["shaped_rows"] == sum(len(j.t) + 1 for j in jobs)
    assert rep["shaped_cells"] > 5 * 400
    assert rep["long_rows"] == rep["shaped_rows"] + len(pathless.t) + 1
    assert rep["host_rows"] == 1
    assert rep["shaped_left"] == 0
