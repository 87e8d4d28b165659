"""Multi-process sharded alignment with lra_tpu_torch: two --nproc
processes + merge reproduce the single-process SAM byte for byte (but
@PG), with and without a torch.distributed (gloo) coordinator; the
merge's and init_process's checks and edge cases as lra_tpu's
(tests/test_multihost.py, tests/test_degenerate_r2.py).  Host path
(--cpu)."""

import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from lra_tpu_torch import seq as sequtils
from lra_tpu_torch.parallel.dist import init_process, merge_shards
from lra_tpu_torch.sim import random_genome, sample_read

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=REPO)


def _strip_pg(text: str) -> list:
    """Drop @PG (embeds the command line, which differs per process)."""
    return [ln for ln in text.splitlines()
            if ln.strip() and not ln.startswith("@PG")]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh")
    rng = np.random.default_rng(13)
    g = random_genome(rng, 100000)
    (d / "ref.fa").write_text(">chr1\n" + sequtils.decode(g) + "\n")
    with open(d / "reads.fa", "w") as f:
        for i in range(9):
            r = sample_read(rng, g, 3000, snp=0.003)
            f.write(f">r{i}\n" + sequtils.decode(r.codes) + "\n")
    return d


def _run(d, extra, out):
    cmd = [sys.executable, "-m", "lra_tpu_torch.cli", "align", "-CCS",
           "ref.fa", "reads.fa", "--cpu", "--batch", "4", "-o", out] + extra
    return subprocess.Popen(cmd, cwd=d, env=ENV,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)


def _wait(p):
    _, err = p.communicate(timeout=600)
    assert p.returncode == 0, err[-600:]


@pytest.fixture(scope="module")
def single(world):
    """The single-process SAM, but @PG."""
    _wait(_run(world, [], "single.sam"))
    return _strip_pg((world / "single.sam").read_text())


def test_two_process_shards_merge_to_single(world, single):
    d = world
    # two concurrent processes, each owning every other read
    p0 = _run(d, ["--nproc", "2", "--procid", "0"], "multi.sam")
    p1 = _run(d, ["--nproc", "2", "--procid", "1"], "multi.sam")
    _wait(p0)
    _wait(p1)
    merge = subprocess.run(
        [sys.executable, "-m", "lra_tpu_torch.cli", "merge",
         "multi.sam.shard0", "multi.sam.shard1", "-o", "merged.sam"],
        cwd=d, env=ENV, capture_output=True, text=True, timeout=120)
    assert merge.returncode == 0, merge.stderr[-300:]
    assert "merged 9 reads from 2 shards" in merge.stderr
    assert _strip_pg((d / "merged.sam").read_text()) == single


def test_merge_rejects_out_of_order_shards(tmp_path):
    """Shards passed out of procid order violate the round-robin count
    invariant and must fail loudly, not silently mis-interleave."""
    s0 = tmp_path / "x.shard0"
    s1 = tmp_path / "x.shard1"
    s0.write_text("@HD\tVN:1.6\nr0\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*\n"
                  "r2\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*\n")
    s1.write_text("@HD\tVN:1.6\nr1\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*\n")
    out = io.StringIO()
    assert merge_shards([str(s0), str(s1)], out) == 3  # correct order ok
    out = io.StringIO()
    with pytest.raises(ValueError, match="round-robin"):
        merge_shards([str(s1), str(s0)], out)


def test_nproc_requires_output_file():
    with pytest.raises(ValueError, match="-o FILE"):
        init_process(2, 0, "-")


def test_duplicate_qname_rejected(world):
    """Two same-named reads adjacent in a shard would fuse into one merge
    group; the aligner rejects them up front."""
    d = world
    text = (d / "reads.fa").read_text()
    # reads r0..r8, then another 'r7' at index 9 -> shard 1 (odd indices)
    # sees r7 then r7
    seq = text.splitlines()[1]
    (d / "dup.fa").write_text(text + ">r7\n" + seq + "\n")
    p = subprocess.run(
        [sys.executable, "-m", "lra_tpu_torch.cli", "align", "-CCS",
         "ref.fa", "dup.fa", "--cpu", "--batch", "4", "-o", "dup.sam",
         "--nproc", "2", "--procid", "1"],
        cwd=d, env=ENV, capture_output=True, text=True, timeout=600)
    assert p.returncode != 0
    assert "duplicate read name" in (p.stderr + p.stdout)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_group(world, single):
    """The same run with a coordinator: both processes join one gloo
    process group (torch.distributed) and still write the stride
    shards, which merge to the single-process SAM."""
    d = world
    addr = f"127.0.0.1:{_free_port()}"
    p0 = _run(d, ["--nproc", "2", "--procid", "0", "--distributed", addr],
              "dist.sam")
    p1 = _run(d, ["--nproc", "2", "--procid", "1", "--distributed", addr],
              "dist.sam")
    _wait(p0)
    _wait(p1)
    out = io.StringIO()
    n = merge_shards([str(d / "dist.sam.shard0"),
                      str(d / "dist.sam.shard1")], out)
    assert n == 9
    assert _strip_pg(out.getvalue()) == single


def test_merge_single_shard(tmp_path):
    sam = "@HD\tVN:1.6\nr0\t0\tchr1\t1\t60\t4=\t*\t0\t0\tACGT\t*\n"
    (tmp_path / "s0").write_text(sam)
    buf = io.StringIO()
    n = merge_shards([str(tmp_path / "s0")], buf)
    assert n == 1
    assert buf.getvalue() == sam


def test_merge_uneven_shards(tmp_path):
    """3 reads over 2 shards interleave back to input order."""
    rec = "{}\t0\tchr1\t1\t60\t4=\t*\t0\t0\tACGT\t*\n"
    (tmp_path / "s0").write_text("@HD\tVN:1.6\n" + rec.format("r0")
                                 + rec.format("r2"))
    (tmp_path / "s1").write_text("@HD\tVN:1.6\n" + rec.format("r1"))
    buf = io.StringIO()
    n = merge_shards([str(tmp_path / "s0"), str(tmp_path / "s1")], buf)
    assert n == 3
    names = [ln.split("\t")[0] for ln in buf.getvalue().splitlines()
             if not ln.startswith("@")]
    assert names == ["r0", "r1", "r2"]


def test_init_process_validates():
    with pytest.raises(ValueError):
        init_process(2, 2, "-")
    start, stride, out = init_process(4, 1, "x.sam")
    assert (start, stride, out) == (1, 4, "x.sam.shard1")
