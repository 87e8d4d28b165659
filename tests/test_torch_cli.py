"""The command line of lra_tpu_torch (`python -m lra_tpu_torch.cli`):
lra_tpu's CLI tests on the port, and the port's commands against
lra_tpu's on one 60 kb world with --cpu (host-only kernels, so no JAX
kernel compiles): SAM (but @PG, which holds the command line), PAF, BED
and pairwise output, -d dot files, index arrays and simulated reads
byte-equal; `align --device cpu` equal to the port's align_reads; on
"cuda" without a CUDA device `align` raises.  Tolerance: exact."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lra_tpu_torch import seq as sequtils
from lra_tpu_torch.cli import main
from lra_tpu_torch.sim import random_genome, sample_read

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _records(path):
    return [ln.split("\t") for ln in open(path)
            if ln.strip() and not ln.startswith("@")]


def _strip_pg(path) -> list:
    return [ln for ln in open(path) if not ln.startswith("@PG")]


def _run(d, *args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "lra_tpu_torch.cli", *args],
        cwd=d, env=env, capture_output=True, text=True, timeout=600)


# ------------------------------------------ lra_tpu's CLI tests, ported ---

@pytest.fixture(scope="module")
def refdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cliworld")
    rng = np.random.default_rng(4)
    g = random_genome(rng, 60000)
    (d / "ref.fa").write_text(">c1\n" + sequtils.decode(g) + "\n")
    recs = []
    for i in range(6):
        r = sample_read(rng, g, 3000, snp=0.004, ins=0.001, dele=0.001)
        recs.append((f"rd{i}", sequtils.decode(r.codes)))
    fq = []
    for name, seq in recs:
        fq.append(f"@{name}\n{seq}\n+\n{'I' * len(seq)}")
    (d / "reads.fq").write_text("\n".join(fq) + "\n")
    main(["index", str(d / "ref.fa"), "-CCS"])
    return d, recs


def test_fastq_quals_preserved(refdir):
    d, recs = refdir
    out = d / "out.sam"
    main(["align", str(d / "ref.fa"), str(d / "reads.fq"), "-CCS",
          "--cpu", "-o", str(out)])
    rows = _records(out)
    assert len(rows) >= 6
    for f in rows:
        if f[1] in ("0", "16"):
            assert set(f[10]) == {"I"}, f[10][:20]


def test_stride_sharding_partitions(refdir):
    d, recs = refdir
    outs = []
    for start in (0, 1):
        out = d / f"shard{start}.sam"
        main(["align", str(d / "ref.fa"), str(d / "reads.fq"), "-CCS",
              "--cpu", "--stride", "2", "--start", str(start),
              "-o", str(out)])
        outs.append({f[0] for f in _records(out)})
    assert outs[0] | outs[1] == {name for name, _ in recs}
    assert not outs[0] & outs[1]


def test_sam_input_passthrough(refdir):
    d, recs = refdir
    sam_in = d / "in.sam"
    lines = ["@HD\tVN:1.6"]
    for name, seq in recs[:3]:
        lines.append(f"{name}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq}\t*\tXZ:Z:hello")
    sam_in.write_text("\n".join(lines) + "\n")
    out = d / "pt.sam"
    main(["align", str(d / "ref.fa"), str(sam_in), "-CCS", "--cpu",
          "--passthrough", "-o", str(out)])
    rows = _records(out)
    assert len(rows) >= 3
    assert any("XZ:Z:hello" in "\t".join(f) for f in rows)


def test_qti(refdir):
    d, _ = refdir
    out = _run(d, "qti", "-CCS", "ref.fa", "reads.fq", "--cpu")
    assert out.returncode == 0, out.stderr[-400:]
    assert "reads/s" in out.stderr


def test_timing_report(refdir):
    d, _ = refdir
    out = _run(d, "align", "-CCS", "ref.fa", "reads.fq", "--cpu",
               "--timing", "t.tsv", "-o", "o.sam")
    assert out.returncode == 0, out.stderr[-400:]
    report = (d / "t.tsv").read_text()
    assert "TOTAL" in report
    assert "SDP-1 (device)" in report


def test_dotplot_dump(refdir):
    d, _ = refdir
    out = _run(d, "align", "-CCS", "ref.fa", "reads.fq", "--cpu",
               "-d", "dots", "--readname", "rd1", "-o", "o2.sam")
    assert out.returncode == 0, out.stderr[-400:]
    dots = d / "dots"
    assert (dots / "all-matches.dots").exists()
    rows = (dots / "all-matches.dots").read_text().strip().splitlines()
    assert len(rows) > 5 and len(rows[0].split("\t")) >= 4


# ------------------------------------------------ the port vs lra_tpu ---

@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """One world in two directories, indexed by each package's CLI: `j`
    for lra_tpu, `t` for the port."""
    from lra_tpu.cli import main as jmain

    root = tmp_path_factory.mktemp("clipair")
    rng = np.random.default_rng(4)
    g = random_genome(rng, 60000)
    reads = []
    for i in range(6):
        r = sample_read(rng, g, 3000, snp=0.004, ins=0.001, dele=0.001)
        reads.append((f"rd{i}", r.codes))
    dirs = {}
    for side, fn in (("j", jmain), ("t", main)):
        d = root / side
        d.mkdir()
        (d / "ref.fa").write_text(">c1\n" + sequtils.decode(g) + "\n")
        with open(d / "reads.fa", "w") as f:
            for name, codes in reads:
                f.write(f">{name}\n{sequtils.decode(codes)}\n")
        fn(["index", str(d / "ref.fa"), "-CCS"])
        dirs[side] = d
    return dirs, reads


def _both(dirs, *args, out="out"):
    from lra_tpu.cli import main as jmain

    paths = {}
    for side, fn in (("j", jmain), ("t", main)):
        d = dirs[side]
        paths[side] = d / out
        fn([a.replace("{d}", str(d)) for a in args] + ["-o", str(d / out)])
    return paths


@pytest.mark.parametrize("fmt", ["s", "p", "pc", "a", "b"])
def test_align_output_equals_jax(pair, fmt):
    """SAM (modulo @PG), PAF (with and without the cigar), pairwise and
    BED output byte-equal."""
    dirs, _ = pair
    p = _both(dirs, "align", "{d}/ref.fa", "{d}/reads.fa", "-CCS", "--cpu",
              "-p", fmt, "--printMD", out=f"out.{fmt}")
    want, got = _strip_pg(p["j"]), _strip_pg(p["t"])
    assert len(want) >= 6
    assert got == want


def test_dot_files_equal_jax(pair):
    dirs, _ = pair
    _both(dirs, "align", "{d}/ref.fa", "{d}/reads.fa", "-CCS", "--cpu",
          "-d", "{d}/dots", "--readname", "rd2", out="dots.sam")
    names = sorted(os.listdir(dirs["j"] / "dots"))
    assert "all-matches.dots" in names
    assert sorted(os.listdir(dirs["t"] / "dots")) == names
    for n in names:
        assert (dirs["t"] / "dots" / n).read_bytes() == \
            (dirs["j"] / "dots" / n).read_bytes(), n


def test_index_arrays_equal_jax(pair):
    dirs, _ = pair
    for ext in (".gdx.npz", ".ldx.npz"):
        want = np.load(dirs["j"] / f"ref.fa{ext}")
        got = np.load(dirs["t"] / f"ref.fa{ext}")
        assert sorted(got.files) == sorted(want.files), ext
        for k in want.files:
            assert got[k].dtype == want[k].dtype, (ext, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_simulate_equals_jax(pair):
    """`simulate` with an error model learned from an aligned SAM: the
    same seed gives the same reads."""
    dirs, _ = pair
    _both(dirs, "align", "{d}/ref.fa", "{d}/reads.fa", "-CCS", "--cpu",
          out="model.sam")
    p = _both(dirs, "simulate", "{d}/ref.fa", "-n", "5", "--seed", "3",
              "--model", "{d}/model.sam", out="sim.fa")
    want = p["j"].read_text()
    assert want.count(">") == 5
    assert p["t"].read_text() == want


def test_align_device_cpu_equals_align_reads(pair):
    """`align --device cpu` (the device rounds on the kernels' plain
    twins) gives the port's align_reads lines for those reads."""
    from lra_tpu_torch import preset
    from lra_tpu_torch.index.global_index import GlobalIndex
    from lra_tpu_torch.io.genome import Genome
    from lra_tpu_torch.pipeline import align_reads

    dirs, reads = pair
    d = dirs["t"]
    main(["align", str(d / "ref.fa"), str(d / "reads.fa"), "-CCS",
          "--device", "cpu", "-t", "2", "--batch", "3",
          "-o", str(d / "dev.sam")])
    genome = Genome.from_fasta(str(d / "ref.fa"))
    idx = GlobalIndex.load(str(d / "ref.fa.gdx.npz"))
    _, want = align_reads(reads, genome, idx, preset("ccs"), device="cpu")
    got = [ln.rstrip("\n") for ln in open(d / "dev.sam")
           if not ln.startswith("@")]
    assert got == want


def test_align_on_cuda_without_cuda_raises(pair, monkeypatch):
    dirs, _ = pair
    d = dirs["t"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in ("align", "qti"):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([cmd, str(d / "ref.fa"), str(d / "reads.fa"), "-CCS",
                  "-o", str(d / "never.sam")])
    assert not (d / "never.sam").exists()
