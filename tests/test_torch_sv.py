"""SV calling and the read simulator of lra_tpu_torch (sv.py,
sim_model.py) against lra_tpu's on the same inputs: one contig SAM with
a 400 bp DEL and a 250 bp INS (tests/test_sv.py's), aligned by the port
on its host path.  VCF text, calls, merged haplotypes, learned error
models and simulated reads must be equal.  Tolerance: exact."""

import io

import numpy as np
import pytest

from lra_tpu_torch import preset
from lra_tpu_torch import seq as sequtils
from lra_tpu_torch.index.global_index import build_global_index
from lra_tpu_torch.io.genome import Genome
from lra_tpu_torch.io.sam import sam_header
from lra_tpu_torch.pipeline import align_reads
from lra_tpu_torch.sim import random_genome
from lra_tpu_torch.sim_model import ErrorModel, learn_model
from lra_tpu_torch.sv import (SVCall, calls_from_sam, merge_haplotypes,
                              sam_to_vcf)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Two haplotype contigs: hap1 with the DEL and the INS, hap2 with
    the DEL only, each aligned to its own SAM."""
    from lra_tpu.io.genome import Genome as JGenome

    d = tmp_path_factory.mktemp("sv")
    rng = np.random.default_rng(0)
    g = Genome.from_seqs([("chr1", random_genome(rng, 150000))])
    opts = preset("contig")
    idx = build_global_index(g, opts)
    pos = 30000
    ins = rng.integers(0, 4, 250).astype(np.uint8)
    head = [g.codes[pos:pos + 15000], g.codes[pos + 15400:pos + 30000]]
    tail = [g.codes[pos + 30000:pos + 45000]]
    haps = {"hap1": np.concatenate(head + [ins] + tail),
            "hap2": np.concatenate(head + tail)}
    sams = {}
    for name, contig in haps.items():
        _, lines = align_reads([(name, contig)], g, idx, opts,
                               use_device=False)
        sams[name] = d / f"{name}.sam"
        sams[name].write_text(sam_header(g) + "\n".join(lines) + "\n")
    (d / "ref.fa").write_text(">chr1\n" + sequtils.decode(g.codes) + "\n")
    return d, g, JGenome.from_seqs([("chr1", g.codes)]), sams


def test_sam_to_vcf_equals_jax(world):
    from lra_tpu.sv import sam_to_vcf as j_sam_to_vcf

    _, g, jg, sams = world
    got, want = io.StringIO(), io.StringIO()
    n = sam_to_vcf(str(sams["hap1"]), g, got, min_length=25)
    assert n == j_sam_to_vcf(str(sams["hap1"]), jg, want, min_length=25)
    assert n == 2, got.getvalue()
    assert got.getvalue() == want.getvalue()
    recs = [ln.split("\t") for ln in got.getvalue().splitlines()
            if not ln.startswith("#")]
    assert "SVLEN=-400" in [r for r in recs if "SVTYPE=DEL" in r[7]][0][7]
    assert "SVLEN=250" in [r for r in recs if "SVTYPE=INS" in r[7]][0][7]


def test_calls_and_haplotype_merge_equal_jax(world):
    from lra_tpu.sv import calls_from_sam as j_calls
    from lra_tpu.sv import merge_haplotypes as j_merge

    _, g, jg, sams = world
    h = [list(calls_from_sam(str(sams[k]), g, 25)) for k in sams]
    jh = [list(j_calls(str(sams[k]), jg, 25)) for k in sams]
    assert [[c.to_vcf() for c in x] for x in h] == \
        [[c.to_vcf() for c in x] for x in jh]
    merged = [c.to_vcf() for c in merge_haplotypes(*h)]
    assert merged == [c.to_vcf() for c in j_merge(*jh)]
    gts = sorted(ln.split("\t")[-1] for ln in merged)
    assert gts == ["0/1", "1/1"]         # the INS on hap1, the DEL on both


def test_callsv_command_equals_jax(world):
    """`callsv` on one SAM and on two haplotype SAMs: the VCF files of
    both packages byte-equal."""
    from lra_tpu.cli import main as jmain
    from lra_tpu_torch.cli import main

    d, _, _, sams = world
    for n, args in ((1, [str(sams["hap1"])]),
                    (2, [str(sams["hap1"]), str(sams["hap2"])])):
        for side, fn in (("j", jmain), ("t", main)):
            fn(["callsv", str(d / "ref.fa"), *args, "-o",
                str(d / f"{side}{n}.vcf")])
        assert (d / f"t{n}.vcf").read_text() == \
            (d / f"j{n}.vcf").read_text()


def test_merge_haplotypes():
    a = [SVCall("chr1", 1000, "A", "A" * 101, "INS", 100, "h1", 1, "+"),
         SVCall("chr1", 5000, "A" * 51, "A", "DEL", -50, "h1", 1, "+")]
    b = [SVCall("chr1", 1020, "A", "A" * 99, "INS", 98, "h2", 1, "+"),
         SVCall("chr2", 100, "A", "A" * 31, "INS", 30, "h2", 1, "+")]
    merged = merge_haplotypes(a, b)
    assert len(merged) == 3
    hom = [c for c in merged if c.gt == "1/1"]
    het = [c for c in merged if c.gt == "0/1"]
    assert len(hom) == 1 and hom[0].pos == 1000
    assert len(het) == 2


def test_error_model_simulates_as_jax(world):
    """A model learned from the contig SAM, and the uniform model with a
    log-normal length: the same seed gives the same reads in both
    packages, by count and by coverage."""
    from lra_tpu.sim_model import ErrorModel as JErrorModel
    from lra_tpu.sim_model import learn_model as j_learn

    _, g, jg, sams = world
    m, jm = learn_model(str(sams["hap1"]), g), j_learn(str(sams["hap1"]), jg)
    np.testing.assert_array_equal(m.probs, jm.probs)
    np.testing.assert_array_equal(m.lengths, jm.lengths)
    u = ErrorModel.uniform(mismatch=0.01, ins=0.005, dele=0.005)
    ju = JErrorModel.uniform(mismatch=0.01, ins=0.005, dele=0.005)
    u.log_mu = ju.log_mu = 8.0
    u.log_sigma = ju.log_sigma = 0.2
    for ours, theirs in ((m, jm), (u, ju)):
        for kw in ({"n_reads": 10}, {"coverage": 0.5}):
            got = list(ours.simulate(np.random.default_rng(7), g.codes, **kw))
            want = list(theirs.simulate(np.random.default_rng(7), g.codes,
                                        **kw))
            assert [n for n, _ in got] == [n for n, _ in want]
            for (_, a), (_, b) in zip(got, want):
                np.testing.assert_array_equal(a, b)
            assert len(got) >= 1 and max(int(c.max()) for _, c in got) <= 3


def test_model_save_load(tmp_path):
    m = ErrorModel.uniform()
    m.lengths = np.random.default_rng(0).integers(1000, 9000, 50)
    p = str(tmp_path / "m.npz")
    m.save(p)
    m2 = ErrorModel.load(p)
    assert np.allclose(m.probs, m2.probs)
    assert np.array_equal(m.lengths, m2.lengths)
    assert (m2.k, m2.log_mu, m2.log_sigma) == (m.k, m.log_mu, m.log_sigma)
