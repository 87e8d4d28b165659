"""The data-parallel mesh (parallel/mesh.py) on CPU meshes: a device list
that repeats "cpu", the port's stand-in for lra_tpu's 8 virtual host
devices (tests/conftest.py).  The sharded steps == lra_tpu's on its
8-device CPU mesh at dryrun_multichip's shapes (__graft_entry__.py:32-63),
exactly; align_reads and a q-range shard problem under the mesh == the
port's unsharded run (which tests/test_torch_e2e.py and
test_torch_sdp.py pin to lra_tpu)."""

import numpy as np
import pytest
import torch

from lra_tpu.ops.gapcost import make_gap_params as jmake_gap_params
from lra_tpu.parallel import mesh as jmesh
from lra_tpu_torch import preset
from lra_tpu_torch.chain import driver
from lra_tpu_torch.index.global_index import build_global_index
from lra_tpu_torch.io.genome import Genome
from lra_tpu_torch.ops.gapcost import make_gap_params
from lra_tpu_torch.parallel import mesh as tmesh
from lra_tpu_torch.pipeline import align_reads
from lra_tpu_torch.sim import mesh_step_inputs, random_genome, sample_read

torch.set_num_threads(2)


def test_mesh_context_resets():
    assert tmesh.active_mesh() is None
    with tmesh.use_mesh(tmesh.make_mesh(devices=["cpu"] * 4)) as m:
        assert tmesh.active_mesh() is m and m.size == 4
        assert m.axis_names == ("dp",)
    assert tmesh.active_mesh() is None


@pytest.mark.parametrize("n", [1, 3, 8])
def test_batch_multiple(n):
    assert tmesh.batch_multiple(5) == 5
    with tmesh.use_mesh(tmesh.make_mesh(devices=["cpu"] * n)):
        for b in (1, 5, 8, 24, 100):
            got = tmesh.batch_multiple(b)
            assert got % n == 0 and b <= got < b + n


def test_make_mesh_needs_cuda():
    """make_mesh() takes every CUDA device, and raises without one (no CPU
    fallback); a CUDA entry of a device list raises the same way."""
    if torch.cuda.is_available():
        assert tmesh.make_mesh().size == torch.cuda.device_count()
        return
    with pytest.raises(RuntimeError):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError):
        tmesh.make_mesh(devices=["cuda:0"] * 2)


def test_shard_batch_and_join():
    """Contiguous shards on axis 0; run_shards joins each output on its
    own batch axis, and without a mesh run_sharded is one call."""
    m = tmesh.make_mesh(devices=["cpu"] * 4)
    a = np.arange(8 * 3).reshape(8, 3)
    (shards,) = tmesh.shard_batch(m, a)
    assert [s.tolist() for s in shards] == [a[2 * k:2 * k + 2].tolist()
                                            for k in range(4)]
    with pytest.raises(ValueError):
        tmesh.shard_batch(m, np.zeros((6, 2)))

    def fn(x):
        return x + 1, torch.stack([x, -x])      # batch axes 0 and 1
    calls = []

    def counted(x):
        calls.append(x.shape[0])
        return fn(x)
    one, two = tmesh.run_shards(m, counted, (shards,), out_axes=(0, 1))
    assert calls == [2, 2, 2, 2]
    want1, want2 = fn(torch.from_numpy(a))
    assert torch.equal(one, want1) and torch.equal(two, want2)
    calls.clear()
    got = tmesh.run_sharded(counted, (a,), device="cpu", out_axes=(0, 1))
    assert calls == [8] and torch.equal(got[1], want2)


def same(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        if w.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def meshes():
    import jax

    assert len(jax.devices()) >= 8
    return (jmesh.make_mesh(8), tmesh.make_mesh(devices=["cpu"] * 8))


@pytest.mark.parametrize("step", ["chain", "banded", "combined"])
def test_sharded_steps_match_jax(meshes, step):
    jm, tm = meshes
    B, K = 16, 30
    chain, gap = mesh_step_inputs(B)
    args = (4.0, 15.0, 1.5, 2000, 3000)
    jgp, tgp = jmake_gap_params(*args), make_gap_params(*args)
    if step == "chain":
        want = jmesh.sharded_chain_scores(jm, *chain, jgp)
        got = tmesh.sharded_chain_scores(tm, *chain, tgp)
    elif step == "banded":
        gq, gt, gql, gtl, gkb = gap
        want = jmesh.sharded_banded_align(jm, gq, gt, gql, gtl, K, 4, -3,
                                          -4, gkb)
        got = tmesh.sharded_banded_align(tm, gq, gt, gql, gtl, K, 4, -3, -4,
                                         gkb)
    else:
        with jm:
            want = jmesh.combined_device_step(jm, jgp, 4, -3, -4, K)(
                *chain, *gap)
        got = tmesh.combined_device_step(tm, tgp, 4, -3, -4, K)(*chain, *gap)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) and g.device.type == "cpu"
    same(got, want)


@pytest.fixture(scope="module")
def world():
    """tests/test_multichip.py's world: a 120 kb genome, 12 CCS reads of
    5 kb (numpy seed 11)."""
    rng = np.random.default_rng(11)
    g = Genome.from_seqs([("chr1", random_genome(rng, 120000))])
    opts = preset("ccs")
    idx = build_global_index(g, opts)
    reads = [(f"r{i}", sample_read(rng, g.codes, 5000, snp=0.004, ins=0.001,
                                   dele=0.001).codes) for i in range(12)]
    _, lines = align_reads(reads, g, idx, opts, device="cpu")
    return g, opts, idx, reads, lines


@pytest.mark.parametrize("n", [3, 8])
def test_mesh_matches_single_device(world, n):
    g, opts, idx, reads, lines_single = world
    with tmesh.use_mesh(tmesh.make_mesh(devices=["cpu"] * n)):
        _, lines_mesh = align_reads(reads, g, idx, opts, device="cpu")
    assert lines_mesh == lines_single
    assert sum(1 for ln in lines_mesh if "\t4\t" not in ln) >= 10


def test_sharded_contig_under_mesh(monkeypatch):
    """dryrun_multichip's q-range shard problem scaled down (2048
    fragments over 500 kb, SHARD_N 256, halo 60 kb): the chain under a
    mesh of 3 equals the unsharded one, covers more than m/4 fragments
    and spans the shard boundaries."""
    rng = np.random.default_rng(3)
    m, span = 2048, 500_000
    dq = np.sort(rng.integers(0, span, m)).astype(np.int64)
    ln = rng.integers(20, 60, m)
    tS = dq + 9000 + rng.integers(-40, 40, m)
    monkeypatch.setattr(driver, "SHARD_N", 256)
    monkeypatch.setattr(driver, "SHARD_HALO", 60000)
    gp = make_gap_params(4.0, 15.0, 1.5, 2000, 3000)

    def solve():
        prob = driver.ChainProblem(dq, dq + ln, tS, tS + ln,
                                   ln.astype(np.float32), np.ones(m, bool),
                                   np.ones(m, bool),
                                   np.arange(m, dtype=np.int64), 0)
        driver.solve_problems([prob], gp, use_device=True, device="cpu")
        return prob

    single = solve()
    with tmesh.use_mesh(tmesh.make_mesh(devices=["cpu"] * 3)):
        sharded = solve()
    for k in ("V", "bp", "lane"):
        np.testing.assert_array_equal(getattr(sharded, k),
                                      getattr(single, k))
    chain = driver.best_chain(sharded)
    assert chain == driver.best_chain(single)
    assert len(chain) > m // 4
    assert dq[min(chain)] < span // 8 and dq[max(chain)] > span - span // 8
