"""On the card: each hand-written CUDA kernel == its plain torch twin,
exactly (bit for bit for f32).  Imports neither jax nor lra_tpu, so it
runs on a machine with only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py -m cuda

Without a CUDA device every test skips."""

import numpy as np
import pytest
import torch

from lra_tpu_torch import preset
from lra_tpu_torch.ops import affine_kernel as ak
from lra_tpu_torch.ops import affine_pallas as ap
from lra_tpu_torch.ops import sdp_blocked as sb
from lra_tpu_torch.ops.gapcost import from_options

torch.set_num_threads(2)
M, MM, IND = 4, -3, -4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def frag_batch(rng, B, N, dev):
    ln = rng.integers(15, 60, (B, N))
    qS = np.sort(rng.integers(0, 60 * N, (B, N)), axis=1)
    tS = (qS + rng.integers(-1500, 1500, (B, N))).clip(0)
    strand = rng.random((B, N)) < 0.7
    both = rng.random((B, N)) < 0.2
    nvalid = rng.integers(1, N + 1, B)
    valid = np.arange(N)[None, :] < nvalid[:, None]
    arrs = [qS.astype(np.int32), (qS + ln).astype(np.int32),
            tS.astype(np.int32), (tS + ln).astype(np.int32),
            (ln * 2.0).astype(np.float32), strand | both, ~strand | both,
            valid]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs]


def gap_batch(rng, B, S, K, dev):
    t = rng.integers(0, 4, (B, S)).astype(np.int8)
    q = t.copy()
    for b in range(B):
        for _ in range(int(rng.integers(0, 6))):
            p = int(rng.integers(0, S))
            q[b, p] = (q[b, p] + 1) % 4
        if rng.random() < 0.5:
            p = int(rng.integers(1, S - 1))
            q[b, p:] = np.roll(q[b, p:], 1)
    qlen = rng.integers(S // 2, S + 1, B).astype(np.int32)
    tlen = np.clip(qlen + rng.integers(-6, 6, B), 8, S).astype(np.int32)
    kb = np.minimum(np.maximum(np.abs(qlen - tlen)
                               + rng.integers(0, 8, B), 1), K)
    return [torch.from_numpy(a).to(dev)
            for a in (q, t, qlen, tlen, kb.astype(np.int32))]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(8, 64), (4, 512)])
def test_chain_scores_blocked_kernel_matches_plain(cuda_device, B, N):
    key = from_options(preset("ccs")).static_key()
    args = frag_batch(np.random.default_rng(N), B, N, cuda_device)
    got = sb.chain_scores_blocked(*args, key)
    ref = sb.chain_scores_blocked_plain(*args, key)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), ref[0].view(torch.int32))
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,B,S,K", [
    ("global", 8, 64, 30), ("global", 4, 256, 128), ("global", 2, 512, 512),
    ("refine", 8, 64, 30), ("refine", 4, 256, 64),
    ("rowsync", 16, 64, 30), ("rowsync", 8, 512, 30)])
def test_banded_kernels_match_plain(cuda_device, kernel, B, S, K):
    q, t, ql, tl, kb = gap_batch(np.random.default_rng(S + K), B, S, K,
                                 cuda_device)
    fn, plain = {
        "global": (ak.banded_global_traced_packed,
                   ak.banded_global_traced_packed_plain),
        "refine": (ak.banded_refine_traced_packed,
                   ak.banded_refine_traced_packed_plain),
        "rowsync": (ap.banded_pallas_rowsync,
                    ap.banded_pallas_rowsync_plain)}[kernel]
    got = fn(q, t, ql, tl, K, M, MM, IND, kband=kb)
    ref = plain(q, t, ql, tl, K, M, MM, IND, kb)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
