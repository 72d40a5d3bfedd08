"""The port's chaining DP (both plain PyTorch versions: the window-axis
DP and the CUDA kernel's warp formulation) against the JAX scan
(``rawalign_tpu/map/chain.py``) and the native C loop
(``native.chain_dp``), on the CPU. Scores and predecessors are compared
exactly: all four do the same int32 arithmetic, the same float32
division and add, and pick the first maximum in distance order.
"""

import numpy as np
import pytest
import torch

from rawalign_tpu import native
from rawalign_tpu.map import chain as dchain
from rawalign_tpu_torch.map import chain, chain_cuda

torch.set_num_threads(1)

KW = dict(e=6, max_gap=2000, max_target_gap=5000, max_skips=25)
SENT = np.int32(0x7FFFFFFF)


@pytest.fixture(autouse=True)
def _need_native():
    if not native.chain_dp_available():
        pytest.skip("native host library not built")


def _anchors(rng, B, A):
    """Sorted anchor rows: several segments per row, so windows cross
    segment boundaries; co-linear runs, so chains form and the skip
    counter runs; wide target spreads, so target-gap breaks occur; and
    n_anchors below A, with sentinel padding past it."""
    seg = np.full((B, A), SENT, np.int32)
    tgt = np.zeros((B, A), np.int32)
    qry = np.zeros((B, A), np.int32)
    n = rng.integers(A // 2, A + 1, B).astype(np.int32)
    n[0] = A
    for b in range(B):
        m = int(n[b])
        s = rng.integers(0, 4, m)
        t = rng.integers(0, 40_000, m)
        q = rng.integers(0, 2_000, m)
        k = int(rng.integers(0, max(1, m - 60)))
        run = np.arange(min(60, m - k))
        s[k : k + run.size] = s[k]
        t[k : k + run.size] = t[k] + run * 10
        q[k : k + run.size] = q[k] + run * 9
        o = np.lexsort((q, t, s))
        seg[b, :m], tgt[b, :m], qry[b, :m] = s[o], t[o], q[o]
    return seg, tgt, qry, n


def _check(seg, tgt, qry, n, window):
    kw = dict(window=window, **KW)
    before = chain_cuda.launches
    got = chain.chain_dp_batch(*(torch.from_numpy(x) for x in (seg, tgt, qry, n)),
                               **kw)
    assert chain_cuda.launches == before  # CPU tensors: the plain version
    ns, npred = native.chain_dp(seg, tgt, qry, n, **kw)
    jdp = dchain.chain_dp_batch(seg, tgt, qry, n, **kw)
    np.testing.assert_array_equal(got.scores.numpy(), ns)
    np.testing.assert_array_equal(got.preds.numpy(), npred)
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(jdp.scores))
    np.testing.assert_array_equal(got.preds.numpy(), np.asarray(jdp.preds))
    scan = chain.chain_dp_scan_plain(
        *(torch.from_numpy(x) for x in (seg, tgt, qry, n)), **kw)
    assert torch.equal(scan.scores, got.scores)
    assert torch.equal(scan.preds, got.preds)
    return got


@pytest.mark.parametrize("window", [8, 64, 2048])
@pytest.mark.parametrize("seed,B,A", [(0, 3, 256), (1, 2, 700)])
def test_chain_matches_jax_and_native(window, seed, B, A):
    rng = np.random.default_rng(seed)
    got = _check(*_anchors(rng, B, A), window)
    preds = got.preds.numpy()
    assert (preds != np.arange(A)).any()  # chains formed


def test_chain_gates_ties_and_breaks():
    """Hand-made rows: a tie (two predecessors give the same candidate;
    the nearer one wins), a skip-counter stop (40 predecessors fail the
    gap-scale gate before a good one: the loop stops after 26), a
    target-gap break, and a cross-segment window."""
    A = 48
    seg = np.full((4, A), SENT, np.int32)
    tgt = np.zeros((4, A), np.int32)
    qry = np.zeros((4, A), np.int32)
    n = np.array([3, 42, 3, 4], np.int32)
    # tie: (0,0) and (0,1) share a target, so both score e; (10,12)
    # extends either by e
    seg[0, :3] = 0
    tgt[0, :3] = [0, 0, 10]
    qry[0, :3] = [0, 1, 12]
    # skip stop: a good predecessor at distance 41 behind 40 that fail
    # 0.75 < dq/dt < 5 (dq = 10 over dt = 61..100)
    seg[1, :42] = 0
    tgt[1, :42] = [0] + list(range(100, 140)) + [200]
    qry[1, :42] = [0] + [170] * 40 + [180]
    # target-gap break: the predecessor is more than 5000 behind
    seg[2, :3] = 0
    tgt[2, :3] = [0, 10, 9000]
    qry[2, :3] = [0, 10, 20]
    # cross-segment window: only the same-segment predecessor counts
    seg[3, :4] = [0, 1, 1, 2]
    tgt[3, :4] = [0, 5, 15, 25]
    qry[3, :4] = [0, 5, 15, 25]
    got = _check(seg, tgt, qry, n, 64)
    preds = got.preds.numpy()
    scores = got.scores.numpy()
    assert preds[0, 2] == 1 and scores[0, 2] == 12.0
    assert preds[1, 41] == 41 and scores[1, 41] == 6.0
    assert preds[2, 2] == 2 and preds[2, 1] == 0
    assert preds[3, 2] == 1 and preds[3, 1] == 1 and preds[3, 3] == 3
    # past n_anchors: score 0, pred = own index
    assert (scores[[0, 2], 3:] == 0).all() and (scores[3, 4:] == 0).all()
    assert (preds[0, 3:] == np.arange(3, A)).all()


def test_chain_wrapper_refuses_other_devices():
    x = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        chain_cuda.chain_dp(x, x, x, torch.zeros(1, dtype=torch.int32,
                                                 device="meta"),
                            window=8, **KW)
