"""The CUDA chain kernel's warp formulation, ``chain_dp_scan_plain``,
against ``chain_dp_plain``, the native C loop (``native.chain_dp``) and
the JAX scan (``rawalign_tpu/map/chain.py:chain_dp_batch``), on the CPU,
on rows that hypothesis draws: windows 1, 31, 32, 33, 64 and 2048 (wider
than the row, so the whole row is the window, in up to ten chunks);
segments sorted or interleaved (then most window slots are inert);
parallel co-linear runs, whose anchors tie; target jumps beyond
``max_target_gap`` and skip limits of 3, 25 and 31, so that both breaks
fall at, before and after the 32-slot chunk boundaries. Scores and
predecessors are compared exactly.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rawalign_tpu.map import chain as jchain
from rawalign_tpu_torch import native
from rawalign_tpu_torch.map import chain

torch.set_num_threads(1)

B = 3
KW = dict(e=6, max_gap=2000, max_target_gap=5000)


@pytest.fixture(autouse=True)
def _need_native():
    if not native.chain_dp_available():
        pytest.skip("native host library not built")


def _rows(seed, A, n_seg, interleave, dup, jumps):
    """(seg, tgt, qry, n) of B rows of A slots: co-linear runs with small
    target steps, random query outliers, ``jumps`` target gaps of more
    than max_target_gap, with ``dup`` a copy of every run shifted by one
    in target and query (equal candidates), segments sorted or
    interleaved; sentinel padding past n."""
    rng = np.random.default_rng(seed)
    seg = np.full((B, A), 0x7FFFFFFF, np.int32)
    tgt = np.zeros((B, A), np.int32)
    qry = np.zeros((B, A), np.int32)
    n = rng.integers(A // 2, A + 1, B).astype(np.int32)
    n[0] = A
    for b in range(B):
        m = int(n[b])
        base = (m + 1) // 2 if dup else m
        step = rng.integers(0, 40, base)
        step[rng.integers(0, base, jumps)] += 5001
        t = np.cumsum(step)
        q = t * 9 // 10 + rng.integers(-3, 4, base)
        out = rng.random(base) < 0.2
        q[out] = rng.integers(0, int(q.max()) + 1, int(out.sum()))
        s = rng.integers(0, n_seg, base)
        if dup:
            t = np.concatenate([t, t[: m - base] + 1])
            q = np.concatenate([q, q[: m - base] + 1])
            s = np.concatenate([s, s[: m - base]])
        o = np.lexsort((q, t) if interleave else (q, t, s))
        seg[b, :m], tgt[b, :m], qry[b, :m] = s[o], t[o], q[o]
    return seg, tgt, qry, n


@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(
    window=st.sampled_from([1, 31, 32, 33, 64, 2048]),
    max_skips=st.sampled_from([3, 25, 31]),
    seed=st.integers(0, 2**32 - 1),
    n_seg=st.integers(1, 4),
    interleave=st.booleans(),
    dup=st.booleans(),
    jumps=st.integers(0, 3),
)
def test_scan_equals_plain_native_and_jax(window, max_skips, seed, n_seg,
                                          interleave, dup, jumps):
    A = 320 if window == 2048 else 160
    x = _rows(seed, A, n_seg, interleave, dup, jumps)
    kw = dict(window=window, max_skips=max_skips, **KW)
    t = [torch.from_numpy(v) for v in x]
    got = chain.chain_dp_scan_plain(*t, **kw)
    want = chain.chain_dp_plain(*t, **kw)
    assert torch.equal(got.scores, want.scores)
    assert torch.equal(got.preds, want.preds)
    ns, npred = native.chain_dp(*x, **kw)
    np.testing.assert_array_equal(got.scores.numpy(), ns)
    np.testing.assert_array_equal(got.preds.numpy(), npred)
    jdp = jchain.chain_dp_batch(*x, **kw)
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(jdp.scores))
    np.testing.assert_array_equal(got.preds.numpy(), np.asarray(jdp.preds))


def _serial(seg, tgt, qry, n, window, e, max_gap, max_target_gap, max_skips):
    """The reference's loop (rmap.cpp:427-484) in Python, with the number
    of predecessor slots it visits in each row."""
    B_, A = seg.shape
    f = np.zeros((B_, A), np.float32)
    p = np.tile(np.arange(A, dtype=np.int32), (B_, 1))
    visits = np.zeros(B_, np.int64)
    for b in range(B_):
        for i in range(int(n[b])):
            best, pred, skips = np.float32(e), i, 0
            for j in range(i - 1, max(i - window, 0) - 1, -1):
                visits[b] += 1
                if seg[b, j] != seg[b, i]:
                    continue
                tj, qj, ct, cq = tgt[b, j], qry[b, j], tgt[b, i], qry[b, i]
                if qj == cq or tj == ct:
                    continue
                if tj + max_target_gap < ct:
                    break
                qd, td = int(cq) - int(qj), int(ct) - int(tj)
                if qd < 0:
                    continue
                scale = np.float32(qd) / np.float32(td) if td > 0 else 1.0
                cur = np.float32(0.0)
                if abs(td - qd) < max_gap and 0.75 < scale < 5.0:
                    cur = f[b, j] + np.float32(min(td, qd, e))
                if cur > best:
                    best, pred, skips = cur, j, skips - 1
                else:
                    skips += 1
                    if skips > max_skips:
                        break
            f[b, i], p[b, i] = best, pred
    return f, p, visits


@pytest.mark.parametrize("window,max_skips", [(33, 25), (2048, 3), (64, 31)])
def test_scan_counts_the_slots_the_serial_loop_visits(window, max_skips):
    A = 320 if window == 2048 else 160
    x = _rows(window, A, 3, True, True, 2)
    kw = dict(window=window, max_skips=max_skips, **KW)
    visited = torch.zeros(B, dtype=torch.int64)
    got = chain.chain_dp_scan_plain(*(torch.from_numpy(v) for v in x),
                                    visited=visited, **kw)
    f, p, visits = _serial(*x, **kw)
    np.testing.assert_array_equal(got.scores.numpy(), f)
    np.testing.assert_array_equal(got.preds.numpy(), p)
    np.testing.assert_array_equal(visited.numpy(), visits)
    assert visits.min() > 0


def test_scan_sends_an_anchor_across_the_lanes_only_when_its_record_cannot_hold_it():
    """Every anchor with a predecessor slot is resolved by the max or
    across the lanes; a lower skip limit turns more records complex (a
    candidate past the limit could meet a skip break), and the scores
    stay the serial loop's either way."""
    x = _rows(7, 160, 2, False, True, 2)
    t = [torch.from_numpy(v) for v in x]
    counts = {}
    for max_skips in (0, 3, 25):
        kw = dict(window=64, max_skips=max_skips, **KW)
        paths = torch.zeros(2, dtype=torch.int64)
        got = chain.chain_dp_scan_plain(*t, paths=paths, **kw)
        f, p, _ = _serial(*x, **kw)
        np.testing.assert_array_equal(got.scores.numpy(), f)
        np.testing.assert_array_equal(got.preds.numpy(), p)
        assert int(paths.sum()) == int(np.maximum(x[3].astype(np.int64) - 1, 0).sum())
        counts[max_skips] = paths.tolist()
    assert counts[0][1] >= counts[3][1] >= counts[25][1]
    assert counts[0][1] > counts[25][1] and counts[25][0] > 0
