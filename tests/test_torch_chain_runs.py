"""The CUDA chain kernel's split of a row into independent runs,
``chain.chain_runs`` and ``chain.chain_dp_runs_plain`` (a plain DP per
run, or per job as the kernel merges runs), against ``chain_dp_plain``,
the native C loop (``native.chain_dp``) and the JAX scan
(``rawalign_tpu/map/chain.py:chain_dp_batch``) on the CPU, bit for bit:
hypothesis-drawn rows of several segments, sorted or interleaved (an
interleaved row is one run); target gaps of exactly ``max_target_gap``
and one more; a slot before a gap with the query or the target of the
anchor after it; windows 1 to 2048; ``max_skips`` 0 and 25; rows of 0, 1
and A anchors; a row whose every anchor is a run, one run far longer
than the rest, and rows the kernel must not split (unsorted, or
``t + max_target_gap`` beyond int32).
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

KW = dict(e=6, max_gap=2000, max_target_gap=5000)
MTG = KW["max_target_gap"]
WINDOWS = [1, 31, 32, 33, 64, 65, 2048]


@pytest.fixture(autouse=True)
def _need_native():
    if not native.chain_dp_available():
        pytest.skip("native host library not built")


def _rows(seed, B, A, n_seg, interleave, gaps, n=None):
    """(seg, tgt, qry, n) of B rows of A slots: co-linear stretches with
    target steps of 0-39 and query outliers, ``gaps`` target steps of
    exactly MTG or MTG + 1 (alternately), segments sorted or
    interleaved; sentinel padding past n."""
    rng = np.random.default_rng(seed)
    seg = np.full((B, A), 0x7FFFFFFF, np.int32)
    tgt = np.zeros((B, A), np.int32)
    qry = np.zeros((B, A), np.int32)
    if n is None:
        n = rng.integers(0, A + 1, B)
        n[0] = A
    n = np.asarray(n, np.int32)
    for b in range(B):
        m = int(n[b])
        step = rng.integers(0, 40, m)
        at = rng.choice(m, min(gaps, m), replace=False)
        step[at] = MTG + (np.arange(at.size) % 2)
        t = np.cumsum(step)
        q = t * 9 // 10 + rng.integers(-3, 4, m)
        out = rng.random(m) < 0.2
        q[out] = rng.integers(0, int(q.max(initial=0)) + 1, int(out.sum()))
        s = rng.integers(0, n_seg, m)
        o = np.lexsort((q, t) if interleave else (q, t, s))
        seg[b, :m], tgt[b, :m], qry[b, :m] = s[o], t[o], q[o]
    return seg, tgt, qry, n


def _check(x, window, max_skips, slabs=(None, chain.JOBS, 4)):
    """Every form of the run-split DP equals the plain DP, native and the
    JAX scan on ``x``."""
    kw = dict(window=window, max_skips=max_skips, **KW)
    t = [torch.from_numpy(v) for v in x]
    want = chain.chain_dp_plain(*t, **kw)
    for sl in slabs:
        got = chain.chain_dp_runs_plain(*t, slabs=sl, **kw)
        assert torch.equal(got.scores, want.scores), sl
        assert torch.equal(got.preds, want.preds), sl
    ns, npred = native.chain_dp(*x, **kw)
    np.testing.assert_array_equal(want.scores.numpy(), ns)
    np.testing.assert_array_equal(want.preds.numpy(), npred)
    jdp = jchain.chain_dp_batch(*x, **kw)
    np.testing.assert_array_equal(want.scores.numpy(), np.asarray(jdp.scores))
    np.testing.assert_array_equal(want.preds.numpy(), np.asarray(jdp.preds))
    return want


def _starts(x, **kw):
    seg, tgt, _q, n = (torch.from_numpy(v) for v in x)
    return [r.tolist() for r in chain.chain_runs(seg, tgt, n,
                                                 max_target_gap=MTG, **kw)]


@settings(max_examples=30, deadline=None, derandomize=True, database=None)
@given(
    window=st.sampled_from(WINDOWS),
    max_skips=st.sampled_from([0, 25]),
    seed=st.integers(0, 2**32 - 1),
    n_seg=st.integers(1, 4),
    interleave=st.booleans(),
    gaps=st.integers(0, 6),
)
def test_runs_equal_plain_native_and_jax(window, max_skips, seed, n_seg,
                                         interleave, gaps):
    A = 320 if window == 2048 else 160
    _check(_rows(seed, 3, A, n_seg, interleave, gaps), window, max_skips)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("max_skips", [0, 25])
def test_runs_at_every_window_and_skip_limit(window, max_skips):
    x = _rows(window * 7 + max_skips, 4, 200, 3, False, 5, n=[200, 0, 1, 137])
    _check(x, window, max_skips)


@pytest.mark.parametrize("n", [0, 1, 96])
def test_rows_of_none_one_and_every_anchor(n):
    x = _rows(n, 2, 96, 2, False, 3, n=[n, n])
    for s in _starts(x):
        assert s[:1] == ([0] if n else []) and (len(s) > 1) == (n == 96)
    _check(x, 64, 25)


def test_a_gap_of_exactly_max_target_gap_joins_and_one_more_splits():
    seg = np.zeros((1, 6), np.int32)
    tgt = np.array([[0, 10, 10 + MTG, 20 + MTG, 21 + 2 * MTG, 30 + 2 * MTG]],
                   np.int32)
    qry = np.array([[0, 9, 18, 27, 36, 45]], np.int32)
    n = np.array([6], np.int32)
    x = (seg, tgt, qry, n)
    assert _starts(x) == [[0, 4]]
    # with the segment break the runs are 0-1, 2-3 | 4-5 by segment
    seg2 = np.array([[0, 0, 1, 1, 1, 1]], np.int32)
    assert _starts((seg2, tgt, qry, n)) == [[0, 2, 4]]
    for w in (1, 2, 5):
        _check(x, w, 25)
        _check((seg2, tgt, qry, n), w, 0)


@pytest.mark.parametrize("same", ["query", "target"])
def test_a_slot_before_the_gap_with_the_query_or_target_of_the_next(same):
    """Slot 2, before the gap, holds the query (or target) of anchor 3,
    after it: the serial loop skips it without counting; the run split
    must not differ. With ``max_target_gap`` negative every target step
    is a gap and equal targets sit on both sides of a split."""
    seg = np.zeros((2, 5), np.int32)
    tgt = np.array([[0, 100, 200, 200 + MTG + 1, 300 + MTG + 1],
                    [0, 7, 7, 7, 9]], np.int32)
    qry = np.array([[0, 90, 180, 270, 360], [0, 5, 6, 7, 8]], np.int32)
    if same == "query":
        qry[0, 2] = qry[0, 3]
    else:
        tgt[0, 2] = tgt[0, 3]
        qry[0, 3] = 400
    n = np.array([5, 5], np.int32)
    x = (seg, tgt, qry, n)
    if same == "query":
        assert _starts(x)[0] == [0, 3]
    for w in (1, 2, 3, 64):
        for sk in (0, 25):
            _check(x, w, sk)
    kw = dict(window=64, max_skips=25, e=6, max_gap=2000, max_target_gap=-1)
    t = [torch.from_numpy(v) for v in x]
    assert [r.tolist() for r in chain.chain_runs(
        t[0], t[1], t[3], max_target_gap=-1)][1] == [0, 1, 2, 3, 4]
    want = chain.chain_dp_plain(*t, **kw)
    got = chain.chain_dp_runs_plain(*t, **kw)
    assert torch.equal(got.scores, want.scores)
    assert torch.equal(got.preds, want.preds)
    ns, npred = native.chain_dp(*x, **kw)
    np.testing.assert_array_equal(got.scores.numpy(), ns)
    np.testing.assert_array_equal(got.preds.numpy(), npred)


def test_interleaved_segments_are_one_run_and_unsorted_rows_too():
    x = _rows(5, 3, 160, 3, True, 4, n=[160, 160, 160])
    assert _starts(x) == [[0]] * 3
    _check(x, 64, 25)
    seg, tgt, qry, n = _rows(6, 2, 160, 1, False, 0, n=[160, 160])
    tgt[:, 100:] += MTG + 1  # a gap in both rows
    tgt[0, 81] = tgt[0, 80] - 1  # row 0: a target step back
    seg[1, :50] = 1  # row 1: the segments out of order
    assert _starts((seg, tgt, qry, n)) == [[0], [0]]
    _check((seg, tgt, qry, n), 64, 25)


def test_targets_near_the_int32_limit_keep_the_row_one_run():
    """Where t + max_target_gap leaves int32 the break's compare wraps
    (in the kernel and the plain versions alike): no split. The native
    loop's signed overflow is undefined in C, so only the plain versions
    are compared here."""
    x = _rows(8, 2, 128, 2, False, 3, n=[128, 128])
    seg, tgt, qry, n = x
    assert len(_starts(x)[0]) > 1
    tgt[0] += np.int32(2**31 - MTG - int(tgt[0].max()))
    assert _starts(x)[0] == [0] and len(_starts(x)[1]) > 1
    t = [torch.from_numpy(v) for v in x]
    kw = dict(window=64, max_skips=25, **KW)
    want = chain.chain_dp_plain(*t, **kw)
    for sl in (None, chain.JOBS):
        got = chain.chain_dp_runs_plain(*t, slabs=sl, **kw)
        assert torch.equal(got.scores, want.scores)
        assert torch.equal(got.preds, want.preds)


def test_every_anchor_its_own_run_and_one_long_run():
    A = 256
    seg = np.zeros((2, A), np.int32)
    tgt = np.zeros((2, A), np.int32)
    qry = np.zeros((2, A), np.int32)
    seg[0] = np.arange(A) // 2
    tgt[0] = np.arange(A) * 10
    tgt[0, 1::2] += MTG  # a gap inside each segment too
    qry[0] = np.arange(A) * 9
    # row 1: 200 co-linear anchors, then 56 runs of one anchor each
    tgt[1, :200] = np.arange(200) * 10
    qry[1, :200] = np.arange(200) * 9
    seg[1, 200:] = np.arange(1, 57)
    tgt[1, 200:] = 7
    n = np.array([A, A], np.int32)
    x = (seg, tgt, qry, n)
    starts = _starts(x)
    assert starts[0] == list(range(A))
    assert starts[1] == [0] + list(range(200, A))
    # the kernel's jobs: at most one a slab, each from a run start
    for sl in (4, 16):
        jobs = _starts(x, slabs=sl)
        assert all(len(j) <= sl and set(j) <= set(s)
                   for j, s in zip(jobs, starts))
    want = _check(x, 64, 25)
    assert (want.preds[1, 1:200] == torch.arange(0, 199)).all()
    assert (want.preds[0] == torch.arange(A)).all()


@pytest.mark.parametrize("A", [1024, 1 << 17])
def test_every_window_gets_a_block_of_at_least_two_warps(A):
    """The kernel's launch geometry: rings a power of two of at least
    min(W, A) + 64 slots, in shared memory while two or more fit, else in
    device memory with the full block, so every window splits its rows
    into jobs."""
    from rawalign_tpu_torch.map import chain_cuda

    fits = []
    for w in (1, 64, 1000, 4032, 4033, 6000, 8128, 8160, 12000, 1 << 17):
        ring, warps, in_smem = chain_cuda.geometry(w, A)
        assert ring >= min(w, A) + 64 and ring & (ring - 1) == 0
        assert ring < 2 * (min(w, A) + 64)
        assert 2 <= warps <= chain_cuda.WARPS
        if in_smem:
            assert (chain_cuda.TABLE_BYTES + 16 * ring * warps
                    <= chain_cuda.MAX_SMEM)
        else:
            assert warps == chain_cuda.WARPS
            assert chain_cuda.TABLE_BYTES + 32 * ring > chain_cuda.MAX_SMEM
        fits.append(in_smem)
    assert fits == ([True] * 10 if A == 1024 else [True] * 4 + [False] * 6)
