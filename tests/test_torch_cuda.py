"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips without a card.

This file imports no JAX and nothing of the JAX package (the golden
engine, options, index build and native bindings are the port's own
copies), so on a machine without it run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Comparisons are exact (torch.equal, or NaN-for-NaN equality where a
chunk's z-norm divides by a zero deviation): kernel and plain version do
the same integer, float32 and float64 operations in the same order, and
the kernels are built with --fmad=false. The event and chain kernels
are also held to the native C detector and chaining DP. The minimizer
filter and the DTW family (plain PyTorch on the card) are held to their
CPU results, and the engine to golden on three paths.
"""

import numpy as np
import pytest
import torch

from rawalign_tpu_torch import config, native, runtime
from rawalign_tpu_torch.golden import events as gevents
from rawalign_tpu_torch.map import chain, chain_cuda, dtw, dtw_cuda, dtw_family, tiles
from rawalign_tpu_torch.parallel import mesh as pmesh
from rawalign_tpu_torch.parallel.dist_engine import DistributedMappingEngine
from rawalign_tpu_torch.seeds import sketch, sketch_cuda
from rawalign_tpu_torch.signal import events, events_cuda

pytestmark = pytest.mark.cuda

OPT = config.MappingOptions()
EV_KW = dict(w1=OPT.window_length1, w2=OPT.window_length2,
             threshold1=OPT.threshold1, threshold2=OPT.threshold2,
             peak_height=OPT.peak_height)
CHAIN_KW = dict(e=6, max_gap=2000, max_target_gap=5000, max_skips=25)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal element for element, NaN matching NaN."""
    return a.shape == b.shape and bool(
        ((a == b) | (a.isnan() & b.isnan())).all())


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _sketch_rows(rng, B, NE, e):
    """Noisy rows with a run of identical events and masked events, and
    the awkward ones: n_events of 0, 1, e - 1, e and NE; event 0 masked
    (alone and at the head of a masked run); a row that is one masked run;
    a whole row within 0.3 of its first event; NaN events, first and
    inside."""
    mask = np.float32(3.402823466e32)
    ev = rng.normal(0.0, 1.0, (B, NE)).astype(np.float32)
    if NE > 140:
        ev[:, 100:140] = ev[:, 100:101]
    ev[rng.random((B, NE)) < 0.02] = mask
    n_ev = rng.integers(0, NE + 1, B).astype(np.int32)
    special = [0, 1, max(e - 1, 0), e, NE, NE, NE, NE, NE, NE]
    for b, n in enumerate(special[:B]):
        n_ev[b] = min(n, NE)
    if B >= 10:
        ev[5, 0] = mask
        ev[6, : NE // 3] = mask
        ev[7, :] = mask
        ev[8, :] = 0.5 + rng.uniform(-0.14, 0.14, NE).astype(np.float32)
        ev[9, 0] = np.nan
        ev[9, rng.integers(0, NE, 4)] = np.nan
    return ev, n_ev


@pytest.mark.parametrize("e,q,lq,B,NE", [
    (1, 9, 3, 40, 700), (5, 9, 3, 40, 700), (6, 9, 3, 40, 700),
    (7, 9, 3, 40, 700), (10, 9, 3, 40, 700), (16, 9, 3, 40, 700),
    (16, 9, 0, 40, 700),  # quant_bit * e = 32 exactly
    (6, 12, 5, 40, 333),  # 42 bits: the pack overflows the uint32
    (6, 9, 3, 1, 2048), (6, 9, 3, 200, 333), (7, 9, 3, 12, 33),
    (6, 9, 3, 10, 1), (6, 9, 3, 10, 20000),  # rows beyond shared memory
])
def test_sketch_kernel_matches_plain(dev, e, q, lq, B, NE):
    rng = np.random.default_rng(e + NE)
    ev, n_ev = _sketch_rows(rng, B, NE, e)
    ev_d = torch.from_numpy(ev).to(dev)
    n_d = torch.from_numpy(n_ev).to(dev)
    before = sketch_cuda.launches
    got = sketch_cuda.sketch_scan(ev_d, n_d, e=e, q=q, lq=lq)
    want = sketch._sketch_scan(ev_d, n_d, e, q, lq)
    torch.cuda.synchronize()
    assert sketch_cuda.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _tiles(rng, lref, hist_shape, n_tiles, max_len, full_fill):
    rows = [(0, 1, lref, 1, 1, 0), (0, 1, lref, 1, 1, 1)]  # 1x1 tiles
    hrows, hmax = hist_shape
    if full_fill:  # read twice the reference part: R = 2*1400 - 700
        rows.append((lref, 1400, 5000, 700, 1400, 1))
    while len(rows) < n_tiles:
        ql = int(rng.integers(1, max_len + 1))
        tl = min(max(1, int(ql * rng.uniform(0.5, 1.6))), max_len)
        t0 = int(rng.integers(0, lref - tl))
        q0 = lref + int(rng.integers(0, hrows)) * hmax + int(
            rng.integers(0, hmax - ql + 1))
        r = ql if full_fill else max(1, int(ql * rng.choice([0.05, 0.1, 0.3])))
        x = int(rng.integers(0, 2))
        rows.append((t0, tl, q0, ql, r, x) if tl > ql else (q0, ql, t0, tl, r, x))
    return np.asarray(rows, np.int64)


def _dtw_round_vs_plain(dev, rng, da, lref, hist_shape, warp_max_slots):
    """The round in one launch against the plain round and the per-class
    plain version on the card; returns the descriptors and classes."""
    ref = torch.from_numpy(rng.normal(0, 1, lref).astype(np.float32)).to(dev)
    hist = torch.from_numpy(rng.normal(0, 1, hist_shape).astype(np.float32)).to(dev)
    cols = [da[:, k].astype(np.int32) for k in range(6)]
    _order, descs, batches = tiles.class_batches(
        *cols, np.arange(da.shape[0]), device_max_n=2048
    )
    descs_d = torch.from_numpy(descs).to(dev)
    before = dtw_cuda.launches
    if warp_max_slots == dtw_cuda.WARP_MAX_SLOTS:  # the dispatch's own path
        got = tiles.run_round(ref, hist, descs)
    else:
        jobs, block_w, stage = tiles.work_list(descs, warp_max_slots=warp_max_slots)
        got = dtw_cuda.dtw_banded_round(ref, hist, descs_d,
                                        torch.from_numpy(jobs).to(dev),
                                        block_w=block_w, stage=stage)
    torch.cuda.synchronize()
    assert dtw_cuda.launches == before + 1
    assert torch.equal(got, dtw.dtw_banded_round(ref, hist, descs_d))
    want = torch.cat([
        dtw.dtw_banded_indexed(
            ref, hist, descs_d[:, c.start : c.start + c.count], dpw=c.dpw)
        for c in batches
    ])
    assert torch.equal(got, want)
    return descs, batches


@pytest.mark.parametrize("full_fill,max_len,n_tiles", [
    (False, 300, 400),
    (False, 2048, 24),
    (True, 1400, 16),  # bands beyond 1024 slots and 48 KB of shared memory
])
def test_dtw_kernel_matches_plain(dev, full_fill, max_len, n_tiles):
    rng = np.random.default_rng(max_len)
    lref, hist_shape = 200_000, (4, 4096)
    da = _tiles(rng, lref, hist_shape, n_tiles, max_len, full_fill)
    _descs, batches = _dtw_round_vs_plain(dev, rng, da, lref, hist_shape,
                                          dtw_cuda.WARP_MAX_SLOTS)
    if full_fill:
        assert max(c.dpw for c in batches) >= 4096


@pytest.mark.parametrize("warp_max_slots", [0, 32, 64, 128])
def test_dtw_kernel_one_round_of_every_class(dev, warp_max_slots):
    """One round mixing every size class (32 .. 2048) and both R
    parities, at radius 5%, 10% and 30% of the read: warp tiles of every
    lane width beside block tiles, in one launch, whatever the cut-off."""
    rng = np.random.default_rng(warp_max_slots + 3)
    lref, hist_shape = 200_000, (4, 4096)
    da = np.concatenate([
        _tiles(rng, lref, hist_shape, 40, max_len, False)
        for max_len in (16, 32, 64, 128, 256, 512, 1024, 2048)
    ])
    descs, batches = _dtw_round_vs_plain(dev, rng, da, lref, hist_shape,
                                         warp_max_slots)
    assert {c.max_n for c in batches} == {32, 64, 128, 256, 512, 1024, 2048}
    assert {int(d6 > d7) for d6, d7 in zip(descs[6], descs[7])} == {0, 1}
    jobs, _w, _stage = tiles.work_list(descs, warp_max_slots=warp_max_slots)
    kinds = set(jobs[:, 0].tolist())
    assert kinds == ({0} | {k for k in dtw_cuda.WARP_K if 32 * k <= warp_max_slots})


def _cut_at_a_short_peak(row):
    """``row`` cut three samples after a short-detector peak above its
    threshold, so that the short detector masks the long one up to and at
    the last sample, where it fires."""
    w1 = OPT.window_length1
    sig = torch.from_numpy(row)[None, :]
    n = torch.tensor([row.size])
    ps, pss = events._prefix_sums(sig, n, row.size)
    t1 = events._tstat(ps, pss, n, w1)[0]
    above = torch.nonzero(t1[: row.size - w1] > 2 * OPT.threshold1)[:, 0]
    p = int(above[-1])
    while t1[p + 1] > t1[p]:  # climb to the local maximum
        p += 1
    return row[: p + w1]


def _event_rows(rng, L, n_noisy=24, edges=True):
    """Synthetic noisy steps of varying length plus the edge cases: an
    empty row, a constant row, a one-event row (NaN z-norm), rows of 9,
    2*w2 - 1 and 2*w2 samples (too short, and just long enough, for the
    long window) and a row in which the short detector masks the long one
    at the last sample."""
    rows = []
    for _ in range(n_noisy):
        n = int(rng.integers(L // 2, L + 1))
        levels = rng.normal(95.0, 12.0, n // 8 + 1)
        rows.append((np.repeat(levels, 8)[:n]
                     + rng.normal(0.0, 1.5, n)).astype(np.float32))
    step = np.concatenate([np.full(L // 4, 90.0), np.full(L // 4, 110.0)])
    w2 = OPT.window_length2
    if edges:
        rows += [np.zeros(0, np.float32), np.full(L // 2, 95.0, np.float32),
                 step.astype(np.float32),
                 rng.normal(95.0, 10.0, 9).astype(np.float32),
                 rng.normal(95.0, 10.0, 2 * w2 - 1).astype(np.float32),
                 rng.normal(95.0, 10.0, 2 * w2).astype(np.float32),
                 _cut_at_a_short_peak(rows[0])]
    sig = np.zeros((len(rows), L), np.float32)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        sig[i, : r.size] = r
        lens[i] = r.size
    return rows, sig, lens


@pytest.mark.parametrize("L,max_events,n_noisy,edges", [
    (4000, 2048, 24, True), (997, 32, 24, True), (20000, 4096, 24, True),
    (4001, 2048, 1, False), (1531, 2048, 193, True)])
def test_event_kernel_matches_plain_and_native(dev, L, max_events, n_noisy,
                                               edges):
    """L = 20000 exceeds shared memory: the block's scratch lives in a
    device buffer. One row alone, and 200 rows of a length that is no
    multiple of the warp or the block."""
    rng = np.random.default_rng(L)
    rows, sig, lens = _event_rows(rng, L, n_noisy, edges)
    sig_d = torch.from_numpy(sig).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    before = events_cuda.launches
    got = events_cuda.detect_events(sig_d, lens_d, max_events=max_events, **EV_KW)
    want = events.detect_events_plain(sig_d, lens_d, max_events=max_events,
                                      **EV_KW)
    torch.cuda.synchronize()
    assert events_cuda.launches == before + 1
    assert torch.equal(got.n_events, want.n_events)
    assert torch.equal(got.n_dropped, want.n_dropped)
    assert _same(got.values, want.values)
    values = got.values.cpu().numpy()
    for i, r in enumerate(rows):
        ev = gevents.detect_events_fast(r, OPT) if r.size else np.zeros(0)
        n = int(got.n_events[i])
        assert n == min(ev.size, max_events)
        np.testing.assert_array_equal(values[i, :n], ev[:max_events])
    assert int(got.n_events.sum()) > 0


def test_event_kernel_runs_again_the_chunks_that_started_wrong(dev):
    """The peak machine's chunks all start from a guess and run again, in
    rounds, until each started from the end state of the one before it:
    the kernel's own count shows that rows of steps take a few rounds,
    white noise more, a constant row none, and every result is the plain
    detector's, bit for bit."""
    rng = np.random.default_rng(5)
    _rows, sig, lens = _event_rows(rng, 1531, 6, True)
    B = 8
    noise = rng.normal(95.0, 15.0, (B, 4000)).astype(np.float32)
    flat = np.full((B, 4000), 95.0, np.float32)
    full = np.full(B, 4000, np.int32)
    seen = {}
    for label, s, n in (("steps", sig, lens), ("noise", noise, full),
                        ("constant", flat, full)):
        sig_d = torch.from_numpy(s).to(dev)
        lens_d = torch.from_numpy(n).to(dev)
        events_cuda.reruns(dev)
        got = events_cuda.detect_events(sig_d, lens_d, max_events=2048, **EV_KW)
        seen[label] = events_cuda.reruns(dev)
        want = events.detect_events_plain(sig_d, lens_d, max_events=2048,
                                          **EV_KW)
        assert torch.equal(got.n_events, want.n_events)
        assert torch.equal(got.n_dropped, want.n_dropped)
        assert _same(got.values, want.values)
    assert events_cuda.reruns(dev) == (0, 0)
    n_chunks = -(-3999 // 17)
    # (chunks run again, rounds), over all rows and both detectors
    assert 0 < seen["steps"][1] <= 6 * 2 * len(lens)
    assert seen["steps"][1] < seen["noise"][1] < 2 * B * n_chunks // 4
    assert seen["noise"][0] >= 2 * B * (n_chunks - 1) // 2
    # a constant row's t is 0: every chunk ends in the state (no peak,
    # minimum 0), but starts from (no peak, FLT_MAX): one more round
    assert seen["constant"] == (2 * B * (n_chunks - 1), 2 * B)


def _chain_rows(rng, B, A, interleave=False, runs=None):
    """Sorted rows with co-linear runs; with ``interleave`` sorted by
    (target, query) alone, so the segments alternate inside the window.
    ``runs`` shapes the rows' independent runs (``chain.chain_runs``):
    ``"gaps"`` adds 40 target jumps beyond max_target_gap a row to its
    four segments; ``"singletons"`` makes every anchor a run of its own
    (a segment each in even rows, a target jump each in odd rows);
    ``"one_long"`` puts a co-linear run of three quarters of the row in
    segment 0 and single anchors in segments of their own after it."""
    seg = np.full((B, A), 0x7FFFFFFF, np.int32)
    tgt = np.zeros((B, A), np.int32)
    qry = np.zeros((B, A), np.int32)
    n = rng.integers(A // 2, A + 1, B).astype(np.int32)
    n[0] = A
    mtg = CHAIN_KW["max_target_gap"]
    for b in range(B):
        m = int(n[b])
        s = np.sort(rng.integers(0, 4, m))
        t = rng.integers(0, 40 * m, m)
        q = rng.integers(0, 2 * m, m)
        for k in rng.integers(0, max(1, m - 60), 8):  # co-linear runs
            run = np.arange(min(60, m - k))
            s[k : k + run.size] = s[k]
            t[k : k + run.size] = t[k] + run * 10
            q[k : k + run.size] = q[k] + run * 9
        o = np.lexsort((q, t) if interleave else (q, t, s))
        s, t, q = s[o], t[o], q[o]
        if runs == "gaps":  # a non-decreasing offset keeps the order
            jump = np.zeros(m, np.int64)
            jump[rng.integers(1, m, 40)] = mtg + 1
            t = t + np.cumsum(jump)
        elif runs == "singletons":
            if b % 2 == 0:
                s = np.arange(m)
            else:
                s[:] = 0
                t = np.arange(m) * (mtg + 1)
        elif runs == "one_long":
            long = 3 * m // 4
            s = np.concatenate([np.zeros(long, np.int64), np.arange(1, m - long + 1)])
            t[:long] = np.arange(long) * 10
            q[:long] = np.arange(long) * 9
        seg[b, :m], tgt[b, :m], qry[b, :m] = s, t, q
    return seg, tgt, qry, n


@pytest.mark.parametrize("window,B,A,interleave,runs", [
    (8, 32, 2048, False, None), (64, 32, 4096, False, None),
    (2048, 8, 1024, False, None), (64, 2, 1 << 17, False, None),
    (1, 8, 512, False, None), (31, 8, 512, True, None),
    (32, 8, 512, True, None), (33, 8, 512, True, None),
    (2048, 8, 4096, True, None), (8160, 2, 9000, True, None),
    (64, 8, 4096, False, "gaps"), (65, 8, 2048, False, "gaps"),
    (2048, 4, 4096, False, "gaps"), (64, 32, 1 << 16, False, "gaps"),
    (64, 8, 1024, False, "singletons"), (64, 8, 4096, False, "one_long"),
    (64, 4, 1 << 17, False, "one_long"), (6000, 2, 8192, False, "gaps"),
    (10_000, 2, 16_384, False, "gaps"),
])
def test_chain_kernel_matches_plain_and_native(dev, window, B, A, interleave,
                                               runs):
    """Up to A = 4096 also against both plain versions (the warp-form scan
    on the CPU) and the run-split plain DP; at A = 1<<16 and 1<<17 (the
    anchor ceiling) and at windows 6000 and up only against native: the
    plain versions would step every anchor one launch sequence at a time.
    Rows of many runs (segments and target gaps), of a run an anchor, and
    of one run far longer than the rest, whose runs the kernel deals to
    the warps of its block; at windows 6000, 8160 and 10,000 the rings
    live in device memory, and the sorted rows with gaps deal their runs
    to eight warps there."""
    rng = np.random.default_rng(window + A)
    seg, tgt, qry, n = _chain_rows(rng, B, A, interleave, runs)
    kw = dict(window=window, **CHAIN_KW)
    host = [torch.from_numpy(x) for x in (seg, tgt, qry, n)]
    starts = chain.chain_runs(host[0], host[1], host[3],
                              max_target_gap=CHAIN_KW["max_target_gap"])
    if runs == "singletons":
        assert all(len(st) == int(m) for st, m in zip(starts, n))
    elif runs is not None:
        assert min(len(st) for st in starts) > 4
    d = [x.to(dev) for x in host]
    before = chain_cuda.launches
    got = chain_cuda.chain_dp(*d, **kw)
    torch.cuda.synchronize()
    assert chain_cuda.launches == before + 2  # window pass, recurrence
    if A <= 4096:
        want = chain.chain_dp_plain(*d, **kw)
        assert torch.equal(got.scores, want.scores)
        assert torch.equal(got.preds, want.preds)
        scan = chain.chain_dp_scan_plain(*host, **kw)
        assert torch.equal(got.scores.cpu(), scan.scores)
        assert torch.equal(got.preds.cpu(), scan.preds)
        split = chain.chain_dp_runs_plain(*host, slabs=chain.JOBS, **kw)
        assert torch.equal(got.scores.cpu(), split.scores)
        assert torch.equal(got.preds.cpu(), split.preds)
    ns, npred = native.chain_dp(seg, tgt, qry, n, **kw)
    np.testing.assert_array_equal(got.scores.cpu().numpy(), ns)
    np.testing.assert_array_equal(got.preds.cpu().numpy(), npred)
    assert (npred != np.arange(A)).any() or runs == "singletons"


def test_chain_kernel_takes_a_window_beyond_shared_memory(dev):
    """min(W, A) above 8128 does not fit the shared-memory ring: the
    kernel keeps its ring in device memory, with the same scores and
    predecessors as the plain DP and native, W = 10,000 at A = 16,384."""
    rng = np.random.default_rng(10_000)
    A = 16_384
    seg, tgt, qry, n = _chain_rows(rng, 2, A, interleave=True)
    # row 1: a co-linear run of segment 0 broken by 9000 anchors of
    # segment 1, so that its second half chains 9001 slots back
    run = np.arange(100)
    seg[1] = 2
    seg[1, :100] = seg[1, 9100:9200] = 0
    seg[1, 100:9100] = 1
    tgt[1] = rng.integers(0, 10 * A, A)
    qry[1] = rng.integers(0, 2 * A, A)
    tgt[1, :100], qry[1, :100] = 10 * run, 9 * run
    tgt[1, 9100:9200], qry[1, 9100:9200] = 1000 + 10 * run, 900 + 9 * run
    n[1] = A
    kw = dict(window=10_000, **CHAIN_KW)
    d = [torch.from_numpy(x).to(dev) for x in (seg, tgt, qry, n)]
    before = chain_cuda.launches
    got = chain_cuda.chain_dp(*d, **kw)
    torch.cuda.synchronize()
    assert chain_cuda.launches == before + 2  # window pass, recurrence
    want = chain.chain_dp_plain(*d, **kw)
    assert torch.equal(got.scores, want.scores)
    assert torch.equal(got.preds, want.preds)
    ns, npred = native.chain_dp(seg, tgt, qry, n, **kw)
    np.testing.assert_array_equal(got.scores.cpu().numpy(), ns)
    np.testing.assert_array_equal(got.preds.cpu().numpy(), npred)
    assert npred[1, 9100] == 99  # beyond the reach of an 8160-slot ring


@pytest.mark.parametrize("w", [1, 5])
def test_minimizer_filter_on_the_card_matches_cpu(dev, w):
    """The sketch kernel feeding the minimizer window filter on the card,
    against the whole function on the CPU (plain scan and filter)."""
    rng = np.random.default_rng(w)
    B, NE = 32, 2048
    ev = rng.normal(0.0, 1.0, (B, NE)).astype(np.float32)
    ev[rng.random((B, NE)) < 0.02] = np.float32(3.402823466e32)
    n_ev = rng.integers(0, NE + 1, B).astype(np.int32)
    n_ev[:3] = [0, 6, NE]
    kw = dict(w=w, e=7, q=9, lq=3)
    before = sketch_cuda.launches
    got = sketch.sketch_events_min_batch(
        torch.from_numpy(ev).to(dev), torch.from_numpy(n_ev).to(dev), **kw)
    want = sketch.sketch_events_min_batch(
        torch.from_numpy(ev), torch.from_numpy(n_ev), **kw)
    torch.cuda.synchronize()
    assert sketch_cuda.launches == before + 1
    for g, c in zip(got, want):
        assert torch.equal(g.cpu(), c)
    assert int(got.valid.sum()) > 0


@pytest.mark.parametrize("semiglobal", [False, True])
@pytest.mark.parametrize("radius", [None, 5])
def test_dtw_family_on_the_card_matches_cpu(dev, semiglobal, radius):
    rng = np.random.default_rng(7)
    B, N, M = 16, 120, 90
    a = rng.normal(0, 1, (B, N)).astype(np.float32)
    b = rng.normal(0, 1, (B, M)).astype(np.float32)
    na = rng.integers(1, N + 1, B).astype(np.int32)
    nb = rng.integers(1, M + 1, B).astype(np.int32)
    kw = dict(semiglobal=semiglobal, radius=radius, exclude_last=True)
    args = [torch.from_numpy(x) for x in (a, b, na, nb)]
    got = dtw_family.dtw_batch(*(x.to(dev) for x in args), **kw)
    want = dtw_family.dtw_batch(*args, **kw)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


def _engine_matches_golden(dev, flags=config.MappingFlag.NONE, mesh=None,
                           **modes):
    """The engine's PAF on the card equals golden's on every read; with
    ``mesh`` a (data, shard) layout, the distributed engine's, its ranks
    all on ``dev``."""
    import re

    from rawalign_tpu_torch.golden import engine as gengine
    from rawalign_tpu_torch.index import index as dindex
    from rawalign_tpu_torch.io import paf
    from rawalign_tpu_torch.testing import synth
    from rawalign_tpu_torch.map.engine import MappingEngine

    ds = synth.make_dataset(seed=11, genome_lengths=[12_000, 6_000],
                            n_reads=10, read_len_bp=(250, 700), noise_pa=1.3)
    io, mo = config.IndexOptions(), config.MappingOptions()
    config.set_opt("viral", io, mo)
    mo.set_flag(config.MappingFlag.DTW_EVALUATE_CHAINS | flags)
    idx = dindex.build_index(ds.seqs, ds.model.pore_vals, io)
    kw = dict(batch_size=4, chain_window=2048, max_occ=256, **modes)
    if mesh is None:
        eng = MappingEngine(idx, mo, device=dev, **kw)
    else:
        eng = DistributedMappingEngine(
            idx, mo, pmesh.make_mesh(*mesh, devices=[dev] * (mesh[0] * mesh[1])),
            **kw)
    strip = lambda s: re.sub(r"mt:f:[0-9.]+", "mt:f:X", s)  # noqa: E731
    got = {r.read_name: strip(paf.paf_line(r))
           for r in eng.map_reads((r.name, r.signal) for r in ds.reads)}
    eng.close()
    assert eng.counters["dtw_tiles_device"] > 0
    for r in ds.reads:
        assert got[r.name] == strip(paf.paf_line(
            gengine.map_read(idx, r.signal, r.name, mo)))
    return got


def test_engine_on_the_card_matches_golden(dev):
    _engine_matches_golden(dev)


def test_all_device_engine_on_the_card_matches_golden(dev):
    launched = (events_cuda.launches, chain_cuda.launches)
    _engine_matches_golden(dev, stage1_impl="device", chain_impl="device")
    assert events_cuda.launches > launched[0]
    assert chain_cuda.launches > launched[1]


def test_cigar_engine_on_the_card_matches_golden(dev):
    """CIGAR and chain output on the all-device path: the events ride the
    stage1 download and the DTW kernel reads the uploaded event pool."""
    launched = dtw_cuda.launches
    _engine_matches_golden(
        dev, config.MappingFlag.DTW_OUTPUT_CIGAR | config.MappingFlag.OUTPUT_CHAINS,
        stage1_impl="device", chain_impl="device")
    assert dtw_cuda.launches > launched


def test_fused_engine_on_the_card_matches_cpu_and_golden(dev):
    """The fused stage1+chain: the event, sketch and chain kernels in one
    device stage; the PAF equals the same engine's at device="cpu"."""
    mods = (events_cuda, sketch_cuda, chain_cuda)
    launched = [m.launches for m in mods]
    got = _engine_matches_golden(dev, fused=True)
    assert all(m.launches > n for m, n in zip(mods, launched))
    assert got == _engine_matches_golden(torch.device("cpu"), fused=True)


def test_dtw_pairs_on_the_card_match_native(dev):
    """The non-indexed dispatch: raw pairs up to n 4096 (a 10% band, as
    tools/check_dtw.py sizes it), in one launch, equal to native; the
    prepared-panel form too."""
    rng = np.random.default_rng(4)
    pairs = []
    for n in [1, 2, 7, 33, 128, 129, 400, 1000, 2048, 2049, 4096, 4096]:
        for stretch in (0.6, 1.0, 1.3):
            m = max(1, int(n * stretch))
            pairs.append((rng.normal(0, 1, n).astype(np.float32),
                          rng.normal(0, 1, m).astype(np.float32),
                          max(1, int(n * 0.10)), bool(rng.integers(0, 2))))
    want = native.dtw_banded_batch(pairs)
    before = dtw_cuda.launches
    got = tiles.dtw_banded_pairs(pairs, device=dev, device_max_n=8192,
                                 device_max_b=8192)
    assert dtw_cuda.launches == before + 1
    np.testing.assert_array_equal(got, want)
    small = [p for p in pairs if max(p[0].size, p[1].size) <= 2048]
    np.testing.assert_array_equal(
        tiles.dtw_banded(tiles.prepare_tiles(small), device=dev),
        native.dtw_banded_batch(small))


@pytest.mark.parametrize("stage1_impl", ["hybrid", "device"])
def test_distributed_engine_on_a_one_card_mesh_matches_golden(dev, stage1_impl):
    """Four ranks on one card: the routed stage1, the sharded chain DP and
    the sharded DTW, one launch per rank a round."""
    launched = (sketch_cuda.launches, chain_cuda.launches)
    _engine_matches_golden(dev, mesh=(2, 2), stage1_impl=stage1_impl)
    assert sketch_cuda.launches > launched[0]
    assert chain_cuda.launches > launched[1]


def test_sharded_dtw_on_a_one_card_mesh_equals_the_one_card_round(dev):
    rng = np.random.default_rng(8)
    lref, hist_shape = 20000, (4, 3000)
    da = _tiles(rng, lref, hist_shape, 300, 1024, False)
    ref = torch.from_numpy(rng.normal(0, 1, lref).astype(np.float32)).to(dev)
    hist = torch.from_numpy(rng.normal(0, 1, hist_shape).astype(np.float32)).to(dev)
    cols = [da[:, k].astype(np.int32) for k in range(6)]
    _order, descs, _b = tiles.class_batches(*cols, np.arange(da.shape[0]),
                                            device_max_n=2048)
    mesh = pmesh.make_mesh(1, 4, devices=[dev] * 4)
    before = dtw_cuda.launches
    order, costs = tiles.run_round_sharded(mesh, {dev: ref}, hist, descs)
    torch.cuda.synchronize()
    assert dtw_cuda.launches == before + 4
    want = tiles.run_round(ref, hist, descs)
    assert torch.equal(costs, want[torch.from_numpy(order).to(dev)])


def test_routed_stage1_on_a_one_card_mesh_equals_the_one_card_stage1(dev):
    from rawalign_tpu_torch.golden import events as gevents
    from rawalign_tpu_torch.index import index as dindex
    from rawalign_tpu_torch.map import stage1_codec
    from rawalign_tpu_torch.map.engine import MappingEngine
    from rawalign_tpu_torch.testing import synth

    ds = synth.make_dataset(seed=11, genome_lengths=[9000, 5000], n_reads=8,
                            read_len_bp=(150, 300))
    io, mo = config.IndexOptions(), config.MappingOptions()
    config.set_opt("viral", io, mo)
    idx = dindex.build_index(ds.seqs, ds.model.pore_vals, io)
    B, ne = 8, mo.max_events_per_chunk
    packed = np.zeros((B, ne + 2), np.float32)
    for i, r in enumerate(ds.reads[:B]):
        e = gevents.detect_events_fast(r.signal[: mo.chunk_size], mo)
        packed[i, : min(e.size, ne)] = e[:ne]
        packed[i, ne] = min(e.size, ne)
        packed[i, ne + 1] = max(e.size - ne, 0)
    one = MappingEngine(idx, mo, device=dev, batch_size=B)
    dist = DistributedMappingEngine(
        idx, mo, pmesh.make_mesh(2, 4, devices=[dev] * 8), batch_size=B)
    hist = torch.zeros((B, one._hmax), device=dev)
    off = np.zeros(B, np.int32)
    a, b = (stage1_codec.unpack_stage1(
        runtime.fetch(e._stage1(packed, hist, off)), ne=ne, ns=e._ns_out,
        events_on_host=False) for e in (one, dist))
    assert np.array_equal(a.count, b.count)
    used = a.count > 0
    assert used.sum() > 50
    assert np.array_equal(a.lo[used], b.lo[used])
    assert np.array_equal(a.qpos[used], b.qpos[used])
    for f in ("n_events", "n_ev_dropped", "n_occ_dropped", "n_compact_dropped"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    one.close()
    dist.close()


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    prev = torch.cuda.current_device()
    torch.cuda.set_device(0)
    yield torch.device("cuda", 1)
    torch.cuda.set_device(prev)


def test_wrappers_keep_the_callers_current_device(two_cards):
    """Each kernel launched on cuda:1 while cuda:0 is current: the result
    is the plain version's and cuda:0 is current again afterwards (the
    entry points set the thread's device themselves)."""
    c1 = two_cards
    rng = np.random.default_rng(9)
    ev, n_ev = _sketch_rows(rng, 16, 300, 6)
    ev_d, n_d = torch.from_numpy(ev).to(c1), torch.from_numpy(n_ev).to(c1)
    got = sketch_cuda.sketch_scan(ev_d, n_d, e=6, q=9, lq=3)
    assert torch.cuda.current_device() == 0
    want = sketch._sketch_scan(ev_d, n_d, 6, 9, 3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))

    sig = rng.normal(95.0, 15.0, (4, 4000)).astype(np.float32)
    sig_d = torch.from_numpy(sig).to(c1)
    lens = torch.full((4,), 4000, dtype=torch.int32, device=c1)
    got = events_cuda.detect_events(sig_d, lens, max_events=512, **EV_KW)
    assert torch.cuda.current_device() == 0
    want = events.detect_events_plain(sig_d, lens, max_events=512, **EV_KW)
    assert torch.equal(got.n_events, want.n_events)
    assert _same(got.values, want.values)
    events_cuda.reruns(c1)
    assert torch.cuda.current_device() == 0

    seg, tgt, qry, n = _chain_rows(rng, 4, 512)
    d = [torch.from_numpy(x).to(c1) for x in (seg, tgt, qry, n)]
    got = chain_cuda.chain_dp(*d, window=64, **CHAIN_KW)
    assert torch.cuda.current_device() == 0
    want = chain.chain_dp_plain(*d, window=64, **CHAIN_KW)
    assert torch.equal(got.scores, want.scores)
    assert torch.equal(got.preds, want.preds)

    da = _tiles(rng, 5000, (2, 800), 40, 300, False)
    ref = torch.from_numpy(rng.normal(0, 1, 5000).astype(np.float32)).to(c1)
    hist = torch.from_numpy(rng.normal(0, 1, (2, 800)).astype(np.float32)).to(c1)
    cols = [da[:, k].astype(np.int32) for k in range(6)]
    _o, descs, _b = tiles.class_batches(*cols, np.arange(da.shape[0]),
                                        device_max_n=2048)
    got = tiles.run_round(ref, hist, descs)
    assert torch.cuda.current_device() == 0
    assert torch.equal(got, dtw.dtw_banded_round(
        ref, hist, torch.from_numpy(descs).to(c1)))
    assert runtime.device("cuda") == torch.device("cuda", 0)


def test_fetch_async_waits_for_the_tensors_own_card(two_cards):
    """A fetch of a cuda:1 tensor made while cuda:0 is current, right
    behind a long chain launch on cuda:1, returns the finished values."""
    c1 = two_cards
    rng = np.random.default_rng(10)
    seg, tgt, qry, n = _chain_rows(rng, 2, 1 << 17)
    d = [torch.from_numpy(x).to(c1) for x in (seg, tgt, qry, n)]
    got = chain_cuda.chain_dp(*d, window=2048, **CHAIN_KW)
    host = runtime.fetch_async(got.scores).result()
    torch.cuda.synchronize(c1)
    np.testing.assert_array_equal(host, got.scores.cpu().numpy())
    assert (host > 0).any()


@pytest.fixture
def guard():
    runtime.set_debug_nans(True)
    yield
    runtime.set_debug_nans(False)


def test_check_finite_on_the_card(dev, guard):
    """The NaN guard on CUDA tensors: a NaN past a row's length passes,
    one inside it raises."""
    x = torch.zeros((2, 8), device=dev)
    n = torch.tensor([8, 3], dtype=torch.int32, device=dev)
    x[1, 5] = float("nan")
    runtime.check_finite("k", x, lengths=n)
    x[1, 2] = float("nan")
    with pytest.raises(FloatingPointError, match="^NaN in k$"):
        runtime.check_finite("k", x, lengths=n)


def test_the_kernel_wrappers_guard_their_inputs_on_the_card(dev, guard):
    """A NaN sample inside a row's length stops the event kernel's
    wrapper, and a NaN event in a slot a tile reads the DTW kernel's;
    neither wrapper launches its kernel then."""
    rng = np.random.default_rng(12)
    sig = torch.from_numpy(rng.normal(90, 10, (2, 600)).astype(np.float32)).to(dev)
    length = torch.tensor([600, 300], dtype=torch.int32, device=dev)
    sig[1, 400] = float("nan")
    events_cuda.detect_events(sig, length, max_events=256, **EV_KW)
    sig[1, 100] = float("nan")
    before = events_cuda.launches
    with pytest.raises(FloatingPointError, match="^NaN in detect_events input$"):
        events_cuda.detect_events(sig, length, max_events=256, **EV_KW)
    assert events_cuda.launches == before

    ref = torch.from_numpy(rng.normal(0, 1, 40).astype(np.float32)).to(dev)
    hist = torch.from_numpy(rng.normal(0, 1, (2, 16)).astype(np.float32)).to(dev)
    da = np.array([[0, 12, 40, 7, 3, 0], [20, 10, 56, 6, 2, 1]], np.int64)
    _o, descs, _b = tiles.class_batches(
        *[da[:, k].astype(np.int32) for k in range(6)], np.arange(2),
        device_max_n=2048)
    hist.view(-1)[10] = float("nan")  # joint slot 50: no tile reads it
    tiles.run_round(ref, hist, descs)
    hist.view(-1)[19] = float("nan")  # joint slot 59: the second tile's
    before = dtw_cuda.launches
    with pytest.raises(FloatingPointError, match="^NaN in dtw_banded_round input$"):
        tiles.run_round(ref, hist, descs)
    assert dtw_cuda.launches == before
