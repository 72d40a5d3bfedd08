"""A round's host tail as row-block jobs: the port's engine cuts each
round's expansion, native chain DP and traceback (``ra_round_chains``)
into contiguous blocks of rows (``map/engine.py:row_blocks``), one job a
pool worker, and merges their outputs.

On a synthetic round made from a seed (carried anchors on some rows, a
dead row, a row over the anchor budget so the occ-ranked drop fires),
every block split gives the anchors, the expansion's statistics, the
scores and preds, and every array of ``round_chains``' tuple bit for bit
as the one call over the whole round does, with the native expansion
and its numpy twin, with and without DTW tile descriptors. Then the
engine's PAF at pool widths 1, 2 and 8 against golden's and the JAX
engine's, under a lossy anchor ceiling, with CIGAR output (the Python
tail after the native chain DP) and with ``fused=True``.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from rawalign_tpu.golden import engine as gengine
from rawalign_tpu.io import paf
from rawalign_tpu.map.engine import MappingEngine as JaxEngine
from rawalign_tpu_torch import native, runtime
from rawalign_tpu_torch.config import MappingFlag
from rawalign_tpu_torch.map import anchors as manchors
from rawalign_tpu_torch.map import engine as tengine
from test_torch_engine import MappingEngine, _map, _opts, _port, golden, setup  # noqa: F401
from test_torch_fused import _port as _fused_port
from test_torch_fused import _strip_mt, ds_setup  # noqa: F401 (fixture)

torch.set_num_threads(1)

B, NS, A = 8, 24, 96
N_SEQ = 3
DEAD, OVER, CARRIED = 3, 6, (1, 5)
CHAIN_KW = dict(window=64, e=6, max_gap=2000, max_target_gap=5000, max_skips=25)


@pytest.fixture(autouse=True)
def _need_native():
    if not (native.available() and native.chain_dp_available()
            and native.round_tail_available()):
        pytest.skip("native host library not built")


def _round(seed: int):
    """One round's stage1 output and carried anchors: each row's first
    hit of a seed lies on one diagonal of one segment, so the rows chain;
    the other hits are random. Row OVER has more hits than A, row DEAD
    is not chained, the rows CARRIED carry anchors from a previous round."""
    rng = np.random.default_rng(seed)
    val_id, val_ps = [], []
    h_lo = np.zeros((B, NS), np.int32)
    h_qpos = np.zeros((B, NS), np.int32)
    h_count = np.zeros((B, NS), np.int32)
    offsets = rng.integers(0, 300, B).astype(np.int64)
    diag = []
    for b in range(B):
        seq, strand = int(rng.integers(0, N_SEQ)), int(rng.integers(0, 2))
        origin = int(rng.integers(1000, 100_000))
        diag.append((seq * 2 + strand, origin))
        h_qpos[b] = np.sort(rng.choice(400, NS, replace=False))
        for s in range(NS):
            if b == OVER:
                c = int(rng.integers(4, 9))
            else:
                c = 0 if rng.random() < 0.15 else int(rng.integers(1, 6))
            h_lo[b, s] = len(val_id)
            h_count[b, s] = c
            for j in range(c):
                if j == 0:
                    tid, st = seq, strand
                    tpos = origin + int(h_qpos[b, s]) + int(rng.integers(0, 2))
                else:
                    tid, st = int(rng.integers(0, N_SEQ)), int(rng.integers(0, 2))
                    tpos = int(rng.integers(0, 200_000))
                val_id.append(tid)
                val_ps.append((tpos << 1) | st)
    carried = {}
    for b in CARRIED:
        seg, origin = diag[b]
        q = np.sort(rng.choice(300, int(rng.integers(8, 20)), replace=False))
        carried[b] = (np.full(q.size, seg, np.int64),
                      (origin + q).astype(np.int64), q.astype(np.int64))
    live = np.ones(B, bool)
    live[DEAD] = False
    return dict(
        h_lo=h_lo, h_qpos=h_qpos, h_count=h_count, live=live, offsets=offsets,
        carried=carried, val_id=np.array(val_id, np.uint32),
        val_ps=np.array(val_ps, np.uint32),
        segbase=np.arange(2 * N_SEQ, dtype=np.int64) * 300_000,
        ev_base=np.arange(B, dtype=np.int64) * 5000 + 10**6,
    )


def _chains_kw(use_dtw: bool) -> dict:
    return dict(min_chaining_score=10.0, num_best_chains=3, min_num_anchors=2,
                disable_filter=False, sort_for_dtw=use_dtw, use_dtw=use_dtw,
                border_global=False, fill_full=False, band_frac=0.1)


def _one_call(r, use_dtw):
    """The round's tail as one call each, on arrays filled on the caller's
    thread, as the engine ran it before the blocks."""
    seg = np.full((B, A), manchors.SENTINEL_SEG, np.int32)
    tgt = np.zeros((B, A), np.int32)
    qry = np.zeros((B, A), np.int32)
    n = np.zeros(B, np.int32)
    stats = manchors.expand_round(
        r["h_lo"], r["h_qpos"], r["h_count"], r["live"], r["offsets"],
        r["carried"], r["val_id"], r["val_ps"], A, seg, tgt, qry, n)
    scores, preds = native.chain_dp(seg, tgt, qry, n, **CHAIN_KW)
    rec = native.round_chains(
        seg, tgt, qry, scores, preds, n, r["live"].astype(np.uint8), A,
        segbase=r["segbase"], ev_base=r["ev_base"], **_chains_kw(use_dtw))
    return (seg, tgt, qry, n), stats, (scores, preds), rec


def _blocks(r, use_dtw, k):
    """The round's tail as the engine's block jobs run it, into arrays
    whose every cell the blocks must write."""
    seg, tgt, qry = (np.full((B, A), -7, np.int32) for _ in range(3))
    n = np.full(B, -7, np.int32)
    scores = np.full((B, A), np.nan, np.float32)
    preds = np.full((B, A), -7, np.int32)
    gate = r["live"].astype(np.uint8)
    need = r["h_count"].sum(axis=1, dtype=np.int64)
    for i, c in r["carried"].items():
        need[i] += c[0].size
    blocks = tengine.row_blocks(np.where(r["live"], need, 0), k)
    stats, recs = [], []
    for lo, hi in blocks:
        stats.append(manchors.expand_block(
            lo, hi, r["h_lo"], r["h_qpos"], r["h_count"], r["live"],
            r["offsets"], r["carried"], r["val_id"], r["val_ps"], A,
            seg, tgt, qry, n))
        rows = slice(lo, hi)
        native.chain_dp_into(seg[rows], tgt[rows], qry[rows], n[rows],
                             scores[rows], preds[rows], **CHAIN_KW)
        recs.append((lo, native.round_chains(
            seg[rows], tgt[rows], qry[rows], scores[rows], preds[rows],
            n[rows], gate[rows], A, segbase=r["segbase"],
            ev_base=r["ev_base"][rows], **_chains_kw(use_dtw))))
    merged = (max(s[0] for s in stats), max(s[1] for s in stats),
              sum(s[2] for s in stats))
    return (seg, tgt, qry, n), merged, (scores, preds), \
        native.merge_round_chains(recs), blocks


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("impl", ["native", "numpy"])
@pytest.mark.parametrize("use_dtw", [False, True])
@pytest.mark.parametrize("k", [1, 2, 5, B])
def test_blocks_equal_the_one_call_round(monkeypatch, k, use_dtw, impl):
    if impl == "numpy":
        monkeypatch.setattr(native, "expand_round_available", lambda: False)
    r = _round(seed=17)
    anchors1, stats1, dp1, rec1 = _one_call(r, use_dtw)
    anchors2, stats2, dp2, rec2, blocks = _blocks(r, use_dtw, k)
    assert (len(blocks) > 1) == (k > 1)
    _equal(anchors2, anchors1)
    assert stats2 == stats1
    _equal(dp2, dp1)
    _equal(rec2, rec1)
    # the round exercises what it was made for
    assert stats1[1] > A and stats1[2] > 0
    assert anchors1[3][DEAD] == 0 and (anchors1[0][DEAD] == manchors.SENTINEL_SEG).all()
    assert rec1[0].size > B // 2 and set(rec1[0]) <= set(np.flatnonzero(r["live"]))
    assert (rec1[10].shape[0] > 0) == use_dtw


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("k", [1, 2, 3, 7, 32, 40])
def test_row_blocks_cover_every_row_once_balanced(seed, k):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 5000, 32) * (rng.random(32) < 0.8)
    blocks = tengine.row_blocks(w, k)
    assert blocks[0][0] == 0 and blocks[-1][1] == w.size
    assert all(lo < hi for lo, hi in blocks)
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    assert len(blocks) <= max(k, 1)
    if k > 1 and w.sum():
        # no block exceeds its share by more than one row's weight
        share = w.sum() / k
        assert max(int(w[lo:hi].sum()) for lo, hi in blocks) <= share + w.max()


def test_row_blocks_without_work_is_one_block():
    assert tengine.row_blocks(np.zeros(8, np.int64), 4) == [(0, 8)]


def test_merge_of_one_block_from_row_zero_is_the_block():
    r = _round(seed=3)
    *_, rec = _one_call(r, True)
    assert native.merge_round_chains([(0, rec)]) is rec


def test_pool_width_rule(setup):  # noqa: F811 (fixture)
    """The default width is the affinity count, at least 2; the keyword
    sets it; fewer than one worker raises."""
    _ds, idx, _reads = setup
    with MappingEngine(idx, _opts(True), device="cpu") as eng:
        assert eng.pool_workers == max(2, tengine.host_cpus())
    with MappingEngine(idx, _opts(True), device="cpu", pool_workers=3) as eng:
        assert eng.pool_workers == 3
    with pytest.raises(ValueError, match="pool_workers"):
        MappingEngine(idx, _opts(True), device="cpu", pool_workers=0)


@pytest.fixture(scope="module")
def jax_lines(setup):  # noqa: F811 (fixture)
    _ds, idx, reads = setup
    cache = {}

    def get(use_dtw):
        if use_dtw not in cache:
            cache[use_dtw] = _map(JaxEngine, idx, reads, use_dtw,
                                  stage1_impl="hybrid")[0]
        return cache[use_dtw]

    return get


@pytest.fixture
def every_round_split(monkeypatch):
    """Cut every round into one block a worker: these rounds are far
    lighter than ``ROW_BLOCK_ANCHORS``, so the engine would run each in one
    job."""
    monkeypatch.setattr(tengine, "ROW_BLOCK_ANCHORS", 1)


def test_a_light_round_runs_in_one_job(setup, monkeypatch):  # noqa: F811
    _ds, idx, reads = setup
    ks = []
    cut = tengine.row_blocks

    def spy(weight, k):
        ks.append((int(weight.sum()), k))
        return cut(weight, k)

    monkeypatch.setattr(tengine, "row_blocks", spy)
    _port(idx, reads, True, pool_workers=8)
    assert ks and all(w < tengine.ROW_BLOCK_ANCHORS and k == 1 for w, k in ks)
    monkeypatch.setattr(tengine, "ROW_BLOCK_ANCHORS", 64)
    ks.clear()
    _port(idx, reads, True, pool_workers=8)
    assert all(k == min(8, -(-w // 64)) for w, k in ks)
    assert max(k for _, k in ks) == 8


@pytest.mark.usefixtures("every_round_split")
@pytest.mark.parametrize("use_dtw", [False, True])
@pytest.mark.parametrize("width", [1, 2, 8])
def test_engine_at_pool_widths_matches_golden_and_jax(setup, golden,  # noqa: F811
                                                      jax_lines, width, use_dtw):
    _ds, idx, reads = setup
    got, eng = _port(idx, reads, use_dtw, pool_workers=width)
    assert eng.pool_workers == width
    assert got == golden(use_dtw)
    assert got == jax_lines(use_dtw)


@pytest.mark.usefixtures("every_round_split")
def test_engine_at_pool_widths_under_a_lossy_ceiling(setup):  # noqa: F811
    """An anchor ceiling below the rounds' demand drops anchors: every
    width drops the same ones (the counters' sum over the blocks)."""
    _ds, idx, reads = setup
    runs = [_port(idx, reads, True, pool_workers=w, max_anchors=64,
                  max_anchors_ceiling=64) for w in (1, 2, 8)]
    (want, eng1), rest = runs[0], runs[1:]
    assert eng1.counters["anchors_dropped"] > 0
    for got, eng in rest:
        assert got == want
        assert eng.counters == eng1.counters


def _golden_cigar(ds_setup, flags):  # noqa: F811 (fixture)
    """golden's PAF with ``flags`` at the default 2048 events a chunk,
    which no chunk of these reads reaches (golden keeps every event)."""
    idx, mo, reads = ds_setup
    mo = copy.deepcopy(mo)
    mo.set_flag(flags)
    mo.max_events_per_chunk = 2048
    return {name: _strip_mt(paf.paf_line(gengine.map_read(idx, sig, name, mo)))
            for name, sig in reads}


@pytest.fixture(scope="module")
def cigar_golden(ds_setup):  # noqa: F811 (fixture)
    return _golden_cigar(ds_setup, MappingFlag.DTW_OUTPUT_CIGAR)


@pytest.mark.usefixtures("every_round_split")
@pytest.mark.parametrize("width", [1, 8])
def test_cigar_at_pool_widths_matches_golden(ds_setup, cigar_golden,  # noqa: F811
                                             width):
    """CIGAR output: the native chain DP, then the traceback into Python
    chains in each block (``host.chains_of_round``)."""
    got, eng = _fused_port(ds_setup, MappingFlag.DTW_OUTPUT_CIGAR, cap=2048,
                           pool_workers=width)
    assert eng.chain_impl == "native" and eng._python_tail
    assert got == cigar_golden
    assert any("\taln:s:" in ln for ln in got.values())


@pytest.mark.usefixtures("every_round_split")
def test_fused_cigar_at_pool_width_8_matches_golden(ds_setup,  # noqa: F811
                                                   cigar_golden):
    """``fused=True`` with CIGAR output: the host replays the expansion in
    blocks, the traceback runs in one job."""
    got, eng = _fused_port(ds_setup, MappingFlag.DTW_OUTPUT_CIGAR, cap=2048,
                           fused=True, pool_workers=8)
    assert eng._fused and eng.counters["fused_escalations"] == 0
    assert got == cigar_golden


@pytest.mark.usefixtures("every_round_split")
def test_spans_name_the_pool_jobs_in_an_all_threads_trace(setup):  # noqa: F811
    """Outside a profiler session a span is nothing; in one started with
    every thread profiled, each job kind of the pools is a span."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    _ds, idx, reads = setup
    assert isinstance(runtime.span("host.expand"), contextlib.nullcontext)
    cfg = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=cfg) as prof:
        _port(idx, reads, True, pool_workers=4)
    spans = [ev for ev in prof.events() if ev.name.startswith("host.")]
    assert {"host.events", "host.expand", "host.chain_dp",
            "host.round_chains"} <= {ev.name for ev in spans}
    assert len({ev.thread for ev in spans}) > 1
