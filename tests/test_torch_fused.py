"""The port's fused stage1+chain (``MappingEngine(fused=True)``) against
its own unfused device stage1, the golden engine and the JAX engine's
``fused=True``, on the dataset and scenarios of
``tests/test_fused_engine.py``; ``map/fused.py`` step by step against the
host's replay (``map/anchors.py``'s numpy expansion and the native one);
the fused codec against the JAX package's; and the constructor's
``"auto"`` resolution against the JAX engine's.

PAF lines are compared byte for byte (mt:f stripped), except against the
JAX engine, whose float32 device event detector differs from golden by
design at this dataset's cap of 256 events a chunk (``ROADMAP.md`` §3
item 1): there identical lines are counted and the rest held to
``test_torch_engine._close_to``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawalign_tpu import config
from rawalign_tpu.config import MappingFlag
from rawalign_tpu.golden import engine as gengine
from rawalign_tpu.index import index as dindex
from rawalign_tpu.io import paf
from rawalign_tpu.map import stage1_codec as jcodec
from rawalign_tpu.map.engine import MappingEngine as JaxEngine
from rawalign_tpu.testing import synth
from rawalign_tpu_torch import native
from rawalign_tpu_torch.config import options_from
from rawalign_tpu_torch.index.index import index_from
from rawalign_tpu_torch.io import paf as tpaf
from rawalign_tpu_torch.map import anchors as manchors
from rawalign_tpu_torch.map import fused as mfused
from rawalign_tpu_torch.map import stage1_codec as tcodec
from rawalign_tpu_torch.map.engine import MappingEngine as PortEngine
from test_torch_engine import _close_to, _map, setup  # noqa: F401 (fixture)
from test_torch_engine import _port as _engine_port

torch.set_num_threads(1)

SENT = 0x7FFFFFFF
#: the port's engine on the CPU; its DTW tiles up to 256 run the plain
#: one-launch round, the rest native
PORT_KW = dict(batch_size=8, device="cpu", dtw_device_max_n=256,
               dtw_device_max_b=256)


@pytest.fixture(autouse=True)
def _need_native():
    if not (native.available() and native.events_available()
            and native.round_tail_available()):
        pytest.skip("native host library not built")


def _strip_mt(line: str) -> str:
    return re.sub(r"\tmt:f:[^\t]*", "", line)


@pytest.fixture(scope="module")
def ds_setup():
    """tests/test_fused_engine.py's dataset: multi-chunk reads (carried
    anchors) and a noise read, viral + DTW evaluation, cap 256."""
    ds = synth.make_dataset(
        seed=21,
        genome_lengths=[15000, 8000],
        n_reads=10,
        read_len_bp=(200, 700),
    )
    io, mo = config.IndexOptions(), config.MappingOptions()
    config.set_opt("viral", io, mo)
    mo.set_flag(MappingFlag.DTW_EVALUATE_CHAINS)
    mo.max_events_per_chunk = 256
    idx = dindex.build_index(ds.seqs, ds.model.pore_vals, io)
    reads = [(r.name, r.signal) for r in ds.reads]
    rng = np.random.default_rng(5)
    reads.append(("noise", rng.normal(95, 15, 9000).astype(np.float32)))
    return idx, mo, reads


def _port(ds_setup, flags=MappingFlag.NONE, fused_p=None, cap=None, **kw):
    """{read name: PAF line} of one pass of the port's engine, and it;
    ``cap`` replaces the dataset's 256 events a chunk."""
    idx, mo, reads = ds_setup
    mo = options_from(mo)
    mo.set_flag(flags)
    if cap is not None:
        mo.max_events_per_chunk = cap
    with PortEngine(index_from(idx), mo, **PORT_KW, **kw) as eng:
        if fused_p is not None:
            eng._fused_p = fused_p
        lines = {r.read_name: _strip_mt(tpaf.paf_line(r))
                 for r in eng.map_reads(iter(reads))}
    return lines, eng


@pytest.fixture(scope="module")
def unfused(ds_setup):
    """The port's unfused device-stage1 PAF at the default budget."""
    return _port(ds_setup, stage1_impl="device")[0]


@pytest.fixture(scope="module")
def golden(ds_setup):
    idx, mo, reads = ds_setup
    return {name: _strip_mt(paf.paf_line(gengine.map_read(idx, sig, name, mo)))
            for name, sig in reads}


def test_fused_in_budget_matches_unfused(ds_setup, unfused):
    got, eng = _port(ds_setup, fused=True)
    assert eng.stage1_impl == "device" and eng._fused
    assert got == unfused
    # multi-chunk reads re-inject their anchors through the carried upload
    assert any("ci:i:2" in ln or "ci:i:3" in ln for ln in got.values())
    assert eng.counters["fused_escalations"] == 0
    # P = 0: every round with chained reads fetches its DP prefix
    assert eng.counters["fused_refetches"] > 0


def test_fused_matches_golden_at_the_default_cap(ds_setup, golden):
    """The golden engine keeps every event of a chunk, so it is held to
    the engines at the default cap (2048 events a chunk, which no chunk
    of these reads reaches)."""
    got, eng = _port(ds_setup, fused=True, cap=2048)
    assert eng.counters["events_dropped"] == 0
    assert got == golden
    assert got == _port(ds_setup, stage1_impl="device", cap=2048)[0]
    assert eng.counters["fused_escalations"] == 0


def test_fused_prefix_refetch(ds_setup, unfused):
    """A downloaded prefix narrower than the replayed anchor count
    refetches a wider prefix of the device-resident DP output."""
    got, eng = _port(ds_setup, fused=True, fused_p=64)
    assert got == unfused
    assert eng.counters["fused_refetches"] > 0


@pytest.mark.parametrize("chain_impl", ["native", "device"])
def test_fused_escalation(ds_setup, chain_impl):
    """Rows with more hits than twice the budget escalate to the chain
    placement's unfused DP; the PAF equals the unfused engine at the same
    budget (its occ-ranked drop included)."""
    want, _ = _port(ds_setup, stage1_impl="device", chain_impl=chain_impl,
                    max_anchors=256, max_anchors_ceiling=256)
    got, eng = _port(ds_setup, fused=True, chain_impl=chain_impl,
                     max_anchors=256)
    assert got == want
    assert eng.counters["fused_escalations"] > 0


def test_fused_over_budget_device_drop(ds_setup):
    """Rows over the budget but within twice it stay fused: the device
    drops exactly the anchors the host's replay drops."""
    want, eng_u = _port(ds_setup, stage1_impl="device", max_anchors=512,
                        max_anchors_ceiling=512)
    assert eng_u.counters["anchors_dropped"] > 0
    got, eng = _port(ds_setup, fused=True, max_anchors=512)
    assert got == want
    assert eng.counters["anchors_dropped"] > 0
    assert eng.counters["fused_escalations"] < eng.phase_times["rounds"]


def test_fused_cigar_matches_unfused(ds_setup):
    """CIGAR output under fusion: the events ride the fused download."""
    flags = MappingFlag.DTW_OUTPUT_CIGAR | MappingFlag.OUTPUT_CHAINS
    want, _ = _port(ds_setup, flags, stage1_impl="device")
    got, eng = _port(ds_setup, flags, fused=True)
    assert eng._s1_dl_events
    assert got == want
    assert any("\taln:s:" in ln for ln in got.values())


def _jax(ds_setup, **kw):
    idx, mo, reads = ds_setup
    eng = JaxEngine(idx, mo, batch_size=8, dtw_device_max_n=0,
                    dtw_device_max_b=0, **kw)
    lines = {r.read_name: _strip_mt(paf.paf_line(r))
             for r in eng.map_reads(iter(reads))}
    eng.close()
    return lines


def test_fused_equals_the_jax_hybrid_engine(ds_setup):
    """At the cap of 256, byte for byte the JAX hybrid engine's PAF: its
    host C events keep the first 256 of a chunk, as the port's device
    events do (the JAX device detector normalises only the kept ones,
    ``ROADMAP.md`` §3 item 1, and at the default cap its float32 events
    move one read of this dataset by a matching base, in its fused and
    unfused passes alike)."""
    got, _ = _port(ds_setup, fused=True)
    assert got == _jax(ds_setup, stage1_impl="hybrid")


def test_fused_against_the_jax_fused_engine_within_tolerance(setup):
    """On ``test_torch_engine.py``'s dataset, as its all-device test holds
    the JAX float32 device events: identical lines counted, the rest
    within the JAX package's own tolerance."""
    _ds, idx, reads = setup
    got, eng = _engine_port(idx, reads, True, fused=True)
    assert eng._fused and eng.counters["fused_refetches"] > 0
    want, _ = _map(JaxEngine, idx, reads, True, fused=True,
                   dtw_device_max_n=0, dtw_device_max_b=0)
    assert got.keys() == want.keys()
    n_same = 0
    for name, line in got.items():
        if line == want[name]:
            n_same += 1
        else:
            assert _close_to(line, want[name]), (name, want[name], line)
    assert n_same >= 1


# ---- map/fused.py step by step ---------------------------------------


def _index_table(rng, S, n_seq=3):
    val_id = rng.integers(0, n_seq, S).astype(np.uint32)
    pos = rng.integers(0, 40_000, S).astype(np.uint32)
    val_ps = (pos << np.uint32(1)) | rng.integers(0, 2, S).astype(np.uint32)
    return val_id, val_ps


def _blocks(rng, B, NS, S, totals, qmax=200):
    """(lo, qpos, count) (B, NS) int32, hits first, each row's counts
    summing to ``totals[i]``, lo in [0, S - count]."""
    lo = np.zeros((B, NS), np.int32)
    qpos = np.zeros((B, NS), np.int32)
    count = np.zeros((B, NS), np.int32)
    for i, tot in enumerate(totals):
        k = int(rng.integers(1, NS + 1))
        cuts = np.sort(rng.integers(0, tot + 1, k - 1))
        c = np.diff(np.concatenate([[0], cuts, [tot]])).astype(np.int32)
        c = c[c > 0]
        count[i, : c.size] = c
        qpos[i, : c.size] = rng.integers(0, qmax, c.size)
        lo[i, : c.size] = rng.integers(0, S - c + 1)
    return lo, qpos, count


def _carried(rng, B, C, n_car, offsets):
    """The carried upload (B, 3C+2) int32 and the host's carried lists;
    a few carried anchors duplicate each other (sort ties)."""
    up = np.zeros((B, 3 * C + 2), np.int32)
    lists = {}
    for i, m in enumerate(n_car):
        seg = rng.integers(0, 6, m).astype(np.int64)
        tgt = rng.integers(0, 40_000, m).astype(np.int64)
        qry = rng.integers(0, 300, m).astype(np.int64)
        if m > 2:
            seg[1], tgt[1], qry[1] = seg[0], tgt[0], qry[0]
        if m:
            lists[i] = (seg, tgt, qry)
        up[i, :m], up[i, C : C + m], up[i, 2 * C : 2 * C + m] = seg, tgt, qry
        up[i, 3 * C] = m
        up[i, 3 * C + 1] = offsets[i]
    return up, lists


def _host_replay(expand, lo, qpos, count, offsets, lists, val_id, val_ps, A):
    B = lo.shape[0]
    seg = np.full((B, A), SENT, np.int32)
    tgt = np.zeros((B, A), np.int32)
    qry = np.zeros((B, A), np.int32)
    n = np.zeros(B, np.int32)
    used, true, dropped = expand(lo, qpos, count, np.ones(B, bool),
                                 offsets.astype(np.int64), lists, val_id,
                                 val_ps, A, seg, tgt, qry, n)
    return seg, tgt, qry, n, true


@pytest.mark.parametrize("seed", range(3))
def test_sort_order_equals_lexsort(seed):
    """Two stable passes equal np.lexsort((qry, tgt, seg)) with the
    concatenation order breaking ties, padding (seg SENT) last."""
    rng = np.random.default_rng(seed)
    B, n = 3, 500
    seg = rng.integers(0, 4, (B, n)).astype(np.int32)
    seg[:, -40:] = SENT
    tgt = rng.integers(0, 50, (B, n)).astype(np.int32)
    qry = rng.integers(0, 20, (B, n)).astype(np.int32)
    idx = np.broadcast_to(np.arange(n, dtype=np.int32), (B, n)).copy()
    x = mfused.Anchors(*(torch.from_numpy(a) for a in (seg, tgt, qry, idx)),
                       valid=torch.ones((B, n), dtype=torch.bool))
    got = mfused.sort_anchors(x)
    for i in range(B):
        order = np.lexsort((qry[i], tgt[i], seg[i]))
        np.testing.assert_array_equal(got.occ[i].numpy(), idx[i, order])
        np.testing.assert_array_equal(got.seg[i].numpy(), seg[i, order])


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("impl", ["numpy", "native"])
def test_fused_anchors_equal_the_host_replay(seed, impl):
    """Expansion, carried merge, sort and the occ-ranked drop equal the
    host's expand_round on the same blocks, rows under the budget, over
    it and under twice it, with and without carried anchors."""
    if impl == "native" and not native.expand_round_available():
        pytest.skip("native expand_round not built")
    expand = (manchors.expand_round_numpy if impl == "numpy"
              else native.expand_round)
    rng = np.random.default_rng(100 + seed)
    A, C, NS, S = 64, 16, 24, 5000
    val_id, val_ps = _index_table(rng, S)
    totals = [0, 5, 40, 64, 70, 100, 128 - 16, 128]
    n_car = [0, 3, 16, 0, 9, 16, 16, 0]
    B = len(totals)
    lo, qpos, count = _blocks(rng, B, NS, S, totals)
    # the second seed repeats the first's query position and, where it
    # fits, its index range (ties in the sort)
    qpos[:, 1] = qpos[:, 0]
    same = count[:, 1] <= count[:, 0]
    lo[same, 1] = lo[same, 0]
    offsets = rng.integers(0, 500, B)
    up, lists = _carried(rng, B, C, n_car, offsets)
    got, n_dp = mfused.fused_anchors(
        torch.from_numpy(lo), torch.from_numpy(tcodec.pack_qc(qpos, count)),
        torch.from_numpy(up), torch.from_numpy(val_id.view(np.int32)),
        torch.from_numpy(val_ps.view(np.int32)), a=A, a_exp=2 * A)
    seg, tgt, qry, n, true = _host_replay(expand, lo, qpos, count, offsets,
                                          lists, val_id, val_ps, A)
    assert true > A  # some rows were over the budget
    np.testing.assert_array_equal(n_dp.numpy(), n)
    np.testing.assert_array_equal(got.seg.numpy(), seg)
    np.testing.assert_array_equal(got.tgt.numpy(), tgt)
    np.testing.assert_array_equal(got.qry.numpy(), qry)


def test_over_budget_drop_where_an_int32_key_wraps():
    """A row at max_anchors 65,536 whose repetitive seed has 40,000 hits:
    occ * E passes 2**31, where an int32 compound key would wrap. The
    int64 key keeps exactly min(A, m) anchors, those with the smallest
    (occ, sorted position), as the host replay does."""
    rng = np.random.default_rng(7)
    A, C = 65536, 512
    E = 2 * A + C
    S = 120_000
    val_id, val_ps = _index_table(rng, S)
    count = np.array([[40_000, 30_000, 5, 0]], np.int32)
    lo = np.array([[0, 50_000, 100_000, 0]], np.int32)
    qpos = np.array([[3, 9, 1, 0]], np.int32)
    offsets = np.array([0])
    up, lists = _carried(rng, 1, C, [7], offsets)
    m = int(count.sum()) + 7
    assert int(count.max()) * E > np.iinfo(np.int32).max
    got, n_dp = mfused.fused_anchors(
        torch.from_numpy(lo), torch.from_numpy(tcodec.pack_qc(qpos, count)),
        torch.from_numpy(up), torch.from_numpy(val_id.view(np.int32)),
        torch.from_numpy(val_ps.view(np.int32)), a=A, a_exp=2 * A)
    assert int(n_dp[0]) == min(A, m)
    assert int(got.valid.sum()) == min(A, m)
    # the kept anchors: all 30,012 of the smaller seeds and the carried
    # ones, and the first of the 40,000 in sorted order
    assert int((got.occ[0] == 40_000).sum()) == A - 30_012
    seg, tgt, qry, n, _ = _host_replay(manchors.expand_round_numpy, lo, qpos,
                                       count, offsets, lists, val_id, val_ps, A)
    np.testing.assert_array_equal(got.seg.numpy(), seg)
    np.testing.assert_array_equal(got.tgt.numpy(), tgt)
    np.testing.assert_array_equal(got.qry.numpy(), qry)


# ---- the codec and the constructor ------------------------------------


@pytest.mark.parametrize("with_events,a", [(False, 0), (True, 0), (False, 5)])
def test_fused_codec_equals_the_jax_codec(with_events, a):
    rng = np.random.default_rng(3)
    B, NE, NS = 4, 12, 6
    ev = rng.normal(0, 1, (B, NE)).astype(np.float32)
    lo = rng.integers(0, 1000, (B, NS)).astype(np.int32)
    qc = tcodec.pack_qc(rng.integers(0, 200, (B, NS)).astype(np.int32),
                        rng.integers(0, 50, (B, NS)).astype(np.int32))
    sc = rng.integers(0, 9, (B, 4)).astype(np.int32)
    scores = rng.normal(0, 9, (B, a)).astype(np.float32)
    preds = rng.integers(0, 100, (B, a)).astype(np.int32)
    got = tcodec.pack_stage1_fused(
        *(torch.from_numpy(x) for x in (lo, qc, sc)),
        torch.from_numpy(ev) if with_events else None,
        torch.from_numpy(scores), torch.from_numpy(preds)).numpy()
    want = np.asarray(jcodec.pack_stage1_fused(
        jnp.asarray(ev), jnp.asarray(lo), jnp.asarray(qc), jnp.asarray(sc),
        jnp.asarray(scores), jnp.asarray(preds), include_events=with_events))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    sf = tcodec.unpack_stage1_fused(got, ne=NE, ns=NS, a=a,
                                    events_on_host=with_events)
    np.testing.assert_array_equal(sf.stage1.lo, lo)
    np.testing.assert_array_equal(sf.scores, scores)
    np.testing.assert_array_equal(sf.preds, preds)
    with pytest.raises(ValueError, match="layout drift"):
        tcodec.unpack_stage1_fused(got, ne=NE, ns=NS, a=a + 1,
                                   events_on_host=with_events)


@pytest.mark.parametrize("fused", [False, True])
def test_auto_resolves_as_the_jax_engine(ds_setup, fused):
    """With the native library built, "auto" picks the hybrid stage1
    unless fused, and the native chain DP, as the JAX engine does."""
    idx, mo, _ = ds_setup
    jeng = JaxEngine(idx, mo, batch_size=8, fused=fused, max_carried=100)
    jeng.close()
    with PortEngine(index_from(idx), options_from(mo), device="cpu",
                    batch_size=8, fused=fused, max_carried=100) as eng:
        assert eng.stage1_impl == jeng._stage1_mode
        assert (eng.chain_impl == "native") == jeng._chain_native
        assert eng._fused == fused
        assert eng._fused_c == jeng._fused_c == 100
        assert eng._fused_exp == jeng._fused_exp


def test_fused_with_the_hybrid_stage1_raises(ds_setup):
    idx, mo, _ = ds_setup
    with pytest.raises(ValueError, match="stage1_impl='device'"):
        PortEngine(index_from(idx), options_from(mo), device="cpu",
                   fused=True, stage1_impl="hybrid")
