"""The host stage1 (``stage1_impl="host"``), the stage1 download that
carries the events, the guard on the native expansion's anchor count and
the port's CLI in the newly ported modes, against the JAX engine and CLI.
Comparisons are exact (mt:f stripped). Dataset: ``test_torch_flags``.
"""

import numpy as np
import pytest
import torch

from rawalign_tpu import config
from rawalign_tpu.config import MappingFlag as F
from rawalign_tpu.golden import events as gevents
from rawalign_tpu_torch.map import engine as tengine
from rawalign_tpu_torch.map.stage1_codec import unpack_stage1
from test_torch_engine import _cli_against_jax_cli, line_of
from test_torch_flags import (  # noqa: F401  (fixtures)
    ENGINE_KW,
    JAX_KW,
    PORT_KW,
    JaxEngine,
    MappingEngine,
    _need_native,
    build_index,
    dataset,
    run,
)


@pytest.mark.parametrize("preset", ["viral", "faster"])
@pytest.mark.parametrize("use_dtw", [False, True])
def test_host_stage1_matches_jax_host_stage1(capsys, preset, use_dtw):
    """The native sketch (``sketch_min`` under ``faster``), searchsorted
    lookup and occurrence cap on the host; DTW on the uploaded pool of
    the chained reads' events."""
    idx = build_index(preset)
    reads = dataset()[1]
    mo = config.MappingOptions()
    config.set_opt(preset, config.IndexOptions(), mo)
    if use_dtw:
        mo.set_flag(F.DTW_EVALUATE_CHAINS)
    eng = MappingEngine(idx, mo, **ENGINE_KW, **PORT_KW, stage1_impl="host")
    got = {r.read_name: r for r in eng.map_reads(reads)}
    eng.close()
    assert eng.stage1_impl == "host" and eng._events_on_host
    assert (eng.counters["dtw_tiles_device"] > 0) == use_dtw
    want, _ = run(JaxEngine, idx, reads, mo, capsys,
                  **{**JAX_KW, "stage1_impl": "host"})
    assert {n: line_of(r) for n, r in got.items()} == want
    assert sum(r.mapped for r in got.values()) >= 5


def test_host_stage1_oversized_tiles_read_the_host_pool(capsys):
    """With no tile small enough for the device, every tile runs in the
    native library on windows of the round's event pool read on the host."""
    idx = build_index("viral")
    reads = dataset()[1]
    mo = config.MappingOptions()
    config.set_opt("viral", config.IndexOptions(), mo)
    mo.set_flag(F.DTW_EVALUATE_CHAINS)
    eng = MappingEngine(idx, mo, **ENGINE_KW, **JAX_KW | {"stage1_impl": "host"},
                        device="cpu")
    got = {r.read_name: line_of(r) for r in eng.map_reads(reads)}
    eng.close()
    assert eng.counters["dtw_tiles_device"] == 0
    assert eng.counters["dtw_tiles_host_large"] > 0
    want, _ = run(JaxEngine, idx, reads, mo, capsys,
                  **{**JAX_KW, "stage1_impl": "host"})
    assert got == want


def test_stage1_download_carries_the_events():
    """The device stage1 under CIGAR output prepends the (B, ne) event
    block; the codec's unpack reads the host detector's events from it and
    the same seed blocks the hybrid stage1 gives."""
    idx = build_index("viral")
    reads = dataset()[1]
    mo = config.MappingOptions()
    config.set_opt("viral", config.IndexOptions(), mo)
    mo.set_flag(F.DTW_EVALUATE_CHAINS | F.DTW_OUTPUT_CIGAR)
    eng = MappingEngine(idx, mo, device="cpu", stage1_impl="device",
                        **ENGINE_KW)
    assert eng._events_on_host
    ne, L, B = mo.max_events_per_chunk, mo.chunk_size, ENGINE_KW["batch_size"]
    packed_sig = np.zeros((B, L + 1), np.float32)
    packed_ev = np.zeros((B, ne + 2), np.float32)
    host_events = []
    for i, (_name, sig) in enumerate(reads[-B:]):
        part = sig[:L]
        packed_sig[i, : part.size] = part
        packed_sig[i, L] = part.size
        evs = gevents.detect_events_fast(part, mo)[:ne]
        host_events.append(evs)
        packed_ev[i, : evs.size] = evs
        packed_ev[i, ne] = evs.size
    hist_off = np.zeros(B, np.int32)
    hmax = mo.max_num_chunk * ne
    out = eng._stage1_device(packed_sig, torch.zeros((B, hmax)), hist_off)
    plain = eng._stage1(packed_ev, torch.zeros((B, hmax)), hist_off)
    eng.close()
    assert out.shape == (B, ne + plain.shape[1])
    s1 = unpack_stage1(out.numpy(), ne=ne, ns=eng._ns_out, events_on_host=True)
    want = unpack_stage1(plain.numpy(), ne=ne, ns=eng._ns_out,
                         events_on_host=False)
    for i, evs in enumerate(host_events):
        assert int(s1.n_events[i]) == evs.size > 0
        np.testing.assert_array_equal(s1.ev_values[i, : evs.size], evs)
    for g, w in zip(s1[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


def test_expand_bound_is_the_24_bit_tie_break():
    """A read may expand 2**24 anchors (tie-break positions 0 .. 2**24-1)
    and not one more; reads the round does not expand do not count."""
    h_count = np.zeros((3, 256), np.int32)
    h_count[0, :] = 1 << 16  # 2**24 seed hits in one read
    h_count[2, :] = 1 << 16
    need = h_count.sum(axis=1, dtype=np.int64)
    live = np.array([True, True, False])
    tengine.check_expand_bound(need, live)
    need[2] += 1
    tengine.check_expand_bound(need, live)
    need[0] += 1  # one carried anchor on top
    with pytest.raises(RuntimeError, match="slot 0 expands 16777217 anchors"):
        tengine.check_expand_bound(need, live)


def test_round_raises_before_an_overflowing_expansion():
    """The engine's round tail counts hits plus carried anchors and raises
    before it calls the native expansion."""
    idx = build_index("viral")
    mo = config.MappingOptions()
    config.set_opt("viral", config.IndexOptions(), mo)
    eng = MappingEngine(idx, mo, device="cpu", **ENGINE_KW)
    B, ns = ENGINE_KW["batch_size"], 256
    count = np.zeros((B, ns), np.int32)
    count[1, :] = 1 << 16
    z = np.zeros(B, np.int64)
    s1 = tengine.stage1_codec.Stage1Host(
        ev_values=None, lo=np.zeros((B, ns), np.int32),
        qpos=np.zeros((B, ns), np.int32), count=count,
        n_events=np.full(B, 100, np.int64), n_ev_dropped=z,
        n_occ_dropped=z, n_compact_dropped=z,
    )
    slots = [tengine._ReadState(f"r{i}", np.zeros(10, np.float32))
             for i in range(B)]
    carried = {1: (np.zeros(1, np.int64),) * 3}
    gen = eng._round_tail(slots, 0, carried, np.ones(B, bool), s1,
                          lambda phase: None, lambda: None)
    with pytest.raises(RuntimeError, match="slot 1 expands 16777217"):
        next(gen)
    eng.close()


def test_cli_faster_cigar_matches_jax_cli(tmp_path):
    got = _cli_against_jax_cli(tmp_path, ["--dtw-output-cigar"], preset="faster",
                               jax_modes=["--dtw-output-cigar"])
    assert any("\taln:s:" in ln for ln in got)


def test_cli_host_stage1_matches_jax_cli(tmp_path):
    _cli_against_jax_cli(tmp_path, ["--stage1-impl", "host"],
                         jax_modes=["--stage1-impl", "host"])
