"""The port's distributed engine against its single-card engine and the
JAX package's engines, on the dataset of ``tests/test_dist_engine.py``
(with its pure-noise read), over logical ranks on the CPU.

PAF lines are compared byte for byte (mt:f stripped), except against the
JAX engine's float32 device event detector (see
``test_device_stage1_equals_single_engine_and_the_jax_detectors``). The
JAX engines run
their DTW tiles in the native library (bit-identical to their device
DTW, which the JAX package's own tests pin), sparing the Pallas DTW's
compiles in interpret mode.
"""

import re

import numpy as np
import pytest
import torch

from rawalign_tpu import config
from rawalign_tpu.config import MappingFlag
from rawalign_tpu.index import index as dindex
from rawalign_tpu.io import paf
from rawalign_tpu.map.engine import MappingEngine as JaxEngine
from rawalign_tpu.parallel import mesh as jmesh
from rawalign_tpu.parallel.dist_engine import (
    DistributedMappingEngine as JaxDistEngine,
)
from rawalign_tpu.testing import synth
from rawalign_tpu_torch import native
from rawalign_tpu_torch.config import options_from
from rawalign_tpu_torch.golden import events as gevents
from rawalign_tpu_torch.index.index import index_from
from rawalign_tpu_torch.io import paf as tpaf
from rawalign_tpu_torch.map import stage1_codec as tcodec
from rawalign_tpu_torch.map.engine import MappingEngine as PortEngine
from rawalign_tpu_torch.parallel import mesh as pmesh
from rawalign_tpu_torch.parallel.dist_engine import DistributedMappingEngine

torch.set_num_threads(1)

CPU = torch.device("cpu")
#: the JAX engines' DTW tiles all run in the native library
JAX_DTW_ON_HOST = dict(dtw_device_max_n=0, dtw_device_max_b=0)
#: the port's engines on the CPU: tiles up to 256 in the plain round
PORT_KW = dict(device="cpu", dtw_device_max_n=256, dtw_device_max_b=256)


def _strip_mt(line: str) -> str:
    return re.sub(r"\tmt:f:[^\t]*", "", line)


@pytest.fixture(autouse=True)
def _need_native():
    if not (native.available() and native.events_available()):
        pytest.skip("native host library not built")


@pytest.fixture(scope="module")
def setup():
    ds = synth.make_dataset(seed=7, genome_lengths=[12000, 6000], n_reads=12,
                            read_len_bp=(150, 350))
    io, mo = config.IndexOptions(), config.MappingOptions()
    config.set_opt("viral", io, mo)
    mo.set_flag(MappingFlag.DTW_EVALUATE_CHAINS)
    mo.max_events_per_chunk = 256
    idx = dindex.build_index(ds.seqs, ds.model.pore_vals, io)
    reads = [(r.name, r.signal) for r in ds.reads]
    rng = np.random.default_rng(0)
    reads.append(("noise", rng.normal(95, 15, 9000).astype(np.float32)))
    return idx, mo, index_from(idx), options_from(mo), reads


def _lines(eng, reads) -> list[str]:
    fmt = tpaf if isinstance(eng, PortEngine) else paf
    with eng:
        return sorted(_strip_mt(fmt.paf_line(r)) for r in eng.map_reads(reads))


def _cpu_mesh(layout):
    return pmesh.make_mesh(*layout, devices=[CPU] * (layout[0] * layout[1]))


@pytest.fixture(scope="module")
def single(setup):
    """single(stage1_impl) -> the port's single-card PAF, computed once."""
    _idx, _mo, tidx, tmo, reads = setup
    cache = {}

    def get(s1):
        if s1 not in cache:
            cache[s1] = _lines(PortEngine(tidx, tmo, batch_size=16,
                                          stage1_impl=s1, **PORT_KW), reads)
        return cache[s1]

    return get


@pytest.mark.parametrize("layout", [(4, 2), (2, 4)])
def test_paf_equals_single_engines(setup, single, layout):
    idx, mo, tidx, tmo, reads = setup
    eng = DistributedMappingEngine(tidx, tmo, _cpu_mesh(layout), batch_size=16,
                                   **PORT_KW)
    assert eng.stage1_impl == "hybrid" and eng.chain_impl == "device"
    got = _lines(eng, reads)
    assert got == single("hybrid")
    assert got == _lines(JaxEngine(idx, mo, batch_size=16, **JAX_DTW_ON_HOST),
                         reads)
    mapped = {ln.split("\t")[0] for ln in got if ln.split("\t")[5] != "*"}
    assert mapped == {name for name, _ in reads} - {"noise"}


def test_paf_equals_jax_distributed_engine(setup):
    idx, mo, tidx, tmo, reads = setup
    got = _lines(DistributedMappingEngine(tidx, tmo, _cpu_mesh((4, 2)),
                                          batch_size=16, **PORT_KW), reads)
    want = _lines(JaxDistEngine(idx, mo, jmesh.make_mesh(4, 2), batch_size=16,
                                **JAX_DTW_ON_HOST), reads)
    assert got == want


def test_device_stage1_equals_single_engine_and_the_jax_detectors(
        setup, single):
    """The device stage1 on (4, 2): byte for byte the port's single-card
    device stage1 and the JAX engine's hybrid one (the port's device
    events follow the host C detector bit for bit). Against the JAX
    float32 device detector every read maps to the same reference and
    strand with the same MAPQ. ``_close_to`` does not hold on this
    dataset (5 of 13 lines differ beyond it, up to 30 positions and cm:i
    21 against 93 on synth_read4): its 256-event cap drops events, and
    the JAX device detector z-normalises only the kept events where the
    host C one (and the port) z-normalises all of them before the cap;
    on one read its float32 arithmetic shifts the whole row
    (``test_torch_dist_step.py``)."""
    idx, mo, tidx, tmo, reads = setup
    eng = DistributedMappingEngine(tidx, tmo, _cpu_mesh((4, 2)), batch_size=16,
                                   stage1_impl="device", **PORT_KW)
    got = _lines(eng, reads)
    assert got == single("device")
    assert got == _lines(JaxEngine(idx, mo, batch_size=16, stage1_impl="hybrid",
                                   **JAX_DTW_ON_HOST), reads)
    want = _lines(JaxEngine(idx, mo, batch_size=16, stage1_impl="device",
                            **JAX_DTW_ON_HOST), reads)
    n_same = 0
    for line, w in zip(got, want):
        g, w = line.split("\t"), w.split("\t")
        n_same += g == w
        assert g[0] == w[0] and g[4:6] == w[4:6] and g[11] == w[11], (w, g)
    assert n_same >= len(got) // 2


def _first_chunks(ds_reads, B, opt):
    """(B, L+1) raw chunks | lengths of the first B reads, and their
    native events as (B, ne+2) values | n_events | n_dropped."""
    L, ne = opt.chunk_size, opt.max_events_per_chunk
    sig = np.zeros((B, L + 1), np.float32)
    for i, (_name, s) in enumerate(ds_reads[:B]):
        part = s[:L]
        sig[i, : part.size] = part
        sig[i, L] = part.size
    ev = np.zeros((B, ne + 2), np.float32)
    for i in range(B):
        e = gevents.detect_events_fast(sig[i, : int(sig[i, L])], opt)
        ev[i, : min(e.size, ne)] = e[:ne]
        ev[i, ne] = min(e.size, ne)
        ev[i, ne + 1] = max(e.size - ne, 0)
    return sig, ev


@pytest.mark.parametrize("s1", ["hybrid", "device"])
def test_routed_stage1_equals_single_card_stage1(s1):
    """The routed stage1 (all-to-all lookup) unpacks to the single-card
    stage1's counts and scalars, and its lo and qpos where the count is
    positive (tests/test_stage1_codec.py's cross-engine bar)."""
    ds = synth.make_dataset(seed=11, genome_lengths=[9000, 5000], n_reads=8,
                            read_len_bp=(150, 300))
    io, mo = config.IndexOptions(), config.MappingOptions()
    config.set_opt("viral", io, mo)
    mo.set_flag(MappingFlag.DTW_OUTPUT_CIGAR)
    mo.max_events_per_chunk = 256
    tidx = index_from(dindex.build_index(ds.seqs, ds.model.pore_vals, io))
    tmo = options_from(mo)
    B, ne = 8, tmo.max_events_per_chunk
    sig, ev = _first_chunks([(r.name, r.signal) for r in ds.reads], B, tmo)
    off = np.zeros(B, np.int32)

    eng1 = PortEngine(tidx, tmo, batch_size=B, stage1_impl=s1, **PORT_KW)
    eng2 = DistributedMappingEngine(tidx, tmo, _cpu_mesh((2, 4)), batch_size=B,
                                    stage1_impl=s1, **PORT_KW)
    hist = torch.zeros((B, eng1._hmax))
    if s1 == "device":
        out1, out2 = (e._stage1_device(sig, hist, off) for e in (eng1, eng2))
    else:
        out1, out2 = (e._stage1(ev, hist, off) for e in (eng1, eng2))
    # the single card's device stage1 carries the events for CIGAR, as
    # the distributed one does; neither hybrid download does
    assert eng1._s1_dl_events == eng2._s1_dl_events == (s1 == "device")
    a, b = (tcodec.unpack_stage1(o.numpy(), ne=ne, ns=e._ns_out,
                                 events_on_host=e._s1_dl_events)
            for o, e in ((out1, eng1), (out2, eng2)))
    np.testing.assert_array_equal(b.count, a.count)
    used = a.count > 0
    assert used.sum() > 50
    np.testing.assert_array_equal(b.lo[used], a.lo[used])
    np.testing.assert_array_equal(b.qpos[used], a.qpos[used])
    for f in ("n_events", "n_ev_dropped", "n_occ_dropped", "n_compact_dropped"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    if s1 == "device":
        np.testing.assert_array_equal(b.ev_values, a.ev_values)
    else:
        assert a.ev_values is None and b.ev_values is None
    eng1.close()
    eng2.close()


def test_hybrid_rounds_append_each_reads_events_once(setup):
    """The hybrid stage1 detects the events on the host and appends them
    there; its download carries none, so the round does not append them
    again (the distributed engine reads every event from the host)."""
    _idx, _mo, tidx, tmo, reads = setup
    eng = DistributedMappingEngine(tidx, tmo, _cpu_mesh((2, 2)), batch_size=8,
                                   **PORT_KW)
    assert eng._events_on_host and not eng._s1_dl_events
    seen = {}
    emit = eng._emit

    def check(st):
        seen[st.name] = (st.events.size, st.ev_total, st.chunks_done)
        return emit(st)

    eng._emit = check
    with eng:
        list(eng.map_reads(reads))
    assert len(seen) == len(reads)
    assert all(n == total > 0 for n, total, _ in seen.values())
    assert max(c for _, _, c in seen.values()) >= 2  # the noise read


def test_constructor_rounds_the_batch_and_refuses_the_host_stage1(setup):
    _idx, _mo, tidx, tmo, _reads = setup
    mesh = _cpu_mesh((4, 2))
    with DistributedMappingEngine(tidx, tmo, mesh, batch_size=10,
                                  **PORT_KW) as eng:
        assert eng.batch_size == 16 and eng._b_loc == 2
        assert eng.device == CPU and eng.mesh is mesh
        assert set(eng._ref_cat_dev) == {CPU}
        assert eng._python_tail
    with pytest.raises(ValueError, match="device|hybrid"):
        DistributedMappingEngine(tidx, tmo, mesh, stage1_impl="host", **PORT_KW)
