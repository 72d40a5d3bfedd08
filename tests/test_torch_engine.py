"""The port's engine against the JAX engine and the golden engine.

Comparisons are exact: stage1 outputs are compared array for array and
PAF lines byte for byte with the mt:f timing tag stripped. The port runs
the same integer and float32 operations as the JAX package in the same
order, so no tolerance is needed — except against the JAX engine's
device event detector, which is float32 where golden (and the port) use
float64: there the tolerance is the one the JAX package holds its own
device engine to (``tests/test_engine_device.py``).
"""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawalign_tpu import cli as jcli
from rawalign_tpu import config
from rawalign_tpu.golden import engine as gengine
from rawalign_tpu.golden import events as gevents
from rawalign_tpu.index import index as dindex
from rawalign_tpu.io import fast5, fasta, paf
from rawalign_tpu.map.engine import MappingEngine as JaxEngine
from rawalign_tpu.map.stage1_codec import unpack_stage1
from rawalign_tpu.pore_model import save_pore_model
from rawalign_tpu.testing import synth
from rawalign_tpu_torch import cli as tcli
from rawalign_tpu_torch import native, runtime
from rawalign_tpu_torch.config import options_from
from rawalign_tpu_torch.index.index import index_from
from rawalign_tpu_torch.io import paf as tpaf
from rawalign_tpu_torch.kernels import build
from rawalign_tpu_torch.map import stage1_codec as tcodec
from rawalign_tpu_torch.map.engine import MappingEngine as _PortEngine

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_KW = dict(batch_size=4, chain_window=2048, max_occ=256, max_anchors=2048)


def _strip_time(line: str) -> str:
    return re.sub(r"mt:f:[0-9.]+", "mt:f:X", line)


def MappingEngine(index, opt, **kw):
    """The port's engine on an index and options built with the JAX
    package, carried into the port's own classes."""
    return _PortEngine(index_from(index), options_from(opt), **kw)


def line_of(res) -> str:
    """A result's PAF line (mt:f stripped) by the formatter of the package
    that made it."""
    fmt = tpaf if isinstance(res, tpaf.MappingResult) else paf
    return _strip_time(fmt.paf_line(res))


@pytest.fixture(autouse=True)
def _need_native():
    if not (native.available() and native.events_available()
            and native.round_tail_available()):
        pytest.skip("native host library not built")


@pytest.fixture(scope="module")
def setup():
    ds = synth.make_dataset(
        seed=11,
        genome_lengths=[12_000, 6_000],
        n_reads=10,
        read_len_bp=(250, 700),
        noise_pa=1.3,
    )
    io = config.IndexOptions()
    mo = config.MappingOptions()
    config.set_opt("viral", io, mo)
    idx = dindex.build_index(ds.seqs, ds.model.pore_vals, io)
    # two pure-noise reads three chunks long: they never map, so they
    # run rounds after the first (carried anchors, the stop decision)
    rng = np.random.default_rng(5)
    reads = [(r.name, r.signal) for r in ds.reads] + [
        (f"noise{k}", rng.normal(95.0, 15.0, 3 * mo.chunk_size).astype(np.float32))
        for k in range(2)
    ]
    return ds, idx, reads


def _opts(use_dtw):
    mo = config.MappingOptions()
    config.set_opt("viral", config.IndexOptions(), mo)
    if use_dtw:
        mo.set_flag(config.MappingFlag.DTW_EVALUATE_CHAINS)
    return mo


@pytest.fixture(scope="module")
def golden(setup):
    """golden(use_dtw) -> {read name: golden PAF line}, computed once."""
    _ds, idx, reads = setup
    cache = {}

    def get(use_dtw):
        if use_dtw not in cache:
            mo = _opts(use_dtw)
            cache[use_dtw] = {
                name: _strip_time(paf.paf_line(gengine.map_read(idx, sig, name, mo)))
                for name, sig in reads
            }
        return cache[use_dtw]

    return get


def _map(engine_cls, idx, reads, use_dtw, **kw):
    """{read name: PAF line} of one engine pass, and the engine."""
    eng = engine_cls(idx, _opts(use_dtw), **{**ENGINE_KW, **kw})
    lines = {r.read_name: line_of(r) for r in eng.map_reads(reads)}
    eng.close()
    return lines, eng


def _port(idx, reads, use_dtw, **kw):
    return _map(MappingEngine, idx, reads, use_dtw, device="cpu",
                dtw_device_max_n=256, dtw_device_max_b=256, **kw)


def _close_to(got: str, want: str) -> bool:
    """The tolerance of tests/test_engine_device.py for an engine whose
    event detector is float32: the read name and every mapping column
    exact, the event-derived read coordinates within 3, the same tags
    with numeric values within 5%."""
    g, w = got.split("\t"), want.split("\t")
    if g[0] != w[0] or g[4:12] != w[4:12]:
        return False
    if any(abs(int(a) - int(b)) > 3 for a, b in zip(g[1:4], w[1:4])):
        return False
    gt = dict(t.split(":", 1) for t in g[12:])
    wt = dict(t.split(":", 1) for t in w[12:])
    if gt.keys() != wt.keys():
        return False
    for k in gt:
        ty, gv = gt[k].split(":", 1)
        _, wv = wt[k].split(":", 1)
        if k != "mt" and ty in ("f", "i"):  # mt: timing, masked to X
            gvf, wvf = float(gv), float(wv)
            if abs(gvf - wvf) > 0.05 * max(abs(gvf), abs(wvf), 1.0):
                return False
        elif gv != wv:
            return False
    return True


def test_stage1_matches_jax_hybrid_stage1(setup):
    """The device half of one round on given events: packed output and
    the event-history append, against the JAX engine's _stage1_hy."""
    _ds, idx, reads = setup
    mo = _opts(False)
    ne = mo.max_events_per_chunk
    jeng = JaxEngine(idx, mo, stage1_impl="hybrid", **ENGINE_KW)
    teng = MappingEngine(idx, mo, device="cpu", **ENGINE_KW)
    B = ENGINE_KW["batch_size"]
    packed = np.zeros((B, ne + 2), np.float32)
    hist_off = np.array([0, 37, 0, 0], np.int32)
    for i, (_name, sig) in enumerate(reads[:3]):
        evs = gevents.detect_events_fast(sig[i * 1000 : i * 1000 + mo.chunk_size], mo)
        packed[i, : evs.size] = evs
        packed[i, ne] = evs.size
    hmax = mo.max_num_chunk * ne
    jout, jhist = jeng._stage1_hy(packed, jnp.zeros((B, hmax), jnp.float32), hist_off)
    thist = torch.zeros((B, hmax))
    tout = teng._stage1(packed, thist, hist_off)
    ns = teng._ns_out
    want = unpack_stage1(np.asarray(jout), ne=ne, ns=ns, events_on_host=False)
    got = tcodec.unpack_stage1(tout.numpy(), ne=ne, ns=ns, events_on_host=False)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(thist.numpy(), np.asarray(jhist))
    assert (got.count > 0).any()
    jeng.close()
    teng.close()


def test_device_stage1_matches_hybrid_stage1(setup):
    """The device stage1 on raw chunks (events detected by the port)
    against the hybrid stage1 on the native detector's events: equal
    packed output and event history, including a dropped-events count."""
    _ds, idx, reads = setup
    mo = _opts(False)
    mo.max_events_per_chunk = 256
    ne, L = mo.max_events_per_chunk, mo.chunk_size
    teng = MappingEngine(idx, mo, device="cpu", stage1_impl="device", **ENGINE_KW)
    B = ENGINE_KW["batch_size"]
    packed_sig = np.zeros((B, L + 1), np.float32)
    packed_ev = np.zeros((B, ne + 2), np.float32)
    hist_off = np.array([0, 37, 0, 0], np.int32)
    for i, (_name, sig) in enumerate(reads[:3]):
        part = sig[i * 1000 : i * 1000 + L]
        packed_sig[i, : part.size] = part
        packed_sig[i, L] = part.size
        evs = gevents.detect_events_fast(part, mo)
        packed_ev[i, : min(evs.size, ne)] = evs[:ne]
        packed_ev[i, ne] = min(evs.size, ne)
        packed_ev[i, ne + 1] = max(evs.size - ne, 0)
    assert packed_ev[:, ne + 1].any()
    hmax = mo.max_num_chunk * ne
    hist_d, hist_h = torch.zeros((B, hmax)), torch.zeros((B, hmax))
    got = teng._stage1_device(packed_sig, hist_d, hist_off)
    want = teng._stage1(packed_ev, hist_h, hist_off)
    assert torch.equal(got, want)
    assert torch.equal(hist_d, hist_h)
    teng.close()


def test_device_stage1_matches_hybrid_and_golden(setup, golden):
    """Device events, the native chain DP and round tail."""
    _ds, idx, reads = setup
    got, eng = _port(idx, reads, True, stage1_impl="device")
    assert eng.stage1_impl == "device" and eng.chain_impl == "native"
    hybrid, heng = _port(idx, reads, True)
    assert got == hybrid
    assert eng.counters == heng.counters
    assert got == golden(True)


@pytest.mark.parametrize("use_dtw", [False, True])
def test_slice_matches_jax_engine_and_golden(setup, use_dtw):
    _ds, idx, reads = setup
    mo = _opts(use_dtw)
    teng = MappingEngine(idx, mo, device="cpu", dtw_device_max_n=256,
                         dtw_device_max_b=256, **ENGINE_KW)
    got = {r.read_name: line_of(r) for r in teng.map_reads(reads)}
    jeng = JaxEngine(idx, mo, stage1_impl="hybrid", **ENGINE_KW)
    jgot = {r.read_name: line_of(r) for r in jeng.map_reads(reads)}
    for name, sig in reads:
        want = _strip_time(paf.paf_line(gengine.map_read(idx, sig, name, mo)))
        assert got[name] == want, (name, want, got[name])
        assert jgot[name] == want, (name, want, jgot[name])
    chunks = [int(re.search(r"ci:i:(\d+)", ln).group(1)) for ln in got.values()]
    assert max(chunks) == 3
    assert any(ln.split("\t")[2] != "*" for ln in got.values())
    if use_dtw:
        assert teng.counters["dtw_tiles_device"] > 0
    teng.close()
    jeng.close()


def test_port_never_imports_jax():
    code = (
        "import sys, numpy as np\n"
        "from rawalign_tpu_torch import config\n"
        "from rawalign_tpu_torch.index import index as dindex\n"
        "from rawalign_tpu_torch.testing import synth\n"
        "from rawalign_tpu_torch.map.engine import MappingEngine\n"
        "import rawalign_tpu_torch.cli\n"
        "ds = synth.make_dataset(seed=3, genome_lengths=[6000], n_reads=1)\n"
        "io, mo = config.IndexOptions(), config.MappingOptions()\n"
        "config.set_opt('viral', io, mo)\n"
        "mo.set_flag(config.MappingFlag.DTW_EVALUATE_CHAINS)\n"
        "idx = dindex.build_index(ds.seqs, ds.model.pore_vals, io)\n"
        "for kw in ({}, dict(stage1_impl='device', chain_impl='device')):\n"
        "    eng = MappingEngine(idx, mo, device='cpu', batch_size=2, **kw)\n"
        "    out = list(eng.map_reads([(ds.reads[0].name, ds.reads[0].signal)]))\n"
        "    assert len(out) == 1 and out[0].mapped\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'rawalign_tpu' not in sys.modules, 'JAX package imported'\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_cuda_device_without_a_card_raises(setup, monkeypatch):
    _ds, idx, _reads = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        runtime.device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        MappingEngine(idx, _opts(True), device="cuda", **ENGINE_KW)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(build, "_libs", {})
    for name in build.KERNELS:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.load(name)


def test_unported_modes_raise(setup):
    """Every mode of the JAX engine is ported; what it refuses, the port
    refuses: the fused stage1+chain on the hybrid stage1 (it needs the
    raw signal on the device)."""
    _ds, idx, _reads = setup
    with pytest.raises(ValueError, match="stage1_impl='device'"):
        MappingEngine(idx, _opts(True), device="cpu", fused=True,
                      stage1_impl="hybrid")


def test_missing_native_library_raises(setup, monkeypatch):
    _ds, idx, _reads = setup
    monkeypatch.setattr(native, "round_tail_available", lambda: False)
    with pytest.raises(RuntimeError, match="native"):
        MappingEngine(idx, _opts(True), device="cpu", chain_impl="native")


@pytest.mark.parametrize("missing,kw", [
    ("events_available", dict(stage1_impl="hybrid")),
    ("chains_from_dp_available", dict(chain_impl="device")),
])
def test_missing_native_piece_raises(setup, monkeypatch, missing, kw):
    """Each placement checks for the native functions it runs."""
    _ds, idx, _reads = setup
    monkeypatch.setattr(native, missing, lambda: False)
    with pytest.raises(RuntimeError, match="native"):
        MappingEngine(idx, _opts(True), device="cpu", **kw)


def test_auto_modes_resolve(setup, monkeypatch):
    """"auto" takes the native placements when the library has them and
    the device ones when it does not, as the JAX engine does."""
    _ds, idx, _reads = setup
    kw = dict(device="cpu", stage1_impl="auto", chain_impl="auto")
    with MappingEngine(idx, _opts(True), **kw) as eng:
        assert (eng.stage1_impl, eng.chain_impl) == ("hybrid", "native")
    monkeypatch.setattr(native, "events_available", lambda: False)
    monkeypatch.setattr(native, "chain_dp_available", lambda: False)
    with MappingEngine(idx, _opts(True), **kw) as eng:
        assert (eng.stage1_impl, eng.chain_impl) == ("device", "device")


def _cli_against_jax_cli(tmp_path, modes, preset="viral", jax_modes=()):
    """The port's CLI with ``modes`` against the JAX CLI with
    ``jax_modes`` (its default path if none), on an index built with
    ``preset``."""
    ds = synth.make_dataset(seed=5, genome_lengths=[10_000], n_reads=6,
                            read_len_bp=(250, 600), noise_pa=1.2)
    fasta.write_fasta(str(tmp_path / "ref.fa"), [(s.name, s.seq) for s in ds.seqs])
    save_pore_model(str(tmp_path / "model.txt"), ds.model)
    fast5.write_fast5(str(tmp_path / "reads.fast5"),
                      [(r.name, r.signal) for r in ds.reads])
    common = ["-x", preset, "--dtw-evaluate-chains", "-t", "1"]
    assert jcli.main(common + ["-p", str(tmp_path / "model.txt"),
                               "-d", str(tmp_path / "ref.idx.npz"),
                               str(tmp_path / "ref.fa")]) == 0
    args = [str(tmp_path / "ref.idx.npz"), str(tmp_path / "reads.fast5")]
    assert jcli.main(common + list(jax_modes) + ["-o", str(tmp_path / "jax.paf")]
                     + args) == 0
    assert tcli.main(common + modes + ["--device", "cpu", "-o",
                                       str(tmp_path / "port.paf")] + args) == 0
    want = [_strip_time(ln) for ln in (tmp_path / "jax.paf").read_text().splitlines()]
    got = [_strip_time(ln) for ln in (tmp_path / "port.paf").read_text().splitlines()]
    assert len(got) == len(ds.reads)
    assert sorted(got) == sorted(want)
    return got


def test_cli_device_cpu_matches_jax_cli(tmp_path):
    _cli_against_jax_cli(tmp_path, [])


def test_cli_all_device_matches_jax_cli(tmp_path):
    _cli_against_jax_cli(
        tmp_path, ["--stage1-impl", "device", "--chain-impl", "device"])
