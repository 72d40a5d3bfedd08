"""The port's replicate-and-sum mapping step (``parallel/mesh.py:
build_mapping_step``) and its dense seed query (``index/query.py:
query_seeds``) against the JAX package's, on the dataset of
``tests/test_multichip.py``, over logical ranks on the CPU.

``query_seeds`` is compared exactly on the same hashes. The step must
give the same arrays on every mesh layout as on one rank, exactly, as
the JAX package's own test asks of it. Its events are the host C
detector's bit for bit. Against the JAX step only the events are
compared, with a tolerance: the JAX detector is float32 where the
port's follows the host C one in float64, so their seeds and anchors
differ where the events do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawalign_tpu import config
from rawalign_tpu.index import index as dindex
from rawalign_tpu.index import query as jquery
from rawalign_tpu.parallel import mesh as jmesh
from rawalign_tpu.testing import synth
from rawalign_tpu_torch import native
from rawalign_tpu_torch.config import options_from
from rawalign_tpu_torch.index import query as tquery
from rawalign_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

CPU = torch.device("cpu")
MAX_OCC, MAX_ANCHORS = 16, 512


@pytest.fixture(scope="module")
def setup():
    ds = synth.make_dataset(seed=21, genome_lengths=[8_000], n_reads=8,
                            read_len_bp=(250, 450), noise_pa=1.2)
    io, mo = config.IndexOptions(), config.MappingOptions()
    config.set_opt("viral", io, mo)
    mo.max_events_per_chunk = 512
    idx = dindex.build_index(ds.seqs, ds.model.pore_vals, io)
    B, L = 8, mo.chunk_size
    chunks = np.zeros((B, L), dtype=np.float32)
    lengths = np.zeros(B, dtype=np.int32)
    for i in range(B):
        sig = ds.reads[i].signal[:L]
        chunks[i, : sig.size] = sig
        lengths[i] = sig.size
    return idx, io, mo, chunks, lengths


def _port_step(setup, layout):
    idx, io, mo, chunks, lengths = setup
    mesh = pmesh.make_mesh(*layout, devices=[CPU] * (layout[0] * layout[1]))
    tables = pmesh.shard_index_by_hash_range(idx.keys, idx.val_id, idx.val_ps,
                                             layout[1])
    step = pmesh.build_mapping_step(mesh, io_opt=io, mo_opt=options_from(mo),
                                    max_occ=MAX_OCC, max_anchors=MAX_ANCHORS)
    return step(chunks, lengths, *tables)


@pytest.fixture(scope="module")
def one_rank(setup):
    return _port_step(setup, (1, 1))


def test_query_seeds_equals_jax():
    rng = np.random.default_rng(3)
    keys = np.sort(rng.integers(0, 400, 900).astype(np.uint32))
    keys[-5:] = 0xFFFFFFFF  # the shards' padding value
    val_id = rng.integers(0, 3, keys.size).astype(np.uint32)
    val_ps = rng.integers(0, 2**32, keys.size, dtype=np.uint64).astype(np.uint32)
    hashes = rng.integers(0, 420, (6, 40)).astype(np.uint32)
    hashes[0, :3] = 0xFFFFFFFF
    qpos = rng.integers(0, 500, (6, 40)).astype(np.int32)
    valid = rng.random((6, 40)) < 0.8
    want = jquery.query_seeds(jnp.asarray(keys), jnp.asarray(val_id),
                              jnp.asarray(val_ps), jnp.asarray(hashes),
                              jnp.asarray(qpos), jnp.asarray(valid), max_occ=4)
    t = lambda x: torch.from_numpy(x.astype(np.int64))  # noqa: E731
    got = tquery.query_seeds(t(keys), t(val_id), t(val_ps), t(hashes),
                             torch.from_numpy(qpos), torch.from_numpy(valid),
                             max_occ=4)
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.valid.any() and got.n_dropped.sum() > 0


@pytest.mark.parametrize("layout", [(8, 1), (4, 2), (2, 4)])
def test_step_equals_one_rank(setup, one_rank, layout):
    got = _port_step(setup, layout)
    for k, (g, w) in enumerate(zip(got, one_rank)):
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=str(k))
    _ev, n_ev, seg, _t, _q, scores, _p = got
    assert (n_ev > 0).all()
    assert (seg[:, 0] != 0x7FFFFFFF).sum() >= 6  # reads with anchors
    assert scores.max() > 0


def test_step_events_equal_native_and_match_jax_step(setup, one_rank):
    """The step's events are the host C detector's bit for bit (z-norm
    over all of a chunk's events, then the first ``ne`` kept). Against
    the JAX step: every row's count within 2, and at least 6 of the 8
    rows with 99.5% of their values within 1e-4. Two rows differ beyond
    that, on the JAX side: read 0 has more than ``ne`` events and the JAX
    detector z-normalises only the kept ones, and on read 4 its float32
    arithmetic shifts the whole row (both rows equal native here)."""
    idx, io, mo, chunks, lengths = setup
    ev, n = one_rank[:2]
    for i in range(n.size):
        want = native.detect_events(
            chunks[i, : lengths[i]], w1=mo.window_length1,
            w2=mo.window_length2, threshold1=mo.threshold1,
            threshold2=mo.threshold2, peak_height=mo.peak_height,
        )[: mo.max_events_per_chunk]
        np.testing.assert_array_equal(ev[i, : n[i]], want)
    mesh = jmesh.make_mesh(4, 2)
    tables = jmesh.shard_index_by_hash_range(idx.keys, idx.val_id, idx.val_ps, 2)
    step = jmesh.build_mapping_step(mesh, io_opt=io, mo_opt=mo,
                                    max_occ=MAX_OCC, max_anchors=MAX_ANCHORS)
    jev, jn = (np.asarray(x) for x in step(chunks, lengths, *tables)[:2])
    rows_close = 0
    for i in range(n.size):
        got, want = ev[i, : n[i]], jev[i, : jn[i]]
        assert abs(got.size - want.size) <= 2, (i, got.size, want.size)
        if got.size == want.size:
            rows_close += np.sum(np.abs(got - want) < 1e-4) >= 0.995 * got.size
    assert rows_close >= 6
