"""The port's mesh module against the JAX package's: the hash-range
shards of the key table array for array, and the all-to-all routed lookup
against the global searchsorted and the JAX routed step (the one of
``tests/test_dist_engine.py``), on the same hashes. The port's ranks are
logical ranks on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from rawalign_tpu.parallel import mesh as jmesh
from rawalign_tpu_torch.parallel import mesh as pmesh

CPU = torch.device("cpu")


def _keys(kind: str) -> np.ndarray:
    rng = np.random.default_rng(1)
    if kind == "duplicates":  # runs of one hash straddling the naive cuts
        return np.sort(rng.integers(0, 300, 513).astype(np.uint32))
    if kind == "few":  # fewer distinct hashes than shards: empty shards
        return np.sort(rng.integers(0, 3, 40).astype(np.uint32))
    if kind == "wide":  # hashes across the whole uint32 range
        return np.sort(rng.integers(0, 2**32, 1000, dtype=np.uint64)
                       .astype(np.uint32))
    return np.zeros(0, np.uint32)


@pytest.mark.parametrize("kind", ["duplicates", "few", "wide", "empty"])
@pytest.mark.parametrize("n_shard", [1, 2, 4, 8])
def test_shards_equal_the_jax_functions(kind, n_shard):
    keys = _keys(kind)
    rng = np.random.default_rng(2)
    val_id = rng.integers(0, 4, keys.size).astype(np.uint32)
    val_ps = rng.integers(0, 2**32, keys.size, dtype=np.uint64).astype(np.uint32)
    got = pmesh.shard_keys_for_routing(keys, n_shard)
    want = jmesh.shard_keys_for_routing(keys, n_shard)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    got = pmesh.shard_index_by_hash_range(keys, val_id, val_ps, n_shard)
    want = jmesh.shard_index_by_hash_range(keys, val_id, val_ps, n_shard)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if kind == "few" and n_shard == 8:
        assert (got[3][:, 0] == 0xFFFFFFFF).any()  # an empty shard


def _jax_routed(keys, hashes, valid, n_data, n_shard, max_occ):
    """The JAX routed step of tests/test_dist_engine.py, on the virtual
    8-device CPU mesh."""
    mesh = jmesh.make_mesh(n_data, n_shard)
    keys_sh, n_real, offs, cut_starts = jmesh.shard_keys_for_routing(
        keys, n_shard)
    S, NS = n_shard, hashes.shape[1]
    cut_starts_j = jnp.asarray(cut_starts)

    def step(h, v, ksh, nr, off):
        b = h.shape[0]
        owner = jnp.clip(
            jnp.searchsorted(cut_starts_j, h.reshape(-1), side="right")
            .astype(jnp.int32) - 1, 0, S - 1).reshape(h.shape)
        dest = jax.lax.broadcasted_iota(jnp.int32, (S, b, NS), 0)
        routed = jnp.where((owner[None] == dest) & v[None], h[None],
                           jnp.uint32(0xFFFFFFFF))
        routed = jax.lax.all_to_all(routed, "shard", split_axis=0,
                                    concat_axis=0)
        flat = routed.reshape(-1)
        lo = jnp.searchsorted(ksh[0], flat, side="left").astype(jnp.int32)
        hi = jnp.searchsorted(ksh[0], flat, side="right").astype(jnp.int32)
        hi = jnp.minimum(hi, nr[0])
        cnt = jnp.maximum(hi - lo, 0).reshape(S, b, NS)
        glo = (lo + off[0]).reshape(S, b, NS)
        back = jax.lax.all_to_all(jnp.stack([glo, cnt], axis=1), "shard",
                                  split_axis=0, concat_axis=0)
        glo_b = jnp.take_along_axis(back[:, 0], owner[None], axis=0)[0]
        cnt_b = jnp.take_along_axis(back[:, 1], owner[None], axis=0)[0]
        cnt_b = jnp.where(v & (cnt_b <= max_occ), cnt_b, 0)
        return glo_b, cnt_b

    f = jax.jit(jax.shard_map(
        step, mesh=mesh,
        in_specs=(P(("data", "shard"), None), P(("data", "shard"), None),
                  P("shard", None), P("shard"), P("shard")),
        out_specs=(P(("data", "shard"), None), P(("data", "shard"), None)),
        check_vma=False,
    ))
    glo, cnt = f(hashes, valid, keys_sh, n_real, offs)
    return np.asarray(glo), np.asarray(cnt)


@pytest.mark.parametrize("layout", [(4, 2), (2, 4), (1, 8)])
def test_routed_lookup_equals_global_lookup_and_jax(layout):
    rng = np.random.default_rng(1)
    keys = _keys("duplicates")
    B, NS, max_occ = 16, 24, 4
    hashes = rng.integers(0, 330, (B, NS)).astype(np.uint32)
    valid = rng.random((B, NS)) < 0.8
    lo_g = np.searchsorted(keys, hashes, side="left")
    cnt_g = np.searchsorted(keys, hashes, side="right") - lo_g

    mesh = pmesh.make_mesh(*layout, devices=[CPU] * 8)
    rk = pmesh.routing_keys(mesh, keys)
    b = B // mesh.size
    h_t = torch.from_numpy(hashes.astype(np.int64))
    v_t = torch.from_numpy(valid)
    glo, cnt, sent = pmesh.routed_lookup(
        mesh, rk, [h_t[r * b : (r + 1) * b] for r in range(mesh.size)],
        [v_t[r * b : (r + 1) * b] for r in range(mesh.size)])
    glo = torch.cat(glo).numpy()
    cnt = torch.cat(cnt).numpy()
    assert glo.dtype == cnt.dtype == np.int32
    S = layout[1]
    # both grids, the slabs for the other S - 1 columns, 8 bytes a seed
    assert sent == mesh.size * (S - 1) * b * NS * (8 + 8)
    # every valid seed gets its global count, whatever its owner
    np.testing.assert_array_equal(np.where(valid, cnt, 0),
                                  np.where(valid, cnt_g, 0))
    hit = valid & (cnt_g > 0)
    assert hit.sum() > 100
    np.testing.assert_array_equal(glo[hit], lo_g[hit])

    jglo, jcnt = _jax_routed(keys, hashes, valid, *layout, max_occ)
    capped = np.where(valid & (cnt <= max_occ), cnt, 0)
    np.testing.assert_array_equal(capped, jcnt)
    sel = jcnt > 0
    np.testing.assert_array_equal(glo[sel], jglo[sel])


def test_all_to_all_moves_slab_j_of_rank_s_to_rank_j():
    mesh = pmesh.make_mesh(2, 3, devices=[CPU] * 6)
    grids = [torch.arange(3)[:, None] * 10 + r for r in range(6)]
    out = pmesh.all_to_all(mesh, grids)
    for r in range(6):
        d, s = divmod(r, 3)
        want = torch.tensor([[s * 10 + d * 3 + j] for j in range(3)])
        assert torch.equal(out[r], want)


def test_make_mesh_over_cpu_and_its_refusals(monkeypatch):
    mesh = pmesh.make_mesh(2, 4, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 2, "shard": 4}
    assert mesh.size == 8 and mesh.ranks == [CPU] * 8
    assert mesh.distinct == [CPU]
    assert mesh.axis_names == ("data", "shard")
    with pytest.raises(ValueError, match="needs 8 devices, 4 given"):
        pmesh.make_mesh(2, 4, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="at least one rank"):
        pmesh.make_mesh(0, 1, devices=[CPU])
    # without devices: the visible cards, never fewer than the ranks
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices, 2 visible"):
        pmesh.make_mesh(2, 2)
    mesh = pmesh.make_mesh(1, 2)
    assert mesh.ranks == [torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs 1 CUDA devices, 0 visible"):
        pmesh.make_mesh(1, 1)
