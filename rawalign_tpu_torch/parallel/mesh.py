"""Multi-card execution: the mesh, the index's hash-range shards, the
all-to-all seed routing and the replicate-and-sum mapping step (port of
rawalign_tpu/parallel/mesh.py).

The JAX package scales over a ``jax.sharding.Mesh`` with two axes, driven
by one process: ``shard_map`` runs one body on every device and
``lax.all_to_all``/``psum`` move data between them.

  data  — read-level data parallelism: each rank maps its rows of the
          read batch;
  shard — index parallelism: the sorted seed table is cut into
          contiguous hash ranges, one per shard column, and every hash
          has exactly one owner.

The port keeps that shape. A :class:`Mesh` is a (data, shard) grid of
``torch.device``s driven by one Python process. Rank ``r = d * S + s``
holds rows ``[r * b_loc, (r + 1) * b_loc)`` of a batch (the row-major
flattening of ``P(("data", "shard"))``), and each rank's work is launched
on its own device's current stream. The all-to-all over the shard axis
is peer copies (``Tensor.to(dst, non_blocking=True)``, NVLink between the
cards of one host); PyTorch's cross-device copy orders the two devices'
streams. A mesh may name a device more than once: logical ranks on the
CPU in the tests, or on one card. ``torch.distributed`` serves only the
multi-host layer (``distributed.py``), each host driving its own mesh.
One process per card with NCCL is not used: NCCL refuses two ranks on
one card, and the round loop would become a controller/worker protocol
the JAX engine does not have.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from rawalign_tpu_torch import runtime
from rawalign_tpu_torch.index import query
from rawalign_tpu_torch.map import chain
from rawalign_tpu_torch.seeds import sketch
from rawalign_tpu_torch.signal import events

#: the hash a routed grid carries where a seed is not for that owner
DEAD = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, shard) grid of devices; ``devices[d][s]`` is rank d*S + s."""

    devices: tuple[tuple[torch.device, ...], ...]
    axis_names = ("data", "shard")

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "shard": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def ranks(self) -> list[torch.device]:
        """The device of every rank, in rank order."""
        return [dev for row in self.devices for dev in row]

    @property
    def distinct(self) -> list[torch.device]:
        """Each device once, in order of its first rank."""
        return list(dict.fromkeys(self.ranks))


def make_mesh(n_data: int, n_shard: int = 1, devices=None) -> Mesh:
    """A (n_data, n_shard) mesh over ``devices`` (the first n_data *
    n_shard of them, which may repeat), by default over ``cuda:0 ..
    cuda:n-1``. Raises when fewer devices (without ``devices``: visible
    cards) are there than ranks: the mesh never repeats a card or falls
    back to the CPU by itself."""
    n = n_data * n_shard
    if n_data < 1 or n_shard < 1:
        raise ValueError(f"mesh ({n_data}, {n_shard}) needs at least one rank "
                         "on each axis")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(f"a ({n_data}, {n_shard}) mesh needs {n} CUDA "
                               f"devices, {have} visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    if len(devices) < n:
        raise ValueError(f"a ({n_data}, {n_shard}) mesh needs {n} devices, "
                         f"{len(devices)} given")
    devs = [runtime.device(d) for d in devices[:n]]
    return Mesh(tuple(tuple(devs[d * n_shard : (d + 1) * n_shard])
                      for d in range(n_data)))


def _hash_range_cuts(keys: np.ndarray, n_shard: int) -> list[int]:
    """Cut points of the sorted key table into n_shard contiguous ranges,
    aligned to key-value boundaries so every hash has one owner."""
    S = keys.shape[0]
    per = -(-max(S, 1) // n_shard)
    cuts = [0]
    for s in range(1, n_shard):
        c = min(s * per, S)
        if 0 < c < S:
            c = int(np.searchsorted(keys, keys[c], side="left"))
        cuts.append(c)
    cuts.append(S)
    return cuts


def shard_index_by_hash_range(keys, val_id, val_ps, n_shard: int):
    """Partition the sorted seed table into n_shard contiguous key ranges,
    padded to equal length. Returns (keys_sh, id_sh, ps_sh, bounds) where
    arrays have shape (n_shard, S_pad) and bounds (n_shard, 2) holds each
    shard's inclusive [lo, hi] hash range (0xFFFFFFFF, 0 for an empty
    shard)."""
    cuts = _hash_range_cuts(keys, n_shard)
    width = max(max(cuts[s + 1] - cuts[s] for s in range(n_shard)), 1)
    keys_sh = np.full((n_shard, width), np.uint32(DEAD), dtype=np.uint32)
    id_sh = np.zeros((n_shard, width), dtype=np.uint32)
    ps_sh = np.zeros((n_shard, width), dtype=np.uint32)
    bounds = np.zeros((n_shard, 2), dtype=np.uint32)
    for s in range(n_shard):
        lo, hi = cuts[s], cuts[s + 1]
        m = hi - lo
        if m > 0:
            keys_sh[s, :m] = keys[lo:hi]
            id_sh[s, :m] = val_id[lo:hi]
            ps_sh[s, :m] = val_ps[lo:hi]
            bounds[s, 0] = keys[lo]
            bounds[s, 1] = keys[hi - 1]
        else:
            bounds[s, 0] = np.uint32(DEAD)
            bounds[s, 1] = 0
    return keys_sh, id_sh, ps_sh, bounds


def shard_keys_for_routing(keys: np.ndarray, n_shard: int):
    """Partition only the sorted key table for the all-to-all seed routing
    (the index values never leave the host: owners answer with (global
    lo, count) into the host position arrays).

    Returns (keys_sh, n_real, offsets, cut_starts):
      keys_sh    (S, W) uint32 — contiguous key ranges, 0xFFFFFFFF-padded
      n_real     (S,)   int32  — real keys per shard (the lookup's hi is
                                 clipped to it so padding never counts)
      offsets    (S,)   int32  — global index of each shard's first key
      cut_starts (S,)   uint32 — first key value per shard; the owner of
                                 hash h is searchsorted(cut_starts, h,
                                 'right') - 1. Empty shards inherit the
                                 next shard's start so routing skips them.
    """
    cuts = _hash_range_cuts(keys, n_shard)
    width = max(max(cuts[s + 1] - cuts[s] for s in range(n_shard)), 1)
    keys_sh = np.full((n_shard, width), np.uint32(DEAD), dtype=np.uint32)
    n_real = np.zeros(n_shard, dtype=np.int32)
    offsets = np.zeros(n_shard, dtype=np.int32)
    cut_starts = np.full(n_shard, np.uint32(DEAD), dtype=np.uint32)
    for s in range(n_shard):
        lo, hi = cuts[s], cuts[s + 1]
        m = hi - lo
        n_real[s] = m
        offsets[s] = lo
        if m > 0:
            keys_sh[s, :m] = keys[lo:hi]
            cut_starts[s] = keys[lo]
    for s in range(n_shard - 2, -1, -1):  # empty shards: inherit next
        if n_real[s] == 0:
            cut_starts[s] = cut_starts[s + 1]
    return keys_sh, n_real, offsets, cut_starts


def all_to_all(mesh: Mesh, grids: list[torch.Tensor]) -> list[torch.Tensor]:
    """All-to-all over the shard axis of each data row: ``grids[r]`` is
    rank r's (S, ...) tensor on its device, slab j for shard column j.
    Returns ``out`` with ``out[d*S + s][j] = grids[d*S + j][s]`` on rank
    d*S + s's device (``lax.all_to_all(split_axis=0, concat_axis=0)``)."""
    S = mesh.shape["shard"]
    out = []
    for r, dev in enumerate(mesh.ranks):
        d, s = divmod(r, S)
        out.append(torch.stack([grids[d * S + j][s].to(dev, non_blocking=True)
                                for j in range(S)]))
    return out


class RoutingKeys(NamedTuple):
    """Each rank's routing state on its device: the owner cut starts and
    its shard column's key range."""

    cut_starts: list[torch.Tensor]  # (S,) int64 per rank
    keys: list[torch.Tensor]  # (W,) int64 per rank, 0xFFFFFFFF-padded
    n_real: list[int]
    offsets: list[int]


def routing_keys(mesh: Mesh, keys: np.ndarray) -> RoutingKeys:
    """Cut the sorted key table over the mesh's shard axis and place each
    rank's part on its device (one copy per rank of the key range its
    shard column owns)."""
    S = mesh.shape["shard"]
    keys_sh, n_real, offsets, cut_starts = shard_keys_for_routing(
        np.asarray(keys, dtype=np.uint32), S)
    cs, ks = {}, {}
    out = RoutingKeys([], [], [], [])
    for r, dev in enumerate(mesh.ranks):
        s = r % S
        if dev not in cs:
            cs[dev] = runtime.put(cut_starts.astype(np.int64), dev)
        if (dev, s) not in ks:
            ks[(dev, s)] = runtime.put(keys_sh[s].astype(np.int64), dev)
        out.cut_starts.append(cs[dev])
        out.keys.append(ks[(dev, s)])
        out.n_real.append(int(n_real[s]))
        out.offsets.append(int(offsets[s]))
    return out


def routed_lookup(mesh: Mesh, rk: RoutingKeys, hashes: list[torch.Tensor],
                  valid: list[torch.Tensor]):
    """The all-to-all routed lookup. ``hashes[r]``/``valid[r]`` (b, NS)
    int64 (uint32 values) and bool are rank r's seeds on its device.
    Every rank sends one masked (S, b, NS) hash grid, one slab per owner;
    each owner searches its own key range and answers with (global lo,
    count); a second all-to-all brings the answers home, where each seed
    takes its owner's. Returns ([glo], [count], bytes sent between ranks),
    int32 (b, NS) per rank: ``count`` equals the global
    ``searchsorted(keys, h, 'right') - searchsorted(keys, h, 'left')``
    for a valid seed, and ``glo`` the global 'left' position where the
    count is positive."""
    S = mesh.shape["shard"]
    owners, grids = [], []
    for r, (h, v) in enumerate(zip(hashes, valid)):
        owner = (torch.searchsorted(rk.cut_starts[r], h, right=True) - 1
                 ).clamp(0, S - 1)
        dest = torch.arange(S, device=h.device)[:, None, None]
        grids.append(torch.where((owner[None] == dest) & v[None], h[None], DEAD))
        owners.append(owner)
    answers = []
    for r, got in enumerate(all_to_all(mesh, grids)):
        keys = rk.keys[r]
        lo = torch.searchsorted(keys, got)
        hi = torch.searchsorted(keys, got, right=True).clamp(max=rk.n_real[r])
        cnt = (hi - lo).clamp(min=0)
        answers.append(torch.stack([lo + rk.offsets[r], cnt], dim=1)
                       .to(torch.int32))
    glo, cnt = [], []
    for owner, back in zip(owners, all_to_all(mesh, answers)):
        idx = owner[None, None].expand(1, 2, *owner.shape)
        mine = back.gather(0, idx)[0]
        glo.append(mine[0])
        cnt.append(mine[1])
    # the slabs that left their rank, both ways
    sent = sum((g.numel() - g[0].numel()) * g.element_size() for g in grids)
    sent += sum((a.numel() - a[0].numel()) * a.element_size() for a in answers)
    return glo, cnt, sent


def build_mapping_step(mesh: Mesh, *, io_opt, mo_opt, max_occ: int = 16,
                       max_anchors: int = 1024):
    """The replicate-and-sum mapping step of one chunk over the mesh
    (rawalign_tpu/parallel/mesh.py:build_mapping_step): events, sketch,
    each shard rank's dense hit lists of its own key range, a sum over
    the shard ranks of each data row (each hash has one owner, so the
    masked parts are disjoint), then the seg-major anchor sort, the cap
    and the chain DP (window 64).

    Returns ``step(chunks, lengths, keys_sh, id_sh, ps_sh, bounds)`` on
    numpy arrays — chunks (B, L) f32 and lengths (B,) split over the data
    axis, the tables of ``shard_index_by_hash_range`` over the shard
    axis — giving numpy (event values, event counts, seg, target, query,
    scores, preds), rows in batch order. The events and seeds of a data
    row are computed on each of its shard ranks, as under ``shard_map``;
    the sum and what follows it run once, on the row's first rank."""
    ne = mo_opt.max_events_per_chunk
    D, S = mesh.shape["data"], mesh.shape["shard"]

    def step(chunks, lengths, keys_sh, id_sh, ps_sh, bounds):
        B = chunks.shape[0]
        if B % D:
            raise ValueError(f"batch {B} does not split over {D} data rows")
        b = B // D
        outs = []
        for d in range(D):
            rows = slice(d * b, (d + 1) * b)
            parts = []
            for s, dev in enumerate(mesh.devices[d]):
                ev = events.detect_events_batch(
                    runtime.put(chunks[rows], dev),
                    runtime.put(lengths[rows].astype(np.int32), dev),
                    w1=mo_opt.window_length1, w2=mo_opt.window_length2,
                    threshold1=mo_opt.threshold1,
                    threshold2=mo_opt.threshold2,
                    peak_height=mo_opt.peak_height, max_events=ne,
                )
                seeds = sketch.sketch_events_batch(
                    ev.values, ev.n_events, e=io_opt.e, q=io_opt.q,
                    lq=io_opt.lq)
                hits = query.query_seeds(
                    *(runtime.put(x[s].astype(np.int64), dev)
                      for x in (keys_sh, id_sh, ps_sh)),
                    seeds.hashes, seeds.qpos, seeds.valid, max_occ=max_occ)
                lo_b, hi_b = (int(x) for x in bounds[s])
                owned = (seeds.hashes >= lo_b) & (seeds.hashes <= hi_b)
                valid = hits.valid & owned[..., None]
                parts.append((ev, hits.q_pos, [
                    torch.where(valid, x, 0)
                    for x in (hits.t_id, hits.t_pos, hits.strand,
                              valid.to(torch.int32))]))
            # the sum over the row's shard ranks, on its first rank
            dev0 = mesh.devices[d][0]
            ev, q_pos = parts[0][0], parts[0][1]
            t_id, t_pos, strand, n_valid = (
                sum(p[2][k].to(dev0, non_blocking=True) for p in parts)
                for k in range(4))
            H = t_id.shape[1] * t_id.shape[2]
            seg = (t_id * 2 + strand).reshape(b, H)
            tgt = t_pos.reshape(b, H)
            qry = q_pos.reshape(b, H).to(torch.int32)
            av = (n_valid > 0).reshape(b, H)
            seg = torch.where(av, seg, 0x7FFFFFFF)
            # jnp.lexsort((qry, tgt, seg)): stable sorts, last key first
            order = torch.sort(qry, dim=1, stable=True).indices
            for key in (tgt, seg):
                order = order.gather(1, torch.sort(key.gather(1, order), dim=1,
                                                   stable=True).indices)
            order = order[:, :max_anchors]
            seg, tgt, qry = (x.gather(1, order).to(torch.int32).contiguous()
                             for x in (seg, tgt, qry))
            n_anchors = av.sum(dim=1).clamp(max=max_anchors).to(torch.int32)
            dp = chain.chain_dp_batch(
                seg, tgt, qry, n_anchors, window=64, e=io_opt.e,
                max_gap=mo_opt.max_gap_length,
                max_target_gap=mo_opt.max_target_gap_length,
                max_skips=mo_opt.max_num_skips,
            )
            outs.append((ev.values, ev.n_events, seg, tgt, qry, dp.scores,
                         dp.preds))
        return tuple(
            np.concatenate([runtime.fetch(o[k]) for o in outs])
            for k in range(7))

    return step
