"""Seed lookup against the index (port of rawalign_tpu/index/query.py).

The index's sorted key table is reorganised once into unique keys with
per-key (first position, count) and a 2^b bucket table over the keys'
top bits; a lookup is then a bucket read plus a fixed-depth binary
search inside the bucket. The tables are built with numpy, exactly as
the JAX package builds them, and moved to the engine's device: they are
the index's device state (:func:`index_state`). :func:`query_seeds`
is the older dense form (a searchsorted on the sorted keys and up to
``max_occ`` hits a seed), used by ``parallel/mesh.py:build_mapping_step``.

Hashes are uint32 values held in int64 tensors, so the bucket index
``h >> (32 - b_bits)`` and every comparison are unsigned-correct (int32
would flip the order of hashes >= 2**31).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class BucketedKeys(NamedTuple):
    ku: torch.Tensor  # (U,) int64 unique sorted hashes (uint32 values)
    kidx: torch.Tensor  # (U,) int64 first position in the full key table
    kcnt: torch.Tensor  # (U,) int32 occurrence count
    boff: torch.Tensor  # (2^b + 1,) int64 bucket start offsets into ku
    n_steps: int  # binary-search iterations (covers the largest bucket)
    b_bits: int


def build_bucketed_keys(keys: np.ndarray, device: torch.device,
                        b_bits: int = 14) -> BucketedKeys:
    keys = np.asarray(keys, dtype=np.uint32)
    ku, kidx, kcnt = np.unique(keys, return_index=True, return_counts=True)
    starts = (
        np.arange(1 << b_bits, dtype=np.uint64) << np.uint64(32 - b_bits)
    ).astype(np.uint32)
    boff = np.empty((1 << b_bits) + 1, dtype=np.int64)
    boff[:-1] = np.searchsorted(ku, starts, side="left")
    boff[-1] = ku.size
    max_span = int(np.diff(boff).max()) if ku.size else 0
    n_steps = int(np.ceil(np.log2(max_span + 1))) if max_span > 0 else 0

    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    return BucketedKeys(
        ku=dev(ku, np.int64),
        kidx=dev(kidx, np.int64),
        kcnt=dev(kcnt, np.int32),
        boff=dev(boff, np.int64),
        n_steps=n_steps,
        b_bits=b_bits,
    )


def index_state(index, device: torch.device) -> BucketedKeys:
    """The RawIndex's lookup tables as tensors on ``device``."""
    return build_bucketed_keys(index.keys, device)


def lookup_bounds(bk: BucketedKeys,
                  h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, count), int32, for every query hash: identical to
    ``searchsorted(keys, h, 'left')`` and ``'right' - 'left'`` over the
    full key table. Missing hashes get count 0 and lo 0. ``h``: any
    shape, int64 holding uint32 values."""
    if bk.ku.numel() == 0:
        z = torch.zeros(h.shape, dtype=torch.int32, device=h.device)
        return z, z.clone()
    h = h.to(torch.int64)
    bidx = h >> (32 - bk.b_bits)
    lo = bk.boff[bidx]
    hi = bk.boff[bidx + 1]
    span = hi - lo
    umax = bk.ku.numel() - 1
    for _ in range(bk.n_steps):  # in-bucket lower_bound, fixed depth
        half = span >> 1
        mid = lo + half
        go = (span > 0) & (bk.ku[mid.clamp(max=umax)] < h)
        lo = torch.where(go, mid + 1, lo)
        span = torch.where(go, span - half - 1, half)
    safe = lo.clamp(max=umax)
    eq = (lo < hi) & (bk.ku[safe] == h)
    cnt = torch.where(eq, bk.kcnt[safe], 0).to(torch.int32)
    glo = torch.where(eq, bk.kidx[safe], 0).to(torch.int32)
    return glo, cnt


class HitBatch(NamedTuple):
    t_id: torch.Tensor  # (B, NE, MAX_OCC) int32 target sequence id
    t_pos: torch.Tensor  # (B, NE, MAX_OCC) int32 target signal position
    strand: torch.Tensor  # (B, NE, MAX_OCC) int32 0/1
    q_pos: torch.Tensor  # (B, NE, MAX_OCC) int32 query event index
    valid: torch.Tensor  # (B, NE, MAX_OCC) bool
    n_dropped: torch.Tensor  # (B,) int32 hits lost to the MAX_OCC cap


def query_seeds(keys: torch.Tensor, val_id: torch.Tensor, val_ps: torch.Tensor,
                hashes: torch.Tensor, qpos: torch.Tensor,
                seed_valid: torch.Tensor, *, max_occ: int = 16) -> HitBatch:
    """Dense per-seed hit lists of up to ``max_occ`` index entries
    (rawalign_tpu/index/query.py:query_seeds): seeds with more hits than
    that get none and count in ``n_dropped``. ``keys`` (S,) sorted,
    ``val_id``/``val_ps`` (S,) and ``hashes`` (B, NE) are int64 holding
    uint32 values; ``qpos`` (B, NE) integer; ``seed_valid`` (B, NE) bool.
    ``val_ps`` packs pos << 1 | strand (rmap.cpp:326,387)."""
    B, NE = hashes.shape
    lo = torch.searchsorted(keys, hashes)
    hi = torch.searchsorted(keys, hashes, right=True)
    count = (hi - lo).to(torch.int32)
    over_cap = count > max_occ
    o = torch.arange(max_occ, device=hashes.device)
    gidx = (lo[..., None] + o).clamp(0, max(keys.numel() - 1, 0))
    hit_valid = (seed_valid[..., None] & ~over_cap[..., None]
                 & (o < count[..., None]))
    ps = val_ps[gidx]
    dropped = torch.where(seed_valid & over_cap, count, 0).sum(
        dim=1, dtype=torch.int32)
    return HitBatch(
        t_id=val_id[gidx].to(torch.int32),
        t_pos=((ps >> 1) & 0x7FFFFFFF).to(torch.int32),
        strand=(ps & 1).to(torch.int32),
        q_pos=qpos.to(torch.int32)[..., None].expand(B, NE, max_occ),
        valid=hit_valid,
        n_dropped=dropped,
    )
