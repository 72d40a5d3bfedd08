"""The device half of the fused stage1+chain (``MappingEngine(fused=True)``).

Port of the closure ``_fused_stage`` in rawalign_tpu/map/engine.py:643-753,
kept here as plain functions on tensors so each step can be held to the
host's replay by itself. On one round's stage1 blocks, each (B, NS) int32
with the seed columns hits first:

1. :func:`expand_hits` expands every seed's index hits into
   ``A_exp = 2 * max_anchors`` slots, in seed order then hit order (the
   host's ``np.repeat`` expansion): slot j belongs to the seed whose
   inclusive hit-count prefix sum first exceeds j;
2. :func:`merge_carried` appends the C carried anchors of the previous
   round (rmap.cpp:343-362) after the hits, with occurrence count 0;
3. :func:`sort_anchors` orders each row as ``np.lexsort((qry, tgt, seg))``
   with the concatenation order as the tie-break, padding last;
4. :func:`drop_over_budget` keeps the ``A`` anchors with the smallest
   (occurrence count, sorted position), in sorted order: the host's
   occ-ranked drop (``map/anchors.py``), so a row over the budget but
   within the expansion width stays on the device.

:func:`fused_anchors` runs the four and returns the chain DP's operands
at width ``A``. The host replays the same expansion from the (lo, qc)
blocks it downloads, so the device DP's predecessors index the host's
anchor arrays; a row with more hits and carried anchors than
``A_exp`` is detected there and escalates.

Index values ``val_ps`` are uint32 held as int32 bits: a right shift then
the mask ``0x7FFFFFFF`` equals the logical shift. The over-budget key
``occ * E + pos`` is int64, where the JAX package's int32 key wraps once
``occ * E`` passes 2**31 (occ above 16,320 at ``max_anchors`` 65,536).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

#: the padding segment: sorts after every real anchor
SENT = 0x7FFFFFFF
#: above every compound key of a valid anchor
_KEY_PAD = 1 << 62


class Anchors(NamedTuple):
    """One round's anchors, (B, n) each; ``valid`` marks real anchors."""

    seg: torch.Tensor  # int32 target * 2 + strand (SENT: padding)
    tgt: torch.Tensor  # int32 target position
    qry: torch.Tensor  # int32 query position (event index in the read)
    occ: torch.Tensor  # int32 parent seed's hit count (0: carried)
    valid: torch.Tensor  # bool


def expand_hits(lo: torch.Tensor, qc: torch.Tensor, offset: torch.Tensor,
                val_id: torch.Tensor, val_ps: torch.Tensor, a_exp: int
                ) -> tuple[Anchors, torch.Tensor]:
    """The first ``a_exp`` hits of each row, as anchors, and each row's
    true hit total (B,) int64. ``lo`` (B, NS) holds each seed's first
    index entry, ``qc`` its (qpos << 16 | count), ``offset`` (B,) the
    read's event offset added to every query position; ``val_id`` and
    ``val_ps`` are the index's value table (int32 bits)."""
    B, NS = qc.shape
    qpos, cnt = qc >> 16, qc & 0xFFFF
    cum = torch.cumsum(cnt, dim=1, dtype=torch.int64)
    total = cum[:, -1]
    j = torch.arange(a_exp, dtype=torch.int64, device=qc.device)
    seed = torch.searchsorted(cum, j.expand(B, a_exp).contiguous(), right=True)
    seed = seed.clamp(max=NS - 1)
    within = j - (cum - cnt).gather(1, seed)
    hidx = (lo.gather(1, seed) + within).clamp(0, val_id.numel() - 1)
    ps = val_ps[hidx]
    tpos = (ps >> 1) & 0x7FFFFFFF
    strand = ps & 1
    valid = j < total[:, None]
    return Anchors(
        seg=torch.where(valid, val_id[hidx] * 2 + strand, SENT),
        tgt=torch.where(valid, tpos, 0),
        qry=torch.where(valid, qpos.gather(1, seed) + offset[:, None], 0),
        occ=cnt.gather(1, seed),
        valid=valid,
    ), total


def merge_carried(hits: Anchors, carried: torch.Tensor) -> tuple[Anchors,
                                                                 torch.Tensor]:
    """``hits`` followed by the carried anchors of ``carried`` (B, 3C+2)
    int32: seg | target | query blocks of C columns, then each row's
    count n_car and its event offset. Returns the merged anchors (B,
    A_exp + C) and n_car (B,) int64."""
    B = carried.shape[0]
    C = (carried.shape[1] - 2) // 3
    n_car = carried[:, 3 * C].to(torch.int64)
    k = torch.arange(C, device=carried.device)
    vcar = k < n_car[:, None]
    car = Anchors(
        seg=torch.where(vcar, carried[:, :C], SENT),
        tgt=torch.where(vcar, carried[:, C : 2 * C], 0),
        qry=torch.where(vcar, carried[:, 2 * C : 3 * C], 0),
        occ=torch.zeros((B, C), dtype=torch.int32, device=carried.device),
        valid=vcar,
    )
    return Anchors(*(torch.cat([h.to(c.dtype), c], dim=1)
                     for h, c in zip(hits, car))), n_car


def sort_anchors(x: Anchors) -> Anchors:
    """Each row ordered as ``np.lexsort((qry, tgt, seg))``: two stable
    sorts, the query first, then (seg, target) packed into one int64 key
    (seg < 2**31 above the target offset by 2**31), so ties keep the
    concatenation order and padding (seg SENT) goes last."""
    p1 = torch.sort(x.qry, dim=1, stable=True).indices
    key = (x.seg.to(torch.int64) << 32) + (x.tgt.to(torch.int64) + (1 << 31))
    p2 = torch.sort(key.gather(1, p1), dim=1, stable=True).indices
    perm = p1.gather(1, p2)
    return Anchors(*(t.gather(1, perm) for t in x))


def drop_over_budget(x: Anchors, a: int) -> Anchors:
    """Of each sorted row, the ``a`` valid anchors with the smallest
    compound key ``occ * E + pos`` (E the row width, pos the sorted
    position: unique), first and in sorted order, padding after; width
    ``a``. A row with at most ``a`` valid anchors keeps them all."""
    B, E = x.seg.shape
    pos = torch.arange(E, dtype=torch.int64, device=x.seg.device)
    sortk = torch.where(x.valid, x.occ.to(torch.int64) * E + pos, _KEY_PAD)
    # column a - 1 of the sorted keys, as the JAX engine takes it: a
    # segmented sort, where torch.kthvalue was 11.0 of the fused steps'
    # 24.6 ms a pass (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W)
    kth = torch.sort(sortk, dim=1).values[:, a - 1]
    keep = (sortk <= kth[:, None]) & x.valid
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices[:, :a]
    keep = keep.gather(1, order)
    return Anchors(
        seg=torch.where(keep, x.seg.gather(1, order), SENT),
        tgt=torch.where(keep, x.tgt.gather(1, order), 0),
        qry=torch.where(keep, x.qry.gather(1, order), 0),
        occ=torch.where(keep, x.occ.gather(1, order), 0),
        valid=keep,
    )


def fused_anchors(lo: torch.Tensor, qc: torch.Tensor, carried: torch.Tensor,
                  val_id: torch.Tensor, val_ps: torch.Tensor, *, a: int,
                  a_exp: int) -> tuple[Anchors, torch.Tensor]:
    """The chain DP's anchors at width ``a`` (contiguous int32 blocks)
    and each row's anchor count n_dp = min(hits + carried, a) (B,) int32,
    from one round's stage1 blocks and its carried upload."""
    C = (carried.shape[1] - 2) // 3
    offset = carried[:, 3 * C + 1]
    hits, total = expand_hits(lo, qc, offset, val_id, val_ps, a_exp)
    merged, n_car = merge_carried(hits, carried)
    kept = drop_over_budget(sort_anchors(merged), a)
    n_dp = (total + n_car).clamp(max=a).to(torch.int32)
    return Anchors(*(t.contiguous() for t in kept)), n_dp
