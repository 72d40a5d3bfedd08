"""Batched chaining DP (port of rawalign_tpu/map/chain.py).

The reference's chaining DP (rmap.cpp:427-507) over one read's anchors,
flattened into one array sorted by (segment = target*2+strand,
target_pos, query_pos): anchor i looks back over at most ``window``
predecessors j = i-1, i-2, ... of its own segment, skipping same-query
or same-target pairs and pairs with a negative query step, stopping at
the first target gap beyond ``max_target_gap`` and once more than
``max_skips`` predecessors in a row fail to improve the score. The
first maximum in distance order wins ties.

:func:`chain_dp_plain` is the JAX package's ``lax.scan`` step by step:
one anchor per step, the window a vector axis, the serial early exits
prefix sums and prefix maxima over it. It equals the JAX scan and the
native C loop (``native.chain_dp``) bit for bit. ``map/chain_cuda.py``
holds the CUDA kernel and the wrapper that picks between the two by the
tensor's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEG = float(np.float32(-3e38))


class ChainScores(NamedTuple):
    scores: torch.Tensor  # (B, A) float32 chaining scores
    preds: torch.Tensor  # (B, A) int32 predecessor index (== i for none)


def chain_dp_plain(
    seg: torch.Tensor,
    target: torch.Tensor,
    query: torch.Tensor,
    n_anchors: torch.Tensor,
    *,
    window: int,
    e: int,
    max_gap: int,
    max_target_gap: int,
    max_skips: int,
) -> ChainScores:
    """Plain PyTorch chaining DP. ``seg``, ``target``, ``query`` (B, A)
    int32 sorted per row; ``n_anchors`` (B,) int32. Slots at and past a
    row's ``n_anchors`` get score 0 and pred = their own index."""
    B, A = seg.shape
    dev = seg.device
    init = float(e)
    ar = torch.arange(A, dtype=torch.int32, device=dev)
    n = n_anchors.to(torch.int64)
    steps = min(A, int(n.max())) if B and A else 0
    f = torch.zeros((B, A), dtype=torch.float32, device=dev)
    preds = ar.expand(B, A).clone()
    for i in range(steps):
        lo = max(i - window, 0)
        if lo == i:
            f[:, i] = init
            continue
        # predecessors j = i-1 .. lo; axis position d-1 is distance d
        ws = seg[:, lo:i].flip(1)
        wt = target[:, lo:i].flip(1)
        wq = query[:, lo:i].flip(1)
        wf = f[:, lo:i].flip(1)
        cs = seg[:, i : i + 1]
        ct = target[:, i : i + 1]
        cq = query[:, i : i + 1]
        seg_ok = ws == cs
        cont = seg_ok & ((wq == cq) | (wt == ct))  # rmap.cpp:456-457
        brk_gap = seg_ok & ~cont & (wt + max_target_gap < ct)  # :458
        qdiff = cq - wq
        tdiff = ct - wt
        cont2 = seg_ok & ~cont & ~brk_gap & (qdiff < 0)  # :465
        # every slot at or past the first target-gap break is dead
        dead = brk_gap.to(torch.int32).cumsum(1) > 0
        processed = seg_ok & ~cont & ~cont2 & ~dead
        matching = torch.minimum(tdiff, qdiff).clamp(max=e)
        gap_len = (tdiff - qdiff).abs()
        gap_scale = torch.where(
            tdiff > 0, qdiff.to(torch.float32) / tdiff.to(torch.float32), 1.0
        )
        gates = (gap_len < max_gap) & (gap_scale < 5.0) & (gap_scale > 0.75)
        cand = torch.where(gates, wf + matching.to(torch.float32), 0.0)  # :472-474
        cand = torch.where(processed, cand, NEG)
        # running best before each slot: max(init, exclusive prefix max)
        cmax = cand.cummax(1).values
        running = torch.cat(
            [torch.full((B, 1), NEG, device=dev), cmax[:, :-1]], dim=1
        ).clamp(min=init)
        improved = processed & (cand > running)  # :476
        # skip counter: +1 per processed non-improving slot, -1 per
        # improvement; the loop stops AFTER the slot that pushes it past
        # max_skips (rmap.cpp:479-483)
        delta = torch.where(processed, torch.where(improved, -1, 1), 0)
        skips = delta.cumsum(1)
        brk = (processed & ~improved & (skips > max_skips)).to(torch.int32)
        alive = processed & ((brk.cumsum(1) - brk) == 0)
        best, best_at = torch.where(alive, cand, NEG).max(dim=1)  # first max
        f[:, i] = best.clamp(min=init)
        preds[:, i] = torch.where(best > init, i - 1 - best_at, i).to(torch.int32)
    inside = ar[None, :] < n[:, None]
    return ChainScores(
        scores=torch.where(inside, f, 0.0),
        preds=torch.where(inside, preds, ar[None, :]),
    )


#: lanes of a warp: the CUDA kernel's chunk of window slots
LANES = 32


def chain_dp_scan_plain(
    seg: torch.Tensor,
    target: torch.Tensor,
    query: torch.Tensor,
    n_anchors: torch.Tensor,
    *,
    window: int,
    e: int,
    max_gap: int,
    max_target_gap: int,
    max_skips: int,
    visited: torch.Tensor | None = None,
) -> ChainScores:
    """The CUDA kernel's warp formulation in plain PyTorch, with the same
    result as :func:`chain_dp_plain`.

    For anchor i the window is walked in chunks of ``LANES`` slots; lane l
    of chunk k holds the predecessor at distance ``32k + l + 1``. Per
    chunk, as the kernel does it: the target-gap break is the first set
    lane of a ballot (that lane and the ones after it are dead); the
    running best before each slot is an exclusive prefix max, continued
    from the chunks before; the skip counter is an inclusive prefix sum of
    +1 (processed, not improving) and -1 (improving), continued likewise;
    the skip break is the first set lane of a ballot (that lane itself
    still counts). The predecessor is the last improvement among the live
    slots, which is the first maximum in distance order; a row stops at
    the first chunk with a break.

    ``visited`` (B,) int64, if given, gains the predecessor slots the
    reference's serial loop visits in each row (every slot up to and
    including the one it breaks at): the work the data needs, which
    ``chip_smoke.py`` turns into the kernel's bound."""
    B, A = seg.shape
    dev = seg.device
    init = float(e)
    lanes = torch.arange(LANES, device=dev)
    ar = torch.arange(A, dtype=torch.int32, device=dev)
    n = n_anchors.to(torch.int64)
    steps = min(A, int(n.max())) if B and A else 0
    f = torch.zeros((B, A), dtype=torch.float32, device=dev)
    preds = ar.expand(B, A).clone()
    rows = torch.arange(B, device=dev)

    def first_lane(mask):  # ffs of a ballot; LANES when none is set
        return torch.where(mask.any(1), mask.to(torch.int32).argmax(1), LANES)

    for i in range(steps):
        nwin = min(window, i)
        cs, ct, cq = seg[:, i : i + 1], target[:, i : i + 1], query[:, i : i + 1]
        best = torch.full((B,), init, device=dev)
        pred = torch.full((B,), i, dtype=torch.int64, device=dev)
        carry_max = torch.full((B,), NEG, device=dev)
        carry_skips = torch.zeros((B,), dtype=torch.int64, device=dev)
        live = torch.ones((B,), dtype=torch.bool, device=dev)
        for k in range((nwin + LANES - 1) // LANES):
            d = k * LANES + lanes + 1
            valid = (d <= nwin)[None, :] & live[:, None]
            j = (i - d).clamp(min=0)
            wt, wq = target[:, j], query[:, j]
            seg_ok = valid & (seg[:, j] == cs)
            cont = seg_ok & ((wq == cq) | (wt == ct))  # rmap.cpp:456-457
            brk_gap = seg_ok & ~cont & (wt + max_target_gap < ct)  # :458
            qdiff = cq - wq
            tdiff = ct - wt
            cont2 = seg_ok & ~cont & ~brk_gap & (qdiff < 0)  # :465
            first_gap = first_lane(brk_gap)
            processed = (seg_ok & ~cont & ~cont2
                         & (lanes[None, :] < first_gap[:, None]))
            matching = torch.minimum(tdiff, qdiff).clamp(max=e)
            gap_len = (tdiff - qdiff).abs()
            gap_scale = torch.where(
                tdiff > 0, qdiff.to(torch.float32) / tdiff.to(torch.float32), 1.0
            )
            gates = (gap_len < max_gap) & (gap_scale < 5.0) & (gap_scale > 0.75)
            cand = torch.where(gates, f[:, j] + matching.to(torch.float32), 0.0)
            cand = torch.where(processed, cand, NEG)
            incl = cand.cummax(1).values
            excl = torch.cat([torch.full((B, 1), NEG, device=dev), incl[:, :-1]], 1)
            running = torch.maximum(excl, carry_max[:, None]).clamp(min=init)
            improved = processed & (cand > running)  # :476
            delta = torch.where(processed, torch.where(improved, -1, 1), 0)
            skips = carry_skips[:, None] + delta.cumsum(1)
            first_skip = first_lane(processed & ~improved & (skips > max_skips))
            kept = improved & (lanes[None, :] <= first_skip[:, None])
            last = LANES - 1 - kept.flip(1).to(torch.int32).argmax(1)
            has = kept.any(1)
            best = torch.where(has, cand[rows, last], best)
            pred = torch.where(has, i - (k * LANES + last + 1), pred)
            carry_max = torch.maximum(carry_max, incl[:, -1])
            carry_skips = skips[:, -1]
            if visited is not None:
                stop = torch.minimum(first_gap, first_skip)
                seen = torch.where(stop < LANES, stop + 1,
                                   min(LANES, nwin - k * LANES))
                visited += torch.where(live & (i < n), seen, 0)
            live &= (first_gap == LANES) & (first_skip == LANES)
            if not live.any():
                break
        f[:, i] = best
        preds[:, i] = pred.to(torch.int32)
    inside = ar[None, :] < n[:, None]
    return ChainScores(
        scores=torch.where(inside, f, 0.0),
        preds=torch.where(inside, preds, ar[None, :]),
    )


def chain_dp_batch(
    seg: torch.Tensor,
    target: torch.Tensor,
    query: torch.Tensor,
    n_anchors: torch.Tensor,
    *,
    window: int = 64,
    e: int = 6,
    max_gap: int = 2000,
    max_target_gap: int = 5000,
    max_skips: int = 25,
) -> ChainScores:
    """Runs the CUDA kernel for CUDA tensors and the plain version for
    CPU tensors."""
    from rawalign_tpu_torch.map import chain_cuda

    return chain_cuda.chain_dp(
        seg, target, query, n_anchors, window=window, e=e, max_gap=max_gap,
        max_target_gap=max_target_gap, max_skips=max_skips,
    )
