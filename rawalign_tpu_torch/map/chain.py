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
