"""Batched banded DTW in descriptor form: the plain PyTorch version.

Port of rawalign_tpu/map/dtw.py together with
rawalign_tpu/map/dtw_pallas.py:_panels_from_descs: the reference's
``DTW_global_slantedbanded_antidiagonalwise`` (dtw.cpp:273-520) for a
batch of tiles, each described by one column of a (9, T) int32
descriptor array (rows a_base, off_a, n, b_base, off_b, m, lp, ls, excl;
built by ``map/tiles.py``). The ``a`` side is the longer sequence.

Values are read straight from the two pools by descriptor: a base below
``len(ref)`` indexes the reference pool, any other base indexes the
flattened event history at ``base - len(ref)``. The TPU kernel's
pre-shifted panel columns (off_a, off_b) are not needed here.

Two formulations of the same costs:

* :func:`dtw_banded_indexed` walks the same (T, dpw) anti-diagonal state
  as map/dtw.py:183-237 and dtw_pallas._kernel for one size class, one
  Python loop step per wavefront iteration: alternating secondary and
  primary anti-diagonals, band centre ``floor(it*m/n)`` by Bresenham
  stepping, L1 cost, with the reference's special cases at the band's
  edges;
* :func:`dtw_banded_round` is the CUDA kernel's formulation
  (``csrc/dtw_banded.cu``, ``map/dtw_cuda.py``): a whole round at once,
  each tile at its own band width ``max(lp, ls) + 2``, in a work-list
  order, with the edge cases dropped (each only ever replaces a value
  that is already INF).

Every cell is ``fmin(fmin(top, left), topleft) + |a - b|`` on the same
float32 operands as the JAX package, so results are bit-identical to it
and to ``native.dtw_banded_batch`` on finite events. The minimum is
``torch.fmin``, the kernel's ``fminf``: a NaN operand (a NaN event, from
a z-norm of zero deviation) is dropped, where the JAX package's
``jnp.minimum`` propagates it and the native twin's ternaries do one or
the other by position. Costs of about ``INF`` (the band missed the
corner) are valid outputs.
"""

from __future__ import annotations

import numpy as np
import torch

INF = float(np.float32(1e10))
DESC_ROWS = 9


def _tile_values(ref: torch.Tensor, hist: torch.Tensor, base: torch.Tensor,
                 rel: torch.Tensor) -> torch.Tensor:
    """Values at ``base + rel`` of each tile's pool (``base`` (T,),
    ``rel`` (T, k)). Out-of-tile positions are clamped into the pool;
    callers mask them."""
    lref = ref.numel()
    in_ref = (base < lref)[:, None]
    pos = base[:, None] + rel
    r = (ref[pos.clamp(0, lref - 1)] if lref
         else torch.zeros(pos.shape, device=pos.device))
    lh = hist.numel()
    h = (hist[(pos - lref).clamp(0, lh - 1)] if lh
         else torch.zeros(pos.shape, device=pos.device))
    return torch.where(in_ref, r, h)


def dtw_banded_indexed(ref: torch.Tensor, hist: torch.Tensor,
                       descs: torch.Tensor, *, dpw: int) -> torch.Tensor:
    """(T,) float32 costs after the exclude_last correction.

    ``ref`` (Lref,) and ``hist`` (any shape, read flattened) float32;
    ``descs`` (9, T) int32; ``dpw`` >= widened band R + 3 of every tile."""
    dev = ref.device
    hist = hist.reshape(-1)
    T = descs.shape[1]
    if T == 0:
        return torch.zeros(0, dtype=torch.float32, device=dev)
    d = descs.to(torch.int64)
    a_base, n, b_base, m, lp, ls, excl = d[0], d[2], d[3], d[5], d[6], d[7], d[8]
    plm = (lp > ls)[:, None]  # True iff R even ("primary larger")
    half_lp = lp >> 1
    half_ls = ls >> 1
    o = torch.arange(dpw, device=dev)[None, :]
    zero = torch.zeros((T, 1), dtype=torch.int64, device=dev)
    slot0 = torch.where(plm[:, 0], half_lp, half_lp + 1)
    ok = (n > 0) & (m > 0)
    d00 = torch.where(
        ok,
        (_tile_values(ref, hist, a_base, zero)
         - _tile_values(ref, hist, b_base, zero)).abs()[:, 0],
        0.0,
    )
    dp1 = torch.where((o == slot0[:, None]) & ok[:, None], d00[:, None], INF)
    dp0 = torch.full((T, dpw), INF, device=dev)
    inf_col = torch.full((T, 1), INF, device=dev)
    is_first = o == 0
    is_first_s1 = o == 1
    is_last_s = o == (ls - 1)[:, None]
    is_last_p = o == (lp - 1)[:, None]
    # element index of the primary anti-diagonal held in slot o: odd-R
    # tiles write element o-1 at slot o ("+1 simplification")
    k_p = torch.where(plm, o, o - 1)

    def shift_left(x):  # out[o] = x[o+1], INF at o = dpw-1
        return torch.cat([x[:, 1:], inf_col], dim=1)

    def shift_right(x):  # out[o] = x[o-1], INF at o = 0
        return torch.cat([inf_col, x[:, :-1]], dim=1)

    def in_range(start_i, start_j, length, idx):
        o0 = torch.maximum(torch.clamp(start_i - n + 1, min=0), -start_j)
        o1 = torch.minimum(torch.minimum(length, start_i + 1), m - start_j)
        return (idx >= o0[:, None]) & (idx < o1[:, None])

    acc = torch.zeros_like(n)
    cr = torch.zeros_like(n)
    pinc = torch.zeros(T, dtype=torch.bool, device=dev)
    for it in range(1, int(n.max())):
        active = it < n
        # Bresenham band-centre stepping: inc iff floor(it*m/n) advanced
        acc2 = acc + m
        incraw = acc2 >= n
        acc = torch.where(incraw, acc2 - n, acc2)
        incb = incraw & active
        cr = cr + incb.to(torch.int64)
        inc = incb[:, None]
        previnc = pinc[:, None]

        # ---- secondary anti-diagonal (dtw.cpp:361-414): cell
        # (s_i - o, s_j + o) at slot o
        s_i = it + half_ls - 1
        s_j = cr - half_ls
        c_s = (_tile_values(ref, hist, a_base, s_i[:, None] - o)
               - _tile_values(ref, hist, b_base, s_j[:, None] + o)).abs()
        sec_top = torch.where(plm | ~is_first, dp1, INF)
        sec_topleft = torch.where(plm | ~(is_first & ~previnc), dp0, INF)
        sec_left = torch.where(plm | ~is_last_s, shift_left(dp1), INF)
        sec = torch.fmin(torch.fmin(sec_top, sec_left), sec_topleft) + c_s
        sec = torch.where(in_range(s_i, s_j, ls, o), sec, INF)

        eff_dp0 = torch.where(inc, dp1, dp0)
        eff_dp1 = torch.where(inc, sec, dp1)

        # ---- primary anti-diagonal (dtw.cpp:416-491): element k at
        # cell (p_i - k, p_j + k)
        p_i = it + half_lp
        p_j = cr - half_lp
        c_p = (_tile_values(ref, hist, a_base, p_i[:, None] - k_p)
               - _tile_values(ref, hist, b_base, p_j[:, None] + k_p)).abs()
        e1r = shift_right(eff_dp1)
        e0r = shift_right(eff_dp0)
        pl_top = torch.where(is_first, INF, e1r)
        pl_topleft = torch.where(inc, eff_dp0, torch.where(is_first, INF, e0r))
        pl_left = torch.where(inc & is_last_p, INF, eff_dp1)
        sp_top = torch.where(inc, e1r, torch.where(is_first_s1, INF, e1r))
        sp_topleft = torch.where(
            inc, eff_dp0, torch.where(is_first_s1 & ~previnc, INF, e0r)
        )
        top = torch.where(plm, pl_top, sp_top)
        topleft = torch.where(plm, pl_topleft, sp_topleft)
        left = torch.where(plm, pl_left, eff_dp1)
        pri = torch.fmin(torch.fmin(top, left), topleft) + c_p
        pri = torch.where(in_range(p_i, p_j, lp, k_p), pri, INF)

        act = active[:, None]
        dp0 = torch.where(act, eff_dp1, dp0)
        dp1 = torch.where(act, pri, dp1)
        pinc = torch.where(active, incraw, pinc)

    # the state froze after each tile's last iteration (it = n-1)
    res = dp1.gather(1, slot0[:, None])[:, 0]
    last = (_tile_values(ref, hist, a_base, (n - 1)[:, None])
            - _tile_values(ref, hist, b_base, (m - 1)[:, None])).abs()[:, 0]
    corr = torch.where((excl != 0) & ok, last, 0.0)
    return res - corr


def dtw_banded_round(ref: torch.Tensor, hist: torch.Tensor,
                     descs: torch.Tensor, *, order=None,
                     pad: int = 0) -> torch.Tensor:
    """(T,) float32 costs of a whole round's tiles in descriptor column
    order, as the CUDA kernel computes them.

    ``order`` is the work list (each column index once, in the order the
    tiles are run; default: column order); it changes no cost and not
    the output order. Each tile has ``max(lp, ls) + 2 + pad`` band slots;
    any ``pad`` >= -1 gives the same costs. The recurrence is the
    reference's without its edge cases: the secondary slot x is
    ``fmin(fmin(dp1[x], dp1[x+1]), dp0[x]) + c``; the primary slot o is
    ``fmin(fmin(e1[o-1], e1[o]), tl) + c`` with ``e0, e1 = dp1, sec`` and
    ``tl = e0[o]`` where the centre advanced, ``e0, e1 = dp0, dp1`` and
    ``tl = e0[o-1]`` where it did not; INF left of slot 0, past the
    tile's last slot and outside the band."""
    dev = ref.device
    hist = hist.reshape(-1)
    T = descs.shape[1]
    if T == 0:
        return torch.zeros(0, dtype=torch.float32, device=dev)
    perm = (torch.arange(T, device=dev) if order is None
            else torch.as_tensor(order, dtype=torch.int64, device=dev))
    d = descs.to(torch.int64)[:, perm]
    a_base, n, b_base, m, lp, ls, excl = d[0], d[2], d[3], d[5], d[6], d[7], d[8]
    width = torch.maximum(lp, ls) + 2 + pad
    o = torch.arange(int(width.max()), device=dev)[None, :]
    plm = (lp > ls)[:, None]  # True iff R even ("primary larger")
    half_lp = lp >> 1
    half_ls = ls >> 1
    slot0 = torch.where(plm[:, 0], half_lp, half_lp + 1)
    ok = (n > 0) & (m > 0)
    zero = torch.zeros((T, 1), dtype=torch.int64, device=dev)
    d00 = torch.where(
        ok,
        (_tile_values(ref, hist, a_base, zero)
         - _tile_values(ref, hist, b_base, zero)).abs()[:, 0],
        0.0,
    )
    dp1 = torch.where((o == slot0[:, None]) & ok[:, None], d00[:, None], INF)
    dp0 = torch.full(dp1.shape, INF, device=dev)
    inf_col = torch.full((T, 1), INF, device=dev)
    has_next = o + 1 < width[:, None]
    k_p = torch.where(plm, o, o - 1)  # primary element held in slot o

    def next_slot(x):  # out[o] = x[o+1], INF at the tile's last slot
        return torch.where(has_next, torch.cat([x[:, 1:], inf_col], dim=1), INF)

    def prev_slot(x):  # out[o] = x[o-1], INF at o = 0
        return torch.cat([inf_col, x[:, :-1]], dim=1)

    def in_range(start_i, start_j, length, idx):
        o0 = torch.maximum(torch.clamp(start_i - n + 1, min=0), -start_j)
        o1 = torch.minimum(torch.minimum(length, start_i + 1), m - start_j)
        return (idx >= o0[:, None]) & (idx < o1[:, None])

    acc = torch.zeros_like(n)
    cr = torch.zeros_like(n)
    for it in range(1, int(n.max())):
        active = it < n
        acc2 = acc + m
        incraw = acc2 >= n
        acc = torch.where(incraw, acc2 - n, acc2)
        incb = incraw & active
        cr = cr + incb.to(torch.int64)
        inc = incb[:, None]

        s_i = it + half_ls - 1
        s_j = cr - half_ls
        c_s = (_tile_values(ref, hist, a_base, s_i[:, None] - o)
               - _tile_values(ref, hist, b_base, s_j[:, None] + o)).abs()
        sec = torch.fmin(torch.fmin(dp1, next_slot(dp1)), dp0) + c_s
        sec = torch.where(in_range(s_i, s_j, ls, o), sec, INF)
        e0 = torch.where(inc, dp1, dp0)
        e1 = torch.where(inc, sec, dp1)

        p_i = it + half_lp
        p_j = cr - half_lp
        c_p = (_tile_values(ref, hist, a_base, p_i[:, None] - k_p)
               - _tile_values(ref, hist, b_base, p_j[:, None] + k_p)).abs()
        topleft = torch.where(inc, e0, prev_slot(e0))
        pri = torch.fmin(torch.fmin(prev_slot(e1), e1), topleft) + c_p
        pri = torch.where(in_range(p_i, p_j, lp, k_p), pri, INF)

        act = active[:, None]
        dp0 = torch.where(act, e1, dp0)
        dp1 = torch.where(act, pri, dp1)

    # the state froze after each tile's last iteration (it = n-1)
    res = dp1.gather(1, slot0[:, None])[:, 0]
    last = (_tile_values(ref, hist, a_base, (n - 1)[:, None])
            - _tile_values(ref, hist, b_base, (m - 1)[:, None])).abs()[:, 0]
    corr = torch.where((excl != 0) & ok, last, 0.0)
    out = torch.empty(T, dtype=torch.float32, device=dev)
    out[perm] = res - corr
    return out
