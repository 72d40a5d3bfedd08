"""The reference's full DTW family in PyTorch (port of
rawalign_tpu/map/dtw_family.py).

The mapping path runs only the slanted-band global DTW (``map/dtw.py``,
``map/dtw_cuda.py``) and the host traceback. This module is the rest of
the family (dtw.hpp:21-29), off the mapping path, on an explicit
device:

  reference (dtw.cpp)                      here
  ------------------------------------     ----------------------------
  DTW_global / DTW_global_slow             dtw_batch(semiglobal=False)
  DTW_semiglobal / DTW_semiglobal_slow     dtw_batch(semiglobal=True)
  DTW_global_diagonalbanded                dtw_batch(radius=r)

The JAX package computes it in XLA, outside any Pallas kernel, so plain
PyTorch is the port: the same anti-diagonal wavefront over n+m-1
diagonals with two rotating carry rows, one vector step per diagonal.
Every cell is ``min(min(top, left), topleft) + |a_i - b_j|`` on the same
float32 operands, so the costs equal the JAX function's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

INF = float(np.float32(1e10))


def dtw_batch(
    a: torch.Tensor,
    b: torch.Tensor,
    n_a: torch.Tensor,
    n_b: torch.Tensor,
    *,
    semiglobal: bool = False,
    radius: int | None = None,
    exclude_last: bool = False,
) -> torch.Tensor:
    """(B,) float32 full-matrix DTW costs of the rows of ``a`` (B, N) and
    ``b`` (B, M), padded float32, whose true lengths ``n_a``/``n_b``
    (B,) are at least 1; global or semiglobal (free start and end on the
    ``b`` axis, the first minimum of the last row), with an optional
    diagonal band of half-width ``radius`` (cells outside read INF)."""
    dev = a.device
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    B, N = a.shape
    M = b.shape[1]
    n = n_a.to(device=dev, dtype=torch.int64)
    m = n_b.to(device=dev, dtype=torch.int64)
    j = torch.arange(M, device=dev)
    inf_col = torch.full((B, 1), INF, device=dev)
    # a reversed with M zeros on either side: the slice [N+M-1-d, +M)
    # holds a[d - j] at column j (0 outside a)
    a_rev = torch.cat(
        [torch.zeros((B, M), device=dev), a.flip(1), torch.zeros((B, M), device=dev)],
        dim=1,
    )
    in_b = (j[None, :] < m[:, None])
    prev = torch.full((B, M), INF, device=dev)  # diagonal d-1, by j
    prev2 = torch.full((B, M), INF, device=dev)  # diagonal d-2
    # cell (n-1, j) of the last row lies on diagonal n-1+j at column j
    last_row = torch.full((B, M), INF, device=dev)
    row_diag = (n - 1)[:, None] + j[None, :]
    for d in range(N + M - 1):
        i = d - j
        valid = (i[None, :] >= 0) & (i[None, :] < n[:, None]) & in_b
        if radius is not None:
            valid &= ((i - j).abs() <= radius)[None, :]
        asel = a_rev[:, N + M - 1 - d : N + 2 * M - 1 - d]
        cost = (asel - b).abs()
        top = torch.where(in_b, prev, INF)  # (i-1, j)
        left = torch.cat([inf_col, prev[:, :-1]], dim=1)  # (i, j-1)
        topleft = torch.cat([inf_col, prev2[:, :-1]], dim=1)  # (i-1, j-1)
        best = torch.minimum(torch.minimum(top, left), topleft)
        free = (i == 0) if semiglobal else ((i == 0) & (j == 0))
        base = torch.where(free[None, :], 0.0, best)
        cur = torch.where(valid, base + cost, INF)
        last_row = torch.where(row_diag == d, cur, last_row)
        prev, prev2 = cur, prev
    last_row = torch.where(in_b, last_row, INF)
    rows = torch.arange(B, device=dev)
    a_last = a[rows, n - 1]
    if semiglobal:
        bj = torch.argmin(last_row, dim=1)  # the first minimum (dtw.cpp:579-585)
    else:
        bj = m - 1
    res = last_row[rows, bj]
    if exclude_last:
        res = res - (a_last - b[rows, bj]).abs()
    return res
