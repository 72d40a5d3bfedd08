"""Copy of rawalign_tpu/golden/dtw.py for the port.

DTW golden model (reference: src/dtw.hpp, src/dtw.cpp).

All variants use L1 cost |a-b| in float32 and the recurrence
``dp[i][j] = min(min(top, left), topleft) + cost`` with 1e10 as the
"infinity" border value, exactly as the reference. ``exclude_last_element``
subtracts the final cell's cost, used by the sparse border constraint to
avoid double-counting shared anchors (dtw.cpp:21-29).

``dtw_global_slantedbanded`` here is the column-wise formulation of the
reference's production kernel ``DTW_global_slantedbanded_antidiagonalwise``
(dtw.cpp:273-520): both traverse the same slanted band (center row
floor(i*m/n), radius widened by ceil((n-m)*r/n) — widening applied only by
the antidiagonalwise variant) and evaluate identical operand triples per
cell, so results agree bit-for-bit; only the execution order differs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

INF = np.float32(1e10)


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _dist(a: np.float32, b: np.float32) -> np.float32:
    return np.float32(abs(np.float32(a) - np.float32(b)))


def dtw_global(a, b, exclude_last_element: bool = False) -> float:
    """Full-matrix global DTW, score only (dtw.cpp:37-66)."""
    a, b = _f32(a), _f32(b)
    n, m = a.size, b.size
    cost = np.abs(a[None, :] - b[:, None])  # (m, n) float32
    dp = np.empty(n, dtype=np.float32)
    dp[0] = cost[0, 0]
    for j in range(1, n):
        dp[j] = dp[j - 1] + cost[0, j]
    for i in range(1, m):
        old_left = dp[0]
        dp[0] = dp[0] + cost[i, 0]
        for j in range(1, n):
            top = dp[j - 1]
            left = dp[j]
            center = min(min(top, left), old_left) + cost[i, j]
            dp[j] = center
            old_left = left
    res = dp[n - 1]
    if exclude_last_element:
        res = res - _dist(a[n - 1], b[m - 1])
    return float(res)


def _full_matrix(a: np.ndarray, b: np.ndarray, semiglobal: bool) -> np.ndarray:
    """(n_a, m_b) float32 DP matrix (dtw.cpp:78-105 / 556-593)."""
    n, m = a.size, b.size
    dp = np.zeros((n, m), dtype=np.float32)
    dp[0, 0] = _dist(a[0], b[0])
    for i in range(1, n):
        dp[i, 0] = dp[i - 1, 0] + _dist(a[i], b[0])
    for j in range(1, m):
        if semiglobal:
            dp[0, j] = _dist(a[0], b[j])
        else:
            dp[0, j] = dp[0, j - 1] + _dist(a[0], b[j])
    for i in range(1, n):
        row_a = a[i]
        for j in range(1, m):
            best = min(min(dp[i - 1, j], dp[i, j - 1]), dp[i - 1, j - 1])
            dp[i, j] = best + _dist(row_a, b[j])
    return dp


def dtw_global_slow(a, b, exclude_last_element: bool = False) -> float:
    a, b = _f32(a), _f32(b)
    dp = _full_matrix(a, b, semiglobal=False)
    res = dp[-1, -1]
    if exclude_last_element:
        res = res - _dist(a[-1], b[-1])
    return float(res)


def dtw_global_diagonalbanded(
    a, b, band_radius: int, exclude_last_element: bool = False
) -> float:
    """Band centered on the main diagonal (dtw.cpp:107-165)."""
    a, b = _f32(a), _f32(b)
    n, m = int(a.size), int(b.size)
    r = int(band_radius)
    width = 2 * r + 1
    dp = np.full(width, INF, dtype=np.float32)
    prev = np.float32(0.0)
    for off in range(0, min(r, m - 1) + 1):
        cur = prev + _dist(a[0], b[off])
        dp[r + off] = cur
        prev = cur
    for i in range(1, n):
        cr = i
        off_start = max(-r, -cr)
        off_end = min(r, m - cr - 1)
        top = INF
        for off in range(off_start, off_end + 1):
            j = cr + off
            topleft = dp[r + off]
            left = INF if off == r else dp[r + off + 1]
            center = min(min(top, left), topleft) + _dist(a[i], b[j])
            dp[r + off] = center
            top = center
    cr = n - 1
    off_start = max(-r, -cr)
    off_end = min(r, m - cr - 1)
    desired = (m - 1) - cr
    if off_start > desired or off_end < desired:
        return float(INF)
    res = dp[r + desired]
    if exclude_last_element:
        res = res - _dist(a[n - 1], b[m - 1])
    return float(res)


def dtw_global_slantedbanded(
    a,
    b,
    band_radius: int,
    exclude_last_element: bool = False,
    widen_for_slope: bool = False,
) -> float:
    """Band following the (n, m) slope (dtw.cpp:167-271).

    With ``widen_for_slope=True`` the radius is widened by
    ceil((n-m)*r/n) first, which is what the production
    ``DTW_global_slantedbanded_antidiagonalwise`` kernel does
    (dtw.cpp:294-300); results then match that kernel exactly.
    """
    a, b = _f32(a), _f32(b)
    # Make a the longer sequence (dtw.cpp:178-186 / 283-292).
    if a.size < b.size:
        a, b = b, a
    n, m = int(a.size), int(b.size)
    r = int(band_radius)
    if widen_for_slope:
        r += ((n - m) * r + n - 1) // n
    width = 2 * r + 1
    dp = np.full(width, INF, dtype=np.float32)
    prev = np.float32(0.0)
    for off in range(0, min(r, m - 1) + 1):
        cur = prev + _dist(a[0], b[off])
        dp[r + off] = cur
        prev = cur
    center_row = 0
    for i in range(1, n):
        next_row = center_row + 1
        increment = next_row * n <= m * i
        if increment:
            center_row += 1
        off_start = max(-r, -center_row)
        off_end = min(r, m - center_row - 1)
        top = INF
        topleft = (
            dp[r + off_start]
            if (increment and center_row + off_start > 0)
            else INF
        )
        for off in range(off_start, off_end + 1):
            j = center_row + off
            if increment:
                left = INF if off == r else dp[r + off + 1]
            else:
                left = dp[r + off]
            center = min(min(top, left), topleft) + _dist(a[i], b[j])
            dp[r + off] = center
            top = center
            topleft = left
    desired = (m - 1) - center_row
    res = dp[r + desired]
    if exclude_last_element:
        res = res - _dist(a[n - 1], b[m - 1])
    return float(res)


def antidiagonal_band_cells(
    n: int, m: int, band_radius: int
) -> np.ndarray:
    """Boolean (n, m) mask of cells visited by the reference production
    kernel's anti-diagonal slanted band (dtw.cpp:273-520), after the
    longer-sequence swap and slope widening have been applied.

    Geometry: radius R = r + ceil((n-m)*r/n); primary anti-diagonals of
    length R rounded up to odd, secondary (inserted when the band center
    steps down a row) of length R rounded up to even; anti-diagonal d
    covers cells along i+j = d centered on the slanted band center
    (floor-slope row tracking, dtw.cpp:350-359).
    """
    r = int(band_radius)
    r += ((n - m) * r + n - 1) // n
    lp = r + (1 if r % 2 == 0 else 0)
    ls = r + (1 if r % 2 == 1 else 0)
    mask = np.zeros((n, m), dtype=bool)
    mask[0, 0] = True  # iteration 0 initializes only the corner (dtw.cpp:317-347)
    cr = 0
    for it in range(1, n):
        cc = it
        increment = (cr + 1) * n <= m * it
        if increment:
            cr += 1
            si = cc + ls // 2 - 1
            sj = cr - ls // 2
            o0 = max(max(0, si - n + 1), -sj)
            o1 = min(min(ls, si + 1), m - sj)
            for o in range(o0, o1):
                mask[si - o, sj + o] = True
        pi = cc + lp // 2
        pj = cr - lp // 2
        o0 = max(max(0, pi - n + 1), -pj)
        o1 = min(min(lp, pi + 1), m - pj)
        for o in range(o0, o1):
            mask[pi - o, pj + o] = True
    return mask


def dtw_global_slantedbanded_antidiagonalwise(
    a, b, band_radius: int, exclude_last_element: bool = False
) -> float:
    """Reference production kernel (dtw.cpp:273-520): masked-matrix
    formulation. The reference evaluates the band anti-diagonal-wise with
    three rotating buffers; evaluating the same visited-cell set in
    row-major order with INF outside the band computes identical operand
    triples per cell, hence identical float32 results."""
    a, b = _f32(a), _f32(b)
    if a.size < b.size:
        a, b = b, a
    n, m = int(a.size), int(b.size)
    mask = antidiagonal_band_cells(n, m, int(band_radius))
    dp = np.full((n, m), INF, dtype=np.float32)
    for i in range(n):
        ai = a[i]
        row_mask = mask[i]
        for j in range(m):
            if not row_mask[j]:
                continue
            if i == 0 and j == 0:
                dp[0, 0] = _dist(ai, b[0])
                continue
            top = dp[i, j - 1] if j > 0 else INF
            left = dp[i - 1, j] if i > 0 else INF
            topleft = dp[i - 1, j - 1] if (i > 0 and j > 0) else INF
            dp[i, j] = min(min(top, left), topleft) + _dist(ai, b[j])
    res = dp[n - 1, m - 1]
    if exclude_last_element:
        res = res - _dist(a[n - 1], b[m - 1])
    return float(res)


def dtw_semiglobal(a, b, exclude_last_element: bool = False) -> float:
    """a aligned globally to the best-matching substring of b
    (dtw.cpp:526-550). Note: exclude_last_element is accepted but unused,
    as in the reference's fast variant."""
    a, b = _f32(a), _f32(b)
    n, m = a.size, b.size
    dp = np.full(n, INF, dtype=np.float32)
    best = INF
    for i in range(m):
        old_left = dp[0]
        dp[0] = _dist(a[0], b[i])
        for j in range(1, n):
            top = dp[j - 1]
            left = dp[j]
            center = min(min(top, left), old_left) + _dist(a[j], b[i])
            dp[j] = center
            old_left = left
        best = min(best, dp[n - 1])
    return float(best)


def dtw_semiglobal_slow(a, b, exclude_last_element: bool = False) -> float:
    a, b = _f32(a), _f32(b)
    dp = _full_matrix(a, b, semiglobal=True)
    last = dp[-1, :]
    best_j = int(np.argmin(last))  # first minimum, matching dtw.cpp:579-585
    best = last[best_j]
    if exclude_last_element:
        return float(best - _dist(a[-1], b[best_j]))
    return float(best)


@dataclasses.dataclass
class AlignmentElement:
    i: int
    j: int
    difference: float


@dataclasses.dataclass
class DtwResult:
    cost: float
    alignment: list[AlignmentElement]


def _traceback(
    dp: np.ndarray, a: np.ndarray, b: np.ndarray, i: int, j: int, stop_i_only: bool
) -> list[AlignmentElement]:
    rev = [AlignmentElement(i, j, float(_dist(a[i], b[j])))]
    while (i > 0) if stop_i_only else (i > 0 or j > 0):
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            left = dp[i - 1, j]
            top = dp[i, j - 1]
            topleft = dp[i - 1, j - 1]
            if left < min(top, topleft):
                i -= 1
            elif top < min(left, topleft):
                j -= 1
            else:
                i -= 1
                j -= 1
        rev.append(AlignmentElement(i, j, float(_dist(a[i], b[j]))))
    return rev[::-1]


def dtw_global_tb(a, b, exclude_last_element: bool = False) -> DtwResult:
    """Full-matrix global DTW with traceback (dtw.cpp:595-667).

    Dispatches to the native C implementation when the host library is
    available (path-identical; the reference also runs this in C per
    best chain at output time, rmap.cpp:715-717) — the pure-Python
    matrix fill below is the fallback and the parity oracle
    (RAWALIGN_TPU_NATIVE_TB=0 forces it)."""
    import os

    a, b = _f32(a), _f32(b)
    if os.environ.get("RAWALIGN_TPU_NATIVE_TB", "1") != "0":
        from rawalign_tpu_torch import native

        if native.available():
            ij, diff, cost = native.dtw_global_tb(a, b)
            alignment = [
                AlignmentElement(int(i), int(j), float(d))
                for (i, j), d in zip(ij, diff)
            ]
            if exclude_last_element:
                return DtwResult(
                    float(np.float32(cost) - _dist(a[-1], b[-1])),
                    alignment[:-1],
                )
            return DtwResult(cost, alignment)
    dp = _full_matrix(a, b, semiglobal=False)
    n, m = a.size, b.size
    alignment = _traceback(dp, a, b, n - 1, m - 1, stop_i_only=False)
    if exclude_last_element:
        alignment = alignment[:-1]
        score = float(dp[-1, -1] - _dist(a[-1], b[-1]))
        return DtwResult(score, alignment)
    return DtwResult(float(dp[-1, -1]), alignment)


def dtw_semiglobal_tb(a, b, exclude_last_element: bool = False) -> DtwResult:
    """Semiglobal DTW with traceback (dtw.cpp:669-753)."""
    a, b = _f32(a), _f32(b)
    dp = _full_matrix(a, b, semiglobal=True)
    n = a.size
    last = dp[-1, :]
    best_j = int(np.argmin(last))
    alignment = _traceback(dp, a, b, n - 1, best_j, stop_i_only=True)
    if exclude_last_element:
        lastel = alignment[-1]
        score = float(dp[-1, best_j] - np.float32(lastel.difference))
        return DtwResult(score, alignment[:-1])
    return DtwResult(float(dp[-1, best_j]), alignment)
