"""Copy of rawalign_tpu/io/paf.py for the port.

PAF emission (Uncalled-style modified PAF).

Reproduces the reference's output format exactly: mapped lines
(rmap.cpp:961-963) and unmapped lines (rmap.cpp:965), with the tag string
built in map_worker_for (rmap.cpp:730-747,760-790). Float tags use C++
std::to_string formatting (6 fixed decimals).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _f(x: float) -> str:
    """std::to_string(float): fixed 6 decimals."""
    return f"{x:.6f}"


def position_scale_f32(
    n_chunks: int, chunk_size: int, offset: int,
    sample_rate: float, bp_per_sec: float,
) -> np.float32:
    """read_position_scale in the reference's exact float32 arithmetic
    (rmap.cpp:698): ((float)(cc+1)*l_chunk/offset) /
    ((float)sample_rate/bp_per_sec), every step rounded to f32."""
    num = np.float32(
        np.float32(np.float32(n_chunks) * np.float32(chunk_size))
        / np.float32(max(offset, 1))
    )
    den = np.float32(np.float32(sample_rate) / np.float32(bp_per_sec))
    return np.float32(num / den)


def scale_pos(scale32: np.float32, pos: int) -> int:
    """(uint32_t)(read_position_scale * position): f32 product then
    C truncation toward zero (rmap.cpp:750-752,793)."""
    return int(np.float32(np.float32(scale32) * np.float32(pos)))


def anchor_gap_means_f32(anchors) -> tuple[float, float]:
    """at/aq tags: mean consecutive-anchor gap of the best chain.

    Bit-identical to the reference (rmap.cpp:719-729): a float32
    left-fold of the per-pair uint32 deltas, then a float32 division by
    n_anchors0. The deltas and partial sums are exact integers until the
    sum crosses 2^24, so the fold must stay in f32 to round exactly
    where the C code does. np.cumsum is a sequential accumulate, i.e.
    the same left fold.
    """
    a = np.asarray(anchors)
    n = a.shape[0]
    if n < 2:
        # the C loop adds nothing; 0.0f / n
        z = np.float32(0.0) / np.float32(max(n, 1))
        return float(z), float(z)
    # C subtracts uint32s (wrapping) before the float conversion
    d = (a[:-1, :2].astype(np.int64) - a[1:, :2].astype(np.int64)) & 0xFFFFFFFF
    nf = np.float32(n)
    tot = d.sum(axis=0)
    if d.max() < (1 << 24) and tot.max() < (1 << 24):
        # deltas non-wrapped and every (monotone) partial sum is an
        # exact integer in f32 -> the fold never rounds; skip the cumsum
        return (
            float(np.float32(tot[0]) / nf),
            float(np.float32(tot[1]) / nf),
        )
    sums = np.cumsum(d.astype(np.uint32).astype(np.float32), axis=0,
                     dtype=np.float32)[-1]
    return float(sums[0] / nf), float(sums[1] / nf)


_F32 = np.float32


def mean_score_f32(scores) -> float:
    """sm tag: float32 left-fold of chain scores / n (rmap.cpp:707-711).

    Chain lists are tiny (<= 2*num_best_chains); a scalar np.float32
    fold beats the array round trip by ~10x at these sizes (this runs
    per emitted read — engine hot path)."""
    n = len(scores)
    if n == 0:
        return 0.0
    acc = _F32(0.0)
    for s in scores:
        acc = _F32(acc + _F32(s))
    return float(acc / _F32(n))


@dataclasses.dataclass
class MappingResult:
    """One read's final mapping outcome (mirror of ri_reg1_t, rmap.h:48-64)."""

    read_name: str
    read_length: int
    mapped: bool
    # mapped-only fields
    read_start_position: int = 0
    read_end_position: int = 0
    ref_name: str = ""
    ref_len: int = 0
    fragment_start_position: int = 0
    fragment_length: int = 0
    rev: int = 0
    mapq: int = 0
    tags: str = ""


def build_tags(
    *,
    mapping_time_ms: float,
    n_chunks: int,
    qlen: int,
    n_anchors0: int = 0,
    n_chains: int = 0,
    s1: float = 0.0,
    s2: float = 0.0,
    sm: float = 0.0,
    at: float = 0.0,
    aq: float = 0.0,
    mapped_with_chains: bool = False,
    alns: float | None = None,
    aln: str | None = None,
    anchors: str | None = None,
) -> str:
    """Tag string (rmap.cpp:730-747 mapped; 760-790 unmapped)."""
    tags = f"mt:f:{_f(mapping_time_ms)}"
    tags += f"\tci:i:{n_chunks}"
    tags += f"\tsl:i:{qlen}"
    if mapped_with_chains or n_chains >= 1:
        tags += f"\tcm:i:{n_anchors0}"
        tags += f"\tnc:i:{n_chains}"
        tags += f"\ts1:f:{_f(s1)}"
        tags += f"\ts2:f:{_f(s2)}"
        tags += f"\tsm:f:{_f(sm)}"
        tags += f"\tat:f:{_f(at)}"
        tags += f"\taq:f:{_f(aq)}"
    else:
        tags += "\tcm:i:0\tnc:i:0\ts1:f:0\ts2:f:0\tsm:f:0\tat:f:0\taq:f:0"
    if alns is not None:
        tags += f"\talns:f:{_f(alns)}"
    if aln is not None:
        tags += f"\taln:s:{aln}"
    if anchors is not None:
        tags += f"\tanchors:s:{anchors}"
    return tags


def paf_line(r: MappingResult) -> str:
    if r.mapped:
        strand = "-" if r.rev else "+"
        return (
            f"{r.read_name}\t{r.read_length}\t{r.read_start_position}"
            f"\t{r.read_end_position}\t{strand}\t{r.ref_name}\t{r.ref_len}"
            f"\t{r.fragment_start_position}"
            f"\t{r.fragment_start_position + r.fragment_length}"
            f"\t{(r.read_end_position - r.read_start_position - 1) & 0xFFFFFFFF}"
            f"\t{r.fragment_length}\t{r.mapq}\t{r.tags}"
        )
    return f"{r.read_name}\t{r.read_length}\t*\t*\t*\t*\t*\t*\t*\t*\t*\t{r.mapq}\t{r.tags}"
