"""Copy of rawalign_tpu/map/stage1_codec.py for the port: its numpy half
verbatim, its device half in PyTorch.

The stage1 packed layout is defined here once: the device side of a
round (:func:`pack_stage1`) writes it and the host side
(:func:`unpack_stage1`) reads it back. Layout, per row (int blocks
bitcast into the f32 payload)::

    [ ev_values (NE, optional) | lo (NS) | qc (NS) | scalars (4) ]

where ``qc`` packs (qpos, count) into one int32 as ``(qpos << 16) |
count``: qpos < 2**15 (bounded by max_events_per_chunk) and count <=
0xFFFF (bounded by max_occ), validated by :func:`validate_bounds` at
engine construction so misconfiguration fails loudly instead of
corrupting anchors via the sign-extending unpack shift.

The four scalar columns are, in order: n_events, n_events_dropped,
n_occ_dropped (seed hits dropped by the occurrence cap), and
n_compact_dropped (valid seeds beyond the compaction width).

The event block rides the download only when the host needs the event
values and did not detect them itself: the device stage1 with CIGAR
output (the JAX engine's ``_s1_dl_events``). On the hybrid path the host
already holds them.

The fused stage1+chain (``MappingEngine(fused=True)``) appends the chain
DP's first ``a`` columns of scores and of predecessors (bitcast) to the
same row: :func:`pack_stage1_fused` and :func:`unpack_stage1_fused`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

#: qpos rides the high 16 bits through a signed int32; the unpack is an
#: arithmetic shift, so qpos must stay below 2**15 to keep the sign bit
#: clear.
QPOS_LIMIT = 1 << 15
#: count occupies the low 16 bits.
COUNT_LIMIT = 1 << 16
#: trailing int32 scalar columns (see module docstring for the order).
N_SCALARS = 4


def validate_bounds(max_events_per_chunk: int, max_occ: int) -> None:
    """Fail loudly on configurations the packed codec cannot represent.

    Called from MappingEngine.__init__: both bounds are user-settable
    (config max_events_per_chunk, CLI --max_occ) and exceeding either
    would silently corrupt anchors on unpack.
    """
    if not 0 < max_events_per_chunk < QPOS_LIMIT:
        raise ValueError(
            f"max_events_per_chunk={max_events_per_chunk} out of range for "
            f"the stage1 (qpos, count) packing: need 0 < value < {QPOS_LIMIT}"
        )
    if not 0 < max_occ < COUNT_LIMIT:
        raise ValueError(
            f"max_occ={max_occ} out of range for the stage1 (qpos, count) "
            f"packing: need 0 < value < {COUNT_LIMIT}"
        )


def pack_qc(qpos, count):
    """Pack (qpos, count) int32 arrays into one int32 word.

    Works on both torch and np arrays (pure arithmetic). Inputs must obey
    :func:`validate_bounds`.
    """
    return (qpos << 16) | count


def unpack_qc(qc):
    """Inverse of :func:`pack_qc` -> (qpos, count)."""
    return qc >> 16, qc & 0xFFFF


def hits_first_perm(count: torch.Tensor) -> torch.Tensor:
    """Stable permutation putting nonzero-count seed columns first (the
    JAX codec's ``lax.sort((flag, idx), num_keys=1)``)."""
    flag = (count == 0).to(torch.int32)
    return torch.sort(flag, dim=1, stable=True).indices


def pack_stage1(lo: torch.Tensor, qc: torch.Tensor, scalars: torch.Tensor,
                ev_values: torch.Tensor | None = None) -> torch.Tensor:
    """(B, [NE +] 2*NS + 4) float32: the events (if given), then the int32
    blocks bitcast."""
    parts = [] if ev_values is None else [ev_values.to(torch.float32)]
    parts += [x.to(torch.int32).contiguous().view(torch.float32)
              for x in (lo, qc, scalars)]
    return torch.cat(parts, dim=1)


def pack_stage1_fused(lo: torch.Tensor, qc: torch.Tensor,
                      scalars: torch.Tensor, ev_values: torch.Tensor | None,
                      scores: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """The fused stage1+chain layout: :func:`pack_stage1`'s row followed
    by the chain DP's ``scores`` (B, a) float32 and ``preds`` (B, a)
    int32 bitcast. The host replays the expansion from (lo, qc) and reads
    scores and preds only when its replayed anchor count fits ``a``."""
    return torch.cat([
        pack_stage1(lo, qc, scalars, ev_values),
        scores.to(torch.float32),
        preds.to(torch.int32).contiguous().view(torch.float32),
    ], dim=1)


class Stage1Host(NamedTuple):
    """Host view of one round's unpacked stage1 output."""

    ev_values: np.ndarray | None  # (B, NE) f32, None when device-resident
    lo: np.ndarray  # (B, NS) int32 — global index-table offsets
    qpos: np.ndarray  # (B, NS) int32
    count: np.ndarray  # (B, NS) int32 — 0 for invalid/over-cap seeds
    n_events: np.ndarray  # (B,) int32
    n_ev_dropped: np.ndarray  # (B,) int32
    n_occ_dropped: np.ndarray  # (B,) int32
    n_compact_dropped: np.ndarray  # (B,) int32


def unpack_stage1(packed: np.ndarray, *, ne: int, ns: int,
                  events_on_host: bool) -> Stage1Host:
    """Decode the fetched packed f32 array back into host arrays."""
    expect = (ne if events_on_host else 0) + 2 * ns + N_SCALARS
    if packed.shape[1] != expect:
        raise ValueError(
            f"stage1 packed width {packed.shape[1]} != expected {expect} "
            f"(ne={ne}, ns={ns}, events_on_host={events_on_host}) — "
            "producer/consumer layout drift"
        )
    pi = packed.view(np.int32)
    base = ne if events_on_host else 0
    ev_values = packed[:, :ne] if events_on_host else None
    lo = pi[:, base : base + ns]
    qc = pi[:, base + ns : base + 2 * ns]
    qpos, count = unpack_qc(qc)
    return Stage1Host(
        ev_values=ev_values,
        lo=lo,
        qpos=qpos,
        count=count,
        n_events=pi[:, -4],
        n_ev_dropped=pi[:, -3],
        n_occ_dropped=pi[:, -2],
        n_compact_dropped=pi[:, -1],
    )


class Stage1FusedHost(NamedTuple):
    stage1: Stage1Host
    scores: np.ndarray  # (B, a) f32
    preds: np.ndarray  # (B, a) int32


def unpack_stage1_fused(packed: np.ndarray, *, ne: int, ns: int, a: int,
                        events_on_host: bool) -> Stage1FusedHost:
    """Decode :func:`pack_stage1_fused`'s fetched row."""
    base = (ne if events_on_host else 0) + 2 * ns + N_SCALARS
    if packed.shape[1] != base + 2 * a:
        raise ValueError(
            f"fused stage1 packed width {packed.shape[1]} != expected "
            f"{base + 2 * a} (ne={ne}, ns={ns}, a={a}, "
            f"events_on_host={events_on_host}) — producer/consumer "
            "layout drift"
        )
    s1 = unpack_stage1(
        packed[:, :base], ne=ne, ns=ns, events_on_host=events_on_host
    )
    scores = packed[:, base : base + a]
    preds = packed.view(np.int32)[:, base + a :]
    return Stage1FusedHost(stage1=s1, scores=scores, preds=preds)
