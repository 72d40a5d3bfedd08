"""Device side of the stage1 packed layout (port of the torch-facing half
of rawalign_tpu/map/stage1_codec.py).

The layout is defined once, in the JAX package's codec; this module
produces it with PyTorch so that the shared numpy ``unpack_stage1``
reads the port's output unchanged::

    [ ev_values (NE, optional) | lo (NS) | qc (NS) | scalars (4) ]

with the int32 blocks bitcast into float32. The event block rides the
download only when the host needs the event values and did not detect
them itself: the device stage1 with CIGAR output (the JAX engine's
``_s1_dl_events``). On the hybrid path the host already holds them.
"""

from __future__ import annotations

import torch

from rawalign_tpu.map.stage1_codec import (  # noqa: F401  (shared numpy half)
    Stage1Host,
    pack_qc,
    unpack_stage1,
    validate_bounds,
)


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
