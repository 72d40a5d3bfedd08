"""Wrapper of the banded DTW CUDA kernel (``csrc/dtw_banded.cu``).

Port of rawalign_tpu/map/dtw_pallas.py (dtw_banded_multi_indexed: every
class batch of a round). :func:`dtw_banded_round` runs the kernel once
for a whole round on CUDA tensors and the plain PyTorch version of its
formulation (``map/dtw.py:dtw_banded_round``) on CPU tensors; any other
device raises. ``launches`` counts kernel launches, one per round.
Under the NaN guard (``runtime.set_debug_nans``) the pool slots the
tiles read and the costs are checked for NaN on either device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rawalign_tpu_torch import runtime
from rawalign_tpu_torch.kernels import build
from rawalign_tpu_torch.map import dtw

#: shared memory a block may use on Hopper (bytes); a block tile keeps
#: four rows of its band's slots there, a warp tile its two sequences
MAX_SMEM = 232448
#: warps of a thread block (RA_DTW_WARPS in the kernel): a job row holds
#: its kind and this many tiles
JOB_WARPS = 8
#: the most n + m floats a warp tile stages (its share of shared memory)
STAGE_MAX = MAX_SMEM // 4 // JOB_WARPS
#: slots a lane holds in a warp tile (the kernel's instantiations)
WARP_K = (1, 2, 4)
#: the widest band a warp takes (32 * K slots); wider tiles take a block.
#: Measured on an H100 (PERF.md, section 6): 4 slots a lane beat a block on
#: bands of 65-128 slots; 8 slots a lane took 2.3x a block's time on
#: bands of 129-256, so there is no 8-slot warp tile
WARP_MAX_SLOTS = 32 * max(WARP_K)

launches = 0


@functools.cache
def _entry():
    fn = build.load("dtw_banded").ra_dtw_banded_round
    p = ctypes.c_void_p
    i64 = ctypes.c_int64
    i32 = ctypes.c_int
    fn.argtypes = [i32, p, i64, p, p, i64, p, i32, i32, i32, p, p]
    fn.restype = ctypes.c_int
    return fn


def dtw_banded_round(ref: torch.Tensor, hist: torch.Tensor,
                     descs: torch.Tensor, jobs: torch.Tensor, *,
                     block_w: int, stage: int) -> torch.Tensor:
    """(T,) float32 costs of the tiles in ``descs`` (9, T) int32, read
    from ``ref`` (Lref,) and the flattened ``hist``, in column order.
    ``jobs``, ``block_w`` and ``stage`` are ``map/tiles.py:work_list``'s
    for ``descs``; see ``map/dtw.py:dtw_banded_round``."""
    if runtime.debug_nans():
        runtime.check_finite("dtw_banded_round input",
                             *_pool_reads(ref, hist, descs))
    if ref.device.type == "cpu":
        order = jobs[:, 1:].reshape(-1)
        out = dtw.dtw_banded_round(ref, hist, descs, order=order[order >= 0])
    else:
        out = _launch(ref, hist, descs, jobs, block_w=block_w, stage=stage)
    runtime.check_finite("dtw_banded_round output", out)
    return out


def _pool_reads(ref: torch.Tensor, hist: torch.Tensor,
                descs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The values of ``ref`` and of the flattened ``hist`` that the tiles
    of ``descs`` read: ``a_base + [0, n)`` and ``b_base + [0, m)`` of
    each, in the pools' joint numbering (``map/dtw.py``)."""
    hist = hist.reshape(-1)
    lref, total = ref.numel(), ref.numel() + hist.numel()
    d = descs.to(ref.device, torch.int64)
    lo = torch.cat([d[0], d[3]]).clamp(0, total)
    hi = (lo + torch.cat([d[2], d[5]]).clamp(min=0)).clamp(max=total)
    cover = torch.zeros(total + 1, dtype=torch.int32, device=ref.device)
    one = torch.ones(lo.shape, dtype=torch.int32, device=ref.device)
    cover.index_add_(0, lo, one)
    cover.index_add_(0, hi, -one)
    read = cover.cumsum(0)[:-1] > 0
    return ref[read[:lref]], hist[read[lref:]]


def _launch(ref: torch.Tensor, hist: torch.Tensor, descs: torch.Tensor,
            jobs: torch.Tensor, *, block_w: int, stage: int) -> torch.Tensor:
    """The kernel's one launch for :func:`dtw_banded_round`."""
    global launches
    if ref.device.type != "cuda":
        raise ValueError(f"dtw_banded_round: unsupported device {ref.device}")
    dev = ref.device
    for name, x in (("ref", ref), ("hist", hist)):
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(
                f"dtw_banded_round: {name} must be contiguous float32 on {dev}"
            )
    if (descs.device != dev or descs.dtype != torch.int32 or descs.dim() != 2
            or descs.shape[0] != dtw.DESC_ROWS
            or (descs.shape[1] > 1 and descs.stride(1) != 1)):
        raise ValueError(
            "dtw_banded_round: descs must be (9, T) int32 with unit column "
            f"stride on {dev}"
        )
    if (jobs.device != dev or jobs.dtype != torch.int32 or jobs.dim() != 2
            or jobs.shape[1] != 1 + JOB_WARPS or not jobs.is_contiguous()):
        raise ValueError(
            f"dtw_banded_round: jobs must be contiguous (J, {1 + JOB_WARPS}) "
            f"int32 on {dev}"
        )
    if block_w < 0 or 16 * block_w > MAX_SMEM:
        raise ValueError(f"dtw_banded_round: band width {block_w} unsupported")
    if stage < 0 or stage > STAGE_MAX:
        raise ValueError(f"dtw_banded_round: {stage} staged floats a warp "
                         "unsupported")
    T = descs.shape[1]
    out = torch.empty(T, dtype=torch.float32, device=dev)
    if jobs.shape[0]:
        stream = torch.cuda.current_stream(dev).cuda_stream
        # the entry point sets the thread's current device; the guard
        # gives the caller's back
        with torch.cuda.device(dev):
            err = _entry()(
                dev.index, ref.data_ptr(), ref.numel(), hist.data_ptr(),
                descs.data_ptr(), descs.stride(0), jobs.data_ptr(),
                jobs.shape[0], block_w, stage, out.data_ptr(), stream,
            )
        build.check(err, "ra_dtw_banded_round")
        launches += 1
    return out
