"""Wrapper of the sketch-scan CUDA kernel (``csrc/sketch_scan.cu``).

Port of rawalign_tpu/seeds/sketch_pallas.py. :func:`sketch_scan` runs
the kernel on CUDA tensors and the plain PyTorch scan
(``seeds/sketch.py:_sketch_scan``) on CPU tensors; any other device
raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rawalign_tpu_torch.kernels import build
from rawalign_tpu_torch.seeds import sketch

#: the widest seed the port takes (``e`` events a seed), as the JAX
#: package's kernel
MAX_E = 16
#: shared memory a block may use on Hopper (bytes). A block keeps four
#: rows of NE + 1 words there (the events, the jump pointers and then the
#: kept count, the kept list, the 32-fold jump pointers), or in a device
#: buffer when they do not fit
MAX_SMEM = 232448
#: bytes of the kernel's static shared memory, rounded up
_STATIC_SMEM = 64

launches = 0


@functools.cache
def _entry():
    fn = build.load("sketch_scan").ra_sketch_scan
    p = ctypes.c_void_p
    i = ctypes.c_int
    fn.argtypes = [i, p, p, i, i, i, i, i, p, ctypes.c_int64, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def sketch_scan(events: torch.Tensor, n_events: torch.Tensor, *, e: int,
                q: int, lq: int):
    """(hashes int64, emit bool, newest int64, oldest int32, cnt int32),
    each (B, NE) — the outputs of ``sketch._sketch_scan``."""
    global launches
    if events.device.type == "cpu":
        return sketch._sketch_scan(events, n_events, e, q, lq)
    if events.device.type != "cuda":
        raise ValueError(f"sketch_scan: unsupported device {events.device}")
    if events.dtype != torch.float32 or events.dim() != 2:
        raise ValueError("sketch_scan: events must be a 2-D float32 tensor")
    B, NE = events.shape
    if (n_events.device != events.device or n_events.dtype != torch.int32
            or tuple(n_events.shape) != (B,)):
        raise ValueError("sketch_scan: n_events must be int32 (B,) on the "
                         "events' device")
    if not (events.is_contiguous() and n_events.is_contiguous()):
        raise ValueError("sketch_scan: inputs must be contiguous")
    if not 1 <= e <= MAX_E or not 1 <= q <= 32 or not 0 <= lq < 30:
        raise ValueError(f"sketch_scan: unsupported e={e} q={q} lq={lq}")
    dev = events.device
    hashes = torch.empty((B, NE), dtype=torch.int64, device=dev)
    emit = torch.empty((B, NE), dtype=torch.bool, device=dev)
    oldest = torch.empty((B, NE), dtype=torch.int32, device=dev)
    cnt = torch.empty((B, NE), dtype=torch.int32, device=dev)
    if B and NE:
        smem = 16 * (NE + 1)
        scratch = None
        if smem + _STATIC_SMEM > MAX_SMEM:
            scratch = torch.empty(B * 4 * (NE + 1), dtype=torch.int32,
                                  device=dev)
            smem = 0
        stream = torch.cuda.current_stream(dev).cuda_stream
        # the entry point sets the thread's current device; the guard
        # gives the caller's back
        with torch.cuda.device(dev):
            err = _entry()(
                dev.index, events.data_ptr(), n_events.data_ptr(), B, NE, e,
                q, lq, None if scratch is None else scratch.data_ptr(), smem,
                hashes.data_ptr(), emit.data_ptr(), oldest.data_ptr(),
                cnt.data_ptr(), stream,
            )
        build.check(err, "ra_sketch_scan")
        launches += 1
    newest = torch.arange(NE, device=dev).expand(B, NE)
    return hashes, emit, newest, oldest, cnt
