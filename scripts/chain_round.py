"""Time the chain DP kernel alone on the all-device path's first chain
round: the round ``chip_smoke.py`` checks (B = 32, A = 65,536, W = 64).

    python3 scripts/chain_round.py --save ROUND.npz
    python3 scripts/chain_round.py --load ROUND.npz [--root DIR] [--reps 20]

``--save`` maps ``chip_smoke.py``'s dataset (a 5 Mb synthetic genome, 256
reads, the ``sensitive`` preset with DTW chain evaluation) once with the
all-device engine and writes its first chain round (seg | target | query
| n_anchors, one row a read) and the engine's chain options to ROUND.npz.
``--load`` times ``chain_cuda.chain_dp`` on that round: CUDA events around
``--reps`` launches after a warm one (ms a launch), and the median of
``--reps`` synchronised calls (the wall ``chip_smoke.py`` reports); the
result must equal ``native.chain_dp`` bit for bit. ``--root DIR`` imports
``rawalign_tpu_torch`` from DIR, a checkout of another commit, so that two
commits' kernels are timed on one round within one call. Prints one JSON
line: the times (and the device ms of each kernel from one profiled
call), the widest row, the round's runs (a new run where the
segment changes or the target jumps by more than ``max_target_gap``, in
rows sorted by segment and target), the widest run, the µs a step of the
widest row and of the widest run, and the card's name and power limit.
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def runs(seg, tgt, n, max_target_gap: int) -> list[int]:
    """Each row's run lengths, longest first (numpy, for any commit)."""
    import numpy as np

    out = []
    for b in range(seg.shape[0]):
        m = int(n[b])
        s, t = seg[b, :m].astype(np.int64), tgt[b, :m].astype(np.int64)
        ordered = bool(((s[1:] > s[:-1]) | ((s[1:] == s[:-1])
                                            & (t[1:] >= t[:-1]))).all())
        cut = ((s[1:] != s[:-1]) | (t[:-1] + max_target_gap < t[1:])
               if ordered else np.zeros(max(m - 1, 0), bool))
        starts = np.concatenate([[0], np.nonzero(cut)[0] + 1]) if m else []
        out.append(sorted(np.diff(np.append(starts, m)).tolist(), reverse=True))
    return out


def save(path: str) -> None:
    import numpy as np
    import torch

    sys.path.append(ROOT)  # chip_smoke, behind the package chosen by --root
    import chip_smoke
    from rawalign_tpu_torch.map.engine import MappingEngine

    ds, idx, _io, mo = chip_smoke.dataset()
    eng = MappingEngine(idx, mo, device=torch.device("cuda", 0), batch_size=32,
                        pipeline_depth=8, stage1_impl="device",
                        chain_impl="device")
    rounds = []
    chain_dp = eng._chain_dp

    def keep(packed, a):
        if not rounds:
            rounds.append((packed.copy(), a))
        return chain_dp(packed, a)

    eng._chain_dp = keep
    list(eng.map_reads([(r.name, r.signal) for r in ds.reads]))
    eng.close()
    packed, a = rounds[0]
    np.savez(path, packed=packed, a=a, window=eng.chain_window,
             e=idx.opt.e, max_gap=mo.max_gap_length,
             max_target_gap=mo.max_target_gap_length,
             max_skips=mo.max_num_skips)
    print(f"[chain_round] saved the first chain round, {packed.shape[0]} rows "
          f"of {a} slots, to {path}", flush=True)


def load(path: str, reps: int) -> dict:
    import numpy as np
    import torch

    from rawalign_tpu_torch import native
    from rawalign_tpu_torch.kernels import build
    from rawalign_tpu_torch.map import chain_cuda

    z = np.load(path)
    packed, a = z["packed"], int(z["a"])
    seg, tgt, qry = (np.ascontiguousarray(packed[:, k * a : (k + 1) * a])
                     for k in range(3))
    n = np.ascontiguousarray(packed[:, 3 * a])
    kw = {k: int(z[k]) for k in ("window", "e", "max_gap", "max_target_gap",
                                 "max_skips")}
    dev = torch.device("cuda", 0)
    d = [torch.from_numpy(x).to(dev) for x in (seg, tgt, qry, n)]
    got = chain_cuda.chain_dp(*d, **kw)
    torch.cuda.synchronize()
    ns, npred = native.chain_dp(seg, tgt, qry, n, **kw)
    if not (np.array_equal(got.scores.cpu().numpy(), ns)
            and np.array_equal(got.preds.cpu().numpy(), npred)):
        raise RuntimeError("chain kernel disagrees with native.chain_dp")
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        chain_cuda.chain_dp(*d, **kw)
    stop.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(stop) / reps
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        chain_cuda.chain_dp(*d, **kw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    # device time by kernel (a launch may be two kernels) from one
    # profiled call
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        chain_cuda.chain_dp(*d, **kw)
        torch.cuda.synchronize()
    by_kernel: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + (
                ev.time_range.end - ev.time_range.start) / 1e3
    lens = runs(seg, tgt, n, kw["max_target_gap"])
    widest_run = max((r[0] for r in lens if r), default=0)
    widest = int(n.max())
    return {"package": os.path.dirname(os.path.dirname(chain_cuda.__file__)),
            "B": int(n.size), "A": a, **kw, "event_ms": event_ms,
            "wall_ms": wall_ms, "reps": reps, "device_ms_by_kernel": by_kernel,
            "widest_row": widest,
            "runs": sum(len(r) for r in lens), "widest_run": widest_run,
            "us_per_step_widest_row": event_ms * 1e3 / max(widest, 1),
            "us_per_step_widest_run": event_ms * 1e3 / max(widest_run, 1),
            "runs_over_1000": sum(x > 1000 for r in lens for x in r),
            "bit_identical_to_native": True,
            "ptxas": [ln.strip() for ln in build.build_log("chain_dp").splitlines()
                      if "registers" in ln or "spill" in ln]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--save")
    ap.add_argument("--load")
    ap.add_argument("--root", help="import rawalign_tpu_torch from this checkout")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root) if args.root else ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chain_round: no card", file=sys.stderr)
        return 2
    if args.save:
        save(args.save)
    if args.load:
        rec = load(args.load, args.reps)
        rec["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print("[chain_round] " + json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
