"""Compare two placements of the chain DP on a benchmark cell's reads:
the engine's default (``chain_impl="auto"``: the native C chain DP on the
host's worker pool) and the device chain kernel (``chain_impl="device"``),
both behind the cell's own stage1.

    python3 scripts/chain_placement.py [--cell NAME] [--seed 7]

For the cell (default ``ecoli5mb-sensitive-hybrid``) it runs
``bench_torch``'s own run of the cell (set-up, warm pass, timed passes,
traced pass, gate) once a placement, in the order auto, device, device,
auto, and reads the host's CPU time over the timed passes: the
process's user and system seconds summed over all its threads
(``time.process_time``), a pass and a read. Prints one
``[placement] {json}`` line a run (reads/s, the host CPU seconds,
``chain_dp_ms`` and the device's busy share, ``correct``), a table, and
the card's name and power limit. Needs a card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PLACEMENTS = {"auto": {}, "device": {"chain_impl": "device"}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="ecoli5mb-sensitive-hybrid")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chain_placement: no card", file=sys.stderr)
        return 2
    from bench_torch import run
    from rawalign_tpu_torch.kernels import build

    build.build_all()
    device = torch.device("cuda", 0)
    smi = run._card_line()
    # the card's context, before the benchmark reads its memory counters
    print(f"[placement] {torch.cuda.get_device_name(0)}; {smi}", flush=True)
    cell = run.load_cell(args.cell)
    timed = run.timed_passes
    cpu: list[float] = []

    def timed_cpu(*a, **kw):
        t0 = time.process_time()
        out = timed(*a, **kw)
        cpu.append(time.process_time() - t0)
        return out

    run.timed_passes = timed_cpu
    indexes: dict = {}
    table: dict = {}
    ok = True
    n_reads = cell["reads"]["n"]
    for name in ("auto", "device", "device", "auto"):
        kernels = cell["kernels"] + (["chain_dp"] if name == "device" else [])
        cv = dict(cell, dtw_mix=False, kernels=kernels,
                  engine={**cell["engine"], **PLACEMENTS[name]})
        rec = run.run_cell(cv, args.seed, device, indexes)
        m = rec["metrics"]
        ok &= m["correct"] is True
        cpu_s = cpu[-1] / m["timed_passes"]
        out = {"cell": args.cell, "placement": name,
               "reads_per_s": m["reads_per_s"],
               "host_cpu_s_per_pass": cpu_s,
               "host_cpu_ms_per_read": cpu_s * 1e3 / n_reads,
               "pass_s": sum(rec["details"]["pass_seconds"]) / m["timed_passes"],
               "chain_dp_ms": m.get("chain_dp_ms"),
               "device_busy_share": m["device_busy_share"],
               "correct": m["correct"], "dtw_cells": m["dtw_cells"],
               "rounds": m["rounds"], "mapped_frac": m["mapped_frac"],
               "host_top": rec["details"]["breakdown"]["host_top"][:4]}
        print("[placement] " + json.dumps(out), flush=True)
        table.setdefault(name, []).append((m["reads_per_s"], cpu_s))
    print(f"[placement] {args.cell} on {smi}:")
    for name, rows in table.items():
        print(f"[placement] {name}: " + "; ".join(
            f"{r!r} reads/s, {c!r} host CPU s a pass" for r, c in rows))
    print(smi)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
