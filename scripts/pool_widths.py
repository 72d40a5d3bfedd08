"""Compare the engine's host pools on benchmark cells, and read the host
jobs' spans.

    python3 scripts/pool_widths.py [--cell NAME]... [--variants 8,7,4] [--spans] [--seed 7]

A variant is ``W[/BLOCKS][/EVENTS]``: ``W`` the worker pool's width
(``pool_workers``); ``BLOCKS`` ``adapt`` (the engine's: a round's tail in
at most one block a worker and one a ``ROW_BLOCK_ANCHORS`` of anchor
demand) or ``all`` (one block a worker whatever the demand); ``EVENTS``
``own`` (the engine's: event detection on a pool of its own as wide as
the worker pool), ``ownN`` (a pool of its own of N threads) or
``shared`` (detection queued in the worker pool, as before the pools
were split).

For each cell (default: ecoli5mb-sensitive-hybrid, ecoli5mb-nodtw-hybrid,
genome50mb-maxocc32k-hybrid, ecoli5mb-cigar-hybrid) and each variant, in
turns (the variants in order for the first cell, reversed for the next,
and so on): ``bench_torch``'s own run of the cell (set-up, warm pass,
timed passes, traced pass, gate) with the variant's engine; the index is
built once a genome. With ``--spans``, per cell and variant one more pass
under ``torch.profiler`` with every thread profiled: the ms of each host
job's span (``host.events``, ``host.expand``, ``host.chain_dp``,
``host.round_chains``, ``host.chains_of_round``, ``host.dtw_native``)
summed over the threads, its count, and that sum over the pass wall (how
many threads it kept busy on average). The benchmark's own traced pass
profiles only the main thread, so it holds none of these spans.

Prints one ``[widths] {json}`` line per cell and variant, a table of
reads/s by variant, the host's CPU count and the card's name and power
limit. Needs a card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CELLS = ["ecoli5mb-sensitive-hybrid", "ecoli5mb-nodtw-hybrid",
         "genome50mb-maxocc32k-hybrid", "ecoli5mb-cigar-hybrid"]
SPANS = ("host.events", "host.expand", "host.chain_dp", "host.round_chains",
         "host.chains_of_round", "host.dtw_native")


@contextlib.contextmanager
def variant(spec: str):
    """Yield the engine keywords of ``spec``; while open, every engine
    ``bench_torch.run.engine`` builds has the variant's blocks and event
    pool."""
    from bench_torch import run
    from rawalign_tpu_torch.map import engine as E

    width, blocks, events = (spec.split("/") + ["adapt", "own"])[:3]
    if blocks not in ("adapt", "all") or not (
            events in ("own", "shared") or events[3:].isdigit()):
        raise SystemExit(f"pool_widths: bad variant {spec!r}")
    make, anchors = run.engine, E.ROW_BLOCK_ANCHORS

    def engine(*args, **kw):
        eng = make(*args, **kw)
        if events != "own":
            eng._events_pool.shutdown()
            eng._events_pool = (
                eng._pool if events == "shared"
                else concurrent.futures.ThreadPoolExecutor(int(events[3:])))
        return eng

    run.engine = engine
    if blocks == "all":
        E.ROW_BLOCK_ANCHORS = 1
    try:
        yield {"pool_workers": int(width)}
    finally:
        run.engine, E.ROW_BLOCK_ANCHORS = make, anchors


def span_pass(cell: dict, idx, mo, reads, device) -> dict:
    """One warm and one traced pass of ``cell``'s engine with every
    thread profiled: {span: [ms summed over threads, count, ms / wall ms]}
    and the pass wall."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    from bench_torch import run

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with run.engine(cell, idx, mo, device) as eng:
        list(eng.map_reads(reads))
        run._sync(device)
        cfg = _ExperimentalConfig(profile_all_threads=True)
        with profile(activities=acts, experimental_config=cfg) as prof:
            t0 = time.perf_counter()
            list(eng.map_reads(reads))
            run._sync(device)
            wall = time.perf_counter() - t0
    spans = {k: [0.0, 0] for k in SPANS}
    threads = set()
    for ev in prof.events():
        if ev.name in spans:
            spans[ev.name][0] += (ev.time_range.end - ev.time_range.start) / 1e3
            spans[ev.name][1] += 1
            threads.add(ev.thread)
    for rec in spans.values():
        rec.append(rec[0] / (wall * 1e3))
    return {"wall_s": wall, "spans": spans, "threads": len(threads)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", action="append", metavar="NAME")
    ap.add_argument("--variants", default="8,7,4")
    ap.add_argument("--spans", action="store_true")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("pool_widths: no card", file=sys.stderr)
        return 2
    from bench_torch import run
    from rawalign_tpu_torch.kernels import build
    from rawalign_tpu_torch.map.engine import host_cpus

    build.build_all()
    device = torch.device("cuda", 0)
    specs = args.variants.split(",")
    smi = run._card_line()
    print(f"[widths] host CPUs (affinity) {host_cpus()}, os.cpu_count() "
          f"{os.cpu_count()}; {torch.cuda.get_device_name(0)}; {smi}",
          flush=True)
    indexes: dict = {}
    table: dict = {}
    ok = True
    for n, name in enumerate(args.cell or CELLS):
        cell = run.load_cell(name)
        ds = run.dataset(cell, args.seed)
        reads = [(r.name, r.signal) for r in ds.reads]
        _io, mo = run.options(cell)
        for spec in (specs if n % 2 == 0 else specs[::-1]):
            t0 = time.perf_counter()
            with variant(spec) as kw:
                # the DTW kernel's tile mixes do not use the pools
                cv = dict(cell, dtw_mix=False, engine={**cell["engine"], **kw})
                try:
                    rec = run.run_cell(cv, args.seed, device, indexes)
                except Exception as e:  # one failed run must not hide the rest
                    traceback.print_exc()
                    print(f"[widths] {name} {spec} failed: {e}", flush=True)
                    ok = False
                    continue
                m, d = rec["metrics"], rec["details"]
                ok &= m["correct"] is True
                br = d["breakdown"]
                out = {"cell": name, "variant": spec, "metrics": m,
                       "host_top": br["host_top"][:5],
                       "idle_gaps": br["idle_gaps"][:3],
                       "phase_seconds": d["phase_seconds"],
                       "cell_wall_s": time.perf_counter() - t0}
                if args.spans:
                    idx = indexes[(tuple(cell["genome_lengths"]), cell["preset"])][0]
                    out["span_pass"] = span_pass(cv, idx, mo, reads, device)
            print("[widths] " + json.dumps(out), flush=True)
            table.setdefault(name, {})[spec] = (m["reads_per_s"], m["correct"])
    print(f"[widths] reads/s by variant on {smi}:")
    for name, by_v in table.items():
        print(f"[widths] {name}: " + "; ".join(
            f"{v}: {r!r} (correct {c})" for v, (r, c) in by_v.items()))
    print(smi)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
