"""Time and profile the port's mapping paths on one CUDA card.

    python -m rawalign_tpu_torch.profile_paths [--paths hybrid,device,fused] [--passes 3]

Maps the dataset of ``chip_smoke.py`` (a 5 Mb synthetic genome, 256
reads, the ``sensitive`` preset with DTW chain evaluation; batch 32,
8 pipeline groups) through each path named: ``hybrid`` (the default
placements), ``device`` (``stage1_impl="device", chain_impl="device"``)
and ``fused`` (the same with ``fused=True`` and ``max_anchors=65536``,
the budget at which this dataset's widest first round, 52,208 anchors,
stays in the fused chain DP instead of escalating).
Per path: one warm pass, ``--passes`` timed passes (reads/s, each ending
in ``torch.cuda.synchronize()``), then one pass under ``torch.profiler``:
the device's busy share (the union of the intervals in which a kernel,
copy or fill ran, over the pass wall), device time per kernel name
(the 12 longest and every kernel of the port) and the engine's counters
(the fused path's escalations and prefix refetches among them);
with ``--cprofile N``, one more pass under ``cProfile`` and the N
functions with the most self time on the main thread (the host work the
worker pool runs in C is not in it). Prints one JSON object per path,
then the card's name and power limit. It fails without a card.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import subprocess
import time

PLACEMENTS = {
    "hybrid": {},
    "device": {"stage1_impl": "device", "chain_impl": "device"},
    "fused": {"stage1_impl": "device", "chain_impl": "device", "fused": True,
              "max_anchors": 65536},
}


def _busy_ms(prof) -> tuple[float, dict[str, list]]:
    """(union of device intervals in ms, {kernel name: [ms, launches]})."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        t0, t1 = ev.time_range.start, ev.time_range.end
        spans.append((t0, t1))
        rec = by_name.setdefault(ev.name, [0.0, 0])
        rec[0] += (t1 - t0) / 1e3
        rec[1] += 1
    busy, end = 0.0, None
    for t0, t1 in sorted(spans):
        if end is None or t0 > end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    return busy / 1e3, by_name


def _host_top(eng, reads, n: int) -> list:
    """[(function, self s, cumulative s, calls)] of one pass, the n with
    the most self time."""
    import torch

    prof = cProfile.Profile()
    prof.enable()
    list(eng.map_reads(reads))
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof).stats
    rows = [(f"{fn}:{line}({func})", tt, ct, nc)
            for (fn, line, func), (_cc, nc, tt, ct, _callers) in st.items()]
    return sorted(rows, key=lambda r: -r[1])[:n]


def profile_path(name, idx, mo, reads, passes: int, top: int) -> dict:
    import torch

    from rawalign_tpu_torch.map.engine import MappingEngine

    out = {"path": name}
    with MappingEngine(idx, mo, device="cuda", batch_size=32,
                       pipeline_depth=8, **PLACEMENTS[name]) as eng:
        list(eng.map_reads(reads))
        torch.cuda.synchronize()
        rates = []
        for _ in range(passes):
            t0 = time.perf_counter()
            n = len(list(eng.map_reads(reads)))
            torch.cuda.synchronize()
            rates.append(n / (time.perf_counter() - t0))
        out["reads_per_s"] = rates
        for d in (eng.phase_times, eng.counters):
            for k in d:
                d[k] = 0
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            list(eng.map_reads(reads))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy, by_name = _busy_ms(prof)
        out.update(
            profiled_wall_ms=wall, device_busy_ms=busy,
            device_busy_share=busy / wall,
            phase_seconds=dict(eng.phase_times),
            counters=dict(eng.counters),
            # the 12 longest, and the port's own kernels however short
            kernels_ms={k[:80]: v for n, (k, v) in enumerate(sorted(
                by_name.items(), key=lambda kv: -kv[1][0]))
                if n < 12 or "ra_" in k},
        )
        if top:
            out["host_top"] = _host_top(eng, reads, top)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", default="hybrid,device")
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--cprofile", type=int, default=0, metavar="N")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_paths: no CUDA card")
    from rawalign_tpu_torch import config
    from rawalign_tpu_torch.index import index as dindex
    from rawalign_tpu_torch.testing import synth

    ds = synth.make_dataset(seed=7, genome_lengths=[5_000_000], n_reads=256,
                            read_len_bp=(400, 1200), noise_pa=1.5)
    io, mo = config.IndexOptions(), config.MappingOptions()
    config.set_opt("sensitive", io, mo)
    mo.set_flag(config.MappingFlag.DTW_EVALUATE_CHAINS)
    idx = dindex.build_index(ds.seqs, ds.model.pore_vals, io)
    reads = [(r.name, r.signal) for r in ds.reads]
    for name in args.paths.split(","):
        print(json.dumps(profile_path(name, idx, mo, reads, args.passes,
                                      args.cprofile)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
