#!/usr/bin/env python3
"""Drive the PyTorch port's mapping paths once on one CUDA card.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. the card: name and power limit, as nvidia-smi reports them;
2. the native host library: probed in a subprocess, rebuilt once with
   ``make -C native -B`` if the probe fails (the committed library may
   have been built for another CPU);
3. all four CUDA kernels built from ``rawalign_tpu_torch/csrc``, one
   nvcc process per source, all started together;
4. the hybrid path (host events, device sketch and lookup, native chain
   DP and round tail, device DTW) on a 5 Mb synthetic genome (about
   8.4 M index keys), 256 reads, the ``sensitive`` preset plus DTW chain
   evaluation: a warm pass (whose first DTW round is kept), then the
   sketch and DTW kernels checked bit for bit against their plain
   PyTorch versions on the card at the shapes of that path — the sketch
   scan at B=32, NE=2048, e=6 (and on a batch of awkward rows: masked
   starts and runs, a row of similar events, NaN events, 0, 1, e-1 and e
   events, a seed wider than the uint32 pack), the banded DTW on the
   kept round's tiles and on a synthetic tile mix up to 2048, one launch
   a round, against the per-class plain version, the plain round and
   native (each class's tile count and longest n logged, and the
   recurrence floor: the longest tile's n-1 iterations at the time per
   iteration it takes alone) — and timed beside them; the non-indexed
   dispatch (``tiles.dtw_banded_pairs``, the JAX package's
   ``dtw_banded_multi``) on the same two rounds as raw pairs and on 64
   tiles of n 4096 at a 10% band (``tools/check_dtw.py``'s), bit for bit
   against native, one launch a call; then
   the launch counters are zeroed and a timed pass maps every read
   again. It fails if either kernel was not launched in that pass, if
   the DTW kernel took other than one launch in each round that had
   device tiles, or no DTW tile ran on the card, and unless the first 16
   reads' PAF lines equal the golden engine's byte for byte (mt:f
   stripped);
5. the all-device path (``stage1_impl="device", chain_impl="device"``:
   device events, sketch and lookup, host expansion, device chain DP,
   Python round tail, device DTW) on the same reads: a warm pass (whose
   first chain round is kept), then the event kernel checked on the
   first chunk of 32 reads (B=32, L=4000) against its plain version on
   the card and the native detector (and on a batch of awkward rows:
   empty, constant, one event, too short and just long enough for the
   long window, the long detector masked at the last sample, noise; then
   on 32 rows of white noise and 32 of long dwells, where it also logs
   how many chunks of the peak machine ran again and the time per call),
   the chain kernel on the kept round
   and on two synthetic rounds of 16384 anchors (W=64, segments sorted;
   W=2048, segments interleaved) against both plain versions (the plain
   DP on the card, the kernel-step scan on the host CPU) and
   ``native.chain_dp``, and at W=12000 (its rings in device memory)
   against the plain DP and native, logging each round's runs (a warp
   each), its widest run and the time per step of that run beside the
   figure before the run split; then the counters are zeroed and a timed pass
   maps every read. It fails unless
   all four kernels launched in that pass and its 256 PAF lines equal
   the hybrid pass's byte for byte (mt:f stripped), the first 16 also
   the golden engine's;
6. the modes ported last, each in one timed pass of the 256 reads with
   the launch counters zeroed just before and read just after:
   a. CIGAR and chain output (``DTW_OUTPUT_CIGAR | OUTPUT_CHAINS``) on
      the hybrid path, whose rounds end in the Python tail: columns 1-12
      and every tag but mt/aln/alns/anchors equal phase 4's lines, the
      first 16 lines equal golden's with the same flags;
   b. the same flags on the all-device path: the events ride the stage1
      download and every DTW launch reads the per-round uploaded event
      pool; all 256 lines equal 6a's;
   c. the ``faster`` preset (minimizers, w=5 e=7) on a second index of
      the same genome: the sketch kernel feeding the minimizer filter at
      B=32, NE=2048 against the CPU result, then a hybrid and an
      all-device pass whose PAFs must be equal, the first 16 lines also
      to the same engine at ``device="cpu"`` (plain versions);
   d. ``stage1_impl="host"`` (host events, sketch and lookup; device
      DTW): the first 16 lines equal the same engine at ``device="cpu"``;
7. the distributed engine (``parallel/dist_engine.py``) over a mesh of
   four ranks, four distinct cards when the machine has them, else four
   ranks on the one card: a warm and a timed pass with the hybrid stage1
   on a (2, 2) mesh and with the device stage1 on a (1, 4) mesh. All 256
   PAF lines of each timed pass must equal phase 5's; in each, every rank
   launches the sketch kernel once a round and the chain kernel's two
   launches (window pass, recurrence) once (and the event kernel under
   the device stage1) and the DTW kernel once a round when
   it has tiles. The routed stage1 (all-to-all lookup) is held to the
   one-card stage1 on a captured round, and phase 4's captured DTW round,
   dealt over the ranks, to the one-launch round bit for bit. It logs
   reads/s beside phases 4 and 5, the all-to-all bytes a round and each
   rank's longest DTW tile;
8. the fused stage1+chain (``fused=True``, device stage1 and chain) at
   ``max_anchors=65536``, where the widest first round stays fused: a
   warm and a timed pass whose 256 PAF lines must equal phase 5's, with
   no escalation, a DP prefix refetch in each chained round, the event
   and sketch kernels launched once a round, the chain kernel's two
   launches once, and the DTW kernel
   once a round with device tiles; it logs reads/s beside phases 4 and 5
   and the chain-upload bytes the fused rounds no longer send. Then one
   pass at the default budget (2048), whose wide rows escalate, against
   the unfused all-device engine at the same ceiling: equal PAFs;
9. the port's CLI on the card: ``python -m rawalign_tpu_torch.cli`` in a
   subprocess with no ``--device`` (the default ``cuda``), on the genome
   of phases 4-5 written as FASTA with its pore model and the 256 reads
   in the float32 ``.sigbin.npz`` container. Seven runs: the hybrid
   default and the all-device placement, each with no flag, with
   ``--profile DIR`` and with ``--debug-nans``, and the hybrid with both
   (run a; run b is the all-device ``--profile``). Each must exit 0 with
   all 256 PAF lines equal to phase 4's (hybrid) or phase 5's
   (all-device), and each ``--profile`` run's Chrome trace must name
   the sketch and DTW kernels (and the event and chain kernels on the
   all-device placement). Each run's wall and reads/s after the index
   are logged beside the card's name and power limit.

``python3 -c 'import chip_smoke; chip_smoke.distributed_only()'`` runs
phases 1-3, the timed passes of 4 and 5 and phase 7 alone (a minute or
two), for a machine with four cards.

Every kernel's record carries its time, its plain version's, its
launches in the timed passes of phases 5 and 8 (two a call for the chain
kernel: the window pass and the recurrence; the all-device and the
fused path), and its bound: the larger of the bytes its launch must move at the card's memory
rate and the operations this run's data needs at its scalar rate (see
``bound``).
The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. It imports neither JAX nor the JAX
package: the golden engine, options, index build and native bindings are
the port's own copies.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GENOME_LEN = 5_000_000
N_READS = 256
N_GOLDEN = 16
N_SYNTH = 512  # synthetic DTW tiles, read side up to SYNTH_MAX_LEN events
SYNTH_MAX_LEN = 2048

# Each kernel's bound is the larger of two times on an H100 at its
# published peaks (NVIDIA's data sheet, SXM part): its inputs read once
# and outputs written once at HBM_BPS, and the operations its algorithm
# needs on this run's data at OPS_PER_S, the card's scalar float32 rate
# outside the tensor cores (the integer work of these kernels runs on the
# same lanes). Operations are counted per element from the algorithms:
HBM_BPS = 3.35e12
OPS_PER_S = 67e12
#: per raw sample: two prefix sums, two windowed t-statistics, the peak
#: test and the event mean
EVENT_OPS = 40
#: per event: quantization, packing of e events and the 32-bit hash
SKETCH_OPS = 30
#: per predecessor slot the serial chaining loop visits: three compares,
#: two subtractions, two minima, the gap and its scale (one division),
#: three gates, the add, the best test and the skip count
CHAIN_OPS = 20
#: per DTW cell in the band: |a - b|, two minima, one add
DTW_OPS = 5
#: launches of the chain kernel a call: the window pass, then the
#: recurrence (map/chain_cuda.py)
CHAIN_LAUNCHES = 2
#: the chain kernel on the captured round before its run split (one warp
#: a read; PERF.md section 6 row 3)
PARENT_CHAIN_MS, PARENT_CHAIN_WIDEST, PARENT_CHAIN_US = 22.5042, 52208, 0.4271


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> tuple[str, str]:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[card] torch: {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    return name, smi


PROBE = (
    "import numpy as np\n"
    "from rawalign_tpu_torch import native\n"
    "assert native.available() and native.events_available()\n"
    "assert native.chain_dp_available() and native.round_tail_available()\n"
    "z = np.zeros((1, 4), np.int32)\n"
    "s, p = native.chain_dp(z, z, z, np.zeros(1, np.int32), window=8, e=6,\n"
    "                       max_gap=2000, max_target_gap=5000, max_skips=25)\n"
    "assert s.shape == (1, 4)\n"
)


def native_library() -> None:
    def probe() -> subprocess.CompletedProcess:
        return subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                              capture_output=True, text=True, timeout=300)

    res = probe()
    if res.returncode != 0:
        log(f"[native] probe failed (rc {res.returncode}); rebuilding with "
            "make -C native -B")
        subprocess.run(["make", "-C", os.path.join(ROOT, "native"), "-B"],
                       check=True, capture_output=True, timeout=600)
        res = probe()
        if res.returncode != 0:
            raise RuntimeError(f"native library probe failed after rebuild:\n"
                               f"{res.stderr}")
    log("[native] ok")


def build_kernels() -> None:
    from rawalign_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    log(f"[build] {len(build.KERNELS)} kernels in {time.perf_counter() - t0:.2f} s")
    for name in build.KERNELS:
        build.load(name)
        log(f"[build] {name}: nvcc {build.build_seconds[name]:.2f} s")
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build]   {line.strip()}")


def bound(nbytes: int, nops: int) -> tuple[float, str]:
    """(milliseconds, "bytes" or "operations"): the least time the card
    could take to move ``nbytes`` and do ``nops``, and which one sets it."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, nops / OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*xs) -> int:
    """Bytes of the tensors among ``xs`` (tuples are walked)."""
    import torch

    total = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, tuple):
            total += nbytes(*x)
    return total


def cuda_ms(fn, reps: int) -> tuple[float, object]:
    """Median milliseconds of ``fn()`` over ``reps`` runs after one warm
    run, each run bracketed by torch.cuda.synchronize(); with ``reps``
    0, the one run is timed (for plain versions that take seconds)."""
    import torch

    if reps:
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def dataset():
    from rawalign_tpu_torch import config
    from rawalign_tpu_torch.index import index as dindex
    from rawalign_tpu_torch.testing import synth

    t0 = time.perf_counter()
    ds = synth.make_dataset(seed=7, genome_lengths=[GENOME_LEN],
                            n_reads=N_READS, read_len_bp=(400, 1200),
                            noise_pa=1.5)
    io = config.IndexOptions()
    mo = config.MappingOptions()
    config.set_opt("sensitive", io, mo)
    mo.set_flag(config.MappingFlag.DTW_EVALUATE_CHAINS)
    idx = dindex.build_index(ds.seqs, ds.model.pore_vals, io)
    log(f"[data] {GENOME_LEN} bp genome, {len(ds.reads)} reads, "
        f"{idx.keys.size} index keys in {time.perf_counter() - t0:.1f} s")
    return ds, idx, io, mo


def check_sketch(ds, mo, io, device, reps: int = 20) -> dict:
    """Kernel against the plain scan on the first chunk of 32 reads."""
    import numpy as np
    import torch

    from rawalign_tpu_torch.golden import events as gevents
    from rawalign_tpu_torch.seeds import sketch, sketch_cuda

    B, ne = 32, mo.max_events_per_chunk
    ev = np.zeros((B, ne), np.float32)
    n_ev = np.zeros(B, np.int32)
    for i, r in enumerate(ds.reads[:B]):
        e = gevents.detect_events_fast(r.signal[: mo.chunk_size], mo)[:ne]
        ev[i, : e.size] = e
        n_ev[i] = e.size
    ev_d = torch.from_numpy(ev).to(device)
    n_d = torch.from_numpy(n_ev).to(device)
    kw = dict(e=io.e, q=io.q, lq=io.lq)
    ms, got = cuda_ms(lambda: sketch_cuda.sketch_scan(ev_d, n_d, **kw), reps)
    plain_ms, want = cuda_ms(lambda: sketch._sketch_scan(ev_d, n_d, **kw), 3)
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise RuntimeError("sketch_scan kernel disagrees with the plain scan")
    err = float((got[0] - want[0]).abs().max())
    # the bound: each row's events and its count read, hashes, emit, oldest
    # and cnt written (newest is a view the wrapper makes, not the kernel)
    moved = 4 * int(n_ev.sum()) + nbytes(n_d, got[0], got[1], got[3], got[4])
    bms, by = bound(moved, SKETCH_OPS * int(n_ev.sum()))
    log(f"[sketch] B={B} NE={ne} e={io.e}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.2f} ms, bit-identical ({int(got[1].sum())} seeds); "
        f"bound {bms:.6f} ms ({by})")
    # awkward rows at the same width, with the path's seed and with one
    # wider than the uint32 pack (16 codes of 5 bits)
    t0 = time.perf_counter()
    mask = np.float32(3.402823466e32)
    rng = np.random.default_rng(3)
    odd = rng.normal(0.0, 1.0, (12, ne)).astype(np.float32)
    odd[rng.random(odd.shape) < 0.02] = mask
    odd[0, 0] = mask
    odd[1, : ne // 3] = mask
    odd[2, :] = mask
    odd[3, :] = 0.5 + rng.uniform(-0.14, 0.14, ne).astype(np.float32)
    odd[4, 0] = np.nan
    odd[4, rng.integers(0, ne, 8)] = np.nan
    odd_n = np.array([ne] * 5 + [0, 1, io.e - 1, io.e, 15, 16, ne - 1], np.int32)
    odd_d = torch.from_numpy(odd).to(device)
    odd_nd = torch.from_numpy(odd_n).to(device)
    for e, q, lq in ((io.e, io.q, io.lq), (16, io.q, io.lq)):
        got_odd = sketch_cuda.sketch_scan(odd_d, odd_nd, e=e, q=q, lq=lq)
        want_odd = sketch._sketch_scan(odd_d, odd_nd, e, q, lq)
        for g, w in zip(got_odd, want_odd):
            if not torch.equal(g, w):
                raise RuntimeError(f"sketch_scan kernel disagrees with the "
                                   f"plain scan on the awkward rows (e={e})")
        err = max(err, float((got_odd[0] - want_odd[0]).abs().max()))
    log(f"[sketch] 12 awkward rows, e={io.e} and e=16: bit-identical "
        f"({time.perf_counter() - t0:.1f} s)")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bms,
                bound_by=by)


def _dtw_round(ref, hist, da, device_max_n, reps):
    """The one-launch kernel on one round of descriptors: timed, and held
    to the per-class plain version (the JAX kernel's formulation) and the
    plain round (the kernel's) on the card. Returns a dict."""
    import numpy as np
    import torch

    from rawalign_tpu_torch import runtime
    from rawalign_tpu_torch.map import dtw, dtw_cuda, tiles

    cols = [da[:, k].astype(np.int32) for k in range(6)]
    small = (cols[1] <= device_max_n) & (cols[3] <= device_max_n)
    order, descs, batches = tiles.class_batches(
        *cols, np.nonzero(small)[0], device_max_n=device_max_n
    )
    jobs, block_w, stage = tiles.work_list(descs)
    descs_d = runtime.put(descs, ref.device)
    jobs_d = runtime.put(jobs, ref.device)

    def kernel(d=descs_d, j=jobs_d, w=block_w, s=stage):
        return dtw_cuda.dtw_banded_round(ref, hist, d, j, block_w=w, stage=s)

    def per_class():
        return torch.cat([
            dtw.dtw_banded_indexed(
                ref, hist, descs_d[:, c.start : c.start + c.count], dpw=c.dpw
            )
            for c in batches
        ])

    before = dtw_cuda.launches
    got = kernel()
    torch.cuda.synchronize()
    if dtw_cuda.launches != before + 1:
        raise RuntimeError("the DTW round took more than one launch")
    ms, got = cuda_ms(kernel, reps)
    plain_ms, want = cuda_ms(per_class, 1)
    for what, ref_costs in (("the per-class plain version", want),
                            ("the plain round", dtw.dtw_banded_round(ref, hist, descs_d))):
        if not torch.equal(got, ref_costs):
            bad = int((got != ref_costs).sum())
            raise RuntimeError(f"DTW kernel disagrees with {what} on {bad} of "
                               f"{got.numel()} tiles")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    # the bound: both sequences of every tile, its descriptor and its cost;
    # DTW_OPS per cell of the band (the engine's dtw_cells count)
    rows = da[order]
    moved = 4 * int(rows[:, 1].sum() + rows[:, 3].sum()) + nbytes(descs_d, got)
    cells = int((rows[:, 1] * np.minimum(2 * rows[:, 4] + 1, rows[:, 3])).sum())
    n = descs[2]
    classes = "; ".join(
        f"{c.max_n}/{'even' if descs[6, c.start] > descs[7, c.start] else 'odd'}: "
        f"{c.count} tiles, longest n {int(n[c.start : c.start + c.count].max())}"
        for c in batches)
    # the recurrence floor: the longest tile's n-1 dependent iterations at
    # the time per iteration that tile takes alone (its launch less that of
    # the same descriptor cut to 1x1, which runs no iteration, over n-1)
    longest = int(np.argmax(n))
    alone = {}
    for key in ("longest", "1x1"):
        d1 = np.ascontiguousarray(descs[:, longest : longest + 1])
        if key == "1x1":
            d1[2] = d1[5] = 1
        j1, w1, s1 = tiles.work_list(d1)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        args = (runtime.put(d1, ref.device), runtime.put(j1, ref.device), w1, s1)
        kernel(*args)
        a.record()
        for _ in range(20):
            kernel(*args)
        b.record()
        torch.cuda.synchronize()
        alone[key] = a.elapsed_time(b) / 20
    iters = max(int(n[longest]) - 1, 1)
    per_it_ns = (alone["longest"] - alone["1x1"]) / iters * 1e6
    return dict(ms=ms, plain_ms=plain_ms, err=err, order=order, got=got,
                batches=batches, jobs=jobs, bound=bound(moved, DTW_OPS * cells),
                classes=classes, longest_n=int(n[longest]),
                longest_width=int(max(descs[6, longest], descs[7, longest]) + 2),
                alone_ms=alone["longest"], per_it_ns=per_it_ns,
                floor_ms=iters * per_it_ns * 1e-6)


def _dtw_log(label: str, r: dict) -> None:
    import numpy as np

    kinds = {int(k): int(c) for k, c in zip(*np.unique(r["jobs"][:, 0],
                                                        return_counts=True))}
    log(f"[dtw] {label}: {r['order'].size} tiles, {len(r['batches'])} classes "
        f"(class/parity: tile count, longest n) {r['classes']}")
    log(f"[dtw] {label}: one launch of {r['jobs'].shape[0]} blocks (jobs by "
        f"lane width K, 0 = block tile: {kinds}): kernel {r['ms']:.4f} ms, "
        f"per-class plain {r['plain_ms']:.2f} ms, bit-identical to both plain "
        f"versions and native; bound {r['bound'][0]:.6f} ms ({r['bound'][1]}); "
        f"longest tile n={r['longest_n']} ({r['longest_width']} slots) alone "
        f"{r['alone_ms']:.4f} ms, {r['per_it_ns']:.2f} ns per iteration, "
        f"recurrence floor {r['floor_ms']:.4f} ms")


def _synthetic_dtw_rows(rng, lref):
    """N_SYNTH tiles through every size class up to SYNTH_MAX_LEN, read
    side and reference side as long as each other within -30%/+40%, radius
    10% of the read, both parities, exclude_last on and off."""
    import numpy as np

    rows = []
    for _ in range(N_SYNTH):
        ql = int(rng.integers(1, SYNTH_MAX_LEN + 1))
        tl = min(max(1, int(ql * rng.uniform(0.7, 1.4))), SYNTH_MAX_LEN)
        t0 = int(rng.integers(0, lref - tl))
        q0 = lref + int(rng.integers(0, 4)) * 4096 + int(rng.integers(0, 4096 - ql + 1))
        r = max(1, int(ql * 0.10))
        x = int(rng.integers(0, 2))
        rows.append((t0, tl, q0, ql, r, x) if tl > ql else (q0, ql, t0, tl, r, x))
    return np.asarray(rows, np.int64)


#: tools/check_dtw.py's performance mode at its documented band: a
#: radius of 10% of the read side, values uniform in [-2.5, 2.5]
CHECK_DTW_N = 4096
CHECK_DTW_TILES = 64
CHECK_DTW_FRAC = 0.1


def _check_dtw_pairs(label: str, pairs, device, reps: int) -> float:
    """The non-indexed dispatch (``tiles.dtw_banded_pairs``, every pair
    on the card) against ``native.dtw_banded_batch`` bit for bit, in one
    launch a call; returns the median milliseconds of a call (host
    layout, upload, launch and fetch)."""
    import numpy as np

    from rawalign_tpu_torch import native
    from rawalign_tpu_torch.map import dtw_cuda, tiles

    kw = dict(device=device, device_max_n=CHECK_DTW_N, device_max_b=CHECK_DTW_N)
    before = dtw_cuda.launches
    got = tiles.dtw_banded_pairs(pairs, **kw)
    if dtw_cuda.launches != before + 1:
        raise RuntimeError(f"dtw_banded_pairs ({label}) took "
                           f"{dtw_cuda.launches - before} launches, not one")
    if not np.array_equal(got, native.dtw_banded_batch(pairs)):
        raise RuntimeError(f"dtw_banded_pairs ({label}) disagrees with "
                           "native.dtw_banded_batch")
    ms, _ = cuda_ms(lambda: tiles.dtw_banded_pairs(pairs, **kw), reps)
    log(f"[dtw pairs] {label}: {len(pairs)} pairs, longest "
        f"{max(max(p[0].size, p[1].size) for p in pairs)}, one launch, "
        f"bit-identical to native; {ms:.4f} ms a call (layout, upload, launch, "
        "fetch)")
    return ms


def _rows_as_pairs(pool, da):
    """Descriptor rows (a_base, a_len, b_base, b_len, radius, excl) over
    ``pool`` as raw (a, b, radius, exclude_last) pairs, a the longer."""
    return [(pool[a : a + n], pool[b : b + m], int(r), bool(x))
            for a, n, b, m, r, x in da]


def check_dtw(engine, captured, device, reps: int = 10) -> dict:
    import numpy as np
    import torch

    from rawalign_tpu_torch import native

    def vs_native(label, ref_host, hist, da, r):
        pool = np.concatenate([ref_host, hist.cpu().numpy().reshape(-1)])
        pairs = [
            (pool[a : a + n], pool[b : b + m], int(rad), bool(x))
            for a, n, b, m, rad, x in da[r["order"]]
        ]
        if not np.array_equal(r["got"].cpu().numpy(), native.dtw_banded_batch(pairs)):
            raise RuntimeError(f"DTW kernel disagrees with "
                               f"native.dtw_banded_batch ({label})")

    da, hist = captured
    r = _dtw_round(engine._ref_cat_dev, hist, da, engine.dtw_device_max_n, reps)
    vs_native("first round", engine._ref_cat_host, hist, da, r)
    _dtw_log("first round", r)

    rng = np.random.default_rng(1)
    lref = 1 << 20
    syn_ref_host = rng.normal(0, 1, lref).astype(np.float32)
    syn_ref = torch.from_numpy(syn_ref_host).to(device)
    syn_hist = torch.from_numpy(
        rng.normal(0, 1, (4, 4096)).astype(np.float32)).to(device)
    syn_da = _synthetic_dtw_rows(rng, lref)
    syn = _dtw_round(syn_ref, syn_hist, syn_da, 2048, 3)
    vs_native("synthetic mix", syn_ref_host, syn_hist, syn_da, syn)
    _dtw_log(f"synthetic mix up to {SYNTH_MAX_LEN}", syn)

    # the non-indexed dispatch (row 1c) on the same tiles as raw pairs,
    # and on tools/check_dtw.py's long tiles
    pool = np.concatenate([engine._ref_cat_host, hist.cpu().numpy().reshape(-1)])
    pairs_ms = _check_dtw_pairs("phase 4's first round",
                                _rows_as_pairs(pool, da), device, reps)
    syn_pool = np.concatenate([syn_ref_host, syn_hist.cpu().numpy().reshape(-1)])
    _check_dtw_pairs("synthetic mix", _rows_as_pairs(syn_pool, syn_da), device, 3)
    rng = np.random.default_rng(2)
    radius = max(1, int(CHECK_DTW_N * CHECK_DTW_FRAC))
    long_pairs = [
        (rng.uniform(-2.5, 2.5, CHECK_DTW_N).astype(np.float32),
         rng.uniform(-2.5, 2.5, int(rng.integers(3 * CHECK_DTW_N // 4,
                                                 CHECK_DTW_N + 1))).astype(np.float32),
         radius, bool(k % 2))
        for k in range(CHECK_DTW_TILES)
    ]
    _check_dtw_pairs(f"{CHECK_DTW_TILES} tiles of n {CHECK_DTW_N}, radius {radius}",
                     long_pairs, device, 3)
    log(f"[dtw] row 1c, the non-indexed dispatch: {pairs_ms:.4f} ms a call on "
        f"phase 4's first round, against {r['ms']:.4f} ms for the indexed "
        "one-launch kernel call on its descriptors")
    return dict(ms=r["ms"], plain_ms=r["plain_ms"], max_abs_err=max(r["err"], syn["err"]),
                bound_ms=r["bound"][0], bound_by=r["bound"][1])


def _same(a, b) -> bool:
    """Equal element for element, NaN matching NaN (a chunk whose z-norm
    divides by a zero deviation gives NaN in every implementation)."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


EDGE_L = 1021  # width of the awkward event rows: no multiple of a warp


def _check_event_edges(read, kw: dict, device) -> float:
    """The event kernel against the plain detector and the native one on
    awkward rows, EDGE_L wide: empty, constant, one event (NaN z-norm), 9,
    2*w2 - 1 and 2*w2 samples, ``read`` cut three samples after a peak of
    the short detector above its threshold (the long detector is masked at
    the last sample, where the short one fires), noise at full width with
    the events capped. Returns the largest difference to the plain values."""
    import numpy as np
    import torch

    from rawalign_tpu_torch import native
    from rawalign_tpu_torch.signal import events, events_cuda

    t0 = time.perf_counter()
    w1, w2 = kw["w1"], kw["w2"]
    read = read[:EDGE_L]
    sig1 = torch.from_numpy(read)[None, :]
    n1 = torch.tensor([read.size])
    t1 = events._tstat(*events._prefix_sums(sig1, n1, read.size), n1, w1)[0]
    p = int(torch.nonzero(t1[: read.size - w1] > 2 * kw["threshold1"])[-1, 0])
    while t1[p + 1] > t1[p]:
        p += 1
    rng = np.random.default_rng(4)
    step = np.concatenate([np.full(500, 90.0), np.full(500, 110.0)])
    rows = [np.zeros(0, np.float32), np.full(1000, 95.0, np.float32),
            step.astype(np.float32)]
    rows += [rng.normal(95.0, 10.0, n).astype(np.float32)
             for n in (9, 2 * w2 - 1, 2 * w2)]
    rows += [read[: p + w1], rng.normal(95.0, 15.0, EDGE_L).astype(np.float32)]
    sig = np.zeros((len(rows), EDGE_L), np.float32)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        sig[i, : r.size] = r
        lens[i] = r.size
    sig_d = torch.from_numpy(sig).to(device)
    lens_d = torch.from_numpy(lens).to(device)
    cap = 16
    kw = dict(kw, max_events=cap)
    got = events_cuda.detect_events(sig_d, lens_d, **kw)
    want = events.detect_events_plain(sig_d, lens_d, **kw)
    if not (torch.equal(got.n_events, want.n_events)
            and torch.equal(got.n_dropped, want.n_dropped)
            and _same(got.values, want.values)):
        raise RuntimeError("event kernel disagrees with the plain detector "
                           "on the awkward rows")
    values = got.values.cpu().numpy()
    for i, r in enumerate(rows[1:], 1):
        ev = native.detect_events(r, **{
            k: v for k, v in kw.items() if k != "max_events"})
        n = int(got.n_events[i])
        if (n != min(ev.size, cap) or int(got.n_dropped[i]) != max(ev.size - cap, 0)
                or not np.array_equal(values[i, :n], ev[:cap], equal_nan=True)):
            raise RuntimeError("event kernel disagrees with native.detect_events "
                               f"on awkward row {i}")
    if int(got.n_events[2]) != 1 or int(got.n_dropped[-1]) == 0:
        raise RuntimeError("the awkward event rows do not exercise what they "
                           "were built for")
    log(f"[events] {len(rows)} awkward rows, L={EDGE_L}: bit-identical to plain "
        f"and native (events {got.n_events.tolist()}, dropped "
        f"{int(got.n_dropped[-1])}; {time.perf_counter() - t0:.1f} s)")
    diff = (got.values - want.values).abs()
    return float(torch.where(diff.isnan(), 0.0, diff).max())


def _check_event_reruns(reads_d, reads_n, kw: dict, device, calls: int = 50):
    """How often the event kernel's peak machine guesses a chunk's start
    state wrong, and what that costs: the rows of the main check
    (``reads_d``), as many rows of white noise and as many of long dwells
    (levels held 200 samples on average), each batch held to
    ``native.detect_events`` bit for bit. Logs per batch the chunks run
    again and the rounds of such runs in one call, and the milliseconds
    per call of ``calls`` launches made back to back between two CUDA
    events (the wrapper's host time bounds it from below)."""
    import numpy as np
    import torch

    from rawalign_tpu_torch import native
    from rawalign_tpu_torch.signal import events_cuda

    t0 = time.perf_counter()
    B, L = reads_d.shape
    rng = np.random.default_rng(6)
    noise = rng.normal(95.0, 15.0, (B, L)).astype(np.float32)
    dwell = np.zeros((B, L), np.float32)
    for row in dwell:
        i = 0
        while i < L:
            n = int(rng.geometric(1 / 200))
            row[i : i + n] = rng.normal(95.0, 12.0)
            i += n
    dwell += rng.normal(0.0, 1.5, (B, L)).astype(np.float32)
    full = torch.full((B,), L, dtype=torch.int32, device=device)
    nat_kw = {k: v for k, v in kw.items() if k != "max_events"}
    for label, sig, lens_d in (("reads", None, reads_n), ("noise", noise, full),
                               ("long dwells", dwell, full)):
        sig_d = reads_d if sig is None else torch.from_numpy(sig).to(device)
        events_cuda.reruns(device)
        got = events_cuda.detect_events(sig_d, lens_d, **kw)
        chunks, rounds = events_cuda.reruns(device)
        if sig is not None:
            values = got.values.cpu().numpy()
            for i in range(B):
                ev = native.detect_events(sig[i], **nat_kw)[: kw["max_events"]]
                if (int(got.n_events[i]) != ev.size
                        or not np.array_equal(values[i, : ev.size], ev)):
                    raise RuntimeError(f"event kernel disagrees with "
                                       f"native.detect_events on {label} row {i}")
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(calls):
            events_cuda.detect_events(sig_d, lens_d, **kw)
        b.record()
        torch.cuda.synchronize()
        log(f"[events] {label}, B={B} L={L}: {chunks} chunks of the peak "
            f"machine run again in {rounds} rounds (of {2 * B} detector "
            f"rows); {a.elapsed_time(b) / calls:.4f} ms per call, {calls} "
            f"calls back to back ({int(got.n_events.sum())} events)")
    log(f"[events] re-run check {time.perf_counter() - t0:.1f} s")


def check_events(ds, mo, device, reps: int = 20) -> dict:
    """Kernel against the plain detector (on the card) and the native
    detector on the first chunk of 32 reads."""
    import numpy as np
    import torch

    from rawalign_tpu_torch import native
    from rawalign_tpu_torch.signal import events, events_cuda

    B, L, ne = 32, mo.chunk_size, mo.max_events_per_chunk
    sig = np.zeros((B, L), np.float32)
    lens = np.zeros(B, np.int32)
    for i, r in enumerate(ds.reads[:B]):
        part = r.signal[:L]
        sig[i, : part.size] = part
        lens[i] = part.size
    sig_d = torch.from_numpy(sig).to(device)
    lens_d = torch.from_numpy(lens).to(device)
    kw = dict(w1=mo.window_length1, w2=mo.window_length2,
              threshold1=mo.threshold1, threshold2=mo.threshold2,
              peak_height=mo.peak_height, max_events=ne)
    ms, got = cuda_ms(lambda: events_cuda.detect_events(sig_d, lens_d, **kw), reps)
    plain_ms, want = cuda_ms(
        lambda: events.detect_events_plain(sig_d, lens_d, **kw), 0)
    if not (torch.equal(got.n_events, want.n_events)
            and torch.equal(got.n_dropped, want.n_dropped)
            and _same(got.values, want.values)):
        raise RuntimeError("event kernel disagrees with the plain detector")
    values = got.values.cpu().numpy()
    for i in range(B):
        ev = native.detect_events(sig[i, : lens[i]], **{
            k: v for k, v in kw.items() if k != "max_events"})
        n = int(got.n_events[i])
        if n != min(ev.size, ne) or not np.array_equal(values[i, :n], ev[:ne]):
            raise RuntimeError(f"event kernel disagrees with native.detect_events "
                               f"on read {i}")
    diff = (got.values - want.values).abs()
    err = float(torch.where(diff.isnan(), 0.0, diff).max())
    err = max(err, _check_event_edges(sig[0, : lens[0]], kw, device))
    _check_event_reruns(sig_d, lens_d, kw, device)
    # the bound: each row's samples and its length read, the events and the
    # two counts written
    moved = 4 * int(lens.sum()) + nbytes(lens_d, got)
    bms, by = bound(moved, EVENT_OPS * int(lens.sum()))
    log(f"[events] B={B} L={L}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
        f"bit-identical to plain and native ({int(got.n_events.sum())} "
        f"events); bound {bms:.6f} ms ({by})")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bms,
                bound_by=by)


def _chain_vs(packed, a, device, window, kw, reps: int, label: str,
              scan: bool = True, scan_rows: int | None = None) -> dict:
    """Chain kernel on one packed round (B, 3a+1): timed, and held bit for
    bit to both plain versions and to ``native.chain_dp``. The plain DP
    runs on the card; the warp-form scan runs on the host CPU (the same
    arithmetic; on the card each of its per-chunk steps is a dozen
    launches) on all rows or the first ``scan_rows``, and counts the
    predecessor slots the serial loop visits (the bound needs all rows).
    Without ``scan`` the scan, its count and the bound are left out."""
    import numpy as np
    import torch

    from rawalign_tpu_torch import native
    from rawalign_tpu_torch.map import chain, chain_cuda

    seg, tgt, qry = (np.ascontiguousarray(packed[:, k * a : (k + 1) * a])
                     for k in range(3))
    n = np.ascontiguousarray(packed[:, 3 * a])
    host = [torch.from_numpy(x) for x in (seg, tgt, qry, n)]
    d = [x.to(device) for x in host]
    kw = dict(window=window, **kw)
    ms, got = cuda_ms(lambda: chain_cuda.chain_dp(*d, **kw), reps)
    plain_ms, want = cuda_ms(lambda: chain.chain_dp_plain(*d, **kw), 0)
    checks = [("chain_dp_plain", want)]
    visited = torch.zeros(n.size, dtype=torch.int64)
    paths = torch.zeros(2, dtype=torch.int64)
    t0 = time.perf_counter()
    rows = slice(0, scan_rows)
    if scan:
        checks.append(("chain_dp_scan_plain", chain.chain_dp_scan_plain(
            *(x[rows] for x in host), visited=visited[rows], paths=paths,
            **kw)))
    scan_s = time.perf_counter() - t0
    for what, ref in checks:
        k = ref.scores.shape[0]
        if not (torch.equal(got.scores[:k].cpu(), ref.scores.cpu())
                and torch.equal(got.preds[:k].cpu(), ref.preds.cpu())):
            raise RuntimeError(f"chain kernel disagrees with {what} ({label})")
    ns, npred = native.chain_dp(seg, tgt, qry, n, **kw)
    if not (np.array_equal(got.scores.cpu().numpy(), ns)
            and np.array_equal(got.preds.cpu().numpy(), npred)):
        raise RuntimeError(f"chain kernel disagrees with native.chain_dp ({label})")
    B = n.size
    # the bound: three int32 inputs and n_anchors read, scores and preds
    # written; CHAIN_OPS operations per predecessor slot the serial loop
    # visits on this data
    nbytes = 4 * (3 * B * a + B + 2 * B * a)
    slots = int(visited.sum())
    bound_ms, bound_by = bound(nbytes, CHAIN_OPS * slots)
    nmax = int(n.max())
    # the kernel's serial chains: a warp per run (segment or target-gap
    # break), so the widest run, not the widest read, sets its time
    starts = chain.chain_runs(host[0], host[1], host[3],
                              max_target_gap=kw["max_target_gap"])
    lens = [int(x) for st, m in zip(starts, n)
            for x in torch.diff(st, append=st.new_tensor([int(m)]))]
    wrun = max(lens, default=0)
    ring, warps, in_smem = chain_cuda.geometry(window, a)
    log(f"[chain] {label}: B={B} A={a} (max {nmax} anchors) W={window}, "
        f"{warps} warps a read, rings of {ring} slots in "
        f"{'shared' if in_smem else 'device'} memory; {len(lens)} runs, the "
        f"widest {wrun} anchors: kernel {ms:.4f} ms ({ms * 1e3 / max(wrun, 1):.4f}"
        f" us per step of the widest run, {ms * 1e3 / max(nmax, 1):.4f} per "
        f"anchor of the widest read), plain {plain_ms:.2f} ms on the card, "
        + (f"scan {scan_s:.1f} s on the CPU; {slots} slots visited, bound "
           f"{bound_ms:.6f} ms ({bound_by}); anchors with a predecessor "
           f"slot resolved by the max / across the lanes: "
           f"{paths.tolist()}; bit-identical to both plain "
           "versions and native" if scan and scan_rows is None else
           f"scan of the first {scan_rows} rows {scan_s:.1f} s on the CPU; "
           "bit-identical to both plain versions (the scan on those rows) "
           "and native" if scan else
           "bit-identical to chain_dp_plain and native"))
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=float(
        (got.scores - want.scores).abs().max()), bound_ms=bound_ms,
        bound_by=bound_by, widest=nmax, runs=len(lens), widest_run=wrun,
        paths=paths.tolist())


def _chain_round(rng, B, A, n_seg, t_span, interleave: bool):
    """A synthetic packed round (B, 3A+1): co-linear runs of 100 anchors
    among random ones; rows sorted by (segment, target, query), or, with
    ``interleave``, by (target, query) alone so that the segments
    alternate inside every window and most slots are inert."""
    import numpy as np

    out = np.zeros((B, 3 * A + 1), np.int32)
    for b in range(B):
        s = np.sort(rng.integers(0, n_seg, A))
        t = rng.integers(0, t_span, A)
        q = rng.integers(0, 20_000, A)
        for k in rng.integers(0, A - 100, 64):
            run = np.arange(100)
            s[k : k + 100] = s[k]
            t[k : k + 100] = t[k] + run * 10
            q[k : k + 100] = q[k] + run * 9
        o = np.lexsort((q, t) if interleave else (q, t, s))
        out[b, :A], out[b, A : 2 * A], out[b, 2 * A : 3 * A] = s[o], t[o], q[o]
        out[b, 3 * A] = A
    return out


def check_chain(engine, captured, device, reps: int = 10) -> dict:
    import numpy as np

    opt = engine.opt
    kw = dict(e=engine.index.opt.e, max_gap=opt.max_gap_length,
              max_target_gap=opt.max_target_gap_length,
              max_skips=opt.max_num_skips)
    packed, a = captured
    rec = _chain_vs(packed, a, device, engine.chain_window, kw, reps,
                    "captured round")
    log(f"[chain] captured round before the run split (one warp a read, "
        f"PERF.md section 6 row 3, on an H100 80GB HBM3 at 700 W): "
        f"{PARENT_CHAIN_MS} ms, the widest read {PARENT_CHAIN_WIDEST} anchors at "
        f"{PARENT_CHAIN_US} us each; now {rec['ms']:.4f} ms, {rec['runs']} runs, "
        f"the widest {rec['widest_run']} steps at "
        f"{rec['ms'] * 1e3 / max(rec['widest_run'], 1):.4f} us each")
    rng = np.random.default_rng(2)
    A = 16384
    wide = _chain_round(rng, 32, A, 8, 5_000_000, False)
    rec["wide_ms"] = _chain_vs(wide, A, device, 64, kw, 3, "synthetic round")["ms"]
    dense = _chain_round(rng, 32, A, 8, 400_000, True)
    # the scan of all 32 rows of this round takes minutes of the host
    # CPU; eight rows hold the kernel to it, all 32 to the plain DP
    rec["w2048_ms"] = _chain_vs(dense, A, device, 2048, kw, 3,
                                "synthetic round, interleaved",
                                scan_rows=8)["ms"]
    # a window beyond the shared-memory rings (min(W, A) > 4032)
    _chain_vs(dense[:8], A, device, 12_000, kw, 3,
              "synthetic round, interleaved, wide window", scan=False)
    return rec


def strip_time(line: str) -> str:
    return re.sub(r"mt:f:[0-9.]+", "mt:f:X", line)


def main() -> int:
    t_start = time.perf_counter()
    name, smi = card()
    native_library()
    build_kernels()
    import torch

    run(torch.device("cuda", 0), name, smi, t_start)
    return 0


def distributed_only() -> None:
    """Phases 1-3, the warm and timed passes of phases 4 and 5 without
    their kernel checks, then phase 7: the short run of the distributed
    engine, over four distinct cards on a machine that has them.

        python3 -c 'import chip_smoke; chip_smoke.distributed_only()'
    """
    import torch

    from rawalign_tpu_torch.map import chain_cuda, dtw_cuda
    from rawalign_tpu_torch.map.engine import MappingEngine
    from rawalign_tpu_torch.seeds import sketch_cuda
    from rawalign_tpu_torch.signal import events_cuda

    t_start = time.perf_counter()
    _name, smi = card()
    native_library()
    build_kernels()
    device = torch.device("cuda", 0)
    ds, idx, _io, mo = dataset()
    reads = [(r.name, r.signal) for r in ds.reads]
    hybrid = MappingEngine(idx, mo, device=device, batch_size=32,
                           pipeline_depth=8)
    captured = []
    submit = hybrid._dtw_submit

    def capture(da, hist, ev_fetch):
        if not captured:
            captured.append((da.copy(), hist.clone()))
        return submit(da, hist, ev_fetch)

    hybrid._dtw_submit = capture
    list(hybrid.map_reads(reads))
    del hybrid._dtw_submit
    _res, _l, hybrid_rate = timed_pass(
        hybrid, reads, {"sketch_scan": sketch_cuda, "dtw_banded": dtw_cuda},
        "hybrid", smi)
    hybrid.close()
    engine = MappingEngine(idx, mo, device=device, batch_size=32,
                           pipeline_depth=8, stage1_impl="device",
                           chain_impl="device")
    list(engine.map_reads(reads))
    res, _l, device_rate = timed_pass(
        engine, reads,
        {"event_detect": events_cuda, "sketch_scan": sketch_cuda,
         "chain_dp": chain_cuda, "dtw_banded": dtw_cuda},
        "device", smi)
    engine.close()
    phase7(device, idx, mo, reads, lines_of(res), engine, hybrid._ref_cat_dev,
           captured[0], {"4 hybrid": hybrid_rate, "5 all-device": device_rate},
           smi)
    log(f"[smoke] distributed run {time.perf_counter() - t_start:.1f} s")


def timed_pass(engine, reads, counters, label: str, smi: str, ranks: int = 1):
    """Map every read once with the launch counters zeroed just before;
    returns (results, launches read just after, reads/s). Each round that
    sends the DTW kernel tiles must launch it once per rank with tiles (at
    least once, at most ``ranks`` times), and no other round may."""
    import torch

    from rawalign_tpu_torch.map import dtw_cuda

    for k in engine.counters:
        engine.counters[k] = 0
    for k in engine.phase_times:
        engine.phase_times[k] = 0
    dtw_rounds = []
    submit = engine._dtw_submit

    def count_rounds(da, ev, ev_fetch):
        before = dtw_cuda.launches
        pend = submit(da, ev, ev_fetch)
        n = dtw_cuda.launches - before
        has_tiles = pend.small_idx.size > 0
        if n > min(ranks, pend.small_idx.size) or has_tiles != (n > 0):
            raise RuntimeError(f"{label}: {n} DTW launches for a round of "
                               f"{pend.small_idx.size} device tiles over "
                               f"{ranks} ranks")
        dtw_rounds.append(has_tiles)
        return pend

    engine._dtw_submit = count_rounds
    for mod in counters.values():
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        results = list(engine.map_reads(reads))
        torch.cuda.synchronize()
    finally:
        engine._dtw_submit = submit
    dt = time.perf_counter() - t0
    launches = {k: mod.launches for k, mod in counters.items()}
    c = engine.counters
    log(f"[{label}] timed pass: {len(results)} reads in {dt:.3f} s = "
        f"{len(results) / dt:.2f} reads/s on {smi}")
    log(f"[{label}] phase seconds: " + json.dumps(
        {k: round(v, 4) for k, v in engine.phase_times.items()}))
    log(f"[{label}] launches {launches}; dtw_tiles_device {c['dtw_tiles_device']}, "
        f"dtw_tiles_host_large {c['dtw_tiles_host_large']}, dtw_cells "
        f"{c['dtw_cells']}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if len(results) != len(reads):
        raise RuntimeError(f"{len(results)} results for {len(reads)} reads")
    if min(launches.values()) == 0 or c["dtw_tiles_device"] == 0:
        raise RuntimeError(f"the {label} pass did not launch every kernel of "
                           f"its path: {launches}")
    if ranks == 1 and launches["dtw_banded"] != sum(dtw_rounds):
        raise RuntimeError(f"{label}: {launches['dtw_banded']} DTW launches for "
                           f"{sum(dtw_rounds)} rounds with device tiles")
    log(f"[{label}] DTW: {launches['dtw_banded']} launches in the "
        f"{sum(dtw_rounds)} rounds with device tiles (of {len(dtw_rounds)}), "
        f"one per rank with tiles, {ranks} ranks")
    return results, launches, len(results) / dt


def score(ds, results) -> tuple[float, float]:
    """mapped_frac, correct_frac against the simulated truth (as
    bench.py scores them)."""
    by_name = {r.name: r for r in ds.reads}
    n_mapped = n_correct = 0
    for res in results:
        if not res.mapped:
            continue
        n_mapped += 1
        r = by_name[res.read_name]
        if (r.ref_id >= 0 and res.ref_name == ds.seqs[r.ref_id].name
                and res.rev == r.strand):
            lo = res.fragment_start_position
            if not (lo + res.fragment_length < r.ref_start or lo > r.ref_end):
                n_correct += 1
    return n_mapped / len(results), n_correct / len(results)


def lines_of(results) -> dict[str, str]:
    from rawalign_tpu_torch.io import paf

    return {res.read_name: strip_time(paf.paf_line(res)) for res in results}


def same_lines(label: str, got: dict, want: dict, what: str) -> None:
    bad = [n for n in want if got.get(n) != want[n]]
    if bad or len(got) != len(want):
        n0 = bad[0] if bad else None
        raise RuntimeError(f"{label}: PAF differs from {what} on {len(bad)} "
                           f"reads; first {n0}:\n  want {want.get(n0)}\n"
                           f"  got  {got.get(n0)}")


def cpu_reference(idx, mo, reads, label: str, **modes) -> dict[str, str]:
    """The same engine on the CPU (the plain versions of every kernel) on
    the first N_GOLDEN reads."""
    from rawalign_tpu_torch.map.engine import MappingEngine

    t0 = time.perf_counter()
    with MappingEngine(idx, mo, device="cpu", batch_size=32, pipeline_depth=8,
                       dtw_device_max_n=256, dtw_device_max_b=256,
                       **modes) as eng:
        out = lines_of(eng.map_reads(reads[:N_GOLDEN]))
    log(f"[{label}] device=\"cpu\" reference on {N_GOLDEN} reads in "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def check_minimizer(ds, mo, io_f, device) -> None:
    """The sketch kernel feeding the minimizer window filter on the card,
    against the whole function on the CPU, on the first chunk of 32
    reads."""
    import numpy as np
    import torch

    from rawalign_tpu_torch.golden import events as gevents
    from rawalign_tpu_torch.seeds import sketch

    B, ne = 32, mo.max_events_per_chunk
    ev = np.zeros((B, ne), np.float32)
    n_ev = np.zeros(B, np.int32)
    for i, r in enumerate(ds.reads[:B]):
        e = gevents.detect_events_fast(r.signal[: mo.chunk_size], mo)[:ne]
        ev[i, : e.size] = e
        n_ev[i] = e.size
    kw = dict(w=io_f.w, e=io_f.e, q=io_f.q, lq=io_f.lq)
    ev_d = torch.from_numpy(ev).to(device)
    n_d = torch.from_numpy(n_ev).to(device)
    ms, got = cuda_ms(lambda: sketch.sketch_events_min_batch(ev_d, n_d, **kw), 20)
    t0 = time.perf_counter()
    want = sketch.sketch_events_min_batch(torch.from_numpy(ev),
                                          torch.from_numpy(n_ev), **kw)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    for g, w in zip(got, want):
        if not torch.equal(g.cpu(), w):
            raise RuntimeError("minimizer filter on the card disagrees with "
                               "its CPU result")
    log(f"[faster] minimizer filter B={B} NE={ne} w={io_f.w} e={io_f.e}: "
        f"{ms:.4f} ms on the card (sketch kernel + filter), {cpu_ms:.1f} ms "
        f"on the CPU, equal ({int(got.valid.sum())} of "
        f"{int((got.hashes != 0).sum())} seeds kept)")


def phase6(device, ds, idx, mo, reads, hybrid: dict, smi: str) -> None:
    """Phase 6: CIGAR and chain output on the hybrid and the all-device
    path, the faster (minimizer) preset on both, the host stage1."""
    import copy

    from rawalign_tpu_torch import config
    from rawalign_tpu_torch.config import MappingFlag as F
    from rawalign_tpu_torch.golden import engine as gengine
    from rawalign_tpu_torch.index import index as dindex
    from rawalign_tpu_torch.io import paf
    from rawalign_tpu_torch.map import chain_cuda, dtw_cuda
    from rawalign_tpu_torch.map.engine import MappingEngine
    from rawalign_tpu_torch.seeds import sketch_cuda
    from rawalign_tpu_torch.signal import events_cuda

    hy_counters = {"sketch_scan": sketch_cuda, "dtw_banded": dtw_cuda}
    all_counters = {"event_detect": events_cuda, "sketch_scan": sketch_cuda,
                    "chain_dp": chain_cuda, "dtw_banded": dtw_cuda}
    out_tags = ("mt", "aln", "alns", "anchors")

    def without_outputs(line: str):
        cols = line.split("\t")
        return cols[:12], [t for t in cols[12:] if t.split(":", 1)[0] not in out_tags]

    # ---- 6a: CIGAR and chain output, hybrid stage1, native chain DP,
    # Python tail
    mo_a = copy.deepcopy(mo)
    mo_a.set_flag(F.DTW_OUTPUT_CIGAR | F.OUTPUT_CHAINS)
    with MappingEngine(idx, mo_a, device=device, batch_size=32,
                       pipeline_depth=8) as eng:
        res, _, _ = timed_pass(eng, reads, hy_counters, "6a cigar hybrid", smi)
    cigar = lines_of(res)
    n_aln = sum("\taln:s:" in ln and "\tanchors:s:" in ln for ln in cigar.values())
    for n, line in hybrid.items():
        if without_outputs(cigar[n]) != without_outputs(line):
            raise RuntimeError(f"6a: {n} differs from the phase-4 line outside "
                               f"the output tags:\n  {line}\n  {cigar[n]}")
    t0 = time.perf_counter()
    for r in ds.reads[:N_GOLDEN]:
        want = strip_time(paf.paf_line(gengine.map_read(idx, r.signal, r.name, mo_a)))
        if cigar[r.name] != want:
            raise RuntimeError(f"6a: PAF differs from golden for {r.name}:\n"
                               f"  golden {want}\n  port   {cigar[r.name]}")
    log(f"[6a cigar hybrid] {n_aln} mapped lines carry aln/alns/anchors; columns "
        f"1-12 and the other tags equal phase 4's on all {len(hybrid)}; the "
        f"first {N_GOLDEN} byte-identical to golden.engine "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---- 6b: the same flags on the all-device path: the events ride the
    # stage1 download, the DTW reads the uploaded event pool
    with MappingEngine(idx, mo_a, device=device, batch_size=32,
                       pipeline_depth=8, stage1_impl="device",
                       chain_impl="device") as eng:
        if not eng._events_on_host:
            raise RuntimeError("6b: the device stage1 does not keep the events")
        pool_launches = []
        submit = eng._dtw_submit

        def count_pool(da, pool, ev_fetch):
            if pool.dim() != 1:
                raise RuntimeError("6b: a DTW round read the device history, "
                                   "not the uploaded event pool")
            before = dtw_cuda.launches
            pend = submit(da, pool, ev_fetch)
            pool_launches.append(dtw_cuda.launches - before)
            return pend

        eng._dtw_submit = count_pool
        res, launches, _ = timed_pass(eng, reads, all_counters, "6b cigar device", smi)
    same_lines("6b", lines_of(res), cigar, "6a")
    if (sum(pool_launches) != launches["dtw_banded"] or not sum(pool_launches)
            or max(pool_launches) > 1):
        raise RuntimeError(f"6b: {pool_launches} DTW launches a round on the "
                           f"pool, of {launches['dtw_banded']}")
    log(f"[6b cigar device] all {len(cigar)} PAF lines byte-identical to 6a; "
        f"{sum(pool_launches)} DTW launches in {len(pool_launches)} rounds, "
        "every one on the uploaded event pool")

    # ---- 6c: the faster preset (minimizers, w=5 e=7) on both paths
    io_f = config.IndexOptions()
    mo_c = config.MappingOptions()
    config.set_opt("faster", io_f, mo_c)
    mo_c.set_flag(F.DTW_EVALUATE_CHAINS)
    t0 = time.perf_counter()
    idx_f = dindex.build_index(ds.seqs, ds.model.pore_vals, io_f)
    log(f"[faster] index w={io_f.w} e={io_f.e}: {idx_f.keys.size} keys in "
        f"{time.perf_counter() - t0:.1f} s (sensitive: {idx.keys.size})")
    check_minimizer(ds, mo_c, io_f, device)
    with MappingEngine(idx_f, mo_c, device=device, batch_size=32,
                       pipeline_depth=8) as eng:
        res, _, _ = timed_pass(eng, reads, hy_counters, "6c faster hybrid", smi)
    faster = lines_of(res)
    mf, cf = score(ds, res)
    log(f"[6c faster hybrid] mapped_frac {mf:.4f}, correct_frac {cf:.4f}")
    with MappingEngine(idx_f, mo_c, device=device, batch_size=32,
                       pipeline_depth=8, stage1_impl="device",
                       chain_impl="device") as eng:
        res, _, _ = timed_pass(eng, reads, all_counters, "6c faster device", smi)
    same_lines("6c", lines_of(res), faster, "the faster hybrid pass")
    same_lines("6c", {r.name: faster[r.name] for r in ds.reads[:N_GOLDEN]},
               cpu_reference(idx_f, mo_c, reads, "6c faster"),
               "the same engine at device='cpu'")
    log(f"[6c faster] all {len(faster)} PAF lines byte-identical between the "
        f"hybrid and the all-device pass, the first {N_GOLDEN} to the "
        "engine at device='cpu'")

    # ---- 6d: the host stage1 (sensitive + DTW); the device runs the DTW
    with MappingEngine(idx, mo, device=device, batch_size=32,
                       pipeline_depth=8, stage1_impl="host") as eng:
        res, _, _ = timed_pass(eng, reads, {"dtw_banded": dtw_cuda},
                            "6d host stage1", smi)
    host = lines_of(res)
    same_lines("6d", {r.name: host[r.name] for r in ds.reads[:N_GOLDEN]},
               cpu_reference(idx, mo, reads, "6d host", stage1_impl="host"),
               "the same engine at device='cpu'")
    n_eq = sum(host[n] == hybrid[n] for n in hybrid)
    log(f"[6d host stage1] the first {N_GOLDEN} PAF lines byte-identical to "
        f"the engine at device='cpu'; {n_eq} of {len(hybrid)} equal to the "
        "hybrid pass (the host stage1 does not compact the seeds)")


def _check_routed_stage1(label, dist, single, packed) -> None:
    """The distributed engine's routed stage1 on a captured round against
    the one-card stage1 (``_stage1_post``) on the same input: counts and
    scalars equal, lo and qpos equal where the count is positive."""
    import numpy as np
    import torch

    from rawalign_tpu_torch import runtime
    from rawalign_tpu_torch.map import stage1_codec

    B = packed.shape[0]
    hist = torch.zeros((B, single._hmax), device=single.device)
    off = np.zeros(B, np.int32)
    ne = single.opt.max_events_per_chunk
    if dist.stage1_impl == "device":
        got, want = (e._stage1_device(packed, hist, off) for e in (dist, single))
    else:
        got, want = (e._stage1(packed, hist, off) for e in (dist, single))
    a, b = (stage1_codec.unpack_stage1(
        runtime.fetch(x), ne=ne, ns=e._ns_out, events_on_host=e._s1_dl_events)
        for x, e in ((want, single), (got, dist)))
    used = a.count > 0
    same = (np.array_equal(a.count, b.count)
            and np.array_equal(a.lo[used], b.lo[used])
            and np.array_equal(a.qpos[used], b.qpos[used])
            and all(np.array_equal(getattr(a, f), getattr(b, f)) for f in (
                "n_events", "n_ev_dropped", "n_occ_dropped",
                "n_compact_dropped")))
    if not same or not used.any():
        raise RuntimeError(f"{label}: the routed stage1 disagrees with the "
                           "one-card stage1 on the captured round")
    log(f"[{label}] routed stage1 on the captured round: counts, scalars and "
        f"lo/qpos of {int(used.sum())} seeds with hits equal the one-card "
        "stage1's")


def _check_sharded_dtw(mesh, ref_cat, captured, device_max_n: int) -> None:
    """Phase 4's captured DTW round dealt over ``mesh``: costs
    bit-identical to the one-launch round; logs each rank's longest tile
    and both times."""
    import numpy as np
    import torch

    from rawalign_tpu_torch.map import tiles

    da, hist = captured
    cols = [da[:, k].astype(np.int32) for k in range(6)]
    small = (cols[1] <= device_max_n) & (cols[3] <= device_max_n)
    _order, descs, _b = tiles.class_batches(*cols, np.nonzero(small)[0],
                                            device_max_n=device_max_n)
    refs = {d: ref_cat.to(d) for d in mesh.distinct}
    one_ms, one = cuda_ms(lambda: tiles.run_round(ref_cat, hist, descs), 10)
    sh_ms, (order, costs) = cuda_ms(
        lambda: tiles.run_round_sharded(mesh, refs, hist, descs), 10)
    if not torch.equal(costs.cpu(), one.cpu()[torch.from_numpy(order)]):
        raise RuntimeError("the sharded DTW round disagrees with the one-card "
                           "round")
    longest = [int(descs[2][sel].max()) if sel.size else 0
               for sel in tiles.deal(descs[2], mesh.size)]
    log(f"[7 dtw] phase 4's captured round ({descs.shape[1]} device tiles) "
        f"dealt over {mesh.size} ranks: bit-identical to the one-launch round; "
        f"longest tile per rank {longest}; {sh_ms:.4f} ms sharded against "
        f"{one_ms:.4f} ms in one launch (synchronised wall)")


def phase7(device, idx, mo, reads, device_lines: dict, single, ref_cat,
           captured_dtw, rates: dict, smi: str) -> None:
    """Phase 7: the distributed engine over a mesh of four ranks (four
    cards when there are, else four ranks on ``device``): a warm and a timed
    pass with the hybrid stage1 on (2, 2) and the device stage1 on (1, 4).
    Every timed pass's PAF must equal phase 5's, each rank must launch the
    sketch kernel and the chain kernel's two launches once a round (and
    the event kernel under the device stage1), the DTW kernel at most once a rank a round and at
    least once a pass; the routed stage1 is held to the one-card stage1
    on a captured round, the sharded DTW to the one-launch round."""
    import torch

    from rawalign_tpu_torch.map import chain_cuda, dtw_cuda
    from rawalign_tpu_torch.parallel import mesh as pmesh
    from rawalign_tpu_torch.parallel.dist_engine import DistributedMappingEngine
    from rawalign_tpu_torch.seeds import sketch_cuda
    from rawalign_tpu_torch.signal import events_cuda

    t0 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    distinct = n_cards >= 4
    devices = ([torch.device("cuda", i) for i in range(4)] if distinct
               else [device] * 4)
    log(f"[7] {n_cards} card(s) visible: the mesh's four ranks are "
        + ("four distinct cards" if distinct else f"four ranks on {device}"))
    for label, layout, s1 in (("7a hybrid (2, 2)", (2, 2), "hybrid"),
                              ("7b device (1, 4)", (1, 4), "device")):
        mesh = pmesh.make_mesh(*layout, devices=devices)
        R = mesh.size
        counters = {"sketch_scan": sketch_cuda, "chain_dp": chain_cuda,
                    "dtw_banded": dtw_cuda}
        if s1 == "device":
            counters["event_detect"] = events_cuda
        with DistributedMappingEngine(idx, mo, mesh, batch_size=32,
                                      pipeline_depth=8,
                                      stage1_impl=s1) as eng:
            entry = "_stage1_device" if s1 == "device" else "_stage1"
            stage1, chain_dp = getattr(eng, entry), eng._chain_dp
            calls = {"stage1": 0, "chain": 0}
            first = []

            def count_stage1(packed, hist, off):
                calls["stage1"] += 1
                if not first:
                    first.append(packed.copy())
                return stage1(packed, hist, off)

            def count_chain(packed, a):
                calls["chain"] += 1
                return chain_dp(packed, a)

            setattr(eng, entry, count_stage1)
            eng._chain_dp = count_chain
            t1 = time.perf_counter()
            list(eng.map_reads(reads))
            torch.cuda.synchronize()
            log(f"[{label}] warm pass {time.perf_counter() - t1:.2f} s")
            _check_routed_stage1(label, eng, single, first[0])
            calls.update(stage1=0, chain=0)
            res, launches, rate = timed_pass(eng, reads, counters, label, smi,
                                             ranks=R)
            rounds = calls["stage1"]
            # the chain DP is two launches a call: the window pass and
            # the recurrence (map/chain_cuda.py)
            want = {"sketch_scan": R * rounds,
                    "chain_dp": CHAIN_LAUNCHES * R * calls["chain"],
                    "event_detect": R * rounds}
            got = {k: launches[k] for k in want if k in launches}
            if any(got[k] != want[k] for k in got) or not launches["dtw_banded"]:
                raise RuntimeError(f"{label}: launches {launches}, expected "
                                   f"{want} and at least one DTW launch")
            same_lines(label, lines_of(res), device_lines, "phase 5's")
            a2a = eng.counters["all_to_all_bytes"]
            log(f"[{label}] all {len(res)} PAF lines byte-identical to phase "
                f"5's; {rounds} stage1 rounds, {calls['chain']} chain rounds "
                f"over {R} ranks; all-to-all {a2a / max(rounds, 1):.0f} bytes "
                f"a round between ranks ({a2a} in the pass); {rate:.2f} reads/s "
                f"against phase " + ", ".join(f"{k} {v:.2f}"
                                              for k, v in rates.items())
                + f" on {smi}, ranks on "
                + ("four distinct cards" if distinct else "one card"))
    _check_sharded_dtw(pmesh.make_mesh(1, 4, devices=devices), ref_cat,
                       captured_dtw, single.dtw_device_max_n)
    log(f"[7] phase 7 in {time.perf_counter() - t0:.1f} s")


#: the budget at which the dataset's widest first round (52,208 anchors)
#: stays in the fused chain DP: phase 5 grows A to the same 65,536
FUSED_ANCHORS = 65536


def phase8(device, idx, mo, reads, device_lines: dict, rates: dict,
           smi: str) -> dict:
    """Phase 8: the fused stage1+chain (``fused=True``) on the device
    stage1 and chain placements. A warm and a timed pass at
    ``max_anchors=FUSED_ANCHORS``: all PAF lines must equal phase 5's,
    no round may escalate, every round must refetch its DP prefix, the
    event and sketch kernels must launch once a fused round, the chain
    kernel's two launches once, and the DTW kernel once a round with
    device tiles. Then one pass at the
    default budget against the unfused all-device engine at the same
    ceiling: equal PAFs, escalations logged. Returns the timed pass's
    launches."""
    import torch

    from rawalign_tpu_torch.map import chain_cuda, dtw_cuda
    from rawalign_tpu_torch.map.engine import MappingEngine
    from rawalign_tpu_torch.seeds import sketch_cuda
    from rawalign_tpu_torch.signal import events_cuda

    t0 = time.perf_counter()
    counters = {"event_detect": events_cuda, "sketch_scan": sketch_cuda,
                "chain_dp": chain_cuda, "dtw_banded": dtw_cuda}
    modes = dict(device=device, batch_size=32, pipeline_depth=8,
                 stage1_impl="device", chain_impl="device")
    with MappingEngine(idx, mo, fused=True, max_anchors=FUSED_ANCHORS,
                       **modes) as eng:
        calls = {"fused": 0, "unfused": 0}
        widths = []
        stage1_fused, stage1_device = eng._stage1_fused, eng._stage1_device
        dp_prefix = eng._dp_prefix

        def count_fused(*a):
            calls["fused"] += 1
            return stage1_fused(*a)

        def count_unfused(*a):
            calls["unfused"] += 1
            return stage1_device(*a)

        def count_prefix(dp_full, w):
            widths.append(w)
            return dp_prefix(dp_full, w)

        eng._stage1_fused, eng._stage1_device = count_fused, count_unfused
        eng._dp_prefix = count_prefix
        t1 = time.perf_counter()
        list(eng.map_reads(reads))
        torch.cuda.synchronize()
        log(f"[8 fused] warm pass {time.perf_counter() - t1:.2f} s")
        calls.update(fused=0, unfused=0)
        widths.clear()
        res, launches, rate = timed_pass(eng, reads, counters, "8 fused", smi)
        c = eng.counters
        same_lines("8 fused", lines_of(res), device_lines, "phase 5's")
        rounds = calls["fused"] + calls["unfused"]
        want = {"event_detect": rounds, "sketch_scan": rounds,
                "chain_dp": CHAIN_LAUNCHES * calls["fused"]}
        if (c["fused_escalations"] or not c["fused_refetches"]
                or calls["unfused"] or any(launches[k] != v
                                           for k, v in want.items())):
            raise RuntimeError(f"8 fused: escalations {c['fused_escalations']}, "
                               f"refetches {c['fused_refetches']}, rounds "
                               f"{calls}, launches {launches} (want {want})")
        B = eng.batch_size
        # the all-device path uploads (B, 3a + 1) int32 anchors a chained
        # round, a the prefix width the fused round refetched; the fused
        # round uploads (B, 3C + 2) int32 carried anchors in their place
        saved = sum(4 * B * (3 * w + 1) for w in widths)
        added = 4 * B * (3 * eng._fused_c + 2) * calls["fused"]
        log(f"[8 fused] all {len(res)} PAF lines byte-identical to phase 5's; "
            f"{calls['fused']} fused rounds, 0 escalations, {c['fused_refetches']}"
            f" DP prefix refetches (widths {sorted(set(widths))}); chain "
            f"uploads no longer made {saved} bytes ({saved / max(len(widths), 1):.0f}"
            f" a chained round), carried uploads added {added} bytes; "
            f"{rate:.2f} reads/s against phase "
            + ", ".join(f"{k} {v:.2f}" for k, v in rates.items()) + f" on {smi}")

    # the default budget: the wide rounds escalate to the unfused chain DP
    with MappingEngine(idx, mo, fused=True, **modes) as eng:
        t1 = time.perf_counter()
        got = lines_of(eng.map_reads(reads))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        esc, rounds = eng.counters["fused_escalations"], eng.phase_times["rounds"]
    with MappingEngine(idx, mo, max_anchors_ceiling=eng.max_anchors,
                       **modes) as ref:
        same_lines("8 default budget", got, lines_of(ref.map_reads(reads)),
                   f"the unfused all-device engine at ceiling {eng.max_anchors}")
    log(f"[8 fused] default budget A={eng.max_anchors}: all {len(got)} PAF lines "
        f"byte-identical to the unfused all-device engine at the same ceiling; "
        f"{esc} of {rounds} rounds escalated; {len(got) / dt:.2f} reads/s "
        "(one pass, the first of its engine)")
    log(f"[8] phase 8 in {time.perf_counter() - t0:.1f} s")
    return launches


#: the CLI runs of phase 9: (label, placement flags, flags under test).
#: (a) runs both flags on the hybrid placement, (b) ``--profile`` on the
#: all-device one; the others time each flag alone against no flag
CLI_RUNS = (
    ("9 hybrid", [], []),
    ("9 hybrid", [], ["--profile"]),
    ("9 hybrid", [], ["--debug-nans"]),
    ("9a hybrid", [], ["--profile", "--debug-nans"]),
    ("9 all-device", ["--stage1-impl", "device", "--chain-impl", "device"], []),
    ("9b all-device", ["--stage1-impl", "device", "--chain-impl", "device"],
     ["--profile"]),
    ("9 all-device", ["--stage1-impl", "device", "--chain-impl", "device"],
     ["--debug-nans"]),
)
#: the kernels each placement launches, by their names in a trace
CLI_KERNELS = {
    "hybrid": ("ra_sketch_scan_kernel", "ra_dtw_round_kernel"),
    "all-device": ("ra_sketch_scan_kernel", "ra_dtw_round_kernel",
                   "ra_event_detect_kernel", "ra_chain_dp_kernel"),
}


def _trace_kernels(trace_dir: str) -> dict[str, int]:
    """Events a kernel of ours has in the one Chrome trace in
    ``trace_dir``, by kernel name."""
    files = os.listdir(trace_dir)
    if len(files) != 1 or not files[0].endswith(".pt.trace.json"):
        raise RuntimeError(f"{trace_dir}: want one trace file, found {files}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    counts: dict[str, int] = {}
    for ev in events:
        m = re.search(r"ra_\w+_kernel", str(ev.get("name", "")))
        if m and ev.get("cat") == "kernel":
            counts[m.group(0)] = counts.get(m.group(0), 0) + 1
    return counts


def phase9(ds, hybrid: dict, device_lines: dict, smi: str) -> None:
    """Phase 9: the port's CLI on the card, ``python -m
    rawalign_tpu_torch.cli`` in a subprocess with no ``--device`` (so the
    default ``cuda``), on phase 4's genome written as FASTA with its pore
    model and its reads in the CLI's float32 signal container
    (``.sigbin.npz``: FAST5 quantizes the signal to 16 bits, so its PAF
    would not be phase 4's, and needs h5py). Each run of ``CLI_RUNS`` must
    exit 0 with PAF lines equal to phase 4's (hybrid) or phase 5's
    (all-device), mt:f stripped; each ``--profile`` run must leave one
    trace naming every kernel of its placement. Logs each run's wall, the
    CLI's own index and total seconds, and reads/s after the index."""
    import tempfile

    from rawalign_tpu_torch.io import fast5, fasta
    from rawalign_tpu_torch.pore_model import save_pore_model

    t0 = time.perf_counter()
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="cli_smoke_", dir=scratch) as tmp:
        ref_fa = os.path.join(tmp, "ref.fa")
        model = os.path.join(tmp, "model.txt")
        sigs = os.path.join(tmp, "reads.sigbin.npz")
        fasta.write_fasta(ref_fa, [(s.name, s.seq) for s in ds.seqs])
        save_pore_model(model, ds.model)
        fast5.write_sigbin(sigs, [(r.name, r.signal) for r in ds.reads])
        env = dict(os.environ, PYTHONPATH=ROOT)
        for k, (label, placement, flags) in enumerate(CLI_RUNS):
            out = os.path.join(tmp, f"run{k}.paf")
            prof = os.path.join(tmp, f"trace{k}")
            argv = ["-x", "sensitive", "--dtw-evaluate-chains",
                    "--pipeline-depth", "8", "-p", model, "-o", out,
                    *placement, *flags, ref_fa, sigs]
            argv = [a if a != "--profile" else f"--profile={prof}" for a in argv]
            t1 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "rawalign_tpu_torch.cli", *argv],
                cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t1
            what = f"{label} {' '.join(flags) or '(no flag)'}"
            if proc.returncode != 0:
                raise RuntimeError(f"[{what}] the CLI exited {proc.returncode}:\n"
                                   f"{proc.stderr[-4000:]}")
            with open(out) as f:
                got = {ln.split("\t", 1)[0]: strip_time(ln)
                       for ln in f.read().splitlines()}
            all_device = "all-device" in label
            same_lines(what, got, device_lines if all_device else hybrid,
                       "phase 5's" if all_device else "phase 4's")
            built = re.search(r"\[M::main::([0-9.]+)\] built the index",
                              proc.stderr)
            real = re.search(r"Real time: ([0-9.]+) sec", proc.stderr)
            if not built or not real:
                raise RuntimeError(f"[{what}] no index or Real time line:\n"
                                   f"{proc.stderr[-4000:]}")
            t_index, t_real = float(built.group(1)), float(real.group(1))
            traced = ""
            if "--profile" in flags:
                kernels = _trace_kernels(prof)
                want = CLI_KERNELS["all-device" if all_device else "hybrid"]
                if any(not kernels.get(k) for k in want):
                    raise RuntimeError(f"[{what}] the trace names {kernels}, "
                                       f"not every one of {want}")
                traced = f"; trace kernel events {json.dumps(kernels)}"
            log(f"[{what}] exit 0, all {len(got)} PAF lines byte-identical to "
                f"{'phase 5' if all_device else 'phase 4'}'s; wall {wall:.3f} s, "
                f"CLI real {t_real:.3f} s, index {t_index:.3f} s, "
                f"{len(got) / (t_real - t_index):.2f} reads/s after the index "
                f"on {smi}{traced}")
    log(f"[9] phase 9 in {time.perf_counter() - t0:.1f} s")


def run(device, name: str, smi: str, t_start: float) -> None:
    """Phases 4 to 9 on ``device``; prints the two result lines."""
    import torch

    from rawalign_tpu_torch.golden import engine as gengine
    from rawalign_tpu_torch.io import paf
    from rawalign_tpu_torch.map import chain_cuda, dtw_cuda
    from rawalign_tpu_torch.map.engine import MappingEngine
    from rawalign_tpu_torch.seeds import sketch_cuda
    from rawalign_tpu_torch.signal import events_cuda

    ds, idx, io, mo = dataset()
    reads = [(r.name, r.signal) for r in ds.reads]

    # ---- phase 4: the hybrid path
    engine = MappingEngine(idx, mo, device=device, batch_size=32,
                           pipeline_depth=8)
    captured = []
    submit = engine._dtw_submit

    def capture(da, hist, ev_fetch):
        if not captured:
            captured.append((da.copy(), hist.clone()))
        return submit(da, hist, ev_fetch)

    engine._dtw_submit = capture
    t0 = time.perf_counter()
    list(engine.map_reads(reads))
    torch.cuda.synchronize()
    log(f"[hybrid] warm pass {time.perf_counter() - t0:.2f} s")
    del engine._dtw_submit
    if not captured:
        raise RuntimeError("the warm pass ran no DTW round")

    rec_sketch = check_sketch(ds, mo, io, device)
    rec_dtw = check_dtw(engine, captured[0], device)
    results, _, hybrid_rate = timed_pass(
        engine, reads, {"sketch_scan": sketch_cuda, "dtw_banded": dtw_cuda},
        "hybrid", smi)
    engine.close()
    ref_cat = engine._ref_cat_dev

    mf, cf = score(ds, results)
    log(f"[hybrid] mapped_frac {mf:.4f}, correct_frac {cf:.4f}")

    hybrid = lines_of(results)
    t0 = time.perf_counter()
    golden = {}
    for r in ds.reads[:N_GOLDEN]:
        golden[r.name] = strip_time(
            paf.paf_line(gengine.map_read(idx, r.signal, r.name, mo)))
        if hybrid[r.name] != golden[r.name]:
            raise RuntimeError(f"PAF differs from the golden engine for "
                               f"{r.name}:\n  golden {golden[r.name]}\n"
                               f"  port   {hybrid[r.name]}")
    log(f"[golden] first {N_GOLDEN} reads byte-identical to golden.engine "
        f"(mt:f stripped) in {time.perf_counter() - t0:.1f} s")

    # ---- phase 5: the all-device path
    engine = MappingEngine(idx, mo, device=device, batch_size=32,
                           pipeline_depth=8, stage1_impl="device",
                           chain_impl="device")
    chain_round = []
    chain_dp = engine._chain_dp

    def capture_chain(packed, a):
        if not chain_round:
            chain_round.append((packed.copy(), a))
        return chain_dp(packed, a)

    engine._chain_dp = capture_chain
    t0 = time.perf_counter()
    list(engine.map_reads(reads))
    torch.cuda.synchronize()
    log(f"[device] warm pass {time.perf_counter() - t0:.2f} s")
    del engine._chain_dp
    if not chain_round:
        raise RuntimeError("the warm pass ran no chain round")

    rec_events = check_events(ds, mo, device)
    rec_chain = check_chain(engine, chain_round[0], device)
    results, launches, device_rate = timed_pass(
        engine, reads,
        {"event_detect": events_cuda, "sketch_scan": sketch_cuda,
         "chain_dp": chain_cuda, "dtw_banded": dtw_cuda},
        "device", smi)
    engine.close()
    device_lines = lines_of(results)
    same_lines("all-device", device_lines, hybrid, "the hybrid pass")
    for n, want in golden.items():
        if device_lines[n] != want:
            raise RuntimeError(f"all-device PAF differs from golden for {n}")
    log(f"[device] all {len(device_lines)} PAF lines byte-identical to the "
        f"hybrid pass (mt:f stripped), the first {N_GOLDEN} to golden.engine")

    phase6(device, ds, idx, mo, reads, hybrid, smi)
    rates = {"4 hybrid": hybrid_rate, "5 all-device": device_rate}
    phase7(device, idx, mo, reads, device_lines, engine, ref_cat, captured[0],
           rates, smi)
    fused_launches = phase8(device, idx, mo, reads, device_lines, rates, smi)
    phase9(ds, hybrid, device_lines, smi)
    log(f"[smoke] launches: phase 5's timed pass {launches}, phase 8's "
        f"{fused_launches}")

    def rec(kname, src, replaces, r):
        return {"name": kname, "route": "cuda",
                "source": f"rawalign_tpu_torch/csrc/{src}",
                "replaces": replaces,
                "launches": launches[kname] + fused_launches[kname],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                # no single PyTorch call computes any of the four
                "library_ms": None}

    kernels = [
        rec("event_detect", "event_detect.cu",
            "rawalign_tpu/signal/events_pallas.py:229", rec_events),
        rec("sketch_scan", "sketch_scan.cu",
            "rawalign_tpu/seeds/sketch_pallas.py:83", rec_sketch),
        rec("chain_dp", "chain_dp.cu",
            "rawalign_tpu/map/chain_pallas.py:162", rec_chain),
        rec("dtw_banded", "dtw_banded.cu",
            "rawalign_tpu/map/dtw_pallas.py:249", rec_dtw),
    ]
    log(f"[smoke] total wall {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    sys.exit(main())
