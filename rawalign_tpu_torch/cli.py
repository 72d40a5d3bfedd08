"""Command-line interface of the PyTorch port.

    python -m rawalign_tpu_torch.cli [options] <target.fa|target.idx.npz> [query ...]

``build_parser``, ``parse_num`` and ``apply_options`` are copies of
rawalign_tpu/cli.py's: the same options with the same help, plus
``--device`` (default ``cuda``). Indexing runs as in the JAX CLI (numpy
and the native host library); mapping runs the port's engine.
``--profile DIR`` traces the mapping loop with ``torch.profiler`` and
writes a Chrome trace into DIR; ``--debug-nans`` turns on the kernel
wrappers' NaN guard (``runtime.set_debug_nans``).
"""

from __future__ import annotations

import argparse
import os
import resource
import socket
import sys
import time

from rawalign_tpu_torch import __version__, config, runtime
from rawalign_tpu_torch.config import BorderConstraint, FillMethod, MappingFlag
from rawalign_tpu_torch.index import index as dindex
from rawalign_tpu_torch.io import fast5, fasta, paf
from rawalign_tpu_torch.pore_model import load_pore_model
from rawalign_tpu_torch.until import SequenceUntil


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rawalign-tpu-torch",
        description="TPU-native raw nanopore signal mapper "
        "(Seed-Filter-Align with banded DTW)",
    )
    p.add_argument("target", nargs="?", help="reference FASTA or prebuilt index (.npz)")
    p.add_argument("query", nargs="*", help="FAST5/sigbin files or directories")
    p.add_argument("-d", dest="dump", help="dump index to FILE")
    p.add_argument("-p", dest="pore", help="k-mer pore model FILE")
    p.add_argument("-k", type=int, help="pore model k-mer size")
    p.add_argument("-e", type=int, help="events per hash value")
    p.add_argument("-q", type=int, help="significant signal bits")
    p.add_argument("-l", dest="lq", type=int, help="low bits of q to quantize")
    p.add_argument("-w", type=int, help="minimizer window (0=off)")
    p.add_argument("-n", type=int, help="BLEND neighbors (unsupported, parity)")
    p.add_argument("-t", dest="threads", type=int, default=3, help="host worker threads")
    p.add_argument("-K", dest="minibatch", default=None, help="mapping mini-batch size")
    p.add_argument("-x", dest="preset", help="preset: sensitive|fast|faster|viral|sequence-until")
    p.add_argument("-o", dest="output", default="-", help="output PAF file")
    p.add_argument("--version", action="version", version=__version__)
    # chaining
    p.add_argument("--min-events", type=int)
    p.add_argument("--max-gap", type=int)
    p.add_argument("--max-target-gap", type=int)
    p.add_argument("--max-chains", type=int, help="chaining band length")
    p.add_argument("--min-anchors", type=int)
    p.add_argument("--best-chains", type=int)
    p.add_argument("--min-score", type=float)
    # mapping
    p.add_argument("--max-chunks", type=int)
    p.add_argument("--stop-min-anchor", type=int)
    p.add_argument("--map-min-anchor", type=int)
    p.add_argument("--stop-best-ratio", type=float)
    p.add_argument("--map-best-ratio", type=float)
    p.add_argument("--stop-mean-ratio", type=float)
    p.add_argument("--map-mean-ratio", type=float)
    p.add_argument("--bp-per-sec", type=int)
    p.add_argument("--sample-rate", type=int)
    p.add_argument("--chunk-size", type=int)
    # DTW
    p.add_argument("--dtw-evaluate-chains", action="store_true")
    p.add_argument("--dtw-output-cigar", action="store_true")
    p.add_argument("--dtw-border-constraint", choices=["global", "sparse", "local"])
    p.add_argument("--dtw-log-scores", action="store_true")
    p.add_argument("--no-chainingscore-filtering", action="store_true")
    p.add_argument("--dtw-match-bonus", type=float)
    p.add_argument("--dtw-fill-method", help="'banded', 'full' or 'banded=FRAC'")
    p.add_argument("--dtw-min-score", type=float)
    p.add_argument("--output-chains", action="store_true")
    p.add_argument("--log-anchors", action="store_true")
    p.add_argument("--log-num-anchors", action="store_true")
    # sequence until
    p.add_argument("--sequence-until", action="store_true")
    p.add_argument("--threshold", type=float)
    p.add_argument("--n-samples", type=int)
    p.add_argument("--test-frequency", type=int)
    p.add_argument("--min-reads", type=int)
    # TPU engine knobs
    p.add_argument("--batch-size", type=int, default=32, help="reads per device batch")
    p.add_argument("--max-occ", type=int, default=4096,
                   help="per-seed hit-count safety cap (the reference "
                   "gathers every hit, rmap.cpp:371-391; the default "
                   "never binds at evaluated genome scales)")
    p.add_argument("--chain-window", type=int, default=64, help="chaining DP predecessor window")
    p.add_argument("--max-anchors", type=int, default=2048,
                   help="per-read anchor budget for DEVICE chain paths; "
                   "the native (default) chain path sizes its arrays "
                   "dynamically and only decimates beyond the 128k "
                   "ceiling — lossless at evaluated scales")
    p.add_argument("--seeds-out", type=int, default=768,
                   help="compacted seed slots per chunk (device stage output)")
    p.add_argument("--pipeline-depth", type=int, default=4,
                   help="read groups advancing round-robin (overlaps host and device work)")
    p.add_argument("--engine", choices=["device", "golden"], default="device",
                   help="'golden' runs the NumPy reference-replica engine")
    p.add_argument("--chain-impl", choices=["auto", "native", "device"],
                   default="auto",
                   help="chaining DP placement: host C (native) or the "
                   "device kernel; auto prefers native when the host "
                   "library is built")
    p.add_argument("--stage1-impl",
                   choices=["auto", "device", "host", "hybrid"],
                   default="auto",
                   help="events+sketch+lookup placement: 'hybrid' "
                   "(host-C event detector — bit-identical to the "
                   "reference's C-double semantics — + device sketch/"
                   "lookup; the default when the native lib is built), "
                   "'device' (everything in one jitted dispatch, "
                   "f32 event detector), 'host' (C events + C sketch + "
                   "binary-search lookup; one device round trip per "
                   "round). 'auto' = hybrid if available else device")
    # observability / fault tolerance (SURVEY §5: the reference has none;
    # these are framework additions)
    p.add_argument("--resume", action="store_true",
                   help="skip reads already present in the -o PAF and append")
    p.add_argument("--profile", metavar="DIR",
                   help="capture a torch.profiler trace (host, and the "
                   "card's kernels) of the mapping loop into DIR")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise on a NaN in a kernel's float inputs or "
                   "outputs, as jax debug_nans (slow; for debugging)")
    p.add_argument("--selfcheck", type=float, default=0.0, metavar="FRAC",
                   help="sanitizer analog: re-map a deterministic FRAC "
                   "sample of reads with the golden host oracle and "
                   "report any mapping-column divergence (0=off). "
                   "Capture stops after --selfcheck-max-reads eligible "
                   "reads (stream order)")
    p.add_argument("--selfcheck-max-reads", type=int, default=64,
                   metavar="N",
                   help="cap on reads captured for --selfcheck (bounds "
                   "the golden re-map cost; raise for full audits)")
    p.add_argument("--mt-mode", choices=["share", "wall"], default="share",
                   help="mt:f tag semantics for the batched engine: "
                   "'share' = amortized per-read share of each round's "
                   "wall (batching-fair aggregate metric), 'wall' = "
                   "strict reference semantics — each read's wall clock "
                   "across its live rounds (rmap.cpp:684-694; directly "
                   "comparable to the binary's mt:f, double-counts "
                   "shared batch cost)")
    p.add_argument("--selfcheck-strict", action="store_true",
                   help="exit nonzero if --selfcheck finds divergent "
                   "reads (for CI/automation)")
    p.add_argument("--device", default="cuda",
                   help="torch device the engine runs on (cuda or cpu)")
    return p


def parse_num(s: str) -> int:
    s = s.strip()
    mult = 1
    if s and s[-1] in "kKmMgG":
        mult = {"k": 10**3, "m": 10**6, "g": 10**9}[s[-1].lower()]
        s = s[:-1]
    return int(float(s) * mult + 0.499)


def apply_options(args) -> tuple[config.IndexOptions, config.MappingOptions]:
    io = config.IndexOptions()
    mo = config.MappingOptions()
    if args.preset:
        config.set_opt(args.preset, io, mo)
    for name, attr in [
        ("k", "k"), ("e", "e"), ("q", "q"), ("lq", "lq"), ("w", "w"), ("n", "n")
    ]:
        v = getattr(args, name)
        if v is not None:
            setattr(io, attr, v)
    simple = {
        "min_events": "min_events",
        "max_gap": "max_gap_length",
        "max_target_gap": "max_target_gap_length",
        "max_chains": "chaining_band_length",
        "min_anchors": "min_num_anchors",
        "best_chains": "num_best_chains",
        "min_score": "min_chaining_score",
        "max_chunks": "max_num_chunk",
        "stop_min_anchor": "min_chain_anchor",
        "map_min_anchor": "min_chain_anchor_out",
        "stop_best_ratio": "min_bestmap_ratio",
        "map_best_ratio": "min_bestmap_ratio_out",
        "stop_mean_ratio": "min_meanmap_ratio",
        "map_mean_ratio": "min_meanmap_ratio_out",
        "bp_per_sec": "bp_per_sec",
        "sample_rate": "sample_rate",
        "chunk_size": "chunk_size",
        "dtw_match_bonus": "dtw_match_bonus",
        "dtw_min_score": "dtw_min_score",
        "threshold": "t_threshold",
        "n_samples": "tn_samples",
        "test_frequency": "ttest_freq",
        "min_reads": "tmin_reads",
    }
    for arg_name, opt_name in simple.items():
        v = getattr(args, arg_name)
        if v is not None:
            setattr(mo, opt_name, v)
    if args.minibatch is not None:
        mo.mini_batch_size = parse_num(args.minibatch)
    flags = [
        ("sequence_until", MappingFlag.SEQUENCE_UNTIL),
        ("dtw_evaluate_chains", MappingFlag.DTW_EVALUATE_CHAINS),
        ("dtw_output_cigar", MappingFlag.DTW_OUTPUT_CIGAR),
        ("dtw_log_scores", MappingFlag.DTW_LOG_SCORES),
        ("no_chainingscore_filtering", MappingFlag.DISABLE_CHAININGSCORE_FILTERING),
        ("output_chains", MappingFlag.OUTPUT_CHAINS),
        ("log_anchors", MappingFlag.LOG_ANCHORS),
        ("log_num_anchors", MappingFlag.LOG_NUM_ANCHORS),
    ]
    for arg_name, flag in flags:
        if getattr(args, arg_name):
            mo.flag |= flag
    if args.dtw_border_constraint:
        mo.dtw_border_constraint = {
            "global": BorderConstraint.GLOBAL,
            "sparse": BorderConstraint.SPARSE,
            "local": BorderConstraint.LOCAL,
        }[args.dtw_border_constraint]
    if args.dtw_fill_method:
        fm = args.dtw_fill_method
        if fm == "banded":
            mo.dtw_fill_method = FillMethod.BANDED
        elif fm == "full":
            mo.dtw_fill_method = FillMethod.FULL
        elif fm.startswith("banded="):
            mo.dtw_fill_method = FillMethod.BANDED
            mo.dtw_band_radius_frac = float(fm[7:])
        else:
            raise SystemExit(f"[ERROR] unknown DTW fill method '{fm}'")
    return io, mo


def _load_or_build_index(args, io, t0):
    if args.target.endswith(".npz"):
        idx = dindex.RawIndex.load(args.target)
        print(f"[M::main::{time.time()-t0:.3f}] loaded the index for "
              f"{idx.n_seq} target sequence(s)", file=sys.stderr)
        return idx
    with open(args.target, "rb") as f:
        is_ref_index = f.read(2) == b"RI"
    if is_ref_index:
        from rawalign_tpu_torch.index.ref_format import load_reference_index

        idx = load_reference_index(args.target)
        print(f"[M::main::{time.time()-t0:.3f}] loaded the reference-format "
              f"index for {idx.n_seq} target sequence(s)", file=sys.stderr)
        return idx
    if not args.pore:
        print("[ERROR] specify a pore model file with -p when indexing from "
              "a sequence file", file=sys.stderr)
        return None
    model = load_pore_model(args.pore)
    io.k = model.k
    idx = dindex.build_index(list(fasta.read_fasta(args.target)),
                             model.pore_vals, io)
    print(f"[M::main::{time.time()-t0:.3f}] built the index for {idx.n_seq} "
          f"target sequence(s), {idx.keys.size} seeds", file=sys.stderr)
    if args.dump:
        if args.dump.endswith(".ind"):
            from rawalign_tpu_torch.index.ref_format import dump_reference_index

            dump_reference_index(idx, args.dump)
        else:
            idx.save(args.dump)
        print(f"[M::main] index dumped to {args.dump}", file=sys.stderr)
    return idx


def _start_profiler(args):
    """A started ``torch.profiler`` session over the host, and over the
    card when the mapping engine runs on one."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if args.engine == "device" and torch.device(args.device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False)
    prof.start()
    return prof


def _write_trace(prof, out_dir: str) -> str:
    """Write the stopped session's Chrome trace into ``out_dir`` under a
    name of its own (host, pid and time, as
    ``torch.profiler.tensorboard_trace_handler`` names its files)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{socket.gethostname()}_{os.getpid()}."
                        f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.target is None:
        parser.print_help()
        return 1
    debug_nans = runtime.debug_nans()
    runtime.set_debug_nans(args.debug_nans)
    try:
        return _run(args)
    finally:
        runtime.set_debug_nans(debug_nans)


def _run(args) -> int:
    t0 = time.time()
    io, mo = apply_options(args)
    idx = _load_or_build_index(args, io, t0)
    if idx is None:
        return 1
    if not args.query:
        if not args.dump and not args.target.endswith(".npz"):
            print("[ERROR] missing input: specify query signal files or -d "
                  "to store the index", file=sys.stderr)
            return 1
        return 0
    files: list[str] = []
    for qpath in args.query:
        files.extend(fast5.find_signal_files(qpath))
    if not files:
        print("[ERROR] no signal files found", file=sys.stderr)
        return 1

    # --resume: skip reads already in the -o PAF and append
    already_done: set[str] = set()
    if args.resume and args.output != "-":
        try:
            with open(args.output) as f:
                already_done = {ln.split("\t", 1)[0] for ln in f if ln.strip()}
            print(f"[M::main] resume: {len(already_done)} reads already mapped",
                  file=sys.stderr)
        except OSError:
            pass
    checker = None
    if args.selfcheck > 0.0:
        from rawalign_tpu_torch.selfcheck import SelfCheck

        checker = SelfCheck(idx, mo, fraction=args.selfcheck,
                            max_reads=args.selfcheck_max_reads)

    def reads():
        from rawalign_tpu_torch.io.prefetch import prefetch_signals

        for name, sig in prefetch_signals(files, n_threads=args.threads):
            if name not in already_done:
                if checker is not None:
                    checker.capture(name, sig)
                yield name, sig

    su = (SequenceUntil(idx.n_seq, mo)
          if mo.flag & MappingFlag.SEQUENCE_UNTIL else None)
    out = sys.stdout if args.output == "-" else open(
        args.output, "a" if args.resume else "w")
    # the trace spans the mapping loop, as the JAX CLI's does; the
    # profiler stops whether the loop ends or raises
    prof = engine = None
    n_out = 0
    su_stopped = False
    try:
        if args.profile:
            prof = _start_profiler(args)
        if args.engine == "golden":
            from rawalign_tpu_torch.golden import engine as gengine

            results = gengine.map_reads(idx, reads(), mo)
        else:
            from rawalign_tpu_torch.map.engine import MappingEngine

            engine = MappingEngine(
                idx, mo,
                device=args.device,
                batch_size=args.batch_size,
                max_occ=args.max_occ,
                chain_window=args.chain_window,
                max_anchors=args.max_anchors,
                seeds_out=args.seeds_out,
                pipeline_depth=args.pipeline_depth,
                chain_impl=args.chain_impl,
                stage1_impl=args.stage1_impl,
                mt_mode=args.mt_mode,
            )
            results = engine.map_reads(reads())
        for res in results:
            line = paf.paf_line(res)
            if su_stopped and res.mapped:
                # post-stop reads print as forced-unmapped lines that keep
                # read_length/mapq/tags (rmap.cpp:960-964)
                cols = line.split("\t")
                cols[2:11] = ["*"] * 9
                line = "\t".join(cols)
            print(line, file=out)
            n_out += 1
            if checker is not None:
                checker.record(res)
            if su is not None and not su_stopped and res.mapped:
                ref_id = idx.seq_names.index(res.ref_name)
                if su.add_mapped_read(ref_id, res.fragment_length):
                    su_stopped = True
                    print("[M::map] Sequence Until is activated, stopping "
                          f"sequencing after processing {su.n_reads} mapped "
                          "reads", file=sys.stderr)
    finally:
        if prof is not None:
            prof.stop()
        if out is not sys.stdout:
            out.close()
        if engine is not None:
            engine.close()
    if prof is not None:
        print(f"[M::main] profiler trace written to "
              f"{_write_trace(prof, args.profile)}", file=sys.stderr)
    selfcheck_failed = checker is not None and checker.report()["n_divergent"] > 0
    # final resource report (main.cpp:389-394); ru_maxrss is KiB on Linux,
    # bytes on macOS
    ru = resource.getrusage(resource.RUSAGE_SELF)
    rss_div = 1024.0**3 if sys.platform == "darwin" else 1024.0**2
    print(f"[M::main] Version: {__version__}\n[M::main] Real time: "
          f"{time.time()-t0:.3f} sec; CPU: {ru.ru_utime + ru.ru_stime:.3f} sec; "
          f"Peak RSS: {ru.ru_maxrss / rss_div:.3f} GB; reads: {n_out}",
          file=sys.stderr)
    if selfcheck_failed and args.selfcheck_strict:
        return 7
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
