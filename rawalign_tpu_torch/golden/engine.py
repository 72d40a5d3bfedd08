"""Copy of rawalign_tpu/golden/engine.py for the port.

Per-read mapping engine golden model (reference: src/rmap.cpp).

Replicates the streaming chunk loop (map_worker_for, rmap.cpp:667-822):
chunks of ``chunk_size`` samples are event-detected, seeded, chained and
DTW-evaluated; chain state carries across chunks; mapping stops early on a
confident decision (rmap.cpp:594-665). Produces MappingResult records that
serialize to the reference's PAF format.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from rawalign_tpu_torch.config import MappingFlag, MappingOptions
from rawalign_tpu_torch.golden import chain as gchain
from rawalign_tpu_torch.golden import events as gevents
from rawalign_tpu_torch.io import paf


def c_fdiv(a: float, b: float) -> float:
    """C float-division semantics: x/0 = +-inf, 0/0 = nan.

    The reference divides chain scores that can be 0 (or <=0 with
    --no-chainingscore-filtering, rmap.cpp:605,652); Python would raise
    ZeroDivisionError where C yields inf/nan (whose comparisons are
    well-defined: nan >= r is false).
    """
    if b == 0.0:
        if a == 0.0:
            return float("nan")
        return float("inf") if a > 0.0 else float("-inf")
    return a / b


@dataclasses.dataclass
class ReadState:
    """Mirror of ri_reg1_t + the per-read global event array."""

    read_name: str
    chains: list[gchain.Chain] = dataclasses.field(default_factory=list)
    events: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.float32)
    )
    offset: int = 0  # events consumed by chaining so far


def map_frag(
    index, sig_chunk: np.ndarray, state: ReadState, opt: MappingOptions
) -> None:
    """One chunk (ri_map_frag, rmap.cpp:545-578)."""
    chunk_events = gevents.detect_events(sig_chunk, opt)
    state.events = np.concatenate([state.events, chunk_events])
    if chunk_events.size < opt.min_events:
        return
    state.chains = gchain.gen_chains(
        index,
        chunk_events,
        state.offset,
        state.events,
        state.chains,
        opt,
        read_name=state.read_name,
    )
    state.offset += chunk_events.size


def is_mapped_with_high_confidence(state: ReadState, opt: MappingOptions) -> bool:
    """Early-termination / output decision (rmap.cpp:594-665)."""
    chains = state.chains
    n_anchors0 = chains[0].n_anchors if chains else 0
    if n_anchors0 == 0:
        return False
    if opt.flag & MappingFlag.DTW_EVALUATE_CHAINS:
        if len(chains) >= 2:
            if (
                c_fdiv(chains[0].alignment_score, chains[1].alignment_score)
                >= opt.min_bestmap_ratio
            ):
                return True
            mean = sum(c.alignment_score for c in chains) / len(chains)
            if chains[0].alignment_score >= opt.min_meanmap_ratio * mean:
                return True
            return False
        if len(chains) == 1 and chains[0].n_anchors >= opt.min_chain_anchor:
            return True
        return False
    if len(chains) >= 2:
        if (
            c_fdiv(chains[0].chaining_score, chains[1].chaining_score)
            >= opt.min_bestmap_ratio
        ):
            return True
        mean = sum(c.chaining_score for c in chains) / len(chains)
        if chains[0].chaining_score >= opt.min_meanmap_ratio * mean:
            return True
    elif len(chains) == 1 and chains[0].n_anchors >= opt.min_chain_anchor:
        return True
    return False


def _dtwresult_to_string(res) -> str:
    """dtwresult_to_string (rmap.cpp:580-592).

    The reference streams the float through ``std::stringstream <<``,
    whose default formatting is 6 SIGNIFICANT digits with trailing
    zeros dropped (printf %g) — not 6 decimal places."""
    return "".join(
        f"({el.i},{el.j},{float(el.difference):.6g})" for el in res.alignment
    )


def _anchors_to_string(anchors: np.ndarray) -> str:
    """anchors_to_string (rmap.cpp:53-63): (query,target) pairs."""
    return "".join(f"({int(q)},{int(t)})" for t, q in anchors)


def map_read(
    index, sig: np.ndarray, read_name: str, opt: MappingOptions
) -> paf.MappingResult:
    """Map one read's full raw signal (map_worker_for, rmap.cpp:667-822)."""
    sig = np.asarray(sig, dtype=np.float32)
    qlen = sig.size
    l_chunk = opt.chunk_size
    max_chunk = opt.max_num_chunk
    state = ReadState(read_name=read_name)

    t0 = time.perf_counter()
    current_chunk = 0
    chunk_start = 0
    # Loop structure mirrors rmap.cpp:685-693: on an early-stop break the
    # counters keep the index of the chunk that produced the decision; on
    # natural exit they point one past the last chunk (and are decremented
    # below, rmap.cpp:696).
    while chunk_start < qlen and current_chunk < max_chunk:
        chunk_end = min(chunk_start + l_chunk, qlen)
        map_frag(index, sig[chunk_start:chunk_end], state, opt)
        if is_mapped_with_high_confidence(state, opt):
            break
        chunk_start += l_chunk
        current_chunk += 1
    mapping_time_ms = (time.perf_counter() - t0) * 1000.0

    # C quirk: the loop increments before the check, then decrements when the
    # loop ran off the end (rmap.cpp:696).
    if current_chunk > 0 and (chunk_start >= qlen or current_chunk == max_chunk):
        current_chunk -= 1

    offset = state.offset if state.offset else 1  # avoid div-by-zero like C's UB
    read_position_scale = paf.position_scale_f32(
        current_chunk + 1, l_chunk, offset, opt.sample_rate, opt.bp_per_sec
    )

    chains = state.chains
    n_anchors0 = chains[0].n_anchors if chains else 0
    mean_chain_score = paf.mean_score_f32(
        [c.chaining_score for c in chains]
    )

    if is_mapped_with_high_confidence(state, opt):
        c0 = chains[0]
        if opt.flag & MappingFlag.DTW_OUTPUT_CIGAR:
            gchain.align_chain(c0, index, state.events, opt, cigar=True)
        at, aq = paf.anchor_gap_means_f32(c0.anchors)
        tags = paf.build_tags(
            mapping_time_ms=mapping_time_ms,
            n_chunks=current_chunk + 1,
            qlen=qlen,
            n_anchors0=n_anchors0,
            n_chains=len(chains),
            s1=c0.chaining_score,
            s2=chains[1].chaining_score if len(chains) > 1 else 0.0,
            sm=mean_chain_score,
            at=at,
            aq=aq,
            mapped_with_chains=True,
            alns=(
                c0.alignment_score
                if opt.flag & MappingFlag.DTW_OUTPUT_CIGAR
                else None
            ),
            aln=(
                _dtwresult_to_string(c0.dtw)
                if opt.flag & MappingFlag.DTW_OUTPUT_CIGAR
                else None
            ),
            anchors=(
                _anchors_to_string(c0.anchors)
                if opt.flag & MappingFlag.OUTPUT_CHAINS
                else None
            ),
        )
        ref_len = int(index.seq_lens[c0.reference_sequence_index])
        frag_start = (
            int(ref_len + 1 - c0.end_position)
            if c0.strand
            else int(c0.start_position)
        )
        return paf.MappingResult(
            read_name=read_name,
            read_length=paf.scale_pos(read_position_scale, c0.anchors[0][1]),
            mapped=True,
            read_start_position=paf.scale_pos(
                read_position_scale, c0.anchors[n_anchors0 - 1][1]
            ),
            read_end_position=paf.scale_pos(read_position_scale, c0.anchors[0][1]),
            ref_name=index.seq_names[c0.reference_sequence_index],
            ref_len=ref_len,
            fragment_start_position=frag_start,
            fragment_length=int(c0.end_position - c0.start_position + 1),
            rev=c0.strand,
            mapq=c0.mapq,
            tags=tags,
        )

    # unmapped
    if chains:
        c0 = chains[0]
        if n_anchors0:
            at, aq = paf.anchor_gap_means_f32(c0.anchors)
        else:
            at = aq = 0.0
        tags = paf.build_tags(
            mapping_time_ms=mapping_time_ms,
            n_chunks=current_chunk + 1,
            qlen=qlen,
            n_anchors0=n_anchors0,
            n_chains=len(chains),
            s1=c0.chaining_score,
            s2=chains[1].chaining_score if len(chains) > 1 else 0.0,
            sm=mean_chain_score,
            at=at,
            aq=aq,
        )
    else:
        tags = paf.build_tags(
            mapping_time_ms=mapping_time_ms,
            n_chunks=current_chunk + 1,
            qlen=qlen,
        )
    return paf.MappingResult(
        read_name=read_name,
        read_length=paf.scale_pos(read_position_scale, state.offset),
        mapped=False,
        mapq=0,
        tags=tags,
    )


def map_reads(index, reads, opt: MappingOptions):
    """Map an iterable of (name, signal) pairs; yields MappingResult."""
    for name, sig in reads:
        yield map_read(index, sig, name, opt)
