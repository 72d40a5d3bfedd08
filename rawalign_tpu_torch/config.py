"""Copy of rawalign_tpu/config.py for the port.

Indexing and mapping options, presets, and feature flags.

Mirrors the reference option system (reference: src/roptions.h:33-87,
src/roptions.c:5-61, src/rawindex.cpp:465-472, presets src/main.cpp:131-150)
as frozen-by-convention dataclasses. Defaults are byte-for-byte the
reference defaults so that runs are comparable.

:func:`options_from` carries options made elsewhere (the JAX package's,
in the tests) into these classes.
"""

from __future__ import annotations

import dataclasses
import enum


class BorderConstraint(enum.IntEnum):
    """DTW border constraint (reference: src/roptions.h:21-23)."""

    GLOBAL = 0
    SPARSE = 1
    LOCAL = 2  # parsed but unsupported, as in the reference (rmap.cpp:301-304)


class FillMethod(enum.IntEnum):
    """DTW fill method (reference: src/roptions.h:25-26)."""

    FULL = 0
    BANDED = 1


class MappingFlag(enum.IntFlag):
    """Mapping feature flags (reference: src/roptions.h:12-19)."""

    NONE = 0
    SEQUENCE_UNTIL = 0x1
    DTW_EVALUATE_CHAINS = 0x2
    DTW_OUTPUT_CIGAR = 0x4
    DTW_LOG_SCORES = 0x8
    DISABLE_CHAININGSCORE_FILTERING = 0x10
    OUTPUT_CHAINS = 0x20
    LOG_ANCHORS = 0x40
    LOG_NUM_ANCHORS = 0x80


@dataclasses.dataclass
class IndexOptions:
    """Indexing options (reference: src/roptions.h:33-37, defaults
    src/rawindex.cpp:465-472)."""

    b: int = 14  # log2 number of buckets (informational; the TPU index is one sorted table)
    w: int = 0  # minimizer window; 0 disables minimizer seeding
    e: int = 6  # events packed per hash
    n: int = 0  # BLEND neighbors (disabled, as in the reference)
    q: int = 9  # most significant bits of the float event value used
    lq: int = 3  # low bits of the q bits kept next to the top-2 bits
    k: int = 6  # pore-model k-mer length
    mini_batch_size: int = 50_000_000
    batch_size: int = 4_000_000_000
    flag: int = 0


@dataclasses.dataclass
class MappingOptions:
    """Mapping options (reference: src/roptions.h:39-87, defaults
    src/roptions.c:5-61)."""

    # ONT device parameters
    bp_per_sec: int = 450
    sample_rate: int = 4000
    chunk_size: int = 4000

    # Chaining parameters
    min_events: int = 50
    max_gap_length: int = 2000
    max_target_gap_length: int = 5000
    chaining_band_length: int = 5000
    max_num_skips: int = 25
    min_num_anchors: int = 2
    num_best_chains: int = 3
    min_chaining_score: float = 10.0

    # Mapping parameters
    step_size: int = 1
    max_num_chunk: int = 30
    min_chain_anchor: int = 2  # --stop-min-anchor
    min_chain_anchor_out: int = 2  # --map-min-anchor
    dtw_border_constraint: BorderConstraint = BorderConstraint.SPARSE
    dtw_fill_method: FillMethod = FillMethod.BANDED
    dtw_band_radius_frac: float = 0.10
    dtw_match_bonus: float = 0.4
    dtw_min_score: float = 20.0

    min_bestmap_ratio: float = 1.2
    min_bestmap_ratio_out: float = 1.2
    min_meanmap_ratio: float = 5.0
    min_meanmap_ratio_out: float = 5.0

    # Sequence Until parameters
    t_threshold: float = 1.5
    tn_samples: int = 5
    ttest_freq: int = 500
    tmin_reads: int = 500

    flag: MappingFlag = MappingFlag.NONE
    mini_batch_size: int = 500_000_000

    # Event detector options
    window_length1: int = 3
    window_length2: int = 6
    threshold1: float = 4.30265
    threshold2: float = 2.57058
    peak_height: float = 1.0

    # --- TPU engine shape caps (not in the reference; padding bounds for
    # fixed-shape device computation). These do not change results: overflow
    # is counted and reported, mirroring the occurrence-filter idea the
    # reference left disabled (rmap.cpp:28-51).
    max_events_per_chunk: int = 2048
    max_seed_hits_per_seed: int = 512
    max_anchors_per_bucket: int = 8192

    def set_flag(self, flag: MappingFlag, on: bool = True) -> None:
        if on:
            self.flag |= flag
        else:
            self.flag &= ~flag


PRESETS = ("sensitive", "fast", "faster", "viral", "sequence-until")


def set_opt(preset: str | None, io: IndexOptions, mo: MappingOptions) -> None:
    """Apply a named preset (reference: src/main.cpp:131-150).

    Presets are applied before other command-line options, exactly as the
    reference applies `-x` first.
    """
    if preset is None:
        return
    if preset == "sensitive":
        io.e, io.q, io.lq, io.w, io.n = 6, 9, 3, 0, 0
    elif preset == "fast":
        io.e, io.q, io.lq, io.w, io.n = 7, 9, 3, 0, 0
        mo.mini_batch_size = 750_000_000
    elif preset == "faster":
        io.e, io.q, io.lq, io.w, io.n = 7, 9, 3, 5, 0
        mo.mini_batch_size = 1_000_000_000
    elif preset == "viral":
        io.e, io.q, io.lq, io.w, io.n = 5, 9, 3, 0, 0
    elif preset == "sequence-until":
        io.e, io.q, io.lq, io.w, io.n = 7, 9, 3, 0, 0
        mo.mini_batch_size = 750_000_000
    else:
        raise ValueError(f"unknown preset {preset!r}; valid: {PRESETS}")


def options_from(other):
    """This module's ``IndexOptions`` or ``MappingOptions`` (by the class
    name of ``other``) with every field read from ``other``; enum fields
    become this module's enums of the same value."""
    cls = {"IndexOptions": IndexOptions,
           "MappingOptions": MappingOptions}[type(other).__name__]
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(other, f.name)
        kw[f.name] = type(f.default)(int(v)) if isinstance(f.default, enum.Enum) else v
    return cls(**kw)
