"""Copy of rawalign_tpu/testing/synth.py for the port.

Synthetic dataset generation for tests and benchmarks.

Real nanopore datasets and the ONT k-mer models are not redistributable
here, so tests and benchmarks run on synthetic data with the same
statistical structure: a random genome, a synthetic pore model, and reads
simulated through the pore model (per-base dwell times around
sample_rate/bp_per_sec samples, Gaussian current noise), mirroring the
signal model the reference's evaluation datasets exercise
(test/data/README.md in the reference).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rawalign_tpu_torch.io.fasta import Sequence
from rawalign_tpu_torch.pore_model import PoreModel, synthetic_pore_model


@dataclasses.dataclass
class SimRead:
    name: str
    signal: np.ndarray  # float32 pA values
    ref_id: int
    strand: int  # 0 = forward ('+'), 1 = reverse ('-')
    ref_start: int  # forward-coordinate start (bp)
    ref_end: int  # forward-coordinate end (bp, exclusive)


@dataclasses.dataclass
class SynthDataset:
    seqs: list[Sequence]
    model: PoreModel
    reads: list[SimRead]


_COMP = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}


def revcomp(seq: str) -> str:
    return "".join(_COMP[c] for c in reversed(seq))


def random_genome(rng: np.random.Generator, lengths: list[int]) -> list[Sequence]:
    return [
        Sequence(
            name=f"synth_seq{i}",
            seq="".join(rng.choice(list("ACGT"), size=n)),
            rid=i,
        )
        for i, n in enumerate(lengths)
    ]


def tandem_genome(
    rng: np.random.Generator,
    *,
    unit_len: int,
    copies: int,
    flank: int = 5000,
    divergence: float = 0.0,
    name: str = "tandem_seq0",
) -> list[Sequence]:
    """A genome dominated by a tandem repeat: ``copies`` near-identical
    repeats of a random ``unit_len``-bp unit (each copy independently
    mutated at ``divergence`` per-base rate), flanked by random sequence.
    The regime where anchor lists get dense and the reference's 5000-
    anchor chaining band (rmap.cpp:440-484) actually matters."""
    unit = "".join(rng.choice(list("ACGT"), size=unit_len))
    bases = "ACGT"
    parts = ["".join(rng.choice(list("ACGT"), size=flank))]
    for _ in range(copies):
        if divergence > 0:
            chars = list(unit)
            n_mut = rng.binomial(unit_len, divergence)
            for j in rng.choice(unit_len, size=n_mut, replace=False):
                chars[j] = bases[int(rng.integers(0, 4))]
            parts.append("".join(chars))
        else:
            parts.append(unit)
    parts.append("".join(rng.choice(list("ACGT"), size=flank)))
    return [Sequence(name=name, seq="".join(parts), rid=0)]


def segdup_genome(
    rng: np.random.Generator,
    *,
    total_len: int,
    dup_len: int,
    n_dups: int,
    divergence: float = 0.02,
    name: str = "segdup_seq0",
) -> list[Sequence]:
    """A genome with ``n_dups`` diverged copies of one ``dup_len``-bp
    block scattered at random offsets over a ``total_len`` random
    backbone — the segmental-duplication regime (d4/d5-class genomes)
    where a read's true locus competes with near-identical paralogs far
    away on the target axis."""
    bases = "ACGT"
    backbone = rng.choice(list(bases), size=total_len)
    block = rng.choice(list(bases), size=dup_len)
    starts = rng.choice(
        max(total_len - dup_len, 1), size=n_dups, replace=False
    )
    for s in starts:
        copy = block.copy()
        n_mut = rng.binomial(dup_len, divergence)
        for j in rng.choice(dup_len, size=n_mut, replace=False):
            copy[j] = bases[int(rng.integers(0, 4))]
        backbone[s : s + dup_len] = copy[: len(backbone) - s]
    return [Sequence(name=name, seq="".join(backbone), rid=0)]


def shuffled_repeat_genome(
    rng: np.random.Generator,
    *,
    n_units: int,
    unit_len: int,
    n_blocks: int,
    divergence: float = 0.03,
    spacer_len: int = 400,
    name: str = "shuffled_seq0",
) -> list[Sequence]:
    """A genome built from a small library of repeat units emitted in
    random order with random spacers (transposon-like shuffled repeats):
    unlike a tandem array, matching anchors are SCATTERED across the
    whole target axis, the adversarial case for a bounded predecessor
    window in the chaining DP."""
    bases = "ACGT"
    units = [rng.choice(list(bases), size=unit_len) for _ in range(n_units)]
    parts = []
    for _ in range(n_blocks):
        parts.append("".join(rng.choice(list(bases), size=spacer_len)))
        u = units[int(rng.integers(0, n_units))].copy()
        n_mut = rng.binomial(unit_len, divergence)
        for j in rng.choice(unit_len, size=n_mut, replace=False):
            u[j] = bases[int(rng.integers(0, 4))]
        parts.append("".join(u))
    parts.append("".join(rng.choice(list(bases), size=spacer_len)))
    return [Sequence(name=name, seq="".join(parts), rid=0)]


def simulate_read_signal(
    rng: np.random.Generator,
    seq: str,
    model: PoreModel,
    *,
    bp_per_sec: int = 450,
    sample_rate: int = 4000,
    noise_pa: float = 1.5,
    dwell_cv: float = 0.25,
) -> np.ndarray:
    """Raw pA signal for a (sub)sequence passed 5'->3' through the pore."""
    k = model.k
    n = len(seq) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.float32)
    codes = np.array(
        ["ACGT".find(c) if c in "ACGT" else 0 for c in seq], dtype=np.int64
    )
    kmers = np.zeros(n, dtype=np.int64)
    for j in range(k):
        kmers = (kmers << 2) | codes[j : n + j]
    levels = model.level_mean[kmers]
    mean_dwell = sample_rate / bp_per_sec
    dwells = np.maximum(
        1, rng.normal(mean_dwell, mean_dwell * dwell_cv, size=n).round().astype(int)
    )
    sig = np.repeat(levels, dwells)
    sig = sig + rng.normal(0.0, noise_pa, size=sig.size)
    return sig.astype(np.float32)


def make_dataset(
    *,
    seed: int = 42,
    genome_lengths: list[int] | None = None,
    n_reads: int = 20,
    read_len_bp: tuple[int, int] = (300, 1500),
    k: int = 6,
    noise_pa: float = 1.5,
    frac_random: float = 0.0,
    seqs: list[Sequence] | None = None,
) -> SynthDataset:
    """A full synthetic dataset.

    frac_random: fraction of reads drawn as pure noise (unmappable), to
    exercise the unmapped path and precision metrics. Pass ``seqs`` to
    simulate reads off a custom genome (e.g. tandem_genome).
    """
    rng = np.random.default_rng(seed)
    if genome_lengths is None:
        genome_lengths = [20_000, 10_000]
    if seqs is None:
        seqs = random_genome(rng, genome_lengths)
    model = synthetic_pore_model(k=k, seed=seed + 1)
    reads: list[SimRead] = []
    for i in range(n_reads):
        if rng.random() < frac_random:
            length = int(rng.integers(2000, 20000))
            sig = rng.normal(95.0, 15.0, size=length).astype(np.float32)
            reads.append(
                SimRead(
                    name=f"random_read{i}",
                    signal=sig,
                    ref_id=-1,
                    strand=0,
                    ref_start=0,
                    ref_end=0,
                )
            )
            continue
        rid = int(rng.integers(0, len(seqs)))
        L = int(rng.integers(read_len_bp[0], read_len_bp[1] + 1))
        ref = seqs[rid].seq
        L = min(L, len(ref) - k)
        start = int(rng.integers(0, len(ref) - L + 1))
        strand = int(rng.integers(0, 2))
        sub = ref[start : start + L]
        if strand:
            sub = revcomp(sub)
        sig = simulate_read_signal(
            rng, sub, model, noise_pa=noise_pa
        )
        reads.append(
            SimRead(
                name=f"synth_read{i}",
                signal=sig,
                ref_id=rid,
                strand=strand,
                ref_start=start,
                ref_end=start + L,
            )
        )
    return SynthDataset(seqs=seqs, model=model, reads=reads)
