"""Copy of rawalign_tpu/pore_model.py for the port.

K-mer pore model: expected current level per k-mer.

Parses the nanopore k-mer model TSV format (columns: kmer, level_mean,
level_stdv, sd_mean, sd_stdv; '#'-comments and a 'kmer' header line are
skipped) into a dense float32 table of size 4**k indexed by the 2-bit
encoding A=0 C=1 G=2 T=3 (reference: src/pore_model.cpp:50-84; 2-bit
encoding src/pore_model.cpp:9-47). Only level_mean is used downstream, as
in the reference (main.cpp:349-351), but all four columns are retained.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# A=0 C=1 G=2 T=3, everything else 4 ("ambiguous").
_BASE_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _BASE_CODE[ord(_c)] = _i
    _BASE_CODE[ord(_c.lower())] = _i

SEQ_NT4 = _BASE_CODE  # alias; same contract as the reference's seq_nt4_table


def encode_kmer(kmer: str) -> int:
    """2-bit encode a k-mer; ambiguous bases encode as A (shift-in 0)."""
    code = 0
    for ch in kmer:
        c = _BASE_CODE[ord(ch)]
        code = (code << 2) | (int(c) if c < 4 else 0)
    return code & ((1 << (2 * len(kmer))) - 1)


@dataclasses.dataclass
class PoreModel:
    k: int
    level_mean: np.ndarray  # float32 (4**k,)
    level_stdv: np.ndarray
    sd_mean: np.ndarray
    sd_stdv: np.ndarray

    @property
    def pore_vals(self) -> np.ndarray:
        """The table the mapper uses: level means only (main.cpp:349-351)."""
        return self.level_mean


def load_pore_model(path: str) -> PoreModel:
    k = None
    table = None
    n_loaded = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("kmer"):
                continue
            fields = line.split()
            kmer = fields[0]
            if k is None:
                k = len(kmer)
                table = np.zeros((4, 4**k), dtype=np.float32)
            if len(kmer) != k:
                raise ValueError(f"inconsistent k-mer length in {path}: {kmer}")
            idx = encode_kmer(kmer)
            vals = [float(v) for v in fields[1:5]]
            vals += [0.0] * (4 - len(vals))
            table[:, idx] = vals
            n_loaded += 1
    if k is None or k <= 4:
        # The reference rejects k<=4 models (main.cpp:344-348).
        raise ValueError(f"cannot parse k-mer pore model file {path!r} (k={k})")
    return PoreModel(
        k=k,
        level_mean=table[0],
        level_stdv=table[1],
        sd_mean=table[2],
        sd_stdv=table[3],
    )


def save_pore_model(path: str, model: PoreModel) -> None:
    """Write a model TSV readable by both this framework and the reference."""
    bases = "ACGT"
    k = model.k
    with open(path, "w") as f:
        f.write("kmer\tlevel_mean\tlevel_stdv\tsd_mean\tsd_stdv\n")
        for idx in range(4**k):
            kmer = "".join(bases[(idx >> (2 * (k - 1 - j))) & 3] for j in range(k))
            f.write(
                f"{kmer}\t{model.level_mean[idx]:.6f}\t{model.level_stdv[idx]:.6f}"
                f"\t{model.sd_mean[idx]:.6f}\t{model.sd_stdv[idx]:.6f}\n"
            )


def synthetic_pore_model(k: int = 6, seed: int = 0) -> PoreModel:
    """A deterministic synthetic k-mer model for tests and benchmarks.

    Real r9.4 models are not redistributable inside this repo; synthetic
    level means drawn in the realistic 60-130 pA range reproduce the
    statistical structure the pipeline cares about (distinct per-kmer
    levels, ~pA scale).
    """
    rng = np.random.default_rng(seed)
    level_mean = rng.uniform(60.0, 130.0, size=4**k).astype(np.float32)
    level_stdv = rng.uniform(1.0, 3.0, size=4**k).astype(np.float32)
    sd_mean = rng.uniform(1.0, 2.0, size=4**k).astype(np.float32)
    sd_stdv = rng.uniform(0.1, 0.5, size=4**k).astype(np.float32)
    return PoreModel(k, level_mean, level_stdv, sd_mean, sd_stdv)
