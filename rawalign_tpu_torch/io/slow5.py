"""Copy of rawalign_tpu/io/slow5.py for the port.

SLOW5 (ASCII) signal ingest.

The reference links slow5lib (src/Makefile:55) but ships the code path
disabled (src/rsig.h:6, rsig.cpp:156). This framework supports the ASCII
``.slow5`` format natively: it is a TSV with ``@`` attribute lines, two
``#`` header lines (type row, column-name row) and one row per read with
the calibration fields and the comma-separated raw signal. Conversion to
picoamperes and the (30, 200) pA clip match the FAST5 path
(rsig.cpp:216-224).

Binary ``.blow5`` (compressed) is intentionally out of scope — convert
with ``slow5tools view`` upstream.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from rawalign_tpu_torch.io.fast5 import _convert

_REQUIRED = (
    "read_id",
    "digitisation",
    "offset",
    "range",
    "len_raw_signal",
    "raw_signal",
)


def read_slow5(path: str) -> Iterator[tuple[str, np.ndarray]]:
    """Yield (read_id, pA_signal) for every record in an ASCII .slow5."""
    cols: dict[str, int] = {}
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("@"):
                continue
            if line.startswith("#"):
                fields = line[1:].split("\t")
                # the column-name row is the one naming read_id; the
                # other # row is the type row (char*, double, ...)
                if "read_id" in fields:
                    cols = {name: i for i, name in enumerate(fields)}
                    missing = [c for c in _REQUIRED if c not in cols]
                    if missing:
                        raise ValueError(
                            f"{path}: missing SLOW5 columns {missing}"
                        )
                continue
            if not cols:
                raise ValueError(
                    f"{path}: data row before #read_id header row"
                )
            parts = line.split("\t")
            rid = parts[cols["read_id"]]
            dig = float(parts[cols["digitisation"]])
            off = float(parts[cols["offset"]])
            rng = float(parts[cols["range"]])
            n = int(parts[cols["len_raw_signal"]])
            field = parts[cols["raw_signal"]]
            if n == 0 and not field:
                raw = np.zeros(0, dtype=np.int16)
            else:
                raw = np.array(field.split(","), dtype=np.int16)
            if raw.size != n:
                raise ValueError(
                    f"{path}: read {rid}: len_raw_signal={n} but "
                    f"{raw.size} samples"
                )
            yield rid, _convert(raw, dig, rng, off)


def write_slow5(
    path: str,
    reads: list[tuple[str, np.ndarray]],
    *,
    dig: float = 8192.0,
    rng: float = 1400.0,
    off: float = 10.0,
    sample_rate: float = 4000.0,
) -> None:
    """Write pA signals as an ASCII .slow5 (testing/interchange)."""
    scale = rng / dig
    with open(path, "w") as f:
        f.write("#slow5_version\t2.0\n")
        f.write("@num_read_groups\t1\n")
        f.write(
            "#char*\tuint32_t\tdouble\tdouble\tdouble\tdouble\t"
            "uint64_t\tint16_t*\n"
        )
        f.write(
            "#read_id\tread_group\tdigitisation\toffset\trange\t"
            "sampling_rate\tlen_raw_signal\traw_signal\n"
        )
        for rid, sig in reads:
            raw = np.round(
                np.asarray(sig, np.float64) / scale - off
            ).astype(np.int16)
            f.write(
                f"{rid}\t0\t{dig}\t{off}\t{rng}\t{sample_rate}\t"
                f"{raw.size}\t{','.join(map(str, raw.tolist()))}\n"
            )
