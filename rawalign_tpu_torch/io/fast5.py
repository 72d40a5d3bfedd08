"""Copy of rawalign_tpu/io/fast5.py for the port.

FAST5 signal ingest (host side).

Replaces the reference's hdf5_tools C++ wrapper (src/rsig.cpp:43-230,
src/hdf5_tools.hpp) with h5py. Handles both single- and multi-read FAST5
layouts, reads the channel calibration (digitisation, range, offset),
converts raw DAC values to picoamperes ``(raw + offset) * range / dig``
and keeps only values in the open interval (30, 200) pA, exactly like the
reference (rsig.cpp:216-224). Also provides the recursive .fast5
directory discovery (find_fast5, rsig.cpp:152-184).

A simple .npz-based container ("sigbin") is provided as a portable
alternative for synthetic datasets and tests.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

try:
    import h5py

    HAVE_H5PY = True
except Exception:  # pragma: no cover
    HAVE_H5PY = False


def find_signal_files(
    path: str, exts=(".fast5", ".sigbin.npz", ".slow5")
) -> list[str]:
    """Recursive discovery of signal files (find_fast5, rsig.cpp:152-184)."""
    out: list[str] = []
    if not os.path.isdir(path):
        if any(path.endswith(e) for e in exts):
            out.append(path)
        return out
    for root, _dirs, files in os.walk(path):
        for f in sorted(files):
            if any(f.endswith(e) for e in exts):
                out.append(os.path.join(root, f))
    return sorted(out)


_VBZ_FILTER_ID = 32020  # ONT vbz_compression HDF5 filter


def _is_vbz(dset) -> bool:
    try:
        plist = dset.id.get_create_plist()
        return any(
            plist.get_filter(i)[0] == _VBZ_FILTER_ID
            for i in range(plist.get_nfilters())
        )
    except Exception:
        return False


def _read_vbz_chunks(dset) -> np.ndarray:
    """Decode a VBZ dataset via HDF5 direct-chunk reads + io/vbz.py —
    no native plugin needed."""
    from rawalign_tpu_torch.io import vbz

    n = int(dset.shape[0])
    out = np.empty(n, dtype=np.int16)
    chunk = dset.chunks[0] if dset.chunks else n
    did = dset.id
    # Position of the vbz filter in the dataset's filter pipeline — the
    # filter_mask from read_direct_chunk sets bit i when pipeline filter i
    # was SKIPPED for that chunk (H5Z semantics for optional filters).
    vbz_pos = None
    try:
        plist = did.get_create_plist()
        for i in range(plist.get_nfilters()):
            if plist.get_filter(i)[0] == _VBZ_FILTER_ID:
                vbz_pos = i
                break
    except Exception:
        pass
    for start in range(0, n, chunk):
        filt_mask, blob = did.read_direct_chunk((start,))
        m = min(chunk, n - start)
        if vbz_pos is not None and (filt_mask >> vbz_pos) & 1:
            # vbz was skipped at write time: the chunk stores raw int16.
            vals = np.frombuffer(bytes(blob), dtype="<i2")
        else:
            vals = vbz.decompress(bytes(blob), n_expected=m)
        if vals.size < m:
            raise ValueError(
                f"vbz chunk at {start} decoded {vals.size} < {m} values"
            )
        out[start : start + m] = vals[:m]
    return out


def _read_signal_dataset(dset) -> np.ndarray:
    """Read a Signal dataset, decoding VBZ without the native plugin.

    ONT FAST5s are commonly vbz-compressed (HDF5 filter 32020); without
    the plugin h5py fails with an opaque 'required filter is not
    registered' OSError. The reference requires the plugin at runtime
    (ensure_hdf5_vbz_plugin.sh + HDF5_PLUGIN_PATH); here the codec is
    reimplemented in NumPy+zstandard (io/vbz.py) and applied through
    HDF5 direct-chunk reads, so VBZ files ingest with no plugin."""
    try:
        return np.asarray(dset[:])
    except OSError as e:
        if _is_vbz(dset) or "filter" in str(e).lower():
            try:
                return _read_vbz_chunks(dset)
            except Exception as e2:
                raise RuntimeError(
                    f"{dset.file.filename}: signal is VBZ-compressed "
                    f"(HDF5 filter {_VBZ_FILTER_ID}); the built-in vbz "
                    f"decoder failed ({e2}). Install ont-vbz-hdf5-plugin "
                    "and set HDF5_PLUGIN_PATH (see the reference's "
                    "ensure_hdf5_vbz_plugin.sh), or convert with "
                    "'slow5tools f2s | slow5tools view' to ASCII .slow5."
                ) from e
        raise


def _convert(raw: np.ndarray, dig: float, rng: float, off: float) -> np.ndarray:
    scale = rng / dig
    sig = (raw.astype(np.float32) + np.float32(off)) * np.float32(scale)
    keep = (sig > 30) & (sig < 200)
    return sig[keep]


def _attr_float(attrs, key: str) -> float:
    """Tolerant attribute-to-float: real ONT files store channel_id
    attrs as float64, float32, integers, or even strings depending on
    the writer version.  The reference stringifies every attribute and
    atof()s it (hdf5_tools get_attr_map + rsig.cpp:201-210), so it
    accepts all of these; match that tolerance."""
    v = attrs[key]
    if isinstance(v, bytes):
        return float(v.decode())
    if isinstance(v, str):
        return float(v)
    a = np.asarray(v).ravel()
    if a.size != 1:
        raise ValueError(f"attribute {key!r} is not scalar: shape {a.shape}")
    x = a[0]
    if isinstance(x, bytes):
        return float(x.decode())
    return float(x)


def _attr_str(attrs, key: str) -> str:
    v = attrs[key]
    a = np.asarray(v).ravel()
    if a.size == 1:
        v = a[0]
    return v.decode() if isinstance(v, bytes) else str(v)


def read_fast5(path: str) -> Iterator[tuple[str, np.ndarray]]:
    """Yield (read_id, pA_signal) for every read in a FAST5 file."""
    if not HAVE_H5PY:  # pragma: no cover
        raise RuntimeError("h5py unavailable; cannot read FAST5")
    with h5py.File(path, "r") as f:
        if "Raw" in f:  # single-read layout (rsig.cpp:73-83)
            ch = f["/UniqueGlobalKey/channel_id"].attrs
            dig = _attr_float(ch, "digitisation")
            rng = _attr_float(ch, "range")
            off = _attr_float(ch, "offset")
            for read_name in f["/Raw/Reads"]:
                grp = f["/Raw/Reads"][read_name]
                rid = _attr_str(grp.attrs, "read_id")
                raw = _read_signal_dataset(grp["Signal"])
                yield rid, _convert(raw, dig, rng, off)
        else:  # multi-read layout (rsig.cpp:84-91); like the
            # reference, every top-level group is treated as a read
            for read_name in f:
                grp = f[read_name]
                raw_grp = grp["Raw"]
                ch = grp["channel_id"].attrs
                dig = _attr_float(ch, "digitisation")
                rng = _attr_float(ch, "range")
                off = _attr_float(ch, "offset")
                rid = _attr_str(raw_grp.attrs, "read_id")
                raw = _read_signal_dataset(raw_grp["Signal"])
                yield rid, _convert(raw, dig, rng, off)


def write_fast5(
    path: str, reads: list[tuple[str, np.ndarray]],
    *, dig: float = 8192.0, rng: float = 1400.0, off: float = 10.0,
    compression: str = "none", sample_rate: float = 4000.0,
) -> None:
    """Write a multi-read FAST5 with pA signals quantized to raw DAC.

    ``compression``: 'none', 'gzip' (HDF5 builtin, what pre-vbz ONT
    files use), or 'vbz' — a genuinely vbz-filtered dataset (HDF5
    filter 32020, written via direct-chunk I/O with the io/vbz.py
    codec; readable here without the native plugin, and tagged so a
    system WITH the official plugin resolves the same filter id).

    The group schema mirrors real multi-read ONT files
    (read_<id>/Raw/Signal + channel_id/tracking_id attrs incl.
    sampling_rate), per the layouts hdf5_tools.hpp walks
    (rsig.cpp:84-96,186-230).
    """
    if not HAVE_H5PY:  # pragma: no cover
        raise RuntimeError("h5py unavailable; cannot write FAST5")
    scale = rng / dig
    with h5py.File(path, "w") as f:
        f.attrs["file_type"] = np.bytes_("multi-read")
        f.attrs["file_version"] = np.bytes_("2.2")
        for i, (rid, sig) in enumerate(reads):
            grp = f.create_group(f"read_{rid}")
            grp.attrs["run_id"] = np.bytes_("synthetic_run_0")
            raw_grp = grp.create_group("Raw")
            raw = np.round(np.asarray(sig, np.float64) / scale - off).astype(
                np.int16
            )
            if compression == "vbz":
                _write_vbz_signal(raw_grp, raw)
            elif compression == "gzip":
                raw_grp.create_dataset(
                    "Signal", data=raw, compression="gzip", chunks=True
                )
            else:
                raw_grp.create_dataset("Signal", data=raw)
            raw_grp.attrs["read_id"] = np.bytes_(rid)
            raw_grp.attrs["read_number"] = np.int32(i)
            raw_grp.attrs["start_time"] = np.uint64(i * 1000)
            raw_grp.attrs["duration"] = np.uint32(raw.size)
            ch = grp.create_group("channel_id")
            ch.attrs["digitisation"] = np.float64(dig)
            ch.attrs["range"] = np.float64(rng)
            ch.attrs["offset"] = np.float64(off)
            ch.attrs["sampling_rate"] = np.float64(sample_rate)
            ch.attrs["channel_number"] = np.bytes_(str(i + 1))
            tr = grp.create_group("tracking_id")
            tr.attrs["device_type"] = np.bytes_("minion")
            tr.attrs["exp_start_time"] = np.bytes_("2024-01-01T00:00:00Z")
            tr.attrs["flow_cell_id"] = np.bytes_("FAK00000")


def _write_vbz_signal(raw_grp, raw: np.ndarray) -> None:
    """Create a Signal dataset carrying the vbz filter (32020) and fill
    it through direct-chunk writes with our codec (no plugin needed)."""
    from rawalign_tpu_torch.io import vbz

    n = int(raw.size)
    chunk = max(min(n, 65536), 1)
    space = h5py.h5s.create_simple((n,))
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk((chunk,))
    # cd_values mirror the plugin's (version, integer size, zigzag,
    # zstd level); OPTIONAL flag so creation needs no registered filter
    dcpl.set_filter(
        _VBZ_FILTER_ID, h5py.h5z.FLAG_OPTIONAL, (0, 2, 1, 1)
    )
    did = h5py.h5d.create(
        raw_grp.id, b"Signal", h5py.h5t.STD_I16LE, space, dcpl
    )
    for start in range(0, n, chunk):
        blob = vbz.compress(raw[start : start + chunk])
        did.write_direct_chunk((start,), blob, filter_mask=0)
    did.close()


def write_sigbin(path: str, reads: list[tuple[str, np.ndarray]]) -> None:
    """Portable signal container: float32 pA signals keyed by read id."""
    np.savez_compressed(
        path,
        names=np.array([r[0] for r in reads]),
        **{f"sig_{i}": np.asarray(r[1], np.float32) for i, r in enumerate(reads)},
    )


def read_sigbin(path: str) -> Iterator[tuple[str, np.ndarray]]:
    z = np.load(path, allow_pickle=False)
    names = z["names"]
    for i, name in enumerate(names):
        sig = z[f"sig_{i}"].astype(np.float32)
        keep = (sig > 30) & (sig < 200)
        yield str(name), sig[keep]


def read_signals(paths: list[str]) -> Iterator[tuple[str, np.ndarray]]:
    """Stream reads from a mixed list of signal files."""
    for p in paths:
        if p.endswith(".fast5"):
            yield from read_fast5(p)
        elif p.endswith(".npz"):
            yield from read_sigbin(p)
        elif p.endswith(".slow5"):
            from rawalign_tpu_torch.io.slow5 import read_slow5

            yield from read_slow5(p)
        else:
            raise ValueError(f"unknown signal file type: {p}")
