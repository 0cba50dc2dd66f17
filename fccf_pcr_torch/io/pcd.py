"""PCD point-cloud I/O.

The reference links the PCD loader (``#include <pcl/io/pcd_io.h>``,
FCCF.cpp:7) although its CLI path only ever reads PLY; a user of
``pcl::io::loadPCDFile``/``savePCDFile`` switching to this framework still
finds the format here. Supports the PCD v0.7 header with ``ascii``,
``binary``, and ``binary_compressed`` data sections; only x/y/z are
extracted (the reference loads ``pcl::PointXYZ`` and discards the rest).

binary_compressed uses PCL's LZF scheme: a compressed blob of the cloud
laid out field-major (all x, then all y, ...), preceded by two uint32
(compressed size, uncompressed size). The LZF decompressor below is the
standard liblzf algorithm in NumPy-friendly Python (decompression is
O(tokens), fine for host-side IO).
"""

from __future__ import annotations

import numpy as np

_DTYPES = {
    ("F", 4): "f4", ("F", 8): "f8",
    ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4", ("I", 8): "i8",
    ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4", ("U", 8): "u8",
}


def _parse_header(f):
    meta = {}
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PCD header")
        s = line.decode("ascii", "replace").strip()
        if not s or s.startswith("#"):
            continue
        key, *vals = s.split()
        meta[key.upper()] = vals
        if key.upper() == "DATA":
            break
    # COUNT is optional per the PCD spec (defaults to 1 per field; the
    # native reader and read_pcd's meta.get fallback both assume that)
    for req in ("FIELDS", "SIZE", "TYPE", "POINTS", "DATA"):
        if req not in meta:
            raise ValueError(f"PCD header missing {req}")
    return meta, f.tell()


def _lzf_decompress(src: bytes, expected: int) -> bytes:
    """liblzf decompression (PCL binary_compressed blobs).

    Every read is bounds-checked: a corrupt stream raises instead of
    silently producing garbage (a negative back-reference would wrap via
    Python negative indexing, and a short literal-run slice would SHRINK
    the bytearray, shifting every later field offset)."""
    out = bytearray(expected)
    i, o, n = 0, 0, len(src)
    while i < n:
        ctrl = src[i]
        i += 1
        if ctrl < 32:  # literal run of ctrl+1 bytes
            run = ctrl + 1
            if i + run > n or o + run > expected:
                raise ValueError("LZF: truncated literal run")
            out[o : o + run] = src[i : i + run]
            i += run
            o += run
        else:  # back reference
            length = ctrl >> 5
            if length == 7:
                if i >= n:
                    raise ValueError("LZF: truncated length byte")
                length += src[i]
                i += 1
            length += 2
            if i >= n:
                raise ValueError("LZF: truncated offset byte")
            ref = o - ((ctrl & 0x1F) << 8) - src[i] - 1
            i += 1
            if ref < 0 or o + length > expected:
                raise ValueError("LZF: back reference out of range")
            if ref + length <= o:  # disjoint: one slice copy
                out[o : o + length] = out[ref : ref + length]
            else:  # overlapping copy must go byte-forward
                for k in range(length):
                    out[o + k] = out[ref + k]
            o += length
    if o != expected:
        raise ValueError(f"LZF: expected {expected} bytes, got {o}")
    return bytes(out)


def read_pcd(path: str, use_native: bool = True) -> np.ndarray:
    """Read x/y/z from a PCD file -> (N, 3) float32 array."""
    if use_native:
        from .native import native_read_pcd

        pts = native_read_pcd(path)
        if pts is not None:
            return pts
    with open(path, "rb") as f:
        meta, data_start = _parse_header(f)
        fields = [s.lower() for s in meta["FIELDS"]]
        sizes = [int(s) for s in meta["SIZE"]]
        types = meta["TYPE"]
        counts = [int(s) for s in meta.get("COUNT", ["1"] * len(fields))]
        n = int(meta["POINTS"][0])
        mode = meta["DATA"][0].lower()

        for ax in ("x", "y", "z"):
            if ax not in fields:
                raise ValueError(f"PCD file has no '{ax}' field")
            if counts[fields.index(ax)] != 1:
                # the native reader returns rc=3 for this layout; fail
                # with the same unsupported-layout contract, not KeyError
                raise ValueError(
                    f"unsupported PCD layout: field '{ax}' has COUNT != 1"
                )

        if mode == "ascii":
            cols, col = {}, 0
            for name, c in zip(fields, counts):
                cols[name] = col
                col += c
            data = np.loadtxt(
                f, dtype=np.float64, max_rows=n,
                usecols=(cols["x"], cols["y"], cols["z"]),
            )
            return np.atleast_2d(data).astype(np.float32)

        np_fields = []
        for fi, (name, size, typ, cnt) in enumerate(
            zip(fields, sizes, types, counts)
        ):
            base = _DTYPES.get((typ, size))
            if base is None:
                raise ValueError(f"unsupported PCD field type {typ}{size}")
            for k in range(cnt):
                # PCL pads with multiple fields all named "_"; np.dtype
                # rejects duplicate names, so non-xyz names get a unique
                # suffix (only x/y/z are read back).
                fname = f"{name}{k if cnt > 1 else ''}"
                if fname not in ("x", "y", "z"):
                    fname = f"f{fi}_{fname}"
                np_fields.append((fname, "<" + base))
        dt = np.dtype(np_fields)

        if mode == "binary":
            raw = np.frombuffer(f.read(dt.itemsize * n), dtype=dt, count=n)
            return np.stack(
                [raw["x"], raw["y"], raw["z"]], axis=-1
            ).astype(np.float32)

        if mode == "binary_compressed":
            comp_size, uncomp_size = np.frombuffer(f.read(8), "<u4")
            blob = _lzf_decompress(f.read(int(comp_size)), int(uncomp_size))
            # field-major layout: each field's n values contiguously
            out, off = {}, 0
            for name, size, typ, cnt in zip(fields, sizes, types, counts):
                width = size * cnt * n
                if name in ("x", "y", "z") and cnt == 1:
                    out[name] = np.frombuffer(
                        blob, "<" + _DTYPES[(typ, size)], count=n, offset=off
                    )
                off += width
            return np.stack(
                [out["x"], out["y"], out["z"]], axis=-1
            ).astype(np.float32)

        raise ValueError(f"unsupported PCD data mode: {mode}")


def write_pcd(path: str, pts: np.ndarray, binary: bool = True) -> None:
    """Write an (N, 3) cloud as a PCD v0.7 x/y/z file."""
    pts = np.asarray(pts, np.float32)
    n = pts.shape[0]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
        f"COUNT 1 1 1\nWIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\nDATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(pts.astype("<f4").tobytes())
        else:
            np.savetxt(f, pts, fmt="%.6f")


def read_cloud(path: str) -> np.ndarray:
    """Read x/y/z from a PLY or PCD file by extension -> (N, 3) float32."""
    if path.lower().endswith(".pcd"):
        return read_pcd(path)
    from . import ply

    return ply.read_ply(path)
