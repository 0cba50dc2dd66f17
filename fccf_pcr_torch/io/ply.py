"""PLY point-cloud I/O.

Replaces ``pcl::io::loadPLYFile`` (FCCF.cpp:1655-1665, C20's I/O layer).
Supports ascii and binary_little_endian vertex clouds with arbitrary
property layouts; only x/y/z are extracted (the reference loads
``pcl::PointXYZ`` and discards everything else).

A native C++ fast path (csrc/ply_reader.cpp, loaded via ctypes) parses
large binary files at memcpy speed; this module transparently falls back
to the NumPy implementation when the shared library isn't built.
"""

from __future__ import annotations

import os

import numpy as np

from .native import native_read_ply

_DTYPES = {
    "char": ("i1", 1), "int8": ("i1", 1),
    "uchar": ("u1", 1), "uint8": ("u1", 1),
    "short": ("i2", 2), "int16": ("i2", 2),
    "ushort": ("u2", 2), "uint16": ("u2", 2),
    "int": ("i4", 4), "int32": ("i4", 4),
    "uint": ("u4", 4), "uint32": ("u4", 4),
    "float": ("f4", 4), "float32": ("f4", 4),
    "double": ("f8", 8), "float64": ("f8", 8),
}


def _parse_header(f):
    """Returns (fmt, elements, header_len). elements: list of
    (name, count, [(prop_name, dtype_str)...]) — list properties get
    dtype None and are only legal in non-vertex elements for us."""
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tok = line.decode("ascii", "replace").strip().split()
        if not tok or tok[0] == "comment" or tok[0] == "obj_info":
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if not elements:
                raise ValueError("PLY property before any element")
            if tok[1] == "list":
                elements[-1][2].append((tok[-1], ("list", tok[2], tok[3])))
            else:
                elements[-1][2].append((tok[-1], tok[1]))
        elif tok[0] == "end_header":
            break
    return fmt, elements, f.tell()


def read_ply(path: str, use_native: bool = True) -> np.ndarray:
    """Read x/y/z from a PLY file -> (N, 3) float32 array."""
    if use_native:
        pts = native_read_ply(path)
        if pts is not None:
            return pts
    with open(path, "rb") as f:
        fmt, elements, data_start = _parse_header(f)
        if fmt == "ascii":
            return _read_ascii(f, elements)
        if fmt == "binary_little_endian":
            return _read_binary(f, elements, "<")
        if fmt == "binary_big_endian":
            return _read_binary(f, elements, ">")
        raise ValueError(f"unsupported PLY format: {fmt}")


def _vertex_element(elements):
    for name, count, props in elements:
        if name == "vertex":
            return name, count, props
    raise ValueError("PLY file has no vertex element")


def _read_ascii(f, elements):
    name, count, props = _vertex_element(elements)
    if elements[0][0] != "vertex":
        raise ValueError("ascii PLY with vertex not first is unsupported")
    cols = [p for p, _ in props]
    ix, iy, iz = cols.index("x"), cols.index("y"), cols.index("z")
    data = np.loadtxt(f, dtype=np.float64, usecols=(ix, iy, iz), max_rows=count)
    return np.atleast_2d(data).astype(np.float32)


def _read_binary(f, elements, endian):
    out = None
    for name, count, props in elements:
        fields = []
        for pname, ptype in props:
            if isinstance(ptype, tuple):  # list property
                raise ValueError(
                    f"list property in element '{name}' before vertex data"
                )
            fields.append((pname, endian + _DTYPES[ptype][0]))
        dt = np.dtype(fields)
        if name == "vertex":
            raw = np.frombuffer(f.read(dt.itemsize * count), dtype=dt, count=count)
            out = np.stack(
                [raw["x"], raw["y"], raw["z"]], axis=-1
            ).astype(np.float32)
            return out  # vertex found; later elements not needed
        else:
            f.seek(dt.itemsize * count, os.SEEK_CUR)
    raise ValueError("PLY file has no vertex element")


def write_ply(path: str, pts: np.ndarray, binary: bool = True) -> None:
    """Write an (N, 3) cloud as a PLY vertex file."""
    pts = np.asarray(pts, np.float32)
    n = pts.shape[0]
    fmt = "binary_little_endian" if binary else "ascii"
    header = (
        f"ply\nformat {fmt} 1.0\ncomment fccf_pcr_tpu\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(pts.astype("<f4").tobytes())
        else:
            np.savetxt(f, pts, fmt="%.6f")
