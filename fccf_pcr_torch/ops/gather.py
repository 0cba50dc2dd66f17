"""Per-row gather ``out[p, i] = tbl[p, clamp(idx[p, i], 0, V - 1)]`` (P1).

Two versions of one function, ``gather_rows``:

  - the CUDA kernel ``csrc/gather.cu``, which replaces the JAX package's
    Pallas probe ``tools/probe_gather.py::kernel`` (a per-lane gather on
    int32 (1, 1024)); it is taken for CUDA tensors, and there is no
    fallback: a missing ``nvcc``, a failed build or a refused launch
    raises;
  - the plain PyTorch version ``gather_rows_plain`` (``torch.gather``
    with the same clamp), taken for CPU tensors.

It is label-prop's path-halving step ``label[label]`` between sweeps in
the per-sweep host loop (``ops.label_prop._label_propagate_host_loop``,
kept for A/B timing); the main path halves inside the propagation kernel
of ``csrc/label_prop.cu`` and launches no gather. ``LAUNCHES`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from . import graph
from .cuda_build import CudaLibrary

# Number of kernel launches made by gather_rows (ops.graph.count_launch).
LAUNCHES = 0
_THIS = sys.modules[__name__]


def _bind(lib):
    fn = lib.fccf_gather_rows
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int


_LIBRARY = CudaLibrary("gather.cu", _bind)


def build(force: bool = False):
    """Compile ``csrc/gather.cu`` (if needed, or always with ``force``)
    and load it. Returns the ctypes library."""
    return _LIBRARY.load(force)


def gather_rows_plain(tbl, idx):
    """The plain PyTorch version (any device), (..., V) int tensors."""
    V = tbl.shape[-1]
    return torch.gather(tbl, -1, torch.clamp(idx, 0, V - 1).long())


def _launch(tbl, idx):
    """Launch the kernel on the current stream, asynchronously."""
    if tbl.dtype != torch.int32 or idx.dtype != torch.int32:
        raise ValueError(f"gather kernel: want int32, got {tbl.dtype}/{idx.dtype}")
    if tbl.shape != idx.shape or tbl.dim() == 0 or tbl.numel() == 0:
        raise ValueError(f"gather kernel: shapes {tuple(tbl.shape)} / {tuple(idx.shape)}")
    if idx.device != tbl.device:
        raise ValueError(f"gather kernel: devices {tbl.device} / {idx.device}")
    tbl, idx = tbl.contiguous(), idx.contiguous()
    V = tbl.shape[-1]
    P = tbl.numel() // V
    out = torch.empty_like(idx)
    lib = build()
    stream = torch.cuda.current_stream(tbl.device).cuda_stream
    with torch.cuda.device(tbl.device):  # the C entry launches on it
        rc = lib.fccf_gather_rows(
            tbl.data_ptr(), idx.data_ptr(), out.data_ptr(), P, V, stream
        )
    if rc != 0:
        raise RuntimeError(f"gather kernel launch failed: CUDA error {rc}")
    graph.count_launch(_THIS, "LAUNCHES")
    return out


def gather_rows(tbl, idx):
    """out[..., i] = tbl[..., clamp(idx[..., i], 0, V - 1)] along the last
    dim, for tbl and idx of one shape (..., V). CPU tensors take the plain
    version, CUDA tensors the kernel (int32 only); any other device
    raises."""
    if tbl.device.type == "cpu":
        return gather_rows_plain(tbl, idx)
    if tbl.device.type == "cuda":
        return _launch(tbl, idx)
    raise ValueError(f"gather_rows: unsupported device {tbl.device}")
