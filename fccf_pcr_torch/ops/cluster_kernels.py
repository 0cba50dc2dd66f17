"""The cluster stage's two sequential loops (C1, C2), each as a CUDA
kernel and its plain PyTorch version.

  - ``block_seeds`` (C1): the greedy seeds of one block of hypotheses,
    the JAX package's intra-block ``lax.while_loop``
    (``fccf_pcr_tpu/cluster/cluster.py:151-161``);
  - ``floor_walk`` (C2): the adaptive floor walk's emit mask, the JAX
    package's ``lax.scan`` (``fccf_pcr_tpu/cluster/cluster.py:241-262``).

CUDA tensors take the kernels of ``csrc/cluster.cu``, which run on the
card with no host sync; there is no fallback: a missing ``nvcc``, a
failed build or a refused launch raises. CPU tensors take the plain
versions (``block_seeds_plain``: the fixpoint iterated until no lane
changes, one host read a round; ``floor_walk_plain``: the walk in Python
over every lane, one transfer each way). Any other device raises.

The library is built with nvcc into ``fccf_pcr_torch/build/`` at first
use and bound with ctypes (``ops.cuda_build``). ``SEEDS`` and ``WALKS``
count the kernels' launches (``ops.graph.count_launch``: a launch
captured into a CUDA graph counts at each replay).
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from . import graph
from .cuda_build import CudaLibrary

# Launches of cluster_block_seeds (C1) and cluster_floor_walk (C2).
SEEDS = 0
WALKS = 0
_THIS = sys.modules[__name__]
# The largest block C1 takes (csrc/cluster.cu: kMaxBlock).
MAX_BLOCK = 512


def _bind(lib):
    for name in ("fccf_cluster_block_seeds", "fccf_cluster_floor_walk"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int


_LIBRARY = CudaLibrary("cluster.cu", _bind)


def build(force: bool = False):
    """Compile ``csrc/cluster.cu`` (if needed, or always with ``force``)
    and load it. Returns the ctypes library."""
    return _LIBRARY.load(force)


# ---------------------------------------------------------------- plain --


def block_seeds_plain(sub_lower, elig):
    """The seeds of one block by the JAX package's fixpoint: s <- elig AND
    NOT any(j: s[j] AND sub_lower[j, i]), from s = elig, until no lane
    changes (at most B rounds). sub_lower (..., B, B) and elig (..., B)
    bool; returns (..., B) bool."""
    s = elig
    for _ in range(elig.shape[-1]):
        new = elig & ~torch.any(sub_lower & s[..., :, None], dim=-2)
        changed = bool(torch.any(new != s))
        s = new
        if not changed:
            break
    return s


def _walk_lane(sizes, cn):
    """The floor walk of one lane over its sorted sizes (Python floats;
    integer counts, so float32 and Python floats compare alike): the
    emitted slots and the number of slots walked before it stopped."""
    emitted = []
    floor = max(sizes[0], 0.0)
    for i, size in enumerate(sizes):
        if not size > 0.0:
            continue
        if size >= floor:
            emitted.append(i)
            if len(emitted) > cn:  # break after push (:1208-1211)
                return emitted, i + 1
        elif len(emitted) < cn / 2.0:
            floor -= 1.0
            if floor < 2.0:
                return emitted, i + 1
        else:
            return emitted, i + 1
    return emitted, len(sizes)


def floor_walk_plain(s_size, cluster_num):
    """The adaptive floor walk over clusters sorted by size (:1126-1229)
    of every lane, on the host: s_size (..., W) (a slot is a seed cluster
    iff its size is > 0), cluster_num (...). Returns the (..., W) emit
    mask on s_size's device."""
    W = s_size.shape[-1]
    host = torch.cat([s_size, cluster_num[..., None].to(s_size.dtype)],
                     dim=-1).reshape(-1, W + 1).cpu().tolist()
    emit = np.zeros((len(host), W), bool)
    for lane, row in enumerate(host):
        emit[lane, _walk_lane(row[:W], row[W])[0]] = True
    return torch.from_numpy(emit).to(s_size.device).reshape(s_size.shape)


# -------------------------------------------------------------- kernels --


def _check(t, name, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: want {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _launch(entry, counter, inputs, out, L, n):
    """One launch of ``entry`` on the current stream, asynchronously."""
    lib = build()
    dev = out.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):  # the C entry launches on the current one
        rc = getattr(lib, entry)(*(t.data_ptr() for t in inputs),
                                 out.data_ptr(), L, n, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    graph.count_launch(_THIS, counter)


def _launch_block_seeds(sub_lower, elig):
    lead, B = tuple(elig.shape[:-1]), elig.shape[-1]
    if not 0 < B <= MAX_BLOCK:
        raise ValueError(f"block_seeds: block of {B}, want 1..{MAX_BLOCK}")
    _check(elig, "elig", torch.bool, lead + (B,), elig.device)
    _check(sub_lower, "sub_lower", torch.bool, lead + (B, B), elig.device)
    L = int(np.prod(lead, dtype=np.int64))
    out = torch.empty_like(elig)
    if L:
        _launch("fccf_cluster_block_seeds", "SEEDS",
                (sub_lower.contiguous(), elig.contiguous()), out, L, B)
    return out


def _launch_floor_walk(s_size, cluster_num):
    lead, W = tuple(s_size.shape[:-1]), s_size.shape[-1]
    _check(s_size, "s_size", torch.float32, lead + (W,), s_size.device)
    _check(cluster_num, "cluster_num", torch.float32, lead, s_size.device)
    L = int(np.prod(lead, dtype=np.int64))
    out = torch.empty(s_size.shape, dtype=torch.bool, device=s_size.device)
    if L and W:
        _launch("fccf_cluster_floor_walk", "WALKS",
                (s_size.contiguous(), cluster_num.contiguous()), out, L, W)
    else:
        out.zero_()
    return out


def block_seeds(sub_lower, elig):
    """The greedy seeds of one block of every lane: sub_lower (..., B, B)
    bool, strictly lower triangular ([j, i] only for j < i: seed j's ball
    holds i), elig (..., B) bool. Returns (..., B) bool s, the one
    solution of s[i] = elig[i] AND NOT any(j < i: s[j] AND
    sub_lower[j, i]). CPU tensors take the plain version, CUDA tensors
    the kernel C1; any other device raises."""
    if elig.device.type == "cpu":
        return block_seeds_plain(sub_lower, elig)
    if elig.device.type == "cuda":
        return _launch_block_seeds(sub_lower, elig)
    raise ValueError(f"block_seeds: unsupported device {elig.device}")


def floor_walk(s_size, cluster_num):
    """The floor walk's emit mask (..., W) bool over s_size (..., W)
    float32 sorted by size descending, with the budgets cluster_num (...)
    float32. CPU tensors take the plain version, CUDA tensors the kernel
    C2; any other device raises."""
    if s_size.device.type == "cpu":
        return floor_walk_plain(s_size, cluster_num)
    if s_size.device.type == "cuda":
        return _launch_floor_walk(s_size, cluster_num)
    raise ValueError(f"floor_walk: unsupported device {s_size.device}")
