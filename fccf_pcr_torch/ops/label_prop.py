"""Connected-component min labels of the voxel affinity graph (K1).

Two versions of one function, ``label_propagate``:

  - the CUDA kernel ``csrc/label_prop.cu`` (one launch = one sweep for a
    batch of pairs), which replaces the JAX package's Pallas kernel
    ``fccf_pcr_tpu/ops/pallas/label_prop.py::_sweep_kernel``; it is taken
    for CUDA tensors, and there is no fallback: a missing ``nvcc``, a
    failed build or a refused launch raises;
  - the plain PyTorch version ``label_propagate_plain`` (the JAX package's
    XLA path: ``_pairwise_affinity`` + ``_label_propagate`` +
    ``pointer_jump``, ``features/faces.py:58-151``), taken for CPU tensors.

Both reach the same integer fixpoint: labels[i] is the minimum valid slot
index of i's component, and invalid slots hold ``_BIG``.

The kernel is built with nvcc into ``fccf_pcr_torch/build/`` at first use
and bound with ctypes (``ops.cuda_build``). ``LAUNCHES`` counts kernel
launches. The path halving between the kernel's sweeps is the gather
kernel of ``ops.gather`` (P1); the plain version halves with the plain
gather.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary
from .gather import gather_rows, gather_rows_plain
from .geometry import cos_deg, normalize

_BIG = 2**30

# Path-halving rounds between kernel sweeps (the JAX wrapper's default).
_JUMP_ROUNDS = 1

# Number of kernel launches (sweeps) made by label_propagate.
LAUNCHES = 0


def _bind(lib):
    fn = lib.fccf_label_prop_sweep
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int


_LIBRARY = CudaLibrary("label_prop.cu", _bind)


def build(force: bool = False):
    """Compile ``csrc/label_prop.cu`` (if needed, or always with
    ``force``) and load it. Returns the ctypes library."""
    return _LIBRARY.load(force)


# ---------------------------------------------------------------- plain --


def pairwise_affinity(normal, centroid, valid, angle_thresh_deg, l, k):
    """(..., V, V) boolean affinity from compare_normal & compare_plane,
    built with (V, 3) x (3, V) matmuls (``faces.py:58-82``)."""
    nh = normalize(normal)
    cosmat = nh @ nh.mT
    ok_normal = cosmat >= cos_deg(angle_thresh_deg)

    c2 = torch.sum(centroid * centroid, dim=-1)
    d2 = c2[..., :, None] + c2[..., None, :] - 2.0 * (centroid @ centroid.mT)
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    ndotc = torch.sum(normal * centroid, dim=-1)
    m1 = ndotc[..., :, None] - normal @ centroid.mT
    m2 = centroid @ normal.mT - ndotc[..., None, :]
    t = l / (k * dist + 1.0)
    ok_plane = (torch.abs(m1) < t * dist) & (torch.abs(m2) < t * dist)
    ok_plane = torch.where(dist > 1e-9, ok_plane, True)

    vv = valid[..., :, None] & valid[..., None, :]
    return vv & ok_normal & ok_plane


def pointer_jump(labels, V, rounds: int = 8, gather=gather_rows):
    """Path halving, batched over leading dims:
    labels <- min(labels, labels[labels]) ``rounds`` times, reads clamped
    to the row of V slots. ``gather`` is ``gather_rows`` (the kernel for
    CUDA tensors) or its plain version."""
    assert labels.shape[-1] == V
    for _ in range(rounds):
        labels = torch.minimum(labels, gather(labels, labels))
    return labels


def _label_propagate(affinity, valid, max_iters):
    """Min-label propagation (Jacobi sweeps over the affinity matrix, each
    followed by 8 path-halving rounds) until a sweep changes nothing, or
    ``max_iters`` sweeps. Batched over leading dims; a lane at its
    fixpoint is unchanged by further sweeps, so the batch is exact."""
    V = affinity.shape[-1]
    big = torch.full_like(valid, _BIG, dtype=torch.int32)
    ar = torch.arange(V, dtype=torch.int32, device=valid.device)
    labels = torch.where(valid, ar.expand(valid.shape), big)
    for _ in range(max_iters):
        neigh = torch.amin(
            torch.where(affinity, labels[..., None, :], _BIG), dim=-1
        )
        new = torch.minimum(labels, neigh)
        new = torch.where(valid, pointer_jump(new, V, gather=gather_rows_plain),
                          big)
        changed = bool(torch.any(new != labels))
        labels = new
        if not changed:
            break
    return labels


def label_propagate_plain(normal, centroid, valid, angle_thresh_deg, l, k,
                          max_iters: int = 32):
    """The plain PyTorch version (any device): (..., V) int32 labels."""
    aff = pairwise_affinity(normal, centroid, valid, angle_thresh_deg, l, k)
    return _label_propagate(aff, valid, max_iters)


# --------------------------------------------------------------- kernel --


def _pack_stats(normal, centroid, valid):
    """(P, 12, V) field-major float32 stats consumed by the kernel."""
    nh = normalize(normal)
    rdotc = torch.sum(normal * centroid, dim=-1)
    c2 = torch.sum(centroid * centroid, dim=-1)
    fields = [
        nh[..., 0], nh[..., 1], nh[..., 2],
        centroid[..., 0], centroid[..., 1], centroid[..., 2],
        rdotc, c2,
        normal[..., 0], normal[..., 1], normal[..., 2],
        valid.to(normal.dtype),
    ]
    return torch.stack(fields, dim=1).contiguous()


def _check(t, name, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: want {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch_sweep(stats, bound, labels, changed, cos_gate, l, k):
    """One sweep for every pair: launches the kernel on the current
    stream, asynchronously. Raises if the launch is refused."""
    global LAUNCHES
    P, V = labels.shape
    dev = labels.device
    if dev.type != "cuda":
        raise ValueError(f"the label-prop kernel needs CUDA tensors, got {dev}")
    _check(stats, "stats", torch.float32, (P, 12, V), dev)
    _check(bound, "bound", torch.int32, (P,), dev)
    _check(labels, "labels", torch.int32, (P, V), dev)
    _check(changed, "changed", torch.int32, (P,), dev)
    lib = build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.fccf_label_prop_sweep(
        stats.data_ptr(), bound.data_ptr(), labels.data_ptr(),
        changed.data_ptr(), P, V, cos_gate, float(l), float(k), stream,
    )
    LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"label-prop kernel launch failed: CUDA error {rc}")


def _label_propagate_kernel(normal, centroid, valid, angle_thresh_deg, l, k,
                            bound, max_iters):
    P, V, _ = normal.shape
    dev = normal.device
    stats = _pack_stats(normal.to(torch.float32), centroid.to(torch.float32),
                        valid)
    if bound is None:
        bound_t = torch.full((P,), V, dtype=torch.int32, device=dev)
    else:
        bound_t = torch.as_tensor(bound, device=dev).to(torch.int32)
        bound_t = bound_t.reshape(-1).expand(P).contiguous()
    big = torch.full((P, V), _BIG, dtype=torch.int32, device=dev)
    ar = torch.arange(V, dtype=torch.int32, device=dev).expand(P, V)
    labels = torch.where(valid, ar, big).contiguous()
    changed = torch.zeros((P,), dtype=torch.int32, device=dev)
    cos_gate = cos_deg(angle_thresh_deg)
    for _ in range(max_iters):
        changed.zero_()
        _launch_sweep(stats, bound_t, labels, changed, cos_gate, l, k)
        # Path halving between sweeps (the gather kernel); invalid slots
        # stay at _BIG.
        labels = torch.where(
            valid, pointer_jump(labels, V, _JUMP_ROUNDS), big
        ).contiguous()
        # Reading the flag is one host sync per sweep; removing it (a
        # device-side loop or a CUDA graph) is later work.
        if not bool(torch.any(changed)):
            break
    return labels


def label_propagate(normal, centroid, valid, angle_thresh_deg, l, k,
                    bound=None, max_iters: int = 32):
    """Component-min labels of the affinity graph.

    normal, centroid: (V, 3) or (P, V, 3) float32; valid: (V,) / (P, V)
    bool. ``bound`` (int or (P,) tensor): every valid slot index is below
    it; the kernel prunes its sweeps to that prefix, the plain version
    ignores it. ``max_iters`` caps the sweeps. Returns int32 labels of
    valid's shape. CPU tensors take the plain version, CUDA tensors the
    kernel; any other device raises.
    """
    squeeze = normal.dim() == 2
    if squeeze:
        normal, centroid, valid = normal[None], centroid[None], valid[None]
    if normal.device.type == "cpu":
        labels = label_propagate_plain(
            normal, centroid, valid, angle_thresh_deg, l, k, max_iters
        )
    elif normal.device.type == "cuda":
        labels = _label_propagate_kernel(
            normal, centroid, valid, angle_thresh_deg, l, k, bound, max_iters
        )
    else:
        raise ValueError(f"label_propagate: unsupported device {normal.device}")
    return labels[0] if squeeze else labels
