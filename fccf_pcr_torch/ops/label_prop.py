"""Connected-component min labels of the voxel affinity graph (K1, P1).

Two versions of one function, ``label_propagate``:

  - the CUDA kernel ``csrc/label_prop.cu``, taken for CUDA tensors: one
    cooperative launch runs the whole propagation on the card (sweeps,
    the path halving between them and the convergence test), with no
    host sync. Its sweep is the port of the JAX package's Pallas kernel
    ``fccf_pcr_tpu/ops/pallas/label_prop.py::_sweep_kernel`` (K1), its
    halving the redesign of ``tools/probe_gather.py::kernel`` (P1). There
    is no fallback: a missing ``nvcc``, a failed build, a card without
    cooperative launch or a refused launch raises;
  - the plain PyTorch version ``label_propagate_plain`` (the JAX package's
    XLA path: ``_pairwise_affinity`` + ``_label_propagate`` +
    ``pointer_jump``, ``features/faces.py:58-151``), taken for CPU tensors.

Both reach the same integer fixpoint: labels[i] is the minimum valid slot
index of i's component, and invalid slots hold ``_BIG``.

The library also exports one sweep a launch (``_launch_sweep``), which
``_label_propagate_host_loop`` drives from the host with the gather
kernel of ``ops.gather`` between sweeps and one host sync a sweep: the
design before the single launch, kept for A/B timing
(``tools/torch_k1_ab.py``, ``chip_smoke.py``) and never taken by
``label_propagate``.

The kernels are built with nvcc into ``fccf_pcr_torch/build/`` at first
use and bound with ctypes (``ops.cuda_build``). ``PROPAGATIONS`` counts
launches of the propagation kernel, ``LAUNCHES`` launches of the
one-sweep kernel; ``sweep_counter(device)`` holds the sweeps the
propagation kernel has run on that device. The counts are kept under a
lock, so that host threads launching on several cards lose no launch.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from .cuda_build import CudaLibrary
from .gather import gather_rows, gather_rows_plain
from .geometry import cos_deg, normalize

_BIG = 2**30

# Path-halving rounds between kernel sweeps (the JAX wrapper's default).
_JUMP_ROUNDS = 1

# Launches of the one-sweep kernel (_launch_sweep).
LAUNCHES = 0
# Launches of the propagation kernel (_launch_propagate).
PROPAGATIONS = 0
# device -> (1,) int64 count of the sweeps the propagation kernel ran.
_SWEEPS = {}
# Guards the counts and _SWEEPS: a split over devices launches from one
# host thread a device (parallel/mesh.py).
_COUNT_LOCK = threading.Lock()


def _bind(lib):
    fn = lib.fccf_label_prop_sweep
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    fn = lib.fccf_label_prop_propagate
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int


_LIBRARY = CudaLibrary("label_prop.cu", _bind)


def build(force: bool = False):
    """Compile ``csrc/label_prop.cu`` (if needed, or always with
    ``force``) and load it. Returns the ctypes library."""
    return _LIBRARY.load(force)


# The kernel's grid: (row tiles, j slices, P) tiles of BI rows (one thread
# a row; BI is fixed in csrc/label_prop.cu) by BJ columns, the widest
# slices that still give 32 blocks per SM: several waves of short blocks
# balance the SMs, as the work of a tile depends on its labels. On an H100
# (132 SMs): V = 9216 -> 144 x 36 tiles of 64 x 256; V = 1536 -> 24 x 48
# tiles of 64 x 32 (the narrowest).
BI = 64


def sweep_grid(V: int, sms: int):
    """(BJ, row tiles, j slices) of the kernel's grid over [0, V)^2 on a
    card of ``sms`` multiprocessors."""
    rows = -(-V // BI)
    BJ = 512
    while BJ > 32 and rows * -(-V // BJ) < 32 * sms:
        BJ //= 2
    return BJ, rows, -(-V // BJ)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    BJ, _, _ = sweep_grid(V, _sm_count(dev))
    with torch.cuda.device(dev):  # the C entry launches on the current one
        rc = lib.fccf_label_prop_sweep(
            stats.data_ptr(), bound.data_ptr(), labels.data_ptr(),
            changed.data_ptr(), P, V, BJ, cos_gate, float(l), float(k),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"label-prop kernel launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        LAUNCHES += 1


def sweep_counter(device) -> torch.Tensor:
    """(1,) int64 on ``device``: the sweeps run there by the propagation
    kernel since the counter was made or last zeroed. The kernel adds to
    it on the card; read it after a synchronize."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _COUNT_LOCK:
        if device not in _SWEEPS:
            _SWEEPS[device] = torch.zeros((1,), dtype=torch.int64,
                                          device=device)
        return _SWEEPS[device]


def _launch_propagate(stats, bound, labels, flags, sweeps, cos_gate, l, k,
                      max_iters, jump_rounds=_JUMP_ROUNDS):
    """A whole propagation for every pair, in place on ``labels``: one
    cooperative launch on the current stream, asynchronously, with no
    host sync. ``flags`` is (max_iters, P + 1) int32 zeros (each sweep's
    per-pair flags and tile counter); the number of sweeps run is added
    to ``sweeps`` ((1,) int64). Raises if the card has no cooperative
    launch or the launch is refused."""
    global PROPAGATIONS
    P, V = labels.shape
    dev = labels.device
    if dev.type != "cuda":
        raise ValueError(f"the label-prop kernel needs CUDA tensors, got {dev}")
    _check(stats, "stats", torch.float32, (P, 12, V), dev)
    _check(bound, "bound", torch.int32, (P,), dev)
    _check(labels, "labels", torch.int32, (P, V), dev)
    _check(flags, "flags", torch.int32, (max_iters, P + 1), dev)
    _check(sweeps, "sweeps", torch.int64, (1,), dev)
    if jump_rounds < 0:
        raise ValueError(f"jump_rounds must be >= 0, got {jump_rounds}")
    lib = build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    BJ, _, _ = sweep_grid(V, _sm_count(dev))
    with torch.cuda.device(dev):  # the C entry sizes and launches on it
        rc = lib.fccf_label_prop_propagate(
            stats.data_ptr(), bound.data_ptr(), labels.data_ptr(),
            flags.data_ptr(), sweeps.data_ptr(), P, V, BJ, cos_gate,
            float(l), float(k), max_iters, jump_rounds, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"label-prop propagation kernel launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        PROPAGATIONS += 1


def _kernel_inputs(normal, centroid, valid, bound):
    """(stats, (P,) int32 bound, initial labels) on normal's device."""
    P, V, _ = normal.shape
    dev = normal.device
    stats = _pack_stats(normal.to(torch.float32), centroid.to(torch.float32),
                        valid)
    if bound is None:
        bound = V
    if isinstance(bound, int):
        bound_t = torch.full((P,), bound, dtype=torch.int32, device=dev)
    else:
        bound_t = torch.as_tensor(bound, device=dev).to(torch.int32)
        bound_t = bound_t.reshape(-1).expand(P).contiguous()
    ar = torch.arange(V, dtype=torch.int32, device=dev).expand(P, V)
    labels = torch.where(valid, ar, _BIG).contiguous()
    return stats, bound_t, labels


def _label_propagate_fused(normal, centroid, valid, angle_thresh_deg, l, k,
                           bound, max_iters):
    """The propagation kernel: one launch, no host sync."""
    stats, bound_t, labels = _kernel_inputs(normal, centroid, valid, bound)
    flags = torch.zeros((max_iters, labels.shape[0] + 1), dtype=torch.int32,
                        device=labels.device)
    _launch_propagate(stats, bound_t, labels, flags,
                      sweep_counter(labels.device), cos_deg(angle_thresh_deg),
                      l, k, max_iters)
    return labels


def _label_propagate_host_loop(normal, centroid, valid, angle_thresh_deg, l,
                               k, bound, max_iters):
    """The per-sweep host loop: one sweep launch, one gather launch (path
    halving) and one host sync (the flag) a sweep. For A/B timing
    against the propagation kernel; ``label_propagate`` never takes it."""
    stats, bound_t, labels = _kernel_inputs(normal, centroid, valid, bound)
    P, V = labels.shape
    big = torch.full((P, V), _BIG, dtype=torch.int32, device=labels.device)
    changed = torch.zeros((P,), dtype=torch.int32, device=labels.device)
    cos_gate = cos_deg(angle_thresh_deg)
    for _ in range(max_iters):
        changed.zero_()
        _launch_sweep(stats, bound_t, labels, changed, cos_gate, l, k)
        labels = torch.where(
            valid, pointer_jump(labels, V, _JUMP_ROUNDS), big
        ).contiguous()
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
    propagation kernel (no host sync); any other device raises.
    """
    squeeze = normal.dim() == 2
    if squeeze:
        normal, centroid, valid = normal[None], centroid[None], valid[None]
    if normal.device.type == "cpu":
        labels = label_propagate_plain(
            normal, centroid, valid, angle_thresh_deg, l, k, max_iters
        )
    elif normal.device.type == "cuda":
        labels = _label_propagate_fused(
            normal, centroid, valid, angle_thresh_deg, l, k, bound, max_iters
        )
    else:
        raise ValueError(f"label_propagate: unsupported device {normal.device}")
    return labels[0] if squeeze else labels
