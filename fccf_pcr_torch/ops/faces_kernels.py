"""The faces stage's plane fit and label segment sums, each as a CUDA
kernel and its plain PyTorch version.

  - F1, ``plane_fit``: each voxel's plane fit (``eigen3.plane_fit_from_cov``,
    the JAX package's ``fccf_pcr_tpu/ops/eigen3.py::plane_fit_from_cov``),
    the point-count and curvature gates, the orientation of the normal
    toward its cloud's centroid and the residual gate
    (``fccf_pcr_tpu/features/faces.py:260-283``), one thread a voxel.
  - F2, ``face_stats`` and ``label_segment_sum``: per-label sums over the
    rows sorted stably by label (``sorted_labels``: ``torch.sort``), as a
    segmented doubling scan whose last row of each label holds its sum,
    which the port uses in place of the JAX package's one-hot contraction
    (``fccf_pcr_tpu/features/faces.py:163-197``): no tensor is (V, V) and
    a cloud sums alike in any batch. The kernel takes the labels as they
    come and forms the stable order itself, on the card, in the same
    launch (``label_order`` returns that order alone, formed by the same
    blocks). ``face_stats``
    forms the eight statistics columns from their sources and divides,
    rounds and casts them in the kernel; ``label_segment_sum`` sums one
    column as it is.

CUDA tensors take the kernels of ``csrc/faces.cu`` on the current stream,
with no host sync, so the register step's CUDA graph captures them; there
is no fallback: a missing ``nvcc``, a failed build or a refused launch
raises. CPU tensors take the plain versions (``plane_fit_plain``;
``sorted_labels`` then ``face_stats_plain`` or ``values_sum_plain``,
together ``face_stats_by_label_plain`` and ``values_sum_by_label_plain``);
any other device raises. Each kernel gives its plain version's bits on
the card. The library is built with nvcc into ``fccf_pcr_torch/build/``
at first use and bound with ctypes (``ops.cuda_build``). ``PLANE_FITS``
and ``SEGMENT_SUMS`` count the launches of F1 and F2, ``ORDERS`` those of
F2's order alone (``ops.graph.count_launch``: a launch captured into a
CUDA graph counts at each replay). Every entry point runs inside a
``record_function`` range named ``faces_kernels.<entry>``.
"""

from __future__ import annotations

import ctypes
import math
import sys
from typing import NamedTuple

import torch
from torch.profiler import record_function

from . import eigen3
from .batch import take
from .cuda_build import CudaLibrary
from .launch import checked, device_type, launched, stream

# Launches of F1 (the plane fit), F2 (the segment sums, both forms) and
# F2's order alone (label_order, off the main path).
PLANE_FITS = 0
SEGMENT_SUMS = 0
ORDERS = 0
_THIS = sys.modules[__name__]
# csrc/faces.cu's forms of F2.
VALUES, FACE_STATS, ORDER = 0, 1, 2


class PlaneFit(NamedTuple):
    """F1's outputs, each (..., V) or (..., V, 3)."""

    normal: torch.Tensor         # unit normal, oriented toward the centroid
    curvature: torch.Tensor      # l0 / (l0 + l1 + l2)
    vvalid: torch.Tensor         # valid, enough points and planar
    residual_gate: torch.Tensor  # valid, enough points, not planar


def _bind(lib):
    fn = lib.fccf_faces_plane_fit
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 2 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.fccf_faces_segment_scratch
    fn.argtypes = [ctypes.c_longlong] * 3 + [ctypes.c_int]
    fn.restype = ctypes.c_longlong
    fn = lib.fccf_faces_segment_sum
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.fccf_faces_face_stats
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.fccf_faces_label_order
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.fccf_faces_math_probe
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int


_LIBRARY = CudaLibrary("faces.cu", _bind)


def build(force: bool = False):
    """Compile ``csrc/faces.cu`` (if needed, or always with ``force``) and
    load it. Returns the ctypes library."""
    return _LIBRARY.load(force)


# ---------------------------------------------------------------- plain --


def plane_fit_plain(cov, centroid, count, valid, global_centroid,
                    point_threshold, curvature_threshold):
    """F1's plain version: cov (..., V, 3, 3), centroid (..., V, 3), count
    (..., V) int32, valid (..., V) bool, global_centroid (..., 3) ->
    ``PlaneFit`` (FCCF.cpp:486-530)."""
    normal, curvature = eigen3.plane_fit_from_cov(cov)
    enough = count > point_threshold  # strictly > (:486)
    planar = curvature < curvature_threshold  # (:497)
    # Orient each normal toward the global centroid (:504-516).
    to_c = centroid - global_centroid[..., None, :]
    flip = torch.sum(to_c * normal, dim=-1) < 0.0
    return PlaneFit(
        normal=torch.where(flip[..., None], normal, -normal),
        curvature=curvature,
        vvalid=valid & enough & planar,
        residual_gate=valid & enough & ~planar,
    )


def sorted_labels(labels, valid, V):
    """The rows sorted stably by label (..., V): (seg_s, order), seg the
    label clamped to V - 1, or V for an invalid row."""
    seg = torch.where(valid, torch.clamp(labels, max=V - 1), V)
    return torch.sort(seg, dim=-1, stable=True)


def segment_sum_plain(seg_s, order, values, V):
    """Per-label sums (..., V, D) of ``values`` (..., n, D) over the rows
    sorted by label (``sorted_labels``): the rows taken in sorted order, a
    segmented inclusive scan (log2 n doubling steps, each adding the
    partial sum d rows back where that row has the same label, +0.0
    elsewhere), and each run's total written to its label's slot; rows
    labelled V or below 0 are dropped (as the one-hot contraction drops
    them) and other slots are 0. Each row of the leading
    batch dims is summed alone with the same adds."""
    x = take(values, order)
    n = seg_s.shape[-1]
    d = 1
    while d < n:
        same = (seg_s[..., d:] == seg_s[..., :-d])[..., None]
        x = torch.cat(
            [x[..., :d, :], x[..., d:, :] + torch.where(same, x[..., :-d, :], 0.0)],
            dim=-2,
        )
        d *= 2
    last = torch.cat(
        [seg_s[..., 1:] != seg_s[..., :-1], torch.ones_like(seg_s[..., :1],
                                                             dtype=torch.bool)],
        dim=-1,
    ) & (seg_s >= 0) & (seg_s < V)
    dest = torch.where(last, seg_s, V)[..., None].expand(x.shape)
    out = torch.zeros(tuple(x.shape[:-2]) + (V + 1, x.shape[-1]),
                      dtype=x.dtype, device=x.device)
    out.scatter_(-2, dest, x)
    return out[..., :V, :]


def values_sum_plain(seg_s, order, values, V):
    """``label_segment_sum``'s plain version: sums (..., V) of one column
    ``values`` (..., n)."""
    return segment_sum_plain(seg_s, order, values[..., None], V)[..., 0]


def stat_columns(count, centroid, normal, valid):
    """The face statistics' columns (..., V, 8): [centroid * w, normal *
    w, w, 1], w = float(count) where valid, else 0."""
    dt = centroid.dtype
    w = torch.where(valid, count.to(dt), 0.0)
    return torch.cat(
        [centroid * w[..., None], normal * w[..., None], w[..., None],
         torch.ones_like(w[..., None])],
        dim=-1,
    )


def face_stats_plain(seg_s, order, count, centroid, normal, valid, V):
    """``face_stats``' plain version on the sorted labels: (centroid,
    normal, psize, vcount) of every slot, the sums of centroid * w and
    normal * w divided by psize (at least 1e-12), psize the sum of w, and
    vcount the rounded count of rows."""
    sums = segment_sum_plain(
        seg_s, order, stat_columns(count, centroid, normal, valid), V)
    csum, nsum = sums[..., 0:3], sums[..., 3:6]
    psize = sums[..., 6]
    vcount = torch.round(sums[..., 7]).to(torch.int32)
    denom = torch.clamp(psize, min=1e-12)[..., None]
    return csum / denom, nsum / denom, psize, vcount


def face_stats_by_label_plain(labels, valid, count, centroid, normal, V):
    """``face_stats``' plain version from the labels (F2's signature): the
    stable sort (``sorted_labels``), then ``face_stats_plain``."""
    seg_s, order = sorted_labels(labels, valid, V)
    return face_stats_plain(seg_s, order, count, centroid, normal, valid, V)


def values_sum_by_label_plain(values, labels, valid, V):
    """``label_segment_sum``'s plain version from the labels (F2's
    signature): the stable sort, then ``values_sum_plain``."""
    seg_s, order = sorted_labels(labels, valid, V)
    return values_sum_plain(seg_s, order, values, V)


# -------------------------------------------------------------- kernels --


def _launch_plane_fit(cov, centroid, count, valid, global_centroid,
                      point_threshold, curvature_threshold):
    """F1 on CUDA tensors."""
    lead = tuple(valid.shape[:-1])
    V = valid.shape[-1]
    cov, centroid, count, valid, gc = checked(
        ("cov", "centroid", "count", "valid", "global_centroid"),
        (cov, centroid, count, valid, global_centroid),
        (torch.float32, torch.float32, torch.int32, torch.bool,
         torch.float32),
        (lead + (V, 3, 3), lead + (V, 3), lead + (V,), lead + (V,),
         lead + (3,)))
    dev = cov.device
    out = PlaneFit(
        normal=torch.empty(lead + (V, 3), dtype=torch.float32, device=dev),
        curvature=torch.empty(lead + (V,), dtype=torch.float32, device=dev),
        vvalid=torch.empty(lead + (V,), dtype=torch.bool, device=dev),
        residual_gate=torch.empty(lead + (V,), dtype=torch.bool, device=dev))
    if valid.numel() == 0:
        return out
    lib = build()
    with torch.cuda.device(dev):  # the C entry launches on it
        rc = lib.fccf_faces_plane_fit(
            cov.data_ptr(), centroid.data_ptr(), count.data_ptr(),
            valid.data_ptr(), gc.data_ptr(),
            *(t.data_ptr() for t in out), math.prod(lead), V,
            int(point_threshold), float(curvature_threshold), stream(dev))
    launched(rc, "fccf_faces_plane_fit", _THIS, "PLANE_FITS")
    return out


def _labels(what, labels, valid, V, form):
    """The labels (int64) and valid flags (bool) checked (one shape, one
    device), made contiguous, with (lead, n, B, scratch) of an F2 launch
    for V slots."""
    if labels.dtype != torch.int64 or valid.dtype != torch.bool or tuple(
            labels.shape) != tuple(valid.shape) or labels.device != valid.device:
        raise ValueError(f"{what}: want int64 labels and bool valid of one "
                         f"shape, got {labels.dtype} {tuple(labels.shape)} "
                         f"and {valid.dtype} {tuple(valid.shape)}")
    lead, n = tuple(labels.shape[:-1]), labels.shape[-1]
    if n >= 1 << 24:
        raise ValueError(f"{what}: {n} rows a cloud, want fewer than 2^24")
    B = math.prod(lead)
    nbytes = int(build().fccf_faces_segment_scratch(B, n, V, form))
    scratch = (torch.empty((nbytes,), dtype=torch.uint8, device=labels.device)
               if nbytes else None)
    return labels.contiguous(), valid.contiguous(), lead, n, B, scratch


def _launch_segment_sum(values, labels, valid, V):
    """F2's values form on CUDA tensors: sums (..., V) of values (..., n)
    float32 by labels (..., n) int64 and valid (..., n) bool, ordered on
    the card in the same launch."""
    labels, valid, lead, n, B, scratch = _labels(
        "label_segment_sum", labels, valid, V, VALUES)
    (values,) = checked(("values",), (values,), (torch.float32,),
                        (lead + (n,),))
    dev = values.device
    out = torch.empty(lead + (V,), dtype=torch.float32, device=dev)
    if out.numel() == 0 or n == 0:
        return out.zero_()
    lib = build()
    with torch.cuda.device(dev):
        rc = lib.fccf_faces_segment_sum(
            labels.data_ptr(), valid.data_ptr(), values.data_ptr(),
            out.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
            B, n, V, stream(dev))
    launched(rc, "fccf_faces_segment_sum", _THIS, "SEGMENT_SUMS")
    return out


def _launch_face_stats(labels, valid, count, centroid, normal, V):
    """F2's face statistics on CUDA tensors (``face_stats``' signature),
    ordered on the card in the same launch."""
    labels, valid, lead, n, B, scratch = _labels(
        "face_stats", labels, valid, V, FACE_STATS)
    count, centroid, normal = checked(
        ("count", "centroid", "normal"), (count, centroid, normal),
        (torch.int32, torch.float32, torch.float32),
        (lead + (n,), lead + (n, 3), lead + (n, 3)))
    dev = centroid.device
    c = torch.empty(lead + (V, 3), dtype=torch.float32, device=dev)
    nrm = torch.empty(lead + (V, 3), dtype=torch.float32, device=dev)
    psize = torch.empty(lead + (V,), dtype=torch.float32, device=dev)
    vcount = torch.empty(lead + (V,), dtype=torch.int32, device=dev)
    if psize.numel() == 0 or n == 0:
        return c.zero_(), nrm.zero_(), psize.zero_(), vcount.zero_()
    lib = build()
    with torch.cuda.device(dev):
        rc = lib.fccf_faces_face_stats(
            labels.data_ptr(), valid.data_ptr(), count.data_ptr(),
            centroid.data_ptr(), normal.data_ptr(), c.data_ptr(),
            nrm.data_ptr(), psize.data_ptr(), vcount.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), B, n, V,
            stream(dev))
    launched(rc, "fccf_faces_face_stats", _THIS, "SEGMENT_SUMS")
    return c, nrm, psize, vcount


def _launch_label_order(labels, valid, V):
    """F2's stable order on CUDA tensors: (seg_s, order), int64 (..., n),
    formed by the blocks of a sum form. Raises where a valid label is below
    -2^31, which F2's 32-bit keys do not order (a host read)."""
    labels, valid, lead, n, B, scratch = _labels(
        "label_order", labels, valid, V, ORDER)
    if bool((valid & (labels < -2**31)).any()):
        raise ValueError("label_order: a valid label below -2^31; F2 orders "
                         "labels of int32 range (its sums drop such rows)")
    seg_s = torch.empty(lead + (n,), dtype=torch.int64, device=labels.device)
    order = torch.empty_like(seg_s)
    if seg_s.numel() == 0:
        return seg_s, order
    lib = build()
    with torch.cuda.device(labels.device):
        rc = lib.fccf_faces_label_order(
            labels.data_ptr(), valid.data_ptr(), seg_s.data_ptr(),
            order.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
            B, n, V, stream(labels.device))
    launched(rc, "fccf_faces_label_order", _THIS, "ORDERS")
    return seg_s, order


def math_probe(x, y):
    """(cosf(x), atan2f(y, x)) of float32 CUDA tensors of one shape, by the
    CUDA math functions F1 calls: held to ``torch.cos`` / ``torch.atan2``,
    which the plain version calls on the card."""
    x, y = checked(("x", "y"), (x, y), (torch.float32,) * 2,
                   (tuple(x.shape),) * 2)
    if x.device.type != "cuda":
        raise ValueError(f"math_probe: want CUDA tensors, got {x.device}")
    cos_out, atan2_out = torch.empty_like(x), torch.empty_like(x)
    lib = build()
    with torch.cuda.device(x.device):
        rc = lib.fccf_faces_math_probe(x.data_ptr(), y.data_ptr(),
                                       cos_out.data_ptr(),
                                       atan2_out.data_ptr(), x.numel(),
                                       stream(x.device))
    if rc != 0:
        raise RuntimeError(f"fccf_faces_math_probe launch failed: CUDA error "
                           f"{rc}")
    return cos_out, atan2_out


# -------------------------------------------------------------- entries --


def plane_fit(cov, centroid, count, valid, global_centroid, point_threshold,
              curvature_threshold):
    """Each voxel's oriented unit normal, curvature, planar gate and
    residual gate (``plane_fit_plain``): F1 on a card."""
    with record_function("faces_kernels.plane_fit"):
        if device_type(cov, "plane_fit") == "cpu":
            return plane_fit_plain(cov, centroid, count, valid,
                                   global_centroid, point_threshold,
                                   curvature_threshold)
        return _launch_plane_fit(cov, centroid, count, valid,
                                 global_centroid, point_threshold,
                                 curvature_threshold)


def face_stats(labels, valid, count, centroid, normal, V):
    """Point-count-weighted statistics of each face label (..., V):
    (centroid, normal, psize, vcount) by slot (``face_stats_plain`` after
    the stable sort by label), F2 on a card, its order formed in the
    kernel."""
    with record_function("faces_kernels.face_stats"):
        if device_type(centroid, "face_stats") == "cpu":
            return face_stats_by_label_plain(labels, valid, count, centroid,
                                             normal, V)
        return _launch_face_stats(labels, valid, count, centroid, normal, V)


def label_segment_sum(values, labels, valid, V):
    """Per-label sums (..., V) of ``values`` (..., V) over slot-index
    labels; invalid rows add nothing (``values_sum_plain`` after the
    stable sort by label): F2 on a card, its order formed in the kernel."""
    with record_function("faces_kernels.segment_sum"):
        if device_type(values, "label_segment_sum") == "cpu":
            return values_sum_by_label_plain(values, labels, valid, V)
        return _launch_segment_sum(values, labels, valid, V)


def label_order(labels, valid, V):
    """The rows sorted stably by label, (seg_s, order) as
    ``sorted_labels`` (``torch.sort``) gives them: on a card F2's own
    order, formed by the blocks of the segment sums, each sorting its range
    of slots as they do (the first also the negative labels, the last the
    invalid rows, which the sums drop); a valid label below -2^31 raises
    there."""
    with record_function("faces_kernels.label_order"):
        if device_type(labels, "label_order") == "cpu":
            return sorted_labels(labels, valid, V)
        return _launch_label_order(labels, valid, V)
