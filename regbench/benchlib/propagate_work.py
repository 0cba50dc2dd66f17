"""The least time of the label-propagation kernel
(``label_prop_propagate_kernel``), from the work that its inputs need.

The kernel turns each cloud's voxels (normal, centroid and valid flag of
V slots) into component labels of the affinity graph: two voxels are
joined when their normals lie within the angle and each lies on the
other's plane (``pairwise_affinity``). Whatever implements it, it has to
read each input once, write each label once, and decide each edge once:

- operations: every valid voxel's normal normalized once (3 products, 2
  adds, a square root and 3 divisions: 9); the normal test once for each
  unordered pair of valid voxels (a 3-term dot product and a compare:
  6); the plane test once for each unordered pair that passes the normal
  test (the centroids' difference, its length, the two plane distances,
  the distance threshold l / (k d + 1) and its product with d, two
  absolute values and compares, the d > 0 test and the conjunction: 29,
  each square root and division counted as one). The affinity is
  symmetric, so an unordered pair needs each test once;
- bytes: the normals and centroids (6 float32 a slot), the valid flags
  (one byte a slot) read once, and the int32 labels written once, for
  all V slots of every cloud.

Neither count depends on how many sweeps a propagation runs, nor on how
the kernel packs its inputs: it is the work that the step's inputs need,
not the work that the kernel did. The bound is the larger of operations
over the float32 peak and bytes over the memory peak of an H100 SXM
(NVIDIA's data sheet, 700 W), and ``bound_by`` says which limit binds.
"""

from __future__ import annotations

import math

import torch

PEAK_F32 = 67e12      # float32 operations a second, outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3 bytes a second
NORMALIZE_OPS = 9
NORMAL_TEST_OPS = 6
PLANE_TEST_OPS = 29


def cloud_work(normal, centroid, valid, angle_deg):
    """(valid voxels, normal tests, plane tests) of one cloud: normal,
    centroid (V, 3), valid (V,) bool. The pairs are counted in float64
    from the inputs."""
    idx = torch.nonzero(valid).flatten()
    n = int(idx.numel())
    if n < 2:
        return n, 0, 0
    nh = normal[idx].double()
    nh = nh / torch.linalg.vector_norm(nh, dim=-1, keepdim=True)
    cos_gate = math.cos(math.radians(angle_deg))
    passes = 0
    for start in range(0, n, 4096):  # row blocks of the (n, n) cosines
        cos = nh[start:start + 4096] @ nh.mT
        rows = torch.arange(start, min(start + 4096, n),
                            device=cos.device)[:, None]
        upper = torch.arange(n, device=cos.device)[None, :] > rows
        passes += int(((cos >= cos_gate) & upper).sum())
    return n, n * (n - 1) // 2, passes


def work(normal, centroid, valid, angle_deg):
    """(operations, bytes) of one propagation over a batch of clouds:
    normal, centroid (P, V, 3), valid (P, V)."""
    P, V = valid.shape
    ops = 0
    for p in range(P):
        n, normal_tests, plane_tests = cloud_work(normal[p], centroid[p],
                                                  valid[p], angle_deg)
        ops += (n * NORMALIZE_OPS + normal_tests * NORMAL_TEST_OPS
                + plane_tests * PLANE_TEST_OPS)
    nbytes = P * V * (6 * 4 + 1 + 4)
    return ops, nbytes


def bound_s(ops, nbytes):
    """(least seconds, the limit that binds: "operations" or "bytes")."""
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
