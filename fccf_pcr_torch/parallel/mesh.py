"""Data-parallel registration: the pair axis split over devices (port of
``fccf_pcr_tpu/parallel/mesh.py``).

The JAX package shards the leading pair axis of its vmapped program over
a ``jax.sharding.Mesh``; pairs are independent, so no collective runs on
the hot path. Here a mesh is a list of ``torch.device``: chunk i of a
batch runs as the batched program (``make_register_fn(batched=True)``)
on ``mesh[i]``, and the results are concatenated in order on
``mesh[0]``; ``sharded_pre_downsample`` splits the sweep's first
downsample the same way and hands its chunks over where they lie, as the
JAX package shards ``pre`` over its mesh. Distinct devices run at once,
one host thread each; a device listed more than once runs its chunks in
turn on its one stream, so one card split k ways stands in for k cards
in a dry run. A row of a
batch equals its pair registered alone bit for bit (the batched program
adds in an order fixed by one row's shape), so a split is exact: its
rows are bitwise equal to the unsplit batch's.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor

import torch

from ..config import Capacities, FCCFParams
from ..pipeline.register import (
    RegistrationResult,
    make_register_fn,
    pre_downsample,
    resolve_device,
)


def _device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices=None) -> list:
    """The devices a batch is split over, in chunk order: every card by
    default (``torch.cuda.device_count()``; none raises), or the given
    list, which may repeat a device."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            resolve_device("cuda")  # raises: no card
        devices = [torch.device("cuda", i) for i in range(n)]
    return [_device(d) for d in devices]


def _on(device):
    """A context that makes ``device`` current for the launches of the
    host thread (CUDA), or nothing (CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _chunks(n_pairs, mesh):
    if n_pairs % len(mesh):
        raise ValueError(
            f"the pair axis ({n_pairs}) does not divide over the mesh's "
            f"{len(mesh)} devices")
    k = n_pairs // len(mesh)
    return [slice(i * k, (i + 1) * k) for i in range(len(mesh))]


def _split(a, mesh):
    """The chunks of ``a``'s leading axis, in mesh order."""
    return [a[s] for s in _chunks(len(a), mesh)]


def _run_split(mesh, work):
    """``work(i)`` for every chunk i: each distinct device in a host
    thread of its own, its chunks in turn. Returns the results in chunk
    order."""
    by_device = {}
    for i, dev in enumerate(mesh):
        by_device.setdefault(dev, []).append(i)

    def run(dev, idxs):
        with _on(dev):
            return [(i, work(i)) for i in idxs]

    if len(by_device) == 1:
        done = [run(*item) for item in by_device.items()]
    else:
        with ThreadPoolExecutor(len(by_device)) as ex:
            done = list(ex.map(lambda item: run(*item), by_device.items()))
    out = dict(r for rs in done for r in rs)
    return [out[i] for i in range(len(mesh))]


def make_sharded_register_fn(params: FCCFParams, caps: Capacities, mesh):
    """Batched registration with the pair axis split over ``mesh``.

    The four arguments carry a leading pair axis that must divide by
    ``len(mesh)`` (else ``ValueError``, as the JAX package's sharding
    refuses it). Chunk i runs on ``mesh[i]``; the ``RegistrationResult``
    fields are concatenated in chunk order on ``mesh[0]``. An argument
    may also be the list of its chunks, chunk i on
    ``mesh[i]`` (``sharded_pre_downsample``'s output), taken as it is."""
    fns = {dev: make_register_fn(params, caps, batched=True, device=dev)
           for dev in mesh}

    def fn(src, src_mask, tar, tar_mask):
        args = [a if isinstance(a, list) else _split(a, mesh)
                for a in (src, src_mask, tar, tar_mask)]
        if any(len(a) != len(mesh) for a in args):
            raise ValueError(f"an argument is not in {len(mesh)} chunks")
        results = _run_split(
            mesh, lambda i: fns[mesh[i]](*(a[i] for a in args)))
        return RegistrationResult(*(
            torch.cat([getattr(r, f).to(mesh[0]) for r in results])
            for f in RegistrationResult._fields))

    return fn


def sharded_pre_downsample(points, mask, params: FCCFParams,
                           caps: Capacities, mesh):
    """``pre_downsample`` of a (P, N, 3) batch with the pair axis split
    over ``mesh``: chunk i on ``mesh[i]``. Returns the points and masks as
    lists of chunks, which ``make_sharded_register_fn``'s function takes
    where they lie, and the (P,) overflow flags on the host."""
    pts, valid = _split(points, mesh), _split(mask, mesh)
    out = _run_split(mesh, lambda i: pre_downsample(
        pts[i], valid[i], params, caps, device=mesh[i]))
    return ([o[0] for o in out], [o[1] for o in out],
            torch.cat([o[2].cpu() for o in out]))


def sharded_mean_errors(T_est, T_gt, mesh):
    """Mean RRE (deg) and RTE (m) over a batch split over ``mesh``: each
    chunk's error sums and count on its device, reduced on the host."""
    from ..pipeline.metrics import registration_errors

    T_est = torch.as_tensor(T_est)
    est = _split(T_est, mesh)
    gt = _split(torch.as_tensor(T_gt, dtype=T_est.dtype), mesh)

    def local(i):
        rre, rte = registration_errors(est[i].to(mesh[i]), gt[i].to(mesh[i]))
        return torch.stack([torch.sum(rre), torch.sum(rte)]).cpu(), len(rre)

    sums = _run_split(mesh, local)
    n = sum(c for _, c in sums)
    total = torch.stack([s for s, _ in sums]).sum(dim=0)
    return float(total[0]) / n, float(total[1]) / n
