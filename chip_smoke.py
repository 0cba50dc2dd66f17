#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fccf_pcr_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line or more each; any failure exits non-zero and prints no
result:

  1. environment: torch / CUDA / nvcc versions and the card's name and
     power limit (nvidia-smi); no card -> fail (never a CPU fallback);
  2. build both sources with nvcc, in parallel: csrc/label_prop.cu
     (the label-propagation kernels: the propagation entry, one
     cooperative launch a propagation, and the one-sweep entry K1) and
     csrc/gather.cu (the per-row gather P1); ptxas's registers, shared
     memory and spills of each kernel;
  3. label propagation vs its plain PyTorch version on the card, through
     the propagation kernel and through the per-sweep host loop (K1 +
     P1 launches): clustered voxel stats at V=1536 (office), V=1000 (a
     tail) and V=9216 (heritage), batch 2 (a pass-1 prefix bound and a
     small pass-2 bound), and the edge cases (bounds 0 and 1, no valid
     row, one component spanning every voxel, only isolated voxels, V
     under one tile, P=3 with mixed bounds, P=3 pairs that converge at
     different sweeps, so the kernel drops a pair at its fixpoint from
     the later sweeps); labels must be equal. Then
     the main path's own pass-1 inputs (seed 0's target cloud at office
     and heritage): one sweep and its plain version timed, with the
     bound and the roofline share; one propagation through the kernel
     and through the host loop, in device time and wall time, the
     sweeps it ran, the device time outside its sweep phase, and its
     bound;
  4. P1 vs its plain version: the TPU probe's own inputs
     (tools/probe_gather.py) and label rows at the main path's shapes,
     (8, 9216) included; outputs must be equal; times beside plain and
     beside torch.gather alone (the library call, never called by the
     port);
  5. the main path at the full eth-office preset: bench.CONFIGS["office"]
     scenes for seeds 0-3 -> one batched pre_downsample a side -> the
     batched program (make_register_fn(batched=True), one program for
     the batch) on the card, held to the office rows of
     tests/golden/pipeline.json (transform within 0.1 deg / 0.02 m,
     status and kept mask equal) and to bench.GATES["office"] against
     ground truth; the propagation kernel's launch count must grow and
     the one-sweep and gather kernels' must not (the main path launches
     neither); each pair registered alone (P = 1) must match its batch
     row (status, kept mask, hypothesis and face counts equal, transform
     within 1e-3 deg / 1e-4 m); a second run, timed, must give
     bitwise-equal transforms; office, structured, resso and heritage
     also within tests/test_twin_production.py's bands of the NumPy
     twin's cached transforms (tests/golden/twin_production.json);
  6. the same for every other golden config at its full preset:
     structured (stairs and hall scenes, round-robin by seed), resso,
     apartment, cross-season and the building-scale heritage (two-key
     voxelization, V=9216); then office seed 0 with the target cut to its
     valid rows (another length than the source's), every field bitwise
     equal to the equal-length run;
  7. the command line in subprocesses: `python -m fccf_pcr_torch SRC TAR
     0.2 --caps heritage --device cuda --json` on the heritage seed-0
     pair written as PLY, held to its golden row; and a `--batch --out
     --caps auto` sweep of the resso seed-0 pair, held to
     bench.GATES["resso"];
  8. steady-state step time at batch 8 (build excluded), office and
     heritage, in pairs/s, each kernel's launches per step and the
     sweeps the propagation kernel ran (at most 4 propagation launches a
     step, no one-sweep or gather launch), and per step: every kernel
     launched (torch.profiler), the host syncs (counted under
     torch.cuda.set_sync_debug_mode("warn")) and the peak device memory
     (torch.cuda.max_memory_allocated);
  9. the mesh dry run: the office batch of 8 split over one card listed
     k times (parallel/mesh.py, make_mesh([cuda:0] * k), k = 2 and 4) and
     over make_mesh() (every card), every field bitwise equal to the
     unsplit batch; step wall times for k = 1, 2, 4 in turns and
     sharded_mean_errors against ground truth;
 10. the face-membership diff (twin/diff.py) on the five twin-sweep
     families' seed-30 targets at TEST_CAPS: the pipeline membership on
     the card equal to the CPU run's, the propagation kernel launched,
     pair_agreement > 0.98 and matched_fraction > 0.95;
 11. one heritage batch-8 step under utils/profiling.py's trace (its
     Chrome trace must name label_prop_propagate) and a StageTimer: host
     time per stage (register.py's record_function scopes), the device's
     busy share of the step, and the kernels with the most device time.

Then one JSON line describing the kernels, the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""


import collections
import functools
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "pipeline.json"
TWIN_PRODUCTION = GOLDEN.with_name("twin_production.json")
# The golden configs, in the order phases 5-6 run them.
PATH_CONFIGS = ("office", "structured", "resso", "apartment", "cross-season",
                "heritage")
KERNELS = {
    "label_prop_propagate": dict(
        name="label_prop_propagate",
        route="cuda",
        source="fccf_pcr_torch/csrc/label_prop.cu",
        replaces="tools/probe_gather.py:23",
        also_replaces="fccf_pcr_tpu/ops/pallas/label_prop.py:72",
    ),
    "label_prop_sweep": dict(
        name="label_prop_sweep",
        route="cuda",
        source="fccf_pcr_torch/csrc/label_prop.cu",
        replaces="fccf_pcr_tpu/ops/pallas/label_prop.py:72",
    ),
    "gather_rows": dict(
        name="gather_rows",
        route="cuda",
        source="fccf_pcr_torch/csrc/gather.cu",
        replaces="tools/probe_gather.py:23",
    ),
}
_BIG = 2**30
# K1 against plain: (V, per-pair bounds) of batch-2 comparisons, and the
# main path's pass-1 shapes it is timed at: (name, reps).
K1_CASES = ((1536, (1019, 97)), (1000, (1000, 61)), (9216, (8526, 100)))
K1_TIMED = (("office", 20), ("heritage", 5))
# P1 against plain: (P, V) label rows (after the TPU probe's own inputs).
P1_SHAPES = ((1, 1536), (1, 9216), (8, 9216))
# Peak rates of an H100 SXM at 700 W (NVIDIA's data sheet): float32
# outside the tensor cores, and HBM3.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# float32 operations of K1's predicate for one pair (i, j)
# (csrc/label_prop.cu): the normal test (3 multiplies, 2 adds, a compare),
# and the plane test, which only a pair that passes the normal test needs
# (12 multiplies, 11 adds, fmaxf, sqrtf and the division counted as one
# each, 3 compares).
K1_NORMAL_OPS = 6
K1_PLANE_OPS = 29
# torch.profiler captures taken again because CUPTI had dropped records
# (kernel_times), by the kernel name they were taken for.
RETAKEN = collections.Counter()


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def run(cmd):
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e.__class__.__name__})"
    return (out.stdout.strip() or out.stderr.strip()).splitlines()[-1]


def clustered(rng, V, n_groups=6, prefix=None):
    import numpy as np

    gn = rng.normal(size=(n_groups, 3))
    gn /= np.linalg.norm(gn, axis=1, keepdims=True)
    gc = rng.uniform(-10, 10, (n_groups, 3))
    which = rng.integers(0, n_groups, V)
    normal = (gn[which] + rng.normal(0, 0.01, (V, 3))).astype(np.float32)
    offsets = rng.uniform(-4, 4, (V, 3)).astype(np.float32)
    offsets -= (offsets * gn[which]).sum(1, keepdims=True) * gn[which]
    centroid = (gc[which] + offsets).astype(np.float32)
    valid = np.arange(V) < (V if prefix is None else prefix)
    valid &= rng.uniform(size=V) < 0.9
    return normal, centroid, valid


def cuda_ms(fn, reps, reset=None):
    """Mean ms of one call of ``fn`` on the card's clock, host time of its
    launches included where the card waits on them: ``reps`` calls back
    to back between two CUDA events or, with ``reset`` (untimed, before
    each call), each call between two events of its own."""
    import torch

    if reset is not None:
        reset()
    fn()  # warm up
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
             for _ in range(1 if reset is None else reps)]
    for a, b in pairs:  # an event is created at its first record: not timed
        a.record()
        b.record()
    if reset is None:
        ((a, b),) = pairs
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps
    for a, b in pairs:
        reset()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def phase_build(modules):
    """Build every kernel from its source, one nvcc each, all at once."""
    def build(mod):
        t0 = time.perf_counter()
        mod.build(force=True)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(modules)) as ex:
        return list(ex.map(build, modules))


def ptxas_summary(mod, kernel=""):
    """ptxas's lines for a source's build, of the kernels whose mangled
    name holds ``kernel``: registers, shared memory, spills."""
    lines, name = [], ""
    for ln in mod._LIBRARY.build_log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
        elif kernel in name and ("Used" in ln or "spill" in ln):
            lines.append(ln.split("ptxas info    : ")[-1].strip())
    return " | ".join(lines)


def edge_cases(rng):
    """K1's edge cases: (name, normal, centroid, valid, bounds) with
    (P, V, 3) / (P, V) numpy arrays and one bound a pair."""
    import numpy as np

    def one(V, prefix=None):
        return clustered(rng, V, prefix=prefix)

    def stack(clouds):
        return [np.stack([c[k] for c in clouds]) for k in range(3)]

    cases = []
    n, c, v = stack([one(700, 0), one(700, 1)])
    v[1, 0] = True  # the one slot below bound 1
    cases.append(("bounds 0 and 1", n, c, v, (0, 1)))
    n, c, v = stack([one(700)])
    cases.append(("no valid row", n, c, np.zeros_like(v), (700,)))
    # one plane through every voxel: every pair affine (the most atomics)
    V = 1536
    n = np.tile(np.float32([0, 0, 1]), (1, V, 1))
    c = np.concatenate([rng.uniform(-2, 2, (1, V, 2)),
                        np.zeros((1, V, 1))], axis=2).astype(np.float32)
    cases.append(("one component", n, c, np.ones((1, V), bool), (V,)))
    # parallel planes 10 apart: no pair affine
    c = np.zeros((1, V, 3), np.float32)
    c[0, :, 2] = 10.0 * np.arange(V)
    cases.append(("only isolated voxels", n, c, np.ones((1, V), bool), (V,)))
    for V in (40, 20):
        n, c, v = stack([one(V)])
        cases.append((f"V={V} under one tile", n, c, v, (V,)))
    n, c, v = stack([one(700, 700), one(700, 40), one(700, 1)])
    cases.append(("P=3 mixed bounds", n, c, v, (700, 40, 1)))
    n, c, v = stack([ring(2), one(700, 700), ring(0)])
    cases.append(("P=3 converging at different sweeps", n, c, v,
                  (700, 700, 700)))
    return cases


def ring(seed, V=700, n=120):
    """n voxels on a circle of radius 10 at 3 deg steps, normals radial,
    slots shuffled, ~5% invalid, in the first n of V slots: only
    neighbours on the circle are affine (6 deg fails the 5 deg gate), so
    components are long chains that take 12-14 sweeps to settle (seeds 2
    and 0; a numpy model of the kernel's schedule, Jacobi sweeps), where
    a clustered pair takes 2-3."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a = np.deg2rad(3.0 * np.arange(n))
    normal = np.zeros((V, 3), np.float32)
    normal[:n] = np.stack([np.cos(a), np.sin(a), np.zeros(n)], 1)[
        rng.permutation(n)]
    valid = np.zeros(V, bool)
    valid[:n] = rng.uniform(size=n) < 0.95
    return normal, 10.0 * normal, valid


def k1_against_plain(lp, dev, normal, centroid, valid, bounds, what,
                     angle=5.0, l=0.5, k=5.0):
    """label_propagate (the propagation kernel, one launch) and the
    per-sweep host loop (one-sweep kernel + gather kernel) against the
    plain version: labels must be equal. Returns the kernel's labels and
    the largest error of each route."""
    import torch

    normal, centroid, valid = (
        torch.as_tensor(a).to(dev) for a in (normal, centroid, valid))
    bound = torch.tensor(bounds, dtype=torch.int32, device=dev)
    want = lp.label_propagate_plain(normal, centroid, valid, angle, l, k)
    routes = {
        "propagate": ("PROPAGATIONS", lambda: lp.label_propagate(
            normal, centroid, valid, angle, l, k, bound=bound)),
        "host loop": ("LAUNCHES", lambda: lp._label_propagate_host_loop(
            normal, centroid, valid, angle, l, k, bound, 32)),
    }
    got, errs = {}, {}
    for route, (counter, fn) in routes.items():
        before = getattr(lp, counter)
        got[route] = fn()
        torch.cuda.synchronize()
        check(getattr(lp, counter) > before,
              f"{what}: the {route} kernel was not launched")
        errs[route] = int((got[route].long() - want.long()).abs().max())
        check(errs[route] == 0, f"{what}: {route} labels differ from plain "
              f"(max {errs[route]})")
    return got["propagate"], errs


def main_path_k1_inputs(name, dev):
    """The main path's first label propagation (pass 1 of seed 0's target
    cloud at the ``name`` preset): (normal, centroid, valid) with a pair
    axis of 1, angle, l, k and the (1,) int32 bound."""
    import torch

    import bench
    from fccf_pcr_torch import make_register_fn
    from fccf_pcr_torch.features import faces
    from fccf_pcr_torch.models.fccf import get_model

    model = get_model(bench.CONFIGS[name]["model"])
    args, _ = config_batch(name, [0], model.params, model.caps, dev)
    calls = []
    propagate = faces.label_propagate

    def record(*a, **kw):
        calls.append((a, kw))
        return propagate(*a, **kw)

    faces.label_propagate = record
    try:
        make_register_fn(model.params, model.caps, batched=True,
                         device=dev)(*args)
    finally:
        faces.label_propagate = propagate
    # The first call is pass 1 of the batch's 2P clouds, targets first.
    (normal, centroid, valid, angle, l, k), kw = calls[0]
    bound = torch.as_tensor(kw["bound"], device=dev).reshape(-1)[:1]
    return (normal[:1], centroid[:1], valid[:1], angle, l, k,
            bound.to(torch.int32))


def capture(fn, only="", reset=None):
    """Device ms of each record whose name holds ``only`` in one
    torch.profiler (CUPTI) capture of one call of ``fn``, after ``reset``
    (untimed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if reset is not None:
        reset()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.device_time / 1e3 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and only in e.name]


def record_count(fn, only="", reset=None, n=3, tries=10):
    """The records named ``only`` that a whole capture of one call of
    ``fn`` holds: the most of ``n`` captures (CUPTI drops records and
    never adds one), and of up to ``tries`` while every capture is
    empty."""
    counts = []
    while len(counts) < n or (not max(counts) and len(counts) < tries):
        counts.append(len(capture(fn, only, reset)))
    check(max(counts) > 0, f"torch.profiler captured no record named "
          f"{only!r} in {len(counts)} captures")
    return max(counts)


def kernel_times(fn, only="", reset=None, launched=None, records=None,
                 tries=10):
    """Device ms of each kernel whose name holds ``only`` that one call
    of ``fn`` launches (``capture``). The capture must hold exactly as
    many records as the call launched: the growth of ``launched()`` (a
    launch count of the port's) over the call, or else ``records``
    (``record_count``). CUPTI can drop records (in chip runs, one capture
    of the host loop held none of its sweep kernels, and three captures of
    a gather in a row held no kernel at all): a capture with another count
    is taken again after a pause that grows with each try, up to ``tries``
    times, and then the phase fails. RETAKEN counts the captures taken
    again."""
    got = []
    for attempt in range(tries):
        if attempt:
            RETAKEN[only] += 1
            time.sleep(0.05 * attempt)
        before = launched() if launched else 0
        times = capture(fn, only, reset)
        want = launched() - before if launched else records
        check(want > 0, f"the call launched no kernel named {only!r}")
        if len(times) == want:
            return times
        got.append(len(times))
    raise SmokeFailure(f"torch.profiler captured {got} records named "
                       f"{only!r} in {tries} captures of a call that "
                       f"launched {want}")


def device_ms(fn, reps, reset=None, only="", launched=None):
    """Mean device time of one call of ``fn`` in ms: the sum of the
    durations of the kernels it launches (those whose name holds
    ``only``), so host time between launches does not count; ``reset``
    (before each call) is left out. Each capture holds every record of
    the call (``kernel_times``): as many as ``launched`` grew by, or as a
    whole capture holds."""
    import torch

    if reset is not None:
        reset()
    fn()  # warm up
    torch.cuda.synchronize()
    records = None if launched else record_count(fn, only, reset)
    return sum(sum(kernel_times(fn, only, reset, launched, records))
               for _ in range(reps)) / reps


def wall_ms(fn, reps):
    """Mean and least wall time of one call of ``fn`` in ms, host clock,
    from an idle card to the end of its work (a synchronize on each
    side)."""
    import torch

    fn()  # warm up
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sum(times) / reps, min(times)


def sweep_device_times(fn, launched=None):
    """Device ms of each one-sweep kernel launch of one call of ``fn``
    (``kernel_times``: as many as ``launched`` grew by, or as a whole
    capture holds)."""
    only = "label_prop_sweep_kernel"
    return kernel_times(fn, only, launched=launched, records=(
        None if launched else record_count(fn, only)))


def propagate_once(lp, stats, bound, init, cos_gate, l, k, max_iters):
    """One launch of the propagation kernel from ``init``: (labels,
    sweeps run)."""
    import torch

    labels = init.clone()
    flags = torch.zeros((max_iters, labels.shape[0] + 1), dtype=torch.int32,
                        device=labels.device)
    sweeps = torch.zeros((1,), dtype=torch.int64, device=labels.device)
    lp._launch_propagate(stats, bound, labels, flags, sweeps, cos_gate, l, k,
                         max_iters)
    torch.cuda.synchronize()
    return labels, int(sweeps)


def plain_sweep(lp, normal, centroid, valid, angle, l, k, labels):
    """One Jacobi sweep of the plain version: the affinity matrix, then
    each row's minimum over its affine labels."""
    import torch

    aff = lp.pairwise_affinity(normal, centroid, valid, angle, l, k)
    neigh = torch.amin(torch.where(aff, labels[..., None, :], _BIG), dim=-1)
    return torch.minimum(labels, neigh)


def k1_bound(stats, labels, nb, cos_gate):
    """The least time of one sweep from ``labels`` (V,) over the packed
    stats (12, V): the float32 operations the sweep's pairs need against
    the bytes (stats and bound read once, labels read and written once,
    the flag written). A pair needs the normal test when i is valid, both
    lie below the bound and j's label is below i's (the kernel skips every
    other pair exactly), and the plane test only when it also passes the
    normal test, evaluated in the kernel's expression order. Returns
    (bound ms, bound_by, operations, normal-test pairs, plane-test
    pairs)."""
    lab = labels[:nb]
    need = (lab[None, :] < lab[:, None]) & (lab[:, None] < _BIG)
    nh = stats[:3, :nb]
    cos = (nh[0][:, None] * nh[0][None, :] + nh[1][:, None] * nh[1][None, :]
           + nh[2][:, None] * nh[2][None, :])
    n_normal = int(need.sum())
    n_plane = int((need & (cos >= cos_gate)).sum())
    ops = n_normal * K1_NORMAL_OPS + n_plane * K1_PLANE_OPS
    ops_s = ops / PEAK_F32
    V = labels.shape[0]
    bytes_s = (12 * V * 4 + 4 + 2 * V * 4 + 4) / PEAK_BYTES
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes",
            ops, n_normal, n_plane)


def phase_kernel_vs_plain(lp, dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    errs = collections.defaultdict(list)

    def compare(*args, **kw):
        got, e = k1_against_plain(lp, dev, *args, **kw)
        for route, err in e.items():
            errs[route].append(err)
        return got

    for V, bounds in K1_CASES:
        stats = [clustered(rng, V, prefix=b) for b in bounds]
        got = compare(*(np.stack([s[k] for s in stats]) for k in range(3)),
                      bounds, f"V={V}")
        check(len(torch.unique(got[0][got[0] < _BIG])) >= 2,
              "no components formed")
    for what, normal, centroid, valid, bounds in edge_cases(rng):
        got = compare(normal, centroid, valid, bounds, what)
        comps = [len(torch.unique(g[g < _BIG])) for g in got]
        print(f"[kernel] propagation and host loop equal to plain: {what} "
              f"(V={valid.shape[1]}, bounds {bounds}, components {comps})",
              flush=True)

    # Times at the main path's own pass-1 inputs: one sweep from the
    # initial labels (reset before each) and its plain version; one
    # propagation through the kernel, through the per-sweep host loop
    # and through the plain version.
    times = {}
    for name, reps in K1_TIMED:
        normal, centroid, valid, angle, l, k, bound = main_path_k1_inputs(
            name, dev)
        V, nb = valid.shape[1], int(bound[0])
        compare(normal, centroid, valid, (nb,), f"{name} pass 1", angle, l, k)
        stats = lp._pack_stats(normal, centroid, valid)
        init = torch.where(valid, torch.arange(V, dtype=torch.int32,
                                               device=dev), _BIG).contiguous()
        labels = init.clone()
        changed = torch.zeros(1, dtype=torch.int32, device=dev)
        cos_gate = lp.cos_deg(angle)

        def sweep():
            lp._launch_sweep(stats, bound, labels, changed, cos_gate, l, k)

        def reset():
            labels.copy_(init)

        def fused():
            return lp.label_propagate(normal, centroid, valid, angle, l, k,
                                      bound=bound)

        def host_loop():
            return lp._label_propagate_host_loop(
                normal, centroid, valid, angle, l, k, bound, 32)

        t = dict(V=V, bound=nb)
        t["sweep_ms"] = device_ms(sweep, 10, reset, "label_prop_sweep_kernel",
                                  lambda: lp.LAUNCHES)
        t["sweep_call_ms"] = cuda_ms(sweep, 4 * reps, reset)
        t["plain_sweep_ms"] = device_ms(lambda: plain_sweep(
            lp, normal, centroid, valid, angle, l, k, init), 10)
        (t["bound_ms"], t["bound_by"], t["ops"], t["normal_pairs"],
         t["plane_pairs"]) = k1_bound(stats[0], init[0], nb, cos_gate)
        t["full_bound_ms"] = (nb * nb * (K1_NORMAL_OPS + K1_PLANE_OPS)
                              / PEAK_F32 * 1e3)
        # Propagation: kernel and host loop in turns (kernel, loop, loop,
        # kernel), wall and device time.
        for which in ("propagate", "host_loop", "host_loop", "propagate"):
            fn = fused if which == "propagate" else host_loop
            mean, least = wall_ms(fn, reps)
            t.setdefault(f"{which}_wall_ms", []).append(mean)
            t.setdefault(f"{which}_wall_min_ms", []).append(least)
        t["propagate_ms"] = device_ms(fused, 10, only="label_prop_propagate",
                                      launched=lambda: lp.PROPAGATIONS)
        t["host_loop_ms"] = device_ms(host_loop, 10)
        t["host_loop_sweeps_ms"] = sweep_device_times(
            host_loop, lambda: lp.LAUNCHES)
        t["plain_ms"] = device_ms(lambda: lp.label_propagate_plain(
            normal, centroid, valid, angle, l, k), 3)
        t["plain_wall_ms"] = wall_ms(lambda: lp.label_propagate_plain(
            normal, centroid, valid, angle, l, k), 3)[0]
        # The sweeps the kernel runs and the labels before each (a launch
        # capped at s sweeps): the propagation's bound counts each sweep's
        # operations from those labels, against its bytes (stats and
        # bound read once, labels read and written once, the flags).
        final, n = propagate_once(lp, stats, bound, init, cos_gate, l, k, 32)
        check(torch.equal(final, lp.label_propagate_plain(
            normal, centroid, valid, angle, l, k)), f"{name}: labels differ")
        t["sweeps"] = n
        sweep_bounds = [k1_bound(stats[0], propagate_once(
            lp, stats, bound, init, cos_gate, l, k, s)[0][0], nb, cos_gate)
            for s in range(n)]
        t["sweep_bounds_ms"] = [b[0] for b in sweep_bounds]
        t["halving_bound_ms"] = halving_bound(1, V)
        ops_s = sum(b[2] for b in sweep_bounds) / PEAK_F32
        flag_bytes = 32 * 2 * 4  # (max_iters, P + 1) int32
        bytes_s = (12 * V * 4 + 4 + 2 * V * 4 + flag_bytes) / PEAK_BYTES
        t["propagate_bound_ms"] = max(ops_s, bytes_s) * 1e3
        t["propagate_bound_by"] = "operations" if ops_s >= bytes_s else "bytes"
        # The sweep phase: the kernel's sweeps timed as the host loop's
        # one-sweep launches (their mean, times the kernel's count).
        host = t["host_loop_sweeps_ms"]
        sweep_phase_ms = sum(host) / len(host) * n
        t["sweep_share"] = sweep_phase_ms / t["propagate_ms"]
        t["outside_per_sweep_ms"] = (t["propagate_ms"] - sweep_phase_ms) / n
        times[name] = t
    return {route: max(e) for route, e in errs.items()}, times


def label_rows(rng, P, V):
    """Label rows as label-prop leaves them between sweeps: each valid
    slot points at or below itself, invalid slots hold 2^30."""
    import numpy as np

    rows = (np.arange(V) * rng.uniform(0, 1, (P, V))).astype(np.int32)
    rows[rng.uniform(size=(P, V)) < 0.1] = _BIG
    return rows


def phase_gather_vs_plain(gt, dev):
    import numpy as np
    import torch

    def on(a):
        return torch.from_numpy(a).to(dev)

    # The TPU probe's own inputs: tbl = arange(1024) * 7, random indices.
    tbl = (np.arange(1024, dtype=np.int32) * 7)[None]
    idx = np.random.default_rng(0).integers(0, 1024, 1024).astype(np.int32)[None]
    before = gt.LAUNCHES
    got = gt.gather_rows(on(tbl), on(idx)).cpu().numpy()
    check(gt.LAUNCHES == before + 1, "gather kernel was not launched")
    check(np.array_equal(got, tbl[:, idx[0]]), "gather differs from tbl[idx] "
          "at the probe's inputs")
    errs = [0]

    rng = np.random.default_rng(1)
    times = {}
    for P, V in P1_SHAPES:
        labels = on(label_rows(rng, P, V))
        wild = on(rng.integers(-5, V + 5, (P, V)).astype(np.int32))
        for a, b in ((labels, labels), (labels, wild)):
            got = gt.gather_rows(a, b)
            want = gt.gather_rows_plain(a, b)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            check(err == 0, f"({P}, {V}): gather differs from plain (max {err})")
            errs.append(err)
        # torch.gather alone, on indices already in range: the library
        # call that computes P1's function (the port never calls it here).
        idx = torch.clamp(labels, 0, V - 1).long()
        fns = dict(kernel=lambda: gt.gather_rows(labels, labels),
                   plain=lambda: gt.gather_rows_plain(labels, labels),
                   library=lambda: torch.gather(labels, -1, idx))
        times[(P, V)] = {
            **{f"{k}_call_ms": cuda_ms(fn, 200) for k, fn in fns.items()},
            "kernel_ms": device_ms(fns["kernel"], 10, only="gather_rows_kernel",
                                   launched=lambda: gt.LAUNCHES),
            **{f"{k}_ms": device_ms(fns[k], 10) for k in ("plain", "library")},
        }
    return max(errs), times


def p1_bound(P, V):
    """(bound ms, bound_by) of one gather over (P, V) int32 rows: the
    table and the indices read once, the output written once."""
    return 3 * P * V * 4 / PEAK_BYTES * 1e3, "bytes"


def halving_bound(P, V):
    """ms of one in-place halving round over (P, V) int32 labels: read
    once and written once (the table is the labels themselves)."""
    return 2 * P * V * 4 / PEAK_BYTES * 1e3


@functools.lru_cache(maxsize=None)
def scene(name, seed):
    """(src, tar, T_gt) of bench.CONFIGS[name] for one seed, as
    bench.pairs_for_config makes it."""
    import bench
    from fccf_pcr_torch.io import synthetic

    cfg = bench.CONFIGS[name]
    fams = cfg.get("scenes")  # mixed-family configs: round-robin by seed
    kw = fams[seed % len(fams)] if fams else cfg["scene"]
    return synthetic.make_pair(seed=seed, **kw, **cfg["pair"])


def config_batch(name, seeds, params, caps, dev):
    import numpy as np
    import torch

    from fccf_pcr_torch import pre_downsample
    from fccf_pcr_torch.io import synthetic

    pts, gts = [], []
    for s in seeds:
        src, tar, T_gt = scene(name, s)
        pair = []
        for cloud in (src, tar):
            p, m = synthetic.pad_points(cloud, caps.raw_points)
            d, dm, ovf = pre_downsample(p, m, params, caps, device=dev)
            check(not bool(ovf), f"{name} seed {s}: pre_downsample overflow")
            pair.append((d, dm))
        pts.append(pair)
        gts.append(T_gt)
    args = (
        torch.stack([p[0][0] for p in pts]), torch.stack([p[0][1] for p in pts]),
        torch.stack([p[1][0] for p in pts]), torch.stack([p[1][1] for p in pts]),
    )
    return args, torch.from_numpy(np.stack(gts).astype(np.float64))


def rotation_gap(T, T_ref):
    """(deg, m) between two transforms: the rotation angle from
    |R - R_ref| (2 sqrt(2) sin(angle / 2) for rotations), exactly 0 for
    equal matrices, which the trace form is not for float32 matrices a
    few ulps from orthonormal; and the translations' distance."""
    import math

    import torch

    T, T_ref = (torch.as_tensor(x, dtype=torch.float64) for x in (T, T_ref))
    fro = float(torch.linalg.norm(T[:3, :3] - T_ref[:3, :3]))
    deg = math.degrees(2.0 * math.asin(min(1.0, fro / (2.0 * math.sqrt(2.0)))))
    return deg, float(torch.linalg.norm(T[:3, 3] - T_ref[:3, 3]))


def drift(T, T_ref):
    import torch

    from fccf_pcr_torch import registration_errors

    rre, rte = registration_errors(
        torch.as_tensor(T, dtype=torch.float64),
        torch.as_tensor(T_ref, dtype=torch.float64),
    )
    return float(rre), float(rte)


def zero_counts(counters, dev):
    """Every kernel's launch count, and the propagation kernel's sweeps,
    to 0."""
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    counters["label_prop_propagate"][0].sweep_counter(dev).zero_()


def read_counts(counters, dev):
    """Launch counts by kernel and the propagation kernel's sweeps, read
    after a synchronize."""
    counts = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    counts["sweeps"] = int(
        counters["label_prop_propagate"][0].sweep_counter(dev))
    return counts


def phase_path(name, counters, dev):
    """One config's golden seeds through the batched main path; returns
    each kernel's launch count in that run (counts reset just before) and
    the sweeps the propagation kernel ran, and the wall ms of a second,
    repeated step (which must give bitwise-equal transforms)."""
    import torch

    import bench
    from fccf_pcr_torch import make_register_fn
    from fccf_pcr_torch.models.fccf import get_model
    from fccf_pcr_torch.twin.families import TWIN_BANDS

    model = get_model(bench.CONFIGS[name]["model"])
    rows = json.loads(GOLDEN.read_text())["configs"][name]
    seeds = [r["seed"] for r in rows]
    args, T_gt = config_batch(name, seeds, model.params, model.caps, dev)
    fn = make_register_fn(model.params, model.caps, batched=True, device=dev)

    zero_counts(counters, dev)
    res = fn(*args)
    torch.cuda.synchronize()
    launches = read_counts(counters, dev)
    check(launches["label_prop_propagate"] > 0 and launches["sweeps"] > 0,
          f"the {name} path launched no propagation kernel")
    for k in ("label_prop_sweep", "gather_rows"):
        check(launches[k] == 0, f"the {name} path launched the {k} kernel "
              f"{launches[k]} times (it runs inside the propagation kernel)")

    T = res.transform
    check(T.shape == (len(seeds), 4, 4) and bool(torch.isfinite(T).all()),
          f"{name}: transforms not finite / wrong shape")
    T64 = T.double().cpu()
    gate = bench.GATES[name]
    for k, row in enumerate(rows):
        d_rre, d_rte = drift(T64[k], row["T"])
        g_rre, g_rte = drift(T64[k], T_gt[k])
        status = int(res.status[k])
        kept = res.kept[k].tolist()
        print(
            f"[{name}] seed {row['seed']}: golden drift {d_rre:.5f} deg "
            f"{d_rte:.5f} m | GT {g_rre:.4f} deg {g_rte:.4f} m "
            f"| status {status} (pinned {row['status']}) kept {kept} "
            f"(pinned {row['kept']}) | n_hyp {int(res.n_hypotheses[k])} "
            f"(pinned {row['n_hypotheses']}) n_faces {res.n_faces[k].tolist()} "
            f"(pinned {row['n_faces']}) | quick "
            f"{[round(x, 5) for x in res.quick_score[k].tolist()]} (pinned "
            f"{[round(x, 5) for x in row['quick_score']]}) fine "
            f"{[round(x, 5) for x in res.fine_score[k].tolist()]} (pinned "
            f"{[round(x, 5) for x in row['fine_score']]})",
            flush=True,
        )
        check(d_rre < 0.1 and d_rte < 0.02,
              f"{name} seed {row['seed']}: outside the golden band")
        check(status == row["status"], f"{name} seed {row['seed']}: status differs")
        check(kept == row["kept"], f"{name} seed {row['seed']}: kept mask differs")
        check(g_rre < gate[0] and g_rte < gate[1],
              f"{name} seed {row['seed']}: ground-truth gate failed")
    if name in TWIN_BANDS:
        check_twin_bands(name, seeds, T64)

    # Each pair alone (P = 1) against its batch row.
    single = make_register_fn(model.params, model.caps, device=dev)
    worst = [0.0, 0.0]
    for k, row in enumerate(rows):
        alone = single(*(a[k] for a in args))
        for f in ("status", "kept", "n_hypotheses", "n_faces"):
            check(torch.equal(getattr(alone, f), getattr(res, f)[k]),
                  f"{name} seed {row['seed']}: {f} of the pair alone "
                  "differs from its batch row")
        d = rotation_gap(alone.transform.double().cpu(), T64[k])
        worst = [max(w, x) for w, x in zip(worst, d)]
        check(d[0] <= 1e-3 and d[1] <= 1e-4,
              f"{name} seed {row['seed']}: the pair alone is {d[0]:.3g} deg "
              f"/ {d[1]:.3g} m from its batch row")
    print(f"[{name}] each pair alone (P = 1) matches its batch row: status, "
          f"kept, n_hypotheses and n_faces equal; largest transform "
          f"difference {worst[0]:.3g} deg / {worst[1]:.3g} m (limit 1e-3 deg "
          "/ 1e-4 m)", flush=True)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = fn(*args)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(again.transform, res.transform),
          f"{name}: a repeated run gave different transforms")
    print(f"[{name}] {len(seeds)} pairs inside the golden bands; launches "
          f"{launches}; repeated run bitwise equal, its step "
          f"{step_ms:.1f} ms wall (batch {len(seeds)})", flush=True)
    return launches, step_ms


def check_twin_bands(name, seeds, T64):
    """The batch's transforms against the NumPy twin's cached ones of
    tests/golden/twin_production.json, within TWIN_BANDS[name]."""
    import numpy as np

    from fccf_pcr_torch.twin.families import TWIN_BANDS

    rows = {r["seed"]: r for r in json.loads(TWIN_PRODUCTION.read_text())[
        "rows"] if r["config"] == name}
    band = TWIN_BANDS[name]
    worst = [0.0, 0.0]
    for k, seed in enumerate(seeds):
        r = rows[seed]
        src, tar, _ = scene(name, seed)
        check((len(src), len(tar)) == (r["n_src"], r["n_tar"]),
              f"{name} seed {seed}: scene differs from the twin fixture's")
        d = drift(T64[k], np.reshape(r["T_twin"], (4, 4)))
        worst = [max(w, x) for w, x in zip(worst, d)]
        check(d[0] < band[0] and d[1] < band[1],
              f"{name} seed {seed}: {d[0]:.4f} deg / {d[1]:.5f} m from the "
              f"twin (band {band})")
    print(f"[{name}] seeds {seeds} within the twin-production band {band}: "
          f"worst {worst[0]:.4f} deg / {worst[1]:.5f} m", flush=True)


def phase_unequal(dev):
    """Office seed 0 with the target cut to its valid rows (another N than
    the source's): every field bitwise equal to the equal-N run."""
    import torch

    import bench
    from fccf_pcr_torch import make_register_fn
    from fccf_pcr_torch.models.fccf import get_model

    model = get_model(bench.CONFIGS["office"]["model"])
    (sp, sm, tp, tm), _ = config_batch("office", [0], model.params,
                                       model.caps, dev)
    n = int(tm[0].sum())
    check(bool(tm[0, :n].all()) and n < tm.shape[1],
          "office seed 0: the target's valid rows are not a proper prefix")
    fn = make_register_fn(model.params, model.caps, device=dev)
    equal = fn(sp[0], sm[0], tp[0], tm[0])
    cut = fn(sp[0], sm[0], tp[0, :n], tm[0, :n])
    for f, a, b in zip(equal._fields, equal, cut):
        check(torch.equal(a, b), f"unequal N: {f} differs from the equal-N run")
    print(f"[unequal] office seed 0, source {sp.shape[1]} rows, target cut "
          f"to its {n} valid rows: every field bitwise equal to the equal-N "
          "run", flush=True)


def phase_mesh(dev, counters):
    """The office batch of 8 split over make_mesh([dev] * k) for k = 2 and
    4 and over make_mesh() (every card): every field bitwise equal to the
    unsplit batch, and so for k = 2 from the raw clouds through
    sharded_pre_downsample (run_sweep's mesh path). Step wall times for
    k = 1, 2, 4 in turns (1, 2, 4, 4, 2, 1); sharded_mean_errors against
    ground truth."""
    import numpy as np
    import torch

    import bench
    from fccf_pcr_torch import make_register_fn, registration_errors
    from fccf_pcr_torch.io import synthetic
    from fccf_pcr_torch.models.fccf import get_model
    from fccf_pcr_torch.parallel.mesh import (
        make_mesh, make_sharded_register_fn, sharded_mean_errors,
        sharded_pre_downsample)

    model = get_model(bench.CONFIGS["office"]["model"])
    args, T_gt = config_batch("office", list(range(8)), model.params,
                              model.caps, dev)
    fns = {1: make_register_fn(model.params, model.caps, batched=True,
                               device=dev)}
    meshes = {k: make_mesh([dev] * k) for k in (2, 4)}
    for k, mesh in meshes.items():
        fns[k] = make_sharded_register_fn(model.params, model.caps, mesh)
    whole = fns[1](*args)
    torch.cuda.synchronize()
    every = make_mesh()
    runs = {**{k: (fns[k], f"[{dev}] * {k}") for k in (2, 4)},
            "all": (make_sharded_register_fn(model.params, model.caps, every),
                    f"make_mesh() = {[str(d) for d in every]}")}
    for k, (fn, what) in runs.items():
        zero_counts(counters, dev)
        split = fn(*args)
        torch.cuda.synchronize()
        props = read_counts(counters, dev)["label_prop_propagate"]
        for f, a, b in zip(whole._fields, split, whole):
            check(torch.equal(a, b), f"mesh {what}: {f} differs from the "
                  "unsplit batch")
        n_chunks = len(every) if k == "all" else k
        check(props == 2 * n_chunks, f"mesh {what}: {props} propagation "
              f"launches (want 2 a chunk, {2 * n_chunks})")
        print(f"[mesh] office batch 8 split over {what}: every field bitwise "
              f"equal to the unsplit batch; {props} propagation launches",
              flush=True)
    # The raw clouds downsampled chunk by chunk, each on its own device,
    # and registered where they lie (run_sweep's mesh path).
    chunks = []
    for side in (0, 2):  # sources, then targets
        raw = [synthetic.pad_points(scene("office", s)[side // 2],
                                    model.caps.raw_points) for s in range(8)]
        pts, valid, ovf = sharded_pre_downsample(
            np.stack([r[0] for r in raw]), np.stack([r[1] for r in raw]),
            model.params, model.caps, meshes[2])
        check(not bool(ovf.any()), "mesh: sharded_pre_downsample overflow")
        for got, want in ((pts, args[side]), (valid, args[side + 1])):
            check(torch.equal(torch.cat(got), want), "mesh: a chunk of "
                  "sharded_pre_downsample differs from its clouds alone")
        chunks += [pts, valid]
    split = fns[2](*chunks)
    for f, a, b in zip(whole._fields, split, whole):
        check(torch.equal(a, b), f"mesh sharded_pre_downsample: {f} differs "
              "from the unsplit batch")
    print(f"[mesh] office raw clouds through sharded_pre_downsample over "
          f"[{dev}] * 2: every chunk equal to its clouds downsampled alone, "
          f"every field of the split batch bitwise equal to the unsplit "
          f"batch", flush=True)
    times = collections.defaultdict(list)
    for k in (1, 2, 4, 4, 2, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns[k](*args)
        torch.cuda.synchronize()
        times[k].append((time.perf_counter() - t0) * 1e3)
    # sharded_mean_errors (float32, like the batch) against the same
    # errors of the whole batch on the card; float64 errors for reference.
    rre32, rte32 = registration_errors(whole.transform,
                                       T_gt.float().to(dev))
    rre, rte = registration_errors(whole.transform.double().cpu(), T_gt)
    errs = {k: sharded_mean_errors(whole.transform, T_gt, meshes[k])
            for k in (2, 4)}
    for k, (m_rre, m_rte) in errs.items():
        check(math.isclose(m_rre, float(rre32.mean()), rel_tol=1e-5)
              and math.isclose(m_rte, float(rte32.mean()), rel_tol=1e-5),
              f"mesh [{dev}] * {k}: sharded_mean_errors {m_rre}, {m_rte} "
              f"disagrees with the whole batch's {float(rre32.mean())}, "
              f"{float(rte32.mean())}")
    print(f"[mesh] torch.cuda.device_count() {torch.cuda.device_count()}; "
          f"office batch-8 step wall ms in turns (k = 1, 2, 4, 4, 2, 1): "
          f"k=1 {[round(x, 1) for x in times[1]]}, k=2 "
          f"{[round(x, 1) for x in times[2]]}, k=4 "
          f"{[round(x, 1) for x in times[4]]} (one card listed k times: "
          f"its chunks run in turn); sharded_mean_errors vs ground truth "
          f"{errs} (float32, as the batch; in float64 {float(rre.mean()):.5f} "
          f"deg {float(rte.mean()):.6f} m)", flush=True)


def phase_diff(lp):
    """twin/diff.py on the FAMILIES targets (seed 30, TEST_CAPS): the
    pipeline membership on the card equal to the CPU run's, the
    propagation kernel launched, and the diff's metrics inside
    tests/test_twin_sweep.py's limits. Returns the wall seconds of the
    card-side diffs."""
    import numpy as np

    from fccf_pcr_torch import TEST_CAPS, FCCFParams
    from fccf_pcr_torch.io import synthetic
    from fccf_pcr_torch.twin import diff
    from fccf_pcr_torch.twin.families import FAMILIES

    params = FCCFParams()
    wall = 0.0
    for fam, cfg in FAMILIES.items():
        _, tar, _ = synthetic.make_pair(seed=30, **cfg["scene"], **cfg["pair"])
        cloud = np.asarray(tar, np.float32)
        before = lp.PROPAGATIONS
        on_card = diff._pipeline_membership(cloud, params, TEST_CAPS,
                                            device="cuda")
        check(lp.PROPAGATIONS > before,
              f"diff {fam}: the propagation kernel was not launched")
        on_cpu = diff._pipeline_membership(cloud, params, TEST_CAPS,
                                           device="cpu")
        check(on_card == on_cpu, f"diff {fam}: the card's membership differs "
              "from the CPU's")
        t0 = time.perf_counter()
        res = diff.face_membership_diff(tar, params, TEST_CAPS, device="cuda")
        wall += time.perf_counter() - t0
        check(res["pair_agreement"] > 0.98 and res["matched_fraction"] > 0.95,
              f"diff {fam}: {res}")
        print(f"[diff] {fam} seed 30 target: card membership == CPU "
              f"membership ({len(on_card)} cells); {res}", flush=True)
    print(f"[diff] {len(FAMILIES)} face_membership_diff calls on the card: "
          f"{wall:.2f} s wall", flush=True)
    return wall


def run_cli(args, what):
    """``python -m fccf_pcr_torch ARGS`` from the repo root; its stdout."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fccf_pcr_torch", *args], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600,
    )
    check(proc.returncode == 0, f"CLI {what} exited {proc.returncode}:\n"
          f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    return proc.stdout, time.perf_counter() - t0


def phase_cli():
    import numpy as np

    import bench
    from fccf_pcr_torch.io import ply
    from fccf_pcr_torch.models.fccf import get_model

    row = json.loads(GOLDEN.read_text())["configs"]["heritage"][0]
    with tempfile.TemporaryDirectory() as tmp:
        src, tar, _ = scene("heritage", row["seed"])
        paths = [os.path.join(tmp, f"heritage_{k}.ply") for k in "st"]
        for path, cloud in zip(paths, (src, tar)):
            ply.write_ply(path, cloud)
        params = get_model("heritage").params
        out, dt = run_cli(
            [*paths, f"{params.leaf_size:g}", "--caps", "heritage",
             "--set", f"face_voxel_size={params.face_voxel_size:g}",
             "--device", "cuda", "--json"], "heritage pair")
        rec = json.loads(out.strip().splitlines()[-1])
        d_rre, d_rte = drift(rec["transform"], row["T"])
        print(f"[cli] heritage seed {row['seed']}: {dt:.1f} s, golden drift "
              f"{d_rre:.5f} deg {d_rte:.5f} m, status {rec['status']} "
              f"(pinned {row['status']}), n_hyp {rec['n_hypotheses']} (pinned "
              f"{row['n_hypotheses']})", flush=True)
        check(rec["device"] == "cuda", "CLI record not from the card")
        check(d_rre < 0.1 and d_rte < 0.02, "CLI heritage: outside the golden band")
        check(rec["status"] == row["status"], "CLI heritage: status differs")

        src, tar, T_gt = scene("resso", 0)
        paths = [os.path.join(tmp, f"resso_{k}.ply") for k in "st"]
        for path, cloud in zip(paths, (src, tar)):
            ply.write_ply(path, cloud)
        jsonl = os.path.join(tmp, "sweep.jsonl")
        out, dt = run_cli(["--batch", *paths, "--out", jsonl, "--caps", "auto",
                           "--device", "cuda"], "resso sweep")
        summary = json.loads(out.strip().splitlines()[-1])
        with open(jsonl) as f:
            lines = [json.loads(line) for line in f]
        check(summary.get("out") == jsonl and summary["summary"]["n_pairs"] == 1,
              f"CLI sweep: unexpected summary {summary}")
        check(len(lines) == 2 and lines[0].get("pair") == 0
              and lines[-1] == {"summary": summary["summary"]},
              "CLI sweep: records / summary missing from the JSONL")
        rec = lines[0]
        g_rre, g_rte = drift(rec["transform"], T_gt)
        gate = bench.GATES["resso"]
        print(f"[cli] resso seed 0 sweep (--caps auto): {dt:.1f} s, GT "
              f"{g_rre:.4f} deg {g_rte:.4f} m, status {rec['status']}, "
              f"escalated {rec.get('escalated', False)}, summary "
              f"{summary['summary']}", flush=True)
        check(np.isfinite(np.asarray(rec["transform"])).all(),
              "CLI sweep: transform not finite")
        check(g_rre < gate[0] and g_rte < gate[1], "CLI sweep: GT gate failed")


def count_syncs(fn, *args):
    """Host syncs in one call of ``fn``: the warnings that
    torch.cuda.set_sync_debug_mode("warn") raises, one per synchronizing
    call (a copy to or from the host, a tensor read as a Python value),
    counted by the source line that made the call."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
        if "called a synchronizing" in str(w.message))


def count_kernels(fn, *args):
    """Kernels launched on the card by one call of ``fn`` (torch.profiler,
    CUDA activity only; ``record_count``)."""
    return record_count(lambda: fn(*args))


def phase_timing(name, dev, counters, batch=8, reps=2):
    """Steady-state step time at ``batch`` pairs, each kernel's launches
    per step and the propagation kernel's sweeps per step (the counts of
    the timed steps over ``reps``), the peak device memory of those
    steps, and, in one more step each, the host syncs and every kernel
    launched."""
    import torch

    import bench
    from fccf_pcr_torch import make_register_fn
    from fccf_pcr_torch.models.fccf import get_model

    model = get_model(bench.CONFIGS[name]["model"])
    args, _ = config_batch(name, list(range(batch)), model.params, model.caps,
                           dev)
    fn = make_register_fn(model.params, model.caps, batched=True, device=dev)
    res = fn(*args)  # warm up
    torch.cuda.synchronize()
    check(bool((res.status == 0).all()), f"{name} timing batch: non-zero status")
    del res
    zero_counts(counters, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    per_step = {k: n / reps for k, n in read_counts(counters, dev).items()}
    per_step["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    per_step["peak_bytes_over_inputs"] = per_step["peak_bytes"] - base
    per_step["host_sync_lines"] = count_syncs(fn, *args)
    per_step["host_syncs"] = sum(per_step["host_sync_lines"].values())
    per_step["kernel_launches"] = count_kernels(fn, *args)
    return batch / dt, dt, per_step, (fn, args)


def phase_profile(fn, args):
    """One heritage step under utils.profiling.trace (its Chrome trace
    must name the propagation kernel) and a StageTimer."""
    import torch

    from fccf_pcr_torch.utils.profiling import StageTimer, trace

    timer = StageTimer()
    with tempfile.TemporaryDirectory() as logdir:
        with trace(logdir) as prof:
            t0 = time.perf_counter()
            with timer.stage("heritage batch-8 step") as live:
                live.append(fn(*args))
            wall_ms = (time.perf_counter() - t0) * 1e3
        text = pathlib.Path(prof.trace_path).read_text()
        check("label_prop_propagate" in text,
              "the exported trace does not name label_prop_propagate")
        print(f"[profile] trace exported by utils.profiling.trace: "
              f"{os.path.basename(prof.trace_path)}, {len(text)} bytes, "
              f"names label_prop_propagate", flush=True)
    print(f"[profile] StageTimer report:\n{timer.report()}", flush=True)
    stages = ("downsample", "faces", "hypotheses", "cluster", "quick_verify",
              "refine", "fine_verify")
    # Device work = the kernels' own time (one stream, so no overlap);
    # the stage ranges also appear on the device timeline and are skipped.
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in stages]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    print(f"[profile] heritage step {wall_ms:.1f} ms wall, {len(kernels)} "
          f"kernels, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%)", flush=True)
    for e in prof.key_averages():
        if e.key in stages and e.cpu_time_total > 0:
            print(f"[profile] stage {e.key}: {e.cpu_time_total / 1e3:.1f} ms "
                  f"host-inclusive over {e.count} calls", flush=True)
    by_name = collections.Counter()
    calls = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.device_time
        calls[e.name] += 1
    for name, us in by_name.most_common(8):
        print(f"[profile] kernel {us / 1e3:.1f} ms over {calls[name]} "
              f"launches: {name[:90]}", flush=True)
    for ours in ("label_prop_propagate_kernel", "label_prop_sweep_kernel",
                 "gather_rows"):
        for name, us in by_name.items():
            if ours in name:
                print(f"[profile] {ours}: {us / 1e3:.2f} ms of device time "
                      f"over {calls[name]} launches in the step", flush=True)


def main():
    sys.path.insert(0, str(ROOT))
    try:
        import numpy  # noqa: F401
        import torch

        import bench  # noqa: F401
        from fccf_pcr_torch.ops import cuda_build
        from fccf_pcr_torch.ops import gather as gt
        from fccf_pcr_torch.ops import label_prop as lp
    except ImportError as e:
        print(f"FAIL: cannot import the port from {ROOT}: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke run "
              "needs a CUDA card", file=sys.stderr)
        return 1

    counters = {"label_prop_propagate": (lp, "PROPAGATIONS"),
                "label_prop_sweep": (lp, "LAUNCHES"),
                "gather_rows": (gt, "LAUNCHES")}
    try:
        dev = torch.device("cuda:0")
        smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"])
        print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
              f"cuda {torch.version.cuda} nvcc: "
              f"{run([cuda_build.nvcc(), '--version'])}", flush=True)
        print(f"[env] device {torch.cuda.get_device_name(0)} "
              f"(count {torch.cuda.device_count()}) | {smi}", flush=True)

        t_start = time.perf_counter()
        secs = phase_build([lp, gt])
        print(f"[build] label_prop.cu {secs[0]:.2f} s, gather.cu {secs[1]:.2f} s "
              f"(in parallel, {time.perf_counter() - t_start:.2f} s)", flush=True)
        ptxas = {"label_prop_propagate": ptxas_summary(lp, "propagate_kernel"),
                 "label_prop_sweep": ptxas_summary(lp, "sweep_kernel"),
                 "gather_rows": ptxas_summary(gt)}
        for name, info in ptxas.items():
            check(info, f"no ptxas lines for {name}")
            print(f"[build] ptxas {name}: {info}", flush=True)

        lp_err, k1 = phase_kernel_vs_plain(lp, dev)
        print("[kernel] labels of the propagation kernel and of the host loop "
              "(K1 + P1 launches) equal to plain at V=1536, V=1000 and V=9216 "
              "(batch 2), at every edge case and at the main path's pass-1 "
              "inputs", flush=True)
        for name, t in k1.items():
            print(f"[kernel] K1 {name} pass-1 inputs (seed 0 target, V={t['V']}, "
                  f"bound {t['bound']}): one sweep {t['sweep_ms']:.4f} ms of "
                  f"device time ({t['sweep_call_ms']:.4f} ms a call with the "
                  f"wrapper) vs plain {t['plain_sweep_ms']:.4f} ms; sweep "
                  f"bound {t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}: "
                  f"{t['normal_pairs']} pairs need the normal test, "
                  f"{t['plane_pairs']} of them the plane test, {t['ops']} "
                  f"ops; both tests on all {t['bound']}^2 pairs: "
                  f"{t['full_bound_ms'] * 1e3:.2f} us), roofline share "
                  f"{100 * t['bound_ms'] / t['sweep_ms']:.2f}%, achieved "
                  f"{t['ops'] / t['sweep_ms'] / 1e9:.3f} TFLOP/s "
                  f"| ptxas {ptxas['label_prop_sweep']} | {smi}", flush=True)
            host = t["host_loop_sweeps_ms"]
            print(f"[kernel] propagation {name} pass 1: kernel "
                  f"{t['propagate_ms']:.4f} ms device, {t['sweeps']} sweeps, "
                  f"wall {[round(x, 4) for x in t['propagate_wall_ms']]} ms "
                  f"(least {[round(x, 4) for x in t['propagate_wall_min_ms']]}"
                  f"); host loop {t['host_loop_ms']:.4f} ms device ("
                  f"{len(host)} sweeps of {[round(x, 4) for x in host]} ms), "
                  f"wall {[round(x, 4) for x in t['host_loop_wall_ms']]} ms "
                  f"(least {[round(x, 4) for x in t['host_loop_wall_min_ms']]}"
                  f"), turns kernel, loop, loop, kernel; plain "
                  f"{t['plain_ms']:.3f} ms device, {t['plain_wall_ms']:.3f} ms "
                  f"wall; sweep phase {100 * t['sweep_share']:.1f}% of the "
                  f"kernel's device time, outside it "
                  f"{t['outside_per_sweep_ms'] * 1e3:.2f} us a sweep (halving "
                  f"bound {t['halving_bound_ms'] * 1e3:.4f} us a round); "
                  f"bound {t['propagate_bound_ms'] * 1e3:.3f} us "
                  f"({t['propagate_bound_by']}; sweeps "
                  f"{[round(x * 1e3, 3) for x in t['sweep_bounds_ms']]} us) | "
                  f"ptxas {ptxas['label_prop_propagate']} | {smi}", flush=True)

        p1_err, p1 = phase_gather_vs_plain(gt, dev)
        print("[gather] equal to tbl[idx] at the probe's inputs (1, 1024) and "
              "to plain at (1, 1536), (1, 9216), (8, 9216)", flush=True)
        for (P, V), t in p1.items():
            b_ms, _ = p1_bound(P, V)
            print(f"[gather] ({P}, {V}) device time: {t['kernel_ms'] * 1e3:.2f} "
                  f"us vs plain {t['plain_ms'] * 1e3:.2f} us, torch.gather "
                  f"alone {t['library_ms'] * 1e3:.2f} us; a call with its "
                  f"wrapper: {t['kernel_call_ms'] * 1e3:.2f} / "
                  f"{t['plain_call_ms'] * 1e3:.2f} / "
                  f"{t['library_call_ms'] * 1e3:.2f} us; bound "
                  f"{b_ms * 1e3:.3f} us (bytes) | {smi}", flush=True)

        launches = collections.Counter()
        path_ms = {}
        for name in PATH_CONFIGS:
            counts, path_ms[name] = phase_path(name, counters, dev)
            launches.update(counts)
        print(f"[paths] repeated-step wall ms by config: {path_ms} | {smi}",
              flush=True)
        phase_unequal(dev)

        phase_cli()

        step = None
        per_step = {}
        for name in ("office", "heritage"):
            pps, dt, per_step[name], step = phase_timing(name, dev, counters)
            t = per_step[name]
            check(t["label_prop_sweep"] == 0 and t["gather_rows"] == 0,
                  f"{name} timing: one-sweep or gather kernel launched")
            check(0 < t["label_prop_propagate"] <= 4,
                  f"{name} timing: {t['label_prop_propagate']} propagation "
                  "launches a step (at most 4)")
            print(f"[timing] {name} batch 8: {dt * 1e3:.1f} ms/step, "
                  f"{pps:.2f} pairs/s; per step: {t['kernel_launches']} "
                  f"kernel launches, {t['label_prop_propagate']:g} "
                  f"propagation launches ({t['sweeps']:g} sweeps), "
                  f"{t['label_prop_sweep']:g} one-sweep and "
                  f"{t['gather_rows']:g} gather launches, "
                  f"{t['host_syncs']} host syncs "
                  f"({dict(t['host_sync_lines'].most_common())}), peak "
                  "device memory "
                  f"{t['peak_bytes'] / 2**30:.3f} GiB "
                  f"({t['peak_bytes_over_inputs'] / 2**30:.3f} GiB over the "
                  f"step's inputs) | {smi} | torch {torch.__version__} "
                  f"cuda {torch.version.cuda}", flush=True)
        phase_mesh(dev, counters)
        print(f"[mesh] {smi}", flush=True)
        phase_diff(lp)
        print(f"[diff] {smi}", flush=True)
        phase_profile(*step)
        print(f"[done] {time.perf_counter() - t_start:.1f} s after the build "
              f"started; torch.profiler captures taken again for dropped "
              f"records: {dict(RETAKEN)}", flush=True)
    except Exception:  # any failed phase fails the run
        traceback.print_exc()
        print("FAIL", file=sys.stderr)
        return 1

    her = k1["heritage"]
    g = p1[(1, 9216)]
    p1_bound_ms, p1_bound_by = p1_bound(1, 9216)

    def per_step_of(k):
        return {name: v[k] for name, v in per_step.items()}

    print(json.dumps({"kernels": [
        dict(KERNELS["label_prop_propagate"],
             launches=launches["label_prop_propagate"],
             max_abs_err=lp_err["propagate"], ms=her["propagate_ms"],
             plain_ms=her["plain_ms"], bound_ms=her["propagate_bound_ms"],
             bound_by=her["propagate_bound_by"], library_ms=None,
             sweeps=her["sweeps"], sweeps_on_main_path=launches["sweeps"],
             launches_per_step=per_step_of("label_prop_propagate"),
             sweeps_per_step=per_step_of("sweeps"),
             step_kernel_launches=per_step_of("kernel_launches"),
             step_host_syncs=per_step_of("host_syncs"),
             step_peak_bytes=per_step_of("peak_bytes"),
             wall_ms=her["propagate_wall_ms"],
             host_loop_wall_ms=her["host_loop_wall_ms"],
             host_loop_ms=her["host_loop_ms"],
             outside_sweep_phase_us_per_sweep=her["outside_per_sweep_ms"] * 1e3,
             sweep_phase_share=her["sweep_share"],
             halving_bound_us=her["halving_bound_ms"] * 1e3,
             plain_wall_ms=her["plain_wall_ms"],
             ptxas=ptxas["label_prop_propagate"],
             shape=f"one propagation, heritage seed 0 pass 1 (V={her['V']}, "
                   f"bound {her['bound']}); ms device time of the kernel, "
                   "plain_ms the plain version's device time"),
        dict(KERNELS["label_prop_sweep"], launches=launches["label_prop_sweep"],
             max_abs_err=lp_err["host loop"], ms=her["sweep_ms"],
             plain_ms=her["plain_sweep_ms"], bound_ms=her["bound_ms"],
             bound_by=her["bound_by"], library_ms=None,
             bound_us=her["bound_ms"] * 1e3,
             launches_per_step=per_step_of("label_prop_sweep"),
             call_ms=her["sweep_call_ms"],
             ptxas=ptxas["label_prop_sweep"],
             shape=f"one sweep, heritage seed 0 pass 1 (V={her['V']}, "
                   f"bound {her['bound']}), from the initial labels; ms "
                   "device time; off the main path"),
        dict(KERNELS["gather_rows"], launches=launches["gather_rows"],
             max_abs_err=p1_err, ms=g["kernel_ms"], plain_ms=g["plain_ms"],
             bound_ms=p1_bound_ms, bound_by=p1_bound_by,
             library_ms=g["library_ms"], call_ms=g["kernel_call_ms"],
             bound_us=p1_bound_ms * 1e3,
             launches_per_step=per_step_of("gather_rows"),
             ptxas=ptxas["gather_rows"],
             shape="(1, 9216) int32; ms device time; off the main path"),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
