#!/usr/bin/env python3
"""A/B of label propagation on one CUDA card, in one process: the
label-prop sweep kernel (K1) before and after its tiled grid, both driven
by the per-sweep host loop (the older source given by path against the
port's ``fccf_pcr_torch/csrc/label_prop.cu``), and the port's propagation
kernel (one launch a propagation, no host sync) as a third arm.

    git show b73f610:fccf_pcr_torch/csrc/label_prop.cu > smoke_checkout/k1_old.cu
    python3 tools/torch_k1_ab.py --old-source smoke_checkout/k1_old.cu [--out FILE]

The old source (as at commit b73f610) exports the entry point without
tile arguments, ``fccf_label_prop_sweep(stats, bound, labels, changed, P,
V, cos_gate, l, k, stream)``: one block of 64 rows walks every j-chunk.
A source from commit e77b891 on, whose entry takes the slice width BJ
after V (``int V, int BJ`` in its text), gets the width the port's grid
picks:

    git show e77b891:fccf_pcr_torch/csrc/label_prop.cu > smoke_checkout/k1_pr3.cu
    python3 tools/torch_k1_ab.py --old-source smoke_checkout/k1_pr3.cu
Both are built with the port's nvcc flags. The old kernel runs through
the package's per-sweep host loop
(``ops/label_prop.py::_label_propagate_host_loop``) with ``_launch_sweep``
swapped for it. At the main path's own pass-1 inputs (seed 0's target
cloud at the office and heritage presets, as chip_smoke.py phase 3 takes
them), all three propagations must give labels equal to the plain
version; then, in turns (old, new, fused, fused, new, old) on the same
inputs, one sweep from the initial labels (old and new) and a whole
propagation are timed for each arm. Prints one line per measurement with
the card's name and power limit, then the results as one JSON line (also
written to ``--out`` when given). Exits non-zero without a card.
"""

import argparse
import contextlib
import ctypes
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def build_old(source):
    """The old source's library, and whether its entry takes BJ."""
    from fccf_pcr_torch.ops import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = cuda_build.BUILD_DIR / "libk1_ab_old.so"
    cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(path),
           str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(path))
    fn = lib.fccf_label_prop_sweep
    tiled = "int V, int BJ" in source.read_text()
    ints = 3 if tiled else 2  # P, V and, tiled, BJ
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * ints + [
        ctypes.c_float] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, proc.stdout + proc.stderr, tiled


@contextlib.contextmanager
def swapped(lp, sweep):
    """Context in which the package's loop launches ``sweep``."""
    new = lp._launch_sweep
    lp._launch_sweep = sweep
    try:
        yield
    finally:
        lp._launch_sweep = new


def propagate(lp, sweep, normal, centroid, valid, angle, l, k, bound):
    """One propagation of the package's host loop around ``sweep``."""
    with swapped(lp, sweep):
        return lp._label_propagate_host_loop(normal, centroid, valid, angle,
                                             l, k, bound, max_iters=32)


def host_breakdown(lp, normal, centroid, valid, angle, l, k, bound, reps):
    """Host ms of each step of one ``label_propagate`` call on the card
    (the card idle before each; no step waits for the card): the
    kernel's inputs, the flags, the cos gate, the wrapper's launch, the C
    entry alone, and the whole call."""
    import torch

    stats, bound_t, init = lp._kernel_inputs(normal, centroid, valid, bound)
    P, V = init.shape
    dev = init.device
    lib = lp.build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    BJ, _, _ = lp.sweep_grid(V, lp._sm_count(dev))
    cos_gate = lp.cos_deg(angle)
    sweeps = torch.zeros((1,), dtype=torch.int64, device=dev)

    def fresh():
        return (init.clone(),
                torch.zeros((32, P + 1), dtype=torch.int32, device=dev))

    def c_entry(labels, flags):
        lib.fccf_label_prop_propagate(
            stats.data_ptr(), bound_t.data_ptr(), labels.data_ptr(),
            flags.data_ptr(), sweeps.data_ptr(), P, V, BJ, cos_gate,
            float(l), float(k), 32, 1, stream)

    steps = {
        "inputs": (lambda _: lp._kernel_inputs(normal, centroid, valid,
                                                bound), None),
        "flags": (lambda _: torch.zeros((32, P + 1), dtype=torch.int32,
                                        device=dev), None),
        "cos_gate": (lambda _: lp.cos_deg(angle), None),
        "launch": (lambda a: lp._launch_propagate(
            stats, bound_t, a[0], a[1], sweeps, cos_gate, l, k, 32), fresh),
        "c_entry": (lambda a: c_entry(*a), fresh),
        "label_propagate": (lambda _: lp.label_propagate(
            normal, centroid, valid, angle, l, k, bound=bound), None),
    }
    out = {}
    for name, (fn, make) in steps.items():
        times = []
        for _ in range(reps + 1):
            arg = make() if make is not None else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(arg)
            times.append(time.perf_counter() - t0)
        out[name] = sum(times[1:]) / reps * 1e3  # the first warms up
    torch.cuda.synchronize()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-source", required=True, type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from fccf_pcr_torch.ops import label_prop as lp

    dev = torch.device("cuda:0")
    smi = cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"])
    lp.build(force=True)
    old_lib, old_log, old_tiled = build_old(args.old_source)
    print(f"[ab] device {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    print(f"[ab] ptxas new: sweep {cs.ptxas_summary(lp, 'sweep_kernel')}; "
          f"propagate {cs.ptxas_summary(lp, 'propagate_kernel')}", flush=True)
    print("[ab] ptxas old: " + " | ".join(
        ln.split("ptxas info    : ")[-1].strip() for ln in old_log.splitlines()
        if "ptxas info" in ln and ("Used" in ln or "spill" in ln)), flush=True)

    def old_sweep(stats, bound, labels, changed, cos_gate, l, k):
        P, V = labels.shape
        width = [lp.sweep_grid(V, lp._sm_count(dev))[0]] if old_tiled else []
        rc = old_lib.fccf_label_prop_sweep(
            stats.data_ptr(), bound.data_ptr(), labels.data_ptr(),
            changed.data_ptr(), P, V, *width, cos_gate, float(l), float(k),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"old kernel launch failed: CUDA error {rc}")

    sweeps = {"old": old_sweep, "new": lp._launch_sweep}
    results = {"device": torch.cuda.get_device_name(0), "smi": smi}
    for name, reps in (("office", 50), ("heritage", 20)):
        normal, centroid, valid, angle, l, k, bound = cs.main_path_k1_inputs(
            name, dev)
        V = valid.shape[1]
        want = lp.label_propagate_plain(normal, centroid, valid, angle, l, k)

        def fused():
            return lp.label_propagate(normal, centroid, valid, angle, l, k,
                                      bound=bound)

        for which, sweep in sweeps.items():
            got = propagate(lp, sweep, normal, centroid, valid, angle, l, k,
                            bound)
            cs.check(torch.equal(got, want),
                     f"{name}: the {which} kernel's labels differ from plain")
        cs.check(torch.equal(fused(), want),
                 f"{name}: the propagation kernel's labels differ from plain")
        stats = lp._pack_stats(normal, centroid, valid)
        init = torch.where(valid, torch.arange(V, dtype=torch.int32,
                                               device=dev), lp._BIG).contiguous()
        labels = init.clone()
        changed = torch.zeros(1, dtype=torch.int32, device=dev)
        cos_gate = lp.cos_deg(angle)
        rows = []
        for which in ("old", "new", "fused", "fused", "new", "old"):
            if which == "fused":
                counter = lp.sweep_counter(dev)
                counter.zero_()
                fused()
                torch.cuda.synchronize()
                n = int(counter)
                prop_ms = cs.cuda_ms(fused, reps)
                prop_wall_ms, _ = cs.wall_ms(fused, reps)
                prop_dev_ms = cs.device_ms(fused, reps,
                                           only="label_prop_propagate")
                rows.append(dict(kernel=which, propagation_ms=prop_ms,
                                 propagation_wall_ms=prop_wall_ms,
                                 propagation_device_ms=prop_dev_ms, sweeps=n))
                print(f"[ab] {name} pass 1 (V={V}, bound {int(bound[0])}): "
                      f"fused propagation {prop_dev_ms:.4f} ms device, "
                      f"{prop_ms:.4f} ms between events, {prop_wall_ms:.4f} "
                      f"ms wall ({n} sweeps) | {smi}", flush=True)
                continue
            sweep = sweeps[which]
            one = lambda: sweep(stats, bound, labels, changed, cos_gate, l, k)  # noqa: E731
            reset = lambda: labels.copy_(init)  # noqa: E731
            sweep_ms = cs.cuda_ms(one, reps, reset=reset)
            sweep_dev_ms = cs.device_ms(one, reps, reset=reset)
            def loop():
                return propagate(lp, sweep, normal, centroid, valid, angle, l,
                                 k, bound)

            prop_ms = cs.cuda_ms(loop, reps)
            prop_wall_ms, _ = cs.wall_ms(loop, reps)
            per_sweep = cs.sweep_device_times(loop)
            rows.append(dict(kernel=which, sweep_ms=sweep_ms,
                             sweep_device_ms=sweep_dev_ms,
                             propagation_ms=prop_ms,
                             propagation_wall_ms=prop_wall_ms,
                             sweeps_device_ms=per_sweep))
            print(f"[ab] {name} pass 1 (V={V}, bound {int(bound[0])}): "
                  f"{which} sweep {sweep_dev_ms:.4f} ms device "
                  f"({sweep_ms:.4f} ms between events), host-loop "
                  f"propagation {prop_ms:.3f} ms between events, "
                  f"{prop_wall_ms:.3f} ms wall ({len(per_sweep)} sweeps, "
                  f"device ms each {[round(x, 4) for x in per_sweep]}) | "
                  f"{smi}", flush=True)
        host = host_breakdown(lp, normal, centroid, valid, angle, l, k,
                              bound, reps)
        print(f"[ab] {name} host ms of one label_propagate call, by step: "
              f"{ {k: round(v, 4) for k, v in host.items()} } | {smi}",
              flush=True)
        results[name] = dict(V=V, bound=int(bound[0]), runs=rows,
                             host_ms=host)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
