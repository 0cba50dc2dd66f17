#!/usr/bin/env python3
"""A/B of the label-prop sweep kernel (K1) before and after its tiled
grid, on one CUDA card, in one process: the older source given by path
against the port's ``fccf_pcr_torch/csrc/label_prop.cu``.

    git show b73f610:fccf_pcr_torch/csrc/label_prop.cu > smoke_checkout/k1_old.cu
    python3 tools/torch_k1_ab.py --old-source smoke_checkout/k1_old.cu [--out FILE]

The old source (as at commit b73f610) exports the entry point without
tile arguments, ``fccf_label_prop_sweep(stats, bound, labels, changed, P,
V, cos_gate, l, k, stream)``: one block of 64 rows walks every j-chunk.
Both are built with the port's nvcc flags. The old kernel runs through
the package's own loop (``ops/label_prop.py::_label_propagate_kernel``)
with ``_launch_sweep`` swapped for it. At the main path's own pass-1
inputs (seed 0's target cloud at the office and heritage presets, as
chip_smoke.py phase 3 takes them), both propagations must give labels
equal to the plain version; then one sweep from the initial labels and a
whole propagation are timed for each in turns (old, new, new, old), on the
same inputs. Prints one line per measurement with the card's name and
power limit, then the results as one JSON line (also written to ``--out``
when given). Exits non-zero without a card.
"""

import argparse
import contextlib
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def build_old(source):
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
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_float] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, proc.stdout + proc.stderr


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
    """One propagation of the package's loop around ``sweep``."""
    with swapped(lp, sweep):
        return lp._label_propagate_kernel(normal, centroid, valid, angle, l,
                                          k, bound, max_iters=32)


def sweep_device_times(lp, sweep, *args):
    """Device ms of each sweep of one propagation (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        propagate(lp, sweep, *args)
        torch.cuda.synchronize()
    return [e.device_time / 1e3 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "label_prop_sweep" in e.name]


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
    old_lib, old_log = build_old(args.old_source)
    print(f"[ab] device {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    print(f"[ab] ptxas new: {cs.ptxas_summary(lp)}", flush=True)
    print("[ab] ptxas old: " + " | ".join(
        ln.split("ptxas info    : ")[-1].strip() for ln in old_log.splitlines()
        if "ptxas info" in ln and ("Used" in ln or "spill" in ln)), flush=True)

    def old_sweep(stats, bound, labels, changed, cos_gate, l, k):
        P, V = labels.shape
        rc = old_lib.fccf_label_prop_sweep(
            stats.data_ptr(), bound.data_ptr(), labels.data_ptr(),
            changed.data_ptr(), P, V, cos_gate, float(l), float(k),
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
        for which, sweep in sweeps.items():
            got = propagate(lp, sweep, normal, centroid, valid, angle, l, k,
                            bound)
            cs.check(torch.equal(got, want),
                     f"{name}: the {which} kernel's labels differ from plain")
        stats = lp._pack_stats(normal, centroid, valid)
        init = torch.where(valid, torch.arange(V, dtype=torch.int32,
                                               device=dev), lp._BIG).contiguous()
        labels = init.clone()
        changed = torch.zeros(1, dtype=torch.int32, device=dev)
        cos_gate = lp.cos_deg(angle)
        rows = []
        for which in ("old", "new", "new", "old"):
            sweep = sweeps[which]
            one = lambda: sweep(stats, bound, labels, changed, cos_gate, l, k)  # noqa: E731
            reset = lambda: labels.copy_(init)  # noqa: E731
            sweep_ms = cs.cuda_ms(one, reps, reset=reset)
            sweep_dev_ms = cs.device_ms(one, reps, reset=reset)
            prop_ms = cs.cuda_ms(lambda: propagate(
                lp, sweep, normal, centroid, valid, angle, l, k, bound), reps)
            per_sweep = sweep_device_times(lp, sweep, normal, centroid,
                                           valid, angle, l, k, bound)
            rows.append(dict(kernel=which, sweep_ms=sweep_ms,
                             sweep_device_ms=sweep_dev_ms,
                             propagation_ms=prop_ms,
                             sweeps_device_ms=per_sweep))
            print(f"[ab] {name} pass 1 (V={V}, bound {int(bound[0])}): "
                  f"{which} sweep {sweep_dev_ms:.4f} ms device "
                  f"({sweep_ms:.4f} ms between events), propagation "
                  f"{prop_ms:.3f} ms ({len(per_sweep)} sweeps, device ms "
                  f"each {[round(x, 4) for x in per_sweep]}) | {smi}",
                  flush=True)
        results[name] = dict(V=V, bound=int(bound[0]), runs=rows)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
