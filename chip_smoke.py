#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fccf_pcr_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and prints no result:

  1. environment: torch / CUDA / nvcc versions and the card's name and
     power limit (nvidia-smi); no card -> fail (never a CPU fallback);
  2. build the label-propagation kernel (csrc/label_prop.cu) with nvcc;
  3. kernel vs its plain PyTorch version on the card: clustered voxel
     stats at V=1536 (office) and V=1000 (a tail), batch 2 (a pass-1
     prefix bound and a small pass-2 bound); labels must be equal;
  4. the main path at the full eth-office preset: bench.CONFIGS["office"]
     scenes for seeds 0-3 -> pre_downsample -> batched register_pair on
     the card, held to the office rows of tests/golden/pipeline.json
     (transform within 0.1 deg / 0.02 m, status and kept mask equal) and
     to bench.GATES["office"] against ground truth; the kernel's launch
     count must grow; a second run must give bitwise-equal transforms;
  5. steady-state step time at batch 8 (build excluded), in pairs/s;
  6. one batch-8 step under torch.profiler: host time per stage
     (register.py's record_function scopes), the device's busy share of
     the step, and the kernels with the most device time.

Then one JSON line describing the kernel, the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""


import collections
import json
import pathlib
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "pipeline.json"
KERNEL = dict(
    name="label_prop_sweep",
    route="cuda",
    source="fccf_pcr_torch/csrc/label_prop.cu",
    replaces="fccf_pcr_tpu/ops/pallas/label_prop.py:72",
)


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


def cuda_ms(fn, reps):
    import torch

    fn()  # warm up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel_vs_plain(lp, dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    errs = []
    for V, bounds in ((1536, (1019, 97)), (1000, (1000, 61))):
        stats = [clustered(rng, V, prefix=b) for b in bounds]
        normal, centroid, valid = (
            torch.from_numpy(np.stack([s[k] for s in stats])).to(dev)
            for k in range(3)
        )
        bound = torch.tensor(bounds, dtype=torch.int32, device=dev)
        before = lp.LAUNCHES
        got = lp.label_propagate(normal, centroid, valid, 5.0, 0.5, 5.0,
                                 bound=bound)
        torch.cuda.synchronize()
        check(lp.LAUNCHES > before, "kernel was not launched")
        want = lp.label_propagate_plain(normal, centroid, valid, 5.0, 0.5, 5.0)
        err = int((got.long() - want.long()).abs().max())
        check(err == 0, f"V={V}: kernel labels differ from plain (max {err})")
        errs.append(err)
        check(len(torch.unique(got[0][valid[0]])) >= 2, "no components formed")

    # Time at the main path's pass-1 shape: one cloud, V=1536, office bound.
    normal, centroid, valid = (
        torch.from_numpy(a)[None].to(dev)
        for a in clustered(rng, 1536, prefix=1019)
    )
    bound = torch.tensor([1019], dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: lp.label_propagate(
        normal, centroid, valid, 5.0, 0.5, 5.0, bound=bound), 20)
    plain_ms = cuda_ms(lambda: lp.label_propagate_plain(
        normal, centroid, valid, 5.0, 0.5, 5.0), 20)
    stats = lp._pack_stats(normal, centroid, valid)
    labels = torch.where(valid, torch.arange(1536, dtype=torch.int32,
                                             device=dev), 2**30).contiguous()
    changed = torch.zeros(1, dtype=torch.int32, device=dev)
    sweep_ms = cuda_ms(lambda: lp._launch_sweep(
        stats, bound, labels, changed, lp.cos_deg(5.0), 0.5, 5.0), 50)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, sweep_ms=sweep_ms)


def office_batch(seeds, params, caps, dev):
    import numpy as np
    import torch

    import bench
    from fccf_pcr_torch import pre_downsample
    from fccf_pcr_torch.io import synthetic

    cfg = bench.CONFIGS["office"]
    pts, gts = [], []
    for s in seeds:
        src, tar, T_gt = synthetic.make_pair(seed=s, **cfg["scene"], **cfg["pair"])
        pair = []
        for cloud in (src, tar):
            p, m = synthetic.pad_points(cloud, caps.raw_points)
            d, dm, ovf = pre_downsample(p, m, params, caps, device=dev)
            check(not bool(ovf), f"seed {s}: pre_downsample overflow")
            pair.append((d, dm))
        pts.append(pair)
        gts.append(T_gt)
    args = (
        torch.stack([p[0][0] for p in pts]), torch.stack([p[0][1] for p in pts]),
        torch.stack([p[1][0] for p in pts]), torch.stack([p[1][1] for p in pts]),
    )
    return args, torch.from_numpy(np.stack(gts).astype(np.float64))


def phase_main_path(lp, dev):
    import torch

    import bench
    from fccf_pcr_torch import make_register_fn, registration_errors
    from fccf_pcr_torch.models.fccf import get_model

    model = get_model(bench.CONFIGS["office"]["model"])
    golden = json.loads(GOLDEN.read_text())
    rows = golden["configs"]["office"]
    seeds = [r["seed"] for r in rows]
    args, T_gt = office_batch(seeds, model.params, model.caps, dev)
    fn = make_register_fn(model.params, model.caps, batched=True, device=dev)

    lp.LAUNCHES = 0
    res = fn(*args)
    torch.cuda.synchronize()
    launches = lp.LAUNCHES
    check(launches > 0, "the main path launched no label-prop kernel")

    T = res.transform
    check(T.shape == (len(seeds), 4, 4) and bool(torch.isfinite(T).all()),
          "transforms not finite / wrong shape")
    T64 = T.double().cpu()
    gate = bench.GATES["office"]
    for k, row in enumerate(rows):
        d_rre, d_rte = registration_errors(T64[k], torch.tensor(row["T"], dtype=torch.float64))
        g_rre, g_rte = registration_errors(T64[k], T_gt[k])
        status = int(res.status[k])
        kept = res.kept[k].tolist()
        print(
            f"[main] seed {row['seed']}: golden drift {float(d_rre):.5f} deg "
            f"{float(d_rte):.5f} m | GT {float(g_rre):.4f} deg {float(g_rte):.4f} m "
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
        check(float(d_rre) < 0.1 and float(d_rte) < 0.02,
              f"seed {row['seed']}: outside the golden band")
        check(status == row["status"], f"seed {row['seed']}: status differs")
        check(kept == row["kept"], f"seed {row['seed']}: kept mask differs")
        check(float(g_rre) < gate[0] and float(g_rte) < gate[1],
              f"seed {row['seed']}: ground-truth gate failed")

    again = fn(*args)
    torch.cuda.synchronize()
    check(torch.equal(again.transform, res.transform),
          "a repeated run gave different transforms")
    print(f"[main] {len(seeds)} office pairs inside the golden bands; "
          f"kernel launches {launches}; repeated run bitwise equal", flush=True)
    return launches, model


def phase_timing(model, dev, batch=8, reps=3):
    import torch

    from fccf_pcr_torch import make_register_fn

    args, _ = office_batch(list(range(batch)), model.params, model.caps, dev)
    fn = make_register_fn(model.params, model.caps, batched=True, device=dev)
    res = fn(*args)  # warm up
    torch.cuda.synchronize()
    check(bool((res.status == 0).all()), "timing batch has non-zero status")
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    return batch / dt, dt, (fn, args)


def phase_profile(fn, args):
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    stages = ("downsample", "faces", "hypotheses", "cluster", "quick_verify",
              "refine", "fine_verify")
    # Device work = the kernels' own time (one stream, so no overlap);
    # the stage ranges also appear on the device timeline and are skipped.
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in stages]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    print(f"[profile] step {wall_ms:.1f} ms wall, {len(kernels)} kernels, "
          f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)",
          flush=True)
    for e in prof.key_averages():
        if e.key in stages and e.cpu_time_total > 0:
            print(f"[profile] stage {e.key}: {e.cpu_time_total / 1e3:.1f} ms "
                  f"host-inclusive over {e.count} calls", flush=True)
    by_name = collections.Counter()
    calls = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.device_time
        calls[e.name] += 1
    for name, us in by_name.most_common(6):
        print(f"[profile] kernel {us / 1e3:.1f} ms over {calls[name]} "
              f"launches: {name[:90]}", flush=True)


def main():
    sys.path.insert(0, str(ROOT))
    try:
        import numpy  # noqa: F401
        import torch

        import bench  # noqa: F401
        from fccf_pcr_torch.ops import label_prop as lp
    except ImportError as e:
        print(f"FAIL: cannot import the port from {ROOT}: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke run "
              "needs a CUDA card", file=sys.stderr)
        return 1

    try:
        dev = torch.device("cuda:0")
        smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"])
        print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
              f"cuda {torch.version.cuda} nvcc: {run([lp._nvcc(), '--version'])}",
              flush=True)
        print(f"[env] device {torch.cuda.get_device_name(0)} "
              f"(count {torch.cuda.device_count()})", flush=True)

        t0 = time.perf_counter()
        lp.build(force=True)
        print(f"[build] label_prop.cu built in {time.perf_counter() - t0:.2f} s",
              flush=True)

        k = phase_kernel_vs_plain(lp, dev)
        print(f"[kernel] labels equal to plain at V=1536 and V=1000 (batch 2); "
              f"propagation {k['ms']:.3f} ms vs plain {k['plain_ms']:.3f} ms; "
              f"one sweep {k['sweep_ms']:.4f} ms (V=1536, bound 1019) | {smi}",
              flush=True)

        launches, model = phase_main_path(lp, dev)

        pps, dt, step = phase_timing(model, dev)
        print(f"[timing] eth-office batch 8: {dt * 1e3:.1f} ms/step, "
              f"{pps:.2f} pairs/s | {smi} | torch {torch.__version__} "
              f"cuda {torch.version.cuda}", flush=True)
        phase_profile(*step)
    except Exception:  # any failed phase fails the run
        traceback.print_exc()
        print("FAIL", file=sys.stderr)
        return 1

    print(json.dumps({"kernels": [dict(
        KERNEL, launches=launches, max_abs_err=k["max_abs_err"],
        ms=k["ms"], plain_ms=k["plain_ms"],
    )]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
