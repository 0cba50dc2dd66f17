#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fccf_pcr_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line or more each; any failure exits non-zero and prints no
result:

  1. environment: torch / CUDA / nvcc versions and the card's name and
     power limit (nvidia-smi); no card -> fail (never a CPU fallback);
  2. build both kernels with nvcc, in parallel: the label-propagation
     sweep K1 (csrc/label_prop.cu) and the per-row gather P1
     (csrc/gather.cu);
  3. K1 vs its plain PyTorch version on the card: clustered voxel stats
     at V=1536 (office), V=1000 (a tail) and V=9216 (heritage), batch 2
     (a pass-1 prefix bound and a small pass-2 bound); labels must be
     equal; times at the office and heritage pass-1 shapes;
  4. P1 vs its plain version: the TPU probe's own inputs
     (tools/probe_gather.py) and label rows at the main path's shapes,
     (8, 9216) included; outputs must be equal;
  5. the main path at the full eth-office preset: bench.CONFIGS["office"]
     scenes for seeds 0-3 -> pre_downsample -> batched register_pair on
     the card, held to the office rows of tests/golden/pipeline.json
     (transform within 0.1 deg / 0.02 m, status and kept mask equal) and
     to bench.GATES["office"] against ground truth; both kernels' launch
     counts must grow; a second run must give bitwise-equal transforms;
  6. the building-scale path at the full heritage preset (two-key
     voxelization, V=9216), seeds 0-3, held to its golden rows and
     bench.GATES["heritage"] the same way;
  7. the command line in subprocesses: `python -m fccf_pcr_torch SRC TAR
     0.2 --caps heritage --device cuda --json` on the heritage seed-0
     pair written as PLY, held to its golden row; and a `--batch --out
     --caps auto` sweep of the resso seed-0 pair, held to
     bench.GATES["resso"];
  8. steady-state step time at batch 8 (build excluded), office and
     heritage, in pairs/s;
  9. one heritage batch-8 step under torch.profiler: host time per stage
     (register.py's record_function scopes), the device's busy share of
     the step, and the kernels with the most device time.

Then one JSON line describing the kernels, the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""


import collections
import functools
import json
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
KERNELS = {
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
# main path's pass-1 shapes it is timed at: (name, V, bound, reps).
K1_CASES = ((1536, (1019, 97)), (1000, (1000, 61)), (9216, (8526, 100)))
K1_TIMED = (("office", 1536, 1019, 20), ("heritage", 9216, 8526, 5))
# P1 against plain: (P, V) label rows (after the TPU probe's own inputs).
P1_SHAPES = ((1, 1536), (1, 9216), (8, 9216))


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


def phase_build(modules):
    """Build every kernel from its source, one nvcc each, all at once."""
    def build(mod):
        t0 = time.perf_counter()
        mod.build(force=True)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(modules)) as ex:
        return list(ex.map(build, modules))


def phase_kernel_vs_plain(lp, dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    errs = []
    for V, bounds in K1_CASES:
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
        del want

    # Times at the main path's pass-1 shapes: one cloud, the office
    # (V=1536, bound 1019) and heritage (V=9216, bound 8526) prefixes.
    times = {}
    for name, V, b, reps in K1_TIMED:
        normal, centroid, valid = (
            torch.from_numpy(a)[None].to(dev)
            for a in clustered(rng, V, prefix=b)
        )
        bound = torch.tensor([b], dtype=torch.int32, device=dev)
        ms = cuda_ms(lambda: lp.label_propagate(
            normal, centroid, valid, 5.0, 0.5, 5.0, bound=bound), reps)
        plain_ms = cuda_ms(lambda: lp.label_propagate_plain(
            normal, centroid, valid, 5.0, 0.5, 5.0), reps)
        stats = lp._pack_stats(normal, centroid, valid)
        labels = torch.where(valid, torch.arange(V, dtype=torch.int32,
                                                 device=dev), _BIG).contiguous()
        changed = torch.zeros(1, dtype=torch.int32, device=dev)
        sweep_ms = cuda_ms(lambda: lp._launch_sweep(
            stats, bound, labels, changed, lp.cos_deg(5.0), 0.5, 5.0), 4 * reps)
        times[name] = dict(V=V, bound=b, ms=ms, plain_ms=plain_ms,
                           sweep_ms=sweep_ms)
    return max(errs), times


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
        times[(P, V)] = (
            cuda_ms(lambda: gt.gather_rows(labels, labels), 200),
            cuda_ms(lambda: gt.gather_rows_plain(labels, labels), 200),
        )
    return max(errs), times


@functools.lru_cache(maxsize=None)
def scene(name, seed):
    """(src, tar, T_gt) of bench.CONFIGS[name] for one seed."""
    import bench
    from fccf_pcr_torch.io import synthetic

    cfg = bench.CONFIGS[name]
    return synthetic.make_pair(seed=seed, **cfg["scene"], **cfg["pair"])


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


def drift(T, T_ref):
    import torch

    from fccf_pcr_torch import registration_errors

    rre, rte = registration_errors(
        torch.as_tensor(T, dtype=torch.float64),
        torch.as_tensor(T_ref, dtype=torch.float64),
    )
    return float(rre), float(rte)


def phase_path(name, counters, dev, repeat=False):
    """One config's golden seeds through the batched main path; returns
    each kernel's launch count in that run (counts reset just before)."""
    import torch

    import bench
    from fccf_pcr_torch import make_register_fn
    from fccf_pcr_torch.models.fccf import get_model

    model = get_model(bench.CONFIGS[name]["model"])
    rows = json.loads(GOLDEN.read_text())["configs"][name]
    seeds = [r["seed"] for r in rows]
    args, T_gt = config_batch(name, seeds, model.params, model.caps, dev)
    fn = make_register_fn(model.params, model.caps, batched=True, device=dev)

    for mod in counters.values():
        mod.LAUNCHES = 0
    res = fn(*args)
    torch.cuda.synchronize()
    launches = {k: mod.LAUNCHES for k, mod in counters.items()}
    for k, n in launches.items():
        check(n > 0, f"the {name} path launched no {k} kernel")

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

    note = ""
    if repeat:
        again = fn(*args)
        torch.cuda.synchronize()
        check(torch.equal(again.transform, res.transform),
              f"{name}: a repeated run gave different transforms")
        note = "; repeated run bitwise equal"
    print(f"[{name}] {len(seeds)} pairs inside the golden bands; launches "
          f"{launches}{note}", flush=True)
    return launches


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


def phase_timing(name, dev, batch=8, reps=2):
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

    counters = {"label_prop_sweep": lp, "gather_rows": gt}
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

        k1_err, k1 = phase_kernel_vs_plain(lp, dev)
        print("[kernel] K1 labels equal to plain at V=1536, V=1000 and V=9216 "
              "(batch 2)", flush=True)
        for name, t in k1.items():
            print(f"[kernel] K1 {name} pass-1 shape (V={t['V']}, bound "
                  f"{t['bound']}): propagation {t['ms']:.3f} ms vs plain "
                  f"{t['plain_ms']:.3f} ms; one sweep {t['sweep_ms']:.4f} ms "
                  f"| {smi}", flush=True)

        p1_err, p1 = phase_gather_vs_plain(gt, dev)
        print("[gather] equal to tbl[idx] at the probe's inputs (1, 1024) and "
              "to plain at (1, 1536), (1, 9216), (8, 9216)", flush=True)
        for (P, V), (ms, plain_ms) in p1.items():
            print(f"[gather] ({P}, {V}): {ms * 1e3:.2f} us vs plain "
                  f"{plain_ms * 1e3:.2f} us | {smi}", flush=True)

        launches = {k: 0 for k in counters}
        for name, repeat in (("office", True), ("heritage", False)):
            for k, n in phase_path(name, counters, dev, repeat).items():
                launches[k] += n

        phase_cli()

        step = None
        for name in ("office", "heritage"):
            pps, dt, step = phase_timing(name, dev)
            print(f"[timing] {name} batch 8: {dt * 1e3:.1f} ms/step, "
                  f"{pps:.2f} pairs/s | {smi} | torch {torch.__version__} "
                  f"cuda {torch.version.cuda}", flush=True)
        phase_profile(*step)
        print(f"[done] {time.perf_counter() - t_start:.1f} s after the build "
              "started", flush=True)
    except Exception:  # any failed phase fails the run
        traceback.print_exc()
        print("FAIL", file=sys.stderr)
        return 1

    print(json.dumps({"kernels": [
        dict(KERNELS["label_prop_sweep"], launches=launches["label_prop_sweep"],
             max_abs_err=k1_err, ms=k1["heritage"]["ms"],
             plain_ms=k1["heritage"]["plain_ms"],
             shape="V=9216, bound 8526, one cloud"),
        dict(KERNELS["gather_rows"], launches=launches["gather_rows"],
             max_abs_err=p1_err, ms=p1[(1, 9216)][0],
             plain_ms=p1[(1, 9216)][1], shape="(1, 9216) int32"),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
