"""The port's benchmark: one cell of ``BENCHMARK.json`` for ``--seconds``.

    python3 regbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up makes the cell's pool of raw pairs from the seed, builds the
port's kernels where they are not built yet, and sends every batch of the
pool once through the timed path (which captures the step's CUDA graph).
The window then sends batches back to back (``benchlib/loop.py``). After
it, ``--trace 1`` reads the per-layer records (``benchlib/traced.py``),
the program's state is freed, and the plain reference (``refpipe``)
registers every distinct pair of the pool again from its raw clouds to
decide ``correct`` (``benchlib/compare.py``). The last line of standard
output is the result as one JSON object; the numbers compared, each with
its limit, are the last lines of standard error.

Needs a CUDA card; exits with code 2 and prints no result without one,
and with code 3 if ``jax``, ``jaxlib``, ``flax`` or ``fccf_pcr_tpu`` is
loaded once the window has closed.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import concurrent.futures  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "fccf_pcr_tpu")
# The port's kernel libraries on the main path, built in parallel in a
# checkout's first run.
KERNEL_MODULES = ("ops.label_prop", "ops.scan", "ops.faces_kernels",
                  "ops.hypotheses_kernels", "ops.cluster_kernels",
                  "ops.fine_kernels", "refine.lm_kernel")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fixed_caches(root):
    """Build and kernel caches in fixed directories of the checkout."""
    cache = root / ".regbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def build_kernels(port):
    """Every kernel library of the main path, built where missing (in
    parallel: each is one nvcc call) and loaded."""
    mods = [importlib.import_module(f"{port.__name__}.{m}")
            for m in KERNEL_MODULES]
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as ex:
        for f in [ex.submit(m.build) for m in mods]:
            f.result()


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def power_limit():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def to_host(x):
    return x.detach().cpu().numpy()


def program_outputs(runner):
    """What the timed path produced for each pair of the pool (its latest
    batch of it): ((src, tar) down-sampled (pts, mask, ovf), result fields
    by name), host copies in pool order."""
    fields = runner.port.RegistrationResult._fields
    outs = []
    for slot, (ds, dt) in enumerate(runner.down):
        down = [[to_host(x) for x in side] for side in (ds, dt)]
        host = [x.numpy().copy() for x in runner.out[slot]]
        for r in range(host[0].shape[0]):
            outs.append((tuple(tuple(x[r] for x in side) for side in down),
                         {f: host[i][r] for i, f in enumerate(fields)}))
    return outs


def reference_outputs(pool, config, device, control=None):
    """The reference's down-sampled clouds and results of each pair of the
    pool, registered one pair at a time from its raw clouds. ``control``:
    ``"tf32"``, the precision control: the reference with the operands of
    its matrix products rounded to TF32's 10-bit mantissa, which is all
    that TF32 changes in a float32 program; ``"tf32_inputs"``, a further
    witness that also rounds the raw points so, which no TF32 program
    does."""
    import torch

    import refpipe

    params = refpipe.FCCFParams(**config["params"])
    caps = refpipe.Capacities(**config["caps"])
    outs = []
    for b in pool.batches:
        for r in range(b.pairs):
            raw = [t.to(device) for t in b.pair(r)]
            with torch.no_grad(), contextlib.ExitStack() as stack:
                if control in ("tf32", "tf32_inputs"):
                    stack.enter_context(refpipe.tf32_products())
                if control == "tf32_inputs":
                    raw[0] = refpipe.tf32_round(raw[0])
                    raw[2] = refpipe.tf32_round(raw[2])
                ds = refpipe.pre_downsample(raw[0], raw[1], params, caps)
                dt = refpipe.pre_downsample(raw[2], raw[3], params, caps)
                res = refpipe.register_batch(ds[0], ds[1], dt[0], dt[1],
                                             params, caps)
            down = tuple(tuple(to_host(x)[0] for x in side) for side in (ds, dt))
            outs.append((down, {f: to_host(v)[0]
                                for f, v in zip(res._fields, res)}))
    return outs


def numbers(prog, ref):
    """The compared numbers of two sides' outputs (``compare``)."""
    from benchlib import compare

    per_pair = []
    for (pdown, pres), (rdown, rres) in zip(prog, ref, strict=True):
        d = [compare.down_numbers(a, b) for a, b in zip(pdown, rdown)]
        row = compare.result_numbers(pres, rres)
        row["down_mask_diff"] = sum(x[0] for x in d)
        row["down_point_gap_m"] = max(x[1] for x in d)
        per_pair.append(row)
    return compare.worst(per_pair)


def accuracy_line(prog, pool, gate):
    """RRE / RTE of the program's transforms against the ground truth,
    beside the configuration's gate (reported, not a metric)."""
    import numpy as np

    T = np.stack([res["transform"] for _, res in prog]).astype(np.float64)
    G = pool.gts.astype(np.float64)
    tr = np.sum(T[:, :3, :3] * G[:, :3, :3], axis=(-2, -1))
    rre = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))
    rte = np.linalg.norm(T[:, :3, 3] - G[:, :3, 3], axis=-1)
    ok = int(np.sum((rre < gate["rre_deg"]) & (rte < gate["rte_m"])))
    status = collections.Counter(int(res["status"]) for _, res in prog)
    return (f"accuracy: {ok}/{len(T)} pairs within the gate (RRE < "
            f"{gate['rre_deg']} deg, RTE < {gate['rte_m']} m); worst RRE "
            f"{float(np.max(rre))!r} deg, worst RTE {float(np.max(rte))!r} m;"
            f" pairs by status {dict(sorted(status.items()))}")


def finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def main(argv=None, *, root=None, device=None, fault=None):
    """One run. ``root`` is the checkout (the parent of this folder by
    default); ``device`` None asks for a card; ``fault`` wraps the
    batched step (the harness's own tests plant faults with it)."""
    args = parse(argv)
    root = Path(root) if root is not None else ROOT
    fixed_caches(root)

    import torch

    from benchlib import compare, loop, pool as pool_mod, spec, traced

    cell = spec.cell(args.workload, root)
    if device is None:
        if not torch.cuda.is_available():
            print("regbench: torch.cuda.is_available() is False; this "
                  "benchmark runs on a CUDA card", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"regbench: {cell.name} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    torch.set_num_threads(min(4, os.cpu_count() or 1))

    import fccf_pcr_torch as port

    marks = [("imports", time.perf_counter())]
    if cuda:
        torch.cuda.set_device(device)
        build_kernels(port)
    marks.append(("context and builds", time.perf_counter()))
    pool = pool_mod.make_pool(cell.config, cell.traffic, args.seed, pin=cuda)
    marks.append(("pool", time.perf_counter()))
    runner = loop.Runner(port, cell.config, pool, device, fault)
    for slot in range(len(pool.batches)):  # warm-up: every shape, the capture
        runner.run(slot)
    if cuda:
        torch.cuda.synchronize()
        process_peak = torch.cuda.max_memory_reserved(device)
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - START
    last = START
    parts = []
    for name, t in marks:
        parts.append(f"{name} {t - last:.3f} s")
        last = t
    print("setup: " + ", ".join(parts), file=sys.stderr)

    events = [] if (args.trace and cuda) else None
    rec = loop.window(runner, args.seconds, events)
    rec["setup_s"] = setup_s
    device_info = dict(platform="gpu" if cuda else device.type,
                       kind=torch.cuda.get_device_name(device) if cuda
                       else "cpu", count=cell.chips if cuda else 1)
    if cuda:
        torch.cuda.synchronize()
        window_peak = torch.cuda.max_memory_reserved(device)
        rec["peak_mem_bytes"] = window_peak
        device_info["memory_peak_bytes"] = max(process_peak, window_peak)
    metrics_of = cell.end_to_end
    breakdown = None
    if args.trace:
        # The idle share's window: the pool's batches, at least 8, over
        # at least half a second at the untraced pace.
        n_slots = len(pool.batches)
        per_batch = rec["window_s"] / len(rec["latencies_s"])
        n_traced = max(n_slots, 8, math.ceil(0.5 / per_batch))
        slots = [s % n_slots for s in range(n_traced)]
        rec.update(traced.records(runner, events, slots,
                                  slots[:max(n_slots, 8)],
                                  list(range(min(n_slots, 4)))))
        print(f"traced windows: {rec['traced_batches']} batches at "
              f"{rec['traced_window_s'] / rec['traced_batches']!r} s a "
              f"batch with CUDA activity alone (the idle share), "
              f"{rec['host_traced_batches']} at "
              f"{rec['host_traced_window_s'] / rec['host_traced_batches']!r}"
              f" s with the host's as well (the idle gaps), against "
              f"{per_batch!r} s untraced", file=sys.stderr)
        if "propagate" in rec:
            p = rec["propagate"]
            print(f"propagation: bound {p['bound_s']!r} s ({p['bound_by']}) "
                  f"over {p['time_s']!r} s in the traced replays",
                  file=sys.stderr)
        device_info["busy_s"] = rec["traced_busy_s"]
        device_info["window_s"] = rec["traced_window_s"]
        breakdown = rec["breakdown"]
        metrics_of = cell.per_layer
    if cuda:
        device_info["power"] = power_limit()
    metrics = {}
    for m in metrics_of:
        value = spec.reader(m["name"], root)(rec)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])

    # Correctness: the program's outputs, then its state freed, then the
    # reference pair by pair on the same device.
    prog = program_outputs(runner)
    print(accuracy_line(prog, pool, cell.config["gate"]), file=sys.stderr)
    del runner
    port.pipeline.register.STEP.clear()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_outputs(pool, cell.config, device)
    print(f"reference: {len(ref)} pairs in "
          f"{time.perf_counter() - t_ref!r} s", file=sys.stderr)
    ok, rows = compare.verdict(numbers(prog, ref), cell.config["limits"])
    bad = forbidden_modules()
    if bad:
        print(f"regbench: loaded once the window closed: {bad}",
              file=sys.stderr)
        return 3

    result = dict(correct=ok, attempted=rec["pairs"], failed=rec["failed"],
                  metrics=metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: dict(value=finite(v), limit=lim)
                        for name, v, lim in rows}
    for name, v, lim in rows:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
