#!/usr/bin/env python3
"""Step-time A/B of two checkouts of the port on one CUDA card: the
batched main path at batch 8 (office and heritage presets, the scenes of
bench.CONFIGS), each checkout in its own subprocess, in turns (parent,
change, change, parent), so that both meet the same card and host.

    python3 tools/torch_step_ab.py --parent DIR [--change DIR] [--reps N]

``--change`` defaults to this checkout. Each subprocess builds the kernels
from its own sources, runs one warm-up step per preset, then times
``--reps`` steps (host clock around work that ends in a synchronize) and,
with ``--eager``, the device time of one eager step (the sum of its
kernels' durations, CUPTI, the mean of three: ``chip_smoke.device_ms``
on ``chip_smoke.eager_step``), and prints one JSON line; this script prints one line per run with the card's
name and power limit, and the whole as JSON last. Exits non-zero without
a card or when a run fails.
"""

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

_RUN = r"""
import json, sys, time
sys.path.insert(0, {tree!r})
import torch
import bench
import chip_smoke as cs
from fccf_pcr_torch import make_register_fn
from fccf_pcr_torch.models.fccf import get_model
from fccf_pcr_torch.ops import gather, label_prop

dev = torch.device("cuda:0")
label_prop.build(force=True)
gather.build(force=True)
out = {{}}
for name in ("office", "heritage"):
    model = get_model(bench.CONFIGS[name]["model"])
    args, _ = cs.config_batch(name, list(range(8)), model.params, model.caps,
                              dev)
    fn = make_register_fn(model.params, model.caps, batched=True, device=dev)
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range({reps}):
        fn(*args)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / {reps}
    out[name] = dict(step_ms=dt * 1e3, pairs_per_s=8 / dt)
    if {eager}:
        eager = cs.eager_step(model.params, model.caps)
        out[name]["eager_device_ms"] = cs.device_ms(lambda: eager(*args), 3)
print(json.dumps(out))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=pathlib.Path)
    ap.add_argument("--change", default=ROOT, type=pathlib.Path)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--eager", action="store_true",
                    help="also the eager step's device time")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    runs = []
    for which in ("parent", "change", "change", "parent"):
        tree = getattr(args, which).resolve()
        proc = subprocess.run(
            [sys.executable, "-c", _RUN.format(tree=str(tree), reps=args.reps,
                                               eager=args.eager)],
            cwd=tree, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(f"FAIL: the {which} run exited {proc.returncode}:\n"
                  f"{proc.stderr[-3000:]}", file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(dict(tree=which, **res))
        print(f"[step-ab] {which}: " + ", ".join(
            f"{k} {v['step_ms']:.1f} ms/step ({v['pairs_per_s']:.2f} pairs/s"
            + (f", eager step {v['eager_device_ms']:.3f} ms of device time"
               if "eager_device_ms" in v else "") + ")"
            for k, v in res.items()) + f" | {smi}", flush=True)
    print(json.dumps({"device": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
