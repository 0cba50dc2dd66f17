"""The readings that the limits of ``correct`` are set from, on the card:
for each seed, the program's numbers (its timed path, a short window at
the cell's load, against the reference) and the TF32 control's (the
reference with every matrix product in TF32, put in the program's place,
against the reference), in one process; with ``--witness``, also those
of the reference with its raw points rounded to TF32 as well.

    python3 regbench/readings.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 2] [--no-control] [--witness] [--out readings.jsonl]

Prints one JSON line a seed, then the largest reading of each number of
the program over the seeds and the smallest of each control over the
seeds on which it differs from the reference at all (on the others it
computed what the reference did, and nothing could tell them apart),
with the count of those seeds; with ``--out``, appends the seeds' lines
to that file.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    run.fixed_caches(run.ROOT)

    import torch

    import fccf_pcr_torch as port
    from benchlib import compare, loop, pool as pool_mod, spec

    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    run.build_kernels(port)
    controls = [] if args.no_control else ["control"]
    controls += ["witness"] if args.witness else []
    mode = dict(control="tf32", witness="tf32_inputs")
    worst, differing = {}, dict.fromkeys(controls, 0)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        pool = pool_mod.make_pool(cell.config, cell.traffic, seed, pin=True)
        runner = loop.Runner(port, cell.config, pool, device)
        for slot in range(len(pool.batches)):
            runner.run(slot)
        loop.window(runner, args.seconds)
        prog = run.program_outputs(runner)
        del runner
        t0 = time.perf_counter()
        ref = run.reference_outputs(pool, cell.config, device)
        row = dict(workload=cell.name, seed=seed,
                   reference_s=time.perf_counter() - t0,
                   program=run.numbers(prog, ref))
        for k, v in row["program"].items():
            worst[f"program.{k}"] = max(worst.get(f"program.{k}", v), v)
        for side in controls:
            out = run.reference_outputs(pool, cell.config, device,
                                        control=mode[side])
            row[side] = run.numbers(out, ref)
            if not any(row[side].values()):
                continue
            differing[side] += 1
            for k, v in row[side].items():
                worst[f"{side}.{k}"] = min(worst.get(f"{side}.{k}", v), v)
        print(json.dumps(row), flush=True)
        lines.append(row)
    print(json.dumps(dict(workload=cell.name, seeds=len(lines),
                          seeds_differing=differing,
                          worst_program_least_control=worst,
                          checks=list(compare.CHECKS))), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for row in lines:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
