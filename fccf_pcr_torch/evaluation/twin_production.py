"""The pipeline against the NumPy twin at production density (the
port's ``tools/twin_production.py``).

``tests/golden/twin_production.json`` caches the NumPy twin's final
transforms (the reference's sequential greedy semantics) on the
benchmark scene pairs of ``PLAN``. ``check`` registers those pairs with
the port, one batch per config, and holds each pair to its config's band
of ``twin.families.TWIN_BANDS`` (deg, m) against the twin's transform.
``generate`` runs the port's twin (``twin/twin.py``, NumPy on the CPU,
no card) on those pairs and writes the rows in the fixture's format to
``--out``; it never writes the committed fixture, which holds the JAX
reference's rows:

    python -m fccf_pcr_torch.evaluation.twin_production --check
    python -m fccf_pcr_torch.evaluation.twin_production --check \
        --configs office --device cpu
    python -m fccf_pcr_torch.evaluation.twin_production --generate \
        --out twin_rows.json --configs office

``--generate`` is resumable: each finished pair is appended to
``<out>.partial`` (JSONL) at once and skipped on a restart.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from ..io import synthetic
from ..models.fccf import get_model
from ..pipeline.register import make_register_fn, pre_downsample, resolve_device
from ..twin import twin
from ..twin.families import TWIN_BANDS
from .configs import CONFIGS, pairs_for_config

FIXTURE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "golden", "twin_production.json")

# (config, seeds) of the fixture: office and structured, and both
# building-scale families, where voxel counts and face merges peak.
PLAN = [
    ("office", list(range(8))),
    ("structured", list(range(8))),  # round-robins stairs/hall by seed
    ("resso", list(range(4))),
    ("heritage", list(range(4))),
]


def errors(T, T_ref):
    """(deg, m) between two 4x4 transforms, in float64."""
    T, T_ref = (np.asarray(x, np.float64).reshape(4, 4) for x in (T, T_ref))
    R = T[:3, :3] @ T_ref[:3, :3].T
    rre = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)))
    rte = np.linalg.norm(T[:3, 3] - T_ref[:3, 3])
    return float(rre), float(rte)


def generate(out, configs=None, log=print):
    """The twin's row for every pair of ``PLAN`` (of the config names
    ``configs``, or all), written to ``out`` as ``{"rows": [...]}`` in
    plan order. Each finished pair is appended to ``out + ".partial"`` at
    once; a restart skips the pairs found there. Returns the rows."""
    if os.path.abspath(out) == os.path.abspath(FIXTURE):
        raise ValueError(f"--out must not be the committed fixture {FIXTURE}")
    plan = [(c, ss) for c, ss in PLAN if not configs or c in configs]
    partial = out + ".partial"
    done = {}
    if os.path.exists(partial):
        with open(partial) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue  # a line cut short by an interrupted run
                done[(r["config"], r["seed"])] = r
    with open(partial, "a") as part:
        for cfg_name, cfg_seeds in plan:
            todo = [s for s in cfg_seeds if (cfg_name, s) not in done]
            if not todo:
                continue
            cfg = CONFIGS[cfg_name]
            params = get_model(cfg["model"]).params
            for s, (src, tar, T_gt) in zip(todo, pairs_for_config(cfg, todo)):
                t0 = time.time()
                T = twin.register_pair(src, tar, params)
                dt = time.time() - t0
                rre, rte = errors(T, T_gt)
                row = {
                    "config": cfg_name,
                    "seed": s,
                    "n_src": int(len(src)),
                    "n_tar": int(len(tar)),
                    "T_twin": np.asarray(T, np.float64).round(9).ravel().tolist(),
                    "T_gt": np.asarray(T_gt, np.float64).round(9).ravel().tolist(),
                    "rre_gt_deg": round(rre, 5),
                    "rte_gt_m": round(rte, 6),
                    "twin_s": round(dt, 1),
                }
                done[(cfg_name, s)] = row
                part.write(json.dumps(row) + "\n")
                part.flush()
                log(f"{cfg_name}/{s}: {dt:.0f}s rre={rre:.4f} rte={rte:.5f}")
    rows = [done[(c, s)] for c, ss in plan for s in ss if (c, s) in done]
    with open(out, "w") as f:
        json.dump({"rows": rows}, f, indent=1)
    log(f"wrote {len(rows)} rows -> {out}")
    return rows


def check(configs=None, device="cuda", fixture=FIXTURE, log=print):
    """Register the fixture's pairs of ``PLAN`` (those of the config names
    ``configs``, or all) on ``device``, one batch per config. Returns
    (rows, worst): one dict per pair with ``pipe_vs_twin``,
    ``pipe_vs_gt``, ``twin_vs_gt``, ``status`` and ``in_band``, and the
    worst (deg, m) pipeline-vs-twin disagreement. Raises if the fixture
    lacks a pair of the plan or the scene generator no longer makes the
    fixture's clouds."""
    dev = resolve_device(device)
    with open(fixture) as f:
        by_pair = {(r["config"], r["seed"]): r for r in json.load(f)["rows"]}

    rows = []
    worst = (0.0, 0.0)
    for cfg_name, seeds in PLAN:
        if configs and cfg_name not in configs:
            continue
        missing = [s for s in seeds if (cfg_name, s) not in by_pair]
        if missing:
            raise RuntimeError(f"{fixture} has no {cfg_name} rows for seeds "
                               f"{missing}")
        rs = [by_pair[cfg_name, s] for s in seeds]
        cfg = CONFIGS[cfg_name]
        model = get_model(cfg["model"])
        raw = model.caps.raw_points
        pairs = pairs_for_config(cfg, seeds)
        for r, (src, tar, _) in zip(rs, pairs):
            if (len(src), len(tar)) != (r["n_src"], r["n_tar"]):
                raise RuntimeError(
                    f"{cfg_name} seed {r['seed']}: the scene generator no "
                    "longer makes the fixture's clouds")
        sides = []
        for side in range(2):
            p, m = zip(*(synthetic.pad_points(pair[side], raw)
                         for pair in pairs))
            pts, mask, _ = pre_downsample(np.stack(p), np.stack(m),
                                          model.params, model.caps, device=dev)
            sides += [pts, mask]
        res = make_register_fn(model.params, model.caps, batched=True,
                               device=dev)(*sides)
        T_pipe = res.transform.cpu().double().numpy()
        status = res.status.cpu().numpy()
        band = TWIN_BANDS[cfg_name]
        for k, r in enumerate(rs):
            x = errors(T_pipe[k], r["T_twin"])
            g = errors(T_pipe[k], r["T_gt"])
            row = {
                "config": cfg_name,
                "seed": r["seed"],
                "pipe_vs_twin": [round(x[0], 4), round(x[1], 5)],
                "pipe_vs_gt": [round(g[0], 4), round(g[1], 5)],
                "twin_vs_gt": [r["rre_gt_deg"], r["rte_gt_m"]],
                "status": int(status[k]),
                "in_band": x[0] < band[0] and x[1] < band[1],
            }
            rows.append(row)
            log(json.dumps(row))
            worst = (max(worst[0], x[0]), max(worst[1], x[1]))
    log(f"worst pipeline-vs-twin: {worst[0]:.4f} deg  {worst[1]:.5f} m")
    return rows, worst


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m fccf_pcr_torch.evaluation.twin_production")
    ap.add_argument("--generate", action="store_true",
                    help="run the NumPy twin on the plan's pairs (CPU) and "
                         "write its rows to --out")
    ap.add_argument("--out", default=None,
                    help="--generate's output (required with it; never "
                         "the committed fixture)")
    ap.add_argument("--check", action="store_true",
                    help="register the fixture's pairs and hold each to "
                         "its config's band of the twin's transform")
    ap.add_argument("--configs", default=None,
                    help="comma filter of the plan's configs")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="cuda (default) needs a CUDA card; cpu runs the "
                         "kernels' plain versions")
    ap.add_argument("--fixture", default=FIXTURE)
    args = ap.parse_args(argv)
    if not (args.generate or args.check):
        ap.error("pass --generate and/or --check")
    if args.generate and not args.out:
        ap.error("--generate needs --out")
    configs = args.configs.split(",") if args.configs else None
    if args.generate:
        generate(args.out, configs)
    if not args.check:
        return 0
    rows, _ = check(configs, device=args.device, fixture=args.fixture)
    out = [r for r in rows if not r["in_band"]]
    for r in out:
        print(f"OUT OF BAND {TWIN_BANDS[r['config']]}: {json.dumps(r)}")
    return 1 if out else 0


if __name__ == "__main__":
    sys.exit(main())
