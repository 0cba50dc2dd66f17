"""Accuracy evaluation sweep (port of ``tools/evaluate.py``).

Registers N seeds per scene family against known ground truth and
reports success rate, RRE/RTE mean/median/p95, the flagged pairs and
throughput, as a markdown table on stdout (one ``# {summary}`` line per
config on stderr):

    python -m fccf_pcr_torch.evaluation.evaluate --seeds 40 \
        --configs office,apartment,cross-season,structured,resso,heritage
    python -m fccf_pcr_torch.evaluation.evaluate --pair-set overlap=0.5 \
        --configs office,resso --escalate-caps auto
    python -m fccf_pcr_torch.evaluation.evaluate --device cpu --seeds 2

Each batch of seeds is one call of the batched program
(``make_register_fn(batched=True)``) after one batched ``pre_downsample``
a side; the last partial batch is padded with copies of its last seed.
A pair succeeds at RRE < 2 deg and RTE < 0.5 m. Pairs/s leaves out each
config's first batch and times the registration step alone, between two
synchronizes of the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..io import synthetic
from ..models.auto import auto_escalation_caps
from ..models.fccf import get_model
from ..pipeline.metrics import registration_errors
from ..pipeline.register import make_register_fn, pre_downsample, resolve_device
from ..pipeline.sweep import ESCALATION_STATUS_MASK
from . import configs

SUCCESS_RRE_DEG = 2.0
SUCCESS_RTE_M = 0.5


def evaluate_config(name, cfg, seeds, batch, rotation_gate=None,
                    escalate_caps=None, params_set=(), device="cuda"):
    """Evaluate seeds 0..``seeds``-1 of the scene config ``cfg`` (a
    ``configs.CONFIGS`` entry) in batches of ``batch`` on ``device`` (the
    card by default; ``resolve_device``). ``escalate_caps`` re-runs the
    seeds whose status shows a capacity hit at larger capacities: a
    ``Capacities``, or ``"auto"`` for ``auto_escalation_caps`` of the
    config's preset; the re-run rows replace the flagged ones. Returns
    the summary dict of ``tools/evaluate.py::evaluate_config``, with the
    per-seed rows under ``seed_rows``."""
    if "sequence" in cfg:
        raise ValueError(
            f"config '{name}' is a sequence-sweep throughput config; its "
            "scene family is evaluated via the office config"
        )
    dev = resolve_device(device)
    model = get_model(cfg["model"])
    params, caps = model.params, model.caps
    if rotation_gate is not None:
        params = params.replace(fuse_rotation_gate_deg=rotation_gate)
    for ov in params_set:  # generic FCCFParams override
        key, _, val = ov.partition("=")
        cur = getattr(params, key)  # raises on unknown field
        params = params.replace(
            **{key: configs.coerce_like(cur, key, val, "--set")})
    if escalate_caps == "auto":
        escalate_caps = auto_escalation_caps(caps)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run_seed_batches(seed_lists, stage_caps, timed):
        """(seed, rre, rte, status) rows of batches of seeds at one
        capacity config; ``timed`` adds to the throughput count (the first
        batch, which pays the kernels' build, is left out)."""
        nonlocal t_total, n_timed
        fn = make_register_fn(params, stage_caps, batched=True, device=dev)
        raw = stage_caps.raw_points
        for bi, ss in enumerate(seed_lists):
            pairs = configs.pairs_for_config(cfg, ss)
            pairs += [pairs[-1]] * (batch - len(ss))
            sides = []
            for side in range(2):
                p, m = zip(*(synthetic.pad_points(pair[side], raw)
                             for pair in pairs))
                sides.append(pre_downsample(np.stack(p), np.stack(m), params,
                                            stage_caps, device=dev))
            (spd, smd, s_ovf), (tpd, tmd, t_ovf) = sides
            # Raw-capacity truncation happens on the host in pad_points,
            # where pre_downsample's flag cannot see it.
            pre_ovf = np.array([len(s) > raw or len(t) > raw
                                for s, t, _ in pairs])
            pre_ovf |= (s_ovf | t_ovf).cpu().numpy()
            sync()
            t0 = time.perf_counter()
            res = fn(spd, smd, tpd, tmd)
            sync()
            dt = time.perf_counter() - t0
            if timed and bi > 0:
                t_total += dt
                n_timed += len(ss)
            T_gt = np.stack([p[2] for p in pairs]).astype(np.float32)
            rre, rte = registration_errors(
                res.transform, torch.from_numpy(T_gt).to(dev))
            rre, rte, st = (x.cpu().numpy() for x in (rre, rte, res.status))
            # preprocess truncation counts as a flagged pair (bit 1)
            st = np.where(pre_ovf, st | 1, st)
            for k, s in enumerate(ss):
                yield s, float(rre[k]), float(rte[k]), int(st[k])

    t_total, n_timed = 0.0, 0
    rows = {}
    seed_lists = [list(range(b0, min(b0 + batch, seeds)))
                  for b0 in range(0, seeds, batch)]
    for s, rre, rte, st in run_seed_batches(seed_lists, caps, timed=True):
        rows[s] = (rre, rte, st)

    n_escalated = 0
    if escalate_caps is not None:
        # the mask holds bit 1, which also marks preprocess truncation
        flagged = sorted(s for s, (_, _, st) in rows.items()
                         if st & ESCALATION_STATUS_MASK)
        if flagged:
            n_escalated = len(flagged)
            bits = {s: rows[s][2] for s in flagged}
            print(f"# {name}: escalating {n_escalated} flagged seeds, status "
                  f"bits by seed {bits}", file=sys.stderr, flush=True)
            chunks = [flagged[i:i + batch]
                      for i in range(0, len(flagged), batch)]
            for s, rre, rte, st in run_seed_batches(chunks, escalate_caps,
                                                     timed=False):
                rows[s] = (rre, rte, st)

    rres = np.array([rows[s][0] for s in range(seeds)])
    rtes = np.array([rows[s][1] for s in range(seeds)])
    statuses = [rows[s][2] for s in range(seeds)]
    ok = (rres < SUCCESS_RRE_DEG) & (rtes < SUCCESS_RTE_M)

    def stat(fn, x):
        return float(fn(x[ok])) if ok.any() else float("nan")

    return {
        "config": name,
        "n": seeds,
        "success": float(ok.mean()),
        "rre_mean": stat(np.mean, rres),
        "rre_med": stat(np.median, rres),
        "rre_p95": stat(lambda x: np.percentile(x, 95), rres),
        "rte_mean": stat(np.mean, rtes),
        "rte_med": stat(np.median, rtes),
        "rte_p95": stat(lambda x: np.percentile(x, 95), rtes),
        "fail_seeds": [int(i) for i in np.flatnonzero(~ok)],
        "nonzero_status": int(np.count_nonzero(statuses)),
        # which seed raised which bits (pipeline/register.py STATUS_*)
        "flagged_seeds": {
            int(i): int(statuses[i]) for i in np.flatnonzero(statuses)
        },
        "pairs_per_s": (n_timed / t_total) if t_total > 0 else None,
        "n_escalated": n_escalated,
        "seed_rows": {
            int(s): {"rre": rows[s][0], "rte": rows[s][1],
                     "status": rows[s][2]}
            for s in range(seeds)
        },
    }


def markdown_table(rows):
    """The evaluation table of ``docs/EVALUATION.md``'s layout."""
    lines = ["| config | pairs | success | RRE mean/med/p95 (deg) | "
             "RTE mean/med/p95 (m) | pairs/s | flagged |",
             "|---|---|---|---|---|---|---|"]
    for r in rows:
        pps = f"{r['pairs_per_s']:.1f}" if r["pairs_per_s"] else "—"
        fails = (f" (fails: {r['fail_seeds']})" if r["fail_seeds"] else "")
        lines.append(
            f"| {r['config']} | {r['n']} | {100 * r['success']:.0f}%{fails} | "
            f"{r['rre_mean']:.3f} / {r['rre_med']:.3f} / {r['rre_p95']:.3f} | "
            f"{r['rte_mean']:.4f} / {r['rte_med']:.4f} / {r['rte_p95']:.4f} | "
            f"{pps} | {r['nonzero_status']} |"
        )
    return "\n".join(lines)


def main(argv=None):
    from ..cli import _caps_preset

    ap = argparse.ArgumentParser(
        prog="python -m fccf_pcr_torch.evaluation.evaluate")
    ap.add_argument("--seeds", type=int, default=40)
    ap.add_argument("--batch", type=int, default=None,
                    help="pairs per step (default: the config's own batch)")
    ap.add_argument("--configs", default="office,apartment,cross-season")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="cuda (default) needs a CUDA card; cpu runs the "
                         "kernels' plain versions")
    ap.add_argument(
        "--fuse-rotation-gate", type=float, default=None,
        help="override FCCFParams.fuse_rotation_gate_deg (degrees; "
        "0 = reference-faithful blind averaging)",
    )
    ap.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        dest="params_set",
        help="override any FCCFParams field for the sweep (repeatable)",
    )
    ap.add_argument(
        "--pair-set", action="append", default=[], metavar="KEY=VALUE",
        dest="pair_set",
        help="override a make_pair kwarg for every config (repeatable; "
        "floats), e.g. --pair-set overlap=0.5 for partial overlap",
    )
    ap.add_argument(
        "--dump-seeds", default=None, metavar="FILE",
        help="append one JSON line per config with the per-seed "
        "rre/rte/status rows",
    )
    ap.add_argument(
        "--escalate-caps", default=None, metavar="PRESET",
        help="re-run capacity-flagged seeds under this registry preset, "
        "or 'auto' to double each config's own envelope bounds",
    )
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda requested but torch.cuda.is_available() is "
                 "False; use --device cpu")
    if args.device == "cuda":
        print(f"# device: {torch.cuda.get_device_name(0)}", file=sys.stderr)

    esc = None
    if args.escalate_caps == "auto":
        esc = "auto"  # resolved per config inside evaluate_config
    elif args.escalate_caps:
        esc = _caps_preset(args.escalate_caps)

    pair_set = {}
    for ov in args.pair_set:
        key, _, val = ov.partition("=")
        pair_set[key] = float(val)

    rows = []
    for name in args.configs.split(","):
        cfg = configs.CONFIGS[name]
        if pair_set:
            cfg = {**cfg, "pair": {**cfg["pair"], **pair_set}}
            name = name + "@" + ",".join(args.pair_set)
        batch = args.batch or cfg.get("batch", 8)
        r = evaluate_config(name, cfg, args.seeds, batch,
                            rotation_gate=args.fuse_rotation_gate,
                            escalate_caps=esc, params_set=args.params_set,
                            device=args.device)
        if args.dump_seeds:
            with open(args.dump_seeds, "a") as f:
                f.write(json.dumps({
                    "config": name,
                    "params_set": args.params_set,
                    "seed_rows": r["seed_rows"],
                }) + "\n")
        summary = {k: v for k, v in r.items() if k != "seed_rows"}
        print(f"# {summary}", file=sys.stderr, flush=True)
        rows.append(r)
    print(markdown_table(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
