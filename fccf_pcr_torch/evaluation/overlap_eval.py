"""Success against partial overlap (port of ``tools/ab_overlap_eval.py``).

Sweeps the overlap of each pair over (1.0, 0.7, 0.5, 0.3) for the office
(indoor) and resso (building exterior) families, with ``--escalate-caps
auto``. The ground-truth transform of a seed is the same at every overlap
level (``io.synthetic.make_pair`` draws the window from its own rng), so
the curves are paired. One JSON record per (config, overlap) goes to
``--out``, and a ``CURVE`` line per config to stdout:

    python -m fccf_pcr_torch.evaluation.overlap_eval --seeds 24 \
        --out chiprun_out/overlap_eval.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ..pipeline.register import resolve_device
from . import configs
from .evaluate import evaluate_config

CONFIGS = ("office", "resso")
OVERLAPS = (1.0, 0.7, 0.5, 0.3)  # full overlap first
DEFAULT_OUT = os.path.join("chiprun_out", "overlap_eval.jsonl")


def overlap_curve(cfgs, overlaps, seeds, out_path, device="cuda"):
    """``evaluate_config`` with ``escalate_caps="auto"`` at each overlap
    level of each (name, cfg) of ``cfgs``, in that order; each record
    (the summary, ``overlap``, ``elapsed_s`` and ``seed_rows``) is written
    to ``out_path`` (a new file) as it completes. Returns the records."""
    device = resolve_device(device)  # no card: raise before any file opens
    rows = []
    with open(out_path, "w") as f:
        for name, cfg in cfgs.items():
            for ov in overlaps:
                cfg_ov = {**cfg, "pair": {**cfg["pair"], "overlap": ov}}
                t0 = time.time()
                r = evaluate_config(name, cfg_ov, seeds, cfg.get("batch", 8),
                                    escalate_caps="auto", device=device)
                rec = {k: v for k, v in r.items() if k != "seed_rows"}
                rec.update(step="overlap_eval", overlap=ov,
                           elapsed_s=round(time.time() - t0, 1),
                           seed_rows=r["seed_rows"])
                f.write(json.dumps(rec) + "\n")
                f.flush()
                rows.append(rec)
                print(f"[{name} overlap={ov}] success={r['success']:.2f} "
                      f"rre mean/p95 {r['rre_mean']:.3f}/{r['rre_p95']:.3f} "
                      f"rte mean/p95 {r['rte_mean']:.4f}/{r['rte_p95']:.4f} "
                      f"fails={r['fail_seeds']}", flush=True)
    return rows


def curve_lines(rows):
    """One ``CURVE`` line per config: success at each overlap level."""
    names = list(dict.fromkeys(r["config"] for r in rows))
    return [
        f"CURVE {name}: success @ overlap " + " ".join(
            f"{r['overlap']:.1f}:{100 * r['success']:.0f}%"
            for r in rows if r["config"] == name)
        for name in names
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m fccf_pcr_torch.evaluation.overlap_eval")
    ap.add_argument("--seeds", type=int, default=24,
                    help="seeds per (config, overlap) point")
    ap.add_argument("--out", default=DEFAULT_OUT, metavar="JSONL",
                    help="records, one per (config, overlap) point "
                         f"(default {DEFAULT_OUT})")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="cuda (default) needs a CUDA card; cpu runs the "
                         "kernels' plain versions")
    args = ap.parse_args(argv)
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    rows = overlap_curve({n: configs.CONFIGS[n] for n in CONFIGS}, OVERLAPS,
                         args.seeds, args.out, device=args.device)
    for line in curve_lines(rows):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
