#!/usr/bin/env python3
"""How far the LM refinement's result moves with rounding, on the CPU: one
golden pair through the port's register_pair, whose refine_pairs inputs
(the matched plane pairs of the per-type top-K candidates) are then
refined three ways on identical inputs: the port, the JAX package's
refine_pairs compiled over the candidates (jit of vmap, as its pipeline
runs it) and compiled one candidate at a time (jit).

    python3 tools/lm_spread.py [--config resso] [--seed 1]

Prints, per candidate, its number of matched pairs and the largest
difference of the transform entries between each two of the three, then
the port's fine scores against the golden row's. Needs jax (the reference)
and runs on the CPU only.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="resso")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    import jax
    import numpy as np
    import torch

    jax.config.update("jax_platforms", "cpu")
    import bench
    from fccf_pcr_tpu.refine import gauss_newton as jgn
    from fccf_pcr_torch import make_register_fn, pre_downsample
    from fccf_pcr_torch.io import synthetic
    from fccf_pcr_torch.models.fccf import get_model
    from fccf_pcr_torch.refine import gauss_newton as tgn
    from fccf_pcr_torch.verify import quick

    cfg = bench.CONFIGS[args.config]
    model = get_model(cfg["model"])
    params, caps = model.params, model.caps
    src, tar, _ = synthetic.make_pair(seed=args.seed, **cfg["scene"],
                                      **cfg["pair"])
    clouds = [synthetic.pad_points(c, caps.raw_points) for c in (src, tar)]
    (sp, sm, _), (tp, tm, _) = (pre_downsample(p, m, params, caps, device="cpu")
                                for p, m in clouds)
    captured = []
    refine = quick.refine_pairs

    def record(**kw):
        captured.append({k: v.numpy().copy() if torch.is_tensor(v) else v
                         for k, v in kw.items()})
        return refine(**kw)

    quick.refine_pairs = record
    try:
        res = make_register_fn(params, caps, device="cpu")(sp, sm, tp, tm)
    finally:
        quick.refine_pairs = refine
    kw = captured[0]
    a = [kw[k] for k in ("n1", "p1", "n2", "p2", "w")]
    iters = kw["iters"]
    port = tgn.refine_pairs(*map(torch.from_numpy, a), iters=iters).numpy()
    vmapped = np.asarray(jax.jit(jax.vmap(
        lambda *x: jgn.refine_pairs(*x, iters=iters)))(*a))
    one = jax.jit(lambda *x: jgn.refine_pairs(*x, iters=iters))
    per_lane = np.stack([np.asarray(one(*(x[b] for x in a)))
                         for b in range(len(port))])
    for b in range(len(port)):
        print(f"candidate {b}: {int((a[4][b] > 0).sum())} matched pairs; "
              f"max |dT| port-vmapped {np.abs(port[b] - vmapped[b]).max():.3g}"
              f", vmapped-per-candidate "
              f"{np.abs(vmapped[b] - per_lane[b]).max():.3g}, port-per-"
              f"candidate {np.abs(port[b] - per_lane[b]).max():.3g}")
    row = next(r for r in json.loads(
        (ROOT / "tests" / "golden" / "pipeline.json").read_text()
    )["configs"][args.config] if r["seed"] == args.seed)
    print(f"fine scores: port {res.fine_score.tolist()}, pinned "
          f"{row['fine_score']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
