#!/usr/bin/env python3
"""The order in which torch adds a row of 3 or 4 entries on a CUDA card,
as the kernels that copy it reproduce it: ``tsum3`` and ``tsum4`` in the
LM kernel L1 (``fccf_pcr_torch/csrc/lm.cu``: n1.p1, the offsets, the
step's squared norm, the quaternion norm) and ``tsum3`` in C1
(``csrc/cluster.cu``). Longer sums of the port's kernels add in
``ops/batch.py::fold_sum``'s order, which no kernel needs torch for.

    python3 tools/torch_sum_order.py [--rows N] [--device cuda]

For n = 3 and 4 and each number R of rows a call sums,
``torch.sum(x, dim=-1)`` of (R, n) rows with entries of mixed sign and
magnitude (so that different orders round differently), over enough
calls to give a few thousand rows, against the float32 model of torch's
CUDA reduce kernel for rows that short (``ATen/native/cuda/Reduce.cuh``:
``setReduceConfig`` gives a block bw threads wide, bw the largest power
of two <= n, whatever R; thread x keeps entries x, x + bw, ... in four
accumulators that start at 0 and are added in order; then a tree over
the width at offsets bw / 2, ..., 1), computed on the host with NumPy.

Then ``x / 3.0`` and ``x / 48.0`` (a Python scalar) against x times the
float32 reciprocal and against the float32 division. Prints one line a
probe with the rows that differ from the model (0 = the model is
torch's order; ``reduce_fits`` says whether it is so at every probe), the
card's name and power limit, and the whole as JSON last. Exits non-zero
without a card, unless ``--device cpu``.
"""

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

# Row lengths: the kernels copy torch's order for 3- and 4-entry sums.
LENGTHS = (3, 4)
# Rows a call sums (L1: the lanes of a launch); for rows this short the
# block's shape does not depend on them.
ROW_COUNTS = (4096, 96, 12, 1)


def _last_pow2(x):
    p = 1
    while 2 * p <= x:
        p *= 2
    return p


def reduce_model(x):
    """torch's CUDA sum of each row of x (..., n), n < 128: thread xx of
    a block bw = _last_pow2(n) wide keeps entries xx, xx + bw, ... in four
    accumulators, added in order; then the tree over the width."""
    n = x.shape[-1]
    bw = _last_pow2(n)
    zero = np.zeros(x.shape[:-1], np.float32)
    vals = []
    for xx in range(bw):
        acc = [zero] * 4
        idx = xx
        while idx + 3 * bw < n:
            acc = [acc[i] + x[..., idx + i * bw] for i in range(4)]
            idx += 4 * bw
        for i in range(4):
            if idx >= n:
                break
            acc[i] = acc[i] + x[..., idx]
            idx += bw
        vals.append(((acc[0] + acc[1]) + acc[2]) + acc[3])
    off = bw // 2
    while off:
        for i in range(off):
            vals[i] = vals[i] + vals[i + off]
        off //= 2
    return vals[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=4096,
                    help="rows a (length, row count) probe sums in all")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("FAIL: no CUDA card", file=sys.stderr)
        return 1
    rng = np.random.default_rng(0)
    out = {"sum": {}, "scalar_division": {}}
    for n in LENGTHS:
        for R in ROW_COUNTS:
            calls = max(1, min(64, a.rows // R))
            x = (rng.normal(size=(calls, R, n))
                 * 10.0 ** rng.integers(-4, 5, (calls, R, n))
                 ).astype(np.float32)
            xd = torch.from_numpy(x).to(dev)
            got = torch.stack([torch.sum(xd[c], dim=-1)
                               for c in range(calls)]).cpu().numpy()
            key = f"{n}x{R}"
            out["sum"][key] = {"reduce": int((reduce_model(x) != got).sum()),
                               "rows": calls * R}
            print(f"[sum] n = {n}, {R} rows a call: rows differing from "
                  f"the model {out['sum'][key]}", flush=True)
    out["reduce_fits"] = all(v["reduce"] == 0 for v in out["sum"].values())
    x = rng.uniform(1e-10, 1e8, a.rows).astype(np.float32)
    for d in (3.0, 48.0):
        got = (torch.from_numpy(x).to(dev) / d).cpu().numpy()
        recip = x * (np.float32(1.0) / np.float32(d))
        out["scalar_division"][d] = {
            "times_reciprocal": int((recip != got).sum()),
            "division": int((x / np.float32(d) != got).sum())}
        print(f"[div] x / {d}: rows differing {out['scalar_division'][d]} "
              f"of {a.rows}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() if dev.type == "cuda" \
        else "cpu"
    print(smi)
    out.update(device=str(dev), torch=torch.__version__, card=smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
