#!/usr/bin/env python3
"""The order in which torch adds on a CUDA card, as the LM kernel L1
(``fccf_pcr_torch/csrc/lm.cu``) reproduces it.

    python3 tools/torch_sum_order.py [--rows N] [--device cuda]

For each row length n and each number R of rows a call sums,
``torch.sum(x, dim=-1)`` of (R, n) rows with entries of mixed sign and
magnitude (so that different orders round differently), over enough
calls to give a few thousand rows, against three float32 models of the
order, computed on the host with NumPy:

  - ``reduce``: torch's CUDA reduce kernel (``ATen/native/cuda/
    Reduce.cuh``: ``setReduceConfig`` and ``ReduceOp``), as L1 adds: a
    block of bw x bh threads, bw from the largest power of two <= n (<=
    n / 4 where n >= 128, read as float4 vectors) and bh from R, at most
    512 threads; thread (x, y) keeps its entries (x + k bw, or its
    vectors), or, where a row is split over the block's height, every
    bw bh-th, in four accumulators that start at 0 and are added in
    order; then a tree over the width at offsets bw / 2, ..., 1 and one
    over the height;
  - ``sequential``: ((x0 + x1) + x2) + ...;
  - ``fold``: ``ops/batch.py::fold_sum``.

Then ``x / 3.0`` and ``x / 48.0`` (a Python scalar) against x times the
float32 reciprocal and against the float32 division. Prints one line a
probe with the rows that differ from each model (0 = that model is
torch's order; ``reduce_fits`` says whether it is so at every probe), the
card's name and power limit, and the whole as JSON last. Exits non-zero without a card, unless ``--device cpu``.
"""

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

# Row lengths: L1 sums rows of 4F entries (F planes a lane).
LENGTHS = (3, 4, 12, 16, 48, 64, 100, 124, 128, 132, 256, 260, 512, 800,
           1024, 4096, 8192, 16384)
# Rows a call sums (L1: the lanes of a launch); the block's shape depends
# on them.
ROW_COUNTS = (4096, 96, 12, 1)
MAX_THREADS = 512  # Reduce.cuh's MAX_NUM_THREADS for float32


def _last_pow2(x):
    p = 1
    while 2 * p <= x:
        p *= 2
    return p


def reduce_config(n, R):
    """(bw, ny, vec) of setReduceConfig for R contiguous rows of n
    float32 entries, 16-byte aligned (csrc/lm.cu: sum_config)."""
    vec = n >= 128
    dim0 = n // 4 if vec else n
    d = _last_pow2(dim0) if dim0 < MAX_THREADS else MAX_THREADS
    r = _last_pow2(R) if R < MAX_THREADS else MAX_THREADS
    bw = min(d, 32)
    bh = min(r, MAX_THREADS // bw)
    bw = min(d, MAX_THREADS // bh)
    split = -(-n // bw) >= min(bh * 16, 256)
    return bw, (bh if split else 1), vec


def reduce_model(x, R):
    n = x.shape[-1]
    if n >= 128 and n % 4:
        raise ValueError("the model takes rows of n % 4 == 0 from 128 on")
    bw, ny, vec = reduce_config(n, R)
    step = bw * ny
    zero = np.zeros(x.shape[:-1], np.float32)
    vals = []
    for y in range(ny):
        for xx in range(bw):
            acc = [zero] * 4
            if vec:
                v = xx + y * bw
                while 4 * v + 3 < n:
                    acc = [acc[i] + x[..., 4 * v + i] for i in range(4)]
                    v += step
            else:
                idx = xx + y * bw
                while idx + 3 * step < n:
                    acc = [acc[i] + x[..., idx + i * step] for i in range(4)]
                    idx += 4 * step
                for i in range(4):
                    if idx >= n:
                        break
                    acc[i] = acc[i] + x[..., idx]
                    idx += step
            vals.append(((acc[0] + acc[1]) + acc[2]) + acc[3])
    for y in range(ny):  # block_x_reduce
        off = bw // 2
        while off:
            for i in range(off):
                vals[y * bw + i] = vals[y * bw + i] + vals[y * bw + i + off]
            off //= 2
    off = ny // 2  # block_y_reduce
    while off:
        for y in range(off):
            vals[y * bw] = vals[y * bw] + vals[(y + off) * bw]
        off //= 2
    return vals[0]


def sequential_model(x):
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


def fold_model(x):
    while x.shape[-1] > 1:
        n = x.shape[-1]
        h = n // 2
        head = x[..., :h] + x[..., h:2 * h]
        x = head if n % 2 == 0 else np.concatenate([head, x[..., 2 * h:]], -1)
    return x[..., 0]


MODELS = {"reduce": reduce_model,
          "sequential": lambda x, R: sequential_model(x),
          "fold": lambda x, R: fold_model(x)}


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
            out["sum"][key] = {k: int((m(x, R) != got).sum())
                               for k, m in MODELS.items()}
            out["sum"][key]["rows"] = calls * R
            print(f"[sum] n = {n}, {R} rows a call: rows differing from "
                  f"each model {out['sum'][key]}", flush=True)
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
