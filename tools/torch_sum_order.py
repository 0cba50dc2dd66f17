#!/usr/bin/env python3
"""The order in which torch adds on a CUDA card, as the LM kernel L1
(``fccf_pcr_torch/csrc/lm.cu``) reproduces it.

    python3 tools/torch_sum_order.py [--rows N] [--device cuda]

For each row length n, ``torch.sum(x, dim=-1)`` of rows with entries of
mixed sign and magnitude (so that different orders round differently)
against three float32 models of the order, computed on the host with
NumPy:

  - ``reduce``: torch's CUDA reduce kernel for a row of n <= 128 entries,
    as L1 adds: bw = min(largest power of two <= n, 32) threads, thread x
    keeping entries x + k bw (k < 4; at n = 128, which torch reads as
    float4 vectors, entries 4x .. 4x + 3) in accumulators that start at 0
    and are added in order, then a shuffle tree at offsets bw / 2, ...,
    2, 1;
  - ``sequential``: ((x0 + x1) + x2) + ...;
  - ``fold``: ``ops/batch.py::fold_sum``.

Then ``x / 3.0`` and ``x / 48.0`` (a Python scalar) against x times the
float32 reciprocal and against the float32 division. Prints one line a
probe with the rows that differ from each model (0 = that model is
torch's order), the card's name and power limit, and the whole as JSON
last. Exits non-zero without a card, unless ``--device cpu``.
"""

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

LENGTHS = (3, 4, 12, 16, 48, 64, 100, 124, 128)


def reduce_model(x):
    n = x.shape[-1]
    bw = 1
    while 2 * bw <= n and 2 * bw <= 32:
        bw *= 2
    zero = np.float32(0.0)
    lanes = []
    for lane in range(bw):
        idx = (range(4 * lane, 4 * lane + 4) if n == 128 else
               (lane + k * bw for k in range(4)))
        acc = [zero + x[..., i] if i < n else np.zeros(x.shape[:-1],
                                                        np.float32)
               for i in idx]
        lanes.append(((acc[0] + acc[1]) + acc[2]) + acc[3])
    off = bw // 2
    while off:
        lanes = [lanes[i] + lanes[i + off] for i in range(off)]
        off //= 2
    return lanes[0]


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


MODELS = {"reduce": reduce_model, "sequential": sequential_model,
          "fold": fold_model}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("FAIL: no CUDA card", file=sys.stderr)
        return 1
    rng = np.random.default_rng(0)
    out = {"sum": {}, "scalar_division": {}}
    for n in LENGTHS:
        x = (rng.normal(size=(a.rows, n))
             * 10.0 ** rng.integers(-4, 5, (a.rows, n))).astype(np.float32)
        got = torch.sum(torch.from_numpy(x).to(dev), dim=-1).cpu().numpy()
        out["sum"][n] = {k: int((m(x) != got).sum())
                         for k, m in MODELS.items()}
        print(f"[sum] n = {n}: rows differing from each model "
              f"{out['sum'][n]} of {a.rows}", flush=True)
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
