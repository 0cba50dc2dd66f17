#!/usr/bin/env python3
"""Times this tree's scans S1 and S2 (``fccf_pcr_torch/csrc/scan.cu``)
against variants of that source on one CUDA card, in turns, at the
heritage batch-8 step's long-row shapes on seeded synthetic data.

    python3 tools/torch_scan_variants.py DIR [DIR ...] [--reps N]

Each ``DIR`` holds a variant ``fccf_pcr_torch/csrc/scan.cu`` with this
tree's C entry points (``fccf_scan_int``, ``fccf_scan_scratch_bytes``,
``fccf_prefix_sum16_leaf``, ``fccf_prefix_sum16_moments`` and
``fccf_prefix_sum16_scratch``), such as a block size changed; it is built
with this tree's nvcc flags into ``fccf_pcr_torch/build/``. Every
variant's output must equal this tree's plain version bit for bit. S1 is
timed on cummax (16, 245760) int64, cumsum (16, 245760) bool, reversed
cummin (8, 12, 86016) int64 and cumsum (16, 9216) bool; S2 on the leaf
and moment columns of (16, 245760) sources. Each call is timed as a CUDA
graph of ``--reps`` calls (``chip_smoke.graph_ms``) in turns, this tree
first, then the variants, then back in reverse order; a line gives every
time with the card's name and power limit, another each library's
kernels by device time (CUPTI) in one call. The whole is JSON last.
Exits non-zero without a card or when a check fails.
"""

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+", type=pathlib.Path)
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args()
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from fccf_pcr_torch.ops import cuda_build, scan

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    libs = {"this": scan.build(force=True)}
    for d in a.variants:
        out = cuda_build.BUILD_DIR / f"variant_{d.name}.so"
        proc = subprocess.run(
            [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out),
             str(d / "fccf_pcr_torch" / "csrc" / "scan.cu")],
            capture_output=True, text=True)
        if proc.returncode:
            print(f"FAIL: nvcc {d}:\n{proc.stdout}{proc.stderr}",
                  file=sys.stderr)
            return 1
        libs[d.name] = ctypes.CDLL(str(out))
        scan._bind(libs[d.name])

    def stream():  # the current one: a CUDA graph captures on its own
        return torch.cuda.current_stream(dev).cuda_stream

    rng = np.random.default_rng(0)

    def on_card(x):
        return torch.from_numpy(x).to(dev)

    def s1(lib, x, op):
        n = x.shape[-1]
        rows = x.reshape(-1, n)
        out = torch.empty(x.shape, device=dev, dtype=torch.int64
                          if op == scan.SUM else x.dtype)
        scratch = torch.empty(
            (int(lib.fccf_scan_scratch_bytes(rows.shape[0], n)),),
            dtype=torch.uint8, device=dev)
        rc = lib.fccf_scan_int(rows.data_ptr(), out.data_ptr(),
                               scratch.data_ptr(), op,
                               scan._IN_TYPES[x.dtype], rows.shape[0], n,
                               rows.stride(0), stream())
        cs.check(rc == 0, f"S1 launch failed: {rc}")
        return out

    def s2(lib, kind, sources):
        B, n = sources[-1].shape
        D = 4 if kind == "leaf" else 10
        out = torch.empty((B, n, D), device=dev)
        scratch = torch.empty(
            (B * D * int(lib.fccf_prefix_sum16_scratch(n)),), device=dev)
        entry = (lib.fccf_prefix_sum16_leaf if kind == "leaf"
                 else lib.fccf_prefix_sum16_moments)
        rc = entry(*(t.data_ptr() for t in sources), out.data_ptr(),
                   scratch.data_ptr(), B, n, stream())
        cs.check(rc == 0, f"S2 launch failed: {rc}")
        return out

    big = rng.integers(0, 2**40, (16, 245760))
    p = on_card(rng.uniform(-2, 2, (16, 245760, 3)).astype(np.float32))
    mask = on_card(rng.uniform(size=(16, 245760)) < 0.7)
    first = on_card(rng.uniform(size=(16, 245760)) < 0.2)
    px, py, pz = (p[..., k].contiguous() for k in range(3))
    cases = [
        ("S1 cummax", lambda lib, x: s1(lib, x, scan.MAX),
         on_card(np.maximum.accumulate(big, axis=1)
                 * (rng.uniform(size=big.shape) < 0.3)),
         lambda x: scan.int_scan_plain(x, scan.MAX)),
        ("S1 cumsum", lambda lib, x: s1(lib, x, scan.SUM),
         on_card(rng.uniform(size=(16, 245760)) < 0.3),
         lambda x: scan.int_scan_plain(x, scan.SUM)),
        ("S1 rev_cummin", lambda lib, x: s1(lib, x, scan.MIN_REVERSED),
         on_card(rng.integers(0, 2**31 - 1, (8, 12, 86016))),
         lambda x: scan.int_scan_plain(x, scan.MIN_REVERSED)),
        ("S1 cumsum", lambda lib, x: s1(lib, x, scan.SUM),
         on_card(rng.uniform(size=(16, 9216)) < 0.3),
         lambda x: scan.int_scan_plain(x, scan.SUM)),
        ("S2 leaf", lambda lib, x: s2(lib, "leaf", x),
         (px, py, pz, mask, first), lambda x: scan.leaf_sums_plain(*x)),
        ("S2 moments", lambda lib, x: s2(lib, "moments", x), (p, mask),
         lambda x: scan.moment_sums_plain(*x)),
    ]
    order = list(libs) + list(reversed(list(libs)))
    res = {"card": smi, "variants": [str(d) for d in a.variants],
           "calls": []}
    for what, call, x, plain in cases:
        shape = tuple((x[-1] if isinstance(x, tuple) else x).shape)
        want = plain(x)
        for name, lib in libs.items():
            cs.check(cs.scan_equal(what[:2], call(lib, x), want),
                     f"{what} {shape}: {name} differs from plain")
        us = [(name, cs.graph_ms(lambda: call(libs[name], x), a.reps) * 1e3)
              for name in order]
        kernels = {}
        for name, lib in libs.items():
            call(lib, x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call(lib, x)
                torch.cuda.synchronize()
            kernels[name] = [
                (e.name().replace("void ", "").replace(
                    "(anonymous namespace)::", "").split("<")[0].split("(")[0],
                 cs.record_ms(e) * 1e3) for e in cs.device_records(prof)]
        res["calls"].append(dict(what=what, shape=shape, us=us,
                                 kernels=kernels))
        print(f"[variants] {what} {shape}, a call in turns: "
              + ", ".join(f"{n} {t:.2f} us" for n, t in us)
              + f" | {smi}", flush=True)
        for name, ks in kernels.items():
            print(f"[variants]   {name}: "
                  + "; ".join(f"{k} {t:.2f} us" for k, t in ks), flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
