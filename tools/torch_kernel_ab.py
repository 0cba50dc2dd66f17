#!/usr/bin/env python3
"""A/B of the LM kernel L1, the floor walk C2 and the scans S1 and S2 of
two checkouts on one CUDA card, in turns (old, new, new, old), at the
inputs the batched main path gives them at batch 8 (heritage and office
presets).

    python3 tools/torch_kernel_ab.py --parent DIR [--reps N] [--turns K]

``DIR`` holds the other checkout (unpack it with ``git archive`` into
the gitignored ``smoke_checkout/``); its ``fccf_pcr_torch/csrc/lm.cu``,
``csrc/cluster.cu`` and ``csrc/scan.cu`` must export the same C entry
points as this tree's (``fccf_lm_refine``, ``fccf_cluster_floor_walk``,
``fccf_scan_int``, ``fccf_prefix_sum16``), each bound by the signature
its source has. They are built with this tree's nvcc flags into
``fccf_pcr_torch/build/``. The inputs are recorded from this tree's
eager batch-8 step (``chip_smoke.py``'s ``lm_inputs`` /
``cluster_inputs`` / ``record_scans``). This tree's L1 must equal
``lm_loop`` run to its cap, its C2 the plain walk and its S1 / S2 their
plain versions, bit for bit; the other tree's outputs are compared and
reported. L1 is timed by CUDA events over ``--reps`` launches back to
back (both instantiations), C2 by its device time (CUPTI), S1 and S2 a
call by CUDA events over a graph of 10 calls (``chip_smoke.graph_ms``;
a fused S2 call of this tree against the other tree's S2 on the columns
concatenated first, the concatenation timed with it, as that tree's step
runs it), each in ``--turns`` rounds of old, new, new, old (2K pairs); a
line gives every time in order and each arm's median, and a step's sum
of S1's and of S2's calls a turn. Prints one line a comparison with the
card's name and power limit, and the whole as JSON last. Exits non-zero
without a card or when a check fails.
"""

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def bind_lm(lib, source):
    """Bind L1's C entry by the signature its source has: with or without
    the accepted-step counts (PR 12 added them, before the scratch)."""
    lib.accepted_out = "accepted_out" in source.read_text()
    fn = lib.fccf_lm_refine
    fn.argtypes = [ctypes.c_void_p] * (10 if lib.accepted_out else 9) + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.fccf_lm_scratch_floats
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_longlong


def bind_scan(lib, source):
    """Bind S1's and S2's C entries by the signatures their source has:
    a source that exports ``fccf_scan_tiles`` takes a totals buffer of
    rows x tiles int64 for S1, one that exports
    ``fccf_scan_scratch_bytes`` a scratch of that many bytes."""
    lib.tiles_totals = "fccf_scan_tiles" in source.read_text()
    fn = lib.fccf_scan_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_longlong] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.fccf_scan_tiles if lib.tiles_totals else lib.fccf_scan_scratch_bytes
    fn.argtypes = [ctypes.c_longlong] * (1 if lib.tiles_totals else 2)
    fn.restype = ctypes.c_longlong
    fn = lib.fccf_prefix_sum16
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.fccf_prefix_sum16_scratch
    fn.argtypes = [ctypes.c_longlong]
    fn.restype = ctypes.c_longlong


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=pathlib.Path)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--turns", type=int, default=1)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from fccf_pcr_torch.evaluation import configs
    from fccf_pcr_torch.models.fccf import get_model
    from fccf_pcr_torch.ops import cluster_kernels as ck
    from fccf_pcr_torch.ops import cuda_build
    from fccf_pcr_torch.ops import gather as gt
    from fccf_pcr_torch.ops import label_prop as lp
    from fccf_pcr_torch.ops import scan
    from fccf_pcr_torch.refine import gauss_newton as gn
    from fccf_pcr_torch.refine import lm_kernel as lmk

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    builds = {}
    for src, bind in (("lm.cu", bind_lm),
                      ("cluster.cu", lambda lib, _: ck._bind(lib)),
                      ("scan.cu", bind_scan)):
        out = cuda_build.BUILD_DIR / f"ab_parent_{src[:-3]}.so"
        path = a.parent / "fccf_pcr_torch" / "csrc" / src
        builds[src] = (subprocess.Popen(
            [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), out, lambda lib, b=bind, p=path: b(lib, p))
    cs.phase_build([lp, gt, ck, lmk, scan])
    old = {}
    for src, (proc, out, bind) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"FAIL: nvcc {src} of {a.parent}:\n{log}", file=sys.stderr)
            return 1
        old[src] = ctypes.CDLL(str(out))
        bind(old[src])
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731

    def old_l1(planes, iters, regs):
        Bt, F = planes[4].shape
        q = torch.empty((Bt, 4), device=dev)
        t = torch.empty((Bt, 3), device=dev)
        st = torch.empty((Bt,), dtype=torch.int32, device=dev)
        scratch = None if regs else torch.empty(
            (Bt, int(old["lm.cu"].fccf_lm_scratch_floats(F))), device=dev)
        acc = [torch.empty((Bt,), dtype=torch.int32, device=dev).data_ptr()
               ] if old["lm.cu"].accepted_out else []
        rc = old["lm.cu"].fccf_lm_refine(
            *(x.data_ptr() for x in planes), q.data_ptr(), t.data_ptr(),
            st.data_ptr(), *acc,
            None if scratch is None else scratch.data_ptr(),
            Bt, F, iters, int(regs), stream())
        cs.check(rc == 0, f"the parent's L1 launch failed: {rc}")
        return q, t, st

    def old_c2(s, c):
        out = torch.empty(s.shape, dtype=torch.bool, device=dev)
        rc = old["cluster.cu"].fccf_cluster_floor_walk(
            s.data_ptr(), c.data_ptr(), out.data_ptr(),
            s.numel() // s.shape[-1], s.shape[-1], stream())
        cs.check(rc == 0, f"the parent's C2 launch failed: {rc}")
        return out

    def old_s1(x, op):
        lib = old["scan.cu"]
        n = x.shape[-1]
        rows = x.reshape(-1, n)
        if rows.stride(-1) != 1:
            rows = rows.contiguous()
        out = torch.empty(x.shape, device=dev, dtype=torch.int64
                          if op == scan.SUM else x.dtype)
        if lib.tiles_totals:
            tiles = int(lib.fccf_scan_tiles(n))
            scratch = torch.empty((rows.shape[0] * tiles if tiles > 1 else 0,),
                                  dtype=torch.int64, device=dev)
        else:
            scratch = torch.empty(
                (int(lib.fccf_scan_scratch_bytes(rows.shape[0], n)),),
                dtype=torch.uint8, device=dev)
        rc = lib.fccf_scan_int(rows.data_ptr(), out.data_ptr(),
                               scratch.data_ptr(), op,
                               scan._IN_TYPES[x.dtype], rows.shape[0], n,
                               rows.stride(0), stream())
        cs.check(rc == 0, f"the parent's S1 launch failed: {rc}")
        return out

    def old_s2(x3):
        lib = old["scan.cu"]
        B, n, D = x3.shape
        out = torch.empty_like(x3)
        scratch = torch.empty((B * D * int(lib.fccf_prefix_sum16_scratch(n)),),
                              device=dev)
        rc = lib.fccf_prefix_sum16(x3.data_ptr(), out.data_ptr(),
                                   scratch.data_ptr(), B, n, D, stream())
        cs.check(rc == 0, f"the parent's S2 launch failed: {rc}")
        return out

    def old_scan(kernel, x, op):
        """The other tree's call for one recorded S1 / S2 input: a fused
        call as its columns concatenated, then its S2."""
        if kernel == "S1":
            return lambda: old_s1(x, op)
        if op is None:
            return lambda: old_s2(x)
        columns = scan.leaf_columns if op == "leaf" else scan.moment_columns

        def run():
            cols = columns(*x)
            return old_s2(cols.reshape(-1, *cols.shape[-2:])).view(cols.shape)
        return run

    order = ("old", "new", "new", "old") * a.turns

    def medians(times):
        return ", ".join(
            f"median {arm} "
            f"{statistics.median([us for x, us in times if x == arm]):.2f} us"
            for arm in ("old", "new"))

    res = {"card": smi, "parent": str(a.parent)}
    for name in ("heritage", "office"):
        kw = cs.lm_inputs(name, list(range(8)), dev)
        planes = tuple(kw[k].contiguous() for k in ("n1", "p1", "n2", "p2",
                                                   "w"))
        iters = kw["iters"]
        walk = cs.cluster_inputs(name, list(range(8)), dev)[1][0]
        new = lmk.lm_solve(*planes, iters)
        cs.check(torch.equal(lmk.refine_lm(*planes, iters),
                             gn.lm_loop(*planes, iters, early_exit=False)),
                 f"{name}: L1 differs from lm_loop")
        r = res[name] = {
            "lanes": int(planes[0].shape[0]), "planes": int(planes[0].shape[1]),
            "steps": int(new[2].sum()), "most_steps": int(new[2].max()),
            "l1_parent_equal": all(torch.equal(x, y) for x, y in zip(
                old_l1(planes, iters, True), new))}
        for regs in (True, False):
            arms = {"old": lambda: old_l1(planes, iters, regs),
                    "new": lambda: lmk.lm_solve(*planes, iters,
                                                registers=regs)}
            key = "l1_us" if regs else "l1_scratch_us"
            r[key] = [(arm, cs.cuda_ms(arms[arm], a.reps) * 1e3)
                      for arm in order]
            print(f"[ab] L1 {'registers' if regs else 'scratch'} {name} "
                  f"({r['lanes']} lanes x {r['planes']} planes, "
                  f"{r['steps']} LM steps, most {r['most_steps']} a lane; "
                  f"parent's q, t, steps equal: {r['l1_parent_equal']}): "
                  + ", ".join(f"{arm} {us:.2f} us" for arm, us in r[key])
                  + f"; {medians(r[key])} | {smi}", flush=True)
        got = ck.floor_walk(*walk)
        cs.check(torch.equal(got, ck.floor_walk_plain(*walk)),
                 f"{name}: C2 differs from the plain walk")
        cs.check(torch.equal(old_c2(*walk), got),
                 f"{name}: the parent's C2 differs from this tree's")
        arms = {"old": lambda: old_c2(*walk),
                "new": lambda: ck.floor_walk(*walk)}
        r["c2_us"] = [(arm, cs.device_ms(
            arms[arm], a.reps, only="cluster_floor_walk_kernel") * 1e3)
            for arm in order]
        print(f"[ab] C2 {name} {tuple(walk[0].shape)} (both equal to the "
              "plain walk), device time: "
              + ", ".join(f"{arm} {us:.2f} us" for arm, us in r["c2_us"])
              + f"; {medians(r['c2_us'])} | {smi}", flush=True)
    names = {0: "cumsum", 1: "cummax", 2: "rev_cummin", None: "prefix_sum",
             "leaf": "leaf_prefix_sums", "moments": "moment_prefix_sums"}
    for name in ("heritage", "office"):
        model = get_model(configs.CONFIGS[name]["model"])
        args, _ = cs.config_batch(name, list(range(8)), model.params,
                                  model.caps, dev)
        calls = cs.record_scans(cs.eager_step(model.params, model.caps), args)
        r = res[name]
        r["scans"] = []
        for kernel, x, op in calls:
            arms = {"old": old_scan(kernel, x, op),
                    "new": cs.scan_forms(kernel, x, op)[0]}
            got = arms["new"]()
            cs.check(cs.scan_equal(kernel, got, cs.scan_forms(kernel, x,
                                                              op)[1]()),
                     f"{name}: {kernel} {names[op]} differs from plain")
            c = dict(kernel=kernel, what=names[op],
                     shape=list((x[-1] if isinstance(x, tuple) else x).shape),
                     parent_equal=cs.scan_equal(kernel, arms["old"](), got),
                     us=[(arm, cs.graph_ms(arms[arm]) * 1e3)
                         for arm in order])
            r["scans"].append(c)
            print(f"[ab] {kernel} {name} {c['what']} {c['shape']} (parent's "
                  f"output equal: {c['parent_equal']}), a call: "
                  + ", ".join(f"{arm} {us:.2f} us" for arm, us in c["us"])
                  + f"; {medians(c['us'])} | {smi}", flush=True)
        for kernel in ("S1", "S2"):
            mine = [c for c in r["scans"] if c["kernel"] == kernel]
            turns = [(arm, sum(c["us"][i][1] for c in mine))
                     for i, arm in enumerate(order)]
            r[f"{kernel}_step_us"] = turns
            print(f"[ab] {kernel} {name} batch-8 step, {len(mine)} calls "
                  "summed: " + ", ".join(f"{arm} {us:.2f} us"
                                         for arm, us in turns)
                  + f"; {medians(turns)} | {smi}", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
