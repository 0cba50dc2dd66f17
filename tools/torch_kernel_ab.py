#!/usr/bin/env python3
"""A/B of the LM kernel L1, the floor walk C2, the scans S1 and S2, the
faces kernels F1 and F2, fine verify's join and the hypotheses kernels
H1, H2 and H3 of two checkouts on one CUDA card, in turns (old, new, new,
old), at the inputs the batched main path gives them at batch 8
(heritage and office presets).

    python3 tools/torch_kernel_ab.py --parent DIR [--reps N] [--turns K]
        [--only lm,cluster,scan,faces,fine,hyp] [--f2-splits 2,4,16]
        [--f1-threads 32,128,256] [--fine-sources A.cu,B.cu]
        [--hyp-sources A.cu,B.cu]

``DIR`` holds the other checkout (unpack it with ``git archive`` into
the gitignored ``smoke_checkout/``); its ``fccf_pcr_torch/csrc/lm.cu``,
``csrc/cluster.cu``, ``csrc/scan.cu`` and ``csrc/faces.cu`` must export
the same C entry points as this tree's (``fccf_lm_refine``,
``fccf_cluster_floor_walk``, ``fccf_scan_int``, ``fccf_prefix_sum16``,
``fccf_faces_plane_fit``, ``fccf_faces_face_stats``,
``fccf_faces_segment_sum``), each bound by the signature its source has
(a ``faces.cu`` with ``fccf_faces_label_order`` takes this tree's
arguments; one without takes the sorted labels and the order: its arm
runs ``torch.sort`` by label first, as that tree's step does). They are
built with this tree's nvcc flags into ``fccf_pcr_torch/build/``. The inputs are recorded from this tree's
eager batch-8 step (``chip_smoke.py``'s ``lm_inputs`` /
``cluster_inputs`` / ``record_scans``). This tree's L1 must equal
``lm_loop`` run to its cap, its C2 the plain walk and its S1 / S2 their
plain versions, bit for bit; the other tree's outputs are compared and
reported. L1 is timed by CUDA events over ``--reps`` launches back to
back (both instantiations), C2 by its device time (CUPTI), S1, S2, F1
and F2 a call by CUDA events over a graph of 10 calls
(``chip_smoke.graph_ms``; F1 and F2 on the calls ``chip_smoke.
record_faces`` records, each held to its plain version; ``--f2-splits``
and ``--f1-threads`` add copies of this tree's ``faces.cu`` patched to
split every cloud over that many blocks (``kMaxSplits``, with
``kSplitRows`` 1) / to launch F1 in blocks of that many threads
(``kFitThreads``), each held to this tree's bits, as further arms of the
same turns;
a fused S2 call of this tree against the other tree's S2 on the columns
concatenated first, the concatenation timed with it, as that tree's step
runs it; the join on the calls ``chip_smoke.record_fine`` records, with
the other tree's ``csrc/fine.cu`` and each ``--fine-sources`` file as
further arms (a source with the two-kernel entries ``fccf_fine_lookup``
and ``fccf_fine_score``, as the tree up to commit 1662b43 has them, runs
as that tree's step ran it: its counters' fill, V1, V2; one with this
tree's entry behind this tree's wrapper), each held to this tree's
bits); H1, H2 and H3 on the calls ``chip_smoke.record_hypotheses``
records (H2 fed the same recorded matches and H3 the same recorded slots
in every arm), and H3 also on the heritage step's own call at the
capacities of ``--caps large`` and of the escalated preset
(``chip_smoke.record_emit``), with the other tree's
``csrc/hypotheses.cu`` and each ``--hyp-sources`` file as further arms
behind this tree's wrappers, each held to this tree's plain versions (H2
on its kept hits, H3 to ``emit_plain``), each in ``--turns`` rounds of
old, new, new, old (2K pairs); a line gives every time in order and each
arm's median, and a step's sum
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


def bind_faces(lib, source):
    """Bind F1's and F2's C entries by the signatures their source has: a
    source with ``fccf_faces_label_order`` takes the labels (this tree's),
    one without takes the sorted labels and the order (PR 15's)."""
    lib.from_labels = "fccf_faces_label_order" in source.read_text()
    if lib.from_labels:
        from fccf_pcr_torch.ops import faces_kernels as fk
        fk._bind(lib)
        return
    fn = lib.fccf_faces_plane_fit
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 2 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.fccf_faces_segment_scratch
    fn.argtypes = [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
    fn.restype = ctypes.c_longlong
    fn = lib.fccf_faces_segment_sum
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.fccf_faces_face_stats
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int


def bind_fine(lib, source):
    """Bind a ``fine.cu``'s C entries by the signature its source has: the
    two-kernel entries (``fccf_fine_lookup`` and ``fccf_fine_score``) or
    this tree's join."""
    if "fccf_fine_lookup" in source.read_text():
        bind_two_kernel_fine(lib)
    else:
        from fccf_pcr_torch.ops import fine_kernels as fnk
        fnk._bind(lib)


def bind_two_kernel_fine(lib):
    """The two-kernel entries' signatures on ``lib``."""
    fn = lib.fccf_fine_lookup
    fn.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.fccf_fine_score
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.fccf_fine_row_floats
    fn.argtypes = []
    fn.restype = ctypes.c_longlong


def bind_hyp(lib, source):
    """Bind a ``hypotheses.cu``'s C entries by the signature its source
    has: every source from the block-a-pair H1 and warp-a-match H2 on
    takes the same arguments, so each takes this tree's binding."""
    from fccf_pcr_torch.ops import hypotheses_kernels as hk

    if "int fccf_hyp_slots(" not in source.read_text():
        raise SystemExit(f"{source} exports no fccf_hyp_slots")
    hk._bind(lib)


def _stream(dev):
    import torch

    return torch.cuda.current_stream(dev).cuda_stream


def two_kernel_lookup(lib, T, table, pts, mask, params, hit, below):
    """The two-kernel source's V1 on fine verify's inputs (T (P, C, 4, 4),
    one leading pair axis), counted into ``hit`` and ``below``."""
    from fccf_pcr_torch.ops.voxelize import _inv

    (P, C), (M, Vf) = T.shape[:2], (mask.shape[-1], table.keys.shape[-1])
    rc = lib.fccf_fine_lookup(
        *(x.data_ptr() for x in (T, pts, mask, table.keys, table.cell_min,
                                 table.cell_max, hit, below)),
        P, C, M, Vf, _inv(params.fine_voxel), _stream(T.device))
    if rc:
        raise RuntimeError(f"fccf_fine_lookup returned {rc}")


def two_kernel_counts(lib, T, table, pts, mask, params):
    """The counters' fill and V1 of the two-kernel source: (hit, below)."""
    import torch

    counts = torch.zeros((2,) + tuple(T.shape[:2]) + table.keys.shape[-1:],
                         dtype=torch.int32, device=T.device)
    two_kernel_lookup(lib, T, table, pts, mask, params, counts[0], counts[1])
    return counts[0], counts[1]


def two_kernel_score(lib, hit, below, table, mask):
    """The two-kernel source's V2: the scores (P, C)."""
    import torch

    (P, C, Vf), M = hit.shape, mask.shape[-1]
    out = torch.empty((P, C), dtype=torch.float32, device=hit.device)
    width = (Vf + M + 1) // 2
    scratch = (torch.empty((P, C, width), dtype=torch.float32,
                           device=hit.device)
               if width > lib.fccf_fine_row_floats() else None)
    rc = lib.fccf_fine_score(
        *(x.data_ptr() for x in (hit, below, table.counts, table.n_src, mask,
                                 out)),
        None if scratch is None else scratch.data_ptr(), P, C, M, Vf,
        _stream(hit.device))
    if rc:
        raise RuntimeError(f"fccf_fine_score returned {rc}")
    return out


def two_kernel_join(lib, T, table, pts, mask, params):
    """The whole join of the two-kernel source, as its step ran it: the
    counters' fill, V1, V2. Returns the scores (P, C)."""
    return two_kernel_score(lib, *two_kernel_counts(lib, T, table, pts, mask,
                                                    params), table, mask)


def faces_variants(a):
    """This tree's ``csrc/faces.cu`` patched for ``--f1-threads`` and
    ``--f2-splits``: {arm: (the form it takes, source text)}."""
    src = (ROOT / "fccf_pcr_torch" / "csrc" / "faces.cu").read_text()

    def patch(text, old, new):
        if old not in text:
            raise SystemExit(f"{old!r} is not in csrc/faces.cu")
        return text.replace(old, new, 1)

    out = {}
    for v in (int(x) for x in a.f1_threads.split(",") if x):
        out[f"threads {v}"] = ("F1", patch(
            src, "constexpr int kFitThreads = 64;",
            f"constexpr int kFitThreads = {v};"))
    for v in (int(x) for x in a.f2_splits.split(",") if x):
        out[f"splits {v}"] = ("F2", patch(patch(
            src, "constexpr int kMaxSplits = 8;",
            f"constexpr int kMaxSplits = {v};"),
            "constexpr int kSplitRows = 1152;",
            "constexpr int kSplitRows = 1;"))
    return out


def behind_wrappers(lib, form, a):
    """The call of ``form`` on ``a`` through this tree's launcher, with
    ``lib`` (built from another ``faces.cu`` with this tree's entries) in
    place of this tree's library."""
    from fccf_pcr_torch.ops import faces_kernels as fk

    launch = {"plane_fit": fk._launch_plane_fit,
              "face_stats": fk._launch_face_stats,
              "values": fk._launch_segment_sum}[form]

    def call():
        kept = fk._LIBRARY._lib
        fk._LIBRARY._lib = lib
        try:
            return launch(*a)
        finally:
            fk._LIBRARY._lib = kept
    return call


def old_faces(lib, form, a, dev):
    """The other tree's F1 or F2 call on one recorded input (this tree's
    launch arguments): F2 of a tree that takes the sorted labels runs
    torch.sort by label first, as that tree's step does."""
    import math

    import torch

    from fccf_pcr_torch.ops import faces_kernels as fk

    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    if lib.from_labels:
        return behind_wrappers(lib, form, a)
    if form == "plane_fit":
        cov, centroid, count, valid, gc, pt, ct = a
        lead, V = tuple(valid.shape[:-1]), valid.shape[-1]

        def fit():
            out = [torch.empty(lead + (V, 3), device=dev),
                   torch.empty(lead + (V,), device=dev),
                   torch.empty(lead + (V,), dtype=torch.bool, device=dev),
                   torch.empty(lead + (V,), dtype=torch.bool, device=dev)]
            rc = lib.fccf_faces_plane_fit(
                cov.data_ptr(), centroid.data_ptr(), count.data_ptr(),
                valid.data_ptr(), gc.data_ptr(), *(o.data_ptr() for o in out),
                math.prod(lead), V, int(pt), float(ct), stream())
            if rc:
                raise RuntimeError(f"the parent's F1 launch failed: {rc}")
            return tuple(out)
        return fit
    if form == "face_stats":
        labels, valid, count, centroid, normal, V = a
        D, kind = 8, 1
    else:
        values, labels, valid, V = a
        D, kind = 1, 0
    lead, n = tuple(labels.shape[:-1]), labels.shape[-1]
    B = math.prod(lead)
    floats = int(lib.fccf_faces_segment_scratch(B, n, D, kind))
    scratch = torch.empty((max(floats, 1),), device=dev)

    def f2():
        seg_s, order = fk.sorted_labels(labels, valid, V)
        if form == "values":
            out = torch.empty(lead + (V,), device=dev)
            rc = lib.fccf_faces_segment_sum(
                seg_s.data_ptr(), order.data_ptr(), values.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), B, n, V, stream())
            outs = out
        else:
            outs = (torch.empty(lead + (V, 3), device=dev),
                    torch.empty(lead + (V, 3), device=dev),
                    torch.empty(lead + (V,), device=dev),
                    torch.empty(lead + (V,), dtype=torch.int32, device=dev))
            rc = lib.fccf_faces_face_stats(
                seg_s.data_ptr(), order.data_ptr(), count.data_ptr(),
                valid.data_ptr(), centroid.data_ptr(), normal.data_ptr(),
                *(o.data_ptr() for o in outs), scratch.data_ptr(), B, n, V,
                stream())
        if rc:
            raise RuntimeError(f"the parent's F2 launch failed: {rc}")
        return outs
    return f2


def faces_ab(old, variants, dev, smi, res, turns):
    """F1 and F2 of both trees in turns on the eager batch-8 steps' own
    calls, with the patched copies of this tree's ``faces.cu``
    (``variants``: {arm: (form, library)}) as further arms."""
    import chip_smoke as cs
    from fccf_pcr_torch.evaluation import configs
    from fccf_pcr_torch.models.fccf import get_model

    for name in ("heritage", "office"):
        model = get_model(configs.CONFIGS[name]["model"])
        args, _ = cs.config_batch(name, list(range(8)), model.params,
                                  model.caps, dev)
        calls = cs.record_faces(cs.eager_step(model.params, model.caps),
                                args)
        r = res.setdefault(name, {})
        r["faces"] = []
        for form, x in calls:
            kernel, plain, _ = cs.faces_forms(form, x)
            got = kernel()
            cs.check(cs.faces_equal(got, plain()),
                     f"{name}: {form} differs from plain")
            arms = {"old": old_faces(old, form, x, dev), "new": kernel}
            kind = "F1" if form == "plane_fit" else "F2"
            for arm, (k, lib) in variants.items():
                if k == kind:
                    arms[arm] = behind_wrappers(lib, form, x)
                    cs.check(cs.faces_equal(arms[arm](), got),
                             f"{name}: {form} at {arm} differs")
            names = list(arms)
            order = (names + names[::-1]) * turns
            shape = list((x[3] if form == "plane_fit" else
                          x[0] if form == "face_stats" else x[1]).shape)
            c = dict(what=form, shape=shape,
                     parent_equal=cs.faces_equal(arms["old"](), got),
                     us=[(arm, cs.graph_ms(arms[arm]) * 1e3)
                         for arm in order])
            r["faces"].append(c)
            meds = ", ".join(
                f"median {arm} "
                f"{statistics.median([us for y, us in c['us'] if y == arm]):.2f} us"
                for arm in names)
            print(f"[ab] {'F1' if form == 'plane_fit' else 'F2'} {name} "
                  f"{form} {shape} (parent's output equal: "
                  f"{c['parent_equal']}), a call: "
                  + ", ".join(f"{arm} {us:.2f} us" for arm, us in c["us"])
                  + f"; {meds} | {smi}", flush=True)
        f2 = [c for c in r["faces"] if c["what"] != "plane_fit"]
        step = [(arm, sum(c["us"][i][1] for c in f2))
                for i, (arm, _) in enumerate(f2[0]["us"])]
        r["F2_step_us"] = step
        print(f"[ab] F2 {name} batch-8 step, {len(f2)} calls summed: "
              + ", ".join(f"{arm} {us:.2f} us" for arm, us in step)
              + f" | {smi}", flush=True)


def fine_ab(sources, dev, smi, res, turns):
    """Fine verify's join of other ``fine.cu`` sources (``sources``: {arm:
    library}) against this tree's in turns on the eager batch-8 steps' own
    calls: a source with the two-kernel entries through
    ``two_kernel_join`` (its counters' fill, V1 and V2), one with this
    tree's entry behind this tree's wrapper."""
    import chip_smoke as cs
    from fccf_pcr_torch.evaluation import configs
    from fccf_pcr_torch.models.fccf import get_model
    from fccf_pcr_torch.ops import fine_kernels as fnk

    def behind(lib, x):
        def call():
            kept = fnk._LIBRARY._lib
            fnk._LIBRARY._lib = lib
            try:
                return fnk._launch_join(*x)
            finally:
                fnk._LIBRARY._lib = kept
        return call

    for name in ("heritage", "office"):
        model = get_model(configs.CONFIGS[name]["model"])
        args, _ = cs.config_batch(name, list(range(8)), model.params,
                                  model.caps, dev)
        calls = cs.record_fine(cs.eager_step(model.params, model.caps), args)
        r = res.setdefault(name, {})
        r["fine"] = []
        for form, x in calls:
            x = tuple(t.contiguous() if hasattr(t, "contiguous") else t
                      for t in x[:5])
            x = (x[0], type(x[1])(*(t.contiguous() for t in x[1]))) + x[2:]
            kernel, plain = cs.fine_forms(form, x)
            got = kernel()
            cs.check(cs.faces_equal(got, plain()),
                     f"{name}: {form} differs from plain")
            arms = {"new": kernel}
            for arm, lib in sources.items():
                arms[arm] = ((lambda lib=lib: two_kernel_join(lib, *x))
                             if hasattr(lib, "fccf_fine_lookup")
                             else behind(lib, x))
            for arm, call in arms.items():
                cs.check(cs.faces_equal(call(), got),
                         f"{name}: {form} at {arm} differs")
            names = list(arms)
            order = (names + names[::-1]) * turns
            c = dict(what=form, us=[(arm, cs.graph_ms(arms[arm]) * 1e3)
                                    for arm in order])
            r["fine"].append(c)
            meds = ", ".join(
                f"median {arm} "
                f"{statistics.median([us for y, us in c['us'] if y == arm]):.2f} us"
                for arm in names)
            print(f"[ab] {cs.FINE_FORMS[form]} {name} {form} "
                  f"{list(x[0].shape)}, a call: "
                  + ", ".join(f"{arm} {us:.2f} us" for arm, us in c["us"])
                  + f"; {meds} | {smi}", flush=True)


def hyp_ab(sources, dev, smi, res, turns):
    """H1, H2 and H3 of other ``hypotheses.cu`` sources (``sources``: {arm:
    library}) against this tree's in turns, behind this tree's wrappers,
    on the eager batch-8 steps' own calls; every arm held to this tree's
    plain versions (``chip_smoke.hyp_equal``: H2 on its kept hits, H3 to
    ``emit_plain``); H3 also on the heritage step's own call at the
    capacities of each of ``chip_smoke.HYP_EMIT_TIMED``."""
    import chip_smoke as cs
    from fccf_pcr_torch.evaluation import configs
    from fccf_pcr_torch.models.fccf import get_model
    from fccf_pcr_torch.ops import hypotheses_kernels as hk

    def behind(lib, form, x):
        def call():
            kept = hk._LIBRARY._lib
            hk._LIBRARY._lib = lib
            try:
                return getattr(hk, f"_launch_{form}")(*x)
            finally:
                hk._LIBRARY._lib = kept
        return call

    suites, args = [], {}
    for name in ("heritage", "office"):
        model = get_model(configs.CONFIGS[name]["model"])
        args[name], _ = cs.config_batch(name, list(range(8)), model.params,
                                        model.caps, dev)
        suites.append((name, cs.record_hypotheses(
            cs.eager_step(model.params, model.caps), args[name])))
    suites += [(what, [("emit", cs.record_emit(what, args["heritage"]))])
               for what in cs.HYP_EMIT_TIMED]
    for name, calls in suites:
        r = res.setdefault(name, {})
        r["hyp"] = []
        for form, x in calls:
            kernel, plain = cs.hyp_forms(form, x)
            want = plain()
            arms = {"new": kernel}
            arms.update({arm: behind(lib, form, x)
                         for arm, lib in sources.items()})
            for arm, call in arms.items():
                cs.check(cs.hyp_equal(form, call(), want),
                         f"{name}: {form} at {arm} differs from plain")
            names = ["old"] + [arm for arm in arms if arm != "old"]
            order = (names + names[::-1]) * turns
            c = dict(what=form, us=[(arm, cs.graph_ms(arms[arm]) * 1e3)
                                    for arm in order])
            r["hyp"].append(c)
            meds = ", ".join(
                f"median {arm} "
                f"{statistics.median([us for y, us in c['us'] if y == arm]):.2f} us"
                for arm in names)
            shape = list((x[2].valid if form == "slots" else x[0].count
                          if form == "emit" else x[0].valid).shape)
            label = {"matches": "H1", "slots": "H2", "emit": "H3"}[form]
            print(f"[ab] {label} {name} {form} "
                  f"{shape}, a call: "
                  + ", ".join(f"{arm} {us:.2f} us" for arm, us in c["us"])
                  + f"; {meds} | {smi}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=pathlib.Path)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--only", default="lm,cluster,scan,faces",
                    help="comma-separated: lm, cluster, scan, faces, fine, "
                    "hyp")
    ap.add_argument("--f2-splits", default="")
    ap.add_argument("--f1-threads", default="")
    ap.add_argument("--fine-sources", default="")
    ap.add_argument("--hyp-sources", default="")
    a = ap.parse_args()
    only = set(a.only.split(","))
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from fccf_pcr_torch.evaluation import configs
    from fccf_pcr_torch.models.fccf import get_model
    from fccf_pcr_torch.ops import cluster_kernels as ck
    from fccf_pcr_torch.ops import cuda_build
    from fccf_pcr_torch.ops import faces_kernels as fk
    from fccf_pcr_torch.ops import fine_kernels as fnk
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
    sources = [(src, a.parent / "fccf_pcr_torch" / "csrc" / src, bind)
               for src, bind, key in (
                   ("lm.cu", bind_lm, "lm"),
                   ("cluster.cu", lambda lib, _: ck._bind(lib), "cluster"),
                   ("scan.cu", bind_scan, "scan"),
                   ("faces.cu", bind_faces, "faces"),
                   ("fine.cu", bind_fine, "fine"),
                   ("hypotheses.cu", bind_hyp, "hyp"))
               if key in only]
    # More fine.cu arms, named by their file's stem.
    sources += [(pathlib.Path(x).stem, pathlib.Path(x), bind_fine)
                for x in a.fine_sources.split(",") if x and "fine" in only]
    sources += [(pathlib.Path(x).stem, pathlib.Path(x), bind_hyp)
                for x in a.hyp_sources.split(",") if x and "hyp" in only]
    for src, path, bind in sources:
        out = cuda_build.BUILD_DIR / f"ab_parent_{src.replace('.', '_')}.so"
        builds[src] = (subprocess.Popen(
            [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), out, lambda lib, b=bind, p=path: b(lib, p))
    variant_builds = {}
    for i, (arm, (kind, text)) in enumerate(
            faces_variants(a).items() if "faces" in only else ()):
        cu = cuda_build.BUILD_DIR / f"ab_variant_{i}.cu"
        cu.write_text(text)
        out = cu.with_suffix(".so")
        variant_builds[arm] = (subprocess.Popen(
            [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), out, kind)
    from fccf_pcr_torch.ops import hypotheses_kernels as hk

    cs.phase_build([lp, gt, ck, lmk, scan, fk, hk, fnk])
    old = {}
    for src, (proc, out, bind) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"FAIL: nvcc {src} of {a.parent}:\n{log}", file=sys.stderr)
            return 1
        old[src] = ctypes.CDLL(str(out))
        bind(old[src])
    variants = {}
    for arm, (proc, out, kind) in variant_builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"FAIL: nvcc faces.cu at {arm}:\n{log}", file=sys.stderr)
            return 1
        variants[arm] = (kind, ctypes.CDLL(str(out)))
        fk._bind(variants[arm][1])
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
    if "faces" in only:
        faces_ab(old["faces.cu"], variants, dev, smi, res, a.turns)
    def arms(main, extra):
        """The other tree's ``main`` source as "old", and the extra
        sources' libraries by their files' stems."""
        stems = {pathlib.Path(x).stem for x in extra.split(",") if x}
        return {"old" if src == main else src: lib
                for src, lib in old.items() if src == main or src in stems}

    if "fine" in only:
        fine_ab(arms("fine.cu", a.fine_sources), dev, smi, res, a.turns)
    if "hyp" in only:
        hyp_ab(arms("hypotheses.cu", a.hyp_sources), dev, smi, res, a.turns)
    for name in ("heritage", "office") if {"lm", "cluster"} <= only else ():
        kw = cs.lm_inputs(name, list(range(8)), dev)
        planes = tuple(kw[k].contiguous() for k in ("n1", "p1", "n2", "p2",
                                                   "w"))
        iters = kw["iters"]
        walk = cs.cluster_inputs(name, list(range(8)), dev)[1][0]
        new = lmk.lm_solve(*planes, iters)
        cs.check(torch.equal(lmk.refine_lm(*planes, iters),
                             gn.lm_loop(*planes, iters, early_exit=False)),
                 f"{name}: L1 differs from lm_loop")
        r = res.setdefault(name, {})
        r.update({
            "lanes": int(planes[0].shape[0]), "planes": int(planes[0].shape[1]),
            "steps": int(new[2].sum()), "most_steps": int(new[2].max()),
            "l1_parent_equal": all(torch.equal(x, y) for x, y in zip(
                old_l1(planes, iters, True), new))})
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
    for name in ("heritage", "office") if "scan" in only else ():
        model = get_model(configs.CONFIGS[name]["model"])
        args, _ = cs.config_batch(name, list(range(8)), model.params,
                                  model.caps, dev)
        calls = cs.record_scans(cs.eager_step(model.params, model.caps), args)
        r = res.setdefault(name, {})
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
