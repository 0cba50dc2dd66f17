"""Command-line interface of the PyTorch port (port of
``fccf_pcr_tpu/cli.py``), contract-compatible with the reference CLI
(FCCF.cpp:1646-1690):

    python -m fccf_pcr_torch SRC.ply TAR.ply VOXEL_SIZE

prints "Leaf size : <v>" and the 4x4 transformation matrix mapping SRC
into TAR's frame. The same extras as the JAX package's CLI: ``--json``,
``--batch A B C...`` (consecutive pairs), ``--out`` (a streamed,
resumable sweep), ``--caps`` (a preset, or ``auto``), ``--escalate-caps``,
``--set KEY=VALUE`` and ``--native-io``. ``--device cuda`` (the default)
needs a CUDA card and fails without one; ``--device cpu`` runs the plain
versions of the kernels.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _caps_preset(name):
    from .config import Capacities, TEST_CAPS
    from .models.fccf import REGISTRY

    if name == "tiny":
        return TEST_CAPS
    if name in REGISTRY:  # measured model presets (eth-*, resso, heritage)
        return REGISTRY[name].caps
    if name == "large":
        return Capacities(
            max_points=1 << 19,
            max_voxels=8192,
            max_matches=4096,
            max_hypotheses=16384,
            max_residual=1 << 17,
            max_fine_voxels=1 << 16,
        )
    return Capacities()


def _coerce(params, key, val):
    field_type = type(getattr(params, key))
    # bool("0") is True and int("0.5") raises: numerics go through float.
    if field_type is bool:
        return val.lower() in ("1", "true", "yes", "on")
    if field_type in (int, float):
        return field_type(float(val))
    return field_type(val)


def main(argv=None):
    from .models.fccf import REGISTRY

    ap = argparse.ArgumentParser(
        prog="fccf",
        description="FCCF-PCR point cloud registration (PyTorch / CUDA)",
    )
    ap.add_argument("source", nargs="?", help="source PLY file")
    ap.add_argument("target", nargs="?", help="target PLY file")
    ap.add_argument("voxel", nargs="?", type=float, default=0.1,
                    help="voxel-grid leaf size in meters (default 0.1)")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument("--caps", default="default",
                    choices=["tiny", "default", "large", "auto",
                             *(k for k in REGISTRY if k != "tiny")],
                    help="capacity preset; 'auto' sizes the bounds from "
                         "the loaded scans (models/auto.py) and pairs "
                         "with an escalation envelope")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="cuda (default) needs a CUDA card; cpu runs the "
                         "kernels' plain versions")
    ap.add_argument("--batch", nargs="+", default=None, metavar="PLY",
                    help="register consecutive pairs of this scan list")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    dest="overrides",
                    help="override any FCCFParams field (e.g. --set "
                         "curvature_threshold=0.08)")
    ap.add_argument("--out", default=None, metavar="JSONL",
                    help="with --batch: stream per-pair records to this file "
                         "(checkpoint/resume on restart)")
    ap.add_argument("--escalate-caps", default=None, metavar="PRESET",
                    choices=["default", "large",
                             *(k for k in REGISTRY if k != "tiny")],
                    help="re-run any pair whose status shows a capacity hit "
                         "under this larger preset")
    ap.add_argument("--native-io", action="store_true",
                    help="load the scan list with the threaded C++ batch "
                         "loader (built by make -C csrc; without it, a "
                         "warning and the Python reader)")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda requested but torch.cuda.is_available() is "
                 "False (no CUDA card or no CUDA build of torch); use "
                 "--device cpu")
    device = torch.device(args.device)

    from . import FCCFParams, __version__, make_register_fn
    from .io.synthetic import pad_points
    from .pipeline.register import pre_downsample

    params = FCCFParams(leaf_size=args.voxel)
    for ov in args.overrides:
        key, _, val = ov.partition("=")
        if not hasattr(params, key):
            ap.error(f"unknown parameter '{key}'")
        params = params.replace(**{key: _coerce(params, key, val)})
    # "auto" sizes capacities from the loaded clouds (below), and derives
    # its escalation envelope when --escalate-caps was not given.
    caps = None if args.caps == "auto" else _caps_preset(args.caps)
    escalate_caps = (
        _caps_preset(args.escalate_caps) if args.escalate_caps else None
    )

    def resolve_caps(caps, escalate_caps, clouds):
        if caps is None:
            from .models.auto import auto_caps, auto_escalation_caps

            caps = auto_caps(clouds, params)
            if escalate_caps is None:
                escalate_caps = auto_escalation_caps(caps)
            print(
                f"# auto caps: points={caps.max_points} "
                f"raw={caps.raw_points} voxels={caps.max_voxels} "
                f"residual={caps.max_residual} fine={caps.max_fine_voxels} "
                f"wide_extent={caps.wide_extent}", file=sys.stderr,
            )
        return caps, escalate_caps

    if not args.json:
        print(f"Leaf size : {args.voxel:g}")

    scans = args.batch if args.batch else [args.source, args.target]
    if len(scans) < 2 or any(s is None for s in scans):
        ap.error("need a source and a target scan (or --batch LIST)")

    if args.batch and args.out:
        # dataset sweep path: consecutive pairs, streamed JSONL records
        from .io.pcd import read_cloud
        from .pipeline.sweep import run_sweep

        clouds = [read_cloud(p) for p in scans]
        caps, escalate_caps = resolve_caps(caps, escalate_caps, clouds)
        pairs = [(clouds[i], clouds[i + 1]) for i in range(len(clouds) - 1)]
        records, summary = run_sweep(
            pairs, params, caps, batch_size=min(8, len(pairs)),
            out_path=args.out, escalate_caps=escalate_caps, device=device,
        )
        print(json.dumps({"summary": summary, "out": args.out}))
        return 0

    t_load0 = time.perf_counter()
    load_truncated: list[int] = []
    loaded = None
    if args.native_io:
        from .io.native import native_read_ply_batch

        # Load at the largest capacity any stage may use (escalation needs
        # the full cloud, and auto caps are unknown before loading).
        if caps is None:
            raw_cap = 1 << 20
        else:
            raw_cap = caps.raw_points
            if escalate_caps is not None:
                raw_cap = max(raw_cap, escalate_caps.raw_points)
        loaded = native_read_ply_batch(scans, raw_cap)
        if loaded is None:
            print("# WARNING: --native-io: the native loader is not built "
                  "(make -C csrc) or a scan needs the Python reader; reading "
                  "with the Python reader", file=sys.stderr)
    if loaded is not None:
        pts_arr, mask_arr, counts = loaded
        clouds = [pts_arr[i][mask_arr[i]] for i in range(len(scans))]
        # the batch loader subsamples at raw_cap: surface the truncation
        for i, cnt in enumerate(np.asarray(counts)):
            if cnt > raw_cap:
                print(f"# WARNING: scan {scans[i]} has {int(cnt)} points; "
                      f"subsampled at load to {raw_cap} (--caps large, or "
                      "load without --native-io)", file=sys.stderr)
                load_truncated.append(i)
    else:
        from .io.pcd import read_cloud

        clouds = [read_cloud(p) for p in scans]
    t_load = time.perf_counter() - t_load0
    caps, escalate_caps = resolve_caps(caps, escalate_caps, clouds)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # First (CLI-level) downsample, as main() does (:1668-1678); the
    # pipeline performs the second, internal one. Truncation at either
    # capacity is surfaced, never silent.
    def run_at(stage_caps):
        pre_overflow = list(load_truncated)
        for k, c in enumerate(clouds):
            if len(c) > stage_caps.raw_points:
                print(f"# WARNING: scan {scans[k]} has {len(c)} points; "
                      f"subsampled to raw capacity {stage_caps.raw_points} "
                      "(use --caps large)", file=sys.stderr)
                pre_overflow.append(k)
        # Every scan in one batch through one pre_downsample call.
        p, m = zip(*(pad_points(c, stage_caps.raw_points) for c in clouds))
        pd, md, ovf = pre_downsample(np.stack(p), np.stack(m), params,
                                     stage_caps, device=device)
        for k, o in enumerate(ovf.tolist()):
            if o and k not in pre_overflow:
                print(f"# WARNING: scan {scans[k]} overflows max_points="
                      f"{stage_caps.max_points} after downsampling; "
                      "truncated (use --caps large)", file=sys.stderr)
                pre_overflow.append(k)

        fn = make_register_fn(
            params, stage_caps, batched=args.batch is not None, device=device
        )
        sync()
        t0 = time.perf_counter()
        if args.batch:
            res = fn(pd[:-1], md[:-1], pd[1:], md[1:])
        else:
            res = fn(pd[0], md[0], pd[1], md[1])
        sync()
        return res, sorted(set(pre_overflow)), time.perf_counter() - t0

    res, pre_overflow, t_reg = run_at(caps)

    escalated = False
    if escalate_caps is not None:
        from .pipeline.sweep import ESCALATION_STATUS_MASK

        if pre_overflow or bool(
            torch.any((res.status & ESCALATION_STATUS_MASK) != 0)
        ):
            print("# capacity hit at the tight caps; re-running at the "
                  "escalation preset", file=sys.stderr)
            res, pre_overflow, t_esc = run_at(escalate_caps)
            t_reg += t_esc
            escalated = True

    T = res.transform.cpu().numpy()
    if args.json:
        rec = {
            "version": __version__,
            "device": str(device),
            "scans": scans,
            "leaf_size": args.voxel,
            "transform": T.tolist(),
            "quick_score": res.quick_score.tolist(),
            "fine_score": res.fine_score.tolist(),
            "n_faces": res.n_faces.tolist(),
            "n_hypotheses": res.n_hypotheses.tolist(),
            "status": res.status.tolist(),
            "preprocess_overflow": pre_overflow,
            "escalated": escalated,
            "time_load_s": t_load,
            "time_register_s": t_reg,
        }
        print(json.dumps(rec))
    else:
        print("Transformation: ")
        if T.ndim == 2:
            T = T[None]
        for k, Tk in enumerate(T):
            if len(T) > 1:
                print(f"# pair {k}: {scans[k]} -> {scans[k + 1]}")
            for row in Tk:
                print(" ".join(f"{v: .6f}" for v in row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
