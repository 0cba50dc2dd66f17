"""Per-stage content statistics of a scene family (port of
``tools/measure_content.py``).

Capacity presets (``models/fccf.py``) are sized from measured content:
every stage is a fixed-shape masked tensor whose bound either wastes
work or drops content. This tool runs the pipeline's stages at generous
measurement capacities (``measurement_caps``) and prints the content
maxima a preset must cover, max over seeds and both clouds:

    python -m fccf_pcr_torch.evaluation.measure_content --scene courtyard \
        --leaf 0.2 --face-voxel 2.0 --seeds 8
    python -m fccf_pcr_torch.evaluation.measure_content --scene room \
        --max-voxels 4096 --seeds 2 --device cpu

Reported: raw points, downsampled points, occupied feature voxels, faces,
base matches, per-match third-plane hits, hypotheses, greedy seeds,
emittable seeds (size >= 2), residual points, fine voxels and the fine
cell span (cells per axis at the fine voxel; >= 1024 would alias).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..cluster.cluster import _greedy_seeds_all_types
from ..config import Capacities, FCCFParams
from ..features.faces import faces_from_voxels
from ..hypotheses.bases import select_bases
from ..io import synthetic
from ..ops import geometry
from ..ops.hypotheses_kernels import match_all
from ..ops.voxelize import compact, downsample_and_voxelize
from ..pipeline.register import pre_downsample, resolve_device, set_precision


def measurement_caps(max_voxels: int = 1 << 14) -> Capacities:
    """Capacities big enough that nothing of a measured scene truncates
    (the label-prop cost grows as V^2: size ``max_voxels`` near the
    expected content; the overflow check catches undersizing)."""
    return Capacities(
        max_points=1 << 19,
        max_raw_points=1 << 20,
        max_voxels=max_voxels,
        max_matches=8192,
        max_hypotheses=1 << 14,
        max_reps=512,
        max_clusters=8192,
        max_residual=1 << 18,
        max_fine_voxels=1 << 17,
        per_match_hits=257,
        wide_extent=True,
    )


def _cloud(nt, k):
    """Cloud ``k`` of a stack of two, with a pair axis of 1."""
    return type(nt)(*(x[k:k + 1] for x in nt))


def _too_small(what):
    raise RuntimeError(f"measurement {what} too small")


def measure_pair(src, tar, params: FCCFParams, caps: Capacities,
                 device="cuda"):
    """Content maxima of one pair of clouds at the measurement capacities
    ``caps``, on ``device`` (``resolve_device``): a dict of integers (and
    ``raw_truncated`` where a cloud exceeds the raw capacity), as
    ``tools/measure_content.py::measure_pair`` returns."""
    dev = resolve_device(device)
    set_precision()
    out = {"raw": max(src.shape[0], tar.shape[0])}
    raw = caps.raw_points
    if src.shape[0] > raw or tar.shape[0] > raw:
        out["raw_truncated"] = True
    # Both clouds as one stack, targets first, as the pipeline runs them.
    (tp, tm), (sp, sm) = (synthetic.pad_points(c, raw) for c in (tar, src))
    dp, dm, ovf = pre_downsample(np.stack([tp, sp]), np.stack([tm, sm]),
                                 params, caps, device=dev)
    if bool(ovf.any()):
        _too_small("capacities for the downsample")
    out["down"] = int(torch.amax(torch.sum(dm, dim=-1)))

    d, _, vs, pv, _ = downsample_and_voxelize(
        dp, dm, params.leaf_size, params.face_voxel_size, caps.max_voxels,
        wide_extent=caps.wide_extent)
    if bool(vs.overflow.any()):
        _too_small("max_voxels")
    faces, (res_pts, res_mask), _ = faces_from_voxels(vs, d, pv, params, caps)
    out["voxels"] = int(torch.amax(torch.sum(vs.valid, dim=-1)))
    out["faces"] = int(torch.amax(torch.sum(faces.valid, dim=-1)))
    out["residual"] = int(torch.amax(torch.sum(res_mask, dim=-1)))

    # f1 = the target's faces, f2 = the source's, each with a pair axis.
    f1, f2 = _cloud(faces, 0), _cloud(faces, 1)
    b1, b2 = select_bases(f1, params), select_bases(f2, params)

    # Base matching and the third-plane fan-out (the predicates of
    # hypotheses.transforms.generate_hypotheses, measurement-sized).
    B = b1.valid.shape[-1]
    match = (
        b1.valid[..., :, None]
        & b2.valid[..., None, :]
        & (torch.abs(b1.angle[..., :, None] - b2.angle[..., None, :])
           < params.angle_same)
        & (b1.type_[..., :, None] == b2.type_[..., None, :])
    )
    out["matches"] = int(torch.sum(match))
    M = caps.max_matches
    if out["matches"] > M:
        _too_small("max_matches")
    sq = (1, B, B)
    _, _, m_valid, mi1, mj1, mi2, mj2, mtype = compact(
        match, M, b1.i[..., :, None].expand(sq), b1.j[..., :, None].expand(sq),
        b2.i[..., None, :].expand(sq), b2.j[..., None, :].expand(sq),
        b1.type_[..., :, None].expand(sq), batch_dims=1)
    quat, T3, pair_ok, t_fb, fb = match_all(f1, f2, mi1, mj1, mi2, mj2,
                                            params)
    hit = pair_ok & m_valid[..., None, None]          # (1, M, F, F)
    hits = torch.sum(hit, dim=(-2, -1))
    out["per_match_hits"] = int(torch.amax(hits))
    out["hypotheses"] = int(torch.sum(hits) + torch.sum(fb & m_valid))

    # Cluster seeds: the production seed scan at measurement H.
    F = f1.valid.shape[-1]
    S = F * F + 1
    slot_valid = torch.cat([hit.reshape(1, M, F * F),
                            (fb & m_valid)[..., None]], dim=-1)
    slot_t = torch.cat([T3.reshape(1, M, F * F, 3), t_fb[..., None, :]],
                       dim=-2)
    H = caps.max_hypotheses
    # the type of each hypothesis is the type of its match row
    _, h_ovf, h_valid, ht, hq, htype = compact(
        slot_valid.reshape(1, -1), H, slot_t.reshape(1, -1, 3),
        quat.repeat_interleave(S, dim=-2), mtype.repeat_interleave(S, dim=-1),
        batch_dims=1)
    if bool(h_ovf.any()):
        _too_small("max_hypotheses")
    types = torch.arange(3, dtype=htype.dtype, device=dev)
    masks = h_valid[..., None, :] & (htype[..., None, :] == types[:, None])
    axes = torch.eye(3, dtype=hq.dtype, device=dev)
    px = geometry.quat_rotate(hq, axes[0].expand(ht.shape))
    py = geometry.quat_rotate(hq, axes[1].expand(ht.shape))
    seeds, size_all, _ = _greedy_seeds_all_types(masks, ht, px, py, params)
    out["seeds"] = int(torch.amax(torch.sum(seeds, dim=-1)))
    out["emittable_seeds"] = int(torch.amax(
        torch.sum(seeds & (size_all >= 2.0), dim=-1)))

    # Fine-verify source-table content: distinct cells and their span.
    for pts, msk in zip(res_pts.cpu().numpy(), res_mask.cpu().numpy()):
        cells = np.floor(pts[msk] / params.fine_voxel).astype(np.int64)
        if cells.size:
            out["fine_voxels"] = max(
                out.get("fine_voxels", 0),
                len(np.unique(
                    (cells[:, 0] << 42) ^ (cells[:, 1] << 21) ^ cells[:, 2]
                )),
            )
            out["fine_span_cells"] = max(
                out.get("fine_span_cells", 0),
                int((cells.max(0) - cells.min(0) + 1).max()),
            )
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m fccf_pcr_torch.evaluation.measure_content")
    ap.add_argument("--scene", required=True, choices=sorted(synthetic.SCENES))
    ap.add_argument("--leaf", type=float, default=0.1)
    ap.add_argument("--face-voxel", type=float, default=None,
                    help="feature voxel size (m); default 1.0 (reference)")
    ap.add_argument("--fine-voxel", type=float, default=None,
                    help="fine-verify voxel size (m); default 0.5")
    ap.add_argument("--max-voxels", type=int, default=1 << 14,
                    help="measurement voxel capacity (label-prop cost is "
                         "O(V^2); size near expected content, the overflow "
                         "check catches undersizing)")
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--max-angle", type=float, default=40.0)
    ap.add_argument("--max-trans", type=float, default=3.0)
    ap.add_argument("--dropout", type=float, default=0.15)
    ap.add_argument("--scene-kw", default="",
                    help="comma k=v scene kwargs (floats/ints)")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="cuda (default) needs a CUDA card; cpu runs the "
                         "kernels' plain versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    scene_kw = {}
    for kv in filter(None, args.scene_kw.split(",")):
        k, v = kv.split("=")
        scene_kw[k] = float(v) if "." in v else int(v)

    pkw = {"leaf_size": args.leaf}
    if args.face_voxel is not None:
        pkw["face_voxel_size"] = args.face_voxel
    if args.fine_voxel is not None:
        pkw["fine_voxel"] = args.fine_voxel
    params = FCCFParams(**pkw)
    caps = measurement_caps(args.max_voxels)

    agg = {}
    for seed in range(args.seeds):
        src, tar, _ = synthetic.make_pair(
            seed=seed, scene=args.scene, max_angle_deg=args.max_angle,
            max_trans=args.max_trans, dropout=args.dropout, **scene_kw,
        )
        m = measure_pair(src, tar, params, caps, device=device)
        print(f"# seed {seed}: {m}", file=sys.stderr, flush=True)
        for k, v in m.items():
            agg[k] = max(agg.get(k, 0), v)
    print({"scene": args.scene, "leaf": args.leaf, "seeds": args.seeds,
           "max": agg})
    return 0


if __name__ == "__main__":
    sys.exit(main())
