"""Dataset sweeps: batched registration of many scan pairs with
structured per-pair records (port of ``fccf_pcr_tpu/pipeline/sweep.py``).

Every pair gets a JSON record with the transform, scores, counts, status
flags, RTE/RRE against ground truth when given, and the batch's wall
time; records stream to a JSONL file that a restarted sweep resumes from
(last record wins). Pairs whose status shows a capacity hit re-run at
larger capacities (``escalate_caps``). One device: the JAX package's
split of the pair axis over a mesh is not ported. Each chunk of
``batch_size`` pairs (the last one padded with repeats of its last pair)
is one batch: one ``pre_downsample`` call a side on the (P, raw, 3)
clouds, then one call of the batched registration program.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from .register import (
    STATUS_FINE_OVERFLOW,
    STATUS_HYPOTHESIS_OVERFLOW,
    STATUS_REP_OVERFLOW,
    STATUS_RESIDUAL_OVERFLOW,
    STATUS_VOXEL_OVERFLOW,
)

# Status bits a larger-capacity re-run can clear (pipeline truncation,
# not geometry): everything except DEGENERATE and FINE_ALIAS.
ESCALATION_STATUS_MASK = (
    STATUS_VOXEL_OVERFLOW
    | STATUS_HYPOTHESIS_OVERFLOW
    | STATUS_REP_OVERFLOW
    | STATUS_RESIDUAL_OVERFLOW
    | STATUS_FINE_OVERFLOW
)


def needs_escalation(record: dict) -> bool:
    """True when a sweep record shows a capacity hit a larger-caps re-run
    could clear (preprocess truncation included)."""
    return bool(record.get("preprocess_overflow")) or bool(
        record["status"] & ESCALATION_STATUS_MASK
    )


def _chunk(lst, n):
    for i in range(0, len(lst), n):
        yield lst[i : i + n]


def _check_dominates(caps, escalate_caps):
    """Escalation must not shrink any bound: a smaller "escalation" would
    truncate harder and replace good records with worse ones."""
    for f in dataclasses.fields(caps):
        if f.name == "max_raw_points":
            # 0 is a sentinel for "= max_points": compare effectives
            lo, hi = caps.raw_points, escalate_caps.raw_points
        else:
            lo = getattr(caps, f.name)
            hi = getattr(escalate_caps, f.name)
        if (hi < lo) if not isinstance(lo, bool) else (lo and not hi):
            raise ValueError(
                f"escalate_caps.{f.name}={hi} is below the tight "
                f"caps' {lo}; escalation capacities must dominate"
            )


def _load_done(out_path, n_pairs):
    """Records of an earlier run of this sweep, last record per pair."""
    done: dict[int, dict] = {}
    with open(out_path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            # pair indices past this list are another sweep's records
            if "pair" in rec and rec["pair"] < n_pairs:
                done[rec["pair"]] = rec
    return done


def run_sweep(
    pairs,
    params,
    caps,
    batch_size: int = 8,
    ground_truth=None,
    out_path: str | None = None,
    resume: bool = True,
    escalate_caps=None,
    device="cuda",
):
    """Register a list of (src_points, tar_points) pairs on ``device``
    (the card by default; without one this raises, see
    ``register.resolve_device``).

    pairs: list of (np.ndarray (M, 3), np.ndarray (K, 3)).
    ground_truth: optional list of 4x4 arrays (src -> tar).
    Returns (records, summary); writes JSONL to out_path if given.

    With ``out_path`` + ``resume``, records are appended as they complete
    and pairs already in the file are skipped on restart; ``resume=False``
    truncates the file. ``escalate_caps`` re-runs exactly the pairs whose
    records show a capacity hit at those (larger) capacities; escalated
    records replace the tight ones (keeping the tight status in
    ``status_tight``) and are re-appended to the JSONL. Throughput counts
    each pair once (its tight run), excluding every pass's first chunk,
    which carries the one-time costs (the kernels' build, allocator
    warm-up).
    """
    from ..io.synthetic import pad_points
    from .metrics import registration_errors
    from .register import make_register_fn, pre_downsample, resolve_device

    if escalate_caps is not None:
        _check_dominates(caps, escalate_caps)
    device = resolve_device(device)
    done = {}
    if resume and out_path and os.path.exists(out_path):
        done = _load_done(out_path, len(pairs))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out_f = open(out_path, "a" if resume else "w") if out_path else None
    total_time = 0.0
    n_done = 0

    def run_pass(todo, stage_caps, escalated, tight_status=None):
        """One pass over pair indices ``todo`` at one capacity config."""
        nonlocal total_time, n_done
        fn = make_register_fn(params, stage_caps, batched=True, device=device)
        pass_records = []
        for chunk_idx, chunk in enumerate(_chunk(todo, batch_size)):
            idxs = list(chunk)
            # pad the final chunk to the batch size (dummy repeats)
            eff = idxs + [idxs[-1]] * (batch_size - len(idxs))
            raw = stage_caps.raw_points
            pre_ovf = np.array([len(s) > raw or len(t) > raw
                                for s, t in (pairs[i] for i in eff)])
            # One batch a side: (P, raw, 3) clouds through one
            # pre_downsample each.
            sides = []
            for side in range(2):
                p, m = zip(*(pad_points(np.asarray(pairs[i][side], np.float32),
                                        raw) for i in eff))
                sides.append(pre_downsample(np.stack(p), np.stack(m), params,
                                            stage_caps, device=device))
            (sp, sm, s_ovf), (tp, tm, t_ovf) = sides
            pre_ovf |= (s_ovf | t_ovf).cpu().numpy()

            sync()
            t0 = time.perf_counter()
            res = fn(sp, sm, tp, tm)
            sync()
            dt = time.perf_counter() - t0
            if chunk_idx > 0:  # the first chunk carries one-time costs
                total_time += dt
                if not escalated:  # escalated pairs already counted once
                    n_done += len(idxs)

            res = type(res)(*(f.cpu() for f in res))
            T = res.transform
            for k, i in enumerate(idxs):
                rec = {
                    "pair": i,
                    "preprocess_overflow": bool(pre_ovf[k]),
                    "transform": T[k].tolist(),
                    "quick_score": res.quick_score[k].tolist(),
                    "fine_score": res.fine_score[k].tolist(),
                    "n_faces": res.n_faces[k].tolist(),
                    "n_hypotheses": int(res.n_hypotheses[k]),
                    "status": int(res.status[k]),
                    "batch_time_s": dt,
                }
                if escalated:
                    rec["escalated"] = True
                    rec["status_tight"] = tight_status[i]
                if ground_truth is not None and ground_truth[i] is not None:
                    rre, rte = registration_errors(
                        T[k],
                        torch.as_tensor(np.asarray(ground_truth[i]),
                                        dtype=torch.float32),
                    )
                    rec["rre_deg"] = float(rre)
                    rec["rte_m"] = float(rte)
                pass_records.append(rec)
                if out_f is not None:
                    out_f.write(json.dumps(rec) + "\n")
                    out_f.flush()
        return pass_records

    try:
        todo = [i for i in range(len(pairs)) if i not in done]
        by_pair = dict(done)
        for rec in run_pass(todo, caps, escalated=False):
            by_pair[rec["pair"]] = rec

        n_escalated = 0
        if escalate_caps is not None:
            # resumed records escalate too; records escalated once never
            # re-run (that status is final)
            flagged = sorted(
                i
                for i, rec in by_pair.items()
                if needs_escalation(rec) and not rec.get("escalated")
            )
            n_escalated = len(flagged)
            tight = {i: by_pair[i]["status"] for i in flagged}
            for rec in run_pass(
                flagged, escalate_caps, escalated=True, tight_status=tight
            ):
                by_pair[rec["pair"]] = rec
    except BaseException:
        # the summary line marks a COMPLETED sweep; on failure just
        # release the handle (streamed records stay for resume)
        if out_f is not None:
            out_f.close()
        raise

    records = list(by_pair.values())
    summary = {
        "n_pairs": len(pairs),
        "n_resumed": len(done),
        # None when nothing was timed past a first chunk
        "pairs_per_sec": (
            (n_done / total_time) if n_done > 0 and total_time > 0 else None
        ),
        "n_devices": 1,
        "sharded": False,
        "device": str(device),
    }
    if escalate_caps is not None:
        summary["n_escalated"] = n_escalated
    if ground_truth is not None and any("rre_deg" in r for r in records):
        rres = [r["rre_deg"] for r in records if "rre_deg" in r]
        rtes = [r["rte_m"] for r in records if "rte_m" in r]
        summary.update(
            rre_mean_deg=float(np.mean(rres)),
            rre_max_deg=float(np.max(rres)),
            rte_mean_m=float(np.mean(rtes)),
            rte_max_m=float(np.max(rtes)),
        )
    if out_f is not None:
        out_f.write(json.dumps({"summary": summary}) + "\n")
        out_f.close()
    records.sort(key=lambda r: r["pair"])
    return records, summary
