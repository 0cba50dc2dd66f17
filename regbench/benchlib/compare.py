"""How ``correct`` is decided: what the timed path produced for every
distinct pair of the pool (its down-sampled clouds and every field of its
``RegistrationResult``) against the plain reference (``refpipe``), which
derives everything again from the same raw clouds, pair by pair.

The numbers compared, each the worst over the pool's pairs:

- ``down_mask_diff``: down-sampled rows whose valid flag differs, plus
  clouds whose overflow flag differs (a count);
- ``down_point_gap_m``: the largest coordinate gap of a row valid on
  both sides (m);
- ``rotation_gap_deg``: the largest rotation between the two sides'
  ``transform`` or ``type_transform`` matrices (deg; from the Frobenius
  norm of the difference, exactly 0 for equal matrices);
- ``translation_gap_m``: the largest distance between their
  translations (m);
- ``score_gap``: the largest gap of ``quick_score``, ``fine_score`` or
  ``type_score`` (scores are shares, 0 to 1);
- ``count_diff``: entries of ``n_faces``, ``n_hypotheses``, ``status``
  and ``kept`` that differ (a count).

Each has a limit in the configuration file (``limits``), set from the
readings of sound runs and of the TF32 control (``readings.py``).
"""

from __future__ import annotations

import math

import numpy as np

CHECKS = ("down_mask_diff", "down_point_gap_m", "rotation_gap_deg",
          "translation_gap_m", "score_gap", "count_diff")
FIELDS = ("transform", "quick_score", "fine_score", "n_faces",
          "n_hypotheses", "status", "type_transform", "type_score", "kept")


def _gap(a, b):
    """Elementwise |a - b| in float64, 0 where equal (NaN == NaN, inf ==
    inf), inf where one side is not finite and the other differs."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    gap = np.abs(a - b)
    return np.where(same, 0.0, np.where(np.isfinite(gap), gap, np.inf))


def rotation_gap_deg(T, T_ref):
    """The rotation between two (..., 4, 4) transforms, from
    |R - R_ref|_F = 2 sqrt(2) sin(angle / 2); 0 for equal matrices."""
    d = _gap(np.asarray(T)[..., :3, :3], np.asarray(T_ref)[..., :3, :3])
    fro = np.sqrt(np.sum(d * d, axis=(-2, -1)))
    s = np.clip(fro / (2.0 * math.sqrt(2.0)), 0.0, 1.0)
    return np.degrees(2.0 * np.arcsin(s))


def translation_gap_m(T, T_ref):
    d = _gap(np.asarray(T)[..., :3, 3], np.asarray(T_ref)[..., :3, 3])
    return np.sqrt(np.sum(d * d, axis=-1))


def down_numbers(prog, ref):
    """(mask diff, point gap) of one down-sampled cloud: (pts, mask, ovf)
    each side, numpy."""
    pts, mask, ovf = (np.asarray(x) for x in prog)
    rpts, rmask, rovf = (np.asarray(x) for x in ref)
    diff = int(np.sum(mask != rmask)) + int(bool(ovf) != bool(rovf))
    both = mask & rmask
    gap = float(np.max(_gap(pts[both], rpts[both]))) if both.any() else 0.0
    return diff, gap


def result_numbers(res, ref):
    """The numbers of one pair's results, dicts of numpy fields."""
    Ts = np.concatenate([np.asarray(res["transform"])[None],
                         np.asarray(res["type_transform"])])
    Tr = np.concatenate([np.asarray(ref["transform"])[None],
                         np.asarray(ref["type_transform"])])
    score = max(float(np.max(_gap(res[k], ref[k])))
                for k in ("quick_score", "fine_score", "type_score"))
    counts = sum(int(np.sum(np.asarray(res[k]) != np.asarray(ref[k])))
                 for k in ("n_faces", "n_hypotheses", "status", "kept"))
    return dict(rotation_gap_deg=float(np.max(rotation_gap_deg(Ts, Tr))),
                translation_gap_m=float(np.max(translation_gap_m(Ts, Tr))),
                score_gap=score, count_diff=counts)


def worst(per_pair):
    """The run's numbers from each pair's: counts summed, gaps maxed."""
    out = {}
    for name in CHECKS:
        vals = [p[name] for p in per_pair]
        out[name] = (sum(vals) if name.endswith("_diff")
                     else max(vals, default=0.0))
    return out


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a NaN is over any limit."""
    rows = [(name, numbers[name], limits[name]) for name in CHECKS]
    ok = all(v <= lim for _, v, lim in rows)
    return ok, rows
