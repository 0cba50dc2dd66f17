"""The port's dataset sweep (pipeline/sweep.py) against the JAX package's
run_sweep: the same records on three small pairs, JSONL resume with
last-record-wins, resume=False truncation, the escalation domination
check, and capacity escalation.

Records: pair, status, counts, preprocess flag exact; transforms within
the golden band (0.1 deg / 0.02 m); quick scores rtol 1e-3 / atol 1e-5;
fine scores atol 2e-3 (tests/test_sweep.py's band for these ~2k-point
clouds: one leaf centroid across a 0.5 m fine-voxel boundary steps a
count and moves the normalized score by ~7e-4); RRE/RTE
against ground truth atol 1e-2 deg / 1e-4 m (each package's float32 RRE
of a near-identity error is an acos within ulps of 1, which resolves
only ~3e-3 deg at 0.06 deg)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from fccf_pcr_tpu.io import synthetic
from fccf_pcr_tpu.pipeline import sweep as jsweep
from fccf_pcr_torch import interop, registration_errors
from fccf_pcr_torch.pipeline import register as tregister
from fccf_pcr_torch.pipeline import sweep as tsweep


@pytest.fixture(scope="module")
def sweep_pairs():
    """tests/test_sweep.py's pairs."""
    pairs, gt = [], []
    for s in (11, 12, 13):
        src, tar, T = synthetic.make_pair(
            seed=s, points_per_plane=800, clutter_points=400, room=(8.0, 6.0, 3.0)
        )
        pairs.append((src, tar))
        gt.append(T)
    return pairs, gt


@pytest.fixture(scope="module")
def light_pairs():
    """Three lighter pairs for the resume tests, which compare the port
    with itself."""
    pairs = []
    for s in (31, 32, 33):
        src, tar, _ = synthetic.make_pair(
            seed=s, points_per_plane=400, clutter_points=200, room=(8.0, 6.0, 3.0)
        )
        pairs.append((src, tar))
    return pairs


def _port(params, caps):
    return (interop.params_from_reference(dataclasses.asdict(params)),
            interop.caps_from_reference(dataclasses.asdict(caps)))


def _assert_records_match(t, j):
    assert [r["pair"] for r in t] == [r["pair"] for r in j]
    for a, b in zip(t, j):
        for f in ("preprocess_overflow", "status", "n_faces", "n_hypotheses"):
            assert a[f] == b[f], (a["pair"], f)
        rre, rte = registration_errors(
            torch.tensor(a["transform"], dtype=torch.float64),
            torch.tensor(b["transform"], dtype=torch.float64),
        )
        assert float(rre) < 0.1 and float(rte) < 0.02
        np.testing.assert_allclose(a["quick_score"], b["quick_score"],
                                   rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(a["fine_score"], b["fine_score"], atol=2e-3)
        np.testing.assert_allclose(a["rre_deg"], b["rre_deg"], atol=1e-2)
        np.testing.assert_allclose(a["rte_m"], b["rte_m"], atol=1e-4)


def test_records_match_jax(params, caps, sweep_pairs, tmp_path):
    pairs, gt = sweep_pairs
    j, jsum = jsweep.run_sweep(pairs, params, caps, batch_size=2,
                               ground_truth=gt, use_mesh=False)
    out = str(tmp_path / "sweep.jsonl")
    t, tsum = tsweep.run_sweep(pairs, *_port(params, caps), batch_size=2,
                               ground_truth=gt, out_path=out)
    _assert_records_match(t, j)
    assert set(jsum) <= set(tsum)
    assert tsum["n_pairs"] == 3 and tsum["n_devices"] == 1
    assert not tsum["sharded"]
    assert tsum["pairs_per_sec"] > 0  # chunk 2 (pair 2) is timed
    lines = [json.loads(line) for line in open(out)]
    assert [r["pair"] for r in lines[:-1]] == [0, 1, 2]
    assert lines[-1] == {"summary": tsum}


def test_resume_skips_recorded_pairs(params, caps, light_pairs, tmp_path):
    """Records already in the file are reused (last record wins); only
    the missing pair runs."""
    pairs = light_pairs
    tparams, tcaps = _port(params, caps)
    out = str(tmp_path / "sweep.jsonl")
    first, _ = tsweep.run_sweep(pairs, tparams, tcaps, batch_size=2,
                                out_path=out)
    kept = [line for line in open(out) if '"pair": 2' not in line
            and "summary" not in line]
    stale = dict(first[0], status=99)  # an older record of pair 0
    with open(out, "w") as f:
        f.write(json.dumps(stale) + "\n")
        f.writelines(kept)
    again, summary = tsweep.run_sweep(pairs, tparams, tcaps, batch_size=2,
                                      out_path=out)
    assert summary["n_resumed"] == 2
    assert [r["pair"] for r in again] == [0, 1, 2]
    assert again[0] == first[0]  # the later record of pair 0 won
    assert again[2]["transform"] == first[2]["transform"]


def test_resume_false_truncates(params, caps, light_pairs, tmp_path):
    pairs = light_pairs
    tparams, tcaps = _port(params, caps)
    out = str(tmp_path / "s.jsonl")
    tsweep.run_sweep(pairs, tparams, tcaps, batch_size=2, out_path=out)
    records, summary = tsweep.run_sweep(pairs[:2], tparams, tcaps,
                                        batch_size=2, out_path=out,
                                        resume=False)
    assert summary["n_resumed"] == 0
    assert [r["pair"] for r in records] == [0, 1]
    assert sorted(json.loads(l)["pair"] for l in open(out) if '"pair"' in l) == [0, 1]


def test_escalation_mask_and_domination(params, caps):
    assert tsweep.ESCALATION_STATUS_MASK == jsweep.ESCALATION_STATUS_MASK
    for bit in range(7):
        rec = {"status": 1 << bit}
        assert tsweep.needs_escalation(rec) == jsweep.needs_escalation(rec)
    assert tsweep.needs_escalation({"status": 0, "preprocess_overflow": True})
    tparams, tcaps = _port(params, caps)
    with pytest.raises(ValueError, match="must dominate"):
        tsweep.run_sweep([], tparams, tcaps, escalate_caps=tcaps.replace(
            max_hypotheses=tcaps.max_hypotheses // 2))
    records, summary = tsweep.run_sweep(
        [], tparams, tcaps.replace(max_raw_points=tcaps.max_points // 2),
        escalate_caps=tcaps)
    assert records == [] and summary["n_escalated"] == 0


def test_capacity_escalation(params, caps, tmp_path):
    """tests/test_sweep.py's escalation case: raw caps between the small
    and the big pairs' sizes truncate the big pairs; escalation re-runs
    exactly those at the full caps, equal to a straight full-caps sweep,
    and a resumed sweep keeps the escalated records."""
    mk = lambda seed, ppp, cl: synthetic.make_pair(  # noqa: E731
        seed=seed, points_per_plane=ppp, clutter_points=cl, room=(8.0, 6.0, 3.0))
    gen = [mk(21, 400, 200), mk(22, 700, 350), mk(23, 700, 350)]
    pairs = [(g[0], g[1]) for g in gen]
    gt = [np.asarray(g[2]) for g in gen]
    sizes = [max(len(s), len(t)) for s, t in pairs]
    tparams, tcaps = _port(params, caps)
    tight = tcaps.replace(max_raw_points=(sizes[0] + min(sizes[1:])) // 2)
    out = str(tmp_path / "esc.jsonl")
    records, summary = tsweep.run_sweep(pairs, tparams, tight, batch_size=2,
                                        ground_truth=gt, out_path=out,
                                        escalate_caps=tcaps)
    by_pair = {r["pair"]: r for r in records}
    assert summary["n_escalated"] == 2
    assert "escalated" not in by_pair[0]
    full, _ = tsweep.run_sweep(pairs, tparams, tcaps, batch_size=2,
                               ground_truth=gt)
    for i in (1, 2):
        rec = by_pair[i]
        assert rec["escalated"] is True and "status_tight" in rec
        assert not tsweep.needs_escalation(rec)
        assert rec["transform"] == full[i]["transform"]
        assert rec["rre_deg"] < 1.0 and rec["rte_m"] < 0.25
    lines = [l for l in open(out) if "summary" not in l]
    with open(out, "w") as f:
        f.writelines(lines)
    again, summary2 = tsweep.run_sweep(pairs, tparams, tight, batch_size=2,
                                       ground_truth=gt, out_path=out,
                                       escalate_caps=tcaps)
    assert summary2["n_resumed"] == 3 and summary2["n_escalated"] == 0
    assert {r["pair"]: r for r in again}[1]["escalated"] is True


def test_status_bits_match_jax():
    from fccf_pcr_tpu.pipeline import register as jregister

    for name in dir(jregister):
        if name.startswith("STATUS_"):
            assert getattr(tregister, name) == getattr(jregister, name)
