"""The port's registration main path end to end against the JAX package:
register_pair on conftest's small pair, the batched entry, a degenerate
input, and the office golden fixture (tests/golden/pipeline.json)
registered through the port at the full eth-office preset.

Against JAX on the small pair: transform within 0.1 deg / 0.02 m;
status, face counts, hypothesis count and the kept mask exact; quick and
fine scores rtol 1e-3 / atol 1e-5 (the golden bands of
tests/test_golden.py)."""

import dataclasses
import json
import pathlib

import numpy as np
import torch

import bench
from fccf_pcr_tpu import make_register_fn as jmake
from fccf_pcr_tpu.io import synthetic
from fccf_pcr_torch import interop
from fccf_pcr_torch import make_register_fn as tmake
from fccf_pcr_torch import pre_downsample as tpre
from fccf_pcr_torch import registration_errors
from fccf_pcr_torch.io import synthetic as tsynthetic
from fccf_pcr_torch.models.fccf import get_model
from fccf_pcr_torch.pipeline.register import STATUS_DEGENERATE

GOLDEN = pathlib.Path(__file__).parent / "golden" / "pipeline.json"


def _port_config(params, caps):
    return (interop.params_from_reference(dataclasses.asdict(params)),
            interop.caps_from_reference(dataclasses.asdict(caps)))


def _drift(T_port, T_ref):
    rre, rte = registration_errors(
        torch.as_tensor(np.array(T_port), dtype=torch.float64),
        torch.as_tensor(np.array(T_ref), dtype=torch.float64),
    )
    return float(rre), float(rte)


def assert_result_matches(t, j):
    rre, rte = _drift(t.transform, j.transform)
    assert rre < 0.1 and rte < 0.02, (rre, rte)
    for f in ("status", "n_faces", "n_hypotheses", "kept"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    for f in ("quick_score", "fine_score"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)),
                                   rtol=1e-3, atol=1e-5, err_msg=f)


def test_register_pair_matches_jax(small_pair, params, caps):
    src_p, src_m, tar_p, tar_m, T_gt = small_pair
    j = jmake(params, caps)(src_p, src_m, tar_p, tar_m)
    t = tmake(*_port_config(params, caps))(src_p, src_m, tar_p, tar_m)
    assert t.transform.dtype == torch.float32
    assert_result_matches(t, j)
    rre, rte = _drift(t.transform, T_gt)
    assert rre < 0.5 and rte < 0.15


def test_batched_entry_matches_jax(params, caps):
    pairs = []
    for seed in (7, 11):
        src, tar, _ = synthetic.make_pair(
            seed=seed, points_per_plane=1500, clutter_points=900
        )
        pairs.append(synthetic.pad_points(src, caps.max_points)
                     + synthetic.pad_points(tar, caps.max_points))
    args = [np.stack([p[k] for p in pairs]) for k in range(4)]
    j = jmake(params, caps, batched=True)(*args)
    t = tmake(*_port_config(params, caps), batched=True)(*args)
    assert t.transform.shape == (2, 4, 4)
    for b in range(2):
        assert_result_matches(
            type(t)(*(f[b] for f in t)), type(j)(*(f[b] for f in j))
        )


def test_empty_cloud_is_degenerate(small_pair, params, caps):
    src_p, src_m, tar_p, tar_m, _ = small_pair
    t = tmake(*_port_config(params, caps))(
        src_p, np.zeros_like(src_m), tar_p, tar_m
    )
    assert int(t.status) & STATUS_DEGENERATE
    np.testing.assert_array_equal(t.transform.numpy(), np.eye(4))


def test_office_golden_through_port():
    """The office rows of tests/golden/pipeline.json through the port's
    pre_downsample + register_pair at the full eth-office preset:
    transform within the golden band, status and kept mask exact, face
    counts exact, quick and fine scores rtol 1e-3 / atol 1e-5, and the
    ground-truth gate of bench.GATES["office"]."""
    data = json.loads(GOLDEN.read_text())
    cfg = bench.CONFIGS["office"]
    model = get_model(cfg["model"])
    params, caps = model.params, model.caps
    fn = tmake(params, caps)
    gate = bench.GATES["office"]
    for row in data["configs"]["office"]:
        seed = row["seed"]
        src, tar, T_gt = tsynthetic.make_pair(
            seed=seed, **cfg["scene"], **cfg["pair"]
        )
        clouds = [tsynthetic.pad_points(c, caps.raw_points) for c in (src, tar)]
        (sp, sm, so), (tp, tm, to) = (tpre(p, m, params, caps) for p, m in clouds)
        assert not bool(so) and not bool(to)
        res = fn(sp, sm, tp, tm)
        rre, rte = _drift(res.transform, row["T"])
        assert rre < 0.1 and rte < 0.02, (seed, rre, rte)
        assert int(res.status) == row["status"], seed
        assert res.kept.tolist() == row["kept"], seed
        assert res.n_faces.tolist() == row["n_faces"], seed
        np.testing.assert_allclose(res.quick_score.numpy(), row["quick_score"],
                                   rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(res.fine_score.numpy(), row["fine_score"],
                                   rtol=1e-3, atol=1e-5)
        g_rre, g_rte = _drift(res.transform, T_gt)
        assert g_rre < gate[0] and g_rte < gate[1], (seed, g_rre, g_rte)
