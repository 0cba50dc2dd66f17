"""The port's registration main path end to end against the JAX package:
register_pair on conftest's small pair (also in the two-key wide_extent
voxelization layout, and at a leaf that does not nest in the feature
voxel: the non-fused face path), the batched entry, a degenerate input,
and the golden fixtures (tests/golden/pipeline.json) registered through
the port at the full presets: office in the fast tier, the building-scale
resso and heritage marked slow, as tests/test_golden.py marks them.

Against JAX on the small pair: transform within 0.1 deg / 0.02 m;
status, face counts, hypothesis count and the kept mask exact; quick and
fine scores rtol 1e-3 / atol 1e-5 (the golden bands of
tests/test_golden.py)."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
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
    t = tmake(*_port_config(params, caps), device="cpu")(src_p, src_m, tar_p, tar_m)
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
    t = tmake(*_port_config(params, caps), batched=True, device="cpu")(*args)
    assert t.transform.shape == (2, 4, 4)
    for b in range(2):
        assert_result_matches(
            type(t)(*(f[b] for f in t)), type(j)(*(f[b] for f in j))
        )


def test_empty_cloud_is_degenerate(small_pair, params, caps):
    src_p, src_m, tar_p, tar_m, _ = small_pair
    t = tmake(*_port_config(params, caps), device="cpu")(
        src_p, np.zeros_like(src_m), tar_p, tar_m
    )
    assert int(t.status) & STATUS_DEGENERATE
    np.testing.assert_array_equal(t.transform.numpy(), np.eye(4))


@pytest.mark.parametrize(
    "variant",
    [dict(caps=dict(wide_extent=True)), dict(params=dict(leaf_size=0.3))],
    ids=["wide_extent", "non_fused_leaf_0.3"],
)
def test_register_pair_variant_matches_jax(small_pair, params, caps, variant):
    params = dataclasses.replace(params, **variant.get("params", {}))
    caps = dataclasses.replace(caps, **variant.get("caps", {}))
    src_p, src_m, tar_p, tar_m, T_gt = small_pair
    j = jmake(params, caps)(src_p, src_m, tar_p, tar_m)
    t = tmake(*_port_config(params, caps), device="cpu")(src_p, src_m, tar_p, tar_m)
    assert_result_matches(t, j)
    rre, rte = _drift(t.transform, T_gt)
    assert rre < 0.5 and rte < 0.15


def _check_golden_through_port(name, fine_atol=1e-5):
    """The ``name`` rows of tests/golden/pipeline.json through the port's
    pre_downsample + register_pair at the config's full preset: transform
    within the golden band, status, kept mask, face and hypothesis counts
    exact, quick scores rtol 1e-3 / atol 1e-5, fine scores rtol 1e-3 /
    atol ``fine_atol``, and the ground-truth gate of bench.GATES[name]."""
    data = json.loads(GOLDEN.read_text())
    cfg = bench.CONFIGS[name]
    model = get_model(cfg["model"])
    params, caps = model.params, model.caps
    fn = tmake(params, caps, device="cpu")
    gate = bench.GATES[name]
    for row in data["configs"][name]:
        seed = row["seed"]
        src, tar, T_gt = tsynthetic.make_pair(
            seed=seed, **cfg["scene"], **cfg["pair"]
        )
        clouds = [tsynthetic.pad_points(c, caps.raw_points) for c in (src, tar)]
        (sp, sm, so), (tp, tm, to) = (tpre(p, m, params, caps, device="cpu")
                                  for p, m in clouds)
        assert not bool(so) and not bool(to)
        res = fn(sp, sm, tp, tm)
        rre, rte = _drift(res.transform, row["T"])
        assert rre < 0.1 and rte < 0.02, (seed, rre, rte)
        assert int(res.status) == row["status"], seed
        assert res.kept.tolist() == row["kept"], seed
        assert res.n_faces.tolist() == row["n_faces"], seed
        assert int(res.n_hypotheses) == row["n_hypotheses"], seed
        np.testing.assert_allclose(res.quick_score.numpy(), row["quick_score"],
                                   rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(res.fine_score.numpy(), row["fine_score"],
                                   rtol=1e-3, atol=fine_atol)
        g_rre, g_rte = _drift(res.transform, T_gt)
        assert g_rre < gate[0] and g_rte < gate[1], (seed, g_rre, g_rte)


def test_office_golden_through_port():
    _check_golden_through_port("office")


@pytest.mark.slow
@pytest.mark.parametrize("name, fine_atol", [("resso", 5e-4), ("heritage", 1e-5)],
                         ids=["resso", "heritage"])
def test_building_golden_through_port(name, fine_atol):
    """Both presets voxelize in the two-key wide_extent layout; heritage
    runs label propagation at V = 9216. Resso's fine scores compare at
    atol 5e-4: on seed 1 the type-2/3 candidates, which fusion drops,
    have 4 matched planes that leave their translation nearly free, and
    where the LM ends along that direction is set by rounding. On the
    same inputs the reference's own vmapped and per-lane compilations of
    refine_pairs end up to 1.0e-3 apart in the transform entries and the
    port 5.7e-4 from the vmapped one (tools/lm_spread.py); the fine score
    reads 0.016119 against 0.016551 pinned (ROADMAP Queue 3)."""
    _check_golden_through_port(name, fine_atol=fine_atol)


def test_entry_points_need_a_card_by_default(params, caps):
    """make_register_fn, register_pair, pre_downsample and run_sweep run on
    the card unless asked for the CPU; without a card the default raises
    (here, before any work) and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs the "
                    "default on it")
    from fccf_pcr_torch import register_pair
    from fccf_pcr_torch.pipeline.sweep import run_sweep

    tparams, tcaps = _port_config(params, caps)
    pts = np.zeros((tcaps.max_points, 3), np.float32)
    mask = np.zeros(tcaps.max_points, bool)
    calls = [
        lambda: tmake(tparams, tcaps),
        lambda: tmake(tparams, tcaps, batched=True),
        lambda: register_pair(pts, mask, pts, mask, tparams, tcaps),
        lambda: tpre(pts, mask, tparams, tcaps),
        lambda: tpre(pts, mask, tparams, tcaps, device=None),  # numpy: card
        lambda: run_sweep([], tparams, tcaps),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            call()
    # device=None keeps a CPU tensor's device
    _, _, ovf = tpre(torch.from_numpy(pts), torch.from_numpy(mask), tparams,
                     tcaps, device=None)
    assert not bool(ovf)
