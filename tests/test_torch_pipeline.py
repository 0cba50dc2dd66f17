"""The port's registration main path end to end against the JAX package:
register_pair on conftest's small pair (also in the two-key wide_extent
voxelization layout, and at a leaf that does not nest in the feature
voxel: the non-fused face path), the batched entry, a degenerate input,
and the golden fixtures (tests/golden/pipeline.json) registered through
the port at the full presets: office, structured, apartment and
cross-season, and tests/golden/pipeline_ref05.json (office and structured
at curvature_threshold=0.05), in the fast tier; the building-scale resso
and heritage, and tests/golden/twin_production.json's first two seeds a
config (against the twin's cached transforms), marked slow, as
tests/test_golden.py and tests/test_twin_production.py mark them. Source
and target clouds of unequal lengths go through register_pair and the
batched entry.

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
REF05 = GOLDEN.with_name("pipeline_ref05.json")
TWIN_PRODUCTION = GOLDEN.with_name("twin_production.json")


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


def config_pair(cfg, seed):
    """(src, tar, T_gt) of a bench.CONFIGS entry for one seed, made by the
    port's io/synthetic.py copy: mixed-family configs take their family
    round-robin by seed, as bench.pairs_for_config does."""
    fams = cfg.get("scenes")
    scene = fams[seed % len(fams)] if fams else cfg["scene"]
    return tsynthetic.make_pair(seed=seed, **scene, **cfg["pair"])


def _register_config_pair(name, seed, params_set=None):
    """One seed of bench.CONFIGS[name] through the port's pre_downsample +
    register_pair at the config's full preset on the CPU: (result,
    T_gt)."""
    cfg = bench.CONFIGS[name]
    model = get_model(cfg["model"])
    params, caps = model.params, model.caps
    if params_set:
        params = params.replace(**params_set)
    src, tar, T_gt = config_pair(cfg, seed)
    clouds = [tsynthetic.pad_points(c, caps.raw_points) for c in (src, tar)]
    (sp, sm, so), (tp, tm, to) = (tpre(p, m, params, caps, device="cpu")
                              for p, m in clouds)
    assert not bool(so) and not bool(to)
    return tmake(params, caps, device="cpu")(sp, sm, tp, tm), T_gt


def _check_golden_through_port(name, fine_atol=1e-5, data=None, widen=None):
    """The ``name`` rows of tests/golden/pipeline.json (or of ``data``, a
    fixture of the same form, with its ``params_set``) through the port's
    pre_downsample + register_pair at the config's full preset: transform
    within the golden band, status, kept mask, face and hypothesis counts
    exact, quick scores rtol 1e-3 / atol 1e-5, fine scores rtol 1e-3 /
    atol ``fine_atol`` (``widen``: {(seed, index): atol} for single
    entries), and the ground-truth gate of bench.GATES[name]."""
    if data is None:
        data = json.loads(GOLDEN.read_text())
    gate = bench.GATES[name]
    for row in data["configs"][name]:
        seed = row["seed"]
        res, T_gt = _register_config_pair(name, seed, data.get("params_set"))
        rre, rte = _drift(res.transform, row["T"])
        assert rre < 0.1 and rte < 0.02, (seed, rre, rte)
        assert int(res.status) == row["status"], seed
        assert res.kept.tolist() == row["kept"], seed
        assert res.n_faces.tolist() == row["n_faces"], seed
        assert int(res.n_hypotheses) == row["n_hypotheses"], seed
        np.testing.assert_allclose(res.quick_score.numpy(), row["quick_score"],
                                   rtol=1e-3, atol=1e-5)
        fine = res.fine_score.numpy()
        for k, want in enumerate(row["fine_score"]):
            np.testing.assert_allclose(
                fine[k], want, rtol=1e-3,
                atol=(widen or {}).get((seed, k), fine_atol),
                err_msg=f"seed {seed} fine score {k}")
        g_rre, g_rte = _drift(res.transform, T_gt)
        assert g_rre < gate[0] and g_rte < gate[1], (seed, g_rre, g_rte)


def test_office_golden_through_port():
    _check_golden_through_port("office")


@pytest.mark.parametrize("name", ["structured", "apartment", "cross-season"])
def test_golden_through_port(name):
    """structured mixes stairs and hall scenes round-robin by seed;
    apartment (leaf 0.05) and cross-season (low overlap) are the JAX
    suite's slow configs, cheap enough on the port's CPU path."""
    _check_golden_through_port(name)


@pytest.mark.parametrize("name, widen",
                         [("office", None), ("structured", {(1, 2): 1e-4})],
                         ids=["office", "structured"])
def test_ref05_golden_through_port(name, widen):
    """tests/golden/pipeline_ref05.json: the reference's own curvature
    gate (0.05), through params.replace. One fine score compares at atol
    1e-4, every other at 1e-5: structured seed 1's type-3 entry (index
    2). There the type-3 candidates, which fusion drops, are refined on
    4-6 matched planes, and the reference's own vmapped and per-candidate
    compilations of refine_pairs end up to 1.52 apart in a transform
    entry (tools/lm_spread.py --config structured --seed 1 --ref05); the
    score reads 0.005303 against 0.005275 pinned, 2.8e-5 apart (ROADMAP
    Queue 3)."""
    data = json.loads(REF05.read_text())["pipeline"]
    assert data["params_set"] == {"curvature_threshold": 0.05}
    _check_golden_through_port(name, data=data, widen=widen)


def _twin_production_rows():
    """The first two seeds of each config of twin_production.json, as
    tests/test_twin_production.py picks them."""
    rows, seen = [], {}
    for r in json.loads(TWIN_PRODUCTION.read_text())["rows"]:
        if seen.setdefault(r["config"], 0) < 2:
            seen[r["config"]] += 1
            rows.append(r)
    return rows


@pytest.mark.slow
@pytest.mark.parametrize("row", _twin_production_rows(),
                         ids=lambda r: f"{r['config']}-s{r['seed']}")
def test_port_matches_twin_at_production_density(row):
    """The port's transform against the NumPy twin's cached one
    (``T_twin``, so the twin does not rerun), within
    tests/test_twin_production.py's BANDS."""
    from test_twin_production import BANDS

    cfg = bench.CONFIGS[row["config"]]
    src, tar, _ = config_pair(cfg, row["seed"])
    assert (len(src), len(tar)) == (row["n_src"], row["n_tar"])
    res, _ = _register_config_pair(row["config"], row["seed"])
    rre, rte = _drift(res.transform, np.reshape(row["T_twin"], (4, 4)))
    band = BANDS[row["config"]]
    assert rre < band[0] and rte < band[1], (rre, rte, band)


@pytest.mark.parametrize("batched", [False, True], ids=["pair", "batched"])
def test_unequal_lengths_match_jax(params, caps, batched):
    """Sources of 8192 rows and targets of 4096 (make_pair seeds 0 and
    1): the port pads the shorter cloud with masked rows before stacking
    the two, and matches the JAX package, which runs the clouds apart."""
    pairs, gts = [], []
    for seed in (0, 1) if batched else (0,):
        src, tar, T_gt = synthetic.make_pair(seed=seed)
        pairs.append(synthetic.pad_points(src, caps.max_points)
                     + synthetic.pad_points(tar, caps.max_points // 2))
        gts.append(T_gt)
    args = ([np.stack([p[k] for p in pairs]) for k in range(4)] if batched
            else pairs[0])
    j = jmake(params, caps, batched=batched)(*args)
    t = tmake(*_port_config(params, caps), batched=batched,
              device="cpu")(*args)
    for b, T_gt in enumerate(gts):
        tb, jb = ((type(t)(*(f[b] for f in t)), type(j)(*(f[b] for f in j)))
                  if batched else (t, j))
        assert_result_matches(tb, jb)
        rre, rte = _drift(tb.transform, T_gt)
        assert rre < 0.5 and rte < 0.15


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
