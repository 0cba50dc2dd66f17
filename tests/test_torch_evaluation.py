"""The port's evaluation entry points (``fccf_pcr_torch/evaluation/``)
against the JAX package's tools on the same seeded inputs, on the CPU:

  - the evaluation modules and chip_smoke.py import neither jax, the JAX
    package nor ``bench``;
  - ``configs``: ``CONFIGS``, ``GATES`` and ``coerce_like`` equal to
    ``bench.py``'s, and ``pairs_for_config`` bit-identical for one seed
    of each family, and at overlap 0.5 and 0.3 (the windowed pairs);
  - ``evaluate_config`` against ``tools/evaluate.evaluate_config`` at
    ``tiny`` (TEST_CAPS) on a cluttered small room, 3 seeds at batch 2 (a
    partial last batch), plain and with ``escalate_caps="auto"``: status,
    fail and flagged seeds and ``n_escalated`` equal, RRE within 5e-3 deg
    and RTE within 1e-4 m a seed; and ``tests/test_evaluate.py``'s two
    raw-truncation cases;
  - ``measure_pair`` against ``tools/measure_content.measure_pair`` at a
    small scene and small measurement capacities: equal dicts;
  - ``overlap_eval``'s records against ``tools/evaluate.evaluate_config``
    at the same partial-overlap cfg with ``escalate_caps="auto"``, as
    ``tools/ab_overlap_eval.py`` builds it, within the row tolerances;
  - ``twin_production.check`` on each config's fixture rows (office and
    structured 8 pairs, resso and heritage 4), each inside its band of the
    twin's transform (25-35 s of CPU a building-scale config).
"""

import ast
import json
import pathlib

import numpy as np
import pytest

import bench
from fccf_pcr_tpu.config import Capacities as JCapacities
from fccf_pcr_tpu.config import FCCFParams as JParams
from fccf_pcr_torch.config import Capacities, FCCFParams
from fccf_pcr_torch.evaluation import configs, measure_content, overlap_eval
from fccf_pcr_torch.evaluation import twin_production
from fccf_pcr_torch.evaluation.evaluate import evaluate_config
from fccf_pcr_torch.io import synthetic
from fccf_pcr_torch.twin.families import TWIN_BANDS
from tools import evaluate as jevaluate
from tools import measure_content as jmeasure

# A cluttered 10 x 8 x 3 m room at TEST_CAPS: ~7.3k raw points (under the
# 8192 raw capacity), seeds 1 and 2 with more residual points than
# TEST_CAPS' 2048 (status bit 16), which auto escalation doubles.
ESCALATING = dict(
    model="tiny",
    scene=dict(points_per_plane=550, clutter_points=2000, noise=0.01,
               room=(10.0, 8.0, 3.0)),
    pair=dict(),
)
# tests/test_evaluate.py's rooms: ~13.5k raw points against 8192.
RAW_TRUNCATED = dict(
    model="tiny",
    scene=dict(points_per_plane=1500, clutter_points=900),
    pair=dict(),
)
# registration_errors runs in float32, as the JAX tool's does: its acos
# resolves ~1e-3 deg a float32 ulp near 0.2 deg, and the two programs'
# transforms differ by an ulp or two (the largest gap seen is ~3e-3 deg).
RRE_TOL_DEG = 5e-3
RTE_TOL_M = 1e-4


ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("path", [
    *sorted((ROOT / "fccf_pcr_torch" / "evaluation").glob("*.py")),
    ROOT / "chip_smoke.py",
], ids=lambda p: p.name)
def test_imports_neither_jax_nor_bench(path):
    """The evaluation modules and chip_smoke.py run on the card's machine,
    which has no jax, and a package module must not need the repository
    root on sys.path: no import of jax, the JAX package or bench.py."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in (
                "jax", "jaxlib", "fccf_pcr_tpu", "bench"), f"imports {n}"


@pytest.mark.parametrize("name", sorted(bench.CONFIGS))
def test_configs_equal_bench(name):
    assert sorted(configs.CONFIGS) == sorted(bench.CONFIGS)
    assert configs.CONFIGS[name] == bench.CONFIGS[name]


@pytest.mark.parametrize("name", sorted(bench.GATES))
def test_gates_equal_bench(name):
    assert sorted(configs.GATES) == sorted(bench.GATES)
    assert configs.GATES[name] == bench.GATES[name]


@pytest.mark.parametrize("cur,val", [
    (True, "yes"), (True, "OFF"), (False, " 1 "), (False, "maybe"),
    (7, "12"), (7, "1.5"), (0.5, "0.25"), (0.5, "x"), ("s", "t"),
])
def test_coerce_like_equals_bench(cur, val):
    def outcome(fn):
        try:
            v = fn(cur, "key", val, "--set")
        except ValueError as e:
            return ("raises", str(e))
        return ("value", type(v), v)

    assert outcome(configs.coerce_like) == outcome(bench._coerce_like)


@pytest.mark.parametrize("name,seed,overlap", [
    ("office", 0, None), ("apartment", 0, None), ("cross-season", 0, None),
    ("structured", 0, None), ("structured", 1, None), ("resso", 0, None),
    ("heritage", 0, None), ("office", 1, 0.5), ("office", 2, 0.3),
    ("resso", 1, 0.5), ("resso", 2, 0.3),
])
def test_pairs_for_config_bit_identical(name, seed, overlap):
    cfg = bench.CONFIGS[name]
    if overlap is not None:  # as tools/ab_overlap_eval.py sets it
        cfg = {**cfg, "pair": {**cfg["pair"], "overlap": overlap}}
    ((js, jt, jT),) = bench.pairs_for_config(cfg, [seed])
    ((ts, tt, tT),) = configs.pairs_for_config(cfg, [seed])
    for a, b in ((js, ts), (jt, tt), (jT, tT)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _assert_rows_match(got, want):
    for k in ("config", "n", "success", "fail_seeds", "nonzero_status",
              "flagged_seeds", "n_escalated"):
        assert got[k] == want[k], k
    assert sorted(got["seed_rows"]) == sorted(want["seed_rows"])
    for s, w in want["seed_rows"].items():
        g = got["seed_rows"][s]
        assert g["status"] == w["status"], s
        assert abs(g["rre"] - w["rre"]) <= RRE_TOL_DEG, (s, g, w)
        assert abs(g["rte"] - w["rte"]) <= RTE_TOL_M, (s, g, w)


@pytest.mark.parametrize("escalate", [None, "auto"])
def test_evaluate_config_matches_jax(escalate):
    got = evaluate_config("room", ESCALATING, 3, 2, escalate_caps=escalate,
                          device="cpu")
    want = jevaluate.evaluate_config("room", ESCALATING, 3, 2,
                                     escalate_caps=escalate)
    _assert_rows_match(got, want)
    if escalate is None:
        assert got["flagged_seeds"] and got["n_escalated"] == 0
        assert all(st & 16 for st in got["flagged_seeds"].values())
    else:
        # every flagged seed re-ran, and the doubled bound cleared it
        assert got["n_escalated"] >= 1 and got["flagged_seeds"] == {}
    assert got["pairs_per_s"] is not None  # the second batch was timed


def test_evaluate_flags_raw_truncation():
    r = evaluate_config("raw-trunc", RAW_TRUNCATED, seeds=2, batch=2,
                        device="cpu")
    assert r["nonzero_status"] == 2
    assert all(st & 1 for st in r["flagged_seeds"].values())
    assert r["n_escalated"] == 0


def test_evaluate_escalate_caps_auto_keeps_the_raw_flag():
    """Escalation keeps the raw bound (the cloud cannot grow): both seeds
    re-run and their flag stays."""
    r = evaluate_config("raw-trunc-esc", RAW_TRUNCATED, seeds=2, batch=2,
                        escalate_caps="auto", device="cpu")
    assert r["n_escalated"] == 2
    assert all(st & 1 for st in r["flagged_seeds"].values())


def test_evaluate_refuses_a_sequence_config():
    with pytest.raises(ValueError, match="sequence"):
        evaluate_config("sweep", configs.CONFIGS["sweep"], 1, 1, device="cpu")


def test_measure_pair_matches_jax():
    kw = dict(max_points=16384, max_raw_points=16384, max_voxels=1024,
              max_matches=1024, max_hypotheses=2048, max_reps=256,
              max_clusters=256, max_residual=8192, max_fine_voxels=4096,
              per_match_hits=257, wide_extent=True)
    src, tar, _ = synthetic.make_pair(seed=1, points_per_plane=1500,
                                      clutter_points=900)
    got = measure_content.measure_pair(src, tar, FCCFParams(leaf_size=0.25),
                                       Capacities(**kw), device="cpu")
    want = jmeasure.measure_pair(src, tar, JParams(leaf_size=0.25),
                                 JCapacities(**kw))
    assert got == want
    assert got["hypotheses"] > 0 and got["fine_voxels"] > 0


def test_measurement_caps_are_the_tools():
    """measure_content's capacities at a given V, as the JAX tool's
    main() builds them."""
    caps = measure_content.measurement_caps(4096)
    assert caps.max_voxels == 4096 and caps.wide_extent
    assert (caps.max_points, caps.raw_points, caps.max_hypotheses) == (
        1 << 19, 1 << 20, 1 << 14)


def test_overlap_eval_matches_jax(tmp_path):
    """The windowed (overlap < 1) pairs through overlap_curve, against the
    JAX tool on the same cfg: the room at overlap 0.5, 3 seeds at batch 2
    with ``escalate_caps="auto"``."""
    out = tmp_path / "overlap.jsonl"
    rows = overlap_eval.overlap_curve({"room": {**ESCALATING, "batch": 2}},
                                      (0.5,), 3, str(out), device="cpu")
    cfg = {**ESCALATING, "batch": 2, "pair": {"overlap": 0.5}}
    want = jevaluate.evaluate_config("room", cfg, 3, 2, escalate_caps="auto")
    (rec,) = rows
    assert [json.loads(x) for x in out.read_text().splitlines()] == [
        json.loads(json.dumps(rec))]
    assert rec["overlap"] == 0.5 and rec["step"] == "overlap_eval"
    _assert_rows_match(rec, want)
    assert overlap_eval.curve_lines(rows) == [
        f"CURVE room: success @ overlap 0.5:{100 * want['success']:.0f}%"]


@pytest.mark.parametrize("name", [c for c, _ in twin_production.PLAN])
def test_twin_production_check(name):
    seeds = dict(twin_production.PLAN)[name]
    rows, worst = twin_production.check([name], device="cpu",
                                        log=lambda *a: None)
    assert [(r["config"], r["seed"]) for r in rows] == [
        (name, s) for s in seeds]
    band = TWIN_BANDS[name]
    for r in rows:
        assert r["in_band"], r
        assert r["pipe_vs_twin"][0] < band[0] and r["pipe_vs_twin"][1] < band[1]
    assert worst[0] < band[0] and worst[1] < band[1]
