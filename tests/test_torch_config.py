"""The port's jax-free copies (config, presets, scene generator) pinned to
the JAX originals, the port's import hygiene, and the interop helpers."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import bench
from fccf_pcr_tpu import config as jconfig
from fccf_pcr_tpu.io import synthetic as jsynthetic
from fccf_pcr_tpu.models import fccf as jmodels
from fccf_pcr_torch import config as tconfig
from fccf_pcr_torch import interop
from fccf_pcr_torch.io import synthetic as tsynthetic
from fccf_pcr_torch.models import fccf as tmodels

PORT = pathlib.Path(__file__).resolve().parent.parent / "fccf_pcr_torch"


def _field_defaults(cls, drop=()):
    return {
        f.name: f.default for f in dataclasses.fields(cls) if f.name not in drop
    }


def test_params_fields_and_defaults_match():
    want = _field_defaults(jconfig.FCCFParams, drop=("use_pallas",))
    assert _field_defaults(tconfig.FCCFParams) == want


def test_capacities_fields_and_defaults_match():
    assert _field_defaults(tconfig.Capacities) == _field_defaults(
        jconfig.Capacities
    )
    assert dataclasses.asdict(tconfig.TEST_CAPS) == dataclasses.asdict(
        jconfig.TEST_CAPS
    )


@pytest.mark.parametrize("name", sorted(jmodels.REGISTRY))
def test_registry_matches_field_by_field(name):
    assert sorted(tmodels.REGISTRY) == sorted(jmodels.REGISTRY)
    j, t = jmodels.REGISTRY[name], tmodels.REGISTRY[name]
    assert t.name == j.name
    jp = dataclasses.asdict(j.params)
    jp.pop("use_pallas")
    assert dataclasses.asdict(t.params) == jp
    assert dataclasses.asdict(t.caps) == dataclasses.asdict(j.caps)
    assert t.caps.raw_points == j.caps.raw_points


def _scene_kwargs(cfg, seed):
    fams = cfg.get("scenes")
    return dict(**(fams[seed % len(fams)] if fams else cfg["scene"]),
                **cfg["pair"])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("name", ["office", "structured"])
def test_synthetic_pairs_bit_identical(name, seed):
    cfg = bench.CONFIGS[name]
    caps = jmodels.REGISTRY[cfg["model"]].caps
    (js, jt, jT), = bench.pairs_for_config(cfg, [seed])
    ts, tt, tT = tsynthetic.make_pair(seed=seed, **_scene_kwargs(cfg, seed))
    for a, b in ((js, ts), (jt, tt), (jT, tT)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for cloud in (js, jt):
        jp, jm = jsynthetic.pad_points(cloud, caps.raw_points)
        tp, tm = tsynthetic.pad_points(cloud, caps.raw_points)
        np.testing.assert_array_equal(jp, tp)
        np.testing.assert_array_equal(jm, tm)


def test_pad_points_subsamples_identically():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(1000, 3)).astype(np.float32)
    for cap in (10, 999, 1000, 1500):
        for a, b in zip(jsynthetic.pad_points(pts, cap),
                        tsynthetic.pad_points(pts, cap)):
            np.testing.assert_array_equal(a, b)


def test_port_imports_no_jax():
    """An AST walk of every module of the port, of chip_smoke.py and of the
    port's tools: no import of jax or of the JAX package, at any depth
    (the card's machine has no jax)."""
    banned = ("jax", "jaxlib", "fccf_pcr_tpu")
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    for module in ("parallel/mesh.py", "utils/profiling.py",
                   "utils/records.py", "io/visualize.py", "twin/twin.py",
                   "twin/diff.py"):
        assert PORT / module in files, module
    files += [PORT.parent / "chip_smoke.py",
              *sorted((PORT.parent / "tools").glob("torch_*.py"))]
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in banned, f"{path}: imports {n}"


def test_interop_config_roundtrip():
    jp = jconfig.FCCFParams(leaf_size=0.05, use_pallas=False)
    tp = interop.params_from_reference(dataclasses.asdict(jp))
    assert tp == tconfig.FCCFParams(leaf_size=0.05)
    caps = interop.caps_from_reference(
        dataclasses.asdict(jmodels.REGISTRY["heritage"].caps)
    )
    assert caps == tmodels.REGISTRY["heritage"].caps
    with pytest.raises(ValueError):
        interop.params_from_reference({"not_a_field": 1})


def test_interop_arrays_roundtrip():
    from fccf_pcr_torch.verify.fine import SourceTable

    rng = np.random.default_rng(0)
    arrays = dict(
        keys=rng.integers(0, 2**32 - 1, 8, dtype=np.uint32),
        counts=rng.uniform(size=8).astype(np.float32),
        n_src=np.float32(8.0),
        overflow=np.bool_(False),
        cell_min=np.array([-3, 0, 1], np.int32),
        cell_max=np.array([5, 6, 7], np.int32),
        aliased=np.bool_(True),
    )
    table = interop.from_numpy(SourceTable, arrays, "cpu")
    assert table.keys.dtype == torch.int64  # uint32 order kept in int64
    assert table.counts.dtype == torch.float32
    assert table.cell_min.dtype == torch.int32
    back = interop.to_numpy(table)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
