"""The port's NumPy twin (fccf_pcr_torch/twin/twin.py, a copy on the
port's config) pinned to the JAX package's twin bit for bit, stage by
stage and end to end on a small scene; its golden fixtures
(tests/golden/twin.json, pipeline_ref05.json's twin rows; slow, as
tests/test_golden.py marks them); and the face-membership diff
(twin/diff.py) against the JAX package's on the five twin-sweep families'
targets at TEST_CAPS: equal memberships and equal metrics."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

from fccf_pcr_tpu import registration_errors
from fccf_pcr_tpu.config import FCCFParams as JParams
from fccf_pcr_tpu.config import TEST_CAPS as JCAPS
from fccf_pcr_tpu.io import synthetic
from fccf_pcr_tpu.twin import diff as jdiff
from fccf_pcr_tpu.twin import twin as jtwin
from fccf_pcr_torch.config import TEST_CAPS, FCCFParams
from fccf_pcr_torch.twin import diff as tdiff
from fccf_pcr_torch.twin import twin as ttwin
from fccf_pcr_torch.twin.families import FAMILIES, TWIN_BANDS

GOLDEN = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(scope="module")
def small_scene():
    """A small room pair (~2.7k points a cloud), downsampled as the twin's
    driver does: (src, tar, cloud1, cloud2)."""
    src, tar, _ = synthetic.make_pair(seed=21, points_per_plane=300,
                                      clutter_points=150, room=(8.0, 6.0, 3.0))
    clouds = [jtwin.voxel_grid_downsample(c, 0.1) for c in (tar, src)]
    np.testing.assert_array_equal(
        clouds[0], ttwin.voxel_grid_downsample(tar, 0.1))
    return src, tar, *clouds


def _assert_faces_equal(a, b):
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(fa.centroid, fb.centroid)
        np.testing.assert_array_equal(fa.normal, fb.normal)
        assert fa.point_size == fb.point_size
        assert len(fa.voxels) == len(fb.voxels)
        for va, vb in zip(fa.voxels, fb.voxels):
            for x, y in zip(va, vb):
                np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def faces(small_scene):
    """face_extrate of both clouds by both twins, checked equal; the JAX
    twin's (faces1, res1, th1, faces2, res2, th2)."""
    out = []
    for cloud in small_scene[2:]:
        for anchor in ("origin", "bbox"):
            j = jtwin.face_extrate(cloud, FCCFParams(), anchor=anchor)
            t = ttwin.face_extrate(cloud, FCCFParams(), anchor=anchor)
            _assert_faces_equal(j[0], t[0])
            np.testing.assert_array_equal(j[1], t[1])
            assert j[2] == t[2]
            if anchor == "origin":
                out += list(j)
    return out


def test_face_extrate_equal(faces):
    assert len(faces[0]) > 4 and len(faces[3]) > 4


def test_select_base_equal(faces):
    p = FCCFParams()
    for fs, th in ((faces[0], faces[2]), (faces[3], faces[5])):
        assert jtwin.select_base(fs, th, p) == ttwin.select_base(fs, th, p)


def _hypotheses(faces, mod):
    p = FCCFParams()
    f1, _, th1, f2, _, th2 = faces
    b1, ty1 = mod.select_base(f1, th1, p)
    b2, ty2 = mod.select_base(f2, th2, p)
    hyp = [[], [], []]
    for x, (i1, j1, a1) in enumerate(b1):
        for y, (i2, j2, a2) in enumerate(b2):
            if abs(a1 - a2) < p.angle_same and ty1[x] == ty2[y]:
                hyp[ty1[x]].extend(
                    mod.computer_transform(f1, f2, i1, j1, i2, j2, p))
    return hyp


def test_computer_transform_equal(faces):
    j, t = _hypotheses(faces, jtwin), _hypotheses(faces, ttwin)
    assert sum(map(len, j)) > 10
    for a, b in zip(j, t):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_transform_cluster_quick_and_fine_verify_equal(faces):
    p = FCCFParams()
    f1, r1, _, f2, r2, _ = faces
    for hyp in _hypotheses(faces, jtwin):
        qts = [(jtwin._quat_from_R(M[:3, :3]), M[:3, 3].copy()) for M in hyp]
        j = jtwin.transform_cluster(qts, 20, p)
        t = ttwin.transform_cluster(qts, 20, p)
        assert len(j) == len(t)
        for (qa, ta), (qb, tb) in zip(j, t):
            np.testing.assert_array_equal(qa, qb)
            np.testing.assert_array_equal(ta, tb)
        for q, tr in j[:2]:
            M = np.eye(4)
            M[:3, :3] = jtwin._R_from_quat(q)
            M[:3, 3] = tr
            (Ma, sa), (Mb, sb) = (mod.quick_verify(M, f1, f2, p)
                                  for mod in (jtwin, ttwin))
            np.testing.assert_array_equal(Ma, Mb)
            assert sa == sb
            for anchor in ("origin", "bbox"):
                assert (jtwin.fine_verify(Ma, r1, r2, p, anchor=anchor)
                        == ttwin.fine_verify(Ma, r1, r2, p, anchor=anchor))


def test_register_pair_equal(small_scene):
    src, tar = small_scene[:2]
    np.testing.assert_array_equal(
        jtwin.register_pair(src, tar, FCCFParams()),
        ttwin.register_pair(src, tar, FCCFParams()))


def test_twin_fixture_params_match_defaults():
    """tests/golden/twin.json pins the params it was made under: every
    field but the JAX package's use_pallas equals the port's defaults."""
    pinned = json.loads((GOLDEN / "twin.json").read_text())["params"]
    assert pinned.pop("use_pallas") is True
    assert pinned == dataclasses.asdict(FCCFParams())


def test_chip_smoke_copies_match_their_originals():
    """chip_smoke.py and the port's tests run without jax: the copies of
    the twin-sweep scene families and of the twin-production bands they
    read (fccf_pcr_torch/twin/families.py)."""
    from test_twin_production import BANDS
    from tools import anchor_sensitivity

    assert FAMILIES == anchor_sensitivity.FAMILIES
    assert TWIN_BANDS == BANDS


def _check_twin_rows(data, params):
    for fam, rows in data["families"].items():
        cfg = FAMILIES[fam]
        for row in rows:
            src, tar, _ = synthetic.make_pair(
                seed=row["seed"], **cfg["scene"], **cfg["pair"])
            T = np.asarray(ttwin.register_pair(src, tar, params), np.float64)
            rre, rte = registration_errors(T, np.asarray(row["T"], np.float64))
            assert float(rre) < 0.05 and float(rte) < 0.01, (fam, row["seed"])


@pytest.mark.slow
def test_twin_golden():
    """tests/test_golden.py::test_twin_golden through the port's twin."""
    _check_twin_rows(json.loads((GOLDEN / "twin.json").read_text()),
                     FCCFParams())


@pytest.mark.slow
def test_twin_golden_ref_defaults():
    data = json.loads((GOLDEN / "pipeline_ref05.json").read_text())["twin"]
    assert data["params_set"] == {"curvature_threshold": 0.05}
    _check_twin_rows(data, FCCFParams(**data["params_set"]))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_face_membership_diff_matches_jax(family):
    cfg = FAMILIES[family]
    _, tar, _ = synthetic.make_pair(seed=30, **cfg["scene"], **cfg["pair"])
    cloud = np.asarray(tar, np.float32)
    jm = jdiff._pipeline_membership(cloud, JParams(), JCAPS)
    tm = tdiff._pipeline_membership(cloud, FCCFParams(), TEST_CAPS,
                                    device="cpu")
    assert len(tm) > 100 and tm == jm
    want = jdiff.face_membership_diff(tar, JParams(), JCAPS)
    got = tdiff.face_membership_diff(tar, FCCFParams(), TEST_CAPS,
                                     device="cpu")
    assert got == want
    assert got["pair_agreement"] > 0.98 and got["matched_fraction"] > 0.95
