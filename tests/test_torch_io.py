"""The port's jax-free copies of the numpy I/O and capacity-sizing
modules (io/ply.py, io/pcd.py, io/native.py, models/auto.py) pinned to
the JAX package's originals: the port's readers against JAX's on files
written by the JAX writers (ascii, binary, PCL's binary_compressed), with
and without the native reader; equal Capacities from auto_caps on
several clouds, one wider than the single-key face budget. Exact."""

import dataclasses

import numpy as np
import pytest

from fccf_pcr_tpu.io import pcd as jpcd
from fccf_pcr_tpu.io import ply as jply
from fccf_pcr_tpu.io import synthetic
from fccf_pcr_tpu.models import auto as jauto
from fccf_pcr_torch import interop
from fccf_pcr_torch.io import native as tnative
from fccf_pcr_torch.io import pcd as tpcd
from fccf_pcr_torch.io import ply as tply
from fccf_pcr_torch.models import auto as tauto


@pytest.fixture(scope="module")
def cloud():
    return np.random.default_rng(0).normal(0, 5, (777, 3)).astype(np.float32)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
@pytest.mark.parametrize("fmt", ["ply", "pcd"])
def test_readers_match_jax(tmp_path, cloud, fmt, binary):
    path = str(tmp_path / f"c.{fmt}")
    (jply.write_ply if fmt == "ply" else jpcd.write_pcd)(path, cloud, binary=binary)
    jread = jply.read_ply if fmt == "ply" else jpcd.read_pcd
    tread = tply.read_ply if fmt == "ply" else tpcd.read_pcd
    for native in (True, False):
        want = jread(path, use_native=native)
        got = tread(path, use_native=native)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tpcd.read_cloud(path), jpcd.read_cloud(path))


def test_binary_compressed_pcd_matches_jax(tmp_path, cloud):
    """A PCL binary_compressed file (an LZF stream of literal runs)."""
    blob = b"".join(cloud[:, k].astype("<f4").tobytes() for k in range(3))
    comp = b"".join(bytes([len(blob[i:i + 32]) - 1]) + blob[i:i + 32]
                    for i in range(0, len(blob), 32))
    n = len(cloud)
    path = str(tmp_path / "c.pcd")
    with open(path, "wb") as f:
        f.write(("VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                 f"COUNT 1 1 1\nWIDTH {n}\nHEIGHT 1\nPOINTS {n}\n"
                 "DATA binary_compressed\n").encode())
        f.write(np.array([len(comp), len(blob)], "<u4").tobytes())
        f.write(comp)
    got = tpcd.read_pcd(path, use_native=False)
    np.testing.assert_array_equal(got, jpcd.read_pcd(path, use_native=False))
    np.testing.assert_array_equal(got, cloud)


def test_writers_write_the_same_bytes(tmp_path, cloud):
    for binary in (True, False):
        for jw, tw, ext in ((jply.write_ply, tply.write_ply, "ply"),
                            (jpcd.write_pcd, tpcd.write_pcd, "pcd")):
            a, b = tmp_path / f"a.{ext}", tmp_path / f"b.{ext}"
            jw(str(a), cloud, binary=binary)
            tw(str(b), cloud, binary=binary)
            assert a.read_bytes() == b.read_bytes()


def test_native_library_path_is_the_repos():
    from fccf_pcr_tpu.io import native as jnative

    assert tnative._lib_path() == jnative._lib_path()


def _clouds():
    out = []
    for seed in (1, 2):
        src, tar, _ = synthetic.make_pair(
            seed=seed, points_per_plane=600, clutter_points=300
        )
        out.append([src, tar])
    wide = out[0][0].copy()
    wide[:, 0] *= 40.0  # ~560 m: past the single-key face-cell budget
    out.append([wide, out[0][1]])
    out.append([np.full((10, 3), np.nan, np.float32)])
    return out


@pytest.mark.parametrize("k", range(4))
def test_auto_caps_match_jax(params, k):
    clouds = _clouds()[k]
    tparams = interop.params_from_reference(dataclasses.asdict(params))
    if k == 3:  # all-NaN: measured, but nothing to size from
        assert tauto.measure_cloud(clouds[0], tparams)["n_down"] == 0
    for c in clouds:
        jm, tm = jauto.measure_cloud(c, params), tauto.measure_cloud(c, tparams)
        assert jm.keys() == tm.keys()
        for key in jm:
            np.testing.assert_array_equal(tm[key], jm[key])
    jc = jauto.auto_caps(clouds, params)
    tc = tauto.auto_caps(clouds, tparams)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.wide_extent == (k == 2)
    assert dataclasses.asdict(tauto.auto_escalation_caps(tc)) == \
        dataclasses.asdict(jauto.auto_escalation_caps(jc))
