"""The port CLI's ``--native-io`` (``python -m fccf_pcr_torch --batch ...
--native-io --json``): the scans load through the threaded C++ batch
loader that ``make -C csrc`` builds (here built from a copy of ``csrc/``
in a temporary directory), which subsamples a scan over the raw capacity
at load and says so. Its record equals the Python reader's and, on a
scan over the raw capacity, the JAX CLI's with the same library (status,
counts and flags exact, transform within the golden band). Without the
library: a warning and the Python reader's record. Load and register
times aside, records are compared whole."""

import json
import pathlib
import shutil
import subprocess

import pytest
import torch

from fccf_pcr_tpu import cli as jcli
from fccf_pcr_tpu.io import native as jnative
from fccf_pcr_torch import cli as tcli
from fccf_pcr_torch import registration_errors
from fccf_pcr_torch.io import native, ply, synthetic

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
TIMES = ("time_load_s", "time_register_s")


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """Two scans of one small room, and a scan of ~13.5k points, over
    TEST_CAPS' raw capacity of 8192."""
    d = tmp_path_factory.mktemp("scans")
    src, tar, _ = synthetic.make_pair(
        seed=1, points_per_plane=400, clutter_points=200, room=(7.0, 5.0, 3.0)
    )
    big, _, _ = synthetic.make_pair(seed=3, points_per_plane=1500,
                                    clutter_points=900)
    assert len(big) > 8192
    paths = [str(d / f"{k}.ply") for k in ("a", "b", "big")]
    for p, cloud in zip(paths, (src, tar, big)):
        ply.write_ply(p, cloud)
    return paths


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """libfccf_io.so built by csrc/'s Makefile from a copy of csrc/."""
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("make and g++ are needed to build csrc/")
    build = tmp_path_factory.mktemp("native") / "csrc"
    shutil.copytree(CSRC, build, ignore=shutil.ignore_patterns("build"))
    subprocess.run(["make", "-C", str(build)], check=True,
                   capture_output=True, timeout=300)
    return build / "build" / "libfccf_io.so"


@pytest.fixture
def use_library(monkeypatch):
    """Point both packages' io/native.py at a library path (FCCF_IO_LIB)
    and forget any library they loaded before; returns what the port's
    loads there."""
    def use(path):
        monkeypatch.setenv("FCCF_IO_LIB", str(path))
        for mod in (native, jnative):
            monkeypatch.setattr(mod, "_LIB", None)
            monkeypatch.setattr(mod, "_TRIED", False)
        return native.load_library()

    return use


def _record(main, argv, capsys):
    """(--json record without its times, stderr) of one CLI run."""
    assert main(argv + ["--json"]) == 0
    cap = capsys.readouterr()
    rec = json.loads(cap.out.splitlines()[-1])
    for k in TIMES:
        rec.pop(k)
    return rec, cap.err


def test_native_io_without_the_library_warns(scans, capsys, tmp_path,
                                             use_library):
    assert use_library(tmp_path / "missing.so") is None
    argv = ["--batch", *scans[:2], "--caps", "tiny", "--device", "cpu"]
    plain, _ = _record(tcli.main, argv, capsys)
    got, err = _record(tcli.main, argv + ["--native-io"], capsys)
    assert "--native-io: the native loader is not built" in err
    assert got == plain


def test_native_io_equals_the_python_reader(scans, capsys, tmp_path,
                                            use_library, built):
    argv = ["--batch", *scans[:2], "--caps", "tiny", "--device", "cpu"]
    assert use_library(tmp_path / "missing.so") is None
    plain, _ = _record(tcli.main, argv, capsys)
    assert use_library(built) is not None
    got, err = _record(tcli.main, argv + ["--native-io"], capsys)
    assert "WARNING" not in err
    assert got == plain and got["preprocess_overflow"] == []


def test_native_io_subsamples_at_load_as_the_jax_cli(scans, capsys,
                                                     tmp_path, use_library,
                                                     built):
    """The scan over the raw capacity is subsampled at load, with the
    warning, and flagged; the record is the JAX CLI's with the same
    library, and the Python reader's (whose pad_points subsample is the
    loader's)."""
    argv = ["--batch", scans[2], scans[0], "--caps", "tiny", "--device",
            "cpu"]
    assert use_library(tmp_path / "missing.so") is None
    plain, _ = _record(tcli.main, argv, capsys)
    assert use_library(built) is not None
    got, err = _record(tcli.main, argv + ["--native-io"], capsys)
    assert f"scan {scans[2]} has " in err and "subsampled at load to 8192" in err
    assert got["preprocess_overflow"] == [0]
    assert got == plain
    want, jerr = _record(jcli.main, argv + ["--native-io"], capsys)
    assert "subsampled at load to 8192" in jerr
    assert got["scans"] == want["scans"]
    for f in ("leaf_size", "status", "n_faces", "n_hypotheses",
              "preprocess_overflow", "escalated"):
        assert got[f] == want[f], f
    rre, rte = registration_errors(
        torch.tensor(got["transform"], dtype=torch.float64),
        torch.tensor(want["transform"], dtype=torch.float64),
    )
    assert float(rre.max()) < 0.1 and float(rte.max()) < 0.02
