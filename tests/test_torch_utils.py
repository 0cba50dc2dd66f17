"""The port's utils/profiling.py (StageTimer, trace, annotate), and its
NumPy/stdlib copies utils/records.py and io/visualize.py pinned to the JAX
package's originals: the same calls write byte-identical files."""

import json

import numpy as np
import pytest
import torch

from fccf_pcr_tpu.io import visualize as jvisualize
from fccf_pcr_tpu.utils import records as jrecords
from fccf_pcr_torch.io import visualize as tvisualize
from fccf_pcr_torch.utils import records as trecords
from fccf_pcr_torch.utils.profiling import StageTimer, annotate, trace


def test_stage_timer_accumulates_and_synchronizes():
    t = StageTimer()
    with t.stage("a") as live:
        live.append(torch.ones((256, 256)) @ torch.ones((256, 256)))
    with t.stage("a"):
        pass
    with t.stage("b"):
        pass
    assert set(t.times) == {"a", "b"}
    assert t.times["a"] > 0.0
    rep = t.report()
    assert "a" in rep and "total" in rep


def test_stage_timer_records_on_exception():
    t = StageTimer()
    with pytest.raises(RuntimeError):
        with t.stage("boom"):
            raise RuntimeError("x")
    assert "boom" in t.times  # recorded despite the raise


def test_stage_timer_entry_sync_args_still_accepted():
    x = torch.arange(8.0)
    t = StageTimer()
    with t.stage("pre", x):
        y = x.numpy() * 2
    assert y[3] == 6.0 and t.times["pre"] >= 0.0


def test_trace_exports_a_chrome_trace_with_the_annotations(tmp_path):
    with trace(str(tmp_path)) as prof:
        with annotate("fccf_stage"):
            torch.ones((64, 64)) @ torch.ones((64, 64))
    assert prof.trace_path.startswith(str(tmp_path))
    events = json.loads(open(prof.trace_path).read())["traceEvents"]
    assert any(e.get("name") == "fccf_stage" for e in events)


def _cloud(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)


def test_records_write_identical_files(tmp_path):
    for mod in (jrecords, trecords):
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        for row, value in ((0, 1.5), (2, "x"), (0, 7), (1, -3)):
            mod.append_csv_cell(str(d / "t.csv"), row, value)
        for rec in ({"pair": 0, "rre": 0.1}, {"summary": {"n": 2}}):
            mod.append_jsonl(str(d / "r.jsonl"), rec)
        with pytest.raises(ValueError):
            mod.append_csv_cell(str(d / "t.csv"), 0, "a,b")
    for name in ("t.csv", "r.jsonl"):
        assert ((tmp_path / "fccf_pcr_torch" / name).read_bytes()
                == (tmp_path / "fccf_pcr_tpu" / name).read_bytes())


def test_visualize_writes_identical_files(tmp_path):
    pts = _cloud(500)
    face = np.random.default_rng(1).integers(-1, 9, 500)
    T = np.eye(4)
    T[:3, 3] = (0.5, -1.0, 2.0)
    for mod in (jvisualize, tvisualize):
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        mod.export_faces(str(d / "faces.ply"), pts, face)
        mod.export_faces(str(d / "faces4.ply"), pts, face, n_faces=4, seed=3)
        mod.export_registration(str(d / "reg.ply"), pts, _cloud(300, 2), T)
    for name in ("faces.ply", "faces4.ply", "reg.ply"):
        assert ((tmp_path / "fccf_pcr_torch" / name).read_bytes()
                == (tmp_path / "fccf_pcr_tpu" / name).read_bytes())
