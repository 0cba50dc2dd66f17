"""BENCHMARK.json against the benchmark's contract, and the harness
finding each cell's files by name."""

import hashlib
import json
import re
import shutil

import pytest

import _paths
from benchlib import compare, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.manifest(_paths.ROOT)


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_keys_and_limits(bench):
    assert set(bench) == TOP_KEYS
    assert len(json.dumps(bench)) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["paths"]) <= 16
    assert 1 <= len(bench["command"]) <= 32
    assert all(line(w) and not w.startswith("/") and ".." not in w
               for w in bench["command"])
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert (_paths.ROOT / p).is_dir()


def test_names_and_units(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert line(w["why"])
    cells = [w["name"] for w in bench["workloads"]]
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) \
        == len(cells)
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in SOURCES_E2E and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and line(m["layer"])
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.manifest(_paths.ROOT)["workloads"]])
def test_cell_resolves(cell):
    """Each workload finds one configuration file, its traffic and a
    reader for every metric it reports; it reports setup_s, another
    end-to-end metric and a per-layer metric, and every per-layer metric
    it reports moves an end-to-end metric it reports."""
    c = spec.cell(cell)
    assert c.config["name"] in {x["name"] for x in
                                spec.manifest(_paths.ROOT)["configs"]}
    for key in ("params", "caps", "scene", "pair", "gate", "limits"):
        assert key in c.config
    assert set(c.config["limits"]) == set(compare.CHECKS)
    for key in ("batch", "pool_pairs"):
        assert c.traffic[key] >= 1
    assert c.traffic["pool_pairs"] % c.traffic["batch"] == 0
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))
    assert {m["moves"] for m in c.per_layer} <= e2e


def test_config_files(bench):
    """Each configuration file is its own, and holds every field of the
    reference's parameters and capacities."""
    import refpipe

    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    for c in bench["configs"]:
        cfg = json.loads((_paths.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        refpipe.FCCFParams(**cfg["params"])
        refpipe.Capacities(**cfg["caps"])
        assert set(cfg["params"]) == set(
            refpipe.FCCFParams.__dataclass_fields__)
        assert set(cfg["caps"]) == set(
            refpipe.Capacities.__dataclass_fields__)


def _digest(folder):
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(folder.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_adding_a_cell_is_adding_files(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric are new
    files and new BENCHMARK.json entries; no file already there changes."""
    root = tmp_path / "checkout"
    shutil.copytree(_paths.BENCH, root / _paths.BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(root / _paths.BENCH.name)
    bench = spec.manifest(_paths.ROOT)
    bench_dir = root / _paths.BENCH.name
    cfg = json.loads((_paths.ROOT / bench["configs"][0]["file"]).read_text())
    cfg["name"] = "dummy-config"
    (bench_dir / "configs" / "dummy-config.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "dummy4.json").write_text(
        json.dumps(dict(batch=4, pool_pairs=8)))
    (bench_dir / "metrics" / "dummy_ms.batch4.py").write_text(
        "def read(rec):\n    return rec.get('dummy')\n")
    bench["configs"].append(dict(name="dummy-config", source="a test",
                                 file="regbench/configs/dummy-config.json",
                                 reduced=[], why="a test"))
    bench["workloads"].append(dict(name="dummy.batch4", config="dummy-config",
                                   traffic="dummy4", chips=1, why="a test"))
    bench["per_layer"].append(dict(
        name="dummy_ms.batch4", unit="ms", better="lower",
        source="device_trace", layer="step", moves="setup_s",
        workloads=["dummy.batch4"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.cell("dummy.batch4", root)
    assert c.config["name"] == "dummy-config" and c.traffic["batch"] == 4
    assert [m["name"] for m in c.per_layer] == ["dummy_ms.batch4"]
    assert spec.reader("dummy_ms.batch4", root)({"dummy": 1.5}) == 1.5
    after = _digest(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before


def test_traffic_sets_only_what_is_read(tmp_path):
    """A traffic file that sets a key no generator or loop reads (say, a
    second client or an open loop) is refused, not run as one closed
    client."""
    root = tmp_path / "checkout"
    shutil.copytree(_paths.BENCH, root / _paths.BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.manifest(_paths.ROOT)
    (root / _paths.BENCH.name / "traffic" / "open4.json").write_text(
        json.dumps(dict(batch=1, pool_pairs=4, clients=4)))
    bench["workloads"].append(dict(name="open.clients4",
                                   config=bench["configs"][0]["name"],
                                   traffic="open4", chips=1, why="a test"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError, match="clients"):
        spec.cell("open.clients4", root)


def test_idle_share_reads_the_measured_pace():
    """The idle share is the traced window's busy time a batch over the
    measured window's time a batch, not over the traced window's own."""
    from benchlib import readers

    rec = dict(traced_busy_s=0.3, traced_batches=100, traced_window_s=0.9,
               window_s=50.0, latencies_s=[0.005] * 10000)
    assert readers.idle_pct(rec) == pytest.approx(40.0)
    assert readers.idle_pct(dict(rec, traced_batches=0)) is None
