"""What a run measures, found by name: the cell's entry in
``BENCHMARK.json``, its configuration file, its traffic mix
(``traffic/<name>.json``) and the readers of its per-layer metrics
(``metrics/<metric>.py``). A cell, a configuration, a traffic mix or a
metric is added by adding files and entries; no file here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def bench_dir(root: Path) -> Path:
    """The benchmark's folder in the checkout at ``root``."""
    return root / BENCH_DIR.name


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict        # the configuration file's object
    traffic: dict       # the traffic file's object
    end_to_end: list    # the BENCHMARK.json entries this cell reports
    per_layer: list


def manifest(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


# What a traffic file may set: the one general generator
# (``benchlib/pool.py``) and loop (``benchlib/loop.py``: one client, closed)
# read these keys and no others.
TRAFFIC_KEYS = {"batch", "pool_pairs", "about"}


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` under ``root``, with its
    files read."""
    bench = manifest(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (bench_dir(root) / "traffic" / f"{w['traffic']}.json").read_text())
    unknown = set(traffic) - TRAFFIC_KEYS
    if unknown:
        raise ValueError(f"traffic {w['traffic']!r} sets {sorted(unknown)}, "
                         f"which nothing reads; it may set only "
                         f"{sorted(TRAFFIC_KEYS)}")
    return Cell(name, w["chips"], config, traffic,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str, root: Path = ROOT):
    """The ``read(records)`` function of ``metrics/<metric>.py``."""
    path = bench_dir(root) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "regbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
