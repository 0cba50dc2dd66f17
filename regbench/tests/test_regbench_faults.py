"""A run with the timed path broken underneath comes out not correct.

Each test drives the whole of ``run.main`` on the CPU (past the look for
a card) at a small size: a cell of its own, copied into a temporary
checkout beside the benchmark's files, with the limits of the eth-office
configuration. Without a fault the run is correct; with each fault this
kind of cell can have, ``correct`` is false:

- the step returns its state unchanged (no registration: identity
  transforms, zero scores and counts);
- half of the batch left out (the second half's results are the first
  half's);
- an answer altered where it is produced (one transform's translation
  moved by 1 cm).

The exchange between chips does not exist here: every cell takes one
chip.
"""

import dataclasses
import io
import json
import shutil
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

import _paths
import run


def unchanged(fn):
    def step(*args):
        res = fn(*args)
        eye = torch.eye(4, dtype=res.transform.dtype)
        return type(res)(
            transform=eye.expand(res.transform.shape).clone(),
            quick_score=torch.zeros_like(res.quick_score),
            fine_score=torch.zeros_like(res.fine_score),
            n_faces=torch.zeros_like(res.n_faces),
            n_hypotheses=torch.zeros_like(res.n_hypotheses),
            status=torch.zeros_like(res.status),
            type_transform=eye.expand(res.type_transform.shape).clone(),
            type_score=torch.zeros_like(res.type_score),
            kept=torch.zeros_like(res.kept))
    return step


def half_batch(fn):
    def step(*args):
        res = fn(*args)
        h = res.transform.shape[0] // 2
        return type(res)(*(torch.cat([x[:h], x[:h]]) for x in res))
    return step


def altered(fn):
    def step(*args):
        res = fn(*args)
        T = res.transform.clone()
        T[0, 0, 3] += 1e-2
        return res._replace(transform=T)
    return step


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A checkout holding the benchmark's files and a small cell."""
    from fccf_pcr_torch.config import TEST_CAPS, FCCFParams

    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(_paths.BENCH, root / _paths.BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench_dir = root / _paths.BENCH.name
    cfg = json.loads((bench_dir / "configs" / "eth-office.json").read_text())
    cfg.update(name="small", params=dataclasses.asdict(
        FCCFParams(leaf_size=0.25)), caps=dataclasses.asdict(TEST_CAPS),
        scene=dict(scene="room", points_per_plane=1500, clutter_points=900,
                   noise=0.004),
        pair=dict(max_angle_deg=40.0, max_trans=3.0, dropout=0.15))
    (bench_dir / "configs" / "small.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "small2.json").write_text(json.dumps(
        dict(batch=2, pool_pairs=2)))
    bench = json.loads((_paths.ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="small", source="a test",
                                 file="regbench/configs/small.json",
                                 reduced=[], why="a test"))
    bench["workloads"].append(dict(name="small.batch2", config="small",
                                   traffic="small2", chips=1, why="a test"))
    for m in bench["end_to_end"]:
        if m["name"] == "pairs_per_s":
            m["workloads"].append("small.batch2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def drive(root, fault):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", "small.batch2", "--seed", "2147483659",
                       "--seconds", "0.5", "--trace", "0"], root=root,
                      device="cpu", fault=fault)
    assert rc == 0, err.getvalue()
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert err.getvalue().strip().splitlines()[-1].startswith("check ")
    return result


def test_sound_run_is_correct(checkout):
    result = drive(checkout, None)
    assert result["correct"] is True
    assert result["attempted"] >= 2 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "pairs_per_s"}


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered],
                         ids=["unchanged", "half_batch", "altered"])
def test_fault_is_not_correct(checkout, fault):
    assert drive(checkout, fault)["correct"] is False


def test_no_card_no_result(checkout, monkeypatch):
    """Without a card the run exits with another code than 0 and prints
    no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with redirect_stdout(out), redirect_stderr(io.StringIO()):
        rc = run.main(["--workload", "small.batch2", "--seed", "1",
                       "--seconds", "1", "--trace", "0"], root=checkout)
    assert rc != 0 and out.getvalue() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    folder the run exits with another code than 0 and prints no result
    (here for want of a card, on a card for want of the program)."""
    import subprocess
    import sys

    shutil.copy(_paths.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(_paths.BENCH, tmp_path / _paths.BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, f"{_paths.BENCH.name}/run.py", "--workload",
         "office.single", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


def test_jax_loaded_no_result(checkout, monkeypatch):
    """A run in whose process a module named jax (or the JAX package) is
    loaded once the window has closed exits with another code than 0,
    prints no result and names it on standard error."""
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", "small.batch2", "--seed", "1",
                       "--seconds", "0.2", "--trace", "0"], root=checkout,
                      device="cpu")
    assert rc != 0 and out.getvalue() == ""
    assert "jax" in err.getvalue().strip().splitlines()[-1]
