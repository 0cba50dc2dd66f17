"""The port's CLI (``python -m fccf_pcr_torch``) against the JAX package's
on the same PLY files: the --json record, the reference's plain output,
the --batch/--out sweep path, and --device cuda without a card.

Record: status, face and hypothesis counts and the preprocess flags
exact; transform within the golden band (0.1 deg / 0.02 m); scores
rtol 1e-3 / atol 1e-5."""

import json

import numpy as np
import pytest
import torch

from fccf_pcr_tpu import cli as jcli
from fccf_pcr_tpu.io import ply, synthetic
from fccf_pcr_torch import cli as tcli
from fccf_pcr_torch import registration_errors


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """Three scans of one room: two consecutive pairs (tests/test_io.py's
    CLI scene)."""
    d = tmp_path_factory.mktemp("scans")
    src, tar, _ = synthetic.make_pair(
        seed=1, points_per_plane=400, clutter_points=200, room=(7.0, 5.0, 3.0)
    )
    _, third, _ = synthetic.make_pair(
        seed=2, points_per_plane=400, clutter_points=200, room=(7.0, 5.0, 3.0)
    )
    paths = [str(d / f"{k}.ply") for k in "abc"]
    for p, cloud in zip(paths, (src, tar, third)):
        ply.write_ply(p, cloud)
    return paths


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


def test_json_record_matches_jax(scans, capsys):
    argv = [scans[0], scans[1], "0.25", "--caps", "tiny", "--device", "cpu",
            "--json"]
    j = json.loads(_run(jcli.main, argv, capsys).splitlines()[-1])
    t = json.loads(_run(tcli.main, argv, capsys).splitlines()[-1])
    assert t["device"] == "cpu" and t["scans"] == j["scans"]
    for f in ("leaf_size", "status", "n_faces", "n_hypotheses",
              "preprocess_overflow", "escalated"):
        assert t[f] == j[f], f
    rre, rte = registration_errors(
        torch.tensor(t["transform"], dtype=torch.float64),
        torch.tensor(j["transform"], dtype=torch.float64),
    )
    assert float(rre) < 0.1 and float(rte) < 0.02
    for f in ("quick_score", "fine_score"):
        np.testing.assert_allclose(t[f], j[f], rtol=1e-3, atol=1e-5)


def test_plain_output_is_the_references(scans, capsys):
    out = _run(tcli.main, [scans[0], scans[1], "0.25", "--caps", "tiny",
                           "--device", "cpu"], capsys).splitlines()
    assert out[0] == "Leaf size : 0.25"
    assert out[1].strip() == "Transformation:"
    T = np.array([[float(v) for v in row.split()] for row in out[2:6]])
    assert T.shape == (4, 4) and np.isfinite(T).all()
    np.testing.assert_allclose(T[3], [0, 0, 0, 1])


def test_batch_sweep_writes_records(scans, capsys, tmp_path):
    out = str(tmp_path / "sweep.jsonl")
    line = _run(tcli.main, ["--batch", *scans, "--out", out, "--caps", "tiny",
                            "--device", "cpu", "--json"], capsys)
    summary = json.loads(line.splitlines()[-1])
    assert summary["out"] == out and summary["summary"]["n_pairs"] == 2
    records = [json.loads(x) for x in open(out)]
    assert [r.get("pair") for r in records[:-1]] == [0, 1]
    assert records[-1] == {"summary": summary["summary"]}
    for r in records[:-1]:
        assert np.isfinite(np.asarray(r["transform"])).all()


def test_cuda_without_a_card_fails(scans, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit) as e:
        tcli.main([scans[0], scans[1], "0.25", "--caps", "tiny", "--json"])
    assert e.value.code != 0
    assert "cuda" in capsys.readouterr().err
