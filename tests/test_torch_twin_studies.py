"""The port's twin studies against the JAX package's tools: the
``--generate`` half of ``evaluation/twin_production.py`` against
``tools/twin_production.py``'s, and ``evaluation/anchor_sensitivity.py``
against ``tools/anchor_sensitivity.py``. Both run the NumPy twin, which
the port copies bit for bit (``tests/test_torch_twin.py``).

Tolerances: generated rows equal the tool's (the twin's transform rounded
to 9 digits, the errors as the fixture rounds them); the Rand index and
the point labels exactly equal; a full anchoring record's integers and
booleans equal, its floats within 1e-4 deg and 1e-5 m (both sides
compute the errors in float32). The committed fixture predates a change
of the scene generator (``tests/golden/twin_production.json``'s office
seed 0 ground truth is 2.4e-7 from today's, and the JAX tool's own
twin now lands 0.0108 deg / 0.0053 m from the fixture's row), so against
the fixture a generated row is held to its clouds' sizes, its ground
truth within 1e-6 and the config's twin band."""

import json

import numpy as np
import pytest

from fccf_pcr_torch.evaluation import anchor_sensitivity as anchor
from fccf_pcr_torch.evaluation import twin_production
from fccf_pcr_torch.twin import twin as ttwin
from fccf_pcr_torch.twin.families import FAMILIES, TWIN_BANDS
from tools import anchor_sensitivity as janchor
from tools import twin_production as jtwin_production


def _row_without_time(r):
    return {k: v for k, v in r.items() if k != "twin_s"}


def _partial_without_office_0(path, fixture):
    """``path + ".partial"`` holding every fixture row but office seed 0's,
    so that a --generate run computes just that pair."""
    with open(str(path) + ".partial", "w") as f:
        for r in fixture:
            if (r["config"], r["seed"]) != ("office", 0):
                f.write(json.dumps(r) + "\n")


def _office_0(rows):
    return [r for r in rows if (r["config"], r["seed"]) == ("office", 0)][0]


def test_generate_office_seed_0_matches_the_tool(tmp_path, monkeypatch):
    """The port's --generate row for office seed 0 against the JAX tool's
    (each run with every other plan row already in its partial file, the
    tool's fixture path moved to a temp dir, so both compute just this
    pair); against the committed fixture within the office twin band; a
    rerun resumes from the partial file without running the twin."""
    fixture = json.loads(open(twin_production.FIXTURE).read())["rows"]
    moved = tmp_path / "jax" / "twin_production.json"
    moved.parent.mkdir()
    _partial_without_office_0(moved, fixture)
    monkeypatch.setattr(jtwin_production, "FIXTURE", str(moved))
    jtwin_production.generate()
    want = json.loads(moved.read_text())["rows"]

    out = str(tmp_path / "port.json")
    _partial_without_office_0(out, fixture)
    assert twin_production.main(["--generate", "--out", out]) == 0
    got = json.loads(open(out).read())["rows"]
    assert len(got) == len(want) == len(fixture)
    assert ([_row_without_time(r) for r in got]
            == [_row_without_time(r) for r in want])

    row, pinned = _office_0(got), _office_0(fixture)
    assert (row["n_src"], row["n_tar"]) == (pinned["n_src"], pinned["n_tar"])
    assert np.abs(np.subtract(row["T_gt"], pinned["T_gt"])).max() < 1e-6
    d = twin_production.errors(row["T_twin"], pinned["T_twin"])
    assert d[0] < TWIN_BANDS["office"][0] and d[1] < TWIN_BANDS["office"][1]

    def no_twin(*a, **k):
        raise AssertionError("the twin ran for a pair in the partial file")

    monkeypatch.setattr(ttwin, "register_pair", no_twin)
    assert twin_production.generate(out, log=lambda s: None) == got
    assert [r["seed"] for r in twin_production.generate(
        out, ["office"], log=lambda s: None)] == list(range(8))


def test_generate_never_writes_the_fixture(tmp_path):
    with pytest.raises(ValueError):
        twin_production.generate(twin_production.FIXTURE, ["office"])
    with pytest.raises(SystemExit):
        twin_production.main(["--generate"])  # no --out
    with pytest.raises(SystemExit):
        twin_production.main([])  # neither --generate nor --check


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rand_index_matches_the_tool(seed):
    """On seeded labellings with unlabelled rows (-1), and at fewer than
    two rows labelled in both."""
    rng = np.random.default_rng(seed)
    n = [1, 40, 500, 3000][seed]
    a = rng.integers(-1, 6, n)
    b = np.where(rng.uniform(size=n) < 0.8, a, rng.integers(-1, 9, n))
    assert anchor.rand_index(a, b) == janchor._rand_index(a, b)


@pytest.fixture(scope="module")
def office_target():
    """Office family seed 30's target, NaN-free and downsampled at the
    default leaf (the tool's cloud)."""
    from fccf_pcr_torch.config import FCCFParams
    from fccf_pcr_torch.io import synthetic

    cfg = FAMILIES["office"]
    _, tar, _ = synthetic.make_pair(seed=30, **cfg["scene"], **cfg["pair"])
    params = FCCFParams()
    return ttwin.voxel_grid_downsample(tar[np.isfinite(tar).all(1)],
                                       params.leaf_size), params


@pytest.mark.parametrize("anchoring", ["origin", "bbox"])
def test_point_labels_match_the_tool(office_target, anchoring):
    from fccf_pcr_tpu.config import FCCFParams as JParams

    cloud, params = office_target
    got = anchor.point_labels(cloud, params, anchoring)
    want = janchor._point_labels(cloud, JParams(), anchoring)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (got >= 0).any()


def test_record_matches_the_tool(tmp_path, monkeypatch, capsys):
    """Office seed 30 through both: the tool's main (its --json record)
    and the port's record."""
    path = tmp_path / "tool.jsonl"
    monkeypatch.setattr("sys.argv", ["anchor_sensitivity", "--families",
                                     "office", "--seeds", "30-30", "--json",
                                     str(path)])
    janchor.main()
    want = json.loads(path.read_text().splitlines()[0])
    got = anchor.record("office", 30)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float) and k.startswith(("rre", "rte")):
            assert abs(got[k] - v) <= (1e-4 if k.startswith("rre") else 1e-5), k
        else:
            assert got[k] == v and type(got[k]) is type(v), k
    capsys.readouterr()
    assert anchor.main(["--families", "office", "--seeds", "30-30"]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert json.loads(printed[0]) == got
    assert printed[1].startswith("[office] rand_index mean=")
