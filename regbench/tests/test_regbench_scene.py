"""The frozen scene generator gives the clouds it gave when it was copied
from the program's generator (``fccf_pcr_torch/io/synthetic.py``)."""

import hashlib
import json

import numpy as np
import pytest

import _paths
from benchlib import pool, scene

# sha256 of (source, target, T_gt) at seed 2147483659, taken when the
# generator was copied: the office configuration's scene, and the
# courtyard of the port's heritage preset, which no cell runs yet.
DIGESTS = {
    "eth-office": ("c703ee2c995203ca0082404b2ee05fb4d0a5256c6387a5f14f10d523b2"
                   "6e2683", (105522, 123996)),
    "courtyard": ("812ec8eccbca57b90056db0a2188087a033ae906d813e197e89be57ead5"
                  "fe3e2", (212089, 282873)),
}
COURTYARD = dict(scene=dict(scene="courtyard", density=14.0,
                            clutter_points=8000, noise=0.015),
                 pair=dict(max_angle_deg=40.0, max_trans=8.0, dropout=0.25))


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_scene_as_copied(name):
    path = _paths.BENCH / "configs" / f"{name}.json"
    cfg = json.loads(path.read_text()) if path.is_file() else COURTYARD
    src, tar, T = scene.make_pair(seed=2147483659, **cfg["scene"],
                                  **cfg["pair"])
    h = hashlib.sha256()
    for a in (src, tar, T):
        h.update(np.ascontiguousarray(a).tobytes())
    assert (src.shape[0], tar.shape[0]) == DIGESTS[name][1]
    assert h.hexdigest() == DIGESTS[name][0]


def test_pair_seeds():
    """Any whole number seeds the pool, the same seed the same pairs."""
    for seed in (0, 7, 2**31 + 11, 2**40 + 3, -5):
        a, b = pool.pair_seeds(seed, 16), pool.pair_seeds(seed, 16)
        assert a == b and len(set(a)) == 16
    assert pool.pair_seeds(1, 8) != pool.pair_seeds(2, 8)


def test_pad_points():
    pts = np.arange(30, dtype=np.float32).reshape(10, 3)
    p, m = scene.pad_points(pts, 16)
    assert m.sum() == 10 and np.array_equal(p[:10], pts) and not p[10:].any()
    p, m = scene.pad_points(pts, 4)
    assert m.all() and np.array_equal(p, pts[[0, 3, 6, 9]])
