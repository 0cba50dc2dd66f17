"""Scenes and bands the twin is held to, as data the port can read
without the JAX package.

``FAMILIES`` are the twin-sweep scene families (``io.synthetic.make_pair``
keyword arguments: ``scene`` for the room, ``pair`` for the second scan),
a copy of ``tools/anchor_sensitivity.py``'s, which imports the JAX
package; ``face_membership_diff`` runs on their seed-30 targets at
``TEST_CAPS``. ``TWIN_BANDS`` are the (deg, m) bands of the pipeline
against the NumPy twin's cached transforms at production density
(``tests/golden/twin_production.json``), a copy of
``tests/test_twin_production.py``'s ``BANDS``. A test pins both copies.
"""

FAMILIES = {
    "office": dict(
        scene=dict(points_per_plane=800, clutter_points=400,
                   room=(10.0, 8.0, 3.0)),
        pair=dict(),
    ),
    "apartment": dict(
        scene=dict(points_per_plane=1600, clutter_points=700,
                   room=(9.0, 7.0, 3.0)),
        pair=dict(),
    ),
    "cross-season": dict(
        scene=dict(points_per_plane=700, clutter_points=900,
                   room=(12.0, 8.0, 3.5)),
        pair=dict(dropout=0.4, max_angle_deg=55.0, max_trans=5.0),
    ),
    "stairs": dict(
        scene=dict(scene="stairs", points_per_plane=1200,
                   clutter_points=600),
        pair=dict(),
    ),
    "hall": dict(
        scene=dict(scene="hall", points_per_plane=1000, clutter_points=600,
                   hall=(12.0, 7.0, 4.0), n_pillars=3),
        pair=dict(),
    ),
}

TWIN_BANDS = {
    "office": (0.15, 0.03),
    "structured": (1.3, 0.15),
    "resso": (0.5, 0.08),
    "heritage": (0.5, 0.3),
}
