"""The port's constraint compiler (caliscope_tpu_torch/constraints.py) held
against the JAX package's (caliscope_tpu/constraints.py) on the same inputs.

Both are host numpy. The compiled arrays (indices, weights, targets,
sigmas) must be bit-equal — the solver's point reductions sum in their row
order — and so must the TOML bytes; the rigidity report agrees to 1e-12.
The marker-set and chessboard compilers read their targets by attribute, so
the port is fed plain stand-ins carrying the JAX package's target values.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from caliscope_tpu.constraints import ConstraintSet as JCS
from caliscope_tpu.constraints import DistanceConstraint as JDC
from caliscope_tpu.constraints import rigidity_report as j_rigidity
from caliscope_tpu.observations import ImagePoints as JIP
from caliscope_tpu.observations import WorldPoints as JWP
from caliscope_tpu.targets import ArucoMarker, ArucoMarkerSet, Charuco, Chessboard, DistanceLink, MirrorPair

from caliscope_tpu_torch import convert
from caliscope_tpu_torch.constraints import CentroidDistanceConstraint, ConstraintSet, DistanceConstraint
from caliscope_tpu_torch.constraints import rigidity_report as t_rigidity
from caliscope_tpu_torch.exceptions import PersistenceError
from caliscope_tpu_torch.observations import STATIC_SYNC_INDEX, ImagePoints, WorldPoints
from caliscope_tpu_torch.targets import Charuco as TCharuco


def port(cs) -> ConstraintSet:
    return convert.constraint_set(dataclasses.asdict(cs))


def assert_same_set(got: ConstraintSet, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def assert_same_arrays(got, want):
    if want is None:
        assert got is None
        return
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def stand_in_marker_set(ms):
    """A JAX ArucoMarkerSet's values on plain objects."""
    markers = {
        mid: SimpleNamespace(corners=np.array(m.corners, copy=True), static=m.static) for mid, m in ms.markers.items()
    }
    fields = lambda o: SimpleNamespace(**{k: getattr(o, k) for k in dir(o) if not k.startswith("_")})  # noqa: E731
    return SimpleNamespace(
        markers=markers, links=tuple(fields(link) for link in ms.links), mirror_pairs=tuple(fields(p) for p in ms.mirror_pairs)
    )


MARKER_SETS = {
    "center_link": lambda: ArucoMarkerSet(
        "DICT_4X4_50", {0: ArucoMarker(0, 0.1), 1: ArucoMarker(1, 0.1)}, links=(DistanceLink(0, 1, 0.5),)
    ),
    "corner_link_static": lambda: ArucoMarkerSet(
        "DICT_4X4_50",
        {0: ArucoMarker(0, 0.1, static=True), 1: ArucoMarker(1, 0.08, static=True), 2: ArucoMarker(2, 0.1)},
        links=(DistanceLink(0, 1, 0.5, 0, 2, sigma_m=0.003),),
    ),
    "zero_thickness_mirror": lambda: ArucoMarkerSet(
        "DICT_4X4_50", {0: ArucoMarker(0, 0.1), 1: ArucoMarker(1, 0.1)}, mirror_pairs=(MirrorPair(0, 1, 0, 0, thickness_m=0.0),)
    ),
    "thick_mirror": lambda: ArucoMarkerSet(
        "DICT_4X4_50", {0: ArucoMarker(0, 0.1), 1: ArucoMarker(1, 0.1)}, mirror_pairs=(MirrorPair(0, 1, 0, 0, thickness_m=0.005),)
    ),
}


@pytest.mark.parametrize("name", sorted(MARKER_SETS))
def test_from_marker_set_matches_jax(name):
    ms = MARKER_SETS[name]()
    want = JCS.from_marker_set(ms)
    got = ConstraintSet.from_marker_set(stand_in_marker_set(ms))
    assert_same_set(got, want)


@pytest.mark.parametrize(
    "rows,columns,square,thickness",
    [(5, 7, 0.054, 0.0), (4, 4, 0.05, 0.006), (6, 9, 0.03, 0.004)],
    ids=["single_sided", "two_sided_4x4", "two_sided_6x9"],
)
def test_from_charuco_matches_jax_and_counts(rows, columns, square, thickness):
    jch = Charuco(rows=rows, columns=columns, square_size_m=square, thickness_m=thickness)
    want = JCS.from_charuco(jch)
    got = ConstraintSet.from_charuco(TCharuco(rows=rows, columns=columns, square_size_m=square, thickness_m=thickness))
    assert_same_set(got, want)
    nx, ny = columns - 1, rows - 1  # the corner grid
    truss = nx * (ny - 1) + ny * (nx - 1) + 2 * (nx - 1) * (ny - 1) + 6
    cross = [c for c in got.distances if c.object_id_a != c.object_id_b]
    if thickness == 0:
        assert len(got.distances) == truss and not cross
    else:
        # a truss per face, one tie per corner, right/down braces
        assert len(cross) == nx * ny + (nx - 1) * ny + nx * (ny - 1)
        assert len(got.distances) == 2 * truss + len(cross)
        assert sum(c.distance == thickness for c in cross) == nx * ny
    assert got.back_face_thickness_m == thickness and not got.static_object_ids


def test_from_chessboard_matches_jax_on_a_stand_in():
    cb = Chessboard(rows=6, columns=8, square_size_m=0.03)
    want = JCS.from_chessboard(cb)
    stand_in = SimpleNamespace(square_size_m=cb.square_size_m, object_points=lambda: np.array(cb.object_points(), copy=True))
    assert_same_set(ConstraintSet.from_chessboard(stand_in), want)
    with pytest.raises(ValueError, match="square_size"):
        ConstraintSet.from_chessboard(SimpleNamespace(square_size_m=None, object_points=lambda: None))


def _world(rng, n_sync=6, n_kp=12, mobile=0, static=(5, 7), drop=0.15):
    """A world-point table: `mobile` seen at n_sync syncs, the static
    objects once at STATIC_SYNC_INDEX, a fraction of rows dropped."""
    rows = [(s, mobile, k) for s in range(n_sync) for k in range(n_kp)]
    rows += [(STATIC_SYNC_INDEX, o, k) for o in static for k in range(4)]
    keep = rng.uniform(size=len(rows)) > drop
    rows = [r for r, k in zip(rows, keep) if k]
    si, oi, ki = (np.array(c) for c in zip(*rows))
    xyz = rng.normal(size=(len(rows), 3))
    return (si, oi, ki, xyz)


def _mixed_set(static=(5, 7)):
    cons = [JDC(0, a, 0, b, 0.05 * (1 + a + b), 0.002) for a, b in [(0, 1), (1, 2), (3, 7), (2, 11), (4, 9)]]
    cons += [JDC(o, i, o, j, 0.1, 0.002) for o in static for i in range(4) for j in range(i + 1, 4)]
    cons.append(JDC(0, 1, static[0], 2, 0.3, 0.002))  # mixed static/mobile: skipped
    from caliscope_tpu.constraints import CentroidDistanceConstraint as JCC

    cents = (JCC(static[0], static[1], 0.7, 0.005), JCC(0, static[0], 0.2, 0.005))
    return JCS(tuple(cons), frozenset(static), cents)


@pytest.mark.parametrize("firing", ["mobile", "static", "mixed"])
def test_compile_arrays_bit_equal(firing):
    rng = np.random.default_rng({"mobile": 1, "static": 2, "mixed": 3}[firing])
    si, oi, ki, xyz = _world(rng)
    jcs = _mixed_set()
    if firing == "mobile":
        jcs = jcs.without_objects(frozenset({5, 7}))
    elif firing == "static":
        jcs = JCS(tuple(d for d in jcs.distances if d.object_id_a != 0), jcs.static_object_ids, jcs.centroid_distances[:1])
    jw, tw = JWP(si, oi, ki, xyz), WorldPoints(si, oi, ki, xyz)
    want = jcs.compile_arrays(jw)
    got = port(jcs).compile_arrays(tw)
    assert want is not None
    assert_same_arrays(got, want)
    rep_j, rep_t = j_rigidity(jcs, jw), t_rigidity(port(jcs), tw)
    assert rep_t.n_violations == rep_j.n_violations > 0
    np.testing.assert_array_equal(rep_t.expected, rep_j.expected)
    np.testing.assert_allclose(rep_t.actual, rep_j.actual, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(rep_t.object_pairs, rep_j.object_pairs)
    for name in ("rmse_mm", "relative_rmse_pct", "max_violation_mm"):
        np.testing.assert_allclose(getattr(rep_t, name), getattr(rep_j, name), rtol=1e-12)
    assert rep_t.per_object_rmse_mm.keys() == rep_j.per_object_rmse_mm.keys()
    for k, v in rep_j.per_object_rmse_mm.items():
        np.testing.assert_allclose(rep_t.per_object_rmse_mm[k], v, rtol=1e-12)


def test_firing_semantics_and_empty_inputs():
    """The JAX package's firing cases: a mobile row at each shared sync, a
    static row once, a mixed row never; no rows or no world points -> None
    and an empty report."""
    world = WorldPoints(
        np.array([0, 0, 1, 1, STATIC_SYNC_INDEX, STATIC_SYNC_INDEX]),
        np.array([0, 0, 0, 0, 5, 5]),
        np.array([0, 1, 0, 1, 0, 1]),
        np.array([[0, 0, 0], [1, 0, 0], [0, 0, 0], [1.1, 0, 0], [0, 0, 0], [0, 2, 0]], float),
    )
    cs = ConstraintSet((DistanceConstraint(0, 0, 0, 1, 1.0, 0.002), DistanceConstraint(5, 0, 5, 1, 2.0, 0.002)), frozenset({5}))
    assert len(cs.compile_arrays(world)[4]) == 3
    assert ConstraintSet((DistanceConstraint(0, 0, 5, 0, 1.0, 0.002),), frozenset({5})).compile_arrays(world) is None
    assert ConstraintSet((), frozenset()).compile_arrays(world) is None
    assert t_rigidity(None, world).n_violations == 0
    assert t_rigidity(cs, WorldPoints.empty()).rmse_mm == 0.0


def test_toml_byte_identical_and_round_trip(tmp_path):
    jcs = _mixed_set()
    remap = JCS.from_marker_set(MARKER_SETS["zero_thickness_mirror"]())
    two = JCS.from_charuco(Charuco(rows=4, columns=4, square_size_m=0.05, thickness_m=0.006))
    for i, cs in enumerate((jcs, remap, two)):
        cs.to_toml(tmp_path / f"j{i}.toml")
        port(cs).to_toml(tmp_path / f"t{i}.toml")
        assert (tmp_path / f"t{i}.toml").read_bytes() == (tmp_path / f"j{i}.toml").read_bytes()
        assert_same_set(ConstraintSet.from_toml(tmp_path / f"j{i}.toml"), JCS.from_toml(tmp_path / f"j{i}.toml"))
        assert ConstraintSet.from_toml(tmp_path / f"t{i}.toml") == port(cs)
    with pytest.raises(PersistenceError, match="not found"):
        ConstraintSet.from_toml(tmp_path / "missing.toml")
    (tmp_path / "bad.toml").write_text("distances = [ { object_id_a = 0 } ]\n")
    with pytest.raises(PersistenceError, match="Failed to load"):
        ConstraintSet.from_toml(tmp_path / "bad.toml")


def test_remaps_and_without_objects_match_jax():
    ms = MARKER_SETS["zero_thickness_mirror"]()
    jcs = JCS.from_marker_set(ms)
    tcs = port(jcs)
    assert len(tcs.point_remaps) == 4 and len(tcs.distances) == 6
    rng = np.random.default_rng(4)
    n = 40
    cols = dict(
        sync_index=rng.integers(0, 5, n), cam_id=rng.integers(0, 3, n), object_id=rng.integers(0, 2, n),
        keypoint_id=rng.integers(0, 4, n), img_xy=rng.uniform(0, 1000, (n, 2)),
    )
    want = jcs.remap_image_points(JIP(**cols))
    got = tcs.remap_image_points(ImagePoints(**cols))
    for f in ("sync_index", "cam_id", "object_id", "keypoint_id", "img_xy", "obj_loc"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert ConstraintSet((), frozenset()).remap_image_points(got) is got
    mixed = _mixed_set()
    for drop in ({5}, {0, 7}, {5, 7}):
        assert_same_set(port(mixed).without_objects(frozenset(drop)), mixed.without_objects(frozenset(drop)))
    assert port(mixed).has_constraints and not ConstraintSet((), frozenset({3})).has_constraints
    assert isinstance(port(mixed).centroid_distances[0], CentroidDistanceConstraint)
