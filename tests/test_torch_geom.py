"""The port's geometry engine (``roadsurf_tpu_torch/geom``: the C++ core
``csrc/geomcore.cpp``, ``core``, ``affinity``, ``index``, ``table``,
``cleanup``) against the reference package's.

1. Every case of tests/test_geom_core.py, test_geom_adversarial.py and
   test_geom_table.py runs through the port (the same source, its imports
   pointed at the port).
2. The repaired faults: two polygons of a road grid that only touch (a
   vertex of one on an edge of the other, the T-junction fault) give the
   true difference, intersection and union in the port; so do two
   polygons that touch along a side where one has a zero-width spike
   (fault (c)); the union of an 8x8 road grid's buffers keeps the holes
   of the fields it encloses (fault (a)), held to a raster oracle.
   Fault (b), buffer(0) of a polygon whose hole leaves its shell, is held
   by the buffer test of part 3.
3. The repair moves nothing else: on 200 seeded random polygon pairs
   (convex and concave, with holes) and on the adversarial cases, every
   result of the port equals the reference's, coordinates and areas
   exact; so do line and polygon buffers, ``union_many``,
   ``points_in_polyset``, ``polyset_intersects``, ``sjoin`` and
   ``overlay``.

An empty areal result is an empty ``Polygon`` in the port and an empty
``MultiPolygon`` in the reference; the comparison takes both as empty.
"""

from __future__ import annotations

import functools
import re
import types
from fractions import Fraction
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from roadsurf_tpu.geom import _native as jn
from roadsurf_tpu.geom import core as jcore
from roadsurf_tpu.geom import table as jtable
from roadsurf_tpu.geom.cleanup import polygons_diff_without_artifacts as jdiff
from roadsurf_tpu_torch.geom import _native as tn
from roadsurf_tpu_torch.geom import core as tcore
from roadsurf_tpu_torch.geom import table as ttable
from roadsurf_tpu_torch.geom.cleanup import \
    polygons_diff_without_artifacts as tdiff

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
REFERENCE_CASES = ("test_geom_core.py", "test_geom_adversarial.py",
                   "test_geom_table.py")
OPS = ("intersection", "union", "difference", "symmetric_difference")


# ---------------------------------------------------------------------------
# exact comparison

def geom_key(g):
    """A geometry as its type and exact coordinates (bytes of the float64
    arrays); every empty areal or lineal geometry is ("EMPTY",)."""
    if g is None:
        return None
    t = g.geom_type
    if t != "Point" and g.is_empty:
        return ("EMPTY",)
    if t == "Point":
        return (t, g.x, g.y)
    if t == "LineString":
        return (t, g.coords_array.tobytes())
    if t == "Polygon":
        return (t, g.exterior_coords.tobytes(),
                tuple(h.tobytes() for h in g.interiors_coords))
    return (t, tuple(geom_key(p) for p in g.geoms))


def assert_tables_equal(got, want):
    """Two GeoDataFrames (one of each package): the same columns, index,
    attribute values and dtypes, CRS and geometries."""
    assert list(got.columns) == list(want.columns)
    assert str(got.crs) == str(want.crs)
    pd.testing.assert_frame_equal(
        pd.DataFrame(got.drop(columns="geometry")),
        pd.DataFrame(want.drop(columns="geometry")))
    assert [geom_key(g) for g in got["geometry"]] == \
        [geom_key(g) for g in want["geometry"]]


# ---------------------------------------------------------------------------
# 1. the reference's geometry tests, through the port

def _reference_cases():
    cases = []
    for fname in REFERENCE_CASES:
        src = (TESTS / fname).read_text()
        names = re.findall(r"^def (test_\w+)\(\):", src, re.M)
        assert len(names) == len(re.findall(r"^def test_", src, re.M)), \
            f"{fname} has a test that takes fixtures"
        cases += [(fname, n) for n in names]
    return cases


@functools.lru_cache(maxsize=None)
def _port_module(fname: str) -> types.ModuleType:
    """The reference's test module with every ``roadsurf_tpu`` import
    pointed at ``roadsurf_tpu_torch``."""
    src = re.sub(r"\broadsurf_tpu\b", "roadsurf_tpu_torch",
                 (TESTS / fname).read_text())
    mod = types.ModuleType(f"port_{fname[:-3]}")
    mod.__file__ = str(TESTS / fname)
    exec(compile(src, f"<{fname} through the port>", "exec"), mod.__dict__)
    return mod


@pytest.mark.parametrize("fname,name", _reference_cases())
def test_reference_geometry_case_holds_in_the_port(fname, name):
    getattr(_port_module(fname), name)()


# ---------------------------------------------------------------------------
# 2. the repaired fault

# two road polygons of a jittered road grid after a de-overlap cut
# (EPSG:2056): a vertex of P2 (the first) lies on the edge of P1 between
# its first and last vertex; the polygons only touch there
P1 = [[2600474.1590133384, 1201952.499337598],
      [2600431.7271640813, 1202083.26596991],
      [2600439.3365870994, 1202085.7351157821],
      [2600481.768436356, 1201954.9684834701],
      [2600474.1590133384, 1201952.499337598]]
P2 = [[2600477.963724847, 1201953.733910534],
      [2600478.11860872, 1201951.739916806],
      [2600481.856576234, 1201952.814286656],
      [2600481.6679013753, 1201952.0156088432],
      [2600586.5858297893, 1201960.165130512],
      [2600586.2760620434, 1201964.153117967],
      [2600477.963724847, 1201953.733910534]]


def exact_area(g) -> float:
    """The area of a (Multi)Polygon in rational arithmetic (its float64
    vertices are exact), so no rounding of the shoelace sum at LV95
    coordinates enters the comparison."""
    total = Fraction(0)
    for p in (g.geoms if g.geom_type == "MultiPolygon" else [g]):
        for k, ring in enumerate([p.exterior_coords, *p.interiors_coords]):
            pts = [(Fraction(x), Fraction(y)) for x, y in ring]
            s = sum(x0 * y1 - x1 * y0 for (x0, y0), (x1, y1)
                    in zip(pts, pts[1:] + pts[:1]))
            total += abs(s) / 2 if k == 0 else -abs(s) / 2
    return float(total)


def test_touching_polygons_give_true_boolean_results():
    p1, p2 = tcore.Polygon(P1), tcore.Polygon(P2)
    a1, a2 = exact_area(p1), exact_area(p2)
    assert a1 == pytest.approx(1099.8290, abs=1e-4)
    assert a2 == pytest.approx(324.9905, abs=1e-4)
    assert exact_area(p2 - p1) == pytest.approx(a2, rel=1e-9)
    assert exact_area(p1 - p2) == pytest.approx(a1, rel=1e-9)
    assert exact_area(p1 & p2) <= 1e-6
    assert exact_area(p1 | p2) == pytest.approx(a1 + a2, rel=1e-9)
    assert exact_area(p2 & p1) <= 1e-6
    assert exact_area(p2 | p1) == pytest.approx(a1 + a2, rel=1e-9)


def test_empty_difference_passes_through_the_cleanup():
    """A road polygon that the cut removes whole: the port's empty
    difference is an empty Polygon, which replaces the row (the
    reference's empty MultiPolygon raised on max() of no parts)."""
    ring = np.array(P1[:-1])
    inner = ring.mean(0) + 0.5 * (ring - ring.mean(0))
    rows = {"OBJECTID": [1, 2],
            "geometry": [tcore.Polygon(P1), tcore.Polygon(inner)]}
    out = tdiff(ttable.GeoDataFrame(rows, crs=2056), 0, 1,
                keep_everything=True)
    assert len(out) == 2
    g = out.loc[1, "geometry"]
    assert g.geom_type == "Polygon" and g.is_empty
    jrows = {"OBJECTID": [1, 2],
             "geometry": [jcore.Polygon(P1), jcore.Polygon(inner)]}
    with pytest.raises(ValueError):
        jdiff(jtable.GeoDataFrame(jrows, crs=2056), 0, 1,
              keep_everything=True)


# two polygons that touch along a side (EPSG:2056): A's side runs along
# B's, and A has a zero-width spike along it (its third to fifth vertices)
TOUCH_A = [[2600000.0, 1200000.0], [2599995.464868169, 1200010.1737698792],
           [2599993.8447878123, 1200009.4515913671],
           [2599993.085424695, 1200009.1130922772],
           [2599993.8447878123, 1200009.4515913671],
           [2599987.811237242, 1200006.7620330646],
           [2599992.3463690733, 1199996.5882631855]]
TOUCH_B = [[2599996.2618327267, 1200010.5290304536],
           [2599991.7546670805, 1200018.4969528613],
           [2599979.1729539447, 1200013.8599244186],
           [2599984.38478473, 1200005.2346332867]]


def test_a_spike_along_the_other_polygons_side_leaves_the_result_true():
    """Fault (c): the reference's A & B covers 36.79 m², A | B 125.59 and
    A - B nothing; the port drops the spike that runs along B's side before
    the sweep."""
    a, b = tcore.Polygon(TOUCH_A), tcore.Polygon(TOUCH_B)
    ja, jb = jcore.Polygon(TOUCH_A), jcore.Polygon(TOUCH_B)
    assert (ja & jb).area > 30 and (ja - jb).area == 0   # the reference
    area_a, area_b = exact_area(a), exact_area(b)
    assert exact_area(a & b) <= 1e-6 and exact_area(b & a) <= 1e-6
    assert exact_area(a - b) == pytest.approx(area_a, rel=1e-9)
    assert exact_area(b - a) == pytest.approx(area_b, rel=1e-9)
    assert exact_area(a | b) == pytest.approx(area_a + area_b, rel=1e-9)


@pytest.mark.parametrize("op", OPS)
def test_spikes_that_run_along_no_edge_stay(op):
    """A spike is dropped only where an edge of the other operand runs along
    it: the adversarial spike against a square inside its polygon gives the
    reference's result, spike included."""
    spike, square = _adversarial_pairs()[5]
    (ja, jb), (ta, tb) = _both((spike, square))
    for x, y, u, v in ((ja, jb, ta, tb), (jb, ja, tb, ta)):
        assert geom_key(getattr(u, op)(v)) == geom_key(getattr(x, op)(y))


def _fill(polys, x0, y0, px, h, w) -> np.ndarray:
    """Even-odd pixel-centre fill of each polygon, OR-ed, on one grid."""
    out = np.zeros((h, w), bool)
    for g in polys:
        for p in (g.geoms if g.geom_type == "MultiPolygon" else [g]):
            bx0, by0, bx1, by1 = p.bounds
            c0, c1 = max(int((bx0 - x0) / px) - 1, 0), \
                min(int((bx1 - x0) / px) + 2, w)
            r0, r1 = max(int((by0 - y0) / px) - 1, 0), \
                min(int((by1 - y0) / px) + 2, h)
            out[r0:r1, c0:c1] |= tn.rasterize(
                tn.pack([[p.exterior_coords, *p.interiors_coords]]),
                x0 + c0 * px, px, y0 + r0 * px, px, r1 - r0,
                c1 - c0).astype(bool)
    return out


def test_road_grid_union_keeps_the_fields_holes():
    """Fault (a): the union of an 8x8 jittered road grid's buffers (the
    restricted AOI's union, 4.5 m round-capped) equals the union of their
    fills at 0.5 m pixels, and holds one hole for each field the roads
    enclose. The reference's union lost most of them (where a road's buffer
    meets its neighbour's, a vertex computed onto an edge almost coincides
    with it; the port splits that edge there)."""
    from scipy import ndimage

    import chip_smoke

    roads = chip_smoke.scene_roads(8, 0)
    bufs = [tcore.LineString(g.coords_array).buffer(4.5)
            for g in roads.geometry.values]
    union = tcore.union_all(bufs)
    x0, y0, x1, y1 = np.array(union.bounds) + [-2.0137, -2.0291, 2, 2]
    px = 0.5
    h, w = int(np.ceil((y1 - y0) / px)), int(np.ceil((x1 - x0) / px))
    truth = _fill(bufs, x0, y0, px, h, w)
    got = _fill([union], x0, y0, px, h, w)
    assert (got != truth).sum() <= 4, (got != truth).sum()
    # the fields: the parts of the rest, pixels joined by a side or a corner
    n_fields = ndimage.label(~truth, structure=np.ones((3, 3)))[1] - 1
    holes = sum(len(p.interiors_coords) for p in (
        union.geoms if union.geom_type == "MultiPolygon" else [union]))
    assert n_fields >= 40 and holes == n_fields, (holes, n_fields)
    want = jcore.union_all([jcore.LineString(g.coords_array).buffer(4.5)
                            for g in roads.geometry.values])
    ref = _fill([_to_port(want)], x0, y0, px, h, w)
    assert (ref != truth).mean() > 0.1          # the reference's fault


def _to_port(g):
    polys = g.geoms if g.geom_type == "MultiPolygon" else [g]
    return tcore.MultiPolygon([tcore.Polygon(p.exterior_coords,
                                             p.interiors_coords)
                               for p in polys])


# ---------------------------------------------------------------------------
# 3. the port equals the reference

def _star(rng, centre, radius, n, jag):
    """A simple star-shaped ring: n vertices at sorted angles, radii in
    [radius·(1 - jag), radius]; convex when jag is 0."""
    a = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = radius * (1 - jag * rng.random(n))
    return centre + np.stack([r * np.cos(a), r * np.sin(a)], 1)


def _random_polygon(rng, origin):
    c = origin + rng.uniform(0, 40, 2)
    radius = rng.uniform(5, 20)
    convex = rng.random() < 0.4
    shell = _star(rng, c, radius, int(rng.integers(3 if convex else 5, 14)),
                  0.0 if convex else 0.6)
    holes = []
    if not convex and rng.random() < 0.4:
        holes = [_star(rng, c, 0.3 * radius, int(rng.integers(3, 7)), 0.3)]
    return shell, holes


@functools.lru_cache(maxsize=None)
def random_pairs(n: int = 200, seed: int = 10):
    """n seeded polygon pairs (shell, holes), half near the origin, half at
    LV95 coordinates."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        origin = np.zeros(2) if i % 2 else np.array([2600000.0, 1200000.0])
        out.append((_random_polygon(rng, origin),
                    _random_polygon(rng, origin)))
    return out


def _adversarial_pairs():
    def sq(x0, y0, x1, y1):
        return [[x0, y0], [x1, y0], [x1, y1], [x0, y1]], []

    def donut(x0, y0, x1, y1, hx0, hy0, hx1, hy1):
        return sq(x0, y0, x1, y1)[0], [sq(hx0, hy0, hx1, hy1)[0]]

    eps = 1e-12
    spike = ([[0, 0], [4, 0], [4, 4], [2, 4], [6, 4], [4, 4], [4, 8],
              [0, 8]], [])
    outer = donut(0, 0, 20, 20, 4, 4, 16, 16)
    inner = donut(6, 6, 14, 14, 9, 9, 11, 11)
    return [
        (sq(0, 0, 2, 2), sq(2, 0, 4, 2)),                 # shared edge
        (sq(0, 0, 10, 10), sq(0, 4, 3, 6)),               # flush notch
        (sq(0, 0, 4, 4), ([[4, 2], [6, 1], [6, 3]], [])),  # T-junction
        (sq(0, 0, 2, 2), ([[eps, 0], [2 + eps, 0], [2 + eps, 2],
                           [eps, 2]], [])),               # nearly equal
        (sq(0, 0, 10, 10), ([[0, 0], [10, 0], [10, 1e-9], [0, 1e-9]], [])),
        (spike, sq(1, 1, 3, 3)),
        (outer, inner), (inner, outer),
        (outer, (sq(0, 0, 20, 20)[0], [sq(4, 4, 16, 16)[0]])),
        (sq(0, 0, 10, 10), sq(0, 4, 10, 6)),              # split in two
        (sq(0, 0, 10, 10), sq(3, 3, 6, 6)),               # hole
    ]


def _both(pair):
    (s1, h1), (s2, h2) = pair
    return ((jcore.Polygon(s1, h1), jcore.Polygon(s2, h2)),
            (tcore.Polygon(s1, h1), tcore.Polygon(s2, h2)))


@pytest.mark.parametrize("op", OPS)
def test_boolean_ops_equal_the_reference(op):
    pairs = list(random_pairs()) + _adversarial_pairs()
    for i, pair in enumerate(pairs):
        (ja, jb), (ta, tb) = _both(pair)
        for x, y, u, v in ((ja, jb, ta, tb), (jb, ja, tb, ta)):
            want, got = getattr(x, op)(y), getattr(u, op)(v)
            assert geom_key(got) == geom_key(want), (op, i)
            assert got.area == want.area, (op, i)


@pytest.mark.parametrize("cap_style", [1, 2, 3])
def test_line_buffers_equal_the_reference(cap_style):
    rng = np.random.default_rng(20 + cap_style)
    for i in range(60):
        pts = np.cumsum(rng.uniform(-30, 30, (int(rng.integers(2, 6)), 2)),
                        0) + (2600000.0 if i % 2 else 0.0)
        d = float(rng.uniform(0.5, 6))
        want = jcore.LineString(pts).buffer(d, cap_style=cap_style)
        got = tcore.LineString(pts).buffer(d, cap_style=cap_style)
        assert geom_key(got) == geom_key(want), i


def _miss(g, truth, pts) -> float:
    """The share of ``pts`` on which ``g`` and ``truth`` (a bool array)
    disagree."""
    inside = (tn.points_in_polyset(pts, g._flat()) if not g.is_empty
              else np.zeros(len(pts), bool))
    return float((inside != truth).mean())


def _within(pts, poly, d) -> np.ndarray:
    """Points inside ``poly`` or within ``d`` of its boundary."""
    near = tn.points_in_polyset(pts, poly._flat())
    for ring in [poly.exterior_coords, *poly.interiors_coords]:
        for a, b in zip(ring, np.roll(ring, -1, 0)):
            ab = b - a
            t = np.clip((pts - a) @ ab / (ab @ ab), 0, 1)
            near |= np.hypot(*(pts - a - t[:, None] * ab).T) <= d
    return near


# a buffer's 32-gon arcs lie within d·(1 - cos(pi/32)) of the true
# distance, which a few of the sampled points fall into
BUFFER_MISS = 1e-3


def _hole_points(*gs) -> np.ndarray:
    """A point in each hole of the given results (its vertices' mean)."""
    pts = [h.mean(0) for g in gs
           for p in (g.geoms if g.geom_type == "MultiPolygon" else [g])
           for h in p.interiors_coords]
    return np.array(pts).reshape(-1, 2)


def _buffer_ok(g, poly, d, pts, truth, probes) -> bool:
    """The buffer ``g`` of ``poly`` by ``d`` agrees with the oracle on the
    sampled points, and on every probe, a point in a hole of either result
    compared (holes too small to be sampled): none of its own holes lies
    within ``d`` of ``poly``, and it lacks no hole of the other that lies
    farther."""
    if _miss(g, truth, pts) > BUFFER_MISS:
        return False
    return not len(probes) or _miss(g, _within(probes, poly, d), probes) == 0


def test_polygon_buffers_equal_the_reference_where_it_is_right():
    """Where the reference's buffer agrees with the distance oracle (sampled
    points inside the polygon or within d of it, and a point in each hole
    of either result), the port's equals it exactly. Where it does not, the
    port's agrees with the oracle: the T-junction fault (rectangles and
    disks meet in vertices on edges), and buffer(0) of a polygon whose hole
    leaves its shell, which the reference reads even-odd, keeping the
    hole's outer part (ROADMAP Queue C, fault (b))."""
    rng = np.random.default_rng(40)
    wrong_ref = kept = 0
    for i, ((s, h), _) in enumerate(random_pairs()[:60]):
        for d in (0.0, 1.5):
            want = jcore.Polygon(s, h).buffer(d)
            got = tcore.Polygon(s, h).buffer(d)
            poly = tcore.Polygon(s, h)
            lo = np.array(poly.bounds[:2]) - d - 1
            hi = np.array(poly.bounds[2:]) + d + 1
            pts = rng.uniform(lo, hi, (20000, 2))
            truth = _within(pts, poly, d)
            probes = _hole_points(got, want)
            if _buffer_ok(want, poly, d, pts, truth, probes):
                assert geom_key(got) == geom_key(want), (i, d)
            elif geom_key(got) == geom_key(want):
                kept += 1
            else:
                wrong_ref += 1
                assert _buffer_ok(got, poly, d, pts, truth, probes), (i, d)
    # measured on these 120 buffers: the reference wrong in 37 (both
    # buffers of the three polygons whose hole leaves the shell, the rest
    # by the T-junction fault), the port in none
    assert wrong_ref >= 37 and kept == 0, (wrong_ref, kept)


def test_union_many_equals_the_reference_where_it_is_right():
    rng = np.random.default_rng(41)
    pairs = random_pairs()
    for k in range(0, 200, 20):
        polys = [p for pair in pairs[k:k + 20] for p in pair]
        want = jcore.union_all([jcore.Polygon(s, h) for s, h in polys])
        got = tcore.union_all([tcore.Polygon(s, h) for s, h in polys])
        flat = [[s, *h] for s, h in polys]
        xy = np.concatenate([r for p in flat for r in p])
        pts = rng.uniform(xy.min(0) - 1, xy.max(0) + 1, (20000, 2))
        truth = np.zeros(len(pts), bool)
        for p in flat:
            truth |= tn.points_in_polyset(pts, tn.pack([p]))
        assert _miss(got, truth, pts) == 0, k
        if _miss(want, truth, pts) == 0:
            assert geom_key(got) == geom_key(want), k
            assert [[r.tobytes() for r in p] for p in tn.union_many(
                tn.pack(flat))] == [[r.tobytes() for r in p]
                                    for p in jn.union_many(jn.pack(flat))]


def test_predicates_equal_the_reference():
    rng = np.random.default_rng(30)
    hits = 0
    for i, ((s1, h1), (s2, h2)) in enumerate(random_pairs()):
        a, b = [[s1, *h1]], [[s2, *h2]]
        got = tn.polyset_intersects(tn.pack(a), tn.pack(b))
        assert got == jn.polyset_intersects(jn.pack(a), jn.pack(b)), i
        hits += got
        lo, hi = np.minimum(s1.min(0), s2.min(0)), np.maximum(s1.max(0),
                                                              s2.max(0))
        pts = rng.uniform(lo - 2, hi + 2, (50, 2))
        flat = a + b
        np.testing.assert_array_equal(
            tn.points_in_polyset(pts, tn.pack(flat)),
            jn.points_in_polyset(pts, jn.pack(flat)))
    assert 0 < hits < len(random_pairs())


def _frames(pairs, which):
    core, table = (jcore, jtable) if which == "ref" else (tcore, ttable)
    left = table.GeoDataFrame(
        {"OBJECTID": np.arange(len(pairs)),
         "geometry": [core.Polygon(*a) for a, _ in pairs]}, crs=2056)
    right = table.GeoDataFrame(
        {"OBJECTID": np.arange(100, 100 + len(pairs)),
         "tag": [f"t{i}" for i in range(len(pairs))],
         "geometry": [core.Polygon(*b) for _, b in pairs]}, crs=2056)
    return table, left, right


@pytest.mark.parametrize("how", ["inner", "left"])
def test_sjoin_equals_the_reference(how):
    pairs = random_pairs()[:80]
    jt, jl, jr = _frames(pairs, "ref")
    tt, tl, tr = _frames(pairs, "port")
    for predicate in ("intersects", "within", "contains"):
        want = jt.sjoin(jl, jr, how=how, predicate=predicate,
                        lsuffix="1", rsuffix="2")
        got = tt.sjoin(tl, tr, how=how, predicate=predicate,
                       lsuffix="1", rsuffix="2")
        assert_tables_equal(got, want)


@pytest.mark.parametrize("how", ["difference", "intersection"])
def test_overlay_equals_the_reference(how):
    pairs = random_pairs()[:80]
    jt, jl, jr = _frames(pairs, "ref")
    tt, tl, tr = _frames(pairs, "port")
    want = jt.overlay(jl, jr[["tag", "geometry"]], how=how)
    got = tt.overlay(tl, tr[["tag", "geometry"]], how=how)
    assert_tables_equal(got, want)
    if how == "difference":
        # a row the clip removes whole is dropped, as geopandas drops it
        covered = tt.GeoDataFrame(
            {"OBJECTID": [1, 2], "geometry": [
                tcore.Polygon([[0, 0], [1, 0], [1, 1], [0, 1]]),
                tcore.Polygon([[5, 5], [6, 5], [6, 6], [5, 6]])]}, crs=2056)
        clip = tt.GeoDataFrame({"geometry": [tcore.Polygon(
            [[-1, -1], [2, -1], [2, 2], [-1, 2]])]}, crs=2056)
        assert list(tt.overlay(covered, clip, how="difference")
                    ["OBJECTID"]) == [2]


def test_crs_equals_the_reference():
    from roadsurf_tpu.crs import CRS as JCRS, crs_equal as jequal
    from roadsurf_tpu_torch.crs import CRS, crs_equal
    for a in (2056, "EPSG:3857", "epsg:4326", CRS(2056)):
        assert str(CRS(a)) == str(JCRS(a if not isinstance(a, CRS)
                                       else a.epsg))
        assert CRS(a).to_epsg() == JCRS(a if not isinstance(a, CRS)
                                        else a.epsg).to_epsg()
    for a, b in ((2056, "EPSG:2056"), (3857, 4326), ("x", "x"), (None, 2056),
                 ("EPSG:21781", "EPSG:21781")):
        assert crs_equal(a, b) == jequal(a, b), (a, b)
    assert CRS(4326).is_geographic and not CRS(3857).is_geographic
