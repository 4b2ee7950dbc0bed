"""The geometry and IO copies of the detection host stage against the JAX
package's own, on the CPU: the C++ tracer, the plain tracer, RDP,
``mask_to_polygons``, ``paste_masks``, WKB, WebMercator and GeoTIFF.

Tolerance: none. Every function here is the reference's arithmetic
operation for operation, so each output is asserted equal, bit for bit
and in order, except the plain tracer, which starts its rings at other
vertices and lists them in another order: it is held equal in the
reference test's canonical form (tests/test_detections.py)."""

import numpy as np
import pytest
import torch

from roadsurf_tpu.crs import transform as jcrs
from roadsurf_tpu.geom import Polygon as JPolygon
from roadsurf_tpu.geom import core as jcore
from roadsurf_tpu.geom import vectorize as jvec
from roadsurf_tpu.io import geotiff as jtif
from roadsurf_tpu.io import wkb as jwkb
from roadsurf_tpu.pipeline.detections import paste_masks as j_paste
from roadsurf_tpu_torch.crs import transform as tcrs
from roadsurf_tpu_torch.geom import Polygon, core as tcore
from roadsurf_tpu_torch.geom import vectorize as tvec
from roadsurf_tpu_torch.geom.table import DetectionTable
from roadsurf_tpu_torch.io import geotiff as ttif
from roadsurf_tpu_torch.io import wkb as twkb
from roadsurf_tpu_torch.pipeline.detections import paste_masks

torch.set_num_threads(1)


def _masks(kind: str) -> list[np.ndarray]:
    if kind == "random":
        rng = np.random.default_rng(11)
        return [(rng.random((40, 56)) > 0.55).astype(np.uint8)
                for _ in range(15)]
    if kind == "zeros":
        return [np.zeros((8, 8), np.uint8)]
    if kind == "ones":
        return [np.ones((8, 8), np.uint8), np.ones((1, 1), np.uint8)]
    # checkerboard corners everywhere, a block with a hole, an island in it
    m = (np.indices((12, 14)).sum(0) % 2).astype(np.uint8)
    m[2:9, 3:11] = 1
    m[4:7, 5:9] = 0
    m[5, 6] = 1
    return [m, 1 - m]


def _equal_rings(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", ["random", "zeros", "ones", "checkerboard"])
def test_cpp_tracer_equals_the_reference_ring_for_ring(kind):
    """Same rings, same start vertices, same order."""
    for m in _masks(kind):
        _equal_rings(tvec._trace_rings(m), jvec._trace_rings(m))


def _canon(rings):
    out = []
    for r in rings:
        area = float(np.sum(r[:-1, 0] * r[1:, 1] - r[1:, 0] * r[:-1, 1]) / 2)
        out.append((round(area, 3), tuple(np.round(r.min(0), 3)),
                    tuple(np.round(r.max(0), 3)), len(r)))
    return sorted(out)


@pytest.mark.parametrize("kind", ["random", "checkerboard"])
def test_plain_tracer_equals_the_reference_in_canonical_form(kind):
    for m in _masks(kind):
        got = tvec._trace_rings_py(m)
        _equal_rings(got, jvec._trace_rings_py(m))
        assert _canon(got) == _canon(tvec._trace_rings(m))


@pytest.mark.parametrize("eps", [0.0, 0.75, 2.5])
def test_rdp_simplify_ring_equals_the_reference(eps):
    rng = np.random.default_rng(3)
    for n in (1, 2, 3, 7, 60):
        t = np.sort(rng.uniform(0, 2 * np.pi, n))
        ring = np.stack([np.cos(t), np.sin(t)], 1) * rng.uniform(1, 9, (n, 1))
        got = tcore.rdp_simplify_ring(ring, eps)
        np.testing.assert_array_equal(got, jcore.rdp_simplify_ring(ring, eps))
        np.testing.assert_array_equal(tcore.rdp_simplify(ring, eps),
                                      jcore.rdp_simplify(ring, eps))


def _tile_transform(west=950000.0, north=6000000.0, s=0.597):
    def to_world(ring):
        out = np.empty_like(ring)
        out[:, 0] = west + ring[:, 0] * s
        out[:, 1] = north - ring[:, 1] * s
        return out
    return to_world


def _equal_polygons(got, ref):
    assert len(got) == len(ref)
    for p, q in zip(got, ref):
        np.testing.assert_array_equal(p.exterior_coords, q.exterior_coords)
        _equal_rings(p.interiors_coords, q.interiors_coords)
        assert p.area == q.area and p.bounds == q.bounds
        assert p.is_empty == q.is_empty and p.geom_type == q.geom_type


@pytest.mark.parametrize("world,eps", [(False, 0.0), (True, 0.75)])
def test_mask_to_polygons_equals_the_reference(world, eps):
    tf = _tile_transform() if world else None
    for kind in ("random", "ones", "checkerboard"):
        for m in _masks(kind):
            _equal_polygons(tvec.mask_to_polygons(m, tf, eps),
                            jvec.mask_to_polygons(m, tf, eps))


def test_paste_masks_equals_the_reference():
    """Random probabilities (u8 and 0/1 bits) in random boxes, boxes past
    every edge of the tile, a degenerate box and one outside it."""
    rng = np.random.default_rng(5)
    D, size = 40, 64
    xy = rng.uniform(-20, 70, (D, 2))
    wh = rng.uniform(0.5, 50, (D, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    boxes[:4] = [[-10, -10, 80, 80], [60, 5, 70, 20], [10, 10, 10, 30],
                 [70, 70, 90, 90]]
    for probs in (rng.integers(0, 256, (D, 28, 28)).astype(np.float32)
                  / 255.0,
                  rng.integers(0, 2, (D, 28, 28)).astype(np.float32)):
        got = paste_masks(probs, boxes, size)
        assert got.dtype == np.uint8 and got.shape == (D, size, size)
        np.testing.assert_array_equal(got, j_paste(probs, boxes, size))
        # past every edge: clipped, not dropped; degenerate and outside:
        # nothing
        assert got[0].any() and not got[2:4].any()


def test_wkb_dumps_equals_the_reference():
    shell = np.array([[0, 0], [10.5, 0], [10.5, 7.25], [0, 7.25]])
    holes = [np.array([[1, 1], [1, 2], [2, 2], [2, 1]]) + k
             for k in (0.0, 3.0)]
    for h in ([], holes):
        assert twkb.dumps(Polygon(shell, h)) \
            == jwkb.dumps(JPolygon(shell, h))
    closed = np.vstack([shell, shell[:1]])   # a closed input ring
    assert twkb.dumps(Polygon(closed)) == jwkb.dumps(JPolygon(closed))
    np.testing.assert_array_equal(Polygon(shell).exterior, closed)


def test_webmercator_equals_the_reference():
    rng = np.random.default_rng(2)
    x = rng.uniform(-2.0e7, 2.0e7, 500)
    y = rng.uniform(-2.0e7, 2.0e7, 500)
    for a, b in zip(tcrs._webmerc_inv(x, y), jcrs._webmerc_inv(x, y)):
        np.testing.assert_array_equal(a, b)
    lon, lat = jcrs._webmerc_inv(x, y)
    for a, b in zip(tcrs._webmerc_fwd(lon, lat), jcrs._webmerc_fwd(lon, lat)):
        np.testing.assert_array_equal(a, b)
    for src, dst in ((3857, 4326), (4326, 3857), (3857, 3857)):
        u, v = (x, y) if src == 3857 else \
            (np.degrees(lon), np.degrees(lat))
        for a, b in zip(tcrs.transform_xy(src, dst, u, v),
                        jcrs.transform_xy(src, dst, u, v)):
            np.testing.assert_array_equal(a, b)
    # a code neither package transforms (CH1903/LV03); EPSG:2056 is
    # tests/test_torch_cog.py's
    with pytest.raises(ValueError, match="EPSG:21781"):
        tcrs.transform_xy(21781, 4326, x, y)


def test_table_to_crs_equals_the_reference_frame():
    """The detections table's reprojection and bounds against the
    reference's GeoDataFrame.to_crs."""
    from roadsurf_tpu.geom import GeoDataFrame

    rng = np.random.default_rng(9)
    polys = []
    for _ in range(5):
        c = rng.uniform(9.0e5, 1.0e6, 2)
        polys.append(c + rng.uniform(-50, 50, (6, 2)))
    t = DetectionTable([Polygon(p) for p in polys], rng.random(5),
                       np.arange(5) % 2, 3857).to_crs(4326)
    g = GeoDataFrame({"geometry": [JPolygon(p) for p in polys]},
                     crs="EPSG:3857").to_crs(epsg=4326)
    _equal_polygons(t.geometry, list(g["geometry"]))
    np.testing.assert_array_equal(t.total_bounds, g.total_bounds)
    assert t.epsg == 4326


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("dtype,compress", [(np.uint8, True),
                                            (np.uint16, False)])
def test_geotiff_round_trips_between_the_packages(tmp_path, writer, dtype,
                                                  compress):
    """A tile written by one package reads back in the other: pixels,
    origin, pixel size, EPSG code, nodata; the files are byte-equal."""
    rng = np.random.default_rng(4)
    data = rng.integers(0, 200, (32, 48, 3)).astype(dtype)
    bounds = (950000.0, 5999980.0, 950028.8, 6000000.0)
    paths = {k: str(tmp_path / f"{k}.tif") for k in ("reference", "port")}
    jtif.write_geotiff(paths["reference"], data, bounds, compress=compress,
                       nodata=0)
    ttif.write_geotiff(paths["port"], data, bounds, compress=compress,
                       nodata=0)
    assert open(paths["reference"], "rb").read() \
        == open(paths["port"], "rb").read()
    read = ttif.read_geotiff if writer == "reference" else jtif.read_geotiff
    r = read(paths[writer])
    ref = jtif.read_geotiff(paths["reference"])
    np.testing.assert_array_equal(r.data, data)
    assert (r.origin, r.pixel_size, r.epsg, r.nodata, r.bounds) \
        == (ref.origin, ref.pixel_size, ref.epsg, ref.nodata, ref.bounds)
