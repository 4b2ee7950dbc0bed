"""tif2cog in the PyTorch port (``pipeline/cog_pipeline.py``, ``io/cog.py``,
``io/objstore.py``, EPSG:2056 in ``crs/transform.py``, ``utils/
profiling.py``) against the JAX package's, on the CPU, on the same inputs:

* ``transform_xy`` 2056 <-> 3857 and 2056 <-> 4326: within 1e-9 m (the
  same float64 operations);
* ``reproject_nearest``: equal (the host's inverse map in row chunks gives
  the reference's indices; the gather moves bytes);
* ``band_stats``: min and max equal, mean and stddev rtol 1e-6 (float32
  sums in another order);
* ``summarize_stats``, ``scale_to_byte``: equal;
* ``write_cog``: equal bytes;
* ``Tif2Cog.run`` over two ``LocalStore``s: the same keys and equal
  bytes, on images whose statistics no summation order changes; on random
  images, the reprojected GeoTIFFs equal, ``stats.json`` within
  ``band_stats``'s tolerance, and the COGs equal from the same
  ``stats.json``.
"""

import json
import os

import numpy as np
import pytest
import torch

from roadsurf_tpu.crs import transform as jcrs
from roadsurf_tpu.io.cog import write_cog as j_write_cog
from roadsurf_tpu.io.geotiff import write_geotiff as j_write_geotiff
from roadsurf_tpu.io.objstore import LocalStore as JLocalStore
from roadsurf_tpu.pipeline import cog_pipeline as jcog
from roadsurf_tpu_torch.crs import transform as tcrs
from roadsurf_tpu_torch.io.cog import average_downsample, write_cog
from roadsurf_tpu_torch.io.geotiff import Raster, read_geotiff
from roadsurf_tpu_torch.io.objstore import LocalStore, S3Store, make_store
from roadsurf_tpu_torch.pipeline import cog_pipeline as tcog
from roadsurf_tpu_torch.utils.profiling import StageTimer, trace

torch.set_num_threads(1)

X0, Y0 = 2600000.0, 1200000.0          # LV95 origin of the test images


def _swissimage(rng, h: int, w: int, px: float = 0.1,
                constant: bool = False) -> Raster:
    """A 4-band uint16 EPSG:2056 image with a nodata (0) border of 3 rows
    and 5 columns; random values, or one value a band."""
    if constant:
        data = np.broadcast_to(rng.integers(1, 4000, 4).astype(np.uint16),
                               (h, w, 4)).copy()
    else:
        data = rng.integers(1, 65535, (h, w, 4)).astype(np.uint16)
    data[:3] = 0
    data[:, -5:] = 0
    x0 = X0 + rng.uniform(-5e4, 5e4)
    y0 = Y0 + rng.uniform(-3e4, 3e4)
    return Raster(data=data, origin=(x0, y0), pixel_size=(px, px),
                  epsg=2056, nodata=0)


@pytest.mark.parametrize("dst", [3857, 4326])
def test_lv95_transforms_equal_the_reference(dst):
    rng = np.random.default_rng(0)
    x = rng.uniform(2.48e6, 2.84e6, 4000)
    y = rng.uniform(1.07e6, 1.30e6, 4000)
    got = tcrs.transform_xy(2056, dst, x, y)
    want = jcrs.transform_xy(2056, dst, x, y)
    # 1e-9 m; in degrees ~1e-14 (a degree is ~1.1e5 m)
    atol = 1e-9 if dst == 3857 else 1e-14
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    back = tcrs.transform_xy(dst, 2056, *want)
    for a, b in zip(back, jcrs.transform_xy(dst, 2056, *want)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    # and the round trip lands within a millimetre of the start
    np.testing.assert_allclose(back[0], x, atol=1e-3)
    np.testing.assert_allclose(back[1], y, atol=1e-3)


@pytest.mark.parametrize("chunk_rows", [37, tcog.CHUNK_ROWS])
def test_reproject_nearest_equals_the_reference(chunk_rows):
    r = _swissimage(np.random.default_rng(1), 180, 210)
    want = jcog.reproject_nearest(r, 3857)
    stats = {}
    got = tcog.reproject_nearest(r, 3857, device="cpu",
                                 chunk_rows=chunk_rows, stats=stats)
    np.testing.assert_array_equal(got.data, want.data)
    assert got.data.dtype == np.uint16
    assert (got.origin, got.pixel_size, got.epsg, got.nodata) == \
        (want.origin, want.pixel_size, want.epsg, want.nodata)
    # the rotated footprint leaves nodata corners, and most pixels valid
    assert 0.5 < (got.data[:, :, 0] > 0).mean() < 1.0
    assert set(stats) == {"inverse_map_s", "gather_s"}


@pytest.mark.parametrize("nodata", [0.0, None])
def test_band_stats_match_the_reference(nodata):
    data = _swissimage(np.random.default_rng(2), 150, 130).data
    got = tcog.band_stats(data, nodata=nodata, device="cpu")
    want = jcog.band_stats(data, nodata=nodata)
    assert list(got) == list(want) == ["1", "2", "3", "4"]
    for band in want:
        assert got[band]["min"] == want[band]["min"]
        assert got[band]["max"] == want[band]["max"]
        for k in ("mean", "stddev"):
            np.testing.assert_allclose(got[band][k], want[band][k],
                                       rtol=1e-6)
    if nodata == 0.0:
        assert got["1"]["min"] > 0


def test_summarize_stats_equals_the_reference():
    rng = np.random.default_rng(3)
    stats = {f"im{i}.tif": {str(b): {"min": 0.0, "max": 1.0,
                                     "mean": float(rng.uniform(0, 6e4)),
                                     "stddev": float(rng.uniform(0, 2e4))}
                            for b in range(1, 5)} for i in range(5)}
    assert tcog.summarize_stats(stats, 2, 3, 4, 1) == \
        jcog.summarize_stats(stats, 2, 3, 4, 1)


def test_scale_to_byte_equals_the_reference():
    """Every uint16 value in each of four bands, under random bounds, a
    clamped bound and a degenerate one (hi = lo)."""
    data = np.stack([np.arange(65536, dtype=np.uint16)] * 4, -1) \
        .reshape(256, 256, 4)
    rng = np.random.default_rng(4)
    for _ in range(6):
        lo = rng.uniform(0, 3e4, 4)
        hi = lo + rng.uniform(1, 4e4, 4)
        lo[1], hi[1] = 0.0, 65535.0
        lo[3] = hi[3] = 7.0
        bounds = list(zip(lo.tolist(), hi.tolist()))
        got = tcog.scale_to_byte(data, bounds, device="cpu")
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, jcog.scale_to_byte(data, bounds))


@pytest.mark.parametrize("dtype,shape", [(np.uint8, (300, 520, 3)),
                                         (np.uint16, (257, 600, 4)),
                                         (np.uint8, (40, 30, 1))])
def test_write_cog_bytes_equal_the_reference(tmp_path, dtype, shape):
    rng = np.random.default_rng(5)
    data = rng.integers(0, np.iinfo(dtype).max, shape).astype(dtype)
    bounds = (950000.0, 6000000.0, 950000.0 + shape[1] * 0.3,
              6000000.0 + shape[0] * 0.3)
    write_cog(str(tmp_path / "t.tif"), data, bounds, epsg=3857, nodata=0)
    j_write_cog(str(tmp_path / "j.tif"), data, bounds, epsg=3857, nodata=0)
    assert (tmp_path / "t.tif").read_bytes() == \
        (tmp_path / "j.tif").read_bytes()
    r = read_geotiff(str(tmp_path / "t.tif"))
    np.testing.assert_array_equal(r.data, data)
    assert r.epsg == 3857 and r.nodata == 0
    np.testing.assert_array_equal(average_downsample(data, 4).shape,
                                  ((shape[0] + 3) // 4, (shape[1] + 3) // 4,
                                   shape[2]))


def _stores(tmp_path, images):
    """The same source images in a reference and a port LocalStore."""
    roots = {}
    for name in ("ref", "port"):
        roots[name] = tmp_path / name
        for i, r in enumerate(images):
            p = roots[name] / "in" / f"img{i}.tif"
            os.makedirs(p.parent, exist_ok=True)
            j_write_geotiff(str(p), r.data, r.bounds, epsg=2056, nodata=0)
    return roots


def _run_both(tmp_path, roots, seed_stats: bool = False):
    kw = dict(prefix_in="in", prefix_tif="tif", prefix_cog="cog")
    out = {"ref": jcog.Tif2Cog(JLocalStore(str(roots["ref"])),
                               workdir=str(tmp_path / "wr"), **kw).run()}
    port = tcog.Tif2Cog(LocalStore(str(roots["port"])),
                        workdir=str(tmp_path / "wp"), device="cpu", **kw)
    if seed_stats:
        # step 1 alone, then the reference's stats.json in the port's
        # store, which step 2 reuses (skip-if-exists)
        port.run(do_step2=False, do_step3=False)
        os.makedirs(roots["port"] / "tif", exist_ok=True)
        (roots["port"] / "tif" / "stats.json").write_bytes(
            (roots["ref"] / "tif" / "stats.json").read_bytes())
    out["port"] = port.run()
    return out, port


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root):
            open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs}


def test_tif2cog_run_equals_the_reference(tmp_path):
    """Images of one value a band: every statistic is exact in float32 in
    any summation order, so the two runs write the same objects, byte for
    byte; then a rerun skips every image."""
    rng = np.random.default_rng(6)
    images = [_swissimage(rng, 90, 70, constant=True) for _ in range(3)]
    roots = _stores(tmp_path, images)
    out, port = _run_both(tmp_path, roots)
    ref, got = _files(roots["ref"]), _files(roots["port"])
    assert sorted(got) == sorted(ref) == sorted(
        [f"in/img{i}.tif" for i in range(3)]
        + [f"tif/img{i}.tif" for i in range(3)] + ["tif/stats.json"]
        + [f"cog/img{i}.tif" for i in range(3)])
    for k in ref:
        assert got[k] == ref[k], k
    assert out["port"]["summary"] == out["ref"]["summary"]
    assert out["port"]["done"] == {"step1": 3, "step2": 3, "step3": 3}
    again = port.run()
    assert again["done"] == {"step1": 0, "step2": 0, "step3": 0}
    assert _files(roots["port"]) == got
    cog = read_geotiff(str(roots["port"] / "cog" / "img0.tif"))
    assert cog.epsg == 3857 and cog.data.dtype == np.uint8


def test_tif2cog_run_on_random_images(tmp_path):
    rng = np.random.default_rng(7)
    images = [_swissimage(rng, 80, 100) for _ in range(3)]
    roots = _stores(tmp_path, images)
    _run_both(tmp_path, roots, seed_stats=True)
    ref, got = _files(roots["ref"]), _files(roots["port"])
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k] == ref[k], k
    # the port's own statistics of the same reprojected images
    for i in range(3):
        r = read_geotiff(str(roots["port"] / "tif" / f"img{i}.tif"))
        want = json.loads(ref["tif/stats.json"])[f"img{i}.tif"]
        mine = tcog.band_stats(r.data, device="cpu")
        for band, s in want.items():
            assert (mine[band]["min"], mine[band]["max"]) == \
                (s["min"], s["max"])
            np.testing.assert_allclose(
                [mine[band]["mean"], mine[band]["stddev"]],
                [s["mean"], s["stddev"]], rtol=1e-6)


def test_entry_point_and_stores(tmp_path):
    """``python -m roadsurf_tpu_torch.pipeline.cog_pipeline <config>
    --device cpu`` over a LOCAL_STORE_ROOT; ``make_store``; S3 without
    boto3 raises."""
    root = tmp_path / "store"
    r = _swissimage(np.random.default_rng(8), 60, 50, constant=True)
    os.makedirs(root / "raw")
    j_write_geotiff(str(root / "raw" / "a.tif"), r.data, r.bounds,
                    epsg=2056, nodata=0)
    config = tmp_path / "config.yaml"
    config.write_text(
        "tif2cog.py:\n"
        "  S3_PREFIX_IN: raw\n  S3_PREFIX_TIF: tif\n  S3_PREFIX_COG: cog\n"
        f"  WORKDIR: {tmp_path / 'work'}\n"
        f"  LOCAL_STORE_ROOT: {root}\n")
    assert tcog.main([str(config), "--device", "cpu"]) == 0
    assert (root / "cog" / "a.tif").exists()
    assert isinstance(make_store({"type": "local", "root": str(root)}),
                      LocalStore)
    with pytest.raises(ValueError, match="unknown store"):
        make_store({"type": "ftp"})
    try:
        import boto3  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="boto3"):
            S3Store("bucket")


def test_profiling_trace_and_stage_timer(tmp_path):
    with trace(None):
        pass
    assert not os.listdir(tmp_path)
    with trace(str(tmp_path / "t")):
        torch.ones(8).sum()
    with open(tmp_path / "t" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    t = StageTimer()
    with t.stage("fetch", items=64):
        pass
    with t.stage("fetch", items=64):
        pass
    rep = t.report()
    assert rep["fetch"]["calls"] == 2 and rep["fetch"]["items_per_sec"] > 0
