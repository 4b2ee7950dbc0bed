"""tif2cog: 16-bit SWISSIMAGE-RS TIFFs -> 8-bit Cloud-Optimized GeoTIFFs.

    python -m roadsurf_tpu_torch.pipeline.cog_pipeline \\
        config/config_preprocessing.yaml [--device cuda]

Port of the reference package's ``pipeline/cog_pipeline.py`` (its
``scripts/tif2cog.py``, the ``tif2cog.py`` YAML block): three idempotent
steps against an object store, each skipped for an image whose output
object exists.

* STEP 1: reproject EPSG:2056 -> EPSG:3857 (nearest, nodata 0) and write
  a tiled GeoTIFF with AVERAGE overviews [2..256] (``io/cog.py``).
* STEP 2: per-band min/max/mean/std over the valid pixels, cached in the
  store as ``stats.json``.
* STEP 3: global scaling bounds (per-band mean ± 2σ envelopes aggregated
  ± σ across the images, clamped to [0, 65535]), then the uint16 -> uint8
  per-band scaling NIR/R/G/B -> [0, 255] and the tiled COG.

The per-pixel stages, XLA-compiled ``jnp`` in the reference (no Pallas
kernel), run as torch ops on ``device``: the gather of
:func:`reproject_nearest`, the masked reductions of :func:`band_stats`
and the elementwise pass of :func:`scale_to_byte`. The inverse map, from
destination pixel centres to source indices, stays float64 numpy on the
host as in the reference, computed ``chunk_rows`` destination rows at a
time to bound the host's temporaries (every value is elementwise, so the
chunks give the reference's indices).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

from ..crs.transform import transform_xy
from ..io.cog import DEFAULT_OVERVIEWS, write_cog
from ..io.geotiff import Raster, read_geotiff
from ..io.objstore import ObjectStore
from ..utils.config import load_script_config
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

CHUNK_ROWS = 1024


# ---------------------------------------------------------------------------
# device stages

def _upload(data: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``; uint16 travels as its int16 view (the
    same bytes), which every indexing op takes."""
    t = torch.from_numpy(np.ascontiguousarray(data))
    if t.dtype == torch.uint16:
        t = t.view(torch.int16)
    return t.to(device)


def _float32(t: torch.Tensor, dtype: np.dtype) -> torch.Tensor:
    """The values of an uploaded array (:func:`_upload`) in float32."""
    if dtype == np.uint16:
        return (t.to(torch.int32) & 0xFFFF).to(torch.float32)
    return t.to(torch.float32)


def dst_grid(raster: Raster, dst_epsg: int = 3857) -> tuple:
    """The destination grid of :func:`reproject_nearest`: the projected
    source corners' bounds at the source's pixel count a side ->
    (west, north, pixel width, pixel height, width, height)."""
    h, w, _ = raster.data.shape
    x0, y0 = raster.origin
    sx, sy = raster.pixel_size
    cx = np.array([x0, x0 + sx * w, x0, x0 + sx * w])
    cy = np.array([y0, y0, y0 - sy * h, y0 - sy * h])
    dx_, dy_ = transform_xy(raster.epsg, dst_epsg, cx, cy)
    west, east = float(dx_.min()), float(dx_.max())
    south, north = float(dy_.min()), float(dy_.max())
    return west, north, (east - west) / w, (north - south) / h, w, h


def inverse_map(raster: Raster, grid: tuple, dst_epsg: int, r0: int,
                r1: int) -> tuple:
    """Host, float64: the source pixel of each destination pixel centre of
    rows [r0, r1) -> (flat source index row·w + col, clipped into the
    image; valid), each ((r1 − r0)·width,)."""
    h, w, _ = raster.data.shape
    x0, y0 = raster.origin
    sx, sy = raster.pixel_size
    west, north, osx, osy, ow, _ = grid
    gx = west + (np.arange(ow) + 0.5) * osx
    gy = north - (np.arange(r0, r1) + 0.5) * osy
    gxx, gyy = np.meshgrid(gx, gy)
    sxx, syy = transform_xy(dst_epsg, raster.epsg, gxx.ravel(), gyy.ravel())
    col = np.floor((sxx - x0) / sx).astype(np.int32)
    row = np.floor((y0 - syy) / sy).astype(np.int32)
    valid = (col >= 0) & (col < w) & (row >= 0) & (row < h)
    col_c = np.clip(col, 0, w - 1)
    row_c = np.clip(row, 0, h - 1)
    return row_c.astype(np.int64) * w + col_c, valid


def gather(src: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
           fill: torch.Tensor) -> torch.Tensor:
    """Device: rows ``idx`` of ``src`` (N, C), ``fill`` where not
    ``valid``."""
    return torch.where(valid[:, None], src.index_select(0, idx), fill)


def reproject_nearest(raster: Raster, dst_epsg: int = 3857,
                      nodata: float = 0.0, device="cuda",
                      chunk_rows: int = CHUNK_ROWS,
                      stats: dict | None = None) -> Raster:
    """Nearest-neighbour reprojection by an inverse-mapped gather: the
    destination grid (:func:`dst_grid`) inverse-projected to source pixel
    indices on the host (:func:`inverse_map`), ``chunk_rows`` rows at a
    time, and gathered on ``device``. ``stats``, if given, gains
    ``inverse_map_s`` (host) and ``gather_s`` (the rest of the call:
    uploads, gathers, the result's download)."""
    dev = resolve_device(device)
    t_call = time.perf_counter()
    h, w, c = raster.data.shape
    grid = dst_grid(raster, dst_epsg)
    west, north, osx, osy, ow, oh = grid
    src = _upload(raster.data, dev).reshape(h * w, c)
    fill = _upload(np.asarray(nodata, raster.data.dtype).reshape(1),
                   dev).reshape(())
    out = torch.empty((oh * ow, c), dtype=src.dtype, device=dev)
    t_map = 0.0
    for r0 in range(0, oh, chunk_rows):
        r1 = min(r0 + chunk_rows, oh)
        t0 = time.perf_counter()
        idx, valid = inverse_map(raster, grid, dst_epsg, r0, r1)
        t_map += time.perf_counter() - t0
        out[r0 * ow:r1 * ow] = gather(src, torch.from_numpy(idx).to(dev),
                                      torch.from_numpy(valid).to(dev), fill)
    data = out.cpu().numpy().view(raster.data.dtype).reshape(oh, ow, c)
    if stats is not None:
        stats["inverse_map_s"] = stats.get("inverse_map_s", 0.0) + t_map
        stats["gather_s"] = stats.get("gather_s", 0.0) \
            + time.perf_counter() - t_call - t_map
    return Raster(data=data, origin=(west, north), pixel_size=(osx, osy),
                  epsg=dst_epsg, nodata=nodata)


def band_stats(data: np.ndarray, nodata: float | None = 0.0,
               device="cuda") -> dict:
    """Per-band min/max/mean/std over the valid pixels (GDAL
    GetStatistics), float32 reductions on ``device`` in the reference's
    order. Band keys are 1-based strings."""
    dev = resolve_device(device)
    c = data.shape[2]
    x = _float32(_upload(data.reshape(-1, c), dev), data.dtype)
    if nodata is not None:
        ok = x != nodata
    else:
        ok = torch.ones_like(x, dtype=torch.bool)
    n = ok.sum(dim=0).clamp(min=1).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    mean = torch.where(ok, x, zero).sum(dim=0) / n
    var = torch.where(ok, (x - mean) ** 2, zero).sum(dim=0) / n
    inf = torch.tensor(float("inf"), device=dev)
    mn = torch.where(ok, x, inf).amin(dim=0)
    mx = torch.where(ok, x, -inf).amax(dim=0)
    mn = torch.where(torch.isfinite(mn), mn, zero)
    mx = torch.where(torch.isfinite(mx), mx, zero)
    std = torch.sqrt(var)
    mn, mx, mean, std = (t.cpu().numpy() for t in (mn, mx, mean, std))
    return {str(i + 1): {"min": float(mn[i]), "max": float(mx[i]),
                         "mean": float(mean[i]), "stddev": float(std[i])}
            for i in range(c)}


def summarize_stats(stats: dict, r_idx: int, g_idx: int, b_idx: int,
                    nir_idx: int, fact: float = 2.0) -> dict:
    """Global scaling bounds across all images: per-band mean±2σ envelopes
    aggregated ±σ, clamped to [0, 65535] (host, float64)."""
    def bounds(band_ids):
        mins, maxs = [], []
        for img_stats in stats.values():
            for b in band_ids:
                s = img_stats[str(b)]
                mins.append(s["mean"] - fact * s["stddev"])
                maxs.append(s["mean"] + fact * s["stddev"])
        lo = max(float(np.mean(mins) - np.std(mins)), 0.0)
        hi = min(float(np.mean(maxs) + np.std(maxs)), 65535.0)
        return lo, hi

    rgb_min, rgb_max = bounds([r_idx, g_idx, b_idx])
    nir_min, nir_max = bounds([nir_idx])
    return {"rgb_min": rgb_min, "rgb_max": rgb_max,
            "nir_min": nir_min, "nir_max": nir_max}


def scale_to_byte(data: np.ndarray, band_bounds: list,
                  device="cuda") -> np.ndarray:
    """uint16 -> uint8 per-band linear scaling on ``device``:
    ``(x − lo) / max(hi − lo, 1e-9) · 255`` in float32, rounded half to
    even and clipped to [0, 255]. ``band_bounds[i]`` = (lo, hi) of band
    i.

    The reference's source divides, but its bounds are constants of the
    jitted function, and XLA's simplifier turns a division by a constant
    into a product with its float32 reciprocal; so the division here is
    that product, ``(x − lo) · (1 / max(hi − lo, 1e-9)) · 255``, each
    operation rounded in this order, and the bytes are the reference's
    (a true division rounds a few pixels in 10⁶ the other way)."""
    dev = resolve_device(device)
    lo = torch.tensor([b[0] for b in band_bounds], dtype=torch.float32,
                      device=dev)
    hi = torch.tensor([b[1] for b in band_bounds], dtype=torch.float32,
                      device=dev)
    inv = 1.0 / torch.clamp(hi - lo, min=1e-9)
    x = _float32(_upload(data, dev), data.dtype)
    y = (x - lo) * inv * 255.0
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8).cpu().numpy()


# ---------------------------------------------------------------------------
# pipeline

class Tif2Cog:
    """The three object-store-resident steps (the reference's ``Tif2Cog``),
    their device stages on ``device``."""

    def __init__(self, store: ObjectStore, prefix_in: str, prefix_tif: str,
                 prefix_cog: str, workdir: str = "./workdir",
                 nir_band: int = 1, r_band: int = 2, g_band: int = 3,
                 b_band: int = 4, device="cuda"):
        self.device = resolve_device(device)
        self.store = store
        self.prefix_in = prefix_in.strip("/")
        self.prefix_tif = prefix_tif.strip("/")
        self.prefix_cog = prefix_cog.strip("/")
        os.makedirs(workdir, exist_ok=True)
        self.workdir = workdir
        self.nir, self.r, self.g, self.b = nir_band, r_band, g_band, b_band

    def get_workload(self) -> list[str]:
        keys = [k for k in self.store.list(self.prefix_in)
                if k.lower().endswith(".tif")]
        logger.info(f"{len(keys)} source images found under "
                    f"{self.prefix_in}/")
        return keys

    # ---- step 1 ----------------------------------------------------------
    def reproject_and_gen_overviews(self, key: str) -> bool:
        basename = os.path.basename(key)
        dst_key = f"{self.prefix_tif}/{basename}"
        if self.store.exists(dst_key):
            logger.info(f"{dst_key} exists => skipping")
            return False
        tmp_in = os.path.join(self.workdir, "in_" + basename)
        tmp_out = os.path.join(self.workdir, basename)
        self.store.download(key, tmp_in)
        src = read_geotiff(tmp_in)
        warped = reproject_nearest(src, 3857, nodata=0.0, device=self.device)
        write_cog(tmp_out, warped.data, warped.bounds, epsg=3857,
                  overview_levels=DEFAULT_OVERVIEWS, nodata=0)
        self.store.upload(tmp_out, dst_key)
        os.remove(tmp_in)
        os.remove(tmp_out)
        return True

    # ---- step 2 ----------------------------------------------------------
    def compute_stats(self, key: str) -> dict:
        basename = os.path.basename(key)
        tmp = os.path.join(self.workdir, "st_" + basename)
        self.store.download(f"{self.prefix_tif}/{basename}", tmp)
        r = read_geotiff(tmp)
        stats = band_stats(r.data, nodata=r.nodata if r.nodata is not None
                           else 0.0, device=self.device)
        os.remove(tmp)
        return stats

    # ---- step 3 ----------------------------------------------------------
    def generate_cogs(self, key: str, summary: dict) -> bool:
        basename = os.path.basename(key)
        dst_key = f"{self.prefix_cog}/{basename}"
        if self.store.exists(dst_key):
            logger.info(f"{dst_key} exists => skipping")
            return False
        tmp_in = os.path.join(self.workdir, "cg_" + basename)
        tmp_out = os.path.join(self.workdir, "cog_" + basename)
        self.store.download(f"{self.prefix_tif}/{basename}", tmp_in)
        r = read_geotiff(tmp_in)
        bounds_by_band = []
        for b in range(1, r.data.shape[2] + 1):
            if b == self.nir:
                bounds_by_band.append((summary["nir_min"],
                                       summary["nir_max"]))
            else:
                bounds_by_band.append((summary["rgb_min"],
                                       summary["rgb_max"]))
        byte = scale_to_byte(r.data, bounds_by_band, device=self.device)
        write_cog(tmp_out, byte, r.bounds, epsg=r.epsg, nodata=0)
        self.store.upload(tmp_out, dst_key)
        os.remove(tmp_in)
        os.remove(tmp_out)
        return True

    # ---- all steps -------------------------------------------------------
    def run(self, do_step1=True, do_step2=True, do_step3=True) -> dict:
        """The steps asked for; returns the workload, the scaling summary,
        and each step's ``seconds`` and count of images it processed."""
        workload = self.get_workload()
        seconds, done = {}, {}
        if do_step1:
            t0 = time.time()
            done["step1"] = sum(self.reproject_and_gen_overviews(k)
                                for k in workload)
            seconds["step1"] = dt = max(time.time() - t0, 1e-9)
            logger.info(f"STEP1: {done['step1']} reprojected "
                        f"({len(workload) / dt:.2f} images/s)")

        stats_key = f"{self.prefix_tif}/stats.json"
        stats_path = os.path.join(self.workdir, "stats.json")
        if do_step2:
            if self.store.exists(stats_key):
                logger.info("stats.json exists => reusing")
                self.store.download(stats_key, stats_path)
                with open(stats_path) as f:
                    stats = json.load(f)
                done["step2"] = 0
            else:
                stats = {}
                t0 = time.time()
                for k in workload:
                    stats[os.path.basename(k)] = self.compute_stats(k)
                seconds["step2"] = dt = max(time.time() - t0, 1e-9)
                done["step2"] = len(workload)
                logger.info(f"STEP2: stats over {len(workload)} images "
                            f"({len(workload) / dt:.2f} images/s)")
                with open(stats_path, "w") as f:
                    json.dump(stats, f, indent=1)
                self.store.upload(stats_path, stats_key)
        else:
            stats = {}

        summary = {}
        if do_step3:
            if not stats:
                self.store.download(stats_key, stats_path)
                with open(stats_path) as f:
                    stats = json.load(f)
            summary = summarize_stats(stats, self.r, self.g, self.b,
                                      self.nir)
            logger.info(f"scaling summary: {summary}")
            t0 = time.time()
            done["step3"] = sum(self.generate_cogs(k, summary)
                                for k in workload)
            seconds["step3"] = dt = max(time.time() - t0, 1e-9)
            logger.info(f"STEP3: {done['step3']} COGs written "
                        f"({len(workload) / dt:.2f} images/s)")
        return {"workload": workload, "summary": summary,
                "seconds": seconds, "done": done}


def run(cfg: dict, store: ObjectStore | None = None,
        device="cuda") -> dict:
    """Execute the ``tif2cog.py`` YAML block (S3_PREFIX_IN/TIF/COG,
    WORKDIR, the band numbers, DO_STEP1..3). ``store`` defaults to a
    ``LocalStore`` when the block sets ``LOCAL_STORE_ROOT``, else an S3
    store of ``BUCKET`` (and ``ENDPOINT_URL``)."""
    device = resolve_device(device)
    if store is None:
        from ..io.objstore import LocalStore, S3Store
        if cfg.get("LOCAL_STORE_ROOT"):
            store = LocalStore(cfg["LOCAL_STORE_ROOT"])
        else:
            store = S3Store(cfg["BUCKET"], cfg.get("ENDPOINT_URL"))
    pipe = Tif2Cog(store,
                   cfg["S3_PREFIX_IN"], cfg["S3_PREFIX_TIF"],
                   cfg["S3_PREFIX_COG"], cfg.get("WORKDIR", "./workdir"),
                   nir_band=cfg.get("NIR_BAND_NO", 1),
                   r_band=cfg.get("R_BAND_NO", 2),
                   g_band=cfg.get("G_BAND_NO", 3),
                   b_band=cfg.get("B_BAND_NO", 4), device=device)
    return pipe.run(cfg.get("DO_STEP1", True), cfg.get("DO_STEP2", True),
                    cfg.get("DO_STEP3", True))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Reprojects 16-bit imagery to EPSG:3857 and converts "
                    "it to 8-bit Cloud-Optimized GeoTIFFs.")
    parser.add_argument("config_file", type=str, help="a YAML config file")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the per-pixel stages; 'cpu' "
                             "runs them on the host")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S")
    tic = time.perf_counter()
    logger.info(f"Using {args.config_file} as config file.")
    cfg = load_script_config(args.config_file, "tif2cog.py")
    run(cfg, device=args.device)
    logger.info(f"Done. Elapsed time: {time.perf_counter() - tic:.2f} "
                f"seconds")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
