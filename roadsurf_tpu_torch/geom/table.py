"""The tabular geometry layer: ``GeoSeries``, ``GeoDataFrame`` (pandas
subclasses, a geopandas-like surface), ``sjoin`` and ``overlay``.

``GeoSeries``/``GeoDataFrame``/``sjoin``/``overlay`` are a copy of the
reference package's ``geom/table.py``: exactly the surface the label
preparation and tileset stages use from geopandas 0.11 (``sjoin`` with
intersects/within/contains, left/inner and suffixes; ``overlay``
difference/intersection; ``unary_union``, elementwise ``buffer``/``area``/
``length``/``is_valid``/``intersects``, ``to_crs``/``set_crs`` and
``from_features``).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import pandas as pd

from ..crs import CRS, transform_xy
from . import core
from .affinity import _apply
from .core import BaseGeometry, MultiPolygon, Polygon, union_all
from .index import GridIndex

GEOM_COL = "geometry"


# ---------------------------------------------------------------------------

class GeoSeries(pd.Series):
    _metadata = ["crs"]

    def __init__(self, data=None, *args, crs=None, **kwargs):
        super().__init__(data, *args, **kwargs)
        self.crs = crs if crs is None else CRS(crs)

    @property
    def _constructor(self):
        return GeoSeries

    # -- elementwise properties ----------------------------------------------
    @property
    def area(self) -> pd.Series:
        return pd.Series([g.area if g is not None else np.nan
                          for g in self.values], index=self.index)

    @property
    def length(self) -> pd.Series:
        return pd.Series([g.length if g is not None else np.nan
                          for g in self.values], index=self.index)

    @property
    def is_valid(self) -> pd.Series:
        return pd.Series([bool(g.is_valid) if g is not None else False
                          for g in self.values], index=self.index)

    @property
    def is_empty(self) -> pd.Series:
        return pd.Series([g.is_empty if g is not None else True
                          for g in self.values], index=self.index)

    @property
    def bounds(self) -> pd.DataFrame:
        rows = [g.bounds if g is not None and not g.is_empty
                else (np.nan,) * 4 for g in self.values]
        return pd.DataFrame(rows, columns=["minx", "miny", "maxx", "maxy"],
                            index=self.index)

    @property
    def total_bounds(self) -> np.ndarray:
        b = self.bounds
        return np.array([b["minx"].min(), b["miny"].min(),
                         b["maxx"].max(), b["maxy"].max()])

    @property
    def centroid(self) -> "GeoSeries":
        return GeoSeries([g.centroid for g in self.values],
                         index=self.index, crs=self.crs)

    @property
    def unary_union(self) -> BaseGeometry:
        return union_all([g for g in self.values if g is not None])

    def union_all(self) -> BaseGeometry:
        return self.unary_union

    # -- elementwise operations ----------------------------------------------
    def buffer(self, distance, cap_style=1, quad_segs=8, resolution=None) -> "GeoSeries":
        if np.isscalar(distance):
            dist = np.full(len(self), float(distance))
        else:
            dist = np.asarray(distance, dtype=np.float64)
        # None geometries pass through (geopandas semantics; the readers
        # produce None for NULL shapes)
        out = [None if g is None else
               g.buffer(d, cap_style=cap_style,
                        quad_segs=(resolution or quad_segs))
               for g, d in zip(self.values, dist)]
        return GeoSeries(out, index=self.index, crs=self.crs)

    def simplify(self, tolerance, preserve_topology=True) -> "GeoSeries":
        return GeoSeries([None if g is None else g.simplify(tolerance)
                          for g in self.values],
                         index=self.index, crs=self.crs)

    def intersects(self, other) -> pd.Series:
        if isinstance(other, BaseGeometry):
            return pd.Series([False if g is None else g.intersects(other)
                              for g in self.values], index=self.index)
        raise TypeError("intersects expects a single geometry")

    def intersection(self, other: BaseGeometry) -> "GeoSeries":
        return GeoSeries([None if g is None else g.intersection(other)
                          for g in self.values],
                         index=self.index, crs=self.crs)

    def scale(self, xfact=1.0, yfact=1.0, origin="center") -> "GeoSeries":
        from .affinity import scale as _scale
        return GeoSeries([None if g is None else
                          _scale(g, xfact, yfact, origin)
                          for g in self.values],
                         index=self.index, crs=self.crs)

    def to_crs(self, crs=None, epsg=None) -> "GeoSeries":
        dst = CRS(epsg if epsg is not None else crs)
        if self.crs is None:
            raise ValueError("source CRS is not set")
        src = self.crs

        def fn(c):
            x, y = transform_xy(src, dst, c[:, 0], c[:, 1])
            return np.stack([x, y], axis=1)

        return GeoSeries([None if g is None else _apply(g, fn)
                          for g in self.values],
                         index=self.index, crs=dst)

    @property
    def values_list(self):
        return list(self.values)


# ---------------------------------------------------------------------------

class GeoDataFrame(pd.DataFrame):
    _metadata = ["crs"]

    def __init__(self, data=None, *args, crs=None, geometry=None, **kwargs):
        if geometry is not None and not isinstance(geometry, str):
            if data is None:
                data = {}
            if isinstance(data, dict):
                data = dict(data)
                data[GEOM_COL] = list(geometry)
        super().__init__(data, *args, **kwargs)
        self.crs = crs if crs is None else CRS(crs)

    @property
    def _constructor(self):
        return GeoDataFrame

    @property
    def _constructor_sliced(self):
        return pd.Series

    def __finalize__(self, other, method=None, **kwargs):
        out = super().__finalize__(other, method=method, **kwargs)
        if getattr(out, "crs", None) is None:
            src = other
            if hasattr(other, "objs"):  # concat
                for o in other.objs:
                    if getattr(o, "crs", None) is not None:
                        src = o
                        break
            out.crs = getattr(src, "crs", None)
        return out

    # -- geometry accessors ----------------------------------------------------
    @property
    def geometry(self) -> GeoSeries:
        return GeoSeries(self[GEOM_COL], crs=self.crs)

    @geometry.setter
    def geometry(self, value):
        self[GEOM_COL] = list(value)

    @property
    def area(self) -> pd.Series:
        return self.geometry.area

    @property
    def length(self) -> pd.Series:
        return self.geometry.length

    @property
    def is_valid(self) -> pd.Series:
        return self.geometry.is_valid

    @property
    def is_empty(self) -> pd.Series:
        return self.geometry.is_empty

    @property
    def bounds(self) -> pd.DataFrame:
        return self.geometry.bounds

    @property
    def total_bounds(self) -> np.ndarray:
        return self.geometry.total_bounds

    @property
    def unary_union(self) -> BaseGeometry:
        return self.geometry.unary_union

    def union_all(self) -> BaseGeometry:
        return self.geometry.unary_union

    def buffer(self, distance, cap_style=1, quad_segs=8, resolution=None) -> GeoSeries:
        return self.geometry.buffer(distance, cap_style, quad_segs, resolution)

    # -- CRS --------------------------------------------------------------------
    def set_crs(self, crs=None, epsg=None, inplace=False,
                allow_override=True) -> "GeoDataFrame":
        target = CRS(epsg if epsg is not None else crs)
        obj = self if inplace else self.copy()
        obj.crs = target
        return obj

    def to_crs(self, crs=None, epsg=None, inplace=False) -> "GeoDataFrame":
        gs = self.geometry.to_crs(crs=crs, epsg=epsg)
        obj = self if inplace else self.copy()
        obj[GEOM_COL] = list(gs.values)
        obj.crs = gs.crs
        return obj

    # -- constructors -------------------------------------------------------------
    @classmethod
    def from_features(cls, features: Iterable[dict], crs=None) -> "GeoDataFrame":
        rows = []
        geoms = []
        for f in features:
            props = dict(f.get("properties") or {})
            rows.append(props)
            geoms.append(core.shape(f["geometry"]) if f.get("geometry") else None)
        df = cls(pd.DataFrame(rows))
        df[GEOM_COL] = geoms
        df.crs = crs if crs is None else CRS(crs)
        return df

    # -- joins ---------------------------------------------------------------------
    def sjoin(self, other: "GeoDataFrame", how: str = "inner",
              predicate: str = "intersects", lsuffix: str = "left",
              rsuffix: str = "right") -> "GeoDataFrame":
        return sjoin(self, other, how=how, predicate=predicate,
                     lsuffix=lsuffix, rsuffix=rsuffix)

    def overlay(self, other: "GeoDataFrame", how: str = "intersection",
                keep_geom_type: bool = True) -> "GeoDataFrame":
        return overlay(self, other, how=how, keep_geom_type=keep_geom_type)

    # -- io --------------------------------------------------------------------------
    def to_file(self, path: str, driver: str | None = None,
                layer: str | None = None, index: bool = False) -> None:
        from ..io import write_file
        write_file(self, path, driver=driver, layer=layer)


# ---------------------------------------------------------------------------
# spatial join

def _candidate_pairs(left: GeoDataFrame, right: GeoDataFrame,
                     predicate: str) -> list[tuple[int, int]]:
    lg = list(left[GEOM_COL].values)
    rg = list(right[GEOM_COL].values)
    rb = np.array([g.bounds if g is not None and not g.is_empty
                   else (np.inf, np.inf, -np.inf, -np.inf) for g in rg])
    idx = GridIndex(rb) if len(rg) else None
    pairs: list[tuple[int, int]] = []
    for i, g in enumerate(lg):
        if g is None or g.is_empty or idx is None:
            continue
        for j in idx.query(*g.bounds):
            o = rg[j]
            if predicate == "intersects":
                ok = g.intersects(o)
            elif predicate == "within":
                ok = g.within(o)
            elif predicate == "contains":
                ok = g.contains(o)
            else:
                raise ValueError(f"unsupported predicate {predicate!r}")
            if ok:
                pairs.append((i, j))
    return pairs


def sjoin(left: GeoDataFrame, right: GeoDataFrame, how: str = "inner",
          predicate: str = "intersects", lsuffix: str = "left",
          rsuffix: str = "right") -> GeoDataFrame:
    """geopandas.sjoin equivalent.

    Keeps the left geometry; right's geometry column is dropped; name
    collisions get lsuffix/rsuffix; ``index_right`` holds the matched right
    index value. how='left' keeps unmatched left rows with NaN fills.
    """
    pairs = _candidate_pairs(left, right, predicate)
    li = [p[0] for p in pairs]
    ri = [p[1] for p in pairs]

    lcols = [c for c in left.columns]
    rcols = [c for c in right.columns if c != GEOM_COL]
    collide = (set(lcols) - {GEOM_COL}) & set(rcols)

    lrename = {c: f"{c}_{lsuffix}" for c in collide}
    rrename = {c: f"{c}_{rsuffix}" for c in collide}

    lpart = left.iloc[li].rename(columns=lrename)
    rpart = right.iloc[ri][rcols].rename(columns=rrename)
    rpart.index = lpart.index
    out = pd.concat(
        [lpart.reset_index(drop=True), rpart.reset_index(drop=True)], axis=1)
    out["index_right"] = [right.index[j] for j in ri]
    out.index = [left.index[i] for i in li]

    if how == "left":
        matched = set(li)
        missing = [i for i in range(len(left)) if i not in matched]
        if missing:
            mpart = left.iloc[missing].rename(columns=lrename)
            madd = pd.DataFrame(
                {c: [np.nan] * len(missing)
                 for c in list(rpart.columns) + ["index_right"]},
                index=mpart.index)
            mrows = pd.concat([mpart, madd], axis=1)
            out = pd.concat([out, mrows], axis=0)
            # keep original left order — positional, robust to duplicate
            # index labels (get_loc returns slices for those)
            pos_of = {}
            for pos, lab in enumerate(left.index):
                pos_of.setdefault(lab, pos)
            order = np.argsort([pos_of.get(i, 0) for i in out.index],
                               kind="stable")
            out = out.iloc[order]
    elif how != "inner":
        raise ValueError(f"unsupported how {how!r}")

    gdf = GeoDataFrame(out)
    gdf.crs = left.crs
    return gdf


# ---------------------------------------------------------------------------
# overlay

def overlay(df1: GeoDataFrame, df2: GeoDataFrame, how: str = "intersection",
            keep_geom_type: bool = True) -> GeoDataFrame:
    """geopandas.overlay equivalent for 'intersection' and 'difference'.

    The pipeline uses difference to cut forests out of road polygons
    (reference prepare_data_obj_detec.py:191) and intersection to weight
    detections against labels (reference determine_class.py:110).
    """
    g1 = list(df1[GEOM_COL].values)
    g2 = list(df2[GEOM_COL].values)
    b2 = np.array([g.bounds if g is not None and not g.is_empty
                   else (np.inf, np.inf, -np.inf, -np.inf) for g in g2])
    idx = GridIndex(b2) if len(g2) else None

    if how == "difference":
        rows = []
        geoms = []
        for i, g in enumerate(g1):
            if g is None or g.is_empty:
                continue
            cand = idx.query(*g.bounds) if idx is not None else []
            out = g
            if len(cand):
                clip = union_all([g2[j] for j in cand])
                out = g.difference(clip)
            if out.is_empty:
                continue
            rows.append(i)
            geoms.append(out)
        res = df1.iloc[rows].copy()
        res[GEOM_COL] = geoms
        res.reset_index(drop=True, inplace=True)
        gdf = GeoDataFrame(res)
        gdf.crs = df1.crs
        return gdf

    if how == "intersection":
        cols1 = [c for c in df1.columns if c != GEOM_COL]
        cols2 = [c for c in df2.columns if c != GEOM_COL]
        collide = set(cols1) & set(cols2)
        # geopandas keep_geom_type keeps df1's geometry family: clipping
        # road LINES to the AOI must yield lines, not silently drop them
        # (reference statistical_analysis/prepare_data.py:79)
        family = _geom_family_of(g1)
        li, ri, geoms = [], [], []
        for i, g in enumerate(g1):
            if g is None or g.is_empty or idx is None:
                continue
            for j in idx.query(*g.bounds):
                o = g2[j]
                inter = g.intersection(o)
                if keep_geom_type:
                    inter = _extract_family(inter, family)
                if inter is None or inter.is_empty or (
                        keep_geom_type and _measure(inter, family) == 0):
                    continue
                li.append(i)
                ri.append(j)
                geoms.append(inter)
        p1 = df1.iloc[li][cols1].rename(
            columns={c: f"{c}_1" for c in collide}).reset_index(drop=True)
        p2 = df2.iloc[ri][cols2].rename(
            columns={c: f"{c}_2" for c in collide}).reset_index(drop=True)
        res = pd.concat([p1, p2], axis=1)
        res[GEOM_COL] = geoms
        gdf = GeoDataFrame(res)
        gdf.crs = df1.crs
        return gdf

    raise ValueError(f"unsupported overlay how={how!r}")


def _geom_family_of(geoms) -> str:
    """Dominant geometry family of a column: 'areal' | 'line' | 'point'."""
    for g in geoms:
        if g is None or g.is_empty:
            continue
        t = g.geom_type
        if t in ("Polygon", "MultiPolygon"):
            return "areal"
        if t in ("LineString", "MultiLineString"):
            return "line"
        if t == "Point":
            return "point"
    return "areal"


_FAMILY_TYPES = {
    "areal": ("Polygon", "MultiPolygon"),
    "line": ("LineString", "MultiLineString"),
    "point": ("Point",),
}


def _extract_family(g, family: str):
    """Keep only the parts of ``g`` in the requested family (descending
    into GeometryCollection), or None if nothing matches."""
    if g is None:
        return None
    t = g.geom_type
    if t in _FAMILY_TYPES[family]:
        return g
    if t == "GeometryCollection":
        parts = []
        for sub in g.geoms:
            m = _extract_family(sub, family)
            if m is None or m.is_empty:
                continue
            parts.extend(m.geoms if hasattr(m, "geoms")
                         and m.geom_type.startswith("Multi") else [m])
        if not parts:
            return None
        if len(parts) == 1:
            return parts[0]
        if family == "areal":
            return core.MultiPolygon(parts)
        if family == "line":
            from .core import MultiLineString
            return MultiLineString(parts)
        return parts[0]
    return None


def _measure(g, family: str) -> float:
    if family == "areal":
        return g.area
    if family == "line":
        return g.length
    return 1.0

