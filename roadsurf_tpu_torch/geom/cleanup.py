"""Geometry cleanup helpers of the label preparation stage (a copy of the
reference package's ``geom/cleanup.py``, itself the upstream project's
fct_misc geometry utilities): overlap removal between buffered road
polygons that avoids sliver parts, and validity repair by a zero buffer.

With the port's empty ``Polygon`` result, a difference that removes a road
polygon entirely passes through ``polygons_diff_without_artifacts`` as an
empty ``Polygon`` (as upstream's shapely result did), where the
reference's empty ``MultiPolygon`` raised on ``max()`` of no parts.
"""

from __future__ import annotations

import sys

import pandas as pd

from ..utils.logging import logger
from .table import sjoin


def keep_largest_part(geom):
    """Collapse a MultiPolygon to its largest part; pass through others.

    The reference applies this to roundabout buffer artifacts
    (prepare_data_obj_detec.py:129-136).
    """
    if geom is not None and geom.geom_type == "MultiPolygon" and not geom.is_empty:
        return max(geom.geoms, key=lambda p: p.area)
    return geom


def polygons_diff_without_artifacts(polygons, p1_idx, p2_idx,
                                    keep_everything: bool = False,
                                    min_part_area: float = 10.0,
                                    id_col: str = "OBJECTID"):
    """Subtract the polygon at row ``p1_idx`` from the one at ``p2_idx``.

    Mirrors fct_misc.polygons_diff_without_artifacts (fct_misc.py:126-176):
    if the difference is a MultiPolygon only the largest part replaces the
    row; with ``keep_everything`` the other parts larger than
    ``min_part_area`` (10 m² in the reference) are appended as new rows
    whose id is the parent id with a 0-based suffix digit.
    """
    p1 = polygons.loc[p1_idx, "geometry"]
    p2 = polygons.loc[p2_idx, "geometry"]
    diff = p2 - p1

    if diff.geom_type != "MultiPolygon":
        polygons.loc[p2_idx, "geometry"] = diff
        return polygons

    polygons.loc[p2_idx, "geometry"] = max(diff.geoms, key=lambda a: a.area)

    parts = sorted((p for p in diff.geoms if p.area > min_part_area),
                   key=lambda p: p.area, reverse=True)
    if len(parts) > 1 and keep_everything:
        base = polygons.loc[p2_idx]
        rows = []
        for i, part in enumerate(parts[1:]):
            row = base.copy()
            row["geometry"] = part
            row[id_col] = int(f"{int(base[id_col])}{i}")
            rows.append(row)
        polygons = pd.concat([polygons, pd.DataFrame(rows)],
                             ignore_index=True)
    return polygons


def intersecting_pairs(gdf, cols):
    """Directed pairs of distinct intersecting rows via self-sjoin, deduped
    on (OBJECTID_1, OBJECTID_2); used by both de-overlap pipelines
    (reference prepare_data_obj_detec.py:144-149, prepare_data.py:110-117).
    """
    probe = gdf.copy()
    probe["saved_geom"] = probe.geometry
    joined = sjoin(probe, probe[cols + ["saved_geom", "geometry"]],
                   how="left", lsuffix="1", rsuffix="2")
    pairs = joined[joined["OBJECTID_2"].notna()]
    pairs = pairs[pairs["OBJECTID_1"] != pairs["OBJECTID_2"]]
    return pairs.drop_duplicates(subset=["OBJECTID_1", "OBJECTID_2"]) \
                .reset_index(drop=True)


def test_valid_geom(gdf, correct: bool = False, gdf_obj_name: str | None = None):
    """Assert all geometries valid; repair with buffer(0) when ``correct``
    else exit(1). Mirrors fct_misc.test_valid_geom (fct_misc.py:179-208)."""
    invalid = ~gdf.is_valid
    n_bad = int(invalid.sum())
    name = f" among the {gdf_obj_name}" if gdf_obj_name else ""
    if n_bad == 0:
        logger.info(f"There aren't any invalid geometries{name}.")
        return gdf
    logger.error(f"{n_bad} geometries are invalid{name}.")
    if not correct:
        sys.exit(1)
    logger.warning("Correction of the invalid geometries with a buffer of 0 m...")
    out = gdf.copy()
    fixed = [g.buffer(0) if not g.is_valid else g
             for g in out.loc[invalid, "geometry"].values]
    out.loc[invalid, "geometry"] = fixed
    return out
