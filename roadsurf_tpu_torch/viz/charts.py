"""Standalone-HTML line/scatter charts (plotly-free).

The reference writes six plotly HTML dashboards (precision-recall curves,
TP/FN/FP vs threshold, metrics vs threshold, reliability diagram —
final_metrics.py:574-742). plotly is not a dependency here; this module
renders the same figures as self-contained HTML with inline SVG: polyline
traces, per-point hover tooltips (SVG <title>), axis ticks and a legend.
"""

from __future__ import annotations

import html
import math

import numpy as np

_COLORS = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b",
           "#e377c2", "#7f7f7f", "#bcbd22", "#17becf", "#aec7e8", "#ffbb78",
           "#98df8a", "#ff9896", "#c5b0d5", "#c49c94"]


def _nice_ticks(lo: float, hi: float, n: int = 6) -> list[float]:
    if hi <= lo:
        hi = lo + 1.0
    raw = (hi - lo) / max(n - 1, 1)
    mag = 10 ** math.floor(math.log10(raw))
    for m in (1, 2, 2.5, 5, 10):
        if raw <= m * mag:
            step = m * mag
            break
    start = math.ceil(lo / step) * step
    ticks = []
    t = start
    while t <= hi + 1e-9:
        ticks.append(round(t, 10))
        t += step
    return ticks


class Figure:
    """Minimal plotly-graph-objects-like figure: add_scatter + write_html."""

    def __init__(self, width: int = 900, height: int = 560):
        self.width = width
        self.height = height
        self.traces: list[dict] = []
        self.layout: dict = {}

    def add_scatter(self, x, y, name: str = "", text=None,
                    mode: str = "markers+lines") -> "Figure":
        self.traces.append({
            "x": [float(v) for v in np.asarray(x, dtype=np.float64)],
            "y": [float(v) for v in np.asarray(y, dtype=np.float64)],
            "name": name,
            "text": None if text is None else [str(t) for t in text],
            "mode": mode,
        })
        return self

    def update_layout(self, xaxis_title: str = "", yaxis_title: str = "",
                      title: str = "", xaxis: dict | None = None,
                      yaxis: dict | None = None) -> "Figure":
        self.layout.update({k: v for k, v in [
            ("xaxis_title", xaxis_title), ("yaxis_title", yaxis_title),
            ("title", title)] if v})
        if xaxis and "range" in xaxis:
            self.layout["xrange"] = xaxis["range"]
        if yaxis and "range" in yaxis:
            self.layout["yrange"] = yaxis["range"]
        return self

    # -- rendering ----------------------------------------------------------

    def _extent(self):
        xs = [v for t in self.traces for v in t["x"] if np.isfinite(v)]
        ys = [v for t in self.traces for v in t["y"] if np.isfinite(v)]
        x0, x1 = (min(xs), max(xs)) if xs else (0.0, 1.0)
        y0, y1 = (min(ys), max(ys)) if ys else (0.0, 1.0)
        if "xrange" in self.layout:
            x0, x1 = self.layout["xrange"]
        if "yrange" in self.layout:
            y0, y1 = self.layout["yrange"]
        if x1 == x0:
            x1 = x0 + 1
        if y1 == y0:
            y1 = y0 + 1
        return x0, x1, y0, y1

    def to_svg(self) -> str:
        W, H = self.width, self.height
        ml, mr, mt, mb = 70, 190, 48, 56
        pw, ph = W - ml - mr, H - mt - mb
        x0, x1, y0, y1 = self._extent()

        def sx(v):
            return ml + (v - x0) / (x1 - x0) * pw

        def sy(v):
            return mt + ph - (v - y0) / (y1 - y0) * ph

        out = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" '
               f'height="{H}" font-family="sans-serif" font-size="12">',
               f'<rect width="{W}" height="{H}" fill="white"/>',
               f'<rect x="{ml}" y="{mt}" width="{pw}" height="{ph}" '
               'fill="none" stroke="#ccc"/>']
        if self.layout.get("title"):
            out.append(f'<text x="{W / 2}" y="24" text-anchor="middle" '
                       f'font-size="16">{html.escape(self.layout["title"])}'
                       '</text>')
        for t in _nice_ticks(x0, x1):
            if x0 <= t <= x1:
                out.append(f'<line x1="{sx(t):.1f}" y1="{mt}" '
                           f'x2="{sx(t):.1f}" y2="{mt + ph}" '
                           'stroke="#eee"/>')
                out.append(f'<text x="{sx(t):.1f}" y="{mt + ph + 18}" '
                           f'text-anchor="middle">{t:g}</text>')
        for t in _nice_ticks(y0, y1):
            if y0 <= t <= y1:
                out.append(f'<line x1="{ml}" y1="{sy(t):.1f}" '
                           f'x2="{ml + pw}" y2="{sy(t):.1f}" '
                           'stroke="#eee"/>')
                out.append(f'<text x="{ml - 8}" y="{sy(t):.1f}" '
                           f'text-anchor="end" dy="4">{t:g}</text>')
        if self.layout.get("xaxis_title"):
            out.append(f'<text x="{ml + pw / 2}" y="{H - 12}" '
                       f'text-anchor="middle">'
                       f'{html.escape(self.layout["xaxis_title"])}</text>')
        if self.layout.get("yaxis_title"):
            out.append(f'<text x="18" y="{mt + ph / 2}" text-anchor="middle" '
                       f'transform="rotate(-90 18 {mt + ph / 2})">'
                       f'{html.escape(self.layout["yaxis_title"])}</text>')

        for i, tr in enumerate(self.traces):
            color = _COLORS[i % len(_COLORS)]
            pts = [(sx(px), sy(py)) for px, py in zip(tr["x"], tr["y"])
                   if np.isfinite(px) and np.isfinite(py)]
            if "lines" in tr["mode"] and len(pts) > 1:
                path = " ".join(f"{px:.1f},{py:.1f}" for px, py in pts)
                out.append(f'<polyline points="{path}" fill="none" '
                           f'stroke="{color}" stroke-width="1.6"/>')
            if "markers" in tr["mode"]:
                for j, (px, py) in enumerate(pts):
                    tip = f'{tr["name"]}: ({tr["x"][j]:g}, {tr["y"][j]:g})'
                    if tr["text"]:
                        tip += f' [{tr["text"][j]}]'
                    out.append(f'<circle cx="{px:.1f}" cy="{py:.1f}" r="3.2" '
                               f'fill="{color}"><title>'
                               f'{html.escape(tip)}</title></circle>')
            ly = mt + 16 + i * 18
            out.append(f'<rect x="{ml + pw + 14}" y="{ly - 9}" width="12" '
                       f'height="12" fill="{color}"/>')
            out.append(f'<text x="{ml + pw + 31}" y="{ly + 1}">'
                       f'{html.escape(tr["name"][:26])}</text>')
        out.append("</svg>")
        return "".join(out)

    def write_html(self, path: str) -> str:
        title = html.escape(self.layout.get("title", "chart"))
        doc = ("<!DOCTYPE html><html><head><meta charset='utf-8'>"
               f"<title>{title}</title></head><body>"
               + self.to_svg() + "</body></html>")
        with open(path, "w") as f:
            f.write(doc)
        return path
