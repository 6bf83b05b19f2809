"""A small raster plotter: polylines and markers on a white canvas inside an
axes box, written as a PNG by ``image_io.write_png``.

The card's machine has no matplotlib and no font, so a plot carries its words
and numbers as PNG ``tEXt`` chunks instead of drawing them: ``Title``,
``XLabel``, ``YLabel``; ``Series``, a JSON list of each series' label, colour,
style and data (``x``, ``y`` as drawn); ``Axes``, JSON of the data limits and
the axes box in pixels (``project`` maps data to pixels with it); ``VLines``.
``read_plot`` reads them back.

Styles: ``"line"``, ``"."`` (dots), ``"x"`` (crosses), ``".-"`` (a line with
dots), ``".--"`` (a dashed line with dots).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from loner_tpu_torch.analysis.image_io import read_png, write_png

MARGINS = (60, 40, 40, 50)  # left, top, right, bottom, pixels
DASH = 6  # pixels on, pixels off
DOT_RADIUS = 3


@dataclass
class Series:
    label: str
    color: str  # "#rrggbb"
    x: np.ndarray
    y: np.ndarray
    style: str = "line"
    width: int = 2  # line width, pixels
    alpha: float = 1.0


def _rgb(color: str) -> np.ndarray:
    return np.array([int(color[i:i + 2], 16) for i in (1, 3, 5)], np.float64)


def _limits(values: np.ndarray, given: Optional[Tuple[float, float]]) -> Tuple[float, float]:
    if given is not None:
        return float(given[0]), float(given[1])
    finite = values[np.isfinite(values)]
    lo, hi = (float(finite.min()), float(finite.max())) if finite.size else (0.0, 1.0)
    pad = 0.05 * (hi - lo) if hi > lo else 0.5
    return lo - pad, hi + pad


def project(axes: Dict, x: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(columns, rows) of data points in the image, from a plot's ``Axes`` record."""
    (xlo, xhi), (ylo, yhi), (c0, r0, c1, r1) = axes["xlim"], axes["ylim"], axes["box"]
    col = c0 + (np.asarray(x, np.float64) - xlo) / (xhi - xlo) * (c1 - c0)
    row = r1 - (np.asarray(y, np.float64) - ylo) / (yhi - ylo) * (r1 - r0)
    return np.rint(col).astype(int), np.rint(row).astype(int)


class _Canvas:
    def __init__(self, width: int, height: int, box: Tuple[int, int, int, int]) -> None:
        self.pixels = np.full((height, width, 3), 255.0)
        self.box = box

    def paint(self, cols: np.ndarray, rows: np.ndarray, color: np.ndarray, alpha: float,
              clip: bool = True) -> None:
        c0, r0, c1, r1 = self.box if clip else (0, 0, self.pixels.shape[1] - 1,
                                                self.pixels.shape[0] - 1)
        keep = (cols >= c0) & (cols <= c1) & (rows >= r0) & (rows <= r1)
        rows, cols = rows[keep], cols[keep]
        self.pixels[rows, cols] = (1.0 - alpha) * self.pixels[rows, cols] + alpha * color

    def polyline(self, cols: np.ndarray, rows: np.ndarray, color: np.ndarray, width: int,
                 alpha: float, dashed: bool = False, clip: bool = True) -> None:
        """Segments between consecutive points, sampled one pixel apart, stamped
        ``width`` pixels square; a dashed line keeps DASH pixels of every 2 DASH."""
        if cols.size < 2:
            return
        dc, dr = np.diff(cols), np.diff(rows)
        n = np.maximum(np.abs(dc), np.abs(dr)) + 1
        seg = np.repeat(np.arange(n.size), n)
        t = (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)) / np.maximum(n[seg] - 1, 1)
        c = np.rint(cols[seg] + t * dc[seg]).astype(int)
        r = np.rint(rows[seg] + t * dr[seg]).astype(int)
        if dashed:
            on = (np.arange(c.size) // DASH) % 2 == 0
            c, r = c[on], r[on]
        pts = np.unique(np.stack([c, r], 1), axis=0)
        offsets = np.arange(width) - width // 2
        oc, orow = np.meshgrid(offsets, offsets)
        cc = (pts[:, 0, None] + oc.reshape(1, -1)).reshape(-1)
        rr = (pts[:, 1, None] + orow.reshape(1, -1)).reshape(-1)
        pix = np.unique(np.stack([cc, rr], 1), axis=0)
        self.paint(pix[:, 0], pix[:, 1], color, alpha, clip)

    def markers(self, cols: np.ndarray, rows: np.ndarray, color: np.ndarray, kind: str,
                alpha: float) -> None:
        d = np.arange(-DOT_RADIUS, DOT_RADIUS + 1)
        if kind == ".":
            oc, orow = np.meshgrid(d, d)
            disc = oc**2 + orow**2 <= DOT_RADIUS**2
            oc, orow = oc[disc], orow[disc]
        else:  # "x"
            oc, orow = np.concatenate([d, d]), np.concatenate([d, -d])
        cc = (cols[:, None] + oc[None]).reshape(-1)
        rr = (rows[:, None] + orow[None]).reshape(-1)
        pix = np.unique(np.stack([cc, rr], 1), axis=0)
        self.paint(pix[:, 0], pix[:, 1], color, alpha)


def render_plot(series: Sequence[Series], fname: str, size: Tuple[int, int] = (800, 600),
                equal: bool = False, ylim: Optional[Tuple[float, float]] = None,
                vlines: Sequence[float] = (),
                title: str = "", xlabel: str = "", ylabel: str = "") -> str:
    """Draw ``series`` in order (later ones on top) and write the PNG. ``equal``:
    one data unit is as many pixels on both axes (the box's limits widen)."""
    width, height = size
    left, top, right, bottom = MARGINS
    box = (left, top, width - 1 - right, height - 1 - bottom)
    xs = np.concatenate([np.asarray(s.x, np.float64).reshape(-1) for s in series]
                        + [np.asarray(vlines, np.float64).reshape(-1)])
    ys = np.concatenate([np.asarray(s.y, np.float64).reshape(-1) for s in series]
                        + [np.zeros(0)])
    (xlo, xhi), (ylo, yhi) = _limits(xs, None), _limits(ys, ylim)
    if equal:
        per_px = max((xhi - xlo) / (box[2] - box[0]), (yhi - ylo) / (box[3] - box[1]))
        xc, yc = (xlo + xhi) / 2, (ylo + yhi) / 2
        xlo, xhi = xc - per_px * (box[2] - box[0]) / 2, xc + per_px * (box[2] - box[0]) / 2
        ylo, yhi = yc - per_px * (box[3] - box[1]) / 2, yc + per_px * (box[3] - box[1]) / 2
    axes = {"xlim": [xlo, xhi], "ylim": [ylo, yhi], "box": list(box), "equal": equal}

    canvas = _Canvas(width, height, box)
    black = np.zeros(3)
    frame_c = np.array([box[0], box[2], box[2], box[0], box[0]])
    frame_r = np.array([box[1], box[1], box[3], box[3], box[1]])
    canvas.polyline(frame_c, frame_r, black, 1, 1.0, clip=False)
    for x in vlines:
        c, _ = project(axes, [x, x], [ylo, yhi])
        canvas.polyline(c, np.array([box[3], box[1]]), black, 1, 1.0, dashed=True)
    for s in series:
        color = _rgb(s.color)
        cols, rows = project(axes, s.x, s.y)
        if s.style in ("line", ".-", ".--"):
            canvas.polyline(cols, rows, color, s.width, s.alpha, dashed=s.style == ".--")
        if s.style in (".", ".-", ".--", "x"):
            canvas.markers(cols, rows, color, "x" if s.style == "x" else ".", s.alpha)
    text = {
        "Title": title, "XLabel": xlabel, "YLabel": ylabel,
        "Series": json.dumps([{"label": s.label, "color": s.color, "style": s.style,
                               "x": np.asarray(s.x, np.float64).reshape(-1).tolist(),
                               "y": np.asarray(s.y, np.float64).reshape(-1).tolist()}
                              for s in series]),
        "Axes": json.dumps(axes),
        "VLines": json.dumps([float(v) for v in vlines]),
        "Software": "loner_tpu_torch.analysis.raster_plot",
    }
    return write_png(fname, np.rint(canvas.pixels).astype(np.uint8), text)


def read_plot(fname: str) -> Tuple[np.ndarray, Dict]:
    """(pixels, text) of a plot, the JSON chunks parsed."""
    pixels, text = read_png(fname)
    meta = dict(text)
    for key in ("Series", "Axes", "VLines"):
        if key in meta:
            meta[key] = json.loads(meta[key])
    return pixels, meta
