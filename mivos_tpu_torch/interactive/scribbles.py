"""DAVIS interactive scribble utilities (counterpart of
mivos_tpu/interactive/scribbles.py; the subset of
davisinteractive.utils.scribbles the protocol needs).

Scribble JSON schema: {'scribbles': [frame_0_lines, frame_1_lines, ...]}
where each line is {'path': [[x, y], ...] in [0,1]^2, 'object_id': int}.

Without cv2: `draw_line` gives the pixels of cv2.line(LINE_8). The
segment is first clipped as cv2.line clips it: to the map at thickness
1, to the map grown by the thickness on every side when thicker. Then,
at thickness 1, OpenCV's 8-connected Bresenham iterator drawn left to
right; thicker, OpenCV's `ThickLine` (imgproc/src/drawing.cpp) step by
step in its 16-bit fixed point: the body as a convex quadrilateral
(`FillConvexPoly` with its `Line2` outline) and a filled `Circle` cap at
each end. `mask_to_scribble` takes its distance transform from
eval/robot.py::chamfer_distance, cv2.distanceTransform(DIST_L2, 3)'s
3x3 chamfer.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

XY_SHIFT = 16            # OpenCV's drawing fixed point (drawing.cpp)
XY_ONE = 1 << XY_SHIFT
_HALF = XY_ONE >> 1


def draw_line(img: np.ndarray, p0, p1, value, thickness: int = 1) -> None:
    """Set the pixels of the segment p0 -> p1 ((x, y) integer points,
    inside the 2-D map `img` or not) to `value`, as cv2.line(img, p0, p1,
    value, thickness) does with LINE_8. The segment is clipped to the
    map, grown by `thickness` on every side when thicker than 1
    (`_clip_line`). Thickness 1: the points are swapped so x increases,
    the major axis steps every pixel, and the minor axis steps where the
    error term dx - 2*dy*(i+1) + 2*dx*m turns negative, i.e. after i
    steps it has moved m_i = ceil((2*dy*i - dx) / (2*dx)). Thicker:
    `_thick_line`, whose body and caps clip to `img`."""
    h, w = img.shape
    g = int(thickness) if thickness > 1 else 0
    inside, x0, y0, x1, y1 = _clip_line(w + 2 * g, h + 2 * g,
                                        int(p0[0]) + g, int(p0[1]) + g,
                                        int(p1[0]) + g, int(p1[1]) + g)
    if not inside:
        return
    x0, y0, x1, y1 = x0 - g, y0 - g, x1 - g, y1 - g
    if thickness > 1:
        _thick_line(img, (x0, y0), (x1, y1), value, int(thickness))
        return
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, abs(y1 - y0)
    sy = 1 if y1 >= y0 else -1
    major, minor = (dy, dx) if dy > dx else (dx, dy)
    i = np.arange(major + 1)
    m = -((-(2 * minor * i - major)) // (2 * major)) if major else i * 0
    if dy > dx:
        img[y0 + sy * i, x0 + m] = value
    else:
        img[y0 + sy * m, x0 + i] = value


def _cdiv(a: int, b: int) -> int:
    """C integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _thick_line(img: np.ndarray, p0, p1, value, thickness: int) -> None:
    """drawing.cpp `ThickLine` for LINE_8, shift 0."""
    x0, y0 = int(p0[0]) << XY_SHIFT, int(p0[1]) << XY_SHIFT
    x1, y1 = int(p1[0]) << XY_SHIFT, int(p1[1]) << XY_SHIFT
    dx, dy = (x0 - x1) / XY_ONE, (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > np.finfo(np.float64).eps:
        r = (thickness + odd * XY_ONE * 0.5) / math.sqrt(r)
        # cvRound: to nearest, ties to even, as Python's round.
        dpx, dpy = round(dy * r), round(dx * r)
        _fill_convex_poly(img, [(x0 + dpx, y0 + dpy), (x0 - dpx, y0 - dpy),
                                (x1 - dpx, y1 - dpy), (x1 + dpx, y1 + dpy)],
                          value)
    radius = (thickness + _HALF) >> XY_SHIFT
    for x, y in ((x0, y0), (x1, y1)):
        _circle(img, (x + _HALF) >> XY_SHIFT, (y + _HALF) >> XY_SHIFT, radius,
                value)


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """drawing.cpp `clipLine` on a (w, h) canvas: returns whether any of
    the segment is inside, and its clipped end points."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line2(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, value) -> None:
    """drawing.cpp `Line2`: an 8-connected line between fixed-point
    points, clipped to the canvas."""
    h, w = img.shape
    inside, x1, y1, x2, y2 = _clip_line(w << XY_SHIFT, h << XY_SHIFT,
                                        x1, y1, x2, y2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        step = _cdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        step = _cdiv(dx << XY_SHIFT, ay | 1)
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += _HALF
    y1 += _HALF
    # The end point, then ecount + 1 steps from the start: one per pixel
    # along the major axis, `step` (fixed point) along the minor.
    i = np.arange(max(ecount + 1, 0), dtype=np.int64)
    if ax > ay:
        xs, ys = (x1 >> XY_SHIFT) + i, (y1 + i * step) >> XY_SHIFT
    else:
        xs, ys = (x1 + i * step) >> XY_SHIFT, (y1 >> XY_SHIFT) + i
    xs = np.append(xs, (x2 + _HALF) >> XY_SHIFT)
    ys = np.append(ys, (y2 + _HALF) >> XY_SHIFT)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = value


def _fill_convex_poly(img: np.ndarray, v, value) -> None:
    """drawing.cpp `FillConvexPoly` for LINE_8 with the points in
    XY_SHIFT fixed point: the outline by `_line2`, then scanline spans
    between the two edges walked down from the topmost vertex."""
    h, w = img.shape
    npts = len(v)
    imin = 0
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    px, py = v[-1]
    for i, (x, y) in enumerate(v):
        if y < ymin:
            ymin, imin = y, i
        ymax, xmax, xmin = max(ymax, y), max(xmax, x), min(xmin, x)
        _line2(img, px, py, x, y, value)
        px, py = x, y
    xmin, xmax = (xmin + _HALF) >> XY_SHIFT, (xmax + _HALF) >> XY_SHIFT
    ymin, ymax = (ymin + _HALF) >> XY_SHIFT, (ymax + _HALF) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # Per edge: [vertex index, index step, x, x step per row, last row].
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    edges, y = npts, ymin
    while True:
        for e in edge:
            if y < e[4]:
                continue
            idx0, di = e[0], e[1]
            idx = (idx0 + di) % npts
            while True:
                more = edges > 0
                edges -= 1
                if not more:
                    break
                ty = (v[idx][1] + _HALF) >> XY_SHIFT
                if ty > y:
                    xs, xe = v[idx0][0], v[idx][0]
                    e[4] = ty
                    e[3] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                    e[2] = xs
                    e[0] = idx
                    break
                idx0, idx = idx, (idx + di) % npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
            xx1 = (edge[left][2] + _HALF) >> XY_SHIFT
            xx2 = (edge[right][2] + _HALF) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                img[y, max(xx1, 0):min(xx2, w - 1) + 1] = value
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def _circle(img: np.ndarray, cx: int, cy: int, radius: int, value) -> None:
    """drawing.cpp `Circle` filled: the midpoint circle's octant walk,
    each step a horizontal span on four rows, clipped to the canvas."""
    h, w = img.shape
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1

    def span(y: int, xl: int, xr: int) -> None:
        if 0 <= y < h and xr >= 0 and xl < w:
            img[y, max(xl, 0):min(xr, w - 1) + 1] = value

    while dx >= dy:
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if x11 < w and x12 >= 0 and cy - dx < h and cy + dx >= 0:
            span(cy - dy, x11, x12)
            span(cy + dy, x11, x12)
            if x21 < w and x22 >= 0:
                span(cy - dx, x21, x22)
                span(cy + dx, x21, x22)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def scribbles2mask(scribbles: Dict, output_resolution: Tuple[int, int],
                   default_value: int = -1) -> np.ndarray:
    """Rasterize every frame's scribble lines into (T, H, W) int32 maps."""
    h, w = output_resolution
    frames = scribbles["scribbles"]
    out = np.full((len(frames), h, w), default_value, dtype=np.int32)
    for ti, lines in enumerate(frames):
        for line in lines:
            path = np.asarray(line["path"], dtype=np.float64)
            if len(path) == 0:
                continue
            obj = int(line["object_id"])
            # np.round is half-to-even, as in the JAX package.
            pts = np.round(path * np.asarray([w - 1, h - 1])).astype(np.int32)
            if len(pts) == 1:
                out[ti, pts[0][1], pts[0][0]] = obj
                continue
            for a, b in zip(pts[:-1], pts[1:]):
                draw_line(out[ti], a, b, obj)
    return out


def annotated_frames(scribbles: Dict) -> List[int]:
    return [i for i, s in enumerate(scribbles["scribbles"]) if len(s) > 0]


def is_empty(scribbles: Dict) -> bool:
    return len(annotated_frames(scribbles)) == 0


def select_single_frame(scribbles: Dict) -> Tuple[Dict, int]:
    """Keep only the (first) annotated frame, the reference's frame
    selection in to_mask (davis_processor.py:42-47). Returns the reduced
    scribble dict and the frame index."""
    for idx, s in enumerate(scribbles["scribbles"]):
        if len(s) != 0:
            return {**scribbles, "scribbles": [s]}, idx
    return scribbles, 0


def mask_to_scribble(mask: np.ndarray, frame: int, num_frames: int,
                     num_points: int = 20,
                     rng: Optional[np.random.RandomState] = None) -> Dict:
    """Synthesize a scribble inside each label of an indexed mask (the
    background's included), as mivos_tpu/interactive/scribbles.py:63
    does: up to num_points interior points (chamfer distance above
    max(1, 0.3 x its max), else any pixel of the label) in column-major
    order, normalized to [0,1]^2, on `frame` of num_frames."""
    from mivos_tpu_torch.eval.robot import chamfer_distance

    rng = rng or np.random.RandomState(0)
    h, w = mask.shape
    lines = []
    for obj in np.unique(mask):
        region = (mask == obj).astype(np.uint8)
        dt = chamfer_distance(region)
        ys, xs = np.nonzero(dt > max(1.0, 0.3 * dt.max()))
        if len(ys) == 0:
            ys, xs = np.nonzero(region)
        if len(ys) == 0:
            continue
        sel = rng.choice(len(ys), size=min(num_points, len(ys)), replace=False)
        order = np.argsort(xs[sel] * h + ys[sel])
        path = [[xs[sel][i] / (w - 1), ys[sel][i] / (h - 1)] for i in order]
        lines.append({"path": path, "object_id": int(obj),
                      "start_time": 0, "end_time": 1})
    frames = [[] for _ in range(num_frames)]
    frames[frame] = lines
    return {"scribbles": frames, "annotated_frame": frame}
