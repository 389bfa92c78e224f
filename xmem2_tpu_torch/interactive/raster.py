"""Stroke rasterizers in numpy: the pixels cv2.line and cv2.circle set.

The JAX package draws strokes with cv2 (interaction.py:65-70, :167-174);
cv2 is not installed beside the port on the card's machine. These functions
follow OpenCV's integer algorithms for LINE_8 (imgproc/drawing.cpp): a
one-pixel line is Bresenham's (LineIterator, 8-connected); a thicker one is a
convex quadrilateral of half-width (thickness + thickness % 2) / 2 in 1/65536
pixel fixed point (FillConvexPoly with its outline drawn by Line2) capped by
a filled midpoint circle of radius (thickness + 1) // 2 at each end; a filled
circle is the midpoint circle (Circle). Canvases are [H, W] or [H, W, C]
arrays of any dtype; value is a scalar or a per-channel sequence.
"""

import math
from typing import Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _bresenham(mask, p0, p1):
    """LineIterator with connectivity 8, points inside the image only."""
    h, w = mask.shape
    (x0, y0), (x1, y1) = p0, p1
    if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
        clipped = _clip_line(w, h, (x0, y0), (x1, y1))
        if clipped is None:
            return
        (x0, y0), (x1, y1) = clipped
    dx, dy = x1 - x0, y1 - y0
    if dx < 0:                           # left to right
        dx, dy = -dx, -dy
        x0, y0, x1, y1 = x1, y1, x0, y0
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x0, y0
    for _ in range(dx + 1):
        mask[y, x] = True
        if err < 0:
            err += 2 * dx
            if vert:
                x += sx
            else:
                y += sy
        err -= 2 * dy
        if vert:
            y += sy
        else:
            x += sx


def _clip_line(w: int, h: int, pt1, pt2):
    """clipLine: the part of the segment inside [0, w-1] x [0, h-1], or
    None."""
    right, bottom = w - 1, h - 1
    x1, y1 = pt1
    x2, y2 = pt2
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
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def _line_fixed(mask, pt1, pt2):
    """Line2: a one-pixel line between fixed-point (1/65536) end points."""
    h, w = mask.shape
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, pt1, pt2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = XY_ONE, _cdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _cdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            mask[y, x] = True

    put((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            put(x1, y1 >> XY_SHIFT)
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            put(x1 >> XY_SHIFT, y1)
            x1 += x_step
            y1 += 1
            ecount -= 1


def _fill_convex(mask, v):
    """FillConvexPoly (LINE_8, shift = XY_SHIFT) of fixed-point vertices."""
    h, w = mask.shape
    n = len(v)
    delta = XY_ONE >> 1
    p0 = v[-1]
    imin = 0
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax = max(ymax, p[1])
        xmax = max(xmax, p[0])
        xmin = min(xmin, p[0])
        _line_fixed(mask, p0, p)
        p0 = p
    xmin, xmax = (xmin + delta) >> XY_SHIFT, (xmax + delta) >> XY_SHIFT
    ymin, ymax = (ymin + delta) >> XY_SHIFT, (ymax + delta) >> XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = n
    edge = [{'idx': imin, 'di': 1, 'x': -XY_ONE, 'dx': 0, 'ye': ymin},
            {'idx': imin, 'di': n - 1, 'x': -XY_ONE, 'dx': 0, 'ye': ymin}]
    y = ymin
    while True:
        for e in edge:
            if y >= e['ye']:
                idx0 = e['idx']
                idx = (idx0 + e['di']) % n
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e['ye'] = ty
                        e['dx'] = _cdiv((xe - xs) * 2 + (ty - y),
                                        2 * (ty - y))
                        e['x'] = xs
                        e['idx'] = idx
                        break
                    idx0 = idx
                    idx = (idx + e['di']) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]['x'] > edge[1]['x'] else (0, 1)
            xx1 = (edge[left]['x'] + delta) >> XY_SHIFT
            xx2 = (edge[right]['x'] + delta) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                mask[y, max(xx1, 0):min(xx2, w - 1) + 1] = True
        edge[0]['x'] += edge[0]['dx']
        edge[1]['x'] += edge[1]['dx']
        y += 1
        if y > ymax:
            break


def _circle(mask, cx: int, cy: int, radius: int):
    """Circle with fill: the midpoint circle's rows, clipped."""
    h, w = mask.shape
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1

    def hline(y, xl, xr):
        if 0 <= y < h and xr >= 0 and xl < w:
            mask[y, max(xl, 0):min(xr, w - 1) + 1] = True

    while dx >= dy:
        hline(cy - dy, cx - dx, cx + dx)
        hline(cy + dy, cx - dx, cx + dx)
        hline(cy - dx, cx - dy, cx + dy)
        hline(cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def line_mask(shape: Tuple[int, int], p0, p1, thickness: int) -> np.ndarray:
    """The [H, W] bool mask of cv2.line(img, p0, p1, color, thickness) with
    integer end points (x, y)."""
    mask = np.zeros(shape, bool)
    p0 = (int(p0[0]), int(p0[1]))
    p1 = (int(p1[0]), int(p1[1]))
    if thickness <= 1:
        _bresenham(mask, p0, p1)
        return mask
    q0 = (p0[0] << XY_SHIFT, p0[1] << XY_SHIFT)
    q1 = (p1[0] << XY_SHIFT, p1[1] << XY_SHIFT)
    dx = (q0[0] - q1[0]) / XY_ONE
    dy = (q1[1] - q0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    half = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex(mask, [(q0[0] + dpx, q0[1] + dpy),
                            (q0[0] - dpx, q0[1] - dpy),
                            (q1[0] - dpx, q1[1] - dpy),
                            (q1[0] + dpx, q1[1] + dpy)])
    radius = (half + (XY_ONE >> 1)) >> XY_SHIFT
    for q in (q0, q1):
        _circle(mask, (q[0] + (XY_ONE >> 1)) >> XY_SHIFT,
                (q[1] + (XY_ONE >> 1)) >> XY_SHIFT, radius)
    return mask


def _paint(canvas: np.ndarray, mask: np.ndarray, value) -> np.ndarray:
    if canvas.ndim == 3 and not np.isscalar(value):
        value = np.asarray(value, canvas.dtype)[:canvas.shape[-1]]
    canvas[mask] = value
    return canvas


def draw_line(canvas: np.ndarray, p0: Sequence[float], p1: Sequence[float],
              value, thickness: int) -> np.ndarray:
    """cv2.line(canvas, round(p0), round(p1), value, thickness) in place;
    returns canvas. Points are (x, y), rounded by Python's round (halves to
    even) as the JAX package's int(round()) does."""
    mask = line_mask(canvas.shape[:2], _round_pt(p0), _round_pt(p1),
                     int(thickness))
    return _paint(canvas, mask, value)


def draw_disc(canvas: np.ndarray, center: Sequence[float], radius: int,
              value) -> np.ndarray:
    """cv2.circle(canvas, round(center), radius, value, thickness=-1) in
    place; returns canvas."""
    mask = np.zeros(canvas.shape[:2], bool)
    cx, cy = _round_pt(center)
    _circle(mask, cx, cy, int(radius))
    return _paint(canvas, mask, value)


def _round_pt(p) -> Tuple[int, int]:
    return int(round(p[0])), int(round(p[1]))
