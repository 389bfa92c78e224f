"""Click encoding: distance maps + click state (Clicker).

Counterpart of xmem2_tpu/interactive/clicks/dist_maps.py. Parity targets in
the reference repo:
  - BFS dist maps: fbrs/utils/cython/_get_dist_maps.pyx (here: the host C++
    source csrc/dist_maps.cpp, a copy of the JAX package's, built with g++ at
    first use into build/ and loaded with ctypes);
  - exact tensor formula: fbrs/model/ops.py:54-80 (here: torch);
  - Clicker click bookkeeping: fbrs/inference/clicker.py.

Both encoders end with tanh(2*sqrt(d)) of the min normalized squared
distance, two layers (positive/negative clicks). A failed build raises: the
JAX package falls back to a numpy BFS without saying so, the port does not
(_bfs_numpy stays as the tests' reference).
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parent / 'csrc' / 'dist_maps.cpp'
BUILD_DIR = Path(__file__).resolve().parents[3] / 'build'
GXX_FLAGS = ['-O3', '-shared', '-fPIC']

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """build/libdistmaps_<hash>.so, keyed by the source and the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + ' '.join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f'libdistmaps_{digest}.so'


def _build(so: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    out = subprocess.run(['g++', *GXX_FLAGS, str(SOURCE), '-o', tmp],
                         capture_output=True, text=True)
    if out.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f'g++ failed to build {SOURCE}:\n{out.stderr}')
    os.replace(tmp, so)    # atomic: a concurrent build never sees half


def load_native() -> ctypes.CDLL:
    """The BFS library, built on first use; raises if it cannot be built."""
    global _lib
    if _lib is None:
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        lib.get_dist_maps.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_float)]
        lib.get_dist_maps.restype = None
        _lib = lib
    return _lib


def _lround(a: np.ndarray) -> np.ndarray:
    """C's lround: to the nearest integer, halves away from zero."""
    return (np.sign(a) * np.floor(np.abs(a) + 0.5)).astype(np.int64)


def _bfs_numpy(points: np.ndarray, height: int, width: int,
               norm_delimeter: float) -> np.ndarray:
    """The same BFS in numpy (slow): the tests' reference for the native
    library."""
    out = np.full((2, height, width), 1e6, np.float32)
    q = deque()
    n = points.shape[0]
    rc = _lround(points)
    for i in range(n):
        x, y = int(rc[i, 0]), int(rc[i, 1])
        if x >= 0:
            layer = 1 if i >= n / 2 else 0
            q.append((x, y, layer, x, y))
            out[layer, x, y] = 0.0
    scale = np.float32(norm_delimeter)
    while q:
        x0, y0, layer, ox, oy = q.popleft()
        for dx, dy in ((-1, 0), (0, -1), (0, 1), (1, 0)):
            x, y = x0 + dx, y0 + dy
            if 0 <= x < height and 0 <= y < width:
                dr = np.float32(x - ox) / scale
                dc = np.float32(y - oy) / scale
                nd = dr * dr + dc * dc
                if out[layer, x, y] > nd:
                    out[layer, x, y] = nd
                    q.append((x, y, layer, ox, oy))
    return out


def inside_points(points: np.ndarray, height: int, width: int
                  ) -> np.ndarray:
    """points with every click whose rounded position falls outside the
    image marked absent (-1). A negative click outside f-BRS's zoom-in crop
    lands there; the JAX package hands it to the BFS, which then writes
    outside its buffer."""
    points = np.array(points, np.float32).reshape(-1, 2)
    rc = _lround(points)
    outside = (rc[:, 0] >= 0) & ((rc[:, 0] >= height) | (rc[:, 1] < 0)
                                 | (rc[:, 1] >= width))
    points[outside] = -1.0
    return points


def get_dist_maps_native(points: np.ndarray, height: int, width: int,
                         norm_delimeter: float) -> np.ndarray:
    """points [n, 2] float (row, col; <0 = absent) -> [2, H, W] float32 of
    min squared normalized distances (pos layer, neg layer). BFS semantics;
    clicks outside the image count as absent (inside_points)."""
    points = np.ascontiguousarray(inside_points(points, height, width))
    out = np.empty((2, height, width), np.float32)
    load_native().get_dist_maps(
        points.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        points.shape[0], height, width, ctypes.c_float(norm_delimeter),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def encode_dist(d: np.ndarray) -> np.ndarray:
    """Final encoding tanh(2*sqrt(d)) (reference ops.py:80)."""
    return np.tanh(2.0 * np.sqrt(d))


def dist_maps_torch(points, height: int, width: int, norm_radius: float,
                    spatial_scale: float = 1.0, device='cpu') -> torch.Tensor:
    """Exact-euclidean tensor path (reference ops.py:54-80).

    points [n, 2] (first half positive, second half negative; <0 = absent).
    Returns [2, H, W] float32 = tanh(2*sqrt(min_d)) on `device`.
    """
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    n = pts.shape[0]
    rr = torch.arange(height, dtype=torch.float32, device=device)[:, None,
                                                                   None]
    cc = torch.arange(width, dtype=torch.float32, device=device)[None, :,
                                                                  None]
    pr = pts[:, 0][None, None, :] * spatial_scale
    pc = pts[:, 1][None, None, :] * spatial_scale
    denom = norm_radius * spatial_scale
    d = ((rr - pr) / denom) ** 2 + ((cc - pc) / denom) ** 2   # [H, W, n]
    invalid = torch.amax(pts, dim=1) < 0
    d = torch.where(invalid[None, None, :], 1e6, d)
    half = n // 2
    pos = torch.amin(d[..., :half], dim=-1)
    neg = torch.amin(d[..., half:], dim=-1)
    return torch.tanh(2.0 * torch.sqrt(torch.stack([pos, neg], dim=0)))


# ---------------------------------------------------------------------------
# click bookkeeping (reference fbrs/inference/clicker.py)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Click:
    is_positive: bool
    coords: Tuple[int, int]  # (row, col)


def clicks_to_points(clicks: List[Click],
                     max_clicks: Optional[int] = None) -> np.ndarray:
    """Pack clicks into the [n, 2] points layout the dist-map encoders
    expect: positives first, then negatives, padded with -1."""
    pos = [c.coords for c in clicks if c.is_positive]
    neg = [c.coords for c in clicks if not c.is_positive]
    half = max_clicks if max_clicks is not None \
        else max(len(pos), len(neg), 1)
    pts = np.full((2 * half, 2), -1.0, np.float32)
    for i, (r, c) in enumerate(pos[:half]):
        pts[i] = (r, c)
    for i, (r, c) in enumerate(neg[:half]):
        pts[half + i] = (r, c)
    return pts


class Clicker:
    def __init__(self):
        self.reset_clicks()

    def reset_clicks(self):
        self.clicks_list: List[Click] = []
        self.num_pos_clicks = 0
        self.num_neg_clicks = 0

    def add_click(self, click: Click):
        if click.is_positive:
            self.num_pos_clicks += 1
        else:
            self.num_neg_clicks += 1
        self.clicks_list.append(click)

    def get_clicks(self, clicks_limit: Optional[int] = None) -> List[Click]:
        return self.clicks_list[:clicks_limit]

    def __len__(self):
        return len(self.clicks_list)

    def get_state(self):
        return list(self.clicks_list)

    def set_state(self, state):
        self.clicks_list = list(state)
        self.num_pos_clicks = sum(c.is_positive for c in state)
        self.num_neg_clicks = len(state) - self.num_pos_clicks

    def to_points(self, clicks_limit: Optional[int] = None,
                  max_clicks: Optional[int] = None) -> np.ndarray:
        return clicks_to_points(self.get_clicks(clicks_limit), max_clicks)
