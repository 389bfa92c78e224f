// Click distance maps via 4-connected BFS (host-side native op).
//
// Equivalent of the reference's Cython kernel
// (inference/interact/fbrs/utils/cython/_get_dist_maps.pyx:17-63): from each
// click, propagate the squared normalized euclidean distance to the click's
// origin through a 4-connected flood fill, keeping the minimum per pixel for
// two layers (positive clicks = first half of the points array, negative =
// second half). BFS is inherently sequential -> CPU is the right home; the
// exact-euclidean tensor formula lives in the JAX path (dist_maps.py).
//
// Build: g++ -O3 -shared -fPIC dist_maps.cpp -o libdistmaps.so

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct QNode {
  int row, col, layer, orig_row, orig_col;
};

}  // namespace

extern "C" {

// points: [n_points * 2] (row, col) floats, < 0 marks an absent click.
// out:    [2 * height * width] floats, prefilled by this function with 1e6.
void get_dist_maps(const float* points, int n_points, int height, int width,
                   float norm_delimeter, float* out) {
  const int plane = height * width;
  for (int i = 0; i < 2 * plane; ++i) out[i] = 1e6f;

  std::vector<QNode> q;
  q.reserve(static_cast<size_t>(4) * plane + 1);

  for (int i = 0; i < n_points; ++i) {
    const int x = static_cast<int>(std::lround(points[2 * i]));
    const int y = static_cast<int>(std::lround(points[2 * i + 1]));
    if (x >= 0) {
      const int layer = (i >= n_points / 2) ? 1 : 0;
      q.push_back({x, y, layer, x, y});
      out[layer * plane + x * width + y] = 0.0f;
    }
  }

  static const int dxy[8] = {-1, 0, 0, -1, 0, 1, 1, 0};
  for (size_t head = 0; head < q.size(); ++head) {
    const QNode v = q[head];
    for (int k = 0; k < 4; ++k) {
      const int x = v.row + dxy[2 * k];
      const int y = v.col + dxy[2 * k + 1];
      if (x < 0 || y < 0 || x >= height || y >= width) continue;
      const float dr = (x - v.orig_row) / norm_delimeter;
      const float dc = (y - v.orig_col) / norm_delimeter;
      const float ndist = dr * dr + dc * dc;
      float* cell = &out[v.layer * plane + x * width + y];
      if (*cell > ndist) {
        *cell = ndist;
        q.push_back({x, y, v.layer, v.orig_row, v.orig_col});
      }
    }
  }
}

}  // extern "C"
