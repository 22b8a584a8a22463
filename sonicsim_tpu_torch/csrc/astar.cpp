// A* on an occupancy grid and string-pulling path simplification, for
// sonicsim_tpu_torch.sim.geometry.NavGrid.find_path (the navmesh
// pathfinder's replacement, SonicSim_rir.py:1064-1080).
//
// The JAX package's pathfinder (sonicsim_tpu/_native_src/sonicsim_native.cpp)
// computes these functions, and its paths on grids with obstacles depend
// on how A* breaks ties between equal-cost cells: here std::priority_queue's
// order, as there, so the two packages give the same trajectories.
//
// Plain C ABI for ctypes; built with g++ at first use (sim/native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct Node {
  double f;
  int idx;
  bool operator<(const Node& o) const { return f > o.f; }  // min-heap
};

inline bool los(const uint8_t* occ, int nx, int nz, int ai, int aj, int bi,
                int bj) {
  const int steps = std::max(std::abs(bi - ai), std::abs(bj - aj)) + 1;
  for (int s = 0; s <= steps; ++s) {
    const double t = steps ? static_cast<double>(s) / steps : 0.0;
    const int i = static_cast<int>(std::lround(ai + (bi - ai) * t));
    const int j = static_cast<int>(std::lround(aj + (bj - aj) * t));
    if (i < 0 || i >= nx || j < 0 || j >= nz || !occ[i * nz + j]) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// A* (8-connected) on an occupancy grid. occ[nx*nz] nonzero = navigable.
// Writes up to max_len (i, j) pairs into `path`; returns the number of
// waypoints, or -1 if unreachable.
int astar(const uint8_t* occ, int nx, int nz, int si, int sj, int gi, int gj,
          int* path, int max_len) {
  if (si < 0 || si >= nx || sj < 0 || sj >= nz || !occ[si * nz + sj]) return -1;
  if (gi < 0 || gi >= nx || gj < 0 || gj >= nz || !occ[gi * nz + gj]) return -1;
  const int total = nx * nz;
  std::vector<double> cost(total, 1e30);
  std::vector<int> came(total, -1);
  const int start = si * nz + sj, goal = gi * nz + gj;
  std::priority_queue<Node> pq;
  cost[start] = 0.0;
  pq.push({0.0, start});
  const int di[8] = {1, -1, 0, 0, 1, 1, -1, -1};
  const int dj[8] = {0, 0, 1, -1, 1, -1, 1, -1};
  const double dw[8] = {1, 1, 1, 1, 1.41421356, 1.41421356, 1.41421356,
                        1.41421356};
  bool found = false;
  while (!pq.empty()) {
    const Node top = pq.top();
    pq.pop();
    if (top.idx == goal) {
      found = true;
      break;
    }
    const int ci = top.idx / nz, cj = top.idx % nz;
    if (top.f > cost[top.idx] + std::hypot(gi - ci, gj - cj) + 1e-9) continue;
    for (int k = 0; k < 8; ++k) {
      const int ni = ci + di[k], nj = cj + dj[k];
      if (ni < 0 || ni >= nx || nj < 0 || nj >= nz) continue;
      const int nidx = ni * nz + nj;
      if (!occ[nidx]) continue;
      const double nc = cost[top.idx] + dw[k];
      if (nc < cost[nidx]) {
        cost[nidx] = nc;
        came[nidx] = top.idx;
        pq.push({nc + std::hypot(gi - ni, gj - nj), nidx});
      }
    }
  }
  if (!found) return -1;
  std::vector<int> cells;
  for (int cur = goal; cur != -1; cur = came[cur]) cells.push_back(cur);
  int n = static_cast<int>(cells.size());
  if (n > max_len) n = max_len;
  for (int i = 0; i < n; ++i) {
    const int cell = cells[cells.size() - 1 - i];
    path[2 * i] = cell / nz;
    path[2 * i + 1] = cell % nz;
  }
  return n;
}

// String-pulling simplification; rewrites `path` in place, returns new count.
int simplify_path(const uint8_t* occ, int nx, int nz, int* path, int n) {
  if (n <= 2) return n;
  std::vector<int> out;
  out.push_back(0);
  int anchor = 0;
  for (int k = 2; k < n; ++k) {
    if (!los(occ, nx, nz, path[2 * anchor], path[2 * anchor + 1], path[2 * k],
             path[2 * k + 1])) {
      out.push_back(k - 1);
      anchor = k - 1;
    }
  }
  out.push_back(n - 1);
  std::vector<int> buf(out.size() * 2);
  for (size_t i = 0; i < out.size(); ++i) {
    buf[2 * i] = path[2 * out[i]];
    buf[2 * i + 1] = path[2 * out[i] + 1];
  }
  std::memcpy(path, buf.data(), buf.size() * sizeof(int));
  return static_cast<int>(out.size());
}

}  // extern "C"
