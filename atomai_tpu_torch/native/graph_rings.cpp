// Native ring-finding for lattice graph analysis.
//
// Replicates the semantics of the Python DFS ring search
// (atomai_tpu/utils/graphx.py Graph.find_rings/polycount/
// remove_filled_polygons, reference `atomai/utils/graphx.py:128-233`):
//
// 1. polycount: DFS from every node bounded by max_depth; a path that
//    returns to its root at depth > 2 is recorded as a ring. At depth 2
//    the root is removed from the current node's working neighbor list,
//    and that erasure deliberately PERSISTS across later roots' sweeps —
//    it is what makes each ring be reported exactly once (matching the
//    Python _enumerate_cycles dedup). Do not "restore" the working lists
//    per root: every k-ring would then be found k times.
// 2. remove_filled_polygons: a ring survives only if no pair of its
//    member nodes is connected by a strictly shorter path in the full
//    graph (bounded BFS) than along the ring.
//
// Exported as a C ABI for ctypes; no Python.h dependency.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct Graph {
  int n;
  std::vector<std::vector<int>> nbrs;      // mutable working lists
  std::vector<std::vector<int>> nbrs_copy; // pristine
};

struct RingCollector {
  std::vector<std::vector<int>> rings;
};

void dfs(Graph& g, std::vector<char>& ingraph, std::vector<int>& visited,
         RingCollector& rc, int v, int root, int depth, int max_depth) {
  if (max_depth && depth >= max_depth) return;
  visited.push_back(v);
  depth += 1;
  // iterate over a snapshot: the depth-2 erase below mutates the list
  std::vector<int> nbr_snapshot = g.nbrs[v];
  for (int nb : nbr_snapshot) {
    if (depth > 2 && nb == root) {
      rc.rings.push_back(visited);
    } else if (ingraph[nb]) {
      ingraph[nb] = 0;
      dfs(g, ingraph, visited, rc, nb, root, depth, max_depth);
      ingraph[nb] = 1;
    }
  }
  if (depth == 2) {
    auto& vn = g.nbrs[v];
    vn.erase(std::remove(vn.begin(), vn.end(), root), vn.end());
  }
  visited.pop_back();
}

// shortest path length (#nodes) between a and b using pristine adjacency,
// bounded by max_len nodes; returns 0 if none within bound
int bounded_bfs(const Graph& g, int a, int b, int max_len) {
  if (a == b) return 1;
  std::vector<int> dist(g.n, -1);
  std::queue<int> q;
  dist[a] = 1;
  q.push(a);
  while (!q.empty()) {
    int v = q.front();
    q.pop();
    if (dist[v] >= max_len) continue;
    for (int nb : g.nbrs_copy[v]) {
      if (dist[nb] < 0) {
        dist[nb] = dist[v] + 1;
        if (nb == b) return dist[nb];
        q.push(nb);
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Finds rings. CSR adjacency: indptr (n+1), indices (indptr[n]).
// Output: flat ring node ids + per-ring sizes; caller frees with
// free_buffer. Returns number of rings.
int find_rings_native(int n, const int64_t* indptr, const int32_t* indices,
                      int max_depth, int filter_filled,
                      int32_t** out_flat, int32_t** out_sizes) {
  Graph g;
  g.n = n;
  g.nbrs.resize(n);
  for (int v = 0; v < n; ++v) {
    for (int64_t i = indptr[v]; i < indptr[v + 1]; ++i) {
      g.nbrs[v].push_back(indices[i]);
    }
  }
  g.nbrs_copy = g.nbrs;

  RingCollector rc;
  std::vector<char> ingraph(n, 1);
  std::vector<int> visited;
  for (int v = 0; v < n; ++v) {
    ingraph[v] = 0;  // root marked out-of-graph for its own search
    dfs(g, ingraph, visited, rc, v, v, 0, max_depth);
    ingraph[v] = 1;
  }

  std::vector<std::vector<int>> kept;
  if (filter_filled) {
    for (auto& r : rc.rings) {
      int l = static_cast<int>(r.size());
      bool remove = false;
      for (int j = 0; j < l && !remove; ++j) {
        for (int k = j + 2; k < l && !remove; ++k) {
          int djk = k - j;
          int dist_r = std::min(djk, l - djk) + 1;
          int dist_g = bounded_bfs(g, r[j], r[k], dist_r);
          if (dist_g && dist_g < dist_r) remove = true;
        }
      }
      if (!remove) kept.push_back(r);
    }
  } else {
    kept = rc.rings;
  }

  size_t total = 0;
  for (auto& r : kept) total += r.size();
  int32_t* flat = new int32_t[total ? total : 1];
  int32_t* sizes = new int32_t[kept.size() ? kept.size() : 1];
  size_t off = 0;
  for (size_t i = 0; i < kept.size(); ++i) {
    sizes[i] = static_cast<int32_t>(kept[i].size());
    for (int v : kept[i]) flat[off++] = v;
  }
  *out_flat = flat;
  *out_sizes = sizes;
  return static_cast<int>(kept.size());
}

void free_buffer(int32_t* p) { delete[] p; }

}  // extern "C"
