// Neighbour queries on a uniform grid hash, for the host-side analytics of
// atom coordinates: the clustering of ensemble_locate's cluster_coord, the
// trajectory chaining of encode_trajectories, the bonds of the lattice graph
// (utils/graphx.py) and find_coord_clusters.
//
// Atom coordinates are near-uniform lattices, the best case for bucketing:
// points are hashed into cells (of edge eps for DBSCAN, sized for O(1)
// points a cell for k-NN), and each query is answered from the cells
// around it. Exposed through a C ABI and loaded with ctypes (no pybind11):
//
//   nn_knn        k nearest neighbours with an optional upper bound
//   nn_ball_csr   all points within r of each query, CSR output
//   nn_pairs      all unique point pairs within r
//   nn_dbscan     DBSCAN labels (noise = -1), sklearn's semantics
//   nn_free       releases a buffer that nn_ball_csr or nn_pairs allocated
//
// The grid hash and the queries are those of the JAX package's
// atomai_tpu/native/neighbors.cpp; this package keeps its own copy, since
// it loads nothing of that package. tests/test_torch_dbscan.py,
// tests/test_torch_vae_tools.py and tests/test_torch_graphx.py hold them
// against plain scipy cKDTree versions and the JAX package's.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <queue>
#include <vector>

namespace {

constexpr int kMaxDim = 3;

struct Grid {
    int dim = 2;
    int n = 0;
    const double* pts = nullptr;
    double cell = 1.0;
    double lo[kMaxDim] = {0, 0, 0};
    int shape[kMaxDim] = {1, 1, 1};
    std::vector<int32_t> start;  // indptr over flattened cells
    std::vector<int32_t> order;  // point ids bucketed by cell

    int64_t ncells() const {
        int64_t c = 1;
        for (int d = 0; d < dim; ++d) c *= shape[d];
        return c;
    }

    int cell_coord(int d, double x) const {
        int c = static_cast<int>(std::floor((x - lo[d]) / cell));
        return std::min(std::max(c, 0), shape[d] - 1);
    }

    int64_t flat(const int* c) const {
        int64_t f = 0;
        for (int d = 0; d < dim; ++d) f = f * shape[d] + c[d];
        return f;
    }
};

// Builds a grid whose cell edge is `cell_hint` when positive, otherwise
// sized so the expected bucket occupancy is O(1). Total cell count is
// capped so pathological extents cannot exhaust memory.
Grid build_grid(int n, int dim, const double* pts, double cell_hint) {
    Grid g;
    g.dim = dim;
    g.n = n;
    g.pts = pts;
    double hi[kMaxDim];
    for (int d = 0; d < dim; ++d) {
        g.lo[d] = std::numeric_limits<double>::infinity();
        hi[d] = -std::numeric_limits<double>::infinity();
    }
    for (int i = 0; i < n; ++i)
        for (int d = 0; d < dim; ++d) {
            double x = pts[i * dim + d];
            g.lo[d] = std::min(g.lo[d], x);
            hi[d] = std::max(hi[d], x);
        }
    double extent = 0.0;
    for (int d = 0; d < dim; ++d) extent = std::max(extent, hi[d] - g.lo[d]);
    double cell = cell_hint;
    if (!(cell > 0.0)) {
        double per_axis = std::pow(std::max(n, 1), 1.0 / dim);
        cell = extent > 0 ? extent / std::max(per_axis, 1.0) : 1.0;
    }
    if (!(cell > 0.0)) cell = 1.0;
    // cap total cells at ~2^22 by coarsening; per-axis sizes and the
    // product are computed in double BEFORE any int cast — a far outlier
    // with a small cell makes the raw ratio exceed both int and int64
    // range (float->int overflow is UB)
    for (;;) {
        double total = 1.0;
        for (int d = 0; d < dim; ++d) {
            double sd = std::floor((hi[d] - g.lo[d]) / cell) + 1.0;
            if (!(sd >= 1.0)) sd = 1.0;
            g.shape[d] = static_cast<int>(std::min(sd, double(1 << 22)));
            total *= sd;
        }
        if (total <= double(int64_t(1) << 22) || n == 0) break;
        cell *= 2.0;
    }
    g.cell = cell;
    // counting sort points into cells
    const int64_t nc = g.ncells();
    g.start.assign(nc + 1, 0);
    std::vector<int32_t> cid(n);
    for (int i = 0; i < n; ++i) {
        int c[kMaxDim];
        for (int d = 0; d < dim; ++d)
            c[d] = g.cell_coord(d, pts[i * dim + d]);
        cid[i] = static_cast<int32_t>(g.flat(c));
        ++g.start[cid[i] + 1];
    }
    for (int64_t i = 0; i < nc; ++i) g.start[i + 1] += g.start[i];
    g.order.resize(n);
    std::vector<int32_t> cursor(g.start.begin(), g.start.end() - 1);
    for (int i = 0; i < n; ++i) g.order[cursor[cid[i]]++] = i;
    return g;
}

inline double sqdist(const double* a, const double* b, int dim) {
    double s = 0.0;
    for (int d = 0; d < dim; ++d) {
        double t = a[d] - b[d];
        s += t * t;
    }
    return s;
}

// Visits every point in cells at Chebyshev ring distance `ring` from the
// query's cell, invoking fn(point_id).
template <typename Fn>
void visit_ring(const Grid& g, const int* qc, int ring, Fn&& fn) {
    int c[kMaxDim];
    int lo[kMaxDim], hi[kMaxDim];
    for (int d = 0; d < g.dim; ++d) {
        lo[d] = std::max(qc[d] - ring, 0);
        hi[d] = std::min(qc[d] + ring, g.shape[d] - 1);
        if (lo[d] > hi[d]) return;
    }
    // iterate the box, skipping the interior (Chebyshev distance < ring)
    auto on_shell = [&](const int* c) {
        for (int d = 0; d < g.dim; ++d)
            if (std::abs(c[d] - qc[d]) == ring) return true;
        return ring == 0;
    };
    if (g.dim == 2) {
        for (c[0] = lo[0]; c[0] <= hi[0]; ++c[0])
            for (c[1] = lo[1]; c[1] <= hi[1]; ++c[1]) {
                if (!on_shell(c)) continue;
                int64_t f = g.flat(c);
                for (int32_t j = g.start[f]; j < g.start[f + 1]; ++j)
                    fn(g.order[j]);
            }
    } else {
        for (c[0] = lo[0]; c[0] <= hi[0]; ++c[0])
            for (c[1] = lo[1]; c[1] <= hi[1]; ++c[1])
                for (c[2] = lo[2]; c[2] <= hi[2]; ++c[2]) {
                    if (!on_shell(c)) continue;
                    int64_t f = g.flat(c);
                    for (int32_t j = g.start[f]; j < g.start[f + 1]; ++j)
                        fn(g.order[j]);
                }
    }
}

template <typename Fn>
void visit_box(const Grid& g, const double* q, double r, Fn&& fn) {
    int lo[kMaxDim], hi[kMaxDim], c[kMaxDim];
    for (int d = 0; d < g.dim; ++d) {
        lo[d] = g.cell_coord(d, q[d] - r);
        hi[d] = g.cell_coord(d, q[d] + r);
    }
    if (g.dim == 2) {
        for (c[0] = lo[0]; c[0] <= hi[0]; ++c[0])
            for (c[1] = lo[1]; c[1] <= hi[1]; ++c[1]) {
                int64_t f = g.flat(c);
                for (int32_t j = g.start[f]; j < g.start[f + 1]; ++j)
                    fn(g.order[j]);
            }
    } else {
        for (c[0] = lo[0]; c[0] <= hi[0]; ++c[0])
            for (c[1] = lo[1]; c[1] <= hi[1]; ++c[1])
                for (c[2] = lo[2]; c[2] <= hi[2]; ++c[2]) {
                    int64_t f = g.flat(c);
                    for (int32_t j = g.start[f]; j < g.start[f + 1]; ++j)
                        fn(g.order[j]);
                }
    }
}

}  // namespace

extern "C" {

// k nearest neighbors of each query among pts, excluding nothing (a query
// that is also a data point returns itself at distance 0, matching
// cKDTree.query). Misses (fewer than k in bound) are reported as
// dist=+inf, idx=n — cKDTree's convention.
void nn_knn(int n, int dim, const double* pts, int nq, const double* q,
            int k, double upper_bound, double* out_d, int32_t* out_i) {
    Grid g = build_grid(n, dim, pts, /*cell_hint=*/0.0);
    const double inf = std::numeric_limits<double>::infinity();
    const double ub2 =
        upper_bound < inf ? upper_bound * upper_bound : inf;
    int max_ring = 0;
    for (int d = 0; d < dim; ++d) max_ring = std::max(max_ring, g.shape[d]);
    for (int iq = 0; iq < nq; ++iq) {
        const double* qp = q + iq * dim;
        int qc[kMaxDim];
        for (int d = 0; d < dim; ++d) qc[d] = g.cell_coord(d, qp[d]);
        // max-heap of the best k (d2, idx)
        std::priority_queue<std::pair<double, int32_t>> best;
        for (int ring = 0; ring <= max_ring; ++ring) {
            // every point in a farther ring is at least this far away
            double ring_min = (ring - 1) * g.cell;
            if (ring > 0 && static_cast<int>(best.size()) == k &&
                best.top().first <= ring_min * ring_min)
                break;
            if (ring > 0 && ring_min * ring_min > ub2) break;
            visit_ring(g, qc, ring, [&](int32_t j) {
                double d2 = sqdist(qp, pts + j * dim, dim);
                if (d2 > ub2) return;
                if (static_cast<int>(best.size()) < k)
                    best.emplace(d2, j);
                else if (d2 < best.top().first) {
                    best.pop();
                    best.emplace(d2, j);
                }
            });
        }
        int m = static_cast<int>(best.size());
        for (int j = m - 1; j >= 0; --j) {
            out_d[iq * k + j] = std::sqrt(best.top().first);
            out_i[iq * k + j] = best.top().second;
            best.pop();
        }
        for (int j = m; j < k; ++j) {
            out_d[iq * k + j] = inf;
            out_i[iq * k + j] = n;  // cKDTree miss convention
        }
    }
}

// All data points within r of each query. CSR output: indptr has nq+1
// entries (allocated by the caller), indices is malloc'd here (release it
// with nn_free). The ids of each query are in ascending order.
void nn_ball_csr(int n, int dim, const double* pts, int nq, const double* q,
                 double r, int64_t* indptr, int32_t** indices_out) {
    Grid g = build_grid(n, dim, pts, r > 0 ? r : 0.0);
    const double r2 = r * r;
    std::vector<int32_t> all;
    all.reserve(static_cast<size_t>(nq) * 8);
    std::vector<int32_t> buf;
    indptr[0] = 0;
    for (int iq = 0; iq < nq; ++iq) {
        const double* qp = q + iq * dim;
        buf.clear();
        visit_box(g, qp, r, [&](int32_t j) {
            if (sqdist(qp, pts + j * dim, dim) <= r2) buf.push_back(j);
        });
        std::sort(buf.begin(), buf.end());
        all.insert(all.end(), buf.begin(), buf.end());
        indptr[iq + 1] = static_cast<int64_t>(all.size());
    }
    auto* out = static_cast<int32_t*>(
        std::malloc(std::max(all.size(), size_t(1)) * sizeof(int32_t)));
    std::memcpy(out, all.data(), all.size() * sizeof(int32_t));
    *indices_out = out;
}

// All unique pairs (i < j) within r, as cKDTree.query_pairs gives them.
// Returns the pair count; *pairs_out is a malloc'd flat [i0,j0,i1,j1,...]
// buffer (release it with nn_free), ascending in i, each i's partners in
// the grid's visiting order.
int64_t nn_pairs(int n, int dim, const double* pts, double r,
                 int32_t** pairs_out) {
    Grid g = build_grid(n, dim, pts, r > 0 ? r : 0.0);
    const double r2 = r * r;
    std::vector<int32_t> pairs;
    for (int i = 0; i < n; ++i) {
        const double* p = pts + i * dim;
        visit_box(g, p, r, [&](int32_t j) {
            if (j > i && sqdist(p, pts + j * dim, dim) <= r2) {
                pairs.push_back(i);
                pairs.push_back(j);
            }
        });
    }
    auto* out = static_cast<int32_t*>(
        std::malloc(std::max(pairs.size(), size_t(1)) * sizeof(int32_t)));
    std::memcpy(out, pairs.data(), pairs.size() * sizeof(int32_t));
    *pairs_out = out;
    return static_cast<int64_t>(pairs.size() / 2);
}

// DBSCAN with sklearn's semantics: a core point has >= min_samples
// neighbors within eps (itself included); clusters are BFS components of
// core points; border points adopt the cluster of the first core point
// that reaches them; everything else is noise (-1).
void nn_dbscan(int n, int dim, const double* pts, double eps,
               int min_samples, int32_t* labels) {
    Grid g = build_grid(n, dim, pts, eps > 0 ? eps : 0.0);
    const double eps2 = eps * eps;
    // CSR neighborhoods (eps-balls) for every point
    std::vector<int64_t> indptr(n + 1, 0);
    std::vector<int32_t> indices;
    indices.reserve(static_cast<size_t>(n) * 8);
    std::vector<int32_t> buf;
    for (int i = 0; i < n; ++i) {
        const double* p = pts + i * dim;
        buf.clear();
        visit_box(g, p, eps, [&](int32_t j) {
            if (sqdist(p, pts + j * dim, dim) <= eps2) buf.push_back(j);
        });
        indices.insert(indices.end(), buf.begin(), buf.end());
        indptr[i + 1] = static_cast<int64_t>(indices.size());
    }
    std::vector<char> core(n, 0);
    for (int i = 0; i < n; ++i)
        core[i] = (indptr[i + 1] - indptr[i]) >= min_samples;
    std::fill(labels, labels + n, -1);
    int32_t next = 0;
    std::vector<int32_t> stack;
    for (int i = 0; i < n; ++i) {
        if (!core[i] || labels[i] != -1) continue;
        labels[i] = next;
        stack.assign(1, i);
        while (!stack.empty()) {
            int32_t u = stack.back();
            stack.pop_back();
            if (!core[u]) continue;  // border: labeled but not expanded
            for (int64_t t = indptr[u]; t < indptr[u + 1]; ++t) {
                int32_t v = indices[t];
                if (labels[v] == -1) {
                    labels[v] = next;
                    stack.push_back(v);
                }
            }
        }
        ++next;
    }
}

void nn_free(int32_t* buf) { std::free(buf); }

}  // extern "C"
