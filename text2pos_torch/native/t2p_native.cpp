// Native host-side routines for Text2Pos data preparation (PyTorch port).
//
// The reference delegates its data-prep hot loops to third-party native
// code: Open3D's C++ voxel grid (prepare.py:70-84) and sklearn's Cython
// DBSCAN (descriptions.py:40-54). This library provides first-party C++
// equivalents, loaded via ctypes (text2pos_torch/data/native.py). The NumPy
// versions are their plain twins, reached only when asked for by name.
//
// Built at first use by text2pos_torch/ops/_build.py (host_library):
// g++ -O3 -march=native -std=c++17 -fPIC -shared, into _build/.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Voxel-grid downsampling keeping the FIRST point per voxel, in
// first-occurrence order (matching Open3D trace[0] semantics as used by the
// reference). Returns the number of kept indices written to out_idx.
// ---------------------------------------------------------------------------
int64_t t2p_voxel_downsample(const double* pts, int64_t n, double voxel,
                             int64_t* out_idx) {
    if (n <= 0 || voxel <= 0.0) return 0;

    std::unordered_map<uint64_t, char> seen;
    seen.reserve(static_cast<size_t>(n));
    int64_t kept = 0;
    for (int64_t i = 0; i < n; ++i) {
        // Exact packed key: floor(p / voxel) per axis (identical binning to
        // the NumPy fallback), offset into the non-negative range and
        // packed at 21 bits per axis — collision-free for coordinate
        // magnitudes < 2^20 voxels, far beyond any KITTI360 scene.
        uint64_t key = 0;
        for (int d = 0; d < 3; ++d) {
            int64_t c = static_cast<int64_t>(std::floor(pts[3 * i + d] / voxel))
                        + (1LL << 20);
            key = (key << 21) | (static_cast<uint64_t>(c) & 0x1FFFFFULL);
        }
        auto ins = seen.emplace(key, 1);
        if (ins.second) {
            out_idx[kept++] = i;
        }
    }
    return kept;
}

// ---------------------------------------------------------------------------
// Grid-bucketed DBSCAN. Labels: 0..K-1 clusters, -1 noise. Semantics match
// sklearn DBSCAN(eps, min_samples): core points (>= min_samples neighbors
// incl. self) union within eps; border points adopt a core neighbor's
// cluster.
// ---------------------------------------------------------------------------
namespace {

struct UnionFind {
    std::vector<int64_t> parent;
    explicit UnionFind(int64_t n) : parent(n) {
        for (int64_t i = 0; i < n; ++i) parent[i] = i;
    }
    int64_t find(int64_t x) {
        int64_t root = x;
        while (parent[root] != root) root = parent[root];
        while (parent[x] != root) {
            int64_t next = parent[x];
            parent[x] = root;
            x = next;
        }
        return root;
    }
    void unite(int64_t a, int64_t b) {
        int64_t ra = find(a), rb = find(b);
        if (ra != rb) parent[rb] = ra;
    }
};

inline uint64_t cell_key(int64_t cx, int64_t cy, int64_t cz) {
    uint64_t key = 1469598103934665603ULL;
    key = key * 0x100000001b3ULL ^ static_cast<uint64_t>(cx + (1 << 20));
    key = key * 0x100000001b3ULL ^ static_cast<uint64_t>(cy + (1 << 20));
    key = key * 0x100000001b3ULL ^ static_cast<uint64_t>(cz + (1 << 20));
    return key;
}

}  // namespace

void t2p_dbscan(const double* pts, int64_t n, double eps, int32_t min_samples,
                int64_t* labels) {
    if (n <= 0) return;
    const double eps2 = eps * eps;

    std::vector<int64_t> cx(n), cy(n), cz(n);
    std::unordered_map<uint64_t, std::vector<int64_t>> buckets;
    buckets.reserve(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) {
        cx[i] = static_cast<int64_t>(std::floor(pts[3 * i + 0] / eps));
        cy[i] = static_cast<int64_t>(std::floor(pts[3 * i + 1] / eps));
        cz[i] = static_cast<int64_t>(std::floor(pts[3 * i + 2] / eps));
        buckets[cell_key(cx[i], cy[i], cz[i])].push_back(i);
    }

    auto for_neighbors = [&](int64_t i, auto&& fn) {
        for (int64_t dx = -1; dx <= 1; ++dx)
            for (int64_t dy = -1; dy <= 1; ++dy)
                for (int64_t dz = -1; dz <= 1; ++dz) {
                    auto it = buckets.find(
                        cell_key(cx[i] + dx, cy[i] + dy, cz[i] + dz));
                    if (it == buckets.end()) continue;
                    for (int64_t j : it->second) {
                        double ddx = pts[3 * i] - pts[3 * j];
                        double ddy = pts[3 * i + 1] - pts[3 * j + 1];
                        double ddz = pts[3 * i + 2] - pts[3 * j + 2];
                        if (ddx * ddx + ddy * ddy + ddz * ddz <= eps2) fn(j);
                    }
                }
    };

    std::vector<int32_t> neighbor_count(n, 0);
    for (int64_t i = 0; i < n; ++i) {
        int32_t count = 0;
        for_neighbors(i, [&](int64_t) { ++count; });
        neighbor_count[i] = count;
    }

    std::vector<char> core(n, 0);
    for (int64_t i = 0; i < n; ++i) core[i] = neighbor_count[i] >= min_samples;

    UnionFind uf(n);
    for (int64_t i = 0; i < n; ++i) {
        if (!core[i]) continue;
        for_neighbors(i, [&](int64_t j) {
            if (core[j]) uf.unite(i, j);
        });
    }

    std::unordered_map<int64_t, int64_t> root_to_label;
    for (int64_t i = 0; i < n; ++i) labels[i] = -1;
    for (int64_t i = 0; i < n; ++i) {
        if (!core[i]) continue;
        int64_t root = uf.find(i);
        auto it = root_to_label.find(root);
        if (it == root_to_label.end()) {
            int64_t lab = static_cast<int64_t>(root_to_label.size());
            root_to_label.emplace(root, lab);
            labels[i] = lab;
        } else {
            labels[i] = it->second;
        }
    }
    // Border points adopt any core neighbor's cluster.
    for (int64_t i = 0; i < n; ++i) {
        if (labels[i] != -1) continue;
        int64_t adopted = -1;
        for_neighbors(i, [&](int64_t j) {
            if (adopted == -1 && core[j]) adopted = labels[uf.find(j)];
        });
        labels[i] = adopted;
    }
}

// ---------------------------------------------------------------------------
// Farthest-point sampling on the host (used by offline bank building when
// deterministic subsets are preferred over random choice).
// ---------------------------------------------------------------------------
void t2p_fps(const double* pts, int64_t n, int64_t num_samples,
             int64_t start, int64_t* out_idx) {
    if (n <= 0 || num_samples <= 0) return;
    std::vector<double> min_dist(n, 1e300);
    int64_t last = start;
    out_idx[0] = last;
    for (int64_t s = 1; s < num_samples; ++s) {
        double best = -1.0;
        int64_t best_i = 0;
        const double lx = pts[3 * last], ly = pts[3 * last + 1],
                     lz = pts[3 * last + 2];
        for (int64_t i = 0; i < n; ++i) {
            double dx = pts[3 * i] - lx;
            double dy = pts[3 * i + 1] - ly;
            double dz = pts[3 * i + 2] - lz;
            double d = dx * dx + dy * dy + dz * dz;
            if (d < min_dist[i]) min_dist[i] = d;
            if (min_dist[i] > best) {
                best = min_dist[i];
                best_i = i;
            }
        }
        out_idx[s] = best_i;
        last = best_i;
    }
}

}  // extern "C"
