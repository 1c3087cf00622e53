// Native host-side data-loader kernels of caster_dta_torch (a copy of the JAX
// package's csrc/caster_host.cpp, kept in the port so it builds on its own).
//
// The reference's featurization materializes dense n*n edge-feature tensors
// and filters them afterwards (utils/create_protein_features.py:201-357,
// utils/create_graphs.py:6-62) — ~1.9 GB of temporaries for a 3,000-residue
// protein. These kernels fuse threshold + featurize and emit the surviving
// COO edges directly, multithreaded, matching the Python path's numerics
// (scipy pdist computes in double; direction vectors stay float32 like the
// numpy path).
//
// Built as a plain shared library with a C interface (no pybind11); loaded from
// Python via ctypes (caster_dta_torch/native/host.py).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

constexpr int kRBF = 16;
constexpr int kPos = 16;  // 8 cos + 8 sin
constexpr int kEdgeS = kRBF + kPos;  // 32 scalar features per edge
constexpr double kDMax = 20.0;
constexpr double kDStep = kDMax / kRBF;         // 1.25 (create_protein_features.py:233-236)
constexpr double kMuStep = kDMax / (kRBF - 1);  // linspace(0, 20, 16) spacing

inline double dist3(const float* a, const float* b) {
  const double dx = double(a[0]) - double(b[0]);
  const double dy = double(a[1]) - double(b[1]);
  const double dz = double(a[2]) - double(b[2]);
  return std::sqrt(dx * dx + dy * dy + dz * dz);
}

inline void write_edge_feats(const float* alpha, int64_t i, int64_t j,
                             double d, float* es, float* ev) {
  // 16 Gaussian RBFs of CA distance (double precision like scipy pdist)
  for (int k = 0; k < kRBF; ++k) {
    const double z = (d - k * kMuStep) / kDStep;
    es[k] = float(std::exp(-z * z));
  }
  // signed sequence-offset sinusoidal encoding, n_embeds=16 -> 8 cos + 8 sin
  const double off = double(j - i);
  for (int k = 0; k < 8; ++k) {
    const double freq = std::exp(2.0 * k * -(std::log(10000.0) / 8.0));
    es[kRBF + k] = float(std::cos(off * freq));
    es[kRBF + 8 + k] = float(std::sin(off * freq));
  }
  // unit direction alpha_i - alpha_j in float32 (numpy path stays f32)
  const float dx = alpha[3 * i] - alpha[3 * j];
  const float dy = alpha[3 * i + 1] - alpha[3 * j + 1];
  const float dz = alpha[3 * i + 2] - alpha[3 * j + 2];
  const float nrm = std::sqrt(dx * dx + dy * dy + dz * dz);
  if (nrm != 0.0f) {
    ev[0] = dx / nrm; ev[1] = dy / nrm; ev[2] = dz / nrm;
  } else {
    ev[0] = ev[1] = ev[2] = 0.0f;
  }
}

void parallel_rows(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int n_threads = std::max(1u, std::min(hw, 16u));
  if (n < 256) n_threads = 1;
  std::vector<std::thread> ts;
  const int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back(fn, lo, hi);
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Fused protein-residue edge construction + featurization.
//
// alpha: [n, 3] float32 CA coordinates.
// mode: 0 = 'dist' (keep d <= thresh), 1 = 'num' (k = int(thresh) nearest),
//       2 = 'prop' (k = ceil(thresh * n) nearest)
//       (reference create_protein_features.py:293-327 semantics).
// keep_self: include the i == j self-loop edge.
// Emission order is row-major (src ascending, dst ascending within a row) —
// identical to np.nonzero on the dense keep mask, so downstream stable sort
// by dst reproduces the Python pipeline's edge order exactly.
//
// Returns the edge count E. If E > cap, nothing is written (call once with
// cap = 0 to size buffers). Outputs: src/dst int32 [E], edge_s float32
// [E, 32], edge_v float32 [E, 3].
int64_t cdt_protein_edges(const float* alpha, int64_t n, double thresh,
                          int mode, int keep_self, int32_t* src, int32_t* dst,
                          float* edge_s, float* edge_v, int64_t cap) {
  if (n <= 0) return 0;
  int64_t k = 0;
  if (mode == 1) k = int64_t(thresh);
  if (mode == 2) k = int64_t(std::ceil(thresh * double(n)));
  k = std::min(k, n);

  // pass 1: per-row survivor count (and kNN selections for mode 1/2)
  std::vector<int64_t> row_count(n, 0);
  std::vector<std::vector<int32_t>> knn_sel;
  if (mode != 0) knn_sel.resize(n);

  parallel_rows(n, [&](int64_t lo, int64_t hi) {
    std::vector<std::pair<double, int32_t>> ds;
    for (int64_t i = lo; i < hi; ++i) {
      if (mode == 0) {
        int64_t c = 0;
        for (int64_t j = 0; j < n; ++j) {
          if (j == i && !keep_self) continue;
          if (dist3(alpha + 3 * i, alpha + 3 * j) <= thresh) ++c;
        }
        row_count[i] = c;
      } else {
        ds.clear();
        for (int64_t j = 0; j < n; ++j) {
          if (j == i && !keep_self) continue;  // NaN dist sorts last in numpy
          ds.emplace_back(dist3(alpha + 3 * i, alpha + 3 * j), int32_t(j));
        }
        const int64_t kk = std::min<int64_t>(k, ds.size());
        std::partial_sort(ds.begin(), ds.begin() + kk, ds.end());
        auto& sel = knn_sel[i];
        sel.reserve(kk);
        for (int64_t t = 0; t < kk; ++t) sel.push_back(ds[t].second);
        std::sort(sel.begin(), sel.end());  // row-major dst ascending
        row_count[i] = kk;
      }
    }
  });

  std::vector<int64_t> offs(n + 1, 0);
  for (int64_t i = 0; i < n; ++i) offs[i + 1] = offs[i] + row_count[i];
  const int64_t total = offs[n];
  if (total > cap) return total;

  // pass 2: fill
  parallel_rows(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t w = offs[i];
      if (mode == 0) {
        for (int64_t j = 0; j < n; ++j) {
          if (j == i && !keep_self) continue;
          const double d = dist3(alpha + 3 * i, alpha + 3 * j);
          if (d <= thresh) {
            src[w] = int32_t(i);
            dst[w] = int32_t(j);
            write_edge_feats(alpha, i, j, d, edge_s + kEdgeS * w, edge_v + 3 * w);
            ++w;
          }
        }
      } else {
        for (int32_t j : knn_sel[i]) {
          const double d = dist3(alpha + 3 * i, alpha + 3 * j);
          src[w] = int32_t(i);
          dst[w] = int32_t(j);
          write_edge_feats(alpha, i, j, d, edge_s + kEdgeS * w, edge_v + 3 * w);
          ++w;
        }
      }
    }
  });
  return total;
}

// Edge packing: stable sort by dst and scatter features into padded buffers.
// Replaces the numpy argsort+fancy-index in data/graphs.py pad_graph for the
// preprocessing pool hot path. perm_out receives the stable-by-dst edge
// permutation (length e). Returns 0.
int64_t cdt_sort_edges_by_dst(const int32_t* dst, int64_t e, int32_t* perm_out) {
  std::vector<int32_t> idx(e);
  for (int64_t i = 0; i < e; ++i) idx[i] = int32_t(i);
  std::stable_sort(idx.begin(), idx.end(),
                   [&](int32_t a, int32_t b) { return dst[a] < dst[b]; });
  std::memcpy(perm_out, idx.data(), sizeof(int32_t) * e);
  return 0;
}

}  // extern "C"
