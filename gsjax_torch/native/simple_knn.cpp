// Exact k-nearest-neighbour mean squared distance for the initial Gaussian
// scales: the port's copy of gsjax/native/simple_knn.cpp, the host-side
// replacement for the reference's CUDA `simple-knn` submodule
// (`simple_knn._C.distCUDA2`, called from scene/gaussian_model.py:134).
//
// The same tree, the same search order and the same float32 sum of the
// neighbour heap as gsjax's, so the results are equal bit for bit. It runs
// once at scene load on the host: an exact KD-tree with multithreaded
// queries. min(k, n - 1) neighbours; a single point gets 0.
//
// Built at first use by gsjax_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -std=c++17 -ffp-contract=off -o lib.so simple_knn.cpp -lpthread
// (-ffp-contract=off: gsjax's build contracts no multiply-add into an FMA
// on x86-64; the flag keeps it so on a host whose g++ would.)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

struct KDTree {
  const float* pts;  // (n, 3)
  std::vector<int32_t> idx;
  // node i covers idx[range]; splits are stored implicitly: the median
  // element of each range is the node point, children are the halves.
  struct Frame {
    int32_t lo, hi;
    int dim;
  };

  explicit KDTree(const float* p, int32_t n) : pts(p), idx(n) {
    for (int32_t i = 0; i < n; ++i) idx[i] = i;
    build(0, n, 0);
  }

  void build(int32_t lo, int32_t hi, int dim) {
    if (hi - lo <= 1) return;
    int32_t mid = (lo + hi) / 2;
    const float* p = pts;
    std::nth_element(
        idx.begin() + lo, idx.begin() + mid, idx.begin() + hi,
        [p, dim](int32_t a, int32_t b) { return p[a * 3 + dim] < p[b * 3 + dim]; });
    build(lo, mid, (dim + 1) % 3);
    build(mid + 1, hi, (dim + 1) % 3);
  }

  // k+1 nearest (including the query point itself when it is in the set).
  // heap holds squared distances, max at heap[0].
  void query(const float* q, int32_t self, int k, float* heap) const {
    for (int i = 0; i < k; ++i) heap[i] = INFINITY;
    search(0, (int32_t)idx.size(), 0, q, self, k, heap);
  }

  void search(int32_t lo, int32_t hi, int dim, const float* q, int32_t self,
              int k, float* heap) const {
    if (hi <= lo) return;
    int32_t mid = (lo + hi) / 2;
    int32_t pi = idx[mid];
    if (pi != self) {
      float dx = q[0] - pts[pi * 3], dy = q[1] - pts[pi * 3 + 1],
            dz = q[2] - pts[pi * 3 + 2];
      float d2 = dx * dx + dy * dy + dz * dz;
      if (d2 < heap[0]) {
        // replace max, sift down (k is tiny: linear is fine)
        heap[0] = d2;
        for (int i = 1; i < k; ++i)
          if (heap[i] > heap[0]) std::swap(heap[0], heap[i]);
      }
    }
    float delta = q[dim] - pts[pi * 3 + dim];
    int ndim = (dim + 1) % 3;
    if (delta < 0) {
      search(lo, mid, ndim, q, self, k, heap);
      if (delta * delta < heap[0]) search(mid + 1, hi, ndim, q, self, k, heap);
    } else {
      search(mid + 1, hi, ndim, q, self, k, heap);
      if (delta * delta < heap[0]) search(lo, mid, ndim, q, self, k, heap);
    }
  }
};

}  // namespace

extern "C" {

// out[i] = mean of squared distances from point i to its k nearest
// neighbors (excluding itself). pts is (n, 3) float32 row-major.
void knn_mean_sq_dist(const float* pts, int32_t n, int32_t k, float* out) {
  if (n <= 1) {
    for (int32_t i = 0; i < n; ++i) out[i] = 0.0f;
    return;
  }
  KDTree tree(pts, n);
  int kk = std::min<int32_t>(k, n - 1);
  unsigned hw = std::thread::hardware_concurrency();
  int n_threads = std::max(1u, std::min(hw, 64u));
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    std::vector<float> heap(kk);
    const int32_t grain = 256;
    for (;;) {
      int32_t begin = next.fetch_add(grain);
      if (begin >= n) break;
      int32_t endi = std::min(begin + grain, n);
      for (int32_t i = begin; i < endi; ++i) {
        tree.query(pts + i * 3, i, kk, heap.data());
        float s = 0.0f;
        for (int j = 0; j < kk; ++j) s += heap[j];
        out[i] = s / kk;
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}
}
