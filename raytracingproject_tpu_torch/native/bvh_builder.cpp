// Native BVH builder: binned-SAH top-down build, flattened to DFS pre-order
// with miss links (escape pointers) for the stackless TPU traversal in
// ../bvh.py.
//
// Completes the reference's empty bvh_node constructor
// (src/bvh.h:12-14, "To be implemented later") as a native
// component: sphere bounds follow src/sphere.h:9-28 (center +/- r, union of
// endpoint boxes for moving spheres). The output arrays are exactly the
// FlatBVH layout consumed on-device.
//
// Build:  g++ -O3 -shared -fPIC -o libbvh_builder.so bvh_builder.cpp
// ABI:    build_bvh_native(...) returns node count, or -1 on error.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Box {
  float mn[3], mx[3];
  void reset() {
    for (int a = 0; a < 3; ++a) {
      mn[a] = 3.4e38f;
      mx[a] = -3.4e38f;
    }
  }
  void grow(const Box &o) {
    for (int a = 0; a < 3; ++a) {
      mn[a] = std::min(mn[a], o.mn[a]);
      mx[a] = std::max(mx[a], o.mx[a]);
    }
  }
  float half_area() const {
    float dx = std::max(0.0f, mx[0] - mn[0]);
    float dy = std::max(0.0f, mx[1] - mn[1]);
    float dz = std::max(0.0f, mx[2] - mn[2]);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct Builder {
  const float *c0, *cd, *rad;
  int leaf_size;
  std::vector<Box> prim_box;
  std::vector<float> prim_centroid;

  // flat output (DFS pre-order)
  std::vector<float> node_min, node_max;
  std::vector<int32_t> leaf_start, leaf_count, subtree_size;
  std::vector<int32_t> order;

  static constexpr int kBins = 16;

  // Returns subtree size.
  int build(std::vector<int32_t> &ids, int lo, int hi) {
    int me = static_cast<int>(leaf_start.size());
    Box bb;
    bb.reset();
    for (int i = lo; i < hi; ++i) bb.grow(prim_box[ids[i]]);
    node_min.insert(node_min.end(), bb.mn, bb.mn + 3);
    node_max.insert(node_max.end(), bb.mx, bb.mx + 3);
    leaf_start.push_back(0);
    leaf_count.push_back(0);
    subtree_size.push_back(1);

    int n = hi - lo;
    if (n <= leaf_size) {
      leaf_start[me] = static_cast<int32_t>(order.size());
      leaf_count[me] = n;
      for (int i = lo; i < hi; ++i) order.push_back(ids[i]);
      return 1;
    }

    // centroid bounds
    Box cb;
    cb.reset();
    for (int i = lo; i < hi; ++i) {
      const float *c = &prim_centroid[3 * ids[i]];
      for (int a = 0; a < 3; ++a) {
        cb.mn[a] = std::min(cb.mn[a], c[a]);
        cb.mx[a] = std::max(cb.mx[a], c[a]);
      }
    }

    // binned SAH over the widest centroid axis; fall back to median split
    // when centroids are degenerate.
    int axis = 0;
    float ext = -1.0f;
    for (int a = 0; a < 3; ++a) {
      float e = cb.mx[a] - cb.mn[a];
      if (e > ext) {
        ext = e;
        axis = a;
      }
    }

    int mid;
    if (ext <= 1e-12f) {
      mid = lo + n / 2;
      std::nth_element(ids.begin() + lo, ids.begin() + mid, ids.begin() + hi,
                       [&](int32_t x, int32_t y) {
                         return prim_centroid[3 * x + axis] <
                                prim_centroid[3 * y + axis];
                       });
    } else {
      Box bin_box[kBins];
      int bin_cnt[kBins];
      for (int b = 0; b < kBins; ++b) {
        bin_box[b].reset();
        bin_cnt[b] = 0;
      }
      float inv = kBins / ext;
      auto bin_of = [&](int32_t id) {
        int b = static_cast<int>((prim_centroid[3 * id + axis] - cb.mn[axis]) * inv);
        return std::min(std::max(b, 0), kBins - 1);
      };
      for (int i = lo; i < hi; ++i) {
        int b = bin_of(ids[i]);
        bin_box[b].grow(prim_box[ids[i]]);
        ++bin_cnt[b];
      }
      // sweep for best split plane
      Box right_acc[kBins];
      Box acc;
      acc.reset();
      for (int b = kBins - 1; b >= 1; --b) {
        acc.grow(bin_box[b]);
        right_acc[b] = acc;
      }
      acc.reset();
      float best_cost = 3.4e38f;
      int best_split = -1;
      int left_n = 0;
      for (int b = 0; b < kBins - 1; ++b) {
        acc.grow(bin_box[b]);
        left_n += bin_cnt[b];
        int right_n = n - left_n;
        if (left_n == 0 || right_n == 0) continue;
        float cost = acc.half_area() * left_n + right_acc[b + 1].half_area() * right_n;
        if (cost < best_cost) {
          best_cost = cost;
          best_split = b;
        }
      }
      if (best_split < 0) {
        mid = lo + n / 2;
        std::nth_element(ids.begin() + lo, ids.begin() + mid, ids.begin() + hi,
                         [&](int32_t x, int32_t y) {
                           return prim_centroid[3 * x + axis] <
                                  prim_centroid[3 * y + axis];
                         });
      } else {
        auto it = std::partition(ids.begin() + lo, ids.begin() + hi,
                                 [&](int32_t id) { return bin_of(id) <= best_split; });
        mid = static_cast<int>(it - ids.begin());
        if (mid == lo || mid == hi) mid = lo + n / 2;  // safety
      }
    }

    int ls = build(ids, lo, mid);
    int rs = build(ids, mid, hi);
    subtree_size[me] = 1 + ls + rs;
    return subtree_size[me];
  }
};

}  // namespace

extern "C" {

// Returns node count (M), or -1 on error. Output buffers must hold at least
// 2*n nodes (node_min/max: 3*2n floats; links/leaf arrays: 2n int32;
// prim_order: n int32).
int build_bvh_native(int n, const float *center0, const float *center_delta,
                     const float *radius, int leaf_size, float *out_node_min,
                     float *out_node_max, int32_t *out_miss_link,
                     int32_t *out_leaf_start, int32_t *out_leaf_count,
                     int32_t *out_prim_order) {
  if (n <= 0 || leaf_size <= 0) return -1;
  Builder b;
  b.c0 = center0;
  b.cd = center_delta;
  b.rad = radius;
  b.leaf_size = leaf_size;
  b.prim_box.resize(n);
  b.prim_centroid.resize(3 * n);
  for (int i = 0; i < n; ++i) {
    float r = radius[i] < 0 ? -radius[i] : radius[i];
    for (int a = 0; a < 3; ++a) {
      float p0 = center0[3 * i + a];
      float p1 = p0 + center_delta[3 * i + a];
      b.prim_box[i].mn[a] = std::min(p0, p1) - r;
      b.prim_box[i].mx[a] = std::max(p0, p1) + r;
      b.prim_centroid[3 * i + a] =
          0.5f * (b.prim_box[i].mn[a] + b.prim_box[i].mx[a]);
    }
  }
  std::vector<int32_t> ids(n);
  for (int i = 0; i < n; ++i) ids[i] = i;
  b.build(ids, 0, n);

  int m = static_cast<int>(b.leaf_start.size());
  std::memcpy(out_node_min, b.node_min.data(), sizeof(float) * 3 * m);
  std::memcpy(out_node_max, b.node_max.data(), sizeof(float) * 3 * m);
  for (int i = 0; i < m; ++i) {
    int32_t miss = i + b.subtree_size[i];
    out_miss_link[i] = (miss >= m) ? -1 : miss;
  }
  std::memcpy(out_leaf_start, b.leaf_start.data(), sizeof(int32_t) * m);
  std::memcpy(out_leaf_count, b.leaf_count.data(), sizeof(int32_t) * m);
  std::memcpy(out_prim_order, b.order.data(), sizeof(int32_t) * n);
  return m;
}
}
