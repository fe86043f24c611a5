// Native BVH builder: binned-SAH over triangles, flattened to DFS order
// with miss-links for stackless traversal.
//
// This is the framework's host-side native component — the role C++ plays
// in the reference's host runtime (src/main.cpp, src/data_utils.h) is
// played here by the performance-critical scene preprocessing: BVH builds
// for large meshes are pure pointer-chasing/partitioning work that NumPy
// does poorly.  Contract is identical to the NumPy builder
// (accel/bvh.py:build_bvh_numpy) and cross-checked in tests.
//
// Build: make -C ascendpathtracing_tpu/native   (produces libaptnative.so)
// ABI: plain C, consumed via ctypes (accel/native.py).

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float area(const Vec3 &mn, const Vec3 &mx) {
  float dx = std::max(mx.x - mn.x, 0.f);
  float dy = std::max(mx.y - mn.y, 0.f);
  float dz = std::max(mx.z - mn.z, 0.f);
  return 2.f * (dx * dy + dy * dz + dx * dz);
}

struct BuildTri {
  Vec3 bmin, bmax, cent;
  int32_t id;
};

struct Node {
  Vec3 bmin, bmax;
  int32_t left = -1;   // tree child (pre-flatten)
  int32_t right = -1;
  int32_t first = -1;  // leaf: start into tri order
  int32_t count = 0;   // leaf: #tris
};

struct Builder {
  std::vector<BuildTri> tris;
  std::vector<Node> nodes;
  std::vector<int32_t> order;
  int max_leaf;
  int n_bins;

  int build(int begin, int end) {
    Node node;
    Vec3 bmin = {FLT_MAX, FLT_MAX, FLT_MAX};
    Vec3 bmax = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    Vec3 cmin = bmin, cmax = bmax;
    for (int i = begin; i < end; ++i) {
      bmin = vmin(bmin, tris[i].bmin);
      bmax = vmax(bmax, tris[i].bmax);
      cmin = vmin(cmin, tris[i].cent);
      cmax = vmax(cmax, tris[i].cent);
    }
    node.bmin = bmin;
    node.bmax = bmax;
    int n = end - begin;
    if (n <= max_leaf) {
      node.first = (int32_t)order.size();
      node.count = n;
      for (int i = begin; i < end; ++i) order.push_back(tris[i].id);
      int id = (int)nodes.size();
      nodes.push_back(node);
      return id;
    }

    // binned SAH over 3 axes
    float best_cost = FLT_MAX;
    int best_axis = -1, best_split = -1;
    for (int axis = 0; axis < 3; ++axis) {
      float lo = axis == 0 ? cmin.x : axis == 1 ? cmin.y : cmin.z;
      float hi = axis == 0 ? cmax.x : axis == 1 ? cmax.y : cmax.z;
      float ext = hi - lo;
      if (ext <= 1e-12f) continue;
      std::vector<int> counts(n_bins, 0);
      std::vector<Vec3> bbmin(n_bins, {FLT_MAX, FLT_MAX, FLT_MAX});
      std::vector<Vec3> bbmax(n_bins, {-FLT_MAX, -FLT_MAX, -FLT_MAX});
      for (int i = begin; i < end; ++i) {
        float c = axis == 0 ? tris[i].cent.x : axis == 1 ? tris[i].cent.y : tris[i].cent.z;
        int b = std::min((int)((c - lo) / ext * n_bins), n_bins - 1);
        counts[b]++;
        bbmin[b] = vmin(bbmin[b], tris[i].bmin);
        bbmax[b] = vmax(bbmax[b], tris[i].bmax);
      }
      // sweep
      std::vector<float> rarea(n_bins + 1, 0.f);
      std::vector<int> rcnt(n_bins + 1, 0);
      Vec3 rmn = {FLT_MAX, FLT_MAX, FLT_MAX}, rmx = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      for (int b = n_bins - 1; b >= 1; --b) {
        rmn = vmin(rmn, bbmin[b]);
        rmx = vmax(rmx, bbmax[b]);
        rcnt[b] = rcnt[b + 1] + counts[b];
        rarea[b] = rcnt[b] ? area(rmn, rmx) : 0.f;
      }
      Vec3 lmn = {FLT_MAX, FLT_MAX, FLT_MAX}, lmx = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      int lcnt = 0;
      for (int split = 1; split < n_bins; ++split) {
        lmn = vmin(lmn, bbmin[split - 1]);
        lmx = vmax(lmx, bbmax[split - 1]);
        lcnt += counts[split - 1];
        int rc = rcnt[split];
        if (lcnt == 0 || rc == 0) continue;
        float cost = lcnt * area(lmn, lmx) + rc * rarea[split];
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_split = split;
        }
      }
    }

    int mid;
    if (best_axis < 0) {
      mid = begin + n / 2;  // degenerate: median split
    } else {
      float lo = best_axis == 0 ? cmin.x : best_axis == 1 ? cmin.y : cmin.z;
      float hi = best_axis == 0 ? cmax.x : best_axis == 1 ? cmax.y : cmax.z;
      float ext = hi - lo;
      auto *it = std::partition(
          tris.data() + begin, tris.data() + end, [&](const BuildTri &t) {
            float c = best_axis == 0 ? t.cent.x
                      : best_axis == 1 ? t.cent.y
                                       : t.cent.z;
            int b = std::min((int)((c - lo) / ext * n_bins), n_bins - 1);
            return b < best_split;
          });
      mid = (int)(it - tris.data());
      if (mid == begin || mid == end) mid = begin + n / 2;
    }

    int id = (int)nodes.size();
    nodes.push_back(node);  // placeholder; children patched below
    int l = build(begin, mid);
    int r = build(mid, end);
    nodes[id].left = l;
    nodes[id].right = r;
    return id;
  }
};

// DFS flatten computing miss links.
struct Flattener {
  const std::vector<Node> &nodes;
  float *bmin, *bmax;
  int32_t *first, *count, *miss;
  int32_t cursor = 0;
  int32_t total;

  int32_t flatten(int32_t tree_id, int32_t miss_link) {
    const Node &nd = nodes[tree_id];
    int32_t my = cursor++;
    bmin[my * 3 + 0] = nd.bmin.x;
    bmin[my * 3 + 1] = nd.bmin.y;
    bmin[my * 3 + 2] = nd.bmin.z;
    bmax[my * 3 + 0] = nd.bmax.x;
    bmax[my * 3 + 1] = nd.bmax.y;
    bmax[my * 3 + 2] = nd.bmax.z;
    first[my] = nd.first;
    count[my] = nd.count;
    miss[my] = miss_link;
    if (nd.count == 0) {
      // inner: left child is next in DFS; its miss is the right child.
      int32_t save = cursor;
      (void)save;
      // we need the right child's flattened id — flatten left with a
      // provisional link, but since DFS ids are assigned in order we can
      // compute: right_id = my + 1 + size(left subtree). Easier: flatten
      // left after computing its subtree size via recursion order — do a
      // two-step: remember position, flatten left with placeholder, then
      // patch.
      int32_t left_pos = cursor;
      flatten(nd.left, -2);  // placeholder
      int32_t right_pos = cursor;
      flatten(nd.right, miss_link);
      // patch all -2 placeholders in the left subtree to right_pos
      for (int32_t i = left_pos; i < right_pos; ++i)
        if (miss[i] == -2) miss[i] = right_pos;
    }
    return my;
  }
};

}  // namespace

extern "C" {

// Returns number of nodes, or -1 on error (max_nodes too small).
// tri_verts: [n_tris][3][3] float32 (three vertices per triangle).
int32_t apt_build_bvh(const float *tri_verts, int32_t n_tris,
                      int32_t max_leaf, int32_t n_bins, float *out_bmin,
                      float *out_bmax, int32_t *out_first,
                      int32_t *out_count, int32_t *out_miss,
                      int32_t *out_tri_order, int32_t max_nodes) {
  if (n_tris <= 0) return 0;
  Builder b;
  b.max_leaf = max_leaf;
  b.n_bins = n_bins;
  b.tris.resize(n_tris);
  for (int32_t i = 0; i < n_tris; ++i) {
    const float *v = tri_verts + i * 9;
    Vec3 a = {v[0], v[1], v[2]};
    Vec3 p = {v[3], v[4], v[5]};
    Vec3 q = {v[6], v[7], v[8]};
    BuildTri &t = b.tris[i];
    t.bmin = vmin(vmin(a, p), q);
    t.bmax = vmax(vmax(a, p), q);
    t.cent = {(t.bmin.x + t.bmax.x) * 0.5f, (t.bmin.y + t.bmax.y) * 0.5f,
              (t.bmin.z + t.bmax.z) * 0.5f};
    t.id = i;
  }
  b.order.reserve(n_tris);
  int root = b.build(0, n_tris);
  int32_t m = (int32_t)b.nodes.size();
  if (m > max_nodes) return -1;

  Flattener fl{b.nodes, out_bmin, out_bmax, out_first, out_count, out_miss, 0, m};
  fl.flatten(root, -3);
  for (int32_t i = 0; i < m; ++i) {
    if (out_miss[i] == -3 || out_miss[i] == -2) out_miss[i] = m;
  }
  std::memcpy(out_tri_order, b.order.data(), sizeof(int32_t) * n_tris);
  return m;
}

}  // extern "C"
