// Native host-side runtime for mgf_tpu.
//
// The accelerator owns the compute path (JAX/XLA); this library owns the host-side
// data plumbing around it — the moral equivalent of the reference's native
// containers and builders (Pool/BVH construction, mesh assembly), done as
// cache-friendly C++ over flat arrays and exposed to Python via ctypes:
//
//   * morton_order            — spatial sort keys for body reordering
//                               (broadphase gather locality; replaces the
//                               incremental-BVH locality of bvh.rs)
//   * build_cell_table        — scene-construction-time cell binning of
//                               static mesh faces (mesh.rs push_face + BVH
//                               insert, done once on host)
//   * weld_vertices           — mesh vertex dedup for soup inputs
//   * aabb_tree_build / query — a classic median-split AABB tree over
//                               static triangles for host-side queries
//                               (editor/tooling path; parity with
//                               bvh.rs:125-342 semantics)
//
// Build: g++ -O3 -march=native -shared -fPIC mgf_host.cpp -o libmgf_host.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Morton codes (30-bit, 10 bits/axis) for spatial sorting of bodies.
// ---------------------------------------------------------------------------

static inline uint32_t expand_bits(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

// pos: (n, 3) float32. out_order: (n,) int32 — indices sorted by morton code
// of the position quantized into the scene AABB.
void morton_order(const float* pos, int64_t n, int32_t* out_order) {
  if (n <= 0) return;
  float lo[3] = {pos[0], pos[1], pos[2]};
  float hi[3] = {pos[0], pos[1], pos[2]};
  for (int64_t i = 0; i < n; ++i) {
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], pos[3 * i + k]);
      hi[k] = std::max(hi[k], pos[3 * i + k]);
    }
  }
  std::vector<uint32_t> codes(n);
  for (int64_t i = 0; i < n; ++i) {
    uint32_t c = 0;
    uint32_t xyz[3];
    for (int k = 0; k < 3; ++k) {
      float range = std::max(hi[k] - lo[k], 1e-9f);
      float t = (pos[3 * i + k] - lo[k]) / range;
      xyz[k] = (uint32_t)std::min(std::max(t * 1023.0f, 0.0f), 1023.0f);
    }
    c = (expand_bits(xyz[0]) << 2) | (expand_bits(xyz[1]) << 1) |
        expand_bits(xyz[2]);
    codes[i] = c;
  }
  std::vector<int32_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int32_t a, int32_t b) { return codes[a] < codes[b]; });
  std::memcpy(out_order, order.data(), n * sizeof(int32_t));
}

// ---------------------------------------------------------------------------
// Static face cell table (host-side build of mesh.MeshGrid).
// ---------------------------------------------------------------------------

// verts: (v, 3) f32; faces: (t, 3) i32; table: (dim^3 * cap) i32 pre-filled
// by caller with -1.  Returns the overflow count.
int64_t build_cell_table(const float* verts, int64_t nverts,
                         const int32_t* faces, int64_t nfaces,
                         float cell_size, int32_t dim, int32_t cap,
                         int32_t* table) {
  const int64_t mask = dim - 1;  // dim is a power of two
  std::vector<int32_t> fill((size_t)dim * dim * dim, 0);
  int64_t overflow = 0;
  for (int64_t f = 0; f < nfaces; ++f) {
    float c[3] = {0, 0, 0};
    for (int j = 0; j < 3; ++j) {
      const float* p = verts + 3 * (int64_t)faces[3 * f + j];
      for (int k = 0; k < 3; ++k) c[k] += p[k] / 3.0f;
    }
    int64_t cx = (int64_t)std::floor(c[0] / cell_size) & mask;
    int64_t cy = (int64_t)std::floor(c[1] / cell_size) & mask;
    int64_t cz = (int64_t)std::floor(c[2] / cell_size) & mask;
    int64_t bucket = (cx * dim + cy) * dim + cz;
    int32_t& count = fill[(size_t)bucket];
    if (count < cap) {
      table[bucket * cap + count] = (int32_t)f;
      ++count;
    } else {
      ++overflow;
    }
  }
  return overflow;
}

// ---------------------------------------------------------------------------
// Vertex welding (mesh soup dedup within a tolerance grid).
// ---------------------------------------------------------------------------

// verts: (n,3) f32; out_remap: (n,) i32 mapping old->new index;
// out_verts: (n,3) f32 buffer, first `return value` rows valid.
int64_t weld_vertices(const float* verts, int64_t n, float tol,
                      int32_t* out_remap, float* out_verts) {
  struct Key {
    int64_t x, y, z;
    bool operator<(const Key& o) const {
      if (x != o.x) return x < o.x;
      if (y != o.y) return y < o.y;
      return z < o.z;
    }
  };
  std::vector<std::pair<Key, int64_t>> keys(n);
  const float inv = 1.0f / std::max(tol, 1e-12f);
  for (int64_t i = 0; i < n; ++i) {
    keys[i] = {{(int64_t)std::llround(verts[3 * i + 0] * inv),
                (int64_t)std::llround(verts[3 * i + 1] * inv),
                (int64_t)std::llround(verts[3 * i + 2] * inv)},
               i};
  }
  std::stable_sort(keys.begin(), keys.end(),
                   [](const auto& a, const auto& b) {
                     return a.first < b.first;
                   });
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (i == 0 || keys[i].first < keys[i - 1].first ||
        keys[i - 1].first < keys[i].first) {
      const float* src = verts + 3 * keys[i].second;
      std::memcpy(out_verts + 3 * count, src, 3 * sizeof(float));
      ++count;
    }
    out_remap[keys[i].second] = (int32_t)(count - 1);
  }
  return count;
}

// ---------------------------------------------------------------------------
// Median-split AABB tree over triangles (host-side query/tooling path —
// the bvh.rs:125-342 insert/query equivalent for static meshes).
// Node layout (8 floats + 4 ints per node, flat arrays):
//   bounds: (2n-1, 6) f32 [cx cy cz rx ry rz]
//   children: (2n-1, 2) i32 (-1 leaf), leaf_face: (2n-1,) i32
// ---------------------------------------------------------------------------

struct BuildCtx {
  const float* cent;
  const float* bmin;
  const float* bmax;
  float* bounds;
  int32_t* children;
  int32_t* leaf_face;
  int32_t next_node;
};

static int32_t build_node(BuildCtx& ctx, int32_t* idx, int64_t count) {
  int32_t node = ctx.next_node++;
  float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 0; i < count; ++i) {
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], ctx.bmin[3 * idx[i] + k]);
      hi[k] = std::max(hi[k], ctx.bmax[3 * idx[i] + k]);
    }
  }
  for (int k = 0; k < 3; ++k) {
    ctx.bounds[6 * node + k] = 0.5f * (lo[k] + hi[k]);
    ctx.bounds[6 * node + 3 + k] = 0.5f * (hi[k] - lo[k]);
  }
  if (count == 1) {
    ctx.children[2 * node] = -1;
    ctx.children[2 * node + 1] = -1;
    ctx.leaf_face[node] = idx[0];
    return node;
  }
  int axis = 0;
  float ext[3] = {hi[0] - lo[0], hi[1] - lo[1], hi[2] - lo[2]};
  if (ext[1] > ext[axis]) axis = 1;
  if (ext[2] > ext[axis]) axis = 2;
  int64_t mid = count / 2;
  std::nth_element(idx, idx + mid, idx + count,
                   [&](int32_t a, int32_t b) {
                     return ctx.cent[3 * a + axis] < ctx.cent[3 * b + axis];
                   });
  ctx.leaf_face[node] = -1;
  int32_t l = build_node(ctx, idx, mid);
  int32_t r = build_node(ctx, idx + mid, count - mid);
  ctx.children[2 * node] = l;
  ctx.children[2 * node + 1] = r;
  return node;
}

// Returns number of nodes written (2*nfaces - 1).
int64_t aabb_tree_build(const float* verts, int64_t nverts,
                        const int32_t* faces, int64_t nfaces,
                        float* bounds, int32_t* children,
                        int32_t* leaf_face) {
  if (nfaces <= 0) return 0;
  std::vector<float> cent(3 * nfaces), bmin(3 * nfaces), bmax(3 * nfaces);
  for (int64_t f = 0; f < nfaces; ++f) {
    for (int k = 0; k < 3; ++k) {
      float a = verts[3 * (int64_t)faces[3 * f] + k];
      float b = verts[3 * (int64_t)faces[3 * f + 1] + k];
      float c = verts[3 * (int64_t)faces[3 * f + 2] + k];
      cent[3 * f + k] = (a + b + c) / 3.0f;
      bmin[3 * f + k] = std::min(a, std::min(b, c));
      bmax[3 * f + k] = std::max(a, std::max(b, c));
    }
  }
  std::vector<int32_t> idx(nfaces);
  std::iota(idx.begin(), idx.end(), 0);
  BuildCtx ctx{cent.data(), bmin.data(), bmax.data(),
               bounds,      children,    leaf_face, 0};
  build_node(ctx, idx.data(), nfaces);
  return ctx.next_node;
}

// Overlap query: AABB (c, r) against the tree; out_hits capacity `cap`.
// Returns hit count (clamped to cap).
int64_t aabb_tree_query(const float* bounds, const int32_t* children,
                        const int32_t* leaf_face, int64_t n_nodes,
                        const float* qc, const float* qr, int32_t* out_hits,
                        int64_t cap) {
  if (n_nodes <= 0) return 0;
  std::vector<int32_t> stack;
  stack.push_back(0);
  int64_t count = 0;
  while (!stack.empty()) {
    int32_t node = stack.back();
    stack.pop_back();
    const float* b = bounds + 6 * node;
    bool overlap = true;
    for (int k = 0; k < 3; ++k) {
      if (std::fabs(b[k] - qc[k]) > b[3 + k] + qr[k]) {
        overlap = false;
        break;
      }
    }
    if (!overlap) continue;
    if (children[2 * node] < 0) {
      if (count < cap) out_hits[count] = leaf_face[node];
      ++count;
    } else {
      stack.push_back(children[2 * node]);
      stack.push_back(children[2 * node + 1]);
    }
  }
  return std::min(count, cap);
}

// ---------------------------------------------------------------------------
// f64 sequential-impulse contact solver — the parity ORACLE's inner loop.
//
// Reproduces the reference solver's exact Gauss-Seidel semantics
// (src/solver.rs:203-253): constraints in insertion order, per contact a
// friction phase (both tangent axes from one relative velocity) then a
// normal phase, velocities mutated in place between contacts.  With
// mgf_friction != 0 the RAW tangent lambdas are applied each sweep (the
// reference's broken accumulator clamp, solver.rs:226-227); otherwise the
// textbook clamped-accumulator delta is applied.
// ---------------------------------------------------------------------------

static inline void cross3(const double* a, const double* b, double* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

static inline double dot3(const double* a, const double* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

static inline void matvec3(const double* m, const double* v, double* out) {
  out[0] = m[0] * v[0] + m[1] * v[1] + m[2] * v[2];
  out[1] = m[3] * v[0] + m[4] * v[1] + m[5] * v[2];
  out[2] = m[6] * v[0] + m[7] * v[1] + m[8] * v[2];
}

// v, omega: (M, 3) f64 in/out.  inv_mass: (M,).  inv_moment: (M, 9).
// Contacts (C rows): body_a/body_b index into the M body rows (statics are
// rows with inv_mass = 0 and zero inv_moment).  ra/rb/normal/t1/t2: (C, 3).
// friction/bias/normal_mass/tm1/tm2: (C,).
void solve_contacts_f64(double* v, double* omega, const double* inv_mass,
                        const double* inv_moment, int64_t n_bodies,
                        const int32_t* body_a, const int32_t* body_b,
                        const double* ra, const double* rb,
                        const double* normal, const double* t1,
                        const double* t2, const double* friction,
                        const double* bias, const double* normal_mass,
                        const double* tm1, const double* tm2,
                        int64_t n_contacts, int32_t iters,
                        int32_t mgf_friction) {
  std::vector<double> acc_n(n_contacts, 0.0), acc_t1(n_contacts, 0.0),
      acc_t2(n_contacts, 0.0);
  (void)n_bodies;
  for (int32_t it = 0; it < iters; ++it) {
    for (int64_t c = 0; c < n_contacts; ++c) {
      const int64_t a = body_a[c], b = body_b[c];
      double* va = v + 3 * a;
      double* vb = v + 3 * b;
      double* oa = omega + 3 * a;
      double* ob = omega + 3 * b;
      const double ima = inv_mass[a], imb = inv_mass[b];
      const double* Ia = inv_moment + 9 * a;
      const double* Ib = inv_moment + 9 * b;
      const double* rac = ra + 3 * c;
      const double* rbc = rb + 3 * c;

      auto apply = [&](const double* dir, double lam) {
        double imp[3] = {dir[0] * lam, dir[1] * lam, dir[2] * lam};
        double tq[3], dl[3];
        for (int k = 0; k < 3; ++k) va[k] -= imp[k] * ima;
        cross3(rac, imp, tq);
        matvec3(Ia, tq, dl);
        for (int k = 0; k < 3; ++k) oa[k] -= dl[k];
        for (int k = 0; k < 3; ++k) vb[k] += imp[k] * imb;
        cross3(rbc, imp, tq);
        matvec3(Ib, tq, dl);
        for (int k = 0; k < 3; ++k) ob[k] += dl[k];
      };
      auto rel_vel = [&](double* dv) {
        double wa[3], wb[3];
        cross3(oa, rac, wa);
        cross3(ob, rbc, wb);
        for (int k = 0; k < 3; ++k)
          dv[k] = vb[k] + wb[k] - va[k] - wa[k];
      };

      double dv[3];
      rel_vel(dv);
      double lam1 = -dot3(dv, t1 + 3 * c) * tm1[c];
      double lam2 = -dot3(dv, t2 + 3 * c) * tm2[c];
      double app1, app2;
      if (mgf_friction) {
        app1 = lam1;
        app2 = lam2;
        acc_t1[c] += lam1;
        acc_t2[c] += lam2;
      } else {
        const double max_l = friction[c] * acc_n[c];
        double n1 = std::min(std::max(acc_t1[c] + lam1, -max_l), max_l);
        double n2 = std::min(std::max(acc_t2[c] + lam2, -max_l), max_l);
        app1 = n1 - acc_t1[c];
        app2 = n2 - acc_t2[c];
        acc_t1[c] = n1;
        acc_t2[c] = n2;
      }
      apply(t1 + 3 * c, app1);
      apply(t2 + 3 * c, app2);

      rel_vel(dv);
      const double vn = dot3(dv, normal + 3 * c);
      const double lam = normal_mass[c] * (-vn + bias[c]);
      const double new_acc = std::max(acc_n[c] + lam, 0.0);
      apply(normal + 3 * c, new_acc - acc_n[c]);
      acc_n[c] = new_acc;
    }
  }
}

}  // extern "C"
