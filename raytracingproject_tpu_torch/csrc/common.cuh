// Device code shared by the path-tracing megakernel (megakernel.cu) and the
// probe kernels (probes.cu): the sphere table's rows, the closest hit's
// carries and the slab test, one definition, so a probe measures the
// instructions the megakernels run. The full sphere test (`sphere_test`,
// the square root and both roots on every pair) and the slab test's warp
// vote (`live_bits`) are the TPU design's, which the probes measure; since
// K3's redesign the megakernels take roots only where a discriminant is
// positive and cull per ray.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int N_ROWS = 16;
constexpr unsigned FULL = 0xffffffffu;

enum {
  ROW_CX, ROW_CY, ROW_CZ, ROW_MX, ROW_MY, ROW_MZ, ROW_RAD, ROW_MAT,
  ROW_AR, ROW_AG, ROW_AB, ROW_FUZZ, ROW_IOR
};

// ---- closest hit ----
struct Hit {
  float bt, hx, hy, hz, hrad, har, hag, hab, hfz, hio;
  int hmat;
};

// The recording kernel's hit also carries the winner column.
struct RecordHit : Hit {
  int hidx;
};

template <bool RECORD> struct HitOf { using type = Hit; };
template <> struct HitOf<true> { using type = RecordHit; };

// The chunked scan's carry: the best t and its column alone; the winner's
// other fields are read once, after the scan.
struct ColumnHit {
  float bt;
  int col;
};

// _hit_init: no hit yet (a recording hit's column is set by its caller).
__device__ __forceinline__ void hit_init(Hit& h) {
  h.bt = __int_as_float(0x7f800000); h.hx = 0.0f; h.hy = 0.0f; h.hz = 0.0f; h.hrad = 1.0f;
  h.hmat = 0; h.har = 0.0f; h.hag = 0.0f; h.hab = 0.0f; h.hfz = 0.0f; h.hio = 1.0f;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, tm, a, inv_a;
};

// _sphere_test_ld: exact reference quadratic (src/sphere.h:30-57), open
// interval (t_min, best_t), moving-sphere centre lerp. H is the carry:
// HitOf<RECORD>'s, or a ColumnHit (idx0 + s is then the winner's column).
template <bool RECORD, class H>
__device__ __forceinline__ void sphere_test(const float* __restrict__ S, int n, int s,
                                            const Ray& r, float t_min, H& h, int idx0 = 0) {
  const float ccx = S[ROW_CX * n + s] + r.tm * S[ROW_MX * n + s];
  const float ccy = S[ROW_CY * n + s] + r.tm * S[ROW_MY * n + s];
  const float ccz = S[ROW_CZ * n + s] + r.tm * S[ROW_MZ * n + s];
  const float rad = S[ROW_RAD * n + s];
  const float ocx = r.ox - ccx, ocy = r.oy - ccy, ocz = r.oz - ccz;
  const float half_b = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  const float cq = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  const float disc = half_b * half_b - r.a * cq;
  const bool dpos = disc > 0.0f;
  const float sq = sqrtf(dpos ? disc : 1.0f);
  const float r0 = (-half_b - sq) * r.inv_a;
  const float r1 = (-half_b + sq) * r.inv_a;
  const bool in0 = (r0 > t_min) && (r0 < h.bt);
  const bool in1 = (r1 > t_min) && (r1 < h.bt);
  if (dpos && (in0 || in1)) {
    h.bt = in0 ? r0 : r1;
    if constexpr (std::is_same<H, ColumnHit>::value) {
      h.col = idx0 + s;
    } else {
      h.hx = ccx; h.hy = ccy; h.hz = ccz;
      h.hrad = rad;
      h.hmat = (int)S[ROW_MAT * n + s];
      if constexpr (RECORD) h.hidx = idx0 + s;
      h.har = S[ROW_AR * n + s]; h.hag = S[ROW_AG * n + s]; h.hab = S[ROW_AB * n + s];
      h.hfz = S[ROW_FUZZ * n + s];
      h.hio = S[ROW_IOR * n + s];
    }
  }
}

struct InvDir { float x, y, z; };

// _slab_factory: does this lane's ray enter box `f` of an (8, n) table
// within (t_min, far]? `far` = +inf for the unclamped stage-1 tests.
__device__ __forceinline__ bool slab(const float* __restrict__ B, int n, int f, const Ray& r,
                                     const InvDir& inv, float t_min, float far) {
  float t0 = (B[0 * n + f] - r.ox) * inv.x;
  float t1 = (B[3 * n + f] - r.ox) * inv.x;
  float tn = fminf(t0, t1);
  float tf = fmaxf(t0, t1);
  t0 = (B[1 * n + f] - r.oy) * inv.y;
  t1 = (B[4 * n + f] - r.oy) * inv.y;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  t0 = (B[2 * n + f] - r.oz) * inv.z;
  t1 = (B[5 * n + f] - r.oz) * inv.z;
  tn = fmaxf(tn, fmaxf(fminf(t0, t1), t_min));
  tf = fminf(tf, fmaxf(t0, t1));
  tf = fminf(tf, far);
  return tf > tn;
}

// Warp-wide "any lane enters box base+k" bits for k < cnt (cnt <= 24).
__device__ __forceinline__ unsigned live_bits(const float* B, int n, int base, int cnt,
                                              const Ray& r, const InvDir& inv, float t_min,
                                              float far) {
  unsigned m = 0u;
  for (int k = 0; k < cnt; ++k)
    if (slab(B, n, base + k, r, inv, t_min, far)) m |= 1u << k;
  return __reduce_or_sync(FULL, m);
}

__device__ __forceinline__ InvDir inv_dir(const Ray& r) {
  InvDir inv;
  inv.x = 1.0f / (fabsf(r.dx) > 1e-20f ? r.dx : 1e-20f);
  inv.y = 1.0f / (fabsf(r.dy) > 1e-20f ? r.dy : 1e-20f);
  inv.z = 1.0f / (fabsf(r.dz) > 1e-20f ? r.dz : 1e-20f);
  return inv;
}

}  // namespace
