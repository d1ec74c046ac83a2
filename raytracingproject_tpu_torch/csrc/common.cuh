// Device code shared by the path-tracing megakernel (megakernel.cu) and the
// probe kernels (probes.cu): the sphere table's rows, the closest hit's
// carries, the ray and the slab test, one definition. Each source holds
// its own sphere test over its own staged layout, every one in the
// reference quadratic's operation order with the roots only where the
// discriminant is positive: `sphere_test_roots` and its global-memory
// kinds in megakernel.cu, `test_sphere` in probes.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ InvDir inv_dir(const Ray& r) {
  InvDir inv;
  inv.x = 1.0f / (fabsf(r.dx) > 1e-20f ? r.dx : 1e-20f);
  inv.y = 1.0f / (fabsf(r.dy) > 1e-20f ? r.dy : 1e-20f);
  inv.z = 1.0f / (fabsf(r.dz) > 1e-20f ? r.dz : 1e-20f);
  return inv;
}

}  // namespace
