// Probe kernels for NVIDIA Hopper (sm_90a): measurements of the card itself
// (its FFMA rate) and of the closest hit in isolation, the yardsticks the
// megakernels' bounds and shares are read against.
//
// Replaces the Pallas probes of the JAX package's measurement tools:
//   fma_kernel                           tools/roofline.py:92 (_fma_kernel :68,
//                                        measure_vpu_peak :86)
//   probe_hit_kernel<WIDE, 8, OUT_SUM>   tools/roofline.py:160 (the kernel of
//                                        measure_mixed_peak :109)
//   probe_hit_kernel<WIDE, 8, OUT_T>     tools/kfront.py:210 (_kernel_brute :165)
//   probe_hit_kernel<WIDE | SLIM, 1 | 4 | 8, OUT_KEXP>
//                                        tools/kexp.py:106 (_kernel :65,
//                                        _slim_test :40)
//   probe_front_kernel<8>                tools/kfront.py:191 (_kernel_front :96)
// Their plain PyTorch versions and wrappers live in
// raytracingproject_tpu_torch/probes/.
//
// What bounds them: FP32 issue, by design; each reads its inputs once and
// writes one float a ray or element.
// - fma_kernel: eight independent chains of __fmaf_rn a thread, eight FMAs
//   a chain per iteration and the iteration loop unrolled by four, so the
//   loop body is 256 FFMA instructions against its few loop instructions
//   (the build's -fmad=false cannot split an explicit __fmaf_rn). Eight
//   chains give each warp scheduler eight independent FFMAs in flight
//   against the FFMA latency. The chains' sum is written, so no chain is
//   dead. The result is FFMA instructions a second; FLOP/s is twice that.
// - probe_hit_kernel: the brute closest hit, every ray against every
//   sphere in column order, the reference quadratic (_sphere_test_ld,
//   src/sphere.h:30-57) with a strict `<` (`test_sphere`). The first port
//   staged the whole [16, n] table in shared memory once a block and took
//   the square root and both roots on every pair: at 2,000 spheres its
//   128 KB left one 256-thread block an SM (8 warps of 64) behind the
//   square root's latency, and every pair paid for roots a bound charges
//   only where the discriminant is positive. What the design does:
//   * the table is staged CHUNK spheres at a time into two buffers filled
//     by cp.async, chunk k + 1 copied while chunk k is scanned (K4's
//     staging, closest_hit.cu), so shared memory does not grow with n;
//   * a sphere's test fields (cx cy cz mx | my mz radius -) are two float4
//     planes, so every lane of the warp reads a sphere with two 16-byte
//     broadcasts; VARIANT WIDE also stages the winner's other fields
//     (material ar ag ab | fuzz ior - -) as two more planes of the same
//     chunk and updates its whole carry in the loop, as the megakernels'
//     hit did; VARIANT SLIM carries best t and winner alone (kexp's "slim",
//     the chunked brute scan's ColumnHit) and stages the test planes alone;
//   * the square root, both roots, the interval tests and the update sit
//     under `if (disc > 0)`, which a warp skips when none of its lanes
//     takes it; a pair with disc <= 0 never used its roots, so no value
//     changes;
//   * one ray a thread, 256 a block: two rays a thread (one sphere load
//     feeding both tests, 128-thread blocks) measured 1.14x slower on
//     kfront's brute probe and kexp, 0.98x on the mixed peak (PERF.md).
//   OUT picks what is written: best t (OUT_T), best t plus a carry times
//   1e-7 (OUT_KEXP: the winner's centre x for WIDE, its index for SLIM), or
//   the sum of every carry (OUT_SUM, the mixed peak): a carry left unread
//   lets the compiler drop its selects, and the probe then times less than
//   the closest hit does. UNROLL unrolls the scan of each chunk.
// - probe_front_kernel: kfront's front-culled closest hit, with no stage 1:
//   every word of 24 subtrees is slab-tested (boxes clamped at t_min only,
//   no best-t clamp) and the live subtrees scanned in ascending order. The
//   first port ORed the word's bits over the warp (the TPU packed them with
//   a one-hot matmul), so every lane scanned every subtree any lane
//   entered, and staged the [16, n] table whole (one block an SM at 2,000
//   spheres). What the design does:
//   * culling per ray: each lane tests its own ray against the word's 24
//     boxes (broadcasts) and scans only its own live columns, one flat loop
//     over them (a loop over each live subtree's columns measured up to
//     1.08x slower), UNROLL columns a step (subtree ranges are
//     padded to a multiple of it), so the warp's steps follow the longest
//     of its rays' own lists, not the union of 32 lists; a ray's scan is
//     its own thread's ascending strict-`<` loop, so the first minimum in
//     column order wins and no reduction is needed (every ray is live: K3's
//     lane groups would have G = 1 here);
//   * roots only where the discriminant is positive, as above;
//   * the staged table is the two test planes alone (the probe writes t),
//     32 B a column, beside the boxes and the index; lanes now read
//     different spheres, and a float4 plane puts column c on bank group
//     c mod 8, so a warp's load takes as many shared-memory wavefronts as
//     the most distinct columns of one residue (probes.kfront.bank_waves
//     counts them).
//
// Built with -fmad=false and without --use_fast_math: each probe's output
// equals its plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int PTPB = 256;   // rays per block, one a thread; the wrappers pad rays to a multiple
constexpr int CHUNK = 256;  // spheres a staged chunk of probe_hit_kernel
constexpr int WORD = 24;    // subtrees a word of the front probe
constexpr float T_MIN = 1e-3f;
// the FMA probe's shape (tools/roofline.py CHAINS, INNER, ITERS)
constexpr int CHAINS = 8, INNER = 8, ITERS = 512;

enum Variant { WIDE = 0, SLIM = 1 };  // the full hit carry, or best t and winner
enum Out { OUT_T = 0, OUT_KEXP = 1, OUT_SUM = 2 };

__global__ void __launch_bounds__(PTPB)
fma_kernel(const float* __restrict__ x, float* __restrict__ out, int n) {
  const int i = blockIdx.x * PTPB + threadIdx.x;
  if (i >= n) return;
  const float x0 = x[i];
  float c[CHAINS];
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) c[k] = x0 * (float)(1.0 + 1e-6 * k);
#pragma unroll 4
  for (int it = 0; it < ITERS; ++it) {
#pragma unroll
    for (int j = 0; j < INNER; ++j) {
#pragma unroll
      for (int k = 0; k < CHAINS; ++k) c[k] = __fmaf_rn(c[k], 1.000000119f, 1e-30f);
    }
  }
  float acc = c[0];
#pragma unroll
  for (int k = 1; k < CHAINS; ++k) acc = acc + c[k];
  out[i] = acc;
}

// Ray planes ([n_rays] each); OUT_SUM reads ox alone.
struct ProbeRays {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tm;
};

template <int OUT>
__device__ __forceinline__ Ray probe_ray(const ProbeRays& R, int i) {
  Ray r;
  if constexpr (OUT == OUT_SUM) {  // measure_mixed_peak's synthetic rays (roofline.py:137-146)
    const float ox = R.ox[i];
    r.ox = ox;
    r.oy = ox * 0.5f + 2.0f;
    r.oz = ox * 0.25f + 3.0f;
    r.dx = ox * 1e-3f - 0.9f;
    r.dy = ox * 1e-3f - 0.1f;
    r.dz = ox * 1e-3f - 0.3f;
    r.tm = ox * 0.0f;
    r.a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  } else {
    r.ox = R.ox[i]; r.oy = R.oy[i]; r.oz = R.oz[i];
    r.dx = R.dx[i]; r.dy = R.dy[i]; r.dz = R.dz[i];
    r.tm = R.tm[i];
    r.a = fmaxf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz, 1e-20f);
  }
  r.inv_a = 1.0f / r.a;
  return r;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy columns [c0, c0 + cn) of rows [0, rows) of the [16, n] table `sph`
// into float4 planes of `planes` columns each: row f < 7 to field f, a
// carry row f >= 7 to field f + 1 (field k is plane k / 4, lane k % 4), so
// the test reads planes 0-1 and WIDE's carry planes 2-3. Every thread of
// the block calls it; cp_async_commit and a wait complete it.
__device__ __forceinline__ void stage_planes(float4* dst, int planes, const float* __restrict__ sph,
                                             int n, int c0, int cn, int rows) {
  float* d = reinterpret_cast<float*>(dst);
  for (int row = 0; row < rows; ++row) {
    const int f = row < ROW_MAT ? row : row + 1;
    float* p = d + 4 * (f >> 2) * planes + (f & 3);
    const float* src = sph + (size_t)row * n + c0;
    for (int s = threadIdx.x; s < cn; s += PTPB) cp_async4(p + 4 * s, src + s);
  }
}

// One ray against sphere s of the staged planes P (`planes` columns each,
// g0 = P[s], g1 = P[planes + s] already loaded), column `col`: the
// reference quadratic, then, only where the discriminant is positive, the
// roots and the strict-`<` update of the carry H (Hit: every field, the
// moving centre as the test computed it, the rest from the carry planes;
// ColumnHit: t and column).
template <class H>
__device__ __forceinline__ void test_sphere(const float4* P, int planes, int s, int col,
                                            const float4& g0, const float4& g1, const Ray& r,
                                            H& h) {
  const float ccx = g0.x + r.tm * g0.w;
  const float ccy = g0.y + r.tm * g1.x;
  const float ccz = g0.z + r.tm * g1.y;
  const float rad = g1.z;
  const float ocx = r.ox - ccx, ocy = r.oy - ccy, ocz = r.oz - ccz;
  const float half_b = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  const float cq = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  const float disc = half_b * half_b - r.a * cq;
  if (disc > 0.0f) {
    const float sq = sqrtf(disc);
    const float r0 = (-half_b - sq) * r.inv_a;
    const float r1 = (-half_b + sq) * r.inv_a;
    const bool in0 = (r0 > T_MIN) && (r0 < h.bt);
    const bool in1 = (r1 > T_MIN) && (r1 < h.bt);
    if (in0 || in1) {
      h.bt = in0 ? r0 : r1;
      if constexpr (std::is_same<H, ColumnHit>::value) {
        h.col = col;
      } else {
        const float4 m0 = P[2 * planes + s], m1 = P[3 * planes + s];
        h.hx = ccx; h.hy = ccy; h.hz = ccz;
        h.hrad = rad;
        h.hmat = (int)m0.x;
        h.har = m0.y; h.hag = m0.z; h.hab = m0.w;
        h.hfz = m1.x;
        h.hio = m1.y;
      }
    }
  }
}

template <int VARIANT>
using CarryOf = typename std::conditional<VARIANT == SLIM, ColumnHit, Hit>::type;

template <int VARIANT, int UNROLL, int OUT>
__global__ void __launch_bounds__(PTPB)
probe_hit_kernel(const float* __restrict__ sph, int n, ProbeRays R, float* __restrict__ out) {
  constexpr int PLANES = VARIANT == WIDE ? 4 : 2;  // float4 planes a staged sphere
  constexpr int ROWS = VARIANT == WIDE ? ROW_IOR + 1 : ROW_RAD + 1;
  __shared__ float4 buf[2 * PLANES * CHUNK];
  const int n_chunks = (n + CHUNK - 1) / CHUNK;
  stage_planes(buf, CHUNK, sph, n, 0, min(CHUNK, n), ROWS);
  cp_async_commit();

  const float inf = __int_as_float(0x7f800000);
  const Ray r = probe_ray<OUT>(R, blockIdx.x * PTPB + threadIdx.x);
  CarryOf<VARIANT> h;
  if constexpr (VARIANT == SLIM) {
    h = ColumnHit{inf, 0};
  } else {
    hit_init(h);
  }
  cp_async_wait_all();
  __syncthreads();  // chunk 0

  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) {  // chunk k - 1 is scanned: its buffer takes chunk k + 1
      const int c1 = (k + 1) * CHUNK;
      stage_planes(buf + ((k + 1) & 1) * PLANES * CHUNK, CHUNK, sph, n, c1, min(CHUNK, n - c1),
                   ROWS);
      cp_async_commit();
    }
    const float4* P = buf + (k & 1) * PLANES * CHUNK;
    const int c0 = k * CHUNK;
    const int cn = min(CHUNK, n - c0);
    const int n_main = cn / UNROLL * UNROLL;
#pragma unroll 1
    for (int q = 0; q < n_main; q += UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int s = q + u;
        const float4 g0 = P[s], g1 = P[CHUNK + s];
        test_sphere(P, CHUNK, s, c0 + s, g0, g1, r, h);
      }
    }
    for (int s = n_main; s < cn; ++s) {
      const float4 g0 = P[s], g1 = P[CHUNK + s];
      test_sphere(P, CHUNK, s, c0 + s, g0, g1, r, h);
    }
    if (k + 1 < n_chunks) {
      cp_async_wait_all();
      __syncthreads();  // chunk k + 1 has landed, chunk k is scanned
    }
  }

  // the ray's index again: held across the scan it cost one instruction a
  // pair (measured 2-3% slower)
  const int i = blockIdx.x * PTPB + threadIdx.x;
  if constexpr (VARIANT == SLIM) {
    out[i] = (h.bt < inf ? h.bt : 0.0f) + (float)h.col * 1e-7f;
  } else {
    const float t = h.bt < inf ? h.bt : 0.0f;
    if constexpr (OUT == OUT_T) {
      out[i] = t;
    } else if constexpr (OUT == OUT_KEXP) {
      out[i] = t + h.hx * 1e-7f;
    } else {  // every carry, in the JAX carry's order (the material in its slot)
      out[i] = h.bt + h.hx + h.hy + h.hz + h.hrad + (float)h.hmat + h.har + h.hag + h.hab +
               h.hfz + h.hio;
    }
  }
}

// Shared memory of the front probe: the two test planes of every column,
// the boxes [8, n_front] and the index [2, n_front].
constexpr size_t front_smem_bytes(int n_cols, int n_front) {
  return sizeof(float4) * 2 * (size_t)n_cols + sizeof(float) * 10 * (size_t)n_front;
}

template <int UNROLL>
__global__ void __launch_bounds__(PTPB)
probe_front_kernel(const float* __restrict__ sph, int n_cols, const float* __restrict__ ff,
                   const int* __restrict__ fi, int n_front, ProbeRays R,
                   float* __restrict__ out) {
  extern __shared__ float4 smem[];
  float4* T = smem;                                  // [2][n_cols] test planes
  float* F = reinterpret_cast<float*>(T + 2 * n_cols);  // [8][n_front] boxes
  int* I = reinterpret_cast<int*>(F + 8 * n_front);     // [2][n_front] start, padded count
  const int tid = threadIdx.x;
  stage_planes(T, n_cols, sph, n_cols, 0, n_cols, ROW_RAD + 1);
  for (int q = tid; q < 8 * n_front; q += PTPB) cp_async4(F + q, ff + q);
  for (int q = tid; q < 2 * n_front; q += PTPB)
    cp_async4(reinterpret_cast<float*>(I) + q, reinterpret_cast<const float*>(fi) + q);
  cp_async_commit();
  const int i = blockIdx.x * PTPB + tid;
  const Ray r = probe_ray<OUT_T>(R, i);
  const InvDir inv = inv_dir(r);
  const float inf = __int_as_float(0x7f800000);
  ColumnHit h{inf, 0};
  cp_async_wait_all();
  __syncthreads();

  for (int w = 0; w < n_front / WORD; ++w) {
    const int base = w * WORD;
    unsigned m = 0u;  // this ray's live subtrees of the word
    for (int k = 0; k < WORD; ++k)
      if (slab(F, n_front, base + k, r, inv, T_MIN, inf)) m |= 1u << k;
    int pos = 0, end = 0;  // this lane's place in its live columns
    while (true) {
      while (pos == end && m) {
        const int k = __ffs(m) - 1;
        m &= m - 1u;
        pos = I[base + k];
        end = pos + I[n_front + base + k];
      }
      if (pos == end) break;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int s = pos + u;
        test_sphere(T, n_cols, s, s, T[s], T[n_cols + s], r, h);
      }
      pos += UNROLL;
    }
  }
  out[i] = h.bt < inf ? h.bt : 0.0f;
}

using HitKernel = void (*)(const float*, int, ProbeRays, float*);

// The instantiation of probe_hit_kernel for (variant, unroll, out): kexp's
// six, kfront's brute (WIDE, 8, OUT_T) and the mixed peak (WIDE, 8,
// OUT_SUM); nullptr for any other combination.
HitKernel hit_kernel(int variant, int unroll, int out_kind) {
  if (out_kind == OUT_KEXP && variant == WIDE) {
    if (unroll == 1) return probe_hit_kernel<WIDE, 1, OUT_KEXP>;
    if (unroll == 4) return probe_hit_kernel<WIDE, 4, OUT_KEXP>;
    if (unroll == 8) return probe_hit_kernel<WIDE, 8, OUT_KEXP>;
  } else if (out_kind == OUT_KEXP && variant == SLIM) {
    if (unroll == 1) return probe_hit_kernel<SLIM, 1, OUT_KEXP>;
    if (unroll == 4) return probe_hit_kernel<SLIM, 4, OUT_KEXP>;
    if (unroll == 8) return probe_hit_kernel<SLIM, 8, OUT_KEXP>;
  } else if (variant == WIDE && unroll == 8) {
    if (out_kind == OUT_T) return probe_hit_kernel<WIDE, 8, OUT_T>;
    if (out_kind == OUT_SUM) return probe_hit_kernel<WIDE, 8, OUT_SUM>;
  }
  return nullptr;
}

// Raise a kernel's dynamic shared-memory limit where `smem` needs it.
template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <class... KA, class... A>
int launch_probe(void (*kernel)(KA...), int n_rays, size_t smem, cudaStream_t stream,
                 A... args) {
  if (n_rays <= 0 || n_rays % PTPB != 0) return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<n_rays / PTPB, PTPB, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rtp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The FMA probe on n elements: out[i] = the sum of eight chains of
// 4,096 __fmaf_rn(c, 1.000000119f, 1e-30f) from x[i] * (1 + 1e-6 k).
int rtp_probe_fma(const float* x, float* out, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  fma_kernel<<<(n + PTPB - 1) / PTPB, PTPB, 0, (cudaStream_t)stream>>>(x, out, n);
  return (int)cudaGetLastError();
}

// The brute closest-hit probes over a [16, n] table: variant 0 full, 1 slim;
// unroll 1, 4 or 8; out 0 best t (or 0), 1 kexp's t + carry * 1e-7, 2 the sum
// of every carry over mixed_peak's synthetic rays (ox alone is read). The
// instantiations are kexp's six, kfront's brute (full, 8, t) and the mixed
// peak (full, 8, sum); other combinations are refused.
int rtp_probe_hit(int variant, int unroll, int out_kind, const float* sph, int n,
                  const float* ox, const float* oy, const float* oz, const float* dx,
                  const float* dy, const float* dz, const float* tm, float* out, int n_rays,
                  void* stream) {
  const HitKernel kernel = hit_kernel(variant, unroll, out_kind);
  if (n <= 0 || !sph || !ox || !kernel) return (int)cudaErrorInvalidValue;
  const ProbeRays R{ox, oy, oz, dx, dy, dz, tm};
  return launch_probe(kernel, n_rays, 0, (cudaStream_t)stream, sph, n, R, out);
}

// The front probe: sph [16, n_cols] padded per subtree to a multiple of 8,
// ff [8, n_front] subtree boxes, fi [2, n_front] (start, padded count),
// n_front a multiple of 24.
int rtp_probe_front(const float* sph, int n_cols, const float* ff, const int* fi, int n_front,
                    const float* ox, const float* oy, const float* oz, const float* dx,
                    const float* dy, const float* dz, const float* tm, float* out, int n_rays,
                    void* stream) {
  if (n_cols <= 0 || n_front <= 0 || n_front % WORD != 0) return (int)cudaErrorInvalidValue;
  const ProbeRays R{ox, oy, oz, dx, dy, dz, tm};
  return launch_probe(probe_front_kernel<8>, n_rays, front_smem_bytes(n_cols, n_front),
                      (cudaStream_t)stream, sph, n_cols, ff, fi, n_front, R, out);
}

// Blocks of PTPB threads one SM holds of a probe as its launch gets them:
// the front probe over n_cols columns and n_front subtrees where n_front >
// 0, else the probe_hit_kernel instantiation (variant, unroll, out_kind)
// (its shared memory does not depend on the table).
int rtp_probe_blocks_per_sm(int variant, int unroll, int out_kind, int n_cols, int n_front,
                            int* blocks) {
  if (n_front > 0) {
    const size_t smem = front_smem_bytes(n_cols, n_front);
    const cudaError_t e = allow_smem(probe_front_kernel<8>, smem);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, probe_front_kernel<8>,
                                                              PTPB, smem);
  }
  const HitKernel kernel = hit_kernel(variant, unroll, out_kind);
  if (!kernel) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, PTPB, 0);
}

}  // extern "C"
