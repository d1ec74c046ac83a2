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
// - probe_hit_kernel: the brute closest hit of the megakernels, on the
//   same sphere_test (common.cuh), with the table staged once a block in
//   shared memory and read as broadcasts (the TPU kernels read it from
//   SMEM). VARIANT SLIM carries best t and winner alone (kexp's "slim"; the
//   chunked brute scan's ColumnHit).
//   OUT picks what is written: best t (OUT_T), best t plus a carry times
//   1e-7 (OUT_KEXP: the winner's centre x for FULL, its index for SLIM), or
//   the sum of every carry (OUT_SUM, the mixed peak): a carry left unread
//   lets the compiler drop its selects, and the probe then times less than
//   the closest hit does.
// - probe_front_kernel: kfront's front-culled closest hit, with no stage 1:
//   every word of 24 subtrees is slab-tested (boxes clamped at t_min only,
//   no best-t clamp), the word's bits ORed over the warp with
//   __reduce_or_sync (the TPU packed them with a one-hot matmul), and the
//   live subtrees scanned in ascending order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int PTPB = 256;  // threads per block; the wrappers pad rays to a multiple
constexpr int WORD = 24;   // subtrees a word of the front probe
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

template <int VARIANT, int UNROLL, int OUT>
__global__ void __launch_bounds__(PTPB)
probe_hit_kernel(const float* __restrict__ sph, int n, ProbeRays R, float* __restrict__ out) {
  extern __shared__ float S[];
  for (int q = threadIdx.x; q < N_ROWS * n; q += PTPB) S[q] = sph[q];
  __syncthreads();
  const int i = blockIdx.x * PTPB + threadIdx.x;
  const Ray r = probe_ray<OUT>(R, i);
  const float inf = __int_as_float(0x7f800000);
  const int n_main = n / UNROLL * UNROLL;
  if constexpr (VARIANT == SLIM) {  // _slim_test (tools/kexp.py:40): the chunked scan's carry
    ColumnHit c{inf, 0};
#pragma unroll 1
    for (int q = 0; q < n_main; q += UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) sphere_test<false>(S, n, q + u, r, T_MIN, c);
    }
    for (int s = n_main; s < n; ++s) sphere_test<false>(S, n, s, r, T_MIN, c);
    out[i] = (c.bt < inf ? c.bt : 0.0f) + (float)c.col * 1e-7f;
  } else {
    Hit h;
    hit_init(h);
#pragma unroll 1
    for (int q = 0; q < n_main; q += UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) sphere_test<false>(S, n, q + u, r, T_MIN, h);
    }
    for (int s = n_main; s < n; ++s) sphere_test<false>(S, n, s, r, T_MIN, h);
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

template <int UNROLL>
__global__ void __launch_bounds__(PTPB)
probe_front_kernel(const float* __restrict__ sph, int n_cols, const float* __restrict__ ff,
                   const int* __restrict__ fi, int n_front, ProbeRays R,
                   float* __restrict__ out) {
  extern __shared__ float smem[];
  float* S = smem;
  float* F = S + N_ROWS * n_cols;
  int* I = reinterpret_cast<int*>(F + 8 * n_front);
  for (int q = threadIdx.x; q < N_ROWS * n_cols; q += PTPB) S[q] = sph[q];
  for (int q = threadIdx.x; q < 8 * n_front; q += PTPB) F[q] = ff[q];
  for (int q = threadIdx.x; q < 2 * n_front; q += PTPB) I[q] = fi[q];
  __syncthreads();
  const int i = blockIdx.x * PTPB + threadIdx.x;
  const Ray r = probe_ray<OUT_T>(R, i);
  const InvDir inv = inv_dir(r);
  const float inf = __int_as_float(0x7f800000);
  Hit h;
  hit_init(h);
  for (int w = 0; w < n_front / WORD; ++w) {
    unsigned m = live_bits(F, n_front, w * WORD, WORD, r, inv, T_MIN, inf);
    while (m) {
      const int f = w * WORD + __ffs(m) - 1;
      m &= m - 1u;
      const int start = I[f], cnt = I[n_front + f];
      for (int q = 0; q < cnt / UNROLL; ++q) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          sphere_test<false>(S, n_cols, start + q * UNROLL + u, r, T_MIN, h);
      }
    }
  }
  out[i] = h.bt < inf ? h.bt : 0.0f;
}

template <class... KA, class... A>
int launch_probe(void (*kernel)(KA...), int n_rays, size_t smem, cudaStream_t stream,
                 A... args) {
  if (n_rays <= 0 || n_rays % PTPB != 0) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n_rays / PTPB, PTPB, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int VARIANT, int UNROLL, int OUT>
int launch_hit(const float* sph, int n, const ProbeRays& R, float* out, int n_rays,
               cudaStream_t stream) {
  return launch_probe(probe_hit_kernel<VARIANT, UNROLL, OUT>, n_rays,
                      sizeof(float) * N_ROWS * (size_t)n, stream, sph, n, R, out);
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
  if (n <= 0 || !sph || !ox) return (int)cudaErrorInvalidValue;
  const ProbeRays R{ox, oy, oz, dx, dy, dz, tm};
  const cudaStream_t st = (cudaStream_t)stream;
  if (out_kind == OUT_KEXP && variant == WIDE) {
    if (unroll == 1) return launch_hit<WIDE, 1, OUT_KEXP>(sph, n, R, out, n_rays, st);
    if (unroll == 4) return launch_hit<WIDE, 4, OUT_KEXP>(sph, n, R, out, n_rays, st);
    if (unroll == 8) return launch_hit<WIDE, 8, OUT_KEXP>(sph, n, R, out, n_rays, st);
  } else if (out_kind == OUT_KEXP && variant == SLIM) {
    if (unroll == 1) return launch_hit<SLIM, 1, OUT_KEXP>(sph, n, R, out, n_rays, st);
    if (unroll == 4) return launch_hit<SLIM, 4, OUT_KEXP>(sph, n, R, out, n_rays, st);
    if (unroll == 8) return launch_hit<SLIM, 8, OUT_KEXP>(sph, n, R, out, n_rays, st);
  } else if (variant == WIDE && unroll == 8) {
    if (out_kind == OUT_T) return launch_hit<WIDE, 8, OUT_T>(sph, n, R, out, n_rays, st);
    if (out_kind == OUT_SUM) return launch_hit<WIDE, 8, OUT_SUM>(sph, n, R, out, n_rays, st);
  }
  return (int)cudaErrorInvalidValue;
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
  const size_t smem = sizeof(float) * (N_ROWS * (size_t)n_cols + 10 * (size_t)n_front);
  return launch_probe(probe_front_kernel<8>, n_rays, smem, (cudaStream_t)stream, sph, n_cols,
                      ff, fi, n_front, R, out);
}

}  // extern "C"
