// Fused closest hit for NVIDIA Hopper (sm_90a): (t, idx) of the nearest
// sphere per ray over the whole sphere table, K4 of the port.
//
// Replaces raytracingproject_tpu/ops/pallas/trace.py::_trace_kernel (37-90),
// called through pallas_closest_hit (101, pallas_call at 136). The plain
// PyTorch version of the same scan is closest_hit_fused_twin in
// ops/cuda/trace.py; the hit point, normal and face are rebuilt from (t, idx)
// outside the kernel, in the wrapper.
//
// What bounds it on an H100: FP32 instruction issue, not bytes. A ray reads
// 28 B (origin, direction, time) and writes 8 B (t, idx), while each of its
// N sphere tests is ~25 instructions up to the sign of the discriminant and
// ~15 more (the IEEE square root, both roots, the interval tests, the
// update) where it is positive, without FMA contraction: at 487 spheres
// some 12,000 instructions for 36 bytes. The first design paid all 40 for
// every pair (66.5 SASS instructions a pair with its loads and selects):
// 0.11 ms for 90,000 rays x 487 spheres on an H100 at 700 W, 0.79 of it
// the loop's issue.
//
// What the design does about it:
// - Roots only where the discriminant is positive: the square root, the
//   roots, the interval tests and the update sit under `if (disc > 0)`,
//   which a warp skips when none of its lanes takes it. The 32 rays of a
//   warp are neighbours, and a ray's line meets few of the spheres, so
//   most (warp, sphere) pairs stop after the discriminant. A pair with
//   disc <= 0 never used its roots, so no value changes.
// - The table is staged sphere-major, 8 floats a sphere (cx cy cz mx | my
//   mz radius 0, the (8, N) table's rows), so a sphere is two 16-byte
//   shared-memory loads; every lane of a warp reads the same sphere, a
//   broadcast.
// - Staging overlaps the scan: CHUNK spheres at a time into two buffers
//   filled by cp.async, chunk k + 1 copied while chunk k is scanned, one
//   barrier a chunk. N is unbounded.
// - One ray a thread, 256 a block, as before. Measured against 32-thread
//   blocks with two rays a thread, 64-thread blocks and 128-thread blocks
//   with two rays a thread (which deal 90,000 rays more evenly over the 132
//   SMs: the most loaded SM 1.03x the mean against 1.13x), it was the
//   fastest on an H100: every block stages the table, so small blocks
//   stage it many times over, and a second ray a thread saved less than
//   its registers cost.
// - Built with -fmad=false and without --use_fast_math, in _trace_kernel's
//   operation order, so the result equals the plain version bit for bit;
//   a ray's scan is one thread's ascending strict-`<` loop, as before.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TPB = 256;    // rays per block, one a thread
constexpr int WORDS = 8;    // floats a staged sphere: cx cy cz mx my mz radius 0
constexpr int CHUNK = 256;  // spheres a buffer holds: 8 KB, two buffers

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying chunk k of the (WORDS, n) table into buffer k % 2,
// sphere-major; cp_async_wait_all and a barrier complete it.
__device__ __forceinline__ void stage_chunk(float* buf, const float* __restrict__ sph, int n,
                                            int k) {
  const int c0 = k * CHUNK;
  const int cn = min(CHUNK, n - c0);
  float* dst = buf + (k & 1) * CHUNK * WORDS;
  for (int row = 0; row < WORDS; ++row)
    for (int s = threadIdx.x; s < cn; s += TPB)
      cp_async4(dst + s * WORDS + row, sph + (size_t)row * n + c0 + s);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(TPB)
closest_hit_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                   const float* __restrict__ time, const float* __restrict__ sph,
                   int n_rays, int n_spheres, float t_min,
                   float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ __align__(16) float tab[2 * CHUNK * WORDS];
  const int n_chunks = (n_spheres + CHUNK - 1) / CHUNK;
  stage_chunk(tab, sph, n_spheres, 0);

  const int ray = blockIdx.x * TPB + threadIdx.x;
  const int r = min(ray, n_rays - 1);  // ragged edge: a masked copy
  const float ox = origin[3 * r + 0], oy = origin[3 * r + 1], oz = origin[3 * r + 2];
  const float dx = direction[3 * r + 0], dy = direction[3 * r + 1], dz = direction[3 * r + 2];
  const float tm = time[r];
  const float a = fmaxf(dx * dx + dy * dy + dz * dz, 1e-20f);
  const float inv_a = 1.0f / a;
  float best_t = INFINITY;
  int best_idx = 0;
  cp_async_wait_all();
  __syncthreads();  // chunk 0

  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) stage_chunk(tab, sph, n_spheres, k + 1);  // chunk k - 1 is scanned
    const float4* S = reinterpret_cast<const float4*>(tab + (k & 1) * CHUNK * WORDS);
    const int c0 = k * CHUNK;
    const int cn = min(CHUNK, n_spheres - c0);
#pragma unroll 4
    for (int s = 0; s < cn; ++s) {
      const float4 g0 = S[2 * s], g1 = S[2 * s + 1];  // cx cy cz mx | my mz radius 0
      // moving-sphere centre at this ray's time (src/sphere.h:68-72)
      const float ocx = ox - (g0.x + tm * g0.w);
      const float ocy = oy - (g0.y + tm * g1.x);
      const float ocz = oz - (g0.z + tm * g1.y);
      const float half_b = ocx * dx + ocy * dy + ocz * dz;
      const float cq = ocx * ocx + ocy * ocy + ocz * ocz - g1.z * g1.z;
      const float disc = half_b * half_b - a * cq;
      if (disc > 0.0f) {
        const float sq = sqrtf(disc);
        const float r0 = (-half_b - sq) * inv_a;
        const float r1 = (-half_b + sq) * inv_a;
        const bool in0 = (r0 > t_min) && (r0 < best_t);
        const bool in1 = (r1 > t_min) && (r1 < best_t);
        if (in0 || in1) {
          best_t = in0 ? r0 : r1;
          best_idx = c0 + s;
        }
      }
    }
    if (k + 1 < n_chunks) {
      cp_async_wait_all();
      __syncthreads();  // chunk k + 1 has landed, chunk k is scanned
    }
  }
  if (ray < n_rays) {
    t_out[ray] = best_t;
    idx_out[ray] = best_idx;
  }
}

}  // namespace

extern "C" {

const char* rtp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// origin, direction [n_rays, 3], time [n_rays], sph (8, n_spheres) f32 ->
// t_out [n_rays] f32 (inf on a miss), idx_out [n_rays] i32 (0 on a miss).
int rtp_closest_hit(const float* origin, const float* direction, const float* time,
                    const float* sph, int n_rays, int n_spheres, float t_min, float* t_out,
                    int* idx_out, void* stream) {
  if (n_rays <= 0 || n_spheres <= 0) return (int)cudaErrorInvalidValue;
  closest_hit_kernel<<<(n_rays + TPB - 1) / TPB, TPB, 0, (cudaStream_t)stream>>>(
      origin, direction, time, sph, n_rays, n_spheres, t_min, t_out, idx_out);
  return (int)cudaGetLastError();
}

// Blocks of closest_hit_kernel one SM holds, and the threads (rays) of a
// block: the deal, printed beside the kernel's time.
int rtp_closest_hit_occupancy(int* blocks_per_sm, int* threads) {
  *threads = TPB;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, closest_hit_kernel,
                                                            TPB, 0);
}

}  // extern "C"
