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
// N sphere tests is 66.5 instructions without FMA contraction (the
// SASS nvcc emits for sm_90a, the loop unrolled twice), the IEEE square root among
// them: at 487 spheres that is over 30,000 instructions for 36 bytes.
// Measured on an H100 at 700 W, 90,000 rays x 487 spheres: 0.11 ms, of
// which the loop's instructions at one per lane and cycle are 0.79.
//
// What the design does about it:
// - One thread per ray. The ray, a = max(|d|^2, 1e-20), 1/a, the best t and
//   the best index stay in registers for the whole scan; the sphere loop is
//   innermost. (The TPU kernel has the sphere loop outermost and 32,768 rays
//   in scratch memory to amortise its scalar loads; none of that is needed
//   here, and rays are not padded beyond the last block's mask.)
// - The block stages the 7 used rows of the (8, N) table into shared memory
//   in chunks of CHUNK spheres, so N is unbounded. Every thread of a warp
//   reads the same sphere: a broadcast, no bank conflict.
// - Built with -fmad=false and without --use_fast_math, in _trace_kernel's
//   operation order, so the result equals the plain version bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TPB = 256;     // rays per block
constexpr int ROWS = 7;      // cx cy cz mx my mz radius (row 7 is padding)
constexpr int CHUNK = 1024;  // spheres staged at once: 7 * 1024 * 4 B = 28 KB

__global__ void __launch_bounds__(TPB)
closest_hit_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                   const float* __restrict__ time, const float* __restrict__ sph,
                   int n_rays, int n_spheres, float t_min,
                   float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ float tab[ROWS][CHUNK];
  const int ray = blockIdx.x * TPB + threadIdx.x;
  const bool in_range = ray < n_rays;
  const int r = in_range ? ray : n_rays - 1;  // ragged edge: a masked copy
  const float ox = origin[3 * r + 0], oy = origin[3 * r + 1], oz = origin[3 * r + 2];
  const float dx = direction[3 * r + 0], dy = direction[3 * r + 1], dz = direction[3 * r + 2];
  const float tm = time[r];
  const float a = fmaxf(dx * dx + dy * dy + dz * dz, 1e-20f);
  const float inv_a = 1.0f / a;
  float best_t = INFINITY;
  int best_idx = 0;

  for (int c0 = 0; c0 < n_spheres; c0 += CHUNK) {
    const int cn = min(CHUNK, n_spheres - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int row = 0; row < ROWS; ++row)
      for (int k = threadIdx.x; k < cn; k += TPB)
        tab[row][k] = sph[(size_t)row * n_spheres + c0 + k];
    __syncthreads();
    for (int s = 0; s < cn; ++s) {
      // moving-sphere centre at this ray's time (src/sphere.h:68-72)
      const float ocx = ox - (tab[0][s] + tm * tab[3][s]);
      const float ocy = oy - (tab[1][s] + tm * tab[4][s]);
      const float ocz = oz - (tab[2][s] + tm * tab[5][s]);
      const float rad = tab[6][s];
      const float half_b = ocx * dx + ocy * dy + ocz * dz;
      const float cq = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
      const float disc = half_b * half_b - a * cq;
      const bool dpos = disc > 0.0f;
      const float sq = sqrtf(dpos ? disc : 1.0f);
      const float r0 = (-half_b - sq) * inv_a;
      const float r1 = (-half_b + sq) * inv_a;
      const bool in0 = (r0 > t_min) && (r0 < best_t);
      const bool in1 = (r1 > t_min) && (r1 < best_t);
      const bool better = dpos && (in0 || in1);
      best_t = better ? (in0 ? r0 : r1) : best_t;
      best_idx = better ? c0 + s : best_idx;
    }
  }
  if (in_range) {
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

}  // extern "C"
