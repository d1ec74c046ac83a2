// Path-tracing megakernel for NVIDIA Hopper (sm_90a): the whole bounce loop
// of a ray in one thread, from camera ray to radiance.
//
// Replaces (raytracingproject_tpu/ops/pallas/megakernel.py):
//   K1  _bounce_loop (532-817) with _uniform/_unit_vector/_ball_radius (61-87)
//   K2  _closest_hit_brute (159) + _sphere_test_ld (98), kernel _megakernel (832)
//   K3  _closest_hit_front (335-529) + _slab_factory (273), kernel
//       _megakernel_front (869); all called through pallas_trace_paths (1362).
// The plain PyTorch versions of the same three functions live in
// ops/cuda/megakernel.py; ops/rng.py specifies the random numbers.
//
// What bounds it on an H100: FP32 issue and latency, not memory. Each sphere
// test is ~25 FP32 operations plus one IEEE sqrt on data that every lane of a
// warp reads from the same shared-memory address (a broadcast), and a ray
// reads and writes device memory only at its start and end (28 B in, 12 B
// out). The limits are (a) the number of sphere tests per ray, (b) warps
// that idle because one lane of the warp is still bouncing, and (c) the
// IEEE sqrt/div/transcendentals this build keeps for exact parity.
//
// What the design does about it (K3, closest_hit_front_warp; the brute
// scan, K7 and K8 below):
// - Tables live in dynamic shared memory, staged once per block with
//   16-byte cp.async copies (the padded tables' rows are multiples of 8
//   words); every sphere or box read is a broadcast or conflict-free. Past
//   48 KB the entry point raises the kernel's dynamic shared-memory limit
//   (up to the card's 227 KB: about 3,000 spheres).
// - Culling is per ray, not per warp: ORing each box's slab bits over the
//   warp (a vote, the TPU's tile-wide `any` of _pack_any_bits) would
//   make every lane test every column of every subtree some lane enters,
//   which after a scatter is several times each ray's own columns.
// - Each bounce the warp ballots its L live lanes and gives each live ray a
//   group of G = the largest power of two <= 32 / L lanes (G = 1 while 17
//   or more live), the j-th live lane's ray to group j, its nine fields
//   shuffled from the owner: no list, no barrier and no shared memory
//   beside the tables, so the fronts the budget admits (the routing of
//   render.prepare_scene) are the same as for a kernel without a list.
//   K6's front segment's block-level live list (below) needs 11 KB more,
//   which the largest fronts lack (the forms' times: PERF.md section 6).
// - The group runs K6's front segment's per-ray work (front_group_word):
//   stage 1 (super-word and word boxes) and each of a word's `repack`
//   chunks' subtree boxes on the ray's own masks, dealt over its lanes,
//   each chunk clamped by the group's best t so far; the columns of the
//   chunk's live subtrees in ascending order, dealt over the lanes, with
//   sphere_test_roots (the reference quadratic, the square root and roots
//   only where the discriminant is positive), each lane carrying (t,
//   column) with a strict `<`; then (t, column) reduced lexicographically
//   with shuffles. Per-ray culling with that reduction is exactly the
//   plain version's function (each ray's columns masked by its own slab
//   tests, the first minimum in column order), ties included
//   (tests/test_torch_front_warp_groups.py).
// - The owner lane takes its group's winner with one full-warp shuffle and
//   reads the winner's row once from the staged table.
// - The bounce loop runs while any lane of the warp is alive
//   (`__any_sync`). Dead lanes keep their parked rays (o = 1e18,
//   d = (1,1,1)) and take no part in a group; a block traces 256
//   neighbouring rays, which share subtrees.
// - The winner index is not needed by the forward pass, so the TPU's
//   `mat + 4*idx` fold is dropped; the material is its own register.
// - Built without --use_fast_math and with -fmad=false: IEEE sqrtf, logf,
//   division and no contracted FMAs, so the kernel reproduces its plain
//   PyTorch version on the card ray for ray. A later PR can trade that
//   parity for speed.
//
// K5, the recording kernel (trace_kernel<FRONT, true>), replaces
// pallas_trace_record (megakernel.py:1511, pallas_call at 1637; brute core
// 1599, front core 1568): the same bounce loop, which also stores each
// bounce's path decisions for the path-replay backward (grad/replay.py).
// - What bounds it on an H100, beyond K1's limits: the residual stores,
//   17 B per ray per bounce (idx int32, three direction floats, a refl
//   byte), written for every bounce up to max_depth: a depth-50 train step
//   of 180,000 rays writes 153 MB, against 40 B of ray traffic per ray.
// - What the design does: planes are ray-minor ([max_depth, n_rays]), so
//   the 32 lanes of a warp store one bounce's values to 32 neighbouring
//   addresses (one coalesced transaction per plane); the winner is its own
//   int register, set beside the material in both closest hits (the TPU's
//   f32 `mat + 4*idx` fold avoided a vector spill there and is not needed
//   here); idx, direction and refl bit are stored apart, not packed into
//   one float, so the wrapper decodes nothing but the front's column
//   remap; rows after a warp's last live bounce are filled DEAD in one
//   tight loop after the bounce loop.
// - RECORD=false compiles to the same forward kernels as before K5 was
//   added, instruction for instruction: the residual pointers and the
//   winner live in their own types (RecordParams, RecordHit), because
//   growing Params or Hit alone changed the forward kernels' register
//   allocation.
//
// The brute scan and large scenes (tables past the card's shared memory),
// three more closest hits under the same bounce loop, selected by the MODE
// template argument:
// - CHUNKED, the brute scan (K2; _closest_hit_brute :159 in _megakernel
//   :832 and K5's brute core :1599), for a table of any size: it is every
//   brute scan (forward, K5, record_miss, SCHLICK3, K6's three segments).
//   What bounds it on an H100: sphere tests, ~60 instruction slots
//   each, and the block: staging needs every thread of it, so a bounce
//   runs while any of its 256 rays lives. A one-ray-a-thread scan there
//   made parked rays test every sphere beside the live ones and left a lone
//   ray's 50,000 tests in one thread (186.9 ms a pass of 90,112 rays at
//   depth 16 on 50,000 spheres, 0.059 of its bound, on an NVIDIA H100 80GB
//   HBM3 at 700 W; PERF.md). Where the table fits whole, a whole-table
//   kernel with one ray a thread (K2's first port) ran the cover scene's
//   bench shape in 3.99 ms against this design's 1.08 (same card, PERF.md),
//   and went. What the design does, each bounce:
//   * the block's live rays enter a list in shared memory (a warp ballot,
//     then the 8 warp counts), and the loop runs while the list is not
//     empty (`__syncthreads_count`);
//   * each live ray gets G = the largest power of two <= 256 / L of the
//     block's threads (L live rays): lane g of its group tests columns
//     g, g + G, ... of every chunk in ascending order with
//     sphere_test_roots and strict `<`, the square root and roots only where
//     the discriminant is positive (0.3% of pairs), carrying (t, column)
//     alone; neighbouring lanes read neighbouring columns (no bank
//     conflicts), and a ray's tests are spread over G threads, not 1;
//   * the groups reduce (t, column) lexicographically, least t and on
//     equal t least column (shuffles within a warp, shared memory across
//     warps): what a strict-`<` scan in column order keeps, since a
//     sphere's candidate root does not read the running best, so the
//     result equals the whole-table scan and the plain version's first
//     minimum bit for bit, ties included;
//   * the ray's own thread reads its winner's row from global memory
//     (the moving centre recomputed as sphere_test_roots computes it) and shades
//     as every other mode does;
//   * only the 7 rows the test reads (centre, velocity, radius) are staged,
//     1,024 columns a chunk, into two buffers: cp.async fills chunk k+1
//     while chunk k is scanned, one barrier a chunk;
//   * thread t of block b traces ray t * gridDim.x + b, not 256 neighbours:
//     neighbouring rays live and die together, so blocks of them left some
//     SMs with three long-lived blocks and others idle (the most loaded SM
//     1.43x the mean). Interleaved, every block's live count follows the
//     launch's (1.17x), for 0.68x the time at the one-pass shape (same
//     card; PERF.md). Random numbers are keyed by the ray, so no value
//     moves; the ray's loads and stores no longer coalesce, which costs
//     less.
//   The block size, group size and chunk size are fixed; there is no knob.
// - BVH (K8, replaces _closest_hit_bvh :180 in _megakernel_bvh :850; with
//   RECORD, K5's bvh core :1621; with MISSREC, record_miss): an ordered
//   walk of the tree, one ray a thread. The TPU walks ONE node pointer per
//   1,024-ray tile, in the flat tree's pre-order along miss links, because
//   one scalar pointer served the tile (the reference means an ordered
//   walk, src/bvh.h:16-24). The first port here walked each thread's own
//   pointer the same way: it never entered the nearer child first, so the
//   best t tightened late; every step was a dependent 32-byte node load;
//   every sphere test paid the square root and both roots (2.59 ms a
//   50,000-sphere pass, 0.017 of its bound; PERF.md). What bounds it on an
//   H100: the latency of its dependent loads (node records, then spheres),
//   not arithmetic. What the design does:
//   * node records of the port's own (bvh_tables): an inner node's record
//     holds both children's boxes and references, 64 B, so one step loads
//     and tests two boxes;
//   * the nearer child entered first, the other deferred with its entry t
//     on a 32-entry stack in local memory (bvh_tables raises on a deeper
//     tree); a deferred child entered beyond the best t is dropped when
//     popped: a pass's primary rays take 4.1x fewer dependent steps, and
//     1.6x fewer after one scatter (CPU count, PERF.md);
//   * (t, column) carried lexicographically, the roots only where a
//     discriminant is positive, the winner's record read once after the
//     walk. The miss-link walk keeps the first minimum in column order;
//     so does this one in any order, as long as its clamp is not strict on
//     the best-t side (a box entered exactly at the best t may hold an
//     equal t at a lower column), so the result is bit for bit the same,
//     ties included;
//   * a block traces 256 neighbouring rays, which read the same records
//     through L1: against warps interleaved over the blocks (0.86 ms a
//     pass) and against the same walk over lane groups on a block-level
//     live list (1.04 ms), this (0.79 ms) won every case (PERF.md).
// - HBM (K7, replaces _closest_hit_front_hbm :2350 in _megakernel_front_hbm
//   :2500): K3's culling with the sphere table in global memory, one
//   128-column block per subtree (the layout of front_tables_hbm), no
//   repack, optional 8-sphere sub-block boxes (`bf`, read from global
//   memory) and per-word early-out. The TPU copies each live subtree's
//   block into a double buffer by DMA; here the spheres are read straight
//   from global memory (50,000 spheres are 3.2 MB against 50 MB of L2),
//   sphere-major, the 32-byte test half of a sphere's 64-byte record.
//   What bounds it on an H100: sphere tests. Its first port culled by warp
//   vote, so every lane tested every column of every subtree any lane of
//   its warp entered (3.3x K8's pairs, PERF.md), one thread traced one
//   ray, a warp ran while any lane lived, and every pair paid the roots.
//   What the design does: K6's front segment's partition (below) over the
//   global-memory tables: a block-level live list, each live ray over a
//   group of G = min(32, 256 / L) lanes that deals its own stage-1 masks,
//   its own subtree masks clamped by the group's best t and (with
//   `word_earlyout`) its word box, its live subtrees' columns and (with
//   sub-block boxes) its own 8-column groups over its lanes, the roots
//   only where a discriminant is positive, (t, column) reduced
//   lexicographically, and the winner's record read once by the ray's
//   thread; warps interleaved over the blocks. The box tables (ff, fi, wf,
//   sf) stay in global memory, read through L1 by a group's lanes, 32
//   neighbouring boxes at a time: shared memory holds the live list alone,
//   so registers (64) set the blocks an SM (4). Staged beside the list,
//   the 50,000-sphere front's 72 KB of boxes left two blocks an SM and
//   took 3.32 ms a pass against 2.30 ms (same card; PERF.md), and smaller
//   fronts gained nothing. A front of more than 576 subtrees takes the
//   three-level path.
//
// K1's record_miss (megakernel.py:636-649; MISSREC below), on all five
// closest hits: instead of adding the built-in sky at a ray's miss, the
// kernel keeps the direction and throughput there and writes them beside
// the radiance, [n_rays, 3] each (zero direction: never missed); the
// caller adds an environment map's radiance (render.render_pass).
//
// K6, the resumable depth segment (SEG below; replaces _segment_call,
// megakernel.py:1759, pallas_call at :1818, bodies _megakernel_seg_brute
// :1714 and _megakernel_seg_front :1734): the same bounce loop over the
// brute (chunked) or front closest hit, started from carried state and
// writing it back, for the two-phase and segmented pipelines
// (ops/cuda/depth_tail.py), which pack the live rays between segments.
// - What bounds it on an H100: as K1, plus the carried state: 14 float
//   planes (20 with the miss planes) read and written once a segment, 112
//   (160) B a ray against K1's 40, and K5's residual rows when recording.
// - What the design does: the state is ray-minor ([plane, n_rays]), so a
//   warp's 32 loads or stores of one plane are one coalesced transaction
//   and the pipelines pack every plane with one gather; a ray carries its
//   slot of the monolithic trace and draws with Philox counter (slot,
//   global bounce), so a trace cut into segments computes the monolithic
//   kernel's paths (the TPU pipelines reseed each phase instead, their
//   generator being keyed by tile position).
// - MISSREC and SEG are template arguments, and their pointers live in a
//   type of their own (TailParams, added by WithTail): the instantiations
//   without them keep their parameter block and code.
// - The front segment (FRONT with SEG: plain, miss planes, recording,
//   each with K3's options or without) has a closest hit of its own,
//   closest_hit_front_seg (grouped_closest_hit, which K7 shares; its
//   per-ray work, front_group_word, is K3's too).
//   What held K3's bounce loop back there: the pipelines pack the live rays
//   first, so after a cut the survivors (a tenth of a pass) filled the first
//   tenth of the blocks, one ray a thread, on about a quarter of the SMs; the 32
//   rays of a packed warp point every way, and K3's warp-wide culling
//   scanned the union of their subtrees; and every sphere test paid the
//   square root and both roots. What this design does, each bounce:
//   * warp w of block b traces the 32 rays of warp w * gridDim.x + b, so
//     the packed survivors' warps spread over every block and SM (the
//     launch keeps its size; there is no host read of the live count)
//     while a warp's rays stay neighbours: coherent at the first bounces,
//     and its state, residual and miss-plane loads and stores coalesced.
//     Measured on an H100 against rays in neighbouring blocks and against
//     CHUNKED's thread-by-thread interleave (PERF.md), it was the
//     fastest on both segments of a two-phase pass;
//   * the block's live rays enter a list in shared memory (as CHUNKED), and
//     the loop runs while it is not empty;
//   * each of the L live rays gets a group of G lanes, the largest power of
//     two <= 256 / L and at most 32 (a group is part of one warp; a front
//     bounce needs ~24 box tests and ~50 sphere tests); one lane a ray, at
//     every L, was slower on both segments;
//   * the group deals the ray's stage-1 (word, super-word) and subtree box
//     tests over its lanes and ORs the bits with shuffles: the ray's own
//     masks, not the warp's union; between a word's `repack` chunks the
//     group's best t re-slabs the next chunk's boxes;
//   * the group scans the live subtrees' columns of each chunk in ascending
//     order, dealt over its lanes, with sphere_test_roots (the roots only
//     where the discriminant is positive), carrying (t, column),
//     and reduces (t, column) lexicographically with shuffles: per-ray
//     culling with that reduction is exactly the plain version's function
//     (each ray's columns masked by its own slab tests, the first minimum
//     in column order), ties included;
//   * the ray's own thread reads its winner's row from the staged table and
//     shades, records, writes the miss planes and the carried state.
//
// The OPT template argument carries what no product instantiation takes,
// again in types of its own, so the instantiations without it keep their
// registers:
// - FRONT_OPTS, K3's options (megakernel.py:335-529, tables :1061-1077):
//   `word_earlyout` re-tests a live word's union box against the group's
//   best t before its subtrees; `sub_block` (the forward kernel only)
//   slab-tests the 8-column group boxes `bf` of each live subtree, staged
//   in shared memory beside the other tables, and scans only the groups
//   the ray enters. Both only cull, so the result is the plain front's bit
//   for bit. Instantiated for the forward front (with and without
//   MISSREC), K5's front core and K6's three front tails, where the JAX
//   package threads the options, through front_group_word: the forward
//   and recording kinds on K3's warp-level groups, the three segments on
//   the front segment's block-level list (a packed tail's few live rays a
//   block get up to 32 lanes each, where a warp's few would get fewer;
//   PERF.md section 6 has both forms' times). K7's options
//   (hbm_group_word) scan 128-column blocks of global memory; these scan
//   the padded, repacked subtree ranges of the shared-memory table.
// - SCHLICK3, K1's planted fault (megakernel.py:683-688): Schlick's
//   reflectance with the exponent 3 instead of 5, for the
//   per-material-region test to catch. The brute scan (CHUNKED) only.
//
// The closest hit's carries, the ray and the slab test live in common.cuh,
// shared with the probe kernels (probes.cu); the sphere test,
// sphere_test_roots, and its global-memory kinds are below.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int TPB = 256;  // rays per block (ops/cuda/megakernel.py TILE)
constexpr int WORD = 24;
constexpr int BLOCK = 128;   // columns per subtree of the global-memory front
constexpr int CHUNK = 1024;  // spheres per staged chunk of the chunked brute scan
constexpr int UNROLL = 8;    // front subtree ranges are padded to a multiple of this
constexpr int MISS = -1;  // residual idx of a live miss (grad/replay.py)
constexpr int DEAD = -2;  // residual idx of a ray already terminated

struct Params {
  const float* origin;     // [R, 3]
  const float* direction;  // [R, 3]
  const float* time;       // [R]
  float* out;              // [R, 3] radiance
  const float* sph;        // [16, n_cols] sphere table (JAX row layout)
  const float* ff;         // [8, n_front] subtree boxes
  const int* fi;           // [2, n_front] (start, padded count)
  const float* wf;         // [8, n_words_pad] word union boxes
  const float* sf;         // [8, n_super] super-word union boxes
  int n_cols, n_front, n_words_pad, n_super, repack;
  uint32_t seed;
  int max_depth;
  float t_min;
  int zero_draws;
};

// K5's parameters: K1's and the residual planes, [max_depth, n_rays] each
// (ray-minor, so a warp's stores of one bounce coalesce). A separate type,
// so that the forward kernels keep their parameter block and code.
struct RecordParams : Params {
  int* res_idx;
  float* res_ndx;
  float* res_ndy;
  float* res_ndz;
  uint8_t* res_refl;
};

// The closest hit a kernel runs. FRONT keeps its tables in shared memory;
// CHUNKED (the brute scan, any size) stages its table in chunks; BVH and HBM
// serve tables past the shared memory's size. (Mode 0, the whole-table
// brute scan, is gone: every brute scan is CHUNKED.)
enum Mode { FRONT = 1, CHUNKED = 2, BVH = 3, HBM = 4 };

// Parameters of the BVH and HBM kernels; `sph` is then sphere-major,
// [n_cols, 16]. Again a separate type: Params stays as it is.
struct LargeParams : Params {
  const float* nodes;  // BVH: [n_nodes, 8] words: min xyz, max xyz, miss link, leaf
  const float* bf;     // HBM: [8, n_bf] sub-block boxes in global memory, or null
  int n_bf, ksub, word_earlyout;
};

struct LargeRecordParams : LargeParams {
  int* res_idx;
  float* res_ndx;
  float* res_ndy;
  float* res_ndz;
  uint8_t* res_refl;
};

template <int MODE, bool RECORD> struct BaseParams {
  using type = typename std::conditional<
      MODE >= BVH, typename std::conditional<RECORD, LargeRecordParams, LargeParams>::type,
      typename std::conditional<RECORD, RecordParams, Params>::type>::type;
};

// Rows of K6's carried state, [n_planes, n_rays] float32 planes, ray-minor:
// 14 planes, 20 with the miss planes (record_miss).
enum {
  ST_OX, ST_OY, ST_OZ, ST_DX, ST_DY, ST_DZ, ST_TM, ST_THR_R, ST_THR_G, ST_THR_B,
  ST_RAD_R, ST_RAD_G, ST_RAD_B, ST_ALIVE, ST_MDX, ST_MDY, ST_MDZ, ST_MTR, ST_MTG, ST_MTB
};

// K6's carried state and the miss planes of record_miss. A type of their
// own, beside the closest hit's parameters: the kernels without them keep
// their parameter block and code.
struct TailParams {
  const float* state_in;  // K6: carried state in (ST_* rows)
  float* state_out;       // K6: the same planes after the segment
  const int* slot;        // K6: [n_rays] each ray's slot in the monolithic trace
  int bounce0;            // K6: the global bounce of the segment's first bounce
  float* mdir;            // record_miss (monolithic): [n_rays, 3] direction at the miss
  float* mthr;            // record_miss (monolithic): [n_rays, 3] throughput at the miss
};

template <class Base> struct WithTail : Base { TailParams tail; };

// Options of a kernel that no product instantiation takes (the OPT template
// argument): SCHLICK3, K1's planted fault for the per-material-region test
// (the brute scan only); FRONT_OPTS, K3's sub-block boxes and word early-out.
enum Opt { NO_OPT = 0, SCHLICK3 = 1, FRONT_OPTS = 2 };

// K3's options. A type of their own, added by WithOpts: the front kernels
// without them keep their parameter block and code.
struct FrontOpts {
  const float* bf;    // [8, n_bf] boxes of 8 padded columns each, or null
  int n_bf;           // columns of bf (the padded table's groups + ksub)
  int ksub;           // groups of the biggest subtree; 0: no sub-block descent
  int word_earlyout;  // re-test a live word's union box against the best t
};

template <class Base> struct WithOpts : Base { FrontOpts opts; };

// MISSREC: record the miss direction and throughput instead of adding the
// built-in sky (K1's record_miss). SEG: a resumable depth segment (K6).
template <int MODE, bool RECORD, bool MISSREC = false, bool SEG = false, int OPT = NO_OPT>
struct KernelParams {
  using base = typename BaseParams<MODE, RECORD>::type;
  using tailed = typename std::conditional<MISSREC || SEG, WithTail<base>, base>::type;
  using type = typename std::conditional<OPT == FRONT_OPTS, WithOpts<tailed>, tailed>::type;
};

// ---- random numbers: Philox-4x32-10 (ops/rng.py) ----
__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) { k0 += 0x9E3779B9u; k1 += 0xBB67AE85u; }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]), lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]), lo1 = 0xCD9E8D57u * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0; c[1] = lo1; c[2] = n2; c[3] = lo0;
  }
}

__device__ __forceinline__ void bounce_bits(uint32_t seed, uint32_t ray, uint32_t bounce,
                                            uint32_t w[4]) {
  w[0] = ray; w[1] = bounce; w[2] = 0u; w[3] = 0u;
  philox4x32_10(w, seed, 0u);
}

__device__ __forceinline__ float bits_to_uniform(uint32_t b) {
  return (float)(b >> 8) * (1.0f / 16777216.0f);
}


struct FrontSmem {
  const float* sph; const float* ff; const int* fi; const float* wf; const float* sf;
};

// ---- CHUNKED: the brute scan, its table staged in chunks ----
constexpr int SCAN_ROWS = ROW_RAD + 1;  // rows the sphere test reads: centre, velocity, radius
constexpr int RAY_WORDS = 9;            // a live ray in the list: o, d, tm, a, inv_a

// CHUNKED's shared memory: two chunk buffers of the scanned rows
// ([2][SCAN_ROWS][CHUNK]), the block's live rays ([RAY_WORDS][TPB], ray j
// in column j), each (ray, 32-lane part)'s winner t and column, and each
// warp's live count.
struct ChunkSmem {
  float* buf;
  float* ray;
  float* win_t;
  int* win_c;
  int* warp_live;
};

constexpr size_t CHUNK_SMEM_BYTES =
    sizeof(float) * (2 * SCAN_ROWS * CHUNK + RAY_WORDS * TPB + 2 * TPB + TPB / 32);

__device__ __forceinline__ ChunkSmem chunk_smem(float* smem) {
  ChunkSmem c;
  c.buf = smem;
  c.ray = c.buf + 2 * SCAN_ROWS * CHUNK;
  c.win_t = c.ray + RAY_WORDS * TPB;
  c.win_c = reinterpret_cast<int*>(c.win_t + TPB);
  c.warp_live = c.win_c + TPB;
  return c;
}

// This thread's place in the block's list of live rays, and its length.
struct LiveList {
  int slot, n;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Start copying chunk k's scanned rows into buffer k % 2 (16-byte copies
// when the rows allow it); cp_async_wait_all and a barrier complete it.
__device__ __forceinline__ void stage_chunk(const ChunkSmem& C, const Params& p, int k) {
  const int c0 = k * CHUNK;
  const int n = min(CHUNK, p.n_cols - c0);
  const bool vec = p.n_cols % 4 == 0 && (reinterpret_cast<uintptr_t>(p.sph) & 15) == 0;
  float* dst = C.buf + (k & 1) * SCAN_ROWS * CHUNK;
  for (int row = 0; row < SCAN_ROWS; ++row) {
    const float* src = p.sph + (size_t)row * p.n_cols + c0;
    if (vec)
      for (int q = 4 * threadIdx.x; q < n; q += 4 * TPB) cp_async16(dst + row * CHUNK + q, src + q);
    else
      for (int q = threadIdx.x; q < n; q += TPB) cp_async4(dst + row * CHUNK + q, src + q);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Keep (ot, oc) if it is lexicographically less than the carry.
__device__ __forceinline__ void take_less(ColumnHit& b, float ot, int oc) {
  if (ot < b.bt || (ot == b.bt && oc < b.col)) {
    b.bt = ot;
    b.col = oc;
  }
}

// The roots of a sphere test whose discriminant is positive, into a
// ColumnHit carry (column `col`): the square root, both roots, the interval
// tests and the update, which a pair with disc <= 0 never reaches, so a
// test that skips them where disc <= 0 keeps a full test's result.
__device__ __forceinline__ void roots_update(float half_b, float disc, const Ray& r, float t_min,
                                             int col, ColumnHit& h) {
  const float sq = sqrtf(disc);
  const float r0 = (-half_b - sq) * r.inv_a;
  const float r1 = (-half_b + sq) * r.inv_a;
  const bool in0 = (r0 > t_min) && (r0 < h.bt);
  const bool in1 = (r1 > t_min) && (r1 < h.bt);
  if (in0 || in1) {
    h.bt = in0 ? r0 : r1;
    h.col = col;
  }
}

// The sphere test of the megakernels: the reference quadratic
// (_sphere_test_ld: src/sphere.h:30-57, exact, open interval (t_min, best
// t), the moving centre lerped to the ray's time) for column s of a
// row-major [16, n] table, with a ColumnHit carry (column idx0 + s), the
// roots only where the discriminant is positive (roots_update).
__device__ __forceinline__ void sphere_test_roots(const float* __restrict__ S, int n, int s,
                                                  const Ray& r, float t_min, ColumnHit& h,
                                                  int idx0 = 0) {
  const float ccx = S[ROW_CX * n + s] + r.tm * S[ROW_MX * n + s];
  const float ccy = S[ROW_CY * n + s] + r.tm * S[ROW_MY * n + s];
  const float ccz = S[ROW_CZ * n + s] + r.tm * S[ROW_MZ * n + s];
  const float rad = S[ROW_RAD * n + s];
  const float ocx = r.ox - ccx, ocy = r.oy - ccy, ocz = r.oz - ccz;
  const float half_b = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  const float cq = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  const float disc = half_b * half_b - r.a * cq;
  if (disc > 0.0f) roots_update(half_b, disc, r, t_min, idx0 + s, h);
}

// The closest hit of every live ray of the block (see CHUNKED above).
// Every thread of the block calls it; `h` is filled for a live ray.
template <bool RECORD>
__device__ __forceinline__ void closest_hit_chunked(const ChunkSmem& C, const Params& p,
                                                    const Ray& r, bool alive,
                                                    const LiveList& live,
                                                    typename HitOf<RECORD>::type& h) {
  const int tid = threadIdx.x;
  const int n_chunks = (p.n_cols + CHUNK - 1) / CHUNK;
  stage_chunk(C, p, 0);
  if (alive) {
    float* w = C.ray + live.slot;
    w[0 * TPB] = r.ox; w[1 * TPB] = r.oy; w[2 * TPB] = r.oz;
    w[3 * TPB] = r.dx; w[4 * TPB] = r.dy; w[5 * TPB] = r.dz;
    w[6 * TPB] = r.tm; w[7 * TPB] = r.a; w[8 * TPB] = r.inv_a;
  }
  cp_async_wait_all();
  __syncthreads();  // chunk 0 and the live list

  const int lg = 31 - __clz(TPB / live.n);  // G = 2^lg lanes a live ray
  const int G = 1 << lg;
  const int j = tid >> lg, g = tid & (G - 1);
  const bool scans = j < live.n;
  Ray q{};
  if (scans) {
    const float* w = C.ray + j;
    q.ox = w[0 * TPB]; q.oy = w[1 * TPB]; q.oz = w[2 * TPB];
    q.dx = w[3 * TPB]; q.dy = w[4 * TPB]; q.dz = w[5 * TPB];
    q.tm = w[6 * TPB]; q.a = w[7 * TPB]; q.inv_a = w[8 * TPB];
  }
  ColumnHit best{__int_as_float(0x7f800000), 0};
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) stage_chunk(C, p, k + 1);  // every thread is done with chunk k - 1
    if (scans) {
      const float* S = C.buf + (k & 1) * SCAN_ROWS * CHUNK;
      const int n = min(CHUNK, p.n_cols - k * CHUNK);  // the last chunk is partial
#pragma unroll 4
      for (int s = g; s < n; s += G) sphere_test_roots(S, CHUNK, s, q, p.t_min, best, k * CHUNK);
    }
    if (k + 1 < n_chunks) {
      cp_async_wait_all();
      __syncthreads();  // chunk k + 1 has landed, chunk k is scanned
    }
  }

  // Each group of G lanes to its least (t, column): within a warp by
  // shuffles, one entry per 32-lane part; the ray's thread reads its parts.
  const int W = min(G, 32);
  for (int off = W >> 1; off > 0; off >>= 1)
    take_less(best, __shfl_xor_sync(FULL, best.bt, off), __shfl_xor_sync(FULL, best.col, off));
  if ((tid & (W - 1)) == 0) {
    C.win_t[tid / W] = best.bt;
    C.win_c[tid / W] = best.col;
  }
  __syncthreads();
  if (alive) {
    const int parts = G / W;
    ColumnHit win{C.win_t[live.slot * parts], C.win_c[live.slot * parts]};
    for (int u = 1; u < parts; ++u)
      take_less(win, C.win_t[live.slot * parts + u], C.win_c[live.slot * parts + u]);
    if (win.bt < __int_as_float(0x7f800000)) {  // the winner's fields
      const float* S = p.sph;
      const int n = p.n_cols, s = win.col;
      h.bt = win.bt;
      h.hx = __ldg(S + ROW_CX * n + s) + r.tm * __ldg(S + ROW_MX * n + s);
      h.hy = __ldg(S + ROW_CY * n + s) + r.tm * __ldg(S + ROW_MY * n + s);
      h.hz = __ldg(S + ROW_CZ * n + s) + r.tm * __ldg(S + ROW_MZ * n + s);
      h.hrad = __ldg(S + ROW_RAD * n + s);
      h.hmat = (int)__ldg(S + ROW_MAT * n + s);
      if constexpr (RECORD) h.hidx = s;
      h.har = __ldg(S + ROW_AR * n + s);
      h.hag = __ldg(S + ROW_AG * n + s);
      h.hab = __ldg(S + ROW_AB * n + s);
      h.hfz = __ldg(S + ROW_FUZZ * n + s);
      h.hio = __ldg(S + ROW_IOR * n + s);
    }
  }
}

// ---- K6's front segment and K7: per-ray culling, each live ray over a group of lanes ----
constexpr int LG_MAX = 5;  // a live ray gets at most 2^5 = 32 lanes: a group is part of one warp

// The front segment's shared memory after the front tables, and K7's
// whole: the block's live rays ([RAY_WORDS][TPB]), each live ray's winner
// t and column, and each warp's live count (ChunkSmem's fields without the
// chunk buffers).
constexpr size_t LIST_SMEM_BYTES = sizeof(float) * (RAY_WORDS * TPB + 2 * TPB + TPB / 32);

__device__ __forceinline__ ChunkSmem list_smem(float* base) {
  ChunkSmem c;
  c.buf = nullptr;
  c.ray = base;
  c.win_t = c.ray + RAY_WORDS * TPB;
  c.win_c = reinterpret_cast<int*>(c.win_t + TPB);
  c.warp_live = c.win_c + TPB;
  return c;
}

// A live ray's lanes: G of them, this lane g-th, `mask` the group's lanes
// of the warp (groups are aligned, so lane ^ off stays in the group for
// off < G).
struct Group {
  int g, G;
  unsigned mask;
};

__device__ __forceinline__ unsigned group_or(unsigned m, const Group& q) {
  for (int off = 1; off < q.G; off <<= 1) m |= __shfl_xor_sync(q.mask, m, off);
  return m;
}

__device__ __forceinline__ float group_min(float t, const Group& q) {
  for (int off = 1; off < q.G; off <<= 1) t = fminf(t, __shfl_xor_sync(q.mask, t, off));
  return t;
}

// "The group's ray enters box base + k" bits for k < cnt (cnt <= 32), the
// boxes dealt over the lanes (lane g tests k = g, g + G, ...): the ray's own
// mask, where a warp vote gives the warp's union.
__device__ __forceinline__ unsigned group_bits(const float* B, int n, int base, int cnt,
                                               const Ray& r, const InvDir& inv, float t_min,
                                               float far, const Group& q) {
  unsigned m = 0u;
  for (int k = q.g; k < cnt; k += q.G)
    if (slab(B, n, base + k, r, inv, t_min, far)) m |= 1u << k;
  return group_or(m, q);
}

// Stage 2 for one live word of the group's ray: each of the `repack`
// chunks' subtree boxes against the group's best t so far (which only
// culls: a later chunk's columns lose ties to the best one's), then the
// columns of the chunk's live subtrees, in ascending order, dealt over the
// lanes: lane g tests the g-th, (g + G)-th, ... of them with a strict `<`.
//
// OPTS: K3's options (FRONT_OPTS; megakernel.py:464-527), which only cull,
// so the result is the plain front's bit for bit. First the word early-out:
// the word's union box against the group's best t, the word skipped when
// the ray enters it only beyond. Then, with sub-block boxes (SUB, and
// o.ksub > 0), one more cull inside each live subtree: its 8-column groups'
// boxes `bf` against the group's best t, dealt over the lanes like the
// subtree boxes, and only the columns of the groups the ray enters dealt
// over the lanes. K5 and K6 take the early-out alone (SUB false), as the
// JAX package's recording and segment kernels do. Without OPTS the
// options' code is discarded.
template <bool OPTS = false, bool SUB = false>
__device__ __forceinline__ void front_group_word(const FrontSmem& T, const Params& p, int w,
                                                 const Ray& r, const InvDir& inv,
                                                 ColumnHit& best, const Group& q,
                                                 [[maybe_unused]] const FrontOpts& o,
                                                 [[maybe_unused]] const float* bf) {
  if constexpr (OPTS) {
    if (o.word_earlyout &&
        !slab(T.wf, p.n_words_pad, w, r, inv, p.t_min, group_min(best.bt, q)))
      return;
  }
  const int per = WORD / p.repack;
  for (int c = 0; c < p.repack; ++c) {
    const int base = w * WORD + c * per;
    unsigned m = group_bits(T.ff, p.n_front, base, per, r, inv, p.t_min,
                            group_min(best.bt, q), q);
    int pos = q.g;  // this lane's next place in the chunk's live columns
    while (m) {
      const int k = __ffs(m) - 1;
      m &= m - 1u;
      const int start = T.fi[base + k];
      const int cnt = T.fi[p.n_front + base + k];
      if constexpr (SUB) {
        if (o.ksub) {  // group g of the subtree is column start / 8 + g of bf
          unsigned bm = group_bits(bf, o.n_bf, start / UNROLL, cnt / UNROLL, r, inv, p.t_min,
                                   group_min(best.bt, q), q);
          while (bm) {
            const int s0 = start + UNROLL * (__ffs(bm) - 1);
            bm &= bm - 1u;
            for (; pos < UNROLL; pos += q.G)
              sphere_test_roots(T.sph, p.n_cols, s0 + pos, r, p.t_min, best);
            pos -= UNROLL;
          }
          continue;
        }
      }
      for (; pos < cnt; pos += q.G) sphere_test_roots(T.sph, p.n_cols, start + pos, r, p.t_min,
                                                      best);
      pos -= cnt;
    }
  }
}

// Stage 1 on the group's ray's own masks (super-word boxes, then the word
// boxes of the super-words it enters): calls word(w) for every word the ray
// enters, in ascending order.
template <class WordFn>
__device__ __forceinline__ void group_live_words(const FrontSmem& T, const Params& p,
                                                 const Ray& r, const InvDir& inv, const Group& q,
                                                 WordFn&& word) {
  const float inf = __int_as_float(0x7f800000);
  const int n_words = p.n_front / WORD;
  const int n_super = (n_words + WORD - 1) / WORD;
  if (n_words == 1) {
    word(0);
  } else if (n_super == 1) {
    unsigned wm = group_bits(T.wf, p.n_words_pad, 0, n_words, r, inv, p.t_min, inf, q);
    while (wm) {
      const int w = __ffs(wm) - 1;
      wm &= wm - 1u;
      word(w);
    }
  } else {
    unsigned sm = group_bits(T.sf, p.n_super, 0, n_super, r, inv, p.t_min, inf, q);
    while (sm) {
      const int sw = __ffs(sm) - 1;
      sm &= sm - 1u;
      unsigned wm = group_bits(T.wf, p.n_words_pad, sw * WORD, WORD, r, inv, p.t_min, inf, q);
      while (wm) {
        const int k = __ffs(wm) - 1;
        wm &= wm - 1u;
        word(sw * WORD + k);
      }
    }
  }
}

// The winner (t, column) of every live ray of the block, each ray over a
// group of lanes (K6's front segment and K7; see them above): the block's
// live rays enter the list, each gets G = the largest power of two <= 256
// / L lanes, at most 32; the group runs stage 1 on its ray's own masks and
// word(w, ray, inv, best, group) for each live word, each lane carrying
// (t, column) with a strict `<`; the group reduces (t, column)
// lexicographically. Every thread of the block calls it; a live ray's
// thread gets its ray's winner (t = inf: a miss).
template <class WordFn>
__device__ __forceinline__ ColumnHit grouped_closest_hit(const FrontSmem& T, const ChunkSmem& L,
                                                         const Params& p, const Ray& r,
                                                         bool alive, const LiveList& live,
                                                         WordFn&& word) {
  const int tid = threadIdx.x;
  const float inf = __int_as_float(0x7f800000);
  if (alive) {
    float* w = L.ray + live.slot;
    w[0 * TPB] = r.ox; w[1 * TPB] = r.oy; w[2 * TPB] = r.oz;
    w[3 * TPB] = r.dx; w[4 * TPB] = r.dy; w[5 * TPB] = r.dz;
    w[6 * TPB] = r.tm; w[7 * TPB] = r.a; w[8 * TPB] = r.inv_a;
  }
  __syncthreads();  // the live list

  const int lg = min(31 - __clz(TPB / live.n), LG_MAX);  // G = 2^lg lanes a live ray
  Group q;
  q.G = 1 << lg;
  q.g = tid & (q.G - 1);
  const int lane = tid & 31;
  q.mask = q.G == 32 ? FULL : ((1u << q.G) - 1u) << (lane & ~(q.G - 1));
  const int j = tid >> lg;
  if (j < live.n) {
    Ray y;
    const float* w = L.ray + j;
    y.ox = w[0 * TPB]; y.oy = w[1 * TPB]; y.oz = w[2 * TPB];
    y.dx = w[3 * TPB]; y.dy = w[4 * TPB]; y.dz = w[5 * TPB];
    y.tm = w[6 * TPB]; y.a = w[7 * TPB]; y.inv_a = w[8 * TPB];
    const InvDir inv = inv_dir(y);
    ColumnHit best{inf, 0};
    group_live_words(T, p, y, inv, q, [&](int wd) { word(wd, y, inv, best, q); });
    // the group to its least (t, column): a strict-`<` scan's first minimum
    for (int off = q.G >> 1; off > 0; off >>= 1)
      take_less(best, __shfl_xor_sync(q.mask, best.bt, off),
                __shfl_xor_sync(q.mask, best.col, off));
    if (q.g == 0) {
      L.win_t[j] = best.bt;
      L.win_c[j] = best.col;
    }
  }
  __syncthreads();  // the winners; the list is read no more this bounce
  ColumnHit win{inf, 0};
  if (alive) {
    win.bt = L.win_t[live.slot];
    win.col = L.win_c[live.slot];
  }
  return win;
}

// The winner's fields from the staged front table, read once after
// the scan by the ray's own thread: the centre moved to the ray's time as
// the test computes it, the material as stored. Nothing for a miss (t = inf).
template <bool RECORD>
__device__ __forceinline__ void winner_s(const float* S, int n, const Ray& r,
                                         const ColumnHit& win,
                                         typename HitOf<RECORD>::type& h) {
  if (win.bt < __int_as_float(0x7f800000)) {
    const int s = win.col;
    h.bt = win.bt;
    h.hx = S[ROW_CX * n + s] + r.tm * S[ROW_MX * n + s];
    h.hy = S[ROW_CY * n + s] + r.tm * S[ROW_MY * n + s];
    h.hz = S[ROW_CZ * n + s] + r.tm * S[ROW_MZ * n + s];
    h.hrad = S[ROW_RAD * n + s];
    h.hmat = (int)S[ROW_MAT * n + s];
    if constexpr (RECORD) h.hidx = s;
    h.har = S[ROW_AR * n + s]; h.hag = S[ROW_AG * n + s]; h.hab = S[ROW_AB * n + s];
    h.hfz = S[ROW_FUZZ * n + s];
    h.hio = S[ROW_IOR * n + s];
  }
}

// The closest hit of every live ray of the block over the front, each ray
// over a group of the block's lanes on the block's live list (K6's front
// segment); `h` is filled for a live ray, from the staged table. OPTS, SUB:
// K3's options, as front_group_word takes them.
template <bool RECORD, bool OPTS = false, bool SUB = false>
__device__ __forceinline__ void closest_hit_front_seg(const FrontSmem& T, const ChunkSmem& L,
                                                      const Params& p, const Ray& r, bool alive,
                                                      const LiveList& live,
                                                      typename HitOf<RECORD>::type& h,
                                                      const FrontOpts& o, const float* bf) {
  const ColumnHit win = grouped_closest_hit(
      T, L, p, r, alive, live,
      [&](int w, const Ray& y, const InvDir& inv, ColumnHit& best, const Group& q) {
        front_group_word<OPTS, SUB>(T, p, w, y, inv, best, q, o, bf);
      });
  winner_s<RECORD>(T.sph, p.n_cols, r, win, h);
}

// ---- K3: the same groups within a warp ----

// The position of the j-th (from 0) set bit of m; j < popc(m).
__device__ __forceinline__ int nth_set_bit(unsigned m, int j) {
  int pos = 0;
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(m & ((1u << w) - 1u));
    if (j >= c) {
      j -= c;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

// K3's closest hit of this warp's live rays (see K3 above): the warp's L
// live lanes (a ballot; L >= 1, the bounce loop runs while one lives), each
// live ray over a group of G = the largest power of two <= 32 / L lanes,
// the j-th live lane's ray in group j (its nine fields shuffled from the
// owner); the group culls and scans with front_group_word as K6's front
// segment does, reduces (t, column) lexicographically, and the owner lane
// takes its group's winner (a shuffle from lane j * G) and reads the
// winner's row from the staged table. Every lane of the warp calls it and
// reaches every full-warp shuffle; a dead lane's `h` stays a miss.
template <bool RECORD, bool OPTS = false, bool SUB = false>
__device__ __forceinline__ void closest_hit_front_warp(const FrontSmem& T, const Params& p,
                                                       const Ray& r, bool alive,
                                                       typename HitOf<RECORD>::type& h,
                                                       const FrontOpts& o, const float* bf) {
  const unsigned live = __ballot_sync(FULL, alive);
  const int n = __popc(live);
  const int lane = threadIdx.x & 31;
  const int lg = 31 - __clz(32 / n);  // G = 2^lg lanes a live ray
  Group q;
  q.G = 1 << lg;
  q.g = lane & (q.G - 1);
  q.mask = q.G == 32 ? FULL : ((1u << q.G) - 1u) << (lane & ~(q.G - 1));
  const int j = lane >> lg;  // the group's ray: the warp's j-th live lane
  const int src = nth_set_bit(live, j < n ? j : 0);
  Ray y;
  y.ox = __shfl_sync(FULL, r.ox, src); y.oy = __shfl_sync(FULL, r.oy, src);
  y.oz = __shfl_sync(FULL, r.oz, src);
  y.dx = __shfl_sync(FULL, r.dx, src); y.dy = __shfl_sync(FULL, r.dy, src);
  y.dz = __shfl_sync(FULL, r.dz, src);
  y.tm = __shfl_sync(FULL, r.tm, src);
  y.a = __shfl_sync(FULL, r.a, src); y.inv_a = __shfl_sync(FULL, r.inv_a, src);
  ColumnHit best{__int_as_float(0x7f800000), 0};
  if (j < n) {
    const InvDir inv = inv_dir(y);
    group_live_words(T, p, y, inv, q,
                     [&](int w) { front_group_word<OPTS, SUB>(T, p, w, y, inv, best, q, o, bf); });
    // the group to its least (t, column): a strict-`<` scan's first minimum
    for (int off = q.G >> 1; off > 0; off >>= 1)
      take_less(best, __shfl_xor_sync(q.mask, best.bt, off),
                __shfl_xor_sync(q.mask, best.col, off));
  }
  const int from = alive ? __popc(live & ((1u << lane) - 1u)) << lg : lane;  // lane j * G
  const ColumnHit win{__shfl_sync(FULL, best.bt, from), __shfl_sync(FULL, best.col, from)};
  if (alive) winner_s<RECORD>(T.sph, p.n_cols, r, win, h);
}

// ---- K7: the same groups over the global-memory front ----

// sphere_test_roots' quadratic for sphere s of the sphere-major table in global
// memory ([n, 16] floats, one 64-byte record a sphere), from the record's
// test half (centre, velocity, radius: its first 32 bytes): its
// discriminant, and half_b.
__device__ __forceinline__ float disc_g(const float4* __restrict__ S, int s, const Ray& r,
                                        float& half_b) {
  const float4 g0 = __ldg(S + 4 * s), g1 = __ldg(S + 4 * s + 1);
  const float ccx = g0.x + r.tm * g0.w;
  const float ccy = g0.y + r.tm * g1.x;
  const float ccz = g0.z + r.tm * g1.y;
  const float rad = g1.z;
  const float ocx = r.ox - ccx, ocy = r.oy - ccy, ocz = r.oz - ccz;
  half_b = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  const float cq = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  return half_b * half_b - r.a * cq;
}

// sphere_test_roots on the sphere-major table in global memory: the same
// arithmetic (disc_g), the roots only where the discriminant is positive.
__device__ __forceinline__ void sphere_test_roots_g(const float4* __restrict__ S, int s,
                                                    const Ray& r, float t_min, ColumnHit& h) {
  float half_b;
  const float disc = disc_g(S, s, r, half_b);
  if (disc > 0.0f) roots_update(half_b, disc, r, t_min, s, h);
}

// Stage 2 of K7 for one live word of the group's ray: with word_earlyout
// the word's own box against the group's best t (the word skipped when the
// ray enters it only beyond), then its 24 subtree boxes against that best t,
// dealt over the lanes; then the columns sid * BLOCK .. + cnt of each live
// subtree in ascending order, dealt over the lanes (lane g tests the g-th,
// (g + G)-th, ... of them), or with sub-block boxes only the columns of
// the 8-column groups the ray enters within its best t, the groups' boxes
// dealt like the subtree boxes. Every clamp only culls: a later box's
// columns lose ties to the best one's.
__device__ __forceinline__ void hbm_group_word(const FrontSmem& T, const LargeParams& p, int w,
                                               const Ray& r, const InvDir& inv, ColumnHit& best,
                                               const Group& q) {
  const float far = group_min(best.bt, q);
  if (p.word_earlyout && !slab(T.wf, p.n_words_pad, w, r, inv, p.t_min, far)) return;
  const float4* __restrict__ S = reinterpret_cast<const float4*>(p.sph);
  unsigned m = group_bits(T.ff, p.n_front, w * WORD, WORD, r, inv, p.t_min, far, q);
  int pos = q.g;  // this lane's next place in the word's live columns
  while (m) {
    const int sid = w * WORD + __ffs(m) - 1;
    m &= m - 1u;
    const int cnt = T.fi[sid];
    if (p.ksub == 0) {
      for (; pos < cnt; pos += q.G) sphere_test_roots_g(S, sid * BLOCK + pos, r, p.t_min, best);
      pos -= cnt;
    } else {
      unsigned bm = group_bits(p.bf, p.n_bf, sid * p.ksub, cnt / UNROLL, r, inv, p.t_min,
                               group_min(best.bt, q), q);
      while (bm) {
        const int s0 = sid * BLOCK + UNROLL * (__ffs(bm) - 1);
        bm &= bm - 1u;
        for (; pos < UNROLL; pos += q.G) sphere_test_roots_g(S, s0 + pos, r, p.t_min, best);
        pos -= UNROLL;
      }
    }
  }
}

// The winner's fields of a sphere-major table in global memory, read once
// after the scan: the centre moved to the ray's time as the test computes
// it, the material as stored. Nothing for a miss (t = inf).
template <bool RECORD>
__device__ __forceinline__ void winner_g(const float* sph, const Ray& r, const ColumnHit& win,
                                         typename HitOf<RECORD>::type& h) {
  if (win.bt < __int_as_float(0x7f800000)) {
    const float4* __restrict__ S = reinterpret_cast<const float4*>(sph);
    const int s = win.col;
    const float4 g0 = __ldg(S + 4 * s), g1 = __ldg(S + 4 * s + 1);
    const float4 g2 = __ldg(S + 4 * s + 2), g3 = __ldg(S + 4 * s + 3);
    h.bt = win.bt;
    h.hx = g0.x + r.tm * g0.w;
    h.hy = g0.y + r.tm * g1.x;
    h.hz = g0.z + r.tm * g1.y;
    h.hrad = g1.z;
    h.hmat = (int)g1.w;
    if constexpr (RECORD) h.hidx = s;
    h.har = g2.x; h.hag = g2.y; h.hab = g2.z;
    h.hfz = g2.w;
    h.hio = g3.x;
  }
}

// K7's closest hit of every live ray of the block (see HBM above); `h` is
// filled for a live ray, the winner's record read once from global memory.
__device__ __forceinline__ void closest_hit_hbm(const FrontSmem& T, const ChunkSmem& L,
                                                const LargeParams& p, const Ray& r, bool alive,
                                                const LiveList& live, Hit& h) {
  const ColumnHit win = grouped_closest_hit(
      T, L, p, r, alive, live,
      [&](int w, const Ray& y, const InvDir& inv, ColumnHit& best, const Group& q) {
        hbm_group_word(T, p, w, y, inv, best, q);
      });
  winner_g<false>(p.sph, r, win, h);
}

// ---- K8: the ordered BVH walk ----
constexpr int BVH_STACK = 32;  // a ray's deferred children (ops/cuda/megakernel.py BVH_STACK)

// The ordered walk's slab test: does the ray enter the box (lo, hi) within
// (t_min, far]? `tn` is where it enters. The far side is not strict: a box
// entered exactly at the best t so far may hold an equal hit at a lower
// column, which a walk in column order would have found first.
__device__ __forceinline__ bool enters(const float4& lo, const float4& hi, const Ray& r,
                                       const InvDir& inv, float t_min, float far, float& tn) {
  float t0 = (lo.x - r.ox) * inv.x;
  float t1 = (hi.x - r.ox) * inv.x;
  float n = fminf(t0, t1);
  float f = fmaxf(t0, t1);
  t0 = (lo.y - r.oy) * inv.y;
  t1 = (hi.y - r.oy) * inv.y;
  n = fmaxf(n, fminf(t0, t1));
  f = fminf(f, fmaxf(t0, t1));
  t0 = (lo.z - r.oz) * inv.z;
  t1 = (hi.z - r.oz) * inv.z;
  n = fmaxf(n, fmaxf(fminf(t0, t1), t_min));
  f = fminf(f, fmaxf(t0, t1));
  tn = n;
  return f > n && n <= far;
}

// sphere_test_roots_g with a lexicographic update: the sphere's first root
// past t_min replaces the carry where (t, column) is less, so that spheres
// tested out of column order keep the first minimum in column order.
__device__ __forceinline__ void sphere_test_lex_g(const float4* __restrict__ S, int s,
                                                  const Ray& r, float t_min, ColumnHit& h) {
  float half_b;
  const float disc = disc_g(S, s, r, half_b);
  if (disc > 0.0f) {
    const float sq = sqrtf(disc);
    const float r0 = (-half_b - sq) * r.inv_a;
    const float r1 = (-half_b + sq) * r.inv_a;
    const float t = r0 > t_min ? r0 : r1;
    if (t > t_min) take_less(h, t, s);
  }
}

// K8's closest hit of this thread's ray: the ordered walk over the node
// records (see BVH above; bvh_tables lays them out). At an inner record
// both children's boxes are tested against the best t, the nearer child
// entered first and the other deferred with its entry t; a deferred child
// entered beyond the best t is dropped when popped; a leaf's spheres update
// (t, column) lexicographically. The winner's record is read once after
// the walk.
template <bool RECORD>
__device__ __forceinline__ void closest_hit_bvh(const LargeParams& p, const Ray& r,
                                                typename HitOf<RECORD>::type& h) {
  const InvDir inv = inv_dir(r);
  const float4* __restrict__ N = reinterpret_cast<const float4*>(p.nodes);
  const float4* __restrict__ S = reinterpret_cast<const float4*>(p.sph);
  float stack_t[BVH_STACK];
  int stack_ref[BVH_STACK];
  int sp = 0;
  ColumnHit best{__int_as_float(0x7f800000), 0};
  int ref = 0;  // record 0: the root's parent
  for (;;) {
    if (ref >= 0) {
      const float4 lo0 = __ldg(N + 4 * ref), hi0 = __ldg(N + 4 * ref + 1);
      const float4 lo1 = __ldg(N + 4 * ref + 2), hi1 = __ldg(N + 4 * ref + 3);
      float tn0, tn1;
      const bool in0 = enters(lo0, hi0, r, inv, p.t_min, best.bt, tn0);
      const bool in1 = enters(lo1, hi1, r, inv, p.t_min, best.bt, tn1);
      const int ref0 = __float_as_int(lo0.w), ref1 = __float_as_int(hi0.w);
      if (in0 && in1) {
        const bool first0 = tn0 <= tn1;  // on equal entries the lower columns first
        stack_t[sp] = first0 ? tn1 : tn0;
        stack_ref[sp] = first0 ? ref1 : ref0;
        ++sp;
        ref = first0 ? ref0 : ref1;
        continue;
      }
      if (in0 || in1) {
        ref = in0 ? ref0 : ref1;
        continue;
      }
    } else {
      const int leaf = ~ref, start = leaf >> 8, end = start + (leaf & 255);
      for (int s = start; s < end; ++s) sphere_test_lex_g(S, s, r, p.t_min, best);
    }
    while (sp > 0 && stack_t[sp - 1] > best.bt) --sp;
    if (sp == 0) break;
    ref = stack_ref[--sp];
  }
  winner_g<RECORD>(p.sph, r, best, h);
}

// Does any ray of this thread's warp still bounce? LISTED (CHUNKED, K6's
// front segment and K7): of its block, whose threads share the scan; it also lists
// the block's live rays (`live`: this ray's place, in warp order, and the
// count).
template <bool LISTED>
__device__ __forceinline__ bool any_alive(bool alive, [[maybe_unused]] LiveList& live,
                                          [[maybe_unused]] int* warp_live) {
  if constexpr (LISTED) {
    const unsigned b = __ballot_sync(FULL, alive);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_live[warp] = __popc(b);
    live.n = __syncthreads_count(alive);
    live.slot = __popc(b & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) live.slot += warp_live[w];
    return live.n > 0;
  } else {
    return __any_sync(FULL, alive);
  }
}

// Start copying n words of a front table into shared memory: 16 bytes a
// copy where the count and both addresses allow it (the padded tables'
// rows are multiples of 8 words), else 4. A commit, cp_async_wait_all and a
// barrier complete it.
__device__ __forceinline__ void stage_table(float* dst, const void* src, int n) {
  const float* f = static_cast<const float*>(src);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(f);
  if ((n & 3) == 0 && (addr & 15) == 0)
    for (int q = 4 * threadIdx.x; q < n; q += 4 * TPB) cp_async16(dst + q, f + q);
  else
    for (int q = threadIdx.x; q < n; q += TPB) cp_async4(dst + q, f + q);
}

// ---- the bounce loop (K1; K5 with RECORD) ----
template <int MODE, bool RECORD, bool MISSREC = false, bool SEG = false, int OPT = NO_OPT>
__global__ void __launch_bounds__(TPB)
trace_kernel(typename KernelParams<MODE, RECORD, MISSREC, SEG, OPT>::type p) {
  // The front segments (K6, with K3's options or without) take the block's
  // live list (closest_hit_front_seg); K3, its record_miss kind and K5's
  // front core run closest_hit_front_warp, whose groups live in a warp.
  constexpr bool FRONT_LISTED = MODE == FRONT && SEG;
  // a block-level live list: the brute scan, K7 and the front segments
  constexpr bool LISTED = MODE == CHUNKED || MODE == HBM || FRONT_LISTED;
  constexpr bool SUB = OPT == FRONT_OPTS && !RECORD && !SEG;  // K3's sub-block descent
  extern __shared__ float smem[];
  FrontSmem T;
  [[maybe_unused]] float* s_bf = nullptr;  // FRONT_OPTS: the sub-block boxes
  [[maybe_unused]] FrontOpts opts{};       // FRONT_OPTS: K3's options
  [[maybe_unused]] ChunkSmem C{};          // CHUNKED: its buffers; LISTED: the live list
  [[maybe_unused]] LiveList live{0, 0};
  if constexpr (MODE == CHUNKED) C = chunk_smem(smem);
  if constexpr (MODE == FRONT) {
    float* s_sph = smem;
    float* s_ff = s_sph + N_ROWS * p.n_cols;
    float* s_wf = s_ff + 8 * p.n_front;
    float* s_sf = s_wf + 8 * p.n_words_pad;
    int* s_fi = reinterpret_cast<int*>(s_sf + 8 * p.n_super);
    [[maybe_unused]] float* rest = reinterpret_cast<float*>(s_fi + 2 * p.n_front);
    stage_table(s_sph, p.sph, N_ROWS * p.n_cols);
    stage_table(s_ff, p.ff, 8 * p.n_front);
    stage_table(s_wf, p.wf, 8 * p.n_words_pad);
    stage_table(s_sf, p.sf, 8 * p.n_super);
    stage_table(reinterpret_cast<float*>(s_fi), p.fi, 2 * p.n_front);
    if constexpr (OPT == FRONT_OPTS) {
      opts = p.opts;
      if (opts.ksub) {
        s_bf = rest;
        stage_table(s_bf, opts.bf, 8 * opts.n_bf);
        rest += 8 * opts.n_bf;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    cp_async_wait_all();
    if constexpr (FRONT_LISTED) C = list_smem(rest);
    T.sph = s_sph; T.ff = s_ff; T.fi = s_fi; T.wf = s_wf; T.sf = s_sf;
  } else if constexpr (MODE == HBM) {  // every table in global memory; fi is [1, n_front]
    T.sph = p.sph; T.ff = p.ff; T.fi = p.fi; T.wf = p.wf; T.sf = p.sf;
    C = list_smem(smem);  // shared memory holds the live list alone
  }
  __syncthreads();

  // The wrapper pads R to TPB. CHUNKED: thread t of block b traces ray
  // t * gridDim.x + b, so each block holds a sample of the whole launch.
  // K7 and the front segments (K6): warp w of block b traces the 32 rays
  // of warp w * gridDim.x + b, so a launch's live warps (a packed tail's
  // survivors sit in its first blocks) spread over the blocks while a
  // warp's rays stay neighbours (its loads and stores coalesce). The
  // others (K3, K8) trace 256 neighbouring rays a block.
  const int ray = MODE == CHUNKED ? (int)(threadIdx.x * gridDim.x + blockIdx.x)
                  : (MODE == HBM || FRONT_LISTED)
                      ? (int)((((threadIdx.x >> 5) * gridDim.x + blockIdx.x) << 5)
                              + (threadIdx.x & 31))
                      : blockIdx.x * TPB + threadIdx.x;
  Ray r;
  float thr_r = 1.0f, thr_g = 1.0f, thr_b = 1.0f;
  float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;
  bool alive = true;
  // record_miss: direction and throughput at the miss; zero direction = "has not missed"
  [[maybe_unused]] float mdx = 0.0f, mdy = 0.0f, mdz = 0.0f;
  [[maybe_unused]] float mtr = 0.0f, mtg = 0.0f, mtb = 0.0f;
  [[maybe_unused]] const size_t n_rays = (size_t)gridDim.x * TPB;
  [[maybe_unused]] uint32_t slot = 0;
  if constexpr (SEG) {  // K6: resume from the carried state, read once
    const float* __restrict__ S = p.tail.state_in;
    r.ox = S[ST_OX * n_rays + ray]; r.oy = S[ST_OY * n_rays + ray];
    r.oz = S[ST_OZ * n_rays + ray];
    r.dx = S[ST_DX * n_rays + ray]; r.dy = S[ST_DY * n_rays + ray];
    r.dz = S[ST_DZ * n_rays + ray];
    r.tm = S[ST_TM * n_rays + ray];
    thr_r = S[ST_THR_R * n_rays + ray]; thr_g = S[ST_THR_G * n_rays + ray];
    thr_b = S[ST_THR_B * n_rays + ray];
    rad_r = S[ST_RAD_R * n_rays + ray]; rad_g = S[ST_RAD_G * n_rays + ray];
    rad_b = S[ST_RAD_B * n_rays + ray];
    alive = S[ST_ALIVE * n_rays + ray] > 0.5f;
    if constexpr (MISSREC) {
      mdx = S[ST_MDX * n_rays + ray]; mdy = S[ST_MDY * n_rays + ray];
      mdz = S[ST_MDZ * n_rays + ray];
      mtr = S[ST_MTR * n_rays + ray]; mtg = S[ST_MTG * n_rays + ray];
      mtb = S[ST_MTB * n_rays + ray];
    }
    slot = (uint32_t)p.tail.slot[ray];
  } else {
    r.ox = p.origin[3 * ray + 0]; r.oy = p.origin[3 * ray + 1]; r.oz = p.origin[3 * ray + 2];
    r.dx = p.direction[3 * ray + 0]; r.dy = p.direction[3 * ray + 1];
    r.dz = p.direction[3 * ray + 2];
    r.tm = p.time[ray];
  }
  const float inf = __int_as_float(0x7f800000);

  int dep_end = 0;  // K5: bounces this warp (LISTED: block) ran; the DEAD fill starts here
  for (int dep = 0; dep < p.max_depth && any_alive<LISTED>(alive, live, C.warp_live); ++dep) {
    if constexpr (RECORD) dep_end = dep + 1;
    r.a = fmaxf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz, 1e-20f);
    r.inv_a = 1.0f / r.a;

    typename HitOf<RECORD>::type h;
    hit_init(h);
    if constexpr (RECORD) h.hidx = 0;
    if constexpr (FRONT_LISTED)
      closest_hit_front_seg<RECORD, OPT == FRONT_OPTS, SUB>(T, C, p, r, alive, live, h, opts,
                                                             s_bf);
    else if constexpr (MODE == FRONT)
      closest_hit_front_warp<RECORD, OPT == FRONT_OPTS, SUB>(T, p, r, alive, h, opts, s_bf);
    else if constexpr (MODE == CHUNKED) closest_hit_chunked<RECORD>(C, p, r, alive, live, h);
    else if constexpr (MODE == BVH) closest_hit_bvh<RECORD>(p, r, h);
    else closest_hit_hbm(T, C, p, r, alive, live, h);

    const bool hit = h.bt < inf;
    const float t_safe = hit ? h.bt : 1.0f;
    const float px = r.ox + t_safe * r.dx;
    const float py = r.oy + t_safe * r.dy;
    const float pz = r.oz + t_safe * r.dz;
    const float inv_r = 1.0f / (h.hrad != 0.0f ? h.hrad : 1.0f);
    float nx = (px - h.hx) * inv_r;
    float ny = (py - h.hy) * inv_r;
    float nz = (pz - h.hz) * inv_r;
    const float d_dot_n = r.dx * nx + r.dy * ny + r.dz * nz;
    const bool front = d_dot_n < 0.0f;
    const float sgn = front ? 1.0f : -1.0f;
    nx = nx * sgn; ny = ny * sgn; nz = nz * sgn;

    // sky on a miss (src/camera_cpu.h:23-25)
    const float inv_len = 1.0f / sqrtf(fmaxf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz, 1e-20f));
    const float m = (alive && !hit) ? 1.0f : 0.0f;
    if constexpr (MISSREC) {  // record the miss instead (megakernel.py:641-649); it happens once
      if (m > 0.0f) {
        mdx = r.dx; mdy = r.dy; mdz = r.dz;
        mtr = thr_r; mtg = thr_g; mtb = thr_b;
      }
    } else {
      const float sky_a = 0.5f * (r.dy * inv_len + 1.0f);
      rad_r = rad_r + m * thr_r * (1.0f - sky_a + sky_a * 0.5f);
      rad_g = rad_g + m * thr_g * (1.0f - sky_a + sky_a * 0.7f);
      rad_b = rad_b + m * thr_b * (1.0f - sky_a + sky_a * 1.0f);
    }

    // scatter (src/material.h)
    const float udx = r.dx * inv_len, udy = r.dy * inv_len, udz = r.dz * inv_len;
    float u1 = 0.0f, u2 = 0.0f, u3 = 0.0f, u4 = 0.0f;
    if (!p.zero_draws) {
      uint32_t w[4];
      if constexpr (SEG)  // keyed as the monolithic trace keys this ray's bounce
        bounce_bits(p.seed, slot, (uint32_t)(p.tail.bounce0 + dep), w);
      else
        bounce_bits(p.seed, (uint32_t)ray, (uint32_t)dep, w);
      u1 = bits_to_uniform(w[0]); u2 = bits_to_uniform(w[1]);
      u3 = bits_to_uniform(w[2]); u4 = bits_to_uniform(w[3]);
    }
    // lambertian: normal + unit vector (cylinder map)
    const float z = 2.0f * u1 - 1.0f;
    const float s = sqrtf(fmaxf(1.0f - z * z, 0.0f));
    const float th = 6.283185307179586f * u2;
    const float uvx = s * cosf(th), uvy = s * sinf(th), uvz = z;
    const float lam_x = nx + uvx, lam_y = ny + uvy, lam_z = nz + uvz;
    // metal: reflect + fuzz * ball point (same unit vector, radius u^(1/3))
    const float u_dot_n = udx * nx + udy * ny + udz * nz;
    const float rfl_x = udx - 2.0f * u_dot_n * nx;
    const float rfl_y = udy - 2.0f * u_dot_n * ny;
    const float rfl_z = udz - 2.0f * u_dot_n * nz;
    const float br = expf(logf(fmaxf(u3, 1e-30f)) * 0.3333333333333333f);
    const float fx = uvx * br, fy = uvy * br, fz = uvz * br;
    const float met_x = rfl_x + h.hfz * fx, met_y = rfl_y + h.hfz * fy;
    const float met_z = rfl_z + h.hfz * fz;
    const bool met_ok = (met_x * nx + met_y * ny + met_z * nz) > 0.0f;
    // dielectric: refract or reflect with Schlick (src/material.h:55-71)
    const float ratio = front ? 1.0f / h.hio : h.hio;
    const float cos_t = fminf(-(udx * nx + udy * ny + udz * nz), 1.0f);
    const float s2 = 1.0f - cos_t * cos_t;
    const float sin_t = sqrtf(fmaxf(s2, 0.0f));
    const bool cannot = ratio * sin_t > 1.0f;
    float r0s = (1.0f - ratio) / (1.0f + ratio);
    r0s = r0s * r0s;
    const float one_m = 1.0f - cos_t;
    // SCHLICK3, a planted fault for tests (megakernel.py:683-688): exponent 3
    const float schlick = OPT == SCHLICK3
                              ? r0s + (1.0f - r0s) * one_m * one_m * one_m
                              : r0s + (1.0f - r0s) * one_m * one_m * one_m * one_m * one_m;
    const bool do_refl = cannot || (schlick > u4);
    const float perp_x = ratio * (udx + cos_t * nx);
    const float perp_y = ratio * (udy + cos_t * ny);
    const float perp_z = ratio * (udz + cos_t * nz);
    const float k = fabsf(1.0f - (perp_x * perp_x + perp_y * perp_y + perp_z * perp_z));
    const float spar = -sqrtf(k);
    const float die_x = do_refl ? rfl_x : perp_x + spar * nx;
    const float die_y = do_refl ? rfl_y : perp_y + spar * ny;
    const float die_z = do_refl ? rfl_z : perp_z + spar * nz;

    const bool is_lam = h.hmat == 0, is_met = h.hmat == 1, is_die = h.hmat == 2;
    const float sx = is_lam ? lam_x : (is_met ? met_x : die_x);
    const float sy = is_lam ? lam_y : (is_met ? met_y : die_y);
    const float sz = is_lam ? lam_z : (is_met ? met_z : die_z);
    const bool scattered = !is_met || met_ok;

    const bool hit_live = alive && hit;
    if constexpr (RECORD) {  // megakernel.py:732-742; absorbed metal rays included
      const size_t q = (size_t)dep * gridDim.x * TPB + ray;
      p.res_idx[q] = hit_live ? h.hidx : (alive ? MISS : DEAD);
      p.res_ndx[q] = hit_live ? sx : 0.0f;
      p.res_ndy[q] = hit_live ? sy : 0.0f;
      p.res_ndz[q] = hit_live ? sz : 0.0f;
      p.res_refl[q] = (hit_live && is_die && do_refl) ? 1 : 0;
    }
    if (hit_live) {
      thr_r = thr_r * (is_die ? 1.0f : h.har);
      thr_g = thr_g * (is_die ? 1.0f : h.hag);
      thr_b = thr_b * (is_die ? 1.0f : h.hab);
      r.ox = px; r.oy = py; r.oz = pz;
      r.dx = sx; r.dy = sy; r.dz = sz;
    }
    alive = hit_live && scattered;
    if (!alive) {  // park: every later slab and sphere test misses
      r.ox = 1e18f; r.oy = 1e18f; r.oz = 1e18f;
      r.dx = 1.0f; r.dy = 1.0f; r.dz = 1.0f;
    }
  }
  if constexpr (RECORD) {  // bounces after the warp's last live one (megakernel.py:796-806)
    for (int dep = dep_end; dep < p.max_depth; ++dep) {
      const size_t q = (size_t)dep * gridDim.x * TPB + ray;
      p.res_idx[q] = DEAD;
      p.res_ndx[q] = 0.0f;
      p.res_ndy[q] = 0.0f;
      p.res_ndz[q] = 0.0f;
      p.res_refl[q] = 0;
    }
  }
  if constexpr (SEG) {  // K6: the carried state out, written once
    float* __restrict__ S = p.tail.state_out;
    S[ST_OX * n_rays + ray] = r.ox; S[ST_OY * n_rays + ray] = r.oy;
    S[ST_OZ * n_rays + ray] = r.oz;
    S[ST_DX * n_rays + ray] = r.dx; S[ST_DY * n_rays + ray] = r.dy;
    S[ST_DZ * n_rays + ray] = r.dz;
    S[ST_TM * n_rays + ray] = r.tm;
    S[ST_THR_R * n_rays + ray] = thr_r; S[ST_THR_G * n_rays + ray] = thr_g;
    S[ST_THR_B * n_rays + ray] = thr_b;
    S[ST_RAD_R * n_rays + ray] = rad_r; S[ST_RAD_G * n_rays + ray] = rad_g;
    S[ST_RAD_B * n_rays + ray] = rad_b;
    S[ST_ALIVE * n_rays + ray] = alive ? 1.0f : 0.0f;
    if constexpr (MISSREC) {
      S[ST_MDX * n_rays + ray] = mdx; S[ST_MDY * n_rays + ray] = mdy;
      S[ST_MDZ * n_rays + ray] = mdz;
      S[ST_MTR * n_rays + ray] = mtr; S[ST_MTG * n_rays + ray] = mtg;
      S[ST_MTB * n_rays + ray] = mtb;
    }
  } else {
    p.out[3 * ray + 0] = rad_r;
    p.out[3 * ray + 1] = rad_g;
    p.out[3 * ray + 2] = rad_b;
    if constexpr (MISSREC) {
      p.tail.mdir[3 * ray + 0] = mdx; p.tail.mdir[3 * ray + 1] = mdy;
      p.tail.mdir[3 * ray + 2] = mdz;
      p.tail.mthr[3 * ray + 0] = mtr; p.tail.mthr[3 * ray + 1] = mtg;
      p.tail.mthr[3 * ray + 2] = mtb;
    }
  }
}

__global__ void philox_kernel(uint32_t* out, int n, uint32_t seed, uint32_t bounce) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t w[4];
  bounce_bits(seed, (uint32_t)i, bounce, w);
  for (int q = 0; q < 4; ++q) out[4 * i + q] = w[q];
}

// Dynamic shared memory of one block, by what the kernel stages there.
template <int MODE>
size_t smem_bytes(const Params& p) {
  const size_t boxes = sizeof(float) * (8 * (size_t)p.n_front + 8 * (size_t)p.n_words_pad +
                                        8 * (size_t)p.n_super);
  if (MODE == FRONT)
    return sizeof(float) * ((size_t)N_ROWS * p.n_cols + 2 * (size_t)p.n_front) + boxes;
  if (MODE == CHUNKED) return CHUNK_SMEM_BYTES;
  if (MODE == HBM) return LIST_SMEM_BYTES;
  return 0;
}

template <int MODE, bool RECORD, bool MISSREC = false, bool SEG = false, int OPT = NO_OPT>
int launch(const typename KernelParams<MODE, RECORD, MISSREC, SEG, OPT>::type& p, int n_rays,
           cudaStream_t stream) {
  if (n_rays <= 0 || n_rays % TPB != 0) return (int)cudaErrorInvalidValue;
  size_t smem = smem_bytes<MODE>(p);
  if constexpr (MODE == FRONT && SEG) smem += LIST_SMEM_BYTES;  // the front segment's live list
  if constexpr (OPT == FRONT_OPTS) {
    static_assert(MODE == FRONT, "K3's options are options of the front");
    if (p.opts.ksub) {
      if (RECORD || SEG || !p.opts.bf || p.opts.ksub > 31 || p.opts.n_bf < p.opts.ksub)
        return (int)cudaErrorInvalidValue;
      smem += sizeof(float) * 8 * (size_t)p.opts.n_bf;
    }
  }
  if constexpr (RECORD) {
    if (p.max_depth > 0 && !(p.res_idx && p.res_ndx && p.res_ndy && p.res_ndz && p.res_refl))
      return (int)cudaErrorInvalidValue;
  }
  if constexpr (SEG) {
    if (!(p.tail.state_in && p.tail.state_out && p.tail.slot) || p.tail.bounce0 < 0)
      return (int)cudaErrorInvalidValue;
  } else if constexpr (MISSREC) {
    if (!(p.tail.mdir && p.tail.mthr)) return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)trace_kernel<MODE, RECORD, MISSREC, SEG, OPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  trace_kernel<MODE, RECORD, MISSREC, SEG, OPT><<<n_rays / TPB, TPB, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

Params base_params(const float* origin, const float* direction, const float* time, float* out,
                   const float* sph, int n_cols, unsigned seed, int max_depth, float t_min,
                   int zero_draws) {
  Params p{};
  p.origin = origin; p.direction = direction; p.time = time; p.out = out;
  p.sph = sph; p.n_cols = n_cols;
  p.seed = seed; p.max_depth = max_depth; p.t_min = t_min; p.zero_draws = zero_draws;
  p.repack = 1;
  return p;
}

bool front_ok(int n_front, int repack) {
  return n_front > 0 && n_front % WORD == 0 && repack > 0 && WORD % repack == 0;
}

void set_front(Params& p, const float* ff, const int* fi, int n_front, const float* wf,
               int n_words_pad, const float* sf, int n_super, int repack) {
  p.ff = ff; p.fi = fi; p.n_front = n_front;
  p.wf = wf; p.n_words_pad = n_words_pad;
  p.sf = sf; p.n_super = n_super;
  p.repack = repack;
}

// `base` with the residual planes: RecordParams from Params,
// LargeRecordParams from LargeParams.
template <class Rec, class Base>
Rec record_params(const Base& base, int* idx, float* ndx, float* ndy, float* ndz,
                  unsigned char* refl) {
  Rec p;
  static_cast<Base&>(p) = base;
  p.res_idx = idx; p.res_ndx = ndx; p.res_ndy = ndy; p.res_ndz = ndz; p.res_refl = refl;
  return p;
}

LargeParams large_params(const Params& base) {
  LargeParams p{};
  static_cast<Params&>(p) = base;
  return p;
}

template <class Base>
WithTail<Base> with_tail(const Base& base, const TailParams& tail) {
  WithTail<Base> p;
  static_cast<Base&>(p) = base;
  p.tail = tail;
  return p;
}

template <class Base>
WithOpts<Base> with_opts(const Base& base, const FrontOpts& opts) {
  WithOpts<Base> p;
  static_cast<Base&>(p) = base;
  p.opts = opts;
  return p;
}

FrontOpts front_opts(const float* bf, int n_bf, int ksub, int word_earlyout) {
  FrontOpts o{};
  o.bf = bf; o.n_bf = n_bf; o.ksub = ksub; o.word_earlyout = word_earlyout;
  return o;
}

bool opts_on(const FrontOpts& o) { return o.ksub != 0 || o.word_earlyout != 0; }

// The forward kernel of MODE over `p` or, given the miss planes, its
// record_miss version.
template <int MODE, class P>
int launch_trace(const P& p, int n_rays, cudaStream_t stream, float* mdir, float* mthr) {
  if (!mdir && !mthr) return launch<MODE, false>(p, n_rays, stream);
  TailParams t{};
  t.mdir = mdir; t.mthr = mthr;
  return launch<MODE, false, true>(with_tail(p, t), n_rays, stream);
}

// The same with K3's options: their own instantiations, plain and record_miss.
int launch_trace_opts(const Params& p, const FrontOpts& o, int n_rays, cudaStream_t stream,
                      float* mdir, float* mthr) {
  if (!mdir && !mthr)
    return launch<FRONT, false, false, false, FRONT_OPTS>(with_opts(p, o), n_rays, stream);
  TailParams t{};
  t.mdir = mdir; t.mthr = mthr;
  return launch<FRONT, false, true, false, FRONT_OPTS>(with_opts(with_tail(p, t), o), n_rays,
                                                       stream);
}

// K6 over MODE (CHUNKED or FRONT): one depth segment of p.max_depth
// bounces from the carried state, plain, with the miss planes carried
// (record_miss: 20 state planes) or recording the residual planes (res_idx
// given). The JAX package's segment call takes one or the other, never both.
// With OPT = FRONT_OPTS (MODE FRONT), the same three with K3's options `o`.
template <int MODE, int OPT = NO_OPT>
int launch_segment(const Params& p, int n_rays, cudaStream_t stream, const float* state_in,
                   float* state_out, const int* slot, int bounce0, int record_miss,
                   int* res_idx, float* res_ndx, float* res_ndy, float* res_ndz,
                   unsigned char* res_refl, const FrontOpts& o = FrontOpts{}) {
  TailParams t{};
  t.state_in = state_in; t.state_out = state_out; t.slot = slot; t.bounce0 = bounce0;
  auto opt = [&](const auto& q) {
    if constexpr (OPT == FRONT_OPTS) return with_opts(q, o);
    else return q;
  };
  if (res_idx) {
    if (record_miss) return (int)cudaErrorInvalidValue;
    return launch<MODE, true, false, true, OPT>(
        opt(with_tail(
            record_params<RecordParams>(p, res_idx, res_ndx, res_ndy, res_ndz, res_refl), t)),
        n_rays, stream);
  }
  if (record_miss)
    return launch<MODE, false, true, true, OPT>(opt(with_tail(p, t)), n_rays, stream);
  return launch<MODE, false, false, true, OPT>(opt(with_tail(p, t)), n_rays, stream);
}

// Blocks of TPB threads one SM holds of CHUNKED's instantiation (RECORD,
// MISSREC, SEG), with its dynamic shared memory.
template <bool RECORD, bool MISSREC, bool SEG>
int chunked_occupancy(int* blocks) {
  const void* fn = (const void*)trace_kernel<CHUNKED, RECORD, MISSREC, SEG>;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)CHUNK_SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, TPB, CHUNK_SMEM_BYTES);
}

// Blocks of TPB threads one SM holds of K8's instantiation (RECORD,
// MISSREC); it takes no shared memory.
template <bool RECORD, bool MISSREC>
int bvh_occupancy(int* blocks) {
  const void* fn = (const void*)trace_kernel<BVH, RECORD, MISSREC>;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, TPB, 0);
}

// Blocks of TPB threads one SM holds of the front instantiation (RECORD,
// MISSREC, SEG, OPT), with the dynamic shared memory of a front of these
// table sizes, n_bf sub-block boxes and, where it takes one, the live list.
template <bool RECORD, bool MISSREC, bool SEG, int OPT>
int front_occupancy(const Params& p, int n_bf, int* blocks) {
  const void* fn = (const void*)trace_kernel<FRONT, RECORD, MISSREC, SEG, OPT>;
  const size_t smem = smem_bytes<FRONT>(p) + sizeof(float) * 8 * (size_t)n_bf +
                      (SEG ? LIST_SMEM_BYTES : 0);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, TPB, smem);
}

template <int OPT>
int front_occupancy_of(const Params& p, int n_bf, int record, int record_miss, int segment,
                       int* blocks) {
  if (segment) {
    if (record) return front_occupancy<true, false, true, OPT>(p, n_bf, blocks);
    if (record_miss) return front_occupancy<false, true, true, OPT>(p, n_bf, blocks);
    return front_occupancy<false, false, true, OPT>(p, n_bf, blocks);
  }
  if (record) return front_occupancy<true, false, false, OPT>(p, n_bf, blocks);
  if (record_miss) return front_occupancy<false, true, false, OPT>(p, n_bf, blocks);
  return front_occupancy<false, false, false, OPT>(p, n_bf, blocks);
}

}  // namespace

extern "C" {

int rtp_rays_per_block() { return TPB; }

const char* rtp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K1 + K3: front-culled closest hit over the front tables. The forward
// entries take the miss planes mdir and mthr ([n_rays, 3] each, or both
// null): given, the kernel records the direction and throughput at each
// ray's miss instead of adding the built-in sky (record_miss). The front
// entries take K3's options last: the sub-block boxes bf ([8, n_bf], or
// null with ksub 0) and word_earlyout; with neither they launch the plain
// front kernels.
int rtp_trace_front(const float* origin, const float* direction, const float* time, float* out,
                    int n_rays, const float* sph, int n_cols, const float* ff, const int* fi,
                    int n_front, const float* wf, int n_words_pad, const float* sf,
                    int n_super, int repack, const float* bf, int n_bf, int ksub,
                    int word_earlyout, unsigned seed, int max_depth, float t_min,
                    int zero_draws, float* mdir, float* mthr, void* stream) {
  if (!front_ok(n_front, repack)) return (int)cudaErrorInvalidValue;
  Params p = base_params(origin, direction, time, out, sph, n_cols, seed, max_depth, t_min,
                         zero_draws);
  set_front(p, ff, fi, n_front, wf, n_words_pad, sf, n_super, repack);
  const FrontOpts o = front_opts(bf, n_bf, ksub, word_earlyout);
  if (opts_on(o)) return launch_trace_opts(p, o, n_rays, (cudaStream_t)stream, mdir, mthr);
  return launch_trace<FRONT>(p, n_rays, (cudaStream_t)stream, mdir, mthr);
}

// K5 (front): K1 + K3 recording the same planes; idx holds columns of the
// front's padded table (the wrapper maps them through front.remap). Of K3's
// options it takes word_earlyout (ksub must be 0), as the JAX package's
// front core does.
int rtp_record_front(const float* origin, const float* direction, const float* time,
                     float* out, int n_rays, const float* sph, int n_cols, const float* ff,
                     const int* fi, int n_front, const float* wf, int n_words_pad,
                     const float* sf, int n_super, int repack, const float* bf, int n_bf,
                     int ksub, int word_earlyout, unsigned seed, int max_depth, float t_min,
                     int zero_draws, int* res_idx, float* res_ndx, float* res_ndy,
                     float* res_ndz, unsigned char* res_refl, void* stream) {
  if (!front_ok(n_front, repack) || ksub != 0) return (int)cudaErrorInvalidValue;
  Params p = base_params(origin, direction, time, out, sph, n_cols, seed, max_depth, t_min,
                         zero_draws);
  set_front(p, ff, fi, n_front, wf, n_words_pad, sf, n_super, repack);
  const RecordParams rp =
      record_params<RecordParams>(p, res_idx, res_ndx, res_ndy, res_ndz, res_refl);
  if (word_earlyout)
    return launch<FRONT, true, false, false, FRONT_OPTS>(
        with_opts(rp, front_opts(bf, n_bf, ksub, word_earlyout)), n_rays, (cudaStream_t)stream);
  return launch<FRONT, true>(rp, n_rays, (cudaStream_t)stream);
}

// K1 + K2: the brute closest hit over a [16, n_spheres] table of any size,
// staged in chunks (see CHUNKED above).
int rtp_trace_brute_chunked(const float* origin, const float* direction, const float* time,
                            float* out, int n_rays, const float* sph, int n_spheres,
                            unsigned seed, int max_depth, float t_min, int zero_draws,
                            float* mdir, float* mthr, void* stream) {
  Params p = base_params(origin, direction, time, out, sph, n_spheres, seed, max_depth, t_min,
                         zero_draws);
  return launch_trace<CHUNKED>(p, n_rays, (cudaStream_t)stream, mdir, mthr);
}

// K1 + K2 with the planted fault SCHLICK3 (Schlick's exponent 3, not 5):
// the per-material-region test's proof that it catches a physics bug.
int rtp_trace_brute_chunked_schlick3(const float* origin, const float* direction,
                                     const float* time, float* out, int n_rays, const float* sph,
                                     int n_spheres, unsigned seed, int max_depth, float t_min,
                                     int zero_draws, void* stream) {
  Params p = base_params(origin, direction, time, out, sph, n_spheres, seed, max_depth, t_min,
                         zero_draws);
  return launch<CHUNKED, false, false, false, SCHLICK3>(p, n_rays, (cudaStream_t)stream);
}

// K5 (brute): K1 + K2 recording the residual planes, each [max_depth,
// n_rays]: idx (winner column / MISS / DEAD), ndx/ndy/ndz (scattered
// direction of a live hit, else 0), refl (dielectric reflect branch).
int rtp_record_brute_chunked(const float* origin, const float* direction, const float* time,
                             float* out, int n_rays, const float* sph, int n_spheres,
                             unsigned seed, int max_depth, float t_min, int zero_draws,
                             int* res_idx, float* res_ndx, float* res_ndy, float* res_ndz,
                             unsigned char* res_refl, void* stream) {
  Params p = base_params(origin, direction, time, out, sph, n_spheres, seed, max_depth, t_min,
                         zero_draws);
  return launch<CHUNKED, true>(
      record_params<RecordParams>(p, res_idx, res_ndx, res_ndy, res_ndz, res_refl), n_rays,
      (cudaStream_t)stream);
}

// K1 + K8: the BVH walk. `sph` is the sphere-major [n_spheres, 16] table of
// the leaf-ordered scene, `nodes` the [n_nodes, 8] node words.
int rtp_trace_bvh(const float* origin, const float* direction, const float* time, float* out,
                  int n_rays, const float* sph, int n_spheres, const float* nodes, int n_nodes,
                  unsigned seed, int max_depth, float t_min, int zero_draws, float* mdir,
                  float* mthr, void* stream) {
  if (n_nodes <= 0 || !nodes) return (int)cudaErrorInvalidValue;
  LargeParams p = large_params(base_params(origin, direction, time, out, sph, n_spheres, seed,
                                           max_depth, t_min, zero_draws));
  p.nodes = nodes;
  return launch_trace<BVH>(p, n_rays, (cudaStream_t)stream, mdir, mthr);
}

// K5 (bvh): K1 + K8 recording the residual planes; idx is a sphere of the
// leaf-ordered scene.
int rtp_record_bvh(const float* origin, const float* direction, const float* time, float* out,
                   int n_rays, const float* sph, int n_spheres, const float* nodes, int n_nodes,
                   unsigned seed, int max_depth, float t_min, int zero_draws, int* res_idx,
                   float* res_ndx, float* res_ndy, float* res_ndz, unsigned char* res_refl,
                   void* stream) {
  if (n_nodes <= 0 || !nodes) return (int)cudaErrorInvalidValue;
  LargeParams p = large_params(base_params(origin, direction, time, out, sph, n_spheres, seed,
                                           max_depth, t_min, zero_draws));
  p.nodes = nodes;
  return launch<BVH, true>(
      record_params<LargeRecordParams>(p, res_idx, res_ndx, res_ndy, res_ndz, res_refl), n_rays,
      (cudaStream_t)stream);
}

// K1 + K7: front culling over a sphere-major [n_front * 128, 16] table in
// global memory, one 128-column block per subtree; fi is [1, n_front]
// (padded counts); bf ([8, n_bf], with ksub sub-blocks a subtree) may be
// null. Every table stays in global memory (shared memory holds the live
// list).
int rtp_trace_front_hbm(const float* origin, const float* direction, const float* time,
                        float* out, int n_rays, const float* sph, const float* ff,
                        const int* fi, int n_front, const float* wf, int n_words_pad,
                        const float* sf, int n_super, const float* bf, int n_bf, int ksub,
                        int word_earlyout, unsigned seed, int max_depth,
                        float t_min, int zero_draws, float* mdir, float* mthr, void* stream) {
  if (!front_ok(n_front, 1) || (ksub != 0 && (ksub != BLOCK / 8 || !bf || n_bf < n_front * ksub)))
    return (int)cudaErrorInvalidValue;
  Params base = base_params(origin, direction, time, out, sph, n_front * BLOCK, seed, max_depth,
                            t_min, zero_draws);
  set_front(base, ff, fi, n_front, wf, n_words_pad, sf, n_super, 1);
  LargeParams p = large_params(base);
  p.bf = bf; p.n_bf = n_bf; p.ksub = ksub;
  p.word_earlyout = word_earlyout;
  return launch_trace<HBM>(p, n_rays, (cudaStream_t)stream, mdir, mthr);
}

// K6, the resumable depth segment (replaces _segment_call,
// megakernel.py:1759, pallas_call at :1818): `depth` bounces of K1 from the
// carried state `state_in` ([n_planes, n_rays], the ST_* rows: 14 planes,
// 20 with record_miss) to `state_out` (the same planes; the time plane is
// copied through). Ray r draws with Philox counter (slot[r], bounce0 + k)
// at the segment's bounce k: the words the monolithic trace draws for that
// ray's bounce, so segments compute the monolithic kernel's paths. With
// res_idx (and the other residual planes, [depth, n_rays] each) the segment
// records K5's residuals, rows indexed by segment-local bounce; then
// record_miss must be 0. This one: the brute scan over a sphere table of
// any size, staged in chunks.
int rtp_segment_brute_chunked(const float* state_in, float* state_out, const int* slot,
                              int n_rays, const float* sph, int n_spheres, unsigned seed,
                              int bounce0, int depth, float t_min, int zero_draws,
                              int record_miss, int* res_idx, float* res_ndx, float* res_ndy,
                              float* res_ndz, unsigned char* res_refl, void* stream) {
  Params p = base_params(nullptr, nullptr, nullptr, nullptr, sph, n_spheres, seed, depth, t_min,
                         zero_draws);
  return launch_segment<CHUNKED>(p, n_rays, (cudaStream_t)stream, state_in, state_out, slot,
                                 bounce0, record_miss, res_idx, res_ndx, res_ndy, res_ndz,
                                 res_refl);
}

// K6 over the front tables (K3's culling); residual idx are padded columns.
// Of K3's options it takes word_earlyout (ksub must be 0), as the JAX
// package's front segment does.
int rtp_segment_front(const float* state_in, float* state_out, const int* slot, int n_rays,
                      const float* sph, int n_cols, const float* ff, const int* fi, int n_front,
                      const float* wf, int n_words_pad, const float* sf, int n_super,
                      int repack, const float* bf, int n_bf, int ksub, int word_earlyout,
                      unsigned seed, int bounce0, int depth, float t_min, int zero_draws,
                      int record_miss, int* res_idx, float* res_ndx, float* res_ndy,
                      float* res_ndz, unsigned char* res_refl, void* stream) {
  if (!front_ok(n_front, repack) || ksub != 0) return (int)cudaErrorInvalidValue;
  Params p = base_params(nullptr, nullptr, nullptr, nullptr, sph, n_cols, seed, depth, t_min,
                         zero_draws);
  set_front(p, ff, fi, n_front, wf, n_words_pad, sf, n_super, repack);
  if (word_earlyout)
    return launch_segment<FRONT, FRONT_OPTS>(p, n_rays, (cudaStream_t)stream, state_in,
                                             state_out, slot, bounce0, record_miss, res_idx,
                                             res_ndx, res_ndy, res_ndz, res_refl,
                                             front_opts(bf, n_bf, ksub, word_earlyout));
  return launch_segment<FRONT>(p, n_rays, (cudaStream_t)stream, state_in, state_out, slot,
                               bounce0, record_miss, res_idx, res_ndx, res_ndy, res_ndz,
                               res_refl);
}

// The occupancy of the chunked brute scan's six instantiations: blocks per
// SM of the forward (record 0, record_miss 0, segment 0), recording,
// record_miss and K6 kinds (segment 1 with record or record_miss).
int rtp_chunked_blocks_per_sm(int record, int record_miss, int segment, int* blocks) {
  if (record && record_miss) return (int)cudaErrorInvalidValue;
  if (segment) {
    if (record) return chunked_occupancy<true, false, true>(blocks);
    if (record_miss) return chunked_occupancy<false, true, true>(blocks);
    return chunked_occupancy<false, false, true>(blocks);
  }
  if (record) return chunked_occupancy<true, false, false>(blocks);
  if (record_miss) return chunked_occupancy<false, true, false>(blocks);
  return chunked_occupancy<false, false, false>(blocks);
}

// The occupancy of K7's two instantiations: blocks per SM of the forward
// and record_miss kinds, with their dynamic shared memory (the live list).
int rtp_hbm_blocks_per_sm(int record_miss, int* blocks) {
  const void* fn = record_miss ? (const void*)trace_kernel<HBM, false, true>
                               : (const void*)trace_kernel<HBM, false>;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, TPB, LIST_SMEM_BYTES);
}

// The occupancy of K8's three instantiations: blocks per SM of the
// forward, recording and record_miss kinds.
int rtp_bvh_blocks_per_sm(int record, int record_miss, int* blocks) {
  if (record && record_miss) return (int)cudaErrorInvalidValue;
  if (record) return bvh_occupancy<true, false>(blocks);
  if (record_miss) return bvh_occupancy<false, true>(blocks);
  return bvh_occupancy<false, false>(blocks);
}

// The occupancy of the twelve front instantiations: blocks per SM of the
// forward (K3, plain or record_miss), recording (K5) and segment (K6:
// plain, record_miss or recording) kinds, with K3's options (opts) or
// without, over a front of these table sizes (n_bf sub-block boxes: the
// forward kinds with options alone).
int rtp_front_blocks_per_sm(int n_cols, int n_front, int n_words_pad, int n_super, int n_bf,
                            int record, int record_miss, int segment, int opts, int* blocks) {
  if ((record && record_miss) || (n_bf && (!opts || record || segment)))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.n_cols = n_cols; p.n_front = n_front; p.n_words_pad = n_words_pad; p.n_super = n_super;
  if (opts) return front_occupancy_of<FRONT_OPTS>(p, n_bf, record, record_miss, segment, blocks);
  return front_occupancy_of<NO_OPT>(p, n_bf, record, record_miss, segment, blocks);
}

// The generator alone: the four words of `bounce` for ray slots [0, n),
// written as out[4*i + q]. Lets a check hold it against ops/rng.py.
int rtp_philox(unsigned* out, int n, unsigned seed, int bounce, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  philox_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(out, n, seed,
                                                                   (uint32_t)bounce);
  return (int)cudaGetLastError();
}

}  // extern "C"
