// The raster tracer's traversal: each 1024-ray packet walks its tile span
// of binned entries, then the overflow segment, in one launch per view,
// hand-written for Hopper (sm_90a).
//
// Stands for intrinsic_neural_fields_tpu/ops/raster.py:_traverse, which the
// JAX package leaves to XLA (lax.map over the packets, a while_loop per
// packet over its tile span and then over the overflow segment with an
// early exit). That is no Pallas kernel, so this replaces no TPU kernel.
// It was added because the port's plain traversal (ops/raster.py:
// traverse_plain) runs the packets in lockstep from the host: ~40 small
// elementwise kernels a chunk step over [packets, 1024, 256] f32
// intermediates, about a thousand host torch calls and one device->host
// read a view. A traced 512^2 render orbit put the largest device time of
// the frame and a third of its device idle time there.
//
// One CTA of 1024 threads per packet, one thread per ray. A CTA takes its
// rays' min and max tile id (the twin's clamped, truncated tile of each
// coordinate, Morton-interleaved), reads the tile offsets for its chunk
// span [c0, c1), and computes each ray's scene-box cap. Before each chunk
// it reduces the packet-wide frontier max(min(best_t, cap)) over its rays
// and skips the chunk when the chunk's depth bound is at or above it: the
// twin's packet-level test, so the same chunks are tested in the same
// order. The overflow segment's bounds ascend, so its walk stops at the
// first chunk that the test rejects (the twin masks the rest). A tested
// chunk's 256 entries x 12 floats (12 KB of the row-major table) are
// staged in shared memory; every thread reads each entry as three float4
// broadcasts and tests it with the twin's expressions in the twin's order
// ((d0*n0 + d1*n1) + d2*n2, t = tnum / dn, u = oa + t*dA, v = ob + t*dB,
// the same hit predicate), each product and sum rounded alone (-fmad=false)
// and the division IEEE. A strict < keeps the first minimum in visit
// order, as the twin's min over the chunk and its strict update do. So the
// kernel gives the twin's (best_t, best_e) to the bit. Missing rays of a
// ragged last packet take no part in any reduction (the twin repeats the
// last ray there, which moves neither the tile range nor the frontier).
//
// Bound on this card: the f32 pair tests, ~25 FLOPs each outside the
// tensor cores, against 67 TFLOP/s; the tables are read from L2 once per
// packet and chunk. The design keeps every test in registers with its
// operands in shared memory (no intermediate leaves the SM), and fits two
// CTAs on an SM (at most 32 registers a thread), so the 256 packets of a
// 512^2 view are resident in one wave on 132 SMs. What is left unbound is
// the walk of the longest packet.
//
// With `counts`, each CTA adds the chunks its walk reached (entry chunks
// and overflow chunks up to and including the one that stopped it) and
// the chunks it tested to counts[0] and counts[1].

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int RAY_TILE = 1024;  // rays per packet = threads per CTA
constexpr int CHUNK = 256;      // entries per chunk
constexpr int ROW = 12;         // floats per entry: n, a, b, tnum, oa, ob
constexpr int TILE_PX = 32;
constexpr int WARPS = RAY_TILE / 32;
constexpr int STAGE_F4 = CHUNK * ROW / 4;  // 768 float4s

struct Consts {
  float dn_eps, t_eps, b_lo, b_hi, cap_scale, cap_add, tiny;
};

__device__ __forceinline__ unsigned spread(unsigned v) {
  v &= 0xFFFFu;
  v = (v | (v << 8)) & 0x00FF00FFu;
  v = (v | (v << 4)) & 0x0F0F0F0Fu;
  v = (v | (v << 2)) & 0x33333333u;
  v = (v | (v << 1)) & 0x55555555u;
  return v;
}

// The twin's (c / TILE_PX).clamp(-1, n).to(int32).clamp(0, n - 1).
__device__ __forceinline__ int tile_of(float c, int n) {
  const float x = fminf(fmaxf(c / (float)TILE_PX, -1.0f), (float)n);
  const int i = (int)x;
  return min(max(i, 0), n - 1);
}

// Block-wide reductions over the CTA's 1024 threads; every thread gets the
// result. The trailing barrier lets the next reduction reuse `slots`.
__device__ __forceinline__ float block_max(float v, float* slots) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = slots[0];
  for (int w = 1; w < WARPS; ++w) r = fmaxf(r, slots[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ int block_min_int(int v, int* slots) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = slots[0];
  for (int w = 1; w < WARPS; ++w) r = min(r, slots[w]);
  __syncthreads();
  return r;
}

// Test one staged chunk whose first entry is `s`: strict-< update of the
// ray's best (t, entry).
__device__ __forceinline__ void test_chunk(const float4* __restrict__ stage, float d0, float d1,
                                           float d2, int s, const Consts& k, float& bt, int& be) {
#pragma unroll 2
  for (int j = 0; j < CHUNK; ++j) {
    const float4 p = stage[3 * j];      // n0 n1 n2 a0
    const float4 q = stage[3 * j + 1];  // a1 a2 b0 b1
    const float4 r = stage[3 * j + 2];  // b2 tnum oa ob
    const float dn = (d0 * p.x + d1 * p.y) + d2 * p.z;
    const float dA = (d0 * p.w + d1 * q.x) + d2 * q.y;
    const float dB = (d0 * q.z + d1 * q.w) + d2 * r.x;
    const float t = r.y / dn;
    const float u = r.z + t * dA;
    const float v = r.w + t * dB;
    const bool hit = fabsf(dn) > k.dn_eps && t > k.t_eps && u >= k.b_lo && v >= k.b_lo &&
                     u + v <= k.b_hi;
    if (hit && t < bt) {
      bt = t;
      be = s + j;
    }
  }
}

__global__ void __launch_bounds__(RAY_TILE, 2)
raster_traverse_kernel(const float* __restrict__ ed_rows, const long long* __restrict__ offsets,
                       const float* __restrict__ czmin_e, const float* __restrict__ czmin_o,
                       const long long* __restrict__ o_chunks, int e_pad,
                       const float* __restrict__ scene_min, const float* __restrict__ scene_max,
                       const float* __restrict__ origins, int origin_stride,
                       const float* __restrict__ dirs, const float* __restrict__ coords, int R,
                       int Tx, int Ty, Consts k, float* __restrict__ best_t,
                       long long* __restrict__ best_e, unsigned long long* __restrict__ counts) {
  __shared__ float4 stage[STAGE_F4];
  __shared__ float fslots[WARPS];
  __shared__ int islots[WARPS];

  const int ray = blockIdx.x * RAY_TILE + threadIdx.x;
  const bool live = ray < R;
  const int rr = live ? ray : R - 1;

  // The packet's tile span: entries [offsets[tmin], offsets[tmax + 1]).
  const float* xy = coords + 2LL * rr;
  const int tid = (int)(spread((unsigned)tile_of(xy[0], Tx)) |
                        (spread((unsigned)tile_of(xy[1], Ty)) << 1));
  const int tmin = block_min_int(live ? tid : INT_MAX, islots);
  const int tmax = -block_min_int(live ? -tid : INT_MAX, islots);
  const long long n_e_chunks = e_pad / CHUNK;
  const long long c0 = offsets[tmin] / CHUNK;
  const long long c1 = llmin((offsets[tmax + 1] + CHUNK - 1) / CHUNK, n_e_chunks);

  // The ray's search cap: its scene-AABB exit distance, the twin's f32 ops.
  const float d0 = dirs[3LL * rr], d1 = dirs[3LL * rr + 1], d2 = dirs[3LL * rr + 2];
  float t_near = -INFINITY, t_far = INFINITY;
  {
    const float d[3] = {d0, d1, d2};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float o = origins[(long long)origin_stride * rr + a];
      const float ds = fabsf(d[a]) > k.dn_eps ? d[a] : (d[a] < 0.0f ? -k.tiny : k.tiny);
      const float t1 = (scene_min[a] - o) / ds;
      const float t2 = (scene_max[a] - o) / ds;
      t_near = fmaxf(t_near, fminf(t1, t2));
      t_far = fminf(t_far, fmaxf(t1, t2));
    }
  }
  const float cap = t_far >= fmaxf(t_near, 0.0f) ? t_far * k.cap_scale + k.cap_add : -INFINITY;

  float bt = INFINITY;
  int be = -1;
  unsigned long long reached = 0, tested = 0;
  const float4* rows = reinterpret_cast<const float4*>(ed_rows);

  auto stage_and_test = [&](long long s) {
    // The reduction before this call ended in a barrier: nobody still
    // reads the previous chunk.
    if (threadIdx.x < STAGE_F4) stage[threadIdx.x] = rows[s * (ROW / 4) + threadIdx.x];
    __syncthreads();
    if (live) test_chunk(stage, d0, d1, d2, (int)s, k, bt, be);
  };

  // Entry span: chunks in (tile, depth) order; bounds are not monotone
  // across tiles, so a chunk that cannot improve is skipped, not a stop.
  for (long long c = c0; c < c1; ++c) {
    const float front = block_max(live ? fminf(bt, cap) : -INFINITY, fslots);
    ++reached;
    if (!(czmin_e[c] < front)) continue;
    ++tested;
    stage_and_test(c * CHUNK);
  }
  // Overflow segment: bounds ascend, so the first rejected chunk ends it.
  const long long oc = *o_chunks;
  for (long long c = 0; c < oc; ++c) {
    const float front = block_max(live ? fminf(bt, cap) : -INFINITY, fslots);
    ++reached;
    if (!(czmin_o[c] < front)) break;
    ++tested;
    stage_and_test((long long)e_pad + c * CHUNK);
  }

  if (live) {
    best_t[ray] = bt;
    best_e[ray] = be;
  }
  if (counts != nullptr && threadIdx.x == 0) {
    atomicAdd(&counts[0], reached);
    atomicAdd(&counts[1], tested);
  }
}

}  // namespace

extern "C" int raster_traverse_ray_tile() { return RAY_TILE; }
extern "C" int raster_traverse_chunk() { return CHUNK; }
extern "C" int raster_traverse_tile_px() { return TILE_PX; }

// Plain C entry point (loaded with ctypes). ed_rows [e_tot, 12] f32 (16-byte
// aligned, e_tot a multiple of 256), offsets i64 per tile id + 1, czmin_e
// [e_pad / 256] and czmin_o f32, o_chunks an i64 scalar on the device,
// scene_min/scene_max [3] f32; origins [R, 3] f32 rows `origin_stride`
// floats apart (0: one shared origin), dirs [R, 3] and coords [R, 2] f32;
// consts: dn_eps, t_eps, b_lo, b_hi, cap_scale, cap_add and the tiny
// direction substitute, as f32. Writes best_t [R] f32 and best_e [R] i64;
// counts: two u64 on the device that the CTAs add to, or nullptr. One
// launch of ceil(R / 1024) CTAs on `stream`; returns cudaGetLastError().
extern "C" int raster_traverse(const float* ed_rows, const long long* offsets,
                               const float* czmin_e, const float* czmin_o,
                               const long long* o_chunks, int e_pad, const float* scene_min,
                               const float* scene_max, const float* origins, int origin_stride,
                               const float* dirs, const float* coords, int R, int Tx, int Ty,
                               float dn_eps, float t_eps, float b_lo, float b_hi,
                               float cap_scale, float cap_add, float tiny, float* best_t,
                               long long* best_e, unsigned long long* counts, void* stream) {
  if (R <= 0) return R == 0 ? 0 : (int)cudaErrorInvalidValue;
  if ((uintptr_t)ed_rows % 16 != 0 || e_pad % CHUNK != 0) return (int)cudaErrorInvalidValue;
  const Consts k{dn_eps, t_eps, b_lo, b_hi, cap_scale, cap_add, tiny};
  const unsigned ctas = (unsigned)((R + RAY_TILE - 1) / RAY_TILE);
  raster_traverse_kernel<<<ctas, RAY_TILE, 0, (cudaStream_t)stream>>>(
      ed_rows, offsets, czmin_e, czmin_o, o_chunks, e_pad, scene_min, scene_max, origins,
      origin_stride, dirs, coords, R, Tx, Ty, k, best_t, best_e, counts);
  return (int)cudaGetLastError();
}
