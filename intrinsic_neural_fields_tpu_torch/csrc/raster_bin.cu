// The raster tracer's binning: a view's per-face projection, tile spans,
// depth keys, compaction and entry tables in three launches, hand-written
// for Hopper (sm_90a). The two stable sorts between the second and the
// third launch stay the caller's (ops/raster.py:argsort_keys).
//
// Stands for the binning of intrinsic_neural_fields_tpu/ops/raster.py:374
// (_bin_faces), which the JAX package leaves to XLA. That is no Pallas
// kernel, so this replaces no TPU kernel. It was added because the port's
// plain binning (ops/raster.py:bin_faces, the twin and the CPU path) is
// ~150 small torch ops a view, each done on the card before the host has
// issued the next: a traced 512^2 render orbit put a quarter of the
// device's idle time there. Here a view is these three launches and the
// two sort calls, and nothing comes back to the host.
//
// The per-mesh work (the face table: precompute_face_data's n, c, a, a0,
// b, b0, ok, the triangles, the scene box) is built once per mesh and
// device by the plain code and only read here. The camera R, o, K and the
// pixel hull come in by value (or the hull as four device floats).
//
//   raster_bin_project  one thread per face: the view's hoists tnum, oa, ob
//                       (12 bytes a face, the view's three columns of an
//                       entry row), camera-space z, the projected box with
//                       its margin, the frontal / onscreen / vis / binnable
//                       / overflow tests, the tile span, z_eff and the mask
//                       of the face's valid slots. Each CTA writes its count
//                       of valid slots and the min and max of its seen
//                       faces' z_eff, as the float's order-preserving
//                       integer image (exact, independent of order).
//   raster_bin_keys     one thread per face again: each CTA reduces every
//                       CTA's partials (no atomics, so nothing to clear
//                       between views), forms the quantization step, zq,
//                       zfloor, the four slot keys and the overflow key, and
//                       compacts the valid slots in the twin's order (face
//                       by face, slot by slot) under the 2F cap: its base is
//                       the count of the CTAs before it, its offset a
//                       block scan. Faces that miss the cap are lost to the
//                       overflow segment. The tail of the buffer gets the
//                       invalid key.
//   raster_bin_tables   one CTA per 256-entry chunk, from the sorted keys
//                       and orders: the entry rows (the face table's 9
//                       columns and the view's 3, zeros where invalid), the
//                       face ids, the chunk's depth minimum, the tile
//                       offsets (the first entry of each tile id, as
//                       torch.searchsorted(sorted, bounds) gives them), and
//                       the overflow segment's count of chunks and of lost
//                       faces.
//
// Every value is the twin's bits on the card: each product, sum and
// division rounds alone (-fmad=false, IEEE division) in the twin's order,
// and the one division by a Python number in the twin, the step's
// (zmax - zmin) / 16383, is a multiplication by the float reciprocal, as
// torch computes a CUDA tensor over a host scalar. The constants come from
// the caller, rounded to float as torch rounds a Python number.
//
// Bound on this card: bytes. A 512^2 view of the 81,920-face mesh reads
// ~7 MB of face table and writes and reads again ~35 MB of per-face
// values, keys and entry rows: ~13 us at 3.35 TB/s, plus the two sorts.
// The launches are a few us each; the design is for the host, whose work
// for the binning falls from ~150 torch calls to these three and the sorts.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int FACES = 256;  // faces per CTA (project, keys) = threads per CTA
constexpr int CHUNK = 256;  // entries per chunk = threads per CTA (tables)
constexpr int WARPS = FACES / 32;
constexpr int Z_BITS = 14;
constexpr int TILE_PX = 32;
constexpr unsigned FULL = 0xffffffffu;

struct View {
  float r[9];        // camCv2world[:3, :3], row-major
  float o[3];        // camCv2world[:3, 3]
  float k00, k01, k02, k11, k12;
  float cmin0, cmin1, cmax0, cmax1;  // the pixel hull (when not on the device)
};

struct Consts {
  float z_near, tile_scale, m0, m1, m2, inv_zq_max, zq_max, step_min;
};

struct ProjectPart {  // a project CTA's partials
  int slots;          // valid slots
  unsigned zlo, zhi;  // min and max of its seen faces' z_eff, ordered images
};

struct KeysPart {  // a keys CTA's partials
  int in_o, lost;
};

// The order-preserving image of a float as an unsigned integer, and back.
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ unsigned spread(unsigned v) {
  v &= 0xFFFFu;
  v = (v | (v << 8)) & 0x00FF00FFu;
  v = (v | (v << 4)) & 0x0F0F0F0Fu;
  v = (v | (v << 2)) & 0x33333333u;
  v = (v | (v << 1)) & 0x55555555u;
  return v;
}

// The twin's floor(x * (1 / TILE_PX)).clamp(-1, n).to(int32).clamp(0, n - 1).
__device__ __forceinline__ int tile_of(float x, int n, float scale) {
  const float f = fminf(fmaxf(floorf(x * scale), -1.0f), (float)n);
  return min(max((int)f, 0), n - 1);
}

// Block-wide reductions over FACES (= CHUNK) threads; every thread gets the
// result. The trailing barrier lets the next one reuse `slots`.
__device__ __forceinline__ long long block_sum(long long v, long long* slots) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
  __syncthreads();
  long long r = 0;
  for (int w = 0; w < WARPS; ++w) r += slots[w];
  __syncthreads();
  return r;
}

__device__ __forceinline__ unsigned block_min_u(unsigned v, unsigned* slots) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned r = slots[0];
  for (int w = 1; w < WARPS; ++w) r = min(r, slots[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ unsigned block_max_u(unsigned v, unsigned* slots) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned r = slots[0];
  for (int w = 1; w < WARPS; ++w) r = max(r, slots[w]);
  __syncthreads();
  return r;
}

// Exclusive prefix sum over the CTA's threads, in thread order.
__device__ __forceinline__ int block_exclusive_scan(int v, int* slots) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) slots[warp] = x;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += slots[w];
  __syncthreads();
  return before + x - v;
}

__global__ void __launch_bounds__(FACES)
raster_bin_project_kernel(int F, const float* __restrict__ n, const float* __restrict__ c,
                          const float* __restrict__ a, const float* __restrict__ a0,
                          const float* __restrict__ b, const float* __restrict__ b0,
                          const bool* __restrict__ ok, const float* __restrict__ tri, View v,
                          const float* __restrict__ hull, int Tx, int Ty, Consts k,
                          float* __restrict__ view3, float* __restrict__ zeff,
                          int4* __restrict__ tiles, int* __restrict__ flags,
                          ProjectPart* __restrict__ part) {
  __shared__ long long lslots[WARPS];
  __shared__ unsigned uslots[WARPS];
  const int f = blockIdx.x * FACES + threadIdx.x;
  int slots = 0;
  unsigned zlo = ordered(INFINITY), zhi = ordered(-INFINITY);
  if (f < F) {
    const float o0 = v.o[0], o1 = v.o[1], o2 = v.o[2];
    // Shared-origin hoists: c - n.o, a.o - a0, b.o - b0.
    const float* nf = n + 3LL * f;
    const float* af = a + 3LL * f;
    const float* bf = b + 3LL * f;
    view3[3LL * f] = c[f] - ((nf[0] * o0 + nf[1] * o1) + nf[2] * o2);
    view3[3LL * f + 1] = ((af[0] * o0 + af[1] * o1) + af[2] * o2) - a0[f];
    view3[3LL * f + 2] = ((bf[0] * o0 + bf[1] * o1) + bf[2] * o2) - b0[f];

    // Camera-space vertices q = R^T (p - o), projected through K.
    float qz[3], u[3], w[3];
    for (int i = 0; i < 3; ++i) {
      const float* p = tri + 9LL * f + 3 * i;
      const float r0 = p[0] - o0, r1 = p[1] - o1, r2 = p[2] - o2;
      const float qx = (r0 * v.r[0] + r1 * v.r[3]) + r2 * v.r[6];
      const float qy = (r0 * v.r[1] + r1 * v.r[4]) + r2 * v.r[7];
      qz[i] = (r0 * v.r[2] + r1 * v.r[5]) + r2 * v.r[8];
      const float zs = fmaxf(qz[i], k.z_near);
      u[i] = (v.k00 * qx + v.k01 * qy) / zs + v.k02;
      w[i] = (v.k11 * qy) / zs + v.k12;
    }
    const float zmin = fminf(fminf(qz[0], qz[1]), qz[2]);
    const float zmax = fmaxf(fmaxf(qz[0], qz[1]), qz[2]);
    const bool frontal = zmin > k.z_near;
    const bool hittable = zmax > 0.0f;  // some vertex in front of the camera plane
    float umin = fminf(fminf(u[0], u[1]), u[2]), umax = fmaxf(fmaxf(u[0], u[1]), u[2]);
    float vmin = fminf(fminf(w[0], w[1]), w[2]), vmax = fmaxf(fmaxf(w[0], w[1]), w[2]);
    const float ext = fmaxf(umax - umin, vmax - vmin);
    const float mag = fmaxf(fabsf(umax), fabsf(vmax));
    const float margin = (k.m0 + k.m1 * ext) + k.m2 * mag;
    umin = umin - margin;
    umax = umax + margin;
    vmin = vmin - margin;
    vmax = vmax + margin;

    float cmin0 = v.cmin0, cmin1 = v.cmin1, cmax0 = v.cmax0, cmax1 = v.cmax1;
    if (hull != nullptr) {
      cmin0 = hull[0];
      cmin1 = hull[1];
      cmax0 = hull[2];
      cmax1 = hull[3];
    }
    const bool onscreen = umax >= cmin0 && umin <= cmax0 && vmax >= cmin1 && vmin <= cmax1;
    // Straddling faces bypass the hull cull (to the overflow segment).
    const bool vis = hittable && (frontal ? onscreen : true);
    const int tx0 = tile_of(umin, Tx, k.tile_scale), tx1 = tile_of(umax, Tx, k.tile_scale);
    const int ty0 = tile_of(vmin, Ty, k.tile_scale), ty1 = tile_of(vmax, Ty, k.tile_scale);
    const int span_x = tx1 - tx0 + 1, span_y = ty1 - ty0 + 1;
    const bool okf = ok[f];
    const bool binnable = okf && frontal && span_x <= 2 && span_y <= 2;
    const bool overflow = okf && vis && !binnable;
    const bool emit = binnable && onscreen;
    int mask = 0;
    for (int sy = 0; sy < 2; ++sy)
      for (int sx = 0; sx < 2; ++sx)
        if (emit && sx < span_x && sy < span_y) mask |= 1 << (2 * sy + sx);
    const float z = frontal ? zmin : 0.0f;
    zeff[f] = z;
    tiles[f] = make_int4(tx0, tx1, ty0, ty1);
    flags[f] = mask | (overflow ? 16 : 0);
    slots = __popc(mask);
    if (okf && vis) zlo = zhi = ordered(z);
  }
  const long long s = block_sum(slots, lslots);
  zlo = block_min_u(zlo, uslots);
  zhi = block_max_u(zhi, uslots);
  if (threadIdx.x == 0) part[blockIdx.x] = ProjectPart{(int)s, zlo, zhi};
}

__global__ void __launch_bounds__(FACES)
raster_bin_keys_kernel(int F, int n_parts, const ProjectPart* __restrict__ part,
                       const float* __restrict__ zeff, const int4* __restrict__ tiles,
                       const int* __restrict__ flags, int e_cap, int invalid_key, Consts k,
                       int* __restrict__ ckeys, int* __restrict__ cfid, int* __restrict__ okey,
                       float* __restrict__ zfloor, KeysPart* __restrict__ kpart) {
  __shared__ long long lslots[WARPS];
  __shared__ unsigned uslots[WARPS];
  __shared__ int islots[WARPS];
  // Every CTA's partials: this CTA's base, the total, the depth range.
  long long before = 0, total = 0;
  unsigned zlo = ordered(INFINITY), zhi = ordered(-INFINITY);
  for (int p = threadIdx.x; p < n_parts; p += FACES) {
    const ProjectPart q = part[p];
    total += q.slots;
    if (p < (int)blockIdx.x) before += q.slots;
    zlo = min(zlo, q.zlo);
    zhi = max(zhi, q.zhi);
  }
  before = block_sum(before, lslots);
  total = block_sum(total, lslots);
  zlo = block_min_u(zlo, uslots);
  zhi = block_max_u(zhi, uslots);
  const float zmx = unordered(zhi);
  const float zmn = fminf(unordered(zlo), zmx);  // both infinite when nothing is seen
  const float s = (zmx - zmn) * k.inv_zq_max;
  const float step = isnan(s) ? s : fmaxf(s, k.step_min);

  const int f = blockIdx.x * FACES + threadIdx.x;
  const int fl = f < F ? flags[f] : 0;
  const int mask = fl & 15;
  long long pos = before + block_exclusive_scan(__popc(mask), islots);
  int lost = 0, in_o = 0;
  if (f < F) {
    // zq: nan_to_num((z - zmn) / step, nan=0).clamp(0, ZQ_MAX).to(int32).
    float x = (zeff[f] - zmn) / step;
    if (isnan(x)) x = 0.0f;
    else if (isinf(x)) x = x > 0.0f ? 3.402823466e38f : -3.402823466e38f;
    const int zq = (int)fminf(fmaxf(x, 0.0f), k.zq_max);
    zfloor[f] = zmn + (float)zq * step;
    const int4 t = tiles[f];
    for (int sy = 0; sy < 2; ++sy)
      for (int sx = 0; sx < 2; ++sx) {
        if (!(mask & (1 << (2 * sy + sx)))) continue;
        if (pos < e_cap) {
          const int tid = (int)(spread((unsigned)min(t.x + sx, t.y)) |
                                (spread((unsigned)min(t.z + sy, t.w)) << 1));
          ckeys[pos] = (tid << Z_BITS) | zq;
          cfid[pos] = f;
        } else {
          lost = 1;
        }
        ++pos;
      }
    in_o = ((fl & 16) != 0) || lost;
    okey[f] = in_o ? zq : (1 << 30);
  }
  const long long n_in_o = block_sum(in_o, lslots);
  const long long n_lost = block_sum(lost, lslots);
  if (threadIdx.x == 0) kpart[blockIdx.x] = KeysPart{(int)n_in_o, (int)n_lost};
  // The slots past the last valid one hold the invalid key and face 0.
  const long long filled = total < e_cap ? total : e_cap;
  for (long long i = filled + (long long)blockIdx.x * FACES + threadIdx.x; i < e_cap;
       i += (long long)gridDim.x * FACES) {
    ckeys[i] = invalid_key;
    cfid[i] = 0;
  }
}

__global__ void __launch_bounds__(CHUNK)
raster_bin_tables_kernel(int F, int n_parts, const KeysPart* __restrict__ kpart,
                         const int* __restrict__ skeys, const long long* __restrict__ order,
                         const int* __restrict__ cfid, const long long* __restrict__ oorder,
                         const float* __restrict__ n, const float* __restrict__ a,
                         const float* __restrict__ b, const float* __restrict__ view3,
                         const float* __restrict__ zfloor, int e_cap, int invalid_key,
                         int t_ids, float* __restrict__ ed_rows, long long* __restrict__ efid,
                         long long* __restrict__ offsets, float* __restrict__ czmin,
                         long long* __restrict__ o_chunks, long long* __restrict__ lost_faces) {
  __shared__ long long lslots[WARPS];
  __shared__ unsigned uslots[WARPS];
  const long long e = (long long)blockIdx.x * CHUNK + threadIdx.x;
  const bool overflow_chunk = e - threadIdx.x >= e_cap;
  long long o_count = 0, lost = 0;
  if (overflow_chunk || blockIdx.x == 0) {
    for (int p = threadIdx.x; p < n_parts; p += CHUNK) {
      o_count += kpart[p].in_o;
      lost += kpart[p].lost;
    }
    o_count = block_sum(o_count, lslots);
    lost = block_sum(lost, lslots);
  }

  int fid;
  bool valid;
  if (!overflow_chunk) {
    const int key = skeys[e];
    valid = key < invalid_key;
    fid = cfid[order[e]];
    // offsets[t] = the first entry whose tile id is t or more.
    const int tile = key >> Z_BITS;
    const int prev = e > 0 ? (skeys[e - 1] >> Z_BITS) : -1;
    for (int t = prev + 1; t <= tile; ++t) offsets[t] = e;
    if (e == e_cap - 1)
      for (int t = tile + 1; t <= t_ids; ++t) offsets[t] = e_cap;
  } else {
    const long long i = e - e_cap;
    valid = i < o_count;
    fid = i < F ? (int)oorder[i] : 0;
  }
  efid[e] = fid;
  float4* row = reinterpret_cast<float4*>(ed_rows + 12 * e);
  if (valid) {
    const float* nf = n + 3LL * fid;
    const float* af = a + 3LL * fid;
    const float* bf = b + 3LL * fid;
    const float* vf = view3 + 3LL * fid;
    row[0] = make_float4(nf[0], nf[1], nf[2], af[0]);
    row[1] = make_float4(af[1], af[2], bf[0], bf[1]);
    row[2] = make_float4(bf[2], vf[0], vf[1], vf[2]);
  } else {
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    row[0] = zero;
    row[1] = zero;
    row[2] = zero;
  }
  const unsigned zc = block_min_u(ordered(valid ? zfloor[fid] : INFINITY), uslots);
  if (threadIdx.x == 0) {
    czmin[blockIdx.x] = unordered(zc);
    if (blockIdx.x == 0) {
      *o_chunks = (o_count + CHUNK - 1) / CHUNK;
      *lost_faces = lost;
    }
  }
}

}  // namespace

extern "C" int raster_bin_faces_per_cta() { return FACES; }
extern "C" int raster_bin_chunk() { return CHUNK; }
extern "C" int raster_bin_z_bits() { return Z_BITS; }
extern "C" int raster_bin_tile_px() { return TILE_PX; }
extern "C" int raster_bin_project_part_bytes() { return (int)sizeof(ProjectPart); }
extern "C" int raster_bin_keys_part_bytes() { return (int)sizeof(KeysPart); }

// Plain C entry points (loaded with ctypes), one launch each on `stream`;
// each returns cudaGetLastError(). F faces in ceil(F / 256) CTAs.
//
// raster_bin_project: the face table n, a, b [F, 3], c, a0, b0 [F] f32, ok
// [F] bool, tri [F, 3, 3] f32; view: 21 host floats (R row-major, o, K00,
// K01, K02, K11, K12, the hull cmin0, cmin1, cmax0, cmax1), or the hull as
// 4 device floats in `hull` (nullable); consts: 8 host floats (z_near,
// 1 / TILE_PX, the margin's 1.5, 1e-4, 1e-5, 1 / ZQ_MAX, ZQ_MAX, the
// step's floor). Writes view3 [F, 3], zeff [F] f32, tiles [F, 4] and flags
// [F] i32 and one partial a CTA.
extern "C" int raster_bin_project(int F, const float* n, const float* c, const float* a,
                                  const float* a0, const float* b, const float* b0,
                                  const bool* ok, const float* tri, const float* view,
                                  const float* hull, int Tx, int Ty, const float* consts,
                                  float* view3, float* zeff, int* tiles, int* flags, void* part,
                                  void* stream) {
  if (F <= 0) return (int)cudaErrorInvalidValue;
  View v;
  for (int i = 0; i < 9; ++i) v.r[i] = view[i];
  for (int i = 0; i < 3; ++i) v.o[i] = view[9 + i];
  v.k00 = view[12];
  v.k01 = view[13];
  v.k02 = view[14];
  v.k11 = view[15];
  v.k12 = view[16];
  v.cmin0 = view[17];
  v.cmin1 = view[18];
  v.cmax0 = view[19];
  v.cmax1 = view[20];
  const Consts k{consts[0], consts[1], consts[2], consts[3],
                 consts[4], consts[5], consts[6], consts[7]};
  const int ctas = (F + FACES - 1) / FACES;
  raster_bin_project_kernel<<<ctas, FACES, 0, (cudaStream_t)stream>>>(
      F, n, c, a, a0, b, b0, ok, tri, v, hull, Tx, Ty, k, view3, zeff,
      reinterpret_cast<int4*>(tiles), flags, static_cast<ProjectPart*>(part));
  return (int)cudaGetLastError();
}

// raster_bin_keys: the project launch's outputs; e_cap slots of keys (a
// multiple of 256); writes ckeys, cfid [e_cap] and okey [F] i32, zfloor [F]
// f32 and one partial a CTA.
extern "C" int raster_bin_keys(int F, const void* part, const float* zeff, const int* tiles,
                               const int* flags, int e_cap, int invalid_key, const float* consts,
                               int* ckeys, int* cfid, int* okey, float* zfloor, void* kpart,
                               void* stream) {
  if (F <= 0 || e_cap <= 0 || e_cap % CHUNK != 0) return (int)cudaErrorInvalidValue;
  const Consts k{consts[0], consts[1], consts[2], consts[3],
                 consts[4], consts[5], consts[6], consts[7]};
  const int ctas = (F + FACES - 1) / FACES;
  raster_bin_keys_kernel<<<ctas, FACES, 0, (cudaStream_t)stream>>>(
      F, ctas, static_cast<const ProjectPart*>(part), zeff,
      reinterpret_cast<const int4*>(tiles), flags, e_cap, invalid_key, k, ckeys, cfid, okey,
      zfloor, static_cast<KeysPart*>(kpart));
  return (int)cudaGetLastError();
}

// raster_bin_tables: the sorted keys [e_cap] i32 and their order [e_cap]
// i64, the overflow order [F] i64, the keys launch's cfid, zfloor and
// partials, the face table's n, a, b and the view's view3; o_pad overflow
// rows (F rounded up to 256). Writes ed_rows [e_cap + o_pad, 12] f32
// (16-byte aligned), efid [e_cap + o_pad] i64, offsets [t_ids + 1] i64,
// czmin [(e_cap + o_pad) / 256] f32 (the entries' chunks, then the overflow
// segment's), o_chunks and lost_faces (i64 scalars).
extern "C" int raster_bin_tables(int F, const void* kpart, const int* skeys,
                                 const long long* order, const int* cfid,
                                 const long long* oorder, const float* n, const float* a,
                                 const float* b, const float* view3, const float* zfloor,
                                 int e_cap, int o_pad, int invalid_key, int t_ids,
                                 float* ed_rows, long long* efid, long long* offsets,
                                 float* czmin, long long* o_chunks, long long* lost_faces,
                                 void* stream) {
  if (F <= 0 || e_cap <= 0 || e_cap % CHUNK != 0 || o_pad % CHUNK != 0 || o_pad < F ||
      (uintptr_t)ed_rows % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int ctas = (e_cap + o_pad) / CHUNK;
  raster_bin_tables_kernel<<<ctas, CHUNK, 0, (cudaStream_t)stream>>>(
      F, (F + FACES - 1) / FACES, static_cast<const KeysPart*>(kpart), skeys, order, cfid,
      oorder, n, a, b, view3, zfloor, e_cap, invalid_key, t_ids, ed_rows, efid, offsets, czmin,
      o_chunks, lost_faces);
  return (int)cudaGetLastError();
}
