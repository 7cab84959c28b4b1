// Stable ascending argsort of non-negative int32 keys by a bitonic network,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel of intrinsic_neural_fields_tpu/ops/raster.py:
// _bitonic_argsort_vmem (body _make_bitonic_vmem_kernel), the raster
// tracer's sort_method="bitonic_vmem". Each (key, index) pair of a network
// of 2^n is one 64-bit word (key << n | index), compared as an unsigned
// integer: keys are non-negative, so the order is the lexicographic (key,
// index) order, every word is unique, and the unstable network returns
// exactly the permutation of a stable sort by key (pads carry the key
// 0x7fffffff and their own position, so they sort last).
//
// The TPU kernel keeps both 2^18 planes in VMEM for all 171 substages. Here
// the words live in registers, move by warp shuffles and shared memory, and,
// between CTAs, through an L2-resident buffer behind a grid-wide barrier:
//
//   - a CTA holds 2^11 words, 128 threads x 16 in registers. Substages of
//     stride < 16 run inside a thread; strides 16..256 by __shfl_xor_sync
//     inside a warp; strides 512 and 1024 through shared memory (one round
//     trip loads the 16 words that up to 4 consecutive substages pair up, so
//     one barrier serves up to 4 substages);
//   - up to 2^18 words one cooperative launch holds the whole network, one
//     CTA per SM (128 at 2^18): substages whose stride reaches another CTA
//     run in round trips through the global buffer, up to 4 substages per
//     round trip and one grid barrier each. So up to 2^18 the sort is ONE
//     launch on up to 128 SMs; the buffer stays in the 50 MB L2;
//   - above 2^18 (up to 2^30), the first launch sorts 2^11-word runs of
//     alternating direction, one CTA each; each larger stage takes one
//     global pass per group of up to 4 substages whose stride reaches past
//     a run, then one launch that finishes the stage inside the runs (on an
//     H100 that beat cooperative runs of 2^12..2^18 words at 2^18+1 and
//     2^20 keys; at 2^22 their CTAs do not all fit on the card).
//
// Why not a thread-block cluster: one cluster holds at most 16 CTAs, so a
// 2^18 run in their distributed shared memory (2^14 words per CTA) runs on
// 16 SMs, and there the network's compare-exchanges, not memory, bound it:
// built that way, it was slower than a launch per global substage, whatever
// the mix of tiers (PERF.md, section 6).
//
// Up to 2^18 a cooperative launch is the one-launch design; the entry point
// takes cooperative runs of any 2^12..2^18 words, so other plans can be
// timed against the shipped one (tools/ab_port_kernels.py).
//
// Inside a launch every word of a descending block is stored complemented,
// so every compare-exchange ascends (one 64-bit compare, four selects); a
// stage boundary complements the words whose block turns.
//
// The launch plan (launches, CTAs, passes) is computed in Python
// (ops/sort.py:sort_plan) and handed to bitonic_argsort(); the step order
// inside a run launch is ops/sort.py:run_steps, which a numpy executor in
// the CPU tests runs tier by tier.
//
// Bound on this card: the keys read once and the indices written once, 8
// bytes per key (0.39 us for the tracer's 163,840 entry keys of a 512^2
// view at 3.35 TB/s).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int TILE_LOG = 11;            // words per CTA: 2^11 (16 KB)
constexpr int PER_THREAD_LOG = 4;       // words per thread: 16
constexpr int PER_THREAD = 1 << PER_THREAD_LOG;
constexpr int THREADS = 1 << (TILE_LOG - PER_THREAD_LOG);
constexpr int SHUFFLE_LO = PER_THREAD_LOG;  // first stride (log2) between threads
constexpr int SHARED_LO = SHUFFLE_LO + 5;   // first stride (log2) between warps
constexpr int GROUP = PER_THREAD_LOG;   // substages per round trip
constexpr int RUN_LOG_MAX = 18;         // one cooperative launch: up to 128 CTAs
constexpr int GLOBAL_THREADS = 256;
constexpr int MAX_LOG = 30;
constexpr u64 PAD_KEY = 0x7fffffffull;
constexpr unsigned ALL = (1u << PER_THREAD) - 1u;

// Where the 16 words of a round trip live: thread g's non-window position
// bits are g's bits, in order; the window bits [w, w+4) index the words.
__device__ __forceinline__ unsigned deposit(unsigned g, int w) {
  return (g & ((1u << w) - 1u)) | ((g >> w) << (w + PER_THREAD_LOG));
}

// Bit a set iff the word at position base | a << w ascends in `stage`
// (bit `stage` of its position is 0): one mask per substage, not per word.
__device__ __forceinline__ unsigned asc_mask(unsigned base, int w, int stage) {
  const int b = stage - w;
  if (b >= 0 && b < PER_THREAD_LOG) {  // the stage bit is a window bit: a's bit b
    const unsigned set = b == 0 ? 0xAAAAu : b == 1 ? 0xCCCCu : b == 2 ? 0xF0F0u : 0xFF00u;
    return ~set & ALL;
  }
  return ((base >> stage) & 1u) ? 0u : ALL;
}

// One substage on 16 plain register words v[a] at positions base | a << w;
// the stride is bit D of a. The pair's lo word keeps the smaller one when
// it ascends (asc bit a of the mask). The global passes use this form.
template <int D>
__device__ __forceinline__ void dir_substage(u64 (&v)[PER_THREAD], unsigned asc) {
#pragma unroll
  for (int a = 0; a < PER_THREAD; ++a) {
    if (a & (1 << D)) continue;
    const u64 lo = v[a], hi = v[a | (1 << D)];
    const bool swap = (lo > hi) == (((asc >> a) & 1u) != 0u);  // selects, no branch
    v[a] = swap ? hi : lo;
    v[a | (1 << D)] = swap ? lo : hi;
  }
}

// Substages j_hi..j_lo (all inside the window [w, w+4)) on plain words.
__device__ __forceinline__ void dir_substages(u64 (&v)[PER_THREAD], unsigned base, int w,
                                              int stage, int j_hi, int j_lo) {
  const unsigned asc = asc_mask(base, w, stage);
  for (int j = j_hi; j >= j_lo; --j) {
    switch (j - w) {
      case 3: dir_substage<3>(v, asc); break;
      case 2: dir_substage<2>(v, asc); break;
      case 1: dir_substage<1>(v, asc); break;
      default: dir_substage<0>(v, asc); break;
    }
  }
}

// The stored form inside a run launch: descending words complemented, so
// the pair's lo word always keeps the smaller one.
template <int D>
__device__ __forceinline__ void asc_substage(u64 (&v)[PER_THREAD]) {
#pragma unroll
  for (int a = 0; a < PER_THREAD; ++a) {
    if (a & (1 << D)) continue;
    const u64 lo = v[a], hi = v[a | (1 << D)];
    const bool swap = lo > hi;
    v[a] = swap ? hi : lo;
    v[a | (1 << D)] = swap ? lo : hi;
  }
}

// Substages j_hi..j_lo (inside the window [w, w+4)) on stored words.
__device__ __forceinline__ void asc_substages(u64 (&v)[PER_THREAD], int w, int j_hi, int j_lo) {
  for (int j = j_hi; j >= j_lo; --j) {
    switch (j - w) {
      case 3: asc_substage<3>(v); break;
      case 2: asc_substage<2>(v); break;
      case 1: asc_substage<1>(v); break;
      default: asc_substage<0>(v); break;
    }
  }
}

// Shared-memory slot of a CTA's word i: the low bits (a thread's word
// index) XOR the next ones, so the consecutive words of neighbouring threads
// (the register layout) fall in distinct banks, as do the strided words of
// a round trip.
__device__ __forceinline__ unsigned slot(unsigned i) {
  return i ^ ((i >> PER_THREAD_LOG) & (PER_THREAD - 1u));
}

__device__ __forceinline__ int window(int j_lo, int limit) {
  return j_lo < limit - PER_THREAD_LOG ? j_lo : limit - PER_THREAD_LOG;
}

// One stage's substages j_hi..j_lo through memory `mem` (the CTA's shared
// words, or the run's global buffer), in round trips of up to GROUP
// substages on the caller's registers v; g: the thread's index in the
// memory's scope, limit: its size in bits. The words are in memory before
// and after, each round trip ending in the scope's barrier.
template <bool GRID>
__device__ __forceinline__ void round_trips(u64 (&v)[PER_THREAD], u64* mem, unsigned g,
                                            int j_hi, int j_lo, int limit) {
  for (int hi = j_hi; hi >= j_lo; hi -= GROUP) {
    const int lo = hi - GROUP + 1 > j_lo ? hi - GROUP + 1 : j_lo;
    const int w = window(lo, limit);
    const unsigned base = deposit(g, w);
#pragma unroll
    for (int a = 0; a < PER_THREAD; ++a) {
      const unsigned p = base | ((unsigned)a << w);
      v[a] = GRID ? __ldcg(mem + p) : mem[slot(p)];
    }
    asc_substages(v, w, hi, lo);
#pragma unroll
    for (int a = 0; a < PER_THREAD; ++a) {
      const unsigned p = base | ((unsigned)a << w);
      if (GRID) __stcg(mem + p, v[a]); else mem[slot(p)] = v[a];
    }
    if (GRID) cg::this_grid().sync(); else __syncthreads();
  }
}

// Stages stage_lo..stage_hi of the network on runs of 2^run_log words: one
// CTA per 2^TILE_LOG words (one smaller CTA for a smaller network); a run of
// several CTAs is one cooperative launch, its strides past a CTA through
// buf. For a stage above the run only the substages below the run's size
// run here (the global passes did the others). in_keys: the words are
// built from the keys (padded); else read from buf (plain). out_idx: the
// order (the words' low n bits) goes to order[0..E); else the plain words
// go back to buf.
__global__ void __launch_bounds__(THREADS)
run_kernel(const int* __restrict__ keys, long long E, u64* __restrict__ buf,
           int* __restrict__ order, int n, int run_log, int stage_lo, int stage_hi, int in_keys,
           int out_idx) {
  __shared__ __align__(16) u64 smem[1 << TILE_LOG];
  const int local_log = run_log < TILE_LOG ? run_log : TILE_LOG;
  const unsigned g = blockIdx.x * blockDim.x + threadIdx.x;  // thread in the network
  const unsigned t = threadIdx.x;                            // thread in the CTA
  const unsigned run_mask = (1u << run_log) - 1u;
  const unsigned lane_mask = blockDim.x >= 32 ? 0xffffffffu : ((1u << blockDim.x) - 1u);
  // registers: thread g holds the 16 consecutive positions 16g + a
  const unsigned pos0 = g << PER_THREAD_LOG;
  const unsigned run0 = pos0 & ~run_mask;  // the run's first position
  u64 v[PER_THREAD];
  unsigned asc = asc_mask(pos0, 0, stage_lo);
#pragma unroll
  for (int a = 0; a < PER_THREAD; ++a) {
    const unsigned p = pos0 | (unsigned)a;
    u64 w;
    if (in_keys)
      w = ((long long)p < E ? (u64)(unsigned)keys[p] : PAD_KEY) << n | p;
    else
      w = buf[p];
    v[a] = ((asc >> a) & 1u) ? w : ~w;
  }
  for (int stage = stage_lo; stage <= stage_hi; ++stage) {
    if (stage > stage_lo) {  // complement the words whose block turns
      const unsigned next = asc_mask(pos0, 0, stage);
      const unsigned turn = asc ^ next;
      asc = next;
#pragma unroll
      for (int a = 0; a < PER_THREAD; ++a)
        if ((turn >> a) & 1u) v[a] = ~v[a];
    }
    const int top = (stage < run_log ? stage : run_log) - 1;  // highest substage here
    if (top >= TILE_LOG) {
      // registers -> the run's buffer, grid round trips, buffer -> registers
#pragma unroll
      for (int a = 0; a < PER_THREAD; ++a) __stcg(buf + (pos0 | a), v[a]);
      cg::this_grid().sync();
      round_trips<true>(v, buf + run0, g & (run_mask >> PER_THREAD_LOG), top, TILE_LOG,
                        run_log);
#pragma unroll
      for (int a = 0; a < PER_THREAD; ++a) v[a] = __ldcg(buf + (pos0 | a));
    }
    if (top >= SHARED_LO) {
      // registers -> shared memory, the round trips, shared memory -> registers
      const int sh_hi = top < TILE_LOG ? top : TILE_LOG - 1;
#pragma unroll
      for (int a = 0; a < PER_THREAD; ++a) smem[slot((t << PER_THREAD_LOG) | a)] = v[a];
      __syncthreads();
      round_trips<false>(v, smem, t, sh_hi, SHARED_LO, local_log);
#pragma unroll
      for (int a = 0; a < PER_THREAD; ++a) v[a] = smem[slot((t << PER_THREAD_LOG) | a)];
    }
    // strides 16..256: the partner is lane ^ (stride / 16); the pair's lo
    // word keeps the smaller one
    const int sh_top = top < SHARED_LO - 1 ? top : SHARED_LO - 1;
    for (int j = sh_top; j >= SHUFFLE_LO; --j) {
      const int lb = j - SHUFFLE_LO;
      const bool is_lo = ((g >> lb) & 1u) == 0u;
#pragma unroll
      for (int a = 0; a < PER_THREAD; ++a) {
        const u64 o = __shfl_xor_sync(lane_mask, v[a], 1 << lb);
        v[a] = (o < v[a]) == is_lo ? o : v[a];
      }
    }
    // strides 1..8: inside the thread
    const int th_top = top < SHUFFLE_LO - 1 ? top : SHUFFLE_LO - 1;
    asc_substages(v, 0, th_top, 0);
  }
#pragma unroll
  for (int a = 0; a < PER_THREAD; ++a) {
    const unsigned p = pos0 | (unsigned)a;
    const u64 w = ((asc >> a) & 1u) ? v[a] : ~v[a];
    if (out_idx) {
      if ((long long)p < E) order[p] = (int)(unsigned)(w & ((1ull << n) - 1ull));
    } else {
      buf[p] = w;
    }
  }
}

// One global pass: substages j_hi..j_lo of `stage` (strides past a run) on
// the plain words, each thread on the 16 words at deposit(g, w) | a << w.
__global__ void __launch_bounds__(GLOBAL_THREADS)
global_kernel(u64* __restrict__ buf, int stage, int j_hi, int j_lo, int w) {
  const unsigned g = blockIdx.x * GLOBAL_THREADS + threadIdx.x;
  const unsigned base = deposit(g, w);
  u64 v[PER_THREAD];
#pragma unroll
  for (int a = 0; a < PER_THREAD; ++a) v[a] = buf[base | ((unsigned)a << w)];
  dir_substages(v, base, w, stage, j_hi, j_lo);
#pragma unroll
  for (int a = 0; a < PER_THREAD; ++a) buf[base | ((unsigned)a << w)] = v[a];
}

int launch_run(const int* keys, long long E, u64* buf, int* order, int n, int run_log,
               int stage_lo, int stage_hi, int in_keys, int out_idx, cudaStream_t st) {
  const int local_log = run_log < TILE_LOG ? run_log : TILE_LOG;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1u << (n - local_log));
  cfg.blockDim = dim3(1u << (local_log - PER_THREAD_LOG));
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;  // the grid barrier of a multi-CTA run
  attr[0].val.cooperative = run_log > TILE_LOG;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, run_kernel, keys, E, buf, order, n, run_log,
                                       stage_lo, stage_hi, in_keys, out_idx);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Launch kinds of a plan row (ops/sort.py:sort_plan).
enum { KIND_RUN = 0, KIND_GLOBAL = 1 };

// Plain C entry point (loaded with ctypes). keys: E int32 (non-negative);
// order: E int32, on return the stable ascending order of the keys. The
// network has 2^n words (E <= 2^n, 4 <= n <= 30); a run launch sorts runs
// of 2^run_log words (11 <= run_log <= 18, or run_log = n below 11). plan:
// n_launches rows of 5 ints (kind, stage, stage_hi or j_hi, j_lo, window),
// in launch order: a run launch runs stages [stage,
// stage_hi]; a global pass runs substages j_hi..j_lo of `stage` with window
// [w, w+4). buf: 2^n u64 words of scratch when n > 11 (the grid round trips
// or more than one launch), else unused (may be null). Launches on
// `stream`; *launches receives the number of kernels launched. Returns the
// first error, else 0.
extern "C" int bitonic_argsort(const int* keys, long long E, int* order, void* buf, int n,
                               int run_log, const int* plan, int n_launches, int* launches,
                               void* stream) {
  *launches = 0;
  if (n < PER_THREAD_LOG || n > MAX_LOG || run_log > n || run_log > RUN_LOG_MAX ||
      run_log < PER_THREAD_LOG || E < 1 || E > (1ll << n) || n_launches < 1 ||
      (n > TILE_LOG && buf == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  u64* words = (u64*)buf;
  for (int i = 0; i < n_launches; ++i) {
    const int* row = plan + 5 * i;
    const int first = i == 0, last = i == n_launches - 1;
    int rc;
    if (row[0] == KIND_RUN) {
      if (first != (row[1] == 1)) return (int)cudaErrorInvalidValue;
      rc = launch_run(keys, E, words, order, n, run_log, row[1], row[2], first, last, st);
    } else {
      if (first || last) return (int)cudaErrorInvalidValue;
      const unsigned threads = 1u << (n - PER_THREAD_LOG);
      global_kernel<<<(threads + GLOBAL_THREADS - 1) / GLOBAL_THREADS,
                      threads < GLOBAL_THREADS ? threads : GLOBAL_THREADS, 0, st>>>(
          words, row[1], row[2], row[3], row[4]);
      rc = (int)cudaGetLastError();
    }
    if (rc != 0) return rc;
    ++*launches;
  }
  return 0;
}

// CTAs of the run kernel the card can hold at once (a cooperative run
// needs all of its CTAs resident), or a negative CUDA error.
extern "C" int bitonic_argsort_max_ctas() {
  int per_sm = 0, sms = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, run_kernel, THREADS, 0);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? per_sm * sms : -(int)err;
}

extern "C" int bitonic_argsort_tile_log() { return TILE_LOG; }
extern "C" int bitonic_argsort_per_thread_log() { return PER_THREAD_LOG; }
