// Training kernels of the texture field's skip-MLP, hand-written for Hopper
// (sm_90a): bf16 tensor cores through wgmma (fwd_bwd) and nvcuda::wmma
// 16x16x16 fragments (wgrad).
//
// Replaces the TPU kernels of intrinsic_neural_fields_tpu/ops/fused_mlp.py
// whose body is _train_grads_body: make_fused_train_grads (gathered and
// streaming pallas_calls), the gradient part of make_fused_train_adam, and
// the backward pallas_call of make_fused_apply (_make_bwd_kernel), which is
// the same walk seeded by an output cotangent instead of a loss gradient.
// The _viewdep entry points replace the same factories in tail mode
// (tail=ViewDepTailSpec: the view-dependent field, body
// _train_grads_body's tail branches).
//
// The TPU kernels add every grid step's gradients into one VMEM block; that
// relies on the TPU grid running in order. Here blocks run in parallel, so
// the step is split in two launches with no atomics, and every sum is taken
// in a fixed order (the result is the same on every run):
//
//   fused_mlp_fwd_bwd  one cluster of two CTAs per 64 batch rows, each CTA
//     half of every layer's columns: the forward, the loss and its gradient
//     (or the cotangent seed) times the sigmoid's derivative, then the
//     deltas back through W^T down to layer 0 (design: the fwd_bwd section
//     below). It writes what the TPU kernel feeds its matrix unit: the bf16
//     post-relu activations and the bf16 deltas of every layer, plus
//     per-64-row f32 partial sums of the loss, the squared error and every
//     bias gradient (column sums of the f32 deltas).
//   fused_mlp_wgrad  NSPLIT blocks per 64-row tile of each weight gradient,
//     each contracting dW = A^T . D over its share of the batch with f32
//     accumulation (A the layer input: the feature rows straight from the
//     table, or the saved activations) into a partial tile; the last block
//     of a tile to finish (an arrival counter, not a float atomic) sums the
//     NSPLIT partials in split order. One more block sums the per-block bias
//     and loss partials in block order.
//
// The view-dependent field is the same chain with two more 128-wide relu
// layers: the spatial head becomes the relu bottleneck, and the concat layer
// relu([bneck | venc] . Wc1 + b1) reads its second operand, the encoded view
// directions, straight from their table at the batch's offset (lanes past
// venc_in read as zero), as the skip layer reads the features; the RGB head
// follows. The delta walk then needs nothing new: the concat layer's delta
// times its bottleneck rows of Wc1 is the bottleneck's delta, which seeds the
// spatial walk (the reference's d_bneck = (d1 . W1b^T) * [bneck > 0]); wgrad
// gains the bottleneck, the two row blocks of Wc1 and the RGB head.
//
// Numerics are the reference's: bf16 (round to nearest even) operands, f32
// accumulation; fwd_bwd reads the weights from a bf16 copy of the f32
// master parameters (rounded once per step, as the TPU kernel loads its
// bf16 weights into VMEM once per grid; csrc/fused_adam.cu writes it beside
// the master); feature lanes past k_in and batch rows past B read as zero,
// so pad rows of the gradient are exactly zero.
//
// Bound on this card: per training row about 2*(k*128*2 + 4*128*128 +
// 128*16) MACs forward and again for the weight gradients, plus the delta
// walk (k=512: ~3.8 GFLOP at B=4096 against ~6 MB moved; the view-dependent
// field adds ~17.9k MACs per row to each pass), above the H100's
// bf16 ridge of ~295 FLOP/byte, so the ideal step is bound by the tensor
// cores. Split in two launches, each kernel is bound by the bytes of the
// intermediates it writes or reads (the activations and deltas). fwd_bwd is
// latency-bound: a chain of dependent 64-row products per cluster; wgrad is
// the first, simple version (synchronous loads, wmma).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace cg = cooperative_groups;
using namespace nvcuda;

namespace {

constexpr int BM = 64;         // batch rows per block (fwd_bwd), batch chunk (wgrad)
constexpr int HID = 128;       // hidden width
constexpr int KC = 64;         // input / weight rows per streamed chunk
constexpr int OUTW = 16;       // head padded to one fragment width
constexpr int NOUT = 3;        // real output columns
constexpr int NTHREADS = 256;  // wgrad: 8 warps, 4 row tiles x 2 column halves
constexpr int LDX = KC + 8;    // bf16 row strides padded by 16 bytes
constexpr int LDW = HID + 8;
constexpr int MAXL = 16;       // most Linear layers a network may have
constexpr int MAXM = MAXL + 1; // most weight matrices (the skip layer has two)
constexpr int NSPLIT = 8;      // wgrad: blocks sharing one tile's batch
constexpr int VENC_MAX = KC;   // most view-encoding lanes (one x tile)
constexpr float CAUCHY_C2 = (float)((20.0 / 255.0) * (20.0 / 255.0));  // as the f32 ops see it

using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Where each layer's operands live in the flat f32 parameter buffer (see
// ops/fused_mlp.py:ParamLayout): the matrix region, then the bias region.
// Relu layers 0..nh-1, then the head (index nh): nh = L-1 for the plain
// field; the view-dependent one adds the bottleneck (L-1) and the concat
// layer (cat = L), nh = L+1.
struct Net {
  int L, skip, k_in, k_w;
  int nh, cat, venc_w;  // relu layers; the concat layer (-1: none); view rows of Wc1
  long long w_h[MAXL];  // layer i >= 1: its [HID, N] h-matrix; nh: the head
  long long w_in;       // layer 0: [k_w, HID]
  long long w_x;        // skip layer's input matrix [k_w, HID]
  long long w_v;        // concat layer's view rows [venc_w, HID]
  long long b[MAXL];    // layer i's bias (the skip layer's h-bias), head at nh
  long long b_x;        // skip layer's input bias
  long long n_w;        // size of the matrix region
};

Net make_net(int k_in, int k_w, int L, int skip, int venc_w) {
  Net n{};
  n.L = L; n.skip = skip; n.k_in = k_in; n.k_w = k_w;
  n.venc_w = venc_w;
  n.nh = venc_w > 0 ? L + 1 : L - 1;
  n.cat = venc_w > 0 ? L : -1;
  long long w = 0, b = 0;
  for (int i = 0; i < L - 1; ++i) {
    if (i == 0) {
      n.w_in = w; w += (long long)k_w * HID;
      n.b[i] = b; b += HID;
    } else if (i == skip) {
      n.w_h[i] = w; w += (long long)HID * HID;
      n.w_x = w; w += (long long)k_w * HID;
      n.b[i] = b; b += HID;
      n.b_x = b; b += HID;
    } else {
      n.w_h[i] = w; w += (long long)HID * HID;
      n.b[i] = b; b += HID;
    }
  }
  if (venc_w > 0) {
    n.w_h[L - 1] = w; w += (long long)HID * HID;  // bottleneck
    n.b[L - 1] = b; b += HID;
    n.w_h[L] = w; w += (long long)HID * HID;      // concat: bottleneck rows of Wc1
    n.w_v = w; w += (long long)venc_w * HID;       //         view rows
    n.b[L] = b; b += HID;
  }
  n.w_h[n.nh] = w; w += (long long)HID * OUTW;
  n.b[n.nh] = b;
  n.n_w = w;
  return n;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// Columns [k0, k0+KC) of BM table rows starting at xrows (row stride ld)
// -> bf16; rows >= nrows and columns >= ncols read as zero.
template <typename XT>
__device__ __forceinline__ void load_x_chunk(__nv_bfloat16* xs, const XT* __restrict__ xrows,
                                             int nrows, int ld, int ncols, int k0, int tid) {
  for (int i = tid; i < BM * KC; i += NTHREADS) {
    const int r = i / KC;
    const int c = i - r * KC;
    const int gc = k0 + c;
    const float v = (r < nrows && gc < ncols) ? to_f(xrows[(size_t)r * ld + gc]) : 0.0f;
    xs[r * LDX + c] = __float2bfloat16_rn(v);
  }
}

// ------------------------------------------------------------------ fwd_bwd
//
// One cluster of two CTAs per 64 batch rows, one warpgroup (128 threads)
// per CTA. CTA c of the pair computes output columns [64c, 64c+64) of every
// 128-wide layer, forward and back, with wgmma m64n64k16 (bf16 in, f32
// accumulators in registers: 32 per thread). A layer's input is the previous
// layer's bf16 output: the CTA's own half straight from its accumulator
// registers (the accumulator of columns [16q, 16q+16) is the A fragment of
// k-step q) goes first; the partner's half is read once per layer from the
// partner's shared memory (DSMEM) behind a split cluster barrier (arrive
// after the epilogue, wait just before the partner's half), so the barrier
// overlaps the own half's products. Weight tiles of the bf16 parameter copy
// (64 x 64, in wgmma's no-swizzle core-matrix layouts) and the feature
// chunks come in by cp.async into a 3-stage ring, issued two tiles ahead
// from a tile program each CTA writes into shared memory once, so a tile's
// loads overlap the products of the two before it; each layer's biases
// (walking back: its relu mask) load while its products run. The 64 x k_w
// feature tile stays resident for the skip layer when it fits. The head (16
// columns), the loss and the seed are computed by both CTAs of the pair on
// the same registers (bit-identical); CTA 0 writes them out.

constexpr int FB_THREADS = 128;            // one warpgroup
constexpr int HALF = HID / 2;              // output columns per CTA of a pair
constexpr int TILE_BYTES = KC * HALF * 2;  // a [64 x 64] bf16 tile: 8 KB
constexpr int STAGES = 3;                  // cp.async ring depth
constexpr int XCHG_BYTES = 4 * FB_THREADS * 16;  // one layer's half in fragment order
constexpr int RED_FLOATS = 4 * HALF + 8;
constexpr int SMEM_LIMIT = 227 * 1024;

enum { T_NONE, T_FWD, T_FWD_VENC, T_FWD_HEAD, T_BWD, T_BWD_HEAD };

struct Tile {
  long long w;  // offset of the matrix in the flat parameters
  int kind;
  int k0;       // first row (forward) or column (backward) of the matrix in the tile
  int xch;      // the feature chunk read with this tile (-1: none)
  int xload;    // 1: load that chunk now (0: it is resident)
};

// The t-th weight tile of CTA c's program, in the order it uses them: the
// forward layers (h-matrix halves, the CTA's own half of the input first,
// then the feature chunks, the view rows), the head, then the walk back
// (the head's transpose, then every h-matrix's, own half first).
__device__ Tile tile_at(const Net& net, int t, bool x_res, int c) {
  for (int l = 0; l < net.nh; ++l) {
    if (l > 0) {
      if (t < 2) return {net.w_h[l], T_FWD, KC * (t ^ c), -1, 0};
      t -= 2;
    }
    if (l == 0 || l == net.skip) {
      const int nch = net.k_w / KC;
      if (t < nch) return {l == 0 ? net.w_in : net.w_x, T_FWD, KC * t, t, l == 0 || !x_res};
      t -= nch;
    }
    if (l == net.cat) {
      if (t < 1) return {net.w_v, T_FWD_VENC, 0, -1, 0};
      t -= 1;
    }
  }
  if (t < 1) return {net.w_h[net.nh], T_FWD_HEAD, 0, -1, 0};
  if (t < 2) return {net.w_h[net.nh], T_BWD_HEAD, 0, -1, 0};
  t -= 2;
  for (int l = net.nh - 2; l >= 0; --l) {
    if (t < 2) return {net.w_h[l + 1], T_BWD, KC * (t ^ c), -1, 0};
    t -= 2;
  }
  return {0, T_NONE, 0, -1, 0};
}

// Tiles in the program (tile_at's length).
int fwd_bwd_tiles(const Net& net) {
  return 2 * (net.k_w / KC) + 4 * (net.nh - 1) + (net.cat >= 0 ? 1 : 0) + 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; bytes past src_bytes read as zero.
__device__ __forceinline__ void cp16(void* dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wgmma's shared-memory matrix descriptor, no swizzle: lbo = byte stride
// between core matrices (8 rows x 16 bytes) along K, sbo = along M or N.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(v & 0xffffu)));
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(v >> 16)));
}

#define ACC32(d)                                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d[64 x 64] += A . B, A from registers (k-step fragment a), B by descriptor;
// TB: B is MN-major (the forward's W[k][n]) or K-major (the walk's W^T).
template <int TB>
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31},"
      "{%32,%33,%34,%35}, %36, p, 1, 1, %37;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TB), "r"(1));
}

// d[64 x 64] += A . B, A (K-major) and B (MN-major) by descriptor.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31},"
      " %32, %33, p, 1, 1, 0, 1;\n}\n"
      : ACC32(d)
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 16] += A . B (the head), A from registers, B MN-major.
__device__ __forceinline__ void wgmma_rs16(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait(float (&d)[N]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <typename XT>
struct FB {
  // inputs
  const XT* xrows;  // the block's first table row
  const XT* vrows;  // its view encodings (VD)
  int k_in, venc_in, venc_w, nrows;
  bool x_async;     // bf16 rows on 16-byte boundaries: cp.async, else converted loads
  bool x_res;       // the whole 64 x k_w feature tile stays in shared memory
  const __nv_bfloat16* wb;
  const Tile* prog;  // the tile program, in shared memory
  int n_tiles;
  int n0, tid;
  // shared memory
  unsigned char* wring;  // STAGES weight tiles
  unsigned char* xs;     // the feature tile (resident) or a STAGES ring of chunks
  unsigned char* vs;     // the view-encoding tile (VD)

  __device__ unsigned char* xbuf(int ch, int slot) const {
    return xs + (x_res ? ch : slot) * TILE_BYTES;
  }

  // 8 weights (16 bytes of the bf16 copy) into a tile
  __device__ __forceinline__ void cpw(void* dst, const __nv_bfloat16* src) const { cp16(dst, src); }

  // Rows x k of a feature / view table into the K-major core-matrix layout
  // (element (m, k) at (k/8)*1024 + (m/8)*128 + (m%8)*16 + (k%8)*2).
  template <typename T>
  __device__ void load_rows(unsigned char* dst, const T* rows, int ld, int ncols, int k0,
                            bool async) const {
    if (async) {
      for (int i = tid; i < BM * (KC / 8); i += FB_THREADS) {
        const int m = i >> 3, kg = i & 7, gk = k0 + 8 * kg;
        const bool ok = m < nrows && gk < ncols;
        cp16(dst + kg * 1024 + (m >> 3) * 128 + (m & 7) * 16,
             ok ? (const void*)(rows + (size_t)m * ld + gk) : (const void*)rows, ok ? 16 : 0);
      }
    } else {
#pragma unroll 8
      for (int i = tid; i < BM * KC; i += FB_THREADS) {
        const int m = i >> 6, k = i & 63, gk = k0 + k;
        const float v = (m < nrows && gk < ncols) ? to_f(rows[(size_t)m * ld + gk]) : 0.0f;
        *reinterpret_cast<__nv_bfloat16*>(dst + (k >> 3) * 1024 + (m >> 3) * 128 + (m & 7) * 16 +
                                          (k & 7) * 2) = __float2bfloat16_rn(v);
      }
    }
  }

  // Issue the loads of tile t into ring slot t % STAGES (one commit group
  // per tile, empty past the program's end).
  __device__ void issue(int t) const {
    if (t >= n_tiles) {
      cp_commit();
      return;
    }
    const Tile d = prog[t];
    const int slot = t % STAGES;
    unsigned char* ws = wring + slot * TILE_BYTES;
    const __nv_bfloat16* W = wb + d.w;
    if (d.kind == T_FWD || d.kind == T_FWD_VENC) {
      // W [rows, 128] -> B[k][n] = W[k0 + k][n0 + n], MN-major
      const int rows = d.kind == T_FWD ? KC : venc_w;
      for (int i = tid; i < rows * 8; i += FB_THREADS) {
        const int k = i >> 3, ng = i & 7;
        cpw(ws + (k >> 3) * 1024 + ng * 128 + (k & 7) * 16,
            W + (size_t)(d.k0 + k) * HID + n0 + 8 * ng);
      }
      if (d.kind == T_FWD_VENC) load_rows(vs, vrows, venc_w, venc_in, 0, false);
    } else if (d.kind == T_FWD_HEAD) {
      // W [128, 16] -> B[k][n] = W[k][n], MN-major, 16 k-groups x 2 n-groups
      for (int i = tid; i < HID * 2; i += FB_THREADS) {
        const int k = i >> 1, ng = i & 1;
        cpw(ws + (k >> 3) * 256 + ng * 128 + (k & 7) * 16, W + (size_t)k * OUTW + 8 * ng);
      }
    } else if (d.kind == T_BWD) {
      // W [128, 128] -> B[k][n] = W[n0 + n][k0 + k], K-major
      for (int i = tid; i < HALF * 8; i += FB_THREADS) {
        const int n = i >> 3, kg = i & 7;
        cpw(ws + kg * 1024 + (n >> 3) * 128 + (n & 7) * 16,
            W + (size_t)(n0 + n) * HID + d.k0 + 8 * kg);
      }
    } else if (d.kind == T_BWD_HEAD) {
      // W [128, 16] -> B[k][n] = W[n0 + n][k], K-major, one k-step
      for (int i = tid; i < HALF * 2; i += FB_THREADS) {
        const int n = i >> 1, kg = i & 1;
        cpw(ws + kg * 1024 + (n >> 3) * 128 + (n & 7) * 16, W + (size_t)(n0 + n) * OUTW + 8 * kg);
      }
    }
    if (d.xch >= 0 && d.xload)
      load_rows(xbuf(d.xch, slot), xrows, k_in, k_in, KC * d.xch, x_async);
    cp_commit();
  }
};

// The two halves of a cluster barrier: a CTA arrives once its half of a
// layer is in its exchange slot, and waits only when it needs the partner's.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Wait for tile t's loads (this thread's), publish every thread's to the
// tensor cores' view of shared memory.
__device__ __forceinline__ void tile_ready() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// Column sums over the 64 rows of NJ 8-column groups of an accumulator
// layout: this thread's two rows, the warp's 8 row pairs by shuffles, then
// the 4 warps in order (a fixed order: the same bits every run).
template <int NJ>
__device__ __forceinline__ void col_sums(const float (&v)[4 * NJ], float* red, int warp, int lane,
                                         int cq, int tid, float* dst) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float s0 = v[4 * j] + v[4 * j + 2], s1 = v[4 * j + 1] + v[4 * j + 3];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (lane < 4) {
      red[warp * HALF + 8 * j + cq] = s0;
      red[warp * HALF + 8 * j + cq + 1] = s1;
    }
  }
  __syncthreads();
  if (tid < 8 * NJ)
    dst[tid] = ((red[tid] + red[HALF + tid]) + red[2 * HALF + tid]) + red[3 * HALF + tid];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// mode: 0 L1, 1 L2, 2 cauchy (target = ground truth), 3 cotangent (target = g).
// VD: the view-dependent chain (a separate instantiation, so the plain
// field's kernel is compiled without the concat layer's code).
template <typename XT, bool VD>
__global__ void __launch_bounds__(FB_THREADS, 1)
fwd_bwd_kernel(const XT* __restrict__ x, long long row0, int B, const float* __restrict__ params,
               const __nv_bfloat16* __restrict__ wb, Net net, const XT* __restrict__ venc,
               int venc_in, const float* __restrict__ target, int mode, float inv_n, int x_async,
               int x_res, int n_tiles, __nv_bfloat16* __restrict__ acts,
               __nv_bfloat16* __restrict__ deltas, float* __restrict__ bias_part,
               float* __restrict__ loss_part) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.block_rank();  // which half of the columns
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2);  // this thread's rows r0 and r0 + 8
  const int cq = 2 * (lane & 3);           // and columns 8j + cq, 8j + cq + 1
  const int blk = blockIdx.x >> 1;
  const int brow = blk * BM;
  const int nrows = min(BM, B - brow);
  const int nh = net.nh;
  const int n0 = HALF * c;
  const int nbp = HID * nh + OUTW;
  const float* bias = params + net.n_w;

  FB<XT> f;
  f.xrows = x + (size_t)(row0 + brow) * net.k_in;
  f.vrows = VD ? venc + (size_t)(row0 + brow) * net.venc_w : nullptr;
  f.k_in = net.k_in;
  f.venc_in = venc_in;
  f.venc_w = net.venc_w;
  f.nrows = nrows;
  f.x_async = x_async != 0;
  f.x_res = x_res != 0;
  f.wb = wb;
  f.n_tiles = n_tiles;
  f.n0 = n0;
  f.tid = tid;
  f.wring = smem_raw;
  f.xs = f.wring + STAGES * TILE_BYTES;
  unsigned char* after_x = f.xs + (x_res ? net.k_w / KC : STAGES) * TILE_BYTES;
  f.vs = after_x;
  uint4* xchg = reinterpret_cast<uint4*>(after_x + (VD ? TILE_BYTES : 0));  // 2 slots
  float* red = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(xchg) + 2 * XCHG_BYTES);
  Tile* prog = reinterpret_cast<Tile*>(red + RED_FLOATS);
  for (int i = tid; i < n_tiles; i += FB_THREADS) prog[i] = tile_at(net, i, x_res != 0, c);
  f.prog = prog;
  __syncthreads();

  uint32_t own[4][4], par[4][4];  // A fragments of this CTA's / the partner's half
  float acc[32];
  float2 bh2[8], bx2[8];  // a forward layer's biases at this thread's columns
  uint32_t mask[8][2];    // a backward layer's activations at this thread's places
  int t = 0;
  f.issue(0);
  f.issue(1);

  // Bias add(s) in the reference order (h-bias, then the skip layer's input
  // bias: zero elsewhere, which changes no bit after the relu), relu, bf16:
  // this CTA's half of the layer's output as A fragments, to global acts.
  auto finish_forward = [&](int layer) {
    __nv_bfloat16* act = acts + ((size_t)layer * B + brow) * HID + n0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + cq;
      const float v0 = (acc[4 * j] + bh2[j].x) + bx2[j].x;
      const float v1 = (acc[4 * j + 1] + bh2[j].y) + bx2[j].y;
      const float v2 = (acc[4 * j + 2] + bh2[j].x) + bx2[j].x;
      const float v3 = (acc[4 * j + 3] + bh2[j].y) + bx2[j].y;
      const uint32_t top = pack_bf16(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
      const uint32_t bot = pack_bf16(fmaxf(v2, 0.0f), fmaxf(v3, 0.0f));
      own[j >> 1][(j & 1) * 2] = top;
      own[j >> 1][(j & 1) * 2 + 1] = bot;
      if (r0 < nrows) *reinterpret_cast<uint32_t*>(act + (size_t)r0 * HID + col) = top;
      if (r0 + 8 < nrows) *reinterpret_cast<uint32_t*>(act + (size_t)(r0 + 8) * HID + col) = bot;
    }
  };
  // own -> exchange slot s, then arrive at the cluster barrier
  auto publish = [&](int s) {
    uint4* mine = xchg + s * 4 * FB_THREADS;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      mine[q * FB_THREADS + tid] = make_uint4(own[q][0], own[q][1], own[q][2], own[q][3]);
    cluster_arrive();
  };
  // wait at the cluster barrier, then the partner's slot s -> par
  auto fetch = [&](int s) {
    cluster_wait();
    const uint4* theirs = cl.map_shared_rank(xchg + s * 4 * FB_THREADS, c ^ 1);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = theirs[q * FB_THREADS + tid];
      par[q][0] = v.x; par[q][1] = v.y; par[q][2] = v.z; par[q][3] = v.w;
    }
  };
  // acc += own . tile (mine) or par . tile: the tile holds the k rows of
  // that half
  auto mma_h = [&](bool mine, int tb) {
    const unsigned char* ws = f.wring + (t % STAGES) * TILE_BYTES;
    wg_fence();
    if (mine) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint64_t bd = gmma_desc(ws + q * 2048, 1024, 128);
        if (tb) wgmma_rs64<1>(acc, own[q], bd); else wgmma_rs64<0>(acc, own[q], bd);
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint64_t bd = gmma_desc(ws + q * 2048, 1024, 128);
        if (tb) wgmma_rs64<1>(acc, par[q], bd); else wgmma_rs64<0>(acc, par[q], bd);
      }
    }
    wg_commit();
  };
  auto next_tile = [&]() {
    f.issue(t + 2);
    wg_wait(acc);
    ++t;
  };

  // ---------------- forward
  for (int layer = 0; layer < nh; ++layer) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    {  // the epilogue's biases, loaded while the products run
      const float* bh = bias + net.b[layer] + n0;
      const float* bx = bias + net.b_x + n0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        bh2[j] = *reinterpret_cast<const float2*>(bh + 8 * j + cq);
        bx2[j] = layer == net.skip ? *reinterpret_cast<const float2*>(bx + 8 * j + cq)
                                   : make_float2(0.0f, 0.0f);
      }
    }
    if (layer > 0) {  // h . Wh: this CTA's half of h from registers, then the partner's
      tile_ready();
      mma_h(true, 1);
      next_tile();
      fetch((layer - 1) & 1);
      tile_ready();
      mma_h(false, 1);
      next_tile();
    }
    if (layer == 0 || layer == net.skip) {  // x . Wx, chunk by chunk
      for (int ch = 0; ch < net.k_w / KC; ++ch) {
        tile_ready();
        const unsigned char* ws = f.wring + (t % STAGES) * TILE_BYTES;
        const unsigned char* xa = f.xbuf(ch, t % STAGES);
        wg_fence();
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wgmma_ss64(acc, gmma_desc(xa + q * 2048, 1024, 128), gmma_desc(ws + q * 2048, 1024, 128));
        wg_commit();
        next_tile();
      }
    }
    if (VD && layer == net.cat) {  // venc . Wv: venc_w / 16 k-steps
      tile_ready();
      const unsigned char* ws = f.wring + (t % STAGES) * TILE_BYTES;
      wg_fence();
      for (int q = 0; q < net.venc_w / 16; ++q)
        wgmma_ss64(acc, gmma_desc(f.vs + q * 2048, 1024, 128), gmma_desc(ws + q * 2048, 1024, 128));
      wg_commit();
      next_tile();
    }
    finish_forward(layer);
    publish(layer & 1);
  }

  // ---------------- head, loss, seed (both CTAs, the same registers)
  float z[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) z[i] = 0.0f;
  fetch((nh - 1) & 1);
  tile_ready();
  {
    const unsigned char* ws = f.wring + (t % STAGES) * TILE_BYTES;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t bd = gmma_desc(ws + kk * 512, 256, 128);
      if ((kk >> 2) == c) wgmma_rs16(z, own[kk & 3], bd); else wgmma_rs16(z, par[kk & 3], bd);
    }
    wg_commit();
    f.issue(t + 2);
    wg_wait(z);
    ++t;
  }
  float lsum = 0.0f, ssum = 0.0f;
  const float* bo = bias + net.b[nh];
  float dv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + ((i >> 1) & 1) * 8;
    const int col = 8 * (i >> 2) + cq + (i & 1);
    float dval = 0.0f;
    if (col < NOUT && r < nrows) {
      const float zz = z[i] + bo[col];
      const float p = 1.0f / (1.0f + expf(-zz));
      const float tg = target[(size_t)(brow + r) * NOUT + col];
      float g;
      if (mode == 3) {
        g = tg;
      } else {
        const float diff = p - tg;
        const float sq = __fmul_rn(diff, diff);
        ssum += sq;
        if (mode == 0) {
          lsum += fabsf(diff);
          g = (diff > 0.0f ? 1.0f : (diff < 0.0f ? -1.0f : 0.0f)) * inv_n;
        } else if (mode == 1) {
          lsum += sq;
          g = __fmul_rn(2.0f * diff, inv_n);
        } else {
          const float q = __fdiv_rn(sq, CAUCHY_C2);
          lsum += __fmul_rn(CAUCHY_C2, log1pf(q));
          g = __fmul_rn(__fdiv_rn(2.0f * diff, __fadd_rn(1.0f, q)), inv_n);
        }
      }
      dval = __fmul_rn(__fmul_rn(g, p), 1.0f - p);
    }
    dv[i] = dval;
  }
  uint32_t hd[4] = {pack_bf16(dv[0], dv[1]), pack_bf16(dv[2], dv[3]), pack_bf16(dv[4], dv[5]),
                    pack_bf16(dv[6], dv[7])};
  float* bpart = bias_part + (size_t)blk * nbp;
  if (c == 0) {
    lsum = warp_sum(lsum);
    ssum = warp_sum(ssum);
    if (lane == 0) {
      red[4 * HALF + warp] = lsum;
      red[4 * HALF + 4 + warp] = ssum;
    }
    col_sums<2>(dv, red, warp, lane, cq, tid, bpart + HID * nh);  // publishes the loss sums too
    if (tid == 0) {
      float a = 0.0f, q = 0.0f;
      for (int w = 0; w < 4; ++w) {
        a += red[4 * HALF + w];
        q += red[4 * HALF + 4 + w];
      }
      loss_part[2 * blk] = a;
      loss_part[2 * blk + 1] = q;
    }
    __nv_bfloat16* dout = deltas + (size_t)nh * B * HID + (size_t)brow * OUTW;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (r0 < nrows) *reinterpret_cast<uint32_t*>(dout + (size_t)r0 * OUTW + 8 * j + cq) = hd[2 * j];
      if (r0 + 8 < nrows)
        *reinterpret_cast<uint32_t*>(dout + (size_t)(r0 + 8) * OUTW + 8 * j + cq) = hd[2 * j + 1];
    }
  }

  // ---------------- backward: D_l = (D_{l+1} . W_{l+1,h}^T) * (h_l > 0)
  for (int l = nh - 1; l >= 0; --l) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    {  // the relu mask: this thread's own activations (rows past B zero),
       // loaded while the products run
      const __nv_bfloat16* act = acts + ((size_t)l * B + brow) * HID + n0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + cq;
        mask[j][0] = r0 < nrows ? *reinterpret_cast<const uint32_t*>(act + (size_t)r0 * HID + col)
                                : 0u;
        mask[j][1] = r0 + 8 < nrows
                         ? *reinterpret_cast<const uint32_t*>(act + (size_t)(r0 + 8) * HID + col)
                         : 0u;
      }
    }
    if (l == nh - 1) {  // from the head: one k-step of 16
      tile_ready();
      wg_fence();
      wgmma_rs64<0>(acc, hd, gmma_desc(f.wring + (t % STAGES) * TILE_BYTES, 1024, 128));
      wg_commit();
      next_tile();
    } else {  // this CTA's half of D_{l+1} from registers, then the partner's
      tile_ready();
      mma_h(true, 0);
      next_tile();
      fetch((l + 2) & 1);
      tile_ready();
      mma_h(false, 0);
      next_tile();
    }
    __nv_bfloat16* dl = deltas + ((size_t)l * B + brow) * HID + n0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + cq;
      const uint32_t a0 = mask[j][0], a1 = mask[j][1];
      acc[4 * j] = bf16_lo(a0) > 0.0f ? acc[4 * j] : 0.0f;
      acc[4 * j + 1] = bf16_hi(a0) > 0.0f ? acc[4 * j + 1] : 0.0f;
      acc[4 * j + 2] = bf16_lo(a1) > 0.0f ? acc[4 * j + 2] : 0.0f;
      acc[4 * j + 3] = bf16_hi(a1) > 0.0f ? acc[4 * j + 3] : 0.0f;
      const uint32_t top = pack_bf16(acc[4 * j], acc[4 * j + 1]);
      const uint32_t bot = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      own[j >> 1][(j & 1) * 2] = top;
      own[j >> 1][(j & 1) * 2 + 1] = bot;
      if (r0 < nrows) *reinterpret_cast<uint32_t*>(dl + (size_t)r0 * HID + col) = top;
      if (r0 + 8 < nrows) *reinterpret_cast<uint32_t*>(dl + (size_t)(r0 + 8) * HID + col) = bot;
    }
    col_sums<8>(acc, red, warp, lane, cq, tid, bpart + HID * l + n0);
    if (l > 0) publish((l + 1) & 1);
  }
  cl.sync();  // the partner may still read this CTA's last exchange slot
}

// ------------------------------------------------------------------ wgrad

struct Wgrad {
  int n_mats;
  int tile0[MAXM + 1];     // first 64-row tile of each matrix; tile0[n_mats] = #tiles
  int nrows[MAXM];         // rows (the view rows of Wc1: venc_w, a partial tile)
  int ncols[MAXM];         // HID or OUTW
  long long w_off[MAXM];   // offset in the flat gradient
  int a_src[MAXM];         // -1: the feature rows, -2: the view rows; else the activation layer
  int d_src[MAXM];         // delta layer (nh: the head)
  int n_bias;              // bias entries
  long long b_off[MAXM];   // offset of each bias in the flat gradient
  int b_len[MAXM];
  int b_src[MAXM];         // offset of its partial sums in a block's partials
  int nbp, nblk;
  int nsplit;              // batch shares per tile
  long long n_w;           // size of the matrix region (a partial's stride)
};

Wgrad make_wgrad(const Net& n, int B) {
  Wgrad g{};
  int m = 0, t = 0;
  auto add = [&](long long off, int rows, int cols, int a, int d) {
    g.tile0[m] = t; g.nrows[m] = rows; g.ncols[m] = cols; g.w_off[m] = off;
    g.a_src[m] = a; g.d_src[m] = d;
    t += (rows + BM - 1) / BM; ++m;
  };
  auto addb = [&](long long off, int len, int src) {
    g.b_off[g.n_bias] = n.n_w + off; g.b_len[g.n_bias] = len; g.b_src[g.n_bias] = src;
    ++g.n_bias;
  };
  for (int i = 0; i < n.L - 1; ++i) {
    if (i == 0) {
      add(n.w_in, n.k_w, HID, -1, 0);
      addb(n.b[0], HID, 0);
    } else if (i == n.skip) {
      add(n.w_h[i], HID, HID, i - 1, i);
      add(n.w_x, n.k_w, HID, -1, i);
      addb(n.b[i], HID, HID * i);
      addb(n.b_x, HID, HID * i);
    } else {
      add(n.w_h[i], HID, HID, i - 1, i);
      addb(n.b[i], HID, HID * i);
    }
  }
  if (n.cat >= 0) {
    const int L = n.L;
    add(n.w_h[L - 1], HID, HID, L - 2, L - 1);  // bottleneck
    addb(n.b[L - 1], HID, HID * (L - 1));
    add(n.w_h[L], HID, HID, L - 1, L);          // concat: bottleneck rows
    add(n.w_v, n.venc_w, HID, -2, L);           //         view rows
    addb(n.b[L], HID, HID * L);
  }
  add(n.w_h[n.nh], HID, OUTW, n.nh - 1, n.nh);
  addb(n.b[n.nh], OUTW, HID * n.nh);
  g.n_mats = m;
  g.tile0[m] = t;
  g.nbp = HID * n.nh + OUTW;
  g.nblk = (B + BM - 1) / BM;
  g.nsplit = g.nblk < NSPLIT ? g.nblk : NSPLIT;
  g.n_w = n.n_w;
  return g;
}

template <typename XT>
__global__ void __launch_bounds__(NTHREADS)
wgrad_kernel(const XT* __restrict__ x, long long row0, int B, int k_in,
             const XT* __restrict__ venc, int venc_in, int venc_w,
             const __nv_bfloat16* __restrict__ acts, const __nv_bfloat16* __restrict__ deltas,
             const float* __restrict__ bias_part, const float* __restrict__ loss_part,
             float* __restrict__ grads, float* __restrict__ sums, float* __restrict__ wpart,
             int* __restrict__ counters, Wgrad g) {
  __shared__ __align__(128) __nv_bfloat16 sa[BM * LDX];  // [batch, 64 rows of A^T]
  __shared__ __align__(128) __nv_bfloat16 sd[BM * LDW];  // [batch, N]
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int n_tiles = g.tile0[g.n_mats];
  if ((int)blockIdx.x == n_tiles * g.nsplit) {
    // bias gradients and the loss sums: per-block partials in block order
    for (int e = 0; e < g.n_bias; ++e) {
      for (int c = tid; c < g.b_len[e]; c += NTHREADS) {
        float sum = 0.0f;
        for (int blk = 0; blk < g.nblk; ++blk) sum += bias_part[(size_t)blk * g.nbp + g.b_src[e] + c];
        grads[g.b_off[e] + c] = sum;
      }
    }
    if (tid == 0) {
      float a = 0.0f, q = 0.0f;
      for (int blk = 0; blk < g.nblk; ++blk) {
        a += loss_part[2 * blk];
        q += loss_part[2 * blk + 1];
      }
      sums[0] = a;
      sums[1] = q;
    }
    return;
  }
  const int tile = blockIdx.x / g.nsplit;
  const int split = blockIdx.x - tile * g.nsplit;
  int m = 0;
  while (tile >= g.tile0[m + 1]) ++m;
  const int r0 = (tile - g.tile0[m]) * BM;  // first row of this tile of dW (input index)
  const int per = (g.nblk + g.nsplit - 1) / g.nsplit;  // batch chunks per split
  const int c_end = min(g.nblk, (split + 1) * per);
  const int N = g.ncols[m];
  const int mrows = min(BM, g.nrows[m] - r0);  // rows of this tile (16 | mrows)
  const int warp = tid >> 5;
  const int rt = warp & 3;
  const int cg = warp >> 2;
  const __nv_bfloat16* D = deltas + (size_t)g.d_src[m] * B * HID;  // row stride N
  const __nv_bfloat16* A = g.a_src[m] >= 0 ? acts + (size_t)g.a_src[m] * B * HID : nullptr;
  const XT* xrows = x + (size_t)row0 * k_in;
  const XT* vrows = venc != nullptr ? venc + (size_t)row0 * venc_w : nullptr;

  FragC acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int chunk = split * per; chunk < c_end; ++chunk) {
    const int b0 = chunk * BM;
    const int nb = min(BM, B - b0);
    if (g.a_src[m] == -1) {
      load_x_chunk(sa, xrows + (size_t)b0 * k_in, nb, k_in, k_in, r0, tid);
    } else if (g.a_src[m] == -2) {
      load_x_chunk(sa, vrows + (size_t)b0 * venc_w, nb, venc_w, venc_in, r0, tid);
    } else {
      for (int i = tid; i < BM * (KC / 8); i += NTHREADS) {  // 16-byte vectors
        const int r = i / (KC / 8);
        const int c = (i - r * (KC / 8)) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r < nb) v = *reinterpret_cast<const uint4*>(A + (size_t)(b0 + r) * HID + r0 + c);
        *reinterpret_cast<uint4*>(sa + r * LDX + c) = v;
      }
    }
    const int vpr = N / 8;
    for (int i = tid; i < BM * vpr; i += NTHREADS) {
      const int r = i / vpr;
      const int c = (i - r * vpr) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < nb) v = *reinterpret_cast<const uint4*>(D + (size_t)(b0 + r) * N + c);
      *reinterpret_cast<uint4*>(sd + r * LDW + c) = v;
    }
    __syncthreads();
    if (N == HID || cg == 0) {
#pragma unroll
      for (int kk = 0; kk < BM; kk += 16) {
        FragAc a;  // a(m, k) = A(k, m): A^T read column-major from A's rows
        wmma::load_matrix_sync(a, sa + kk * LDX + rt * 16, LDX);
        if (N == HID) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            FragB b;
            wmma::load_matrix_sync(b, sd + kk * LDW + cg * 64 + j * 16, LDW);
            wmma::mma_sync(acc[j], a, b, acc[j]);
          }
        } else {
          FragB b;
          wmma::load_matrix_sync(b, sd + kk * LDW, LDW);
          wmma::mma_sync(acc[0], a, b, acc[0]);
        }
      }
    }
    __syncthreads();
  }
  // this split's partial tile; with one split it is the gradient itself
  float* dst = g.nsplit == 1 ? grads : wpart + (size_t)split * g.n_w;
  float* out = dst + g.w_off[m] + (size_t)(r0 + rt * 16) * N;
  if (rt * 16 >= mrows) {
    // past the matrix's last row (a partial tile): nothing to store
  } else if (N == HID) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(out + cg * 64 + j * 16, acc[j], N, wmma::mem_row_major);
  } else if (cg == 0) {
    wmma::store_matrix_sync(out, acc[0], N, wmma::mem_row_major);
  }
  if (g.nsplit == 1) return;
  // the last split of this tile to arrive sums the partials in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(counters + tile, 1) == g.nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const size_t base = g.w_off[m] + (size_t)r0 * N;
  for (int i = tid; i < mrows * N; i += NTHREADS) {
    float sum = 0.0f;
    for (int sp = 0; sp < g.nsplit; ++sp) sum += __ldcg(wpart + (size_t)sp * g.n_w + base + i);
    grads[base + i] = sum;
  }
  if (tid == 0) counters[tile] = 0;  // ready for the next launch
}

bool bad_net(int B, int k_in, int k_w, int L, int skip, int venc_in, int venc_w) {
  const bool bad_venc = venc_w > 0 && (venc_in <= 0 || venc_w < venc_in || venc_w % 16 != 0 ||
                                       venc_w > VENC_MAX || L + 4 > MAXM);
  return B <= 0 || k_in <= 0 || k_w < k_in || k_w % KC != 0 || L < 3 || L > MAXL ||
         skip <= 0 || skip >= L - 1 || venc_w < 0 || bad_venc;
}

// Launch shape of fwd_bwd: {CTAs, cluster size, threads, shared memory
// bytes, 1 if the feature tile stays resident}.
void fwd_bwd_config(int B, const Net& net, int (&out)[5]) {
  const int k_w = net.k_w;
  const bool vd = net.cat >= 0;
  const int fixed = STAGES * TILE_BYTES + (vd ? TILE_BYTES : 0) + 2 * XCHG_BYTES +
                    RED_FLOATS * (int)sizeof(float) + fwd_bwd_tiles(net) * (int)sizeof(Tile);
  const bool x_res = fixed + (k_w / KC) * TILE_BYTES <= SMEM_LIMIT;
  out[0] = 2 * ((B + BM - 1) / BM);
  out[1] = 2;
  out[2] = FB_THREADS;
  out[3] = fixed + (x_res ? k_w / KC : STAGES) * TILE_BYTES;
  out[4] = x_res;
}

template <typename XT, bool VD>
int launch_fwd_bwd_kernel(const XT* x, long long row0, int B, const float* params,
                          const __nv_bfloat16* wb, const Net& net, const XT* venc, int venc_in,
                          const float* target, int mode, float inv_n, void* acts, void* deltas,
                          float* bias_part, float* loss_part, int* launched, cudaStream_t st) {
  int cfg[5];
  fwd_bwd_config(B, net, cfg);
  auto kern = fwd_bwd_kernel<XT, VD>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, cfg[3]);
  if (err != cudaSuccess) return (int)err;
  // cp.async of 16-byte feature pieces: bf16 rows on 16-byte boundaries
  const int x_async = sizeof(XT) == 2 && net.k_in % 8 == 0 && (uintptr_t)x % 16 == 0;
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3(cfg[0]);
  lc.blockDim = dim3(cfg[2]);
  lc.dynamicSmemBytes = (size_t)cfg[3];
  lc.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cfg[1];
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  lc.attrs = attr;
  lc.numAttrs = 1;
  err = cudaLaunchKernelEx(&lc, kern, x, row0, B, params, wb, net, venc, venc_in, target, mode,
                           inv_n, x_async, cfg[4], fwd_bwd_tiles(net), (__nv_bfloat16*)acts,
                           (__nv_bfloat16*)deltas, bias_part, loss_part);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (launched) {  // the shape this launch ran with
    launched[0] = (int)lc.gridDim.x;
    launched[1] = (int)attr[0].val.clusterDim.x;
    launched[2] = (int)lc.blockDim.x;
    launched[3] = (int)lc.dynamicSmemBytes;
    launched[4] = cfg[4];
  }
  return 0;
}

int launch_fwd_bwd(const void* x, int x_bf16, long long row0, int B, int k_in,
                   const float* params, const void* wb, int k_w, int num_layers, int skip_idx,
                   const void* venc, int venc_in, int venc_w, const float* target, int mode,
                   float inv_n, void* acts, void* deltas, float* bias_part, float* loss_part,
                   int* launched, void* stream) {
  if (bad_net(B, k_in, k_w, num_layers, skip_idx, venc_in, venc_w) || mode < 0 ||
      mode > 3 || wb == nullptr || (uintptr_t)wb % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Net net = make_net(k_in, k_w, num_layers, skip_idx, venc_w);
  cudaStream_t st = (cudaStream_t)stream;
  const auto* w = (const __nv_bfloat16*)wb;
  if (x_bf16) {
    const auto* xb = (const __nv_bfloat16*)x;
    const auto* vb = (const __nv_bfloat16*)venc;
    return venc_w > 0
               ? launch_fwd_bwd_kernel<__nv_bfloat16, true>(xb, row0, B, params, w, net, vb,
                                                            venc_in, target, mode, inv_n, acts,
                                                            deltas, bias_part, loss_part,
                                                            launched, st)
               : launch_fwd_bwd_kernel<__nv_bfloat16, false>(xb, row0, B, params, w, net, vb,
                                                             venc_in, target, mode, inv_n, acts,
                                                             deltas, bias_part, loss_part,
                                                             launched, st);
  }
  const auto* xf = (const float*)x;
  const auto* vf = (const float*)venc;
  return venc_w > 0
             ? launch_fwd_bwd_kernel<float, true>(xf, row0, B, params, w, net, vf, venc_in,
                                                  target, mode, inv_n, acts, deltas, bias_part,
                                                  loss_part, launched, st)
             : launch_fwd_bwd_kernel<float, false>(xf, row0, B, params, w, net, vf, venc_in,
                                                   target, mode, inv_n, acts, deltas, bias_part,
                                                   loss_part, launched, st);
}

int launch_wgrad(const void* x, int x_bf16, long long row0, int B, int k_in, int k_w,
                 int num_layers, int skip_idx, const void* venc, int venc_in, int venc_w,
                 const void* acts, const void* deltas, const float* bias_part,
                 const float* loss_part, float* grads, float* sums, float* wpart, int* counters,
                 void* stream) {
  if (bad_net(B, k_in, k_w, num_layers, skip_idx, venc_in, venc_w))
    return (int)cudaErrorInvalidValue;
  const Net net = make_net(k_in, k_w, num_layers, skip_idx, venc_w);
  const Wgrad g = make_wgrad(net, B);
  const dim3 grid(g.tile0[g.n_mats] * g.nsplit + 1);
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16)
    wgrad_kernel<__nv_bfloat16><<<grid, NTHREADS, 0, st>>>(
        (const __nv_bfloat16*)x, row0, B, k_in, (const __nv_bfloat16*)venc, venc_in, venc_w,
        (const __nv_bfloat16*)acts, (const __nv_bfloat16*)deltas, bias_part, loss_part, grads,
        sums, wpart, counters, g);
  else
    wgrad_kernel<float><<<grid, NTHREADS, 0, st>>>(
        (const float*)x, row0, B, k_in, (const float*)venc, venc_in, venc_w,
        (const __nv_bfloat16*)acts, (const __nv_bfloat16*)deltas, bias_part, loss_part, grads,
        sums, wpart, counters, g);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). They launch on `stream` and
// return cudaGetLastError() (0 on success); they never synchronize.
//
// x: the feature table ([*, k_in] row-major, bf16 if x_bf16 else f32); the
// batch is rows [row0, row0 + B). params: flat f32 (matrix region, then
// biases; fwd_bwd reads the biases); wb: its bf16 copy (round to nearest
// even, 16-byte aligned; fwd_bwd reads the matrices). target: [B, 3] f32.
// Scratch: acts [nh, B, HID] bf16; deltas [nh, B, HID] then [B, OUTW]
// bf16; bias_part [nblk, HID*nh+OUTW] f32; loss_part [nblk, 2] f32, nblk =
// ceil(B / 64); nh = num_layers - 1 (the _viewdep entry points:
// num_layers + 1). launched (null, or 5 ints): on success, the shape the
// launch ran with: {CTAs, cluster size, threads per CTA, shared memory
// bytes, feature tile resident (0/1)}.
extern "C" int fused_mlp_fwd_bwd(const void* x, int x_bf16, long long row0, int B, int k_in,
                                 const float* params, const void* wb, int k_w, int num_layers,
                                 int skip_idx, const float* target, int mode, float inv_n,
                                 void* acts, void* deltas, float* bias_part, float* loss_part,
                                 int* launched, void* stream) {
  return launch_fwd_bwd(x, x_bf16, row0, B, k_in, params, wb, k_w, num_layers, skip_idx, nullptr,
                        0, 0, target, mode, inv_n, acts, deltas, bias_part, loss_part, launched,
                        stream);
}

// The view-dependent field: venc is the encoded view-direction table
// beside x ([*, venc_w] row-major, x's dtype, the same rows), of which
// lanes [0, venc_in) are read; venc_w = the view rows of Wc1 in params.
extern "C" int fused_mlp_fwd_bwd_viewdep(const void* x, int x_bf16, long long row0, int B,
                                         int k_in, const float* params, const void* wb, int k_w,
                                         int num_layers, int skip_idx, const void* venc,
                                         int venc_in, int venc_w, const float* target, int mode,
                                         float inv_n, void* acts, void* deltas,
                                         float* bias_part, float* loss_part, int* launched,
                                         void* stream) {
  if (venc == nullptr || venc_w <= 0) return (int)cudaErrorInvalidValue;
  return launch_fwd_bwd(x, x_bf16, row0, B, k_in, params, wb, k_w, num_layers, skip_idx, venc,
                        venc_in, venc_w, target, mode, inv_n, acts, deltas, bias_part,
                        loss_part, launched, stream);
}

// grads: flat f32 like params (every entry written); sums: [2] f32 (loss,
// squared error) summed over the batch. Scratch: wpart [8, size of the
// matrix region] f32; counters: one int per gradient tile of the matrices,
// zero before the first launch (each launch leaves them zero).
extern "C" int fused_mlp_wgrad(const void* x, int x_bf16, long long row0, int B, int k_in,
                               int k_w, int num_layers, int skip_idx, const void* acts,
                               const void* deltas, const float* bias_part,
                               const float* loss_part, float* grads, float* sums, float* wpart,
                               int* counters, void* stream) {
  return launch_wgrad(x, x_bf16, row0, B, k_in, k_w, num_layers, skip_idx, nullptr, 0, 0,
                      acts, deltas, bias_part, loss_part, grads, sums, wpart, counters, stream);
}

extern "C" int fused_mlp_wgrad_viewdep(const void* x, int x_bf16, long long row0, int B,
                                       int k_in, int k_w, int num_layers, int skip_idx,
                                       const void* venc, int venc_in, int venc_w,
                                       const void* acts, const void* deltas,
                                       const float* bias_part, const float* loss_part,
                                       float* grads, float* sums, float* wpart, int* counters,
                                       void* stream) {
  if (venc == nullptr || venc_w <= 0) return (int)cudaErrorInvalidValue;
  return launch_wgrad(x, x_bf16, row0, B, k_in, k_w, num_layers, skip_idx, venc, venc_in,
                      venc_w, acts, deltas, bias_part, loss_part, grads, sums, wpart, counters,
                      stream);
}

// Constants the Python wrapper checks its layout against.
extern "C" int fused_mlp_train_kc() { return KC; }
extern "C" int fused_mlp_train_out_pad() { return OUTW; }
extern "C" int fused_mlp_train_block_rows() { return BM; }
extern "C" int fused_mlp_train_nsplit() { return NSPLIT; }
extern "C" int fused_mlp_train_venc_max() { return VENC_MAX; }
