// Training kernels of the texture field's skip-MLP, hand-written for Hopper
// (sm_90a): bf16 tensor cores through wgmma, operands streamed by cp.async,
// thread-block clusters (device code shared with the forward kernel in
// mlp_tiles.cuh).
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
//   fused_mlp_wgrad  one cluster of up to 8 CTAs per 128-row tile of each
//     weight gradient, each CTA contracting dW = A^T . D over its share of
//     the batch with f32 accumulation (A the layer input: the feature rows
//     straight from the table, or the saved activations); the cluster sums
//     its partials on chip, in rank order (design: the wgrad section
//     below). Every warp of the grid also sums one bias entry or loss sum
//     over the per-block partials, in a fixed order.
//   fused_mlp_wgrad_adam  the same kernel with an Adam epilogue (the train
//     step of make_fused_train_adam): the owner of each final gradient
//     entry applies csrc/adam.cuh to its parameter, moments and bf16 copy
//     instead of storing the gradient, and the loss sums also go into the
//     epoch's accumulators. A train step is then two launches.
//
// Given the epoch's block order (nullable), the entry points take the
// batch's place on the device, as the TPU kernel takes its
// scalar-prefetched block offset: a step number i, so row0 = order[i] * B
// is read at kernel start, the targets are read at the same rows of the
// whole table and the Adam hyper row is row i of the epoch's table. A
// step's launch arguments then do not depend on the permutation, and an
// epoch can be captured once as a CUDA graph and replayed.
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
// latency-bound: a chain of dependent 64-row products per cluster; wgrad by
// the chunks it streams from L2 (every tile reads all of its deltas).

#include "adam.cuh"
#include "mlp_tiles.cuh"

namespace {

constexpr int MAXM = MAXL + 1; // most weight matrices (the skip layer has two)
constexpr int VENC_MAX = KC;   // most view-encoding lanes (one x tile)
constexpr float CAUCHY_C2 = (float)((20.0 / 255.0) * (20.0 / 255.0));  // as the f32 ops see it

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
constexpr int RED_FLOATS = 4 * HALF + 8;

// Tiles in the program (tile_at's length): the forward's, the head's
// transpose, the h-matrices' transposes.
int fwd_bwd_tiles(const Net& net) { return forward_tiles(net) + 1 + 2 * (net.nh - 1); }

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
    if (d.kind == T_FWD || d.kind == T_FWD_VENC || d.kind == T_FWD_HEAD) {
      load_fwd_w_tile<FB_THREADS>(ws, W, d.kind, d.k0, n0, d.kind == T_FWD ? KC : venc_w, tid,
                                  [&](void* dst, const __nv_bfloat16* src) { cpw(dst, src); });
      if (d.kind == T_FWD_VENC) load_rows(vs, vrows, venc_w, venc_in, 0, false);
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
fwd_bwd_kernel(const XT* __restrict__ x, const int* __restrict__ order, int step, long long row0,
               int B, const float* __restrict__ params, const __nv_bfloat16* __restrict__ wb,
               Net net, const XT* __restrict__ venc, int venc_in, const float* __restrict__ target,
               long long target_row0, int mode, float inv_n, int x_async, int x_res, int n_tiles,
               __nv_bfloat16* __restrict__ acts, __nv_bfloat16* __restrict__ deltas,
               float* __restrict__ bias_part, float* __restrict__ loss_part) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if (order != nullptr) row0 = (long long)order[step] * B;  // the step's block, on the device
  target += (row0 - target_row0) * NOUT;  // target's first row is row target_row0 of x
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
//
// One thread-block cluster of S CTAs (S = min(8, 64-row batch chunks)) per
// 128-row tile of a weight gradient. CTA r of the cluster contracts dW =
// A^T . D over its share of the chunks (shares differ by at most one chunk,
// in batch order) with two consumer warpgroups of 64 rows each, which share
// every D chunk. The chunks (A^T: 128 rows x 64 batch rows; D: 64 batch
// rows x N columns; both MN-major in wgmma's no-swizzle layout) stream in
// by cp.async into a 3-stage ring, two chunks ahead; table rows that are
// f32 or off 16-byte boundaries go through converting loads (two CTAs per
// SM hide part of their latency). The view rows are copied whole (venc_w
// lanes); their pad lanes meet only the pad rows of the gradient, which
// are written as zero. wgmma accumulates in f32 registers (m64n64k16 twice per k-step,
// m64n16k16 for the head). The split partials then meet on chip: each CTA
// writes its partial into its own shared memory (the ring, free by then);
// after a cluster barrier, CTA r sums the r-th share of the tile's entries
// over the S partials through distributed shared memory, in rank order, and
// writes them out. So no partial crosses device memory, no arrival counter
// is needed, and every launch gives the same bits. While its first chunks
// arrive, every warp of the grid sums one bias entry (or loss sum) over
// fwd_bwd's per-64-row partials: lane l the blocks l, l+32, ... in order,
// then a fixed shuffle tree.
//
// With the Adam epilogue (ADAM), the owner of each final entry updates its
// parameter instead of storing the gradient: CTA r of a tile's cluster the
// entries of its share, read p, m and v, write them back and write the bf16
// copy (round to nearest even); lane 0 of a bias item's warp its bias entry;
// the loss-sum items write `sums` and add into the epoch's accumulators,
// acc[0] += loss_sum / 3 and acc[1] += sq_sum (step-ordered because the
// launches are). The flat layout (ops/fused_mlp.py:ParamLayout) is the
// matrix region, the matrices back to back in make_wgrad's order, then the
// bias region, the biases back to back in its order, with no gap; so the
// tiles, which cover every row of every matrix (pad rows included: rows
// past k_in, the view rows past venc_in, the head's 13 pad columns), and
// the bias items, which cover every bias entry (the head's 13 pad entries
// included), update each of the layout's n entries exactly once. A pad
// entry takes g = 0 (its gradient is exactly zero: zero table lanes, zero
// head deltas), as the split path's Adam over the whole buffer gives it.
// The kernel reads neither params nor wb but the entries it owns, after
// fwd_bwd (earlier on the stream) has read them.

constexpr int WG_THREADS = 256;                      // two consumer warpgroups
constexpr int WG_ROWS = 128;                         // gradient rows per tile
constexpr int WG_STAGES = 3;                         // chunk ring depth
constexpr int WG_MAX_SPLIT = 8;                      // most CTAs of a cluster (portable)
constexpr int A_BYTES = WG_ROWS * KC * 2;            // an A^T chunk: 16 KB
constexpr int STAGE_BYTES = A_BYTES + KC * HID * 2;  // and a D chunk: 32 KB
constexpr int PART_F4 = WG_THREADS * HID / 8;        // a partial tile in float4s

struct AdamArgs {
  float* p;             // flat f32 params, m, v: updated in place
  float* m;
  float* v;
  __nv_bfloat16* wb;    // the params' bf16 copy: written
  const float* hyper;   // [steps, 128] hyper rows (row `step` is read)
  float* acc;           // [2] epoch accumulators (loss, squared error), or null
};

struct Wgrad {
  int n_mats;
  int tile0[MAXM + 1];     // first 128-row tile of each matrix; tile0[n_mats] = #tiles
  int nrows[MAXM];         // rows (the view rows of Wc1: venc_w, a partial tile)
  int ncols[MAXM];         // HID or OUTW
  long long w_off[MAXM];   // offset in the flat gradient
  int a_src[MAXM];         // -1: the feature rows, -2: the view rows; else the activation layer
  int d_src[MAXM];         // delta layer (nh: the head)
  int n_bias;              // bias entries
  long long b_off[MAXM];   // offset of each bias in the flat gradient
  int b_len[MAXM];
  int b_src[MAXM];         // offset of its partial sums in a block's partials
  int n_items;             // bias columns of every entry, then the two loss sums
  int nbp, nblk;           // partials per fwd_bwd block; fwd_bwd blocks (64 rows each)
};

Wgrad make_wgrad(const Net& n, int B) {
  Wgrad g{};
  int m = 0, t = 0;
  auto add = [&](long long off, int rows, int cols, int a, int d) {
    g.tile0[m] = t; g.nrows[m] = rows; g.ncols[m] = cols; g.w_off[m] = off;
    g.a_src[m] = a; g.d_src[m] = d;
    t += (rows + WG_ROWS - 1) / WG_ROWS; ++m;
  };
  auto addb = [&](long long off, int len, int src) {
    g.b_off[g.n_bias] = n.n_w + off; g.b_len[g.n_bias] = len; g.b_src[g.n_bias] = src;
    g.n_items += len;
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
  g.n_items += 2;
  g.nbp = HID * n.nh + OUTW;
  g.nblk = (B + BM - 1) / BM;
  return g;
}

// Adam on the two entries at off, off + 1 from their gradients (a float2
// of the flat buffer: off is even).
__device__ __forceinline__ void adam_pair(const AdamArgs& ad, const AdamHyper& h, size_t off,
                                          float2 gq) {
  float2 pq = *reinterpret_cast<const float2*>(ad.p + off);
  float2 mq = *reinterpret_cast<const float2*>(ad.m + off);
  float2 vq = *reinterpret_cast<const float2*>(ad.v + off);
  adam_update(h, gq.x, pq.x, mq.x, vq.x);
  adam_update(h, gq.y, pq.y, mq.y, vq.y);
  *reinterpret_cast<float2*>(ad.p + off) = pq;
  *reinterpret_cast<float2*>(ad.m + off) = mq;
  *reinterpret_cast<float2*>(ad.v + off) = vq;
  *reinterpret_cast<__nv_bfloat162*>(ad.wb + off) = __floats2bfloat162_rn(pq.x, pq.y);
}

template <typename XT, bool ADAM>
__global__ void __launch_bounds__(WG_THREADS, 2)
wgrad_kernel(const XT* __restrict__ x, const int* __restrict__ order, int step, long long row0,
             int B, int k_in, int t_async, const XT* __restrict__ venc, int venc_in, int venc_w,
             const __nv_bfloat16* __restrict__ acts, const __nv_bfloat16* __restrict__ deltas,
             const float* __restrict__ bias_part, const float* __restrict__ loss_part,
             float* __restrict__ grads, float* __restrict__ sums, Wgrad g, AdamArgs ad) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if (order != nullptr) row0 = (long long)order[step] * B;  // the step's block, on the device
  if (ADAM) ad.hyper += (size_t)step * 128;
  cg::cluster_group cl = cg::this_cluster();
  const int S = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.x / S;
  int m = 0;
  while (tile >= g.tile0[m + 1]) ++m;
  const int r0 = (tile - g.tile0[m]) * WG_ROWS;  // first row of this tile of dW (input index)
  const int N = g.ncols[m];
  const int mrows = min(WG_ROWS, g.nrows[m] - r0);
  const int nchunk = (B + BM - 1) / BM;
  const int c_begin = (int)((long long)rank * nchunk / S);
  const int c_end = (int)((long long)(rank + 1) * nchunk / S);
  const int a_src = g.a_src[m];
  const __nv_bfloat16* D = deltas + (size_t)g.d_src[m] * B * HID;  // row stride N
  const __nv_bfloat16* A = a_src >= 0 ? acts + (size_t)a_src * B * HID : nullptr;
  // a table operand: the feature rows (k_in lanes) or the view rows (venc_in of venc_w)
  const XT* tab = a_src == -1 ? x + (size_t)row0 * k_in
                              : (a_src == -2 ? venc + (size_t)row0 * venc_w : nullptr);
  const int tab_ld = a_src == -1 ? k_in : venc_w;
  const bool copy_a = a_src >= 0 || (a_src == -1 && (t_async & 1)) ||
                      (a_src == -2 && (t_async & 2));
  const int tab_cols = a_src == -1 ? k_in : (copy_a ? venc_w : venc_in);
  const int mvalid = a_src == -2 ? venc_in : mrows;  // rows past it are written as zero
  const int dpr = N / 8;  // 16-byte pieces per D row

  // Chunk i of this CTA's share into ring slot i % WG_STAGES (one commit
  // group, empty past the share). A^T (m, b) at (b/8)*2048 + (m/8)*128 +
  // (b%8)*16 + (m%8)*2; D (b, n) at (b/8)*16N + (n/8)*128 + (b%8)*16 +
  // (n%8)*2; batch rows past B read as zero.
  auto issue = [&](int i) {
    const int chunk = c_begin + i;
    if (chunk < c_end) {
      unsigned char* sa = smem_raw + (i % WG_STAGES) * STAGE_BYTES;
      unsigned char* sd = sa + A_BYTES;
      const int b0 = chunk * BM;
      const int nb = min(BM, B - b0);
      if (copy_a) {
        for (int j = tid; j < BM * (WG_ROWS / 8); j += WG_THREADS) {
          const int b = j >> 4, mg = j & 15, gm = r0 + 8 * mg;
          const bool ok = b < nb && (a_src >= 0 || gm < tab_cols);
          const void* src = a_src >= 0 ? (const void*)(A + (size_t)(b0 + b) * HID + gm)
                                       : (const void*)(tab + (size_t)(b0 + b) * tab_ld + gm);
          cp16(sa + (b >> 3) * 2048 + mg * 128 + (b & 7) * 16, ok ? src : (const void*)D,
               ok ? 16 : 0);
        }
      } else {
#pragma unroll 8
        for (int j = tid; j < BM * WG_ROWS; j += WG_THREADS) {
          const int b = j >> 7, mm = j & 127, gm = r0 + mm;
          const float v =
              (b < nb && gm < tab_cols) ? to_f(tab[(size_t)(b0 + b) * tab_ld + gm]) : 0.0f;
          *reinterpret_cast<__nv_bfloat16*>(sa + (b >> 3) * 2048 + (mm >> 3) * 128 +
                                            (b & 7) * 16 + (mm & 7) * 2) = __float2bfloat16_rn(v);
        }
      }
      for (int j = tid; j < BM * dpr; j += WG_THREADS) {
        const int b = j / dpr, ng = j - b * dpr;
        const bool ok = b < nb;
        cp16(sd + (b >> 3) * (16 * N) + ng * 128 + (b & 7) * 16,
             ok ? (const void*)(D + (size_t)(b0 + b) * N + 8 * ng) : (const void*)D, ok ? 16 : 0);
      }
    }
    cp_commit();
  };

  for (int s = 0; s < WG_STAGES - 1; ++s) issue(s);

  // Bias gradients and the loss sums, one per warp of the grid.
  const int n_warps = (int)gridDim.x * (WG_THREADS / 32);
  for (int item = (int)blockIdx.x * (WG_THREADS / 32) + warp; item < g.n_items;
       item += n_warps) {
    int e = 0, c = item;
    while (e < g.n_bias && c >= g.b_len[e]) c -= g.b_len[e++];
    const float* src = e < g.n_bias ? bias_part + g.b_src[e] + c : loss_part + c;
    const int stride = e < g.n_bias ? g.nbp : 2;
    float s = 0.0f;
    for (int blk = lane; blk < g.nblk; blk += 32) s += src[(size_t)blk * stride];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      if (e == g.n_bias) {
        sums[c] = s;
        if (ADAM && ad.acc != nullptr)
          ad.acc[c] = __fadd_rn(ad.acc[c], c == 0 ? __fdiv_rn(s, 3.0f) : s);
      } else if (ADAM) {
        const size_t o = (size_t)g.b_off[e] + c;
        float p = ad.p[o], m = ad.m[o], v = ad.v[o];
        adam_update(adam_hyper(ad.hyper), s, p, m, v);
        ad.p[o] = p;
        ad.m[o] = m;
        ad.v[o] = v;
        ad.wb[o] = __float2bfloat16_rn(p);
      } else {
        grads[g.b_off[e] + c] = s;
      }
    }
  }

  float acc0[32], acc1[32], acc16[8];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc16[i] = 0.0f;
  for (int i = 0; i < c_end - c_begin; ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(WG_STAGES - 2) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // chunk i is in; every warpgroup is done with chunk i - 1's slot
    issue(i + WG_STAGES - 1);
    const unsigned char* sa = smem_raw + (i % WG_STAGES) * STAGE_BYTES + wg * 1024;
    const unsigned char* sd = smem_raw + (i % WG_STAGES) * STAGE_BYTES + A_BYTES;
    wg_fence();
    if (N == HID) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint64_t ad = gmma_desc(sa + q * 4096, 2048, 128);
        wgmma_ss64<1, 1>(acc0, ad, gmma_desc(sd + q * 4096, 2048, 128));
        wgmma_ss64<1, 1>(acc1, ad, gmma_desc(sd + q * 4096 + 1024, 2048, 128));
      }
      wg_commit();
      wg_wait(acc0);
      wg_wait(acc1);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wgmma_ss16<1, 1>(acc16, gmma_desc(sa + q * 4096, 2048, 128),
                         gmma_desc(sd + q * 512, 256, 128));
      wg_commit();
      wg_wait(acc16);
    }
  }

  // This CTA's partial, float4 f of thread tid at [f * WG_THREADS + tid]
  // (f: 8-column group; the accumulator's rows r, r + 8 at columns c, c + 1).
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // every warpgroup's products are done: the ring is free
  float4* red = reinterpret_cast<float4*>(smem_raw);
  if (N == HID) {
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      red[f * WG_THREADS + tid] = make_float4(acc0[4 * f], acc0[4 * f + 1], acc0[4 * f + 2],
                                              acc0[4 * f + 3]);
      red[(8 + f) * WG_THREADS + tid] = make_float4(acc1[4 * f], acc1[4 * f + 1],
                                                    acc1[4 * f + 2], acc1[4 * f + 3]);
    }
  } else {
#pragma unroll
    for (int f = 0; f < 2; ++f)
      red[f * WG_THREADS + tid] = make_float4(acc16[4 * f], acc16[4 * f + 1], acc16[4 * f + 2],
                                              acc16[4 * f + 3]);
  }
  AdamHyper h{};
  if (ADAM) h = adam_hyper(ad.hyper);  // its latency overlaps the cluster barrier
  cl.sync();
  // the r-th share of the tile's float4s: summed over the S partials in rank order
  const int total = dpr * WG_THREADS;
  const size_t out0 = (size_t)g.w_off[m] + (size_t)r0 * N;
  for (int idx = rank * total / S + tid; idx < (rank + 1) * total / S; idx += WG_THREADS) {
    float4 s = *cl.map_shared_rank(red + idx, 0);
    for (int q = 1; q < S; ++q) {
      const float4 v = *cl.map_shared_rank(red + idx, q);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    const int f = idx / WG_THREADS, t = idx - f * WG_THREADS, tw = t & 127;
    const int row = 64 * (t >> 7) + 16 * (tw >> 5) + ((tw & 31) >> 2);
    const int col = 8 * f + 2 * (tw & 3);
    const float2 top = row < mvalid ? make_float2(s.x, s.y) : make_float2(0.0f, 0.0f);
    const float2 bot = row + 8 < mvalid ? make_float2(s.z, s.w) : make_float2(0.0f, 0.0f);
    const size_t o_top = out0 + (size_t)row * N + col, o_bot = o_top + (size_t)8 * N;
    if (ADAM) {
      if (row < mrows) adam_pair(ad, h, o_top, top);
      if (row + 8 < mrows) adam_pair(ad, h, o_bot, bot);
    } else {
      if (row < mrows) *reinterpret_cast<float2*>(grads + o_top) = top;
      if (row + 8 < mrows) *reinterpret_cast<float2*>(grads + o_bot) = bot;
    }
  }
  cl.sync();  // the other CTAs may still read this CTA's partial
}

bool bad_net(int B, int k_in, int k_w, int L, int skip, int venc_in, int venc_w) {
  const bool bad_venc = venc_w > 0 && (venc_in <= 0 || venc_w < venc_in || venc_w % 16 != 0 ||
                                       venc_w > VENC_MAX || L + 4 > MAXM);
  return B <= 0 || k_in <= 0 || k_w < k_in || k_w % KC != 0 || L < 3 || L > MAXL ||
         skip <= 0 || skip >= L - 1 || venc_w < 0 || bad_venc;
}

constexpr int WG_SMEM = WG_STAGES * STAGE_BYTES;

// Raise every kernel's dynamic shared memory ceiling once per device (the
// attribute belongs to the current device) to the most any of its launches
// takes (fwd_bwd: the limit; wgrad: its ring), so that no launch, and none
// captured into a CUDA graph, calls cudaFuncSetAttribute. It also loads
// every kernel of the library.
constexpr int MAX_DEVICES = 64;

int prepare_kernels() {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  const cudaError_t dev_err = cudaGetDevice(&dev);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (done[dev]) return 0;
  const void* fb[] = {(const void*)fwd_bwd_kernel<__nv_bfloat16, false>,
                      (const void*)fwd_bwd_kernel<__nv_bfloat16, true>,
                      (const void*)fwd_bwd_kernel<float, false>,
                      (const void*)fwd_bwd_kernel<float, true>};
  const void* wg[] = {(const void*)wgrad_kernel<__nv_bfloat16, false>,
                      (const void*)wgrad_kernel<__nv_bfloat16, true>,
                      (const void*)wgrad_kernel<float, false>,
                      (const void*)wgrad_kernel<float, true>};
  for (const void* k : fb) {
    const cudaError_t err =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
  }
  for (const void* k : wg) {
    const cudaError_t err =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  done[dev] = true;
  return 0;
}

// A launch of `kern` on `st` as clusters of `cluster` CTAs; on success
// `launched` (null, or 5 ints) gets {CTAs, cluster size, threads, shared
// memory bytes, last}.
template <typename... KArgs, typename... Args>
int launch_clusters(void (*kern)(KArgs...), const int (&cfg)[5], cudaStream_t st, int* launched,
                    Args... args) {
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
  cudaError_t err = cudaLaunchKernelEx(&lc, kern, args...);
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
int launch_fwd_bwd_kernel(const XT* x, const int* order, int step, long long row0, int B,
                          const float* params, const __nv_bfloat16* wb, const Net& net,
                          const XT* venc, int venc_in, const float* target, long long target_row0,
                          int mode, float inv_n, void* acts, void* deltas, float* bias_part,
                          float* loss_part, int* launched, cudaStream_t st) {
  int cfg[5];
  fwd_bwd_config(B, net, cfg);
  const int err = prepare_kernels();
  if (err != 0) return err;
  // cp.async of 16-byte feature pieces: bf16 rows on 16-byte boundaries
  const int x_async = sizeof(XT) == 2 && net.k_in % 8 == 0 && (uintptr_t)x % 16 == 0;
  return launch_clusters(fwd_bwd_kernel<XT, VD>, cfg, st, launched, x, order, step, row0, B,
                         params, wb, net, venc, venc_in, target, target_row0, mode, inv_n,
                         x_async, cfg[4],
                         fwd_bwd_tiles(net), (__nv_bfloat16*)acts, (__nv_bfloat16*)deltas,
                         bias_part, loss_part);
}

int launch_fwd_bwd(const void* x, int x_bf16, const int* order, int step, long long row0, int B,
                   int k_in, const float* params, const void* wb, int k_w, int num_layers,
                   int skip_idx, const void* venc, int venc_in, int venc_w, const float* target,
                   long long target_row0, int mode, float inv_n, void* acts, void* deltas,
                   float* bias_part, float* loss_part, int* launched, void* stream) {
  if (bad_net(B, k_in, k_w, num_layers, skip_idx, venc_in, venc_w) || mode < 0 ||
      mode > 3 || wb == nullptr || (uintptr_t)wb % 16 != 0 || (order != nullptr && step < 0))
    return (int)cudaErrorInvalidValue;
  const Net net = make_net(k_in, k_w, num_layers, skip_idx, venc_w);
  cudaStream_t st = (cudaStream_t)stream;
  const auto* w = (const __nv_bfloat16*)wb;
  if (x_bf16) {
    const auto* xb = (const __nv_bfloat16*)x;
    const auto* vb = (const __nv_bfloat16*)venc;
    return venc_w > 0
               ? launch_fwd_bwd_kernel<__nv_bfloat16, true>(
                     xb, order, step, row0, B, params, w, net, vb, venc_in, target, target_row0,
                     mode, inv_n, acts, deltas, bias_part, loss_part, launched, st)
               : launch_fwd_bwd_kernel<__nv_bfloat16, false>(
                     xb, order, step, row0, B, params, w, net, vb, venc_in, target, target_row0,
                     mode, inv_n, acts, deltas, bias_part, loss_part, launched, st);
  }
  const auto* xf = (const float*)x;
  const auto* vf = (const float*)venc;
  return venc_w > 0
             ? launch_fwd_bwd_kernel<float, true>(xf, order, step, row0, B, params, w, net, vf,
                                                  venc_in, target, target_row0, mode, inv_n,
                                                  acts, deltas, bias_part, loss_part, launched,
                                                  st)
             : launch_fwd_bwd_kernel<float, false>(xf, order, step, row0, B, params, w, net, vf,
                                                   venc_in, target, target_row0, mode, inv_n,
                                                   acts, deltas, bias_part, loss_part, launched,
                                                   st);
}

// Launch shape of wgrad: {CTAs, cluster size, threads, shared memory
// bytes, gradient tiles}.
void wgrad_config(int B, const Wgrad& g, int (&out)[5]) {
  const int nchunk = (B + BM - 1) / BM;
  const int split = nchunk < WG_MAX_SPLIT ? nchunk : WG_MAX_SPLIT;
  out[0] = g.tile0[g.n_mats] * split;
  out[1] = split;
  out[2] = WG_THREADS;
  out[3] = WG_SMEM;
  out[4] = g.tile0[g.n_mats];
}

template <typename XT>
int launch_wgrad_kernel(const XT* x, const int* order, int step, long long row0, int B, int k_in,
                        int t_async, const XT* venc, int venc_in, int venc_w, const void* acts,
                        const void* deltas, const float* bias_part, const float* loss_part,
                        float* grads, float* sums, const Wgrad& g, const AdamArgs* ad,
                        int* launched, cudaStream_t st) {
  int cfg[5];
  wgrad_config(B, g, cfg);
  const int err = prepare_kernels();
  if (err != 0) return err;
  const auto* A = (const __nv_bfloat16*)acts;
  const auto* D = (const __nv_bfloat16*)deltas;
  if (ad != nullptr)
    return launch_clusters(wgrad_kernel<XT, true>, cfg, st, launched, x, order, step, row0, B,
                           k_in, t_async, venc, venc_in, venc_w, A, D, bias_part, loss_part,
                           grads, sums, g, *ad);
  return launch_clusters(wgrad_kernel<XT, false>, cfg, st, launched, x, order, step, row0, B,
                         k_in, t_async, venc, venc_in, venc_w, A, D, bias_part, loss_part, grads,
                         sums, g, AdamArgs{});
}

int launch_wgrad(const void* x, int x_bf16, const int* order, int step, long long row0, int B,
                 int k_in, int k_w, int num_layers, int skip_idx, const void* venc, int venc_in,
                 int venc_w, const void* acts, const void* deltas, const float* bias_part,
                 const float* loss_part, float* grads, float* sums, const AdamArgs* ad,
                 int* launched, void* stream) {
  if (bad_net(B, k_in, k_w, num_layers, skip_idx, venc_in, venc_w) ||
      (order != nullptr && step < 0) || sums == nullptr)
    return (int)cudaErrorInvalidValue;
  if (ad != nullptr &&
      (ad->p == nullptr || ad->m == nullptr || ad->v == nullptr || ad->wb == nullptr ||
       ad->hyper == nullptr || step < 0 ||
       (((uintptr_t)ad->p | (uintptr_t)ad->m | (uintptr_t)ad->v) % 8 != 0) ||
       (uintptr_t)ad->wb % 4 != 0))
    return (int)cudaErrorInvalidValue;
  if (ad == nullptr && grads == nullptr) return (int)cudaErrorInvalidValue;
  const Net net = make_net(k_in, k_w, num_layers, skip_idx, venc_w);
  const Wgrad g = make_wgrad(net, B);
  cudaStream_t st = (cudaStream_t)stream;
  // cp.async of 16-byte table pieces: bf16 rows on 16-byte boundaries (bit 0:
  // the feature rows, bit 1: the view rows); else converting loads
  const int t_async = (x_bf16 && k_in % 8 == 0 && (uintptr_t)x % 16 == 0) |
                      (x_bf16 && venc != nullptr && venc_w % 8 == 0 && (uintptr_t)venc % 16 == 0)
                          << 1;
  if (x_bf16)
    return launch_wgrad_kernel<__nv_bfloat16>(
        (const __nv_bfloat16*)x, order, step, row0, B, k_in, t_async, (const __nv_bfloat16*)venc,
        venc_in, venc_w, acts, deltas, bias_part, loss_part, grads, sums, g, ad, launched, st);
  return launch_wgrad_kernel<float>((const float*)x, order, step, row0, B, k_in, t_async,
                                    (const float*)venc, venc_in, venc_w, acts, deltas, bias_part,
                                    loss_part, grads, sums, g, ad, launched, st);
}

}  // namespace

// Plain C entry points (loaded with ctypes). They launch on `stream` and
// return cudaGetLastError() (0 on success); they never synchronize.
//
// x: the feature table ([*, k_in] row-major, bf16 if x_bf16 else f32); the
// batch is rows [row0, row0 + B), or [order[step] * B, +B) when order
// (int32 block ids on the device, nullable) is given. params: flat f32
// (matrix region, then biases; fwd_bwd reads the biases); wb: its bf16 copy
// (round to nearest even, 16-byte aligned; fwd_bwd reads the matrices).
// target: f32 rows of 3 whose first row belongs to row target_row0 of x,
// read at the batch's rows (the batch's own [B, 3]: target_row0 = row0;
// the whole ground-truth table: 0).
// Scratch: acts [nh, B, HID] bf16; deltas [nh, B, HID] then [B, OUTW]
// bf16; bias_part [nblk, HID*nh+OUTW] f32; loss_part [nblk, 2] f32, nblk =
// ceil(B / 64); nh = num_layers - 1 (the _viewdep entry points:
// num_layers + 1). launched (null, or 5 ints): on success, the shape the
// launch ran with: {CTAs, cluster size, threads per CTA, shared memory
// bytes, feature tile resident (0/1)}.
extern "C" int fused_mlp_fwd_bwd(const void* x, int x_bf16, const int* order, int step,
                                 long long row0, int B, int k_in, const float* params,
                                 const void* wb, int k_w, int num_layers, int skip_idx,
                                 const float* target, long long target_row0, int mode,
                                 float inv_n, void* acts, void* deltas, float* bias_part,
                                 float* loss_part, int* launched, void* stream) {
  return launch_fwd_bwd(x, x_bf16, order, step, row0, B, k_in, params, wb, k_w, num_layers,
                        skip_idx, nullptr, 0, 0, target, target_row0, mode, inv_n, acts, deltas,
                        bias_part, loss_part, launched, stream);
}

// The view-dependent field: venc is the encoded view-direction table
// beside x ([*, venc_w] row-major, x's dtype, the same rows), of which
// lanes [0, venc_in) are read; venc_w = the view rows of Wc1 in params.
extern "C" int fused_mlp_fwd_bwd_viewdep(const void* x, int x_bf16, const int* order, int step,
                                         long long row0, int B, int k_in, const float* params,
                                         const void* wb, int k_w, int num_layers, int skip_idx,
                                         const void* venc, int venc_in, int venc_w,
                                         const float* target, long long target_row0, int mode,
                                         float inv_n, void* acts, void* deltas,
                                         float* bias_part, float* loss_part, int* launched,
                                         void* stream) {
  if (venc == nullptr || venc_w <= 0) return (int)cudaErrorInvalidValue;
  return launch_fwd_bwd(x, x_bf16, order, step, row0, B, k_in, params, wb, k_w, num_layers,
                        skip_idx, venc, venc_in, venc_w, target, target_row0, mode, inv_n, acts,
                        deltas, bias_part, loss_part, launched, stream);
}

// grads: flat f32 like params (every entry written); sums: [2] f32 (loss,
// squared error) summed over the batch. launched (null, or 5 ints): on
// success, the shape the launch ran with: {CTAs, cluster size, threads per
// CTA, shared memory bytes, gradient tiles}.
extern "C" int fused_mlp_wgrad(const void* x, int x_bf16, long long row0, int B, int k_in,
                               int k_w, int num_layers, int skip_idx, const void* acts,
                               const void* deltas, const float* bias_part,
                               const float* loss_part, float* grads, float* sums, int* launched,
                               void* stream) {
  return launch_wgrad(x, x_bf16, nullptr, 0, row0, B, k_in, k_w, num_layers, skip_idx, nullptr,
                      0, 0, acts, deltas, bias_part, loss_part, grads, sums, nullptr, launched,
                      stream);
}

extern "C" int fused_mlp_wgrad_viewdep(const void* x, int x_bf16, long long row0, int B,
                                       int k_in, int k_w, int num_layers, int skip_idx,
                                       const void* venc, int venc_in, int venc_w,
                                       const void* acts, const void* deltas,
                                       const float* bias_part, const float* loss_part,
                                       float* grads, float* sums, int* launched, void* stream) {
  if (venc == nullptr || venc_w <= 0) return (int)cudaErrorInvalidValue;
  return launch_wgrad(x, x_bf16, nullptr, 0, row0, B, k_in, k_w, num_layers, skip_idx, venc,
                      venc_in, venc_w, acts, deltas, bias_part, loss_part, grads, sums, nullptr,
                      launched, stream);
}

// wgrad with the Adam epilogue, the second launch of a train step: params,
// m and v (flat f32, 8-byte aligned) updated in place from this step's
// gradients, wb (their bf16 copy) written; no gradient is stored. The batch
// is rows [order[step] * B, +B) when order (int32 block ids on the device)
// is given, else [row0, row0 + B); hyper: [*, 128] f32 hyper rows, of which
// row `step` is read. sums: [2] f32 as fused_mlp_wgrad's; acc: [2] f32 epoch
// accumulators, acc[0] += loss_sum / 3, acc[1] += sq_sum (null: none).
extern "C" int fused_mlp_wgrad_adam(const void* x, int x_bf16, const int* order, int step,
                                    long long row0, int B, int k_in, int k_w, int num_layers,
                                    int skip_idx, const void* acts, const void* deltas,
                                    const float* bias_part, const float* loss_part, float* params,
                                    float* m, float* v, void* wb, const float* hyper, float* sums,
                                    float* acc, int* launched, void* stream) {
  const AdamArgs ad{params, m, v, (__nv_bfloat16*)wb, hyper, acc};
  return launch_wgrad(x, x_bf16, order, step, row0, B, k_in, k_w, num_layers, skip_idx, nullptr,
                      0, 0, acts, deltas, bias_part, loss_part, nullptr, sums, &ad, launched,
                      stream);
}

extern "C" int fused_mlp_wgrad_adam_viewdep(const void* x, int x_bf16, const int* order,
                                            int step, long long row0, int B, int k_in, int k_w,
                                            int num_layers, int skip_idx, const void* venc,
                                            int venc_in, int venc_w, const void* acts,
                                            const void* deltas, const float* bias_part,
                                            const float* loss_part, float* params, float* m,
                                            float* v, void* wb, const float* hyper, float* sums,
                                            float* acc, int* launched, void* stream) {
  if (venc == nullptr || venc_w <= 0) return (int)cudaErrorInvalidValue;
  const AdamArgs ad{params, m, v, (__nv_bfloat16*)wb, hyper, acc};
  return launch_wgrad(x, x_bf16, order, step, row0, B, k_in, k_w, num_layers, skip_idx, venc,
                      venc_in, venc_w, acts, deltas, bias_part, loss_part, nullptr, sums, &ad,
                      launched, stream);
}

// Raise the kernels' shared memory ceilings and load them: call before a
// capture of launches into a CUDA graph (the first launch does it too).
extern "C" int fused_mlp_train_prepare() { return prepare_kernels(); }

// Constants the Python wrapper checks its layout against.
extern "C" int fused_mlp_train_kc() { return KC; }
extern "C" int fused_mlp_train_out_pad() { return OUTW; }
extern "C" int fused_mlp_train_block_rows() { return BM; }
extern "C" int fused_mlp_train_venc_max() { return VENC_MAX; }
