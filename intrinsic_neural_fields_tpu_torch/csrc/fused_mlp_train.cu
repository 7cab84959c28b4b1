// Training kernels of the texture field's skip-MLP, hand-written for Hopper
// (sm_90a), bf16 tensor cores through nvcuda::wmma 16x16x16 fragments.
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
//   fused_mlp_fwd_bwd  one block per 64 batch rows: the forward (as
//     csrc/fused_mlp_fwd.cu), the loss and its gradient (or the cotangent
//     seed) times the sigmoid's derivative, then the deltas back through
//     W^T down to layer 0. It writes what the TPU kernel feeds its matrix
//     unit: the bf16 post-relu activations and the bf16 deltas of every
//     layer, plus per-block f32 partial sums of the loss, the squared error
//     and every bias gradient (column sums of the f32 deltas).
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
// accumulation; weights are f32 master copies rounded to bf16 as they are
// loaded into shared memory; feature lanes past k_in and batch rows past B
// read as zero, so pad rows of the gradient are exactly zero.
//
// Bound on this card: per training row about 2*(k*128*2 + 4*128*128 +
// 128*16) MACs forward and again for the weight gradients, plus the delta
// walk (k=512: ~3.8 GFLOP at B=4096 against ~6 MB moved; the view-dependent
// field adds ~17.9k MACs per row to each pass), above the H100's
// bf16 ridge of ~295 FLOP/byte, so the ideal step is bound by the tensor
// cores. This first version is simple (synchronous shared-memory loads,
// 64-row blocks, no wgmma/TMA), so it is far from that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;         // batch rows per block (fwd_bwd), batch chunk (wgrad)
constexpr int HID = 128;       // hidden width
constexpr int KC = 64;         // input / weight rows per streamed chunk
constexpr int OUTW = 16;       // head padded to one fragment width
constexpr int NOUT = 3;        // real output columns
constexpr int NTHREADS = 256;  // 8 warps: 4 row tiles x 2 column halves
constexpr int LDH = HID + 8;   // bf16 row strides padded by 16 bytes
constexpr int LDX = KC + 8;
constexpr int LDW = HID + 8;
constexpr int LDS = HID + 4;   // f32 staging stride
constexpr int MAXL = 16;       // most Linear layers a network may have
constexpr int MAXM = MAXL + 1; // most weight matrices (the skip layer has two)
constexpr int NSPLIT = 8;      // wgrad: blocks sharing one tile's batch
constexpr int VENC_MAX = KC;   // most view-encoding lanes (one x tile)
constexpr float CAUCHY_C2 = (float)((20.0 / 255.0) * (20.0 / 255.0));  // as the f32 ops see it

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
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

struct Smem {
  __nv_bfloat16 h[BM * LDH];   // current activations, bf16
  __nv_bfloat16 d[BM * LDH];   // current delta, bf16
  __nv_bfloat16 x[BM * LDX];   // one K-chunk of the input, bf16
  __nv_bfloat16 w[HID * LDW];  // a weight chunk, or a whole [HID, N] matrix
  float st[BM * LDS];          // f32 staging of fragment results
  float red[2 * NTHREADS / 32];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// nrows rows of a row-major f32 [*, ncols] matrix into ws, rounded to bf16.
__device__ __forceinline__ void load_w_f32(__nv_bfloat16* ws, const float* __restrict__ src,
                                           int nrows, int ncols, int tid) {
  const int vpr = ncols / 4;
  const int total = nrows * vpr;
  for (int i = tid; i < total; i += NTHREADS) {
    const int r = i / vpr;
    const int c = (i - r * vpr) * 4;
    const float4 v = *reinterpret_cast<const float4*>(src + (size_t)r * ncols + c);
    __nv_bfloat16* dst = ws + r * LDW + c;
    dst[0] = __float2bfloat16_rn(v.x);
    dst[1] = __float2bfloat16_rn(v.y);
    dst[2] = __float2bfloat16_rn(v.z);
    dst[3] = __float2bfloat16_rn(v.w);
  }
}

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

// acc[j] += A[16 x KC] . W[KC x 16] for NF column fragments starting at col0.
template <int NF>
__device__ __forceinline__ void mma_chunk(const __nv_bfloat16* a_base, int lda,
                                          const __nv_bfloat16* ws, int col0, FragC (&acc)[NF]) {
#pragma unroll
  for (int kk = 0; kk < KC; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, a_base + kk, lda);
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      FragB b;
      wmma::load_matrix_sync(b, ws + kk * LDW + col0 + j * 16, LDW);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
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
__global__ void __launch_bounds__(NTHREADS)
fwd_bwd_kernel(const XT* __restrict__ x, long long row0, int B, const float* __restrict__ params,
               Net net, const XT* __restrict__ venc, int venc_in,
               const float* __restrict__ target, int mode, float inv_n,
               __nv_bfloat16* __restrict__ acts, __nv_bfloat16* __restrict__ deltas,
               float* __restrict__ bias_part, float* __restrict__ loss_part) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int rt = warp & 3;   // 16-row tile of the block
  const int cg = warp >> 2;  // 64-column half of a 128-wide result
  const int brow = blockIdx.x * BM;
  const int nrows = min(BM, B - brow);
  const int nh = net.nh;
  const int nbp = HID * nh + OUTW;  // bias partials per block
  const XT* xrows = x + (size_t)(row0 + brow) * net.k_in;
  const XT* vrows = VD ? venc + (size_t)(row0 + brow) * net.venc_w : nullptr;
  const float* wm = params;
  const float* bias = params + net.n_w;

  // ---------------- forward
  for (int layer = 0; layer < nh; ++layer) {
    FragC acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
    if (layer > 0) {  // h . Wh  ([HID, HID])
      for (int k0 = 0; k0 < HID; k0 += KC) {
        load_w_f32(s.w, wm + net.w_h[layer] + (size_t)k0 * HID, KC, HID, tid);
        __syncthreads();
        mma_chunk<4>(s.h + rt * 16 * LDH + k0, LDH, s.w, cg * 64, acc);
        __syncthreads();
      }
    }
    if (layer == 0 || layer == net.skip) {  // x . Wx  ([k_w, HID]), same accumulator
      const float* wx = wm + (layer == 0 ? net.w_in : net.w_x);
      for (int k0 = 0; k0 < net.k_w; k0 += KC) {
        load_x_chunk(s.x, xrows, nrows, net.k_in, net.k_in, k0, tid);
        load_w_f32(s.w, wx + (size_t)k0 * HID, KC, HID, tid);
        __syncthreads();
        mma_chunk<4>(s.x + rt * 16 * LDX, LDX, s.w, cg * 64, acc);
        __syncthreads();
      }
    }
    if (VD && layer == net.cat) {  // venc . Wv  ([venc_w, HID]), same accumulator
      // one whole KC-row chunk: view lanes past venc_in read as zero and
      // the weight rows past venc_w are zeroed, so mma_chunk keeps its
      // constant trip count (on an H100 this kernel took 0.175 ms at k=512,
      // B=4096, against 0.216 ms with a venc_w/16-step loop here)
      load_x_chunk(s.x, vrows, nrows, net.venc_w, venc_in, 0, tid);
      load_w_f32(s.w, wm + net.w_v, net.venc_w, HID, tid);
      for (int i = tid; i < (KC - net.venc_w) * HID; i += NTHREADS)
        s.w[(net.venc_w + i / HID) * LDW + i % HID] = __float2bfloat16_rn(0.0f);
      __syncthreads();
      mma_chunk<4>(s.x + rt * 16 * LDX, LDX, s.w, cg * 64, acc);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(s.st + rt * 16 * LDS + cg * 64 + j * 16, acc[j], LDS,
                              wmma::mem_row_major);
    __syncthreads();
    // f32 bias add(s) in the reference order, relu, bf16 activation
    const float* bh = bias + net.b[layer];
    const float* bx = (layer == net.skip) ? bias + net.b_x : nullptr;
    __nv_bfloat16* act = acts + (size_t)layer * B * HID + (size_t)brow * HID;
    for (int i = tid; i < BM * HID; i += NTHREADS) {
      const int r = i / HID;
      const int c = i - r * HID;
      float v = s.st[r * LDS + c] + bh[c];
      if (bx != nullptr) v = v + bx[c];
      const __nv_bfloat16 hb = __float2bfloat16_rn(fmaxf(v, 0.0f));
      s.h[r * LDH + c] = hb;
      if (r < nrows) act[(size_t)r * HID + c] = hb;
    }
    __syncthreads();
  }

  // ---------------- head, loss, seed
  {
    FragC acc_o[1];
    wmma::fill_fragment(acc_o[0], 0.0f);
    for (int k0 = 0; k0 < HID; k0 += KC) {
      load_w_f32(s.w, wm + net.w_h[nh] + (size_t)k0 * OUTW, KC, OUTW, tid);
      __syncthreads();
      if (cg == 0) mma_chunk<1>(s.h + rt * 16 * LDH + k0, LDH, s.w, 0, acc_o);
      __syncthreads();
    }
    if (cg == 0)
      wmma::store_matrix_sync(s.st + rt * 16 * LDS, acc_o[0], LDS, wmma::mem_row_major);
    __syncthreads();
  }
  float lsum = 0.0f, ssum = 0.0f;
  const float* bo = bias + net.b[nh];
  for (int i = tid; i < BM * OUTW; i += NTHREADS) {
    const int r = i / OUTW;
    const int c = i - r * OUTW;
    float dval = 0.0f;
    if (c < NOUT && r < nrows) {
      const float z = s.st[r * LDS + c] + bo[c];
      const float p = 1.0f / (1.0f + expf(-z));
      const float t = target[(size_t)(brow + r) * NOUT + c];
      float g;
      if (mode == 3) {
        g = t;
      } else {
        const float diff = p - t;
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
    s.st[r * LDS + c] = dval;
  }
  // per-block loss and squared-error sums, in a fixed order
  lsum = warp_sum(lsum);
  ssum = warp_sum(ssum);
  if ((tid & 31) == 0) {
    s.red[warp] = lsum;
    s.red[NTHREADS / 32 + warp] = ssum;
  }
  __syncthreads();
  if (tid == 0) {
    float a = 0.0f, q = 0.0f;
    for (int wi = 0; wi < NTHREADS / 32; ++wi) {
      a += s.red[wi];
      q += s.red[NTHREADS / 32 + wi];
    }
    loss_part[2 * blockIdx.x] = a;
    loss_part[2 * blockIdx.x + 1] = q;
  }
  // head delta: bias partial (f32 column sums), bf16 copy for the matmuls
  float* bpart = bias_part + (size_t)blockIdx.x * nbp;
  if (tid < OUTW) {
    float sum = 0.0f;
    for (int r = 0; r < BM; ++r) sum += s.st[r * LDS + tid];
    bpart[HID * nh + tid] = sum;
  }
  __nv_bfloat16* dout = deltas + (size_t)nh * B * HID + (size_t)brow * OUTW;
  for (int i = tid; i < BM * OUTW; i += NTHREADS) {
    const int r = i / OUTW;
    const int c = i - r * OUTW;
    const __nv_bfloat16 db = __float2bfloat16_rn(s.st[r * LDS + c]);
    s.d[r * LDH + c] = db;
    if (r < nrows) dout[(size_t)r * OUTW + c] = db;
  }
  __syncthreads();

  // ---------------- backward: D_l = (D_{l+1} . W_{l+1,h}^T) * (h_l > 0)
  int N = OUTW;  // width of D_{l+1}
  for (int l = nh - 1; l >= 0; --l) {
    load_w_f32(s.w, wm + net.w_h[l + 1], HID, N, tid);  // [HID rows (in), N cols (out)]
    __syncthreads();
    FragC acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int kk = 0; kk < N; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, s.d + rt * 16 * LDH + kk, LDH);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragBc b;  // b(k, n) = W(n, k): W^T read column-major from W's rows
        wmma::load_matrix_sync(b, s.w + (cg * 64 + j * 16) * LDW + kk, LDW);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(s.st + rt * 16 * LDS + cg * 64 + j * 16, acc[j], LDS,
                              wmma::mem_row_major);
    __syncthreads();
    const __nv_bfloat16* act = acts + (size_t)l * B * HID + (size_t)brow * HID;
    __nv_bfloat16* dl = deltas + (size_t)l * B * HID + (size_t)brow * HID;
    for (int i = tid; i < BM * HID; i += NTHREADS) {
      const int r = i / HID;
      const int c = i - r * HID;
      float v = 0.0f;
      if (r < nrows && __bfloat162float(act[(size_t)r * HID + c]) > 0.0f) v = s.st[r * LDS + c];
      s.st[r * LDS + c] = v;
      const __nv_bfloat16 db = __float2bfloat16_rn(v);
      s.d[r * LDH + c] = db;
      if (r < nrows) dl[(size_t)r * HID + c] = db;
    }
    __syncthreads();
    if (tid < HID) {
      float sum = 0.0f;
      for (int r = 0; r < BM; ++r) sum += s.st[r * LDS + tid];
      bpart[HID * l + tid] = sum;
    }
    __syncthreads();
    N = HID;
  }
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

template <typename XT, typename K>
int launch_fwd_bwd_kernel(K kern, const XT* x, long long row0, int B, const float* params,
                          const Net& net, const XT* venc, int venc_in,
                          const float* target, int mode, float inv_n, void* acts, void* deltas,
                          float* bias_part, float* loss_part, cudaStream_t st) {
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((B + BM - 1) / BM), NTHREADS, smem, st>>>(
      x, row0, B, params, net, venc, venc_in, target, mode, inv_n, (__nv_bfloat16*)acts,
      (__nv_bfloat16*)deltas, bias_part, loss_part);
  return (int)cudaGetLastError();
}

int launch_fwd_bwd(const void* x, int x_bf16, long long row0, int B, int k_in,
                   const float* params, int k_w, int num_layers, int skip_idx, const void* venc,
                   int venc_in, int venc_w, const float* target, int mode, float inv_n,
                   void* acts, void* deltas, float* bias_part, float* loss_part, void* stream) {
  if (bad_net(B, k_in, k_w, num_layers, skip_idx, venc_in, venc_w) || mode < 0 ||
      mode > 3)
    return (int)cudaErrorInvalidValue;
  const Net net = make_net(k_in, k_w, num_layers, skip_idx, venc_w);
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16) {
    auto kern = venc_w > 0 ? fwd_bwd_kernel<__nv_bfloat16, true>
                           : fwd_bwd_kernel<__nv_bfloat16, false>;
    return launch_fwd_bwd_kernel(kern, (const __nv_bfloat16*)x, row0, B, params, net,
                                 (const __nv_bfloat16*)venc, venc_in, target, mode, inv_n,
                                 acts, deltas, bias_part, loss_part, st);
  }
  auto kern = venc_w > 0 ? fwd_bwd_kernel<float, true> : fwd_bwd_kernel<float, false>;
  return launch_fwd_bwd_kernel(kern, (const float*)x, row0, B, params, net, (const float*)venc,
                               venc_in, target, mode, inv_n, acts, deltas, bias_part,
                               loss_part, st);
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
// biases). target: [B, 3] f32. Scratch: acts [nh, B, HID] bf16; deltas
// [nh, B, HID] then [B, OUTW] bf16; bias_part [nblk, HID*nh+OUTW] f32;
// loss_part [nblk, 2] f32, nblk = ceil(B / 64); nh = num_layers - 1
// (the _viewdep entry points: num_layers + 1).
extern "C" int fused_mlp_fwd_bwd(const void* x, int x_bf16, long long row0, int B, int k_in,
                                 const float* params, int k_w, int num_layers, int skip_idx,
                                 const float* target, int mode, float inv_n, void* acts,
                                 void* deltas, float* bias_part, float* loss_part, void* stream) {
  return launch_fwd_bwd(x, x_bf16, row0, B, k_in, params, k_w, num_layers, skip_idx, nullptr, 0,
                        0, target, mode, inv_n, acts, deltas, bias_part, loss_part, stream);
}

// The view-dependent field: venc is the encoded view-direction table
// beside x ([*, venc_w] row-major, x's dtype, the same rows), of which
// lanes [0, venc_in) are read; venc_w = the view rows of Wc1 in params.
extern "C" int fused_mlp_fwd_bwd_viewdep(const void* x, int x_bf16, long long row0, int B,
                                         int k_in, const float* params, int k_w, int num_layers,
                                         int skip_idx, const void* venc, int venc_in,
                                         int venc_w, const float* target, int mode, float inv_n,
                                         void* acts, void* deltas, float* bias_part,
                                         float* loss_part, void* stream) {
  if (venc == nullptr || venc_w <= 0) return (int)cudaErrorInvalidValue;
  return launch_fwd_bwd(x, x_bf16, row0, B, k_in, params, k_w, num_layers, skip_idx, venc,
                        venc_in, venc_w, target, mode, inv_n, acts, deltas, bias_part,
                        loss_part, stream);
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
