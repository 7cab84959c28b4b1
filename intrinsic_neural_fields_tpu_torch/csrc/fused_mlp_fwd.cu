// Fused skip-MLP forward for the texture field, hand-written for Hopper
// (sm_90a), bf16 tensor cores through nvcuda::wmma 16x16x16 fragments.
//
// Replaces the TPU kernels of intrinsic_neural_fields_tpu/ops/fused_mlp.py:
// make_fused_apply's forward pallas_call (body _make_fwd_kernel over
// _forward_layers) and, through the fused_mlp_fwd_viewdep entry point,
// make_fused_apply_viewdep's (the view-dependent field: the spatial
// network's head is a relu bottleneck, then relu([bneck | venc] . Wc1 + b1)
// and a sigmoid RGB head). It computes exactly what those kernels compute:
//   - every matmul operand (x, each layer's post-relu h, the weights) is
//     rounded to bf16 with round-to-nearest-even;
//   - products accumulate in f32;
//   - biases are added in f32 after the contraction, in the reference's
//     order (acc + bh + bx at the skip layer, whose contraction is
//     [h | x] . [Wh ; Wx]);
//   - relu on hidden layers, sigmoid on the 3 real output columns.
//
// Bound on this card: per ray about 0.39 MFLOP at k=512 (0.66 MFLOP at
// k=1024) against 4*k bytes of f32 input read once, i.e. ~190 FLOP/byte —
// below the H100's ~295 FLOP/byte bf16 ridge, so the ideal kernel is bound
// by reading x from device memory (bytes), with the tensor cores close
// behind. The design therefore reads x exactly as given (unpadded f32,
// converted to bf16 in the load, no padded copy in device memory) and keeps
// every activation on chip: h lives in shared memory as bf16 between
// layers, and only 3 f32 columns per ray are written back.
//
// The view-dependent field is the same chain with two more 128-wide relu
// layers: the bottleneck (the spatial head, relu instead of sigmoid) and
// the concat layer, whose second operand is the block's encoded view
// directions read straight from their f32 rows (lanes past venc_in read as
// zero), as the skip layer reads the features. Its bound is the same as the
// plain forward's (+17.9k MACs and 4*venc_in bytes per ray: bytes).
//
// Unlike the TPU kernel, which keeps all weights resident in VMEM, the
// weights do not fit in shared memory (at k=512 the input and skip-x
// matrices are 128 KB each in bf16, 256 KB each at k=1024 against 227 KB
// per block), so they are streamed through shared memory in KC-row chunks;
// every block re-reads them, mostly from the 50 MB L2. Ragged K and B edges
// are masked in the x load (zero padding contributes nothing, as in the
// reference). This first version is simple: one 64-row block per 256
// threads, synchronous chunk loads, no double buffering.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;         // rows (rays) per block
constexpr int HID = 128;       // hidden width
constexpr int KC = 64;         // weight rows per streamed chunk
constexpr int OUTW = 16;       // head padded to one fragment width
constexpr int NOUT = 3;        // real output columns
constexpr int NTHREADS = 256;  // 8 warps: 4 row tiles x 2 column halves
constexpr int LDH = HID + 8;   // row strides padded by 16 bytes against
constexpr int LDX = KC + 8;    // shared-memory bank conflicts; multiples of
constexpr int LDW = HID + 8;   // 8 elements as wmma requires
constexpr int LDS = HID + 4;   // f32 staging stride (multiple of 4)
constexpr int VENC_MAX = KC;   // most view-encoding lanes (one x tile)

struct Smem {
  __nv_bfloat16 h[BM * LDH];  // current activations, bf16
  __nv_bfloat16 x[BM * LDX];  // one K-chunk of the input, bf16
  __nv_bfloat16 w[KC * LDW];  // one K-chunk of a weight matrix
  float st[BM * LDS];         // f32 accumulator staging for the epilogue
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// nrows (<= KC) rows of a row-major [*, ncols] bf16 matrix into s.w
// (16-byte vectors).
__device__ __forceinline__ void load_w_chunk(__nv_bfloat16* ws, const __nv_bfloat16* src,
                                             int ncols, int tid, int nrows = KC) {
  const int vec_per_row = ncols / 8;
  const int total = nrows * vec_per_row;
  for (int i = tid; i < total; i += NTHREADS) {
    const int r = i / vec_per_row;
    const int c = (i - r * vec_per_row) * 8;
    *reinterpret_cast<uint4*>(ws + r * LDW + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * ncols + c);
  }
}

// Columns [k0, k0+KC) of the block's 64 input rows, f32 -> bf16 (RNE);
// rows >= B and columns >= k_in read as zero.
__device__ __forceinline__ void load_x_chunk(__nv_bfloat16* xs, const float* __restrict__ x,
                                             int row0, int B, int k_in, int k0, int tid) {
  for (int i = tid; i < BM * KC; i += NTHREADS) {
    const int r = i / KC;
    const int c = i - r * KC;
    const int gr = row0 + r;
    const int gc = k0 + c;
    const float v = (gr < B && gc < k_in) ? __ldg(x + (size_t)gr * k_in + gc) : 0.0f;
    xs[r * LDX + c] = __float2bfloat16_rn(v);
  }
}

// Lanes [0, venc_w) of the block's 64 view-encoding rows ([B, venc_in]
// f32), -> bf16; rows >= B and lanes >= venc_in read as zero.
__device__ __forceinline__ void load_v_rows(__nv_bfloat16* xs, const float* __restrict__ v,
                                            int row0, int B, int venc_in, int venc_w, int tid) {
  for (int i = tid; i < BM * venc_w; i += NTHREADS) {
    const int r = i / venc_w;
    const int c = i - r * venc_w;
    const int gr = row0 + r;
    const float val = (gr < B && c < venc_in) ? __ldg(v + (size_t)gr * venc_in + c) : 0.0f;
    xs[r * LDX + c] = __float2bfloat16_rn(val);
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

// Weight pack (bf16, row-major [in, out], in layer order; the skip layer
// holds Wh then Wx): input [k_w,128], hidden [128,128], skip Wh [128,128] +
// Wx [k_w,128], output [128,16]. Bias pack (f32) in the same order:
// 128 per matrix, 16 for the head. k_w = k_in rounded up to KC, zero rows.
// With venc (the view-dependent field) the output slot holds the
// bottleneck [128,128], then come Wc1 [128 + venc_w, 128] (bottleneck rows,
// then the view rows) and the RGB head [128,16]; biases 128, 128, 16.
// VD: the view-dependent chain (a separate instantiation, so the plain
// field's kernel is compiled without the concat layer's code).
template <bool VD>
__global__ void __launch_bounds__(NTHREADS)
fused_mlp_fwd_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ wpack,
                     const float* __restrict__ bpack, float* __restrict__ out, int B,
                     int k_in, int k_w, int num_layers, int skip_idx,
                     const float* __restrict__ venc, int venc_in, int venc_w) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int rt = warp & 3;   // 16-row tile of the block
  const int cg = warp >> 2;  // 64-column half of the layer output
  const int row0 = blockIdx.x * BM;
  const __nv_bfloat16* w = wpack;
  const float* b = bpack;
  // relu layers: the spatial ones, then the bottleneck and the concat layer
  const int n_relu = VD ? num_layers + 1 : num_layers - 1;
  const int cat = VD ? num_layers : -1;

  for (int layer = 0; layer < n_relu; ++layer) {
    FragC acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
    const float* bias_h = b;
    const float* bias_x = nullptr;
    b += HID;

    if (layer > 0) {  // h . W  (W [128,128])
      for (int k0 = 0; k0 < HID; k0 += KC) {
        load_w_chunk(s.w, w + (size_t)k0 * HID, HID, tid);
        __syncthreads();
        mma_chunk<4>(s.h + rt * 16 * LDH + k0, LDH, s.w, cg * 64, acc);
        __syncthreads();
      }
      w += HID * HID;
    }
    if (layer == 0 || layer == skip_idx) {  // x . W  (W [k_w,128])
      if (layer == skip_idx) {
        bias_x = b;
        b += HID;
      }
      for (int k0 = 0; k0 < k_w; k0 += KC) {
        load_x_chunk(s.x, x, row0, B, k_in, k0, tid);
        load_w_chunk(s.w, w + (size_t)k0 * HID, HID, tid);
        __syncthreads();
        mma_chunk<4>(s.x + rt * 16 * LDX, LDX, s.w, cg * 64, acc);
        __syncthreads();
      }
      w += (size_t)k_w * HID;
    }
    if (VD && layer == cat) {  // venc . Wv  (the view rows of Wc1, [venc_w,128])
      // venc_w/16 wmma k-steps over venc_w loaded rows. The train kernel's
      // form (one whole KC chunk, weight rows past venc_w zeroed) is faster
      // there but not here: on an H100 it took this kernel from 0.077 to
      // 0.087 ms at k=512, B=8192.
      load_v_rows(s.x, venc, row0, B, venc_in, venc_w, tid);
      load_w_chunk(s.w, w, HID, tid, venc_w);
      __syncthreads();
      for (int kk = 0; kk < venc_w; kk += 16) {
        FragA a;
        wmma::load_matrix_sync(a, s.x + rt * 16 * LDX + kk, LDX);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          FragB bf;
          wmma::load_matrix_sync(bf, s.w + kk * LDW + cg * 64 + j * 16, LDW);
          wmma::mma_sync(acc[j], a, bf, acc[j]);
        }
      }
      __syncthreads();
      w += (size_t)venc_w * HID;
    }

    // Epilogue: f32 bias add(s) in the reference order, relu, bf16 h.
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(s.st + rt * 16 * LDS + cg * 64 + j * 16, acc[j], LDS,
                              wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < BM * HID; i += NTHREADS) {
      const int r = i / HID;
      const int c = i - r * HID;
      float v = s.st[r * LDS + c] + bias_h[c];
      if (bias_x != nullptr) v = v + bias_x[c];
      s.h[r * LDH + c] = __float2bfloat16_rn(fmaxf(v, 0.0f));
    }
    __syncthreads();
  }

  // Output head: h . Wo ([128,16], 3 real columns), warps of column half 0.
  FragC acc_o[1];
  wmma::fill_fragment(acc_o[0], 0.0f);
  for (int k0 = 0; k0 < HID; k0 += KC) {
    load_w_chunk(s.w, w + (size_t)k0 * OUTW, OUTW, tid);
    __syncthreads();
    if (cg == 0) mma_chunk<1>(s.h + rt * 16 * LDH + k0, LDH, s.w, 0, acc_o);
    __syncthreads();
  }
  if (cg == 0)
    wmma::store_matrix_sync(s.st + rt * 16 * LDS, acc_o[0], LDS, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * NOUT; i += NTHREADS) {
    const int r = i / NOUT;
    const int c = i - r * NOUT;
    const int gr = row0 + r;
    if (gr < B) {
      const float z = s.st[r * LDS + c] + b[c];
      out[(size_t)gr * NOUT + c] = 1.0f / (1.0f + expf(-z));
    }
  }
}

int launch(const float* x, const void* wpack, const float* bpack, float* out, int B, int k_in,
           int k_w, int num_layers, int skip_idx, const float* venc, int venc_in, int venc_w,
           void* stream) {
  if (B <= 0) return 0;
  if (k_in <= 0 || k_w < k_in || k_w % KC != 0 || num_layers < 3 || skip_idx <= 0 ||
      skip_idx >= num_layers - 1)
    return (int)cudaErrorInvalidValue;
  if (venc != nullptr && (venc_in <= 0 || venc_w < venc_in || venc_w % 16 != 0 ||
                          venc_w > VENC_MAX))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  auto kern = venc != nullptr ? fused_mlp_fwd_kernel<true> : fused_mlp_fwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + BM - 1) / BM);
  kern<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      x, (const __nv_bfloat16*)wpack, bpack, out, B, k_in, k_w, num_layers, skip_idx, venc,
      venc_in, venc_w);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). They launch on `stream` and
// return cudaGetLastError() (0 on success); they never synchronize.
extern "C" int fused_mlp_fwd(const float* x, const void* wpack, const float* bpack, float* out,
                             int B, int k_in, int k_w, int num_layers, int skip_idx,
                             void* stream) {
  return launch(x, wpack, bpack, out, B, k_in, k_w, num_layers, skip_idx, nullptr, 0, 0,
                stream);
}

// The view-dependent field: venc [B, venc_in] f32 rows; venc_w = the view
// rows of Wc1 in the pack (venc_in rounded up to 16, zero rows).
extern "C" int fused_mlp_fwd_viewdep(const float* x, const float* venc, const void* wpack,
                                     const float* bpack, float* out, int B, int k_in, int k_w,
                                     int num_layers, int skip_idx, int venc_in, int venc_w,
                                     void* stream) {
  if (venc == nullptr) return (int)cudaErrorInvalidValue;
  return launch(x, wpack, bpack, out, B, k_in, k_w, num_layers, skip_idx, venc, venc_in, venc_w,
                stream);
}

// Constants the Python wrapper checks its packing against.
extern "C" int fused_mlp_fwd_kc() { return KC; }
extern "C" int fused_mlp_fwd_out_pad() { return OUTW; }
extern "C" int fused_mlp_fwd_venc_max() { return VENC_MAX; }
