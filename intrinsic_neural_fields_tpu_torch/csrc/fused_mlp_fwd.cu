// Fused skip-MLP forward for the texture field, hand-written for Hopper
// (sm_90a): wgmma, 2-CTA thread-block clusters, cp.async weight tiles.
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
// behind. The view-dependent field adds the bottleneck and the concat layer
// (+17.9k MACs and 4*venc_in bytes per ray: still bytes).
//
// Design: the forward half of the train kernel's fwd_bwd (fused_mlp_train.cu,
// device code shared through mlp_tiles.cuh). One cluster of two CTAs per
// ROWS batch rows; CTA c computes columns [64c, 64c+64) of every 128-wide
// layer with wgmma m64n64k16, one consumer warpgroup per 64 rows (ROWS =
// 128, two warpgroups sharing every weight tile, unless only a 64-row
// CTA's resident feature tile fits in shared memory). A layer's bf16 output
// feeds the next layer as register A fragments (own half) and through the
// partner's shared memory (its half, behind a split cluster barrier).
// Weight tiles of the bf16 pack (ParamLayout.pack: the train kernels'
// layout) stream through a 3-stage cp.async ring, two tiles ahead, driven
// by the tile program (tile_at). x is f32 and the dominant byte stream:
// each chunk is loaded two tiles ahead into registers while earlier
// chunks' products run, then rounded to bf16 into the CTA's feature tile.
// When the whole ROWS x k_w tile fits in shared memory it stays resident
// and the skip layer reads it from there, so x is read once; when not even
// a 64-row CTA's does (k_w >= ~1500), the tile is a ring of two chunks and
// the skip layer streams x again the same way. The head (16 columns) runs
// in both CTAs on the same registers; CTA 0 writes the 3 sigmoid outputs.
// Ragged K and B edges read as zero (zero padding contributes nothing, as
// in the reference).

#include "mlp_tiles.cuh"

namespace {

constexpr int VENC_MAX = KC;  // most view-encoding lanes (one x tile)

// One CTA: WG consumer warpgroups, ROWS = 64 * WG batch rows; XRES: the
// feature tile is resident (every chunk), else a ring of two chunks.
template <int WG, bool XRES>
struct FwdCta {
  static constexpr int NT = 128 * WG;
  static constexpr int ROWS = BM * WG;
  static constexpr int LBO = ROWS * 16;        // K-major A tiles: k-group stride
  static constexpr int CHUNK = ROWS * KC * 2;  // one 64-lane chunk of the feature tile

  const float* xrows;  // the CTA's first feature row ([*, k_in] f32)
  const float* vrows;  // its view encodings ([*, venc_in] f32; VD)
  int k_in, venc_in, venc_w, nrows, nch, tid, n0, n_tiles;
  bool x_vec;          // float4 feature loads
  const __nv_bfloat16* wpack;
  const Tile* prog;
  unsigned char* wring;  // STAGES weight tiles
  unsigned char* xs;     // the bf16 feature tile
  unsigned char* vs;     // the ROWS x venc_w bf16 view tile (VD)

  // This thread's 32 values of feature chunk ch (rows past nrows, lanes
  // past k_in: zero), loaded into registers.
  __device__ __forceinline__ void load_x(float (&v)[32], int ch) const {
    if (x_vec) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int j = tid + NT * i, m = j >> 4, k = KC * ch + 4 * (j & 15);
        const float4 q = m < nrows && k < k_in
                             ? __ldg(reinterpret_cast<const float4*>(xrows + (size_t)m * k_in + k))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        v[4 * i] = q.x; v[4 * i + 1] = q.y; v[4 * i + 2] = q.z; v[4 * i + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int j = tid + NT * i, m = j >> 6, k = KC * ch + (j & 63);
        v[i] = m < nrows && k < k_in ? __ldg(xrows + (size_t)m * k_in + k) : 0.0f;
      }
    }
  }

  // Chunk ch of the feature tile (its slot in the ring when not resident).
  __device__ __forceinline__ unsigned char* x_chunk(int ch) const {
    return xs + (XRES ? ch : ch & 1) * CHUNK;
  }

  // Those values, rounded to bf16, into the feature tile (K-major core
  // matrices: (m, k) at (k/8)*LBO + (m/8)*128 + (m%8)*16 + (k%8)*2).
  __device__ __forceinline__ void store_x(const float (&v)[32], int ch) const {
    unsigned char* dst = x_chunk(ch);
    if (x_vec) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int j = tid + NT * i, m = j >> 4, k = 4 * (j & 15);
        *reinterpret_cast<uint2*>(dst + (k >> 3) * LBO + (m >> 3) * 128 + (m & 7) * 16 +
                                  (k & 7) * 2) =
            make_uint2(pack_bf16(v[4 * i], v[4 * i + 1]), pack_bf16(v[4 * i + 2], v[4 * i + 3]));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int j = tid + NT * i, m = j >> 6, k = j & 63;
        *reinterpret_cast<__nv_bfloat16*>(dst + (k >> 3) * LBO + (m >> 3) * 128 + (m & 7) * 16 +
                                          (k & 7) * 2) = __float2bfloat16_rn(v[i]);
      }
    }
  }

  // Issue the loads of tile t into ring slot t % STAGES (one commit group
  // per tile, empty past the program's end); the concat layer's tile also
  // converts the view rows into vs.
  __device__ void issue(int t) const {
    if (t < n_tiles) {
      const Tile d = prog[t];
      load_fwd_w_tile<NT>(wring + (t % STAGES) * TILE_BYTES, wpack + d.w, d.kind, d.k0, n0,
                          d.kind == T_FWD ? KC : venc_w, tid,
                          [](void* dst, const __nv_bfloat16* src) { cp16(dst, src); });
      if (d.kind == T_FWD_VENC) {
        for (int i = tid; i < ROWS * venc_w; i += NT) {
          const int m = i / venc_w, k = i - m * venc_w;
          const float v = m < nrows && k < venc_in ? __ldg(vrows + (size_t)m * venc_in + k) : 0.0f;
          *reinterpret_cast<__nv_bfloat16*>(vs + (k >> 3) * LBO + (m >> 3) * 128 + (m & 7) * 16 +
                                            (k & 7) * 2) = __float2bfloat16_rn(v);
        }
      }
    }
    cp_commit();
  }
};

// Shared memory of a CTA: the weight ring, the feature tile (x_chunks
// chunks of 64 lanes), the view tile (VD), two exchange slots per
// warpgroup, the tile program.
int fwd_smem(int wg, int x_chunks, bool vd, int n_tiles) {
  return STAGES * TILE_BYTES + BM * wg * KC * 2 * x_chunks + (vd ? BM * wg * KC * 2 : 0) +
         2 * wg * XCHG_BYTES + n_tiles * (int)sizeof(Tile);
}

// Weight pack (bf16, ParamLayout's matrix region) and bias pack (f32, its
// bias region): see mlp_tiles.cuh:Net. VD: the view-dependent chain (a
// separate instantiation, so the plain field's kernel is compiled without
// the concat layer's code); XRES likewise (the resident tile's kernel
// carries no second pass over x).
template <int WG, bool VD, bool XRES>
__global__ void __launch_bounds__(128 * WG, 1)
fused_mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ venc,
                     const __nv_bfloat16* __restrict__ wpack, const float* __restrict__ bpack,
                     float* __restrict__ out, int B, Net net, int venc_in, int n_tiles) {
  using Cta = FwdCta<WG, XRES>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.block_rank();  // which half of the columns
  const int tid = threadIdx.x;
  const int wg = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2);  // this thread's rows r0 and r0 + 8 of its warpgroup
  const int cq = 2 * (lane & 3);           // and columns 8j + cq, 8j + cq + 1
  const int brow = (blockIdx.x >> 1) * Cta::ROWS;
  const int wrow = brow + BM * wg;          // the warpgroup's first row
  const int nh = net.nh;
  const int n0 = HALF * c;

  Cta f;
  f.xrows = x + (size_t)brow * net.k_in;
  f.vrows = VD ? venc + (size_t)brow * venc_in : nullptr;
  f.k_in = net.k_in;
  f.venc_in = venc_in;
  f.venc_w = net.venc_w;
  f.nrows = min(Cta::ROWS, B - brow);
  f.nch = net.k_w / KC;
  f.tid = tid;
  f.n0 = n0;
  f.n_tiles = n_tiles;
  f.x_vec = net.k_in % 4 == 0 && ((uintptr_t)x & 15) == 0;
  f.wpack = wpack;
  f.wring = smem_raw;
  f.xs = f.wring + STAGES * TILE_BYTES;
  f.vs = f.xs + (size_t)(XRES ? f.nch : 2) * Cta::CHUNK;
  uint4* xchg = reinterpret_cast<uint4*>(f.vs + (VD ? Cta::ROWS * KC * 2 : 0));  // 2 x WG slots
  Tile* prog = reinterpret_cast<Tile*>(reinterpret_cast<unsigned char*>(xchg) +
                                       2 * WG * XCHG_BYTES);
  for (int i = tid; i < n_tiles; i += Cta::NT) prog[i] = tile_at(net, i, true, c);
  f.prog = prog;
  __syncthreads();

  uint32_t own[4][4], par[4][4];  // A fragments of this CTA's / the partner's half
  float acc[32];
  float2 bh2[8], bx2[8];  // a layer's biases at this thread's columns
  float xa[32], xb[32];   // feature chunks in flight (even, odd)
  int t = 0;
  f.issue(0);
  f.issue(1);
  f.load_x(xa, 0);
  if (f.nch > 1) f.load_x(xb, 1);

  // own -> exchange slot s (this warpgroup's part), then arrive at the
  // cluster barrier
  auto publish = [&](int s) {
    uint4* mine = xchg + (s * WG + wg) * 4 * 128;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      mine[q * 128 + wtid] = make_uint4(own[q][0], own[q][1], own[q][2], own[q][3]);
    cluster_arrive();
  };
  // wait at the cluster barrier, then the partner's slot s -> par
  auto fetch = [&](int s) {
    cluster_wait();
    const uint4* theirs = cl.map_shared_rank(xchg + (s * WG + wg) * 4 * 128, c ^ 1);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = theirs[q * 128 + wtid];
      par[q][0] = v.x; par[q][1] = v.y; par[q][2] = v.z; par[q][3] = v.w;
    }
  };
  // acc += own . tile (mine) or par . tile: the tile holds that half's k rows
  auto mma_h = [&](bool mine) {
    const unsigned char* ws = f.wring + (t % STAGES) * TILE_BYTES;
    wg_fence();
    if (mine) {
#pragma unroll
      for (int q = 0; q < 4; ++q) wgmma_rs64<1>(acc, own[q], gmma_desc(ws + q * 2048, 1024, 128));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) wgmma_rs64<1>(acc, par[q], gmma_desc(ws + q * 2048, 1024, 128));
    }
    wg_commit();
  };
  // acc += rows . tile, the A operand a resident K-major tile (k-steps of 16)
  auto mma_rows = [&](const unsigned char* a, int ksteps) {
    const unsigned char* ws = f.wring + (t % STAGES) * TILE_BYTES;
    wg_fence();
    for (int q = 0; q < ksteps; ++q)
      wgmma_ss64(acc, gmma_desc(a + q * 2 * Cta::LBO + wg * 1024, Cta::LBO, 128),
                 gmma_desc(ws + q * 2048, 1024, 128));
    wg_commit();
  };
  auto next_tile = [&]() {
    f.issue(t + 2);
    wg_wait(acc);
    ++t;
  };

  for (int layer = 0; layer < nh; ++layer) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    {  // the epilogue's biases, loaded while the products run
      const float* bh = bpack + net.b[layer] + n0;
      const float* bx = bpack + net.b_x + n0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        bh2[j] = *reinterpret_cast<const float2*>(bh + 8 * j + cq);
        bx2[j] = layer == net.skip ? *reinterpret_cast<const float2*>(bx + 8 * j + cq)
                                   : make_float2(0.0f, 0.0f);
      }
    }
    if (!XRES && layer == net.skip) {  // x again: its first chunks load under h . Wh
      f.load_x(xa, 0);
      if (f.nch > 1) f.load_x(xb, 1);
    }
    if (layer > 0) {  // h . Wh: this CTA's half of h from registers, then the partner's
      tile_ready();
      mma_h(true);
      next_tile();
      fetch((layer - 1) & 1);
      tile_ready();
      mma_h(false);
      next_tile();
    }
    if (layer == 0 || layer == net.skip) {  // x . Wx, chunk by chunk
      for (int ch = 0; ch < f.nch; ++ch) {
        if (layer == 0 || !XRES) {  // chunk ch into the tile; chunk ch + 2 into registers
          if (ch & 1) {
            f.store_x(xb, ch);
            if (ch + 2 < f.nch) f.load_x(xb, ch + 2);
          } else {
            f.store_x(xa, ch);
            if (ch + 2 < f.nch) f.load_x(xa, ch + 2);
          }
        }
        tile_ready();  // also publishes the stored chunk to the tensor cores
        mma_rows(f.x_chunk(ch), KC / 16);
        next_tile();
      }
    }
    if (VD && layer == net.cat) {  // venc . Wv: venc_w / 16 k-steps
      tile_ready();
      mma_rows(f.vs, net.venc_w / 16);
      next_tile();
    }
    // bias add(s) in the reference order (h-bias, then the skip layer's
    // input bias: zero elsewhere, which changes no bit after the relu),
    // relu, bf16: this warpgroup's half of the layer as A fragments
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v0 = (acc[4 * j] + bh2[j].x) + bx2[j].x;
      const float v1 = (acc[4 * j + 1] + bh2[j].y) + bx2[j].y;
      const float v2 = (acc[4 * j + 2] + bh2[j].x) + bx2[j].x;
      const float v3 = (acc[4 * j + 3] + bh2[j].y) + bx2[j].y;
      own[j >> 1][(j & 1) * 2] = pack_bf16(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
      own[j >> 1][(j & 1) * 2 + 1] = pack_bf16(fmaxf(v2, 0.0f), fmaxf(v3, 0.0f));
    }
    publish(layer & 1);
  }

  // the head (both CTAs, the same registers), sigmoid; CTA 0 writes
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
    wg_wait(z);
  }
  if (c == 0) {
    const float* bo = bpack + net.b[nh];
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // columns cq, cq + 1 of rows r0, r0 + 8
      const int r = wrow + r0 + (i >> 1) * 8, col = cq + (i & 1);
      if (col < NOUT && r < B) out[(size_t)r * NOUT + col] = 1.0f / (1.0f + expf(-(z[i] + bo[col])));
    }
  }
  cl.sync();  // the partner may still read this CTA's last exchange slot
}

// Launch shape: {CTAs, cluster size, threads, shared memory bytes, rows
// per CTA, 1 if the feature tile stays resident}: 128-row CTAs with the
// resident tile when their shared memory fits, else 64-row ones, else
// 128-row CTAs that stream x twice.
void fwd_config(int B, const Net& net, int (&out)[6]) {
  const int n_tiles = forward_tiles(net), nch = net.k_w / KC;
  const bool vd = net.cat >= 0;
  int wg = 2, x_res = 1;
  if (fwd_smem(2, nch, vd, n_tiles) > SMEM_LIMIT) {
    if (fwd_smem(1, nch, vd, n_tiles) <= SMEM_LIMIT) wg = 1;
    else x_res = 0;
  }
  const int rows = BM * wg;
  out[0] = 2 * ((B + rows - 1) / rows);
  out[1] = 2;
  out[2] = 128 * wg;
  out[3] = fwd_smem(wg, x_res ? nch : 2, vd, n_tiles);
  out[4] = rows;
  out[5] = x_res;
}

template <int WG, bool VD, bool XRES = true>
cudaError_t launch_kernel(const int (&cfg)[6], const float* x, const float* venc,
                          const void* wpack, const float* bpack, float* out, int B,
                          const Net& net, int venc_in, cudaStream_t st) {
  auto kern = fused_mlp_fwd_kernel<WG, VD, XRES>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, cfg[3]);
  if (err != cudaSuccess) return err;
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
  err = cudaLaunchKernelEx(&lc, kern, x, venc, (const __nv_bfloat16*)wpack, bpack, out, B, net,
                           venc_in, forward_tiles(net));
  return err == cudaSuccess ? cudaGetLastError() : err;
}

int launch(const float* x, const void* wpack, const float* bpack, float* out, int B, int k_in,
           int k_w, int num_layers, int skip_idx, const float* venc, int venc_in, int venc_w,
           int* launched, void* stream) {
  if (B <= 0) return 0;
  if (k_in <= 0 || k_w < k_in || k_w % KC != 0 || num_layers < 3 || num_layers > MAXL ||
      (venc != nullptr && num_layers + 3 > MAXL) || skip_idx <= 0 ||
      skip_idx >= num_layers - 1 || wpack == nullptr ||
      (uintptr_t)wpack % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (venc != nullptr && (venc_in <= 0 || venc_w < venc_in || venc_w % 16 != 0 ||
                          venc_w > VENC_MAX))
    return (int)cudaErrorInvalidValue;
  const Net net = make_net(k_in, k_w, num_layers, skip_idx, venc != nullptr ? venc_w : 0);
  int cfg[6];
  fwd_config(B, net, cfg);
  if (cfg[3] > SMEM_LIMIT) return (int)cudaErrorInvalidValue;  // the tile program does not fit
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (!cfg[5])
    err = venc != nullptr
              ? launch_kernel<2, true, false>(cfg, x, venc, wpack, bpack, out, B, net, venc_in, st)
              : launch_kernel<2, false, false>(cfg, x, venc, wpack, bpack, out, B, net, venc_in,
                                               st);
  else if (cfg[4] == 2 * BM)
    err = venc != nullptr
              ? launch_kernel<2, true>(cfg, x, venc, wpack, bpack, out, B, net, venc_in, st)
              : launch_kernel<2, false>(cfg, x, venc, wpack, bpack, out, B, net, venc_in, st);
  else
    err = venc != nullptr
              ? launch_kernel<1, true>(cfg, x, venc, wpack, bpack, out, B, net, venc_in, st)
              : launch_kernel<1, false>(cfg, x, venc, wpack, bpack, out, B, net, venc_in, st);
  if (err != cudaSuccess) return (int)err;
  if (launched)
    for (int i = 0; i < 6; ++i) launched[i] = cfg[i];
  return 0;
}

}  // namespace

// Plain C entry points (loaded with ctypes). They launch on `stream` and
// return cudaGetLastError() (0 on success); they never synchronize.
// launched (null, or 6 ints): on success, the shape the launch ran with:
// {CTAs, cluster size, threads per CTA, shared memory bytes, rows per CTA,
// 1 if the feature tile stays resident}.
extern "C" int fused_mlp_fwd(const float* x, const void* wpack, const float* bpack, float* out,
                             int B, int k_in, int k_w, int num_layers, int skip_idx,
                             int* launched, void* stream) {
  return launch(x, wpack, bpack, out, B, k_in, k_w, num_layers, skip_idx, nullptr, 0, 0,
                launched, stream);
}

// The view-dependent field: venc [B, venc_in] f32 rows; venc_w = the view
// rows of Wc1 in the pack (venc_in rounded up to 16, zero rows).
extern "C" int fused_mlp_fwd_viewdep(const float* x, const float* venc, const void* wpack,
                                     const float* bpack, float* out, int B, int k_in, int k_w,
                                     int num_layers, int skip_idx, int venc_in, int venc_w,
                                     int* launched, void* stream) {
  if (venc == nullptr) return (int)cudaErrorInvalidValue;
  return launch(x, wpack, bpack, out, B, k_in, k_w, num_layers, skip_idx, venc, venc_in, venc_w,
                launched, stream);
}

// Constants the Python wrapper checks its packing against.
extern "C" int fused_mlp_fwd_kc() { return KC; }
extern "C" int fused_mlp_fwd_out_pad() { return OUTW; }
extern "C" int fused_mlp_fwd_venc_max() { return VENC_MAX; }
