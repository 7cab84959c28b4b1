// Device code shared by the skip-MLP kernels for Hopper (sm_90a):
// fused_mlp_train.cu (fwd_bwd, wgrad) and fused_mlp_fwd.cu (the forward).
//
//   - Net: where every layer's matrices and biases live in the flat
//     parameter layout (ops/fused_mlp.py:ParamLayout), whose bf16 cast is
//     both the train kernels' weight copy and the forward's weight pack;
//   - the tile program: the t-th 64 x 64 weight tile a CTA of a 2-CTA
//     cluster uses (tile_at), forward layers, the head, then the walk back;
//     the forward's weight-tile loader (wgmma's no-swizzle layouts);
//   - cp.async, wgmma descriptors and wrappers (A from registers or shared
//     memory, either operand K-major or MN-major), the split cluster
//     barrier, bf16 packing.
//
// wgmma's no-swizzle shared-memory layouts, settled on the card: a core
// matrix is 8 rows x 16 bytes (the 16 bytes along the operand's contiguous
// dimension: K for K-major, M or N for MN-major); a descriptor's LBO is the
// byte stride between core matrices along K, its SBO along M or N, for both
// transpose modes.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 64;         // batch rows of a warpgroup's tile
constexpr int HID = 128;       // hidden width
constexpr int KC = 64;         // input / weight rows per streamed chunk
constexpr int OUTW = 16;       // head padded to one fragment width
constexpr int NOUT = 3;        // real output columns
constexpr int MAXL = 16;       // most Linear layers a network may have
constexpr int HALF = HID / 2;  // output columns per CTA of a pair
constexpr int TILE_BYTES = KC * HALF * 2;  // a [64 x 64] bf16 tile: 8 KB
constexpr int STAGES = 3;                  // weight-tile ring depth
constexpr int XCHG_BYTES = 4 * 128 * 16;   // one warpgroup's layer half in fragment order
constexpr int SMEM_LIMIT = 227 * 1024;

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

// Tiles of the forward program: the relu layers and the head.
int forward_tiles(const Net& net) {
  return 2 * (net.k_w / KC) + 2 * (net.nh - 1) + (net.cat >= 0 ? 1 : 0) + 1;
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

// A forward tile's weights into a ring slot (16-byte copies by cp(dst, src),
// NT threads): T_FWD / T_FWD_VENC: W [rows, 128] -> B[k][n] = W[k0 + k][n0 +
// n] (rows = KC, or the view rows), MN-major; T_FWD_HEAD: W [128, 16] ->
// B[k][n] = W[k][n], MN-major, 16 k-groups x 2 n-groups.
template <int NT, typename Copy>
__device__ __forceinline__ void load_fwd_w_tile(unsigned char* ws, const __nv_bfloat16* W, int kind,
                                                int k0, int n0, int rows, int tid, Copy cp) {
  if (kind == T_FWD || kind == T_FWD_VENC) {
    for (int i = tid; i < rows * 8; i += NT) {
      const int k = i >> 3, ng = i & 7;
      cp(ws + (k >> 3) * 1024 + ng * 128 + (k & 7) * 16, W + (size_t)(k0 + k) * HID + n0 + 8 * ng);
    }
  } else if (kind == T_FWD_HEAD) {
    for (int i = tid; i < HID * 2; i += NT) {
      const int k = i >> 1, ng = i & 1;
      cp(ws + (k >> 3) * 256 + ng * 128 + (k & 7) * 16, W + (size_t)k * OUTW + 8 * ng);
    }
  }
}

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

// d[64 x 64] += A . B, both by descriptor; TA: A is MN-major (1) or K-major
// (0); TB: B is MN-major (1) or K-major (0).
template <int TA = 0, int TB = 1>
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31},"
      " %32, %33, p, 1, 1, %34, %35;\n}\n"
      : ACC32(d)
      : "l"(a), "l"(b), "n"(TA), "n"(TB), "r"(1));
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

// d[64 x 16] += A . B, both by descriptor, transpose modes as wgmma_ss64.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss16(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %12, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, %8, %9, p, 1, 1, %10, %11;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "n"(TA), "n"(TB), "r"(1));
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

}  // namespace
