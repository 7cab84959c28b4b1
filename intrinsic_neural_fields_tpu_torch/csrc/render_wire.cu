// The render's wire image: one launch a frame composites the background,
// quantizes and puts the colours in raster order, hand-written for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX renderer (intrinsic_neural_fields_tpu/
// render/renderer.py:755-761) composites on the device and scatters the
// Morton-ordered colours into the image in numpy on the host. It was added
// because the port did the same: ~8 torch calls a frame for the composite,
// then on the host a u8 -> f32 pass, a copy and a row scatter of H*W x 3
// floats through the Morton permutation (and a second, boolean scatter for
// a masked view). A traced 512^2 render orbit put ~28 of its ~51 idle
// points there, with nothing queued on the card behind it.
//
// One thread per four raster pixels. Pixel p reads its slot s = slot[p]:
// the row of the Morton-ordered hit records that traced it, or -1 for a
// pixel outside the mask (any s outside [0, L) is taken as such). Inside
// the mask it reads valid[s] and, for a hit, preds[s] (f32 x3); it rounds
// the colour to f16 (__float2half_rn, as preds.to(torch.float16)) and takes
// the background's f16 where nothing was hit or the pixel is outside the
// mask. On the u8 wire it then quantizes as torch does: back to f32, clamp
// to [0, 1], times 255.0f, round half to even (rintf), to u8. It writes
// out[p] (u8 x3 or f16 x3) in raster order, and with `valid_plane` the hit
// flag of p (0 outside the mask). So the host gets the image the plain
// twin (ops/wire.py:compose_wire_plain) gives, to the bit: one multiply,
// a clamp and a rounding, nothing for nvcc to contract.
//
// Bound on this card: bytes. The slot map (4 B a pixel) and the hit
// records (16 B a ray) are read and the wire (3 or 6 B a pixel, +1 with the
// plane) written once: ~5 MB at 512^2, ~1.6 us at 3.35 TB/s. The reads
// through the slot are gathers, local because the Morton order keeps
// neighbouring pixels in neighbouring rows; the writes are whole 4- or
// 8-byte words, contiguous across a warp. Its time on the card is small
// next to the frame's; what it buys is the host's time.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PIXELS = 4;     // raster pixels per thread
constexpr int THREADS = 256;  // threads per CTA

__device__ __forceinline__ unsigned char quantize(__half h) {
  float f = __half2float(h);
  f = fminf(fmaxf(f, 0.0f), 1.0f);
  return (unsigned char)rintf(f * 255.0f);
}

// The f16 colour of pixel p and whether it was hit.
__device__ __forceinline__ bool pixel(const float* __restrict__ preds,
                                      const unsigned char* __restrict__ valid,
                                      const int* __restrict__ slot, int L, int p, __half bg,
                                      __half c[3]) {
  const int s = __ldg(slot + p);
  const bool hit = s >= 0 && s < L && __ldg(valid + s) != 0;
  if (hit) {
    const float* row = preds + 3 * (size_t)s;
    c[0] = __float2half_rn(__ldg(row));
    c[1] = __float2half_rn(__ldg(row + 1));
    c[2] = __float2half_rn(__ldg(row + 2));
  } else {
    c[0] = c[1] = c[2] = bg;
  }
  return hit;
}

template <bool U8>
__global__ void __launch_bounds__(THREADS)
    render_wire_kernel(const float* __restrict__ preds, const unsigned char* __restrict__ valid,
                       const int* __restrict__ slot, int P, int L, float background,
                       void* __restrict__ out, unsigned char* __restrict__ valid_plane) {
  const int p0 = (blockIdx.x * THREADS + threadIdx.x) * PIXELS;
  if (p0 >= P) return;
  const __half bg = __float2half_rn(background);
  const int n = min(PIXELS, P - p0);
  __half c[PIXELS][3];
  unsigned char hit[PIXELS];
#pragma unroll
  for (int i = 0; i < PIXELS; ++i) {
    c[i][0] = c[i][1] = c[i][2] = bg;
    hit[i] = i < n && pixel(preds, valid, slot, L, p0 + i, bg, c[i]);
  }

  if (U8) {
    unsigned char* o = static_cast<unsigned char*>(out) + 3 * (size_t)p0;
    if (n == PIXELS) {  // 12 bytes at a 12-byte boundary: three 4-byte words
      uint32_t w[3] = {0, 0, 0};
#pragma unroll
      for (int i = 0; i < 3 * PIXELS; ++i)
        w[i / 4] |= (uint32_t)quantize(c[i / 3][i % 3]) << (8 * (i % 4));
      uint32_t* o4 = reinterpret_cast<uint32_t*>(o);
      o4[0] = w[0];
      o4[1] = w[1];
      o4[2] = w[2];
    } else {
#pragma unroll
      for (int i = 0; i < PIXELS; ++i)
        if (i < n)
          for (int j = 0; j < 3; ++j) o[3 * i + j] = quantize(c[i][j]);
    }
  } else {
    __half* o = static_cast<__half*>(out) + 3 * (size_t)p0;
    if (n == PIXELS) {  // 24 bytes at an 8-byte boundary: three 8-byte words
      uint64_t w[3] = {0, 0, 0};
#pragma unroll
      for (int i = 0; i < 3 * PIXELS; ++i)
        w[i / 4] |= (uint64_t)__half_as_ushort(c[i / 3][i % 3]) << (16 * (i % 4));
      uint64_t* o8 = reinterpret_cast<uint64_t*>(o);
      o8[0] = w[0];
      o8[1] = w[1];
      o8[2] = w[2];
    } else {
#pragma unroll
      for (int i = 0; i < PIXELS; ++i)
        if (i < n)
          for (int j = 0; j < 3; ++j) o[3 * i + j] = c[i][j];
    }
  }
  if (valid_plane != nullptr) {
    if (n == PIXELS && ((uintptr_t)(valid_plane + p0) & 3) == 0) {
      *reinterpret_cast<uint32_t*>(valid_plane + p0) =
          (uint32_t)hit[0] | (uint32_t)hit[1] << 8 | (uint32_t)hit[2] << 16 |
          (uint32_t)hit[3] << 24;
    } else {
#pragma unroll
      for (int i = 0; i < PIXELS; ++i)
        if (i < n) valid_plane[p0 + i] = hit[i];
    }
  }
}

}  // namespace

extern "C" int render_wire_pixels_per_thread() { return PIXELS; }

// Plain C entry point (loaded with ctypes). preds [L, 3] f32 and valid [L]
// bytes (0 or 1) in trace order; slot [P] i32, one per raster pixel; u8: 1
// for the u8 wire (out [P, 3] u8), 0 for the f16 wire (out [P, 3] f16);
// out 8-byte aligned; valid_plane [P] u8, or nullptr. One launch of
// ceil(P / 1024) CTAs on `stream`; returns cudaGetLastError().
extern "C" int render_wire(const float* preds, const unsigned char* valid, const int* slot, int P,
                           int L, float background, int u8, void* out,
                           unsigned char* valid_plane, void* stream) {
  if (P < 0 || L < 0 || (uintptr_t)out % 8 != 0) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const int per_cta = THREADS * PIXELS;
  const unsigned ctas = (unsigned)((P + per_cta - 1) / per_cta);
  if (u8) {
    render_wire_kernel<true><<<ctas, THREADS, 0, (cudaStream_t)stream>>>(
        preds, valid, slot, P, L, background, out, valid_plane);
  } else {
    render_wire_kernel<false><<<ctas, THREADS, 0, (cudaStream_t)stream>>>(
        preds, valid, slot, P, L, background, out, valid_plane);
  }
  return (int)cudaGetLastError();
}
