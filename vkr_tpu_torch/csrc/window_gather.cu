// K4, K5, K6: per-pixel-offset bilinear gathers (reprojection, GTAO
// horizon taps, TAA history taps).
//
// Replaces, from vkr_tpu/raster/gather_kernel.py:
//   K5 _window_gather_kernel       (wrapper window_gather_bilinear :130)
//   K4 _window_gather_multi_kernel (wrapper window_gather_bilinear_multi :246)
//   K6 _taa_gather_kernel          (wrapper taa_history_gather :431)
// Each samples an image bilinearly at (y + off_y, x + off_x) per pixel, with
// the offsets clamped to +-radius and clamp-to-edge taps. The TPU kernels
// fetched a (8 + 2R) x 384 window per tile and gathered rows within vregs;
// on this card the four taps are plain loads through L1/L2, and the window,
// sublane gathers and static shift loop are dropped. The clamp to +-radius
// stays: the output depends on it under fast motion.
//
// What bounds them on this card: device memory bandwidth. Each output
// element reads 4 taps that neighbouring threads mostly share (the caches
// absorb the reuse), so the floor is about one read of the image plus the
// offsets and one write of the output: at 1080p K6 moves ~8 MB in and
// ~133 MB out.
// What the design does about it: one thread per output element, adjacent
// threads on adjacent pixels, so offset reads and output writes coalesce
// and the taps of a warp fall in a few cache lines. K6 computes its six
// taps in one thread from one read of the offsets.
//
// Arithmetic: built with -fmad=false; per tap, o = clamp(off, -r, r),
// i = floor(o), f = o - i (exact), then a y-lerp of both columns and an
// x-lerp, in the plain PyTorch versions' order, so kernel and plain
// version agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Tap {
  int i0, i1;
  float f;
};

__device__ __forceinline__ Tap axis_tap(float off, float r, int pos,
                                        int size) {
  const float o = fminf(fmaxf(off, -r), r);
  const float fl = floorf(o);
  const int i = pos + (int)fl;
  return {min(max(i, 0), size - 1), min(max(i + 1, 0), size - 1), o - fl};
}

// bilinear sample of channel c of a (H, W, C) image
__device__ __forceinline__ float bilerp(const float* __restrict__ img, int w,
                                        int ch, int c, Tap ty, Tap tx) {
  const float a0 = img[((long long)ty.i0 * w + tx.i0) * ch + c];
  const float a1 = img[((long long)ty.i1 * w + tx.i0) * ch + c];
  const float b0 = img[((long long)ty.i0 * w + tx.i1) * ch + c];
  const float b1 = img[((long long)ty.i1 * w + tx.i1) * ch + c];
  const float va = a0 + (a1 - a0) * ty.f;
  const float vb = b0 + (b1 - b0) * ty.f;
  return va + (vb - va) * tx.f;
}

// K5: one tap per pixel, C channels. out (H, W, C).
__global__ void window_gather_kernel(const float* __restrict__ img, int h,
                                     int w, int ch,
                                     const float* __restrict__ off_y,
                                     const float* __restrict__ off_x, float r,
                                     float* __restrict__ out) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)h * w) return;
  const int y = (int)(p / w);
  const int x = (int)(p - (long long)y * w);
  const Tap ty = axis_tap(off_y[p], r, y, h);
  const Tap tx = axis_tap(off_x[p], r, x, w);
  for (int c = 0; c < ch; ++c) out[p * ch + c] = bilerp(img, w, ch, c, ty, tx);
}

// K4: K taps per pixel of one (H, W) image. off_* and out (K, H, W).
__global__ void window_gather_multi_kernel(const float* __restrict__ img,
                                           int h, int w, int k_sets,
                                           const float* __restrict__ off_y,
                                           const float* __restrict__ off_x,
                                           float r, float* __restrict__ out) {
  const long long n = (long long)h * w;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n * k_sets) return;
  const long long p = q % n;
  const int y = (int)(p / w);
  const int x = (int)(p - (long long)y * w);
  out[q] = bilerp(img, w, 1, 0, axis_tap(off_y[q], r, y, h),
                  axis_tap(off_x[q], r, x, w));
}

// K6: the six TAA history taps. history (H, W, 3), depth (H, W);
// out (16, H, W) = centre rgb, rgb at (+1,0), (0,+1), (-1,0), (0,-1)
// texels, centre prev depth. Each tap clamps off + d on its own.
__global__ void taa_history_gather_kernel(const float* __restrict__ hist,
                                          const float* __restrict__ depth,
                                          int h, int w,
                                          const float* __restrict__ off_y,
                                          const float* __restrict__ off_x,
                                          float r, float* __restrict__ out) {
  const long long n = (long long)h * w;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int y = (int)(p / w);
  const int x = (int)(p - (long long)y * w);
  const float oy = off_y[p];
  const float ox = off_x[p];
  const int dxs[5] = {0, 1, 0, -1, 0};
  const int dys[5] = {0, 0, 1, 0, -1};
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const Tap ty = axis_tap(oy + (float)dys[k], r, y, h);
    const Tap tx = axis_tap(ox + (float)dxs[k], r, x, w);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[(3 * k + c) * n + p] = bilerp(hist, w, 3, c, ty, tx);
  }
  out[15 * n + p] = bilerp(depth, w, 1, 0, axis_tap(oy, r, y, h),
                           axis_tap(ox, r, x, w));
}

unsigned blocks(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int vkr_window_gather(const float* img, int h, int w, int ch,
                                 const float* off_y, const float* off_x,
                                 float radius, float* out, void* stream) {
  const long long n = (long long)h * w;
  if (n > 0)
    window_gather_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        img, h, w, ch, off_y, off_x, radius, out);
  return (int)cudaGetLastError();
}

extern "C" int vkr_window_gather_multi(const float* img, int h, int w,
                                       int k_sets, const float* off_y,
                                       const float* off_x, float radius,
                                       float* out, void* stream) {
  const long long n = (long long)h * w * k_sets;
  if (n > 0)
    window_gather_multi_kernel<<<blocks(n), kThreads, 0,
                                 (cudaStream_t)stream>>>(
        img, h, w, k_sets, off_y, off_x, radius, out);
  return (int)cudaGetLastError();
}

extern "C" int vkr_taa_history_gather(const float* hist, const float* depth,
                                      int h, int w, const float* off_y,
                                      const float* off_x, float radius,
                                      float* out, void* stream) {
  const long long n = (long long)h * w;
  if (n > 0)
    taa_history_gather_kernel<<<blocks(n), kThreads, 0,
                                (cudaStream_t)stream>>>(
        hist, depth, h, w, off_y, off_x, radius, out);
  return (int)cudaGetLastError();
}
