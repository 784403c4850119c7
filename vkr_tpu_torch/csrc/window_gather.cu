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
// What the design does about it: K4 and K6 run one thread per output
// element, adjacent threads on adjacent pixels, so offset reads and output
// writes coalesce and the taps of a warp fall in a few cache lines. K6
// computes its six taps in one thread from one read of the offsets.
// K5 moves only ~8 MB at (540, 960), so fixed costs per launch and per
// pixel weigh on it: its kernel is templated on the channel count and runs
// one pixel per thread on a 2-D grid of (32 x 8)-thread blocks, with no
// index division, 32-bit indices, and the offsets and taps read through the
// read-only path. Four pixels per thread (float4 offsets and stores) lost
// to this on the card: a warp's tap loads then span four times the cache
// lines, which cost most with two channels.
//
// Band mode (multi-device rendering): the offsets and the output cover rows
// [row0, row0 + bh) of the image, which stays whole. Output row y samples
// image row row0 + y; the +-radius clamp and the clamp to the image's edges
// stay those of the full frame. vkr_tpu slices its padded image at row0
// in the wrapper (gather_kernel.py:160-162, :262-264, :450-452).
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

// the bilinear blend of taps a0 (y0, x0), a1 (y1, x0), b0 (y0, x1),
// b1 (y1, x1): a y-lerp of both columns, then an x-lerp
__device__ __forceinline__ float lerp2(float a0, float a1, float b0, float b1,
                                       float fy, float fx) {
  const float va = a0 + (a1 - a0) * fy;
  const float vb = b0 + (b1 - b0) * fy;
  return va + (vb - va) * fx;
}

// bilinear sample of channel c of a (H, W, C) image
__device__ __forceinline__ float bilerp(const float* __restrict__ img, int w,
                                        int ch, int c, Tap ty, Tap tx) {
  return lerp2(img[((long long)ty.i0 * w + tx.i0) * ch + c],
               img[((long long)ty.i1 * w + tx.i0) * ch + c],
               img[((long long)ty.i0 * w + tx.i1) * ch + c],
               img[((long long)ty.i1 * w + tx.i1) * ch + c], ty.f, tx.f);
}

// K5: one tap per pixel, C channels. out (bh, W, C). Thread (tx, ty) of
// block (bx, by) takes pixel x = 32 bx + tx of row y = 8 by + ty: a warp
// holds 32 adjacent pixels of one row, so its offset loads, its taps
// (neighbours in the image) and its stores coalesce.
constexpr int kK5ThreadsX = 32;
constexpr int kK5Rows = 8;

template <int C>
__global__ void __launch_bounds__(kK5ThreadsX * kK5Rows)
    window_gather_k5(const float* __restrict__ img, int h, int w, int bh,
                     int row0, const float* __restrict__ off_y,
                     const float* __restrict__ off_x, float r,
                     float* __restrict__ out) {
  const int x = blockIdx.x * kK5ThreadsX + threadIdx.x;
  const int y = blockIdx.y * kK5Rows + threadIdx.y;
  if (x >= w || y >= bh) return;
  const int p = y * w + x;
  const Tap ty = axis_tap(__ldg(off_y + p), r, row0 + y, h);
  const Tap tx = axis_tap(__ldg(off_x + p), r, x, w);
  const float* a0 = img + (ty.i0 * w + tx.i0) * C;
  const float* a1 = img + (ty.i1 * w + tx.i0) * C;
  const float* b0 = img + (ty.i0 * w + tx.i1) * C;
  const float* b1 = img + (ty.i1 * w + tx.i1) * C;
#pragma unroll
  for (int c = 0; c < C; ++c)
    out[p * C + c] = lerp2(__ldg(a0 + c), __ldg(a1 + c), __ldg(b0 + c),
                           __ldg(b1 + c), ty.f, tx.f);
}

// K4: K taps per pixel of one (H, W) image. off_* and out (K, bh, W).
__global__ void window_gather_multi_kernel(const float* __restrict__ img,
                                           int h, int w, int bh, int row0,
                                           int k_sets,
                                           const float* __restrict__ off_y,
                                           const float* __restrict__ off_x,
                                           float r, float* __restrict__ out) {
  const long long n = (long long)bh * w;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n * k_sets) return;
  const long long p = q % n;
  const int y = (int)(p / w);
  const int x = (int)(p - (long long)y * w);
  out[q] = bilerp(img, w, 1, 0, axis_tap(off_y[q], r, row0 + y, h),
                  axis_tap(off_x[q], r, x, w));
}

// K6: the six TAA history taps. history (H, W, 3), depth (H, W); off_*
// (bh, W); out (16, bh, W) = centre rgb, rgb at (+1,0), (0,+1), (-1,0), (0,-1)
// texels, centre prev depth. Each tap clamps off + d on its own.
__global__ void taa_history_gather_kernel(const float* __restrict__ hist,
                                          const float* __restrict__ depth,
                                          int h, int w, int bh, int row0,
                                          const float* __restrict__ off_y,
                                          const float* __restrict__ off_x,
                                          float r, float* __restrict__ out) {
  const long long n = (long long)bh * w;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int y = row0 + (int)(p / w);
  const int x = (int)(p % w);
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

dim3 k5_grid(int h, int w) {
  return dim3((unsigned)((w + kK5ThreadsX - 1) / kK5ThreadsX),
              (unsigned)((h + kK5Rows - 1) / kK5Rows));
}

}  // namespace

// ch in {1, 2, 3} and h * w * ch < 2^31 (the wrapper checks both). The
// offsets and out cover image rows [row0, row0 + bh) (all: 0, h).
extern "C" int vkr_window_gather(const float* img, int h, int w, int ch,
                                 int bh, int row0, const float* off_y,
                                 const float* off_x, float radius, float* out,
                                 void* stream) {
  if (bh <= 0 || w <= 0) return 0;
  const dim3 grid = k5_grid(bh, w), block(kK5ThreadsX, kK5Rows);
  cudaStream_t s = (cudaStream_t)stream;
  switch (ch) {
    case 1:
      window_gather_k5<1><<<grid, block, 0, s>>>(img, h, w, bh, row0, off_y,
                                                 off_x, radius, out);
      break;
    case 2:
      window_gather_k5<2><<<grid, block, 0, s>>>(img, h, w, bh, row0, off_y,
                                                 off_x, radius, out);
      break;
    case 3:
      window_gather_k5<3><<<grid, block, 0, s>>>(img, h, w, bh, row0, off_y,
                                                 off_x, radius, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int vkr_window_gather_multi(const float* img, int h, int w,
                                       int bh, int row0, int k_sets,
                                       const float* off_y,
                                       const float* off_x, float radius,
                                       float* out, void* stream) {
  const long long n = (long long)bh * w * k_sets;
  if (n > 0)
    window_gather_multi_kernel<<<blocks(n), kThreads, 0,
                                 (cudaStream_t)stream>>>(
        img, h, w, bh, row0, k_sets, off_y, off_x, radius, out);
  return (int)cudaGetLastError();
}

extern "C" int vkr_taa_history_gather(const float* hist, const float* depth,
                                      int h, int w, int bh, int row0,
                                      const float* off_y, const float* off_x,
                                      float radius, float* out,
                                      void* stream) {
  const long long n = (long long)bh * w;
  if (n > 0)
    taa_history_gather_kernel<<<blocks(n), kThreads, 0,
                                (cudaStream_t)stream>>>(
        hist, depth, h, w, bh, row0, off_y, off_x, radius, out);
  return (int)cudaGetLastError();
}
