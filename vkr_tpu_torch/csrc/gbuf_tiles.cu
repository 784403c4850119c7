// K1: merged tile raster + attribute resolve for the G-buffer, and K7: the
// same tile walk without the resolve (visibility only: depth and tri id).
//
// K1 replaces vkr_tpu/raster/gbuf_kernel.py:_gbuf_kernel (wrapper
// gbuf_tiles); K7 replaces vkr_tpu/raster/kernel.py:_raster_kernel (wrapper
// rasterize_tiles), which the shadow-map pass uses. Both are one template:
// kWithResolve = false drops the peel floor and the attribute resolve.
//
// Per screen tile it walks the tile's binned pair segment in order; each
// pair gives edge-function coverage, a depth plane and a LESS_OR_EQUAL test
// with an optional strict peel floor. The winning pair's resolve planes
// (perspective denominator, 9 attribute/w planes, material id) are
// evaluated once per pixel at the end.
//
// What bounds it on this card: the pair walk is arithmetic on values every
// thread of the tile shares (16 flops per pair-pixel); at 1080p the opaque
// phase is ~4e8 pair-pixel tests. Global traffic is small (the tile's
// rows once per block, one row per pixel at the end), so the limit is
// issue rate and the tail of the busiest tiles.
// What the design does about it: one block per 1024 pixels of a tile
// (8x128: one block; the masked phase's 8x512: four), one thread per
// pixel. The block stages the 12 raster floats of each chunk of pairs in
// shared memory, so every pair is read from global memory once per block
// and then broadcast from shared memory to all threads. A thread keeps
// only its depth and the index of its winning pair in registers (not the
// 31 latched coefficients of the TPU kernel), and reads the winner's
// resolve planes from global memory once at the end: the same values with
// 31 fewer live registers. Bounds are the plain segment [start, start+count);
// the TPU kernel's 8-row DMA alignment served only Mosaic.
//
// Arithmetic: every plane is evaluated as fma(a, px, b*py) + c — the
// contraction vkr_tpu's kernel gets from XLA — with an explicit fmaf, and
// the file is built with -fmad=false so nvcc contracts nothing else. The
// plain PyTorch version (gbuf_kernel.py) evaluates the same form, so the
// two agree bit for bit. The depth test is d <= z, so on equal depth the
// later pair wins; pairs arrive in ascending triangle id within a tile.

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 64;       // floats per pair row (raster/pair_rows.py)
constexpr int kRaster = 12;    // a(3) b(3) c(3) z-plane(3)
constexpr int kTriId = 12;     // row index of the triangle id
constexpr int kResolve = 16;   // first resolve field: denominator plane
constexpr int kChannels = 9;   // uv(2) normal(3) prev clip(4)
constexpr int kMaterial = 46;  // row index of the material id
constexpr int kChunk = 256;    // pairs staged per shared-memory chunk
constexpr int kThreads = 1024;

__device__ __forceinline__ float plane(float a, float b, float c, float px,
                                       float py) {
  return fmaf(a, px, b * py) + c;
}

template <bool kWithResolve>
__global__ void __launch_bounds__(kThreads) tile_raster_kernel(
    const float* __restrict__ pairs, const int* __restrict__ seg_starts,
    const int* __restrict__ seg_counts, const float* __restrict__ peel,
    int tiles_x, int tile_h, int tile_w, float* __restrict__ zbuf,
    int* __restrict__ tid, float* __restrict__ attrs, long long stride) {
  __shared__ float rs[kChunk * kRaster];

  const int tile = blockIdx.x;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int l = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = l < tile_h * tile_w;
  const int ly = live ? l / tile_w : 0;
  const int lx = live ? l - ly * tile_w : 0;
  const int gx = tx * tile_w + lx;
  const int gy = ty * tile_h + ly;
  const long long pix = (long long)gy * (tiles_x * tile_w) + gx;
  const float px = (float)gx + 0.5f;
  const float py = (float)gy + 0.5f;
  // depth-peel floor: only fragments strictly behind it survive
  const float floor_d = kWithResolve && live ? peel[pix] : -1.0f;

  const int start = seg_starts[tile];
  const int count = seg_counts[tile];
  float z = 1.0f;  // depth clear
  int win = -1;    // winning pair row, -1 = background
  for (int base = 0; base < count; base += kChunk) {
    const int n = min(kChunk, count - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n * kRaster; i += blockDim.x) {
      const int p = i / kRaster;
      rs[i] = pairs[(long long)(start + base + p) * kRow + (i - p * kRaster)];
    }
    __syncthreads();
    for (int p = 0; p < n; ++p) {
      const float* r = rs + p * kRaster;
      const float e0 = plane(r[0], r[3], r[6], px, py);
      const float e1 = plane(r[1], r[4], r[7], px, py);
      const float e2 = plane(r[2], r[5], r[8], px, py);
      const float d = plane(r[9], r[10], r[11], px, py);
      if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && d >= 0.0f &&
          d <= 1.0f && d <= z && d > floor_d) {
        z = d;
        win = start + base + p;
      }
    }
  }
  if (!live) return;

  zbuf[pix] = z;
  const float* w = win >= 0 ? pairs + (long long)win * kRow : nullptr;
  tid[pix] = w ? (int)w[kTriId] : -1;
  if (!kWithResolve) return;
  // background: denominator plane (0, 0, 1), channel planes 0, material -1
  const float* c = w ? w + kResolve : nullptr;
  float den = c ? plane(c[0], c[1], c[2], px, py) : 1.0f;
  if (fabsf(den) < 1e-20f) den = 1e-20f;
  const float inv = 1.0f / den;
  for (int ch = 0; ch < kChannels; ++ch) {
    const float v =
        c ? plane(c[3 + 3 * ch], c[4 + 3 * ch], c[5 + 3 * ch], px, py) : 0.0f;
    attrs[ch * stride + pix] = v * inv;
  }
  attrs[kChannels * stride + pix] = w ? w[kMaterial] : -1.0f;
}

}  // namespace

extern "C" int vkr_gbuf_tiles(const float* pairs, const int* seg_starts,
                              const int* seg_counts, const float* peel,
                              int tiles_x, int tiles_y, int tile_h,
                              int tile_w, float* zbuf, int* tid,
                              float* attrs, void* stream) {
  const int tile_px = tile_h * tile_w;
  int threads = tile_px < kThreads ? tile_px : kThreads;
  threads = (threads + 31) / 32 * 32;
  const dim3 grid(tiles_x * tiles_y, (tile_px + threads - 1) / threads);
  const long long stride = (long long)tiles_y * tile_h * tiles_x * tile_w;
  tile_raster_kernel<true><<<grid, threads, 0, (cudaStream_t)stream>>>(
      pairs, seg_starts, seg_counts, peel, tiles_x, tile_h, tile_w, zbuf, tid,
      attrs, stride);
  return (int)cudaGetLastError();
}

extern "C" int vkr_rasterize_tiles(const float* pairs, const int* seg_starts,
                                   const int* seg_counts, int tiles_x,
                                   int tiles_y, int tile_h, int tile_w,
                                   float* zbuf, int* tid, void* stream) {
  const int tile_px = tile_h * tile_w;
  int threads = tile_px < kThreads ? tile_px : kThreads;
  threads = (threads + 31) / 32 * 32;
  const dim3 grid(tiles_x * tiles_y, (tile_px + threads - 1) / threads);
  tile_raster_kernel<false><<<grid, threads, 0, (cudaStream_t)stream>>>(
      pairs, seg_starts, seg_counts, nullptr, tiles_x, tile_h, tile_w, zbuf,
      tid, nullptr, 0);
  return (int)cudaGetLastError();
}
