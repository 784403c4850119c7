// R2: the SSR blur's 23x23 bilateral gather (blur.comp's roughness-adaptive
// gaussian with depth and normal weights), behind passes/ssr.py:ssr_blur.
//
// Replaces no pallas_call: vkr_tpu computes the blur in jnp
// (vkr_tpu/passes/ssr.py:858 `tap`, a lax.fori_loop over the 529 taps of the
// whole image). The port's plain version
// (passes/ssr_blur_kernel.py:ssr_blur_reference) adds the taps one by one in
// the same order; in PyTorch that is some 14,000 launches over (h, w)
// tensors, each tap's weight and product written to device memory and read
// back.
//
// What bounds it on this card: float32 throughput. Each tap inside a pixel's
// radius takes about 26 float32 operations (the depth weight with its IEEE
// division, the normal dot, the gaussian's division and expf, the weight,
// the colour and weight sums); at 1440p a frame has up to 921,600 half-res
// pixels x 529 taps, 12.7 GFLOP, 0.19 ms at 67 TFLOP/s. Its bytes are the
// inputs read once and the colour written once, 44 bytes a pixel, 0.012 ms
// at 3.35 TB/s. chip_smoke.py:work_of counts the taps inside each pixel's
// radius on the frame's own sigma plane.
// What the design does about it:
//  * one block owns a 16 x 16 tile of output pixels and loads the tile with
//    its 11-texel halo once into shared memory: (n0, n1, n2, depth) as one
//    float4 and the reflection as three planes, 40,432 bytes, so a tap is
//    one 16-byte and three 4-byte shared loads (a warp is 16 pixels of two
//    rows). The halo's indices clamp to the frame's rows [0, H) and columns
//    [0, w), as the plain version's edge padding replicates the edges, so
//    no padded copy exists in device memory. On an H100 (the Sponza
//    stand-in's 1440p frame) a 16 x 16 tile ran 12% faster than a 32 x 8
//    one: a warp's pixels lie closer together, so their radii differ less.
//  * one thread per pixel loops only over the taps inside its radius
//    r = floor(3 sigma - 0.01) (1 to 11 for sigma in [0.4, 4]): 9 taps at
//    the lowest roughness, 529 at the highest. The taps outside add
//    reflection x 0 to the sums, which changes nothing while the reflection
//    is finite. A warp runs as many taps as its widest pixel needs.
//    (Skipping the gaussian of a tap whose weight is exactly 0 ran 9%
//    slower on an H100: the branch costs more than the taps it saves.)
//  * a block whose tile or halo holds a non-finite reflection or depth
//    (__syncthreads_or over the loads) takes every one of the 529 taps, as
//    the plain version does, so that reflection x 0 gives its NaN.
//
// Arithmetic, so that the output equals the plain version's bit for bit:
// built with -fmad=false and IEEE division; the taps are added in
// vkr_tpu's order (j from -11 to 11 outer, i inner, k = (j + 11) 23 +
// (i + 11)); each tap computes bw = max(1 - (1000 |dc - pd|) / max(|dc|,
// 1e-20), 0), nw = max((c0 p0 + c1 p1) + c2 p2, 0), g = expf(-(i i + j j) /
// e) with e = (2 sigma) sigma, and adds (g bw) nw, with torch.clamp's and
// torch.maximum's NaN propagation. The sums start at +0 and never become
// -0, so a skipped +-0 term leaves them as they are. The output is the
// colour over max(weight sum, (float(0.001 (2 pi)) sigma) sigma).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kR = 11;  // MAX_BLUR_RADIUS: the 23 x 23 window
constexpr int kTileW = 16;
constexpr int kTileH = 16;
constexpr int kThreads = kTileW * kTileH;
constexpr int kHaloW = kTileW + 2 * kR;
constexpr int kHaloH = kTileH + 2 * kR;
constexpr int kHalo = kHaloW * kHaloH;
// float32(0.001 * (2 pi)), the weight floor's factor, rounded from the
// double product as PyTorch rounds the Python scalar
constexpr float kFloorScale = (float)(0.001 * (2.0 * 3.14159265358979323846));

// torch.clamp(x, min=0.0): a NaN stays NaN
__device__ __forceinline__ float clamp0(float x) {
  return x != x ? x : fmaxf(x, 0.0f);
}

// torch.maximum(a, b): NaN if either is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

struct Sums {
  float c0, c1, c2, w;
};

// One tap at offset (i, j): p is its (n0, n1, n2, depth), r0..r2 its
// reflection's planes at the tap's row and the pixel's column; the plain
// version's weight and sums.
__device__ __forceinline__ void tap(Sums& s, const float4 p, const float* r0,
                                    const float* r1, const float* r2, int i,
                                    int j, float dc, float dabs, float c0,
                                    float c1, float c2, float e) {
  const float bw = clamp0(1.0f - (1000.0f * fabsf(dc - p.w)) / dabs);
  const float nw = clamp0((c0 * p.x + c1 * p.y) + c2 * p.z);
  const float g = expf(-(float)(i * i + j * j) / e);
  const float wgt = (g * bw) * nw;
  s.c0 = s.c0 + r0[i] * wgt;
  s.c1 = s.c1 + r1[i] * wgt;
  s.c2 = s.c2 + r2[i] * wgt;
  s.w = s.w + wgt;
}

__global__ void __launch_bounds__(kThreads, 4)
    ssr_blur_kernel(const float* __restrict__ refl,
                    const float* __restrict__ depth,
                    const float* __restrict__ normal,
                    const float* __restrict__ sigma, int H, int w, int row0,
                    int h, float* __restrict__ out) {
  __shared__ float4 geo[kHalo];  // (n0, n1, n2, depth)
  __shared__ float rad[3][kHalo];

  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;  // band row of the tile's first row
  bool bad = false;
  for (int t = threadIdx.x; t < kHalo; t += kThreads) {
    const int hy = t / kHaloW;
    const int hx = t - hy * kHaloW;
    const int gy = min(max(row0 + y0 + hy - kR, 0), H - 1);
    const int gx = min(max(x0 + hx - kR, 0), w - 1);
    const int p = gy * w + gx;
    const float d = __ldg(depth + p);
    const float n0 = __ldg(normal + 3 * p), n1 = __ldg(normal + 3 * p + 1),
                n2 = __ldg(normal + 3 * p + 2);
    const float q0 = __ldg(refl + 3 * p), q1 = __ldg(refl + 3 * p + 1),
                q2 = __ldg(refl + 3 * p + 2);
    geo[t] = make_float4(n0, n1, n2, d);
    rad[0][t] = q0;
    rad[1][t] = q1;
    rad[2][t] = q2;
    bad |= !(isfinite(d) && isfinite(q0) && isfinite(q1) && isfinite(q2));
  }
  const bool every_tap = __syncthreads_or(bad);

  const int tx = threadIdx.x % kTileW;
  const int ty = threadIdx.x / kTileW;
  const int x = x0 + tx;
  const int y = y0 + ty;
  if (x >= w || y >= h) return;

  const float s = __ldg(sigma + y * w + x);
  const float rp = floorf(3.0f * s - 0.01f);
  const float e = 2.0f * s * s;
  const int centre = (ty + kR) * kHaloW + tx + kR;
  const float4 c = geo[centre];
  const float dc = c.w;
  const float dabs = nan_max(fabsf(dc), 1e-20f);

  Sums acc = {0.0f, 0.0f, 0.0f, 0.0f};
  if (!every_tap) {
    // the taps inside the radius; |i| <= rp for an integer-valued rp
    const int r = rp >= (float)kR ? kR : (rp >= 0.0f ? (int)rp : -1);
    for (int j = -r; j <= r; ++j) {
      const int row = centre + j * kHaloW;
      for (int i = -r; i <= r; ++i) {
        tap(acc, geo[row + i], &rad[0][row], &rad[1][row], &rad[2][row], i,
            j, dc, dabs, c.x, c.y, c.z, e);
      }
    }
  } else {
    // every tap, in order; outside the radius the weight is +0
    for (int j = -kR; j <= kR; ++j) {
      const int row = centre + j * kHaloW;
      const bool in_j = fabsf((float)j) <= rp;
      for (int i = -kR; i <= kR; ++i) {
        if (in_j && fabsf((float)i) <= rp) {
          tap(acc, geo[row + i], &rad[0][row], &rad[1][row], &rad[2][row],
              i, j, dc, dabs, c.x, c.y, c.z, e);
        } else {
          acc.c0 = acc.c0 + rad[0][row + i] * 0.0f;
          acc.c1 = acc.c1 + rad[1][row + i] * 0.0f;
          acc.c2 = acc.c2 + rad[2][row + i] * 0.0f;
        }
      }
    }
  }
  const float den = nan_max(acc.w, (kFloorScale * s) * s);
  float* o = out + 3 * (y * w + x);
  o[0] = acc.c0 / den;
  o[1] = acc.c1 / den;
  o[2] = acc.c2 / den;
}

}  // namespace

// out (h, w, 3) = the blurred colour of rows [row0, row0 + h) of a frame
// of H rows: refl (H, w, 3), depth (H, w) and the decoded normals (H, w, 3)
// of the whole frame, sigma (h, w) of the band, all float32 and
// contiguous. Returns a cudaError_t.
extern "C" int vkr_ssr_blur(const float* refl, const float* depth,
                            const float* normal, const float* sigma, int H,
                            int w, int row0, int h, float* out,
                            void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  ssr_blur_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      refl, depth, normal, sigma, H, w, row0, h, out);
  return (int)cudaGetLastError();
}
