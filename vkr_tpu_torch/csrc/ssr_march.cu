// The SSR hierarchical hi-Z march: one ray per lane, warps fed 8x4 patches.
//
// Replaces vkr_tpu/passes/ssr_march.py:_phase_a_kernel (K2, iterations 0-15
// at mip 0) and :_phase_b_kernel (K3, the hierarchical iterations), both
// behind hierarchical_march_pallas. Those split the march for Mosaic and the
// MXU: a 56x384 mip-0 window with a ring-shell prefetch, one-hot matmul
// gathers from bf16 hi+lo tables, compaction with drops. Here every ray runs
// the body of vkr_tpu's _hierarchical_march (passes/ssr.py:456-524) in a
// loop until it is done or reaches max_iterations, and no ray is dropped:
// the result is vkr_tpu's no-drop oracle (compact_frac=0.0) up to rounding.
//
// What bounds it on this card: issue slots and divergence, not bytes. Per
// ray and iteration about 60 float32 operations (several of them IEEE
// division and square-root sequences, as no fast math is allowed) and one
// data-dependent 4-byte load from the pyramid (10 levels, ~0.69 M texels,
// 2.8 MB at 1080p, resident in L2). Rays need from one to max_iterations
// iterations (at 1080p: median 28, mean 29.3, 1% at the cap of 80), and a
// warp runs as long as its longest ray: with 32 rays of one row, 61% of
// the lanes' slots did work.
// What the design does about it:
// 1. Patches of rays, balanced over warps. A persistent grid of 256-thread
//    blocks, as many as the SMs hold. Each warp takes an 8x4 patch of the
//    ray grid from a global atomic counter, marches its 32 rays, and takes
//    the next patch when the patch's longest ray ends. Neighbouring rays
//    end closer together than the rays of a row (70% of the lanes' slots
//    work), neighbouring lanes fetch neighbouring texels, and no warp waits
//    on a block's slowest warp. Refilling single lanes as their rays end
//    (a warp's pool of rays, refilled once 1 to 16 lanes were free) ran
//    slower on the H100: a warp then mixes rays at every stage, so the
//    horizon branch and a new ray's set-up diverge on most iterations.
// 2. Fewer instructions per iteration, no rounded value changed: the level
//    scale 2^-mip is built from its exponent bits (ldexpf costs two exp2
//    sequences per iteration); the horizon's vector and length run only
//    where mip <= 1, its three divisions and dot only where the length is
//    also below 0.3 (their only use); each ray's invariants are computed
//    once. The per-level table arrives by value, with no host-to-device
//    copy.
// Coarse pyramid levels in shared memory (levels >= 3, 44 KB per block)
// ran no faster on the H100 than reading them through __ldg, and levels
// >= 2 (173 KB, one block per SM) ran at half the speed, so every level is
// read through __ldg.
//
// Arithmetic: the plain PyTorch version (passes/ssr_march.py) rounds every
// operation as this file does (built with -fmad=false, no fast math: the
// 1e20/1e6 clips and the MAX_T guard rely on IEEE float32). PyTorch's
// scalar / tensor is reciprocal-then-multiply, so linearize_depth and the
// constant 0.005 / screen are written that way here too.

#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 256;
constexpr int kFindHorPrefix = 15;  // iterations 0..14 stay at mip 0
constexpr int kPatchW = 8, kPatchH = 4;  // a warp's 32 rays

struct Levels {
  int offset[kMaxLevels], width[kMaxLevels], height[kMaxLevels];
};

// torch.minimum / torch.maximum / torch.clamp: a NaN operand propagates
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tclamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__global__ void __launch_bounds__(kThreads, 2) ssr_march_kernel(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ camera_start, const float* __restrict__ w0,
    int ray_h, int ray_w, const float* __restrict__ flat, Levels levels,
    int n_levels, int screen_w, int screen_h, float tg,
    float aspect, float k_nf, float k_fn, float zfar, int max_iterations,
    float* __restrict__ out_pos, float* __restrict__ out_hor,
    int* __restrict__ out_iters, int* __restrict__ counter) {
  __shared__ int lv_off[kMaxLevels], lv_w[kMaxLevels], lv_h[kMaxLevels];
  if (threadIdx.x < n_levels) {
    lv_off[threadIdx.x] = levels.offset[threadIdx.x];
    lv_w[threadIdx.x] = levels.width[threadIdx.x];
    lv_h[threadIdx.x] = levels.height[threadIdx.x];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int patches_x = (ray_w + kPatchW - 1) / kPatchW;
  const int n_patches = patches_x * ((ray_h + kPatchH - 1) / kPatchH);
  const float sw = (float)screen_w, sh = (float)screen_h;
  // 0.005 * exp2(most_detailed_mip = 0) / screen (screen_trace.glsl:71);
  // PyTorch's scalar / tensor is reciprocal-then-multiply
  const float mag_x = (1.0f / sw) * 0.005f, mag_y = (1.0f / sh) * 0.005f;

  while (true) {
    // the warp's next 8x4 patch of rays
    int patch = 0;
    if (lane == 0) patch = atomicAdd(counter, 1);
    patch = __shfl_sync(0xffffffffu, patch, 0);
    if (patch >= n_patches) return;
    const int pyi = patch / patches_x;
    const int x = (patch - pyi * patches_x) * kPatchW + lane % kPatchW;
    const int y = pyi * kPatchH + lane / kPatchW;
    // no continue: every lane must reach the next __shfl_sync
    if (x < ray_w && y < ray_h) {
      const int ray = y * ray_w + x;

      const float ox = origin[3 * ray], oy = origin[3 * ray + 1],
                  oz = origin[3 * ray + 2];
      const float dx = direction[3 * ray], dy = direction[3 * ray + 1],
                  dz = direction[3 * ray + 2];
      const float cx = camera_start[3 * ray], cy = camera_start[3 * ray + 1],
                  cz = camera_start[3 * ray + 2];
      const float wx = w0[3 * ray], wy = w0[3 * ray + 1], wz = w0[3 * ray + 2];
      const float idx_ = dx != 0.0f ? 1.0f / dx : FLT_MAX;
      const float idy = dy != 0.0f ? 1.0f / dy : FLT_MAX;
      const float idz = dz != 0.0f ? 1.0f / dz : FLT_MAX;
      const float uox = dx < 0.0f ? -mag_x : mag_x;
      const float uoy = dy < 0.0f ? -mag_y : mag_y;
      const float fox = dx < 0.0f ? 0.0f : 1.0f;
      const float foy = dy < 0.0f ? 0.0f : 1.0f;

      // initial_advance_ray (screen_trace.glsl:8-15) at mip 0
      const float tx0 = ((floorf(sw * ox) + fox) / sw + uox - ox) * idx_;
      const float ty0 = ((floorf(sh * oy) + foy) / sh + uoy - oy) * idy;
      float t = tmin(tx0, ty0);
      float px = ox + t * dx, py = oy + t * dy, pz = oz + t * dz;

      int mip = 0, iters = 0;
      float hor = 0.0f;
      bool done = false, oob = false;
      for (int i = 0; i < max_iterations && !done; ++i) {
        // 2^-mip exactly, from its bits (0 <= mip <= max_iterations < 127):
        // the resolution of this level as the oracle sees it
        const float scale = __int_as_float((127 - mip) << 23);
        const float rx = sw * scale, ry = sh * scale;
        const float mx = rx * px, my = ry * py;
        const int m = min(max(mip, 0), n_levels - 1);
        // truncation toward zero, saturating: clamp the float first
        int xi = (int)tclamp(mx, -1.0f, 16777216.0f);
        int yi = (int)tclamp(my, -1.0f, 16777216.0f);
        xi = min(max(xi, 0), lv_w[m] - 1);
        yi = min(max(yi, 0), lv_h[m] - 1);
        const float sz = __ldg(flat + lv_off[m] + yi * lv_w[m] + xi);

        // advance_ray (screen_trace.glsl:17-45)
        const float t_x = ((floorf(mx) + fox) / rx + uox - ox) * idx_;
        const float t_y = ((floorf(my) + foy) / ry + uoy - oy) * idy;
        const float t_z = dz > 0.0f ? (sz - oz) * idz : FLT_MAX;
        const float t_min = tmin(tmin(t_x, t_y), t_z);
        const bool above = sz > pz;
        const bool skipped = (t_min != t_z) && above;
        const float nt = tclamp(above ? t_min : t, -1e20f, 1e20f);
        t = nt;
        px = ox + nt * dx;
        py = oy + nt * dy;
        pz = oz + nt * dz;
        if (i >= kFindHorPrefix) mip += skipped ? 1 : -1;

        // horizon estimate on fine mips (trace.comp:214-223):
        // reconstruct_view_vec(position.xy, surface_z) - camera_start
        if (mip <= 1) {
          const float z = (1.0f / (sz * k_fn - zfar)) * k_nf;
          const float vx = -(2.0f * px - 1.0f) * ((z * aspect) * tg) - cx;
          const float vy = -(2.0f * py - 1.0f) * (z * tg) - cy;
          const float vz = z - cz;
          const float vl = tmax(sqrtf((vx * vx + vy * vy) + vz * vz), 1e-20f);
          if (vl < 0.3f)
            hor = tmax(hor, (wx * (vx / vl) + wy * (vy / vl)) + wz * (vz / vl));
        }

        iters = i + 1;
        done = mip < 0;
        // a ray outside the screen moving further out never intersects again
        const bool out = (px < 0.0f && dx <= 0.0f) ||
                         (px > 1.0f && dx >= 0.0f) ||
                         (py < 0.0f && dy <= 0.0f) || (py > 1.0f && dy >= 0.0f);
        if (out && mip >= 0) done = oob = true;
      }

      out_iters[ray] = (done && !oob) ? iters : max_iterations + 1;
      const float p[3] = {px, py, pz};
      for (int k = 0; k < 3; ++k) {
        const float v = isfinite(p[k]) ? p[k] : 0.0f;
        out_pos[3 * ray + k] = fminf(fmaxf(v, -1e6f), 1e6f);
      }
      out_hor[ray] = hor;
    }
  }
}

}  // namespace

// levels: host array of 3 * n_levels ints (offsets, widths, heights),
// passed to the kernel by value; counter: one int of device scratch.
extern "C" int vkr_ssr_march(const float* origin, const float* direction,
                             const float* camera_start, const float* w0,
                             int ray_h, int ray_w, const float* flat,
                             const int* levels, int n_levels, int screen_w,
                             int screen_h, float tg, float aspect, float k_nf,
                             float k_fn, float zfar, int max_iterations,
                             float* out_pos, float* out_hor, int* out_iters,
                             int* counter, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (ray_h * ray_w == 0) return 0;
  Levels lv = {};
  for (int l = 0; l < n_levels; ++l) {
    lv.offset[l] = levels[l];
    lv.width[l] = levels[n_levels + l];
    lv.height[l] = levels[2 * n_levels + l];
  }
  // the persistent grid: every block the SMs hold at once
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ssr_march_kernel,
                                                  kThreads, 0);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  const auto s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  ssr_march_kernel<<<blocks, kThreads, 0, s>>>(
      origin, direction, camera_start, w0, ray_h, ray_w, flat, lv, n_levels,
      screen_w, screen_h, tg, aspect, k_nf, k_fn, zfar, max_iterations,
      out_pos, out_hor, out_iters, counter);
  return (int)cudaGetLastError();
}
