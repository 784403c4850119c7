// R1: any-hit ray queries against the uniform triangle grid, the rayQuery
// analog behind ray-traced GTAO (passes/gtao.py:gtao_rt).
//
// Replaces vkr_tpu/scene/accel.py:140 ray_any_hit. vkr_tpu has no Pallas
// kernel for it: it computes the walk in jnp inside a lax.fori_loop over a
// static max_steps, every ray through every step, so that the RT frame
// traces like any other. The port's plain version
// (scene/accel.py:ray_any_hit_reference) compacts the live rays at every
// DDA step, which a CUDA graph cannot record; this kernel gives the same
// hits from a launch of fixed shape, so the captured frame holds it.
//
// One thread per ray. Each thread walks its ray through the same 3-D DDA as
// the plain version, up to max_steps cells, and tests each cell's filled
// slots with Moller-Trumbore. It stops where the plain version stops
// carrying the ray: on a hit, when the next cell lies outside the grid, or
// when the segment ends before it (tmin > t_max). vkr_tpu walks such a ray
// on, but nothing it does after that reaches the result, so the early exit
// is exact.
//
// What bounds it on this card: instruction issue and latency, not bytes
// and not the float32 rate. At 1080p gtao_rt traces 8 calls of 4,147,200
// rays (540 x 960 pixels x 8 directions) of 0.2 world units, in cells of
// ~2.5 units: a ray reads 24 bytes, writes 1 and tests ~19 slots, and a
// slot test is loads, an IEEE division, compares and branches more than
// it is arithmetic (about 78 SASS instructions a test; chip_smoke.py
// prints the count and the instruction-issue estimate). What the design
// does about it:
//  * slot records (scene/accel.py:slot_records): for every filled slot, in
//    cell order, v0, e1 = v1 - v0 and e2 = v2 - v0 as three 16-byte loads,
//    and each cell's (first record, filled slots). A test loads its
//    triangle in three vector loads with no dependent id load, does not
//    form the edges (the table holds the same float32 subtractions), and
//    the empty slots cost nothing. The 1080p colonnade's table is 553 KB,
//    which stays in L2.
//  * exact early exits inside the test: a miss is settled after det
//    (|det| < 1e-20 or NaN); before the division where a = dot3(s, p)
//    puts u = a * (1 / det) out of [0, 1] for certain (|a| > |det| (1 +
//    2^-20): the two roundings of u cannot bring it back to 1; a and det
//    of opposite signs with |a| > |det| 2^-50: u < 0 and too large to round
//    to -0.0, which would pass u >= 0); after u (u < 0, u > 1 or NaN: u + v
//    rounds monotonically, so u > 1 fails u + v <= 1 for any v >= 0); and
//    after v. 86% of the 1080p RT frame's slot tests end before the
//    division.
//  * occupancy: __launch_bounds__ keeps the kernel at 40 registers, twelve
//    blocks of 128 threads (48 warps) on an SM, so the latency of a test's
//    dependent chain (loads, the fma chains, the division) is hidden; the
//    small blocks free their slot sooner when their rays end unevenly.
//  * lanes in ray order: thread i takes ray i, so a warp holds 4 pixels x
//    8 directions of gtao_rt's rays, which start in one cell. Measured
//    against a warp of 32 pixels of one direction, ray order keeps more
//    lanes busy (slot tests / (32 x a warp's most): 0.77 against 0.65 on
//    RT frame 1) and ran faster.
// A warp-cooperative form (a division-free mask of the cell's slots, then
// the masked (ray, slot) pairs shared out over the warp) ran slower: the
// pairs left after the mask are too few to pay for the sharing.

// Arithmetic, so that the hits equal the plain version's bit for bit:
// built with -fmad=false and IEEE division; every product and sum rounds
// on its own, except where the plain version calls mathlib/brdf.py:_fma
// (cross and dot3, the form XLA compiles vkr_tpu's loop body into), where
// this file calls fmaf. _fma rounds twice (a float64 sum, then float32);
// fmaf rounds once, as XLA's fma does, so the two differ only where the
// float64 sum falls exactly on a float32 tie. The entry cell takes
// floor, the saturating cast (a NaN gives cell 0, as PyTorch's cast of NaN
// and the clamp at 0 do), and the clamp to [0, dims - 1]; the comparisons
// with 1e-20 and 1e-12 are float32 ones, as PyTorch makes them for a
// Python scalar. The axis step takes the first of equal t_next (argmin); a
// NaN t_next makes the plain version's amin NaN, and the ray leaves the
// walk after testing its cell.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlocksPerSM = 12;  // at most 40 registers a thread

// Moller-Trumbore any-hit for t in (1e-12, tm) of the triangle whose record
// is (v0, e1, e2): the plain version's _tri_hit_mask, operation for
// operation, leaving as soon as the result is a miss.
__device__ __forceinline__ bool tri_hit(const float4 v0, const float4 e1,
                                        const float4 e2, float o0, float o1,
                                        float o2, float d0, float d1,
                                        float d2, float tm) {
  // p = cross(d, e2); component i is fma(a_j, b_k, -(a_k * b_j))
  const float p0 = fmaf(d1, e2.z, -(d2 * e2.y));
  const float p1 = fmaf(d2, e2.x, -(d0 * e2.z));
  const float p2 = fmaf(d0, e2.y, -(d1 * e2.x));
  // det = dot3(e1, p): an fma chain from the first product
  const float det = fmaf(e1.z, p2, fmaf(e1.y, p1, e1.x * p0));
  // the |det| >= 1e-20 guard (false for a NaN): nothing else can hit
  const float ad = fabsf(det);
  if (!(ad >= 1e-20f)) return false;
  const float s0 = o0 - v0.x, s1 = o1 - v0.y, s2 = o2 - v0.z;
  const float a = fmaf(s2, p2, fmaf(s1, p1, s0 * p0));
  // u = a * (1 / det) out of [0, 1] for certain, before the division: |u|
  // > 1, or u < 0 too far from 0 to round to -0.0 (a NaN a goes on)
  const float aa = fabsf(a);
  if (aa > ad * 1.00000095367431640625f) return false;
  if (((__float_as_uint(a) ^ __float_as_uint(det)) >> 31) &&
      aa > ad * 0x1p-50f)
    return false;
  const float inv = 1.0f / det;
  const float u = a * inv;
  if (!(u >= 0.0f) || u > 1.0f) return false;
  // q = cross(s, e1)
  const float q0 = fmaf(s1, e1.z, -(s2 * e1.y));
  const float q1 = fmaf(s2, e1.x, -(s0 * e1.z));
  const float q2 = fmaf(s0, e1.y, -(s1 * e1.x));
  const float vv = fmaf(d2, q2, fmaf(d1, q1, d0 * q0)) * inv;
  if (!(vv >= 0.0f) || !(u + vv <= 1.0f)) return false;
  const float t = fmaf(e2.z, q2, fmaf(e2.y, q1, e2.x * q0)) * inv;
  return t > 1e-12f && t < tm;
}

// The DDA's set-up on one axis: the entry cell, the step, the t of the
// next boundary and the t between boundaries.
__device__ __forceinline__ void axis_setup(float o, float d, float gmin,
                                           float cell, int dim, int* ic,
                                           int* step, float* t_next,
                                           float* dt) {
  const bool small = fabsf(d) < 1e-20f;
  const float inv = small ? 1e20f : 1.0f / (d == 0.0f ? 1.0f : d);
  const float f = floorf((o - gmin) / cell);
  // clamp(-1, 2^24) then the cast; NaN casts to a value the clamp at 0
  // takes to 0
  int c = isnan(f) ? 0 : (int)fminf(fmaxf(f, -1.0f), 16777216.0f);
  c = min(max(c, 0), dim - 1);
  *ic = c;
  *step = d >= 0.0f ? 1 : -1;
  const float next_b = (float)(c + (d >= 0.0f ? 1 : 0));
  const float tn = ((next_b * cell + gmin) - o) * inv;
  *t_next = small ? 1e20f : tn;
  *dt = fabsf(cell * inv);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    ray_any_hit_kernel(const float* __restrict__ orig,
                       const float* __restrict__ dir, float t_max,
                       const float* __restrict__ t_max_ray, int t_max_stride,
                       int n, const float4* __restrict__ records,
                       const int2* __restrict__ spans,
                       const float* __restrict__ grid_min,
                       const float* __restrict__ cell_size, int sx, int sy,
                       int sz, int max_steps,
                       unsigned char* __restrict__ hit) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long r = 3 * (long long)i;
  const float o0 = orig[r], o1 = orig[r + 1], o2 = orig[r + 2];
  const float d0 = dir[r], d1 = dir[r + 1], d2 = dir[r + 2];
  const float tm = t_max_ray != nullptr
                       ? __ldg(t_max_ray + (long long)i * t_max_stride)
                       : t_max;

  int ix, iy, iz, stx, sty, stz;
  float tx, ty, tz, dtx, dty, dtz;
  axis_setup(o0, d0, __ldg(grid_min), __ldg(cell_size), sx, &ix, &stx, &tx,
             &dtx);
  axis_setup(o1, d1, __ldg(grid_min + 1), __ldg(cell_size + 1), sy, &iy,
             &sty, &ty, &dty);
  axis_setup(o2, d2, __ldg(grid_min + 2), __ldg(cell_size + 2), sz, &iz,
             &stz, &tz, &dtz);

  const int flat_dim = sx * sy * sz;
  bool h = false;
  for (int s = 0; s < max_steps; ++s) {
    const int flat = min(max((iz * sy + iy) * sx + ix, 0), flat_dim - 1);
    const int2 span = __ldg(spans + flat);  // (first record, filled slots)
    const float4* rec = records + 3 * (long long)span.x;
    for (int j = 0; j < span.y; ++j, rec += 3) {
      if (tri_hit(__ldg(rec), __ldg(rec + 1), __ldg(rec + 2), o0, o1, o2,
                  d0, d1, d2, tm)) {
        h = true;
        break;
      }
    }
    if (h) break;
    // a NaN makes the plain version's amin NaN: tmin <= t_max fails
    if (isnan(tx) || isnan(ty) || isnan(tz)) break;
    // argmin of t_next, ties to the first axis
    float tmin = tx;
    int ax = 0;
    if (ty < tmin) { tmin = ty; ax = 1; }
    if (tz < tmin) { tmin = tz; ax = 2; }
    bool inside;
    if (ax == 0) {
      ix += stx;
      tx = tx + dtx;
      inside = ix >= 0 && ix < sx;
    } else if (ax == 1) {
      iy += sty;
      ty = ty + dty;
      inside = iy >= 0 && iy < sy;
    } else {
      iz += stz;
      tz = tz + dtz;
      inside = iz >= 0 && iz < sz;
    }
    if (!inside || !(tmin <= tm)) break;
  }
  hit[i] = h ? 1 : 0;
}

}  // namespace

// hit[i] = 1 where ray i (orig/dir: (n, 3) float32) hits a triangle of the
// grid for t in (1e-12, t_max), where t_max is t_max_ray[i * t_max_stride]
// (a stride of 1 per ray, 0 for one value on the card), or the number t_max
// when t_max_ray is null. records: (rows, 3) float4 slot records, spans:
// (cells) int2 (first record, filled slots), both
// scene/accel.py:slot_records. Returns a cudaError_t.
extern "C" int vkr_ray_any_hit(const float* orig, const float* dir,
                               float t_max, const float* t_max_ray,
                               int t_max_stride, int n, const void* records,
                               const void* spans, const float* grid_min,
                               const float* cell_size, int sx, int sy,
                               int sz, int max_steps, unsigned char* hit,
                               void* stream) {
  if (n <= 0) return 0;
  ray_any_hit_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(
      orig, dir, t_max, t_max_ray, t_max_stride, n,
      (const float4*)records, (const int2*)spans, grid_min, cell_size, sx,
      sy, sz, max_steps, hit);
  return (int)cudaGetLastError();
}
