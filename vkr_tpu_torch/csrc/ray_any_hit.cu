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
// the plain version, up to max_steps cells, and tests each cell's cap slots
// with Moller-Trumbore. It stops where the plain version stops carrying the
// ray: on a hit, when the next cell lies outside the grid, or when the
// segment ends before it (tmin > t_max). vkr_tpu walks such a ray on, but
// nothing it does after that reaches the result, so the early exit is
// exact.
//
// What bounds it on this card: operations and latency, not bytes. At 1080p
// gtao_rt traces 8 calls of 4,147,200 rays (540 x 960 pixels x 8
// directions); a ray reads 24 bytes and writes 1, but tests up to
// max_steps x cap = 12 x 24 triangles of ~50 float32 operations each,
// every one after a dependent load of its id and its 36 bytes of vertices.
// The grid's tables stay in L2 (the 1080p colonnade's: 480 cells of 24
// slots, 46 KB, and 11 MB of triangle vertices).
// What the design does about it, for now: nothing beyond one thread per
// ray, consecutive threads on the consecutive rays of one pixel (its 8
// directions), so a warp's loads fall in few cells; the tables are read
// through the read-only path (__ldg). The walk state stays in registers
// (no indexed local arrays). Staging cells in shared memory and ordering
// the triangles are for a later change.
//
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

constexpr int kThreads = 256;

// Moller-Trumbore any-hit of triangle `id` for t in (1e-12, tm): the plain
// version's _tri_hit_mask, operation for operation.
__device__ __forceinline__ bool tri_hit(const float* __restrict__ tri_verts,
                                        int id, float o0, float o1, float o2,
                                        float d0, float d1, float d2,
                                        float tm) {
  const float* v = tri_verts + 9 * (long long)id;
  const float v00 = __ldg(v + 0), v01 = __ldg(v + 1), v02 = __ldg(v + 2);
  const float e10 = __ldg(v + 3) - v00, e11 = __ldg(v + 4) - v01,
              e12 = __ldg(v + 5) - v02;
  const float e20 = __ldg(v + 6) - v00, e21 = __ldg(v + 7) - v01,
              e22 = __ldg(v + 8) - v02;
  // p = cross(d, e2); component i is fma(a_j, b_k, -(a_k * b_j))
  const float p0 = fmaf(d1, e22, -(d2 * e21));
  const float p1 = fmaf(d2, e20, -(d0 * e22));
  const float p2 = fmaf(d0, e21, -(d1 * e20));
  // det = dot3(e1, p): an fma chain from the first product
  const float det = fmaf(e12, p2, fmaf(e11, p1, e10 * p0));
  // the |det| >= 1e-20 guard (false for a NaN): nothing else can hit
  if (!(fabsf(det) >= 1e-20f)) return false;
  const float inv = 1.0f / det;
  const float s0 = o0 - v00, s1 = o1 - v01, s2 = o2 - v02;
  const float u = fmaf(s2, p2, fmaf(s1, p1, s0 * p0)) * inv;
  // q = cross(s, e1)
  const float q0 = fmaf(s1, e12, -(s2 * e11));
  const float q1 = fmaf(s2, e10, -(s0 * e12));
  const float q2 = fmaf(s0, e11, -(s1 * e10));
  const float vv = fmaf(d2, q2, fmaf(d1, q1, d0 * q0)) * inv;
  const float t = fmaf(e22, q2, fmaf(e21, q1, e20 * q0)) * inv;
  return u >= 0.0f && vv >= 0.0f && u + vv <= 1.0f && t > 1e-12f && t < tm;
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

__global__ void __launch_bounds__(kThreads) ray_any_hit_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir,
    float tm, int n,
    const float* __restrict__ tri_verts, const int* __restrict__ cell_tris,
    const float* __restrict__ grid_min, const float* __restrict__ cell_size,
    int sx, int sy, int sz, int cap, int max_steps,
    unsigned char* __restrict__ hit) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long r = 3 * (long long)i;
  const float o0 = orig[r], o1 = orig[r + 1], o2 = orig[r + 2];
  const float d0 = dir[r], d1 = dir[r + 1], d2 = dir[r + 2];

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
    const int* slots = cell_tris + (long long)flat * cap;
    for (int j = 0; j < cap; ++j) {
      const int id = __ldg(slots + j);
      if (id >= 0 && tri_hit(tri_verts, id, o0, o1, o2, d0, d1, d2, tm)) {
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
// grid for t in (1e-12, t_max). Returns a cudaError_t.
extern "C" int vkr_ray_any_hit(const float* orig, const float* dir,
                               float t_max, int n,
                               const float* tri_verts, const int* cell_tris,
                               const float* grid_min, const float* cell_size,
                               int sx, int sy, int sz, int cap, int max_steps,
                               unsigned char* hit, void* stream) {
  if (n <= 0) return 0;
  ray_any_hit_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(
      orig, dir, t_max, n, tri_verts, cell_tris, grid_min,
      cell_size, sx, sy, sz, cap, max_steps, hit);
  return (int)cudaGetLastError();
}
