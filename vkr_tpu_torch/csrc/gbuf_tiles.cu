// K1: merged tile raster + attribute resolve for the G-buffer, and K7: the
// same tile walk without the resolve (visibility only: depth and tri id).
//
// K1 replaces vkr_tpu/raster/gbuf_kernel.py:_gbuf_kernel (wrapper
// gbuf_tiles); K7 replaces vkr_tpu/raster/kernel.py:_raster_kernel (wrapper
// rasterize_tiles), which the shadow-map pass uses. Both run the same walk;
// K7 passes no peel floor and takes the visibility-only resolve.
//
// The function: per screen tile, the tile's binned pair segment in order;
// each pair gives edge-function coverage, a depth plane and a LESS_OR_EQUAL
// test with an optional strict peel floor. The winning pair's resolve
// planes (perspective denominator, 9 attribute/w planes, material id) are
// evaluated once per pixel at the end.
//
// What bounds it on this card: issue slots and the longest segments. The
// walk is arithmetic on values every pixel of a tile shares; at 1080p the
// opaque phase holds 387,496 (tile, triangle) pairs against 8x128-pixel
// tiles, 4e8 pair-pixel tests if every pixel tests every pair, while most
// of the colonnade's triangles cover a few pixels of their tile. Segments
// run from 2 to 15,845 pairs (median 6, mean 191), so one block per tile
// leaves the card waiting on its longest tiles. Global traffic is small: each
// pair's 48 raster bytes per cell, the outputs once per pixel.
//
// What the design does about it:
// 1. Balanced work items, no host sync. prep_kernel's block 0 cuts every
//    tile's segment into chunks of kChunk pairs, times the 8x128 cells of
//    a larger tile, and writes each tile's first item index. A persistent
//    grid of 256-thread blocks, as many as the SMs hold, takes items from
//    a global atomic counter. Each thread walks its pixels over the item's
//    pairs in order (d <= z: the minimum depth, the last pair among equal
//    depths). A cell whose segment is one chunk (most of them) resolves
//    its pixels right there. Otherwise the chunks merge per pixel into a
//    64-bit key, (canonical depth bits << 32) | (0xFFFFFFFF - pair row),
//    which orders as the in-order walk does: smaller depth first, then the
//    later row (rows ascend along a segment); -0.0 becomes +0.0 so the two
//    tie as d <= z ties them. prep_kernel empties such a cell's keys, every
//    chunk atomicMins into them, and the last chunk to finish, found
//    through a per-cell counter, resolves the cell. The resolve evaluates
//    the winner's depth plane again for zbuf: the winner's own bits, as
//    the in-order walk keeps them. A one-chunk cell's winners pass through
//    shared memory so that a warp stores 32 neighbouring pixels of a row;
//    a last chunk resolves in the walk's own layout, four pixels of a row
//    per lane as 16-byte stores. Both evaluate the same per-pixel resolve
//    helpers; only the stores differ.
// 2. Warp-uniform trivial reject. A warp owns an 8x16-pixel patch, four
//    pixels of one row per lane. Each lane tests one of 32 staged pairs
//    against the patch: an edge whose value at the patch's maximising
//    corner (picked by the signs of a and b) is below -margin excludes the
//    whole patch. The margin, (|a| X + |b| Y + |c|) 2^-20 + 2^-100 with X, Y
//    the patch's largest pixel centre, is above twice the rounding error of
//    plane() anywhere in the patch (at most about 3 ulp of that sum per
//    evaluation), so a pair that covers any pixel of the patch under
//    plane() is never skipped. A ballot of the survivors drives the warp's
//    loop over the pairs that can cover, so a rejected pair costs the warp
//    1/32 of one test.
// 3. Staging that overlaps testing. The raster fields (floats 0-11 of the
//    64-float row: three 16-byte pieces) of the next item are copied with
//    cp.async into the other half of a double buffer while the current
//    item is tested, and a thread reads one pair as three 16-byte shared
//    loads. 256-thread blocks keep the barriers small and several blocks
//    resident per SM.
//
// Arithmetic: every plane is evaluated as fma(a, px, b*py) + c — the
// contraction vkr_tpu's kernel gets from XLA — with an explicit fmaf, and
// the file is built with -fmad=false so nvcc contracts nothing else. The
// plain PyTorch version (gbuf_kernel.py) evaluates the same form, so the
// two agree bit for bit. Bounds are the plain segment [start, start+count);
// the TPU kernel's 8-row DMA alignment served only Mosaic.
//
// Band viewports (multi-device rendering, vkr_tpu's yoff_ref): y_offset is
// the first pixel row of the band in the full frame. The planes stay in
// full-frame coordinates, so every plane is evaluated at the global row
// y_offset + gy, while outputs, keys and the peel floor are indexed by the
// band-local row gy. A band that is not whole tile-rows (1080 / 4 = 270
// rows: 33 tile-rows of 8 and one of 6) bins nothing past its last row (the
// setup clamps the bbox to the band); the tile-aligned grid's two rows past
// it are evaluated like any others and cropped by the caller.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kRow = 64;        // floats per pair row (raster/pair_rows.py)
constexpr int kTriId = 12;      // row index of the triangle id
constexpr int kResolve = 16;    // first resolve field: denominator plane
constexpr int kChannels = 9;    // uv(2) normal(3) prev clip(4)
constexpr int kMaterial = 46;   // row index of the material id
constexpr int kChunk = 128;     // pairs per work item
constexpr int kThreads = 256;   // 8 warps: one 8x128 cell
constexpr int kCellH = 8, kCellW = 128;
constexpr int kPatchW = 16;     // a warp's patch: 8 rows x 16 columns
constexpr int kPixels = 4;      // pixels per lane, one row
constexpr unsigned long long kEmpty = ~0ull;  // no covering pair

__device__ __forceinline__ float plane(float a, float b, float c, float px,
                                       float py) {
  return fmaf(a, px, b * py) + c;
}

// True when e(x, y) = a x + b y + c is negative over the whole patch of
// pixel centres [x0, x1] x [y0, y1] (0 < x0 <= x1, 0 < y0 <= y1) beyond
// the rounding of plane(); NaN never rejects.
__device__ __forceinline__ bool edge_rejects(float a, float b, float c,
                                             float x0, float x1, float y0,
                                             float y1) {
  const float e = plane(a, b, c, a > 0.0f ? x1 : x0, b > 0.0f ? y1 : y0);
  const float m =
      ((fabsf(a) * x1 + fabsf(b) * y1) + fabsf(c)) * 0x1p-20f + 0x1p-100f;
  return e < -m;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Work items and scratch. A tile of tile_h x tile_w pixels is cut into
// 8x128 cells; a cell's segment into chunks of kChunk pairs, at least one
// (an empty segment still resolves the background). Item order: tile,
// then chunk, then cell. table = [item_start (n_tiles + 1) | counter |
// cell_done (n_tiles * n_cells)]: item_start[n_tiles] is the item count,
// counter the walk's next item, cell_done[c] the chunks of cell c merged.
__device__ __forceinline__ int chunks_of(int count) {
  return max(1, (count + kChunk - 1) / kChunk);
}

// Block 0: item_start by a running block-wide scan, counter = 0. Block
// 1 + c: cell c's done count = 0 and, where the cell has more than one
// chunk, its keys = kEmpty (one-chunk cells never touch their keys).
__global__ void __launch_bounds__(kThreads) prep_kernel(
    const int* __restrict__ seg_counts, int n_tiles, int tiles_x,
    int cells_x, int n_cells, int wp, int* __restrict__ table,
    unsigned long long* __restrict__ keys) {
  if (blockIdx.x > 0) {
    const int c = blockIdx.x - 1;
    const int tile = c / n_cells, cell = c - tile * n_cells;
    if (threadIdx.x == 0) table[n_tiles + 2 + c] = 0;
    if (chunks_of(seg_counts[tile]) == 1) return;
    const int cy = cell / cells_x, cx = cell - cy * cells_x;
    const int ty = tile / tiles_x, tx = tile - ty * tiles_x;
    const int tile_h_cells = n_cells / cells_x;
    const int gy = (ty * tile_h_cells + cy) * kCellH + (threadIdx.x >> 5);
    const int gx = (tx * cells_x + cx) * kCellW + (threadIdx.x & 31) * 4;
    ulonglong2* k = (ulonglong2*)(keys + (long long)gy * wp + gx);
    k[0] = k[1] = make_ulonglong2(kEmpty, kEmpty);
    return;
  }
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < n_tiles; base += kThreads) {
    const int t = base + threadIdx.x;
    const int v = t < n_tiles ? chunks_of(seg_counts[t]) * n_cells : 0;
    int incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int before = 0, all = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      before += w < warp ? warp_sums[w] : 0;
      all += warp_sums[w];
    }
    if (t < n_tiles) table[t] = carry + before + incl - v;
    carry += all;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    table[n_tiles] = carry;
    table[n_tiles + 1] = 0;
  }
}

struct Item {
  int row0;     // first pair row of the item
  int n;        // pairs in the item
  int gx0;      // the cell's first pixel column
  int gy0;      // the cell's first pixel row
  int cell;     // tile * n_cells + cell: the cell's done counter
  int chunks;   // chunks of the cell's segment
};

// The winner's outputs at a pixel centre, from its row w (null: the
// background, whose denominator plane is (0, 0, 1), channel planes 0 and
// material -1): depth from the winner's own plane (its bits, as the
// in-order walk keeps them), id, 1 / the perspective denominator, channel
// ch, material id.
__device__ __forceinline__ const float* winner_row(const float* pairs,
                                                   int win) {
  return win >= 0 ? pairs + (long long)win * kRow : nullptr;
}
__device__ __forceinline__ float depth_at(const float* w, float px,
                                          float py) {
  return w ? plane(w[9], w[10], w[11], px, py) : 1.0f;
}
__device__ __forceinline__ int id_of(const float* w) {
  return w ? (int)w[kTriId] : -1;
}
__device__ __forceinline__ float inv_denominator(const float* w, float px,
                                                 float py) {
  float den = w ? plane(w[kResolve], w[kResolve + 1], w[kResolve + 2], px, py)
                : 1.0f;
  if (fabsf(den) < 1e-20f) den = 1e-20f;
  return 1.0f / den;
}
__device__ __forceinline__ float channel_at(const float* w, int ch, float px,
                                            float py, float inv) {
  const float* c = w ? w + kResolve + 3 + 3 * ch : nullptr;
  return (c ? plane(c[0], c[1], c[2], px, py) : 0.0f) * inv;
}
__device__ __forceinline__ float material_of(const float* w) {
  return w ? w[kMaterial] : -1.0f;
}

// Pixel (gx, gy)'s outputs, one 4-byte store per plane. win < 0:
// background.
template <bool kWithResolve>
__device__ __forceinline__ void resolve(
    const float* __restrict__ pairs, int win, int gx, int gy, int y_offset,
    int wp, long long n_px, float* __restrict__ zbuf, int* __restrict__ tid,
    float* __restrict__ attrs) {
  const float px = (float)gx + 0.5f, py = (float)(gy + y_offset) + 0.5f;
  const long long pix = (long long)gy * wp + gx;
  const float* w = winner_row(pairs, win);
  zbuf[pix] = depth_at(w, px, py);
  tid[pix] = id_of(w);
  if (!kWithResolve) return;
  const float inv = inv_denominator(w, px, py);
  for (int ch = 0; ch < kChannels; ++ch)
    attrs[ch * n_px + pix] = channel_at(w, ch, px, py, inv);
  attrs[kChannels * n_px + pix] = material_of(w);
}

// A lane's four pixels (one row, columns gx..gx+3), one 16-byte store per
// plane, each plane's four values computed just before their store.
template <bool kWithResolve>
__device__ __forceinline__ void resolve4(
    const float* __restrict__ pairs, const int (&win)[kPixels], int gx,
    int gy, int y_offset, int wp, long long n_px, float* __restrict__ zbuf,
    int* __restrict__ tid, float* __restrict__ attrs) {
  const float py = (float)(gy + y_offset) + 0.5f;
  const long long pix = (long long)gy * wp + gx;
  const float* w[kPixels];
  float px[kPixels];
  for (int k = 0; k < kPixels; ++k) {
    px[k] = (float)(gx + k) + 0.5f;
    w[k] = winner_row(pairs, win[k]);
  }
  *(float4*)(zbuf + pix) =
      make_float4(depth_at(w[0], px[0], py), depth_at(w[1], px[1], py),
                  depth_at(w[2], px[2], py), depth_at(w[3], px[3], py));
  *(int4*)(tid + pix) =
      make_int4(id_of(w[0]), id_of(w[1]), id_of(w[2]), id_of(w[3]));
  if (!kWithResolve) return;
  float inv[kPixels];
  for (int k = 0; k < kPixels; ++k) inv[k] = inv_denominator(w[k], px[k], py);
  for (int ch = 0; ch < kChannels; ++ch)
    *(float4*)(attrs + ch * n_px + pix) =
        make_float4(channel_at(w[0], ch, px[0], py, inv[0]),
                    channel_at(w[1], ch, px[1], py, inv[1]),
                    channel_at(w[2], ch, px[2], py, inv[2]),
                    channel_at(w[3], ch, px[3], py, inv[3]));
  *(float4*)(attrs + kChannels * n_px + pix) =
      make_float4(material_of(w[0]), material_of(w[1]), material_of(w[2]),
                  material_of(w[3]));
}

template <bool kWithResolve>
__global__ void __launch_bounds__(kThreads) walk_kernel(
    const float* __restrict__ pairs, const int* __restrict__ seg_starts,
    const int* __restrict__ seg_counts, int* __restrict__ table, int n_tiles,
    const float* __restrict__ peel, int peel_h, int peel_w, int tiles_x,
    int tile_h, int tile_w, int cells_x, int n_cells, int wp, long long n_px,
    int y_offset, unsigned long long* __restrict__ keys,
    float* __restrict__ zbuf, int* __restrict__ tid,
    float* __restrict__ attrs) {
  __shared__ float4 stage[2][kChunk * 3];
  __shared__ Item items[2];
  __shared__ int item_ids[2];
  __shared__ int cell_win[kCellH * kCellW];  // winners in row-major order
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int total = table[n_tiles];
  int* counter = table + n_tiles + 1;
  int* cell_done = table + n_tiles + 2;

  // thread 0 takes the next item and decodes it into items[b]
  auto take = [&](int b) {
    const int item = atomicAdd(counter, 1);
    item_ids[b] = item;
    if (item >= total) return;
    int lo = 0, hi = n_tiles - 1;  // the last tile whose first item <= item
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (__ldg(table + mid) <= item) lo = mid; else hi = mid - 1;
    }
    const int local = item - __ldg(table + lo);
    const int chunk = local / n_cells, cell = local - chunk * n_cells;
    const int cy = cell / cells_x, cx = cell - cy * cells_x;
    const int ty = lo / tiles_x, tx = lo - ty * tiles_x;
    const int count = seg_counts[lo];
    Item it;
    it.row0 = seg_starts[lo] + chunk * kChunk;
    it.n = max(0, min(kChunk, count - chunk * kChunk));
    it.gx0 = tx * tile_w + cx * kCellW;
    it.gy0 = ty * tile_h + cy * kCellH;
    it.cell = lo * n_cells + cell;
    it.chunks = chunks_of(count);
    items[b] = it;
  };
  // every thread issues its share of the item's 16-byte pieces
  auto stage_item = [&](int b) {
    const Item& it = items[b];
    for (int i = threadIdx.x; i < it.n * 3; i += kThreads) {
      const int p = i / 3;
      cp_async16(&stage[b][i],
                 pairs + (long long)(it.row0 + p) * kRow + (i - p * 3) * 4);
    }
  };

  if (threadIdx.x == 0) take(0);
  __syncthreads();
  int b = 0;
  if (item_ids[0] < total) stage_item(0);
  cp_async_commit();

  const int r = lane >> 2;                               // row in the cell
  const int c0 = warp * kPatchW + (lane & 3) * kPixels;  // first column
  while (item_ids[b] < total) {
    if (threadIdx.x == 0) take(b ^ 1);
    __syncthreads();  // items[b ^ 1] visible; stage[b ^ 1] free again
    if (item_ids[b ^ 1] < total) stage_item(b ^ 1);
    // read before the barrier: thread 0 refills items[b] once past it
    const Item it = items[b];
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // stage[b] complete for every thread

    const int gy = it.gy0 + r, gx = it.gx0 + c0;
    const float py = (float)(gy + y_offset) + 0.5f;
    float px[kPixels], floor_d[kPixels], z[kPixels];
    int win[kPixels];
    for (int k = 0; k < kPixels; ++k) {
      px[k] = (float)(gx + k) + 0.5f;
      // the peel floor: only fragments strictly behind it survive; -1
      // (none) outside peel_depth
      floor_d[k] = peel && gy < peel_h && gx + k < peel_w
                       ? peel[(long long)gy * peel_w + gx + k]
                       : -1.0f;
      z[k] = 1.0f;  // depth clear
      win[k] = -1;
    }
    // the warp's patch of pixel centres, rows in full-frame coordinates
    const float x0 = (float)(it.gx0 + warp * kPatchW) + 0.5f;
    const float x1 = x0 + (float)(kPatchW - 1);
    const float y0 = (float)(it.gy0 + y_offset) + 0.5f;
    const float y1 = y0 + (float)(kCellH - 1);

    const float4* s = stage[b];
    for (int g = 0; g < it.n; g += 32) {
      bool keep = false;
      if (g + lane < it.n) {
        const float4 f0 = s[3 * (g + lane)], f1 = s[3 * (g + lane) + 1],
                     f2 = s[3 * (g + lane) + 2];
        // f0 = (a0 a1 a2 b0), f1 = (b1 b2 c0 c1), f2 = (c2 za zb zc)
        keep = !(edge_rejects(f0.x, f0.w, f1.z, x0, x1, y0, y1) ||
                 edge_rejects(f0.y, f1.x, f1.w, x0, x1, y0, y1) ||
                 edge_rejects(f0.z, f1.y, f2.x, x0, x1, y0, y1));
      }
      unsigned mask = __ballot_sync(0xffffffffu, keep);
      while (mask) {
        const int j = __ffs(mask) - 1;
        mask &= mask - 1;
        const int p = g + j;
        const float4 f0 = s[3 * p], f1 = s[3 * p + 1], f2 = s[3 * p + 2];
        const float b0 = f0.w * py, b1 = f1.x * py, b2 = f1.y * py,
                    bz = f2.z * py;
        for (int k = 0; k < kPixels; ++k) {
          const float e0 = fmaf(f0.x, px[k], b0) + f1.z;
          const float e1 = fmaf(f0.y, px[k], b1) + f1.w;
          const float e2 = fmaf(f0.z, px[k], b2) + f2.x;
          const float d = fmaf(f2.y, px[k], bz) + f2.w;
          if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && d >= 0.0f &&
              d <= 1.0f && d <= z[k] && d > floor_d[k]) {
            z[k] = d;
            win[k] = it.row0 + p;
          }
        }
      }
    }

    if (it.chunks == 1) {  // the whole segment was this item: resolve now
      // in row-major order, thread q of the block taking pixels q, q + 256,
      // ...: a warp writes 32 neighbouring pixels of a row per store
      for (int k = 0; k < kPixels; ++k) cell_win[r * kCellW + c0 + k] = win[k];
      __syncthreads();
      for (int q = threadIdx.x; q < kCellH * kCellW; q += kThreads)
        resolve<kWithResolve>(pairs, cell_win[q], it.gx0 + q % kCellW,
                              it.gy0 + q / kCellW, y_offset, wp, n_px, zbuf,
                              tid, attrs);
    } else {  // merge into the keys; the cell's last chunk resolves it
      unsigned long long* key = keys + (long long)gy * wp + gx;
      for (int k = 0; k < kPixels; ++k) {
        if (win[k] < 0) continue;
        // +0.0 for -0.0: the two tie, as d <= z ties them
        const unsigned bits = z[k] == 0.0f ? 0u : __float_as_uint(z[k]);
        atomicMin(key + k, ((unsigned long long)bits << 32) |
                               (0xFFFFFFFFu - (unsigned)win[k]));
      }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0)
        last = atomicAdd(cell_done + it.cell, 1) == it.chunks - 1;
      __syncthreads();
      if (last) {
        __threadfence();
        for (int k = 0; k < kPixels; ++k) {
          const unsigned long long v = __ldcg(key + k);
          win[k] = v == kEmpty ? -1 : (int)(0xFFFFFFFFu - (unsigned)v);
        }
        resolve4<kWithResolve>(pairs, win, gx, gy, y_offset, wp, n_px, zbuf,
                               tid, attrs);
      }
    }
    b ^= 1;
  }
}

template <bool kWithResolve>
int walk(const float* pairs, const int* seg_starts, const int* seg_counts,
         const float* peel, int peel_h, int peel_w, int tiles_x, int tiles_y,
         int tile_h, int tile_w, int y_offset, float* zbuf, int* tid,
         float* attrs, void* keys, int* table, cudaStream_t stream) {
  if (tile_h % kCellH || tile_w % kCellW) return (int)cudaErrorInvalidValue;
  const int n_tiles = tiles_x * tiles_y;
  const int wp = tiles_x * tile_w;
  const long long n_px = (long long)tiles_y * tile_h * wp;
  const int cells_x = tile_w / kCellW;
  const int n_cells = cells_x * (tile_h / kCellH);
  const auto k = (unsigned long long*)keys;
  prep_kernel<<<1 + n_tiles * n_cells, kThreads, 0, stream>>>(
      seg_counts, n_tiles, tiles_x, cells_x, n_cells, wp, table, k);
  // the persistent grid: every block the SMs hold at once
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, walk_kernel<kWithResolve>, kThreads, 0);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  walk_kernel<kWithResolve><<<blocks, kThreads, 0, stream>>>(
      pairs, seg_starts, seg_counts, table, n_tiles, peel, peel_h, peel_w,
      tiles_x, tile_h, tile_w, cells_x, n_cells, wp, n_px, y_offset, k, zbuf,
      tid, attrs);
  return (int)cudaGetLastError();
}

}  // namespace

// peel: the (peel_h, peel_w) depth-peel floor or null; pixels outside it
// have none. Scratch from the caller: keys, (hp * wp) 8-byte words; table,
// (n_tiles * (1 + (tile_h / 8) * (tile_w / 128)) + 2) ints. tile_h must
// be a multiple of 8 and tile_w of 128. y_offset: the band's first row in
// the full frame (0 for a whole frame).
extern "C" int vkr_gbuf_tiles(const float* pairs, const int* seg_starts,
                              const int* seg_counts, const float* peel,
                              int peel_h, int peel_w, int tiles_x,
                              int tiles_y, int tile_h, int tile_w,
                              int y_offset, float* zbuf, int* tid,
                              float* attrs, void* keys, int* table,
                              void* stream) {
  return walk<true>(pairs, seg_starts, seg_counts, peel, peel_h, peel_w,
                    tiles_x, tiles_y, tile_h, tile_w, y_offset, zbuf, tid,
                    attrs, keys, table, (cudaStream_t)stream);
}

extern "C" int vkr_rasterize_tiles(const float* pairs, const int* seg_starts,
                                   const int* seg_counts, int tiles_x,
                                   int tiles_y, int tile_h, int tile_w,
                                   int y_offset, float* zbuf, int* tid,
                                   void* keys, int* table, void* stream) {
  return walk<false>(pairs, seg_starts, seg_counts, nullptr, 0, 0, tiles_x,
                     tiles_y, tile_h, tile_w, y_offset, zbuf, tid, nullptr,
                     keys, table, (cudaStream_t)stream);
}
