// Native asset-pipeline runtime for vkr_tpu_torch: the port's own copy of
// vkr_tpu/native/asset_pipeline.cpp, same entry points, ABI version 1.
//
// The reference's scene layer is C++ (src/scene/: tiny_gltf mesh merging,
// stb image decode, blit-chain mip generation). The data-preparation hot
// paths stay native: box-filter mip pyramids, bilinear RGBA8 resize, and
// the triangle/vertex stream compiler that instance-expands glTF
// primitives, and the node-transform bake. Exposed C ABI, consumed via
// ctypes (vkr_tpu_torch/native/__init__.py), which builds this file with
// the host compiler at first use.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// 2x2 box-filter one mip level: (n, s, s, 4) u8 -> (n, s/2, s/2, 4) u8.
// Rounding matches scene/scene.py build_mip_pyramid_plain: (sum + 2) / 4.
void mip_downsample_rgba8(const uint8_t* src, uint8_t* dst, int64_t n,
                          int64_t size) {
  const int64_t half = size / 2;
  const int64_t src_row = size * 4;
  const int64_t src_img = size * src_row;
  const int64_t dst_img = half * half * 4;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* s = src + i * src_img;
    uint8_t* d = dst + i * dst_img;
    for (int64_t y = 0; y < half; ++y) {
      const uint8_t* r0 = s + (2 * y) * src_row;
      const uint8_t* r1 = r0 + src_row;
      for (int64_t x = 0; x < half; ++x) {
        const uint8_t* p00 = r0 + 8 * x;
        const uint8_t* p01 = p00 + 4;
        const uint8_t* p10 = r1 + 8 * x;
        const uint8_t* p11 = p10 + 4;
        for (int c = 0; c < 4; ++c) {
          d[(y * half + x) * 4 + c] = static_cast<uint8_t>(
              (static_cast<uint32_t>(p00[c]) + p01[c] + p10[c] + p11[c] +
               2) /
              4);
        }
      }
    }
  }
}

// Bilinear resize (H, W, 4) u8 -> (h2, w2, 4) u8 (half-texel centers,
// clamp-to-edge), used at texture-array build (scene.py _resize_rgba).
void resize_rgba8(const uint8_t* src, int64_t h, int64_t w, uint8_t* dst,
                  int64_t h2, int64_t w2) {
  for (int64_t y = 0; y < h2; ++y) {
    float fy = (y + 0.5f) * h / h2 - 0.5f;
    int64_t y0 = static_cast<int64_t>(std::floor(fy));
    float ty = fy - y0;
    int64_t y0c = std::clamp<int64_t>(y0, 0, h - 1);
    int64_t y1c = std::clamp<int64_t>(y0 + 1, 0, h - 1);
    for (int64_t x = 0; x < w2; ++x) {
      float fx = (x + 0.5f) * w / w2 - 0.5f;
      int64_t x0 = static_cast<int64_t>(std::floor(fx));
      float tx = fx - x0;
      int64_t x0c = std::clamp<int64_t>(x0, 0, w - 1);
      int64_t x1c = std::clamp<int64_t>(x0 + 1, 0, w - 1);
      const uint8_t* p00 = src + (y0c * w + x0c) * 4;
      const uint8_t* p01 = src + (y0c * w + x1c) * 4;
      const uint8_t* p10 = src + (y1c * w + x0c) * 4;
      const uint8_t* p11 = src + (y1c * w + x1c) * 4;
      for (int c = 0; c < 4; ++c) {
        float top = p00[c] + (p01[c] - p00[c]) * tx;
        float bot = p10[c] + (p11[c] - p10[c]) * tx;
        float v = top + (bot - top) * ty;
        dst[(y * w2 + x) * 4 + c] =
            static_cast<uint8_t>(std::clamp(v + 0.5f, 0.0f, 255.0f));
      }
    }
  }
}

// Instance-expand triangles: for each of n_idx/3 triangles of a primitive
// whose indices are relative, emit absolute vertex ids (+v_base) and the
// material id — the inner loop of compile_scene.
void expand_triangles(const uint32_t* indices, int64_t n_idx,
                      int32_t v_base, int32_t material, int32_t* out_tri,
                      int32_t* out_mat) {
  const int64_t n_tri = n_idx / 3;
  for (int64_t t = 0; t < n_tri; ++t) {
    out_tri[3 * t + 0] = static_cast<int32_t>(indices[3 * t + 0]) + v_base;
    out_tri[3 * t + 1] = static_cast<int32_t>(indices[3 * t + 1]) + v_base;
    out_tri[3 * t + 2] = static_cast<int32_t>(indices[3 * t + 2]) + v_base;
    out_mat[t] = material;
  }
}

// Apply a 4x4 row-major transform to positions (V, 3) f32 (w=1) — the
// host-side node-hierarchy flatten (update_scene analog) for baking.
void transform_points(const float* m, const float* src, int64_t n,
                      float* dst) {
  for (int64_t i = 0; i < n; ++i) {
    const float x = src[3 * i], y = src[3 * i + 1], z = src[3 * i + 2];
    dst[3 * i + 0] = m[0] * x + m[1] * y + m[2] * z + m[3];
    dst[3 * i + 1] = m[4] * x + m[5] * y + m[6] * z + m[7];
    dst[3 * i + 2] = m[8] * x + m[9] * y + m[10] * z + m[11];
  }
}

// Pack a mip pyramid into the flat texture layout consumed by
// the uniform texture array: per texture, mips concatenated.
void pack_flat_mips(const uint8_t* const* mips, const int64_t* sizes,
                    int64_t n_levels, int64_t n_tex, uint8_t* dst) {
  int64_t flat_len = 0;
  for (int64_t l = 0; l < n_levels; ++l) flat_len += sizes[l] * sizes[l];
  for (int64_t t = 0; t < n_tex; ++t) {
    uint8_t* out = dst + t * flat_len * 4;
    for (int64_t l = 0; l < n_levels; ++l) {
      const int64_t texels = sizes[l] * sizes[l];
      std::memcpy(out, mips[l] + t * texels * 4, texels * 4);
      out += texels * 4;
    }
  }
}

int32_t vkr_native_abi_version() { return 1; }

}  // extern "C"
