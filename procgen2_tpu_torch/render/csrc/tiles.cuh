// The two-pass tile resolver of physics/tiles.py (`_resolve_core`) for one
// rect, as device code: System_Tilemap::get_collision of the reference
// (`games/coinrun/tilemap.cpp:323-396`). Shared by the game-step kernels;
// each caller fetches the rect's 3x3 window of collision types itself.
//
// Every f32 operation is the plain version's, in its order: each add,
// subtract and multiply rounds on its own (the file that includes this is
// built with --fmad=false), min and max let a NaN through as torch.minimum
// and torch.maximum do, floor and ceil go to int32 as `.to(torch.int32)`
// does (cvt.rzi), and the cells are visited in the plain version's order,
// row by row.
#pragma once

#include <stdint.h>

namespace tiles {

constexpr uint32_t kNone = 0, kDownOnly = 2;  // tiles.py (FULL is 1)
constexpr int kWindow = 3;  // floor(x)..ceil(x + w) spans <= 3 tiles
constexpr int kLutIds = 16;  // a packed LUT holds tile ids 0..15

// torch.maximum / torch.minimum on f32: a NaN operand is the result (the
// first one if both are NaN).
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// f32 -> int32 as torch's `.to(torch.int32)` on the card.
__device__ __forceinline__ int to_i32(float v) { return __float2int_rz(v); }

// The collision type of tile `id` under `lut`, 2 bits per id (id i at bits
// 2i, 2i + 1): `_apply_lut`, where ids beyond the LUT are NONE.
__device__ __forceinline__ uint32_t lut_type(uint32_t lut, int id) {
  return (id >= 0 && id < kLutIds) ? (lut >> (2 * id)) & 3u : kNone;
}

// A rect and its edges as `_resolve_core` takes them: x_hi and y_hi stand
// in for x + w and y + h where the resolver adds them to the unmoved x and
// y, cx and cy are the centre.
struct Rect {
  float x, y, w, h, x_hi, y_hi, cx, cy;
};

// The rect of `resolve_tile_collisions` with the default edges
// (x + w, y + h, x + w * 0.5, y + h * 0.5); half_w and half_h are w * 0.5
// and h * 0.5 as Python computes them.
__device__ __forceinline__ Rect rect(float x, float y, float w, float h,
                                     float half_w, float half_h) {
  return Rect{x, y, w, h, x + w, y + h, x + half_w, y + half_h};
}

struct Resolved {
  float rx, ry;
  bool collided;
};

// `_resolve_core` for one rect whose window's top-left tile is (lx, ly) =
// (floor(x), floor(y)). `types` holds the window's collision types, 2 bits
// per cell, cell (dy, dx) at bits 2 * (3 * dy + dx). `fallthrough` and
// `step_y` drive the one-way tiles; `down_only_vy` is the 0.01 of their
// test, as torch rounds it.
__device__ __forceinline__ Resolved resolve(uint32_t types, int lx, int ly,
                                            const Rect& r, bool fallthrough,
                                            float step_y, float down_only_vy) {
  const int ux = to_i32(ceilf(r.x_hi));
  const int uy = to_i32(ceilf(r.y_hi));
  bool collided = false;

  // Pass 1: vertical resolution (tilemap.cpp:337-368)
  float ry = r.y;
#pragma unroll
  for (int dy = 0; dy < kWindow; ++dy) {
#pragma unroll
    for (int dx = 0; dx < kWindow; ++dx) {
      const int tx = lx + dx, ty = ly + dy;
      const uint32_t t = (types >> (2 * (kWindow * dy + dx))) & 3u;
      const float txf = (float)tx, tyf = (float)ty;
      const float ox = tmax(r.x, txf);
      const float oy = tmax(ry, tyf);
      const float ow = tmin(r.x_hi, txf + 1.0f) - ox;
      const float oh =
          tmin(dy + dx == 0 ? r.y_hi : ry + r.h, tyf + 1.0f) - oy;
      bool hit = tx <= ux && ty <= uy && t != kNone && ow > 0.0f &&
                 oh > 0.0f && ow > oh;
      // down_only: solid only when landing from above while moving down
      // without fallthrough (tilemap.cpp:353-360)
      const bool inside = (ry + r.h) - step_y > tyf;
      if (t == kDownOnly) {
        hit = hit && step_y > down_only_vy && !fallthrough && !inside;
      }
      const float oc_y = oy + oh * 0.5f;
      const float new_y = oc_y > r.cy ? tyf - r.h : tyf + 1.0f;
      if (hit) ry = new_y;
      collided = collided || hit;
    }
  }

  // Pass 2: horizontal resolution (tilemap.cpp:370-393)
  float rx = r.x;
#pragma unroll
  for (int dy = 0; dy < kWindow; ++dy) {
#pragma unroll
    for (int dx = 0; dx < kWindow; ++dx) {
      const int tx = lx + dx, ty = ly + dy;
      const uint32_t t = (types >> (2 * (kWindow * dy + dx))) & 3u;
      const float txf = (float)tx, tyf = (float)ty;
      const float ox = tmax(rx, txf);
      const float oy = tmax(ry, tyf);
      const float ow =
          tmin(dy + dx == 0 ? r.x_hi : rx + r.w, txf + 1.0f) - ox;
      const float oh = tmin(ry + r.h, tyf + 1.0f) - oy;
      const bool hit = tx <= ux && ty <= uy && t != kNone &&
                       t != kDownOnly && ow > 0.0f && oh > 0.0f && ow <= oh;
      const float oc_x = ox + ow * 0.5f;
      const float new_x = oc_x > r.cx ? txf - r.w : txf + 1.0f;
      if (hit) rx = new_x;
      collided = collided || hit;
    }
  }
  return Resolved{rx, ry, collided};
}

}  // namespace tiles
