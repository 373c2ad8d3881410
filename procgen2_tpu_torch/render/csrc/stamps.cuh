// Stamp placement shared by the port's Hopper kernels (scene_kernel.cu,
// stamp_kernel.cu): the bf16 rounding helpers, the stamp-group
// descriptors, `blend_stamps`, the device function that replaces the
// Pallas painter-order stamp loop (`_blend_stamps_ref` in
// procgen2_tpu/render/scene_kernel.py, `_kernel_blend`'s body in
// procgen2_tpu/render/stamp_kernel.py), and `sum_stamps`, the body of the
// Pallas stamp-sum kernel (`_kernel` in procgen2_tpu/render/stamp_kernel.py).
//
// Every multiply, subtract and add is computed in f32 and rounded to bf16
// (RNE) on its own, with __fmul_rn/__fsub_rn/__fadd_rn so that nothing is
// contracted into an FMA: that is the rounding of the plain torch versions
// and of the JAX package's bf16 ops. Build with --fmad=false as well.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace stamps {

constexpr int kMaxGroups = 4;

struct StampGroup {
  const __nv_bfloat16* bank;  // premultiplied [V, 4, P, P]
  const int32_t* var;         // [N, K]
  const float* scale;         // [N, K]
  const int32_t* r0;          // [N, K]
  const int32_t* c0;          // [N, K]
  int V, P, K;
};

// Up to kMaxGroups groups, passed to a kernel by value.
struct StampGroups {
  StampGroup g[kMaxGroups];
  int n;
};

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// frame = frame * (1 - a) + rgb, each op rounded to bf16
__device__ __forceinline__ void blend(float f[3], const float rgb[3],
                                      float a) {
  const float om = bf(__fsub_rn(1.0f, a));
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    f[ch] = bf(__fadd_rn(bf(__fmul_rn(f[ch], om)), rgb[ch]));
  }
}

// Calls fn(t, pp, s) for each slot of group g, in order, that covers
// pixel (r, c) of env e: a slot with scale == 0 or var outside [0, V) is
// skipped; bank[var] is placed at (r0, c0) clipped to [-P, obs]; t points
// at the pixel's texel in channel 0 of bank[var] (channel ch at
// t + ch * pp), s is the slot's scale. Inlined with its caller's fn, this
// is one loop with no per-slot call or pointer test.
template <typename Fn>
__device__ __forceinline__ void for_each_stamp(const StampGroup& g, int e,
                                               int r, int c, int obs,
                                               Fn fn) {
  const size_t row = (size_t)e * g.K;
  const int pp = g.P * g.P;
  for (int k = 0; k < g.K; ++k) {
    const float s = g.scale[row + k];
    const int v = g.var[row + k];
    if (s == 0.0f || v < 0 || v >= g.V) continue;
    const int dr = r - clampi(g.r0[row + k], -g.P, obs);
    const int dc = c - clampi(g.c0[row + k], -g.P, obs);
    if (dr < 0 || dr >= g.P || dc < 0 || dc >= g.P) continue;
    fn(g.bank + (size_t)v * 4 * pp + dr * g.P + dc, pp, s);
  }
}

// Painter-order stamps of one group over one pixel (r, c) of env e: under
// each covering slot (`for_each_stamp`) contrib = bf16(texel * scale) and
// frame = frame * (1 - a) + rgb.
__device__ __forceinline__ void blend_stamps(float f[3],
                                             const StampGroup& g, int e,
                                             int r, int c, int obs) {
  for_each_stamp(g, e, r, c, obs,
                 [&](const __nv_bfloat16* t, int pp, float s) {
                   float rgb[3];
#pragma unroll
                   for (int ch = 0; ch < 3; ++ch) {
                     rgb[ch] = bf(__fmul_rn(ld(t + ch * pp), s));
                   }
                   blend(f, rgb, bf(__fmul_rn(ld(t + 3 * pp), s)));
                 });
}

// Sum of the premultiplied stamps of one group at pixel (r, c) of env e
// into f[4] (rgb * a, a): under each covering slot (`for_each_stamp`)
// f[ch] = bf16(f[ch] + bf16(texel * scale)) for all four channels.
__device__ __forceinline__ void sum_stamps(float f[4], const StampGroup& g,
                                           int e, int r, int c, int obs) {
  for_each_stamp(g, e, r, c, obs,
                 [&](const __nv_bfloat16* t, int pp, float s) {
#pragma unroll
                   for (int ch = 0; ch < 4; ++ch) {
                     const float contrib = bf(__fmul_rn(ld(t + ch * pp), s));
                     f[ch] = bf(__fadd_rn(f[ch], contrib));
                   }
                 });
}

// Host side: fill a StampGroups from the per-group arrays of a plain C
// entry point. Returns false for a count the kernels do not take.
inline bool make_groups(StampGroups* out, int n_groups,
                        const void* const* banks, const void* const* vars,
                        const void* const* scales, const void* const* r0s,
                        const void* const* c0s, const int* Vs, const int* Ps,
                        const int* Ks) {
  if (n_groups < 0 || n_groups > kMaxGroups) return false;
  out->n = n_groups;
  for (int i = 0; i < n_groups; ++i) {
    StampGroup& g = out->g[i];
    g.bank = static_cast<const __nv_bfloat16*>(banks[i]);
    g.var = static_cast<const int32_t*>(vars[i]);
    g.scale = static_cast<const float*>(scales[i]);
    g.r0 = static_cast<const int32_t*>(r0s[i]);
    g.c0 = static_cast<const int32_t*>(c0s[i]);
    g.V = Vs[i];
    g.P = Ps[i];
    g.K = Ks[i];
  }
  return true;
}

}  // namespace stamps
