// Stamp-over-frame kernel for Hopper (sm_90a): K premultiplied P x P
// stamps per env alpha-blended OVER a given frame in slot (painter)
// order, for 1 to 4 stamp groups in one launch.
//
// Replaces the Pallas TPU kernel procgen2_tpu/render/stamp_kernel.py
// `_kernel_blend` (launched by `_composite`, entry `composite_tpu`, called
// from `compositor.composite_stamps`). One launch over several groups is
// the same as one call per group in order: per pixel, painter order runs
// through all slots of group 0, then group 1, and so on.
//
// What it computes, per env e and output pixel (r, c): the frame's three
// bf16 values, then, for each group in order, `blend_stamps` (stamps.cuh):
// each slot in order, skipped where scale == 0 or var is outside [0, V);
// bank[var] placed at (r0, c0) clipped to [-P, OBS]; under it
// contrib = bf16(texel * scale) and frame = bf16(bf16(frame * bf16(1 - a))
// + rgb), every op rounded on its own (no FMA).
//
// The TPU kernel's lane/sublane rolls, its tile-aligned W-row window and
// its f32 bank padded to 128 lanes answer TPU layout rules; what they
// compute is the placement above, so none of them is carried over.
//
// Design: one thread per output pixel, a block of 256 threads covers 4
// rows of one env, blockIdx.x is the env. Each pixel's blend chain is
// independent: no synchronisation, no shared memory. What bounds it on
// the card: the frame read and write (6 + 6 bytes per pixel, 100.7 MB
// each way at 4096 envs) and the per-slot scalar loads that every thread
// of a block repeats (var, scale, r0, c0: served from L1 as broadcasts);
// a thread under no stamp only tests bounds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stamps.cuh"

namespace {

using stamps::StampGroups;
using stamps::blend_stamps;
using stamps::ld;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
stamp_composite_kernel(const __nv_bfloat16* __restrict__ img,
                       const StampGroups groups,
                       __nv_bfloat16* __restrict__ out, int obs) {
  const int e = blockIdx.x;
  const int p = blockIdx.y * kThreads + threadIdx.x;
  const int npix = obs * obs;
  if (p >= npix) return;
  const int r = p / obs;
  const int c = p - r * obs;

  const size_t base = (size_t)e * 3 * npix + p;
  float f[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) f[ch] = ld(img + base + ch * npix);

  for (int gi = 0; gi < groups.n; ++gi) {
    blend_stamps(f, groups.g[gi], e, r, c, obs);
  }

#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    out[base + ch * npix] = __float2bfloat16_rn(f[ch]);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Tensor pointers are device
// pointers of contiguous tensors checked by the Python wrapper: img and
// out bf16 [N, 3, obs, obs]; the per-group arrays (n_groups entries) are
// host arrays. Returns 0, a cudaError_t, or -1 for a shape the kernel does
// not take.
extern "C" int stamp_composite_launch(
    const void* img, int n_groups, const void* const* banks,
    const void* const* vars, const void* const* scales,
    const void* const* r0s, const void* const* c0s, const int* Vs,
    const int* Ps, const int* Ks, void* out, int N, int obs, void* stream) {
  StampGroups groups;
  if (!stamps::make_groups(&groups, n_groups, banks, vars, scales, r0s, c0s,
                           Vs, Ps, Ks) ||
      N < 0 || obs <= 0) {
    return -1;
  }
  if (N == 0) return 0;
  const dim3 grid_dim(N, (obs * obs + kThreads - 1) / kThreads);
  stamp_composite_kernel<<<grid_dim, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(img), groups,
      static_cast<__nv_bfloat16*>(out), obs);
  return static_cast<int>(cudaGetLastError());
}
