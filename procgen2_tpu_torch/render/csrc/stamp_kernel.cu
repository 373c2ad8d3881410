// Stamp kernels for Hopper (sm_90a), one nvcc build:
//
// (B3) stamp_composite_kernel: K premultiplied P x P stamps per env
// alpha-blended OVER a given frame in slot (painter) order, for 1 to 4
// stamp groups in one launch. Replaces the Pallas TPU kernel
// procgen2_tpu/render/stamp_kernel.py `_kernel_blend` (launched by
// `_composite`, entry `composite_tpu`, called from
// `compositor.composite_stamps`). One launch over several groups is the
// same as one call per group in order: per pixel, painter order runs
// through all slots of group 0, then group 1, and so on.
// Per env e and output pixel (r, c): the frame's three bf16 values, then,
// for each group in order, each slot in order (the semantics of
// `blend_stamps` in stamps.cuh), skipped where scale == 0 or var is
// outside [0, V); bank[var] placed at (r0, c0) clipped to [-P, OBS]; under it
// contrib = bf16(texel * scale) and frame = bf16(bf16(frame * bf16(1 - a))
// + rgb), every op rounded on its own (no FMA).
//
// (B4) stamp_sum_kernel: the K premultiplied stamps of one group summed
// into a zeroed 4-channel frame (rgb * a, a). Replaces the Pallas TPU
// kernel procgen2_tpu/render/stamp_kernel.py `_kernel` (launched by
// `_stamps`, entry `stamps_tpu`, called from
// `compositor.stamps_from_pixel_bank`). Per env e and output pixel
// (r, c): four zeros, then `sum_stamps` (stamps.cuh): the same slot skip
// and placement as B3; under the stamp f[ch] = bf16(f[ch] +
// bf16(texel * scale)) in slot order.
//
// The TPU kernels' lane/sublane rolls, their tile-aligned W-row window and
// their f32 bank padded to 128 lanes answer TPU layout rules; what they
// compute is the placement above, so none of them is carried over.
//
// Design of B3 (redesigned for Hopper; before, it was B4's design below,
// one thread per pixel running `blend_stamps`): the bound is bytes, the
// frame read and written once (6 + 6 bytes per pixel, 100.7 MB each way at
// 4096 envs). The per-pixel design spent its time elsewhere: every thread
// decoded every slot of all four groups (62 for bossfight: four dependent
// loads, two clamps and a bounds test each, per pixel), a warp spanned 8
// full rows so that a small stamp kept few of its lanes busy, and the
// frame moved 2 bytes at a time. Now one block of 256 threads owns an
// env, each warp a 16 x 16 pixel region and each lane an 8-pixel run of
// one row (stamps.cuh), and
//   * the run's three channel rows are read as 16-byte vectors before the
//     slot table is staged, so that both sets of loads are in flight
//     together, and written back the same way. An asynchronous copy of
//     the next env's frame (TMA `cp.async.bulk` or `cp.async`) was not
//     built: 4 resident blocks per SM (64 registers) already overlap one
//     env's loads with another's blends, and the time beyond the bound is
//     in the blends (PERF.md);
//   * the env's slot table is decoded once, into shared memory
//     (`stage_slots`: coalesced loads, the skip test, the clip, a cull of
//     slots wholly off the frame, compaction of the live ones in painter
//     order; a table over 256 slots in passes);
//   * a slot is tested once per warp region (no divergence) and once per
//     run, and blends only the pixels it covers (`blend_slots`).
// No tensor cores: the work is a chain of separately rounded bf16 blends
// per pixel, not a product. What remains beyond the bytes is the blends
// themselves (the lanes of a warp under no stamp wait for those under
// one) and the staging's two barriers per env.
//
// Design of B4 (unchanged): one thread per output pixel, a block of 256
// threads covers 4 rows of one env, blockIdx.x is the env; no
// synchronisation, no shared memory. What bounds it: it only writes its
// 4-channel frame (8 bytes per pixel, 134.2 MB at 4096 envs); it repeats
// the per-slot scalar loads in every thread of a block (var, scale, r0,
// c0: served from L1 as broadcasts); a thread under no stamp only tests
// bounds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stamps.cuh"

namespace {

using stamps::kStageSlots;
using stamps::kTileCols;
using stamps::Run;
using stamps::SlotList;
using stamps::StampGroup;
using stamps::StampGroups;
using stamps::sum_stamps;

constexpr int kThreads = 256;  // B4: one thread per pixel

// B3: one block per env; each warp a 16 x 16 pixel region, each lane an
// 8-pixel run of one row (stamps.cuh), in passes when the frame has more
// regions than the block has warps. The run's three channel rows are read
// as 16-byte vectors before the slot table is staged, so that the frame's
// loads and the slot table's are in flight together.
__global__ void __launch_bounds__(kStageSlots, 4)
stamp_composite_kernel(const __nv_bfloat16* __restrict__ img,
                       const StampGroups groups,
                       __nv_bfloat16* __restrict__ out, int obs) {
  __shared__ SlotList slots;
  const int e = blockIdx.x;
  const size_t plane = (size_t)obs * obs;
  int n = 0;
  for (int pass = 0; pass < stamps::runs_passes(obs); ++pass) {
    const Run u = stamps::run_of(pass, obs);
    const size_t row0 = ((size_t)e * 3 * obs + u.R) * obs + u.C;
    uint4 raw[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      raw[ch] = u.active ? __ldg(reinterpret_cast<const uint4*>(
                               img + row0 + ch * plane))
                         : make_uint4(0, 0, 0, 0);
    }
    float f[kTileCols][3];
#pragma unroll
    for (int k = 0; k < kTileCols; ++k) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) f[k][ch] = stamps::lane_of(raw[ch], k);
    }
    stamps::stamp_pass(f, u, groups, e, obs, pass, slots, n);
    if (u.active) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        *reinterpret_cast<uint4*>(out + row0 + ch * plane) =
            stamps::pack8(f, ch);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
stamp_sum_kernel(const StampGroup group, __nv_bfloat16* __restrict__ out,
                 int obs) {
  const int e = blockIdx.x;
  const int p = blockIdx.y * kThreads + threadIdx.x;
  const int npix = obs * obs;
  if (p >= npix) return;
  const int r = p / obs;
  const int c = p - r * obs;

  float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  sum_stamps(f, group, e, r, c, obs);

  __nv_bfloat16* o = out + (size_t)e * 4 * npix + p;
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) o[ch * npix] = __float2bfloat16_rn(f[ch]);
}

}  // namespace

// Plain C entry point of B3 (bound with ctypes). Tensor pointers are device
// pointers of contiguous tensors checked by the Python wrapper: img and
// out bf16 [N, 3, obs, obs], obs a multiple of 8, both on 16-byte
// boundaries; the per-group arrays (n_groups entries) are host arrays.
// Returns 0, a cudaError_t, or -1 for a shape the kernel does not take.
extern "C" int stamp_composite_launch(
    const void* img, int n_groups, const void* const* banks,
    const void* const* vars, const void* const* scales,
    const void* const* r0s, const void* const* c0s, const int* Vs,
    const int* Ps, const int* Ks, void* out, int N, int obs, void* stream) {
  StampGroups groups;
  if (!stamps::make_groups(&groups, n_groups, banks, vars, scales, r0s, c0s,
                           Vs, Ps, Ks) ||
      N < 0 || obs <= 0 || obs % kTileCols != 0 ||
      reinterpret_cast<uintptr_t>(img) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return -1;
  }
  if (N == 0) return 0;
  stamp_composite_kernel<<<N, kStageSlots, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(img), groups,
      static_cast<__nv_bfloat16*>(out), obs);
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry point of B4 (bound with ctypes). Tensor pointers are device
// pointers of contiguous tensors checked by the Python wrapper: bank bf16
// [V, 4, P, P]; var, r0, c0 int32 and scale f32 [N, K]; out bf16
// [N, 4, obs, obs]. Returns 0, a cudaError_t, or -1 for a shape the kernel
// does not take.
extern "C" int stamp_sum_launch(const void* bank, const void* var,
                                const void* scale, const void* r0,
                                const void* c0, int V, int P, int K,
                                void* out, int N, int obs, void* stream) {
  if (V < 0 || P <= 0 || K < 0 || N < 0 || obs <= 0) return -1;
  if (N == 0) return 0;
  StampGroup group;
  group.bank = static_cast<const __nv_bfloat16*>(bank);
  group.var = static_cast<const int32_t*>(var);
  group.scale = static_cast<const float*>(scale);
  group.r0 = static_cast<const int32_t*>(r0);
  group.c0 = static_cast<const int32_t*>(c0);
  group.V = V;
  group.P = P;
  group.K = K;
  const dim3 grid_dim(N, (obs * obs + kThreads - 1) / kThreads);
  stamp_sum_kernel<<<grid_dim, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      group, static_cast<__nv_bfloat16*>(out), obs);
  return static_cast<int>(cudaGetLastError());
}
