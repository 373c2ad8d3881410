// Stamp kernels for Hopper (sm_90a), one nvcc build:
//
// (B3) stamp_composite_kernel: K premultiplied P x P stamps per env
// alpha-blended OVER a given frame in slot (painter) order, for 1 to 4
// stamp groups in one launch. Replaces the Pallas TPU kernel
// procgen2_tpu/render/stamp_kernel.py `_kernel_blend` (launched by
// `_composite`, entry `composite_tpu`, called from
// `compositor.composite_stamps` on its kernel path). One launch over
// several groups is the same as one call per group in order: per pixel,
// painter order runs through all slots of group 0, then group 1, and so
// on.
// Per env e and output pixel (r, c): the frame's three bf16 values, then,
// for each group in order, each slot in order (`BlendOp` in
// stamps.cuh), skipped where scale == 0 or var is
// outside [0, V); bank[var] placed at (r0, c0) clipped to [-P, OBS]; under it
// contrib = bf16(texel * scale) and frame = bf16(bf16(frame * bf16(1 - a))
// + rgb), every op rounded on its own (no FMA).
//
// (B4) stamp_sum_kernel: the K premultiplied stamps of one group summed
// into a zeroed 4-channel frame (rgb * a, a). Replaces the Pallas TPU
// kernel procgen2_tpu/render/stamp_kernel.py `_kernel` (launched by
// `_stamps`, entry `stamps_tpu`, called from
// `compositor.stamps_from_pixel_bank` on its kernel path). Per env e and
// output pixel (r, c): four zeros, then the same slot skip and placement
// as B3; under the stamp f[ch] = bf16(f[ch] + bf16(texel * scale)) in
// slot order (`SumOp` in stamps.cuh).
//
// The TPU kernels' lane/sublane rolls, their tile-aligned W-row window and
// their f32 bank padded to 128 lanes answer TPU layout rules; what they
// compute is the placement above, so none of them is carried over.
//
// B3 and B4 share one design, the staged slot table of stamps.cuh (B1 and
// B5 run it too): one block of 256 threads owns an env, each warp a
// 16 x 16 pixel region and each lane an 8-pixel run of one row;
//   * the env's slot table is decoded once, into shared memory
//     (`stage_slots`: coalesced loads, the skip test, the clip, a cull of
//     slots wholly off the frame, compaction of the live ones in painter
//     order; a table over 256 slots in passes);
//   * a slot is tested once per warp region (no divergence) and once per
//     run, and works only on the pixels it covers (`for_slots`);
//   * the frame moves as 16-byte vectors: B3 reads its run's three channel
//     rows before the slot table is staged, so that both sets of loads are
//     in flight together, and writes them back the same way; B4 starts
//     from zeros in registers and writes its four channel rows.
// What bounds them is bytes: B3 reads and writes its frame once (6 + 6
// bytes per pixel, 100.7 MB each way at 4096 envs), B4 only writes its
// 4-channel frame (8 bytes per pixel, 134.2 MB). No tensor cores: the work
// is a chain of separately rounded bf16 blends or adds per pixel, not a
// product. B3 reads its frame into registers pass by pass; B5
// (scene_kernel.cu) gained from copying its rows of both passes ahead
// with cp.async, which B3 has not tried. What remains beyond the bytes is
// the per-pixel work itself (the lanes of a warp under no stamp wait for
// those under one) and the staging's two barriers per env. B4's first
// design ran one thread per pixel, each decoding all K slots (climber's
// merged group: 35) with four dependent scalar loads apiece, and stored 2
// bytes at a time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stamps.cuh"

namespace {

using stamps::kStageSlots;
using stamps::kTileCols;
using stamps::Run;
using stamps::SlotList;
using stamps::StampGroups;

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
    stamps::stamp_pass(f, u, groups, e, obs, pass, slots, n,
                       stamps::BlendOp());
    if (u.active) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        *reinterpret_cast<uint4*>(out + row0 + ch * plane) =
            stamps::pack8(f, ch);
      }
    }
  }
}

// B4: the layout of B3 over a 4-channel frame that starts at zero in
// registers; one group.
__global__ void __launch_bounds__(kStageSlots, 4)
stamp_sum_kernel(const StampGroups groups, __nv_bfloat16* __restrict__ out,
                 int obs) {
  __shared__ SlotList slots;
  const int e = blockIdx.x;
  const size_t plane = (size_t)obs * obs;
  int n = 0;
  for (int pass = 0; pass < stamps::runs_passes(obs); ++pass) {
    const Run u = stamps::run_of(pass, obs);
    float f[kTileCols][4];
#pragma unroll
    for (int k = 0; k < kTileCols; ++k) {
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) f[k][ch] = 0.0f;
    }
    stamps::stamp_pass(f, u, groups, e, obs, pass, slots, n,
                       stamps::SumOp());
    if (u.active) {
      const size_t row0 = ((size_t)e * 4 * obs + u.R) * obs + u.C;
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        *reinterpret_cast<uint4*>(out + row0 + ch * plane) =
            stamps::pack8(f, ch);
      }
    }
  }
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
// [N, 4, obs, obs], obs a multiple of 8, on a 16-byte boundary. Returns
// 0, a cudaError_t, or -1 for a shape the kernel does not take.
extern "C" int stamp_sum_launch(const void* bank, const void* var,
                                const void* scale, const void* r0,
                                const void* c0, int V, int P, int K,
                                void* out, int N, int obs, void* stream) {
  StampGroups groups;
  if (!stamps::make_groups(&groups, 1, &bank, &var, &scale, &r0, &c0, &V,
                           &P, &K) ||
      V < 0 || P <= 0 || K < 0 || N < 0 || obs <= 0 ||
      obs % kTileCols != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return -1;
  }
  if (N == 0) return 0;
  stamp_sum_kernel<<<N, kStageSlots, 0, static_cast<cudaStream_t>(stream)>>>(
      groups, static_cast<__nv_bfloat16*>(out), obs);
  return static_cast<int>(cudaGetLastError());
}
