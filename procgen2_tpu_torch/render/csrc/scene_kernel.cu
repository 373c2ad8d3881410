// Scene kernels for Hopper (sm_90a): tile layer + background +
// painter-order stamps of the quantized-camera scene render, one env frame
// per block. One nvcc build, two kernels:
//
// (B1) scene_raw_kernel replaces the Pallas TPU kernel
// procgen2_tpu/render/scene_kernel.py `_scene_kernel_raw` (launched by
// `_scene_raw`, entry `scene_tpu_raw`), with its stamp loop
// `_blend_stamps_ref` as the staged slot list of stamps.cuh
// (`stage_slots`, `stamp_pass`, shared with B3, B4 and B5).
// (B5) scene_kernel replaces the Pallas TPU kernel `_scene_kernel` of the
// same file (launched by `_scene`, entry `scene_tpu`): B1 without step 1,
// reading the kind field and the background from a pre-expanded field
// X [N, 4, OBS, OBS] (channel 0 the kind, 1-3 the background), with the
// same staged stamp loop.
//
// What they compute, per env e and output pixel (r, c):
//   1. the kind field and background under the pixel. B1 reads them from
//      the padded tile grid through the phase offset table:
//        y = ty0 + pad + TR[jy][r],  x = tx0 + pad + TR[jx][c],
//        G = grid[e, y, x],  frame = bg_bank[bg_i, :, y, x];
//      a read outside the grid gives 0, as the TPU's 0/1 selector
//      contraction does; jy and jx are clamped to [0, QP). B5 reads
//      G = X[e, 0, r, c] (a bf16 value, not always an integer) and
//      frame = X[e, 1:4, r, c], and its joint phase p_joint clamped to
//      [0, NPH);
//   2. every tile entry i in order, where G == entry_kind[i] (for B5 the
//      f32 comparison G == (float)entry_kind[i]) and the entry is
//      unthemed or matches the env's theme:
//        frame = frame * (1 - a) + rgb   (tile_bank[phase, i]);
//   3. every stamp group in order, every slot in order (painter order):
//      skip a slot with scale == 0 or var outside [0, V); place
//      bank[var] at (r0, c0) (clipped to [-P, OBS]); where the pixel is
//      under it, contrib = bf16(texel * scale) and
//        frame = frame * (1 - a) + rgb.
//   Every multiply, subtract and add is computed in f32 and rounded to
//   bf16 (RNE) on its own, with __fmul_rn/__fadd_rn so that nothing is
//   contracted into an FMA: that is the rounding of the plain torch
//   versions (`scene_raw_reference`, `scene_reference`) and of the JAX
//   package's bf16 ops.
//
// Design of B1 (redesigned for Hopper; before, one thread per pixel):
// the bound is bytes, the 100.7 MB bf16 output at 4096 envs plus the grid
// cells, background texels and tile texels under the env windows (a few
// MB, L2-resident). The one-thread-per-pixel design spent its time issuing
// work instead: every pixel compared its kind with every tile entry (18
// for coinrun), decoded every slot of every group (four dependent loads,
// clamps and a bounds test each), re-read the env's scalars and two
// phase-table entries, and stored 2 bytes at a time; and a warp spanned 8
// full rows, so a small stamp kept few of its lanes busy. Now one block of
// 256 threads owns an env, each warp a 16 x 16 pixel region and each lane
// an 8-pixel run of one row (stamps.cuh), and
//   * per env, in shared memory: the six scalars; the padded-grid row of
//     every output row and column of every output column (the two TR rows,
//     offset); for each int8 kind value, the mask of the tile entries that
//     match it and the env's theme. A pixel looks its mask up once and
//     blends its 0-2 entries in bit order = entry order;
//   * a lane reads a grid cell and its three background texels only where
//     its column's cell differs from the previous column's (the phase
//     table maps ~4.8 adjacent columns to one cell): these scalar reads
//     were the largest cost left;
//   * an entry's 8 texels of one channel under a run are one 16-byte load;
//   * the slot table is staged once per env in shared memory and culled per
//     warp region and per run (stamps.cuh);
//   * the output is stored as 16-byte vectors.
// The TPU kernel's selector matmuls (0/1 matrices contracted against the
// grid and the background on the MXU) are the gather above: no tensor
// cores, the work is a chain of separately rounded bf16 blends per pixel,
// not a product. What remains beyond the bytes: the per-env preamble (two
// barriers, the scalar and phase-table loads) and the staging barriers,
// hidden by 4 resident blocks per SM (64 registers), and the blends.
//
// Design of B5 (redesigned for Hopper after B1; before, one thread per
// pixel read X as four 2-byte loads, compared its kind with every tile
// entry, decoded every slot of every group and stored 2 bytes at a time):
// the bound is bytes, X read once (8 bytes per pixel, 134.2 MB at 4096
// envs) and the 6-byte output written once (100.7 MB), plus the tile
// texels under matching kinds (L2-resident). Now B1's layout, one block
// of 256 threads per env, a 16 x 16 region per warp, an 8-pixel run per
// lane, and
//   * per env, in shared memory: for each int8 kind value, the mask of
//     the tile entries that match it and the env's theme. The joint phase
//     (clamped) and the theme are read by every thread from global memory
//     (one broadcast load per warp), which spares a barrier;
//   * the run's four X channel rows are copied into shared memory as
//     16-byte asynchronous copies (cp.async), those of both passes before
//     the mask table is built and the slot table staged, so that all
//     these loads are in flight together; the tile blends then run in
//     `stamp_pass`'s hook, between the staging and the stamps. With the
//     rows read into registers, pass by pass, B5 took 0.128 ms on
//     climber's field at 4096 envs with no tile blend and no stamp left in
//     its inputs, against 0.164 ms with them (chip_smoke's ablation on an
//     H100 SXM at 700 W; bound 0.071 ms): the loads, not the blends, held
//     the time. The copies ahead took it to 0.134 ms;
//   * the kind is a bf16 float here: a pixel takes the table's mask only
//     when its kind is an integer in [-128, 127] (-0.0 is 0), and
//     otherwise compares it with every entry as floats (`entry_mask`), so
//     a fraction matches nothing and an integer beyond int8 matches the
//     entries of that kind, as the float comparison does. Each pixel's
//     mask is found once per run and kept in shared memory for the
//     entries' blends;
//   * an entry's 8 texels of one channel under a run are one 16-byte load;
//   * the stamps go through the staged slot table (stamps.cuh);
//   * the output is stored as 16-byte vectors.
// The TPU kernels' selector matmuls, lane rolls, 128-lane f32 bank
// padding and 16-env blocks answer TPU constraints and are not carried
// over.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stamps.cuh"

namespace {

using stamps::SlotList;
using stamps::StampGroups;
using stamps::blend;
using stamps::clampi;
using stamps::kStageSlots;
using stamps::kTileCols;
using stamps::ld;
using stamps::Run;

constexpr int kMaxEntries = 32;
constexpr int kMaxObs = 256;  // B1: rows and columns staged per env

// The tile entries' kinds and themes travel as kernel parameters.
struct TileEntries {
  int32_t kind[kMaxEntries];
  int32_t theme[kMaxEntries];  // -1: every theme
  int n;
};

// Entry t of an env's table of int8 kinds: the mask of the tile entries
// (bit i = entry i) whose kind is (int8_t)t and whose theme is -1 or the
// env's theme th.
__device__ __forceinline__ uint32_t int8_kind_mask(const TileEntries& entries,
                                                   int t, int th) {
  const int kind = (int)(int8_t)t;
  uint32_t m = 0;
#pragma unroll 8
  for (int i = 0; i < entries.n; ++i) {
    const int want = entries.theme[i];
    if (entries.kind[i] == kind && (want < 0 || want == th)) m |= 1u << i;
  }
  return m;
}

// B1: one block per env; each warp a 16 x 16 pixel region, each lane an
// 8-pixel run of one row (stamps.cuh), in passes when the frame has more
// regions than the block has warps. Staged per env in shared memory: the
// six per-env scalars, the padded-grid row and column of every output row
// and column (ty0 + pad + TR[jy][r], tx0 + pad + TR[jx][c]), and for each
// int8 kind value the mask of the tile entries that match it and the
// env's theme (bit i = entry i, so entry order is bit order).
__global__ void __launch_bounds__(kStageSlots, 4)
scene_raw_kernel(const int8_t* __restrict__ grid,
                 const int32_t* __restrict__ ty0,
                 const int32_t* __restrict__ tx0,
                 const int32_t* __restrict__ jy,
                 const int32_t* __restrict__ jx,
                 const int32_t* __restrict__ bg_i,
                 const int32_t* __restrict__ theme,
                 const __nv_bfloat16* __restrict__ bg_bank,
                 const int32_t* __restrict__ tr_tab,
                 const __nv_bfloat16* __restrict__ tile_bank,
                 const TileEntries entries,
                 const StampGroups groups,
                 __nv_bfloat16* __restrict__ out,
                 int GP, int NB, int QP, int obs, int pad) {
  static_assert(kStageSlots == 256, "one kind mask per thread");
  __shared__ SlotList slots;
  __shared__ int env_y[kMaxObs];
  __shared__ int env_x[kMaxObs];
  __shared__ uint32_t kind_mask[256];
  __shared__ int env[6];  // ty0, tx0, jy, jx, bg_i, theme
  const int e = blockIdx.x;
  const int t = threadIdx.x;
  if (t < 6) {
    const int32_t* src = t == 0 ? ty0 : t == 1 ? tx0 : t == 2 ? jy
                       : t == 3 ? jx : t == 4 ? bg_i : theme;
    env[t] = src[e];
  }
  __syncthreads();
  const int py = clampi(env[2], 0, QP - 1);
  const int px = clampi(env[3], 0, QP - 1);
  const int b = env[4];
  const int th = env[5];
  for (int i = t; i < obs; i += kStageSlots) {
    env_y[i] = env[0] + pad + tr_tab[py * obs + i];
    env_x[i] = env[1] + pad + tr_tab[px * obs + i];
  }
  kind_mask[t] = int8_kind_mask(entries, t, th);
  __syncthreads();

  const bool bg_ok = b >= 0 && b < NB;
  const int npix = obs * obs;
  const __nv_bfloat16* tb =
      tile_bank + (size_t)(py * QP + px) * entries.n * 4 * npix;
  int n = 0;
  for (int pass = 0; pass < stamps::runs_passes(obs); ++pass) {
    const Run u = stamps::run_of(pass, obs);
    float f[kTileCols][3];
    if (u.active) {
      // (1) kind field and background under each pixel of the run. The
      // phase table maps several adjacent columns to one cell, so a cell
      // is read only where the column's cell differs from the previous
      // column's; the others take the same values.
      const int y = env_y[u.R];
      const bool yin = y >= 0 && y < GP;
      const int8_t* grow = grid + ((size_t)e * GP + y) * GP;
      const __nv_bfloat16* brow = bg_bank + ((size_t)b * 3 * GP + y) * GP;
      const size_t bplane = (size_t)GP * GP;
      // the run's kinds, a byte each: two registers where eight masks
      // would spill at 64 (the tile loop looks the masks up again)
      uint32_t kinds[2] = {0, 0};
      uint32_t any = 0;
      uint32_t cell_kind = 0;
      uint32_t cell_mask = 0;
      float cell_bg[3] = {0.0f, 0.0f, 0.0f};
      int x_prev = 0;
#pragma unroll
      for (int k = 0; k < kTileCols; ++k) {
        const int x = env_x[u.C + k];
        if (k == 0 || x != x_prev) {
          const bool inb = yin && x >= 0 && x < GP;
          cell_kind = inb ? (uint32_t)(uint8_t)grow[x] : 0u;
          cell_mask = kind_mask[cell_kind];
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            cell_bg[ch] = inb && bg_ok ? ld(brow + ch * bplane + x) : 0.0f;
          }
        }
        x_prev = x;
        kinds[k / 4] |= cell_kind << (8 * (k % 4));
        any |= cell_mask;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) f[k][ch] = cell_bg[ch];
      }
      // (2) the matching tile entries in order: an entry's 8 texels of one
      // channel under the run are one 16-byte load
      while (any) {
        const int i = __ffs(any) - 1;
        any &= any - 1;
        const uint4* tp = reinterpret_cast<const uint4*>(
            tb + (size_t)i * 4 * npix + u.R * obs + u.C);
        uint4 v[4];
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) v[ch] = __ldg(tp + ch * (npix / 8));
#pragma unroll
        for (int k = 0; k < kTileCols; ++k) {
          const uint32_t kind = (kinds[k / 4] >> (8 * (k % 4))) & 255u;
          if (!((kind_mask[kind] >> i) & 1u)) continue;
          const float rgb[3] = {stamps::lane_of(v[0], k),
                                stamps::lane_of(v[1], k),
                                stamps::lane_of(v[2], k)};
          blend(f[k], rgb, stamps::lane_of(v[3], k));
        }
      }
    }
    // (3) stamp groups in painter order
    stamps::stamp_pass(f, u, groups, e, obs, pass, slots, n,
                       stamps::BlendOp());
    if (u.active) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        *reinterpret_cast<uint4*>(
            out + (((size_t)e * 3 + ch) * obs + u.R) * obs + u.C) =
            stamps::pack8(f, ch);
      }
    }
  }
}

// The mask of the tile entries that match kind G at an env (bit i =
// entry i), as the f32 comparison G == (float)entry_kind[i] and the theme
// test decide: an integer G in [-128, 127] (-0.0 included) is looked up
// in the env's table of int8 kinds; any other G (a fraction, an integer
// beyond int8, an infinity, a NaN) is compared with every entry.
__device__ __forceinline__ uint32_t entry_mask(float G,
                                               const uint32_t* kind_mask,
                                               const TileEntries& entries,
                                               int th) {
  const int k = __float2int_rz(G);
  if (__int2float_rn(k) == G && k >= -128 && k <= 127) {
    return kind_mask[k & 255];
  }
  uint32_t m = 0;
  for (int i = 0; i < entries.n; ++i) {
    const int want = entries.theme[i];
    if (G == __int2float_rn(entries.kind[i]) && (want < 0 || want == th)) {
      m |= 1u << i;
    }
  }
  return m;
}

// B5: B1's layout (stamps.cuh) over the expanded field X. Staged per env
// in shared memory: for each int8 kind value the mask of the tile entries
// that match it and the env's theme (bit i = entry i, so entry order is
// bit order). Each thread copies its runs' four X channel rows into
// shared memory asynchronously (cp.async, 16 bytes each), the next pass's
// while the current one is worked on, in a ring of two buffers; it keeps
// its run's 8 pixel masks in shared memory too. Only the thread that
// copies a buffer slot, or writes a mask, reads it, so neither needs a
// barrier.
__global__ void __launch_bounds__(kStageSlots, 4)
scene_kernel(const __nv_bfloat16* __restrict__ X,
             const int32_t* __restrict__ p_joint,
             const int32_t* __restrict__ theme,
             const __nv_bfloat16* __restrict__ tile_bank,
             const TileEntries entries, const StampGroups groups,
             __nv_bfloat16* __restrict__ out, int NPH, int obs) {
  static_assert(kStageSlots == 256, "one kind mask per thread");
  __shared__ SlotList slots;
  __shared__ uint32_t kind_mask[256];
  __shared__ uint32_t run_mask[kTileCols][kStageSlots];
  __shared__ uint4 xbuf[2][4][kStageSlots];  // [pass & 1][channel][thread]
  const int e = blockIdx.x;
  const int t = threadIdx.x;
  const int ph = clampi(p_joint[e], 0, NPH - 1);
  const int th = theme[e];
  const size_t npix = (size_t)obs * obs;
  const __nv_bfloat16* tb = tile_bank + (size_t)ph * entries.n * 4 * npix;
  const int passes = stamps::runs_passes(obs);
  // (1) the run's kinds and background, four 16-byte copies per pass
  const auto copy_x = [&](int pass) {
    const Run u = stamps::run_of(pass, obs);
    if (u.active) {
      const __nv_bfloat16* src = X + (size_t)e * 4 * npix +
                                 (size_t)u.R * obs + u.C;
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        __pipeline_memcpy_async(&xbuf[pass & 1][ch][t], src + ch * npix, 16);
      }
    }
    __pipeline_commit();
  };
  copy_x(0);
  kind_mask[t] = int8_kind_mask(entries, t, th);
  __syncthreads();
  int n = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const Run u = stamps::run_of(pass, obs);
    const size_t run = (size_t)u.R * obs + u.C;
    if (pass + 1 < passes) {
      copy_x(pass + 1);
    } else {
      __pipeline_commit();  // an empty group: one wait rule for every pass
    }
    float f[kTileCols][3];
    // (2) the matching tile entries in order, after the slot table is
    // staged: an entry's 8 texels of one channel under the run are one
    // 16-byte load
    const auto tiles = [&] {
      __pipeline_wait_prior(1);  // this pass's copies have landed
      const uint4(&x)[4][kStageSlots] = xbuf[pass & 1];
      uint32_t any = 0;
      if (u.active) {
        const uint4 kinds = x[0][t];
#pragma unroll
        for (int k = 0; k < kTileCols; ++k) {
          const uint32_t m = entry_mask(stamps::lane_of(kinds, k), kind_mask,
                                        entries, th);
          run_mask[k][t] = m;
          any |= m;
        }
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const uint4 bg = x[ch + 1][t];
#pragma unroll
        for (int k = 0; k < kTileCols; ++k) f[k][ch] = stamps::lane_of(bg, k);
      }
      while (any) {
        const int i = __ffs(any) - 1;
        any &= any - 1;
        const uint4* tp =
            reinterpret_cast<const uint4*>(tb + (size_t)i * 4 * npix + run);
        uint4 v[4];
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) v[ch] = __ldg(tp + ch * (npix / 8));
#pragma unroll
        for (int k = 0; k < kTileCols; ++k) {
          if (!((run_mask[k][t] >> i) & 1u)) continue;
          const float rgb[3] = {stamps::lane_of(v[0], k),
                                stamps::lane_of(v[1], k),
                                stamps::lane_of(v[2], k)};
          blend(f[k], rgb, stamps::lane_of(v[3], k));
        }
      }
    };
    // (3) stamp groups in painter order
    stamps::stamp_pass(f, u, groups, e, obs, pass, slots, n,
                       stamps::BlendOp(), tiles);
    if (u.active) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        *reinterpret_cast<uint4*>(out + ((size_t)e * 3 + ch) * npix + run) =
            stamps::pack8(f, ch);
      }
    }
  }
}

// The tile entries from the host arrays of a plain C entry point; false
// for a count the kernels do not take.
bool make_entries(TileEntries* out, int NE, const int* entry_kind,
                  const int* entry_theme) {
  if (NE < 0 || NE > kMaxEntries) return false;
  out->n = NE;
  for (int i = 0; i < NE; ++i) {
    out->kind[i] = entry_kind[i];
    out->theme[i] = entry_theme[i];
  }
  return true;
}

}  // namespace

// Plain C entry point of B1 (bound with ctypes). Tensor pointers are device
// pointers of contiguous tensors checked by the Python wrapper (obs a
// multiple of 8 up to kMaxObs, tile_bank and out on 16-byte boundaries);
// entry_kind/entry_theme (NE entries) and the per-group arrays
// (n_groups entries) are host arrays. Returns 0, a cudaError_t, or -1
// for a shape the kernel does not take.
extern "C" int scene_raw_launch(
    const void* grid, const void* ty0, const void* tx0, const void* jy,
    const void* jx, const void* bg_i, const void* theme,
    const void* bg_bank, const void* tr_tab, const void* tile_bank,
    const int* entry_kind, const int* entry_theme, int NE, int n_groups,
    const void* const* banks, const void* const* vars,
    const void* const* scales, const void* const* r0s,
    const void* const* c0s, const int* Vs, const int* Ps, const int* Ks,
    void* out, int N, int GP, int NB, int QP, int obs, int pad,
    void* stream) {
  StampGroups groups;
  TileEntries entries;
  if (!stamps::make_groups(&groups, n_groups, banks, vars, scales, r0s, c0s,
                           Vs, Ps, Ks) ||
      !make_entries(&entries, NE, entry_kind, entry_theme) || N < 0 ||
      obs <= 0 || obs > kMaxObs || obs % kTileCols != 0 || QP <= 0 ||
      reinterpret_cast<uintptr_t>(tile_bank) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return -1;
  }
  if (N == 0) return 0;
  scene_raw_kernel<<<N, kStageSlots, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(grid), static_cast<const int32_t*>(ty0),
      static_cast<const int32_t*>(tx0), static_cast<const int32_t*>(jy),
      static_cast<const int32_t*>(jx), static_cast<const int32_t*>(bg_i),
      static_cast<const int32_t*>(theme),
      static_cast<const __nv_bfloat16*>(bg_bank),
      static_cast<const int32_t*>(tr_tab),
      static_cast<const __nv_bfloat16*>(tile_bank), entries, groups,
      static_cast<__nv_bfloat16*>(out), GP, NB, QP, obs, pad);
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry point of B5 (bound with ctypes). Tensor pointers are device
// pointers of contiguous tensors checked by the Python wrapper: X bf16
// [N, 4, obs, obs], p_joint and theme int32 [N], tile_bank bf16
// [NPH, NE, 4, obs, obs], out bf16 [N, 3, obs, obs]; obs a multiple of
// 8, and X, tile_bank and out on 16-byte boundaries; entry_kind/
// entry_theme (NE entries) and the per-group arrays (n_groups entries) are
// host arrays. Returns 0, a cudaError_t, or -1 for a shape the kernel
// does not take.
extern "C" int scene_launch(
    const void* X, const void* p_joint, const void* theme,
    const void* tile_bank, const int* entry_kind, const int* entry_theme,
    int NE, int n_groups, const void* const* banks, const void* const* vars,
    const void* const* scales, const void* const* r0s,
    const void* const* c0s, const int* Vs, const int* Ps, const int* Ks,
    void* out, int N, int NPH, int obs, void* stream) {
  StampGroups groups;
  TileEntries entries;
  if (!stamps::make_groups(&groups, n_groups, banks, vars, scales, r0s, c0s,
                           Vs, Ps, Ks) ||
      !make_entries(&entries, NE, entry_kind, entry_theme) || N < 0 ||
      obs <= 0 || obs % kTileCols != 0 || NPH <= 0 ||
      reinterpret_cast<uintptr_t>(X) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(tile_bank) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return -1;
  }
  if (N == 0) return 0;
  scene_kernel<<<N, kStageSlots, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(X),
      static_cast<const int32_t*>(p_joint),
      static_cast<const int32_t*>(theme),
      static_cast<const __nv_bfloat16*>(tile_bank), entries, groups,
      static_cast<__nv_bfloat16*>(out), NPH, obs);
  return static_cast<int>(cudaGetLastError());
}
