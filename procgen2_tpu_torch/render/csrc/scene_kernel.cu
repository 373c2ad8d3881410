// Scene kernels for Hopper (sm_90a): tile layer + background +
// painter-order stamps of the quantized-camera scene render, one env frame
// per launch row. One nvcc build, two kernels:
//
// (B1) scene_raw_kernel replaces the Pallas TPU kernel
// procgen2_tpu/render/scene_kernel.py `_scene_kernel_raw` (launched by
// `_scene_raw`, entry `scene_tpu_raw`), with its stamp loop
// `_blend_stamps_ref` as the device function `blend_stamps` (stamps.cuh,
// shared with the stamp kernels).
// (B5) scene_kernel replaces the Pallas TPU kernel `_scene_kernel` of the
// same file (launched by `_scene`, entry `scene_tpu`): B1 without step 1,
// reading the kind field and the background from a pre-expanded field
// X [N, 4, OBS, OBS] (channel 0 the kind, 1-3 the background).
//
// What they compute, per env e and output pixel (r, c):
//   1. the kind field and background under the pixel. B1 reads them from
//      the padded tile grid through the phase offset table:
//        y = ty0 + pad + TR[jy][r],  x = tx0 + pad + TR[jx][c],
//        G = grid[e, y, x],  frame = bg_bank[bg_i, :, y, x];
//      a read outside the grid gives 0, as the TPU's 0/1 selector
//      contraction does; jy and jx are clamped to [0, QP). B5 reads
//      G = X[e, 0, r, c] and frame = X[e, 1:4, r, c], and its joint
//      phase p_joint clamped to [0, NPH);
//   2. every tile entry i in order, where G == entry_kind[i] and the entry
//      is unthemed or matches the env's theme:
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
// Design (both): one thread per output pixel, a block of 256 threads
// covers 4 rows of one env, blockIdx.x is the env. Each pixel's blend
// chain is independent, so no synchronisation and no shared memory. What
// bounds them on the card: B1 reads ~40 bytes per pixel (grid, bg, the
// matching tile entries, the stamps that cover it) and writes 6; B5 reads
// the 8-byte field X (134.2 MB at 4096 envs) plus the matching tile
// entries and stamps and writes 6 (100.7 MB); both repeat the per-slot
// scalar loads in every thread of the block (served from L1 as
// broadcasts). The TPU kernels' selector matmuls, lane rolls, 128-lane f32
// bank padding and 16-env blocks answer TPU constraints and are not
// carried over.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stamps.cuh"

namespace {

using stamps::StampGroups;
using stamps::blend;
using stamps::blend_stamps;
using stamps::clampi;
using stamps::ld;

constexpr int kMaxEntries = 32;
constexpr int kThreads = 256;

// The tile entries' kinds and themes travel as kernel parameters.
struct TileEntries {
  int32_t kind[kMaxEntries];
  int32_t theme[kMaxEntries];  // -1: every theme
  int n;
};

// Step (2) at one pixel: tb points at the pixel's texel of entry 0 of
// the env's phase in the tile bank [NPH, NE, 4, OBS, OBS]. The kind G is
// an int (B1, from the grid) or a float (B5, from the bf16 field).
template <typename Kind>
__device__ __forceinline__ void blend_tiles(float f[3], Kind G, int th,
                                            const __nv_bfloat16* tb,
                                            const TileEntries& entries,
                                            int npix) {
  for (int i = 0; i < entries.n; ++i) {
    if (G != (Kind)entries.kind[i]) continue;
    const int want = entries.theme[i];
    if (want >= 0 && want != th) continue;
    const __nv_bfloat16* t = tb + (size_t)i * 4 * npix;
    const float rgb[3] = {ld(t), ld(t + npix), ld(t + 2 * npix)};
    blend(f, rgb, ld(t + 3 * npix));
  }
}

__global__ void __launch_bounds__(kThreads)
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
  const int e = blockIdx.x;
  const int p = blockIdx.y * kThreads + threadIdx.x;
  const int npix = obs * obs;
  if (p >= npix) return;
  const int r = p / obs;
  const int c = p - r * obs;

  // (1) kind field and background under the pixel
  const int py = clampi(jy[e], 0, QP - 1);
  const int px = clampi(jx[e], 0, QP - 1);
  const int y = ty0[e] + pad + tr_tab[py * obs + r];
  const int x = tx0[e] + pad + tr_tab[px * obs + c];
  const bool inb = y >= 0 && y < GP && x >= 0 && x < GP;
  const int G = inb ? (int)grid[((size_t)e * GP + y) * GP + x] : 0;
  const int b = bg_i[e];
  const bool bg_ok = inb && b >= 0 && b < NB;
  float f[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    f[ch] = bg_ok ? ld(bg_bank + (((size_t)b * 3 + ch) * GP + y) * GP + x)
                  : 0.0f;
  }

  // (2) tile entries in order
  blend_tiles(f, G, theme[e],
              tile_bank + (size_t)(py * QP + px) * entries.n * 4 * npix + p,
              entries, npix);

  // (3) stamp groups in painter order
  for (int gi = 0; gi < groups.n; ++gi) {
    blend_stamps(f, groups.g[gi], e, r, c, obs);
  }

  __nv_bfloat16* o = out + (size_t)e * 3 * npix + p;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) o[ch * npix] = __float2bfloat16_rn(f[ch]);
}

__global__ void __launch_bounds__(kThreads)
scene_kernel(const __nv_bfloat16* __restrict__ X,
             const int32_t* __restrict__ p_joint,
             const int32_t* __restrict__ theme,
             const __nv_bfloat16* __restrict__ tile_bank,
             const TileEntries entries, const StampGroups groups,
             __nv_bfloat16* __restrict__ out, int NPH, int obs) {
  const int e = blockIdx.x;
  const int p = blockIdx.y * kThreads + threadIdx.x;
  const int npix = obs * obs;
  if (p >= npix) return;
  const int r = p / obs;
  const int c = p - r * obs;

  // (1) kind field and background from the expanded field
  const __nv_bfloat16* x = X + (size_t)e * 4 * npix + p;
  const float G = ld(x);
  float f[3] = {ld(x + npix), ld(x + 2 * npix), ld(x + 3 * npix)};

  // (2) tile entries in order
  const int ph = clampi(p_joint[e], 0, NPH - 1);
  blend_tiles(f, G, theme[e],
              tile_bank + (size_t)ph * entries.n * 4 * npix + p, entries,
              npix);

  // (3) stamp groups in painter order
  for (int gi = 0; gi < groups.n; ++gi) {
    blend_stamps(f, groups.g[gi], e, r, c, obs);
  }

  __nv_bfloat16* o = out + (size_t)e * 3 * npix + p;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) o[ch * npix] = __float2bfloat16_rn(f[ch]);
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
// pointers of contiguous tensors checked by the Python wrapper;
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
      obs <= 0 || QP <= 0) {
    return -1;
  }
  if (N == 0) return 0;
  const dim3 grid_dim(N, (obs * obs + kThreads - 1) / kThreads);
  scene_raw_kernel<<<grid_dim, kThreads, 0,
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
// [NPH, NE, 4, obs, obs], out bf16 [N, 3, obs, obs]; entry_kind/entry_theme
// (NE entries) and the per-group arrays (n_groups entries) are host
// arrays. Returns 0, a cudaError_t, or -1 for a shape the kernel does not
// take.
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
      obs <= 0 || NPH <= 0) {
    return -1;
  }
  if (N == 0) return 0;
  const dim3 grid_dim(N, (obs * obs + kThreads - 1) / kThreads);
  scene_kernel<<<grid_dim, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(X),
      static_cast<const int32_t*>(p_joint),
      static_cast<const int32_t*>(theme),
      static_cast<const __nv_bfloat16*>(tile_bank), entries, groups,
      static_cast<__nv_bfloat16*>(out), NPH, obs);
  return static_cast<int>(cudaGetLastError());
}
