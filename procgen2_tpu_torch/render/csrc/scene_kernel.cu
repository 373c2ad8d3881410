// Scene kernel for Hopper (sm_90a): tile layer + background + painter-order
// stamps of the quantized-camera scene render, one env frame per launch row.
//
// Replaces the Pallas TPU kernel procgen2_tpu/render/scene_kernel.py
// `_scene_kernel_raw` (launched by `_scene_raw`), with its stamp loop
// `_blend_stamps_ref` as the device function `blend_stamps` (stamps.cuh,
// shared with the stamp-over-frame kernel).
//
// What it computes, per env e and output pixel (r, c):
//   1. the kind field and background under the pixel, read from the
//      padded tile grid through the phase offset table:
//        y = ty0 + pad + TR[jy][r],  x = tx0 + pad + TR[jx][c],
//        G = grid[e, y, x],  frame = bg_bank[bg_i, :, y, x];
//      a read outside the grid gives 0, as the TPU's 0/1 selector
//      contraction does;
//   2. every tile entry i in order, where G == entry_kind[i] and the entry
//      is unthemed or matches the env's theme:
//        frame = frame * (1 - a) + rgb   (tile_bank[jy*QP + jx, i]);
//   3. every stamp group in order, every slot in order (painter order):
//      skip a slot with scale == 0 or var outside [0, V); place
//      bank[var] at (r0, c0) (clipped to [-P, OBS]); where the pixel is
//      under it, contrib = bf16(texel * scale) and
//        frame = frame * (1 - a) + rgb.
//   Every multiply, subtract and add is computed in f32 and rounded to
//   bf16 (RNE) on its own, with __fmul_rn/__fadd_rn so that nothing is
//   contracted into an FMA: that is the rounding of the plain torch
//   version (`scene_raw_reference`) and of the JAX package's bf16 ops.
//
// Design: one thread per output pixel, a block of 256 threads covers 4
// rows of one env, blockIdx.x is the env. Each pixel's blend chain is
// independent, so no synchronisation and no shared memory. What bounds
// it on the card: per pixel ~40 bytes of reads (grid, bg, the matching
// tile entries, the stamps that cover it) and a 6-byte write, and the
// per-slot scalar loads that every thread of the block repeats (served
// from L1 as broadcasts). The TPU kernel's selector matmuls, lane rolls,
// 128-lane f32 bank padding and 16-env blocks answer TPU constraints and
// are not carried over.
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
  const int th = theme[e];
  const __nv_bfloat16* tb =
      tile_bank + (size_t)(py * QP + px) * entries.n * 4 * npix + p;
  for (int i = 0; i < entries.n; ++i) {
    if (G != entries.kind[i]) continue;
    const int want = entries.theme[i];
    if (want >= 0 && want != th) continue;
    const __nv_bfloat16* t = tb + (size_t)i * 4 * npix;
    const float rgb[3] = {ld(t), ld(t + npix), ld(t + 2 * npix)};
    blend(f, rgb, ld(t + 3 * npix));
  }

  // (3) stamp groups in painter order
  for (int gi = 0; gi < groups.n; ++gi) {
    blend_stamps(f, groups.g[gi], e, r, c, obs);
  }

  __nv_bfloat16* o = out + (size_t)e * 3 * npix + p;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) o[ch * npix] = __float2bfloat16_rn(f[ch]);
}

}  // namespace

// Plain C entry point (bound with ctypes). Tensor pointers are device
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
  if (!stamps::make_groups(&groups, n_groups, banks, vars, scales, r0s, c0s,
                           Vs, Ps, Ks) ||
      NE < 0 || NE > kMaxEntries || N < 0 || obs <= 0 || QP <= 0) {
    return -1;
  }
  if (N == 0) return 0;
  TileEntries entries;
  entries.n = NE;
  for (int i = 0; i < NE; ++i) {
    entries.kind[i] = entry_kind[i];
    entries.theme[i] = entry_theme[i];
  }
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
