// Stamp placement shared by the port's Hopper kernels (scene_kernel.cu,
// stamp_kernel.cu): the bf16 rounding helpers, the stamp-group
// descriptors, and one staged slot-table path (`stage_slots`,
// `for_slots`, `stamp_pass`) that all four kernels run, with a per-pixel
// operation for each:
//   * `BlendOp`: B2, the Pallas painter-order stamp blend
//     (`_blend_stamps_ref` in procgen2_tpu/render/scene_kernel.py,
//     `_kernel_blend`'s body in procgen2_tpu/render/stamp_kernel.py),
//     over a 3-channel frame (B1, B3, B5);
//   * `SumOp`: the body of the Pallas stamp-sum kernel (`_kernel` in
//     procgen2_tpu/render/stamp_kernel.py), into a 4-channel frame (B4).
//
// Every multiply, subtract and add is computed in f32 and rounded to bf16
// (RNE) on its own, with __fmul_rn/__fsub_rn/__fadd_rn so that nothing is
// contracted into an FMA: that is the rounding of the plain torch versions
// and of the JAX package's bf16 ops. Build with --fmad=false as well.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

// ---------------------------------------------------------------------------
// Staged slot tables.
//
// Decoding every slot of every group in every thread, for every pixel
// (four dependent scalar loads, two clamps and a bounds test per slot and
// pixel, though most slots are dead or far from the pixel) is what the
// kernels' first, one-thread-per-pixel designs spent their time on.
// Instead, a block of kStageSlots threads owns one env frame. It decodes
// the env's slot table once per staging pass, one slot per thread with
// coalesced loads: the skip test (scale == 0, var outside [0, V)), the
// clip of r0/c0 to [-P, obs], and a cull of slots that lie wholly off the
// frame (they cover no pixel). The live slots are compacted in painter
// order (groups in order, slots in order: a warp ballot and a prefix sum
// over the warps' counts) into a shared-memory list. A table of more than
// kStageSlots slots is staged in passes, in order; each thread keeps its
// pixels in registers across the passes, so every pixel's chain keeps its
// order.
//
// Each warp owns a region of kRegion x kRegion pixels and each of its
// lanes a run of 8 adjacent pixels of one row (one 16-byte vector per
// channel). A stamp then covers most lanes of the warps it touches, so
// the lanes work together instead of one lane working while the others
// wait (laid along 4 full rows, a warp's 32 runs would have a P = 8
// stamp on at most 8 of them; in a 16 x 16 region, on up to 16). A slot
// is tested once against the warp's region (the same answer in every
// lane: no divergence) and once against the lane's run; only a slot that
// covers the run runs the per-pixel operation, over the pixels it covers.
// ---------------------------------------------------------------------------

constexpr int kStageSlots = 256;  // threads of a staging block = list size
constexpr int kTileCols = 8;      // a lane's run of pixels in one row
constexpr int kRegion = 16;       // a warp's region: 16 rows x 2 runs
static_assert(kRegion * kRegion == 32 * kTileCols, "one run per lane");

// The live slots of one staging pass, in painter order.
struct SlotList {
  int4 geo[kStageSlots];  // r0, c0 (clipped), P, scale (f32 bits)
  const __nv_bfloat16* tex[kStageSlots];  // bank[var], channel 0, texel 0
  int warp_live[kStageSlots / 32];
};

// Where a lane's run lies: pass `pass` of a block of kStageSlots threads
// over a frame of obs x obs pixels. R, C: the run's row and first column
// (the warp's region starts at R and C rounded down to a multiple of
// kRegion); active: the run lies in the frame.
struct Run {
  int R, C;
  bool active;
};

// Passes of the block's warps over the frame's regions.
__device__ __forceinline__ int runs_passes(int obs) {
  const int nreg = (obs + kRegion - 1) / kRegion;
  constexpr int warps = kStageSlots / 32;
  return (nreg * nreg + warps - 1) / warps;
}

__device__ __forceinline__ Run run_of(int pass, int obs) {
  const int nreg = (obs + kRegion - 1) / kRegion;
  const int lane = threadIdx.x & 31;
  const int g = pass * (kStageSlots / 32) + (threadIdx.x >> 5);
  Run u;
  u.R = g / nreg * kRegion + lane / 2;
  u.C = g % nreg * kRegion + lane % 2 * kTileCols;
  u.active = g < nreg * nreg && u.R < obs && u.C < obs;
  return u;
}

// Number of slots over all groups.
__device__ __forceinline__ int slot_count(const StampGroups& gs) {
  int n = 0;
#pragma unroll
  for (int gi = 0; gi < kMaxGroups; ++gi) {
    if (gi < gs.n) n += gs.g[gi].K;
  }
  return n;
}

// Decode and compact slots [j0, j0 + kStageSlots) of env e (the groups'
// slots in painter order) into L; returns how many are live. Each thread
// decodes one slot: the skip test, the clip, the cull of a slot wholly
// off the frame; the live ones are compacted in order by a warp ballot and
// a prefix sum over the warps' counts. Every thread of the block calls it
// (it holds two __syncthreads); the list is complete on return. A thread
// reaches the first barrier only after its work over the previous list,
// so no list is overwritten while it is read; warp_live is read only
// between the two barriers.
__device__ __forceinline__ int stage_slots(const StampGroups& gs, int e,
                                           int j0, int obs, SlotList& L) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  bool live = false;
  int4 geo = make_int4(0, 0, 0, 0);
  const __nv_bfloat16* tex = nullptr;
  int k = j0 + threadIdx.x;
#pragma unroll
  for (int gi = 0; gi < kMaxGroups; ++gi) {
    if (gi < gs.n) {
      const StampGroup& g = gs.g[gi];
      if (k >= 0 && k < g.K) {
        const size_t i = (size_t)e * g.K + k;
        const float s = g.scale[i];
        const int v = g.var[i];
        const int r0 = clampi(g.r0[i], -g.P, obs);
        const int c0 = clampi(g.c0[i], -g.P, obs);
        live = s != 0.0f && v >= 0 && v < g.V && r0 > -g.P && r0 < obs &&
               c0 > -g.P && c0 < obs;
        geo = make_int4(r0, c0, g.P, __float_as_int(s));
        tex = g.bank + (size_t)v * 4 * g.P * g.P;
      }
      k -= g.K;
    }
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if (lane == 0) L.warp_live[warp] = __popc(ballot);
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kStageSlots / 32; ++w) {
    const int c = L.warp_live[w];
    total += c;
    base += w < warp ? c : 0;
  }
  if (live) {
    const int pos = base + __popc(ballot & ((1u << lane) - 1u));
    L.geo[pos] = geo;
    L.tex[pos] = tex;
  }
  __syncthreads();
  return total;
}

// B2's per-pixel blend: contrib = bf16(texel * scale) on all four
// channels, frame = frame * (1 - a) + rgb. t points at the texel in
// channel 0 (channel ch at t + ch * pp).
struct BlendOp {
  static constexpr int kChannels = 3;
  __device__ __forceinline__ void operator()(float (&f)[3],
                                             const __nv_bfloat16* t, int pp,
                                             float s) const {
    float rgb[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) rgb[ch] = bf(__fmul_rn(ld(t + ch * pp), s));
    blend(f, rgb, bf(__fmul_rn(ld(t + 3 * pp), s)));
  }
};

// B4's per-pixel sum: f[ch] = bf16(f[ch] + bf16(texel * scale)) on all
// four channels (rgb * a, a).
struct SumOp {
  static constexpr int kChannels = 4;
  __device__ __forceinline__ void operator()(float (&f)[4],
                                             const __nv_bfloat16* t, int pp,
                                             float s) const {
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      f[ch] = bf(__fadd_rn(f[ch], bf(__fmul_rn(ld(t + ch * pp), s))));
    }
  }
};

// Does nothing: the hook of `stamp_pass` for a kernel with no work
// between the staging of its slot table and the slots.
struct NoHook {
  __device__ __forceinline__ void operator()() const {}
};

// The n listed slots, in order, over the lane's run u: a slot that misses
// the warp's region, or the run, is skipped with one test each; under a
// slot, op(f[k], texel, pp, scale) at each pixel k of the run it covers.
template <typename Op>
__device__ __forceinline__ void for_slots(
    float (&f)[kTileCols][Op::kChannels], const Run& u, const SlotList& L,
    int n, const Op& op) {
  const int R0 = u.R & -kRegion;  // the warp's region
  const int C0 = u.C & -kRegion;
  for (int j = 0; j < n; ++j) {
    const int4 geo = L.geo[j];
    const int sr = geo.x, sc = geo.y, P = geo.z;
    if (sr >= R0 + kRegion || sr + P <= R0 || sc >= C0 + kRegion ||
        sc + P <= C0) {
      continue;  // the whole warp skips it
    }
    const int dr = u.R - sr;
    if (!u.active || dr < 0 || dr >= P || sc >= u.C + kTileCols ||
        sc + P <= u.C) {
      continue;
    }
    const __nv_bfloat16* t = L.tex[j] + dr * P;
    const float s = __int_as_float(geo.w);
    const int pp = P * P;
#pragma unroll
    for (int k = 0; k < kTileCols; ++k) {
      const int dc = u.C + k - sc;
      if (dc < 0 || dc >= P) continue;
      op(f[k], t + dc, pp, s);
    }
  }
}

// The stamp groups of env e over the lane's run u, in pass `pass` of the
// block over the frame (run_of). A table of at most kStageSlots slots is
// staged in pass 0 and its list, n long, serves the later passes; a
// larger one is staged anew in every pass, kStageSlots slots at a time,
// each part run before the next is staged. hook() runs after the first
// (or only) staging of the pass and before the first slot: a kernel whose
// frame needs work before the stamps (B5's tile blends) does it there, so
// that its frame loads are in flight while the table is staged. Every
// thread of the block calls it.
template <typename Op, typename Hook = NoHook>
__device__ __forceinline__ void stamp_pass(
    float (&f)[kTileCols][Op::kChannels], const Run& u,
    const StampGroups& gs, int e, int obs, int pass, SlotList& L, int& n,
    const Op& op, const Hook& hook = Hook()) {
  const int nslots = slot_count(gs);
  if (nslots <= kStageSlots) {
    if (pass == 0) n = nslots > 0 ? stage_slots(gs, e, 0, obs, L) : 0;
    hook();
    for_slots(f, u, L, n, op);
    return;
  }
  for (int j0 = 0; j0 < nslots; j0 += kStageSlots) {
    n = stage_slots(gs, e, j0, obs, L);
    if (j0 == 0) hook();
    for_slots(f, u, L, n, op);
  }
}

// bf16 lane k of 8 packed in a uint4, as a float (exact).
__device__ __forceinline__ float lane_of(const uint4& v, int k) {
  const uint32_t w = k < 2 ? v.x : k < 4 ? v.y : k < 6 ? v.z : v.w;
  return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
}

// 8 floats that are bf16 values (every frame value is: a bf16 load, 0 or
// the result of `bf`) packed into a uint4 by keeping their high halves,
// which is exact.
template <int C>
__device__ __forceinline__ uint4 pack8(const float (&f)[kTileCols][C],
                                       int ch) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = __byte_perm(__float_as_uint(f[2 * i][ch]),
                       __float_as_uint(f[2 * i + 1][ch]), 0x7632);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
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
