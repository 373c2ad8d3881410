// M1: maze's fixed-camera render for Hopper (sm_90a), the whole of
// games/maze.py::observe_batch_reference in easy and hard mode in one
// launch. It replaces no TPU kernel: the JAX package renders maze with XLA
// ops (procgen2_tpu/games/maze.py:341-350), and the port ran the same ops
// as ~60 plain torch kernels a step, most of them full-frame bf16 passes
// (a mask, a cast and four arithmetic ops for each of the four kind
// layers, then round, clamp and cast).
//
// What it computes, per env e and output pixel (c, y, x), in the plain
// render's order:
//   * the kind G: grid[e, ty[y], tx[x]], replaced by `cheese` on the goal's
//     cell and then by the mouse's kind on the agent's cell (`_augmented`:
//     the cell of a position is its f32 coordinates truncated to int, a
//     negative one wrapped once, as torch indexes; the mouse's kind is
//     mouse[flip + 2 * on_cheese], on_cheese comparing the unwrapped cells);
//   * the background: img = bg_bank[bg_index[e], c, y, x] as a float (u8,
//     exact in bf16);
//   * the four kind layers in painter order (`_compose`): layer L applies
//     where bit L of layer_lut[G + 128] is set; with a = kinds[L, 3, y, x]
//     and k = kinds[L, c, y, x]: d = rn(k - img), p = rn(a * d),
//     img = rn(img + p), rn rounding to bf16 to nearest even after each f32
//     op (built with --fmad=false, so nothing is contracted into an FMA).
//     Where a layer's mask is 0 the plain render blends with a = +0, which
//     gives p = +-0 and img + p = img for every img >= 0: skipping it is
//     exact;
//   * the obs: rintf (half to even, as torch.round), clamped to [0, 255],
//     stored as u8.
// The result equals the plain render bit for bit. A pixel whose kind takes
// no layer is its background byte; one whose kind takes layer 0 alone is
// its byte of `walled`, the obs of that one layer over each background at
// every pixel, which maze.py makes once with the plain render's own ops.
//
// Design for Hopper: the work is a streaming write of the u8 obs, 12,288 B
// an env (100.7 MB at 8192 envs); besides it each env's grid (225 B easy,
// 625 B hard) and 21 B of state are read once, and the constants (the
// backgrounds, 110 KB, the same backgrounds under the walls, 110 KB, and
// the kind images, 131 KB) are shared by every env and stay in L2. At
// 3.35 TB/s that bounds a step at 8192 envs to ~0.031 ms.
//   * Most pixels are background alone or background under the wall layer
//     alone, and that result depends only on the background, the channel
//     and the pixel, so it is made once (`walled`), not once per env. Only
//     the cheese's and the mouse's cells (and any kind whose layers are
//     neither none nor layer 0 alone) run the layer arithmetic, from the
//     background's byte. A first design ran the arithmetic for every pixel:
//     0.33 ms a step at 8192 envs on an H100 (99 registers, two blocks an
//     SM), ten times the bound.
//   * One block of 256 threads per env. The env's grid, the tile column
//     under each obs column and the layer table are staged in shared
//     memory, one barrier.
//   * Each thread owns a run of 16 pixels of one row (four runs a row),
//     works out their kinds once, then per channel reads the 16 bytes of
//     both banks as two 16-byte vectors, selects bytewise, and writes its
//     16 bytes as one 16-byte store: neighbouring threads write neighbouring
//     16 bytes of a channel's row. The few pixels that blend the cheese or
//     the mouse are then written again, one byte each, by the same thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kObs = 64;                      // the obs' rows and columns
constexpr int kPlane = kObs * kObs;           // pixels of one channel
constexpr int kRun = 16;                      // pixels a thread: 16 u8
constexpr int kRunsPerRow = kObs / kRun;      // 4
constexpr int kThreads = kObs * kRunsPerRow;  // 256: one thread per run
constexpr int kChannels = 3;
constexpr int kLayers = 4;  // wall, cheese, mouse, flipped mouse
constexpr int kPlanes = 4;  // a kind image: r, g, b, then alpha
constexpr int kLutSize = 256;  // one entry per int8 kind
constexpr int kMaxDim = 64;    // the largest grid side staged

struct Args {
  const int8_t* grid;        // [N, dim, dim]
  const float* goal_pos;     // [N, 2]
  const float* pos;          // [N, 2]
  const uint8_t* face;       // [N] bool
  const int32_t* bg_index;   // [N]
  const int32_t* tables;     // [2, kObs]: ty, then tx
  const uint8_t* bg_bank;    // [num_bgs, 3, kObs, kObs]
  const uint8_t* walled;     // [num_bgs, 3, kObs, kObs]: layer 0 alone
  const __nv_bfloat16* kinds;  // [kLayers, kPlanes, kObs, kObs]
  const uint8_t* layer_lut;  // [kLutSize]
  uint8_t* out;              // [N, 3, kObs, kObs]
  int num_bgs;
  int dim;
  int cheese;
  int mouse;            // by flip + 2 * on_cheese: bits 8k..8k+7 hold
                        // mouse kind k as an int8
};

__device__ __forceinline__ float rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The cell of a coordinate, as the plain render indexes with it: truncated
// toward zero, a negative index counted from the end.
__device__ __forceinline__ int cell(float v, int dim) {
  const int i = static_cast<int>(v);
  return i < 0 ? i + dim : i;
}

__device__ __forceinline__ uint4 ld16(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The bytes of `a` where `sel` is 0xff, of `b` elsewhere.
__device__ __forceinline__ uint32_t pick(uint32_t sel, uint32_t a,
                                         uint32_t b) {
  return (a & sel) | (b & ~sel);
}

// One pixel's layers (bit L of `bits` for layer L, in painter order) over
// its background value, then the obs byte.
__device__ __forceinline__ uint8_t blend_pixel(const Args& args,
                                               uint32_t bits, float img,
                                               size_t c_px, size_t a_px) {
#pragma unroll
  for (int L = 0; L < kLayers; ++L) {
    if (!((bits >> L) & 1u)) continue;
    const __nv_bfloat16* kimg =
        args.kinds + static_cast<size_t>(L) * kPlanes * kPlane;
    const float k = __bfloat162float(kimg[c_px]);
    const float a = __bfloat162float(kimg[a_px]);
    const float d = rn(k - img);
    const float p = rn(a * d);
    img = rn(img + p);
  }
  return static_cast<uint8_t>(fminf(fmaxf(rintf(img), 0.0f), 255.0f));
}

__global__ void __launch_bounds__(kThreads)
maze_render_kernel(const Args args) {
  __shared__ int8_t cells[kMaxDim * kMaxDim];
  __shared__ int32_t cols[kObs];
  __shared__ uint8_t lut[kLutSize];
  const int e = blockIdx.x;
  const int t = threadIdx.x;
  const int dim = args.dim;
  const int8_t* grid = args.grid + static_cast<size_t>(e) * dim * dim;
  for (int i = t; i < dim * dim; i += kThreads) cells[i] = grid[i];
  if (t < kObs) cols[t] = __ldg(args.tables + kObs + t);
  lut[t] = __ldg(args.layer_lut + t);  // kThreads == kLutSize

  // the env's scalars, read by every thread (one broadcast load each)
  const float gxf = __ldg(args.goal_pos + 2 * e);
  const float gyf = __ldg(args.goal_pos + 2 * e + 1);
  const float mxf = __ldg(args.pos + 2 * e);
  const float myf = __ldg(args.pos + 2 * e + 1);
  const int on_cheese = static_cast<int>(mxf) == static_cast<int>(gxf) &&
                        static_cast<int>(myf) == static_cast<int>(gyf);
  const int flip = __ldg(args.face + e) != 0;
  const int gx = cell(gxf, dim), gy = cell(gyf, dim);
  const int mx = cell(mxf, dim), my = cell(myf, dim);
  const int8_t mouse =
      static_cast<int8_t>(args.mouse >> (8 * (flip + 2 * on_cheese)));
  const int8_t cheese = static_cast<int8_t>(args.cheese);
  int b = __ldg(args.bg_index + e);
  b = b < 0 ? b + args.num_bgs : b;
  b = min(max(b, 0), args.num_bgs - 1);

  const int y = t / kRunsPerRow;
  const int x0 = (t % kRunsPerRow) * kRun;
  const int ty = __ldg(args.tables + y);
  __syncthreads();

  // the run's kinds: which pixels take layer 0 alone (their bytes of
  // `walled`), which take other layers (`blended`, with their bits)
  uint32_t sel[4] = {0, 0, 0, 0};
  uint32_t blended = 0;
  uint64_t run_bits = 0;
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    const int tx = cols[x0 + i];
    int8_t g = cells[ty * dim + tx];
    if (ty == gy && tx == gx) g = cheese;
    if (ty == my && tx == mx) g = mouse;
    const uint32_t bits = lut[static_cast<int>(g) + 128];
    if (bits == 1u) sel[i >> 2] |= 0xffu << (8 * (i & 3));
    if (bits > 1u) blended |= 1u << i;
    run_bits |= static_cast<uint64_t>(bits) << (4 * i);
  }

  const size_t px = static_cast<size_t>(y) * kObs + x0;
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    const size_t src = (static_cast<size_t>(b) * kChannels + c) * kPlane + px;
    const uint4 bg = ld16(args.bg_bank + src);
    const uint4 wl = ld16(args.walled + src);
    uint8_t* dst =
        args.out + (static_cast<size_t>(e) * kChannels + c) * kPlane + px;
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(pick(sel[0], wl.x, bg.x), pick(sel[1], wl.y, bg.y),
                   pick(sel[2], wl.z, bg.z), pick(sel[3], wl.w, bg.w));
    for (uint32_t m = blended; m; m &= m - 1) {
      const int i = __ffs(m) - 1;
      const uint32_t bits = static_cast<uint32_t>(run_bits >> (4 * i)) & 0xfu;
      const float img = static_cast<float>(__ldg(args.bg_bank + src + i));
      dst[i] = blend_pixel(args, bits, img, c * kPlane + px + i,
                           kChannels * kPlane + px + i);
    }
  }
}

}  // namespace

// The plain C entry point (ctypes). Pointers as the wrapper checked them
// (render/maze_render.py: dtypes, shapes, one CUDA device, contiguous, the
// constants on 16-byte boundaries); `mouse` the four mouse kinds packed as
// int8 bytes, kind k in bits 8k..8k+7. Returns cudaGetLastError() after the
// launch, or -1 for arguments it cannot take.
extern "C" int maze_render_launch(const void* grid, const void* goal_pos,
                                  const void* pos, const void* face,
                                  const void* bg_index, const void* tables,
                                  const void* bg_bank, const void* walled,
                                  int num_bgs, const void* kinds,
                                  const void* layer_lut, int cheese,
                                  int mouse, void* out, int n, int dim,
                                  void* stream) {
  if (n < 0 || dim < 1 || dim > kMaxDim || num_bgs < 1) return -1;
  if (n == 0) return 0;
  Args args;
  args.grid = static_cast<const int8_t*>(grid);
  args.goal_pos = static_cast<const float*>(goal_pos);
  args.pos = static_cast<const float*>(pos);
  args.face = static_cast<const uint8_t*>(face);
  args.bg_index = static_cast<const int32_t*>(bg_index);
  args.tables = static_cast<const int32_t*>(tables);
  args.bg_bank = static_cast<const uint8_t*>(bg_bank);
  args.walled = static_cast<const uint8_t*>(walled);
  args.kinds = static_cast<const __nv_bfloat16*>(kinds);
  args.layer_lut = static_cast<const uint8_t*>(layer_lut);
  args.out = static_cast<uint8_t*>(out);
  args.num_bgs = num_bgs;
  args.dim = dim;
  args.cheese = cheese;
  args.mouse = mouse;
  maze_render_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      args);
  return static_cast<int>(cudaGetLastError());
}
