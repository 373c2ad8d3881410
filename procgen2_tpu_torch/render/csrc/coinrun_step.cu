// Coinrun's game step for Hopper (sm_90a): the whole of
// games/coinrun.py::step_reference for every env in one launch. It replaces
// no TPU kernel: the JAX package runs the step as XLA ops, and the port ran
// it as plain torch ops, 12.5k kernels of ~1.4 us a step at 4096 envs on an
// H100, one per op of the 16 tile resolves (4 sub-steps x the agent, the
// lava, the mobs' wall and ledge sensors) and their masked selects.
//
// What it computes, per env (coinrun.cpp:341-391, common_systems.cpp:65-252):
//   * the mob sensors' 3x5 patches of collision types, once per step (a
//     mob's y never changes and its x moves <= 0.15 units a step);
//   * SUB_STEPS masked sub-steps, each: the alive mobs move and turn at a
//     wall or a ledge (`_mob_substep`, two resolves on the patches); the
//     agent's velocity, its resolve against the grid with one-way crates
//     and fallthrough, the saw, lava (a second resolve) and coin contacts
//     (`_agent_substep`); the mob contact after the mobs moved; then the
//     sub-step's results kept only where the env was still running, the
//     reward, done and anim_t;
//   * t + 1.
// Every f32 operation is the plain version's, in its order and with its
// rounding (built with --fmad=false, so that nothing is contracted into an
// FMA): the outputs equal the plain torch step bit for bit. The physics
// constants and the collision LUTs come from games/coinrun.py as arguments
// (`Consts`, each a Python float rounded to f32 as torch rounds a scalar
// operand); the literals left here are exact in f32 (box sizes, halves).
//
// Design for Hopper: the bound is bytes, a few hundred a env (its state,
// the 40 saw and 40 mob slots, the grid cells under its windows), ~1 us at
// 4096 envs; what remains is the work, 16 resolves of 18 cells each,
// chains of dependent f32 ops. One warp per env, four envs per block:
//   * lane i owns mob slots i and i + 32 and saw slots i and i + 32: it
//     reads them once into registers, builds its mobs' two patches once,
//     and moves its alive mobs in every sub-step, in parallel with the
//     other lanes' (a dead mob's update is discarded by the plain step, so
//     it is skipped; the output is the same);
//   * every lane computes the agent's sub-step itself (the same values in
//     each lane: no broadcast needed, and its grid reads coalesce into one
//     per warp); the saw and mob contacts are each lane's slots reduced
//     with __any_sync;
//   * an env that is done skips its remaining sub-steps, whose updates the
//     plain step masks out (warp-uniform: done is the same in all lanes);
//   * results are written once: the agent's fields by lane 0, each mob
//     slot by its lane.
// At 4096 envs on an H100 SXM (700 W) it takes 0.087-0.096 ms against the
// plain step's 137 ms (eager). It holds 128 registers a thread, so 16
// warps an SM and two waves of envs; capping it at 64 (8 blocks an SM, one
// wave, with spills) gained 3%, at 80 or 40 it lost: the time is the
// instructions each warp issues (4 resolves a sub-step, the agent's two
// in every lane), not occupancy.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles.cuh"

namespace {

using tiles::Rect;
using tiles::Resolved;

constexpr int kWarp = 32;
constexpr int kEnvsPerBlock = 4;
constexpr int kSlotsPerLane = 2;
constexpr int kMaxSlots = kWarp * kSlotsPerLane;  // saws and mobs each
constexpr int kPatch = 5;  // mob sensor patch width (fetch_window_patch)

}  // namespace

// The physics constants, in the order of physics/coinrun_step.py's
// `Consts` (tests/test_torch_coinrun_step.py holds the two lists equal).
struct Consts {
  float dt;            // DT
  float mix_ground;    // MIX
  float mix_air;       // MIX * AIR_CONTROL
  float max_speed;     // MAX_SPEED
  float max_jump;      // MAX_JUMP
  float gravity_dt;    // GRAVITY * DT
  float anim_dt;       // 0.1 * DT
  float down_only_vy;  // the one-way tiles' 0.01 (tiles.py)
  float sensor_dy;     // the mob sensors' 0.6
  float mob_top;       // the mob box's 0.48
  float mob_h;         // the mob box's 0.98
  float coin_reward;   // 10.0
};

// The collision LUTs, 2 bits per tile id (tiles::lut_type).
struct Luts {
  uint32_t agent, lava, wall, ledge;
  int oob;  // the tile id outside the grid
};

namespace {

struct Inputs {
  const int8_t* grid;  // [N, H, W]
  const float* pos;    // [N, 2]
  const float* vel;    // [N, 2]
  const uint8_t* on_ground;
  const uint8_t* face_forward;
  const float* anim_t;
  const float* mob_pos;  // [N, M, 2]
  const float* mob_vx;   // [N, M]
  const uint8_t* mob_alive;
  const float* saw_pos;  // [N, S, 2]
  const uint8_t* saw_alive;
  const float* coin_pos;  // [N, 2]
  const int32_t* t;
  const int32_t* action;
};

struct Outputs {
  float* pos;
  float* vel;
  uint8_t* on_ground;
  uint8_t* face_forward;
  float* anim_t;
  float* mob_pos;
  float* mob_vx;
  int32_t* t;
  float* reward;
  uint8_t* done;
};

struct Shape {
  int N, H, W, M, S, sub_steps;
};

// tile_at: the id at (tx, ty), `oob` outside the grid.
__device__ __forceinline__ int tile_at(const int8_t* grid, const Shape& s,
                                       int tx, int ty, int oob) {
  const bool inb = tx >= 0 && tx < s.W && ty >= 0 && ty < s.H;
  return inb ? (int)__ldg(grid + ty * s.W + tx) : oob;
}

// The 3x3 window at (lx, ly) of the grid under `lut`, packed as
// tiles::resolve takes it (resolve_tile_collisions' window).
__device__ __forceinline__ uint32_t grid_window(const int8_t* grid,
                                                const Shape& s, int lx,
                                                int ly, uint32_t lut,
                                                int oob) {
  uint32_t types = 0;
#pragma unroll
  for (int dy = 0; dy < tiles::kWindow; ++dy) {
#pragma unroll
    for (int dx = 0; dx < tiles::kWindow; ++dx) {
      const int id = tile_at(grid, s, lx + dx, ly + dy, oob);
      types |= tiles::lut_type(lut, id) << (2 * (tiles::kWindow * dy + dx));
    }
  }
  return types;
}

// The 3 x kPatch patch at (lx0, ly) under `lut`, cell (r, c) at bits
// 2 * (kPatch * r + c) (fetch_window_patch, then the LUT).
__device__ __forceinline__ uint32_t patch_types(const int8_t* grid,
                                                const Shape& s, int lx0,
                                                int ly, uint32_t lut,
                                                int oob) {
  uint32_t types = 0;
  for (int r = 0; r < tiles::kWindow; ++r) {
#pragma unroll
    for (int c = 0; c < kPatch; ++c) {
      const int id = tile_at(grid, s, lx0 + c, ly + r, oob);
      types |= tiles::lut_type(lut, id) << (2 * (kPatch * r + c));
    }
  }
  return types;
}

// The 3x3 window of a patch whose columns start at `col`
// (resolve_from_patch: col = clip(floor(x) - lx0, 0, kPatch - 3)).
__device__ __forceinline__ uint32_t patch_window(uint32_t patch, int col) {
  uint32_t types = 0;
#pragma unroll
  for (int r = 0; r < tiles::kWindow; ++r) {
    types |= ((patch >> (2 * (kPatch * r + col))) & 0x3fu)
             << (2 * tiles::kWindow * r);
  }
  return types;
}

// check_collision (physics/aabb.py) of the agent's box (ax, ay, 1, 1)
// with a box whose edges are given.
__device__ __forceinline__ bool touches(float ax, float ay, float bx0,
                                        float bx1, float by0, float by1) {
  return ax < bx1 && ax + 1.0f > bx0 && ay < by1 && ay + 1.0f > by0;
}

struct Mob {
  bool alive;
  float x, y, vx;
  int lx0;                    // the patches' first column
  int ly_wall, ly_ledge;      // floor of each sensor's y
  float y_wall, y_ledge;      // each sensor's y
  uint32_t wall, ledge;       // the patches under the two LUTs
};

__global__ void __launch_bounds__(kWarp * kEnvsPerBlock)
coinrun_step_kernel(const Inputs in, const Outputs out, const Shape s,
                    const Consts c, const Luts lut) {
  const int lane = threadIdx.x % kWarp;
  const int e = blockIdx.x * kEnvsPerBlock + threadIdx.x / kWarp;
  if (e >= s.N) return;  // whole warps: e is the same in every lane
  const int8_t* grid = in.grid + (size_t)e * s.H * s.W;

  // ---- the env's slots, once: lane i holds slots i and i + 32 ----
  Mob mob[kSlotsPerLane];
  bool saw_alive[kSlotsPerLane];
  float saw_x0[kSlotsPerLane], saw_x1[kSlotsPerLane];
  float saw_y0[kSlotsPerLane], saw_y1[kSlotsPerLane];
#pragma unroll
  for (int k = 0; k < kSlotsPerLane; ++k) {
    const int slot = lane + kWarp * k;
    Mob& m = mob[k];
    m.alive = false;
    if (slot < s.M) {
      const size_t i = (size_t)e * s.M + slot;
      m.alive = in.mob_alive[i] != 0;
      m.x = in.mob_pos[2 * i];
      m.y = in.mob_pos[2 * i + 1];
      m.vx = in.mob_vx[i];
    }
    if (m.alive) {
      // coinrun.py: lx0 = floor(x - 0.5) - 1, the patches' rows at
      // floor(y -+ 0.6)
      m.lx0 = tiles::to_i32(floorf(m.x - 0.5f)) - 1;
      m.y_wall = m.y - c.sensor_dy;
      m.y_ledge = m.y + c.sensor_dy;
      m.ly_wall = tiles::to_i32(floorf(m.y_wall));
      m.ly_ledge = tiles::to_i32(floorf(m.y_ledge));
      m.wall = patch_types(grid, s, m.lx0, m.ly_wall, lut.wall, lut.oob);
      m.ledge = patch_types(grid, s, m.lx0, m.ly_ledge, lut.ledge, lut.oob);
    }
    saw_alive[k] = false;
    if (slot < s.S) {
      const size_t i = (size_t)e * s.S + slot;
      saw_alive[k] = in.saw_alive[i] != 0;
      // the saw's bounds (x - 0.5, y - 0.5, 1, 1)
      saw_x0[k] = in.saw_pos[2 * i] - 0.5f;
      saw_y0[k] = in.saw_pos[2 * i + 1] - 0.5f;
      saw_x1[k] = saw_x0[k] + 1.0f;
      saw_y1[k] = saw_y0[k] + 1.0f;
    }
  }
  const float coin_x0 = in.coin_pos[2 * e] - 0.5f;
  const float coin_y0 = in.coin_pos[2 * e + 1] - 0.5f;
  const float coin_x1 = coin_x0 + 1.0f, coin_y1 = coin_y0 + 1.0f;

  // ---- the agent's state and action ----
  float px = in.pos[2 * e], py = in.pos[2 * e + 1];
  float vel_x = in.vel[2 * e], vel_y = in.vel[2 * e + 1];
  bool on_ground = in.on_ground[e] != 0;
  bool face_forward = in.face_forward[e] != 0;
  float anim_t = in.anim_t[e];
  const int a = in.action[e];
  const float movement_x = (float)(a == 6 || a == 7 || a == 8) -
                           (float)(a == 0 || a == 1 || a == 2);
  const bool jump = a == 2 || a == 5 || a == 8;
  const bool fallthrough = a == 0 || a == 3 || a == 6;

  bool done = false;
  float reward = 0.0f;
  for (int sub = 0; sub < s.sub_steps && !done; ++sub) {
    // ---- _mob_substep: each lane's alive mobs ----
#pragma unroll
    for (int k = 0; k < kSlotsPerLane; ++k) {
      Mob& m = mob[k];
      if (!m.alive) continue;
      const float x = m.x + m.vx * c.dt;
      const float sx = x - 0.5f;
      const int lx = tiles::to_i32(floorf(sx));
      const int col = min(max(lx - m.lx0, 0), kPatch - tiles::kWindow);
      // wall sensor (x - 0.5, y - 0.6, 1, 0.5): full vs walls
      const Resolved w = tiles::resolve(
          patch_window(m.wall, col), lx, m.ly_wall,
          tiles::rect(sx, m.y_wall, 1.0f, 0.5f, 0.5f, 0.25f), false, 0.0f,
          c.down_only_vy);
      // ledge sensor (x - 0.5, y + 0.6, 1, 0.5): "collides with empty"
      const Resolved f = tiles::resolve(
          patch_window(m.ledge, col), lx, m.ly_ledge,
          tiles::rect(sx, m.y_ledge, 1.0f, 0.5f, 0.5f, 0.25f), false, 0.0f,
          c.down_only_vy);
      const float new_x = f.collided ? f.rx + 0.5f : w.rx + 0.5f;
      m.vx = (w.collided || f.collided) ? -m.vx : m.vx;
      m.x = new_x;
    }

    // ---- _agent_substep, in every lane ----
    const float mix_x = on_ground ? c.mix_ground : c.mix_air;
    float vx = vel_x + mix_x * (c.max_speed * movement_x - vel_x) * c.dt;
    vx = fabsf(vx) < mix_x * c.max_speed * c.dt ? 0.0f : vx;
    float vy = (jump && on_ground) ? -c.max_jump : vel_y;
    vy = vy + c.gravity_dt;
    // torch.clamp: a NaN passes through
    vy = vy != vy ? vy : fminf(fmaxf(vy, -c.max_jump), c.max_jump);
    float x = px + vx * c.dt;
    float y = py + vy * c.dt;

    // collision box (-0.5, -1, 1, 1) (coinrun.cpp:492)
    const float bx = x - 0.5f, by = y - 1.0f;
    const int blx = tiles::to_i32(floorf(bx));
    const int bly = tiles::to_i32(floorf(by));
    const Resolved body = tiles::resolve(
        grid_window(grid, s, blx, bly, lut.agent, lut.oob), blx, bly,
        tiles::rect(bx, by, 1.0f, 1.0f, 0.5f, 0.5f), fallthrough,
        vy * c.dt, c.down_only_vy);
    const float dx_moved = body.rx - (x - 0.5f);
    const float dy_moved = body.ry - (y - 1.0f);
    const bool new_on_ground = dy_moved < 0.0f && body.collided;
    x = body.rx + 0.5f;
    y = body.ry + 1.0f;
    vx = dx_moved != 0.0f ? 0.0f : vx;
    vy = new_on_ground ? 0.0f : vy;

    // hazards and the coin, the agent's box 1x1 above the feet
    const float ax = x - 0.5f, ay = y - 1.0f;
    const int alx = tiles::to_i32(floorf(ax));
    const int aly = tiles::to_i32(floorf(ay));
    const bool lava = tiles::resolve(
        grid_window(grid, s, alx, aly, lut.lava, lut.oob), alx, aly,
        tiles::rect(ax, ay, 1.0f, 1.0f, 0.5f, 0.5f), false, 0.0f,
        c.down_only_vy).collided;
    const bool achieved = touches(ax, ay, coin_x0, coin_x1, coin_y0, coin_y1);

    // saw and mob contacts over this lane's slots; mob bounds
    // (-0.5, -0.48, 1, 0.98) after the mobs moved
    bool hit = false;
#pragma unroll
    for (int k = 0; k < kSlotsPerLane; ++k) {
      hit = hit || (saw_alive[k] && touches(ax, ay, saw_x0[k], saw_x1[k],
                                            saw_y0[k], saw_y1[k]));
      const Mob& m = mob[k];
      if (m.alive) {
        const float mx0 = m.x - 0.5f, my0 = m.y - c.mob_top;
        hit = hit || touches(ax, ay, mx0, mx0 + 1.0f, my0, my0 + c.mob_h);
      }
    }
    const bool dead = __any_sync(0xffffffffu, hit) || lava;

    // ---- the sub-step's results: this env is running ----
    px = x;
    py = y;
    vel_x = vx;
    vel_y = vy;
    on_ground = new_on_ground;
    face_forward = movement_x > 0.0f ? true
                   : movement_x < 0.0f ? false
                                       : face_forward;
    // torch.remainder(anim_t + 0.1 * DT, 1.0)
    float r = fmodf(anim_t + c.anim_dt, 1.0f);
    if (r != 0.0f && r < 0.0f) r += 1.0f;
    anim_t = r;
    reward = achieved ? c.coin_reward : 0.0f;
    done = dead || achieved;
  }

  // ---- outputs ----
#pragma unroll
  for (int k = 0; k < kSlotsPerLane; ++k) {
    const int slot = lane + kWarp * k;
    if (slot < s.M) {
      const size_t i = (size_t)e * s.M + slot;
      const Mob& m = mob[k];
      out.mob_pos[2 * i] = m.alive ? m.x : in.mob_pos[2 * i];
      out.mob_pos[2 * i + 1] = in.mob_pos[2 * i + 1];
      out.mob_vx[i] = m.alive ? m.vx : in.mob_vx[i];
    }
  }
  if (lane == 0) {
    out.pos[2 * e] = px;
    out.pos[2 * e + 1] = py;
    out.vel[2 * e] = vel_x;
    out.vel[2 * e + 1] = vel_y;
    out.on_ground[e] = on_ground;
    out.face_forward[e] = face_forward;
    out.anim_t[e] = anim_t;
    out.t[e] = (int32_t)((uint32_t)in.t[e] + 1u);
    out.reward[e] = reward;
    out.done[e] = done;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Tensor pointers are device
// pointers of contiguous tensors checked by the Python wrapper
// (physics/coinrun_step.py): grid int8 [N, H, W]; pos, vel, coin_pos f32
// [N, 2]; on_ground, face_forward bool [N]; anim_t f32 [N]; mob_pos f32
// [N, M, 2], mob_vx f32 [N, M], mob_alive bool [N, M]; saw_pos f32
// [N, S, 2], saw_alive bool [N, S]; t, action int32 [N]; the outputs
// likewise, reward f32 [N] and done bool [N]. `consts` is a host pointer.
// Returns 0, a cudaError_t, or -1 for a shape the kernel does not take.
extern "C" int coinrun_step_launch(
    const void* grid, const void* pos, const void* vel, const void* on_ground,
    const void* face_forward, const void* anim_t, const void* mob_pos,
    const void* mob_vx, const void* mob_alive, const void* saw_pos,
    const void* saw_alive, const void* coin_pos, const void* t,
    const void* action, void* pos_out, void* vel_out, void* on_ground_out,
    void* face_forward_out, void* anim_t_out, void* mob_pos_out,
    void* mob_vx_out, void* t_out, void* reward_out, void* done_out, int N,
    int H, int W, int M, int S, int sub_steps, const Consts* consts,
    uint32_t lut_agent, uint32_t lut_lava, uint32_t lut_wall,
    uint32_t lut_ledge, int oob, void* stream) {
  if (N < 0 || H <= 0 || W <= 0 || M < 0 || M > kMaxSlots || S < 0 ||
      S > kMaxSlots || sub_steps < 0 || consts == nullptr) {
    return -1;
  }
  if (N == 0) return 0;
  const Inputs in{
      static_cast<const int8_t*>(grid),       static_cast<const float*>(pos),
      static_cast<const float*>(vel),
      static_cast<const uint8_t*>(on_ground),
      static_cast<const uint8_t*>(face_forward),
      static_cast<const float*>(anim_t),      static_cast<const float*>(mob_pos),
      static_cast<const float*>(mob_vx),
      static_cast<const uint8_t*>(mob_alive),
      static_cast<const float*>(saw_pos),
      static_cast<const uint8_t*>(saw_alive),
      static_cast<const float*>(coin_pos),    static_cast<const int32_t*>(t),
      static_cast<const int32_t*>(action)};
  const Outputs out{static_cast<float*>(pos_out),
                    static_cast<float*>(vel_out),
                    static_cast<uint8_t*>(on_ground_out),
                    static_cast<uint8_t*>(face_forward_out),
                    static_cast<float*>(anim_t_out),
                    static_cast<float*>(mob_pos_out),
                    static_cast<float*>(mob_vx_out),
                    static_cast<int32_t*>(t_out),
                    static_cast<float*>(reward_out),
                    static_cast<uint8_t*>(done_out)};
  const Shape shape{N, H, W, M, S, sub_steps};
  const Luts luts{lut_agent, lut_lava, lut_wall, lut_ledge, oob};
  const int blocks = (N + kEnvsPerBlock - 1) / kEnvsPerBlock;
  coinrun_step_kernel<<<blocks, kWarp * kEnvsPerBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(in, out, shape,
                                                             *consts, luts);
  return static_cast<int>(cudaGetLastError());
}
