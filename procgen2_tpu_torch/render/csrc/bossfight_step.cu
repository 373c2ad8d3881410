// Bossfight's game step for Hopper (sm_90a): the whole of
// games/bossfight.py::step_reference for every env in one launch. It
// replaces no TPU kernel: the JAX package runs the step as XLA ops, and the
// port ran it as plain torch ops, ~15.8k kernels of ~1.2 us a step at 4096
// envs on an H100, one per op of the 4 masked sub-steps (threefry draws,
// the volley's cos/sin, one-hot pushes into the bullet rings, hit tests and
// ~30 selects each).
//
// What it computes, per env and sub-step (bossfight.cpp:308-325,
// common_systems.cpp:75-386), in the plain step's order:
//   * the 7-way threefry split of the env's key, the bounce, shield, weapon,
//     volley, damage and move draws (`random.py`: threefry-2x32, `uniform`
//     with its f32 multiply-add taken in f64 and rounded once, `randint`);
//   * the agent's move and clamp, its bullet's spawn into the 32-slot ring,
//     its contact with the boss and the barriers, the ring's hits (arena,
//     boss, barriers), bounces, explosions and timeouts;
//   * the boss's phase, weapon and HP, `_fire_pattern`'s volley into the
//     64-slot ring with glibc's sincosf (`trig.py`, in f64), the damage show
//     and the 8-slot explosion pool, the boss's move, the boss ring's hits
//     and explosions, the reward and done;
//   * the sub-step's results kept only where the env still ran, except the
//     key and the boss ring, which run on after the episode's end;
// then t + 1. Every f32 and f64 operation is the plain version's, in its
// order and with its rounding (built with --fmad=false, so that nothing is
// contracted into an FMA): the outputs equal the plain torch step bit for
// bit. The game's constants come from games/bossfight.py as arguments
// (`Consts`, each a Python float rounded to f32 as torch rounds a scalar
// operand, and the volley tables as the plain step holds them); the
// literals left here are exact in f32 (frame codes, halves, thresholds
// written as integers in the plain step).
//
// Design for Hopper: the bound is bytes, the state's ~2.6 KB an env read
// and written once, ~6 us at 4096 envs; what remains is the work, chains of
// dependent integer (threefry) and f32 ops. One warp per env, four envs per
// block:
//   * lane i owns agent-ring slot i, boss-ring slots i and i + 32 and (i < 8)
//     explosion slot i, in registers for the four sub-steps; reads and
//     writes coalesce by slot;
//   * the scalar work (the agent, the boss, the timers) runs in every lane
//     with the same values, so nothing needs a broadcast; counts and `any`s
//     over the slots are ballots;
//   * the draws are spread over the lanes: lane i draws its bounce (counter
//     i), lanes 0-8 each one of the nine other draws (a split and a bits
//     call), read back with shuffles; lanes 0-7 each take one bullet of the
//     volley and its sincosf;
//   * a volley's push j lands at the ring's next slot plus the number of
//     earlier pushes that fired, refused once the ring holds 64: the 8
//     one-hot pushes in order give the same ring;
//   * a done env still runs every sub-step (its key and boss ring move on);
//     only the commits are masked, as in the plain step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kEnvsPerBlock = 4;
constexpr int kABullets = 32;    // NUM_A_BULLETS: one slot a lane
constexpr int kBBullets = 64;    // NUM_B_BULLETS: two slots a lane
constexpr int kExplosions = 8;   // NUM_EXPLOSIONS: lanes 0-7
constexpr int kBarriers = 4;     // MAX_BARRIERS
constexpr int kVolley = 8;       // _fire_pattern's pushes
constexpr int kDraws = 9;        // the draws other than the bounce
constexpr unsigned kFull = 0xffffffffu;

}  // namespace

// The game's constants, in the order of physics/bossfight_step.py's
// `Consts` (tests/test_torch_bossfight_step.py holds the two lists equal).
struct Consts {
  float dt;               // DT
  float move_mix;         // MOVE_MIX
  float move_speed;       // MOVE_SPEED
  float lo_x;             // the agent's clamp: -HALF + 0.15
  float hi_x;             // HALF - 0.15
  float lo_y;             // -HALF + 0.1
  float hi_y;             // HALF - 0.1
  float a_bullet_time;    // A_BULLET_TIME
  float a_bullet_vy;      // -A_BULLET_SPEED
  float bounce_speed;     // BOUNCE_SPEED
  float bounce_time;      // BOUNCE_TIME
  float explosion_dt;     // EXPLOSION_RATE * DT
  float agent_dx;         // the agent's box (-0.15, -0.1, 0.3, 0.2)
  float agent_dy;
  float agent_w;
  float agent_h;
  float boss_dx;          // the boss's box (-0.6, -0.4, 1.2, 0.8)
  float boss_dy;
  float boss_w;
  float boss_h;
  float bullet_half;      // a bullet's box (-0.01, -0.01, 0.02, 0.02)
  float bullet_size;
  float barrier_half;     // a barrier's box (-0.1, -0.1, 0.2, 0.2)
  float barrier_size;
  float half;             // HALF: the arena is (-HALF, -HALF, 2 HALF, 2 HALF)
  float unshielded_time;  // UNSHIELDED_TIME
  float damage_time;      // DAMAGE_TIME
  float move_time;        // MOVE_TIME
  float inv_move_time;    // _INV_MOVE_TIME
  float target_x_scale;   // the move target's 0.7
  float target_y_shift;   // the move target's 0.3
  float pi;               // _PI
  float passive_p;        // the passive shot's 0.1 * DT
  float bullet_speed;     // Config.bullet_speed
  float shield_jitter;    // Config.shield_jitter
  float fan[kVolley];     // _volley_tables: pattern 0's rotations
  float cross[kVolley];   // pattern 1's
  float radial[kVolley];  // pattern 2's offsets
  int boss_hp;            // BOSS_HP
  int num_weapons;        // NUM_WEAPONS
};

// The state's fields, in the order of bossfight.State (and of
// physics/bossfight_step.py's FIELDS): element type and name.
#define BOSSFIGHT_FIELDS(X)                                                  \
  X(float, pos) X(float, vel) X(uint8_t, alive) X(float, a_bullet_timer)     \
  X(float, ab_pos) X(float, ab_vel) X(float, ab_frame)                       \
  X(uint8_t, ab_bouncing) X(float, ab_bounce_timer) X(int32_t, ab_num)       \
  X(int32_t, ab_next) X(float, boss_pos) X(float, boss_vel)                  \
  X(float, phase_timer) X(int32_t, phase_index) X(int32_t, weapon_index)     \
  X(float, attack_timer) X(int32_t, hp) X(float, move_timer)                 \
  X(float, explosion_timer) X(float, damage_timer) X(float, bb_pos)          \
  X(float, bb_vel) X(float, bb_rot) X(float, bb_frame) X(int32_t, bb_num)    \
  X(int32_t, bb_next) X(float, ex_pos) X(float, ex_frame) X(int32_t, ex_num) \
  X(int32_t, ex_next) X(int32_t, t) X(int64_t, rng)

namespace {

#define BOSSFIGHT_IN(type, name) const type* name;
#define BOSSFIGHT_OUT(type, name) type* name;
struct StateIn {
  BOSSFIGHT_FIELDS(BOSSFIGHT_IN)
  const float* barrier_pos;       // [N, 4, 2]
  const uint8_t* barrier_exists;  // [N, 4]
  const int32_t* action;          // [N]
};
struct StateOut {
  BOSSFIGHT_FIELDS(BOSSFIGHT_OUT)
  float* reward;  // [N]
  uint8_t* done;  // [N]
};
#undef BOSSFIGHT_IN
#undef BOSSFIGHT_OUT

// ---------------------------------------------------------------------------
// threefry-2x32 and the draws (random.py)
// ---------------------------------------------------------------------------

struct Key {
  uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32 with 20 rounds of key (k.a, k.b) on (x1, x2)
// (random.py: _threefry2x32).
__device__ __forceinline__ Key threefry(Key k, uint32_t x1, uint32_t x2) {
  const uint32_t ks[3] = {k.a, k.b, k.a ^ k.b ^ 0x1BD11BDAu};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r0 = i % 2 ? 17 : 13, r1 = i % 2 ? 29 : 15;
    const int r2 = i % 2 ? 16 : 26, r3 = i % 2 ? 24 : 6;
    x1 += x2; x2 = rotl(x2, r0) ^ x1;
    x1 += x2; x2 = rotl(x2, r1) ^ x1;
    x1 += x2; x2 = rotl(x2, r2) ^ x1;
    x1 += x2; x2 = rotl(x2, r3) ^ x1;
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return Key{x1, x2};
}

// split(k, n)[j]
__device__ __forceinline__ Key split_at(Key k, uint32_t j) {
  return threefry(k, 0u, j);
}

// the random bits of element j of a draw from k (o1 ^ o2)
__device__ __forceinline__ uint32_t bits_at(Key k, uint32_t j) {
  const Key o = threefry(k, 0u, j);
  return o.a ^ o.b;
}

// uniform(k, minval=lo, maxval=hi) from its bits: floats * (hi - lo) + lo
// taken in f64 and rounded to f32 once (random._fma32), then max(lo, .)
__device__ __forceinline__ float uniform(uint32_t bits, float lo, float hi) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  const float r = (float)((double)f * (double)(hi - lo) + (double)lo);
  return r != r ? r : fmaxf(lo, r);
}

// randint(k, (), lo, hi) from its two words (random.randint_from_bits)
__device__ __forceinline__ int randint(uint32_t higher, uint32_t lower,
                                       int lo, int hi) {
  const uint32_t span = hi <= lo ? 1u : (uint32_t)hi - (uint32_t)lo;
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  uint32_t off = (higher % span) * mult + lower % span;
  off %= span;
  return (int)((uint32_t)lo + off);
}

// ---------------------------------------------------------------------------
// glibc's sincosf in f64 (trig.py: _sincos)
// ---------------------------------------------------------------------------

__constant__ uint32_t kInvPio4[24] = {
    0xa2,       0xa2f9,     0xa2f983,   0xa2f9836e, 0xf9836e4e, 0x836e4e44,
    0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1,
    0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62,
    0xc0db6295, 0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041};

constexpr double kHpiInv = 0x1.45f306dc9c883p+23;
constexpr double kHpiHi = 0x1.921fb5p+0;    // pi/2's top 26 bits
constexpr double kHpiLo = 0x1.110b46p-26;   // pi/2 - kHpiHi
constexpr double kPi63 = 0x1.921fb54442d18p-62;
constexpr double kC0 = 1.0, kC1 = -0x1.ffffffd0c621cp-2;
constexpr double kC2 = 0x1.55553e1068f19p-5, kC3 = -0x1.6c087e89a359dp-10;
constexpr double kC4 = 0x1.99343027bf8c3p-16;
constexpr double kS1 = -0x1.555545995a603p-3, kS2 = 0x1.1107605230bc4p-7;
constexpr double kS3 = -0x1.994eb3774cf24p-13;
// the top 12 bits of 2**-12, pi/4 (0x3f490fdb), 120 and infinity
constexpr uint32_t kTopTiny = 0x398, kTopPio4 = 0x3F4, kTop120 = 0x42F;
constexpr uint32_t kTopInf = 0x7F8;

// (cos y, sin y), each bit for bit trig.cos32 / trig.sin32
__device__ __forceinline__ void sincos32(float y, float& cos_y,
                                         float& sin_y) {
  const uint32_t xi = __float_as_uint(y);
  const uint32_t top = (xi >> 20) & 0x7FF;
  const double x = (double)y;
  double r = x;
  int n = 0, n_poly = 0;
  if (top >= kTop120) {
    // reduce_large: the 2.62 fixed-point product with 4/pi
    const int base = (xi >> 26) & 15;
    const int shift = (xi >> 23) & 7;
    const uint32_t m = ((xi & 0xFFFFFFu) | 0x800000u) << shift;
    uint64_t res0 = (uint32_t)(m * kInvPio4[base]);
    const uint64_t res1 = (uint64_t)m * kInvPio4[base + 4];
    const uint64_t res2 = (uint64_t)m * kInvPio4[base + 8];
    res0 = (res2 >> 32) | (res0 << 32);
    res0 += res1;
    const uint64_t q = (res0 + (1ull << 61)) >> 62;
    res0 -= q << 62;
    r = (double)(int64_t)res0 * kPi63;
    n_poly = (int)q;
    n = n_poly + (int)(xi >> 31);
  } else if (top >= kTopPio4) {
    // reduce_fast: x - n * pi/2 in two exact products and one rounding
    const double rr = x * kHpiInv;
    n = ((int)rr + 0x800000) >> 24;
    const double nf = (double)n;
    r = (x - nf * kHpiHi) - nf * kHpiLo;
    n_poly = n;
  }
  const double sign = top < kTopPio4 ? 1.0 : ((n & 3) == 1 || (n & 3) == 2
                                                  ? -1.0 : 1.0);
  const double neg = (n & 2) ? -1.0 : 1.0;  // table 1: the cosine negated
  const double x2 = r * r;
  const double xs = r * sign;
  // sinf_poly, the sine: x + x3 * s1 + x7 * (s2 + x2 * s3)
  const double x3 = xs * x2;
  const double s1 = kS2 + x2 * kS3;
  const double x7 = x3 * x2;
  const double s = xs + x3 * kS1;
  const double sin_p = s + x7 * s1;
  // the cosine: c0 + x2 * c1 + x4 * c2 + x6 * (c3 + x2 * c4)
  const double x4 = x2 * x2;
  const double c2 = kC3 * neg + x2 * (kC4 * neg);
  const double c1 = kC0 * neg + x2 * (kC1 * neg);
  const double x6 = x4 * x2;
  const double c = c1 + x4 * (kC2 * neg);
  const double cos_p = c + x6 * c2;
  const bool odd = (n_poly & 1) != 0;  // sin takes the cosine polynomial
  sin_y = (float)(odd ? cos_p : sin_p);
  cos_y = (float)(odd ? sin_p : cos_p);
  if (top < kTopTiny) {
    sin_y = y;
    cos_y = 1.0f;
  }
  if (top >= kTopInf) sin_y = cos_y = __uint_as_float(0x7FC00000u);
}

// ---------------------------------------------------------------------------
// the step
// ---------------------------------------------------------------------------

// torch.remainder(x, n) for n > 0
__device__ __forceinline__ int floor_mod(int x, int n) {
  const int r = x % n;
  return r < 0 ? r + n : r;
}

// slot j of a ring in its window: the `num` slots before `next`
__device__ __forceinline__ bool in_window(int next, int num, int j, int n) {
  return floor_mod(next - 1 - j, n) < num;
}

// check_collision (physics/aabb.py): strict overlap, each sum rounded
__device__ __forceinline__ bool overlap(float ax, float ay, float aw,
                                        float ah, float bx, float by,
                                        float bw, float bh) {
  return ax < bx + bw && ax + aw > bx && ay < by + bh && ay + ah > by;
}

// torch.clamp(x, min=0.0): a NaN passes through
__device__ __forceinline__ float clamp_min0(float x) {
  return x != x ? x : fmaxf(x, 0.0f);
}

__device__ __forceinline__ int popc_ballot(bool p) {
  return __popc(__ballot_sync(kFull, p));
}

struct Barriers {
  float x[kBarriers], y[kBarriers];  // the boxes' corners
  bool exists[kBarriers];
};

// _hits_barriers: a bullet at (x, y) against the env's barriers
__device__ __forceinline__ bool hits_barriers(const Barriers& b,
                                              const Consts& c, float x,
                                              float y) {
  const float ax = x - c.bullet_half, ay = y - c.bullet_half;
  bool hit = false;
#pragma unroll
  for (int i = 0; i < kBarriers; ++i) {
    hit = hit || (b.exists[i] && overlap(ax, ay, c.bullet_size,
                                         c.bullet_size, b.x[i], b.y[i],
                                         c.barrier_size, c.barrier_size));
  }
  return hit;
}

// a bullet at (x, y) inside the arena
__device__ __forceinline__ bool in_arena(const Consts& c, float x, float y) {
  return overlap(x - c.bullet_half, y - c.bullet_half, c.bullet_size,
                 c.bullet_size, -c.half, -c.half, 2.0f * c.half,
                 2.0f * c.half);
}

// a constant table's entry j < kVolley, by selects (no local copy)
__device__ __forceinline__ float pick(const float (&table)[kVolley], int j) {
  float v = 0.0f;
#pragma unroll
  for (int i = 0; i < kVolley; ++i) v = i == j ? table[i] : v;
  return v;
}

struct BossBullet {
  float x, y, vx, vy, rot, frame;
};

__global__ void __launch_bounds__(kWarp * kEnvsPerBlock)
bossfight_step_kernel(const StateIn in, const StateOut out, const int N,
                      const int sub_steps, const Consts c) {
  const int lane = threadIdx.x % kWarp;
  const int e = blockIdx.x * kEnvsPerBlock + threadIdx.x / kWarp;
  if (e >= N) return;  // whole warps: e is the same in every lane

  // ---- the env's barriers and action ----
  Barriers bar;
#pragma unroll
  for (int i = 0; i < kBarriers; ++i) {
    bar.x[i] = in.barrier_pos[(e * kBarriers + i) * 2] - c.barrier_half;
    bar.y[i] = in.barrier_pos[(e * kBarriers + i) * 2 + 1] - c.barrier_half;
    bar.exists[i] = in.barrier_exists[e * kBarriers + i] != 0;
  }
  const int a = in.action[e];
  const float movement_x = (float)(a == 6 || a == 7 || a == 8) -
                           (float)(a == 0 || a == 1 || a == 2);
  const float movement_y = (float)(a == 2 || a == 5 || a == 8) -
                           (float)(a == 0 || a == 3 || a == 6);
  const bool fire = a == 9;

  // ---- the env's scalars, in every lane ----
  Key rng{(uint32_t)in.rng[2 * e], (uint32_t)in.rng[2 * e + 1]};
  bool alive = in.alive[e] != 0;
  float px = in.pos[2 * e], py = in.pos[2 * e + 1];
  float vel_x = in.vel[2 * e], vel_y = in.vel[2 * e + 1];
  float a_btimer = in.a_bullet_timer[e];
  int ab_num = in.ab_num[e], ab_next = in.ab_next[e];
  float boss_x = in.boss_pos[2 * e], boss_y = in.boss_pos[2 * e + 1];
  float boss_vx = in.boss_vel[2 * e], boss_vy = in.boss_vel[2 * e + 1];
  float phase_timer = in.phase_timer[e];
  int phase_index = in.phase_index[e], weapon_index = in.weapon_index[e];
  float attack_timer = in.attack_timer[e];
  int hp = in.hp[e];
  float move_timer = in.move_timer[e];
  float explosion_timer = in.explosion_timer[e];
  float damage_timer = in.damage_timer[e];
  int bb_num = in.bb_num[e], bb_next = in.bb_next[e];
  int ex_num = in.ex_num[e], ex_next = in.ex_next[e];

  // ---- the lane's slots ----
  const int ia = e * kABullets + lane;
  float ab_x = in.ab_pos[2 * ia], ab_y = in.ab_pos[2 * ia + 1];
  float ab_vx = in.ab_vel[2 * ia], ab_vy = in.ab_vel[2 * ia + 1];
  float ab_frame = in.ab_frame[ia];
  bool ab_bounc = in.ab_bouncing[ia] != 0;
  float ab_btime = in.ab_bounce_timer[ia];
  BossBullet bb[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int ib = e * kBBullets + lane + kWarp * k;
    bb[k] = BossBullet{in.bb_pos[2 * ib], in.bb_pos[2 * ib + 1],
                       in.bb_vel[2 * ib], in.bb_vel[2 * ib + 1],
                       in.bb_rot[ib],     in.bb_frame[ib]};
  }
  const bool ex_lane = lane < kExplosions;
  const int ie = e * kExplosions + (ex_lane ? lane : 0);
  float ex_x = 0.0f, ex_y = 0.0f, ex_frame = 0.0f;
  if (ex_lane) {
    ex_x = in.ex_pos[2 * ie];
    ex_y = in.ex_pos[2 * ie + 1];
    ex_frame = in.ex_frame[ie];
  }

  bool done = false;
  float reward = 0.0f;
  for (int sub = 0; sub < sub_steps; ++sub) {
    const bool active = !done;

    // ---- the draws: sp = split(rng, 7), rng = sp[0] ----
    // lane i: bits i of uniform(sp[6], (32,)), the bounce; lanes 0-8: the
    // shield (sp[1]), the weapon's two words (split(sp[2])), the volley's
    // u1 and u2 (split(sp[3])), the damage show's x and y (split(sp[5])),
    // the move's x and y (split(sp[4]))
    const uint32_t bounce_bits = bits_at(split_at(rng, 6), lane);
    uint32_t draw = 0;
    if (lane < kDraws) {
      const uint32_t src = lane == 0 ? 1 : lane <= 2 ? 2 : lane <= 4 ? 3
                           : lane <= 6 ? 5 : 4;
      Key k = split_at(rng, src);
      if (lane > 0) k = split_at(k, (lane - 1) & 1);
      draw = bits_at(k, 0);
    }
    rng = split_at(rng, 0);
    const uint32_t d_shield = __shfl_sync(kFull, draw, 0);
    const uint32_t d_weapon_hi = __shfl_sync(kFull, draw, 1);
    const uint32_t d_weapon_lo = __shfl_sync(kFull, draw, 2);
    const uint32_t d_u1 = __shfl_sync(kFull, draw, 3);
    const uint32_t d_u2 = __shfl_sync(kFull, draw, 4);
    const uint32_t d_dmg_x = __shfl_sync(kFull, draw, 5);
    const uint32_t d_dmg_y = __shfl_sync(kFull, draw, 6);
    const uint32_t d_move_x = __shfl_sync(kFull, draw, 7);
    const uint32_t d_move_y = __shfl_sync(kFull, draw, 8);

    // ================= System_Agent =================
    float n_vx = vel_x + c.move_mix * (movement_x * c.move_speed - vel_x) *
                             c.dt;
    float n_vy = vel_y + c.move_mix * (-movement_y * c.move_speed - vel_y) *
                             c.dt;
    const float ux = px + n_vx * c.dt, uy = py + n_vy * c.dt;
    const float npx = ux != ux ? ux : fminf(fmaxf(ux, c.lo_x), c.hi_x);
    const float npy = uy != uy ? uy : fminf(fmaxf(uy, c.lo_y), c.hi_y);
    n_vx = npx != ux ? 0.0f : n_vx;
    n_vy = npy != uy ? 0.0f : n_vy;

    // fire a player bullet into slot ab_next
    const bool can_spawn = fire && a_btimer == 0.0f && ab_num < kABullets;
    const bool upd_ab = can_spawn && lane == ab_next;
    float nab_x = upd_ab ? npx : ab_x, nab_y = upd_ab ? npy : ab_y;
    float nab_vx = upd_ab ? 0.0f : ab_vx;
    float nab_vy = upd_ab ? c.a_bullet_vy : ab_vy;
    float nab_frame = upd_ab ? 0.0f : ab_frame;
    bool nab_bounc = ab_bounc && !upd_ab;
    float nab_btime = upd_ab ? 0.0f : ab_btime;
    const int n_ab_next = can_spawn ? floor_mod(ab_next + 1, kABullets)
                                    : ab_next;
    int n_ab_num = ab_num + (int)can_spawn;
    const float n_abtimer =
        can_spawn ? c.a_bullet_time
                  : (fire ? clamp_min0(a_btimer - c.dt) : a_btimer);

    // the agent against the boss and the barriers
    const float agx = npx - c.agent_dx, agy = npy - c.agent_dy;
    bool contact = overlap(agx, agy, c.agent_w, c.agent_h,
                           boss_x - c.boss_dx, boss_y - c.boss_dy, c.boss_w,
                           c.boss_h);
#pragma unroll
    for (int i = 0; i < kBarriers; ++i) {
      contact = contact || (bar.exists[i] &&
                            overlap(agx, agy, c.agent_w, c.agent_h, bar.x[i],
                                    bar.y[i], c.barrier_size,
                                    c.barrier_size));
    }
    bool n_alive = alive && !contact;
    const bool agent_alive_now = n_alive;

    // the player's bullets
    const bool window = in_window(n_ab_next, n_ab_num, lane, kABullets);
    const bool live = window && nab_frame == 0.0f;
    const bool offscreen = live && !in_arena(c, nab_x, nab_y);
    const bool shielded = (phase_index & 1) == 0;
    const bool boss_hit =
        live && !offscreen &&
        overlap(nab_x - c.bullet_half, nab_y - c.bullet_half, c.bullet_size,
                c.bullet_size, boss_x - c.boss_dx, boss_y - c.boss_dy,
                c.boss_w, c.boss_h);
    const bool bounce = boss_hit && shielded;
    const bool damage = boss_hit && !shielded;
    const bool barrier_hit = live && !offscreen && !boss_hit &&
                             hits_barriers(bar, c, nab_x, nab_y);
    if (bounce) {
      nab_vx = uniform(bounce_bits, -1.0f, 1.0f) * c.bounce_speed;
      nab_vy = c.bounce_speed;
      nab_btime = c.bounce_time;
    }
    nab_bounc = nab_bounc || bounce;
    if (damage || barrier_hit) {
      nab_vx = 0.0f;
      nab_vy = 0.0f;
      nab_frame = 1.0f;
    }
    if (offscreen) {
      nab_frame = 5.0f;
      nab_vx = 0.0f;
      nab_vy = 0.0f;
    }
    int n_hp = max(hp - popc_ballot(damage), 0);
    if (window) {
      nab_x = nab_x + nab_vx * c.dt;
      nab_y = nab_y + nab_vy * c.dt;
    }
    bool expired = window && nab_frame >= 5.0f;
    const bool exploding = window && nab_frame >= 1.0f && nab_frame < 5.0f;
    if (exploding) nab_frame = nab_frame + c.explosion_dt;
    // a bounce timeout destroys the bullet
    const bool ticking = window && nab_bounc && nab_btime > 0.0f;
    if (ticking) nab_btime = clamp_min0(nab_btime - c.dt);
    expired = expired ||
              (window && nab_bounc && nab_btime == 0.0f && !ticking);
    if (expired) nab_frame = -1.0f;
    n_ab_num -= popc_ballot(expired);

    // ================= System_Mob_AI (the boss) =================
    const float shielded_phase_time =
        (float)((double)uniform(d_shield, 0.0f, 1.0f) *
                    (double)c.shield_jitter +
                180.0);
    // a phase start re-rolls the weapon and HP
    const bool at_start = phase_timer == 0.0f;
    const int n_weapon =
        at_start ? randint(d_weapon_hi, d_weapon_lo, 0, c.num_weapons)
                 : weapon_index;
    float n_attack = at_start ? 0.0f : attack_timer;
    n_hp = at_start ? c.boss_hp : n_hp;
    const bool adv = (shielded && phase_timer >= shielded_phase_time) ||
                     (!shielded && phase_timer >= c.unshielded_time);
    const float n_phase_timer = adv ? 0.0f : phase_timer + c.dt;
    int n_phase_index = phase_index + (int)adv;

    // _fire_pattern: lane j < 8 holds the volley's bullet j
    const int pattern = shielded ? n_weapon : -1;
    const float u1 = uniform(d_u1, 0.0f, 1.0f);
    const float u2 = uniform(d_u2, 0.0f, 1.0f);
    const bool passive_fire = pattern == -1 && u1 < c.passive_p;
    const float aimed_rot = c.pi * (1.0f + u2);
    const float limit = pattern == 0   ? 8.0f
                        : pattern == 1 ? 5.0f
                        : pattern == 2 ? 10.0f
                                       : 4.0f;
    const bool timer_done = n_attack >= limit && pattern >= 0;
    const int n_per = pattern == 0 ? 5 : pattern == 1 ? 4 : pattern == 2 ? 8
                                                                          : 1;
    const float two_u2 = u2 * 2.0f;
    const float radial = pick(c.radial, lane);
    float rot = pattern == 0   ? pick(c.fan, lane)
                : pattern == 1 ? pick(c.cross, lane)
                : pattern == 2 ? radial + two_u2 * c.pi
                               : aimed_rot;
    bool fires = lane < n_per && timer_done;
    fires = (pattern == -1 ? lane == 0 : fires) &&
            ((pattern >= 0 && timer_done) || passive_fire);
    fires = fires && lane < kVolley;
    if (pattern == -1) rot = aimed_rot;
    const unsigned fired = __ballot_sync(kFull, fires);
    if (fired) {
      // the bullet's velocity (cos r, -sin r) * speed; where the radial
      // volley's angle feeds cos/sin, u * 2 * pi + offset is one f32
      // multiply-add (random._fma32)
      const float angle =
          pattern == 2 ? (float)((double)two_u2 * (double)c.pi +
                                 (double)radial)
                       : rot;
      float cos_r, sin_r;
      sincos32(angle, cos_r, sin_r);
      const float bvx = cos_r * c.bullet_speed;
      const float bvy = -sin_r * c.bullet_speed;
      // push j lands after the earlier pushes that fired, while the ring
      // holds fewer than 64
      const int rank = __popc(fired & ((1u << lane) - 1u));
      const bool accepted = fires && bb_num + rank < kBBullets;
      const int slot = rank == 0 ? bb_next
                                 : floor_mod(bb_next + rank, kBBullets);
      unsigned pushes = __ballot_sync(kFull, accepted);
      const int n_acc = __popc(pushes);
      while (pushes) {
        const int j = __ffs(pushes) - 1;
        pushes &= pushes - 1;
        const int s = __shfl_sync(kFull, slot, j);
        const float vx = __shfl_sync(kFull, bvx, j);
        const float vy = __shfl_sync(kFull, bvy, j);
        const float r = __shfl_sync(kFull, rot, j);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (s == lane + kWarp * k) {
            bb[k] = BossBullet{boss_x, boss_y, vx, vy, r, 0.0f};
          }
        }
      }
      if (n_acc > 0) bb_next = floor_mod(bb_next + n_acc, kBBullets);
      bb_num += n_acc;
    }
    if (pattern >= 0) n_attack = timer_done ? 0.0f : n_attack + c.dt;

    // HP depleted: the damage show and an extra phase advance
    const bool depleted = !shielded && n_hp == 0;
    const bool show = depleted && explosion_timer >= 8.0f;
    const float n_expl_timer =
        depleted ? (show ? 0.0f : explosion_timer + c.dt) : explosion_timer;
    const bool can_ex = show && ex_num < kExplosions;
    const bool upd_ex = can_ex && ex_lane && lane == ex_next;
    float nex_x = ex_x, nex_y = ex_y, nex_frame = ex_frame;
    if (upd_ex) {
      nex_x = boss_x + uniform(d_dmg_x, -0.5f, 0.5f);
      nex_y = boss_y + uniform(d_dmg_y, -0.5f, 0.5f);
      nex_frame = 0.0f;
    }
    const int n_ex_next = can_ex ? floor_mod(ex_next + 1, kExplosions)
                                 : ex_next;
    int n_ex_num = ex_num + (int)can_ex;
    const bool dmg_done = depleted && damage_timer >= c.damage_time;
    const float n_damage_timer =
        depleted ? (dmg_done ? 0.0f : damage_timer + c.dt) : damage_timer;
    n_phase_index += (int)dmg_done;
    n_hp = dmg_done ? c.boss_hp : n_hp;

    // the boss's move
    const bool retarget = move_timer >= c.move_time;
    const float n_move_timer = retarget ? 0.0f : move_timer + c.dt;
    const float arena = 2.0f * c.half;
    const float tx = (uniform(d_move_x, 0.0f, 1.0f) * 2.0f - 1.0f) * 0.5f *
                     arena * c.target_x_scale;
    const float ty =
        ((uniform(d_move_y, 0.0f, 1.0f) * 2.0f - 1.0f) * 0.5f -
         c.target_y_shift) * arena * 0.5f;
    const float n_boss_vx = retarget ? (tx - boss_x) * c.inv_move_time
                                     : boss_vx;
    const float n_boss_vy = retarget ? (ty - boss_y) * c.inv_move_time
                                     : boss_vy;
    const float n_boss_x = boss_x + n_boss_vx * c.dt;
    const float n_boss_y = boss_y + n_boss_vy * c.dt;

    // the boss's bullets, after the volley; the ring runs on after the
    // episode's end
    bool hit_agent[2], b_expired[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      BossBullet& b = bb[k];
      const bool bwin = in_window(bb_next, bb_num, lane + kWarp * k,
                                  kBBullets);
      const bool blive = bwin && b.frame == 0.0f;
      const bool boff = blive && !in_arena(c, b.x, b.y);
      hit_agent[k] = blive && !boff &&
                     overlap(b.x - c.bullet_half, b.y - c.bullet_half,
                             c.bullet_size, c.bullet_size, agx, agy,
                             c.agent_w, c.agent_h);
      const bool hit_bar = blive && !boff && !hit_agent[k] &&
                           hits_barriers(bar, c, b.x, b.y);
      const bool impact = hit_agent[k] || hit_bar;
      if (impact || boff) {
        b.vx = 0.0f;
        b.vy = 0.0f;
      }
      if (impact) b.frame = 1.0f;
      if (boff) b.frame = 5.0f;
      if (bwin) {
        b.x = b.x + b.vx * c.dt;
        b.y = b.y + b.vy * c.dt;
      }
      b_expired[k] = bwin && b.frame >= 5.0f;
      if (bwin && b.frame >= 1.0f && b.frame < 5.0f) {
        b.frame = b.frame + c.explosion_dt;
      }
      if (b_expired[k]) b.frame = -1.0f;
    }
    // a hit registers next sub-step
    n_alive = n_alive && !__any_sync(kFull, hit_agent[0] || hit_agent[1]);
    bb_num -= popc_ballot(b_expired[0]) + popc_ballot(b_expired[1]);

    // the explosion pool's animation
    const bool ewin = ex_lane && in_window(n_ex_next, n_ex_num, lane,
                                           kExplosions);
    const bool e_expired = ewin && nex_frame >= 4.0f;
    nex_frame = e_expired ? -1.0f
                : (ewin && nex_frame >= 0.0f) ? nex_frame + c.explosion_dt
                                              : nex_frame;
    n_ex_num -= popc_ballot(e_expired);

    const bool boss_dead = n_phase_index >= 6;
    const float sub_reward = (float)!agent_alive_now * -10.0f +
                             (float)boss_dead * 10.0f;

    // ---- commit the sub-step where the episode still runs ----
    if (active) {
      alive = n_alive;
      px = npx;
      py = npy;
      vel_x = n_vx;
      vel_y = n_vy;
      a_btimer = n_abtimer;
      ab_x = nab_x;
      ab_y = nab_y;
      ab_vx = nab_vx;
      ab_vy = nab_vy;
      ab_frame = nab_frame;
      ab_bounc = nab_bounc;
      ab_btime = nab_btime;
      ab_num = n_ab_num;
      ab_next = n_ab_next;
      boss_x = n_boss_x;
      boss_y = n_boss_y;
      boss_vx = n_boss_vx;
      boss_vy = n_boss_vy;
      phase_timer = n_phase_timer;
      phase_index = n_phase_index;
      weapon_index = n_weapon;
      attack_timer = n_attack;
      hp = n_hp;
      move_timer = n_move_timer;
      explosion_timer = n_expl_timer;
      damage_timer = n_damage_timer;
      ex_x = nex_x;
      ex_y = nex_y;
      ex_frame = nex_frame;
      ex_num = n_ex_num;
      ex_next = n_ex_next;
      reward = sub_reward;
      done = !agent_alive_now || boss_dead;
    }
  }

  // ---- outputs ----
  out.ab_pos[2 * ia] = ab_x;
  out.ab_pos[2 * ia + 1] = ab_y;
  out.ab_vel[2 * ia] = ab_vx;
  out.ab_vel[2 * ia + 1] = ab_vy;
  out.ab_frame[ia] = ab_frame;
  out.ab_bouncing[ia] = ab_bounc;
  out.ab_bounce_timer[ia] = ab_btime;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int ib = e * kBBullets + lane + kWarp * k;
    out.bb_pos[2 * ib] = bb[k].x;
    out.bb_pos[2 * ib + 1] = bb[k].y;
    out.bb_vel[2 * ib] = bb[k].vx;
    out.bb_vel[2 * ib + 1] = bb[k].vy;
    out.bb_rot[ib] = bb[k].rot;
    out.bb_frame[ib] = bb[k].frame;
  }
  if (ex_lane) {
    out.ex_pos[2 * ie] = ex_x;
    out.ex_pos[2 * ie + 1] = ex_y;
    out.ex_frame[ie] = ex_frame;
  }
  if (lane == 0) {
    out.pos[2 * e] = px;
    out.pos[2 * e + 1] = py;
    out.vel[2 * e] = vel_x;
    out.vel[2 * e + 1] = vel_y;
    out.alive[e] = alive;
    out.a_bullet_timer[e] = a_btimer;
    out.ab_num[e] = ab_num;
    out.ab_next[e] = ab_next;
    out.boss_pos[2 * e] = boss_x;
    out.boss_pos[2 * e + 1] = boss_y;
    out.boss_vel[2 * e] = boss_vx;
    out.boss_vel[2 * e + 1] = boss_vy;
    out.phase_timer[e] = phase_timer;
    out.phase_index[e] = phase_index;
    out.weapon_index[e] = weapon_index;
    out.attack_timer[e] = attack_timer;
    out.hp[e] = hp;
    out.move_timer[e] = move_timer;
    out.explosion_timer[e] = explosion_timer;
    out.damage_timer[e] = damage_timer;
    out.bb_num[e] = bb_num;
    out.bb_next[e] = bb_next;
    out.ex_num[e] = ex_num;
    out.ex_next[e] = ex_next;
    out.t[e] = (int32_t)((uint32_t)in.t[e] + 1u);
    out.rng[2 * e] = (int64_t)rng.a;
    out.rng[2 * e + 1] = (int64_t)rng.b;
    out.reward[e] = reward;
    out.done[e] = done;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). `state_in` and `state_out` are
// host arrays of the device pointers of the state's fields, contiguous
// tensors in BOSSFIGHT_FIELDS' order checked by the Python wrapper
// (physics/bossfight_step.py): f32 [N, 2] positions and velocities, bool
// [N] flags, f32 [N] timers, i32 [N] counters, the rings f32 [N, 32 | 64 |
// 8, 2] and [N, 32 | 64 | 8], rng int64 [N, 2]; barrier_pos f32 [N, 4, 2],
// barrier_exists bool [N, 4], action int32 [N], reward f32 [N] and done
// bool [N]. `consts` is a host pointer. Returns 0, a cudaError_t, or -1 for
// arguments the kernel does not take.
extern "C" int bossfight_step_launch(const void* const* state_in,
                                     void* const* state_out,
                                     const void* barrier_pos,
                                     const void* barrier_exists,
                                     const void* action, void* reward,
                                     void* done, int N, int sub_steps,
                                     const Consts* consts, void* stream) {
  if (N < 0 || sub_steps < 0 || consts == nullptr || state_in == nullptr ||
      state_out == nullptr) {
    return -1;
  }
  if (N == 0) return 0;
  StateIn in;
  StateOut out;
  int i = 0;
#define BOSSFIGHT_SET(type, name)                         \
  in.name = static_cast<const type*>(state_in[i]);        \
  out.name = static_cast<type*>(state_out[i]);            \
  ++i;
  BOSSFIGHT_FIELDS(BOSSFIGHT_SET)
#undef BOSSFIGHT_SET
  in.barrier_pos = static_cast<const float*>(barrier_pos);
  in.barrier_exists = static_cast<const uint8_t*>(barrier_exists);
  in.action = static_cast<const int32_t*>(action);
  out.reward = static_cast<float*>(reward);
  out.done = static_cast<uint8_t*>(done);
  const int blocks = (N + kEnvsPerBlock - 1) / kEnvsPerBlock;
  bossfight_step_kernel<<<blocks, kWarp * kEnvsPerBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      in, out, N, sub_steps, *consts);
  return static_cast<int>(cudaGetLastError());
}
