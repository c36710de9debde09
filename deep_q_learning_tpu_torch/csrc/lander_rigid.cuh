// One frame of the rigid LunarLander for one env: the body of the R1 kernel
// (lander_rigid.cu), written as __host__ __device__ functions so that a host
// compiler builds the same code for the CPU tests.
//
// It computes, for env i, exactly what the plain PyTorch version
// deep_q_learning_tpu_torch/envs/lunar_lander.py::LunarLander.
// step_env_reference computes for lane i in rigid mode (the port of the
// XLA-compiled deep_q_learning_tpu/envs/lunar_lander.py::step_env with
// _physics_step): every value comes from the same operations on the same
// operands, in the same order:
//   1. the engine dispersion (the step's draws over SCALE, times the
//      dispersion scale; zeros in the reset frame);
//   2. wind and turbulence where enabled (gymnasium v3's tanh pattern, only
//      while airborne);
//   3. the main and side engines' impulses with gym's geometry, the reset
//      kick (the reset frame only) and gravity;
//   4. the leg tips against the piecewise-linear terrain at the
//      start-of-step pose, then SOLVER_ITERS passes of the 2x2 block normal
//      solve with sequential friction, and the J_CRASH overload test;
//   5. semi-implicit integration and the lift of a contacting tip back to
//      the surface;
//   6. the hull's bottom corners against the terrain, the sleep counter;
//   7. the observation, the shaping potential, the reward and the flags
//      (the step), or the reset's potential and t = 0 (the reset frame).
//
// The plain version's arithmetic, as PyTorch rounds it:
//   * every +, -, * and / rounds once: build with contraction off (nvcc
//     --fmad=false, g++ -ffp-contract=off) and without fast math;
//   * a tensor divided by a Python float (x / TOTAL_MASS, x / SCALE, the
//     observation's scalings) is, on the card, a multiply by the float32
//     reciprocal of the float32 constant, and on the CPU a true division:
//     sdiv() below does what each device does (ROADMAP F5).  A division by
//     a tensor (/ det, -b1 / a11) and a reciprocal (1.0 / t) are true
//     divisions on both;
//   * Python folds constant expressions in double and rounds the result
//     once to float32 where it meets a tensor (1.0 / TOTAL_MASS,
//     HELIPAD_Y + LEG_DOWN, MAIN_ENGINE_Y_LOCATION / SCALE, CHUNKS - 1 -
//     1e-6, pi * 0.01): struct RigidConsts holds those float32 values, made
//     by ops/lander_kernels.py::const_values; an expression with a tensor on
//     its left (tip0 * 17.0 / SCALE, kick * dt / TOTAL_MASS) rounds at each
//     step, left to right;
//   * clamp, clamp_min and maximum propagate NaN as PyTorch's kernels do;
//   * sin and cos: sincosf on the card, bitwise torch.sin and torch.cos
//     there (lander_solver.cuh::Trig); tanhf and sinf in the wind pattern,
//     held to torch.tanh and torch.sin on the card by chip_smoke.py; the C
//     library's in the host build, which the CPU tests give the plain
//     version too.

#ifndef DEEP_Q_LEARNING_TPU_TORCH_LANDER_RIGID_CUH_
#define DEEP_Q_LEARNING_TPU_TORCH_LANDER_RIGID_CUH_

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define LR_FN __host__ __device__ __forceinline__
#else
#define LR_FN inline
#endif

namespace rigid {

constexpr int kChunks = 11;  // terrain heights per env
constexpr int kObs = 8;
constexpr int kSolverIters = 4;

// A Python float that a tensor is divided by: the float32 constant and its
// float32 reciprocal (1.0f / c, as PyTorch's CUDA division takes it).
struct Div {
  float c, inv;
};

// Float32 constants and the params, in the order of
// ops/lander_kernels.py::CONST_FIELDS.
struct RigidConsts {
  Div scale;                       // SCALE: the dispersion draws
  Div total_mass, inertia;         // TOTAL_MASS, INERTIA
  Div chunk_w;                     // W / (CHUNKS - 1)
  Div half_w, half_h, fps;         // W / 2, H / 2, FPS: the observation
  float dispersion_scale, wind_power, turbulence_power;
  float dt, g_dt;                  // 1 / FPS; float32(gravity) * float32(dt)
  float com_offset;
  float wind_k1, wind_k2;          // 0.02, pi * 0.01
  float main_y;                    // MAIN_ENGINE_Y_LOCATION / SCALE
  float main_power, side_power;
  float side_away, side_height;    // SIDE_ENGINE_AWAY, SIDE_ENGINE_HEIGHT
  float tip_x[2], tip_y;           // the leg tips (-LEG_TIP_X, LEG_TIP_X), LEG_TIP_Y
  float xi_max;                    // CHUNKS - 1 - 1e-6
  float contact_skin, slop;
  float inv_mass;                  // 1.0 / TOTAL_MASS
  float mu, neg_mu, j_crash;
  float hull_x[2], hull_y;         // the hull's bottom corners
  float hull_skin;                 // 0.01
  float lin_sleep, ang_sleep;
  float pad_y;                     // HELIPAD_Y + LEG_DOWN
  float height;                    // H: the fresh hull's y
  int32_t enable_wind;
  int32_t sleep_frames;
  int32_t max_steps;
};

// Pointers of one call, in the order of ops/lander_kernels.py::IO: (N,) each
// unless noted; flags are one byte (torch.bool).  A step reads the state,
// the actions and the dispersion draws.  The reset frame (kick not null)
// reads none of them: it starts from reset_env's fresh state (the hull at
// (W/2, H) at rest, no contact, sleep 0), its wind and torque indices from
// wind_draws, with the nop action and zero dispersion, and writes t = 0 and
// no reward or flags (reward, terminated and truncated null).  wind_out and
// torque_out are null in a step with the wind off: the indices are not read
// and the caller keeps its tensors.
struct IO {
  const float* state[6];  // x, y, vx, vy, angle, omega
  const uint8_t* leg[2];
  const float* terrain;  // (N, kChunks)
  const float* prev_shaping;
  const int32_t* t;
  const int32_t* sleep;
  const int32_t* wind_idx;
  const int32_t* torque_idx;
  const int32_t* action;
  const float* draws;  // (N, 2) on [-1, 1)
  const float* kick;  // (N, 2)
  const int32_t* wind_draws;  // (N, 2): wind, torque index
  float* obs;  // (N, kObs)
  float* state_out[6];
  uint8_t* leg_out[2];
  float* shaping_out;
  int32_t* t_out;
  int32_t* sleep_out;
  int32_t* wind_out;
  int32_t* torque_out;
  float* reward;
  uint8_t* terminated;
  uint8_t* truncated;
};

// ------------------------------------------------------------- arithmetic
// x / (Python float): on the card a multiply by the float32 reciprocal, in
// the host build (as on the CPU) a true division.
LR_FN float sdiv(float x, const Div& d) {
#ifdef __CUDA_ARCH__
  return x * d.inv;
#else
  return x / d.c;
#endif
}

// torch.clamp, clamp(min=) and maximum: NaN passes through.
LR_FN float clamp_t(float v, float lo, float hi) { return v != v ? v : fminf(fmaxf(v, lo), hi); }
LR_FN float clamp_min_t(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
LR_FN float maximum_t(float a, float b) { return a != a ? a : (b != b ? b : fmaxf(a, b)); }

LR_FN void sin_cos(float a, float* s, float* c) {
#ifdef __CUDA_ARCH__
  sincosf(a, s, c);
#else
  *s = sinf(a);
  *c = cosf(a);
#endif
}

// _wind_pattern: tanh(sin(0.02 f) + sin(pi 0.01 f)) of the float index f.
LR_FN float wind_pattern(int32_t idx, const RigidConsts& k) {
  float f = (float)idx;
  return tanhf(sinf(f * k.wind_k1) + sinf(f * k.wind_k2));
}

// _terrain_height: the piecewise-linear surface at world x.  xi lies in
// [0, CHUNKS - 1 - 1e-6], so floor(xi) in [0, 9] and the right height's
// index, clamped to 10 in the plain version, is i0 + 1; a NaN xi (which
// the plain version's gather refuses) reads chunk 0.
LR_FN float terrain_height(const float* ter, float x, const RigidConsts& k) {
  float xi = clamp_t(sdiv(x, k.chunk_w), 0.0f, k.xi_max);
  float fl = floorf(xi);
  int i0 = fl >= 0.0f && fl <= (float)(kChunks - 2) ? (int)fl : 0;
  float frac = xi - (float)i0;
  return ter[i0] * (1.0f - frac) + ter[i0 + 1] * frac;
}

// ------------------------------------------------------------------ a frame
// The plain version's _physics_step and step_env (or reset_env's frame)
// for env i.
LR_FN void rigid_step_env(const IO& io, const RigidConsts& k, int i) {
  const float* ter = io.terrain + (int64_t)i * kChunks;
  const bool reset = io.kick != nullptr;
  // the start-of-frame state: a step's, or reset_env's fresh lander
  float sx = k.half_w.c, sy = k.height, angle0 = 0.0f;
  float vx = 0.0f, vy = 0.0f, omega = 0.0f;
  bool leg1 = false, leg2 = false;
  int32_t sleep0 = 0, wind_idx = 0, torque_idx = 0, action = 0;
  float d0 = 0.0f, d1 = 0.0f;  // the engine dispersion
  if (reset) {
    wind_idx = io.wind_draws[2 * i];
    torque_idx = io.wind_draws[2 * i + 1];
  } else {
    sx = io.state[0][i];
    sy = io.state[1][i];
    vx = io.state[2][i];
    vy = io.state[3][i];
    angle0 = io.state[4][i];
    omega = io.state[5][i];
    leg1 = io.leg[0][i] != 0;
    leg2 = io.leg[1][i] != 0;
    sleep0 = io.sleep[i];
    action = io.action[i];
    if (k.enable_wind) {
      wind_idx = io.wind_idx[i];
      torque_idx = io.torque_idx[i];
    }
    // draws / SCALE * dispersion_scale
    d0 = sdiv(io.draws[2 * i], k.scale) * k.dispersion_scale;
    d1 = sdiv(io.draws[2 * i + 1], k.scale) * k.dispersion_scale;
  }

  float sin_a, cos_a;
  sin_cos(angle0, &sin_a, &cos_a);
  const float tip0 = sin_a, tip1 = cos_a;
  const float side0 = -cos_a, side1 = sin_a;

  float comx = sx - k.com_offset * sin_a;
  float comy = sy + k.com_offset * cos_a;

  if (k.enable_wind) {
    const bool airborne = !(leg1 | leg2);
    const float wind = wind_pattern(wind_idx, k) * k.wind_power;
    const float torq = wind_pattern(torque_idx, k) * k.turbulence_power;
    vx = vx + (airborne ? sdiv(wind, k.total_mass) * k.dt : 0.0f);
    omega = omega + (airborne ? sdiv(torq, k.inertia) * k.dt : 0.0f);
    wind_idx = wind_idx + (int32_t)airborne;
    torque_idx = torque_idx + (int32_t)airborne;
  }
  if (io.wind_out != nullptr) {
    io.wind_out[i] = wind_idx;
    io.torque_out[i] = torque_idx;
  }

  // --- main engine
  const float m_power = action == 2 ? 1.0f : 0.0f;
  const float k_main = 2.0f * d0 + k.main_y;
  const float ox_m = tip0 * k_main + side0 * d1;
  const float oy_m = -tip1 * k_main - side1 * d1;
  const float jmx = -ox_m * k.main_power * m_power;
  const float jmy = -oy_m * k.main_power * m_power;
  const float rmx = (sx + ox_m) - comx;
  const float rmy = (sy + oy_m) - comy;
  vx = vx + sdiv(jmx, k.total_mass);
  vy = vy + sdiv(jmy, k.total_mass);
  omega = omega + sdiv(rmx * jmy - rmy * jmx, k.inertia);

  // --- side engines
  const float s_power = (action == 1) | (action == 3) ? 1.0f : 0.0f;
  const float direction = action == 3 ? 1.0f : (action == 1 ? -1.0f : 0.0f);
  const float k_side = 3.0f * d1 + direction * k.side_away;
  const float ox_s = tip0 * d0 + side0 * k_side;
  const float oy_s = -tip1 * d0 - side1 * k_side;
  const float jsx = -ox_s * k.side_power * s_power;
  const float jsy = -oy_s * k.side_power * s_power;
  const float rsx = ((sx + ox_s) - sdiv(tip0 * 17.0f, k.scale)) - comx;
  const float rsy = ((sy + oy_s) + tip1 * k.side_height) - comy;
  vx = vx + sdiv(jsx, k.total_mass);
  vy = vy + sdiv(jsy, k.total_mass);
  omega = omega + sdiv(rsx * jsy - rsy * jsx, k.inertia);

  // --- reset kick (the reset frame) and gravity
  if (reset) {
    vx = vx + sdiv(io.kick[2 * i] * k.dt, k.total_mass);
    vy = vy + sdiv(io.kick[2 * i + 1] * k.dt, k.total_mass);
  }
  vy = vy + k.g_dt;

  // --- contacts at the start-of-step pose
  const float p1x = (sx + k.tip_x[0] * cos_a) - k.tip_y * sin_a;
  const float p1y = (sy + k.tip_x[0] * sin_a) + k.tip_y * cos_a;
  const float p2x = (sx + k.tip_x[1] * cos_a) - k.tip_y * sin_a;
  const float p2y = (sy + k.tip_x[1] * sin_a) + k.tip_y * cos_a;
  const float g1 = terrain_height(ter, p1x, k);
  const float g2 = terrain_height(ter, p2x, k);
  const bool c1 = p1y <= (g1 + k.contact_skin) + k.slop;
  const bool c2 = p2y <= (g2 + k.contact_skin) + k.slop;

  // --- SOLVER_ITERS passes: the 2x2 block normal solve, sequential friction
  const float r1x = p1x - comx, r1y = p1y - comy;
  const float r2x = p2x - comx, r2y = p2y - comy;
  const float a11 = sdiv(r1x * r1x, k.inertia) + k.inv_mass;
  const float a22 = sdiv(r2x * r2x, k.inertia) + k.inv_mass;
  const float a12 = sdiv(r1x * r2x, k.inertia) + k.inv_mass;
  const float det = a11 * a22 - a12 * a12;
  const float mt1 = (1.0f / (sdiv(r1y * r1y, k.inertia) + k.inv_mass)) * 1.0f;
  const float mt2 = (1.0f / (sdiv(r2y * r2y, k.inertia) + k.inv_mass)) * 1.0f;
  float jn1 = 0.0f, jn2 = 0.0f, jt1 = 0.0f, jt2 = 0.0f;
  const float f1 = c1 ? 1.0f : 0.0f;
  const float f2 = c2 ? 1.0f : 0.0f;
#pragma unroll
  for (int it = 0; it < kSolverIters; ++it) {
    const float un1 = vy + omega * r1x;
    const float un2 = vy + omega * r2x;
    const float b1 = un1 - (a11 * jn1 + a12 * jn2);
    const float b2 = un2 - (a12 * jn1 + a22 * jn2);
    const float x1_b = (-a22 * b1 + a12 * b2) / det;
    const float x2_b = (a12 * b1 - a11 * b2) / det;
    const bool ok_b = c1 & c2 & (x1_b >= 0.0f) & (x2_b >= 0.0f);
    const float x1_1 = clamp_min_t(-b1 / a11, 0.0f) * f1;
    const bool ok_1 = (c1 & (a12 * x1_1 + b2 >= 0.0f)) | !c2;
    const float x2_2 = clamp_min_t(-b2 / a22, 0.0f) * f2;
    const float x1 = (ok_b ? x1_b : (ok_1 ? x1_1 : 0.0f)) * f1;
    const float x2 = (ok_b ? x2_b : (ok_1 ? 0.0f : x2_2)) * f2;
    const float dn1 = x1 - jn1, dn2 = x2 - jn2;
    vy = vy + sdiv(dn1 + dn2, k.total_mass);
    omega = omega + sdiv(dn1 * r1x + dn2 * r2x, k.inertia);
    jn1 = x1;
    jn2 = x2;
    // contact 1: friction
    float ut = vx - omega * r1y;
    float jt_new = clamp_t(jt1 - ut * mt1, jn1 * k.neg_mu, jn1 * k.mu);
    float djt = (jt_new - jt1) * f1;
    vx = vx + sdiv(djt, k.total_mass);
    omega = omega - sdiv(djt * r1y, k.inertia);
    jt1 = jt1 + djt;
    // contact 2: friction
    ut = vx - omega * r2y;
    jt_new = clamp_t(jt2 - ut * mt2, jn2 * k.neg_mu, jn2 * k.mu);
    djt = (jt_new - jt2) * f2;
    vx = vx + sdiv(djt, k.total_mass);
    omega = omega - sdiv(djt * r2y, k.inertia);
    jt2 = jt2 + djt;
  }
  const bool hard = (jn1 > k.j_crash) | (jn2 > k.j_crash);

  // --- integrate
  comx = comx + vx * k.dt;
  comy = comy + vy * k.dt;
  const float angle = angle0 + omega * k.dt;
  float sin_n, cos_n;
  sin_cos(angle, &sin_n, &cos_n);
  const float x = comx + k.com_offset * sin_n;
  float y = comy - k.com_offset * cos_n;

  // --- lift contacting tips back to the surface
  const float q1x = (x + k.tip_x[0] * cos_n) - k.tip_y * sin_n;
  const float q1y = (y + k.tip_x[0] * sin_n) + k.tip_y * cos_n;
  const float q2x = (x + k.tip_x[1] * cos_n) - k.tip_y * sin_n;
  const float q2y = (y + k.tip_x[1] * sin_n) + k.tip_y * cos_n;
  const float h1 = terrain_height(ter, q1x, k);
  const float h2 = terrain_height(ter, q2x, k);
  const float pen1 = c1 ? (h1 + k.contact_skin) - q1y : 0.0f;
  const float pen2 = c2 ? (h2 + k.contact_skin) - q2y : 0.0f;
  y = y + clamp_min_t(maximum_t(pen1, pen2), 0.0f);

  // --- the hull's bottom corners touching the ground
  bool hull_hit = false;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float hx = (x + k.hull_x[c] * cos_n) - k.hull_y * sin_n;
    const float hy = (y + k.hull_x[c] * sin_n) + k.hull_y * cos_n;
    hull_hit = hull_hit | (hy <= terrain_height(ter, hx, k) + k.hull_skin);
  }
  const bool game_over = hull_hit | hard;

  // --- sleep: the +100 rest trigger
  const bool still = c1 & c2 & (fabsf(vx) < k.lin_sleep) & (fabsf(vy) < k.lin_sleep) &
                     (fabsf(omega) < k.ang_sleep);
  const int32_t sleep = still ? sleep0 + 1 : 0;
  const bool rest = sleep >= k.sleep_frames;

  // --- observation and shaping potential
  float o[kObs];
  o[0] = sdiv(x - k.half_w.c, k.half_w);
  o[1] = sdiv(y - k.pad_y, k.half_h);
  o[2] = sdiv(vx * k.half_w.c, k.fps);
  o[3] = sdiv(vy * k.half_h.c, k.fps);
  o[4] = angle;
  o[5] = sdiv(omega * 20.0f, k.fps);
  o[6] = c1 ? 1.0f : 0.0f;
  o[7] = c2 ? 1.0f : 0.0f;
  const float shaping = ((((sqrtf(o[0] * o[0] + o[1] * o[1]) * -100.0f) -
                           sqrtf(o[2] * o[2] + o[3] * o[3]) * 100.0f) -
                          fabsf(o[4]) * 100.0f) +
                         o[6] * 10.0f) +
                        o[7] * 10.0f;

  float* obs = io.obs + (int64_t)i * kObs;
#pragma unroll
  for (int q = 0; q < kObs; ++q) obs[q] = o[q];
  io.state_out[0][i] = x;
  io.state_out[1][i] = y;
  io.state_out[2][i] = vx;
  io.state_out[3][i] = vy;
  io.state_out[4][i] = angle;
  io.state_out[5][i] = omega;
  io.leg_out[0][i] = c1;
  io.leg_out[1][i] = c2;
  io.shaping_out[i] = shaping;
  io.sleep_out[i] = sleep;
  if (reset) {
    io.t_out[i] = 0;
    return;
  }
  const int32_t t = io.t[i] + 1;
  io.t_out[i] = t;

  // --- reward and flags
  float reward = shaping - io.prev_shaping[i];
  reward = (reward - m_power * 0.3f) - s_power * 0.03f;
  const bool out_of_bounds = fabsf(o[0]) >= 1.0f;
  const bool crash = game_over | out_of_bounds;
  io.reward[i] = crash ? -100.0f : (rest ? 100.0f : reward);
  const bool terminated = crash | rest;
  io.terminated[i] = terminated;
  io.truncated[i] = (t >= k.max_steps) & !terminated;
}

}  // namespace rigid

#ifndef __CUDACC__
// The host build (g++, for the CPU tests): each env in turn.
extern "C" int lander_rigid_host(const rigid::IO* io, const rigid::RigidConsts* k, int n) {
  for (int i = 0; i < n; ++i) rigid::rigid_step_env(*io, *k, i);
  return 0;
}

// sinf (which = 0), cosf (1), tanhf (2) or sqrtf (3) of n floats: the C
// library's, which the host build calls, for the CPU tests to give the
// plain version the same values (PyTorch's CPU kernels compute these
// functions otherwise: their results differ in the last ulp on some inputs,
// sqrt's too).
extern "C" int lander_rigid_math_host(const float* x, float* out, int n, int which) {
  for (int i = 0; i < n; ++i) {
    float v = x[i];
    out[i] = which == 0 ? sinf(v) : (which == 1 ? cosf(v) : (which == 2 ? tanhf(v) : sqrtf(v)));
  }
  return 0;
}

extern "C" int lander_rigid_sizes(int* out) {
  out[0] = (int)sizeof(rigid::IO);
  out[1] = (int)sizeof(rigid::RigidConsts);
  return 0;
}
#endif

#endif  // DEEP_Q_LEARNING_TPU_TORCH_LANDER_RIGID_CUH_
