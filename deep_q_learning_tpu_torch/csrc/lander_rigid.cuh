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
//   1. the frame's start: the state and the engine dispersion, or the fresh
//      lander of the reset frame (lander_frame.cuh::start_of);
//   2. wind and turbulence where enabled (gymnasium v3's tanh pattern, only
//      while airborne);
//   3. the main and side engines' impulses with gym's geometry
//      (lander_frame.cuh::engines), the reset kick (the reset frame only)
//      and gravity;
//   4. the leg tips against the piecewise-linear terrain at the
//      start-of-step pose, then SOLVER_ITERS passes of the 2x2 block normal
//      solve with sequential friction, and the J_CRASH overload test;
//   5. semi-implicit integration and the lift of a contacting tip back to
//      the surface;
//   6. the hull's bottom corners against the terrain, the sleep predicate;
//   7. the sleep counter, the observation, the shaping potential, the reward
//      and the flags (the step), or the reset's potential and t = 0 (the
//      reset frame): lander_frame.cuh::outcome.
//
// lander_frame.cuh says how the plain version's arithmetic rounds and how
// this code repeats it.  Besides: a division by a tensor (/ det, -b1 / a11)
// and a reciprocal (1.0 / t) are true divisions on both devices, and
// 1.0 / TOTAL_MASS, CHUNKS - 1 - 1e-6 fold in double; kick * dt /
// TOTAL_MASS rounds at each step.
//
// One env's chain of dependent operations is what a launch waits for, so
// the frame keeps it short:
//   * every input is loaded before the physics starts, the terrain row
//     too, into registers (RegRow: each height picked by a tree of
//     selects on the index's bits), so no load waits on the chain;
//   * sin and cos are the card's sincosf written out without its branch
//     (lander_fast_math.cuh::sincos_poly), and the solve's quotients are
//     Markstein's corrections from the reciprocals of its divisors (det,
//     a11, a22), taken once a frame (quot, divisor_of), as J1's passes
//     take them: bitwise sincosf and division on every operand of their
//     ranges.  A frame with an operand outside (a zero determinant where
//     both legs touch, a subnormal, an infinity or a NaN) runs again with
//     sincosf and division (kExact), so every frame gives the plain
//     version's bits.
//
// rigid_vector_env is the vector step around the frame (VectorEnv._step
// with a reset pool): the frame, done = terminated | truncated, the time
// feature t / max_steps where the env is wrapped in TimeFractionObs, and
// the auto-reset's selects of every state leaf and of the observation
// between the stepped values and the pool's entry i.

#ifndef DEEP_Q_LEARNING_TPU_TORCH_LANDER_RIGID_CUH_
#define DEEP_Q_LEARNING_TPU_TORCH_LANDER_RIGID_CUH_

#include <math.h>
#include <stdint.h>

#include "lander_fast_math.cuh"
#include "lander_frame.cuh"

#ifdef __CUDACC__
#define LR_FN __host__ __device__ __forceinline__
#else
#define LR_FN inline
#endif

namespace rigid {

using frame::Div;
using frame::IO;
using frame::clamp_t;
using frame::clamp_min_t;
using frame::maximum_t;
using frame::sdiv;
using frame::wind_pattern;
using RigidConsts = frame::FrameConsts;

constexpr int kChunks = frame::kChunks;
constexpr int kObs = frame::kObs;
constexpr int kSolverIters = 4;

// ------------------------------------------------------------ the terrain
// An env's terrain row in registers: at(j) picks h[j], j in [0, kChunks),
// by a tree of selects on j's bits (an array indexed at run time would
// live in local memory).
struct RegRow {
  float h[kChunks];

  LR_FN float at(int j) const {
    const bool b0 = (j & 1) != 0, b1 = (j & 2) != 0, b2 = (j & 4) != 0, b3 = (j & 8) != 0;
    const float p0 = b0 ? h[1] : h[0], p1 = b0 ? h[3] : h[2], p2 = b0 ? h[5] : h[4];
    const float p3 = b0 ? h[7] : h[6], p4 = b0 ? h[9] : h[8];
    const float q0 = b1 ? p1 : p0, q1 = b1 ? p3 : p2, q2 = b1 ? h[10] : p4;
    return b3 ? q2 : (b2 ? q1 : q0);
  }
};

LR_FN RegRow load_row(const float* p) {
  RegRow r;
#pragma unroll
  for (int q = 0; q < kChunks; ++q) r.h[q] = p[q];
  return r;
}

// _terrain_height: the piecewise-linear surface at world x.  xi lies in
// [0, CHUNKS - 1 - 1e-6], so floor(xi) in [0, 9] and the right height's
// index, clamped to 10 in the plain version, is i0 + 1; a NaN xi (which
// the plain version's gather refuses) reads chunk 0.
LR_FN float terrain_height(const RegRow& ter, float x, const RigidConsts& k) {
  float xi = clamp_t(sdiv(x, k.chunk_w), 0.0f, k.xi_max);
  float fl = floorf(xi);
  int i0 = fl >= 0.0f && fl <= (float)(kChunks - 2) ? (int)fl : 0;
  float frac = xi - (float)i0;
  return ter.at(i0) * (1.0f - frac) + ter.at(i0 + 1) * frac;
}

// sin and cos of a: without a branch where in range (ok cleared elsewhere),
// or sincosf (kExact).
template <bool kExact>
LR_FN lander::Trig trig(float a, bool& ok) {
  if constexpr (kExact) {
    return lander::trig_of(a);
  } else {
    return lander::trig_fast(a, ok);
  }
}

// 1 / d.b: the reciprocal rounded to nearest where d is in range (ok
// cleared elsewhere), or a division (kExact).
template <bool kExact>
LR_FN float recip(const lander::Divisor& d, bool& ok) {
  if constexpr (kExact) {
    return 1.0f / d.b;
  } else {
    ok = ok & d.ok;
    return d.y;
  }
}


// ------------------------------------------------------------------ a frame
// The plain version's _physics_step for one env from its start s (the
// reset frame's kick (kick_x, kick_y)), on its terrain row.
template <bool kExact>
LR_FN frame::End physics(const frame::Start& s, const RegRow& ter, float kick_x, float kick_y,
                         const RigidConsts& k, bool& ok) {
  const float sx = s.x, sy = s.y, angle0 = s.angle;
  float vx = s.vx, vy = s.vy, omega = s.omega;
  int32_t wind_idx = s.wind_idx, torque_idx = s.torque_idx;

  const lander::Trig t0 = trig<kExact>(angle0, ok);
  const float sin_a = t0.s, cos_a = t0.c;

  float comx = sx - k.com_offset * sin_a;
  float comy = sy + k.com_offset * cos_a;

  if (k.enable_wind) {
    const bool airborne = !(s.leg1 | s.leg2);
    const float wind = wind_pattern(wind_idx, k) * k.wind_power;
    const float torq = wind_pattern(torque_idx, k) * k.turbulence_power;
    vx = vx + (airborne ? sdiv(wind, k.total_mass) * k.dt : 0.0f);
    omega = omega + (airborne ? sdiv(torq, k.inertia) * k.dt : 0.0f);
    wind_idx = wind_idx + (int32_t)airborne;
    torque_idx = torque_idx + (int32_t)airborne;
  }

  // --- the main engine, then the side engines
  frame::Impulse main, side;
  frame::engines(s, sin_a, cos_a, comx, comy, k, main, side);
  vx = vx + sdiv(main.jx, k.total_mass);
  vy = vy + sdiv(main.jy, k.total_mass);
  omega = omega + sdiv(main.rx * main.jy - main.ry * main.jx, k.inertia);
  vx = vx + sdiv(side.jx, k.total_mass);
  vy = vy + sdiv(side.jy, k.total_mass);
  omega = omega + sdiv(side.rx * side.jy - side.ry * side.jx, k.inertia);

  // --- reset kick (the reset frame) and gravity
  if (s.reset) {
    vx = vx + sdiv(kick_x * k.dt, k.total_mass);
    vy = vy + sdiv(kick_y * k.dt, k.total_mass);
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

  // --- SOLVER_ITERS passes: the 2x2 block normal solve, sequential friction;
  // the divisors' reciprocals once a frame
  const float r1x = p1x - comx, r1y = p1y - comy;
  const float r2x = p2x - comx, r2y = p2y - comy;
  const float a11 = sdiv(r1x * r1x, k.inertia) + k.inv_mass;
  const float a22 = sdiv(r2x * r2x, k.inertia) + k.inv_mass;
  const float a12 = sdiv(r1x * r2x, k.inertia) + k.inv_mass;
  const lander::Divisor d_det = lander::divisor_of(a11 * a22 - a12 * a12);
  const lander::Divisor d11 = lander::divisor_of(a11), d22 = lander::divisor_of(a22);
  const float mt1 =
      recip<kExact>(lander::divisor_of(sdiv(r1y * r1y, k.inertia) + k.inv_mass), ok) * 1.0f;
  const float mt2 =
      recip<kExact>(lander::divisor_of(sdiv(r2y * r2y, k.inertia) + k.inv_mass), ok) * 1.0f;
  float jn1 = 0.0f, jn2 = 0.0f, jt1 = 0.0f, jt2 = 0.0f;
  const float f1 = c1 ? 1.0f : 0.0f;
  const float f2 = c2 ? 1.0f : 0.0f;
#pragma unroll
  for (int it = 0; it < kSolverIters; ++it) {
    const float un1 = vy + omega * r1x;
    const float un2 = vy + omega * r2x;
    const float b1 = un1 - (a11 * jn1 + a12 * jn2);
    const float b2 = un2 - (a12 * jn1 + a22 * jn2);
    // the block's quotients reach a result only through ok_b, which needs
    // both contacts (a lander on its side divides by a zero det without
    // them); the single-contact ones reach it even as a NaN times f = 0
    const float x1_b = lander::quot<kExact>(-a22 * b1 + a12 * b2, d_det, c1 & c2, ok);
    const float x2_b = lander::quot<kExact>(a12 * b1 - a11 * b2, d_det, c1 & c2, ok);
    const bool ok_b = c1 & c2 & (x1_b >= 0.0f) & (x2_b >= 0.0f);
    const float x1_1 = clamp_min_t(lander::quot<kExact>(-b1, d11, true, ok), 0.0f) * f1;
    const bool ok_1 = (c1 & (a12 * x1_1 + b2 >= 0.0f)) | !c2;
    const float x2_2 = clamp_min_t(lander::quot<kExact>(-b2, d22, true, ok), 0.0f) * f2;
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
  const lander::Trig t1 = trig<kExact>(angle, ok);
  const float sin_n = t1.s, cos_n = t1.c;
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
  return {x, y, vx, vy, angle, omega, c1, c2, game_over, still, wind_idx, torque_idx};
}

// The frame: without a branch on the chain, and again with sincosf and
// division where an operand left their ranges.
LR_FN frame::End frame_of(const frame::Start& s, const RegRow& ter, float kick_x, float kick_y,
                          const RigidConsts& k) {
  bool ok = true;
  frame::End e = physics<false>(s, ter, kick_x, kick_y, k, ok);
  if (!ok) {
    bool unused = true;
    e = physics<true>(s, ter, kick_x, kick_y, k, unused);
  }
  return e;
}

// The plain version's step_env (or reset_env's frame) for env i, on its
// terrain row ter: its inputs loaded first, the frame, then the
// observation, potential, reward and flags (lander_frame.cuh::outcome).
LR_FN void rigid_step_env(const IO& io, const RigidConsts& k, int i, const RegRow& ter) {
  const frame::Start s = frame::start_of(io, k, i);
  const bool step = !s.reset;
  const int32_t t = step ? io.t[i] : 0;
  const float prev_shaping = step ? io.prev_shaping[i] : 0.0f;
  const float kick_x = step ? 0.0f : io.kick[2 * i];
  const float kick_y = step ? 0.0f : io.kick[2 * i + 1];
  const frame::End e = frame_of(s, ter, kick_x, kick_y, k);
  frame::store(io, i, s, e, frame::outcome(k, s, e, t, prev_shaping));
}

// ------------------------------------------------------------ the vector step
// The reset pool (VectorEnv.fresh_pool's (fresh_obs, fresh_states)) and the
// vector step's state after the auto-reset, (N,) each unless noted, in the
// order of ops/lander_kernels.py::VecIO.
struct Pool {
  const float* state[6];  // x, y, vx, vy, angle, omega
  const uint8_t* leg[2];
  const float* terrain;  // (N, kChunks)
  const float* prev_shaping;
  const int32_t* t;
  const int32_t* sleep;
  const int32_t* wind_idx;
  const int32_t* torque_idx;
  const float* obs;  // (N, width)
};

struct Out {
  float* obs;  // (N, width)
  float* state[6];
  uint8_t* leg[2];
  float* terrain;  // (N, kChunks)
  float* prev_shaping;
  int32_t* t;
  int32_t* sleep;
  int32_t* wind_idx;
  int32_t* torque_idx;
};

// One call of the vector step: the step's io (its state, action and draws;
// the wind indices read with the wind off too; obs the pre-reset next_obs,
// width wide; reward, terminated and truncated; its state_out unused), the
// pool, the outputs after the reset, and the time feature: width is kObs,
// or kObs + 1 with t / max_steps (time_div) last.
struct VecIO {
  IO step;
  Pool pool;
  Out out;
  Div time_div;
  int32_t time_feature;
};

// VectorEnv._step for env i with a reset pool, on its terrain row ter:
// every load first (the pool's entry too), the frame, done, the time
// feature, the stores of next_obs, reward and flags, then the selects.
LR_FN void rigid_vector_env(const VecIO& v, const RigidConsts& k, int i, const RegRow& ter) {
  const IO& io = v.step;
  const Pool& pool = v.pool;
  const int width = kObs + (v.time_feature ? 1 : 0);
  const frame::Start s = frame::start_of(io, k, i);
  const int32_t t = io.t[i];
  const float prev_shaping = io.prev_shaping[i];
  const int32_t wind_idx = io.wind_idx[i], torque_idx = io.torque_idx[i];
  float p_state[6], p_ter[kChunks], p_obs[kObs + 1];
#pragma unroll
  for (int f = 0; f < 6; ++f) p_state[f] = pool.state[f][i];
  const bool p_leg1 = pool.leg[0][i] != 0, p_leg2 = pool.leg[1][i] != 0;
#pragma unroll
  for (int q = 0; q < kChunks; ++q) p_ter[q] = pool.terrain[(int64_t)i * kChunks + q];
  const float p_shaping = pool.prev_shaping[i];
  const int32_t p_t = pool.t[i], p_sleep = pool.sleep[i];
  const int32_t p_wind = pool.wind_idx[i], p_torque = pool.torque_idx[i];
#pragma unroll
  for (int q = 0; q < kObs + 1; ++q) {
    p_obs[q] = q < width ? pool.obs[(int64_t)i * width + q] : 0.0f;
  }

  const frame::End e = frame_of(s, ter, 0.0f, 0.0f, k);
  const frame::Outcome r = frame::outcome(k, s, e, t, prev_shaping);
  const bool done = r.terminated | r.truncated;

  // the step's observation, with the time feature: t.to(float32) / max_steps
  float obs[kObs + 1];
#pragma unroll
  for (int q = 0; q < kObs; ++q) obs[q] = r.obs[q];
  obs[kObs] = sdiv((float)r.t, v.time_div);
  float* next_obs = io.obs + (int64_t)i * width;
  float* out_obs = v.out.obs + (int64_t)i * width;
#pragma unroll
  for (int q = 0; q < kObs + 1; ++q) {
    if (q < width) {
      next_obs[q] = obs[q];
      out_obs[q] = done ? p_obs[q] : obs[q];
    }
  }
  io.reward[i] = r.reward;
  io.terminated[i] = r.terminated;
  io.truncated[i] = r.truncated;

  // the auto-reset: pool entry i where done, the stepped state elsewhere
  // (with the wind off the stepped state keeps the indices it was given)
  const Out& out = v.out;
  const float stepped[6] = {e.x, e.y, e.vx, e.vy, e.angle, e.omega};
#pragma unroll
  for (int f = 0; f < 6; ++f) out.state[f][i] = done ? p_state[f] : stepped[f];
  out.leg[0][i] = done ? p_leg1 : e.leg1;
  out.leg[1][i] = done ? p_leg2 : e.leg2;
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    out.terrain[(int64_t)i * kChunks + q] = done ? p_ter[q] : ter.at(q);
  }
  out.prev_shaping[i] = done ? p_shaping : r.shaping;
  out.t[i] = done ? p_t : r.t;
  out.sleep[i] = done ? p_sleep : r.sleep;
  out.wind_idx[i] = done ? p_wind : (k.enable_wind ? e.wind_idx : wind_idx);
  out.torque_idx[i] = done ? p_torque : (k.enable_wind ? e.torque_idx : torque_idx);
}

}  // namespace rigid

#ifndef __CUDACC__
// The host build (g++, for the CPU tests): each env in turn, its terrain
// row in registers.
extern "C" int lander_rigid_host(const rigid::IO* io, const rigid::RigidConsts* k, int n) {
  for (int i = 0; i < n; ++i) {
    rigid::rigid_step_env(*io, *k, i, rigid::load_row(io->terrain + (int64_t)i * rigid::kChunks));
  }
  return 0;
}

extern "C" int lander_rigid_vector_host(const rigid::VecIO* v, const rigid::RigidConsts* k,
                                        int n) {
  for (int i = 0; i < n; ++i) {
    rigid::rigid_vector_env(*v, *k, i,
                            rigid::load_row(v->step.terrain + (int64_t)i * rigid::kChunks));
  }
  return 0;
}

extern "C" int lander_rigid_sizes(int* out) {
  out[0] = (int)sizeof(rigid::IO);
  out[1] = (int)sizeof(rigid::RigidConsts);
  out[2] = (int)sizeof(rigid::VecIO);
  return 0;
}
#endif

#endif  // DEEP_Q_LEARNING_TPU_TORCH_LANDER_RIGID_CUH_
