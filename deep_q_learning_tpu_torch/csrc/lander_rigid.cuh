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
//      reset frame): lander_frame.cuh::finish.
//
// lander_frame.cuh says how the plain version's arithmetic rounds and how
// this code repeats it.  Besides: a division by a tensor (/ det, -b1 / a11)
// and a reciprocal (1.0 / t) are true divisions on both devices, and
// 1.0 / TOTAL_MASS, CHUNKS - 1 - 1e-6 fold in double; kick * dt /
// TOTAL_MASS rounds at each step.

#ifndef DEEP_Q_LEARNING_TPU_TORCH_LANDER_RIGID_CUH_
#define DEEP_Q_LEARNING_TPU_TORCH_LANDER_RIGID_CUH_

#include <math.h>
#include <stdint.h>

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
using frame::sin_cos;
using frame::wind_pattern;
using RigidConsts = frame::FrameConsts;

constexpr int kChunks = frame::kChunks;
constexpr int kSolverIters = 4;

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
  const frame::Start s = frame::start_of(io, k, i);
  const float sx = s.x, sy = s.y, angle0 = s.angle;
  float vx = s.vx, vy = s.vy, omega = s.omega;
  int32_t wind_idx = s.wind_idx, torque_idx = s.torque_idx;

  float sin_a, cos_a;
  sin_cos(angle0, &sin_a, &cos_a);

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

  // --- sleep: the +100 rest trigger; the observation, potential and reward
  const bool still = c1 & c2 & (fabsf(vx) < k.lin_sleep) & (fabsf(vy) < k.lin_sleep) &
                     (fabsf(omega) < k.ang_sleep);
  const frame::End e = {x, y, vx, vy, angle, omega, c1, c2, game_over, still,
                        wind_idx, torque_idx};
  frame::finish(io, k, i, s, e, true);
}

}  // namespace rigid

#ifndef __CUDACC__
// The host build (g++, for the CPU tests): each env in turn.
extern "C" int lander_rigid_host(const rigid::IO* io, const rigid::RigidConsts* k, int n) {
  for (int i = 0; i < n; ++i) rigid::rigid_step_env(*io, *k, i);
  return 0;
}

extern "C" int lander_rigid_sizes(int* out) {
  out[0] = (int)sizeof(rigid::IO);
  out[1] = (int)sizeof(rigid::RigidConsts);
  return 0;
}
#endif

#endif  // DEEP_Q_LEARNING_TPU_TORCH_LANDER_RIGID_CUH_
