// The classic-control envs' steps for one env: the bodies of the kernels
// A1 (Acrobot), C1 (CartPole) and M1 (MountainCar) in classic_envs.cu,
// written as __host__ __device__ functions so that a host compiler builds
// the same code for the CPU tests.
//
// Each computes, for env i, exactly what the plain PyTorch version
// computes for lane i, from the same operations on the same operands in the
// same order:
//   * the step entry (step_env): deep_q_learning_tpu_torch/envs/<env>.py::
//     <Env>.step_env_reference, the port of the XLA-compiled
//     deep_q_learning_tpu/envs/acrobot.py::step_env (with _rk4_step and
//     _dynamics), cartpole.py::step_env and mountain_car.py::step_env: the
//     next state, its observation, the reward and the flags;
//   * the vector entry (vector_env): envs/base.py::VectorEnv._step without a
//     reset pool (the JAX package's VectorEnv.step, vmapped and fused by
//     XLA): the step, done = terminated | truncated, reset_env's state from
//     the injected reset draws (t = 0) and its observation, and the selects
//     of every state field and of the observation between the two; for an
//     env in TimeFractionObs, t / max_steps at the end of each observation.
//
// The plain version's arithmetic, as PyTorch rounds it:
//   * every +, -, * and / rounds once: build with contraction off (nvcc
//     --fmad=false, g++ -ffp-contract=off) and without fast math;
//   * Python folds constant expressions in double and rounds the result
//     once to float32 where it meets a tensor (M2 * L1 * LC2, (M1 * LC1 +
//     M2 * L1) * G, 4.0 / 3.0, 12 * 2 * pi / 360): the Consts structs hold
//     those float32 values, made by ops/classic_kernels.py::classic_consts;
//     an expression with a tensor on its left rounds at each step, left to
//     right;
//   * a tensor divided by a Python number (CartPole's / total_mass, the
//     time feature's / max_steps) is, on the card, a multiply by the
//     float32 of the double reciprocal 1 / c and, on the CPU, a true division
//     (lander_frame.cuh::sdiv); a tensor divided by a tensor (Acrobot's
//     d2 / d1) is a true division on both;
//   * x**2 is x * x; torch.remainder(a, b) is fmodf(a, b), plus b where
//     that is not 0 and its sign is not b's; clamp lets NaN through;
//   * sin and cos: sincosf on the card, which chip_smoke.py holds bitwise
//     to torch.sin and torch.cos there; the C library's sinf and cosf in
//     the host build, which the CPU tests give the plain version too.

#ifndef DEEP_Q_LEARNING_TPU_TORCH_CLASSIC_ENVS_CUH_
#define DEEP_Q_LEARNING_TPU_TORCH_CLASSIC_ENVS_CUH_

#include <math.h>
#include <stdint.h>

#include "lander_frame.cuh"

#ifdef __CUDACC__
#define CE_FN __host__ __device__ __forceinline__
#else
#define CE_FN inline
#endif

namespace classic {

using frame::Div;
using frame::clamp_t;
using frame::sdiv;

constexpr int kMaxFields = 4;  // an env's float state fields
constexpr int kMaxObs = 7;     // Acrobot's 6 and the time feature

// Pointers of one call, in the order of ops/classic_kernels.py::IO: (N,)
// each unless noted; flags are one byte (torch.bool).  A state field may
// be strided (a reset's fields are columns of its (N, 4) draws): stride
// counts elements.  The step entry writes next_obs and the stepped state;
// the vector entry reads reset_draws ((N, kDraws), or (N,) for one) and
// writes next_obs (before the reset), out_obs and the state after the
// auto-reset.  Observations are width = kObs (+ 1 with time_feature) wide.
struct IO {
  const float* state[kMaxFields];
  int64_t stride[kMaxFields];
  const int32_t* t;
  int64_t t_stride;
  const int32_t* action;
  const float* reset_draws;
  float* next_obs;
  float* out_obs;
  float* state_out[kMaxFields];
  int32_t* t_out;
  float* reward;
  uint8_t* terminated;
  uint8_t* truncated;
  Div time_div;  // max_steps, for t / max_steps
  int32_t time_feature;
};

// What a step gives one env: the state, the observation (room for the time
// feature), the reward and the flags.
struct Stepped {
  float s[kMaxFields];
  float obs[kMaxObs];
  float reward;
  bool terminated, truncated;
};

// sin and cos of x as each device's plain version computes them.
CE_FN void sin_cos(float x, float& s, float& c) {
#ifdef __CUDA_ARCH__
  sincosf(x, &s, &c);
#else
  s = sinf(x);
  c = cosf(x);
#endif
}

CE_FN float cos_of(float x) {
  float s, c;
  sin_cos(x, s, c);
  return c;
}

// torch.remainder of floats: the result takes the divisor's sign.
CE_FN float remainder_t(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

// ----------------------------------------------------------------- Acrobot
// envs/acrobot.py: the book's equations of motion, four RK4 stages with dt
// 0.2, the angles wrapped to [-pi, pi), the rates clamped; the goal is the
// tip above height 1.
struct Acrobot {
  static constexpr int kFields = 4, kObs = 6, kDraws = 4;
  struct Consts {
    float m1_lc1_sq, m2, l1_sq_lc2_sq, two_l1_lc2, i1, i2;  // d1
    float lc2_sq, l1_lc2;                                   // d2
    float m2_lc2_g, half_pi;                                // phi2
    float neg_m2_l1_lc2, two_m2_l1_lc2, phi1_g;             // phi1
    float m2_l1_lc2, m2_lc2_sq_i2;                          // ddtheta2
    float half_dt, dt, sixth_dt, two;                       // RK4
    float low, span;                                        // the wrap
    float max_vel1, max_vel2, goal;
    int32_t max_steps;
  };

  // _dynamics: d/dt of (theta1, theta2, dtheta1, dtheta2).
  static CE_FN void dynamics(const float* s, float torque, const Consts& k, float* out) {
    float s2, c2;
    sin_cos(s[1], s2, c2);
    const float d1 = ((k.m1_lc1_sq + k.m2 * (k.l1_sq_lc2_sq + k.two_l1_lc2 * c2)) + k.i1) + k.i2;
    const float d2 = k.m2 * (k.lc2_sq + k.l1_lc2 * c2) + k.i2;
    const float phi2 = k.m2_lc2_g * cos_of((s[0] + s[1]) - k.half_pi);
    const float phi1 = (((k.neg_m2_l1_lc2 * (s[3] * s[3])) * s2 -
                         ((k.two_m2_l1_lc2 * s[3]) * s[2]) * s2) +
                        k.phi1_g * cos_of(s[0] - k.half_pi)) +
                       phi2;
    const float dd2 = (((torque + (d2 / d1) * phi1) - (k.m2_l1_lc2 * (s[2] * s[2])) * s2) - phi2) /
                      (k.m2_lc2_sq_i2 - (d2 * d2) / d1);
    const float dd1 = -(d2 * dd2 + phi1) / d1;
    out[0] = s[2];
    out[1] = s[3];
    out[2] = dd1;
    out[3] = dd2;
  }

  static CE_FN float wrap(float x, const Consts& k) { return k.low + remainder_t(x - k.low, k.span); }

  static CE_FN void step(const float* s, int32_t t, int32_t a, const Consts& k, Stepped& r) {
    const float torque = (float)(a - 1);
    float k1[4], k2[4], k3[4], k4[4], y[4];
    dynamics(s, torque, k, k1);
    for (int f = 0; f < 4; ++f) y[f] = s[f] + k.half_dt * k1[f];
    dynamics(y, torque, k, k2);
    for (int f = 0; f < 4; ++f) y[f] = s[f] + k.half_dt * k2[f];
    dynamics(y, torque, k, k3);
    for (int f = 0; f < 4; ++f) y[f] = s[f] + k.dt * k3[f];
    dynamics(y, torque, k, k4);
    for (int f = 0; f < 4; ++f) {
      y[f] = s[f] + k.sixth_dt * (((k1[f] + k.two * k2[f]) + k.two * k3[f]) + k4[f]);
    }
    r.s[0] = wrap(y[0], k);
    r.s[1] = wrap(y[1], k);
    r.s[2] = clamp_t(y[2], -k.max_vel1, k.max_vel1);
    r.s[3] = clamp_t(y[3], -k.max_vel2, k.max_vel2);
    float s1, c1, s2, c2;
    sin_cos(r.s[0], s1, c1);
    sin_cos(r.s[1], s2, c2);
    r.terminated = (-c1 - cos_of(r.s[1] + r.s[0])) > k.goal;
    r.truncated = t >= k.max_steps && !r.terminated;
    r.reward = r.terminated ? 0.0f : -1.0f;
    obs(r.s, c1, s1, c2, s2, r.obs);
  }

  static CE_FN void obs(const float* s, float c1, float s1, float c2, float s2, float* o) {
    o[0] = c1;
    o[1] = s1;
    o[2] = c2;
    o[3] = s2;
    o[4] = s[2];
    o[5] = s[3];
  }

  // reset_env from the draws d (on (-0.1, 0.1)): the state and get_obs.
  static CE_FN void reset(const float* d, const Consts&, float* s, float* o) {
    for (int f = 0; f < 4; ++f) s[f] = d[f];
    float s1, c1, s2, c2;
    sin_cos(s[0], s1, c1);
    sin_cos(s[1], s2, c2);
    obs(s, c1, s1, c2, s2, o);
  }
};

// ---------------------------------------------------------------- CartPole
// envs/cartpole.py: one Euler step of the cart and pole, the bounds on x
// and theta.
struct CartPole {
  static constexpr int kFields = 4, kObs = 4, kDraws = 4;
  struct Consts {
    float force_mag, neg_force_mag, polemass_length;
    Div total_mass;
    float gravity, masspole, length, four_thirds, tau;
    float x_threshold, theta_threshold;
    int32_t max_steps;
  };

  static CE_FN void step(const float* s, int32_t t, int32_t a, const Consts& k, Stepped& r) {
    const float force = a == 1 ? k.force_mag : k.neg_force_mag;
    float st, ct;
    sin_cos(s[2], st, ct);
    const float temp = sdiv(force + (k.polemass_length * (s[3] * s[3])) * st, k.total_mass);
    const float thetaacc = (k.gravity * st - ct * temp) /
                           (k.length * (k.four_thirds - sdiv(k.masspole * (ct * ct), k.total_mass)));
    const float xacc = temp - sdiv((k.polemass_length * thetaacc) * ct, k.total_mass);
    r.s[0] = s[0] + k.tau * s[1];
    r.s[1] = s[1] + k.tau * xacc;
    r.s[2] = s[2] + k.tau * s[3];
    r.s[3] = s[3] + k.tau * thetaacc;
    r.terminated = fabsf(r.s[0]) > k.x_threshold || fabsf(r.s[2]) > k.theta_threshold;
    r.truncated = t >= k.max_steps && !r.terminated;
    r.reward = 1.0f;
    for (int f = 0; f < 4; ++f) r.obs[f] = r.s[f];
  }

  static CE_FN void reset(const float* d, const Consts&, float* s, float* o) {
    for (int f = 0; f < 4; ++f) s[f] = o[f] = d[f];
  }
};

// ------------------------------------------------------------- MountainCar
// envs/mountain_car.py: the push and the hill's gravity, the clipped speed
// and position, the inelastic left wall, the goal.
struct MountainCar {
  static constexpr int kFields = 2, kObs = 2, kDraws = 1;
  struct Consts {
    float force, three, neg_gravity, max_speed, min_position, max_position, goal;
    int32_t max_steps;
  };

  static CE_FN void step(const float* s, int32_t t, int32_t a, const Consts& k, Stepped& r) {
    const float push = (float)(a - 1) * k.force;
    float v = (s[1] + push) + cos_of(k.three * s[0]) * k.neg_gravity;
    v = clamp_t(v, -k.max_speed, k.max_speed);
    const float p = clamp_t(s[0] + v, k.min_position, k.max_position);
    v = (p <= k.min_position && v < 0.0f) ? 0.0f : v;
    r.s[0] = r.obs[0] = p;
    r.s[1] = r.obs[1] = v;
    r.terminated = p >= k.goal;
    r.truncated = t >= k.max_steps && !r.terminated;
    r.reward = -1.0f;
  }

  // reset_env: the drawn position (on [-0.6, -0.4)) at rest.
  static CE_FN void reset(const float* d, const Consts&, float* s, float* o) {
    s[0] = o[0] = d[0];
    s[1] = o[1] = 0.0f;
  }
};

// ------------------------------------------------------------ the entries
template <class Env>
CE_FN int32_t load(const IO& io, int i, float* s) {
  for (int f = 0; f < Env::kFields; ++f) s[f] = io.state[f][(int64_t)i * io.stride[f]];
  return io.t[(int64_t)i * io.t_stride];
}

// step_env for env i: the stepped state, its observation, the reward and
// the flags.
template <class Env>
CE_FN void step_env(const IO& io, const typename Env::Consts& k, int i) {
  float s[kMaxFields];
  const int32_t t = load<Env>(io, i, s) + 1;
  Stepped r;
  Env::step(s, t, io.action[i], k, r);
  for (int q = 0; q < Env::kObs; ++q) io.next_obs[(int64_t)i * Env::kObs + q] = r.obs[q];
  for (int f = 0; f < Env::kFields; ++f) io.state_out[f][i] = r.s[f];
  io.t_out[i] = t;
  io.reward[i] = r.reward;
  io.terminated[i] = r.terminated;
  io.truncated[i] = r.truncated;
}

// VectorEnv._step for env i without a pool: every load first, the step,
// done, the reset from the draws, the time feature, then the stores of the
// transition's fields and the selects.
template <class Env>
CE_FN void vector_env(const IO& io, const typename Env::Consts& k, int i) {
  float s[kMaxFields], d[Env::kDraws];
  const int32_t t = load<Env>(io, i, s) + 1;
  const int32_t a = io.action[i];
  for (int q = 0; q < Env::kDraws; ++q) d[q] = io.reset_draws[(int64_t)i * Env::kDraws + q];

  Stepped r;
  Env::step(s, t, a, k, r);
  const bool done = r.terminated | r.truncated;
  float fresh[kMaxFields], fresh_obs[kMaxObs];
  Env::reset(d, k, fresh, fresh_obs);
  // TimeFractionObs._augment: t.to(float32) / max_steps
  r.obs[Env::kObs] = sdiv((float)t, io.time_div);
  fresh_obs[Env::kObs] = sdiv(0.0f, io.time_div);

  const int width = Env::kObs + (io.time_feature ? 1 : 0);
  float* next_obs = io.next_obs + (int64_t)i * width;
  float* out_obs = io.out_obs + (int64_t)i * width;
  for (int q = 0; q < Env::kObs + 1; ++q) {
    if (q < width) {
      next_obs[q] = r.obs[q];
      out_obs[q] = done ? fresh_obs[q] : r.obs[q];
    }
  }
  io.reward[i] = r.reward;
  io.terminated[i] = r.terminated;
  io.truncated[i] = r.truncated;
  for (int f = 0; f < Env::kFields; ++f) io.state_out[f][i] = done ? fresh[f] : r.s[f];
  io.t_out[i] = done ? 0 : t;
}

}  // namespace classic

#ifndef __CUDACC__
// The host build (g++, for the CPU tests): env (0 Acrobot, 1 CartPole, 2
// MountainCar), the step entry or the vector entry, each env in turn.
template <class Env>
static void classic_host_loop(const classic::IO* io, const void* consts, int n, int vector) {
  const auto& k = *static_cast<const typename Env::Consts*>(consts);
  for (int i = 0; i < n; ++i) {
    if (vector) {
      classic::vector_env<Env>(*io, k, i);
    } else {
      classic::step_env<Env>(*io, k, i);
    }
  }
}

extern "C" int classic_envs_host(int env, int vector, const classic::IO* io, const void* consts,
                                 int n) {
  if (env == 0) classic_host_loop<classic::Acrobot>(io, consts, n, vector);
  if (env == 1) classic_host_loop<classic::CartPole>(io, consts, n, vector);
  if (env == 2) classic_host_loop<classic::MountainCar>(io, consts, n, vector);
  return env < 0 || env > 2;
}

extern "C" int classic_envs_sizes(int* out) {
  out[0] = (int)sizeof(classic::IO);
  out[1] = (int)sizeof(classic::Acrobot::Consts);
  out[2] = (int)sizeof(classic::CartPole::Consts);
  out[3] = (int)sizeof(classic::MountainCar::Consts);
  return 0;
}
#endif

#endif  // DEEP_Q_LEARNING_TPU_TORCH_CLASSIC_ENVS_CUH_
