// What one LunarLander frame computes around its physics, for one env: the
// part that the rigid lander's kernel R1 (lander_rigid.cu) and the jointed
// lander's kernel J1 (lander_jointed.cu) share, written as __host__
// __device__ functions so that a host compiler builds the same code for the
// CPU tests.
//
// Each function computes what the plain PyTorch version
// deep_q_learning_tpu_torch/envs/lunar_lander.py::LunarLander computes for
// lane i (step_env_reference and reset_env_reference, both engines):
//   * the frame's start (start_of): a step's state, actions and engine
//     dispersion (the step's draws over SCALE, times the dispersion scale),
//     or reset_env's fresh lander with the nop action and zero dispersion;
//   * gymnasium v3's wind pattern, tanh(sin(0.02 f) + sin(pi 0.01 f));
//   * the main and side engines' impulses with gym's geometry (engines);
//   * the frame's end (finish): the sleep counter and the rest trigger, the
//     observation, the shaping potential, the reward and the flags (a
//     step), or the reset's potential and t = 0 (the reset frame), stored.
//
// The plain version's arithmetic, as PyTorch rounds it:
//   * every +, -, * and / rounds once: build with contraction off (nvcc
//     --fmad=false, g++ -ffp-contract=off) and without fast math;
//   * a tensor divided by a Python float (x / SCALE, the observation's
//     scalings) is, on the card, a multiply by the float32 of the double
//     reciprocal 1 / c, and on the CPU a true division: sdiv() below does
//     what each device does (ROADMAP F5);
//   * Python folds constant expressions in double and rounds the result
//     once to float32 where it meets a tensor (HELIPAD_Y + LEG_DOWN,
//     MAIN_ENGINE_Y_LOCATION / SCALE, pi * 0.01): struct FrameConsts holds
//     those float32 values, made by ops/lander_kernels.py::const_values; an
//     expression with a tensor on its left (tip0 * 17.0 / SCALE) rounds at
//     each step, left to right;
//   * clamp, clamp_min and maximum propagate NaN as PyTorch's kernels do;
//   * sin and cos: sincosf on the card, bitwise torch.sin and torch.cos
//     there, or its branch-free transcription (lander_fast_math.cuh::Trig,
//     sincos_poly); tanhf and sinf in the wind pattern
//     and sqrtf in the potential, held to torch's on the card by
//     chip_smoke.py; the C library's in the host build, which the CPU tests
//     give the plain version too.

#ifndef DEEP_Q_LEARNING_TPU_TORCH_LANDER_FRAME_CUH_
#define DEEP_Q_LEARNING_TPU_TORCH_LANDER_FRAME_CUH_

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define LF_FN __host__ __device__ __forceinline__
#else
#define LF_FN inline
#endif

namespace frame {

constexpr int kChunks = 11;  // terrain heights per env
constexpr int kObs = 8;

// A Python float that a tensor is divided by: the float32 constant and the
// float32 of its double reciprocal, float32(1 / c), as PyTorch's CUDA
// division takes it (ops/lander_kernels.py::card_div).
struct Div {
  float c, inv;
};

// Float32 constants and the params, in the order of
// ops/lander_kernels.py::CONST_FIELDS.  The rigid engine reads them all;
// the jointed engine the frame's (not the rigid body's mass, inertia,
// COM offset, leg tips, contact terms and hull corners).
struct FrameConsts {
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
LF_FN float sdiv(float x, const Div& d) {
#ifdef __CUDA_ARCH__
  return x * d.inv;
#else
  return x / d.c;
#endif
}

// torch.clamp, clamp(min=) and maximum: NaN passes through.
LF_FN float clamp_t(float v, float lo, float hi) { return v != v ? v : fminf(fmaxf(v, lo), hi); }
LF_FN float clamp_min_t(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
LF_FN float maximum_t(float a, float b) { return a != a ? a : (b != b ? b : fmaxf(a, b)); }

// _wind_pattern: tanh(sin(0.02 f) + sin(pi 0.01 f)) of the float index f.
LF_FN float wind_pattern(int32_t idx, const FrameConsts& k) {
  float f = (float)idx;
  return tanhf(sinf(f * k.wind_k1) + sinf(f * k.wind_k2));
}

// --------------------------------------------------------- a frame's start
// The start-of-frame state of env i: a step's, or reset_env's fresh lander.
struct Start {
  bool reset;
  float x, y, angle, vx, vy, omega;
  bool leg1, leg2;
  int32_t sleep, wind_idx, torque_idx, action;
  float d0, d1;  // the engine dispersion
};

LF_FN Start start_of(const IO& io, const FrameConsts& k, int i) {
  Start s;
  s.reset = io.kick != nullptr;
  s.x = k.half_w.c;
  s.y = k.height;
  s.angle = s.vx = s.vy = s.omega = 0.0f;
  s.leg1 = s.leg2 = false;
  s.sleep = s.wind_idx = s.torque_idx = s.action = 0;
  s.d0 = s.d1 = 0.0f;
  if (s.reset) {
    s.wind_idx = io.wind_draws[2 * i];
    s.torque_idx = io.wind_draws[2 * i + 1];
    return s;
  }
  s.x = io.state[0][i];
  s.y = io.state[1][i];
  s.vx = io.state[2][i];
  s.vy = io.state[3][i];
  s.angle = io.state[4][i];
  s.omega = io.state[5][i];
  s.leg1 = io.leg[0][i] != 0;
  s.leg2 = io.leg[1][i] != 0;
  s.sleep = io.sleep[i];
  s.action = io.action[i];
  if (k.enable_wind) {
    s.wind_idx = io.wind_idx[i];
    s.torque_idx = io.torque_idx[i];
  }
  // draws / SCALE * dispersion_scale
  s.d0 = sdiv(io.draws[2 * i], k.scale) * k.dispersion_scale;
  s.d1 = sdiv(io.draws[2 * i + 1], k.scale) * k.dispersion_scale;
  return s;
}

// ------------------------------------------------------------- the engines
// An engine's impulse (jx, jy) and its point relative to the COM (rx, ry).
struct Impulse {
  float jx, jy, rx, ry;
};

// The main and side engines' impulses with gym's geometry at the
// start-of-frame pose (sin_a, cos_a of its angle; com the hull's COM).
LF_FN void engines(const Start& s, float sin_a, float cos_a, float comx, float comy,
                   const FrameConsts& k, Impulse& main, Impulse& side) {
  const float tip0 = sin_a, tip1 = cos_a;
  const float side0 = -cos_a, side1 = sin_a;
  const float m_power = s.action == 2 ? 1.0f : 0.0f;
  const float k_main = 2.0f * s.d0 + k.main_y;
  const float ox_m = tip0 * k_main + side0 * s.d1;
  const float oy_m = -tip1 * k_main - side1 * s.d1;
  main.jx = -ox_m * k.main_power * m_power;
  main.jy = -oy_m * k.main_power * m_power;
  main.rx = (s.x + ox_m) - comx;
  main.ry = (s.y + oy_m) - comy;

  const float s_power = (s.action == 1) | (s.action == 3) ? 1.0f : 0.0f;
  const float direction = s.action == 3 ? 1.0f : (s.action == 1 ? -1.0f : 0.0f);
  const float k_side = 3.0f * s.d1 + direction * k.side_away;
  const float ox_s = tip0 * s.d0 + side0 * k_side;
  const float oy_s = -tip1 * s.d0 - side1 * k_side;
  side.jx = -ox_s * k.side_power * s_power;
  side.jy = -oy_s * k.side_power * s_power;
  // the published 17-vs-14 impulse-position quirk, reproduced verbatim
  side.rx = ((s.x + ox_s) - sdiv(tip0 * 17.0f, k.scale)) - comx;
  side.ry = ((s.y + oy_s) + tip1 * k.side_height) - comy;
}

// ---------------------------------------------------------- a frame's end
// The physics' result of env i's frame: the hull's origin, velocities and
// angle, the leg contacts, the crash, Box2D's sleep predicate and the wind
// indices after the frame.
struct End {
  float x, y, vx, vy, angle, omega;
  bool leg1, leg2, game_over, still;
  int32_t wind_idx, torque_idx;
};

// What a frame's end gives env i: the sleep counter, the observation, the
// shaping potential, and for a step (t_in and prev_shaping: the state's t
// and potential) t, the reward and the flags; the reset frame's t is 0.
struct Outcome {
  float obs[kObs];
  float shaping, reward;
  int32_t sleep, t;
  bool terminated, truncated;
};

LF_FN Outcome outcome(const FrameConsts& k, const Start& s, const End& e, int32_t t_in,
                      float prev_shaping) {
  Outcome r;
  r.sleep = e.still ? s.sleep + 1 : 0;
  const bool rest = r.sleep >= k.sleep_frames;

  float* o = r.obs;
  o[0] = sdiv(e.x - k.half_w.c, k.half_w);
  o[1] = sdiv(e.y - k.pad_y, k.half_h);
  o[2] = sdiv(e.vx * k.half_w.c, k.fps);
  o[3] = sdiv(e.vy * k.half_h.c, k.fps);
  o[4] = e.angle;
  o[5] = sdiv(e.omega * 20.0f, k.fps);
  o[6] = e.leg1 ? 1.0f : 0.0f;
  o[7] = e.leg2 ? 1.0f : 0.0f;
  r.shaping = ((((sqrtf(o[0] * o[0] + o[1] * o[1]) * -100.0f) -
                 sqrtf(o[2] * o[2] + o[3] * o[3]) * 100.0f) -
                fabsf(o[4]) * 100.0f) +
               o[6] * 10.0f) +
              o[7] * 10.0f;
  r.t = 0;
  r.reward = 0.0f;
  r.terminated = r.truncated = false;
  if (s.reset) return r;
  r.t = t_in + 1;

  // the reward and the flags
  const float m_power = s.action == 2 ? 1.0f : 0.0f;
  const float s_power = (s.action == 1) | (s.action == 3) ? 1.0f : 0.0f;
  float reward = r.shaping - prev_shaping;
  reward = (reward - m_power * 0.3f) - s_power * 0.03f;
  const bool out_of_bounds = fabsf(o[0]) >= 1.0f;
  const bool crash = e.game_over | out_of_bounds;
  r.reward = crash ? -100.0f : (rest ? 100.0f : reward);
  r.terminated = crash | rest;
  r.truncated = (r.t >= k.max_steps) & !r.terminated;
  return r;
}

// Env i's frame stored through io: the observation, the state, and for a
// step the reward and the flags.
LF_FN void store(const IO& io, int i, const Start& s, const End& e, const Outcome& r) {
  float* obs = io.obs + (int64_t)i * kObs;
#pragma unroll
  for (int q = 0; q < kObs; ++q) obs[q] = r.obs[q];
  io.state_out[0][i] = e.x;
  io.state_out[1][i] = e.y;
  io.state_out[2][i] = e.vx;
  io.state_out[3][i] = e.vy;
  io.state_out[4][i] = e.angle;
  io.state_out[5][i] = e.omega;
  io.leg_out[0][i] = e.leg1;
  io.leg_out[1][i] = e.leg2;
  io.shaping_out[i] = r.shaping;
  io.sleep_out[i] = r.sleep;
  if (io.wind_out != nullptr) {
    io.wind_out[i] = e.wind_idx;
    io.torque_out[i] = e.torque_idx;
  }
  io.t_out[i] = r.t;
  if (s.reset) return;
  io.reward[i] = r.reward;
  io.terminated[i] = r.terminated;
  io.truncated[i] = r.truncated;
}

// outcome() of env i's frame, its t and potential read from io, stored
// where store holds.
LF_FN void finish(const IO& io, const FrameConsts& k, int i, const Start& s, const End& e,
                  bool store_it) {
  if (!store_it) return;
  const bool step = !s.reset;
  store(io, i, s, e, outcome(k, s, e, step ? io.t[i] : 0, step ? io.prev_shaping[i] : 0.0f));
}

}  // namespace frame

#ifndef __CUDACC__
// sinf (which = 0), cosf (1), tanhf (2) or sqrtf (3) of n floats: the C
// library's, which the host builds of S1, R1 and J1 call, for the CPU tests
// to give the plain version the same values (PyTorch's CPU kernels compute
// these functions otherwise: their results differ in the last ulp on some
// inputs, sqrt's too).
extern "C" int lander_math_host(const float* x, float* out, int n, int which) {
  for (int i = 0; i < n; ++i) {
    float v = x[i];
    out[i] = which == 0 ? sinf(v) : (which == 1 ? cosf(v) : (which == 2 ? tanhf(v) : sqrtf(v)));
  }
  return 0;
}
#endif

#endif  // DEEP_Q_LEARNING_TPU_TORCH_LANDER_FRAME_CUH_
