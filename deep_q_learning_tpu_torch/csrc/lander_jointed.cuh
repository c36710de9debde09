// One frame of the jointed LunarLander for one env: the body of the J1
// kernel (lander_jointed.cu), written as __host__ __device__ functions so
// that a host compiler builds the same code for the CPU tests.
//
// It computes, for env i, exactly what the plain PyTorch version
// deep_q_learning_tpu_torch/envs/lunar_lander.py::LunarLander.
// step_env_reference computes for lane i with the jointed engine (the port
// of the XLA-compiled deep_q_learning_tpu/envs/lunar_lander.py::step_env
// with _physics_step_jointed), and reset_env_reference its reset frame:
// every value comes from the same operations on the same operands, in the
// same order:
//   1. the frame's start (lander_frame.cuh::start_of): a step's state and
//      engine dispersion, or reset_env's fresh lander, its legs where
//      reset_env places them (at rest, angles +-0.05) and zero accumulators;
//   2. the hull's COM from its origin (lander_solver.py::hull_com);
//   3. wind and turbulence where enabled, forces on the hull only while
//      airborne, and the reset frame's kick force;
//   4. the main and side engines' impulses with gym's geometry
//      (lander_frame.cuh::engines) on the hull's velocities, at the hull's
//      mass and inertia (IMH, IIH);
//   5. Box2D's world.Step of the three bodies: S1's body,
//      lander_solver.cuh::solve_env, called here, not copied;
//   6. the hull's origin from its COM (hull_origin) and the island's sleep
//      predicate;
//   7. the sleep counter, the observation, the shaping potential, the reward
//      and the flags, crash = the hull touching the terrain or out of bounds
//      (the step), or the reset's potential and t = 0 (the reset frame):
//      lander_frame.cuh::finish.
//
// A group of kGroup lanes runs an env, as in S1: every lane computes the
// frame's start and end alike (S1 holds the env's bodies on every lane), the
// leg contacts read from the lanes that own the legs; rank 0 stores the
// frame's outputs, ranks 0 and 1 each its leg's body and accumulators.  The
// branches after the solve come after every shuffle, and those before it
// are the same on every lane of the warp, so S1's loops stay converged.
// lander_frame.cuh says how the plain version's arithmetic rounds and how
// this code repeats it; lander_solver.cuh the solve's.

#ifndef DEEP_Q_LEARNING_TPU_TORCH_LANDER_JOINTED_CUH_
#define DEEP_Q_LEARNING_TPU_TORCH_LANDER_JOINTED_CUH_

#include <math.h>
#include <stdint.h>

#include "lander_frame.cuh"
#include "lander_solver.cuh"

#ifdef __CUDACC__
#define LJ_FN __host__ __device__ __forceinline__
#else
#define LJ_FN inline
#endif

namespace jointed {

// The frame's constants (lander_frame.cuh; ops/lander_kernels.py::
// rigid_consts of the params), the solver's (lander_solver.cuh;
// ops/solver_kernels.py::solver_consts), and the jointed frame's own, in
// the order of ops/jointed_kernels.py::Consts.
struct Consts {
  frame::FrameConsts frame;
  lander::Consts solver;
  float hull_cx, hull_cy;        // HULL_CX (0), HULL_CY: the hull's COM in its frame
  float leg_x[2], leg_a[2];      // a fresh leg's x (W / 2 - side * LEG_AWAY) and angle
  int32_t vel_iters, pos_iters;
};

// Pointers of one call, in the order of ops/jointed_kernels.py::IO: the
// frame's (lander_frame.cuh) and the solver's (lander_solver.cuh), of which
// the frame reads and writes the legs' bodies (body[6..17], body_out[6..17])
// and the accumulators (j, s, c and j_out, s_out, c_out; the reset frame
// reads none), and pos_used where not null; terrain is the frame's.  The
// solver's hull, forces and flags are not used.
struct IO {
  frame::IO frame;
  lander::IO solver;
};

// rot(a, HULL_CX, HULL_CY) of lander_solver.py, with a's sin and cos.
LJ_FN void hull_offset(const lander::Trig& t, const Consts& k, float* ox, float* oy) {
  *ox = t.c * k.hull_cx - t.s * k.hull_cy;
  *oy = t.s * k.hull_cx + t.c * k.hull_cy;
}

// The frame of env i on the group's lanes (a group that is not live runs
// env i with its warp and stores nothing).
template <class Lanes>
LJ_FN void jointed_step_env(const IO& io, const Consts& k, int i, bool live, const Lanes& lanes) {
  const frame::IO& fio = io.frame;
  const frame::FrameConsts& fk = k.frame;
  const lander::Consts& sk = k.solver;
  const frame::Start s = frame::start_of(fio, fk, i);

  // ---- the hull's COM, the wind, the kick and the engines' impulses
  const lander::Trig t0 = lander::trig_of(s.angle);
  float ox, oy;
  hull_offset(t0, k, &ox, &oy);
  const float comx = s.x + ox, comy = s.y + oy;

  float fx = 0.0f, fy = 0.0f, torque = 0.0f;
  int32_t wind_idx = s.wind_idx, torque_idx = s.torque_idx;
  if (fk.enable_wind) {
    const bool airborne = !(s.leg1 | s.leg2);
    fx = fx + (airborne ? frame::wind_pattern(wind_idx, fk) * fk.wind_power : 0.0f);
    torque = torque + (airborne ? frame::wind_pattern(torque_idx, fk) * fk.turbulence_power
                                : 0.0f);
    wind_idx = wind_idx + (int32_t)airborne;
    torque_idx = torque_idx + (int32_t)airborne;
  }
  if (s.reset) {
    fx = fx + fio.kick[2 * i];
    fy = fy + fio.kick[2 * i + 1];
  }

  frame::Impulse main, side;
  frame::engines(s, t0.s, t0.c, comx, comy, fk, main, side);
  lander::Pos hp = {comx, comy, s.angle};
  lander::Vel hv = {s.vx, s.vy, s.omega};
  hv.vx = hv.vx + main.jx * sk.imh;
  hv.vy = hv.vy + main.jy * sk.imh;
  hv.w = hv.w + (main.rx * main.jy - main.ry * main.jx) * sk.iih;
  hv.vx = hv.vx + side.jx * sk.imh;
  hv.vy = hv.vy + side.jy * sk.imh;
  hv.w = hv.w + (side.rx * side.jy - side.ry * side.jx) * sk.iih;

  // ---- the legs, then S1's step of the three bodies
  lander::Pos lp[2];
  lander::Vel lv[2];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    if (s.reset) {
      lp[g] = {k.leg_x[g], fk.height, k.leg_a[g]};
      lv[g] = {0.0f, 0.0f, 0.0f};
    } else {
      const float* const* b = io.solver.body + 6 * (g + 1);
      lp[g] = {b[0][i], b[1][i], b[2][i]};
      lv[g] = {b[3][i], b[4][i], b[5][i]};
    }
  }
  lander::StepFlags<Lanes::kLocal> f;
  lander::solve_env(io.solver, sk, i, live, s.reset, k.vel_iters, k.pos_iters, lanes, fx, fy,
                    torque, hp, hv, lp, lv, f);
  lander::store_legs(io.solver.body_out, i, live, lanes, lp, lv);

  // ---- the hull's origin, the leg contacts on every lane, the frame's end
  int touch[Lanes::kLocal];
#pragma unroll
  for (int l = 0; l < Lanes::kLocal; ++l) touch[l] = f.touch[l];
  const bool leg1 = lanes.read(touch, 0) != 0;
  const bool leg2 = lanes.read(touch, 1) != 0;
  hull_offset(lander::trig_of(hp.a), k, &ox, &oy);
  const frame::End e = {hp.cx - ox, hp.cy - oy, hv.vx, hv.vy, hp.a, hv.w, leg1, leg2,
                        f.hull_hit, lander::island_still(hv, lv, sk), wind_idx, torque_idx};
  bool rank0 = false;
#pragma unroll
  for (int l = 0; l < Lanes::kLocal; ++l) {
    const bool store = live && lanes.rank(l) == 0;
    rank0 = rank0 | store;
    if (store && io.solver.pos_used != nullptr) io.solver.pos_used[i] = f.pos_used;
  }
  frame::finish(fio, fk, i, s, e, rank0);
}

}  // namespace jointed

#ifndef __CUDACC__
// The host build (g++, for the CPU tests): each env's group in turn
// (lander_solver.cuh::HostLanes); with others, each group runs every pass
// its loops allow.
extern "C" int lander_jointed_host(const jointed::IO* io, const jointed::Consts* k, int n,
                                   int others) {
  lander::HostLanes lanes{others != 0};
  for (int i = 0; i < n; ++i) jointed::jointed_step_env(*io, *k, i, true, lanes);
  return 0;
}

extern "C" int lander_jointed_sizes(int* out) {
  out[0] = (int)sizeof(jointed::IO);
  out[1] = (int)sizeof(jointed::Consts);
  return 0;
}
#endif

#endif  // DEEP_Q_LEARNING_TPU_TORCH_LANDER_JOINTED_CUH_
