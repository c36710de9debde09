// J1: one frame of N jointed LunarLanders for Hopper, S1's world.Step inside.
//
// Replaces no Pallas kernel: the JAX package writes the jointed lander's
// step as scalar code for one env (deep_q_learning_tpu/envs/lunar_lander.py::
// step_env with _physics_step_jointed, and reset_env's physics frame),
// jax.vmap batches it and XLA fuses it into the jitted superstep.  The
// port's plain PyTorch version (envs/lunar_lander.py::LunarLander.
// step_env_reference) runs the frame around the solver as ~200 elementwise
// kernels, with S1 (lander_solver.cu) for the solve.  This kernel runs the
// whole frame in one launch: the wind, the engines, S1's body
// (lander_solver.cuh::solve_env), the hull's origin, the sleep counter, the
// observation, the reward and the flags, and likewise the reset frame.  The
// body is lander_jointed.cuh, shared with the host build of the CPU tests.
//
// The launch is S1's: a group of kGroup (4) lanes an env, 16 envs a 64-thread
// block, so the presets' N = 128 runs on 8 SMs; the warp stays converged
// through the solve's loops (a group past the last env runs the last env
// with its warp and stores nothing).  What bounds it is S1's chain of
// dependent operations (lander_solver.cu): the frame around it adds two
// sincosf and a few dozen operations an env, and the bytes of the state.
//
// Build with --fmad=false (ops/build.py gives it to this source): PyTorch's
// elementwise kernels round every product and sum, and so must this code to
// agree with the plain version; no --use_fast_math, so that division,
// sqrtf, sinf and tanhf are the precise ones PyTorch calls.
//
// Plain C interface (no PyTorch headers), built by nvcc and loaded with
// ctypes (ops/build.py).  The launcher runs on the caller's stream,
// allocates nothing (it can be captured in a CUDA graph) and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include "lander_jointed.cuh"

__global__ void __launch_bounds__(lander::kThreads, 1)
jointed_step_kernel(jointed::IO io, jointed::Consts k, int n) {
  int i = (blockIdx.x * lander::kThreads + threadIdx.x) / lander::kGroup;
  // a group past the last env runs the last env with its warp and stores
  // nothing (a warp past it has no live group and leaves)
  int first = (blockIdx.x * lander::kThreads + (threadIdx.x & ~31)) / lander::kGroup;
  if (first >= n) return;
  lander::WarpLanes lanes{static_cast<int>(threadIdx.x) & (lander::kGroup - 1)};
  jointed::jointed_step_env(io, k, i < n ? i : n - 1, i < n, lanes);
}

extern "C" int jointed_step_launch(const jointed::IO* io, const jointed::Consts* k, int n,
                                   cudaStream_t stream) {
  if (n > 0) {
    jointed_step_kernel<<<lander::blocks_for(n), lander::kThreads, 0, stream>>>(*io, *k, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lander_jointed_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(jointed::IO));
  out[1] = static_cast<int>(sizeof(jointed::Consts));
  return 0;
}
