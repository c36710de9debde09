// S1: one world.Step of N jointed LunarLander assemblies for Hopper.
//
// Replaces no Pallas kernel: the JAX package writes the jointed solver as
// scalar code per env (deep_q_learning_tpu/envs/lander_solver.py::
// assembly_step), jax.vmap batches it and XLA compiles its loops into one
// program inside the jitted superstep.  The port's plain PyTorch version
// (envs/lander_solver.py::assembly_step_reference) runs the same arithmetic
// as ~56k elementwise kernels a frame at the presets' (120, 40) passes.
// This kernel runs the whole step, every pass, for one env per group of
// kGroup (4) lanes of a warp; the body is lander_solver.cuh, shared with the
// host build of the CPU tests and with J1 (lander_jointed.cu), which runs it
// inside the jointed lander's whole frame on the presets' path.
//
// What bounds it on the card: neither bytes nor operations.  A call reads
// 232 bytes and writes 180 bytes an env, and the plain version does ~53k
// float32 operations an env at the presets' (120, 40) passes
// (ops/solver_kernels.py::assembly_step_work): at N = 128, 53 KB and 6.8M
// operations, 0.1 us at an H100's published 67 TFLOP/s.  But each env is
// one long chain of dependent operations (sequential impulse passes, IEEE
// divisions, sin/cos), and the call lasts as long as its slowest warp: 120
// velocity passes and, where a lander has not settled, up to 40 position
// passes.  A division without fast math is a reciprocal, Newton steps and a
// checked slow path that the compiler keeps in order, and a warp alone on
// its scheduler waits out every latency.  So the design shortens the chain
// an env's lanes walk:
//   * the group's lanes hold the env's state alike and split what is
//     independent: the two legs' contact solves and position passes, a
//     joint's three divisions, a position joint's sin/cos and divisions,
//     the hull's vertices (lander_solver.cuh);
//   * only what a select keeps is computed: in a velocity pass a lane
//     divides once a joint (again only where a limit is violated) and a
//     leg's contacts divide only in a 2x2 block;
//   * the warp stays converged (a group past the last env runs with it, and
//     loops run while any group needs them), so every shuffle names the
//     whole warp and costs no check of which lanes arrived;
//   * 16 envs a 64-thread block, so the presets' N = 128 runs on 8 SMs, the
//     state in registers, no shared memory and no block-wide
//     synchronisation.
//
// Build with --fmad=false (ops/build.py gives it to this source alone):
// PyTorch's elementwise kernels round every product and sum, and so must
// this code to agree with the plain version; no --use_fast_math, so that
// sqrtf and division are the precise ones PyTorch calls (sincosf is bitwise
// PyTorch's sin and cos on this card, lander_solver.cuh::Trig).
//
// Plain C interface (no PyTorch headers), built by nvcc and loaded with
// ctypes (ops/build.py).  The launcher runs on the caller's stream,
// allocates nothing (it can be captured in a CUDA graph) and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include "lander_solver.cuh"

__global__ void __launch_bounds__(lander::kThreads)
assembly_step_kernel(lander::IO io, lander::Consts k, int n, int vel_iters, int pos_iters) {
  int i = (blockIdx.x * lander::kThreads + threadIdx.x) / lander::kGroup;
  // a group past the last env runs the last env with its warp and stores
  // nothing (a warp past it has no live group and leaves)
  int first = (blockIdx.x * lander::kThreads + (threadIdx.x & ~31)) / lander::kGroup;
  if (first >= n) return;
  lander::WarpLanes lanes{static_cast<int>(threadIdx.x) & (lander::kGroup - 1)};
  lander::assembly_step_env(io, k, i < n ? i : n - 1, i < n, vel_iters, pos_iters, lanes);
}

extern "C" int assembly_step_launch(const lander::IO* io, const lander::Consts* k, int n,
                                    int vel_iters, int pos_iters, cudaStream_t stream) {
  if (n > 0) {
    assembly_step_kernel<<<lander::blocks_for(n), lander::kThreads, 0, stream>>>(
        *io, *k, n, vel_iters, pos_iters);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lander_solver_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(lander::IO));
  out[1] = static_cast<int>(sizeof(lander::Consts));
  return 0;
}
