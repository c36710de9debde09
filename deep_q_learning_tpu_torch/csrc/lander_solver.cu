// S1: one world.Step of N jointed LunarLander assemblies for Hopper.
//
// Replaces no Pallas kernel: the JAX package writes the jointed solver as
// scalar code per env (deep_q_learning_tpu/envs/lander_solver.py::
// assembly_step), jax.vmap batches it and XLA compiles its loops into one
// program inside the jitted superstep.  The port's plain PyTorch version
// (envs/lander_solver.py::assembly_step_reference) runs the same arithmetic
// as ~56k elementwise kernels a frame at the presets' (120, 40) passes.
// This kernel runs the whole step, every pass, for one env per thread; the
// body is lander_solver.cuh, shared with the host build of the CPU tests.
//
// What bounds it on the card: neither bytes nor operations.  A call reads
// 232 bytes and writes 180 bytes an env, and does ~66k float32 operations
// an env at the presets' (120, 40) passes (ops/solver_kernels.py::
// assembly_step_work): at N = 128, 53 KB and 8.4M operations, 0.13 us at
// an H100's published 67 TFLOP/s.  But each env is one long chain of dependent
// operations (sequential impulse passes, divisions, sin/cos), and at the
// presets' N = 128 the whole call is one block of 128 threads on one SM of
// 132.  So its time is the latency of that chain, and the design is the
// simple one: one thread an env, its state in registers
// (__launch_bounds__(128) lets ptxas use up to 255 a thread), early exits
// per thread with no host read, no shared memory and no synchronisation.
// Spreading an env over a warp or over more SMs is later work (ROADMAP).
//
// Build with --fmad=false (ops/build.py gives it to this source alone):
// PyTorch's elementwise kernels round every product and sum, and so must
// this code to agree with the plain version; no --use_fast_math, so that
// sinf/cosf/sqrtf and division are the precise ones PyTorch calls.
//
// Plain C interface (no PyTorch headers), built by nvcc and loaded with
// ctypes (ops/build.py).  The launcher runs on the caller's stream,
// allocates nothing (it can be captured in a CUDA graph) and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include "lander_solver.cuh"

namespace {

constexpr int kThreads = 128;

}  // namespace

__global__ void __launch_bounds__(kThreads)
assembly_step_kernel(lander::IO io, lander::Consts k, int n, int vel_iters, int pos_iters) {
  int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) lander::assembly_step_env(io, k, i, vel_iters, pos_iters);
}

extern "C" int assembly_step_launch(const lander::IO* io, const lander::Consts* k, int n,
                                    int vel_iters, int pos_iters, cudaStream_t stream) {
  if (n > 0) {
    assembly_step_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        *io, *k, n, vel_iters, pos_iters);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lander_solver_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(lander::IO));
  out[1] = static_cast<int>(sizeof(lander::Consts));
  return 0;
}
