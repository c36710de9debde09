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
// passes.  A division without fast math is a reciprocal, a Newton step
// and a checked call to a slow path, and sincosf a checked call to a long
// reduction: branches that split the pass into pieces the compiler cannot
// interleave, each piece waiting out its latencies, and a shuffle or a
// vote waits for the whole warp (with them J1 took ~1,230 cycles a
// velocity pass and ~2,950 a position pass on an H100,
// artifacts/rigid_kernel/j1_profile.py).  So
// the design shortens the chain an env's lanes walk (lander_solver.cuh):
//   * a pass holds no branch, no vote and no shuffle but one read of the
//     legs: every lane solves both joints whole, the plain version's
//     selects are selects here too, divisions are Markstein's correction
//     from a reciprocal rounded to nearest (a velocity pass's once a
//     frame), sin and cos the card's sincosf written out, the slop test
//     takes no square root; a part whose operands leave those ranges (a
//     position pass's part, the velocity passes all) runs again with
//     division and sincosf, so every value keeps its bits;
//   * the group's lanes split what is independent: the two legs' contact
//     solves and position passes, the start-of-step sin/cos, the hull's
//     vertices;
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
// PyTorch's sin and cos on this card, lander_fast_math.cuh::Trig).
//
// Plain C interface (no PyTorch headers), built by nvcc and loaded with
// ctypes (ops/build.py).  The launcher runs on the caller's stream,
// allocates nothing (it can be captured in a CUDA graph) and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include "lander_solver.cuh"

__global__ void __launch_bounds__(lander::kThreads, 1)
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

// A check, on no path of the program: the passes' branch-free math
// against the card's own on every float of its range, counting the values
// that differ in any bit: out[0] sincos_poly against sincosf (sine or
// cosine) for every |a| < kTrigFast, out[1] divisor_of's reciprocal
// against 1.0f / b for every kDivisorLo <= |b| <= kDivisorHi; both signs.
__global__ void fast_math_check_kernel(unsigned long long* out) {
  const uint32_t trig_top = __float_as_uint(lander::kTrigFast);
  const uint32_t rcp_lo = __float_as_uint(lander::kDivisorLo);
  const uint32_t rcp_hi = __float_as_uint(lander::kDivisorHi);
  const uint64_t stride = (uint64_t)gridDim.x * blockDim.x;
  unsigned long long trig = 0, rcp = 0;
  for (uint64_t i = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x; i < 2ull * trig_top;
       i += stride) {
    const float a = __uint_as_float((uint32_t)(i >> 1) | ((uint32_t)(i & 1) << 31));
    float s, c, s2, c2;
    sincosf(a, &s, &c);
    lander::sincos_poly(a, &s2, &c2);
    trig += (__float_as_uint(s) != __float_as_uint(s2)) | (__float_as_uint(c) != __float_as_uint(c2));
  }
  for (uint64_t i = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x;
       i < 2ull * (rcp_hi - rcp_lo + 1); i += stride) {
    const float b = __uint_as_float((rcp_lo + (uint32_t)(i >> 1)) | ((uint32_t)(i & 1) << 31));
    rcp += __float_as_uint(lander::divisor_of(b).y) != __float_as_uint(1.0f / b);
  }
  if (trig != 0) atomicAdd(&out[0], trig);
  if (rcp != 0) atomicAdd(&out[1], rcp);
}

extern "C" int fast_math_check_launch(unsigned long long* out, cudaStream_t stream) {
  fast_math_check_kernel<<<132 * 8, 256, 0, stream>>>(out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lander_solver_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(lander::IO));
  out[1] = static_cast<int>(sizeof(lander::Consts));
  return 0;
}
