// R1: one frame of N rigid LunarLanders for Hopper.
//
// Replaces no Pallas kernel: the JAX package writes the rigid lander's step
// as scalar code for one env (deep_q_learning_tpu/envs/lunar_lander.py::
// step_env with _physics_step), jax.vmap batches it and XLA fuses it into
// the jitted superstep.  The port's plain PyTorch version
// (envs/lunar_lander.py::LunarLander.step_env_reference) runs the same
// arithmetic as ~700 elementwise kernels a frame.  This kernel runs the
// whole frame, observation, reward and flags included, in one launch: one
// thread an env, 128 threads a block (lunar_per's N = 128 is one block,
// multihost_ddqn's 8192 are 64).  The body is lander_rigid.cuh, shared with
// the host build of the CPU tests; the reset frame (reset_env's physics
// frame with the kick) runs through the same body.
//
// What bounds it on the card: neither bytes nor operations.  A step reads
// 94 bytes and writes 76 an env (102 and 84 with the wind) and does 546
// float32 operations (ops/lander_kernels.py::rigid_step_work): at N = 128,
// 22 KB, 0.0065 us at 3.35 TB/s.  Each env is one short chain of dependent
// operations (two sincosf, six terrain lookups, four solve passes with four
// IEEE divisions each), so a launch lasts about a launch's floor and one
// thread's chain (3.4-4.8 us at N = 1-8192 on an H100, PERF.md); this first
// kernel keeps the state in registers and reads each terrain height where a
// lookup needs it (the row stays in L1).
//
// Build with --fmad=false (ops/build.py gives it to this source): PyTorch's
// elementwise kernels round every product and sum, and so must this code to
// agree with the plain version; no --use_fast_math, so that division, sqrtf,
// sinf and tanhf are the precise ones PyTorch calls.
//
// Plain C interface (no PyTorch headers), built by nvcc and loaded with
// ctypes (ops/build.py).  The launcher runs on the caller's stream,
// allocates nothing (it can be captured in a CUDA graph) and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include "lander_rigid.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
rigid_step_kernel(rigid::IO io, rigid::RigidConsts k, int n) {
  int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) rigid::rigid_step_env(io, k, i);
}

// The card's sinf, cosf, sincosf and tanhf of n floats, for chip_smoke.py
// to hold them to torch.sin, torch.cos and torch.tanh on the card.
__global__ void rigid_math_kernel(const float* x, float* out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s, c;
  sincosf(x[i], &s, &c);
  out[i] = sinf(x[i]);
  out[n + i] = cosf(x[i]);
  out[2 * n + i] = s;
  out[3 * n + i] = c;
  out[4 * n + i] = tanhf(x[i]);
}

}  // namespace

extern "C" int rigid_step_launch(const rigid::IO* io, const rigid::RigidConsts* k, int n,
                                 cudaStream_t stream) {
  if (n > 0) {
    rigid_step_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(*io, *k, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// out: (5, n): sinf, cosf, sincosf's sine and cosine, tanhf.
extern "C" int rigid_math_launch(const float* x, float* out, int n, cudaStream_t stream) {
  if (n > 0) rigid_math_kernel<<<(n + 255) / 256, 256, 0, stream>>>(x, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lander_rigid_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(rigid::IO));
  out[1] = static_cast<int>(sizeof(rigid::RigidConsts));
  return 0;
}
