// R1: one frame of N rigid LunarLanders for Hopper, and the rigid vector
// step around it.
//
// Replaces no Pallas kernel: the JAX package writes the rigid lander's step
// as scalar code for one env (deep_q_learning_tpu/envs/lunar_lander.py::
// step_env with _physics_step), and jax.vmap with XLA fuses it, the vector
// step's auto-reset selects and the time feature
// (deep_q_learning_tpu/envs/base.py::VectorEnv.step, envs/wrappers.py::
// TimeFractionObs) into the jitted superstep.  The port's plain PyTorch
// version (envs/lunar_lander.py::LunarLander.step_env_reference, then
// envs/base.py::tree_where and TimeFractionObs._augment) runs the same
// arithmetic as ~700 elementwise kernels a frame and 19 more around it.
// This kernel runs in one launch either the frame (rigid_step_kernel<false>:
// step_env, or reset_env's physics frame) or the whole vector step with a
// reset pool (rigid_step_kernel<true>: the frame, done, the time feature,
// and the selects between the stepped state and the pool's entry): one
// thread an env, kThreads a block.  The body is lander_rigid.cuh, shared
// with the host build of the CPU tests.
//
// What bounds it on the card: neither bytes nor operations.  A vector step
// reads ~225 bytes and writes ~160 an env and does ~546 float32 operations
// (ops/lander_kernels.py::rigid_step_work): at N = 128, 50 KB, 0.015 us at
// 3.35 TB/s.  Each env is one chain of dependent operations, so a launch
// lasts about a launch's floor and one thread's chain; the body keeps that
// chain short (lander_rigid.cuh: every load first, the terrain row off the
// chain, sin, cos and the solve's quotients without a branch).
//
// Build with --fmad=false (ops/build.py gives it to this source): PyTorch's
// elementwise kernels round every product and sum, and so must this code to
// agree with the plain version; no --use_fast_math, so that division, sqrtf,
// sinf and tanhf are the precise ones PyTorch calls.
//
// Plain C interface (no PyTorch headers), built by nvcc and loaded with
// ctypes (ops/build.py).  The launchers run on the caller's stream,
// allocate nothing (they can be captured in a CUDA graph) and return
// cudaGetLastError().

#include <cuda_runtime.h>

#include "lander_rigid.cuh"

namespace {

// One warp a block: at N = 128 four SMs run an env's warp each, not one SM
// all four (PERF.md: the vector step's strided row loads and stores then
// share one SM's L1).
constexpr int kThreads = 32;

// Env i = blockIdx.x * kThreads + threadIdx.x; its terrain row read first.
template <bool kVector>
__global__ void __launch_bounds__(kThreads)
rigid_step_kernel(rigid::VecIO v, rigid::RigidConsts k, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const rigid::RegRow ter = rigid::load_row(v.step.terrain + (int64_t)i * rigid::kChunks);
  if constexpr (kVector) {
    rigid::rigid_vector_env(v, k, i, ter);
  } else {
    rigid::rigid_step_env(v.step, k, i, ter);
  }
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
    rigid::VecIO v = {};
    v.step = *io;
    rigid_step_kernel<false><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(v, *k, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rigid_vector_launch(const rigid::VecIO* v, const rigid::RigidConsts* k, int n,
                                   cudaStream_t stream) {
  if (n > 0) {
    rigid_step_kernel<true><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(*v, *k, n);
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
  out[2] = static_cast<int>(sizeof(rigid::VecIO));
  return 0;
}
