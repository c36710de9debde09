// A1, C1 and M1: the classic-control envs' steps for Hopper, one kernel an
// env (acrobot_kernel, cartpole_kernel, mountain_car_kernel), each with a
// step entry and a vector entry (the template's kVector).
//
// They replace no Pallas kernel: the JAX package writes each env's step as
// scalar code for one env (deep_q_learning_tpu/envs/acrobot.py::step_env
// with _rk4_step and _dynamics, cartpole.py::step_env,
// mountain_car.py::step_env), and jax.vmap with XLA fuses it, the per-frame
// reset from one bulk draw and the auto-reset's selects
// (deep_q_learning_tpu/envs/base.py::VectorEnv.step) into the jitted
// superstep.  The port's plain PyTorch version (envs/<env>.py::<Env>.
// step_env_reference, reset_env and envs/base.py::tree_where) runs the same
// arithmetic one elementwise kernel at a time: ~265 kernels a vector step
// for Acrobot, ~50 for CartPole, ~33 for MountainCar.  Each kernel here runs
// in one launch either the step (step_env) or the whole vector step without
// a pool (the step, done, the reset from the injected draws, the time
// feature and the selects): one thread an env.  The bodies are
// classic_envs.cuh, shared with the host build of the CPU tests.
//
// What bounds them on the card: neither bytes nor operations.  A vector
// step moves ~60-110 bytes an env and does ~30-300 float32 operations
// (ops/classic_kernels.py::classic_step_work): at N = 4096 CartPole moves
// 0.4 MB, 0.12 us at 3.35 TB/s.  A launch lasts about a launch's floor and
// one thread's chain of dependent operations (Acrobot's four RK4 stages of
// sincosf and two divisions each); every input is loaded before the step
// starts, and the reset's values are computed beside the step, off its
// chain.  The threads a block are the launcher's argument (a warp by
// default: ops/classic_kernels.py::THREADS), so that a small N spreads over
// SMs.
//
// Build with --fmad=false (ops/build.py gives it to this source): PyTorch's
// elementwise kernels round every product and sum, and so must this code to
// agree with the plain version; no --use_fast_math, so that division,
// fmodf and sincosf are the precise ones.
//
// Plain C interface (no PyTorch headers), built by nvcc and loaded with
// ctypes (ops/build.py).  The launchers run on the caller's stream,
// allocate nothing (they can be captured in a CUDA graph) and return
// cudaGetLastError().

#include <cuda_runtime.h>

#include "classic_envs.cuh"

namespace {

constexpr int kMaxThreads = 256;  // __launch_bounds__: up to 255 registers a thread

template <class Env, bool kVector>
__device__ __forceinline__ void run(const classic::IO& io, const typename Env::Consts& k, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if constexpr (kVector) {
    classic::vector_env<Env>(io, k, i);
  } else {
    classic::step_env<Env>(io, k, i);
  }
}

template <bool kVector>
__global__ void __launch_bounds__(kMaxThreads)
acrobot_kernel(classic::IO io, classic::Acrobot::Consts k, int n) {
  run<classic::Acrobot, kVector>(io, k, n);
}

template <bool kVector>
__global__ void __launch_bounds__(kMaxThreads)
cartpole_kernel(classic::IO io, classic::CartPole::Consts k, int n) {
  run<classic::CartPole, kVector>(io, k, n);
}

template <bool kVector>
__global__ void __launch_bounds__(kMaxThreads)
mountain_car_kernel(classic::IO io, classic::MountainCar::Consts k, int n) {
  run<classic::MountainCar, kVector>(io, k, n);
}

template <class Consts>
int launch(void (*step)(classic::IO, Consts, int), void (*vec)(classic::IO, Consts, int),
           const classic::IO* io, const Consts* k, int n, int vector, int threads,
           cudaStream_t stream) {
  if (threads < 1 || threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int blocks = (n + threads - 1) / threads;
    if (vector) {
      vec<<<blocks, threads, 0, stream>>>(*io, *k, n);
    } else {
      step<<<blocks, threads, 0, stream>>>(*io, *k, n);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// env: the step entry (vector 0) or the vector entry (vector 1) on n envs,
// threads a block.
extern "C" int acrobot_launch(const classic::IO* io, const classic::Acrobot::Consts* k, int n,
                              int vector, int threads, cudaStream_t stream) {
  return launch(acrobot_kernel<false>, acrobot_kernel<true>, io, k, n, vector, threads, stream);
}

extern "C" int cartpole_launch(const classic::IO* io, const classic::CartPole::Consts* k, int n,
                               int vector, int threads, cudaStream_t stream) {
  return launch(cartpole_kernel<false>, cartpole_kernel<true>, io, k, n, vector, threads, stream);
}

extern "C" int mountain_car_launch(const classic::IO* io, const classic::MountainCar::Consts* k,
                                   int n, int vector, int threads, cudaStream_t stream) {
  return launch(mountain_car_kernel<false>, mountain_car_kernel<true>, io, k, n, vector, threads,
                stream);
}

extern "C" int classic_envs_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(classic::IO));
  out[1] = static_cast<int>(sizeof(classic::Acrobot::Consts));
  out[2] = static_cast<int>(sizeof(classic::CartPole::Consts));
  out[3] = static_cast<int>(sizeof(classic::MountainCar::Consts));
  return 0;
}
