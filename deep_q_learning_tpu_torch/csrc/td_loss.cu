// Fused double-DQN TD target + huber loss, forward and backward, for Hopper.
//
// Replaces the Pallas TPU kernels of deep_q_learning_tpu/ops/td_kernels.py:
//   _fwd_kernel (pl.pallas_call at td_kernels.py:148) -> td_loss_fwd_kernel
//   _bwd_kernel (pl.pallas_call at td_kernels.py:187) -> td_loss_bwd_kernel
//
// Forward, per row b of a batch of B with A actions:
//   a*   = argmax_a Q_online(s', a)   (double; first max, as jnp.argmax)
//   boot = Q_target(s', a*)           or max_a Q_target(s', a)
//   y    = G + bootstrap * boot
//   td   = y - Q(s, a)
//   loss = sum_b w * huber_delta(td) / B
// Backward (targets are stopped):
//   dQ(s, a) = -w * clip(td, -delta, delta) * g / B at the taken action, 0 elsewhere.
//
// What bounds it on the card: nothing but launch latency.  At the shapes the
// main path gives it (B = 256..1024, A = 4) the forward reads 3*B*A + 4*B
// floats (a few KB) and the backward writes B*A; both finish in a few
// microseconds.  So the design is the simple one:
//   * the forward is ONE block: thread t handles rows t, t + blockDim, ...
//     (one thread per row, looping over the A actions), then a fixed-order
//     shared-memory tree reduces the loss.  No atomics, so the loss is
//     bitwise deterministic run to run; one launch instead of a second pass.
//   * the backward is elementwise over B*A and reads the cotangent g from a
//     device pointer, so the backward never synchronises with the host.
// Products and sums that feed td use the _rn intrinsics so that nvcc does
// not contract them into FMAs: td then rounds as the plain PyTorch version
// (ops/td_kernels.py::td_loss_reference) does.
//
// Plain C interface (no PyTorch headers), built by nvcc and loaded with
// ctypes (ops/build.py).  Each launcher returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kFwdThreads = 256;  // power of two: the tree halves it
constexpr int kBwdThreads = 256;

__global__ void td_loss_fwd_kernel(const float* __restrict__ q_s,
                                   const float* __restrict__ q_next_online,
                                   const float* __restrict__ q_next_target,
                                   const int* __restrict__ action,
                                   const float* __restrict__ reward,
                                   const float* __restrict__ bootstrap,
                                   const float* __restrict__ weights,
                                   float* __restrict__ loss,
                                   float* __restrict__ td,
                                   int B, int A, float delta, int dbl) {
  __shared__ float partial[kFwdThreads];
  float acc = 0.0f;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const float* q_no = q_next_online + static_cast<size_t>(b) * A;
    const float* q_nt = q_next_target + static_cast<size_t>(b) * A;
    float boot;
    if (dbl) {
      int best = 0;
      float m = q_no[0];
      for (int a = 1; a < A; ++a) {
        if (q_no[a] > m) {  // strict: the first maximum wins
          m = q_no[a];
          best = a;
        }
      }
      boot = q_nt[best];
    } else {
      boot = q_nt[0];
      for (int a = 1; a < A; ++a) boot = q_nt[a] > boot ? q_nt[a] : boot;
    }
    const float y = __fadd_rn(reward[b], __fmul_rn(bootstrap[b], boot));
    const int act = action[b];
    // an action outside [0, A) selects nothing, like the one-hot gather
    const float q_taken =
        (act >= 0 && act < A) ? q_s[static_cast<size_t>(b) * A + act] : 0.0f;
    const float t = __fsub_rn(y, q_taken);
    td[b] = t;
    const float abs_t = fabsf(t);
    const float quad = fminf(abs_t, delta);
    const float per = __fadd_rn(__fmul_rn(__fmul_rn(0.5f, quad), quad),
                                __fmul_rn(delta, __fsub_rn(abs_t, quad)));
    acc = __fadd_rn(acc, __fmul_rn(weights[b], per));
  }
  partial[threadIdx.x] = acc;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) partial[threadIdx.x] += partial[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) loss[0] = __fdiv_rn(partial[0], static_cast<float>(B));
}

__global__ void td_loss_bwd_kernel(const float* __restrict__ td,
                                   const int* __restrict__ action,
                                   const float* __restrict__ weights,
                                   const float* __restrict__ g,
                                   float* __restrict__ dq,
                                   int B, int A, float delta) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * A) return;
  const int b = i / A;
  const int a = i - b * A;
  const float clipped = fminf(fmaxf(td[b], -delta), delta);
  const float coeff =
      __fmul_rn(__fmul_rn(-clipped, weights[b]), __fdiv_rn(g[0], static_cast<float>(B)));
  dq[i] = (a == action[b]) ? coeff : 0.0f;
}

}  // namespace

extern "C" int td_loss_fwd(const void* q_s, const void* q_next_online,
                           const void* q_next_target, const void* action,
                           const void* reward, const void* bootstrap,
                           const void* weights, void* loss, void* td, int B,
                           int A, float delta, int dbl, void* stream) {
  if (B <= 0 || A <= 0) return static_cast<int>(cudaErrorInvalidValue);
  td_loss_fwd_kernel<<<1, kFwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q_s), static_cast<const float*>(q_next_online),
      static_cast<const float*>(q_next_target), static_cast<const int*>(action),
      static_cast<const float*>(reward), static_cast<const float*>(bootstrap),
      static_cast<const float*>(weights), static_cast<float*>(loss),
      static_cast<float*>(td), B, A, delta, dbl);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int td_loss_bwd(const void* td, const void* action, const void* weights,
                           const void* g, void* dq, int B, int A, float delta,
                           void* stream) {
  if (B <= 0 || A <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n = B * A;
  const int blocks = (n + kBwdThreads - 1) / kBwdThreads;
  td_loss_bwd_kernel<<<blocks, kBwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(td), static_cast<const int*>(action),
      static_cast<const float*>(weights), static_cast<const float*>(g),
      static_cast<float*>(dq), B, A, delta);
  return static_cast<int>(cudaGetLastError());
}
