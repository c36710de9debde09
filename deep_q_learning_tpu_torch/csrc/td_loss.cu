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
// What bounds it on the card: launch latency, not bytes.  The forward moves
// 12*B*A + 20*B + 4 bytes (17 KB at B = 256, A = 4: 5 ns at 3.35 TB/s) and
// the backward 12*B + 4 + 4*R*A for R output rows; a launch on this card
// costs about a microsecond whatever the work.  So the design keeps the
// critical path of one launch short:
//   * one thread per row, ceil(B / 256) blocks: no thread walks rows one
//     after another;
//   * every load of a row is issued before any of them is used.  For
//     A == 4 with 16-byte-aligned rows (the wrapper checks) each Q row is
//     one float4; otherwise a scalar loop over the actions.  The bootstrap
//     and the taken action's value are selected in registers from the
//     loaded rows, never loaded through an index read first;
//   * the loss: warp shuffles in a fixed lane order, then the same over the
//     block's warps.  With one block, thread 0 writes the loss.  With
//     several, each block writes its partial to a scratch array and takes
//     an integer ticket (one atomic with acquire-release order, no full
//     fence); the last block's first warp adds the partials, lane i those
//     at i, i + 32, ..., then a shuffle tree, writes the loss and sets the
//     ticket counter back to 0 for the next launch.  Float sums keep an
//     order fixed by the grid, so the loss is bitwise the same from run to
//     run; the only atomic is the integer ticket.  The
//     scratch and the counter are the wrapper's, one pair per device, so
//     launches that share them run in stream order;
//   * the backward: one thread per output row reads td, w, action and g
//     once and writes its whole row (one float4 when A == 4).  It writes
//     the gradient of the learner's q_both = Q([s; s']) of 2B rows, whose
//     rows past B are zero (the s' half is stopped), so autograd needs no
//     slice backward (a zero fill and a copy) after it.
// Products and sums that feed td and the loss use the _rn intrinsics so that
// nvcc does not contract them into FMAs: td then rounds as the plain PyTorch
// version (ops/td_kernels.py::td_loss_reference) does.
//
// Plain C interface (no PyTorch headers), built by nvcc and loaded with
// ctypes (ops/build.py).  Each launcher returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

// One action's values of a row, taken in action order: the running argmax of
// Q_online(s', .) carries Q_target(s', .) at it (strict >: the first maximum
// wins), or the running max of Q_target(s', .); and Q(s, act).
__device__ __forceinline__ void take_action(int a, float s, float no, float nt, int act,
                                            int dbl, float& m, float& boot, float& q_taken) {
  if (a == 0) {
    m = no;
    boot = nt;
  } else if (dbl) {
    if (no > m) {
      m = no;
      boot = nt;
    }
  } else {
    boot = nt > boot ? nt : boot;
  }
  if (a == act) q_taken = s;
}

// sum over the warp's lanes, in a fixed tree; lane 0 holds the result
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(kFullMask, v, off));
  return v;
}

// atomicAdd with acquire-release order at device scope: the caller's earlier
// writes are visible to whoever reads the new count, and its later reads see
// what the earlier ticket holders wrote
__device__ __forceinline__ unsigned int fetch_add_acq_rel(unsigned int* p, unsigned int v) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.add.u32 %0, [%1], %2;" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__global__ void __launch_bounds__(kThreads)
td_loss_fwd_kernel(const float* __restrict__ q_s, const float* __restrict__ q_next_online,
                   const float* __restrict__ q_next_target, const int* __restrict__ action,
                   const float* __restrict__ reward, const float* __restrict__ bootstrap,
                   const float* __restrict__ weights, float* __restrict__ loss,
                   float* __restrict__ td, float* __restrict__ partials,
                   unsigned int* __restrict__ ticket, int B, int A, float delta, int dbl,
                   int vec4) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  float contrib = 0.0f;
  if (b < B) {
    const int act = action[b];
    const float g_ret = reward[b];
    const float boot_factor = bootstrap[b];
    const float w = weights[b];
    float m = 0.0f, boot = 0.0f;
    float q_taken = 0.0f;  // an action outside [0, A) selects 0, as the one-hot gather
    if (vec4) {
      const float4 s = reinterpret_cast<const float4*>(q_s)[b];
      const float4 no = reinterpret_cast<const float4*>(q_next_online)[b];
      const float4 nt = reinterpret_cast<const float4*>(q_next_target)[b];
      take_action(0, s.x, no.x, nt.x, act, dbl, m, boot, q_taken);
      take_action(1, s.y, no.y, nt.y, act, dbl, m, boot, q_taken);
      take_action(2, s.z, no.z, nt.z, act, dbl, m, boot, q_taken);
      take_action(3, s.w, no.w, nt.w, act, dbl, m, boot, q_taken);
    } else {
      const size_t row = static_cast<size_t>(b) * A;
#pragma unroll 4
      for (int a = 0; a < A; ++a) {
        take_action(a, q_s[row + a], q_next_online[row + a], q_next_target[row + a], act,
                    dbl, m, boot, q_taken);
      }
    }
    const float y = __fadd_rn(g_ret, __fmul_rn(boot_factor, boot));
    const float t = __fsub_rn(y, q_taken);
    td[b] = t;
    const float abs_t = fabsf(t);
    const float quad = fminf(abs_t, delta);
    const float per = __fadd_rn(__fmul_rn(__fmul_rn(0.5f, quad), quad),
                                __fmul_rn(delta, __fsub_rn(abs_t, quad)));
    contrib = __fmul_rn(w, per);
  }

  // the block's sum: a fixed shuffle tree over the lanes, then over the warps
  const int lane = threadIdx.x & 31;
  contrib = warp_sum(contrib);
  __shared__ float warp_sums[kWarps];
  if (lane == 0) warp_sums[threadIdx.x >> 5] = contrib;
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const float partial = warp_sum(lane < kWarps ? warp_sums[lane] : 0.0f);
  const float count = static_cast<float>(B);
  if (gridDim.x == 1) {
    if (lane == 0) loss[0] = __fdiv_rn(partial, count);
    return;
  }
  // several blocks: publish the partial, take a ticket; the last block sums
  unsigned int last = 0;
  if (lane == 0) {
    partials[blockIdx.x] = partial;
    last = fetch_add_acq_rel(ticket, 1u) == gridDim.x - 1;  // release: the partial first
  }
  if (!__shfl_sync(kFullMask, last, 0)) return;
  __syncwarp();
  // lane i adds partials i, i + 32, ... in order, then the fixed tree: the
  // order depends on the grid alone
  float sum = 0.0f;
  for (unsigned i = lane; i < gridDim.x; i += 32) sum = __fadd_rn(sum, __ldcg(partials + i));
  sum = warp_sum(sum);
  if (lane == 0) {
    loss[0] = __fdiv_rn(sum, count);
    *ticket = 0u;
  }
}

__global__ void __launch_bounds__(kThreads)
td_loss_bwd_kernel(const float* __restrict__ td, const int* __restrict__ action,
                   const float* __restrict__ weights, const float* __restrict__ g,
                   float* __restrict__ dq, int B, int A, int rows, float delta, int vec4) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  float coeff = 0.0f;
  int act = -1;  // rows past B (the stopped s' half) are zero
  if (r < B) {
    act = action[r];
    const float t = td[r];
    const float w = weights[r];
    const float g_loss = g[0];
    const float clipped = fminf(fmaxf(t, -delta), delta);
    coeff = __fmul_rn(__fmul_rn(-clipped, w), __fdiv_rn(g_loss, static_cast<float>(B)));
  }
  if (vec4) {
    float4 out;
    out.x = act == 0 ? coeff : 0.0f;
    out.y = act == 1 ? coeff : 0.0f;
    out.z = act == 2 ? coeff : 0.0f;
    out.w = act == 3 ? coeff : 0.0f;
    reinterpret_cast<float4*>(dq)[r] = out;
  } else {
    float* row = dq + static_cast<size_t>(r) * A;
    for (int a = 0; a < A; ++a) row[a] = a == act ? coeff : 0.0f;
  }
}

}  // namespace

// partials holds n_partials floats; the forward needs one per block.
extern "C" int td_loss_fwd(const void* q_s, const void* q_next_online,
                           const void* q_next_target, const void* action,
                           const void* reward, const void* bootstrap,
                           const void* weights, void* loss, void* td, void* partials,
                           int n_partials, void* ticket, int B, int A, float delta,
                           int dbl, int vec4, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  if (B <= 0 || A <= 0 || (vec4 && A != 4) || (blocks > 1 && n_partials < blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  td_loss_fwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q_s), static_cast<const float*>(q_next_online),
      static_cast<const float*>(q_next_target), static_cast<const int*>(action),
      static_cast<const float*>(reward), static_cast<const float*>(bootstrap),
      static_cast<const float*>(weights), static_cast<float*>(loss),
      static_cast<float*>(td), static_cast<float*>(partials),
      static_cast<unsigned int*>(ticket), B, A, delta, dbl, vec4);
  return static_cast<int>(cudaGetLastError());
}

// dq has rows >= B rows of A floats; rows past B are written as zeros.
extern "C" int td_loss_bwd(const void* td, const void* action, const void* weights,
                           const void* g, void* dq, int B, int A, int rows, float delta,
                           int vec4, void* stream) {
  if (B <= 0 || A <= 0 || rows < B || (vec4 && A != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (rows + kThreads - 1) / kThreads;
  td_loss_bwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(td), static_cast<const int*>(action),
      static_cast<const float*>(weights), static_cast<const float*>(g),
      static_cast<float*>(dq), B, A, rows, delta, vec4);
  return static_cast<int>(cudaGetLastError());
}

// rows of the forward per block, so the wrapper sizes the scratch array
extern "C" int td_loss_fwd_rows_per_block() { return kThreads; }
