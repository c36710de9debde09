// PER level-2 slot selection for Hopper: for each draw, the slot within the
// chosen env row, proportional to the row's priorities.
//
// Replaces the Pallas TPU kernel of deep_q_learning_tpu/ops/sample_kernels.py:
//   _slot_kernel (pl.pallas_call at sample_kernels.py:128, reached through
//   prioritized_sample_pallas) -> slot_warp_kernel (C <= 512) and
//   slot_block_kernel (C > 512)
//
// For each draw b of B, with priorities (N, C):
//   row   = priorities[env_idx[b]]      (no row if env_idx is outside [0, N))
//   draw  = u_slot[b] * sum(row)
//   slot  = #{c : inclusive_prefix(row)[c] < draw}, clamped to C - 1
// An all-zero (or absent) row gives draw 0 and slot 0.  The slot is a count,
// not a search, so it is the Pallas kernel's for any row, monotone or not.
//
// What bounds it on the card: latency, not bytes or operations.  A call
// needs the distinct rows its draws select (at most N*C*4 bytes) and 20
// bytes a draw: at the main path's shapes (N, C, B) = (1024, 512, 1024) the
// draws touch ~63 % of the rows, 1.3 MB, 0.4 us at 3.35 TB/s, and O(B*C)
// adds.  A launch costs about a microsecond whatever the work, so the design
// keeps each draw's chain of dependent steps short and the grid small:
//   * a team of threads sized to the row, not a block per draw.  Each thread
//     holds V contiguous values of the row in registers, V a multiple of 4
//     from 4 to 16, loaded as V/4 float4s that are all issued before any
//     arithmetic.  C <= 32*16: one warp per draw, eight draws per 256-thread
//     block, V = ceil(C / 32) rounded up to a multiple of 4 (C = 128: one
//     float4 a lane).  Larger C: V = 16 and a block of ceil(C / 16) threads
//     per draw, in whole warps, at most 1024;
//   * one pass over the row: each thread takes the inclusive prefix of its
//     values in registers; a warp scan of the thread totals with
//     __shfl_up_sync (5 steps in a fixed order) gives each thread its
//     offset, and its last value is the row total.  No shared memory in the
//     warp path.  The block path exchanges its warps' totals through shared
//     memory (one barrier) and every warp scans them in the same order;
//   * each thread counts its prefixes below the draw (lanes past C hold 0
//     and are masked out of the count); __reduce_add_sync adds the counts
//     of a warp (the block path adds its warps' counts through shared
//     memory, one more barrier) and one lane writes the slot.  Float sums in
//     a fixed order and integer counts, no atomics: a slot is bitwise the
//     same from run to run;
//   * rows that are not 16-byte aligned (C % 4 != 0, or a misaligned base)
//     take a scalar-load path, chosen by the launcher from C and the pointer;
//   * C > 1024*16 (no preset reaches it): the block walks the row in chunks
//     of 16384 values with a carry, twice, the first pass for the total.
//
// Plain C interface (no PyTorch headers), built by nvcc and loaded with
// ctypes (ops/build.py).  The launcher runs on the caller's stream,
// allocates nothing (it can be captured in a CUDA graph) and returns
// cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpSize = 32;
constexpr int kMaxValues = 16;  // values a thread holds: at most four float4s
constexpr int kWarpBlockThreads = 256;
constexpr int kDrawsPerWarpBlock = kWarpBlockThreads / kWarpSize;
constexpr int kMaxBlockThreads = 1024;

// How a call runs: threads per draw (32: the warp path), values a thread
// holds, float4 loads or not, and chunks of the row a block walks.
struct Plan {
  int threads;
  int values;
  int vec;
  int chunks;
};

Plan make_plan(int C, const void* priorities) {
  Plan plan;
  plan.vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(priorities) % 16 == 0;
  if (C <= kWarpSize * kMaxValues) {
    plan.threads = kWarpSize;
    plan.values = ((C + kWarpSize - 1) / kWarpSize + 3) / 4 * 4;
  } else {
    plan.values = kMaxValues;
    const int warps = ((C + kMaxValues - 1) / kMaxValues + kWarpSize - 1) / kWarpSize;
    const int most = kMaxBlockThreads / kWarpSize;
    plan.threads = (warps < most ? warps : most) * kWarpSize;
  }
  const int span = plan.threads * plan.values;
  plan.chunks = (C + span - 1) / span;
  return plan;
}

// Values c0 .. c0 + V - 1 of row e into x, 0 past C and for a row outside
// [0, N).  Every load is issued before any value is used.  kVec: float4
// loads; the row is 16-byte aligned and C % 4 == 0, so a float4 that starts
// below C ends below it.
template <int V, bool kVec>
__device__ __forceinline__ void load_row(const float* __restrict__ priorities, int64_t e, int N,
                                         int C, int c0, float (&x)[V]) {
  if (e < 0 || e >= N) {
#pragma unroll
    for (int i = 0; i < V; ++i) x[i] = 0.0f;
    return;
  }
  const float* row = priorities + e * C;
  if constexpr (kVec) {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const int c = c0 + 4 * k;
      const float4 v = c < C ? __ldg(reinterpret_cast<const float4*>(row + c))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      x[4 * k] = v.x;
      x[4 * k + 1] = v.y;
      x[4 * k + 2] = v.z;
      x[4 * k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) x[i] = c0 + i < C ? __ldg(row + c0 + i) : 0.0f;
  }
}

// x becomes its own inclusive prefix; x[V - 1] is the thread's total
template <int V>
__device__ __forceinline__ void local_prefix(float (&x)[V]) {
#pragma unroll
  for (int i = 1; i < V; ++i) x[i] = __fadd_rn(x[i - 1], x[i]);
}

// inclusive scan over the warp's lanes: __shfl_up_sync in 5 fixed steps
__device__ __forceinline__ float warp_scan(float v, int lane) {
#pragma unroll
  for (int off = 1; off < kWarpSize; off <<= 1) {
    const float up = __shfl_up_sync(kFullMask, v, off);
    if (lane >= off) v = __fadd_rn(up, v);
  }
  return v;
}

// the lane's exclusive offset from the warp's inclusive scan
__device__ __forceinline__ float exclusive_of(float inclusive, int lane) {
  const float up = __shfl_up_sync(kFullMask, inclusive, 1);
  return lane == 0 ? 0.0f : up;
}

// how many of the thread's prefixes (offset + x[i]) at columns below C lie
// below the draw
template <int V>
__device__ __forceinline__ unsigned count_below(const float (&x)[V], float offset, float draw,
                                                int c0, int C) {
  unsigned n = 0;
#pragma unroll
  for (int i = 0; i < V; ++i) n += (c0 + i < C && __fadd_rn(offset, x[i]) < draw) ? 1u : 0u;
  return n;
}

template <int V, bool kVec>
__global__ void __launch_bounds__(kWarpBlockThreads)
slot_warp_kernel(const float* __restrict__ priorities, const int64_t* __restrict__ env_idx,
                 const float* __restrict__ u_slot, int64_t* __restrict__ slot_idx, int N,
                 int C, int B) {
  const int b = blockIdx.x * kDrawsPerWarpBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp: it holds one draw
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int64_t e = env_idx[b];
  const float u = u_slot[b];
  const int c0 = lane * V;
  float x[V];
  load_row<V, kVec>(priorities, e, N, C, c0, x);
  local_prefix(x);
  const float inclusive = warp_scan(x[V - 1], lane);
  const float draw = __fmul_rn(u, __shfl_sync(kFullMask, inclusive, kWarpSize - 1));
  const unsigned n = __reduce_add_sync(
      kFullMask, count_below(x, exclusive_of(inclusive, lane), draw, c0, C));
  if (lane == 0) slot_idx[b] = min(n, static_cast<unsigned>(C - 1));
}

// The thread's exclusive offset within the block's chunk, from its total;
// chunk_total is the chunk's sum.  A warp scan, the warps' totals through
// shared memory (one barrier), and a scan of those, the same in every warp.
__device__ __forceinline__ float block_scan(float thread_total, int lane, int warp, int warps,
                                            float* warp_totals, float& chunk_total) {
  const float inclusive = warp_scan(thread_total, lane);
  if (lane == kWarpSize - 1) warp_totals[warp] = inclusive;
  __syncthreads();
  const float over_warps = warp_scan(lane < warps ? warp_totals[lane] : 0.0f, lane);
  chunk_total = __shfl_sync(kFullMask, over_warps, warps - 1);
  const float warp_offset = __shfl_sync(kFullMask, over_warps, warp > 0 ? warp - 1 : 0);
  const float lane_offset = exclusive_of(inclusive, lane);
  return warp > 0 ? __fadd_rn(warp_offset, lane_offset) : lane_offset;
}

template <bool kVec>
__global__ void __launch_bounds__(kMaxBlockThreads)
slot_block_kernel(const float* __restrict__ priorities, const int64_t* __restrict__ env_idx,
                  const float* __restrict__ u_slot, int64_t* __restrict__ slot_idx, int N,
                  int C) {
  constexpr int V = kMaxValues;
  __shared__ float warp_totals[kWarpSize];
  __shared__ unsigned warp_counts[kWarpSize];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int64_t e = env_idx[b];
  const float u = u_slot[b];
  const int span = blockDim.x * V;
  const int chunks = (C + span - 1) / span;
  float x[V];
  float chunk_total;

  float total = 0.0f;
  if (chunks > 1) {  // the row does not fit the block's registers: a pass for the total
    for (int k = 0; k < chunks; ++k) {
      load_row<V, kVec>(priorities, e, N, C, k * span + threadIdx.x * V, x);
      local_prefix(x);
      block_scan(x[V - 1], lane, warp, warps, warp_totals, chunk_total);
      total = __fadd_rn(total, chunk_total);
      __syncthreads();  // before warp_totals is written again
    }
  }
  float carry = 0.0f;  // the sum of the chunks before this one
  unsigned n = 0;
  for (int k = 0; k < chunks; ++k) {
    const int c0 = k * span + threadIdx.x * V;
    load_row<V, kVec>(priorities, e, N, C, c0, x);
    local_prefix(x);
    const float offset = block_scan(x[V - 1], lane, warp, warps, warp_totals, chunk_total);
    if (chunks == 1) total = chunk_total;
    n += count_below(x, __fadd_rn(carry, offset), __fmul_rn(u, total), c0, C);
    carry = __fadd_rn(carry, chunk_total);
    if (k + 1 < chunks) __syncthreads();
  }
  n = __reduce_add_sync(kFullMask, n);
  if (lane == 0) warp_counts[warp] = n;
  __syncthreads();
  if (warp == 0) {
    n = __reduce_add_sync(kFullMask, lane < warps ? warp_counts[lane] : 0u);
    if (lane == 0) slot_idx[b] = min(n, static_cast<unsigned>(C - 1));
  }
}

template <int V>
void launch_warp(int vec, int blocks, cudaStream_t stream, const float* p, const int64_t* e,
                 const float* u, int64_t* out, int N, int C, int B) {
  if (vec) {
    slot_warp_kernel<V, true><<<blocks, kWarpBlockThreads, 0, stream>>>(p, e, u, out, N, C, B);
  } else {
    slot_warp_kernel<V, false><<<blocks, kWarpBlockThreads, 0, stream>>>(p, e, u, out, N, C, B);
  }
}

}  // namespace

// The plan a call with C columns on this priorities pointer runs:
// plan[0..3] = threads per draw, values a thread, float4 loads (0/1), chunks.
extern "C" int per_slot_sample_plan(int C, const void* priorities, int* plan) {
  if (C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(C, priorities);
  plan[0] = p.threads;
  plan[1] = p.values;
  plan[2] = p.vec;
  plan[3] = p.chunks;
  return 0;
}

extern "C" int per_slot_sample(const void* priorities, const void* env_idx,
                               const void* u_slot, void* slot_idx, int N, int C,
                               int B, void* stream) {
  if (N <= 0 || C <= 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = make_plan(C, priorities);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto p = static_cast<const float*>(priorities);
  const auto e = static_cast<const int64_t*>(env_idx);
  const auto u = static_cast<const float*>(u_slot);
  const auto out = static_cast<int64_t*>(slot_idx);
  if (plan.threads == kWarpSize) {
    const int blocks = (B + kDrawsPerWarpBlock - 1) / kDrawsPerWarpBlock;
    switch (plan.values) {
      case 4: launch_warp<4>(plan.vec, blocks, s, p, e, u, out, N, C, B); break;
      case 8: launch_warp<8>(plan.vec, blocks, s, p, e, u, out, N, C, B); break;
      case 12: launch_warp<12>(plan.vec, blocks, s, p, e, u, out, N, C, B); break;
      default: launch_warp<16>(plan.vec, blocks, s, p, e, u, out, N, C, B); break;
    }
  } else if (plan.vec) {
    slot_block_kernel<true><<<B, plan.threads, 0, s>>>(p, e, u, out, N, C);
  } else {
    slot_block_kernel<false><<<B, plan.threads, 0, s>>>(p, e, u, out, N, C);
  }
  return static_cast<int>(cudaGetLastError());
}
