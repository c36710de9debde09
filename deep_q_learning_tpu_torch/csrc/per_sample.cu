// PER level-2 slot selection for Hopper: for each draw, the slot within the
// chosen env row, proportional to the row's priorities.
//
// Replaces the Pallas TPU kernel of deep_q_learning_tpu/ops/sample_kernels.py:
//   _slot_kernel (pl.pallas_call at sample_kernels.py:128) -> per_slot_sample_kernel
//
// For each draw b of B, with priorities (N, C):
//   row   = priorities[env_idx[b]]      (no row if env_idx is outside [0, N))
//   draw  = u_slot[b] * sum(row)
//   slot  = #{c : inclusive_prefix(row)[c] < draw}, clamped to C - 1
// An all-zero (or absent) row gives draw 0 and slot 0.
//
// The Pallas kernel gathers rows with a one-hot matmul and builds prefix
// sums from 128x128 triangular matmuls, because Mosaic has no cumsum and no
// dynamic row load.  Neither constraint holds here, so the design is the
// direct one:
//   * one block per draw; it reads its row straight from device memory;
//   * thread t owns the contiguous chunk [t*k, (t+1)*k) of the row, k =
//     ceil(C / threads), and sums it;
//   * a Hillis-Steele scan of the chunk sums in shared memory gives the row
//     total and each chunk's offset.  Its order is fixed, with no atomics,
//     so a slot is bitwise the same from run to run;
//   * each thread walks its chunk again from its offset and counts the
//     prefixes below the draw; a shared-memory tree adds the counts.
// What bounds it on the card: latency, not bytes.  A call needs the distinct
// rows its draws select (at most N*C*4 bytes) and 20 bytes a draw: at the
// main path's shapes (N, C, B) = (1024, 512, 1024) the draws touch ~63 % of
// the rows, 1.3 MB, 0.4 us at 3.35 TB/s, and O(B*C) adds.  The time goes to
// the chain inside a block: two passes over the row, a 256-wide scan with
// 16 barriers and a tree with 8 more.
//
// Plain C interface (no PyTorch headers), built by nvcc and loaded with
// ctypes (ops/build.py).  The launcher returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // power of two: the scan and the tree rely on it

__global__ void per_slot_sample_kernel(const float* __restrict__ priorities,
                                       const int64_t* __restrict__ env_idx,
                                       const float* __restrict__ u_slot,
                                       int64_t* __restrict__ slot_idx,
                                       int N, int C) {
  __shared__ float scan[kThreads];
  __shared__ int counts[kThreads];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int64_t e = env_idx[b];
  const bool has_row = e >= 0 && e < N;
  const float* row = priorities + (has_row ? static_cast<size_t>(e) * C : 0);
  const int chunk = (C + kThreads - 1) / kThreads;
  const int lo = min(t * chunk, C);
  const int hi = has_row ? min(lo + chunk, C) : lo;

  float chunk_sum = 0.0f;
  for (int c = lo; c < hi; ++c) chunk_sum += row[c];
  scan[t] = chunk_sum;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {  // inclusive scan
    const float add = t >= off ? scan[t - off] : 0.0f;
    __syncthreads();
    scan[t] += add;
    __syncthreads();
  }
  const float draw = u_slot[b] * scan[kThreads - 1];

  float prefix = t > 0 ? scan[t - 1] : 0.0f;
  int count = 0;
  for (int c = lo; c < hi; ++c) {
    prefix += row[c];
    count += prefix < draw;
  }
  counts[t] = count;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) counts[t] += counts[t + s];
    __syncthreads();
  }
  if (t == 0) slot_idx[b] = min(counts[0], C - 1);
}

}  // namespace

extern "C" int per_slot_sample(const void* priorities, const void* env_idx,
                               const void* u_slot, void* slot_idx, int N, int C,
                               int B, void* stream) {
  if (N <= 0 || C <= 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  per_slot_sample_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(priorities), static_cast<const int64_t*>(env_idx),
      static_cast<const float*>(u_slot), static_cast<int64_t*>(slot_idx), N, C);
  return static_cast<int>(cudaGetLastError());
}
