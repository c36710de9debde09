// Host-side replay ring buffer + uniform sampler (C API for ctypes).
//
// The port's own copy of deep_q_learning_tpu/native/replay_buffer.cc, with
// the same extern "C" interface and the same std::mt19937_64 stream seeded
// by rb_create, so that one seed and one sequence of adds give the same
// samples in both packages.  A preallocated circular buffer of
// (s, a, r, s', done) with overwrite-oldest writes and uniform
// with-replacement batch sampling, the native analog of the reference's
// host buffer + numba-jitted sampler.  Used by the host-compat training
// path (deep_q_learning_tpu_torch/compat/host_loop.py) that drives
// arbitrary stateful Python/Gym environments; the device path keeps its
// replay in device memory instead (deep_q_learning_tpu_torch/replay/).
//
// Built at first use by deep_q_learning_tpu_torch/native/__init__.py:
// g++ -O3 -shared -fPIC -std=c++17, into build/torch_native/.

#include <cstdint>
#include <cstring>
#include <random>

namespace {

struct Buffer {
  int64_t capacity;
  int64_t obs_dim;
  int64_t cursor;      // next write slot
  int64_t num_samples; // min(total_adds, capacity)
  float* obs;          // capacity x obs_dim
  float* next_obs;     // capacity x obs_dim
  int32_t* action;     // capacity
  float* reward;       // capacity
  uint8_t* done;       // capacity
  std::mt19937_64 rng;
};

} // namespace

extern "C" {

void* rb_create(int64_t capacity, int64_t obs_dim, uint64_t seed) {
  Buffer* b = new Buffer();
  b->capacity = capacity;
  b->obs_dim = obs_dim;
  b->cursor = 0;
  b->num_samples = 0;
  b->obs = new float[capacity * obs_dim]();
  b->next_obs = new float[capacity * obs_dim]();
  b->action = new int32_t[capacity]();
  b->reward = new float[capacity]();
  b->done = new uint8_t[capacity]();
  b->rng.seed(seed);
  return b;
}

void rb_destroy(void* handle) {
  Buffer* b = static_cast<Buffer*>(handle);
  delete[] b->obs;
  delete[] b->next_obs;
  delete[] b->action;
  delete[] b->reward;
  delete[] b->done;
  delete b;
}

int64_t rb_size(void* handle) {
  return static_cast<Buffer*>(handle)->num_samples;
}

int64_t rb_capacity(void* handle) {
  return static_cast<Buffer*>(handle)->capacity;
}

// Overwrite-oldest add (ref replay_buffer.py:35-43).
void rb_add(void* handle, const float* obs, int32_t action, float reward,
            const float* next_obs, uint8_t done) {
  Buffer* b = static_cast<Buffer*>(handle);
  const int64_t i = b->cursor;
  std::memcpy(b->obs + i * b->obs_dim, obs, sizeof(float) * b->obs_dim);
  std::memcpy(b->next_obs + i * b->obs_dim, next_obs,
              sizeof(float) * b->obs_dim);
  b->action[i] = action;
  b->reward[i] = reward;
  b->done[i] = done;
  b->cursor = (b->cursor + 1) % b->capacity;
  if (b->num_samples < b->capacity) b->num_samples++;
}

// Bulk add of n transitions (vectorized envs / batched host steps).
void rb_add_batch(void* handle, int64_t n, const float* obs,
                  const int32_t* action, const float* reward,
                  const float* next_obs, const uint8_t* done) {
  Buffer* b = static_cast<Buffer*>(handle);
  for (int64_t k = 0; k < n; ++k) {
    rb_add(handle, obs + k * b->obs_dim, action[k], reward[k],
           next_obs + k * b->obs_dim, done[k]);
  }
}

// Uniform with-replacement batch sample (ref replay_buffer.py:68-85):
// gathers into caller-provided output arrays.
void rb_sample(void* handle, int64_t batch_size, float* out_obs,
               int32_t* out_action, float* out_reward, float* out_next_obs,
               uint8_t* out_done) {
  Buffer* b = static_cast<Buffer*>(handle);
  const int64_t n = b->num_samples > 0 ? b->num_samples : 1;
  std::uniform_int_distribution<int64_t> dist(0, n - 1);
  for (int64_t k = 0; k < batch_size; ++k) {
    const int64_t i = dist(b->rng);
    std::memcpy(out_obs + k * b->obs_dim, b->obs + i * b->obs_dim,
                sizeof(float) * b->obs_dim);
    std::memcpy(out_next_obs + k * b->obs_dim, b->next_obs + i * b->obs_dim,
                sizeof(float) * b->obs_dim);
    out_action[k] = b->action[i];
    out_reward[k] = b->reward[i];
    out_done[k] = b->done[i];
  }
}

} // extern "C"
