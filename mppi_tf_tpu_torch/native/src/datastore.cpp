// Native transition datastore for the replay buffer.
//
// A copy of the JAX package's mppi_tf_tpu/native/src/datastore.cpp (the
// port builds its own, learning/datastore.py). Counterpart of the
// reference's C++ DataBase (include/data_base.hpp, src/data_base.cpp): an
// append-only transition store (x, u, x_next) with CSV export for offline
// training. The reference kept one tensorflow::Tensor per transition in
// std::vectors (data_base.hpp:14-31); here storage is three contiguous
// ring buffers so (a) appends are O(1) memcpy with zero allocation after
// construction, (b) the full dataset exports to Python as flat float64
// arrays, and (c) capacity is bounded for long closed-loop runs (the
// reference grew without bound).
//
// Exposed as a C ABI for ctypes (no pybind11 in this toolchain).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

struct DataStore {
  int64_t capacity;
  int64_t sdim;
  int64_t adim;
  int64_t head;   // next write slot
  int64_t size;   // number of valid transitions (<= capacity)
  std::vector<double> obs;       // [capacity, sdim]
  std::vector<double> act;       // [capacity, adim]
  std::vector<double> next_obs;  // [capacity, sdim]
  std::mutex mu;

  DataStore(int64_t cap, int64_t s, int64_t a)
      : capacity(cap), sdim(s), adim(a), head(0), size(0),
        obs(static_cast<size_t>(cap * s)),
        act(static_cast<size_t>(cap * a)),
        next_obs(static_cast<size_t>(cap * s)) {}
};

}  // namespace

extern "C" {

void* ds_create(int64_t capacity, int64_t sdim, int64_t adim) {
  if (capacity <= 0 || sdim <= 0 || adim <= 0) return nullptr;
  return new DataStore(capacity, sdim, adim);
}

void ds_destroy(void* handle) { delete static_cast<DataStore*>(handle); }

int64_t ds_size(void* handle) {
  auto* ds = static_cast<DataStore*>(handle);
  std::lock_guard<std::mutex> lock(ds->mu);
  return ds->size;
}

int64_t ds_capacity(void* handle) {
  return static_cast<DataStore*>(handle)->capacity;
}

// Append one transition (reference data_base.cpp:14-31 addX/addU/addNext,
// fused into one call since the trio always travels together).
void ds_add(void* handle, const double* x, const double* u,
            const double* x_next) {
  auto* ds = static_cast<DataStore*>(handle);
  std::lock_guard<std::mutex> lock(ds->mu);
  const int64_t i = ds->head;
  std::memcpy(&ds->obs[i * ds->sdim], x, sizeof(double) * ds->sdim);
  std::memcpy(&ds->act[i * ds->adim], u, sizeof(double) * ds->adim);
  std::memcpy(&ds->next_obs[i * ds->sdim], x_next, sizeof(double) * ds->sdim);
  ds->head = (i + 1) % ds->capacity;
  ds->size = std::min(ds->size + 1, ds->capacity);
}

// Copy up to max_rows transitions, oldest first, into caller-provided
// buffers of shapes [max_rows, sdim], [max_rows, adim], [max_rows, sdim];
// returns the number of rows actually written. The bound is part of the
// ABI: a size-then-copy two-call sequence raced concurrent ds_add —
// the store could grow between the size read and the copy, overflowing
// the caller's buffers (review finding, reproduced as a segfault).
int64_t ds_get_all(void* handle, double* obs_out, double* act_out,
                   double* next_out, int64_t max_rows) {
  auto* ds = static_cast<DataStore*>(handle);
  std::lock_guard<std::mutex> lock(ds->mu);
  const int64_t n = std::min(ds->size, max_rows);
  const int64_t start = (ds->size == ds->capacity) ? ds->head : 0;
  for (int64_t j = 0; j < n; ++j) {
    const int64_t i = (start + j) % ds->capacity;
    std::memcpy(&obs_out[j * ds->sdim], &ds->obs[i * ds->sdim],
                sizeof(double) * ds->sdim);
    std::memcpy(&act_out[j * ds->adim], &ds->act[i * ds->adim],
                sizeof(double) * ds->adim);
    std::memcpy(&next_out[j * ds->sdim], &ds->next_obs[i * ds->sdim],
                sizeof(double) * ds->sdim);
  }
  return n;
}

// CSV export, one transition per row: x..., u..., x_next...
// (reference data_base.cpp:52-71 toCSV).
int ds_to_csv(void* handle, const char* path) {
  auto* ds = static_cast<DataStore*>(handle);
  std::lock_guard<std::mutex> lock(ds->mu);
  FILE* f = std::fopen(path, "w");
  if (!f) return -1;
  for (int64_t d = 0; d < ds->sdim; ++d) std::fprintf(f, "x%lld,", (long long)d);
  for (int64_t d = 0; d < ds->adim; ++d) std::fprintf(f, "u%lld,", (long long)d);
  for (int64_t d = 0; d < ds->sdim; ++d)
    std::fprintf(f, "x_next%lld%s", (long long)d,
                 d + 1 == ds->sdim ? "" : ",");
  std::fprintf(f, "\n");
  const int64_t n = ds->size;
  const int64_t start = (ds->size == ds->capacity) ? ds->head : 0;
  for (int64_t j = 0; j < n; ++j) {
    const int64_t i = (start + j) % ds->capacity;
    for (int64_t d = 0; d < ds->sdim; ++d)
      std::fprintf(f, "%.17g,", ds->obs[i * ds->sdim + d]);
    for (int64_t d = 0; d < ds->adim; ++d)
      std::fprintf(f, "%.17g,", ds->act[i * ds->adim + d]);
    for (int64_t d = 0; d < ds->sdim; ++d)
      std::fprintf(f, "%.17g%s", ds->next_obs[i * ds->sdim + d],
                   d + 1 == ds->sdim ? "" : ",");
    std::fprintf(f, "\n");
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
