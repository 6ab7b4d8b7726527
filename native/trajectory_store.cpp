// Chunked host-side trajectory store for streaming particle history.
//
// Native equivalent of the reference driver's history buffers: run.rcpp.cpp
// (/root/reference/src/run.rcpp.cpp:80-97) materializes the FULL
// timeSteps x N x d posterior in per-step Eigen heap vectors. On the device the
// filter streams history out of HBM in chunks of K steps; this store
// appends those chunks into one preallocated, page-aligned host arena
// (no per-step allocation, no Python-loop copies) and hands back a
// contiguous row-major view.
//
// C ABI (ctypes, see cusmc_tpu/io/native_store.py):
//   h = csmc_store_create(step_bytes, max_steps)   -> opaque handle (0 on fail)
//   csmc_store_append(h, data, n_steps)            -> 0 ok
//   csmc_store_size(h)                             -> steps appended
//   csmc_store_data(h)                             -> pointer to arena
//   csmc_store_destroy(h)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>

namespace {

struct Store {
  char* data = nullptr;
  int64_t step_bytes = 0;
  int64_t max_steps = 0;
  int64_t size = 0;  // steps appended
};

}  // namespace

extern "C" {

void* csmc_store_create(int64_t step_bytes, int64_t max_steps) {
  if (step_bytes <= 0 || max_steps <= 0) return nullptr;
  Store* s = new (std::nothrow) Store;
  if (!s) return nullptr;
  // 64-byte alignment: full-cacheline memcpy on append and clean numpy views.
  void* arena = nullptr;
  if (posix_memalign(&arena, 64,
                     static_cast<size_t>(step_bytes * max_steps)) != 0) {
    delete s;
    return nullptr;
  }
  s->data = static_cast<char*>(arena);
  s->step_bytes = step_bytes;
  s->max_steps = max_steps;
  return s;
}

int csmc_store_append(void* handle, const void* data, int64_t n_steps) {
  Store* s = static_cast<Store*>(handle);
  if (!s || n_steps < 0 || s->size + n_steps > s->max_steps) return 1;
  std::memcpy(s->data + s->size * s->step_bytes, data,
              static_cast<size_t>(n_steps * s->step_bytes));
  s->size += n_steps;
  return 0;
}

int64_t csmc_store_size(void* handle) {
  Store* s = static_cast<Store*>(handle);
  return s ? s->size : -1;
}

void* csmc_store_data(void* handle) {
  Store* s = static_cast<Store*>(handle);
  return s ? s->data : nullptr;
}

void csmc_store_destroy(void* handle) {
  Store* s = static_cast<Store*>(handle);
  if (!s) return;
  std::free(s->data);
  delete s;
}

}  // extern "C"
