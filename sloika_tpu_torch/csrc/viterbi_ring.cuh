// The Viterbi kernels' posterior ring (csrc/viterbi_fwd.cu, and the probe
// csrc/viterbi_parts.cu built on its single route): a frame's row comes into
// a shared-memory slot by one thread's bulk copy of its 16-byte-aligned
// superset, completing on the slot's mbarrier, and its readers find it at
// the row's offset into the superset.  A superset that would run past the
// end of the tensor's storage (its last rows) is not copied: its readers
// take that row from device memory.  A row's elements E are float or
// __nv_bfloat16 (a bf16 posterior streams at half the bytes, and a row's
// offset into its superset moves in 2-byte steps); a reader upcasts each
// element to f32 (upcast) before any arithmetic.
#pragma once
#include <cuda_bf16.h>

#include "bulk_copy.cuh"

namespace {

constexpr float kEta = 1e-10f;

// a posterior element in f32
__device__ __forceinline__ float upcast(float v) { return v; }
__device__ __forceinline__ float upcast(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// whether the aligned superset of the n elements at `row` ends within the
// storage that ends at `end` (then fill copies it)
template <typename E>
__device__ __forceinline__ bool in_storage(const E* row, int n,
                                           unsigned long long end) {
  const unsigned long long a = (unsigned long long)row;
  return ((a + sizeof(E) * n + 15ull) & ~15ull) <= end;
}

// One thread: copy the aligned superset of the n elements at `row` into a
// ring slot, on the slot's barrier (one arrival that expects the copy's
// bytes); a superset past `end` is not copied, and arrives with no bytes.
template <typename E>
__device__ __forceinline__ void fill(const E* row, int n,
                                     unsigned long long end, void* slot,
                                     uint64_t* bar) {
  const unsigned long long a = (unsigned long long)row;
  const unsigned long long a0 = a & ~15ull;
  const unsigned long long e = (a + sizeof(E) * n + 15ull) & ~15ull;
  if (e <= end) {
    mbar_expect_tx(bar, (unsigned)(e - a0));
    bulk_copy(slot, reinterpret_cast<const void*>(a0), (unsigned)(e - a0),
              bar);
  } else {
    mbar_expect_tx(bar, 0u);
  }
}

// the offset, in elements, of `row` into its aligned superset
template <typename E>
__device__ __forceinline__ int superset_offset(const E* row) {
  return (int)(((uintptr_t)row & 15) / sizeof(E));
}

}  // namespace
