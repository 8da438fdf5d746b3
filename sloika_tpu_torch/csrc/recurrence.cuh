// Device helpers shared by the recurrence kernels (gru_fwd.cu, gru_bwd.cu,
// lstm_fwd.cu, lstm_bwd.cu): the accurate sigmoid, the cp.async copies of
// their step rings (lstm_fwd.cu's ring takes the bulk copies of
// bulk_copy.cuh instead), and the blocked dot products that keep 4 / BR
// partial sums a row in flight and join them in a fixed order (the same
// bits on every run).  Each kernel is its own library with a plain C
// interface; this header only saves them repeating these.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

// the accurate expf, as PyTorch's own CUDA sigmoid uses (no fast-math)
__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (0-3) of this thread's groups are pending; the
// barrier after it publishes what landed to the block
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// start the block's copies of len floats, 16 bytes a copy when vec (len a
// multiple of 4 and both ends 16-byte aligned); the caller commits
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int len, int vec) {
  if (vec) {
    for (int i = threadIdx.x; i < len / 4; i += blockDim.x)
      cp_async16(dst + 4 * i, src + 4 * i);
  } else {
    for (int i = threadIdx.x; i < len; i += blockDim.x)
      cp_async4(dst + i, src + i);
  }
}

// partial sums a row keeps, so that BR * NP >= 4 chains are in flight
template <int BR>
struct Parts {
  static constexpr int NP = BR >= 4 ? 1 : 4 / BR;
};

// acc[r] += v[r] * w over the block's rows; v points into shared memory
template <int BR>
__device__ __forceinline__ void fma_rows(float (&acc)[BR], const float* v,
                                         float w) {
  if constexpr (BR % 4 == 0) {
#pragma unroll
    for (int i = 0; i < BR; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(v + i);
      acc[i] = fmaf(a.x, w, acc[i]);
      acc[i + 1] = fmaf(a.y, w, acc[i + 1]);
      acc[i + 2] = fmaf(a.z, w, acc[i + 2]);
      acc[i + 3] = fmaf(a.w, w, acc[i + 3]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < BR; ++r) acc[r] = fmaf(v[r], w, acc[r]);
  }
}

// NP consecutive k of an operand block [NP][BR] into NP partial sums; at
// BR = 1, 2 the NP * BR values are one 16-byte load
template <int BR, int NP>
__device__ __forceinline__ void fma_block(float (&acc)[NP][BR],
                                          const float* v,
                                          const float (&w)[NP]) {
  if constexpr (BR * NP == 4) {
    const float4 a = *reinterpret_cast<const float4*>(v);
    const float f[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int r = 0; r < BR; ++r)
        acc[p][r] = fmaf(f[p * BR + r], w[p], acc[p][r]);
  } else {
#pragma unroll
    for (int p = 0; p < NP; ++p) fma_rows<BR>(acc[p], v + p * BR, w[p]);
  }
}

template <int BR, int NP>
__device__ __forceinline__ void join(float (&out)[BR],
                                     const float (&acc)[NP][BR]) {
#pragma unroll
  for (int r = 0; r < BR; ++r) {
    if constexpr (NP == 4)
      out[r] = (acc[0][r] + acc[1][r]) + (acc[2][r] + acc[3][r]);
    else if constexpr (NP == 2)
      out[r] = acc[0][r] + acc[1][r];
    else
      out[r] = acc[0][r];
  }
}

// out = sum over k < K of v(k) * w(k).  The operand comes in blocks of NP
// consecutive k ([NP][BR] floats), block kb at v + kb * stride; the default
// stride makes it a plain [K][BR] array in shared memory.  A tail of
// K % NP k goes into the first partial sum.
template <int BR, class W>
__device__ __forceinline__ void dot_col(float (&out)[BR], const float* v,
                                        W w, int K,
                                        int stride = Parts<BR>::NP * BR) {
  constexpr int NP = Parts<BR>::NP;
  float acc[NP][BR];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int r = 0; r < BR; ++r) acc[p][r] = 0.0f;
  int k = 0;
#pragma unroll 2
  for (; k + NP <= K; k += NP, v += stride) {
    float wv[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) wv[p] = w(k + p);
    fma_block<BR, NP>(acc, v, wv);
  }
  for (; k < K; ++k, v += BR) fma_rows<BR>(acc[0], v, w(k));
  join<BR, NP>(out, acc);
}

// the same over K weights held in registers (K a multiple of 4)
template <int BR, int K>
__device__ __forceinline__ void dot_reg(float (&out)[BR], const float* v,
                                        const float (&w)[K],
                                        int stride = Parts<BR>::NP * BR) {
  constexpr int NP = Parts<BR>::NP;
  float acc[NP][BR];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int r = 0; r < BR; ++r) acc[p][r] = 0.0f;
#pragma unroll
  for (int k = 0; k < K; k += NP) {
    float wv[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) wv[p] = w[k + p];
    fma_block<BR, NP>(acc, v + (k / NP) * stride, wv);
  }
  join<BR, NP>(out, acc);
}

}  // namespace
