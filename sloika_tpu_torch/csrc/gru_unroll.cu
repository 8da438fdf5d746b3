// GRU forward recurrence with U time steps a loop body, a probe of
// gru_fwd.cu for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of scripts/bench_gru_unroll.py::run_case
// (kernel :26-45, pl.pallas_call :47), a diagnostic copy of the production
// forward sloika_tpu/nn/pallas_gru.py::_kernel that takes U time rows of the
// projections a grid step.  Same contract: over xp (T, B, 3S) f32, h0 = 0, no
// mask, forward in time,
//
//     z, r = sigmoid(xp[:, :2S] + h . sWT)          sWT  (S, 2S)
//     hbar = tanh(xp[:, 2S:] + (r * h) . sW2T)      sW2T (S, S)
//     h    = z * h + (1 - z) * hbar
//
// and out (T, B, S) f32.  With BF16 (the Pallas kernel's precision="default",
// one bf16 pass on the TPU) sWT, sW2T, h and r * h are rounded to bf16
// (nearest even) before the products, whose sums stay f32.
//
// Design.  As gru_fwd.cu: one block owns BR batch rows for all T steps, BR
// from the batch (the fewest of 1, 2, 4, 8 that fit it in one wave over the
// SMs); thread j of 2S owns gate column j; h and r * h live in shared memory
// k-major ([k][row]); two __syncthreads() a step.  Both weight matrices are
// staged in shared memory when they fit (110 KB in f32 at S = 96, 124 KB in
// bf16 at S = 144; else sW2T, then sWT, is read through L1).  The time loop
// runs U steps a body (U a template parameter).  While a body runs, the U
// rows of xp of the next body are fetched with cp.async into the other half
// of a double buffer in shared memory; the last step of a body waits for
// them before its closing barrier.  So a step finds its projections in
// shared memory: the GPU counterpart of the TPU's U rows a grid step.  The
// U steps of a body stay a rolled loop: unrolled, the compiler scheduled
// each U differently (on an H100, f32 steps of 1.7-2.7 us with no order in
// U), while rolled every U runs the same step code and U prices only how
// far ahead the projections are fetched.
//
// What bounds it.  The recurrence is T dependent steps of 3 S^2 FMAs a row:
// the step latency of one block, not bandwidth, bounds it (gru_fwd.cu).  The
// probe prices two parts of that latency: the load of each step's
// projections (against gru_fwd.cu, which loads them from global memory at
// the start of each step), and the width of the weights (bf16 halves the
// bytes each product reads from shared memory).  The products' FMAs stay f32
// on the CUDA cores, and the state update is rounded op by op (no
// contraction), so every U gives the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

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

// acc = column j of vT^T . W for a (S, N) weight W: from its shared-memory
// copy (f32 or bf16) when staged, else from global memory through L1
template <int BR, bool BF16>
__device__ __forceinline__ void product(float (&acc)[BR], const float* vT,
                                        const float* __restrict__ w,
                                        const void* wsm, int staged, int S,
                                        int N, int j) {
#pragma unroll
  for (int r = 0; r < BR; ++r) acc[r] = 0.0f;
  if (staged) {
    if constexpr (BF16) {
      const __nv_bfloat16* ws = reinterpret_cast<const __nv_bfloat16*>(wsm);
#pragma unroll 8
      for (int k = 0; k < S; ++k)
        fma_rows<BR>(acc, vT + k * BR, __bfloat162float(ws[k * N + j]));
    } else {
      const float* ws = reinterpret_cast<const float*>(wsm);
#pragma unroll 8
      for (int k = 0; k < S; ++k) fma_rows<BR>(acc, vT + k * BR, ws[k * N + j]);
    }
  } else {
#pragma unroll 8
    for (int k = 0; k < S; ++k) {
      const float v = __ldg(w + (size_t)k * N + j);
      fma_rows<BR>(acc, vT + k * BR, BF16 ? round_bf16(v) : v);
    }
  }
}

template <bool BF16>
__device__ void stage(void* dst, const float* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if constexpr (BF16)
      reinterpret_cast<__nv_bfloat16*>(dst)[i] = __float2bfloat16_rn(src[i]);
    else
      reinterpret_cast<float*>(dst)[i] = src[i];
  }
}

// start the copies of time rows t0 .. t0 + n - 1 (the block's nrows batch
// rows of each) into dst [n][BR][3S]; one commit group
__device__ __forceinline__ void fetch(float* dst, const float* __restrict__ xp,
                                      int t0, int n, int B, int b0, int nrows,
                                      int S3, int chunk, int vec) {
  const int len = nrows * S3;            // floats of one time row
  if (vec) {
    const int len4 = len / 4;
    for (int i = threadIdx.x; i < n * len4; i += blockDim.x) {
      const int u = i / len4, q = i - u * len4;
      cp_async16(dst + u * chunk + 4 * q,
                 xp + ((size_t)(t0 + u) * B + b0) * S3 + 4 * q);
    }
  } else {
    for (int i = threadIdx.x; i < n * len; i += blockDim.x) {
      const int u = i / len, q = i - u * len;
      cp_async4(dst + u * chunk + q,
                xp + ((size_t)(t0 + u) * B + b0) * S3 + q);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int U, int BR, bool BF16>
__global__ void gru_unroll_kernel(const float* __restrict__ xp,
                                  const float* __restrict__ sWT,
                                  const float* __restrict__ sW2T,
                                  float* __restrict__ out, int T, int B,
                                  int S, int stage1, int stage2, int vec) {
  extern __shared__ float4 smem4[];
  const int S2 = 2 * S, S3 = 3 * S;
  const int chunk = BR * S3;                     // floats of one time row
  float* xbuf = reinterpret_cast<float*>(smem4); // [2][U][BR][3S]
  float* hT = xbuf + 2 * U * chunk;              // [S][BR] state
  float* hbT = hT + S * BR;                      // [S][BR] bf16-rounded state
  float* rhT = hbT + S * BR;                     // [S][BR] r * h (rounded)
  void* w1 = rhT + S * BR;                       // sWT when staged
  void* w2 = reinterpret_cast<char*>(w1) +
             (stage1 ? (size_t)S * S2 * (BF16 ? 2 : 4) : 0);  // sW2T
  const float* hv = BF16 ? hbT : hT;             // the state as products read it
  const int j = threadIdx.x;
  const int b0 = blockIdx.x * BR;
  const int nrows = min(BR, B - b0);

  // rows past the batch are never fetched and stay 0
  for (int i = j; i < 2 * U * chunk; i += blockDim.x) xbuf[i] = 0.0f;
  for (int i = j; i < 3 * S * BR; i += blockDim.x) hT[i] = 0.0f;
  if (stage1) stage<BF16>(w1, sWT, S * S2);
  if (stage2) stage<BF16>(w2, sW2T, S * S);
  __syncthreads();
  fetch(xbuf, xp, 0, min(U, T), B, b0, nrows, S3, chunk, vec);
  cp_async_wait_all();
  __syncthreads();

  float z[BR];
  const int nbody = (T + U - 1) / U;
  for (int body = 0; body < nbody; ++body) {
    const float* cur = xbuf + (body & 1) * U * chunk;
    const int t1 = (body + 1) * U;
    if (t1 < T)
      fetch(xbuf + ((body + 1) & 1) * U * chunk, xp, t1, min(U, T - t1), B,
            b0, nrows, S3, chunk, vec);
#pragma unroll 1
    for (int u = 0; u < U; ++u) {
      const int t = body * U + u;
      if (t >= T) break;                          // the same for every thread
      const float* xr = cur + u * chunk;
      float xg[BR], xc[BR];
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        xg[r] = j < S2 ? xr[r * S3 + j] : 0.0f;
        xc[r] = j < S ? xr[r * S3 + S2 + j] : 0.0f;
      }

      // z / r gates: column j of h . sWT for the block's rows
      if (j < S2) {
        float acc[BR];
        product<BR, BF16>(acc, hv, sWT, w1, stage1, S, S2, j);
#pragma unroll
        for (int r = 0; r < BR; ++r) {
          const float g = sigmoid_f32(xg[r] + acc[r]);
          if (j < S) {
            z[r] = g;
          } else {
            const int c = (j - S) * BR + r;
            const float rh = g * hT[c];
            rhT[c] = BF16 ? round_bf16(rh) : rh;
          }
        }
      }
      __syncthreads();

      // candidate and state update: column j of (r * h) . sW2T
      if (j < S) {
        float acc[BR];
        product<BR, BF16>(acc, rhT, sW2T, w2, stage2, S, S, j);
#pragma unroll
        for (int r = 0; r < BR; ++r) {
          if (r < nrows) {
            const float hbar = tanhf(xc[r] + acc[r]);
            const float h = hT[j * BR + r];
            const float nw = __fadd_rn(__fmul_rn(z[r], h),
                                       __fmul_rn(1.0f - z[r], hbar));
            hT[j * BR + r] = nw;
            if (BF16) hbT[j * BR + r] = round_bf16(nw);
            out[((size_t)t * B + b0 + r) * S + j] = nw;
          }
        }
      }
      if (u == U - 1) cp_async_wait_all();        // the next body has landed
      __syncthreads();
    }
  }
}

template <int U, int BR, bool BF16>
int launch(const void* xp, const void* sWT, const void* sW2T, void* out,
           int T, int B, int S, int optin, cudaStream_t stream) {
  const size_t wsz = BF16 ? 2 : 4;
  const size_t base = (2 * (size_t)U * BR * 3 * S + 3 * (size_t)S * BR) * 4;
  const size_t w1 = (size_t)S * 2 * S * wsz, w2 = (size_t)S * S * wsz;
  if (base > (size_t)optin) return (int)cudaErrorInvalidValue;
  const int stage1 = base + w1 <= (size_t)optin;
  const int stage2 = stage1 && base + w1 + w2 <= (size_t)optin;
  const size_t smem = base + (stage1 ? w1 : 0) + (stage2 ? w2 : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gru_unroll_kernel<U, BR, BF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec = (3 * S) % 4 == 0 && (uintptr_t)xp % 16 == 0;
  const int threads = (2 * S + 31) / 32 * 32;
  gru_unroll_kernel<U, BR, BF16><<<(B + BR - 1) / BR, threads, smem, stream>>>(
      (const float*)xp, (const float*)sWT, (const float*)sW2T, (float*)out, T,
      B, S, stage1, stage2, vec);
  return (int)cudaGetLastError();
}

template <int U, bool BF16>
int by_rows(int br, const void* xp, const void* sWT, const void* sW2T,
            void* out, int T, int B, int S, int optin, cudaStream_t s) {
  switch (br) {
    case 1: return launch<U, 1, BF16>(xp, sWT, sW2T, out, T, B, S, optin, s);
    case 2: return launch<U, 2, BF16>(xp, sWT, sW2T, out, T, B, S, optin, s);
    case 4: return launch<U, 4, BF16>(xp, sWT, sW2T, out, T, B, S, optin, s);
    default: return launch<U, 8, BF16>(xp, sWT, sW2T, out, T, B, S, optin, s);
  }
}

template <bool BF16>
int by_unroll(int U, int br, const void* xp, const void* sWT,
              const void* sW2T, void* out, int T, int B, int S, int optin,
              cudaStream_t s) {
  switch (U) {
    case 1: return by_rows<1, BF16>(br, xp, sWT, sW2T, out, T, B, S, optin, s);
    case 2: return by_rows<2, BF16>(br, xp, sWT, sW2T, out, T, B, S, optin, s);
    case 4: return by_rows<4, BF16>(br, xp, sWT, sW2T, out, T, B, S, optin, s);
    case 8: return by_rows<8, BF16>(br, xp, sWT, sW2T, out, T, B, S, optin, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// U in {1, 2, 4, 8}; bf16 != 0 for precision "default"
extern "C" int gru_unroll(const void* xp, const void* sWT, const void* sW2T,
                          void* out, int T, int B, int S, int U, int bf16,
                          void* stream) {
  int dev = 0, sms = 1, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  // fewest rows per block that keep the batch in one wave over the SMs
  int br = 1;
  while (br < 8 && (B + br - 1) / br > sms) br *= 2;
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? by_unroll<true>(U, br, xp, sWT, sW2T, out, T, B, S, optin, s)
              : by_unroll<false>(U, br, xp, sWT, sW2T, out, T, B, S, optin,
                                 s);
}
