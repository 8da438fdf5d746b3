// GRU forward recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sloika_tpu/nn/pallas_gru.py::_kernel
// (driven by _pallas_scan / gru_fused).  Same contract: over the hoisted
// input projection xp (T, B, 3S), f32 throughout,
//
//     z, r = sigmoid(xp[:, :2S] + h . sWT)          sWT  (S, 2S)
//     hbar = tanh(xp[:, 2S:] + (r * h) . sW2T)      sW2T (S, S)
//     h    = z * h + (1 - z) * hbar
//
// A masked step (mask == 0) keeps AND emits the carried h.  With `reverse`
// the scan runs from t = T-1 down to 0 (the Pallas kernel does it with its
// index map).  out is (T, B, S) f32.
//
// Design.  One block owns BR batch rows and walks all T steps, so the
// sequential dependency stays inside the block.  Thread j (of 2S, rounded up
// to a warp multiple) owns gate column j for the block's rows: each weight
// it loads feeds BR FMAs.  h and r*h live in shared memory, stored k-major
// ([k][row]).  Two __syncthreads() per step: after the z/r product (r*h
// ready), and after the state update (h ready for the next step).  This
// step's projections and mask are loaded before the products, so their
// latency hides behind them.
//
// What bounds it.  The recurrence is T dependent steps, and each step is a
// small amount of work per row (3 S^2 FMAs), so the time per step of one
// block, not bandwidth, bounds the kernel: with 8 rows per block the time per
// step on an H100 is the same at B = 64 (8 blocks) as at B = 1024 (128
// blocks).  So BR adapts to the batch: the fewest rows per block (1, 2, 4 or
// 8) that still fit the batch in one wave of blocks over the SMs, which
// spreads a small batch over as many SMs as it has rows.  The f32 recurrent
// weights are 3 S^2 floats, 249 KB at S = 144: more than the 227 KB a block
// may hold in shared memory.  So the larger matrix sWT (S x 2S, 166 KB at
// S = 144) is staged in shared memory once when it fits, and sW2T (83 KB) is
// read with __ldg through L1, which keeps most of it beside the staged sWT.
// Sums are plain f32 FMA: no TF32 and no fast-math (expf/tanhf are the
// accurate versions).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
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

template <int BR>
__global__ void gru_fwd_kernel(const float* __restrict__ xp,
                               const uint8_t* __restrict__ mask,
                               const float* __restrict__ sWT,
                               const float* __restrict__ sW2T,
                               float* __restrict__ out,
                               int T, int B, int S, int reverse, int stage) {
  extern __shared__ float4 smem4[];
  float* hT = reinterpret_cast<float*>(smem4);   // [S][BR]  state
  float* rhT = hT + S * BR;                      // [S][BR]  r * h
  float* wsm = rhT + S * BR;                     // [S][2S]  sWT when staged
  const int j = threadIdx.x;
  const int b0 = blockIdx.x * BR;
  const int S2 = 2 * S;
  const int S3 = 3 * S;

  for (int i = j; i < 2 * S * BR; i += blockDim.x) hT[i] = 0.0f;
  if (stage) {
    for (int i = j; i < S * S2; i += blockDim.x) wsm[i] = sWT[i];
  }
  __syncthreads();

  float z[BR];
  for (int step = 0; step < T; ++step) {
    const int t = reverse ? T - 1 - step : step;
    const size_t row0 = (size_t)t * B + b0;      // (t, b0) row index

    float xg[BR], xc[BR];
    uint8_t valid[BR];
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      const bool in = b0 + r < B;
      xg[r] = (in && j < S2) ? xp[(row0 + r) * S3 + j] : 0.0f;
      xc[r] = (in && j < S) ? xp[(row0 + r) * S3 + S2 + j] : 0.0f;
      valid[r] = (in && j < S) ? mask[row0 + r] : 0;
    }

    // z / r gates: column j of h . sWT for the block's rows
    if (j < S2) {
      float acc[BR];
#pragma unroll
      for (int r = 0; r < BR; ++r) acc[r] = 0.0f;
      if (stage) {
#pragma unroll 8
        for (int k = 0; k < S; ++k)
          fma_rows<BR>(acc, hT + k * BR, wsm[k * S2 + j]);
      } else {
#pragma unroll 8
        for (int k = 0; k < S; ++k)
          fma_rows<BR>(acc, hT + k * BR, __ldg(sWT + (size_t)k * S2 + j));
      }
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const float g = sigmoid_f32(xg[r] + acc[r]);
        if (j < S) {
          z[r] = g;
        } else {
          const int c = (j - S) * BR + r;
          rhT[c] = g * hT[c];           // padded rows: h stays 0
        }
      }
    }
    __syncthreads();

    // candidate and state update: column j of (r * h) . sW2T
    if (j < S) {
      float acc[BR];
#pragma unroll
      for (int r = 0; r < BR; ++r) acc[r] = 0.0f;
#pragma unroll 8
      for (int k = 0; k < S; ++k)
        fma_rows<BR>(acc, rhT + k * BR, __ldg(sW2T + (size_t)k * S + j));
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        if (b0 + r < B) {
          const float hbar = tanhf(xc[r] + acc[r]);
          const float h = hT[j * BR + r];
          float nw = z[r] * h + (1.0f - z[r]) * hbar;
          if (valid[r] == 0) nw = h;
          hT[j * BR + r] = nw;
          out[(row0 + r) * S + j] = nw;
        }
      }
    }
    __syncthreads();
  }
}

template <int BR>
int launch(const void* xp, const void* mask, const void* sWT,
           const void* sW2T, void* out, int T, int B, int S, int reverse,
           int optin, cudaStream_t stream) {
  const size_t base = 2 * (size_t)S * BR * sizeof(float);
  const size_t wbytes = (size_t)S * 2 * S * sizeof(float);
  const int stage = base + wbytes <= (size_t)optin;
  const size_t smem = base + (stage ? wbytes : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gru_fwd_kernel<BR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = (2 * S + 31) / 32 * 32;
  gru_fwd_kernel<BR><<<(B + BR - 1) / BR, threads, smem, stream>>>(
      (const float*)xp, (const uint8_t*)mask, (const float*)sWT,
      (const float*)sW2T, (float*)out, T, B, S, reverse, stage);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gru_fwd(const void* xp, const void* mask, const void* sWT,
                       const void* sW2T, void* out, int T, int B, int S,
                       int reverse, void* stream) {
  int dev = 0, sms = 1, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  // fewest rows per block that keep the batch in one wave over the SMs
  int br = 1;
  while (br < 8 && (B + br - 1) / br > sms) br *= 2;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (br) {
    case 1:
      return launch<1>(xp, mask, sWT, sW2T, out, T, B, S, reverse, optin, s);
    case 2:
      return launch<2>(xp, mask, sWT, sW2T, out, T, B, S, reverse, optin, s);
    case 4:
      return launch<4>(xp, mask, sWT, sW2T, out, T, B, S, reverse, optin, s);
    default:
      return launch<8>(xp, mask, sWT, sW2T, out, T, B, S, reverse, optin, s);
  }
}
