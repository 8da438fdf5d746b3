// GRU backward recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sloika_tpu/nn/pallas_gru.py::_bwd_kernel
// (driven by _pallas_scan_bwd and the VJP _bwd), all but its weight
// cotangent sums, which csrc/gru_wgrad.cu takes over.  Same contract: it
// walks the forward scan backwards and, at each step, recomputes the gates
// from (xp_t, h_prev) rather than reading them,
//
//     z, r  = sigmoid(xp[:, :2S] + h_prev . sWT)      sWT  (S, 2S)
//     hbar  = tanh(xp[:, 2S:] + (r * h_prev) . sW2T)  sW2T (S, S)
//     dht   = dh + g_t;  dh_eff = mask ? dht : 0
//     dz    = dh_eff (h_prev - hbar) z (1 - z)
//     da    = dh_eff (1 - z) (1 - hbar^2)
//     drh   = da . sW2                                 sW2 = sW2T^T
//     dr    = drh h_prev r (1 - r)
//     dh    = dh_eff z + drh r + [dz, dr] . sW  (+ dht where masked)
//                                                      sW  = sWT^T (2S, S)
//
// and writes dxp = mask ? [dz, dr, da] : 0 (T, B, 3S) and r * h_prev
// (T, B, S), the one extra buffer gru_wgrad.cu needs.  h_prev is h_out
// shifted one step towards the scan start (zeros at the first step); the
// forward emits the carried state at a masked step, so h_prev there is the
// carried state, as the Pallas kernel sees it.
//
// Design.  As gru_fwd.cu: one block owns BR batch rows and walks all T
// steps (in reverse scan order), so the carried dh stays in the registers
// of the thread that owns its column.  Thread j (of 2S, rounded up to a
// warp multiple) owns gate column j for the product with sWT; threads
// j < S own state column j for the other three products.  Vectors that
// every thread reads (h_prev, r * h_prev, da, [dz, dr]) live in shared
// memory, k-major ([k][row]); four __syncthreads() a step separate the four
// dependent products.  Each product reads its weight in the layout that puts
// neighbouring threads on neighbouring addresses, which is why both sWT/sW2T
// and their transposes sW/sW2 come in.
//
// What bounds it.  Like the forward, T dependent steps of little work per
// row each: the latency of a step, not bandwidth.  A step here is four
// dependent products (about 6 S^2 FMAs per row) to the forward's two.
// The four weight matrices are 6 S^2 floats, 221,184 bytes at S = 96, near
// the 232,448 bytes a block may hold.  The launcher stages them in shared
// memory in order of use (sWT, sW, sW2T, sW2) while they fit beside the
// block's vectors (6 S BR floats), and the kernel reads the rest with
// __ldg: at S = 96 all four fit up to BR = 4, and sW2 is read by __ldg at
// BR = 8.  The weight cotangents are left to gru_wgrad.cu: accumulating an
// S x 3S rank-BR update each step would lengthen the critical path, and its
// 110,592 bytes of accumulators at S = 96 do not fit beside the weights.
// Rows per block adapt to the batch as in gru_fwd.cu, then halve while the
// block's registers would not fit the SM.  Sums are plain f32 FMA: no TF32 and no fast-math.
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

// acc[r] = sum_k vT[k][r] * W[k][j], W (K, ld) row-major: from shared memory
// (smem + woff) when staged, else from global memory through L1
template <int BR>
__device__ __forceinline__ void col_dot(float (&acc)[BR], const float* vT,
                                        const float* __restrict__ wg,
                                        const float* smem, int woff, int K,
                                        int ld, int j) {
#pragma unroll
  for (int r = 0; r < BR; ++r) acc[r] = 0.0f;
  if (woff >= 0) {
    const float* ws = smem + woff;
#pragma unroll 8
    for (int k = 0; k < K; ++k) fma_rows<BR>(acc, vT + k * BR, ws[k * ld + j]);
  } else {
#pragma unroll 8
    for (int k = 0; k < K; ++k)
      fma_rows<BR>(acc, vT + k * BR, __ldg(wg + (size_t)k * ld + j));
  }
}

// staging order and bits: sWT, sW (2 S^2 floats each), sW2T, sW2 (S^2)
constexpr int kStageSWT = 1, kStageSW = 2, kStageSW2T = 4, kStageSW2 = 8;

template <int BR>
__global__ void gru_bwd_kernel(const float* __restrict__ xp,
                               const uint8_t* __restrict__ mask,
                               const float* __restrict__ sWT,
                               const float* __restrict__ sW2T,
                               const float* __restrict__ sW,
                               const float* __restrict__ sW2,
                               const float* __restrict__ g,
                               const float* __restrict__ h_out,
                               float* __restrict__ dxp,
                               float* __restrict__ rh_out, int T, int B,
                               int S, int reverse, int stage) {
  extern __shared__ float4 smem4[];
  float* hT = reinterpret_cast<float*>(smem4);   // [S][BR]  h_prev
  float* rT = hT + S * BR;                       // [S][BR]  r
  float* rhT = rT + S * BR;                      // [S][BR]  r * h_prev
  float* daT = rhT + S * BR;                     // [S][BR]  da
  float* dvT = daT + S * BR;                     // [2S][BR] dz, dr
  float* wsm = dvT + 2 * S * BR;                 // staged weights
  const int j = threadIdx.x;
  const int b0 = blockIdx.x * BR;
  const int S2 = 2 * S;
  const int S3 = 3 * S;

  // offsets of the staged weights in wsm (-1: read from global memory)
  int off = 0, o_sWT = -1, o_sW = -1, o_sW2T = -1, o_sW2 = -1;
  if (stage & kStageSWT) { o_sWT = off; off += S * S2; }
  if (stage & kStageSW) { o_sW = off; off += S * S2; }
  if (stage & kStageSW2T) { o_sW2T = off; off += S * S; }
  if (stage & kStageSW2) { o_sW2 = off; off += S * S; }
  for (int i = j; i < S * S2; i += blockDim.x) {
    if (o_sWT >= 0) wsm[o_sWT + i] = sWT[i];
    if (o_sW >= 0) wsm[o_sW + i] = sW[i];
  }
  for (int i = j; i < S * S; i += blockDim.x) {
    if (o_sW2T >= 0) wsm[o_sW2T + i] = sW2T[i];
    if (o_sW2 >= 0) wsm[o_sW2 + i] = sW2[i];
  }
  __syncthreads();

  float dh[BR];                // carried state cotangent of column j < S
#pragma unroll
  for (int r = 0; r < BR; ++r) dh[r] = 0.0f;

  for (int step = 0; step < T; ++step) {
    // the forward scan's steps, last first
    const int t = reverse ? step : T - 1 - step;
    const bool has_prev = reverse ? t + 1 < T : t > 0;
    const size_t row0 = (size_t)t * B + b0;
    const size_t prow0 = has_prev ? (size_t)(reverse ? t + 1 : t - 1) * B + b0
                                  : 0;

    // (A) this step's inputs; h_prev into shared memory
    float hp[BR], xg[BR], xc[BR], gt[BR];
    uint8_t valid[BR];
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      const bool in = b0 + r < B;
      const bool col = in && j < S;
      hp[r] = (col && has_prev) ? h_out[(prow0 + r) * S + j] : 0.0f;
      xg[r] = (in && j < S2) ? xp[(row0 + r) * S3 + j] : 0.0f;
      xc[r] = col ? xp[(row0 + r) * S3 + S2 + j] : 0.0f;
      gt[r] = col ? g[(row0 + r) * S + j] : 0.0f;
      valid[r] = col ? mask[row0 + r] : 0;
    }
    if (j < S) {
#pragma unroll
      for (int r = 0; r < BR; ++r) hT[j * BR + r] = hp[r];
    }
    __syncthreads();

    // (B) z / r gates: column j of h_prev . sWT
    float z[BR];
    if (j < S2) {
      float acc[BR];
      col_dot<BR>(acc, hT, sWT, wsm, o_sWT, S, S2, j);
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const float gate = sigmoid_f32(xg[r] + acc[r]);
        if (j < S) {
          z[r] = gate;
        } else {
          const int c = (j - S) * BR + r;
          const float v = gate * hT[c];    // padded rows: h_prev stays 0
          rT[c] = gate;
          rhT[c] = v;
          if (b0 + r < B) rh_out[(row0 + r) * S + (j - S)] = v;
        }
      }
    }
    __syncthreads();

    // (C) candidate, then dz and da of column j
    float dht[BR], dhe[BR], dz[BR], da[BR];
    if (j < S) {
      float acc[BR];
      col_dot<BR>(acc, rhT, sW2T, wsm, o_sW2T, S, S, j);
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const float hbar = tanhf(xc[r] + acc[r]);
        dht[r] = dh[r] + gt[r];
        dhe[r] = valid[r] ? dht[r] : 0.0f;
        dz[r] = dhe[r] * (hp[r] - hbar) * z[r] * (1.0f - z[r]);
        da[r] = dhe[r] * (1.0f - z[r]) * (1.0f - hbar * hbar);
        dvT[j * BR + r] = dz[r];
        daT[j * BR + r] = da[r];
      }
    }
    __syncthreads();

    // (D) drh = da . sW2 and dr of column j
    float drh[BR], rk[BR], dr[BR];
    if (j < S) {
      col_dot<BR>(drh, daT, sW2, wsm, o_sW2, S, S, j);
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        rk[r] = rT[j * BR + r];
        dr[r] = drh[r] * hp[r] * rk[r] * (1.0f - rk[r]);
        dvT[(S + j) * BR + r] = dr[r];
      }
    }
    __syncthreads();

    // (E) dh_prev = dh_eff z + drh r + [dz, dr] . sW; outputs of column j.
    // The next step's (A) writes only hT, which nothing here reads, and its
    // barrier orders everything after it behind this step.
    if (j < S) {
      float acc[BR];
      col_dot<BR>(acc, dvT, sW, wsm, o_sW, S2, S, j);
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        float d = dhe[r] * z[r] + drh[r] * rk[r] + acc[r];
        if (!valid[r]) d = d + dht[r];
        dh[r] = d;
        if (b0 + r < B) {
          float* out = dxp + (row0 + r) * S3;
          out[j] = valid[r] ? dz[r] : 0.0f;
          out[S + j] = valid[r] ? dr[r] : 0.0f;
          out[S2 + j] = valid[r] ? da[r] : 0.0f;
        }
      }
    }
  }
}

template <int BR>
int kernel_max_threads() {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, gru_bwd_kernel<BR>) != cudaSuccess) return 0;
  return a.maxThreadsPerBlock;
}

int max_threads(int br) {
  switch (br) {
    case 1: return kernel_max_threads<1>();
    case 2: return kernel_max_threads<2>();
    case 4: return kernel_max_threads<4>();
    default: return kernel_max_threads<8>();
  }
}

template <int BR>
int launch(const void* xp, const void* mask, const void* sWT,
           const void* sW2T, const void* sW, const void* sW2, const void* g,
           const void* h_out, void* dxp, void* rh, int T, int B, int S,
           int reverse, int optin, int threads, cudaStream_t stream) {
  const size_t f = sizeof(float);
  size_t smem = 6 * (size_t)S * BR * f;
  const size_t sizes[4] = {2 * (size_t)S * S * f, 2 * (size_t)S * S * f,
                           (size_t)S * S * f, (size_t)S * S * f};
  int stage = 0;
  for (int i = 0; i < 4; ++i) {
    if (smem + sizes[i] <= (size_t)optin) {
      smem += sizes[i];
      stage |= 1 << i;
    }
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gru_bwd_kernel<BR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gru_bwd_kernel<BR><<<(B + BR - 1) / BR, threads, smem, stream>>>(
      (const float*)xp, (const uint8_t*)mask, (const float*)sWT,
      (const float*)sW2T, (const float*)sW, (const float*)sW2,
      (const float*)g, (const float*)h_out, (float*)dxp, (float*)rh, T, B,
      S, reverse, stage);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gru_bwd(const void* xp, const void* mask, const void* sWT,
                       const void* sW2T, const void* sW, const void* sW2,
                       const void* g, const void* h_out, void* dxp, void* rh,
                       int T, int B, int S, int reverse, void* stream) {
  int dev = 0, sms = 1, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int threads = (2 * S + 31) / 32 * 32;
  // fewest rows per block that keep the batch in one wave over the SMs ...
  int br = 1;
  while (br < 8 && (B + br - 1) / br > sms) br *= 2;
  // ... and no more than the block's registers allow
  while (br > 1 && max_threads(br) < threads) br /= 2;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (br) {
    case 1:
      return launch<1>(xp, mask, sWT, sW2T, sW, sW2, g, h_out, dxp, rh, T, B,
                       S, reverse, optin, threads, s);
    case 2:
      return launch<2>(xp, mask, sWT, sW2T, sW, sW2, g, h_out, dxp, rh, T, B,
                       S, reverse, optin, threads, s);
    case 4:
      return launch<4>(xp, mask, sWT, sW2T, sW, sW2, g, h_out, dxp, rh, T, B,
                       S, reverse, optin, threads, s);
    default:
      return launch<8>(xp, mask, sWT, sW2T, sW, sW2, g, h_out, dxp, rh, T, B,
                       S, reverse, optin, threads, s);
  }
}
