// Peephole LSTM backward recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sloika_tpu/nn/pallas_lstm.py::_bwd_kernel
// (driven by _pallas_scan_bwd and the VJP _bwd), all but its weight and
// peephole cotangent sums, which csrc/lstm_wgrad.cu takes over.  Same
// contract: it walks the forward scan backwards and, at each step,
// recomputes the gates from (xp_t, h_prev, c_prev) rather than reading them,
//
//     f, i, u, c_new, o from xp_t + h_prev . sWT, c_prev, p  (as the forward)
//     tc   = tanh(c_new)
//     dht  = dh + g_t;  dh_eff, dc_eff = mask ? (dht, dc) : 0
//     dg3  = dh_eff tc o (1 - o)
//     dcn  = dc_eff + dh_eff o (1 - tc^2) + dg3 p[2]
//     dg0  = dcn i (1 - u^2);  dg1 = dcn u i (1 - i);  dg2 = dcn c_prev f (1 - f)
//     dc   = dcn f + dg1 p[0] + dg2 p[1]           (+ dc  where masked)
//     dh   = [dg0 dg1 dg2 dg3] . sW                (+ dht where masked)
//                                                  sW = sWT^T (4S, S)
//
// and writes dxp = dg (T, B, 4S), zero at masked steps (dh_eff = dc_eff = 0
// make every dg zero there).  h_prev and c_prev are the forward's h and c
// traces shifted one step towards the scan start (zeros at the first step);
// the forward emits the carried state at a masked step, so they are what the
// Pallas kernel sees.
//
// Design.  As csrc/gru_bwd.cu: one block owns BR batch rows and walks all T
// steps in reverse scan order, so the carried (dh, dc) stay in the registers
// of the thread that owns state column s < S, with c_prev.  Four barriers a
// step separate four phases: (A) h_prev into shared memory; (B) thread j of
// 4S sums gate column j of xp + h_prev . sWT into shared memory; (C) thread
// s < S recomputes its cell, forms its four dg columns in place of the four
// gate sums it alone reads, writes dxp and carries dc; (D) thread j = q S + s
// sums the q-th quarter of dg . sW for state column s, and (A) of the next
// step adds the four quarters in a fixed order.  Spreading (D) over all 4S
// threads makes its sequential length S, not 4S.
//
// What bounds it.  Like the forward, T dependent steps of little work per
// row (8 S^2 FMAs): the latency of a step, not bandwidth.  It reads both
// sWT (coalesced for the gate product) and sW (for dg . sW); at S = 64 the
// pair is 128 KB and both are staged in shared memory beside the block's
// vectors (9 S BR floats), sWT first; what does not fit is read with __ldg.
// Rows per block adapt to the batch as in lstm_fwd.cu, then halve while the
// block's registers would not fit the SM.  Threads are 4S, so S <= 256.  The
// weight cotangents are left to lstm_wgrad.cu: an S x 4S rank-BR update each
// step would lengthen the critical path, and its accumulators do not fit
// beside the weights.  Plain f32 FMA: no TF32 and no fast-math.
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

// acc[r] = sum_{k < K} vT[k][r] * W[k][j], W row-major with leading
// dimension ld: from shared memory (smem + woff) when staged, else from
// global memory through L1
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

// staging bits: sWT (S x 4S), then sW (4S x S)
constexpr int kStageSWT = 1, kStageSW = 2;

template <int BR>
__global__ void lstm_bwd_kernel(const float* __restrict__ xp,
                                const uint8_t* __restrict__ mask,
                                const float* __restrict__ sWT,
                                const float* __restrict__ sW,
                                const float* __restrict__ p,
                                const float* __restrict__ g,
                                const float* __restrict__ h_out,
                                const float* __restrict__ c_out,
                                float* __restrict__ dxp, int T, int B, int S,
                                int reverse, int stage) {
  extern __shared__ float4 smem4[];
  float* hT = reinterpret_cast<float*>(smem4);   // [S][BR]   h_prev
  float* gT = hT + S * BR;                       // [4S][BR]  gate sums, dg
  float* qT = gT + 4 * S * BR;                   // [4][S][BR] dg . sW parts
  float* wsm = qT + 4 * S * BR;                  // staged weights
  const int j = threadIdx.x;
  const int b0 = blockIdx.x * BR;
  const int S4 = 4 * S;
  const bool own_state = j < S;
  const bool own_gate = j < S4;                  // threads round up to 32

  const int o_sWT = (stage & kStageSWT) ? 0 : -1;
  const int o_sW = (stage & kStageSW) ? ((stage & kStageSWT) ? S * S4 : 0)
                                      : -1;
  for (int i = j; i < S * S4; i += blockDim.x) {
    if (o_sWT >= 0) wsm[o_sWT + i] = sWT[i];
    if (o_sW >= 0) wsm[o_sW + i] = sW[i];
  }
  for (int i = j; i < 4 * S * BR; i += blockDim.x) qT[i] = 0.0f;
  float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f;
  if (own_state) {
    p0 = p[j];
    p1 = p[S + j];
    p2 = p[2 * S + j];
  }
  // carried cotangents of state column j < S; dh is the part that does not
  // go through dg . sW (masked steps pass dht straight through)
  float dh[BR], dc[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) dh[r] = dc[r] = 0.0f;
  __syncthreads();

  for (int step = 0; step < T; ++step) {
    // the forward scan's steps, last first
    const int t = reverse ? step : T - 1 - step;
    const bool has_prev = reverse ? t + 1 < T : t > 0;
    const size_t row0 = (size_t)t * B + b0;
    const size_t prow0 =
        has_prev ? (size_t)(reverse ? t + 1 : t - 1) * B + b0 : 0;

    // (A) this step's inputs; h_prev into shared memory; dh completed with
    // the previous step's four quarters of dg . sW, in a fixed order
    float xg[BR], cp[BR], gt[BR];
    uint8_t valid[BR];
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      const bool in = b0 + r < B;
      const bool col = in && own_state;
      xg[r] = (in && own_gate) ? xp[(row0 + r) * S4 + j] : 0.0f;
      cp[r] = (col && has_prev) ? c_out[(prow0 + r) * S + j] : 0.0f;
      gt[r] = col ? g[(row0 + r) * S + j] : 0.0f;
      valid[r] = col ? mask[row0 + r] : 0;
      if (own_state) {
        hT[j * BR + r] = (col && has_prev) ? h_out[(prow0 + r) * S + j]
                                           : 0.0f;
        const int e = j * BR + r, q = S * BR;
        dh[r] += ((qT[e] + qT[q + e]) + qT[2 * q + e]) + qT[3 * q + e];
      }
    }
    __syncthreads();

    // (B) gate column j of xp + h_prev . sWT
    if (own_gate) {
      float acc[BR];
      col_dot<BR>(acc, hT, sWT, wsm, o_sWT, S, S4, j);
#pragma unroll
      for (int r = 0; r < BR; ++r) gT[j * BR + r] = xg[r] + acc[r];
    }
    __syncthreads();

    // (C) the cell of state column j, its dg (in place), dxp and dc
    if (own_state) {
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        float* g0p = gT + j * BR + r;
        float* g1p = gT + (S + j) * BR + r;
        float* g2p = gT + (2 * S + j) * BR + r;
        float* g3p = gT + (3 * S + j) * BR + r;
        const float c = cp[r];
        const float f = sigmoid_f32(*g2p + c * p1);
        const float i = sigmoid_f32(*g1p + c * p0);
        const float u = tanhf(*g0p);
        const float cn = c * f + u * i;
        const float o = sigmoid_f32(*g3p + cn * p2);
        const float tc = tanhf(cn);

        const float dht = dh[r] + gt[r];
        const float dct = dc[r];
        const float dhe = valid[r] ? dht : 0.0f;
        const float dce = valid[r] ? dct : 0.0f;
        const float dg3 = dhe * tc * o * (1.0f - o);
        const float dcn = dce + dhe * o * (1.0f - tc * tc) + dg3 * p2;
        const float dg0 = dcn * i * (1.0f - u * u);
        const float dg1 = dcn * u * i * (1.0f - i);
        const float dg2 = dcn * c * f * (1.0f - f);
        *g0p = dg0;
        *g1p = dg1;
        *g2p = dg2;
        *g3p = dg3;
        dc[r] = dcn * f + dg1 * p0 + dg2 * p1 + (valid[r] ? 0.0f : dct);
        dh[r] = valid[r] ? 0.0f : dht;
        if (b0 + r < B) {
          float* out = dxp + (row0 + r) * S4;
          out[j] = dg0;
          out[S + j] = dg1;
          out[2 * S + j] = dg2;
          out[3 * S + j] = dg3;
        }
      }
    }
    __syncthreads();

    // (D) quarter q of dg . sW for state column s, j = q S + s
    if (own_gate) {
      const int q = j / S, s = j - q * S;
      float acc[BR];
      if (o_sW >= 0) {
        col_dot<BR>(acc, gT + q * S * BR, nullptr, wsm, o_sW + q * S * S, S,
                    S, s);
      } else {
        col_dot<BR>(acc, gT + q * S * BR, sW + (size_t)q * S * S, wsm, -1, S,
                    S, s);
      }
#pragma unroll
      for (int r = 0; r < BR; ++r) qT[(q * S + s) * BR + r] = acc[r];
    }
    // the next step's (A) reads qT and writes hT only; its barrier orders
    // (B) behind it, and nothing of this step reads hT any more
    __syncthreads();
  }
}

template <int BR>
int kernel_max_threads() {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, lstm_bwd_kernel<BR>) != cudaSuccess) return 0;
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
int launch(const void* xp, const void* mask, const void* sWT, const void* sW,
           const void* p, const void* g, const void* h_out,
           const void* c_out, void* dxp, int T, int B, int S, int reverse,
           int optin, int threads, cudaStream_t stream) {
  const size_t f = sizeof(float);
  size_t smem = 9 * (size_t)S * BR * f;
  const size_t wbytes = 4 * (size_t)S * S * f;
  const int bits[2] = {kStageSWT, kStageSW};
  int stage = 0;
  for (int b = 0; b < 2; ++b) {
    if (smem + wbytes <= (size_t)optin) {
      smem += wbytes;
      stage |= bits[b];
    }
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_bwd_kernel<BR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lstm_bwd_kernel<BR><<<(B + BR - 1) / BR, threads, smem, stream>>>(
      (const float*)xp, (const uint8_t*)mask, (const float*)sWT,
      (const float*)sW, (const float*)p, (const float*)g,
      (const float*)h_out, (const float*)c_out, (float*)dxp, T, B, S,
      reverse, stage);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lstm_bwd(const void* xp, const void* mask, const void* sWT,
                        const void* sW, const void* p, const void* g,
                        const void* h_out, const void* c_out, void* dxp,
                        int T, int B, int S, int reverse, void* stream) {
  int dev = 0, sms = 1, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int threads = (4 * S + 31) / 32 * 32;
  // fewest rows per block that keep the batch in one wave over the SMs ...
  int br = 1;
  while (br < 8 && (B + br - 1) / br > sms) br *= 2;
  // ... and no more than the block's registers allow
  while (br > 1 && max_threads(br) < threads) br /= 2;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (br) {
    case 1:
      return launch<1>(xp, mask, sWT, sW, p, g, h_out, c_out, dxp, T, B, S,
                       reverse, optin, threads, s);
    case 2:
      return launch<2>(xp, mask, sWT, sW, p, g, h_out, c_out, dxp, T, B, S,
                       reverse, optin, threads, s);
    case 4:
      return launch<4>(xp, mask, sWT, sW, p, g, h_out, c_out, dxp, T, B, S,
                       reverse, optin, threads, s);
    default:
      return launch<8>(xp, mask, sWT, sW, p, g, h_out, c_out, dxp, T, B, S,
                       reverse, optin, threads, s);
  }
}
