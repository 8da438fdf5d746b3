// Peephole LSTM forward recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels sloika_tpu/nn/pallas_lstm.py::_fwd_kernel
// and _fwd_kernel_nocout (both through _fwd_step, driven by _pallas_scan).
// Same contract: over the hoisted input projection xp (T, B, 4S), f32
// throughout, gate order 0 candidate, 1 input, 2 forget, 3 output,
//
//     sumW = xp_t + h . sWT                         sWT (S, 4S)
//     f    = sigmoid(g2 + c * p[1])                 both peepholes read
//     i    = sigmoid(g1 + c * p[0])                 the old c
//     c'   = c * f + tanh(g0) * i
//     o    = sigmoid(g3 + c' * p[2])                the new c
//     h'   = tanh(c') * o
//
// A masked step (mask == 0) keeps AND emits the carried (h, c).  With
// `reverse` the scan runs from t = T-1 down to 0.  h_out is (T, B, S) f32;
// the training variant also writes the cell trace c_out (T, B, S), which
// only the backward pass reads, and the inference variant (_nocout) skips
// that stream.  Both are one template, EMIT_C.  Given a `gates` buffer the
// training variant also writes the gate trace gates (T, B, 4S) = [u, i, f,
// o] (u = tanh(g0), the activated candidate; i, f, o the activated gates),
// which csrc/lstm_bwd.cu reads instead of recomputing the gates; tanh(c')
// is not stored, the backward takes it from c_out.  The cell computes its
// gates at masked steps too, from the carried (h, c), so every entry is
// finite.  The gate stores sit behind a test of the pointer, uniform over
// the block, and after the step's closing barrier: issued before it, they
// held the barrier back.  The inference variant has neither stream.
//
// Design.  As csrc/gru_fwd.cu: one block owns BR batch rows and walks all
// T steps, so the sequential dependency stays inside the block.  Thread j
// (of 4S) owns gate column j for the block's rows: it sums column j of
// h . sWT, adds xp, and writes the pre-activation to shared memory; after a
// barrier, thread s < S owns state column s and applies the cell update to
// its four gate columns (s, S+s, 2S+s, 3S+s).  c never leaves the
// registers of its thread; h lives in shared memory, stored k-major
// ([k][row]), for the next step's product.  Two __syncthreads() a step.
// The projections and mask of step t+1 are loaded while step t runs.
//
// What bounds it.  The recurrence is T dependent steps of little work per
// row (4 S^2 FMAs), so the latency of one block's step bounds the kernel,
// not bandwidth or arithmetic: the rows per block (1, 2, 4 or 8) are the
// fewest that fit the batch in one wave over the SMs (one row a block at
// B = 64 and B = 100), which spreads the batch over as many SMs as it has
// rows.  sWT is 4 S^2 floats, 64 KB at S = 64: it is staged in shared
// memory while it fits beside the block's vectors (up to S ~ 118), else
// read with __ldg through L1.  Threads are 4S, so S <= 256.  Sums are plain
// f32 FMA: no TF32 and no fast-math (expf/tanhf are the accurate versions).
#include "recurrence.cuh"

namespace {

template <int BR, bool EMIT_C>
__global__ void lstm_fwd_kernel(const float* __restrict__ xp,
                                const uint8_t* __restrict__ mask,
                                const float* __restrict__ sWT,
                                const float* __restrict__ p,
                                float* __restrict__ h_out,
                                float* __restrict__ c_out,
                                float* __restrict__ gates, int T, int B,
                                int S, int reverse, int stage) {
  extern __shared__ float4 smem4[];
  float* hT = reinterpret_cast<float*>(smem4);   // [S][BR]   state h
  float* gT = hT + S * BR;                       // [4S][BR]  gate sums
  float* wsm = gT + 4 * S * BR;                  // [S][4S]   sWT if staged
  const int j = threadIdx.x;
  const int b0 = blockIdx.x * BR;
  const int S4 = 4 * S;
  const bool own_state = j < S;
  const bool own_gate = j < S4;                  // threads round up to 32

  for (int i = j; i < S * BR; i += blockDim.x) hT[i] = 0.0f;
  if (stage) {
    for (int i = j; i < S * S4; i += blockDim.x) wsm[i] = sWT[i];
  }
  float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f;
  if (own_state) {
    p0 = p[j];
    p1 = p[S + j];
    p2 = p[2 * S + j];
  }
  float c[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) c[r] = 0.0f;

  // projections and mask of the next step, loaded a step ahead
  float xn[BR];
  uint8_t vn[BR];
  auto load = [&](int step) {
    const int t = reverse ? T - 1 - step : step;
    const size_t row0 = (size_t)t * B + b0;
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      const bool in = step < T && b0 + r < B;
      xn[r] = (in && own_gate) ? xp[(row0 + r) * S4 + j] : 0.0f;
      vn[r] = (in && own_state) ? mask[row0 + r] : 0;
    }
  };
  load(0);
  __syncthreads();

  for (int step = 0; step < T; ++step) {
    const int t = reverse ? T - 1 - step : step;
    const size_t row0 = (size_t)t * B + b0;
    float xg[BR];
    uint8_t valid[BR];
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      xg[r] = xn[r];
      valid[r] = vn[r];
    }
    load(step + 1);

    // gate column j of xp + h . sWT for the block's rows
    if (own_gate) {
      float acc[BR];
#pragma unroll
      for (int r = 0; r < BR; ++r) acc[r] = 0.0f;
      if (stage) {
#pragma unroll 8
        for (int k = 0; k < S; ++k)
          fma_rows<BR>(acc, hT + k * BR, wsm[k * S4 + j]);
      } else {
#pragma unroll 8
        for (int k = 0; k < S; ++k)
          fma_rows<BR>(acc, hT + k * BR, __ldg(sWT + (size_t)k * S4 + j));
      }
#pragma unroll
      for (int r = 0; r < BR; ++r) gT[j * BR + r] = xg[r] + acc[r];
    }
    __syncthreads();

    // cell update of state column j
    float gu[BR], gi[BR], gf[BR], go[BR];   // the training variant's trace
    if (own_state) {
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const float g0 = gT[j * BR + r];
        const float g1 = gT[(S + j) * BR + r];
        const float g2 = gT[(2 * S + j) * BR + r];
        const float g3 = gT[(3 * S + j) * BR + r];
        const float f = sigmoid_f32(g2 + c[r] * p1);
        const float i = sigmoid_f32(g1 + c[r] * p0);
        const float u = tanhf(g0);
        const float cn = c[r] * f + u * i;
        const float o = sigmoid_f32(g3 + cn * p2);
        const float hn = tanhf(cn) * o;
        float h = hT[j * BR + r];
        if (valid[r]) {
          h = hn;
          c[r] = cn;
        }
        hT[j * BR + r] = h;           // padded rows: valid 0, h stays 0
        if (b0 + r < B) {
          h_out[(row0 + r) * S + j] = h;
          if constexpr (EMIT_C) c_out[(row0 + r) * S + j] = c[r];
        }
        if constexpr (EMIT_C) {
          gu[r] = u;
          gi[r] = i;
          gf[r] = f;
          go[r] = o;
        }
      }
    }
    __syncthreads();
    if constexpr (EMIT_C) {
      // the gate trace, stored after the barrier, off the step's path
      if (gates != nullptr && own_state) {
#pragma unroll
        for (int r = 0; r < BR; ++r) {
          if (b0 + r < B) {
            float* gt = gates + (row0 + r) * S4;
            gt[j] = gu[r];
            gt[S + j] = gi[r];
            gt[2 * S + j] = gf[r];
            gt[3 * S + j] = go[r];
          }
        }
      }
    }
  }
}

template <int BR, bool EMIT_C>
int launch(const void* xp, const void* mask, const void* sWT, const void* p,
           void* h_out, void* c_out, void* gates, int T, int B, int S,
           int reverse, int optin, int threads, cudaStream_t stream) {
  const size_t base = 5 * (size_t)S * BR * sizeof(float);
  const size_t wbytes = (size_t)S * 4 * S * sizeof(float);
  const int stage = base + wbytes <= (size_t)optin;
  const size_t smem = base + (stage ? wbytes : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_fwd_kernel<BR, EMIT_C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lstm_fwd_kernel<BR, EMIT_C><<<(B + BR - 1) / BR, threads, smem, stream>>>(
      (const float*)xp, (const uint8_t*)mask, (const float*)sWT,
      (const float*)p, (float*)h_out, (float*)c_out, (float*)gates, T, B, S,
      reverse, stage);
  return (int)cudaGetLastError();
}

template <int BR, bool EMIT_C>
int kernel_max_threads() {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, lstm_fwd_kernel<BR, EMIT_C>) != cudaSuccess)
    return 0;
  return a.maxThreadsPerBlock;
}

template <bool EMIT_C>
int dispatch(const void* xp, const void* mask, const void* sWT,
             const void* p, void* h_out, void* c_out, void* gates, int T,
             int B, int S, int reverse, cudaStream_t s) {
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
  auto fits = [&](int b) {
    switch (b) {
      case 1: return kernel_max_threads<1, EMIT_C>() >= threads;
      case 2: return kernel_max_threads<2, EMIT_C>() >= threads;
      case 4: return kernel_max_threads<4, EMIT_C>() >= threads;
      default: return kernel_max_threads<8, EMIT_C>() >= threads;
    }
  };
  while (br > 1 && !fits(br)) br /= 2;
  switch (br) {
    case 1:
      return launch<1, EMIT_C>(xp, mask, sWT, p, h_out, c_out, gates, T, B,
                               S, reverse, optin, threads, s);
    case 2:
      return launch<2, EMIT_C>(xp, mask, sWT, p, h_out, c_out, gates, T, B,
                               S, reverse, optin, threads, s);
    case 4:
      return launch<4, EMIT_C>(xp, mask, sWT, p, h_out, c_out, gates, T, B,
                               S, reverse, optin, threads, s);
    default:
      return launch<8, EMIT_C>(xp, mask, sWT, p, h_out, c_out, gates, T, B,
                               S, reverse, optin, threads, s);
  }
}

}  // namespace

// c_out == nullptr selects the inference variant (no cell trace, and gates
// must be nullptr); gates == nullptr leaves out the gate trace
extern "C" int lstm_fwd(const void* xp, const void* mask, const void* sWT,
                        const void* p, void* h_out, void* c_out, void* gates,
                        int T, int B, int S, int reverse, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (c_out == nullptr) {
    if (gates != nullptr) return (int)cudaErrorInvalidValue;
    return dispatch<false>(xp, mask, sWT, p, h_out, c_out, gates, T, B, S,
                           reverse, s);
  }
  return dispatch<true>(xp, mask, sWT, p, h_out, c_out, gates, T, B, S,
                        reverse, s);
}
