// Peephole LSTM backward recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sloika_tpu/nn/pallas_lstm.py::_bwd_kernel
// (driven by _pallas_scan_bwd and the VJP _bwd), all but its weight and
// peephole cotangent sums, which csrc/lstm_wgrad.cu takes over.  It walks
// the forward scan backwards and, at each step, reads the gates [u, i, f, o]
// that the forward's training variant saved (csrc/lstm_fwd.cu) and the cell
// trace c_out,
//
//     tc   = tanh(c_out_t)   (c' at a valid step)
//     dht  = dh + g_t;  dh_eff, dc_eff = mask ? (dht, dc) : 0
//     dg3  = dh_eff tc o (1 - o)
//     dcn  = dc_eff + dh_eff o (1 - tc^2) + dg3 p[2]
//     dg0  = dcn i (1 - u^2);  dg1 = dcn u i (1 - i)
//     dg2  = dcn c_prev f (1 - f)
//     dc   = dcn f + dg1 p[0] + dg2 p[1]           (+ dc  where masked)
//     dh   = [dg0 dg1 dg2 dg3] . sW                (+ dht where masked)
//                                                  sW = sWT^T (4S, S)
//
// and writes dxp = dg (T, B, 4S), zero at masked steps.  c_prev is c_out
// shifted one step towards the scan start (zeros at the first step); the
// forward emits the carried state at a masked step, so it is what the
// Pallas kernel sees.  At a masked step dh_eff = dc_eff = 0 multiply the
// saved gates, which the forward computed from the carried state, so they
// are finite and the step passes (dht, dc) through exactly.
//
// Why the gates are saved here although the Pallas kernel recomputes them
// (pallas_lstm.py:137): on the TPU the recompute ran on the MXU beside the
// step's other product; here it was half of the step's FMAs and two of its
// four barriers, on the critical path of a latency-bound loop.  The trace
// costs the forward one (T, B, 4S) stream of stores (51 MB at T = 500,
// B = 100, S = 64) and replaces xp among the tensors kept for the backward;
// tanh(c') is recomputed from c_out here, off the product's path.
//
// What bounds it.  T dependent steps of 4 S^2 FMAs a row: the latency of a
// step, now one product and one barrier.  On an H100 the step (1.0-1.1 us
// at S = 64, one row a block) costs what lstm_fwd.cu's inference step
// costs, with half its barriers.  Its clocked split (bench_lstm, ~1,840
// cycles): the refill's address and loop code ~40%, even in the warps that
// copy nothing; the product ~26%, at the shared-memory pipe's rate (256
// threads each read a 64-float operand quarter, 64 KB a step at 128 bytes
// a clock); the cell ~22%; the barrier, the slot wait and the commit under
// 8% together.  Not the FMAs.  The design:
//
// - One block owns BR batch rows for all T steps (the fewest that fit the
//   batch in one wave over the SMs; nn/fused_lstm.py::lstm_bwd_plan), so
//   the carried (dh, dc) stay in registers.
// - Thread j = 4s + q sums the q-th quarter of dg . sW for state column s:
//   sWT[s, qS:(q+1)S], S floats, which it holds in registers at the model's
//   width (mode REG, S <= 64: 64 floats a thread at 8 warps).  The four
//   quarters of a column sit in one warp and are joined by two shuffles in
//   a fixed order, so all four threads hold the same dh_s; each then runs
//   the cell backward of column s (the same arithmetic on the same values)
//   and stores its own quarter of dg.  dg is double-buffered in shared
//   memory, so one barrier a step separates the cell from the product.
//   Below S = 33, and from 65 while it fits, sWT is staged in shared memory
//   instead; past that it is read through L1.  Threads are 4S, so S <= 256.
// - Inputs arrive through a ring of NS (2-4) step slots in shared memory,
//   filled with cp.async NS-1 steps ahead: the gates, c_out at the step and
//   the step before, g and the mask words.  The step is a rolled loop.
// - 4 / BR partial sums a quarter, joined in a fixed order; no atomics, so
//   every run gives the same bits.
//
// The weight cotangents are left to lstm_wgrad.cu: an S x 4S rank-BR update
// each step would lengthen the critical path.  Plain f32 FMA: no TF32 and
// no fast-math.
#include "recurrence.cuh"

#ifdef LSTM_BWD_CLOCKS
// Step-phase clocks, for scripts/bench_lstm.py --clocks, which also builds
// this source with -DLSTM_BWD_CLOCKS into a library of its own (the kernels
// the port launches are built without it).  Lane 0 of each warp of block 0
// sums, over the T steps, the SM clock cycles of the step's phases: the
// cell (C), the wait for the next slot, the barrier, the refill's copies,
// its commit, the product (D), the shuffles; then the whole loop.
__device__ long long lstm_bwd_clocks[32 * 8];
#define STEP_CLOCK(k) PHASE_CLOCK(k)
#else
#define STEP_CLOCK(k) \
  do {                \
  } while (0)
#endif

namespace {

// start the copies of the scan step at time t into a ring slot: the gates
// [BR][4S], c_out at t [BR][S], c_prev [BR][S] (c_out at time tp; zeros
// when tp < 0, the scan's first step), g [BR][S] and the int32 mask words
// [BR]; the caller commits the group.  Rows past the batch are never
// written: they stay zero.
template <int BR>
__device__ __forceinline__ void fetch_step(
    float* slot, const float* __restrict__ gates,
    const float* __restrict__ c_out, const float* __restrict__ g,
    const int* __restrict__ mask, int t, int tp, int B, int b0, int nrows,
    int S, int vec) {
  const size_t row0 = (size_t)t * B + b0;
  const int n = nrows * S;
  copy_async(slot, gates + row0 * 4 * S, 4 * n, vec);
  copy_async(slot + BR * 4 * S, c_out + row0 * S, n, vec);
  float* cp = slot + BR * 5 * S;
  if (tp >= 0) {
    copy_async(cp, c_out + ((size_t)tp * B + b0) * S, n, vec);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) cp[i] = 0.0f;
  }
  copy_async(slot + BR * 6 * S, g + row0 * S, n, vec);
  int* m = reinterpret_cast<int*>(slot + BR * 7 * S);
  for (int i = threadIdx.x; i < nrows; i += blockDim.x)
    cp_async4(m + i, mask + row0 + i);
}

// KQ (0 or >= S): the floats of its quarter row a thread holds in
// registers; otherwise the weights come from shared memory when `stage`,
// else through L1.  qs: the floats between two quarters of dg in shared
// memory (padded so that the four quarters' reads fall in other banks)
template <int BR, int KQ>
__global__ void __launch_bounds__(KQ > 0 ? 4 * KQ : 1024)
lstm_bwd_kernel(const float* __restrict__ gates,
                const float* __restrict__ c_out,
                const float* __restrict__ g, const int* __restrict__ mask,
                const float* __restrict__ sWT, const float* __restrict__ p,
                float* __restrict__ dxp, int T, int B, int S, int reverse,
                int ns, int stage, int qs, int vec) {
  extern __shared__ float4 smem4[];
  const int S4 = 4 * S;
  const int KK = KQ > 0 ? KQ : round4(S);           // k-range of a quarter
  const int slot_len = round4(BR * 7 * S + BR);
  float* ring = reinterpret_cast<float*>(smem4);    // [ns][slot_len]
  float* dgb = ring + ns * slot_len;                // [2][4][qs]: [k][BR]
  float* ws = dgb + 8 * qs;                         // [KK][S][4] if staged
  const int j = threadIdx.x;
  const int b0 = blockIdx.x * BR;
  const int nrows = min(BR, B - b0);
  // the four threads j = 4s + q own state column s; threads past 4S (when
  // 4S is not a multiple of 32) compute on column 0's weights and store
  // nothing
  const int s = j >> 2, q = j & 3;
  const bool own = j < S4;
  const int sw = own ? s : 0;

  // the ring and dg start at zero: rows past the batch and k past S are
  // never written
  const int nzero = ns * slot_len + 8 * qs;
  for (int i = j; i < nzero; i += blockDim.x) ring[i] = 0.0f;
  if (KQ == 0 && stage) {
    // ws[(k * S + ss) * 4 + qq] = sWT[ss][qq S + k]: the threads of a warp
    // read neighbouring words
    for (int i = j; i < 4 * S * KK; i += blockDim.x) {
      const int qq = i & 3, ks = i >> 2;
      const int k = ks / S, ss = ks - k * S;
      ws[i] = k < S ? sWT[(size_t)ss * S4 + qq * S + k] : 0.0f;
    }
  }
  float w[KQ > 0 ? KQ : 1];
  if constexpr (KQ > 0) {
#pragma unroll
    for (int k = 0; k < KQ; ++k)
      w[k] = (own && k < S) ? __ldg(sWT + (size_t)s * S4 + q * S + k) : 0.0f;
  }
  float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f;
  if (own) {
    p0 = p[s];
    p1 = p[S + s];
    p2 = p[2 * S + s];
  }
  __syncthreads();

  // scan step f of the backward (the forward's steps, last first): its time
  // and the time of its c_prev (-1 at the forward scan's first step)
  auto time_of = [&](int f) { return reverse ? f : T - 1 - f; };
  auto prev_of = [&](int t) {
    return reverse ? (t + 1 < T ? t + 1 : -1) : t - 1;
  };
  for (int f = 0; f < ns; ++f) {
    if (f < T) {
      const int t = time_of(f);
      fetch_step<BR>(ring + f * slot_len, gates, c_out, g, mask, t,
                     prev_of(t), B, b0, nrows, S, vec);
    }
    cp_async_commit();
  }
  cp_async_wait_pending(ns - 1);   // the first step's slot has landed
  __syncthreads();

  // carried cotangents of column s (the same in its four threads)
  float dh[BR], dc[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) dh[r] = dc[r] = 0.0f;
  int cur = 0;
#ifdef LSTM_BWD_CLOCKS
  PHASE_CLOCK_START();
#endif
  for (int st = 0; st < T; ++st) {
    const int t = time_of(st);
    float* slot = ring + cur * slot_len;
    float* dg = dgb + (st & 1) * 4 * qs;
    const float* cns = slot + BR * 4 * S;
    const float* cps = slot + BR * 5 * S;
    const float* gs = slot + BR * 6 * S;
    const int* ms = reinterpret_cast<const int*>(slot + BR * 7 * S);

    // (C) the cell backward of column s; thread q stores dg's quarter q
    float pass[BR];            // what a masked step passes straight to dh
#pragma unroll
    for (int r = 0; r < BR; ++r) pass[r] = 0.0f;
    if (own) {
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const float* gt = slot + r * S4 + s;
        const float u = gt[0], i = gt[S], f = gt[2 * S], o = gt[3 * S];
        const float tc = tanhf(cns[r * S + s]);
        const float c = cps[r * S + s];
        const bool valid = ms[r] != 0;
        const float dht = dh[r] + gs[r * S + s];
        const float dct = dc[r];
        const float dhe = valid ? dht : 0.0f;
        const float dce = valid ? dct : 0.0f;
        const float dg3 = dhe * tc * o * (1.0f - o);
        const float dcn = dce + dhe * o * (1.0f - tc * tc) + dg3 * p2;
        const float dg0 = dcn * i * (1.0f - u * u);
        const float dg1 = dcn * u * i * (1.0f - i);
        const float dg2 = dcn * c * f * (1.0f - f);
        dc[r] = dcn * f + dg1 * p0 + dg2 * p1 + (valid ? 0.0f : dct);
        pass[r] = valid ? 0.0f : dht;
        const float mine = q == 0 ? dg0 : q == 1 ? dg1 : q == 2 ? dg2 : dg3;
        dg[q * qs + s * BR + r] = mine;
        if (r < nrows)
          dxp[((size_t)t * B + b0 + r) * S4 + q * S + s] = mine;
      }
    }
    STEP_CLOCK(0);
    // the next step's slot has landed; every thread has left this one
    cp_async_wait_pending(ns - 2);
    STEP_CLOCK(1);
    __syncthreads();
    STEP_CLOCK(2);
    {
      const int f = st + ns;
      if (f < T) {
        const int tf = time_of(f);
        fetch_step<BR>(slot, gates, c_out, g, mask, tf, prev_of(tf), B, b0,
                       nrows, S, vec);
      }
      STEP_CLOCK(3);
      cp_async_commit();
      cur = cur + 1 == ns ? 0 : cur + 1;
    }
    STEP_CLOCK(4);

    // (D) quarter q of dg . sW for column s, then the four quarters joined
    float acc[BR];
    const float* v = dg + q * qs;
    if constexpr (KQ > 0) {
      dot_reg<BR, KQ>(acc, v, w);
    } else if (stage) {
      dot_col<BR>(acc, v, [&](int k) { return ws[(k * S + sw) * 4 + q]; },
                 KK);
    } else {
      dot_col<BR>(acc, v,
                 [&](int k) {
                   return k < S ? __ldg(sWT + (size_t)sw * S4 + q * S + k)
                                : 0.0f;
                 },
                 KK);
    }
    STEP_CLOCK(5);
    // (a0 + a1) + (a2 + a3) in every thread of the four
#pragma unroll
    for (int r = 0; r < BR; ++r)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 1);
#pragma unroll
    for (int r = 0; r < BR; ++r)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 2);
    if (own) {
#pragma unroll
      for (int r = 0; r < BR; ++r) dh[r] = acc[r] + pass[r];
    }
    STEP_CLOCK(6);
    // the next step's (C) writes the other dg buffer and reads its own
    // slot, which landed before the barrier above
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#ifdef LSTM_BWD_CLOCKS
  clk[7] = PHASE_CLOCK_TOTAL();
  if (blockIdx.x == 0 && (j & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) lstm_bwd_clocks[(j >> 5) * 8 + k] = clk[k];
  }
#endif
}

template <int BR, int KQ>
int launch(const void* gates, const void* c_out, const void* g,
           const void* mask, const void* sWT, const void* p, void* dxp,
           int T, int B, int S, int reverse, int ns, int stage, int qs,
           int smem, int threads, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_bwd_kernel<BR, KQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec = S % 4 == 0 && (uintptr_t)gates % 16 == 0 &&
                  (uintptr_t)c_out % 16 == 0 && (uintptr_t)g % 16 == 0;
  lstm_bwd_kernel<BR, KQ><<<(B + BR - 1) / BR, threads, smem, stream>>>(
      (const float*)gates, (const float*)c_out, (const float*)g,
      (const int*)mask, (const float*)sWT, (const float*)p, (float*)dxp, T,
      B, S, reverse, ns, stage, qs, vec);
  return (int)cudaGetLastError();
}

template <int KQ>
int by_rows(int br, const void* gates, const void* c_out, const void* g,
            const void* mask, const void* sWT, const void* p, void* dxp,
            int T, int B, int S, int reverse, int ns, int stage, int qs,
            int smem, int threads, cudaStream_t s) {
#define LSTM_BWD_LAUNCH(BR)                                                \
  launch<BR, KQ>(gates, c_out, g, mask, sWT, p, dxp, T, B, S, reverse, ns, \
                 stage, qs, smem, threads, s)
  switch (br) {
    case 1: return LSTM_BWD_LAUNCH(1);
    case 2: return LSTM_BWD_LAUNCH(2);
    case 4: return LSTM_BWD_LAUNCH(4);
    case 8: return LSTM_BWD_LAUNCH(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LSTM_BWD_LAUNCH
}

}  // namespace

// The launch plan comes from the caller (nn/fused_lstm.py::lstm_bwd_plan):
// rows a block br (1, 2, 4, 8), the register floats kq (64, or 0), stage
// (sWT in shared memory when not in registers), ring depth ns (2-4), the
// quarter stride qs of dg, smem bytes and threads (4S rounded up to a
// warp).  gates is the forward's (T, B, 4S) trace, mask (T, B) int32.
extern "C" int lstm_bwd(const void* gates, const void* c_out, const void* g,
                        const void* mask, const void* sWT, const void* p,
                        void* dxp, int T, int B, int S, int reverse, int br,
                        int kq, int stage, int ns, int qs, int smem,
                        int threads, void* stream) {
  if (ns < 2 || ns > 4 || threads < 4 * S || (kq > 0 && kq < S) ||
      qs % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (kq == 64)
    return by_rows<64>(br, gates, c_out, g, mask, sWT, p, dxp, T, B, S,
                       reverse, ns, stage, qs, smem, threads, s);
  if (kq == 0)
    return by_rows<0>(br, gates, c_out, g, mask, sWT, p, dxp, T, B, S,
                      reverse, ns, stage, qs, smem, threads, s);
  return (int)cudaErrorInvalidValue;
}

#ifdef LSTM_BWD_CLOCKS
// copy the step-phase clocks of the last launch, [warp][8], to host
// memory
extern "C" int lstm_bwd_clocks_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, lstm_bwd_clocks,
                                   sizeof(lstm_bwd_clocks));
}
#endif
