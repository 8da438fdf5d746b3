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
// that stream.  Both are one template, EMIT_C: a runtime branch cost
// gru_fwd.cu's inference variant 2-5%.  Given a `gates` buffer the training
// variant also writes the gate trace gates (T, B, 4S) = [u, i, f, o] (u =
// tanh(g0), the activated candidate; i, f, o the activated gates), which
// csrc/lstm_bwd.cu reads instead of recomputing the gates; tanh(c') is not
// stored, the backward takes it from c_out.  The cell computes its gates at
// masked steps too, from the carried (h, c), so every entry is finite.
//
// Design.  One block owns BR batch rows and walks all T steps, so the
// sequential dependency stays inside the block (the plan,
// nn/fused_lstm.py::lstm_fwd_plan, takes the fewest rows a block that fit
// the batch in one wave over the SMs).  A step:
//
// - Lane j = 4s + q owns gate column qS + s: it sums column qS + s of
//   h . sWT for the block's rows.  At the model's width (mode "registers",
//   S from 33 to 64) the lane holds that column's S weights in registers, 64
//   floats; otherwise they come from shared memory (staged in lane order,
//   so a warp reads consecutive words) or through L1.  h is double-buffered
//   in shared memory, k-major ([k][BR]), and every lane of a warp reads the
//   same 16 bytes at once (a broadcast): a step's product reads S floats a
//   warp a row, not S floats a thread.  4 / BR partial sums, joined in a
//   fixed order: the same bits on every run.
// - The four pre-activations of state s sit in one quad of lanes.  Lane q
//   applies its own activation (q 0: u = tanh(g0); 1: i = sigmoid(g1 +
//   c p0); 2: f = sigmoid(g2 + c p1); 3 keeps g3), four shuffles give every
//   lane of the quad all four, and each lane computes c', o and h' (the same
//   values in the four: the carried c and h stay in registers).  Lane 0 of
//   the quad writes h' to the other h buffer; then the step's one
//   __syncthreads().
// - xp arrives through a ring of NS step slots in shared memory: one
//   thread issues one bulk asynchronous copy a step (cp.async.bulk, the
//   block's BR rows of xp_t, 1 KB at S = 64 and one row a block) on the
//   slot's mbarrier NS - 1 steps ahead; a lane waits on the barrier's phase
//   and reads its own element.  The step's barrier frees the slot, so the
//   refill is issued right after it.  The mask is staged in shared memory
//   a window of steps at a time (all T steps at the event paths' shapes).
// - The global stores (h_out, c_out and the gate trace) follow the barrier,
//   off the step's path.
//
// What bounds it.  The recurrence is T dependent steps of little work per
// row (4 S^2 FMAs), so the latency of one block's step bounds the kernel,
// not bandwidth or arithmetic.  With the weights staged in shared memory
// and a thread a column, the product took 58% of a step (PERF.md §6): 1,024
// shared-memory wavefronts (every thread read its 64 weights and 64 h
// values a word at a time), which registers and broadcasts cut to 128.
// Threads are 4S, so S <= 256; wider cells (S 257-384, bonito's LSTMs of
// 384, inference only) go to csrc/lstm_fwd_wide.cu, a cluster of blocks
// that split the gate columns.
//
// Sums are plain f32 FMA: no TF32 and no fast-math (expf/tanhf are the
// accurate versions).
#include "recurrence.cuh"

#ifdef LSTM_FWD_CLOCKS
// Step-phase clocks (scripts/bench_lstm.py --clocks builds this source with
// -DLSTM_FWD_CLOCKS into a library of its own): lane 0 of each warp of
// block 0 sums, over the T steps, the SM clock cycles of the product, the
// wait for the step's slot (and the read of xp), the lane's activation, the
// shuffles and the cell, the barrier, and the refill with the stores; then
// the whole loop.  A wait at a barrier shows in the phase of the first
// memory access after it.
__device__ long long lstm_fwd_clocks[32 * 8];
#define FWD_CLOCK(k) PHASE_CLOCK(k)
#else
#define FWD_CLOCK(k) \
  do {               \
  } while (0)
#endif

namespace {

constexpr int kMaxSlots = 4;
constexpr int kBarFloats = 16;          // the slots' mbarriers, 64 bytes

// KQ (0 or >= S): the weights of its column a lane holds in registers;
// otherwise they come from shared memory when `stage`, else through L1.
// ns: ring slots (2-4); mw: steps of the mask window
template <int BR, int KQ, bool EMIT_C>
__global__ void __launch_bounds__(KQ > 0 ? 4 * KQ : 1024)
lstm_fwd_kernel(const float* __restrict__ xp,
                const uint8_t* __restrict__ mask,
                const float* __restrict__ sWT, const float* __restrict__ p,
                float* __restrict__ h_out, float* __restrict__ c_out,
                float* __restrict__ gates, int T, int B, int S, int reverse,
                int ns, int mw, int stage) {
  extern __shared__ float4 smem4[];
  const int S4 = 4 * S;
  const int KK = KQ > 0 ? KQ : round4(S);            // k-rows of an h buffer
  const int slot_len = BR * S4;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);         // [ns]
  float* ring = reinterpret_cast<float*>(smem4) + kBarFloats;  // [ns][BR][4S]
  float* hb = ring + ns * slot_len;                  // [2][KK][BR]
  float* ws = hb + 2 * KK * BR;                      // [S][4S] if staged
  uint8_t* mks = reinterpret_cast<uint8_t*>(
      ws + (KQ == 0 && stage ? S * S4 : 0));         // [mw][BR]
  const int j = threadIdx.x;
  const int b0 = blockIdx.x * BR;
  const int nrows = min(BR, B - b0);
  // lanes past 4S (when 4S is not a multiple of 32) compute on state 0's
  // columns and store nothing
  const int s = j >> 2, q = j & 3;
  const bool own = j < S4;
  const int col = q * S + (own ? s : 0);
  const int jw = own ? j : q;
  const int base = (j & 31) & ~3;                    // the quad's lane 0
  const unsigned bytes = (unsigned)(nrows * S4) * 4u;
  auto time_of = [&](int step) { return reverse ? T - 1 - step : step; };

  // the ring and both h buffers start at zero: rows past the batch and k
  // past S are never written
  for (int i = j; i < ns * slot_len + 2 * KK * BR; i += blockDim.x)
    ring[i] = 0.0f;
  if (KQ == 0 && stage) {
    // ws[k][4 s + q] = sWT[k][q S + s]: lane order
    for (int i = j; i < S * S4; i += blockDim.x) {
      const int k = i / S4, jj = i - k * S4;
      ws[i] = sWT[(size_t)k * S4 + (jj & 3) * S + (jj >> 2)];
    }
  }
  float w[KQ > 0 ? KQ : 1];
  if constexpr (KQ > 0) {
#pragma unroll
    for (int k = 0; k < KQ; ++k)
      w[k] = (own && k < S) ? __ldg(sWT + (size_t)k * S4 + col) : 0.0f;
  }
  float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f;
  if (own) {
    p0 = p[s];
    p1 = p[S + s];
    p2 = p[2 * S + s];
  }
  const float pq = q == 1 ? p0 : p1;                 // lanes 1 and 2
  if (j == 0) {
    for (int f = 0; f < ns; ++f) mbar_init(&full[f], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (j == 0) {
    fence_proxy_async();          // the zeros above come before the copies
    for (int f = 0; f < ns && f < T; ++f) {
      mbar_expect_tx(&full[f], bytes);
      bulk_copy(ring + f * slot_len, xp + ((size_t)time_of(f) * B + b0) * S4,
                bytes, &full[f]);
    }
  }

  // the carried state of column s (the same in the quad's four lanes)
  float c[BR], h[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) c[r] = h[r] = 0.0f;
  int slot = 0, mleft = 0, mi = 0;
  unsigned phase = 0;
#ifdef LSTM_FWD_CLOCKS
  PHASE_CLOCK_START();
#endif
  for (int step = 0; step < T; ++step) {
    if (mleft == 0) {
      // the next window of the mask: the last one was last read before the
      // previous step's barrier
      const int n = min(mw, T - step) * BR;
      for (int i = j; i < n; i += blockDim.x) {
        const int st = i / BR, r = i - st * BR;
        mks[i] = b0 + r < B ? mask[(size_t)time_of(step + st) * B + b0 + r]
                            : (uint8_t)0;
      }
      mleft = mw;
      mi = 0;
      __syncthreads();
    }
    const float* hv = hb + (step & 1) * KK * BR;
    float* hn = hb + ((step & 1) ^ 1) * KK * BR;

    // column col of h . sWT for the block's rows
    float acc[BR];
    if constexpr (KQ > 0) {
      dot_reg<BR, KQ>(acc, hv, w);
    } else if (stage) {
      dot_col<BR>(acc, hv, [&](int k) { return ws[k * S4 + jw]; }, S);
    } else {
      dot_col<BR>(acc, hv,
                  [&](int k) { return __ldg(sWT + (size_t)k * S4 + col); },
                  S);
    }
    FWD_CLOCK(0);
    mbar_wait(&full[slot], phase);
    float g[BR];
    const float* xs = ring + slot * slot_len + col;
#pragma unroll
    for (int r = 0; r < BR; ++r) g[r] = xs[r * S4] + acc[r];
    FWD_CLOCK(1);

    // this lane's activation: u, i, f, or g3 as it is
    float mine[BR];
    if (q == 0) {
#pragma unroll
      for (int r = 0; r < BR; ++r) mine[r] = tanhf(g[r]);
    } else if (q < 3) {
#pragma unroll
      for (int r = 0; r < BR; ++r) mine[r] = sigmoid_f32(g[r] + c[r] * pq);
    } else {
#pragma unroll
      for (int r = 0; r < BR; ++r) mine[r] = g[r];
    }
    FWD_CLOCK(2);
    const uint8_t* valid = mks + mi * BR;
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      const float u = __shfl_sync(0xffffffffu, mine[r], base);
      const float i = __shfl_sync(0xffffffffu, mine[r], base + 1);
      const float f = __shfl_sync(0xffffffffu, mine[r], base + 2);
      const float g3 = __shfl_sync(0xffffffffu, mine[r], base + 3);
      const float cn = c[r] * f + u * i;
      const float o = sigmoid_f32(g3 + cn * p2);
      const float hnew = tanhf(cn) * o;
      if (q == 3) mine[r] = o;
      if (valid[r]) {
        h[r] = hnew;
        c[r] = cn;
      }
    }
    if (q == 0 && own) {
#pragma unroll
      for (int r = 0; r < BR; ++r) hn[s * BR + r] = h[r];
    }
    FWD_CLOCK(3);
    __syncthreads();
    FWD_CLOCK(4);
    // every lane has read the slot: refill it with the step NS ahead
    if (j == 0 && step + ns < T) {
      mbar_expect_tx(&full[slot], bytes);
      bulk_copy(ring + slot * slot_len,
                xp + ((size_t)time_of(step + ns) * B + b0) * S4, bytes,
                &full[slot]);
    }
    if (own) {
      const size_t row0 = (size_t)time_of(step) * B + b0;
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        if (r < nrows) {
          if (q == 0) h_out[(row0 + r) * S + s] = h[r];
          if constexpr (EMIT_C) {
            if (q == 1) c_out[(row0 + r) * S + s] = c[r];
            if (gates != nullptr) gates[(row0 + r) * S4 + col] = mine[r];
          }
        }
      }
    }
    if (++slot == ns) {
      slot = 0;
      phase ^= 1u;
    }
    --mleft;
    ++mi;
    FWD_CLOCK(5);
  }
#ifdef LSTM_FWD_CLOCKS
  clk[7] = PHASE_CLOCK_TOTAL();
  if (blockIdx.x == 0 && (j & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) lstm_fwd_clocks[(j >> 5) * 8 + k] = clk[k];
  }
#endif
}

template <int BR, int KQ, bool EMIT_C>
int launch(const void* xp, const void* mask, const void* sWT, const void* p,
           void* h_out, void* c_out, void* gates, int T, int B, int S,
           int reverse, int ns, int mw, int stage, int smem, int threads,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_fwd_kernel<BR, KQ, EMIT_C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  lstm_fwd_kernel<BR, KQ, EMIT_C>
      <<<(B + BR - 1) / BR, threads, smem, stream>>>(
          (const float*)xp, (const uint8_t*)mask, (const float*)sWT,
          (const float*)p, (float*)h_out, (float*)c_out, (float*)gates, T, B,
          S, reverse, ns, mw, stage);
  return (int)cudaGetLastError();
}

template <int KQ, bool EMIT_C>
int by_rows(int br, const void* xp, const void* mask, const void* sWT,
            const void* p, void* h_out, void* c_out, void* gates, int T,
            int B, int S, int reverse, int ns, int mw, int stage, int smem,
            int threads, cudaStream_t s) {
#define LSTM_FWD_LAUNCH(BR)                                               \
  launch<BR, KQ, EMIT_C>(xp, mask, sWT, p, h_out, c_out, gates, T, B, S, \
                         reverse, ns, mw, stage, smem, threads, s)
  switch (br) {
    case 1: return LSTM_FWD_LAUNCH(1);
    case 2: return LSTM_FWD_LAUNCH(2);
    case 4: return LSTM_FWD_LAUNCH(4);
    case 8: return LSTM_FWD_LAUNCH(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LSTM_FWD_LAUNCH
}

template <bool EMIT_C>
int by_mode(int kq, int br, const void* xp, const void* mask,
            const void* sWT, const void* p, void* h_out, void* c_out,
            void* gates, int T, int B, int S, int reverse, int ns, int mw,
            int stage, int smem, int threads, cudaStream_t s) {
  if (kq == 64)
    return by_rows<64, EMIT_C>(br, xp, mask, sWT, p, h_out, c_out, gates, T,
                               B, S, reverse, ns, mw, stage, smem, threads, s);
  if (kq == 0)
    return by_rows<0, EMIT_C>(br, xp, mask, sWT, p, h_out, c_out, gates, T,
                              B, S, reverse, ns, mw, stage, smem, threads, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The launch plan comes from the caller (nn/fused_lstm.py::lstm_fwd_plan):
// rows a block br (1, 2, 4, 8), the register floats kq (64, or 0), stage
// (sWT in shared memory when not in registers), ring depth ns (2-4), mask
// window mw (steps), smem bytes and threads (4S rounded up to a warp).  xp
// 16-byte aligned.  c_out == nullptr selects the inference variant (no cell
// trace, and gates must be nullptr); gates == nullptr leaves out the gate
// trace.
extern "C" int lstm_fwd(const void* xp, const void* mask, const void* sWT,
                        const void* p, void* h_out, void* c_out, void* gates,
                        int T, int B, int S, int reverse, int br, int kq,
                        int stage, int ns, int mw, int smem, int threads,
                        void* stream) {
  if (ns < 2 || ns > kMaxSlots || mw < 1 || threads < 4 * S ||
      threads % 32 || (kq > 0 && kq < S) || (uintptr_t)xp % 16 ||
      (c_out == nullptr && gates != nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (c_out == nullptr)
    return by_mode<false>(kq, br, xp, mask, sWT, p, h_out, c_out, gates, T, B,
                          S, reverse, ns, mw, stage, smem, threads, s);
  return by_mode<true>(kq, br, xp, mask, sWT, p, h_out, c_out, gates, T, B, S,
                       reverse, ns, mw, stage, smem, threads, s);
}

#ifdef LSTM_FWD_CLOCKS
// copy the step-phase clocks of the last launch, [warp][8], to host memory
extern "C" int lstm_fwd_clocks_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, lstm_fwd_clocks,
                                   sizeof(lstm_fwd_clocks));
}
#endif
