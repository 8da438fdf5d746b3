// GRU backward recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sloika_tpu/nn/pallas_gru.py::_bwd_kernel
// (driven by _pallas_scan_bwd and the VJP _bwd), all but its weight
// cotangent sums, which csrc/gru_wgrad.cu takes over.  It walks the forward
// scan backwards and, at each step, reads the gates [z, r, hbar] that the
// forward's training variant saved (csrc/gru_fwd.cu, EMIT_G),
//
//     dht   = dh + g_t;  dh_eff = mask ? dht : 0
//     dz    = dh_eff (h_prev - hbar) z (1 - z)
//     da    = dh_eff (1 - z) (1 - hbar^2)
//     drh   = da . sW2                          sW2 = sW2T^T (S, S)
//     dr    = drh h_prev r (1 - r)
//     dh    = dh_eff z + drh r + dz . sW[:S] + dr . sW[S:]  (+ dht where
//                                                masked)   sW = sWT^T (2S, S)
//
// and writes dxp = mask ? [dz, dr, da] : 0 (T, B, 3S) and r * h_prev
// (T, B, S), the one extra buffer gru_wgrad.cu needs (the forward does not
// write it: it is formed here from r and h_prev, off the critical path).
// h_prev is h_out shifted one step towards the scan start (zeros at the
// first step); the forward emits the carried state at a masked step, so
// h_prev there is the carried state, as the Pallas kernel sees it.  At a
// masked step dh_eff = 0 multiplies the saved gates, which the forward
// computed from the carried state, so they are finite and the step passes
// dht through exactly.
//
// Why the gates are saved here although the Pallas kernel recomputes them
// ("cheaper than saving them", pallas_gru.py:162): on the TPU the recompute
// ran on the MXU beside the step's other products; here it was half of the
// step's FMAs and two of its four barriers, on the critical path of a
// latency-bound loop.  The trace costs the forward one (T, B, 3S) stream of
// stores (46 MB at T = 400, B = 100, S = 96: ~14 us at 3.35 TB/s)
// and replaces xp among the tensors kept for the backward.
//
// What bounds it.  T dependent steps of little work per row: the latency of
// a step.  A step is now two all-to-all exchanges through shared memory and
// two barriers: (dz, da) -> barrier A -> drh and dz . sW[:S] -> dr ->
// barrier B -> dr . sW[S:] -> dh.  On an H100 it takes about as long as
// the forward's step (1.2 us at S = 96, one row a block; bench_gru), and
// so does lstm_bwd.cu's with less than half the FMAs: what a thread issues
// a step (ring copies, the elementwise work, the products' operand loads,
// shuffles, stores) on a few warps bounds it, not the FMAs.  The design:
//
// - One block owns BR batch rows for all T steps, so the carried dh stays
//   in registers.  BR (1, 2, 4 or 8) is the fewest rows that fit the batch
//   in one wave over the SMs (nn/fused_gru.py::gru_bwd_plan).
// - All 2S threads work in every product.  The pair (2c, 2c+1) owns state
//   column c: after barrier A thread 2c sums drh_c = da . sW2T[c, :] and
//   thread 2c+1 sums e1_c = dz . sWT[c, :S] (the dz half of the last
//   product, which does not wait for drh), and one shuffle swaps them.
//   After barrier B the pair splits dr . sWT[c, S:] over its two halves of
//   k, joined with one shuffle; both threads then hold the same dh_c.
// - Weights in registers at the models' widths (mode REG, S <= 112): a
//   thread holds KA = S floats of its first product's row and KB = S/2 of
//   the second's, 144 a thread at S = 96, so the products read only the
//   broadcast operands from shared memory.  At S = 144 (9 warps, 168
//   registers a thread) the second product's 72 stay in registers and the
//   first's rows are staged in shared memory; below S = 73 both are staged;
//   past S = 144 what does not fit is read through L1.
// - Inputs arrive through a ring of NS (2-4) step slots in shared memory,
//   filled with cp.async NS-1 steps ahead: the gates, h_prev, g and the
//   mask words of a step.  A step waits only for the slot of the step after
//   it, before barrier B.  The step is a rolled loop.
// - 4 / BR partial sums a column, joined in a fixed order; no atomics, so
//   every run gives the same bits.
//
// Sums are plain f32 FMA: no TF32 and no fast-math.
#include "recurrence.cuh"

namespace {

// threads a block at most, for __launch_bounds__ (2S rounded up to a warp).
// It sets the registers a thread may take: 255 at 6-7 warps, 168 at 9
template <int KA, int KB>
struct MaxThreads {
  static constexpr int value = KA > 0 ? (2 * KA + 31) / 32 * 32
                               : KB > 0 ? (4 * KB + 31) / 32 * 32 : 512;
};

// start the copies of the scan step at time t into a ring slot: the gates
// [BR][3S], h_prev [BR][S] (h_out at time tp; zeros when tp < 0, the scan's
// first step), g [BR][S] and the int32 mask words [BR]; the caller commits
// the group.  Rows past the batch are never written: they stay zero.
template <int BR>
__device__ __forceinline__ void fetch_step(
    float* slot, const float* __restrict__ gates,
    const float* __restrict__ h_out, const float* __restrict__ g,
    const int* __restrict__ mask, int t, int tp, int B, int b0, int nrows,
    int S, int vec) {
  const size_t row0 = (size_t)t * B + b0;
  const int n = nrows * S;
  copy_async(slot, gates + row0 * 3 * S, 3 * n, vec);
  float* hp = slot + BR * 3 * S;
  if (tp >= 0) {
    copy_async(hp, h_out + ((size_t)tp * B + b0) * S, n, vec);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) hp[i] = 0.0f;
  }
  copy_async(slot + BR * 4 * S, g + row0 * S, n, vec);
  int* m = reinterpret_cast<int*>(slot + BR * 5 * S);
  for (int i = threadIdx.x; i < nrows; i += blockDim.x)
    cp_async4(m + i, mask + row0 + i);
}

// KA (0 or >= S): the floats of the first product's row a thread holds in
// registers (thread 2c: sW2T[c, :], thread 2c+1: sWT[c, :S]); KB (0 or
// >= S/2): those of its half of the second product's row (sWT[c, S:]).
// Weights not in registers are read from shared memory where `stage` bit 0
// (first product) or bit 1 (second) says they were staged, else through L1.
template <int BR, int KA, int KB>
__global__ void __launch_bounds__(MaxThreads<KA, KB>::value)
gru_bwd_kernel(const float* __restrict__ gates,
               const float* __restrict__ h_out,
               const float* __restrict__ g, const int* __restrict__ mask,
               const float* __restrict__ sWT, const float* __restrict__ sW2T,
               float* __restrict__ dxp, float* __restrict__ rh, int T, int B,
               int S, int reverse, int ns, int stage, int vec) {
  constexpr int NP = Parts<BR>::NP;
  extern __shared__ float4 smem4[];
  const int S2 = 2 * S, S3 = 3 * S;
  const int KD = KA > 0 ? KA : round4(S);           // k-range, first product
  const int KH = KB > 0 ? KB : round4((S + 1) / 2); // a half of the second
  const bool stage_a = KA == 0 && (stage & 1);
  const bool stage_b = KB == 0 && (stage & 2);
  const int slot_len = round4(BR * 5 * S + BR);
  float* ring = reinterpret_cast<float*>(smem4);    // [ns][slot_len]
  float* dv = ring + ns * slot_len;                 // [KD/NP][2][NP][BR]
  float* drT = dv + 2 * KD * BR;                    // [2KH][BR]  dr
  float* wsa = drT + 2 * KH * BR;                   // [KD][S][2]
  float* wsb = wsa + (stage_a ? 2 * S * KD : 0);    // [KH][S][2]
  const int j = threadIdx.x;
  const int b0 = blockIdx.x * BR;
  const int nrows = min(BR, B - b0);
  // the pair (2c, 2c + 1) owns state column c; threads past 2S (when 2S is
  // not a multiple of 32) compute on column 0's weights and store nothing
  const int c = j >> 1, half = j & 1;
  const bool on = j < S2;
  const int cw = on ? c : 0;

  // the ring and the operands start at zero: rows past the batch and k
  // past S are never written
  const int nzero = ns * slot_len + 2 * KD * BR + 2 * KH * BR;
  for (int i = j; i < nzero; i += blockDim.x) ring[i] = 0.0f;
  if (stage_a) {
    // wsa[(k * S + cc) * 2 + h]: the threads of a warp read neighbouring
    // words
    for (int i = j; i < 2 * S * KD; i += blockDim.x) {
      const int h = i & 1, kc = i >> 1;
      const int k = kc / S, cc = kc - k * S;
      wsa[i] = k >= S ? 0.0f
               : h ? sWT[(size_t)cc * S2 + k] : sW2T[(size_t)cc * S + k];
    }
  }
  if (stage_b) {
    for (int i = j; i < 2 * S * KH; i += blockDim.x) {
      const int h = i & 1, kc = i >> 1;
      const int k = kc / S, cc = kc - k * S;
      const int kk = h * KH + k;
      wsb[i] = kk < S ? sWT[(size_t)cc * S2 + S + kk] : 0.0f;
    }
  }
  float wa[KA > 0 ? KA : 1];
  float wb[KB > 0 ? KB : 1];
  if constexpr (KA > 0) {
#pragma unroll
    for (int k = 0; k < KA; ++k)
      wa[k] = (on && k < S) ? (half ? __ldg(sWT + (size_t)c * S2 + k)
                                    : __ldg(sW2T + (size_t)c * S + k))
                            : 0.0f;
  }
  if constexpr (KB > 0) {
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      const int kk = half * KB + k;
      wb[k] = (on && kk < S) ? __ldg(sWT + (size_t)c * S2 + S + kk) : 0.0f;
    }
  }
  __syncthreads();

  // scan step f of the backward (the forward's steps, last first): its time
  // and the time of its h_prev (-1 at the forward scan's first step)
  auto time_of = [&](int f) { return reverse ? f : T - 1 - f; };
  auto prev_of = [&](int t) {
    return reverse ? (t + 1 < T ? t + 1 : -1) : t - 1;
  };
  for (int p = 0; p < ns - 1; ++p) {
    if (p < T) {
      const int t = time_of(p);
      fetch_step<BR>(ring + p * slot_len, gates, h_out, g, mask, t,
                     prev_of(t), B, b0, nrows, S, vec);
    }
    cp_async_commit();
  }
  cp_async_wait_pending(ns - 2);
  __syncthreads();

  float dh[BR];                // carried cotangent of column c (both threads)
#pragma unroll
  for (int r = 0; r < BR; ++r) dh[r] = 0.0f;
  int cur = 0, nxt = ns - 1;   // slots of steps s, s + ns - 1
  for (int s = 0; s < T; ++s) {
    const int t = time_of(s);
    const float* slot = ring + cur * slot_len;
    cur = cur + 1 == ns ? 0 : cur + 1;
    const float* hps = slot + BR * S3;             // h_prev
    const float* gs = slot + BR * 4 * S;           // g
    const int* ms = reinterpret_cast<const int*>(slot + BR * 5 * S);
    auto out_row = [&](int r) { return ((size_t)t * B + b0 + r); };

    // (1) dz and da of column c from the carried dh: thread 2c puts da,
    // thread 2c+1 dz, in its half of the first product's operand
    if (on) {
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const float z = slot[r * S3 + c];
        const float hbar = slot[r * S3 + S2 + c];
        const float hp = hps[r * S + c];
        const float dht = dh[r] + gs[r * S + c];
        const float dhe = ms[r] ? dht : 0.0f;
        const float v = half ? dhe * (hp - hbar) * z * (1.0f - z)
                             : dhe * (1.0f - z) * (1.0f - hbar * hbar);
        dv[((c / NP) * 2 + half) * (NP * BR) + (c % NP) * BR + r] = v;
        if (r < nrows) {
          const size_t row = out_row(r);
          if (half) {
            dxp[row * S3 + c] = ms[r] ? v : 0.0f;
            rh[row * S + c] = slot[r * S3 + S + c] * hp;
          } else {
            dxp[row * S3 + S2 + c] = ms[r] ? v : 0.0f;
          }
        }
      }
    }
    __syncthreads();           // A

    {
      // refill the slot that step s - 1 used (every thread has left it)
      const int f = s + ns - 1;
      if (f < T) {
        const int tf = time_of(f);
        fetch_step<BR>(ring + nxt * slot_len, gates, h_out, g, mask, tf,
                       prev_of(tf), B, b0, nrows, S, vec);
      }
      cp_async_commit();
      nxt = nxt + 1 == ns ? 0 : nxt + 1;
    }

    // (2) thread 2c: drh_c = da . sW2T[c, :]; thread 2c+1: e1_c =
    // dz . sWT[c, :S]; then the pair swaps them
    float drh[BR], e1[BR];
    {
      float acc[BR];
      // this half's blocks of the interleaved operand
      const float* v = dv + half * (NP * BR);
      const int stride = 2 * NP * BR;
      if constexpr (KA > 0) {
        dot_reg<BR, KA>(acc, v, wa, stride);
      } else if (stage_a) {
        dot_col<BR>(acc, v,
                    [&](int k) { return wsa[(k * S + cw) * 2 + half]; }, KD,
                    stride);
      } else {
        dot_col<BR>(acc, v,
                    [&](int k) {
                      return k >= S ? 0.0f
                             : half ? __ldg(sWT + (size_t)cw * S2 + k)
                                    : __ldg(sW2T + (size_t)cw * S + k);
                    },
                    KD, stride);
      }
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const float o = __shfl_xor_sync(0xffffffffu, acc[r], 1);
        drh[r] = half ? o : acc[r];
        e1[r] = half ? acc[r] : o;
      }
    }
    // dr of column c, into the second product's operand
    if (on && !half) {
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const float rg = slot[r * S3 + S + c];
        const float dr = drh[r] * hps[r * S + c] * rg * (1.0f - rg);
        drT[c * BR + r] = dr;
        if (r < nrows) dxp[out_row(r) * S3 + S + c] = ms[r] ? dr : 0.0f;
      }
    }
    cp_async_wait_pending(ns - 2);  // the next step's slot has landed
    __syncthreads();           // B

    // (3) dr . sWT[c, S:], its k-range split over the pair, and dh_c
    {
      float acc[BR];
      const float* v = drT + half * KH * BR;
      if constexpr (KB > 0) {
        dot_reg<BR, KB>(acc, v, wb);
      } else if (stage_b) {
        dot_col<BR>(acc, v,
                    [&](int k) { return wsb[(k * S + cw) * 2 + half]; }, KH);
      } else {
        dot_col<BR>(acc, v,
                    [&](int k) {
                      const int kk = half * KH + k;
                      return kk < S ? __ldg(sWT + (size_t)cw * S2 + S + kk)
                                    : 0.0f;
                    },
                    KH);
      }
      // both threads of the pair form the same sums (a + b == b + a)
      float e2[BR];
#pragma unroll
      for (int r = 0; r < BR; ++r)
        e2[r] = acc[r] + __shfl_xor_sync(0xffffffffu, acc[r], 1);
      if (on) {
#pragma unroll
        for (int r = 0; r < BR; ++r) {
          const float z = slot[r * S3 + c];
          const float rg = slot[r * S3 + S + c];
          const float dht = dh[r] + gs[r * S + c];
          const float dhe = ms[r] ? dht : 0.0f;
          float d = ((dhe * z + drh[r] * rg) + e1[r]) + e2[r];
          if (!ms[r]) d = d + dht;
          dh[r] = d;
        }
      }
    }
    // the next step's (1) writes dv, which (2) read before barrier B, and
    // reads its own slot; its barrier A orders (2) behind all of (3)
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int BR, int KA, int KB>
int launch(const void* gates, const void* h_out, const void* g,
           const void* mask, const void* sWT, const void* sW2T, void* dxp,
           void* rh, int T, int B, int S, int reverse, int ns, int stage,
           int smem, int threads, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gru_bwd_kernel<BR, KA, KB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec = S % 4 == 0 && (uintptr_t)gates % 16 == 0 &&
                  (uintptr_t)h_out % 16 == 0 && (uintptr_t)g % 16 == 0;
  gru_bwd_kernel<BR, KA, KB><<<(B + BR - 1) / BR, threads, smem, stream>>>(
      (const float*)gates, (const float*)h_out, (const float*)g,
      (const int*)mask, (const float*)sWT, (const float*)sW2T, (float*)dxp,
      (float*)rh, T, B, S, reverse, ns, stage, vec);
  return (int)cudaGetLastError();
}

template <int KA, int KB>
int by_rows(int br, const void* gates, const void* h_out, const void* g,
            const void* mask, const void* sWT, const void* sW2T, void* dxp,
            void* rh, int T, int B, int S, int reverse, int ns, int stage,
            int smem, int threads, cudaStream_t s) {
#define GRU_BWD_LAUNCH(BR)                                                  \
  launch<BR, KA, KB>(gates, h_out, g, mask, sWT, sW2T, dxp, rh, T, B, S,    \
                     reverse, ns, stage, smem, threads, s)
  switch (br) {
    case 1: return GRU_BWD_LAUNCH(1);
    case 2: return GRU_BWD_LAUNCH(2);
    case 4: return GRU_BWD_LAUNCH(4);
    case 8: return GRU_BWD_LAUNCH(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GRU_BWD_LAUNCH
}

}  // namespace

// The launch plan comes from the caller (nn/fused_gru.py::gru_bwd_plan):
// rows a block br (1, 2, 4, 8), the register floats ka and kb (one of the
// pairs below), stage bits (1: the first product's weights, 2: the
// second's, in shared memory), ring depth ns (2-4), smem bytes and threads
// (2S rounded up to a warp).  gates is the forward's (T, B, 3S) trace,
// mask (T, B) int32.
extern "C" int gru_bwd(const void* gates, const void* h_out, const void* g,
                       const void* mask, const void* sWT, const void* sW2T,
                       void* dxp, void* rh, int T, int B, int S, int reverse,
                       int br, int ka, int kb, int stage, int ns, int smem,
                       int threads, void* stream) {
  if (ns < 2 || ns > 4 || threads < 2 * S || (ka > 0 && ka < S) ||
      (kb > 0 && 2 * kb < S))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define GRU_BWD_BY_ROWS(KA, KB)                                           \
  by_rows<KA, KB>(br, gates, h_out, g, mask, sWT, sW2T, dxp, rh, T, B, S, \
                  reverse, ns, stage, smem, threads, s)
  if (ka == 96 && kb == 48) return GRU_BWD_BY_ROWS(96, 48);
  if (ka == 112 && kb == 56) return GRU_BWD_BY_ROWS(112, 56);
  if (ka == 0 && kb == 72) return GRU_BWD_BY_ROWS(0, 72);
  if (ka == 0 && kb == 0) return GRU_BWD_BY_ROWS(0, 0);
#undef GRU_BWD_BY_ROWS
  return (int)cudaErrorInvalidValue;
}
