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
// What bounds it.  The recurrence is T dependent steps of 3 S^2 FMAs a row,
// so the latency of one block's step, not bandwidth, bounds the kernel: a
// step waits on its projections, on the weights it reads, on the dependent
// FMA chains of its sums and on two barriers.  With both weights in shared
// memory the products read ~1,080 warp-wide words of weights a step at
// S = 96 (a word a clock is the pipe's rate), against 27,648 FMAs; with the
// weights in registers they read only h and r * h.  The design:
//
// - One block owns BR batch rows for all T steps; BR (1, 2, 4 or 8) is the
//   fewest rows that fit the batch in one wave over the SMs.
// - Weights in registers where they fit.  Mode REG: thread j holds KR rows
//   of sWT's column j (KR >= S at the models' S = 96 and 112; the rows past
//   KR are staged in shared memory) and KH2 rows of sW2T's column j / 2 (a
//   half of its k-range), so the products read only h and r * h from shared
//   memory, as broadcasts.  A thread may take 255 registers at 6-7 warps a
//   block, 168 at 9 (S = 144: a sub-partition's 16K registers serve 3 of
//   the warps), so at S = 144 it holds sW2T's 72 rows and 48 of sWT's.  Mode
//   SMEM stages both weights in shared memory (small S).  Mode GLOBAL (S
//   past 144) stages sWT when it fits and reads the rest through L1.  The
//   host plan (nn/fused_gru.py::gru_fwd_plan) picks the mode, BR and the
//   ring depth from the shape alone, and each mode is a template instance.
// - Projections and mask words arrive through a ring of NS (2-4) step slots
//   in shared memory, filled with cp.async NS-1 steps ahead; a step waits
//   only for the slot of the step after it, at its closing barrier.  The
//   step stays a rolled loop (unrolled bodies were scheduled unpredictably,
//   scripts/bench_gru_unroll.py's probe in csrc/gru_unroll.cu).
// - No long dependent chains: thread j (of 2S) owns gate column j of
//   h . sWT and splits its k-sum over 4 / BR partial sums; the candidate
//   product uses all 2S threads too, the pair (2c, 2c+1) summing the two
//   halves of column c's k-range, joined with one shuffle.  Partial sums
//   are joined in a fixed order.
//
// Sums are plain f32 FMA: no TF32 and no fast-math (expf/tanhf are the
// accurate versions).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { W2_SMEM = 0, W2_REG = 1, W2_GLOBAL = 2 };

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

// wait until at most ns - 2 groups are pending: the slot of the next step
// has landed (for this thread; the barrier after it publishes the slot)
__device__ __forceinline__ void cp_async_wait_ring(int ns) {
  switch (ns) {
    case 2: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
  }
}

// threads a block at most, for __launch_bounds__: 2S <= 4 KH2 in mode REG.
// It sets the registers a thread may take: a sub-partition of the SM holds
// 16K registers for its share of the warps (at 6 or 7 warps, 255 a thread;
// at 9 warps, 168)
template <int W2, int KH2>
struct MaxThreads {
  static constexpr int value =
      W2 == W2_GLOBAL ? 1024 : W2 == W2_REG ? (4 * KH2 + 31) / 32 * 32 : 288;
};

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

// NP consecutive k of a [k][BR] operand into NP partial sums; at BR = 1, 2
// the NP * BR values are one 16-byte load
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

// out = sum over k < K of vT[k][:] * w(k), vT [K][BR] in shared memory
template <int BR, class W>
__device__ __forceinline__ void dot_col(float (&out)[BR], const float* vT,
                                        W w, int K) {
  constexpr int NP = Parts<BR>::NP;
  float acc[NP][BR];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int r = 0; r < BR; ++r) acc[p][r] = 0.0f;
  int k = 0;
#pragma unroll 2
  for (; k + NP <= K; k += NP) {
    float wv[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) wv[p] = w(k + p);
    fma_block<BR, NP>(acc, vT + k * BR, wv);
  }
  for (; k < K; ++k) fma_rows<BR>(acc[0], vT + k * BR, w(k));
  join<BR, NP>(out, acc);
}

// the same over K weights held in registers
template <int BR, int K>
__device__ __forceinline__ void dot_reg(float (&out)[BR], const float* vT,
                                        const float (&w)[K]) {
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
    fma_block<BR, NP>(acc, vT + k * BR, wv);
  }
  join<BR, NP>(out, acc);
}

// start the copies of one time step (nrows rows of 3S projections, then
// their mask words) into a ring slot; the caller commits the group
__device__ __forceinline__ void fetch_step(float* slot,
                                           const float* __restrict__ xp,
                                           const int* __restrict__ mask,
                                           int t, int B, int b0, int nrows,
                                           int S3, int xlen, int vec) {
  const size_t row0 = (size_t)t * B + b0;
  const float* src = xp + row0 * S3;
  const int len = nrows * S3;
  if (vec) {
    for (int i = threadIdx.x; i < len / 4; i += blockDim.x)
      cp_async16(slot + 4 * i, src + 4 * i);
  } else {
    for (int i = threadIdx.x; i < len; i += blockDim.x)
      cp_async4(slot + i, src + i);
  }
  int* m = reinterpret_cast<int*>(slot + xlen);
  for (int i = threadIdx.x; i < nrows; i += blockDim.x)
    cp_async4(m + i, mask + row0 + i);
}

// KR rows of sWT (mode REG) and KH2 rows of sW2T (a half of a pair, mode
// REG) a thread holds in registers
template <int BR, int W2, int KR, int KH2>
__global__ void __launch_bounds__(MaxThreads<W2, KH2>::value)
gru_fwd_kernel(const float* __restrict__ xp, const int* __restrict__ mask,
               const float* __restrict__ sWT, const float* __restrict__ sW2T,
               float* __restrict__ out, int T, int B, int S, int reverse,
               int ns, int stage1, int vec) {
  extern __shared__ float4 smem4[];
  const int S2 = 2 * S, S3 = 3 * S;
  // rows of sW2T each half of a pair sums (a multiple of 4)
  const int KH = W2 == W2_REG ? KH2 : round4((S + 1) / 2);
  const int HR = S > KR ? S : KR;                // rows of the state
  const int K1 = S > KR ? S - KR : 0;            // rows of sWT staged
  const int xlen = BR * S3;                      // projections of a slot
  const int slot_len = round4(xlen + BR);        // and its mask words
  float* ring = reinterpret_cast<float*>(smem4); // [ns][slot_len]
  float* hT = ring + ns * slot_len;              // [HR][BR]  state
  float* zT = hT + round4(HR * BR);              // [S][BR]   update gate
  float* rhT = zT + round4(S * BR);              // [2KH][BR] r * h
  float* w1 = rhT + round4(2 * KH * BR);         // [K1][2S]  sWT rows KR..
  float* w2 = w1 + (stage1 ? K1 * S2 : 0);       // [KH][S][2] sW2T (SMEM)
  const int j = threadIdx.x;
  const int b0 = blockIdx.x * BR;
  const int nrows = min(BR, B - b0);

  // the ring and the state start at zero: rows past the batch are never
  // fetched, so their mask words stay 0 and their h stays 0
  const int nzero = ns * slot_len + round4(HR * BR) + round4(S * BR) +
                    round4(2 * KH * BR);
  for (int i = j; i < nzero; i += blockDim.x) ring[i] = 0.0f;
  if (stage1) {
    for (int i = j; i < K1 * S2; i += blockDim.x) w1[i] = sWT[KR * S2 + i];
  }
  if constexpr (W2 == W2_SMEM) {
    // w2[(k * S + c) * 2 + half] = sW2T[half * KH + k][c]: the two threads
    // of a pair read neighbouring words
    for (int i = j; i < KH * S * 2; i += blockDim.x) {
      const int half = i & 1, kc = i >> 1;
      const int k = kc / S, c = kc - k * S;
      const int kk = half * KH + k;
      w2[i] = kk < S ? sW2T[(size_t)kk * S + c] : 0.0f;
    }
  }
  // this thread's role in the candidate product: half of column c's k-sum
  const int c = j >> 1, half = j & 1;
  const bool pair_on = j < S2;
  const unsigned pair_mask = 3u << (threadIdx.x & 30);
  float w1r[KR > 0 ? KR : 1];
  float w2r[W2 == W2_REG ? KH2 : 1];
  if constexpr (KR > 0) {
#pragma unroll
    for (int k = 0; k < KR; ++k)
      w1r[k] = (j < S2 && k < S) ? __ldg(sWT + (size_t)k * S2 + j) : 0.0f;
  }
  if constexpr (W2 == W2_REG) {
#pragma unroll
    for (int k = 0; k < KH2; ++k) {
      const int kk = half * KH2 + k;
      w2r[k] = (pair_on && kk < S) ? __ldg(sW2T + (size_t)kk * S + c) : 0.0f;
    }
  }
  __syncthreads();

  for (int p = 0; p < ns - 1; ++p) {
    if (p < T)
      fetch_step(ring + p * slot_len, xp, mask, reverse ? T - 1 - p : p, B,
                 b0, nrows, S3, xlen, vec);
    cp_async_commit();
  }
  cp_async_wait_ring(ns);
  __syncthreads();

  int cur = 0, nxt = ns - 1;                     // slots of steps s, s+ns-1
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    {
      // refill the slot that step s - 1 used, ns - 1 steps ahead
      const int f = s + ns - 1;
      if (f < T)
        fetch_step(ring + nxt * slot_len, xp, mask, reverse ? T - 1 - f : f,
                   B, b0, nrows, S3, xlen, vec);
      cp_async_commit();
      nxt = nxt + 1 == ns ? 0 : nxt + 1;
    }
    const float* slot = ring + cur * slot_len;
    cur = cur + 1 == ns ? 0 : cur + 1;
    const int* mslot = reinterpret_cast<const int*>(slot + xlen);

    // z / r gates: column j of h . sWT for the block's rows
    if (j < S2) {
      float acc[BR];
      if constexpr (KR > 0) {
        dot_reg<BR, KR>(acc, hT, w1r);
        if (K1 > 0) {
          float rest[BR];
          dot_col<BR>(rest, hT + KR * BR,
                      [&](int k) { return w1[k * S2 + j]; }, K1);
#pragma unroll
          for (int r = 0; r < BR; ++r) acc[r] += rest[r];
        }
      } else if (stage1)
        dot_col<BR>(acc, hT, [&](int k) { return w1[k * S2 + j]; }, S);
      else
        dot_col<BR>(acc, hT,
                    [&](int k) { return __ldg(sWT + (size_t)k * S2 + j); },
                    S);
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const float g = sigmoid_f32(slot[r * S3 + j] + acc[r]);
        if (j < S) {
          zT[j * BR + r] = g;
        } else {
          const int e = (j - S) * BR + r;
          rhT[e] = g * hT[e];
        }
      }
    }
    __syncthreads();

    // candidate and state update: column c of (r * h) . sW2T, its k-range
    // split over the pair (2c, 2c + 1)
    if (pair_on) {
      float acc[BR];
      const float* v = rhT + half * KH * BR;
      if constexpr (W2 == W2_SMEM) {
        dot_col<BR>(acc, v, [&](int k) { return w2[(k * S + c) * 2 + half]; },
                    KH);
      } else if constexpr (W2 == W2_REG) {
        dot_reg<BR, KH2>(acc, v, w2r);
      } else {
        dot_col<BR>(acc, v,
                    [&](int k) {
                      const int kk = half * KH + k;
                      return kk < S ? __ldg(sW2T + (size_t)kk * S + c) : 0.0f;
                    },
                    KH);
      }
      // both threads of the pair form the same sum (a + b == b + a)
#pragma unroll
      for (int r = 0; r < BR; ++r)
        acc[r] += __shfl_xor_sync(pair_mask, acc[r], 1);
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        if ((r & 1) == half && r < nrows) {
          const float hbar = tanhf(slot[r * S3 + S2 + c] + acc[r]);
          const float h = hT[c * BR + r];
          const float z = zT[c * BR + r];
          float nw = z * h + (1.0f - z) * hbar;
          if (mslot[r] == 0) nw = h;
          hT[c * BR + r] = nw;
          out[((size_t)t * B + b0 + r) * S + c] = nw;
        }
      }
    }
    cp_async_wait_ring(ns);          // the next step's slot has landed
    __syncthreads();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int BR, int W2, int KR, int KH2>
int launch(const void* xp, const void* mask, const void* sWT,
           const void* sW2T, void* out, int T, int B, int S, int reverse,
           int ns, int stage1, int smem, int threads, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gru_fwd_kernel<BR, W2, KR, KH2>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec = (3 * S) % 4 == 0 && (uintptr_t)xp % 16 == 0;
  gru_fwd_kernel<BR, W2, KR, KH2>
      <<<(B + BR - 1) / BR, threads, smem, stream>>>(
      (const float*)xp, (const int*)mask, (const float*)sWT,
      (const float*)sW2T, (float*)out, T, B, S, reverse, ns, stage1, vec);
  return (int)cudaGetLastError();
}

template <int W2, int KR, int KH2>
int by_rows(int br, const void* xp, const void* mask, const void* sWT,
            const void* sW2T, void* out, int T, int B, int S, int reverse,
            int ns, int stage1, int smem, int threads, cudaStream_t s) {
  switch (br) {
    case 1:
      return launch<1, W2, KR, KH2>(xp, mask, sWT, sW2T, out, T, B, S, reverse, ns,
                           stage1, smem, threads, s);
    case 2:
      return launch<2, W2, KR, KH2>(xp, mask, sWT, sW2T, out, T, B, S, reverse, ns,
                           stage1, smem, threads, s);
    case 4:
      return launch<4, W2, KR, KH2>(xp, mask, sWT, sW2T, out, T, B, S, reverse, ns,
                           stage1, smem, threads, s);
    case 8:
      return launch<8, W2, KR, KH2>(xp, mask, sWT, sW2T, out, T, B, S, reverse, ns,
                           stage1, smem, threads, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The launch plan comes from the caller (nn/fused_gru.py::gru_fwd_plan):
// rows a block br (1, 2, 4, 8), mode (0 SMEM, 1 REG, 2 GLOBAL), in mode
// REG the register rows kr of sWT and kh2 of sW2T (one of the pairs
// below), ring depth ns (2-4), stage1 (sWT rows past kr in shared memory),
// smem bytes and threads (2S rounded up to a warp).  mask is (T, B) int32.
extern "C" int gru_fwd(const void* xp, const void* mask, const void* sWT,
                       const void* sW2T, void* out, int T, int B, int S,
                       int reverse, int br, int mode, int kr, int kh2, int ns,
                       int stage1, int smem, int threads, void* stream) {
  if (ns < 2 || ns > 4 || threads < 2 * S || (mode != W2_GLOBAL && !stage1) ||
      (mode == W2_REG && S > 2 * kh2))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define GRU_FWD_BY_ROWS(W2, KR, KH2)                                        \
  by_rows<W2, KR, KH2>(br, xp, mask, sWT, sW2T, out, T, B, S, reverse, ns, \
                       stage1, smem, threads, s)
  if (mode == W2_SMEM) return GRU_FWD_BY_ROWS(W2_SMEM, 0, 0);
  if (mode == W2_GLOBAL) return GRU_FWD_BY_ROWS(W2_GLOBAL, 0, 0);
  if (mode != W2_REG) return (int)cudaErrorInvalidValue;
  if (kr == 96 && kh2 == 48) return GRU_FWD_BY_ROWS(W2_REG, 96, 48);
  if (kr == 112 && kh2 == 56) return GRU_FWD_BY_ROWS(W2_REG, 112, 56);
  if (kr == 48 && kh2 == 72) return GRU_FWD_BY_ROWS(W2_REG, 48, 72);
  if (kr == 0 && kh2 == 72) return GRU_FWD_BY_ROWS(W2_REG, 0, 72);
#undef GRU_FWD_BY_ROWS
  return (int)cudaErrorInvalidValue;
}
