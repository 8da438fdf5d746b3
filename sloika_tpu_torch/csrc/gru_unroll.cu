// GRU forward recurrence with U time steps a ring slot, a probe of
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
// What bounds it.  The recurrence is T dependent steps of 3 S^2 FMAs a row:
// the latency of one block's step, not bandwidth, bounds it (gru_fwd.cu).
// The probe prices parts of that latency on the production step's design,
// so that what it measures carries over to gru_fwd.cu:
//
// - One block owns BR batch rows for all T steps (the fewest of 1, 2, 4, 8
//   that fit the batch in one wave over the SMs).  Thread j of 2S owns gate
//   column j / 2 of z (j even) or of r (j odd): a pair (2c, 2c + 1) holds
//   the z and r of state c, and both keep state c's h in registers, so r * h
//   needs no shared-memory read and z reaches the update by one shuffle.
//   The candidate product splits column c's k-range over the same pair,
//   joined with one shuffle (a + b == b + a: both hold the same sum).
// - Weights in registers, gru_fwd.cu's mode REG, through recurrence.cuh's
//   blocked dots: in f32 a thread holds KR rows of its sWT column and KH2 of
//   its half of sW2T's column (96 and 48 up to S = 96; 48 and 72 above,
//   where 9 warps leave 168 registers a thread, and sWT's other rows are
//   staged in shared memory in thread order).  At S = 144 in f32, one row a
//   block, the 8-warp layout (gru_unroll_w8, below) holds 104 of sWT's rows
//   at 255 registers instead: 0.64-0.69 ms against the 9 warps' 0.77-0.84
//   (T = 400, B = 100; H100 80GB HBM3 at 700 W, scripts/
//   bench_gru_unroll.py).  In bf16 the weights are held as bf16 pairs, two
//   rows a register, so at S = 144 all of sWT's 144 rows and sW2T's 72 fit
//   in 108 registers.  Mode SMEM (small or large S) stages both weights in
//   shared memory when they fit, else reads them through L1.  The products
//   read only h and r * h from shared memory, as broadcasts.
// - The lean refill.  The projections come through a ring of NSLOT slots of
//   U time rows.  One thread issues a slot's U bulk asynchronous copies
//   (one a time row: the block's rows of a step are contiguous) on the
//   slot's one mbarrier, right after the barrier that closes the last step
//   to read the slot; a step that opens a slot tests the barrier's phase
//   before it blocks on it (bulk_copy.cuh's mbar_wait_tested).  So U prices
//   only how far ahead the projections come and how many refills run.
// - Two barriers a step, as in gru_fwd.cu: both products are all-to-all
//   over the block (every column reads every row of h, then of r * h), so
//   the design allows no fewer.  The out stores follow the second barrier,
//   off the step's path.
//
// The step is a rolled loop whatever U (the compiler schedules unrolled
// bodies unpredictably), the products' FMAs stay f32 on the CUDA cores,
// and the state update is rounded op by op (no contraction), so every U
// gives the same bits.
#include <cuda_bf16.h>

#include <type_traits>

#include "recurrence.cuh"

#ifdef GRU_UNROLL_CLOCKS
// Step-phase clocks (scripts/bench_gru_unroll.py --clocks builds this
// source with -DGRU_UNROLL_CLOCKS into a library of its own): lane 0 of each
// warp of block 0 sums, over the T steps, the SM clock cycles of the ring
// (a slot's wait, its refill's issue and the out stores), the first
// product, the gates, the first barrier, the candidate product, the update
// and the second barrier; then the whole loop.
__device__ long long gru_unroll_clocks[32 * 8];
#define UNROLL_CLOCK(k) PHASE_CLOCK(k)
#else
#define UNROLL_CLOCK(k) \
  do {                  \
  } while (0)
#endif

namespace {

constexpr int kMaxSlots = 4;
constexpr int kBarFloats = 16;          // the slots' mbarriers, 64 bytes

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two bf16 of a pair register: row 2i in the low half, 2i + 1 in the high
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// row 2i + odd of a pair register, widened to f32.  volatile: the compiler
// would otherwise widen every pair once, outside the time loop, and hold
// twice the registers (at S = 144 it spilled)
__device__ __forceinline__ float pair_row(uint32_t p, int odd) {
  uint32_t w;
  if (odd)
    asm volatile("and.b32 %0, %1, 0xffff0000;" : "=r"(w) : "r"(p));
  else
    asm volatile("shl.b32 %0, %1, 16;" : "=r"(w) : "r"(p));
  return __uint_as_float(w);
}

// dot_reg over K2 bf16 pairs (K = 2 K2 rows), each row widened to f32
template <int BR, int K2>
__device__ __forceinline__ void dot_pairs(float (&out)[BR], const float* v,
                                          const uint32_t (&w)[K2]) {
  constexpr int NP = Parts<BR>::NP;
  float acc[NP][BR];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int r = 0; r < BR; ++r) acc[p][r] = 0.0f;
#pragma unroll
  for (int k = 0; k < 2 * K2; k += NP) {
    float wv[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) wv[p] = pair_row(w[(k + p) >> 1], (k + p) & 1);
    fma_block<BR, NP>(acc, v + k * BR, wv);
  }
  join<BR, NP>(out, acc);
}

// threads a block at most, for __launch_bounds__: 2S <= 4 KH2 in the
// register modes (288 at KH2 = 72: 9 warps, 168 registers a thread)
template <int KH2>
struct MaxThreads {
  static constexpr int value = KH2 > 0 ? (4 * KH2 + 31) / 32 * 32 : 1024;
};

// KR rows of sWT's column and KH2 of a half of sW2T's column a thread
// holds in registers (0, 0: mode SMEM); stage1 / stage2: the weights not in
// registers are staged in shared memory, else read through L1
template <int BR, int KR, int KH2, bool BF16>
__global__ void __launch_bounds__(MaxThreads<KH2>::value)
gru_unroll_kernel(const float* __restrict__ xp,
                  const float* __restrict__ sWT,
                  const float* __restrict__ sW2T, float* __restrict__ out,
                  int T, int B, int S, int ld, int U, int nslot, int stage1,
                  int stage2) {
  extern __shared__ float4 smem4[];
  using WS = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  const int S2 = 2 * S;
  const int KH = KH2 > 0 ? KH2 : round4((S + 1) / 2);  // rows a half sums
  const int HR = S > KR ? S : KR;                      // rows of the state
  const int K1 = S > KR ? S - KR : 0;                  // sWT rows not held
  const int slot_len = U * BR * ld;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);          // [nslot]
  float* ring = reinterpret_cast<float*>(smem4) + kBarFloats;   // [nslot][U][BR][ld]
  float* hv = ring + nslot * slot_len;           // [HR][BR] h as read
  float* rhT = hv + round4(HR * BR);             // [2 KH][BR] r * h
  WS* w1 = reinterpret_cast<WS*>(rhT + round4(2 * KH * BR));   // [K1][2S]
  WS* w2 = w1 + (stage1 ? K1 * S2 : 0);          // [KH][S][2] (mode SMEM)
  const int j = threadIdx.x;
  const int b0 = blockIdx.x * BR;
  const int nrows = min(BR, B - b0);
  const int c = j >> 1, half = j & 1;
  const bool pair_on = j < S2;
  // this thread's sWT column and candidate column of xp (threads past 2S
  // read column 0 and store nothing)
  const int col1 = pair_on ? (half ? S + c : c) : 0;
  const int colc = pair_on ? S2 + c : 0;
  const int jw = pair_on ? j : 0, cw = pair_on ? c : 0;  // staged reads
  const unsigned row_bytes = (unsigned)(nrows * ld) * 4u;

  // the ring and the state start at zero: rows past the batch and columns
  // past 3S are never written, and k past S adds zeros
  for (int i = j; i < nslot * slot_len + round4(HR * BR) +
                      round4(2 * KH * BR); i += blockDim.x)
    ring[i] = 0.0f;
  if (stage1) {
    // w1[k][jj] = sWT[KR + k][col1(jj)]: a warp reads consecutive words
    for (int i = j; i < K1 * S2; i += blockDim.x) {
      const int k = i / S2, jj = i - k * S2;
      const float v = sWT[(size_t)(KR + k) * S2 + ((jj & 1) ? S : 0) +
                          (jj >> 1)];
      if constexpr (BF16)
        w1[i] = __float2bfloat16_rn(v);
      else
        w1[i] = v;
    }
  }
  if (KH2 == 0 && stage2) {
    // w2[(k S + cc) 2 + hh] = sW2T[hh KH + k][cc]
    for (int i = j; i < KH * S * 2; i += blockDim.x) {
      const int hh = i & 1, kc = i >> 1;
      const int k = kc / S, cc = kc - k * S;
      const int kk = hh * KH + k;
      const float v = kk < S ? sW2T[(size_t)kk * S + cc] : 0.0f;
      if constexpr (BF16)
        w2[i] = __float2bfloat16_rn(v);
      else
        w2[i] = v;
    }
  }
  // the weights held in registers: f32 rows, or bf16 pairs of rows
  constexpr int R1 = KR > 0 ? (BF16 ? KR / 2 : KR) : 1;
  constexpr int R2 = KH2 > 0 ? (BF16 ? KH2 / 2 : KH2) : 1;
  using WR = typename std::conditional<BF16, uint32_t, float>::type;
  WR w1r[R1], w2r[R2];
  auto w1_at = [&](int k) {
    return (pair_on && k < S) ? __ldg(sWT + (size_t)k * S2 + col1) : 0.0f;
  };
  auto w2_at = [&](int k) {
    const int kk = half * KH + k;
    return (pair_on && kk < S) ? __ldg(sW2T + (size_t)kk * S + c) : 0.0f;
  };
  if constexpr (KR > 0) {
#pragma unroll
    for (int i = 0; i < R1; ++i) {
      if constexpr (BF16)
        w1r[i] = pack_bf16(w1_at(2 * i), w1_at(2 * i + 1));
      else
        w1r[i] = w1_at(i);
    }
  }
  if constexpr (KH2 > 0) {
#pragma unroll
    for (int i = 0; i < R2; ++i) {
      if constexpr (BF16)
        w2r[i] = pack_bf16(w2_at(2 * i), w2_at(2 * i + 1));
      else
        w2r[i] = w2_at(i);
    }
  }
  if (j == 0) {
    for (int f = 0; f < nslot; ++f) mbar_init(&full[f], 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int nbody = (T + U - 1) / U;
  // issue body `body`'s time rows into its slot, on the slot's barrier
  auto refill = [&](int slot, int body) {
    const int t0 = body * U, n = min(U, T - t0);
    mbar_expect_tx(&full[slot], row_bytes * (unsigned)n);
    for (int i = 0; i < n; ++i)
      bulk_copy(ring + slot * slot_len + i * BR * ld,
                xp + ((size_t)(t0 + i) * B + b0) * ld, row_bytes,
                &full[slot]);
  };
  if (j == 0) {
    fence_proxy_async();          // the zeros above come before the copies
    for (int f = 0; f < nslot && f < nbody; ++f) refill(f, f);
  }

  float h[BR];                    // state c of the block's rows (both lanes)
#pragma unroll
  for (int r = 0; r < BR; ++r) h[r] = 0.0f;
  int slot = 0, u = 0;
  unsigned parity = 0;
#ifdef GRU_UNROLL_CLOCKS
  PHASE_CLOCK_START();
#endif
  for (int t = 0; t < T; ++t) {
    if (u == 0) mbar_wait_tested(&full[slot], parity);
    UNROLL_CLOCK(0);
    const float* xs = ring + slot * slot_len + u * BR * ld;

    // z (even lanes) or r (odd lanes): column col1 of h . sWT
    float acc[BR];
    if constexpr (KR > 0) {
      if constexpr (BF16)
        dot_pairs<BR, R1>(acc, hv, w1r);
      else
        dot_reg<BR, KR>(acc, hv, w1r);
    } else {
#pragma unroll
      for (int r = 0; r < BR; ++r) acc[r] = 0.0f;
    }
    if (K1 > 0) {
      float rest[BR];
      const float* v = hv + KR * BR;
      if (stage1) {
        if constexpr (BF16)
          dot_col<BR>(rest, v,
                      [&](int k) { return __bfloat162float(w1[k * S2 + jw]); },
                      K1);
        else
          dot_col<BR>(rest, v, [&](int k) { return w1[k * S2 + jw]; }, K1);
      } else {
        dot_col<BR>(rest, v,
                    [&](int k) {
                      const float w = w1_at(KR + k);
                      return BF16 ? round_bf16(w) : w;
                    },
                    K1);
      }
#pragma unroll
      for (int r = 0; r < BR; ++r) acc[r] += rest[r];
    }
    UNROLL_CLOCK(1);
    float g[BR];
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      g[r] = sigmoid_f32(xs[r * ld + col1] + acc[r]);
      if (half && pair_on) {
        const float rh = g[r] * h[r];
        rhT[c * BR + r] = BF16 ? round_bf16(rh) : rh;
      }
    }
    UNROLL_CLOCK(2);
    __syncthreads();
    UNROLL_CLOCK(3);

    // candidate: column c of (r * h) . sW2T, its k-range over the pair
    const float* v = rhT + half * KH * BR;
    if constexpr (KH2 > 0) {
      if constexpr (BF16)
        dot_pairs<BR, R2>(acc, v, w2r);
      else
        dot_reg<BR, KH2>(acc, v, w2r);
    } else if (stage2) {
      if constexpr (BF16)
        dot_col<BR>(acc, v,
                    [&](int k) {
                      return __bfloat162float(w2[(k * S + cw) * 2 + half]);
                    },
                    KH);
      else
        dot_col<BR>(acc, v, [&](int k) { return w2[(k * S + cw) * 2 + half]; },
                    KH);
    } else {
      dot_col<BR>(acc, v,
                  [&](int k) {
                    const float w = w2_at(k);
                    return BF16 ? round_bf16(w) : w;
                  },
                  KH);
    }
    // every lane runs the shuffles, so they name the whole warp (a mask of
    // the pair alone would split the warp into 16 groups)
#pragma unroll
    for (int r = 0; r < BR; ++r)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 1);
    UNROLL_CLOCK(4);
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      const float z = __shfl_sync(0xffffffffu, g[r], 0, 2);  // the even lane's
      const float hbar = tanhf(xs[r * ld + colc] + acc[r]);
      h[r] = __fadd_rn(__fmul_rn(z, h[r]), __fmul_rn(1.0f - z, hbar));
      if (!half && pair_on) hv[c * BR + r] = BF16 ? round_bf16(h[r]) : h[r];
    }
    UNROLL_CLOCK(5);
    __syncthreads();
    UNROLL_CLOCK(6);
    if (++u == U) {
      // every thread has read the slot: refill it nslot bodies ahead
      const int next = t / U + nslot;
      if (j == 0 && next < nbody) refill(slot, next);
      u = 0;
      if (++slot == nslot) {
        slot = 0;
        parity ^= 1u;
      }
    }
    if (!half && pair_on) {
#pragma unroll
      for (int r = 0; r < BR; ++r)
        if (r < nrows) out[((size_t)t * B + b0 + r) * S + c] = h[r];
    }
  }
#ifdef GRU_UNROLL_CLOCKS
  clk[7] = PHASE_CLOCK_TOTAL();
  if (blockIdx.x == 0 && (j & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) gru_unroll_clocks[(j >> 5) * 8 + k] = clk[k];
  }
#endif
}

// The 8-warp layout of f32 at 128 < S <= 144, one row a block: 256
// threads at 255 registers (2 warps a sub-partition), where the 9 warps of
// 2S threads have 168.  Pair p (p < 128) owns state p as above, holding
// W8_KR of its sWT column's rows (the rest staged) and its half of sW2T's
// column, 72 rows.  The E = S - 128 states left over are spread over all
// 256 threads by rows: each warp takes 4 of their 2E gate columns, a group
// of 8 lanes a column and W8_X1 rows a lane, joined by 3 shuffles; and 2 of
// their E candidate columns, 16 lanes a column and W8_X2 rows a lane,
// joined by 4.  Their z and h go through shared memory.
constexpr int W8_THREADS = 256, W8_KR = 104, W8_KH2 = 72, W8_MAIN = 128;
constexpr int W8_X1 = 18, W8_X2 = 9;

__global__ void __launch_bounds__(W8_THREADS)
gru_unroll_w8(const float* __restrict__ xp, const float* __restrict__ sWT,
              const float* __restrict__ sW2T, float* __restrict__ out, int T,
              int B, int S, int ld, int U, int nslot) {
  extern __shared__ float4 smem4[];
  constexpr int BR = 1;
  const int S2 = 2 * S, E = S - W8_MAIN;
  const int K1 = S - W8_KR;                      // sWT rows staged
  const int slot_len = U * ld;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);          // [nslot]
  float* ring = reinterpret_cast<float*>(smem4) + kBarFloats;   // [nslot][U][ld]
  float* hv = ring + nslot * slot_len;           // [2 KH2] h (f32: exact)
  float* rhT = hv + 2 * W8_KH2;                  // [2 KH2] r * h
  float* zx = rhT + 2 * W8_KH2;                  // [16] z of the extra states
  float* w1 = zx + 16;                           // [K1][256] sWT rows W8_KR..
  const int j = threadIdx.x, lane = j & 31, w = j >> 5;
  const int b0 = blockIdx.x;
  const int c = j >> 1, half = j & 1;
  const int col1 = half ? S + c : c;
  // the extra gate column of this lane's group of 8, and its rows
  const int x1 = 4 * w + (lane >> 3), q1 = lane & 7;
  const int e1 = W8_MAIN + (x1 >> 1);
  const bool on1 = (x1 >> 1) < E;
  const int colx1 = (x1 & 1) ? S + e1 : e1;
  // the extra candidate column of this lane's group of 16, and its rows
  const int x2 = 2 * w + (lane >> 4), q2 = lane & 15;
  const int e2 = W8_MAIN + x2;
  const bool on2 = x2 < E;
  const unsigned row_bytes = (unsigned)ld * 4u;

  for (int i = j; i < nslot * slot_len + 4 * W8_KH2 + 16; i += blockDim.x)
    ring[i] = 0.0f;
  for (int i = j; i < K1 * W8_THREADS; i += blockDim.x) {
    const int k = i / W8_THREADS, jj = i - k * W8_THREADS;
    w1[i] = sWT[(size_t)(W8_KR + k) * S2 + ((jj & 1) ? S : 0) + (jj >> 1)];
  }
  float w1r[W8_KR], w2r[W8_KH2], wx1[W8_X1], wx2[W8_X2];
#pragma unroll
  for (int k = 0; k < W8_KR; ++k) w1r[k] = __ldg(sWT + (size_t)k * S2 + col1);
#pragma unroll
  for (int k = 0; k < W8_KH2; ++k) {
    const int kk = half * W8_KH2 + k;
    w2r[k] = kk < S ? __ldg(sW2T + (size_t)kk * S + c) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < W8_X1; ++k) {
    const int kk = q1 * W8_X1 + k;
    wx1[k] = on1 && kk < S ? __ldg(sWT + (size_t)kk * S2 + colx1) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < W8_X2; ++k) {
    const int kk = q2 * W8_X2 + k;
    wx2[k] = on2 && kk < S ? __ldg(sW2T + (size_t)kk * S + e2) : 0.0f;
  }
  if (j == 0) {
    for (int f = 0; f < nslot; ++f) mbar_init(&full[f], 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int nbody = (T + U - 1) / U;
  auto refill = [&](int slot, int body) {
    const int t0 = body * U, n = min(U, T - t0);
    mbar_expect_tx(&full[slot], row_bytes * (unsigned)n);
    for (int i = 0; i < n; ++i)
      bulk_copy(ring + slot * slot_len + i * ld,
                xp + ((size_t)(t0 + i) * B + b0) * ld, row_bytes,
                &full[slot]);
  };
  if (j == 0) {
    fence_proxy_async();
    for (int f = 0; f < nslot && f < nbody; ++f) refill(f, f);
  }

  float h = 0.0f;                 // state c (both lanes of the pair)
  int slot = 0, u = 0;
  unsigned parity = 0;
#ifdef GRU_UNROLL_CLOCKS
  PHASE_CLOCK_START();
#endif
  for (int t = 0; t < T; ++t) {
    if (u == 0) mbar_wait_tested(&full[slot], parity);
    UNROLL_CLOCK(0);
    const float* xs = ring + slot * slot_len + u * ld;

    // z / r of state c; then the extra gate column, joined over 8 lanes
    float acc[1], rest[1];
    dot_reg<1, W8_KR>(acc, hv, w1r);
    dot_col<1>(rest, hv + W8_KR, [&](int k) { return w1[k * W8_THREADS + j]; },
               K1);
    float ax = 0.0f;
#pragma unroll
    for (int k = 0; k < W8_X1; ++k) ax = fmaf(hv[q1 * W8_X1 + k], wx1[k], ax);
#pragma unroll
    for (int m = 1; m < 8; m <<= 1) ax += __shfl_xor_sync(0xffffffffu, ax, m);
    UNROLL_CLOCK(1);
    const float g = sigmoid_f32(xs[col1] + (acc[0] + rest[0]));
    if (half) rhT[c] = g * h;
    const float gx = sigmoid_f32(xs[on1 ? colx1 : 0] + ax);
    if (on1 && q1 == 0) {
      if (x1 & 1)
        rhT[e1] = gx * hv[e1];
      else
        zx[e1 - W8_MAIN] = gx;
    }
    UNROLL_CLOCK(2);
    __syncthreads();
    UNROLL_CLOCK(3);

    // the candidate of state c over the pair; the extra candidate column,
    // joined over 16 lanes
    dot_reg<1, W8_KH2>(acc, rhT + half * W8_KH2, w2r);
    acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 1);
    float a2 = 0.0f;
#pragma unroll
    for (int k = 0; k < W8_X2; ++k) a2 = fmaf(rhT[q2 * W8_X2 + k], wx2[k], a2);
#pragma unroll
    for (int m = 1; m < 16; m <<= 1) a2 += __shfl_xor_sync(0xffffffffu, a2, m);
    UNROLL_CLOCK(4);
    const float z = __shfl_sync(0xffffffffu, g, 0, 2);
    const float hbar = tanhf(xs[S2 + c] + acc[0]);
    h = __fadd_rn(__fmul_rn(z, h), __fmul_rn(1.0f - z, hbar));
    if (!half) hv[c] = h;
    float hx = 0.0f;
    if (on2) {
      const float zz = zx[x2];
      const float hbx = tanhf(xs[S2 + e2] + a2);
      hx = __fadd_rn(__fmul_rn(zz, hv[e2]), __fmul_rn(1.0f - zz, hbx));
    }
    __syncwarp();                 // every lane has read hv[e2]
    if (on2 && q2 == 0) hv[e2] = hx;
    UNROLL_CLOCK(5);
    __syncthreads();
    UNROLL_CLOCK(6);
    if (++u == U) {
      const int next = t / U + nslot;
      if (j == 0 && next < nbody) refill(slot, next);
      u = 0;
      if (++slot == nslot) {
        slot = 0;
        parity ^= 1u;
      }
    }
    if (!half) out[((size_t)t * B + b0) * S + c] = h;
    if (on2 && q2 == 0) out[((size_t)t * B + b0) * S + e2] = hx;
  }
#ifdef GRU_UNROLL_CLOCKS
  clk[7] = PHASE_CLOCK_TOTAL();
  if (blockIdx.x == 0 && lane == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) gru_unroll_clocks[w * 8 + k] = clk[k];
  }
#endif
}

template <int BR, int KR, int KH2, bool BF16>
int launch(const void* xp, const void* sWT, const void* sW2T, void* out,
           int T, int B, int S, int ld, int U, int nslot, int stage1,
           int stage2, int smem, int threads, cudaStream_t stream) {
  if (threads > MaxThreads<KH2>::value) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gru_unroll_kernel<BR, KR, KH2, BF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  gru_unroll_kernel<BR, KR, KH2, BF16>
      <<<(B + BR - 1) / BR, threads, smem, stream>>>(
          (const float*)xp, (const float*)sWT, (const float*)sW2T,
          (float*)out, T, B, S, ld, U, nslot, stage1, stage2);
  return (int)cudaGetLastError();
}

template <int KR, int KH2, bool BF16>
int by_rows(int br, const void* xp, const void* sWT, const void* sW2T,
            void* out, int T, int B, int S, int ld, int U, int nslot,
            int stage1, int stage2, int smem, int threads, cudaStream_t s) {
#define GRU_UNROLL_LAUNCH(BR)                                             \
  launch<BR, KR, KH2, BF16>(xp, sWT, sW2T, out, T, B, S, ld, U, nslot,   \
                            stage1, stage2, smem, threads, s)
  switch (br) {
    case 1: return GRU_UNROLL_LAUNCH(1);
    case 2: return GRU_UNROLL_LAUNCH(2);
    case 4: if constexpr (KH2 != 72) return GRU_UNROLL_LAUNCH(4); break;
    case 8: if constexpr (KH2 != 72) return GRU_UNROLL_LAUNCH(8); break;
  }
#undef GRU_UNROLL_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <bool BF16>
int by_mode(int kr, int kh2, int br, const void* xp, const void* sWT,
            const void* sW2T, void* out, int T, int B, int S, int ld, int U,
            int nslot, int stage1, int stage2, int smem, int threads,
            cudaStream_t s) {
#define GRU_UNROLL_BY_ROWS(KR, KH2)                                       \
  by_rows<KR, KH2, BF16>(br, xp, sWT, sW2T, out, T, B, S, ld, U, nslot,  \
                         stage1, stage2, smem, threads, s)
  if (kr == 0 && kh2 == 0) return GRU_UNROLL_BY_ROWS(0, 0);
  if (kr == 96 && kh2 == 48) return GRU_UNROLL_BY_ROWS(96, 48);
  if constexpr (BF16) {
    if (kr == 144 && kh2 == 72) return GRU_UNROLL_BY_ROWS(144, 72);
  } else {
    if (kr == 48 && kh2 == 72) return GRU_UNROLL_BY_ROWS(48, 72);
  }
#undef GRU_UNROLL_BY_ROWS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The launch plan comes from the caller (scripts/bench_gru_unroll.py::
// gru_unroll_plan): rows a block br, the register rows kr of sWT and kh2 of
// sW2T (0, 0: mode SMEM), ring slots nslot (1-4) of U time rows, whether
// the weights not in registers are staged (stage1 sWT, stage2 sW2T), smem
// bytes and threads (2S rounded up to a warp).  xp is (T, B, ld) with ld
// >= 3S a multiple of 4, 16-byte aligned; bf16 != 0 for precision
// "default".
extern "C" int gru_unroll(const void* xp, const void* sWT, const void* sW2T,
                          void* out, int T, int B, int S, int ld, int U,
                          int bf16, int br, int kr, int kh2, int nslot,
                          int stage1, int stage2, int smem, int threads,
                          void* stream) {
  if (U < 1 || nslot < 1 || nslot > kMaxSlots || ld < 3 * S || ld % 4 ||
      (uintptr_t)xp % 16 || threads % 32 ||
      (threads < 2 * S && kr != W8_KR) ||
      (kr > 0 && kr < S && !stage1) || (kh2 > 0 && 2 * kh2 < S))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (kr == W8_KR && kh2 == W8_KH2) {
    // the 8-warp layout: f32, one row a block, 128 < S <= 144
    if (bf16 || br != 1 || S <= W8_MAIN || S > 2 * W8_KH2 ||
        threads != W8_THREADS)
      return (int)cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        gru_unroll_w8, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    gru_unroll_w8<<<B, W8_THREADS, smem, s>>>(
        (const float*)xp, (const float*)sWT, (const float*)sW2T, (float*)out,
        T, B, S, ld, U, nslot);
    return (int)cudaGetLastError();
  }
  if (bf16)
    return by_mode<true>(kr, kh2, br, xp, sWT, sW2T, out, T, B, S, ld, U,
                         nslot, stage1, stage2, smem, threads, s);
  return by_mode<false>(kr, kh2, br, xp, sWT, sW2T, out, T, B, S, ld, U,
                        nslot, stage1, stage2, smem, threads, s);
}

#ifdef GRU_UNROLL_CLOCKS
// copy the step-phase clocks of the last launch, [warp][8], to host memory
extern "C" int gru_unroll_clocks_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, gru_unroll_clocks,
                                   sizeof(gru_unroll_clocks));
}
#endif
