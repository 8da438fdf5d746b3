// The CTC-CRF decode of bonito's CRF basecallers (dna_r9.4.1_e8_hac@v3.3)
// for Hopper (sm_90a): transition posteriors by forward-backward, then a
// Viterbi over their logs and its backtrace, for each row of a batch of
// score frames.
//
// It replaces no Pallas kernel: the JAX package has no CRF model.  bonito
// decodes with seqdist's CTC_CRF (posteriors, then viterbi on their logs);
// this is that arithmetic in float32, written out by ops/crf_decode.py's
// plain twin, crf_decode_plain, which the CPU runs.
//
// Contract.  scores (T, B, 5N) f32 are a row's transition scores per frame,
// viewed as M[t][s][k], N = 4^state_len states, k = 0 the stay into s from
// s and k = 1..4 the step into s from idx(s, k) = (k - 1) N/4 + s / 4.  A
// row has n = min(lengths[b], T) valid frames; frames past them are not
// read.  With a(s) and b(s) the forward and backward log-sums, each kept
// relative to its state 0 (the offsets cancel),
//
//   b_n = 0;   b_t(j)   = lse over (s, k) into j of M[t][s][k] + b_t+1(s)
//   a_0 = 0;   a_t+1(s) = lse_k a_t(idx(s, k)) + M[t][s][k]
//   P[t][s][k] = softmax over the frame's 5N transitions of
//                a_t(idx(s, k)) + M[t][s][k] + b_t+1(s)
//   v_0 = 0;   v_t+1(s) = max_k v_t(idx(s, k)) + log(P[t][s][k] + 1e-8)
//
// (the frame's softmax is exp(a + M + b - logZ) in exact arithmetic; it
// spares the cancellation of sums of 2,000 frames against logZ in f32).  v
// is kept relative to its state 0 too, the offsets summed in double.  The
// first of equal maxima wins, for the backpointer k and the final state.
// score[b] = max_s v_n(s); labels[b][t] is the best path's k at frame t
// (0 from frame n on): k >= 1 emits base k - 1 of ACGT.
//
// Design.  A block of N threads (at least a warp) owns a row; thread j owns
// state j.  crf_beta_kernel walks the row's frames down from n - 1 and
// writes b_t+1 (T, B, N); crf_forward_kernel walks them up, forms P on the
// fly (the posterior never reaches device memory), writes a uint8
// backpointer a state a frame, then backtraces the row itself.  Each step
// reads its frame's scores (and b) from a ring of kSlots slots in shared
// memory that one thread refills by bulk asynchronous copies kSlots - 1
// frames ahead; a and v live in double buffers, so a step takes one barrier
// (the forward two: its softmax's sum crosses the warps).  The backtrace
// stages kChunk frames' backpointers (N bytes a frame) in the ring's room,
// the next chunk loading while thread 0 walks the last.
//
// What bounds it.  The scores are read twice (once a pass) and b written and
// read once: ~6 N floats a frame against the 5 N the work needs, at 3.35
// TB/s.  A step is a chain of dependent exp/log and a barrier or two, so
// one row is latency-bound; the batch's rows run side by side (B = 512 rows
// fit the card's SMs at four blocks each).  Plain f32, accurate expf and
// logf (no fast-math).
#include <type_traits>

#include "recurrence.cuh"

namespace {

constexpr int kSlots = 4;          // ring slots (frames in flight)
constexpr int kBarFloats = 16;     // the slots' mbarriers, 64 bytes
constexpr int kChunk = 32;         // backtrace frames a chunk

template <int N>
struct Shape {
  static constexpr int Q = N / 4;              // states a step group
  static constexpr int C = 5 * N;              // scores a frame
  static constexpr int THREADS = N < 32 ? 32 : N;
  static constexpr int WARPS = THREADS / 32;
};

__device__ __forceinline__ float lse5(const float (&x)[5]) {
  float m = x[0];
#pragma unroll
  for (int k = 1; k < 5; ++k) m = fmaxf(m, x[k]);
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < 5; ++k) s += expf(x[k] - m);
  return m + logf(s);
}

// (m, s) of a log-sum-exp joined with (m2, s2); commutative, so every lane
// of a butterfly ends with the same bits
__device__ __forceinline__ void join_lse(float& m, float& s, float m2,
                                         float s2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) return;
  s = s * expf(m - mm) + s2 * expf(m2 - mm);
  m = mm;
}

// the predecessor of state s by transition k
template <int N>
__device__ __forceinline__ int pred(int s, int k) {
  return k == 0 ? s : (k - 1) * Shape<N>::Q + s / 4;
}

template <int N>
__global__ void __launch_bounds__(Shape<N>::THREADS)
crf_beta_kernel(const float* __restrict__ scores,
                const int* __restrict__ lengths, float* __restrict__ beta,
                int T, int B) {
  using Sh = Shape<N>;
  extern __shared__ float4 smem4[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);           // [kSlots]
  float* ring = reinterpret_cast<float*>(smem4) + kBarFloats;    // [kSlots][C]
  float* bb = ring + kSlots * Sh::C;                             // [2][N]
  const int j = threadIdx.x, b = blockIdx.x;
  const bool own = j < N;
  const int n = min(lengths[b], T);
  const unsigned bytes = Sh::C * 4u;
  auto frame = [&](int t) { return scores + ((size_t)t * B + b) * Sh::C; };

  if (own) bb[j] = 0.0f;
  if (j == 0) {
    for (int f = 0; f < kSlots; ++f) mbar_init(&full[f], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (j == 0) {
    for (int f = 0; f < kSlots && f < n; ++f) {
      mbar_expect_tx(&full[f], bytes);
      bulk_copy(ring + f * Sh::C, frame(n - 1 - f), bytes, &full[f]);
    }
  }
  int slot = 0;
  unsigned phase = 0;
  for (int i = 0; i < n; ++i) {
    const int t = n - 1 - i;
    const float* cur = bb + (i & 1) * N;
    float* nxt = bb + ((i & 1) ^ 1) * N;
    const float b0 = cur[0];
    if (own) beta[((size_t)t * B + b) * N + j] = cur[j] - b0;
    mbar_wait(&full[slot], phase);
    if (own) {
      const float* m = ring + slot * Sh::C;
      float x[5];
      x[0] = m[5 * j] + (cur[j] - b0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int s = 4 * (j % Sh::Q) + r;
        x[r + 1] = m[5 * s + j / Sh::Q + 1] + (cur[s] - b0);
      }
      nxt[j] = lse5(x);
    }
    __syncthreads();
    if (j == 0 && t - kSlots >= 0) {
      mbar_expect_tx(&full[slot], bytes);
      bulk_copy(ring + slot * Sh::C, frame(t - kSlots), bytes, &full[slot]);
    }
    if (++slot == kSlots) {
      slot = 0;
      phase ^= 1u;
    }
  }
}

// a chunk's backpointer units: 16 bytes where a frame has a multiple of 16
template <int N>
struct Units {
  using U = typename std::conditional<(N % 16 == 0), uint4, uint32_t>::type;
  static constexpr int PER_FRAME = N / (int)sizeof(U);
  static constexpr int PER_CHUNK = kChunk * PER_FRAME;
  static constexpr int PER_THREAD =
      (PER_CHUNK + Shape<N>::THREADS - 1) / Shape<N>::THREADS;
};

template <int N>
__global__ void __launch_bounds__(Shape<N>::THREADS)
crf_forward_kernel(const float* __restrict__ scores,
                   const int* __restrict__ lengths,
                   const float* __restrict__ beta, uint8_t* bp,
                   float* __restrict__ score, uint8_t* __restrict__ labels,
                   int T, int B) {
  using Sh = Shape<N>;
  using Un = Units<N>;
  using U = typename Un::U;
  constexpr int SLOT = Sh::C + N;                 // scores, then b_t+1
  extern __shared__ float4 smem4[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);
  float* ring = reinterpret_cast<float*>(smem4) + kBarFloats;  // [kSlots][SLOT]
  float* aa = ring + kSlots * SLOT;               // [2][N] a, raw
  float* vv = aa + 2 * N;                         // [2][N] v, raw
  float* red = vv + 2 * N;                        // [WARPS][2]
  const int j = threadIdx.x, b = blockIdx.x, lane = j & 31, w = j >> 5;
  const bool own = j < N;
  const int n = min(lengths[b], T);
  auto frame = [&](int t) { return (size_t)t * B + b; };

  if (own) aa[j] = vv[j] = 0.0f;
  if (j == 0) {
    for (int f = 0; f < kSlots; ++f) mbar_init(&full[f], 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto issue = [&](int f, int t) {
    mbar_expect_tx(&full[f], (Sh::C + N) * 4u);
    bulk_copy(ring + f * SLOT, scores + frame(t) * Sh::C, Sh::C * 4u,
              &full[f]);
    bulk_copy(ring + f * SLOT + Sh::C, beta + frame(t) * N, N * 4u, &full[f]);
  };
  if (j == 0)
    for (int f = 0; f < kSlots && f < n; ++f) issue(f, f);

  double off = 0.0;                   // thread 0: the v offsets summed
  int slot = 0;
  unsigned phase = 0;
  for (int t = 0; t < n; ++t) {
    const float* ac = aa + (t & 1) * N;
    const float* vc = vv + (t & 1) * N;
    float* an = aa + ((t & 1) ^ 1) * N;
    float* vn = vv + ((t & 1) ^ 1) * N;
    const float a0 = ac[0], v0 = vc[0];
    off += v0;
    mbar_wait(&full[slot], phase);
    const float* m = ring + slot * SLOT;
    float e[5], z[5];
    float mx = -INFINITY, sm = 0.0f;
    if (own) {
      const float bj = m[Sh::C + j];
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        e[k] = (ac[pred<N>(j, k)] - a0) + m[5 * j + k];
        z[k] = e[k] + bj;
        mx = fmaxf(mx, z[k]);
      }
#pragma unroll
      for (int k = 0; k < 5; ++k) sm += expf(z[k] - mx);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      join_lse(mx, sm, __shfl_xor_sync(0xffffffffu, mx, o),
               __shfl_xor_sync(0xffffffffu, sm, o));
    if (lane == 0) {
      red[2 * w] = mx;
      red[2 * w + 1] = sm;
    }
    __syncthreads();
    float zm = red[0], zs = red[1];
#pragma unroll
    for (int i = 1; i < Sh::WARPS; ++i)
      join_lse(zm, zs, red[2 * i], red[2 * i + 1]);
    const float logz = zm + logf(zs);
    if (own) {
      float best = -INFINITY;
      int kb = 0;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const float lp = logf(expf(z[k] - logz) + 1e-8f);
        const float c = (vc[pred<N>(j, k)] - v0) + lp;
        if (c > best) {
          best = c;
          kb = k;
        }
      }
      an[j] = lse5(e);
      vn[j] = best;
      bp[frame(t) * N + j] = (uint8_t)kb;
    }
    __syncthreads();
    if (j == 0 && t + kSlots < n) issue(slot, t + kSlots);
    if (++slot == kSlots) {
      slot = 0;
      phase ^= 1u;
    }
  }

  // the final state: the first of the largest v_n
  const float* vf = vv + (n & 1) * N;
  float bv = own ? vf[j] : -INFINITY;
  int bs = own ? j : N;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, bv, o);
    const int s2 = __shfl_xor_sync(0xffffffffu, bs, o);
    if (v2 > bv || (v2 == bv && s2 < bs)) {
      bv = v2;
      bs = s2;
    }
  }
  __syncthreads();                    // every read of red is done
  if (lane == 0) {
    red[2 * w] = bv;
    red[2 * w + 1] = __int_as_float(bs);
  }
  __syncthreads();
  if (j == 0) {
    for (int i = 1; i < Sh::WARPS; ++i) {
      const float v2 = red[2 * i];
      const int s2 = __float_as_int(red[2 * i + 1]);
      if (v2 > bv || (v2 == bv && s2 < bs)) {
        bv = v2;
        bs = s2;
      }
    }
    score[b] = n > 0 ? (float)(off + (double)bv) : 0.0f;
  }
  for (int t = n + j; t < T; t += blockDim.x) labels[(size_t)b * T + t] = 0;

  // the backtrace: chunks of kChunk frames down from n - 1, staged in the
  // ring's room (its copies have all landed), the next one loading while
  // thread 0 walks this one
  uint8_t* stage = reinterpret_cast<uint8_t*>(ring);   // [2][kChunk][N]
  const int nchunk = (n + kChunk - 1) / kChunk;
  U held[Un::PER_THREAD];
  auto load = [&](int c) {
    const int hi = n - c * kChunk, lo = max(0, hi - kChunk);
#pragma unroll
    for (int i = 0; i < Un::PER_THREAD; ++i) {
      const int u = j + i * Sh::THREADS;
      const int f = u / Un::PER_FRAME;
      if (u < Un::PER_CHUNK && lo + f < hi)
        held[i] = reinterpret_cast<const U*>(bp + frame(lo + f) * N)
            [u - f * Un::PER_FRAME];
    }
  };
  auto put = [&](int c) {
    const int hi = n - c * kChunk, lo = max(0, hi - kChunk);
    U* dst = reinterpret_cast<U*>(stage + (c & 1) * kChunk * N);
#pragma unroll
    for (int i = 0; i < Un::PER_THREAD; ++i) {
      const int u = j + i * Sh::THREADS;
      if (u < Un::PER_CHUNK && lo + u / Un::PER_FRAME < hi) dst[u] = held[i];
    }
  };
  __syncthreads();                    // the backpointers are in memory
  if (nchunk > 0) {
    load(0);
    put(0);
  }
  int s = bs;
  for (int c = 0; c < nchunk; ++c) {
    if (c + 1 < nchunk) load(c + 1);
    __syncthreads();                  // chunk c is staged
    if (j == 0) {
      const int hi = n - c * kChunk, lo = max(0, hi - kChunk);
      const uint8_t* ch = stage + (c & 1) * kChunk * N;
      for (int t = hi - 1; t >= lo; --t) {
        const int k = ch[(t - lo) * N + s];
        labels[(size_t)b * T + t] = (uint8_t)k;
        s = pred<N>(s, k);
      }
    }
    if (c + 1 < nchunk) put(c + 1);
  }
}

template <int N>
int launch(const void* scores, const void* lengths, void* beta, void* bp,
           void* score, void* labels, int T, int B, cudaStream_t stream) {
  using Sh = Shape<N>;
  const int beta_smem = (kBarFloats + kSlots * Sh::C + 2 * N) * 4;
  const int fwd_smem =
      (kBarFloats + kSlots * (Sh::C + N) + 4 * N + 2 * Sh::WARPS) * 4;
  static_assert((kSlots * (Sh::C + N)) * 4 >= 2 * kChunk * N,
                "the backtrace's chunks fit the ring");
  crf_beta_kernel<N><<<B, Sh::THREADS, beta_smem, stream>>>(
      (const float*)scores, (const int*)lengths, (float*)beta, T, B);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  crf_forward_kernel<N><<<B, Sh::THREADS, fwd_smem, stream>>>(
      (const float*)scores, (const int*)lengths, (const float*)beta,
      (uint8_t*)bp, (float*)score, (uint8_t*)labels, T, B);
  return (int)cudaGetLastError();
}

}  // namespace

// One call decodes a batch: crf_beta_kernel, then crf_forward_kernel, one
// block a row.  nstate N = 4^state_len, state_len 1-4; scores (T, B, 5N)
// f32, lengths (B,) int32, beta (T, B, N) f32 and bp (T, B, N) uint8
// scratch, score (B,) f32 and labels (B, T) uint8 out; every pointer
// 16-byte aligned.
extern "C" int crf_decode(const void* scores, const void* lengths,
                          void* beta, void* bp, void* score, void* labels,
                          int T, int B, int N, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  switch (N) {
    case 4: return launch<4>(scores, lengths, beta, bp, score, labels, T, B, s);
    case 16: return launch<16>(scores, lengths, beta, bp, score, labels, T, B, s);
    case 64: return launch<64>(scores, lengths, beta, bp, score, labels, T, B, s);
    case 256: return launch<256>(scores, lengths, beta, bp, score, labels, T, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
