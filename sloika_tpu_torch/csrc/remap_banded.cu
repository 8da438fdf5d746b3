// Banded sequence-remap Viterbi forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sloika_tpu/ops/pallas/remap.py::
// _banded_kernel (driven by map_to_sequence_banded :259).  Each batch row
// aligns its frames to a window of W sequence positions starting at
// starts[t, b]; between frames a position stays, steps one forward, or slips
// k >= 2 forward at slip per skipped position.  For t >= 1 and window lane j:
//
//   y[i]   = p[i] + slip*i, prefix-maxed over i (earlier i wins ties) -> ys, yi
//   d      = starts[t] - starts[t-1]            (in [0, TB], 0 inside blocks)
//   q      = j+d < W ? p[j+d] : NEG             (stay source, realigned)
//   qm1    = j > 0 ? q[j-1] : NEG               (step source)
//   z, zi  = 2 <= j+d < W ? ys/yi[j+d-2] : NEG  (slip source, old coordinates)
//   cs     = q + stay;  delta = 0
//   step   = qm1 + emit;  if step > cs: cs = step, delta = 1
//   fs     = z - slip*((j - 1) + d);  if fs + emit > cs: delta = j+d-zi, ...
//   p'[j]  = valid[j] ? cs : NEG
//
// and writes traceback[t, b, j] = delta (int16) and, after the last frame,
// vfinal[b, j] = p[j].  Row t = 0 holds the initialisation
// prior_initial + fmax(emit_0, stay_0) on valid lanes, and a zero traceback.
// Frames t >= T are stays: NEG emissions, stay score 0.  The emissions are
// gathered here from the time-major log-posterior lt (T, B, NS) at the
// window's emission states (the JAX package builds them outside its kernel).
// Every sum and product is rounded on its own (__fadd_rn, __fmul_rn): no
// fused multiply-add, so the scores and deltas are bit-identical to the
// plain PyTorch twin's.
//
// What bounds it.  The DP is sequential in t and independent across rows:
// 35,584 dependent steps at the remap main path's shapes (T = 35,429
// frames, B = 64, W = 768).  Its bytes, the whole posterior read once
// (9.3 GB) and the int16 traceback written once (3.5 GB), take ~3.8 ms at
// 3.35 TB/s; the chain of steps, each a prefix max across the window and
// two block barriers, takes far longer.  So it is bound by the latency of
// a step, not by bytes or operations.
//
// What the design does about it.  One block per batch row runs all steps,
// with the carried scores (double-buffered), the prefix maxima and their
// positions in shared memory (14 bytes a position; W up to 16,384).  Each
// thread owns ppt contiguous positions (256 threads x 3 at W = 768).  The
// prefix max, a Hillis-Steele scan of log2(W) lane rolls on the TPU, is a
// sequential pass over each thread's positions, a warp __shfl_up_sync scan
// and a fold of the warp totals: two barriers a step, not log2(W).  Since
// ties go to the earlier position under any order of combination, the
// result equals the TPU scan's wherever it can win (see the plain twin's
// test).  The realignment by d, log2(TB) conditional lane rolls on the TPU,
// is one shifted shared-memory read.  The emissions of step t+1 and the
// window start of step t+2 are loaded while step t runs, so their
// global-memory latency is off the chain except at block boundaries,
// where the window's emission states are read anew.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1.0e30f;   // NEG_LARGE, sloika_tpu/ops/remap_jax.py:29
constexpr unsigned kFull = 0xffffffffu;

// The states and validity bits of a thread's positions for the window
// starting at s (_block_emissions :230-242, by gather).
template <int MAXP>
__device__ __forceinline__ void window(int s, int j0, int np, int P, int NS,
                                       const int32_t* __restrict__ seq_b,
                                       const uint8_t* __restrict__ mask_b,
                                       int (&st)[MAXP], unsigned& ok) {
  ok = 0u;
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    if (i < np) {
      const int a = s + j0 + i;
      const int idx = min(max(a, 0), P - 1);
      // clamped so a bad state can never address outside the row
      st[i] = min(max(seq_b[idx], 0), NS - 1);
      if (a < P && mask_b[idx]) ok |= 1u << i;
    }
  }
}

// The emissions and stay score of frame t for those positions.
template <int MAXP>
__device__ __forceinline__ void emissions(const float* __restrict__ lt,
                                          int t, int T, int B, int b, int NS,
                                          int np, const int (&st)[MAXP],
                                          unsigned ok, float (&em)[MAXP],
                                          float& stay) {
  const bool live = t < T;
  const float* row = lt + ((size_t)(live ? t : 0) * B + b) * NS;
  stay = live ? row[0] : 0.0f;
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    if (i < np) em[i] = (live && ((ok >> i) & 1u)) ? row[st[i]] : kNeg;
  }
}

template <int MAXP, int MAXT>
__global__ void __launch_bounds__(MAXT)
remap_banded_kernel(const float* __restrict__ lt,
                    const int32_t* __restrict__ seq,
                    const uint8_t* __restrict__ pos_mask,
                    const float* __restrict__ prior0,
                    const int32_t* __restrict__ starts,
                    int16_t* __restrict__ tb, float* __restrict__ vfinal,
                    int T, int B, int NS, int P, int W, int Tp, int ppt,
                    float slip) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* pbuf0 = reinterpret_cast<float*>(smem);
  float* pbuf1 = pbuf0 + W;
  float* ys = pbuf1 + W;
  int16_t* yi = reinterpret_cast<int16_t*>(ys + W);
  __shared__ float warp_v[32];
  __shared__ int warp_i[32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j0 = tid * ppt;
  const int np = max(0, min(ppt, W - j0));
  const int32_t* seq_b = seq + (size_t)b * P;
  const uint8_t* mask_b = pos_mask + (size_t)b * P;

  int st[MAXP];
  unsigned ok_n;
  float em_n[MAXP], stay_n;

  // t = 0: the initialisation row (sloika_tpu/ops/pallas/remap.py:311-315)
  int s_prev = starts[b];
  window<MAXP>(s_prev, j0, np, P, NS, seq_b, mask_b, st, ok_n);
  emissions<MAXP>(lt, 0, T, B, b, NS, np, st, ok_n, em_n, stay_n);
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    if (i < np) {
      const int j = j0 + i;
      const float p0w = prior0[(size_t)b * P + min(max(s_prev + j, 0), P - 1)];
      pbuf0[j] = em_n[i] > kNeg * 0.5f
                     ? __fadd_rn(p0w, fmaxf(em_n[i], stay_n)) : kNeg;
      tb[(size_t)b * W + j] = 0;
    }
  }

  // inputs of step 1, and the window start of step 2
  int s_n1 = Tp > 1 ? starts[(size_t)B + b] : s_prev;
  int s_n2 = Tp > 2 ? starts[(size_t)2 * B + b] : s_n1;
  if (Tp > 1) {
    if (s_n1 != s_prev)
      window<MAXP>(s_n1, j0, np, P, NS, seq_b, mask_b, st, ok_n);
    emissions<MAXP>(lt, 1, T, B, b, NS, np, st, ok_n, em_n, stay_n);
  }

  for (int t = 1; t < Tp; ++t) {
    const int s = s_n1;
    const int d = s - s_prev;
    const unsigned ok_c = ok_n;
    const float stay_c = stay_n;
    float em_c[MAXP];
#pragma unroll
    for (int i = 0; i < MAXP; ++i) em_c[i] = em_n[i];

    // load the next step's inputs while this one runs
    s_n1 = s_n2;
    if (t + 2 < Tp) s_n2 = starts[(size_t)(t + 2) * B + b];
    if (t + 1 < Tp) {
      if (s_n1 != s)
        window<MAXP>(s_n1, j0, np, P, NS, seq_b, mask_b, st, ok_n);
      emissions<MAXP>(lt, t + 1, T, B, b, NS, np, st, ok_n, em_n, stay_n);
    }

    const float* p_old = (t & 1) ? pbuf0 : pbuf1;
    float* p_new = (t & 1) ? pbuf1 : pbuf0;

    // prefix max of y = p + slip*i: this thread's positions in order...
    float ly[MAXP];
    int li[MAXP];
    float bv = -INFINITY;
    int bi = 0;
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      if (i < np) {
        const int j = j0 + i;
        const float y = __fadd_rn(p_old[j], __fmul_rn(slip, (float)j));
        if (i == 0 || y > bv) {
          bv = y;
          bi = j;
        }
        ly[i] = bv;
        li[i] = bi;
      }
    }
    // ...then across the warp (the earlier lane's total wins ties)...
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float ov = __shfl_up_sync(kFull, bv, off);
      const int oi = __shfl_up_sync(kFull, bi, off);
      if (lane >= off && !(bv > ov)) {
        bv = ov;
        bi = oi;
      }
    }
    const float ev = __shfl_up_sync(kFull, bv, 1);
    const int ei = __shfl_up_sync(kFull, bi, 1);
    if (lane == 31) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();
    // ...then the totals of the warps before this one
    float xv = -INFINITY;
    int xi = 0;
    for (int w = 0; w < warp; ++w) {
      if (warp_v[w] > xv) {
        xv = warp_v[w];
        xi = warp_i[w];
      }
    }
    if (lane > 0 && ev > xv) {
      xv = ev;
      xi = ei;
    }
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      if (i < np) {
        const bool own = ly[i] > xv;
        ys[j0 + i] = own ? ly[i] : xv;
        yi[j0 + i] = (int16_t)(own ? li[i] : xi);
      }
    }
    __syncthreads();

    // realign by d; stay, then step, then slip, each under strict >
    const float df = (float)d;
    int16_t* tb_row = tb + ((size_t)t * B + b) * W;
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      if (i < np) {
        const int j = j0 + i;
        const int src = j + d;
        const float q = (src >= 0 && src < W) ? p_old[src] : kNeg;
        const float qm1 = (j > 0 && src >= 1 && src - 1 < W) ? p_old[src - 1]
                                                            : kNeg;
        const float z = (src >= 2 && src < W) ? ys[src - 2] : kNeg;
        int zw = (src - 2) % W;
        if (zw < 0) zw += W;
        float cs = __fadd_rn(q, stay_c);
        int delta = 0;
        const float step = __fadd_rn(qm1, em_c[i]);
        if (step > cs) {
          cs = step;
          delta = 1;
        }
        const float fs = __fsub_rn(
            z, __fmul_rn(slip, __fadd_rn(__fsub_rn((float)j, 1.0f), df)));
        const float sl = __fadd_rn(fs, em_c[i]);
        if (sl > cs) {
          delta = j + d - (int)yi[zw];
          cs = sl;
        }
        p_new[j] = ((ok_c >> i) & 1u) ? cs : kNeg;
        tb_row[j] = (int16_t)delta;
      }
    }
    s_prev = s;
  }

  const float* p_last = ((Tp - 1) & 1) ? pbuf1 : pbuf0;
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    if (i < np) vfinal[(size_t)b * W + j0 + i] = p_last[j0 + i];
  }
}

template <int MAXP, int MAXT>
int launch(const void* lt, const void* seq, const void* pos_mask,
           const void* prior0, const void* starts, void* tb, void* vfinal,
           int T, int B, int NS, int P, int W, int Tp, int threads, int ppt,
           float slip, cudaStream_t stream) {
  const size_t smem = (size_t)W * 14;
  auto kernel = remap_banded_kernel<MAXP, MAXT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, threads, smem, stream>>>(
      (const float*)lt, (const int32_t*)seq, (const uint8_t*)pos_mask,
      (const float*)prior0, (const int32_t*)starts, (int16_t*)tb,
      (float*)vfinal, T, B, NS, P, W, Tp, ppt, slip);
  return (int)cudaGetLastError();
}

}  // namespace

// lt (T, B, NS) f32; seq (B, P) int32; pos_mask (B, P) uint8; prior0 (B, P)
// f32; starts (Tp, B) int32; tb (Tp, B, W) int16; vfinal (B, W) f32.
// Returns the cudaError_t of the launch; cudaErrorInvalidValue (1) for a
// window wider than 16,384 positions.
extern "C" int remap_banded(const void* lt, const void* seq,
                            const void* pos_mask, const void* prior0,
                            const void* starts, void* tb, void* vfinal, int T,
                            int B, int NS, int P, int W, int Tp, float slip,
                            void* stream) {
  if (W < 1 || W > 16384) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // about three positions a thread up to 256 threads, then up to 16
  int threads = min(256, (((W + 2) / 3 + 31) / 32) * 32);
  if (W > 256 * 16) threads = (((W + 15) / 16 + 31) / 32) * 32;
  const int ppt = (W + threads - 1) / threads;
  if (ppt <= 4)
    return launch<4, 256>(lt, seq, pos_mask, prior0, starts, tb, vfinal, T, B,
                          NS, P, W, Tp, threads, ppt, slip, s);
  if (threads <= 256)
    return launch<16, 256>(lt, seq, pos_mask, prior0, starts, tb, vfinal, T,
                           B, NS, P, W, Tp, threads, ppt, slip, s);
  return launch<16, 1024>(lt, seq, pos_mask, prior0, starts, tb, vfinal, T, B,
                          NS, P, W, Tp, threads, ppt, slip, s);
}
