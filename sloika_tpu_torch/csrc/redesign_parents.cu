// The parents of the two kernels redesigned for Hopper in the port's last
// kernel redesign, kept only so that chip_smoke.py can time each new design
// beside the design it replaced, in one process on one card.  Nothing on a
// path of the port loads this library: sloika_tpu_torch/scripts/
// redesign_parents.py is its only loader, and chip_smoke.py its only user.
//
// remap_banded_wide_parent: the banded remap DP's wide route (windows of
// 16,385 .. 32,767 positions) as csrc/remap_banded.cu had it before its
// cluster design: one block of 1,024 threads a row, ceil(W / 1024)
// contiguous positions a thread, the window's scores, prefix maxima and
// their positions in device memory.  viterbi_back_general_parent: the
// general Viterbi backtrace as csrc/viterbi_back.cu had it before its ring
// design: one thread a row walking the codes in device memory.  Both give
// the bits of the port's kernels (the same rounding and tie rules).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1.0e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void later(float& av, int& ai, float bv, int bi) {
  const bool take = bv > av;
  av = take ? bv : av;
  ai = take ? bi : ai;
}

// The parent wide route.  A step: (1) each thread's running max of y = p +
// slip*j over its positions, a __shfl_up_sync scan of those in the warp,
// lane 31 publishes the warp's total; barrier; (2) the serial fold of the
// warp totals before the thread's warp, each position's prefix max and its
// position written to scratch, the traceback row of the step before copied
// out of shared memory; barrier; (3) the update at every position, its
// delta staged in shared memory by the parity of t.
constexpr int kWideThreads = 1024;

__global__ void __launch_bounds__(kWideThreads)
remap_banded_wide_kernel(const float* __restrict__ lt,
                         const int32_t* __restrict__ seq,
                         const uint8_t* __restrict__ pos_mask,
                         const float* __restrict__ prior0,
                         const int32_t* __restrict__ starts,
                         int16_t* __restrict__ tb, float* __restrict__ vfinal,
                         float* scratch, int T, int B, int NS, int P, int W,
                         int Tp, int ppt, float slip) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Wc = ppt * kWideThreads;
  int16_t* stage = reinterpret_cast<int16_t*>(smem);     // [2][Wc] deltas
  __shared__ float wtot_v[kWideThreads / 32];
  __shared__ int wtot_i[kWideThreads / 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j0 = tid * ppt;
  const int32_t* seq_b = seq + (size_t)b * P;
  const uint8_t* mask_b = pos_mask + (size_t)b * P;
  float* pc = scratch + (size_t)b * 4 * Wc;   // scores, this step
  float* pn = pc + Wc;                        // scores, the next
  float* ys = pn + Wc;                        // prefix max
  int* yi = reinterpret_cast<int*>(ys + Wc);  // its position

  // copy staged traceback row t (buffer t & 1) to device memory
  auto flush = [&](int t) {
    const int16_t* src = stage + (size_t)(t & 1) * Wc;
    int16_t* dst = tb + ((size_t)t * B + b) * W;
    for (int j = tid; j < W; j += kWideThreads) dst[j] = src[j];
  };

  // t = 0: the initialisation row (sloika_tpu/ops/pallas/remap.py:311-315)
  int s_prev = starts[b];
  {
    const float* row = lt + (size_t)b * NS;
    const float stay0 = row[0];
    for (int i = 0; i < ppt; ++i) {
      const int j = j0 + i;
      const int a = s_prev + j;
      const int idx = min(max(a, 0), P - 1);
      const bool ok = j < W && a < P && mask_b[idx];
      const float em = ok ? row[min(max(seq_b[idx], 0), NS - 1)] : kNeg;
      pc[j] = em > kNeg * 0.5f
                  ? __fadd_rn(prior0[(size_t)b * P + idx], fmaxf(em, stay0))
                  : kNeg;
      stage[j] = 0;
    }
  }
  for (int t = 1; t < Tp; ++t) {
    const int s = starts[(size_t)t * B + b];
    const int d = s - s_prev;
    // 1. the thread's running max of y, then the warp's inclusive scan
    // (the earlier total wins ties)
    float bv = -INFINITY;
    int bi = 0;
    for (int i = 0; i < ppt; ++i) {
      const int j = j0 + i;
      later(bv, bi, __fadd_rn(pc[j], __fmul_rn(slip, (float)j)), j);
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float ov = __shfl_up_sync(kFull, bv, o);
      const int oi = __shfl_up_sync(kFull, bi, o);
      const bool take = lane >= o && !(bv > ov);
      bv = take ? ov : bv;
      bi = take ? oi : bi;
    }
    float ev = __shfl_up_sync(kFull, bv, 1);
    int ei = __shfl_up_sync(kFull, bi, 1);
    if (lane == 31) {
      wtot_v[warp] = bv;
      wtot_i[warp] = bi;
    }
    __syncthreads();
    // 2. the prefix max before this thread's positions: the warps before
    // this one, then the lanes before this one, then through its positions
    float cv = -INFINITY;
    int ci = 0;
    for (int k = 0; k < warp; ++k) later(cv, ci, wtot_v[k], wtot_i[k]);
    if (lane > 0) later(cv, ci, ev, ei);
    for (int i = 0; i < ppt; ++i) {
      const int j = j0 + i;
      later(cv, ci, __fadd_rn(pc[j], __fmul_rn(slip, (float)j)), j);
      ys[j] = cv;
      yi[j] = ci;
    }
    flush(t - 1);
    __syncthreads();
    // 3. stay, then step, then slip, each under strict >
    const bool live = t < T;
    const float* row = lt + ((size_t)(live ? t : 0) * B + b) * NS;
    const float stay = live ? row[0] : 0.0f;
    const float df = (float)d;
    int16_t* st_row = stage + (size_t)(t & 1) * Wc;
    for (int i = 0; i < ppt; ++i) {
      const int j = j0 + i;
      const int a = s + j;
      const int idx = min(max(a, 0), P - 1);
      const bool ok = j < W && a < P && mask_b[idx];
      const float em =
          (ok && live) ? row[min(max(seq_b[idx], 0), NS - 1)] : kNeg;
      const int src = j + d;
      const float q = (src >= 0 && src < W) ? pc[src] : kNeg;
      const float qm1 = (j > 0 && src >= 1 && src - 1 < W) ? pc[src - 1] : kNeg;
      const float z = (src >= 2 && src < W) ? ys[src - 2] : kNeg;
      float c = __fadd_rn(q, stay);
      int delta = 0;
      const float step = __fadd_rn(qm1, em);
      if (step > c) {
        c = step;
        delta = 1;
      }
      const float fs = __fsub_rn(
          z, __fmul_rn(slip, __fadd_rn(__fsub_rn((float)j, 1.0f), df)));
      const float sl = __fadd_rn(fs, em);
      if (sl > c) {
        int zw = src - 2;              // the twin's roll: mod W
        if (zw < 0) zw += W;
        else if (zw >= W) zw %= W;
        delta = src - yi[zw];
        c = sl;
      }
      pn[j] = ok ? c : kNeg;
      st_row[j] = (int16_t)delta;
    }
    float* tmp = pc;
    pc = pn;
    pn = tmp;
    s_prev = s;
  }
  __syncthreads();
  flush(Tp - 1);
  for (int i = 0; i < ppt; ++i) {
    const int j = j0 + i;
    if (j < W) vfinal[(size_t)b * W + j] = pc[j];
  }
}

// The parent general backtrace: a thread a row walks the codes in device
// memory, a chain of T - 1 dependent loads.
__global__ void __launch_bounds__(32)
viterbi_back_general_kernel(const int8_t* __restrict__ tb,
                            const int32_t* __restrict__ last_state,
                            int32_t* __restrict__ path,
                            uint8_t* __restrict__ moved, int T, int B, int K,
                            int nbase) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int nskip = nbase * nbase;
  const int nrs = K / nbase, nrk = K / nskip;
  int state = last_state[b];
  int32_t* p = path + (size_t)b * T;
  uint8_t* m = moved + (size_t)b * T;
  for (int t = T - 1; t > 0; --t) {
    const int c = tb[((size_t)t * B + b) * K + state];
    p[t] = state;
    m[t] = (uint8_t)(c >= 0);
    if (c >= nbase)
      state = (c - nbase) * nrk + state / nskip;
    else if (c >= 0)
      state = c * nrs + state / nbase;
  }
  p[0] = state;
  m[0] = 0;
}

}  // namespace

// The parent wide route (remap_banded_wide_kernel): the same arguments as
// remap_banded but for the plan's ppt (ceil(W / 1024)) and smem (2 * ppt *
// 1024 * 2 bytes of staged traceback rows), and scratch, (B, 4, ppt *
// 1024) floats of device memory.  Returns the launch's cudaError_t;
// cudaErrorInvalidValue (1) for a window outside 1..32,767 or a plan that
// does not cover it.
extern "C" int remap_banded_wide_parent(const void* lt, const void* seq,
                                        const void* pos_mask,
                                        const void* prior0,
                                        const void* starts, void* tb,
                                        void* vfinal, void* scratch, int T,
                                        int B, int NS, int P, int W, int Tp,
                                        float slip, int ppt, int smem,
                                        void* stream) {
  if (W < 1 || W > 32767 || ppt < 1 || ppt * kWideThreads < W || T < 1 ||
      Tp < T || smem < 4 * ppt * kWideThreads || (uintptr_t)lt % 4)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      remap_banded_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  remap_banded_wide_kernel<<<B, kWideThreads, smem, (cudaStream_t)stream>>>(
      (const float*)lt, (const int32_t*)seq, (const uint8_t*)pos_mask,
      (const float*)prior0, (const int32_t*)starts, (int16_t*)tb,
      (float*)vfinal, (float*)scratch, T, B, NS, P, W, Tp, ppt, slip);
  return (int)cudaGetLastError();
}

// The parent general backtrace (viterbi_back_general_kernel): tb (T, B, K)
// int8 of K = nbase^klen states over nbase bases, nbase + nbase^2 <= 128;
// last_state (B,) int32; path (B, T) int32; moved (B, T) uint8.  Returns
// the cudaError_t of the launch; cudaErrorInvalidValue (1) for shapes it
// does not take.
extern "C" int viterbi_back_general_parent(const void* tb,
                                           const void* last_state,
                                           void* path, void* moved, int T,
                                           int B, int K, int nbase,
                                           void* stream) {
  if (T < 1 || B < 1 || nbase < 2 || nbase + nbase * nbase > 128 ||
      K < nbase * nbase || K % (nbase * nbase))
    return (int)cudaErrorInvalidValue;
  viterbi_back_general_kernel<<<(B + 31) / 32, 32, 0,
                                (cudaStream_t)stream>>>(
      (const int8_t*)tb, (const int32_t*)last_state, (int32_t*)path,
      (uint8_t*)moved, T, B, K, nbase);
  return (int)cudaGetLastError();
}
