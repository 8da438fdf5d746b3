// Peephole LSTM recurrent-weight and peephole cotangents for Hopper (sm_90a).
//
// The Pallas TPU kernel sloika_tpu/nn/pallas_lstm.py::_bwd_kernel sums
// these in its body, step by step, into VMEM scratch (:165-169), one slot
// per batch block, and the slots are summed afterwards (:230):
//
//     dsWT (S, 4S) = sum over rows n = (t, b) of h_prev[n]^T dxp[n]
//     dp[0] (S)    = sum over rows n of dxp[n, S:2S]  * c_prev[n]
//     dp[1] (S)    = sum over rows n of dxp[n, 2S:3S] * c_prev[n]
//     dp[2] (S)    = sum over rows n of dxp[n, 3S:]   * c_new[n]
//
// where h_prev and c_prev are the forward's h and c traces shifted one step
// towards the scan start (zeros at the first step) and c_new is the c trace
// itself.  At a masked step the trace holds the carried cell, not the fresh
// one, but dxp (csrc/lstm_bwd.cu) is zero there, so masked steps add
// nothing, as in the Pallas kernel.
//
// Design.  The product [S x N] . [N x 4S] over the N = T * B rows is split
// along N.  Each block owns one 32 x 64 output tile and one split of the
// rows; its 256 threads each hold a 2 x 4 tile of sums in registers, and
// 32-row slices of both operands pass through shared memory with coalesced
// loads (the tiling of csrc/gru_wgrad.cu).  One more block per split sums
// the three peephole columns: 4-8 threads a state column, each on every
// 4th-8th row, added in lane order.  Each block stores
// its partial sums to its own slot, and a last kernel adds the slots in a
// fixed order: no atomics, so the result has the same bits from run to run.
// The number of splits is chosen by the caller from the shapes alone.
//
// What bounds it.  At the training shapes (N = 50,000, S = 64) it is 1.6
// GFLOP of f32 FMA over 77 MB of operands: throughput work, with every
// block independent, unlike the recurrence.  This first version is a plain
// shared-memory tiled product (no tensor cores: the sums stay f32).
#include <cuda_runtime.h>

namespace {

constexpr int TI = 32;     // output rows (index i < S) per tile
constexpr int TC = 64;     // output columns per tile
constexpr int KB = 32;     // rows of N per shared-memory slice
constexpr int NT = 256;    // threads per block: 16 x 16, each 2 x 4 outputs

// the row index of the previous scan step of row n, or -1 at the first step
__device__ __forceinline__ long long prev_row(long long n, int T, int B,
                                              int reverse) {
  const long long t = n / B;
  if (reverse) return t + 1 < T ? n + B : -1;
  return t > 0 ? n - B : -1;
}

__global__ void __launch_bounds__(NT)
wgrad_tiles(const float* __restrict__ h_out, const float* __restrict__ dxp,
            float* __restrict__ part, int T, int B, int S, int reverse,
            int rows_per_split, int slot) {
  const int split = blockIdx.z;
  const int S4 = 4 * S;
  const int c0 = blockIdx.x * TC;
  const int i0 = blockIdx.y * TI;
  const long long N = (long long)T * B;
  const long long n0 = (long long)split * rows_per_split;
  const long long n1 = n0 + rows_per_split < N ? n0 + rows_per_split : N;

  __shared__ float As[KB][TI];
  __shared__ __align__(16) float Ds[KB][TC];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[a][q] = 0.0f;

  for (long long nb = n0; nb < n1; nb += KB) {
    for (int e = tid; e < KB * TI; e += NT) {
      const int kk = e / TI, ii = e % TI;
      const long long n = nb + kk;
      const int i = i0 + ii;
      float v = 0.0f;
      if (n < n1 && i < S) {
        const long long pn = prev_row(n, T, B, reverse);
        if (pn >= 0) v = h_out[pn * S + i];
      }
      As[kk][ii] = v;
    }
    for (int e = tid; e < KB * TC; e += NT) {
      const int kk = e / TC, cc = e % TC;
      const long long n = nb + kk;
      const int c = c0 + cc;
      Ds[kk][cc] = (n < n1 && c < S4) ? dxp[n * S4 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KB; ++kk) {
      const float a0 = As[kk][2 * ty];
      const float a1 = As[kk][2 * ty + 1];
      const float4 d = *reinterpret_cast<const float4*>(&Ds[kk][4 * tx]);
      acc[0][0] = fmaf(a0, d.x, acc[0][0]);
      acc[0][1] = fmaf(a0, d.y, acc[0][1]);
      acc[0][2] = fmaf(a0, d.z, acc[0][2]);
      acc[0][3] = fmaf(a0, d.w, acc[0][3]);
      acc[1][0] = fmaf(a1, d.x, acc[1][0]);
      acc[1][1] = fmaf(a1, d.y, acc[1][1]);
      acc[1][2] = fmaf(a1, d.z, acc[1][2]);
      acc[1][3] = fmaf(a1, d.w, acc[1][3]);
    }
    __syncthreads();
  }

  // slot `split` of part holds S * 4S weight sums, then 3 S peephole sums
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int i = i0 + 2 * ty + a;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + 4 * tx + q;
      if (i < S && c < S4) part[(size_t)split * slot + i * S4 + c] = acc[a][q];
    }
  }
}

// the three peephole sums of state column s over one split of the rows:
// thread (lane, s) takes every lanes-th row of the split, and threads
// (k < 3, s) add the lanes' sums of peephole k in lane order
__global__ void peep_parts(const float* __restrict__ c_out,
                           const float* __restrict__ dxp,
                           float* __restrict__ part, int T, int B, int S,
                           int reverse, int rows_per_split, int slot) {
  extern __shared__ float red[];                 // [3][lanes][S]
  const int split = blockIdx.x;
  const int s = threadIdx.x, lane = threadIdx.y, lanes = blockDim.y;
  const int S4 = 4 * S;
  const long long N = (long long)T * B;
  const long long n0 = (long long)split * rows_per_split;
  const long long n1 = n0 + rows_per_split < N ? n0 + rows_per_split : N;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  if (s < S) {
    for (long long n = n0 + lane; n < n1; n += lanes) {
      const long long pn = prev_row(n, T, B, reverse);
      const float cp = pn >= 0 ? c_out[pn * S + s] : 0.0f;
      const float* d = dxp + n * S4;
      a0 = fmaf(d[S + s], cp, a0);
      a1 = fmaf(d[2 * S + s], cp, a1);
      a2 = fmaf(d[3 * S + s], c_out[n * S + s], a2);
    }
    red[lane * S + s] = a0;
    red[(lanes + lane) * S + s] = a1;
    red[(2 * lanes + lane) * S + s] = a2;
  }
  __syncthreads();
  if (s < S && lane < 3) {
    float sum = 0.0f;
    for (int l = 0; l < lanes; ++l) sum += red[(lane * lanes + l) * S + s];
    part[(size_t)split * slot + (size_t)S * S4 + lane * S + s] = sum;
  }
}

// out = sum of the slots in slot order; split into dsWT and dp
__global__ void wgrad_sum(const float* __restrict__ part,
                          float* __restrict__ dsWT, float* __restrict__ dp,
                          int S, int nsplit, int slot) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= slot) return;
  float s = 0.0f;
  for (int k = 0; k < nsplit; ++k) s += part[(size_t)k * slot + e];
  const int nw = 4 * S * S;
  if (e < nw)
    dsWT[e] = s;
  else
    dp[e - nw] = s;
}

}  // namespace

extern "C" int lstm_wgrad(const void* h_out, const void* c_out,
                          const void* dxp, void* part, void* dsWT, void* dp,
                          int T, int B, int S, int reverse, int nsplit,
                          void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long N = (long long)T * B;
  const int rows = (int)((N + nsplit - 1) / nsplit);
  const int slot = 4 * S * S + 3 * S;
  const dim3 grid((4 * S + TC - 1) / TC, (S + TI - 1) / TI, nsplit);
  wgrad_tiles<<<grid, NT, 0, s>>>((const float*)h_out, (const float*)dxp,
                                  (float*)part, T, B, S, reverse, rows, slot);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // 8 row lanes a column, 4 above S = 128 (a block has 1,024 threads)
  const int width = (S + 31) / 32 * 32;
  const int lanes = 1024 / width < 8 ? 1024 / width : 8;
  const dim3 pblock(width, lanes);
  peep_parts<<<nsplit, pblock, 3 * lanes * S * sizeof(float), s>>>(
      (const float*)c_out, (const float*)dxp, (float*)part, T, B, S, reverse,
      rows, slot);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wgrad_sum<<<(slot + 255) / 256, 256, 0, s>>>(
      (const float*)part, (float*)dsWT, (float*)dp, S, nsplit, slot);
  return (int)cudaGetLastError();
}
