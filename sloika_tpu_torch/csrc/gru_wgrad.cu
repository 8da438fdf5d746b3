// GRU recurrent-weight cotangents for Hopper (sm_90a).
//
// The Pallas TPU kernel sloika_tpu/nn/pallas_gru.py::_bwd_kernel sums
// these in its body, step by step, into VMEM scratch (:210-214), one slot
// per batch block, and the slots are summed afterwards (:241-243, :278):
//
//     dsWT  (S, 2S) = sum over rows n = (t, b) of h_prev[n]^T  dxp[n, :2S]
//     dsW2T (S, S)  = sum over rows n        of rh[n]^T      dxp[n, 2S:]
//
// where h_prev is h_out shifted one step towards the scan start (zeros at
// the first step) and rh = r * h_prev comes from csrc/gru_bwd.cu.  dxp is
// zero at masked steps, so they add nothing, as in the Pallas kernel.
//
// Design.  Two products [S x N] . [N x 2S] and [S x N] . [N x S] over the
// N = T * B rows, split along N.  Each block owns one 32 x 64 output tile of
// one product and one split of the rows; its 256 threads each hold a 2 x 4
// tile of sums in registers, and 32-row slices of both operands pass through
// shared memory with coalesced loads.  Each block stores its partial sums
// to its own slot, and a second kernel adds the slots in a fixed order: no
// atomics, so the result has the same bits from run to run.  The number of
// splits is chosen by the caller from the shapes alone.
//
// What bounds it.  At the training shapes (N = 40,000, S = 96) it is 2.2
// GFLOP of f32 FMA over 77 MB of operands: throughput work, with every
// block independent, unlike the recurrence.  This first version is a plain
// shared-memory tiled product (no tensor cores: the sums stay f32).
#include <cuda_runtime.h>

namespace {

constexpr int TI = 32;     // output rows (index i < S) per tile
constexpr int TC = 64;     // output columns per tile
constexpr int KB = 32;     // rows of N per shared-memory slice
constexpr int NT = 256;    // threads per block: 16 x 16, each 2 x 4 outputs

__global__ void __launch_bounds__(NT)
wgrad_tiles(const float* __restrict__ h_out, const float* __restrict__ rh,
            const float* __restrict__ dxp, float* __restrict__ part, int T,
            int B, int S, int reverse, int rows_per_split) {
  const int prod = blockIdx.z & 1;           // 0: dsWT, 1: dsW2T
  const int split = blockIdx.z >> 1;
  const int S3 = 3 * S;
  const int ncol = prod == 0 ? 2 * S : S;
  const int coff = prod == 0 ? 0 : 2 * S;    // column offset in dxp and part
  const int c0 = blockIdx.x * TC;
  const int i0 = blockIdx.y * TI;
  if (c0 >= ncol) return;                    // the whole block: no barrier yet
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
        if (prod == 1) {
          v = rh[n * S + i];
        } else {
          const long long t = n / B;
          if (reverse ? t + 1 < T : t > 0)
            v = h_out[(reverse ? n + B : n - B) * S + i];
        }
      }
      As[kk][ii] = v;
    }
    for (int e = tid; e < KB * TC; e += NT) {
      const int kk = e / TC, cc = e % TC;
      const long long n = nb + kk;
      const int c = c0 + cc;
      Ds[kk][cc] = (n < n1 && c < ncol) ? dxp[n * S3 + coff + c] : 0.0f;
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

  // part is (nsplit, S, 3S): this product's columns start at coff
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int i = i0 + 2 * ty + a;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + 4 * tx + q;
      if (i < S && c < ncol)
        part[((size_t)split * S + i) * S3 + coff + c] = acc[a][q];
    }
  }
}

// out = sum of the slots in slot order; split into dsWT and dsW2T
__global__ void wgrad_sum(const float* __restrict__ part,
                          float* __restrict__ dsWT, float* __restrict__ dsW2T,
                          int S, int nsplit) {
  const int S3 = 3 * S;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= S * S3) return;
  float s = 0.0f;
  for (int k = 0; k < nsplit; ++k) s += part[(size_t)k * S * S3 + e];
  const int i = e / S3, c = e % S3;
  if (c < 2 * S)
    dsWT[i * 2 * S + c] = s;
  else
    dsW2T[i * S + (c - 2 * S)] = s;
}

}  // namespace

extern "C" int gru_wgrad(const void* h_out, const void* rh, const void* dxp,
                         void* part, void* dsWT, void* dsW2T, int T, int B,
                         int S, int reverse, int nsplit, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long N = (long long)T * B;
  const int rows = (int)((N + nsplit - 1) / nsplit);
  const dim3 grid((2 * S + TC - 1) / TC, (S + TI - 1) / TI, 2 * nsplit);
  wgrad_tiles<<<grid, NT, 0, s>>>((const float*)h_out, (const float*)rh,
                                  (const float*)dxp, (float*)part, T, B, S,
                                  reverse, rows);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wgrad_sum<<<(S * 3 * S + 255) / 256, 256, 0, s>>>(
      (const float*)part, (float*)dsWT, (float*)dsW2T, S, nsplit);
  return (int)cudaGetLastError();
}
