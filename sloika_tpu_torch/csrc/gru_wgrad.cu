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
// What bounds it.  Two tall, skinny products split along K = N = T * B:
// at the training shapes (N = 40,000, S = 96) 2.2 GFLOP of f32 FMA over
// 77 MB of operands, into 27,648 sums.  All the work lies along N, so the
// design keeps the FMA units fed and reads each operand row once:
//
// - Wide blocks.  The output S x 3S is cut into 8 x 8 thread tiles: row
//   group m (8 of the S rows) and column group g, where the groups of dsWT
//   come first and those of dsW2T after them.  A block holds every row
//   group and as many column groups as fit 512 threads: all of S x 3S up to
//   S = 96.  Per row of N a thread loads 4 x 16 bytes from shared memory
//   and does 64 FMAs.
// - A copy ring.  Slices of KB rows of dxp, h_prev and rh pass through a
//   3-stage cp.async ring (16-byte copies where S % 4 == 0), so the loads of
//   slice i + 2 overlap the FMAs of slice i; one barrier a slice.
// - h_prev by offset: its rows are h_out's rows one step (B rows) away, so
//   no index is divided; rows of the first scan step are zero-filled.
// - One wave: the blocks split N so that about one wave of blocks covers
//   the 132 SMs of an H100.  The split depends on the shapes alone (the
//   host plan, nn/fused_gru.py::gru_wgrad_plan).
// - Fixed-order sums.  Each block stores its partial tile to its own slot
//   and a second kernel adds the slots in slot order: no atomics, so the
//   result has the same bits from run to run.
// The sums stay f32 on the CUDA cores (no tensor cores, no TF32).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NSTG = 3;    // stages of the copy ring
constexpr int MAXT = 512;  // threads a block at most

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

// copy u (4 or 1) floats, or write zeros where the source row is absent
__device__ __forceinline__ void put(float* dst, const float* src, bool on,
                                    int u) {
  if (u == 4) {
    if (on)
      cp_async16(dst, src);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    if (on)
      cp_async4(dst, src);
    else
      *dst = 0.0f;
  }
}

struct Shape {
  int T, B, S, reverse;
  long long N;
  int MT, P0, G, NG, KB, rows;  // row groups, dsWT column groups, all column
                                // groups, column groups a block, slice rows,
                                // rows a split
  int vec;
};

// start the copies of slice [nb, nb + KB) of this split (rows < n1) into
// one ring stage: D [KB][8G] (dsWT's columns at 0, dsW2T's at 8 P0),
// Ah, Ar [KB][8 MT]
__device__ __forceinline__ void load_slice(
    float* D, float* Ah, float* Ar, const float* __restrict__ h_out,
    const float* __restrict__ rh, const float* __restrict__ dxp,
    const Shape& p, long long nb, long long n1) {
  const int u = p.vec ? 4 : 1;
  const int S = p.S, S3 = 3 * S, DW = 8 * p.G, AW = 8 * p.MT;
  const long long BS = p.B;
  const int q3 = S3 / u, q1 = S / u;
  for (int e = threadIdx.x; e < p.KB * q3; e += blockDim.x) {
    const int kk = e / q3, col = (e - kk * q3) * u;
    const long long n = nb + kk;
    const int dst = col < 2 * S ? col : col - 2 * S + 8 * p.P0;
    put(D + kk * DW + dst, dxp + n * S3 + col, n < n1, u);
  }
  for (int e = threadIdx.x; e < p.KB * q1; e += blockDim.x) {
    const int kk = e / q1, col = (e - kk * q1) * u;
    const long long n = nb + kk;
    put(Ar + kk * AW + col, rh + n * S + col, n < n1, u);
    // h_prev[n] = h_out[n - B] (forward) or h_out[n + B] (reverse); zero
    // at the first scan step
    const bool has = n < n1 && (p.reverse ? n + BS < p.N : n >= BS);
    put(Ah + kk * AW + col, h_out + (p.reverse ? n + BS : n - BS) * S + col,
        has, u);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(MAXT)
wgrad_tiles(const float* __restrict__ h_out, const float* __restrict__ rh,
            const float* __restrict__ dxp, float* __restrict__ part,
            Shape p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int S = p.S, S3 = 3 * S;
  const int DW = 8 * p.G, AW = 8 * p.MT;
  const int stage = p.KB * (DW + 2 * AW);
  const int split = blockIdx.y;
  const long long n0 = (long long)split * p.rows;
  const long long n1 = n0 + p.rows < p.N ? n0 + p.rows : p.N;
  const int nslice = n1 > n0 ? (int)((n1 - n0 + p.KB - 1) / p.KB) : 0;

  const int tid = threadIdx.x;
  const int m = tid / p.NG, gl = tid - m * p.NG;
  const int g = blockIdx.x * p.NG + gl;
  const bool active = m < p.MT && g < p.G;
  const bool second = g >= p.P0;            // a column group of dsW2T

  // padding rows and columns stay zero (they feed only unstored sums)
  for (int i = tid; i < NSTG * stage; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();

  for (int s = 0; s < NSTG - 1; ++s) {
    float* st = smem + s * stage;
    if (s < nslice)
      load_slice(st, st + p.KB * DW, st + p.KB * DW + p.KB * AW, h_out, rh,
                 dxp, p, n0 + (long long)s * p.KB, n1);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[a][q] = 0.0f;

  for (int it = 0; it < nslice; ++it) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NSTG - 2) : "memory");
    __syncthreads();   // slice it visible; slice it - 1's stage is free
    {
      const int f = it + NSTG - 1;
      float* st = smem + (f % NSTG) * stage;
      if (f < nslice)
        load_slice(st, st + p.KB * DW, st + p.KB * DW + p.KB * AW, h_out, rh,
                   dxp, p, n0 + (long long)f * p.KB, n1);
      else
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    if (active) {
      const float* st = smem + (it % NSTG) * stage;
      const float* D = st + 8 * g;
      const float* A = st + p.KB * DW + (second ? p.KB * AW : 0) + 8 * m;
#pragma unroll 4
      for (int kk = 0; kk < p.KB; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(A + kk * AW);
        const float4 a1 = *reinterpret_cast<const float4*>(A + kk * AW + 4);
        const float4 d0 = *reinterpret_cast<const float4*>(D + kk * DW);
        const float4 d1 = *reinterpret_cast<const float4*>(D + kk * DW + 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[a][q] = fmaf(av[a], dv[q], acc[a][q]);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (!active) return;

  // part is (nsplit, S, 3S) in the outputs' own columns
  const int c0 = second ? 2 * S + 8 * (g - p.P0) : 8 * g;
  const int cend = second ? S3 : 2 * S;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = 8 * m + a;
    if (i >= S) break;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = c0 + q;
      if (c < cend) part[((size_t)split * S + i) * S3 + c] = acc[a][q];
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

// The plan comes from the caller (nn/fused_gru.py::gru_wgrad_plan): column
// groups a block ng, column blocks ncb, slice rows kb, splits nsplit of
// rows_per_split rows each, threads and smem bytes.  part is
// (nsplit, S, 3S) f32 scratch.
extern "C" int gru_wgrad(const void* h_out, const void* rh, const void* dxp,
                         void* part, void* dsWT, void* dsW2T, int T, int B,
                         int S, int reverse, int ng, int ncb, int kb,
                         int nsplit, int rows_per_split, int threads,
                         int smem, void* stream) {
  Shape p;
  p.T = T;
  p.B = B;
  p.S = S;
  p.reverse = reverse;
  p.N = (long long)T * B;
  p.MT = (S + 7) / 8;
  p.P0 = (2 * S + 7) / 8;
  p.G = p.P0 + (S + 7) / 8;
  p.NG = ng;
  p.KB = kb;
  p.rows = rows_per_split;
  p.vec = S % 4 == 0 && (uintptr_t)h_out % 16 == 0 &&
          (uintptr_t)rh % 16 == 0 && (uintptr_t)dxp % 16 == 0;
  if (threads > MAXT || (long long)ncb * ng < p.G || kb <= 0 ||
      (long long)nsplit * rows_per_split < p.N)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wgrad_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  wgrad_tiles<<<dim3(ncb, nsplit), threads, smem, s>>>(
      (const float*)h_out, (const float*)rh, (const float*)dxp, (float*)part,
      p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wgrad_sum<<<(S * 3 * S + 255) / 256, 256, 0, s>>>(
      (const float*)part, (float*)dsWT, (float*)dsW2T, S, nsplit);
  return (int)cudaGetLastError();
}
