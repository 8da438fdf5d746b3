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
// What bounds it.  At the event-training shape (N = T * B = 50,000 rows,
// S = 64) the product [S x N] . [N x 4S] is 1.64 GFLOP of f32 FMA over
// 76.8 MB of operands, into 16,384 + 192 sums: throughput work with every
// row independent, about as long on the FMA units (24 us at 67 TFLOP/s) as
// on device memory (23 us at 3.35 TB/s).  So the design reads each operand
// row once and keeps the FMA units fed:
//
// - One pass, one launch for the sums.  A block holds the whole S x 4S
//   output (S <= 64; larger S splits the columns over blocks, the plan's
//   ncb) in 8 x 8 thread tiles: per row a thread makes 4 x 16-byte shared
//   loads (two of h_prev, two of dxp, the h_prev ones broadcasts) for 64
//   FMAs.  After its tile, thread e of column block 0 adds peephole column
//   e's products (of the 3S, e, e + threads, ...) over the slice's rows, so
//   no kernel reads dxp twice.  The peephole work is 3S products a row
//   against the tiles' 4 S^2: spread over the block it costs ~1% of a
//   slice (a warp of its own for it, 32 threads of 6 columns, ran 6x longer
//   than the tiles and held every slice's barrier).
// - Contiguous slices of KB rows of dxp, h_prev, c_prev and c_new come
//   through a 3-stage ring in shared memory, two slices ahead, by 16-byte
//   cp.async copies that every thread issues.  One bulk copy an operand a
//   slice, issued by one thread on an mbarrier, measured slower (0.083
//   against 0.076 ms at the event-training shape, H100 80GB HBM3 at
//   700 W; its slices waited ~1,050 cycles each for their copies).  One
//   block barrier a slice publishes the slice that landed and frees the
//   stage that the next refill takes.  Where S is not a multiple of 4
//   (h_out's and c_out's rows are then not 16-byte units) or an operand is
//   not 16-byte aligned, that operand comes by 4-byte cp.async copies
//   instead, each row of S floats into its row of lh (S rounded up to 4)
//   in the stage, so the tiles' 16-byte loads stay aligned.
// - h_prev and c_prev by offset: their rows are h_out's and c_out's rows B
//   rows earlier (later with `reverse`).  No index is divided: the rows of
//   the first scan step, whose h_prev is zero, are left out of the loops'
//   bounds instead of zero-filled, and so are a slice's rows past its
//   split.
// - One wave: the rows are split so that the ncb x nsplit blocks cover the
//   SMs once (nn/fused_lstm.py::lstm_wgrad_plan, from the shapes alone).
// - Fixed-order sums.  Each block stores its partial sums to its own slot
//   and a second kernel adds the slots in slot order: no atomics, two
//   launches, and the same bits from run to run.
//
// Sums are plain f32 FMA on the CUDA cores: no TF32 and no fast-math.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"   // smem_u32, and the clock stamps

#ifdef LSTM_WGRAD_CLOCKS
// Slice-phase clocks (scripts/bench_lstm.py --clocks builds this source
// with -DLSTM_WGRAD_CLOCKS into a library of its own): lane 0 of each warp
// of block 0 sums, over its slices, the SM clock cycles of the wait for
// the slice's copies with the slice's barrier, the refill's issue and the
// FMAs; then the whole loop.
__device__ long long lstm_wgrad_clocks[32 * 8];
#define WGRAD_CLOCK(k) PHASE_CLOCK(k)
#else
#define WGRAD_CLOCK(k) \
  do {                 \
  } while (0)
#endif

namespace {

constexpr int NSTG = 3;          // stages of the copy ring
constexpr int MAXT = 384;        // threads a block at most (168 registers)
constexpr int MAXPC = 8;         // peephole columns a thread at most
constexpr int kPad = 8;          // floats after the h and dxp regions: the
                                 // tiles' last loads run up to 7 past a row


struct Shape {
  int T, B, S, lh, reverse;  // lh: floats a staged row of h_prev and c
  int wide_h, wide_d;        // h_out and c_out, dxp: by 16-byte copies
  long long N;
  int MT, G, NG, KB;         // row groups, column groups, column groups a
                             // block, slice rows
  long long rows;            // rows a split
};

// region offsets of a stage, in floats: h_prev, dxp, c_prev, c_new
struct Stage {
  int h, d, cp, cn, len;
  __device__ Stage(const Shape& p) {
    h = 0;
    d = h + p.KB * p.lh + kPad;
    cp = d + p.KB * 4 * p.S + kPad;
    cn = cp + p.KB * p.lh;
    len = cn + p.KB * p.lh;
  }
};

// the rows of slice i of this split: [nb, ne), and those [plo, phi) whose
// previous scan step exists (h_prev, c_prev nonzero)
struct Slice {
  long long nb, ne, plo, phi;
  __device__ Slice(const Shape& p, long long n0, long long n1, int i) {
    nb = n0 + (long long)i * p.KB;
    ne = nb + p.KB < n1 ? nb + p.KB : n1;
    plo = nb;
    phi = ne;
    if (p.reverse) {
      if (phi > p.N - p.B) phi = p.N - p.B;
    } else if (plo < p.B) {
      plo = p.B;
    }
    if (phi < plo) phi = plo;
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}

// every thread's share of the copies of nrows rows of w floats, contiguous
// in device memory, into rows of ld floats: 16-byte copies where `wide`
// (then ld == w, a multiple of 4, and src 16-byte aligned), else 4-byte
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          long long nrows, int w, int ld,
                                          bool wide, int nthreads) {
  const long long n = nrows * w;
  if (wide) {
    for (long long i = threadIdx.x; i < n / 4; i += nthreads)
      cp_async16(dst + 4 * i, src + 4 * i);
  } else {
    for (long long i = threadIdx.x; i < n; i += nthreads) {
      const long long r = i / w;
      cp_async4(dst + r * ld + (i - r * w), src + i);
    }
  }
}

// start every thread's share of the copies of slice i into stage
// st, one commit group (an empty one past the split's last slice)
__device__ __forceinline__ void issue(float* st, const float* __restrict__ h,
                                      const float* __restrict__ c,
                                      const float* __restrict__ dxp,
                                      const Shape& p, const Stage& g,
                                      long long n0, long long n1, int i,
                                      int nslice, bool peep) {
  if (i < nslice) {
    const Slice sl(p, n0, n1, i);
    const long long shift = p.reverse ? p.B : -(long long)p.B;
    const long long nr = sl.ne - sl.nb;          // rows of dxp and c_new
    const long long npr = sl.phi - sl.plo;       // of h_prev and c_prev
    const long long prev = (sl.plo + shift) * p.S;
    const int row = (int)(sl.plo - sl.nb) * p.lh;
    const int nt = blockDim.x, S4 = 4 * p.S;
    copy_rows(st + g.d, dxp + sl.nb * S4, nr, S4, S4, p.wide_d, nt);
    copy_rows(st + g.h + row, h + prev, npr, p.S, p.lh, p.wide_h, nt);
    if (peep) {
      copy_rows(st + g.cn, c + sl.nb * p.S, nr, p.S, p.lh, p.wide_h, nt);
      copy_rows(st + g.cp + row, c + prev, npr, p.S, p.lh, p.wide_h, nt);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(MAXT)
wgrad_kernel(const float* __restrict__ h, const float* __restrict__ c,
             const float* __restrict__ dxp, float* __restrict__ part,
             Shape p) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);               // [NSTG][..]
  const Stage g(p);
  const int S = p.S, S4 = 4 * S;
  const int split = blockIdx.y;
  const long long n0 = (long long)split * p.rows;
  const long long n1 = n0 + p.rows < p.N ? n0 + p.rows : p.N;
  const int nslice = n1 > n0 ? (int)((n1 - n0 + p.KB - 1) / p.KB) : 0;
  const bool peep = blockIdx.x == 0;
  const long long slot = 4LL * S * S + 3LL * S;

  const int tid = threadIdx.x;
  // the tile: row group m, column group gc of the block's columns
  const int m = tid / p.NG, gc = blockIdx.x * p.NG + (tid - m * p.NG);
  const bool active = m < p.MT && gc < p.G;

  for (int s = 0; s < NSTG - 1; ++s)
    issue(ring + s * g.len, h, c, dxp, p, g, n0, n1, s, nslice, peep);

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[a][q] = 0.0f;
  float pacc[MAXPC];
#pragma unroll
  for (int k = 0; k < MAXPC; ++k) pacc[k] = 0.0f;

#ifdef LSTM_WGRAD_CLOCKS
  PHASE_CLOCK_START();
#endif
  for (int it = 0; it < nslice; ++it) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NSTG - 2) : "memory");
    __syncthreads();   // slice it has landed; slice it - 1's stage is free
    WGRAD_CLOCK(0);
    {
      const int f = it + NSTG - 1;
      issue(ring + (f % NSTG) * g.len, h, c, dxp, p, g, n0, n1, f, nslice,
            peep);
    }
    WGRAD_CLOCK(1);
    const float* st = ring + (it % NSTG) * g.len;
    const Slice sl(p, n0, n1, it);
    const int k0 = (int)(sl.plo - sl.nb), k1 = (int)(sl.phi - sl.nb);
    const int kend = (int)(sl.ne - sl.nb);
    if (active) {
      const float* A = st + g.h + 8 * m;
      const float* D = st + g.d + 8 * gc;
#pragma unroll 4
      for (int kk = k0; kk < k1; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(A + kk * p.lh);
        const float4 a1 = *reinterpret_cast<const float4*>(A + kk * p.lh + 4);
        const float4 d0 = *reinterpret_cast<const float4*>(D + kk * S4);
        const float4 d1 = *reinterpret_cast<const float4*>(D + kk * S4 + 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[a][q] = fmaf(av[a], dv[q], acc[a][q]);
      }
    }
    if (peep) {
      // peephole column e = tid + k blockDim of the 3S: dp[2] (kind 2) over
      // every row of the slice, dp[0], dp[1] over the rows whose previous
      // step exists
#pragma unroll
      for (int k = 0; k < MAXPC; ++k) {
        const int e = tid + k * (int)blockDim.x;
        if (e < 3 * S) {
          const int kind = e / S;
          const float* D = st + g.d + S + e;
          const float* C = st + (kind == 2 ? g.cn : g.cp) + (e - kind * S);
          const int lo = kind == 2 ? 0 : k0, hi = kind == 2 ? kend : k1;
#pragma unroll 8
          for (int kk = lo; kk < hi; ++kk)
            pacc[k] = fmaf(D[kk * S4], C[kk * p.lh], pacc[k]);
        }
      }
    }
    WGRAD_CLOCK(2);
  }
#ifdef LSTM_WGRAD_CLOCKS
  clk[7] = PHASE_CLOCK_TOTAL();
  if (blockIdx.x == 0 && blockIdx.y == 0 && (tid & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) lstm_wgrad_clocks[(tid >> 5) * 8 + k] = clk[k];
  }
#endif
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // slot `split` of part: S x 4S weight sums, then the 3S peephole sums
  float* out = part + (size_t)split * slot;
  if (active) {
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int i = 8 * m + a;
      if (i >= S) break;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = 8 * gc + q;
        if (col < S4) out[(size_t)i * S4 + col] = acc[a][q];
      }
    }
  }
  if (peep) {
#pragma unroll
    for (int k = 0; k < MAXPC; ++k) {
      const int e = tid + k * (int)blockDim.x;
      if (e < 3 * S) out[(size_t)S * S4 + e] = pacc[k];
    }
  }
}

// out = sum of the slots in slot order; split into dsWT and dp
__global__ void wgrad_sum(const float* __restrict__ part,
                          float* __restrict__ dsWT, float* __restrict__ dp,
                          int S, int nsplit) {
  const int slot = 4 * S * S + 3 * S;
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

// The plan comes from the caller (nn/fused_lstm.py::lstm_wgrad_plan):
// column groups a block ng, column blocks ncb, slice rows kb, splits nsplit
// of rows_per_split rows each, threads and smem bytes; lh = S rounded up
// to 4, the floats of a staged row of h and c.  h_out and c_out are
// (T, B, S), dxp is (T, B, 4S), each at least 4-byte aligned.  part is
// (nsplit, 4S^2 + 3S) f32 scratch.
extern "C" int lstm_wgrad(const void* h_out, const void* c_out,
                          const void* dxp, void* part, void* dsWT, void* dp,
                          int T, int B, int S, int lh, int reverse, int ng,
                          int ncb, int kb, int nsplit, long long rows,
                          int threads, int smem, void* stream) {
  Shape p;
  p.T = T;
  p.B = B;
  p.S = S;
  p.lh = lh;
  p.reverse = reverse;
  p.wide_h = S % 4 == 0 && (uintptr_t)h_out % 16 == 0 &&
             (uintptr_t)c_out % 16 == 0;
  p.wide_d = (uintptr_t)dxp % 16 == 0;
  p.N = (long long)T * B;
  p.MT = (S + 7) / 8;
  p.G = (4 * S + 7) / 8;
  p.NG = ng;
  p.KB = kb;
  p.rows = rows;
  if (threads > MAXT || threads % 32 || threads < p.MT * ng ||
      (long long)ncb * ng < p.G || kb <= 0 || lh % 4 || lh < S ||
      (long long)threads * MAXPC < 3LL * S ||
      (long long)nsplit * rows < p.N || (uintptr_t)h_out % 4 ||
      (uintptr_t)c_out % 4 || (uintptr_t)dxp % 4)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  wgrad_kernel<<<dim3(ncb, nsplit), threads, smem, s>>>(
      (const float*)h_out, (const float*)c_out, (const float*)dxp,
      (float*)part, p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int slot = 4 * S * S + 3 * S;
  wgrad_sum<<<(slot + 255) / 256, 256, 0, s>>>(
      (const float*)part, (float*)dsWT, (float*)dp, S, nsplit);
  return (int)cudaGetLastError();
}

#ifdef LSTM_WGRAD_CLOCKS
// copy the slice-phase clocks of the last launch, [warp][8], to host memory
extern "C" int lstm_wgrad_clocks_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, lstm_wgrad_clocks,
                                   sizeof(lstm_wgrad_clocks));
}
#endif
