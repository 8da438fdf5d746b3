// Device memory -> shared memory bandwidth ring for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of scripts/bench_dma.py::run_case (kernel
// :28-52, pl.pallas_call :54), the HBM -> VMEM DMA probe.  Same contract:
// over x (T, B, K) f32, out (B, K) f32 is the elementwise max over the first
// Tr = nchunk * rows time rows, -inf where Tr = 0.  The max propagates NaN,
// as torch.maximum does.
//
// Design.  The N = B * K columns are cut into tiles of W floats; a grid of
// one block an SM walks them (block i takes tiles i, i + grid, ...).  A block
// streams its (tile, chunk) pairs, chunks of `rows` time rows, through an
// nslots-deep ring in shared memory.  Thread 0 fills the ring with Hopper's
// bulk asynchronous copies (cp.async.bulk, one a row of the chunk: W * 4
// contiguous bytes) that complete on the slot's mbarrier, armed with
// expect_tx for the chunk's bytes.  All threads wait on the barrier's phase,
// fold the chunk's rows into a max in registers (a float4 a thread a row
// segment), meet at a __syncthreads(), and thread 0 refills the slot with
// the chunk nslots ahead.  So nslots - 1 chunks are in flight while one is
// folded: nslots * rows * W * 4 bytes of ring a block.  W is the largest
// multiple of 4 for which the ring fits the block's shared memory (at most
// 4,096), shrunk so the tiles spread evenly over the SMs: on 132 SMs at
// B = 128, K = 1,024, 996 floats (one tile a block) up to rows 8, nslots 4
// (127 KB of ring), and 500 floats (two tiles a block) at rows 32, nslots 3
// (192 KB).
//
// What bounds it.  Device memory: the input is read once (1.71 GB at
// B = 128, T = 3,264, K = 1,024: 0.51 ms at 3.35 TB/s).  What the probe
// measures is the bandwidth a ring of (rows, nslots) attains, that is how
// many bytes must be in flight an SM to approach that rate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 16;
constexpr int kMaxQuads = 4;                 // float4s a thread a row
constexpr int kMaxW = 4 * kMaxQuads * kThreads;
constexpr int kBarBytes = 128;               // the slots' mbarriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(max_nan(a.x, b.x), max_nan(a.y, b.y), max_nan(a.z, b.z),
                     max_nan(a.w, b.w));
}

// a block's cursor over its (tile, chunk) pairs, in order: the chunks of
// tile blockIdx.x, then of tile blockIdx.x + gridDim.x, ...
struct Cursor {
  long long c0;        // first column of the tile
  int width;           // its columns
  int chunk;

  __device__ void start(long long N, int W) {
    chunk = 0;
    c0 = (long long)blockIdx.x * W;
    width = (int)min((long long)W, N - c0);
  }
  __device__ void next(int nchunk, long long N, int W) {
    if (++chunk == nchunk) {
      chunk = 0;
      c0 += (long long)gridDim.x * W;
      width = (int)min((long long)W, N - c0);
    }
  }
};

__global__ void __launch_bounds__(kThreads)
    hbm_ring_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int nchunk, int rows, int nslots, long long N, int W,
                    long long ntiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);         // [nslots]
  float* ring = reinterpret_cast<float*>(smem + kBarBytes);   // [nslots][rows][W]
  const int tid = threadIdx.x;
  const long long mytiles = (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long nitems = mytiles * nchunk;

  if (tid == 0) {
    for (int s = 0; s < nslots; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0: copy the producer cursor's chunk into slot s, one bulk copy
  // a row, and advance the cursor
  Cursor prod;
  prod.start(N, W);
  auto issue = [&](int s) {
    const unsigned bytes = (unsigned)prod.width * 4u;
    mbar_expect_tx(&full[s], bytes * rows);
    for (int q = 0; q < rows; ++q)
      bulk_copy(ring + ((size_t)s * rows + q) * W,
                x + ((size_t)prod.chunk * rows + q) * N + prod.c0, bytes,
                &full[s]);
    prod.next(nchunk, N, W);
  };
  if (tid == 0)
    for (int s = 0; s < nslots && s < nitems; ++s) issue(s);

  const float neg = __int_as_float(0xff800000);    // -inf
  const float4 ninf = make_float4(neg, neg, neg, neg);
  float4 acc[kMaxQuads];
#pragma unroll
  for (int q = 0; q < kMaxQuads; ++q) acc[q] = ninf;

  Cursor cur;
  cur.start(N, W);
  int s = 0;
  unsigned phase = 0;
  for (long long i = 0; i < nitems; ++i) {
    const int n4 = cur.width / 4;
    mbar_wait(&full[s], phase);
    const float4* slot = reinterpret_cast<const float4*>(
        ring + (size_t)s * rows * W);
    for (int row = 0; row < rows; ++row) {
#pragma unroll
      for (int q = 0; q < kMaxQuads; ++q) {
        const int c = tid + q * kThreads;
        if (c < n4) acc[q] = max4(acc[q], slot[row * (W / 4) + c]);
      }
    }
    __syncthreads();                    // every thread is done with slot s
    if (tid == 0 && i + nslots < nitems) {
      // the refill's async writes follow the generic reads of the slot
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(s);
    }
    if (cur.chunk == nchunk - 1) {      // the tile is done
      float4* o = reinterpret_cast<float4*>(out + cur.c0);
#pragma unroll
      for (int q = 0; q < kMaxQuads; ++q) {
        const int c = tid + q * kThreads;
        if (c < n4) o[c] = acc[q];
        acc[q] = ninf;
      }
    }
    cur.next(nchunk, N, W);
    if (++s == nslots) {
      s = 0;
      phase ^= 1u;
    }
  }
}

}  // namespace

// out (N floats) = max over the first nchunk * rows rows (N floats each) of
// x; plan[0..2] receives the tile width W, the tile count and the grid.
// N % 4 == 0 and 16-byte aligned x and out; nslots <= 16.
extern "C" int hbm_ring(const void* x, void* out, int nchunk, int rows,
                        int nslots, long long N, int* plan, void* stream) {
  if (nchunk < 1 || rows < 1 || nslots < 1 || nslots > kMaxSlots || N < 4 ||
      N % 4 || (uintptr_t)x % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 1, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  // the widest tile whose ring fits, then narrowed so the tiles spread
  // evenly over the SMs (k tiles a block)
  long long wfit = (optin - kBarBytes) / (4LL * nslots * rows);
  wfit = (wfit < kMaxW ? wfit : kMaxW) / 4 * 4;
  if (wfit < 4) return (int)cudaErrorInvalidValue;
  const long long k = (N + (long long)sms * wfit - 1) / ((long long)sms * wfit);
  long long W = (N + k * sms - 1) / (k * sms);
  W = (W + 3) / 4 * 4;
  const long long ntiles = (N + W - 1) / W;
  const int grid = (int)(ntiles < sms ? ntiles : sms);
  const size_t smem = kBarBytes + 4 * (size_t)nslots * rows * W;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hbm_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  plan[0] = (int)W;
  plan[1] = (int)ntiles;
  plan[2] = grid;
  hbm_ring_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, nchunk, rows, nslots, N, (int)W, ntiles);
  return (int)cudaGetLastError();
}
