// Device memory -> shared memory bandwidth ring for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of scripts/bench_dma.py::run_case (kernel
// :28-52, pl.pallas_call :54), the HBM -> VMEM DMA probe.  Same contract:
// over x (T, B, K) f32, out (B, K) f32 is the elementwise max over the first
// Tr = nchunk * rows time rows, -inf where Tr = 0.  The max propagates NaN,
// as torch.maximum does.
//
// Design.  The N = B * K columns are cut into tiles of W floats (the plan,
// scripts/bench_dma.py::hbm_ring_plan); block i walks tiles i, i + grid, ...
// and streams each tile's chunks of `rows` time rows through an nslots-deep
// ring in shared memory.  The block is warp-specialised:
//
// - its last warp is the producer.  Before it fills slot s it waits on the
//   slot's "empty" barrier; lane 0 arms the slot's "full" barrier with the
//   chunk's bytes, and lanes 0-31 each issue the bulk asynchronous copy
//   (cp.async.bulk) of one row of the chunk (W * 4 contiguous bytes): one
//   copy instruction a lane for rows <= 32;
// - the other C = W / 128 warps are consumers.  Lane l of consumer warp w
//   owns float4 column 32 w + l of the tile, so every consumer thread folds
//   one float4 a row of a whole tile.  A consumer warp waits on the slot's
//   full barrier, folds the chunk's rows into a max in registers,
//   __syncwarp()s, and its lane 0 arrives on the slot's empty barrier (one
//   arrival a warp, C a slot).
//
// No block-wide barrier in the loop: each warp waits only on the slot it
// needs.  So nslots - 1 chunks are in flight while one is folded.
//
// What bounds it.  Device memory: the input is read once (1.71 GB at
// B = 128, T = 3,264, K = 1,024: 0.51 ms at 3.35 TB/s).  The ring caps the
// bytes in flight at (nslots - 1) * rows * 4 bytes a column over the N
// columns, whatever the tiling; a block an SM that walks its tiles in turn
// holds one tile's share, so where tiles outnumber the SMs the plan puts
// several blocks on an SM.  What the probe measures is the bandwidth a ring
// of (rows, nslots) attains, and at rows 1 the cost of a slot's handshake.
#include "bulk_copy.cuh"

#ifdef HBM_RING_CLOCKS
// Chunk-phase clocks (scripts/bench_dma.py --clocks builds this source with
// -DHBM_RING_CLOCKS into a library of its own): lane 0 of each warp of
// block 0 sums, over its chunks, the SM clock cycles of the slot wait (the
// producer's: on the empty barrier), the fold, the release (__syncwarp and
// arrival), the refill's issue and the tile's store; slot 6 counts the
// chunks, slot 7 the loop's cycles.
__device__ long long hbm_ring_clocks[32 * 8];
#define RING_CLOCK(k) PHASE_CLOCK(k)
#else
#define RING_CLOCK(k) \
  do {                \
  } while (0)
#endif

namespace {

constexpr int kMaxSlots = 16;
constexpr int kMaxConsumers = 8;             // warps: W <= 1,024
constexpr int kBarBytes = 256;               // full[16], empty[16]

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

__global__ void __launch_bounds__(32 * (kMaxConsumers + 1))
    hbm_ring_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int nchunk, int rows, int nslots, long long N, int W,
                    long long ntiles, int consumers) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);         // [nslots]
  uint64_t* empty = full + kMaxSlots;                         // [nslots]
  float* ring = reinterpret_cast<float*>(smem + kBarBytes);   // [nslots][rows][W]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long mytiles = (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long nitems = mytiles * nchunk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < nslots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  Cursor cur;
  cur.start(N, W);
  int s = 0;
  unsigned phase = 0;
#ifdef HBM_RING_CLOCKS
  PHASE_CLOCK_START();
#endif
  if (warp == consumers) {
    // the producer: item i goes to slot i % nslots once the consumers have
    // released the slot's item i - nslots
    for (long long i = 0; i < nitems; ++i) {
      if (i >= nslots) mbar_wait(&empty[s], phase ^ 1u);
      RING_CLOCK(0);
      const unsigned bytes = (unsigned)cur.width * 4u;
      if (lane == 0) mbar_expect_tx(&full[s], bytes * rows);
      __syncwarp();
      for (int q = lane; q < rows; q += 32)
        bulk_copy(ring + ((size_t)s * rows + q) * W,
                  x + ((size_t)cur.chunk * rows + q) * N + cur.c0, bytes,
                  &full[s]);
      RING_CLOCK(3);
      cur.next(nchunk, N, W);
      if (++s == nslots) {
        s = 0;
        phase ^= 1u;
      }
      RING_CLOCK(4);
    }
  } else {
    const float neg = __int_as_float(0xff800000);    // -inf
    const float4 ninf = make_float4(neg, neg, neg, neg);
    const int c = threadIdx.x;                       // float4 column
    const int W4 = W / 4;
    float4 acc = ninf;
    for (long long i = 0; i < nitems; ++i) {
      mbar_wait(&full[s], phase);
      RING_CLOCK(0);
      if (c < cur.width / 4) {
        const float4* col =
            reinterpret_cast<const float4*>(ring + (size_t)s * rows * W) + c;
#pragma unroll 4
        for (int row = 0; row < rows; ++row)
          acc = max4(acc, col[row * W4]);
      }
      RING_CLOCK(1);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      RING_CLOCK(2);
      if (cur.chunk == nchunk - 1) {      // the tile is done
        if (c < cur.width / 4)
          reinterpret_cast<float4*>(out + cur.c0)[c] = acc;
        acc = ninf;
      }
      cur.next(nchunk, N, W);
      if (++s == nslots) {
        s = 0;
        phase ^= 1u;
      }
      RING_CLOCK(4);
    }
  }
#ifdef HBM_RING_CLOCKS
  clk[6] = nitems;
  clk[7] = PHASE_CLOCK_TOTAL();
  if (blockIdx.x == 0 && lane == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) hbm_ring_clocks[warp * 8 + k] = clk[k];
  }
#endif
}

}  // namespace

// out (N floats) = max over the first nchunk * rows rows (N floats each) of
// x, by the plan of scripts/bench_dma.py::hbm_ring_plan: tiles of W floats
// (W % 4 == 0, at most 128 * consumers), ntiles of them over `grid` blocks
// of consumers + 1 warps, smem bytes of shared memory (the barriers and
// the ring).  N % 4 == 0 and 16-byte aligned x and out; nslots <= 16.
extern "C" int hbm_ring(const void* x, void* out, int nchunk, int rows,
                        int nslots, long long N, int W, long long ntiles,
                        int grid, int consumers, int smem, void* stream) {
  if (nchunk < 1 || rows < 1 || nslots < 1 || nslots > kMaxSlots || N < 4 ||
      N % 4 || W < 4 || W % 4 || consumers < 1 ||
      consumers > kMaxConsumers || W > 128 * consumers ||
      ntiles != (N + W - 1) / W || grid < 1 || grid > ntiles ||
      (size_t)smem < kBarBytes + 4 * (size_t)nslots * rows * W ||
      (uintptr_t)x % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hbm_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  hbm_ring_kernel<<<grid, 32 * (consumers + 1), smem,
                    (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, nchunk, rows, nslots, N, W, ntiles,
      consumers);
  return (int)cudaGetLastError();
}

#ifdef HBM_RING_CLOCKS
// copy the chunk-phase clocks of the last launch, [warp][8], to host memory
extern "C" int hbm_ring_clocks_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, hbm_ring_clocks,
                                   sizeof(hbm_ring_clocks));
}
#endif
