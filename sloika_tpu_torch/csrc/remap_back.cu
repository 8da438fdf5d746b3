// Banded remap traceback for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sloika_tpu/ops/pallas/remap.py::
// _backtrack_kernel (driven by _backtrack :183).  Given the int16 position
// deltas tb (Tp, B, W) of remap_banded.cu, the window starts (Tp, B) and
// each row's last absolute position, it walks t = Tp-1 .. 1:
//
//   path[Tp-1] = last
//   rel        = clamp(pos - starts[t], 0, W-1)
//   pos       -= tb[t, b, rel];   path[t-1] = pos
//
// path is (Tp, B) int32.
//
// What bounds it.  Each step's read depends on the step before: a row is a
// chain of Tp - 1 dependent reads (35,584 at the remap main path's shapes).
// Read from device memory, as the design before this one did, each took a
// device-memory latency: 848 of its 893 cycles a step (PERF.md §6,
// step 0).  The bytes the function must move (a delta and a window start
// read, a position written, a step) are a few MB.
//
// What the design does about it.  One block per row.  Its second warp
// streams the row's traceback rows tb[t, b, 0:W], in falling t, into a
// ring of shared-memory slots of K frames each, on the slot's "full"
// mbarrier, once the walker has released the slot on its "empty" one (the
// plan, ops/remap_kernel.py::remap_back_plan; K a power of two, so that a
// slot's frames share a register of window starts).  Two copy forms:
// - one box of a 4-D tensor map over tb, the lanes split as inner x
//   W / inner (each at most 256, as a box's sides must be): box (inner,
//   W / inner, 1, K), one cp.async.bulk.tensor a slot, landing [K][W].
//   The map's strides need W % 8 == 0; the tensor bounds the reads
//   (frames below 0 come as zeros and are not walked);
// - one bulk copy (cp.async.bulk) a frame, lane q copying frame q.  A row
//   is W * 2 bytes at (t * B + b) * W * 2, 16-byte aligned only where W %
//   8 == 0, so a copy takes the row's aligned superset and the walk reads
//   at the row's offset into it; a superset that would run past the
//   tensor's storage (its last row) is not copied, and that frame is read
//   from device memory.
// The copier issues a slot's copies one after another, ~100 cycles each
// (PERF.md §6), so the plan takes the box wherever W allows it.  A
// wait on a slot's barrier tests it first (mbarrier.test_wait), since a
// blocking try_wait on a completed phase cost ~200 cycles.  The first warp walks the chain in shared memory, all 32
// lanes on the same position, so that each lane can hold the window start
// of one of 32 steps, read a window ahead; a slot's starts and rows'
// offsets are read before its chain of K dependent reads, and lane q
// stores frame q's position.  The design reads the whole traceback once,
// 3.5 GB at the main path's shapes (~1.05 ms at 3.35 TB/s), and its chain
// is Tp shared-memory load-to-use latencies (~32 cycles each).
#include "bulk_copy.cuh"
#include "tensor_map.cuh"

#ifdef REMAP_BACK_CLOCKS
// Slot-phase clocks (scripts/bench_remap.py --clocks builds this source with
// -DREMAP_BACK_CLOCKS into a library of its own): lane 0 of each warp of
// block 0 sums, over its slots, the SM clock cycles of the wait for the
// slot (0: the walker's on the full barrier, the copier's on the empty
// one), the walk of its K frames (1), the release (2) and the copies' issue
// (3); slot 7 holds the loop's cycles.  Before the loop, thread 0 of
// block 0 chases 64 dependent 2-byte reads through shared memory (slot 6
// of warp 0: their cycles), the load-to-use latency that the walk's chain
// repeats.
__device__ long long remap_back_clocks[32 * 8];
__device__ int remap_back_sink;
#define BACK_CLOCK(k) PHASE_CLOCK(k)
#else
#define BACK_CLOCK(k) \
  do {                \
  } while (0)
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSlots = 16;
constexpr int kBarBytes = 256;       // full[16], empty[16]

// Frame t's traceback row as a bulk copy takes it: the 16-byte boundary at
// or below the row, the row's offset into the copy (int16) and the copy's
// bytes.  Returns false where the copy would run past `end`, the end of the
// tensor's storage: that row is read from device memory instead.
__device__ __forceinline__ bool row_span(const int16_t* tb, int t, int B,
                                         int b, int W, unsigned long long end,
                                         const int16_t*& src, int& off,
                                         unsigned& bytes) {
  const unsigned long long a =
      (unsigned long long)(tb + ((size_t)t * B + b) * W);
  const unsigned long long a0 = a & ~15ull;
  const unsigned long long e = (a + 2ull * W + 15ull) & ~15ull;
  src = reinterpret_cast<const int16_t*>(a0);
  off = (int)((a - a0) >> 1);
  bytes = (unsigned)(e - a0);
  return e <= end;
}

// Where a slot holds frame t0 - q's row.  Bulk rows: frame q's row at
// q * frame_elems, shifted by the row's offset in its 16-byte line.
// Tensor boxes: the K frames in rising t, [K][W].
template <int K, bool TENSOR>
__device__ __forceinline__ int frame_base(int frame_elems, int W, int q,
                                          unsigned long long row_addr) {
  if constexpr (TENSOR) return (K - 1 - q) * W;
  return q * frame_elems + (int)((row_addr & 15ull) >> 1);
}

// the walk of one chunk of frames t0, t0 - 1, ... of a slot
template <int K, bool TENSOR>
__device__ __forceinline__ int walk_chunk(int pos, const int16_t* slot,
                                          int frame_elems, int t0, int nf,
                                          bool whole, int sw, int widx,
                                          const int16_t* __restrict__ tb,
                                          int B, int b, int W,
                                          unsigned long long tb_end,
                                          int32_t* __restrict__ path,
                                          int lane) {
  if (whole) {
    // every frame landed: the window starts and the rows' offsets first,
    // then the chain of K dependent shared-memory reads
    int stq[K], offq[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      stq[q] = __shfl_sync(kFull, sw, (widx + q) & 31);
      offq[q] = frame_base<K, TENSOR>(
          frame_elems, W, q,
          (unsigned long long)(tb + ((size_t)(t0 - q) * B + b) * W));
    }
    int mine = 0;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int rel = min(max(pos - stq[q], 0), W - 1);
      pos -= (int)slot[offq[q] + rel];
      mine = lane == q ? pos : mine;
    }
    if (lane < K) path[(size_t)(t0 - lane - 1) * B + b] = mine;
    return pos;
  }
  // the last chunk, or one with a row that was read from device memory
  for (int q = 0; q < nf; ++q) {
    const int t = t0 - q;
    const int st = __shfl_sync(kFull, sw, (widx + q) & 31);
    const int16_t* src;
    int off;
    unsigned bytes;
    // a tensor box's reads are bounded by the tensor: every row lands
    const bool landed =
        TENSOR || row_span(tb, t, B, b, W, tb_end, src, off, bytes);
    const int rel = min(max(pos - st, 0), W - 1);
    const int base = frame_base<K, TENSOR>(
        frame_elems, W, q, (unsigned long long)(tb + ((size_t)t * B + b) * W));
    pos -= landed ? (int)slot[base + rel]
                  : (int)tb[((size_t)t * B + b) * W + rel];
    if (lane == 0) path[(size_t)(t - 1) * B + b] = pos;
  }
  return pos;
}

template <int K, bool TENSOR>
__global__ void __launch_bounds__(64)
remap_back_kernel(const int16_t* __restrict__ tb,
                  const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ last,
                  int32_t* __restrict__ path, int Tp, int B, int W,
                  int nslots, int frame_elems, int slot_elems,
                  unsigned long long tb_end,
                  const __grid_constant__ CUtensorMap tmap) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);          // [nslots]
  uint64_t* empty = full + kMaxSlots;                          // [nslots]
  int16_t* ring = reinterpret_cast<int16_t*>(smem + kBarBytes);  // [nslots][slot]
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nframes = Tp - 1;                  // t = Tp-1 .. 1
  const int nchunks = (nframes + K - 1) / K;

#ifdef REMAP_BACK_CLOCKS
  long long chase = 0;
  if (b == 0 && threadIdx.x == 0) {
    for (int i = 0; i < 64; ++i) ring[i] = (int16_t)((i + 1) & 63);
    int x = 0;
    long long c0, c1;
    asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(c0) : : "memory");
    for (int i = 0; i < 64; ++i) x = ring[x];
    asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(c1) : : "memory");
    chase = c1 - c0;
    remap_back_sink = x;
    fence_proxy_async();        // these writes come before the copies'
  }
#endif
  if (threadIdx.x == 0) {
    for (int s = 0; s < nslots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  int s = 0;
  unsigned phase = 0;
#ifdef REMAP_BACK_CLOCKS
  PHASE_CLOCK_START();
#endif
  if (warp == 1) {
    // the copier: chunk g (frames Tp-1-gK .. down) into slot g % nslots,
    // once the walker has released the slot's chunk g - nslots
    for (int g = 0; g < nchunks; ++g) {
      if (g >= nslots) mbar_wait_tested(&empty[s], phase ^ 1u);
      BACK_CLOCK(0);
      const int nf = min(K, nframes - g * K);
      int16_t* slot = ring + (size_t)s * slot_elems;
      if constexpr (TENSOR) {
        // one box: the K frames up to Tp-1-gK, in rising t (frames below 0
        // come as zeros and are not walked)
        if (lane == 0) {
          mbar_expect_tx(&full[s], (unsigned)(K * W * 2));
          tensor_copy_4d(slot, &tmap, 0, 0, b, Tp - g * K - K, &full[s]);
        }
      } else {
        const int16_t* src = nullptr;
        int off = 0;
        unsigned bytes = 0;
        bool copy = false;
        if (lane < nf)
          copy = row_span(tb, Tp - 1 - g * K - lane, B, b, W, tb_end, src,
                          off, bytes);
        const unsigned total = __reduce_add_sync(kFull, copy ? bytes : 0u);
        if (lane == 0) mbar_expect_tx(&full[s], total);
        __syncwarp();
        if (copy)
          bulk_copy(slot + (size_t)lane * frame_elems, src, bytes, &full[s]);
      }
      if (++s == nslots) {
        s = 0;
        phase ^= 1u;
      }
      BACK_CLOCK(3);
    }
  } else {
    // the walker: every lane on the same position; lane l holds the window
    // start of frame Tp-1-(w*32+l) of the current 32 (sw_cur) and of the
    // next 32 (sw_next); K divides 32, so a chunk lies in one of them
    int pos = last[b];
    if (lane == 0) path[(size_t)(Tp - 1) * B + b] = pos;
    auto start_of = [=](int u) {
      return u >= 0 ? starts[(size_t)u * B + b] : 0;
    };
    int sw_cur = start_of(Tp - 1 - lane), sw_next = start_of(Tp - 33 - lane);
    for (int g = 0; g < nchunks; ++g) {
      const int i0 = g * K;                    // frames walked before
      if (i0 > 0 && (i0 & 31) == 0) {
        sw_cur = sw_next;
        sw_next = start_of(Tp - 1 - (i0 + 32) - lane);
      }
      const int t0 = Tp - 1 - i0;
      const int nf = min(K, nframes - i0);
      // whether the chunk is whole and every row of it was copied
      const int16_t* src;
      int off;
      unsigned bytes;
      const bool landed =
          TENSOR || lane >= nf ||
          row_span(tb, t0 - lane, B, b, W, tb_end, src, off, bytes);
      const bool whole = nf == K && __all_sync(kFull, landed);
      mbar_wait_tested(&full[s], phase);
      BACK_CLOCK(0);
      pos = walk_chunk<K, TENSOR>(pos, ring + (size_t)s * slot_elems,
                                  frame_elems, t0, nf, whole, sw_cur, i0 & 31,
                                  tb, B, b, W, tb_end, path, lane);
      BACK_CLOCK(1);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == nslots) {
        s = 0;
        phase ^= 1u;
      }
      BACK_CLOCK(2);
    }
  }
#ifdef REMAP_BACK_CLOCKS
  clk[6] = chase;
  clk[7] = PHASE_CLOCK_TOTAL();
  if (b == 0 && lane == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) remap_back_clocks[warp * 8 + k] = clk[k];
  }
#endif
}

template <int K, bool TENSOR>
int launch(const void* tb, const void* starts, const void* last, void* path,
           int Tp, int B, int W, int nslots, int smem, int frame_elems,
           int slot_elems, unsigned long long tb_end, const CUtensorMap& tmap,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        remap_back_kernel<K, TENSOR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  remap_back_kernel<K, TENSOR><<<B, 64, smem, stream>>>(
      (const int16_t*)tb, (const int32_t*)starts, (const int32_t*)last,
      (int32_t*)path, Tp, B, W, nslots, frame_elems, slot_elems, tb_end,
      tmap);
  return (int)cudaGetLastError();
}

}  // namespace

// tb (Tp, B, W) int16; starts (Tp, B) int32; last (B,) int32; path (Tp, B)
// int32.  The plan comes from the caller (ops/remap_kernel.py::
// remap_back_plan): K frames a slot (1, 2, 4, 8 or 16), nslots slots
// (2-16), smem bytes, and the copy form: inner > 0 for one box a slot of
// a 4-D tensor map over tb, (inner, W / inner, B, Tp) (W % inner == 0,
// inner % 8 == 0, inner and W / inner at most 256), else one bulk copy a
// frame's row.  tb_end: the address one past the last byte of tb's
// storage.  Returns the cudaError_t of the launch (or of the map's
// encoding).
extern "C" int remap_back(const void* tb, const void* starts, const void* last,
                          void* path, int Tp, int B, int W, int K, int nslots,
                          int inner, int smem, unsigned long long tb_end,
                          void* stream) {
  int frame_elems, slot_elems;
  CUtensorMap tmap{};
  const bool tensor = inner > 0;
  if (tensor) {
    if (W % inner || inner % 8 || inner > 256 || W / inner > 256 ||
        (uintptr_t)tb % 16)
      return (int)cudaErrorInvalidValue;
    frame_elems = W;
    slot_elems = (K * W + 63) & ~63;     // 128-byte aligned slots
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[4] = {(cuuint64_t)inner, (cuuint64_t)(W / inner),
                                (cuuint64_t)B, (cuuint64_t)Tp};
    const cuuint64_t strides[3] = {(cuuint64_t)inner * 2, (cuuint64_t)W * 2,
                                   (cuuint64_t)B * W * 2};
    const cuuint32_t box[4] = {(cuuint32_t)inner, (cuuint32_t)(W / inner), 1,
                               (cuuint32_t)K};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    if (encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_UINT16, 4, const_cast<void*>(tb),
               dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  } else {
    frame_elems = ((2 * W + 14 + 15) & ~15) / 2;
    slot_elems = K * frame_elems;
  }
  if (Tp < 1 || W < 1 || nslots < 2 || nslots > kMaxSlots ||
      (uintptr_t)tb % 2 ||
      (size_t)smem < kBarBytes + (size_t)nslots * slot_elems * 2)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define REMAP_BACK_LAUNCH(K)                                                  \
  (tensor ? launch<K, true>(tb, starts, last, path, Tp, B, W, nslots, smem,  \
                            frame_elems, slot_elems, tb_end, tmap, s)        \
          : launch<K, false>(tb, starts, last, path, Tp, B, W, nslots, smem, \
                             frame_elems, slot_elems, tb_end, tmap, s))
  switch (K) {
    case 1: return REMAP_BACK_LAUNCH(1);
    case 2: return REMAP_BACK_LAUNCH(2);
    case 4: return REMAP_BACK_LAUNCH(4);
    case 8: return REMAP_BACK_LAUNCH(8);
    case 16: return REMAP_BACK_LAUNCH(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REMAP_BACK_LAUNCH
}

#ifdef REMAP_BACK_CLOCKS
// copy the slot-phase clocks of the last launch, [warp][8], to host memory
extern "C" int remap_back_clocks_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, remap_back_clocks,
                                   sizeof(remap_back_clocks));
}
#endif
