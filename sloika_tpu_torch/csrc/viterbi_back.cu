// Transducer Viterbi backtrace for Hopper (sm_90a).
//
// Replaces the reverse lax.scan of sloika_tpu/ops/pallas/viterbi.py::
// _viterbi_impl (decode_code / back_step), which runs as XLA code after the
// Pallas forward.  Given the int8 traceback codes tb (T, B, K) of the
// forward kernel and the final state of each row, it walks t = T-1 .. 1:
//
//   path[t] = state;  moved[t] = code >= 0
//   code in [0, 4):   state = code * K/4  + state / 4     (step from group)
//   code in [4, 20):  state = (code-4) * K/16 + state / 16 (skip from group)
//   code == -1:       state unchanged                      (stay)
//
// and ends with path[0] = state, moved[0] = false.  path is (B, T) int32,
// moved (B, T) bool.
// For another nbase or klen (codes g < nbase a step, nbase + h a skip) the
// general route below streams frames by 1-D bulk copies; klen 7 over 4
// bases takes this kernel (ops/viterbi_kernel.py::viterbi_back_general_plan).
//
// What bounds it.  Each step's read depends on the step before: a row is a
// chain of T - 1 dependent reads.  The design before this one gave each
// row a thread, all of them in one block, and read each code from device
// memory: 880 of its 932 cycles a step waited for that load (PERF.md §6,
// step 0).  The bytes the function must move (a code read, a state and a
// move written, a step) are a few MB.
//
// What the design does about it.  One block a row, of two warps.  The
// second (the copier) streams the row's traceback rows tb[t, b, 0:K], in
// falling t, into a ring of shared-memory slots of F frames each: one box
// of a 4-D tensor map over tb, (inner, K / inner, B, T) with inner =
// min(K, 256) (a box's sides are at most 256), box (inner, K / inner, 1,
// F), one cp.async.bulk.tensor a slot on the slot's "full" mbarrier, once
// the walker has released the slot on its "empty" one.  Frames below 0
// come as zeros and are not walked.  The first warp (the walker) chases the
// state through the slot's frames, all 32 lanes on the same address (a
// broadcast), so that lane q can keep frame q's state and move; after a
// slot, lanes 0 .. F-1 store them, 32 neighbouring int32 and bytes a warp
// store.  A wait on a slot's barrier tests it first (mbarrier.test_wait):
// a blocking try_wait on a completed phase cost ~200 cycles (PERF.md §6).
// The plan (ops/viterbi_kernel.py::viterbi_back_plan) takes F frames a
// slot (16 KB at K = 1,024) and as many slots as fit beside the blocks an
// SM must hold.  The design reads the whole traceback once, T B K bytes,
// and its chain is T shared-memory load-to-use latencies (23 cycles each,
// chased alone) and the decode: ~77 cycles a frame in all (PERF.md §6);
// the bytes bound it only at B = 1,024.
#include "bulk_copy.cuh"
#include "tensor_map.cuh"

#ifdef VITERBI_BACK_CLOCKS
// Slot-phase clocks (scripts/bench_viterbi.py --clocks builds this source
// with -DVITERBI_BACK_CLOCKS into a library of its own): lane 0 of each warp
// of block 0 sums, over its slots, the SM clock cycles of the wait for the
// slot (0: the walker's on the full barrier, the copier's on the empty
// one), the walk of its frames (1), the stores of their states and moves
// (2), the release (3) and the copy's issue (4); slot 7 holds the loop's
// cycles.  Before the loop, thread 0 of block 0 chases 64 dependent 1-byte
// reads through shared memory (slot 6 of warp 0: their cycles), the
// load-to-use latency that the walk's chain repeats.
__device__ long long viterbi_back_clocks[32 * 8];
__device__ int viterbi_back_sink;
#define BACK_CLOCK(k) PHASE_CLOCK(k)
#else
#define BACK_CLOCK(k) \
  do {                \
  } while (0)
#endif

namespace {

constexpr int kMaxSlots = 16;
constexpr int kBarBytes = 256;       // full[16], empty[16]
constexpr int kMaxInner = 256;       // the longest side of a box
constexpr unsigned kFull = 0xffffffffu;

// one frame of the walk: the code at (row, state), kept by lane q, then
// decoded into the state before it
__device__ __forceinline__ int step_back(int state, const int8_t* row,
                                         int q4, int q16, int q, int lane,
                                         int& mine, int& mv) {
  const int c = row[state];
  mine = lane == q ? state : mine;
  mv = lane == q ? (int)(c >= 0) : mv;
  const int step = c * q4 + (state >> 2);
  const int skip = (c - 4) * q16 + (state >> 4);
  return c >= 4 ? skip : (c >= 0 ? step : state);
}

// the walk of a slot's nf frames t0, t0 - 1, ...: frame t0 - q is row
// F-1-q of the slot ([F][K], rising t)
template <int F>
__device__ __forceinline__ int walk_slot(int state, const int8_t* slot, int K,
                                         int nf, int lane, int& mine,
                                         int& mv) {
  const int q4 = K >> 2, q16 = K >> 4;
  if (nf == F) {
#pragma unroll
    for (int q = 0; q < F; ++q)
      state = step_back(state, slot + (F - 1 - q) * K, q4, q16, q, lane,
                        mine, mv);
  } else {
    for (int q = 0; q < nf; ++q)
      state = step_back(state, slot + (F - 1 - q) * K, q4, q16, q, lane,
                        mine, mv);
  }
  return state;
}

template <int F>
__global__ void __launch_bounds__(64)
viterbi_back_kernel(const int32_t* __restrict__ last_state,
                    int32_t* __restrict__ path, uint8_t* __restrict__ moved,
                    int T, int B, int K, int nslots, int slot_bytes,
                    const __grid_constant__ CUtensorMap tmap) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);          // [nslots]
  uint64_t* empty = full + kMaxSlots;                          // [nslots]
  int8_t* ring = reinterpret_cast<int8_t*>(smem + kBarBytes);  // [nslots][slot]
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nframes = T - 1;                  // t = T-1 .. 1
  const int nchunks = (nframes + F - 1) / F;

#ifdef VITERBI_BACK_CLOCKS
  long long chase = 0;
  if (b == 0 && threadIdx.x == 0) {
    for (int i = 0; i < 64; ++i) ring[i] = (int8_t)((i + 1) & 63);
    int x = 0;
    long long c0, c1;
    asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(c0) : : "memory");
    for (int i = 0; i < 64; ++i) x = ring[x];
    asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(c1) : : "memory");
    chase = c1 - c0;
    viterbi_back_sink = x;
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
#ifdef VITERBI_BACK_CLOCKS
  PHASE_CLOCK_START();
#endif
  if (warp == 1) {
    // the copier: chunk g (frames T-1-gF .. down) into slot g % nslots,
    // once the walker has released the slot's chunk g - nslots
    if (lane == 0) {
      for (int g = 0; g < nchunks; ++g) {
        if (g >= nslots) mbar_wait_tested(&empty[s], phase ^ 1u);
        BACK_CLOCK(0);
        mbar_expect_tx(&full[s], (unsigned)(F * K));
        tensor_copy_4d(ring + (size_t)s * slot_bytes, &tmap, 0, 0, b,
                       T - (g + 1) * F, &full[s]);
        if (++s == nslots) {
          s = 0;
          phase ^= 1u;
        }
        BACK_CLOCK(4);
      }
    }
  } else {
    int state = last_state[b];
    int32_t* p = path + (size_t)b * T;
    uint8_t* m = moved + (size_t)b * T;
    for (int g = 0; g < nchunks; ++g) {
      const int t0 = T - 1 - g * F;
      const int nf = min(F, nframes - g * F);
      mbar_wait_tested(&full[s], phase);
      BACK_CLOCK(0);
      int mine = 0, mv = 0;
      state = walk_slot<F>(state, ring + (size_t)s * slot_bytes, K, nf, lane,
                           mine, mv);
      BACK_CLOCK(1);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == nslots) {
        s = 0;
        phase ^= 1u;
      }
      BACK_CLOCK(3);
      if (lane < nf) {
        p[t0 - lane] = mine;
        m[t0 - lane] = (uint8_t)mv;
      }
      BACK_CLOCK(2);
    }
    if (lane == 0) {
      p[0] = state;
      m[0] = 0;
    }
  }
#ifdef VITERBI_BACK_CLOCKS
  clk[6] = chase;
  clk[7] = PHASE_CLOCK_TOTAL();
  if (b == 0 && lane == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) viterbi_back_clocks[warp * 8 + k] = clk[k];
  }
#endif
}

// The general route, for the general forward's codes (any nbase; K =
// nbase^klen, not a power of two for nbase 3 or 5, so a frame's start
// (t B + b) K is not 16-byte aligned and the tensor map's 16-byte strides
// cannot take it).  The design of the kernel above, by other copies: the
// copier streams frames t = T-1 .. 1 of row b into a ring of slots of F
// frames, lane q of the copier warp copying frame q of a slot as one 1-D
// cp.async.bulk of its 16-byte-aligned superset (up to frame_bytes, the
// row's offset inside it kept), all on the slot's full mbarrier; a frame
// whose superset would run past the traceback's storage is not copied and
// the walker reads it from device memory (with no ring, nslots = 0, it
// reads every frame so: the plan takes that for frames past 32 KB, whose
// copies into one SM take longer than a dependent load, and where two
// slots do not fit; klen 7 over 4 bases goes to the kernel above, K being
// a power of two).  The walker chases the state through the slot's frames
// (unrolled where the slot is whole and copied) with all lanes on one
// address, keeping frame q's state and move in lane q % 32, and stores 32
// neighbouring states and moves a warp store.  The decode divides by
// nbase and nbase^2 as a multiply-high by a reciprocal m (state < 2^24 and
// nbase^2 <= 100 keep it exact), not a division in the chain.  Each wait
// tests before it blocks.  What bounds it: the chain (a shared-memory load,
// a multiply-add and two selects a frame), or, where K is large, the
// copies of K bytes a frame into one SM.
struct GeneralWalk {
  int nbase, nrs, nrk, skip0;
  unsigned m1, m2;
  // the state before `state` at a frame whose code is c
  __device__ __forceinline__ int back(int state, int c) const {
    const int h1 = (int)__umulhi((unsigned)state, m1);   // state / nbase
    const int h2 = (int)__umulhi((unsigned)state, m2);   // / nbase^2
    const int step = c * nrs + h1;
    const int skip = c * nrk - skip0 + h2;               // (c - nbase) nrk
    return c >= nbase ? skip : (c >= 0 ? step : state);
  }
};

template <int F>
__global__ void __launch_bounds__(64)
viterbi_back_general_kernel(const int8_t* __restrict__ tb,
                            const int32_t* __restrict__ last_state,
                            int32_t* __restrict__ path,
                            uint8_t* __restrict__ moved, int T, int B, int K,
                            int nbase, int nslots, int frame_bytes,
                            unsigned m1, unsigned m2,
                            unsigned long long tb_end) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);          // [nslots]
  uint64_t* empty = full + kMaxSlots;                          // [nslots]
  // [nslots][F][frame_bytes]
  int8_t* ring = reinterpret_cast<int8_t*>(smem + kBarBytes);
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nframes = T - 1;                  // t = T-1 .. 1
  const int nchunks = (nframes + F - 1) / F;
  const int slot_bytes = F * frame_bytes;
  const unsigned long long row0 = (unsigned long long)(tb + (size_t)b * K);
  const unsigned long long frame_step = (unsigned long long)B * K;
  // frame t's address, and its 16-byte-aligned superset: its start, the
  // row's offset in it and its bytes; whether it is copied (it ends within
  // the storage and there is a ring)
  auto at = [&](int t) { return row0 + (unsigned long long)t * frame_step; };
  auto span = [&](int t, unsigned long long& a0, int& off,
                  unsigned& bytes) -> bool {
    const unsigned long long a = at(t);
    a0 = a & ~15ull;
    off = (int)(a - a0);
    const unsigned long long e = (a + (unsigned long long)K + 15ull) & ~15ull;
    bytes = (unsigned)(e - a0);
    return nslots > 0 && e <= tb_end;
  };

#ifdef VITERBI_BACK_CLOCKS
  long long chase = 0;
  if (b == 0 && threadIdx.x == 0 && nslots > 0) {
    for (int i = 0; i < 64; ++i) ring[i] = (int8_t)((i + 1) & 63);
    int x = 0;
    long long c0, c1;
    asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(c0) : : "memory");
    for (int i = 0; i < 64; ++i) x = ring[x];
    asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(c1) : : "memory");
    chase = c1 - c0;
    viterbi_back_sink = x;
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
#ifdef VITERBI_BACK_CLOCKS
  PHASE_CLOCK_START();
#endif
  if (warp == 1) {
    // the copier: chunk g (frames T-1-gF .. down) into slot g % nslots,
    // once the walker has released the slot's chunk g - nslots
    for (int g = 0; g < nchunks && nslots > 0; ++g) {
      if (g >= nslots) {
        if (lane == 0) mbar_wait_tested(&empty[s], phase ^ 1u);
        __syncwarp();
      }
      BACK_CLOCK(0);
      const int nf = min(F, nframes - g * F);
      unsigned long long a0 = 0;
      int off;
      unsigned bytes = 0;
      const bool copy = lane < nf && span(T - 1 - g * F - lane, a0, off,
                                          bytes);
      const unsigned total = __reduce_add_sync(kFull, copy ? bytes : 0u);
      if (lane == 0) mbar_expect_tx(&full[s], total);  // 0: completes
      __syncwarp();
      if (copy)
        bulk_copy(ring + s * slot_bytes + lane * frame_bytes,
                  reinterpret_cast<const void*>(a0), bytes, &full[s]);
      if (++s == nslots) {
        s = 0;
        phase ^= 1u;
      }
      BACK_CLOCK(4);
    }
  } else {
    const GeneralWalk walk{nbase, K / nbase, K / (nbase * nbase),
                           nbase * (K / (nbase * nbase)), m1, m2};
    int state = last_state[b];
    int32_t* p = path + (size_t)b * T;
    uint8_t* m = moved + (size_t)b * T;
    // lane k + q keeps frame t_hi - k - q; 32 frames a warp store (F
    // divides 32, so a slot never straddles two stores)
    int mine = 0, mv = 0, k = 0, t_hi = T - 1;
    for (int g = 0; g < nchunks; ++g) {
      const int t0 = T - 1 - g * F;
      const int nf = min(F, nframes - g * F);
      if (nslots > 0) mbar_wait_tested(&full[s], phase);
      BACK_CLOCK(0);
      const int8_t* slot = ring + s * slot_bytes;
      unsigned long long a0;
      int off0;
      unsigned bytes;
      // frames at falling addresses: the slot's first copied, all copied
      if (nf == F && span(t0, a0, off0, bytes)) {
        int offs[F];
#pragma unroll
        for (int q = 0; q < F; ++q)
          offs[q] = q * frame_bytes + (int)(at(t0 - q) & 15ull);
#pragma unroll
        for (int q = 0; q < F; ++q) {
          const int c = slot[offs[q] + state];
          mine = lane == k + q ? state : mine;
          mv = lane == k + q ? (int)(c >= 0) : mv;
          state = walk.back(state, c);
        }
      } else {
        for (int q = 0; q < nf; ++q) {
          int off;
          const bool copied = span(t0 - q, a0, off, bytes);
          const int8_t* own = reinterpret_cast<const int8_t*>(at(t0 - q));
          const int c = copied ? (int)slot[q * frame_bytes + off + state]
                               : (int)own[state];
          mine = lane == k + q ? state : mine;
          mv = lane == k + q ? (int)(c >= 0) : mv;
          state = walk.back(state, c);
        }
      }
      BACK_CLOCK(1);
      __syncwarp();
      if (nslots > 0) {
        if (lane == 0) mbar_arrive(&empty[s]);
        if (++s == nslots) {
          s = 0;
          phase ^= 1u;
        }
      }
      BACK_CLOCK(3);
      k += nf;
      if (k == 32) {
        p[t_hi - lane] = mine;
        m[t_hi - lane] = (uint8_t)mv;
        t_hi -= 32;
        k = 0;
      }
      BACK_CLOCK(2);
    }
    if (lane < k) {
      p[t_hi - lane] = mine;
      m[t_hi - lane] = (uint8_t)mv;
    }
    if (lane == 0) {
      p[0] = state;
      m[0] = 0;
    }
    BACK_CLOCK(2);
  }
#ifdef VITERBI_BACK_CLOCKS
  clk[6] = chase;
  clk[7] = PHASE_CLOCK_TOTAL();
  if (b == 0 && lane == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) viterbi_back_clocks[warp * 8 + k] = clk[k];
  }
#endif
}

template <int F>
int launch_general(const void* tb, const void* last, void* path, void* moved,
                   int T, int B, int K, int nbase, int nslots,
                   int frame_bytes, int smem, unsigned m1, unsigned m2,
                   unsigned long long tb_end, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        viterbi_back_general_kernel<F>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  viterbi_back_general_kernel<F><<<B, 64, smem, stream>>>(
      (const int8_t*)tb, (const int32_t*)last, (int32_t*)path,
      (uint8_t*)moved, T, B, K, nbase, nslots, frame_bytes, m1, m2, tb_end);
  return (int)cudaGetLastError();
}

template <int F>
int launch(const void* last, void* path, void* moved, int T, int B, int K,
           int nslots, int slot_bytes, int smem, const CUtensorMap& tmap,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        viterbi_back_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  viterbi_back_kernel<F><<<B, 64, smem, stream>>>(
      (const int32_t*)last, (int32_t*)path, (uint8_t*)moved, T, B, K, nslots,
      slot_bytes, tmap);
  return (int)cudaGetLastError();
}

}  // namespace

// tb (T, B, K) int8, 16-byte aligned; last_state (B,) int32; path (B, T)
// int32; moved (B, T) uint8.  K a power of two from 16 to 65,536 (the
// tuned shapes, and the general route's klen 7 over 4 bases).  The plan
// comes from the caller (ops/viterbi_kernel.py::viterbi_back_plan): F
// frames a slot (1, 2, 4, 8, 16 or 32), nslots slots (2-16) and smem
// bytes.  Returns the cudaError_t of the launch (or of the map's encoding);
// cudaErrorInvalidValue (1) for a plan that does not fit.
extern "C" int viterbi_back(const void* tb, const void* last_state,
                            void* path, void* moved, int T, int B, int K,
                            int F, int nslots, int smem, void* stream) {
  const int slot_bytes = (F * K + 127) & ~127;      // 128-byte aligned boxes
  if (T < 1 || B < 1 || K < 16 || K > 65536 || (K & (K - 1)) ||
      nslots < 2 || nslots > kMaxSlots || (uintptr_t)tb % 16 ||
      (size_t)smem < kBarBytes + (size_t)nslots * slot_bytes)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const int inner = K < kMaxInner ? K : kMaxInner;
  const cuuint64_t dims[4] = {(cuuint64_t)inner, (cuuint64_t)(K / inner),
                              (cuuint64_t)B, (cuuint64_t)T};
  const cuuint64_t strides[3] = {(cuuint64_t)inner, (cuuint64_t)K,
                                 (cuuint64_t)B * K};
  const cuuint32_t box[4] = {(cuuint32_t)inner, (cuuint32_t)(K / inner), 1,
                             (cuuint32_t)F};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUtensorMap tmap{};
  if (encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(tb),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define VITERBI_BACK_LAUNCH(F_)                                            \
  launch<F_>(last_state, path, moved, T, B, K, nslots, slot_bytes, smem, \
             tmap, s)
  switch (F) {
    case 1: return VITERBI_BACK_LAUNCH(1);
    case 2: return VITERBI_BACK_LAUNCH(2);
    case 4: return VITERBI_BACK_LAUNCH(4);
    case 8: return VITERBI_BACK_LAUNCH(8);
    case 16: return VITERBI_BACK_LAUNCH(16);
    case 32: return VITERBI_BACK_LAUNCH(32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VITERBI_BACK_LAUNCH
}

// The general route (viterbi_back_general_kernel): tb (T, B, K) int8 of
// K = nbase^klen states over nbase bases, nbase + nbase^2 <= 128, any
// alignment; the rest as viterbi_back.  The plan comes from the caller
// (ops/viterbi_kernel.py::viterbi_back_general_plan): F frames a slot (1,
// 2, 4, 8, 16 or 32), nslots slots (0: no ring, every frame read from
// device memory; else 2-16) of F frame_bytes each (a frame's
// 16-byte-aligned superset, K + 15 rounded up to 16) and smem bytes.
// tb_end: the address one past the last byte of tb's storage.  Returns
// the cudaError_t of the launch; cudaErrorInvalidValue (1) for shapes or a
// plan it does not take.
extern "C" int viterbi_back_general(const void* tb, const void* last_state,
                                    void* path, void* moved, int T, int B,
                                    int K, int nbase, int F, int nslots,
                                    int frame_bytes, int smem,
                                    unsigned long long tb_end, void* stream) {
  const int nskip = nbase * nbase;
  if (T < 1 || B < 1 || nbase < 2 || nbase + nskip > 128 || K < nskip ||
      K % nskip || K >= (1 << 24) || nslots == 1 || nslots < 0 ||
      nslots > kMaxSlots || frame_bytes % 16 ||
      frame_bytes < ((K + 15 + 15) & ~15) ||
      (size_t)smem < kBarBytes + (size_t)nslots * F * frame_bytes)
    return (int)cudaErrorInvalidValue;
  // ceil(2^32 / d): exact floor(state / d) by multiply-high for state <
  // 2^24 and d <= 100 (the error state (m d - 2^32) / (d 2^32) < 1 / d)
  const unsigned m1 = (unsigned)((0x100000000ull + nbase - 1) / nbase);
  const unsigned m2 = (unsigned)((0x100000000ull + nskip - 1) / nskip);
  const cudaStream_t s = (cudaStream_t)stream;
#define VITERBI_BACK_GENERAL_LAUNCH(F_)                                   \
  launch_general<F_>(tb, last_state, path, moved, T, B, K, nbase, nslots, \
                     frame_bytes, smem, m1, m2, tb_end, s)
  switch (F) {
    case 1: return VITERBI_BACK_GENERAL_LAUNCH(1);
    case 2: return VITERBI_BACK_GENERAL_LAUNCH(2);
    case 4: return VITERBI_BACK_GENERAL_LAUNCH(4);
    case 8: return VITERBI_BACK_GENERAL_LAUNCH(8);
    case 16: return VITERBI_BACK_GENERAL_LAUNCH(16);
    case 32: return VITERBI_BACK_GENERAL_LAUNCH(32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VITERBI_BACK_GENERAL_LAUNCH
}

#ifdef VITERBI_BACK_CLOCKS
// copy the slot-phase clocks of the last launch, [warp][8], to host memory
extern "C" int viterbi_back_clocks_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, viterbi_back_clocks,
                                   sizeof(viterbi_back_clocks));
}
#endif
