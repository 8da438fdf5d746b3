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
// 3.35 TB/s; the chain of steps takes far longer, so the latency of one
// step bounds it.  The design before this one took ~3,000 cycles a step
// (PERF.md §6, step 0): two block barriers and a serial fold of the
// warp totals ~950, an update ~1,000 whose shared-memory reads queued
// behind the next step's 768 scattered 4-byte gathers from device memory,
// and ~500 waiting for those gathers.
//
// What the design does about it.  One block per batch row runs all steps
// with C consumer warps of PPT contiguous positions a thread (the plan,
// ops/remap_kernel.py::remap_banded_plan: 6 warps x 4 at W = 768, 12 x 8
// at 3,072).  PPT is a template argument: every position of a thread is
// computed without a guard, positions past the window included (they come
// after every real one, so no real prefix max or source reads them), and
// only their stores are masked.
// - Each frame's posterior row comes into a ring of shared-memory slots of
//   G frames by bulk asynchronous copies (cp.async.bulk) on the slot's
//   mbarrier.  A producer warp joins each step's barrier and, after the
//   one that ends a slot's frames, refills the slot: lane q copies frame
//   q, off the consumers' path.  A row is NS * 4 = 4,100 bytes and starts
//   on a 16-byte boundary for one row in four, so a copy takes the aligned
//   superset (up to 4,112 bytes) and the emissions are read at the row's
//   offset into it; a superset that would run past the tensor's storage
//   (its last row) is not copied, and that frame is gathered from device
//   memory.  The consumers gather frame t + 1 after step t's barrier, so
//   those reads land while the fold and the update run, and wait on a
//   slot's barrier once in G steps.  No device-memory latency is left on
//   the step's chain but at window moves, every TB frames, where the next
//   window's states are read (6 cycles a step in the design before this
//   one).  Where no ring of two slots fits beside the window's arrays
//   (posterior rows of 16,385 states at W above 9,976, or of 65,537 at
//   any W), the plan sets no slots and no producer: the consumers gather
//   each frame's emissions from device memory a step ahead, as the design
//   before this one did, so the kernel keeps its reach over NS.
// - The carried scores stay in registers.  A step's prefix max is a
//   sequential pass over a thread's positions, a __shfl_up_sync scan of the
//   thread totals in the warp, and a fold of the warp totals before the
//   thread's warp, which lane 31 of each warp publishes (double-buffered by
//   the parity of t) before the step's one __syncthreads().  Where the
//   window does not move (d = 0, all but one step in TB) every source of
//   lane j lies at j, j - 1 or j - 2: in the thread's own registers, in
//   lane - 1's (a shuffle), or, for lane 0, in what lane 31 of the warp
//   before published beside its total.  Where it moves, every thread also
//   publishes its scores and warp prefix maxima, and the step takes two
//   more barriers: one before the shifted reads, one after them.  The
//   combination is associative with ties to the earlier position, so the
//   result equals the TPU scan's wherever it can win (see the plain twin's
//   tests).
// - The traceback row is written a thread's PPT deltas at a time, up to
//   16 bytes a store: 53 cycles a step in the design before this one, so
//   no bulk store.
// What bounds it now: a step is ~600 warp instructions, most of them
// dependent compares and selects on the half-rate integer pipe; with one
// warp a scheduler they run at ~3 cycles each (PERF.md §6), so the
// plan spreads W over more warps than schedulers.
//
// The wide route: windows of 16,385 .. 32,767 positions, past what one block
// holds (10 bytes a position of shared memory beside the ring, and 16
// positions a thread in registers at 1,024 threads). The exact DP of a
// reference in the 22,145-position bucket takes W = 22,272. A row is a
// cluster of nblk blocks (the plan, ops/remap_kernel.py::wide_plan: 8 of
// 2,816 positions at 8 a thread at W = 22,272), each the design above on its
// share of the window, in its own registers, with its own posterior ring and
// its own arrays for the moved window. Every block before the last holds hb
// positions, a multiple of its warps' 32 ppt, so that no position past its
// own lies in it. Blocks of at most 15 consumer warps and a producer keep to
// 512 threads and 128 registers a thread. (Two blocks cannot cover the
// route: beside the producer warp, a block of 1,024 threads holds 31
// consumer warps, 15,872 positions at 16 a thread, and two hold 31,744.)
// The fold of a block's warp totals is one scan across a warp (every
// warp reads all the totals), not a serial fold. Across the splits, a step
// that does not move (d = 0, all but one step in 256) needs only, in block
// r, the total prefix max (value, position) of each block before it, and the
// block before's last score and prefix max at its last position but one.
// After the step's block barrier each producer warp scans its block's warp
// totals and stores those into the shared memory of the blocks after it (by
// the parity of t), then arrives at the step's cluster barrier: it has no
// stores of its own for the release to wait for. The consumers arrive as the
// step before ends, before its traceback stores; block r > 0 waits before
// its fold takes the totals, block 0 last, at the step's end, so the
// barrier's hop is on the later blocks' path only. A moved step publishes
// every block's arrays and takes a second cluster barrier; the sources in
// another block (a block's last d + 2 positions, and a wrapped slip
// position) are read over distributed shared memory. Between two moves the
// steps' barriers order every reuse. The traceback row goes out as above,
// each block writing its share.
#include <math.h>

#include "bulk_copy.cuh"

#ifdef REMAP_BANDED_CLOCKS
// Step-phase clocks (scripts/bench_remap.py --clocks builds this source
// with -DREMAP_BANDED_CLOCKS into a library of its own): lane 0 of each warp
// of row 0's block (the wide route: of its first two blocks, block r's
// warps from 32 r) sums, over the steps, the SM clock cycles of the
// traceback stores, the masking of the next emissions (where their reads
// land) and the step's head with the issue of the next window's loads (0),
// the issue of the next frame's gather (1), the local and warp scans with
// the publication (2), the barrier (3), the fold of the warp totals (4; the
// wide route: with block 0's send of its edge and block 1's merge of it),
// the update (5) and the wait for a slot's copies (6; the wide route: the
// waits at the cluster barriers, its slot waits going to 1); slot 7 holds
// the loop's cycles.  The producer warp stamps its barrier and refill (3)
// and its window moves' barriers (5; the wide route: every cluster
// barrier).
__device__ long long remap_banded_clocks[2 * 32 * 8];
#define BAND_CLOCK(k) PHASE_CLOCK(k)
#else
#define BAND_CLOCK(k) \
  do {                \
  } while (0)
#endif

namespace {

constexpr float kNeg = -1.0e30f;   // NEG_LARGE, sloika_tpu/ops/remap_jax.py:29
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSlots = 16;
constexpr int kBarBytes = 256;     // the slots' full mbarriers
// the wide route: its mbarriers, then the edges the blocks before this
// one send it (by the parity of t: every earlier block's total, float2 [2]
// [8] from kXtotOffset; the block before's last score and prefix max at its
// last position but one, float4 [2] from kXedgeOffset), then the ring
constexpr int kWideBarBytes = 512;
constexpr int kXtotOffset = 128, kXedgeOffset = 256;
constexpr int kMaxCluster = 8;     // blocks a row at most (portable)

// The states and validity bits of a thread's positions for the window
// starting at s (_block_emissions :230-242, by gather); positions past the
// window are not valid.
template <int PPT>
__device__ __forceinline__ void window(int s, int j0, int W, int P, int NS,
                                       const int32_t* __restrict__ seq_b,
                                       const uint8_t* __restrict__ mask_b,
                                       int (&st)[PPT], unsigned& ok) {
  ok = 0u;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int a = s + j0 + i;
    const int idx = min(max(a, 0), P - 1);
    // clamped so a bad state can never address outside the row
    st[i] = min(max(seq_b[idx], 0), NS - 1);
    if (j0 + i < W && a < P && mask_b[idx]) ok |= 1u << i;
  }
}

// Frame t's posterior row as a bulk copy takes it: the 16-byte boundary at
// or below the row, the row's offset into the copy (floats) and the copy's
// bytes.  Returns false where the copy would run past `end`, the end of the
// tensor's storage: that row is read from device memory instead.
__device__ __forceinline__ bool row_span(const float* lt, int t, int B, int b,
                                         int NS, unsigned long long end,
                                         const float*& src, int& off,
                                         unsigned& bytes) {
  const unsigned long long a =
      (unsigned long long)(lt + ((size_t)t * B + b) * NS);
  const unsigned long long a0 = a & ~15ull;
  const unsigned long long e = (a + 4ull * NS + 15ull) & ~15ull;
  src = reinterpret_cast<const float*>(a0);
  off = (int)((a - a0) >> 2);
  bytes = (unsigned)(e - a0);
  return e <= end;
}

// Fill ring slot `slot` (G rows) with frames f0 .. f0 + G - 1, those below
// T: lane q copies frame f0 + q; lane 0 arms the slot's barrier with their
// bytes.  A row whose copy would run past the storage is not copied (it is
// read from device memory).  Called by a whole warp.
__device__ __forceinline__ void refill(const float* lt, int f0, int G, int T,
                                       int B, int b, int NS,
                                       unsigned long long end, float* slot,
                                       int slot_floats, uint64_t* bar,
                                       int lane) {
  const float* src = nullptr;
  int off = 0;
  unsigned bytes = 0;
  bool copy = false;
  if (lane < G && f0 + lane < T)
    copy = row_span(lt, f0 + lane, B, b, NS, end, src, off, bytes);
  const unsigned total = __reduce_add_sync(kFull, copy ? bytes : 0u);
  if (lane == 0) mbar_expect_tx(bar, total);   // 0: the phase completes
  __syncwarp();
  if (copy) bulk_copy(slot + (size_t)lane * slot_floats, src, bytes, bar);
}

// a, the earlier segment's (value, position), takes b's only where b's
// value is strictly greater: ties go to the earlier position
__device__ __forceinline__ void later(float& av, int& ai, float bv, int bi) {
  const bool take = bv > av;
  av = take ? bv : av;
  ai = take ? bi : ai;
}

// The wide route's cluster of blocks (sm_90): the address of `p` in
// the shared memory of the cluster's block `rank`, weak loads and stores
// at such an address, and the split cluster barrier (an arrival releases
// this thread's earlier writes, local and remote; a wait acquires those of
// every thread that arrived)
__device__ __forceinline__ uint32_t map_rank(const void* p, unsigned rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ int ld_cluster_s16(uint32_t a) {
  int v;
  asm volatile("ld.shared::cluster.s16 %0, [%1];\n" : "=r"(v) : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_cluster(uint32_t a, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   a),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t a, float2 v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(a),
               "f"(v.x), "f"(v.y)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the inclusive scan of (value, position) pairs across a warp, in lane
// order, the earlier lane's winning ties
__device__ __forceinline__ void warp_scan_later(float& v, int& vi, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float ov = __shfl_up_sync(kFull, v, o);
    const int oi = __shfl_up_sync(kFull, vi, o);
    const bool take = lane >= o && !(v > ov);
    v = take ? ov : v;
    vi = take ? oi : vi;
  }
}

__device__ __forceinline__ uint32_t pack2(int lo, int hi) {
  return ((uint32_t)lo & 0xffffu) | ((uint32_t)hi << 16);
}

// the thread's PPT deltas of a traceback row: `vec` bytes a store, 16
// (W % 8 == 0 and PPT % 8 == 0), 8 (W % 4 == 0 and PPT % 4 == 0), 4 (W
// even) or 2
template <int PPT>
__device__ __forceinline__ void store_row(int16_t* __restrict__ row, int j0,
                                          int W, const int (&dl)[PPT],
                                          int vec) {
  if (PPT % 8 == 0 && vec == 16) {
#pragma unroll
    for (int i = 0; i < PPT; i += 8) {
      if (j0 + i < W) {
        *reinterpret_cast<uint4*>(row + j0 + i) = make_uint4(
            pack2(dl[i], dl[i + 1]), pack2(dl[i + 2], dl[i + 3]),
            pack2(dl[i + 4], dl[i + 5]), pack2(dl[i + 6], dl[i + 7]));
      }
    }
  } else if (PPT % 4 == 0 && vec == 8) {
#pragma unroll
    for (int i = 0; i < PPT; i += 4) {
      if (j0 + i < W)
        *reinterpret_cast<uint2*>(row + j0 + i) = make_uint2(
            pack2(dl[i], dl[i + 1]), pack2(dl[i + 2], dl[i + 3]));
    }
  } else if (vec == 4) {
#pragma unroll
    for (int i = 0; i < PPT; i += 2) {
      if (j0 + i < W)
        *reinterpret_cast<uint32_t*>(row + j0 + i) = pack2(dl[i], dl[i + 1]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      if (j0 + i < W) row[j0 + i] = (int16_t)dl[i];
    }
  }
}

// A row's window starts, 32 steps to a register of a warp: lane l of cur
// holds step base + l, of nxt step base + 32 + l (read 32 steps ahead)
struct StartWindow {
  const int32_t* starts;
  int B, b, Tp, lane, base, cur, nxt;

  __device__ int load(int u) const {
    return u < Tp ? starts[(size_t)u * B + b] : 0;
  }
  __device__ void init(const int32_t* s, int B_, int b_, int Tp_, int l) {
    starts = s;
    B = B_;
    b = b_;
    Tp = Tp_;
    lane = l;
    base = 0;
    cur = load(lane);
    nxt = load(32 + lane);
  }
  // the start of step u, for u = 1, 2, ... in turn
  __device__ int at(int u) {
    if (u - base == 32) {
      base += 32;
      cur = nxt;
      nxt = load(base + 32 + lane);
    }
    return __shfl_sync(kFull, cur, (u - base) & 31);
  }
};

// The kernel of both routes.  WIDE: the wide route, one block of a cluster
// of nblk a row, this block's positions those from rank * hb (the header
// says how the blocks meet; its producer warp is always there).
template <int PPT, int MAXT, bool WIDE>
__global__ void __launch_bounds__(MAXT)
remap_banded_kernel(const float* __restrict__ lt,
                    const int32_t* __restrict__ seq,
                    const uint8_t* __restrict__ pos_mask,
                    const float* __restrict__ prior0,
                    const int32_t* __restrict__ starts,
                    int16_t* __restrict__ tb, float* __restrict__ vfinal,
                    int T, int B, int NS, int P, int W, int Tp, int nwarps,
                    int producer, int G, int nslots, int slot_floats, int vec,
                    unsigned long long lt_end, float slip, int hb,
                    int nblk) {
  constexpr int kWarps = MAXT / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);           // [nslots]
  // the wide route's edges from the blocks before this one
  float2* xtot = reinterpret_cast<float2*>(smem + kXtotOffset);   // [2][8]
  float4* xedge = reinterpret_cast<float4*>(smem + kXedgeOffset); // [2]
  float* ring = reinterpret_cast<float*>(
      smem + (WIDE ? kWideBarBytes : kBarBytes));               // [nslots][G][slot]
  // the moved window's arrays: the block's own positions (from `base`)
  const int Wc = WIDE ? hb : (W + 7) & ~7;
  float* psh = ring + (size_t)nslots * G * slot_floats;         // [Wc] scores
  float* ysh = psh + Wc;                                        // [Wc] prefix max
  int16_t* ish = reinterpret_cast<int16_t*>(ysh + Wc);          // [Wc] its position
  // lane 31 of each warp: its warp's total (value, position), its last
  // score and the warp prefix max at its last position but one (value,
  // position); by the parity of t
  __shared__ float4 edge[2][kWarps];
  __shared__ int edge_i[2][kWarps];

  const int rank = WIDE ? (int)cluster_rank() : 0;
  const int b = WIDE ? (int)blockIdx.x / nblk : (int)blockIdx.x;
  const int base = WIDE ? rank * hb : 0;        // the block's first position
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j0 = base + tid * PPT;
  const int32_t* seq_b = seq + (size_t)b * P;
  const uint8_t* mask_b = pos_mask + (size_t)b * P;
  const size_t chunk_floats = (size_t)G * slot_floats;

  // the warp that fills the ring: the producer (the last), or warp 0 where
  // the consumers take all 32 warps
  const int filler = producer ? nwarps : 0;
  if (tid == 0) {
    for (int s = 0; s < nslots; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  // the wide route: every block runs before any remote access
  if constexpr (WIDE) cluster_sync();
  if (warp == filler) {
    // chunk k holds frames 1 + kG .. (k + 1)G, in slot k % nslots
    for (int k = 0; k < nslots; ++k)
      refill(lt, 1 + k * G, G, T, B, b, NS, lt_end, ring + k * chunk_floats,
             slot_floats, &full[k], lane);
  }
  StartWindow sw;
  sw.init(starts, B, b, Tp, lane);
  // only the last frame's copy can run past the storage (a row before it
  // ends at least a row before the end)
  bool last_copied;
  {
    const float* src;
    int off;
    unsigned bytes;
    last_copied = row_span(lt, T - 1, B, b, NS, lt_end, src, off, bytes);
  }
#ifdef REMAP_BANDED_CLOCKS
  PHASE_CLOCK_START();
  // row 0's blocks 0 and 1
  long long* clocks_out = remap_banded_clocks + (min(rank, 1) * 32 + warp) * 8;
  const bool clocked = b == 0 && lane == 0 && rank < 2;
#endif
  if (warp == nwarps) {
    // the producer: the step's barriers; after the one that ends a chunk,
    // the refill of its slot with the chunk nslots ahead
    int s_prev = starts[b], row = 0, slot = 0;
    int s_next = Tp > 1 ? sw.at(1) : s_prev;
    for (int t = 1; t < Tp; ++t) {
      const int s = s_next;
      s_next = sw.at(t + 1);
      __syncthreads();
      if constexpr (WIDE) {
        // the wide route: from the warps' edges, this block's total prefix
        // max (value, position) to every block after it, and its last
        // score and prefix max at its last position but one to the next,
        // then the step's arrival (this warp has no stores of its own for
        // the release to wait for)
        const int par = t & 1;
        float sv = -INFINITY;
        int si = 0;
        if (lane < nwarps) {
          const float2 e = *reinterpret_cast<const float2*>(&edge[par][lane]);
          sv = e.x;
          si = __float_as_int(e.y);
        }
        warp_scan_later(sv, si, lane);
        const float ov = __shfl_sync(kFull, sv, nwarps - 1);
        const int oi = __shfl_sync(kFull, si, nwarps - 1);
        float yv = __shfl_sync(kFull, sv, max(nwarps - 2, 0));
        int yi = __shfl_sync(kFull, si, max(nwarps - 2, 0));
        if (nwarps < 2) {
          yv = -INFINITY;
          yi = 0;
        }
        const float4 last = edge[par][nwarps - 1];
        later(yv, yi, last.w, edge_i[par][nwarps - 1]);
        if (lane > rank && lane < nblk)
          st_cluster(map_rank(&xtot[par * kMaxCluster + rank], lane),
                     make_float2(ov, __int_as_float(oi)));
        if (lane == rank + 1 && lane < nblk)
          st_cluster(map_rank(&xedge[par], lane),
                     make_float4(last.z, yv, __int_as_float(yi), 0.0f));
        __syncwarp();
        cluster_arrive();
        cluster_wait();
      }
      // (no ring: the wide route's producer only sends the edges)
      if (nslots > 0 && ++row == G) {
        row = 0;
        const int f0 = t + 1 + (nslots - 1) * G;
        if (f0 < T)
          refill(lt, f0, G, T, B, b, NS, lt_end, ring + slot * chunk_floats,
                 slot_floats, &full[slot], lane);
        slot = slot + 1 == nslots ? 0 : slot + 1;
      }
      BAND_CLOCK(3);
      if constexpr (WIDE) {
        if (s != s_prev) cluster_sync();  // the moved window's second
      } else if (s != s_prev) {      // the consumers' two more barriers
        __syncthreads();
        __syncthreads();
      }
      s_prev = s;
      BAND_CLOCK(5);
    }
#ifdef REMAP_BANDED_CLOCKS
    clk[7] = PHASE_CLOCK_TOTAL();
    if (clocked) {
#pragma unroll
      for (int k = 0; k < 8; ++k) clocks_out[k] = clk[k];
    }
#endif
    if constexpr (WIDE) cluster_sync();  // no block leaves while read
    return;
  }

  int st[PPT];
  unsigned ok, ok_next;
  float p[PPT];
  int dl[PPT];
  float sj[PPT];     // slip * j, and slip * (j - 1), rounded as the twin
  float sjm[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    dl[i] = 0;
    sj[i] = __fmul_rn(slip, (float)(j0 + i));
    sjm[i] = __fmul_rn(slip, __fadd_rn(__fsub_rn((float)(j0 + i), 1.0f),
                                       0.0f));
  }

  // t = 0: the initialisation row (sloika_tpu/ops/pallas/remap.py:311-315)
  int s_prev = starts[b];
  window<PPT>(s_prev, j0, W, P, NS, seq_b, mask_b, st, ok);
  {
    const float* row = lt + (size_t)b * NS;
    const float stay0 = row[0];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const float e = row[st[i]];
      const float em = ((ok >> i) & 1u) ? e : kNeg;
      const float p0w =
          prior0[(size_t)b * P + min(max(s_prev + j0 + i, 0), P - 1)];
      p[i] = em > kNeg * 0.5f ? __fadd_rn(p0w, fmaxf(em, stay0)) : kNeg;
    }
    store_row<PPT>(tb + (size_t)b * W, j0, W, dl, vec);
  }

  // the ring's cursor: frame `frame`'s row `row` of slot `slot`, whose
  // barrier's phase is `phase`; gathered a step ahead
  int frame = 1, row = 0, slot = 0;
  unsigned phase = 0;
  const float* row_g = lt + ((size_t)B + b) * NS;   // frame's row in lt
  const size_t row_step = (size_t)B * NS;
  float em[PPT], stay;
  // frame `frame`'s emissions and stay score at the window's states st
  // (unmasked: the caller applies the window's validity bits); then the
  // cursor moves on
  auto gather = [&](float (&e)[PPT], float& sv) {
    if (frame < T) {
      if (nslots > 0 && (frame < T - 1 || last_copied)) {
        if (row == 0) {
          BAND_CLOCK(1);
          mbar_wait_tested(&full[slot], phase);
          BAND_CLOCK(WIDE ? 1 : 6);
        }
        const float* r = ring + slot * chunk_floats + row * slot_floats +
                         (((uintptr_t)row_g >> 2) & 3);
        sv = r[0];
#pragma unroll
        for (int i = 0; i < PPT; ++i) e[i] = r[st[i]];
      } else {
        sv = row_g[0];
#pragma unroll
        for (int i = 0; i < PPT; ++i) e[i] = row_g[st[i]];
      }
    } else {
      sv = 0.0f;
#pragma unroll
      for (int i = 0; i < PPT; ++i) e[i] = kNeg;
    }
    ++frame;
    row_g += row_step;
    if (++row == G) {
      row = 0;
      slot = slot + 1 == nslots ? 0 : slot + 1;
      phase ^= slot == 0 ? 1u : 0u;
    }
  };
  // the moved window's arrays at a position g of the whole window: this
  // block's, or (the wide route) block g / hb's over the cluster
  auto psh_at = [&](int g) -> float {
    if constexpr (WIDE) {
      if ((unsigned)(g - base) >= (unsigned)hb) {
        const int k = g / hb;
        return ld_cluster_f32(map_rank(psh + (g - k * hb), k));
      }
    }
    return psh[g - base];
  };
  auto ysh_at = [&](int g) -> float {
    if constexpr (WIDE) {
      if ((unsigned)(g - base) >= (unsigned)hb) {
        const int k = g / hb;
        return ld_cluster_f32(map_rank(ysh + (g - k * hb), k));
      }
    }
    return ysh[g - base];
  };
  auto ish_at = [&](int g) -> int {
    if constexpr (WIDE) {
      if ((unsigned)(g - base) >= (unsigned)hb) {
        const int k = g / hb;
        return ld_cluster_s16(map_rank(ish + (g - k * hb), k));
      }
    }
    return (int)ish[g - base];
  };
  int s_next = Tp > 1 ? sw.at(1) : s_prev;
  ok_next = ok;
  if (Tp > 1) {
    if (s_next != s_prev)
      window<PPT>(s_next, j0, W, P, NS, seq_b, mask_b, st, ok_next);
    gather(em, stay);
#pragma unroll
    for (int i = 0; i < PPT; ++i) em[i] = ((ok_next >> i) & 1u) ? em[i] : kNeg;
  }
  int16_t* tb_row = tb + ((size_t)B + b) * W;
  const size_t tb_step = (size_t)B * W;
  // the wide route: the consumers arrive at each step's cluster barrier as
  // the step before ends (their reads of the edges before it done), the
  // producer warp once it has sent this block's edges
  if constexpr (WIDE) cluster_arrive();
#ifdef REMAP_BANDED_CLOCKS
  asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(stamp) : : "memory");
  const long long loop_start = stamp;
#endif
  for (int t = 1; t < Tp; ++t) {
    const int s = s_next;
    const int d = s - s_prev;
    const int par = t & 1;
    ok = ok_next;                    // step t's valid positions
    // the next step's window start, and its states' loads where it moves
    s_next = sw.at(t + 1);
    const bool more = t + 1 < Tp;
    if (more && s_next != s)
      window<PPT>(s_next, j0, W, P, NS, seq_b, mask_b, st, ok_next);
    BAND_CLOCK(0);

    // prefix max of y = p + slip*j: this thread's positions in order...
    float wv[PPT];
    float bv = __fadd_rn(p[0], sj[0]);
    int bi = j0;
    wv[0] = bv;
#pragma unroll
    for (int i = 1; i < PPT; ++i) {
      wv[i] = __fadd_rn(p[i], sj[i]);
      later(bv, bi, wv[i], j0 + i);
    }
    // ...then across the warp (the earlier lane's total wins ties)
    warp_scan_later(bv, bi, lane);
    // the warp's prefix max before this thread's positions...
    float ev = __shfl_up_sync(kFull, bv, 1);
    int ei = __shfl_up_sync(kFull, bi, 1);
    ev = lane == 0 ? -INFINITY : ev;
    ei = lane == 0 ? 0 : ei;
    // ...and through each of its positions (y in wv becomes the prefix
    // max); the last score and the prefix max at the last position but
    // one go to lane + 1
    int wi[PPT];
    {
      float rv = ev;
      int ri = ei;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        later(rv, ri, wv[i], j0 + i);
        wv[i] = rv;
        wi[i] = ri;
      }
    }
    if (lane == 31) {
      edge[par][warp] = make_float4(bv, __int_as_float(bi), p[PPT - 1],
                                    wv[PPT - 2]);
      edge_i[par][warp] = wi[PPT - 2];
    }
    const float pl_up = __shfl_up_sync(kFull, p[PPT - 1], 1);
    const float v2_up = __shfl_up_sync(kFull, wv[PPT - 2], 1);
    const int i2_up = __shfl_up_sync(kFull, wi[PPT - 2], 1);
    BAND_CLOCK(2);
    __syncthreads();
    // without a producer warp, warp 0 refills a chunk's slot once every
    // thread has gathered its frames (the producer's loop does the same)
    if (nslots > 0 && !producer && warp == 0 && t % G == 0) {
      const int f0 = t + 1 + (nslots - 1) * G;
      const int k = (t / G - 1) % nslots;
      if (f0 < T)
        refill(lt, f0, G, T, B, b, NS, lt_end, ring + k * chunk_floats,
               slot_floats, &full[k], lane);
    }
    BAND_CLOCK(3);
    // the next frame's emissions: their reads stay in flight through the
    // fold and the update
    float em_next[PPT], stay_next = 0.0f;
    if (more) gather(em_next, stay_next);
    BAND_CLOCK(1);

    // the prefix max of the warps before the one before this one (xv1),
    // then of the warps before this one (xv), folded in order
    float xv1 = -INFINITY;
    int xi1 = 0;
    float xv;
    int xi;
    float4 eb = make_float4(0.0f, 0.0f, kNeg, -INFINITY);
    int eb_i = 0;
    // the wide route's blocks after the first: the prefix max before the
    // block's first position and before the one before it (value,
    // position: tv, tv1), and the block before's last score (xe.x)
    float4 xe = make_float4(kNeg, 0.0f, 0.0f, 0.0f);
    float tv = -INFINITY, tv1 = -INFINITY;
    int ti = 0, ti1 = 0;
    if constexpr (WIDE) {
      // every warp's total at once, scanned across the warp in warp order
      float sv = -INFINITY;
      int si = 0;
      if (lane < nwarps) {
        const float2 e = *reinterpret_cast<const float2*>(&edge[par][lane]);
        sv = e.x;
        si = __float_as_int(e.y);
      }
      warp_scan_later(sv, si, lane);
      const float a1 = __shfl_sync(kFull, sv, max(warp - 2, 0));
      const int a1i = __shfl_sync(kFull, si, max(warp - 2, 0));
      const float a = __shfl_sync(kFull, sv, max(warp - 1, 0));
      const int ai = __shfl_sync(kFull, si, max(warp - 1, 0));
      xv1 = warp > 1 ? a1 : xv1;
      xi1 = warp > 1 ? a1i : xi1;
      xv = warp > 0 ? a : -INFINITY;
      xi = warp > 0 ? ai : 0;
      if (warp > 0) {
        eb = edge[par][warp - 1];
        eb_i = edge_i[par][warp - 1];
      }
      if (rank > 0) {
        BAND_CLOCK(4);
        cluster_wait();
        BAND_CLOCK(6);
        // the blocks before this one come first, in block order
        for (int k = 0; k < rank; ++k) {
          if (k + 1 == rank) {
            tv1 = tv;
            ti1 = ti;
          }
          const float2 e = xtot[par * kMaxCluster + k];
          later(tv, ti, e.x, __float_as_int(e.y));
        }
        xe = xedge[par];
        float v = tv;
        int vi = ti;
        later(v, vi, xv1, xi1);
        xv1 = v;
        xi1 = vi;
        v = tv;
        vi = ti;
        later(v, vi, xv, xi);
        xv = v;
        xi = vi;
      }
    } else {
      if constexpr (kWarps <= 16) {
        // every total first (all in flight at once), then the fold
        float2 e[kWarps - 2];
#pragma unroll
        for (int k = 0; k < kWarps - 2; ++k)
          e[k] = *reinterpret_cast<const float2*>(&edge[par][k]);
#pragma unroll
        for (int k = 0; k < kWarps - 2; ++k) {
          if (k + 1 < warp) later(xv1, xi1, e[k].x, __float_as_int(e[k].y));
        }
      } else {
        for (int k = 0; k + 1 < warp; ++k) {
          const float4 e = edge[par][k];
          later(xv1, xi1, e.x, __float_as_int(e.y));
        }
      }
      xv = xv1;
      xi = xi1;
      if (warp > 0) {
        eb = edge[par][warp - 1];       // the warp before's edge
        eb_i = edge_i[par][warp - 1];
        later(xv, xi, eb.x, __float_as_int(eb.y));
      }
    }
    BAND_CLOCK(4);


    // stay, then step, then slip, each under strict >; positions in
    // falling order, so that p[i - 1] is still the old score when read
    if (d == 0) {
      // sources at j, j - 1 and j - 2: lane - 1's last score and its
      // prefix maxima at its last two positions (lane 0: the warp before's;
      // the wide route's block 1, warp 0: block 0's)
      float pl = pl_up, fv1 = xv, fv2 = xv;
      int fi1 = xi, fi2 = xi;
      if (lane > 0) {
        later(fv1, fi1, ev, ei);
        later(fv2, fi2, v2_up, i2_up);
      } else if (warp > 0) {
        pl = eb.z;
        fv2 = xv1;
        fi2 = xi1;
        later(fv2, fi2, eb.w, eb_i);
      } else if (WIDE && rank > 0) {
        // the block before's last score and its prefix max at its last
        // position but one, after the blocks before it
        pl = xe.x;
        fv2 = tv1;
        fi2 = ti1;
        later(fv2, fi2, xe.y, __float_as_int(xe.z));
      }
#pragma unroll
      for (int i = PPT - 1; i >= 0; --i) {
        const int j = j0 + i;
        const float q = p[i];
        const float qm1 = i > 0 ? p[i > 0 ? i - 1 : 0] : (j > 0 ? pl : kNeg);
        float z = i >= 2 ? xv : (i == 1 ? fv1 : fv2);
        int zi = i >= 2 ? xi : (i == 1 ? fi1 : fi2);
        if (i >= 2) later(z, zi, wv[i >= 2 ? i - 2 : 0], wi[i >= 2 ? i - 2 : 0]);
        if (i < 2) z = j < 2 ? kNeg : z;   // a wrapped source: never wins
        float c = __fadd_rn(q, stay);
        const float step = __fadd_rn(qm1, em[i]);
        int delta = step > c ? 1 : 0;
        c = step > c ? step : c;
        const float sl = __fadd_rn(__fsub_rn(z, sjm[i]), em[i]);
        delta = sl > c ? j - zi : delta;
        c = sl > c ? sl : c;
        p[i] = ((ok >> i) & 1u) ? c : kNeg;
        dl[i] = delta;
      }
    } else {
      // the window moved: publish the old scores and every position's
      // prefix max, then read them shifted by d
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        if (j0 + i < W) {
          float v = xv;
          int vi = xi;
          later(v, vi, wv[i], wi[i]);
          psh[j0 + i - base] = p[i];
          ysh[j0 + i - base] = v;
          ish[j0 + i - base] = (int16_t)vi;
        }
      }
      if constexpr (WIDE) {
        // both blocks' arrays published, over a second cluster barrier
        BAND_CLOCK(5);
        if (rank == 0) cluster_wait();
        cluster_sync();
        BAND_CLOCK(6);
      } else {
        __syncthreads();
      }
      const float df = (float)d;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const int j = j0 + i;
        const int src = j + d;
        const float q = (src >= 0 && src < W) ? psh_at(src) : kNeg;
        const float qm1 =
            (j > 0 && src >= 1 && src - 1 < W) ? psh_at(src - 1) : kNeg;
        const float z = (src >= 2 && src < W) ? ysh_at(src - 2) : kNeg;
        float c = __fadd_rn(q, stay);
        int delta = 0;
        const float step = __fadd_rn(qm1, em[i]);
        if (step > c) {
          c = step;
          delta = 1;
        }
        const float fs = __fsub_rn(
            z, __fmul_rn(slip, __fadd_rn(__fsub_rn((float)j, 1.0f), df)));
        const float sl = __fadd_rn(fs, em[i]);
        if (sl > c) {
          int zw = src - 2;              // the twin's roll: mod W
          if (zw < 0) zw += W;
          else if (zw >= W) zw %= W;
          delta = src - ish_at(zw);
          c = sl;
        }
        p[i] = ((ok >> i) & 1u) ? c : kNeg;
        dl[i] = delta;
      }
      // the next move's writers wait for these reads (the wide route: the
      // steps' cluster barriers between two moves order them)
      if constexpr (!WIDE) __syncthreads();
    }
    BAND_CLOCK(5);
    if constexpr (WIDE) {
      // block 0 waits for the step's cluster barrier last (on a moved step
      // it waited before the second); then every consumer arrives at the
      // next step's, before this step's traceback stores
      if (rank == 0 && d == 0) {
        BAND_CLOCK(0);
        cluster_wait();
        BAND_CLOCK(6);
      }
      cluster_arrive();
    }
    store_row<PPT>(tb_row, j0, W, dl, vec);
    tb_row += tb_step;
    // the next step's emissions, masked by its window's validity bits
#pragma unroll
    for (int i = 0; i < PPT; ++i)
      em[i] = ((ok_next >> i) & 1u) ? em_next[i] : kNeg;
    stay = stay_next;
    s_prev = s;
  }
#ifdef REMAP_BANDED_CLOCKS
  clk[7] = stamp - loop_start;
  if (clocked) {
#pragma unroll
    for (int k = 0; k < 8; ++k) clocks_out[k] = clk[k];
  }
#endif
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    if (j0 + i < W) vfinal[(size_t)b * W + j0 + i] = p[i];
  }
  if constexpr (WIDE) cluster_wait();  // no block leaves while read
}

template <int PPT, int MAXT>
int launch(const void* lt, const void* seq, const void* pos_mask,
           const void* prior0, const void* starts, void* tb, void* vfinal,
           int T, int B, int NS, int P, int W, int Tp, float slip,
           int warps, int producer, int G, int nslots, int slot_floats,
           int vec, int smem, unsigned long long lt_end,
           cudaStream_t stream) {
  auto kernel = remap_banded_kernel<PPT, MAXT, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<B, 32 * (warps + producer), smem, stream>>>(
      (const float*)lt, (const int32_t*)seq, (const uint8_t*)pos_mask,
      (const float*)prior0, (const int32_t*)starts, (int16_t*)tb,
      (float*)vfinal, T, B, NS, P, W, Tp, warps, producer, G, nslots,
      slot_floats, vec, lt_end, slip, 0, 1);
  return (int)cudaGetLastError();
}

// the wide route's launch configuration: a cluster of nblk blocks a row
cudaLaunchConfig_t wide_config(int B, int nblk, int threads, int smem,
                               cudaLaunchAttribute* cluster,
                               cudaStream_t stream) {
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = nblk;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(nblk * B, 1, 1);
  config.blockDim = dim3(threads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = cluster;
  config.numAttrs = 1;
  return config;
}

// the wide route's kernel at a (positions a thread, block size) instance
// (ops/remap_kernel.py::WIDE_BUILDS), or null
using WideKernel = void (*)(const float*, const int32_t*, const uint8_t*,
                            const float*, const int32_t*, int16_t*, float*,
                            int, int, int, int, int, int, int, int, int, int,
                            int, int, unsigned long long, float, int, int);
WideKernel wide_kernel(int ppt, int maxt) {
  if (ppt == 8 && maxt == 512) return remap_banded_kernel<8, 512, true>;
  if (ppt == 12 && maxt == 512) return remap_banded_kernel<12, 512, true>;
  return nullptr;
}

}  // namespace

// The wide route: windows of 16,385 .. 32,767 positions, a cluster of nblk
// blocks a row (see the header).  The same arguments as remap_banded but
// for the plan's (ops/remap_kernel.py::remap_banded_plan, route "wide"):
// hb, a block's positions (a multiple of 32 ppt; the blocks before the
// last hold hb each, the last the rest), nblk blocks (2-8), consumer
// warps hb / (32 ppt) a block, the producer warp, the instance (ppt,
// maxt), frames a ring slot G, ring slots, the traceback's store width vec
// and smem bytes a block.  Returns the cudaError_t of the launch
// (cudaErrorClusterOutOfResources where the card cannot place such a
// cluster); cudaErrorInvalidValue (1) for a plan that does not cover the
// window.
extern "C" int remap_banded_wide(const void* lt, const void* seq,
                                 const void* pos_mask, const void* prior0,
                                 const void* starts, void* tb, void* vfinal,
                                 int T, int B, int NS, int P, int W, int Tp,
                                 float slip, int hb, int nblk, int warps,
                                 int producer, int ppt, int maxt, int G,
                                 int nslots, int vec, int smem,
                                 unsigned long long lt_end, void* stream) {
  const int slot_bytes = (4 * NS + 12 + 15) & ~15;
  const int threads = 32 * (warps + producer);
  const WideKernel kernel = wide_kernel(ppt, maxt);
  if (kernel == nullptr || W < 2 || W > 32767 || nblk < 2 ||
      nblk > kMaxCluster || hb < 1 || hb % (32 * ppt) ||
      (nblk - 1) * hb >= W || nblk * hb < W || warps != hb / (32 * ppt) ||
      warps > 32 || threads > maxt || G < 1 || G > 32 || nslots == 1 ||
      nslots < 0 || nslots > kMaxSlots || producer != 1 || T < 1 ||
      Tp < T ||
      (vec == 16 && (W % 8 || ppt % 8)) || (vec == 8 && (W % 4 || ppt % 4)) ||
      (vec == 4 && (W % 2 || ppt % 2)) ||
      (vec != 16 && vec != 8 && vec != 4 && vec != 2) || (uintptr_t)lt % 4 ||
      (size_t)smem < kWideBarBytes + (size_t)nslots * G * slot_bytes +
                         10 * (size_t)hb)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute cluster[1];
  const cudaLaunchConfig_t config =
      wide_config(B, nblk, threads, smem, cluster, (cudaStream_t)stream);
  e = cudaLaunchKernelEx(&config, kernel, (const float*)lt,
                         (const int32_t*)seq, (const uint8_t*)pos_mask,
                         (const float*)prior0, (const int32_t*)starts,
                         (int16_t*)tb, (float*)vfinal, T, B, NS, P, W, Tp,
                         warps, producer, G, nslots, slot_bytes / 4, vec,
                         lt_end, slip, hb, nblk);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The clusters of the wide route's nblk blocks (the instance (ppt, maxt),
// threads and smem bytes a block) that the device runs at once, into
// *clusters.  Returns the cudaError_t.
extern "C" int remap_banded_wide_clusters(int nblk, int ppt, int maxt,
                                          int threads, int smem,
                                          int* clusters) {
  const WideKernel kernel = wide_kernel(ppt, maxt);
  if (kernel == nullptr || nblk < 2 || nblk > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute cluster[1];
  const cudaLaunchConfig_t config =
      wide_config(1, nblk, threads, smem, cluster, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &config);
}

// lt (T, B, NS) f32; seq (B, P) int32; pos_mask (B, P) uint8; prior0 (B, P)
// f32; starts (Tp, B) int32; tb (Tp, B, W) int16; vfinal (B, W) f32.  The
// launch plan comes from the caller (ops/remap_kernel.py::
// remap_banded_plan): consumer warps, whether a producer warp fills the
// ring (else warp 0 does), the instance's block size maxt and positions a
// thread ppt (one of the pairs REMAP_BANDED_CASE lists below), frames a
// ring slot G, ring slots (0: the emissions are gathered from device
// memory), smem bytes, and the traceback's store width vec (16: W % 8 ==
// 0 and ppt % 8 == 0; 8: W % 4 == 0 and ppt % 4 == 0; 4: W even; 2).
// lt_end: the address one past the last byte of lt's storage.  Returns
// the cudaError_t of the launch; cudaErrorInvalidValue (1) for a plan that
// does not cover the window or has no instance.
extern "C" int remap_banded(const void* lt, const void* seq,
                            const void* pos_mask, const void* prior0,
                            const void* starts, void* tb, void* vfinal, int T,
                            int B, int NS, int P, int W, int Tp, float slip,
                            int warps, int producer, int maxt, int ppt,
                            int G, int nslots, int vec, int smem,
                            unsigned long long lt_end, void* stream) {
  const int threads = 32 * warps;
  const int block = 32 * (warps + producer);
  const int slot_bytes = (4 * NS + 12 + 15) & ~15;
  if (W < 1 || W > 16384 || warps < 1 || warps > 32 ||
      threads * ppt < W || G < 1 || G > 32 || nslots == 1 || nslots < 0 ||
      nslots > kMaxSlots || (nslots == 0 && producer) || T < 1 ||
      Tp < T || (vec == 16 && (W % 8 || ppt % 8)) ||
      (vec == 8 && (W % 4 || ppt % 4)) || (vec == 4 && (W % 2 || ppt % 2)) ||
      (vec != 16 && vec != 8 && vec != 4 && vec != 2) || (uintptr_t)lt % 4 ||
      (producer != 0 && producer != 1) || block > maxt ||
      (size_t)smem < kBarBytes + (size_t)nslots * G * slot_bytes +
                         10 * (size_t)((W + 7) & ~7))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int slot_floats = slot_bytes / 4;
#define REMAP_BANDED_LAUNCH(PPT, MAXT)                                     \
  launch<PPT, MAXT>(lt, seq, pos_mask, prior0, starts, tb, vfinal, T, B, \
                    NS, P, W, Tp, slip, warps, producer, G, nslots,        \
                    slot_floats, vec, smem, lt_end, s)
  // the pairs the plan can choose (ops/remap_kernel.py::BANDED_BUILDS)
#define REMAP_BANDED_CASE(PPT, MAXT) \
  if (ppt == PPT && maxt == MAXT) return REMAP_BANDED_LAUNCH(PPT, MAXT)
  REMAP_BANDED_CASE(2, 256);
  REMAP_BANDED_CASE(3, 256);
  REMAP_BANDED_CASE(4, 256);
  REMAP_BANDED_CASE(6, 256);
  REMAP_BANDED_CASE(8, 256);
  REMAP_BANDED_CASE(6, 512);
  REMAP_BANDED_CASE(8, 512);
  REMAP_BANDED_CASE(12, 512);
  REMAP_BANDED_CASE(16, 512);
  REMAP_BANDED_CASE(16, 1024);
  return (int)cudaErrorInvalidValue;
#undef REMAP_BANDED_CASE
#undef REMAP_BANDED_LAUNCH
}

#ifdef REMAP_BANDED_CLOCKS
// copy the step-phase clocks of the last launch, [block][warp][8], to host
// memory
extern "C" int remap_banded_clocks_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, remap_banded_clocks,
                                   sizeof(remap_banded_clocks));
}
#endif
