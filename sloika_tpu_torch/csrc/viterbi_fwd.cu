// Transducer Viterbi forward pass for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels sloika_tpu/ops/pallas/viterbi.py::
// _fwd_kernel_sm (state-major, driven by viterbi_forward_sm) and its
// lane-major twin _fwd_kernel (viterbi_forward): one GPU layout serves both.
//
// Input: the forward's time-major posterior post (T, B, K+1), column 0 =
// stay, in the probability domain, f32 or bf16 (the JAX package's
// Basecaller streams it in bf16 when its compute dtype is bf16: each kernel
// is a template over the element type E, and upcasts each element to f32
// before the log, as the Pallas kernel's _row does, so a bf16 posterior
// gives the bits of the f32 kernel fed its upcast).  Output: traceback
// codes tb (T, B, K) int8 and the final scores vfinal (B, K) f32.  nbase = 4, so a destination
// state i has 4 step predecessors g*K/4 + i/4 and 16 skip predecessors
// h*K/16 + i/16.  Per step, with lp = logf(p + 1e-10) taken here in f32:
//
//   step:  max over g = 0..3, the first wins (strict >)
//   skip:  max over h = 0..15, the first wins, minus skip_pen (equal to the
//          Pallas kernel's two-level (g, q) lexicographic reduction)
//   move:  the step only if mx_step > skip (a skip wins a tie)
//   new    = lp[1 + i] + max(mx_step, skip)
//   stay   = score[i] + lp[0]
//   code   = new > stay ? (step: g, skip: 4 + h) : -1   (a stay wins a tie)
//   score' = max(new, stay)
//
// At t = 0 the scores are the row-0 kmer log-posteriors and the codes -1.
// A posterior of another nbase or klen (nbase 3 or 5, klen 7 over 4
// bases) takes the general route below (viterbi_fwd_general): the same
// function for any nbase, with nbase step and nbase^2 skip predecessors
// (codes g and nbase + h).
// logf is the accurate one (no fast-math), the same PyTorch's torch.log
// calls on the GPU, so the plain twin agrees bit for bit.
//
// What bounds it.  The DP is sequential in t and independent across rows.
// Per step a row reads K+1 elements of posterior and writes K bytes of
// traceback: 5 bytes a state, streamed once (3 from a bf16 posterior: the
// single and pair routes' times moved by +0.5% to +1.2% at the decode
// paths' shapes and by 0.90x at B = 1,024; PERF.md §6).
// At the basecall paths'
// batches (B = 8 to 64, one row a block) a block's step bounds the kernel:
// the design before this one loaded each posterior row into registers one
// step ahead, and half of its 1,237-cycle step waited for that row
// (PERF.md §6, step 0).  With the row in shared memory the step is
// ~260 instructions a thread (5 accurate logf ~110, the 20 candidate reads
// and their compare chains ~75, the update ~25), two warps a scheduler,
// and one barrier: issue and the chains' latency bound it.  At bench.py's
// B = 1,024 (8 blocks an SM) the SM's instruction issue bounds it.
//
// What the design does about it.  Thread r owns step groups, 4
// destinations each, which share one step and one skip decision; the K
// scores are double-buffered in shared memory, so one barrier a step
// separates the reads of step t from the writes of step t+1.  The
// posterior rows come into rings of shared-memory slots by bulk
// asynchronous copies (cp.async.bulk) on each slot's mbarrier, ahead of the
// step.  A row is s (K+1) bytes at a stride of B s (K+1) (s = 4 for f32,
// 2 for bf16), 16-byte aligned for one row in 16 / s at most, so a copy
// takes the row's aligned superset (s (K+1) + 16 - s bytes at most: a
// ring slot, row_bytes) and the reader starts at the row's offset into it,
// in elements; a superset that would run
// past the tensor's storage (its last row) is not copied, and that row is
// read from device memory.  A wait on a slot's barrier tests it first
// (mbarrier.test_wait): a blocking try_wait on a completed phase cost
// ~200 cycles (PERF.md §6).  The plan
// (ops/viterbi_kernel.py::viterbi_fwd_plan) picks one of two routes:
// - "pair", where the card runs a cluster of two blocks for every row at
//   once (B = 8 and 64): the second block of the cluster (the log block)
//   streams the row's posterior through its own ring, takes logf(p +
//   1e-10) of G frames at a time into a staging slot, and copies them by
//   one bulk copy into the DP block's log ring ([G][K+4]: kmers, then the
//   stay), completing on the DP block's barrier; the DP block frees a slot
//   with a remote arrival on the log block's barrier.  The DP block's step
//   reads its 4 logs as one float4 and the stay's as a broadcast: the 5
//   logf leave its path, and run on an SM the batch left idle.
// - "single", one block a row: thread 0 refills the slot of frame t with
//   frame t + nslots right after step t's barrier, one copy a step, and
//   the step takes its own logs.  Where blocks share an SM (B above the
//   SMs) a thread takes 8 destinations, two step groups of one skip group,
//   whose skip maximum it computes once: fewer instructions a step.
// Thread r's 4 in-order reads of its columns fall 4 threads to a bank; a
// rotated order that avoids it measured no faster (PERF.md §6), so the
// reads stay in order.
#include <type_traits>

#include "cluster.cuh"
#include "viterbi_ring.cuh"

#ifdef VITERBI_FWD_CLOCKS
// Step-phase clocks (scripts/bench_viterbi.py --clocks builds this source
// with -DVITERBI_FWD_CLOCKS into a library of its own): lane 0 of each DP
// warp of row 0's block sums, over the steps, the SM clock cycles of the
// wait for the frame's slot and its reads (0), the logs (1: none on the
// pair route), the step and skip maxima (2), the update and the stores (3)
// and the barrier with the refill or the slot's release (4); slot 7 holds
// the loop's cycles.  The general route's kernel stamps, in block 0 of row
// 0's cluster, the slot's wait (0), the frame's logs (1), the cluster
// barrier's wait (2), the gather with the block barrier and the refill (3),
// the maxima (4) and the update with the stores and the arrival (5); slot 6
// holds thread 0's cycles of 16 cluster barriers and thread 32's of a chase
// of 64 dependent loads through the next block's shared memory.
__device__ long long viterbi_fwd_clocks[32 * 8];
#define FWD_CLOCK(k) PHASE_CLOCK(k)
#else
#define FWD_CLOCK(k) \
  do {               \
  } while (0)
#endif

namespace {

// the aligned superset of n elements of esize bytes from any esize-aligned
// start, rounded up to 16 bytes (a ring slot of a row at n = K + 1)
__host__ __device__ constexpr int superset_bytes(int n, int esize) {
  return (esize * n + 16 - esize + 15) & ~15;
}

constexpr int kMaxSlots = 16;
constexpr int kBarBytes = 128;     // the slots' full mbarriers
constexpr int kPairBarBytes = 384; // full, freed, logged: 16 each
constexpr int kPairPostSlots = 2;  // the log block's posterior slots

// The DP with DPT destinations a thread: thread r owns the step groups
// (DPT/4) r .. (DPT/4) r + DPT/4 - 1, i.e. destinations DPT r ..
// DPT r + DPT - 1, which share one skip group (DPT <= 16).
// With 4 destinations a thread a block has its SM alone (the plan), and
// may take up to 64 registers a thread; with 8, blocks share an SM.
template <int DPT, typename E>
__global__ void __launch_bounds__(DPT == 4 ? 1024 : 512, DPT == 4 ? 1 : 2)
viterbi_fwd_kernel(const E* __restrict__ post, int8_t* __restrict__ tb,
                   float* __restrict__ vfinal, int T, int B, int K,
                   float skip_pen, int nslots, int row_bytes,
                   unsigned long long post_end) {
  constexpr int kGroups = DPT / 4;      // step groups a thread
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // [nslots]
  unsigned char* ring = smem + kBarBytes;               // [nslots][row_bytes]
  float* cur = reinterpret_cast<float*>(ring + (size_t)nslots * row_bytes);
  float* nxt = cur + K;                 // [K] scores at t; cur: at t-1
  const int b = blockIdx.x;
  const int r = threadIdx.x;
  const int nrem_step = K >> 2;
  const int nrem_skip = K >> 4;
  const int s = (kGroups * r) >> 2;    // skip group
  const int nst = K + 1;
  const size_t row_step = (size_t)B * nst;

  if (r == 0) {
    for (int k = 0; k < nslots; ++k) mbar_init(&full[k], 1);
    mbar_init_fence();
    // frame 1 + k into slot k
    const E* row = post + ((size_t)B + b) * nst;
    for (int k = 0; k < nslots && 1 + k < T; ++k, row += row_step)
      fill(row, nst, post_end, ring + (size_t)k * row_bytes, &full[k]);
  }
  {
    // t = 0: the scores are the row's kmer log-posteriors
    const E* row = post + (size_t)b * nst + 1 + DPT * r;
#pragma unroll
    for (int i = 0; i < DPT; i += 4)
      reinterpret_cast<float4*>(cur + DPT * r)[i / 4] = make_float4(
          logf(upcast(row[i]) + kEta), logf(upcast(row[i + 1]) + kEta),
          logf(upcast(row[i + 2]) + kEta), logf(upcast(row[i + 3]) + kEta));
#pragma unroll
    for (int i = 0; i < DPT; i += 4)
      reinterpret_cast<char4*>(tb + (size_t)b * K + DPT * r)[i / 4] =
          make_char4(-1, -1, -1, -1);
  }
  // only the last row of the storage can be left out of the ring
  const bool last_copied =
      in_storage(post + ((size_t)(T - 1) * B + b) * nst, nst, post_end);
  __syncthreads();

  int slot = 0;
  unsigned phase = 0;
  const E* row_g = post + ((size_t)B + b) * nst;   // frame t's row
  const E* fill_row = row_g + nslots * row_step;   // frame t + nslots's
  int8_t* tb_row = tb + ((size_t)B + b) * K;
  const size_t tb_step = (size_t)B * K;
#ifdef VITERBI_FWD_CLOCKS
  PHASE_CLOCK_START();
#endif
  for (int t = 1; t < T; ++t) {
    // the frame's stay and DPT kmers: from its slot, or from device memory
    // (two loops, so that the slot's reads are shared-memory loads)
    float p0, pk[DPT];
    if (t < T - 1 || last_copied) {
      mbar_wait_tested(&full[slot], phase);
      const E* p = reinterpret_cast<const E*>(ring + (size_t)slot * row_bytes) +
                   superset_offset(row_g);
      p0 = upcast(p[0]);
#pragma unroll
      for (int i = 0; i < DPT; ++i) pk[i] = upcast(p[1 + DPT * r + i]);
    } else {
      p0 = upcast(row_g[0]);
#pragma unroll
      for (int i = 0; i < DPT; ++i) pk[i] = upcast(row_g[1 + DPT * r + i]);
    }
#ifdef VITERBI_FWD_CLOCKS
    asm volatile("" ::"f"(p0), "f"(pk[0]), "f"(pk[DPT - 1]));
#endif
    FWD_CLOCK(0);
    const float lps = logf(p0 + kEta);
    float l[DPT];
#pragma unroll
    for (int i = 0; i < DPT; ++i) l[i] = logf(pk[i] + kEta);
#ifdef VITERBI_FWD_CLOCKS
    asm volatile("" ::"f"(lps), "f"(l[0]), "f"(l[DPT - 1]));
#endif
    FWD_CLOCK(1);

    // each step group's 4 predecessors g, the first maximum (strict >)
    float mx[kGroups];
    int am[kGroups];
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      mx[j] = cur[kGroups * r + j];
      am[j] = 0;
    }
#pragma unroll
    for (int g = 1; g < 4; ++g) {
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        const float c = cur[g * nrem_step + kGroups * r + j];
        if (c > mx[j]) { mx[j] = c; am[j] = g; }
      }
    }
    // the skip group's 16 predecessors h, the first maximum
    float mk = cur[s];
    int ak = 0;
#pragma unroll
    for (int h = 1; h < 16; ++h) {
      const float c = cur[h * nrem_skip + s];
      if (c > mk) { mk = c; ak = h; }
    }
    const float sk = mk - skip_pen;
    float m[kGroups];
    int code[kGroups];
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      if (mx[j] > sk) { m[j] = mx[j]; code[j] = am[j]; }
      else { m[j] = sk; code[j] = 4 + ak; }
    }
#ifdef VITERBI_FWD_CLOCKS
    asm volatile("" ::"f"(m[0]), "r"(code[0]));
#endif
    FWD_CLOCK(2);

#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const float4 old = reinterpret_cast<const float4*>(cur)[kGroups * r + j];
      float4 sc;
      char4 cd;
      float nw, st;
      nw = l[4 * j] + m[j]; st = old.x + lps;
      cd.x = (signed char)(nw > st ? code[j] : -1); sc.x = nw > st ? nw : st;
      nw = l[4 * j + 1] + m[j]; st = old.y + lps;
      cd.y = (signed char)(nw > st ? code[j] : -1); sc.y = nw > st ? nw : st;
      nw = l[4 * j + 2] + m[j]; st = old.z + lps;
      cd.z = (signed char)(nw > st ? code[j] : -1); sc.z = nw > st ? nw : st;
      nw = l[4 * j + 3] + m[j]; st = old.w + lps;
      cd.w = (signed char)(nw > st ? code[j] : -1); sc.w = nw > st ? nw : st;
      reinterpret_cast<float4*>(nxt)[kGroups * r + j] = sc;
      reinterpret_cast<char4*>(tb_row)[kGroups * r + j] = cd;
    }
    FWD_CLOCK(3);

    __syncthreads();
    // every thread has read frame t: its slot takes frame t + nslots
    if (r == 0 && t + nslots < T)
      fill(fill_row, nst, post_end, ring + (size_t)slot * row_bytes,
           &full[slot]);
    if (++slot == nslots) {
      slot = 0;
      phase ^= 1u;
    }
    row_g += row_step;
    fill_row += row_step;
    tb_row += tb_step;
    float* tmp = cur; cur = nxt; nxt = tmp;
    FWD_CLOCK(4);
  }
#ifdef VITERBI_FWD_CLOCKS
  clk[7] = PHASE_CLOCK_TOTAL();
  if (b == 0 && (r & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) viterbi_fwd_clocks[(r >> 5) * 8 + k] = clk[k];
  }
#endif
#pragma unroll
  for (int j = 0; j < kGroups; ++j)
    reinterpret_cast<float4*>(vfinal + (size_t)b * K)[kGroups * r + j] =
        reinterpret_cast<const float4*>(cur)[kGroups * r + j];
}

// the pair route's threads a block: K (the log block takes four frames'
// logs at once, K / 4 threads a frame), at least a warp, at most 1,024
__host__ __device__ constexpr int pair_threads(int K) {
  return K < 32 ? 32 : (K > 1024 ? 1024 : K);
}

// the DP threads' barrier (named barrier 1): the pair's DP block leaves its
// other threads out
__device__ __forceinline__ void dp_barrier(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// The DP of one row with its logs taken by a second block: a cluster of two
// blocks a row.  Block 1 (the log block) streams the row's posterior rows
// through its own ring of bulk copies (P slots of G frames), takes
// logf(p + 1e-10) of each frame, K / 4 threads a frame (up to four frames
// at once) and 4 kmers a thread, into a staging slot ([G][K+4]: the kmers,
// then the stay), and
// copies each chunk of G frames by one bulk copy into block 0's log ring,
// where it completes on the slot's barrier.  Block 0 runs the step of
// viterbi_fwd_kernel<4> on its first max(32, K / 4) threads and frees a
// log slot by a remote arrival on the log block's barrier.  Slot c % n of
// each ring holds chunk c, frames 1 + cG .. (c + 1)G.  A posterior slot is
// G row_bytes (the rows' supersets, f32 or bf16), a log slot G log rows of
// K + 4 floats (the same bytes where E is float).
template <typename E>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(1024, 1)
viterbi_fwd_pair_kernel(const E* __restrict__ post,
                        int8_t* __restrict__ tb, float* __restrict__ vfinal,
                        int T, int B, int K, float skip_pen, int G,
                        int nslots, int P, int row_bytes,
                        unsigned long long post_end) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // log block: copied
  uint64_t* freed = full + kMaxSlots;                   // log block: read
  uint64_t* logged = freed + kMaxSlots;                 // DP block: logs in
  // the DP block: nslots log slots, then the scores; the log block: P
  // posterior slots, then nslots staging slots
  unsigned char* ring = smem + kPairBarBytes;
  const int log_floats = K + 4;             // a log row: kmers, then stay
  const int chunk_floats = G * log_floats;  // a log slot
  const size_t post_chunk = (size_t)G * row_bytes;   // a posterior slot
  const unsigned rank = cluster_rank();
  const int b = blockIdx.x >> 1;
  const int r = threadIdx.x;
  const int nst = K + 1;
  const int nstep = K >> 2;
  const size_t row_step = (size_t)B * nst;
  const int nchunks = (T - 1 + G - 1) / G;
  if (r == 0) {
    for (int k = 0; k < nslots; ++k) {
      mbar_init(&full[k], 1);
      mbar_init(&freed[k], 1);
      mbar_init(&logged[k], 1);
    }
    mbar_init_fence();
  }
  cluster_sync();

  if (rank == 1) {
    // the log block.  Chunk c's frames come into its posterior slot as
    // their aligned supersets (a frame past the last, or whose superset
    // would run past the storage, is not copied: it is read from device
    // memory); thread 0 arms the slot's barrier with their bytes, and lane
    // 0 of warp w issues the copies of frames w, w + nwarps, ...
    const int nwarps = blockDim.x >> 5;
    auto span = [&](int c, int q, unsigned long long& a0) -> unsigned {
      const unsigned long long a = (unsigned long long)(
          post + ((size_t)(1 + c * G + q) * B + b) * nst);
      const unsigned long long e = (a + sizeof(E) * nst + 15ull) & ~15ull;
      a0 = a & ~15ull;
      return 1 + c * G + q < T && e <= post_end ? (unsigned)(e - a0) : 0u;
    };
    auto refill = [&](int c) {
      uint64_t* bar = &full[c % P];
      unsigned long long a0;
      if (r == 0) {
        unsigned total = 0;
        for (int q = 0; q < G; ++q) total += span(c, q, a0);
        mbar_expect_tx(bar, total);
      }
      if ((r & 31) == 0) {
        for (int q = r >> 5; q < G; q += nwarps) {
          const unsigned bytes = span(c, q, a0);
          if (bytes)
            bulk_copy(ring + (c % P) * post_chunk + (size_t)q * row_bytes,
                      reinterpret_cast<const void*>(a0), bytes, bar);
        }
      }
    };
    for (int c = 0; c < P && c < nchunks; ++c) refill(c);
    // thread r takes kmers 4 kk .. 4 kk + 3 of frames q0, q0 + per, ...
    const int kk = r % nstep, q0 = r / nstep, per = blockDim.x / nstep;
    float* stage = reinterpret_cast<float*>(ring + P * post_chunk);
    const uint32_t dp_ring = map_rank(ring, 0);
    const uint32_t dp_logged = map_rank(logged, 0);
    int pslot = 0, slot = 0;
    unsigned pphase = 0, phase = 0;
    for (int c = 0; c < nchunks; ++c) {
      mbar_wait_tested(&full[pslot], pphase);
      if (c >= nslots) mbar_wait_cluster(&freed[slot], phase ^ 1u);
      const unsigned char* src = ring + pslot * post_chunk;
      float* dst = stage + slot * chunk_floats;
      if (q0 < per) {
        for (int q = q0; q < G && 1 + c * G + q < T; q += per) {
          const E* row = post + ((size_t)(1 + c * G + q) * B + b) * nst;
          const E* p =
              in_storage(row, nst, post_end)
                  ? reinterpret_cast<const E*>(src + (size_t)q * row_bytes) +
                        superset_offset(row)
                  : row;
          float* d = dst + q * log_floats;
          reinterpret_cast<float4*>(d)[kk] =
              make_float4(logf(upcast(p[1 + 4 * kk]) + kEta),
                          logf(upcast(p[2 + 4 * kk]) + kEta),
                          logf(upcast(p[3 + 4 * kk]) + kEta),
                          logf(upcast(p[4 + 4 * kk]) + kEta));
          if (kk == 0) d[K] = logf(upcast(p[0]) + kEta);
        }
      }
      fence_proxy_async();       // these writes come before the copy's reads
      __syncthreads();
      if (r == 0)
        bulk_copy_cluster(dp_ring + 4u * (uint32_t)(slot * chunk_floats), dst,
                          4u * (uint32_t)chunk_floats,
                          dp_logged + 8u * (uint32_t)slot);
      // the posterior slot is read: it takes chunk c + P
      if (c + P < nchunks) refill(c + P);
      if (++pslot == P) {
        pslot = 0;
        pphase ^= 1u;
      }
      if (++slot == nslots) {
        slot = 0;
        phase ^= 1u;
      }
    }
    cluster_sync();
    return;
  }

  // the DP block: threads r < ndp (whole warps) run the step; r < K / 4
  // own a step group
  const float* lring = reinterpret_cast<const float*>(ring);
  float* cur = reinterpret_cast<float*>(ring) +
               (size_t)nslots * chunk_floats;           // scores at t-1
  float* nxt = cur + K;                                 // scores at t
  const int ndp = nstep < 32 ? 32 : nstep;
  if (r >= ndp) {
    cluster_sync();
    return;
  }
  const bool active = r < nstep;
  const int nrem_skip = K >> 4;
  const int s = r >> 2;                // skip group
  if (active) {
    // t = 0: the scores are the row's kmer log-posteriors
    const E* row = post + (size_t)b * nst + 1 + 4 * r;
    reinterpret_cast<float4*>(cur)[r] = make_float4(
        logf(upcast(row[0]) + kEta), logf(upcast(row[1]) + kEta),
        logf(upcast(row[2]) + kEta), logf(upcast(row[3]) + kEta));
    reinterpret_cast<char4*>(tb + (size_t)b * K)[r] =
        make_char4(-1, -1, -1, -1);
  }
  // each log slot expects a chunk's bytes (the copy may land first)
  if (r == 0)
    for (int k = 0; k < nslots; ++k)
      mbar_expect_tx(&logged[k], 4u * (unsigned)chunk_floats);
  dp_barrier(ndp);
  const uint32_t log_freed = map_rank(freed, 1);
  int slot = 0, row = 0;
  unsigned phase = 0;
  int8_t* tb_row = tb + ((size_t)B + b) * K;
  const size_t tb_step = (size_t)B * K;
#ifdef VITERBI_FWD_CLOCKS
  PHASE_CLOCK_START();
#endif
  for (int t = 1; t < T; ++t) {
    if (row == 0) mbar_wait_tested(&logged[slot], phase);
    if (active) {
      const float* lrow = lring + slot * chunk_floats + row * log_floats;
      const float4 lk = reinterpret_cast<const float4*>(lrow)[r];
      const float lps = lrow[K];
#ifdef VITERBI_FWD_CLOCKS
      asm volatile("" ::"f"(lk.x), "f"(lps));
#endif
      FWD_CLOCK(0);
      FWD_CLOCK(1);

      float mx = cur[r];
      int am = 0;
#pragma unroll
      for (int g = 1; g < 4; ++g) {
        const float c = cur[g * nstep + r];
        if (c > mx) { mx = c; am = g; }
      }
      float mk = cur[s];
      int ak = 0;
#pragma unroll
      for (int h = 1; h < 16; ++h) {
        const float c = cur[h * nrem_skip + s];
        if (c > mk) { mk = c; ak = h; }
      }
      const float sk = mk - skip_pen;
      float m;
      int code;
      if (mx > sk) { m = mx; code = am; } else { m = sk; code = 4 + ak; }
#ifdef VITERBI_FWD_CLOCKS
      asm volatile("" ::"f"(m), "r"(code));
#endif
      FWD_CLOCK(2);

      const float4 old = reinterpret_cast<const float4*>(cur)[r];
      float4 sc;
      char4 cd;
      float nw, st;
      nw = lk.x + m; st = old.x + lps;
      cd.x = (signed char)(nw > st ? code : -1); sc.x = nw > st ? nw : st;
      nw = lk.y + m; st = old.y + lps;
      cd.y = (signed char)(nw > st ? code : -1); sc.y = nw > st ? nw : st;
      nw = lk.z + m; st = old.z + lps;
      cd.z = (signed char)(nw > st ? code : -1); sc.z = nw > st ? nw : st;
      nw = lk.w + m; st = old.w + lps;
      cd.w = (signed char)(nw > st ? code : -1); sc.w = nw > st ? nw : st;
      reinterpret_cast<float4*>(nxt)[r] = sc;
      reinterpret_cast<char4*>(tb_row)[r] = cd;
      FWD_CLOCK(3);
    }

    dp_barrier(ndp);
    // after a chunk's last frame every thread has read its log slot: it
    // expects the chunk nslots on, and the log block may fill it again
    if (++row == G) {
      row = 0;
      if (r == 0) {
        mbar_expect_tx(&logged[slot], 4u * (unsigned)chunk_floats);
        mbar_arrive_cluster(log_freed + 8u * slot);
      }
      if (++slot == nslots) {
        slot = 0;
        phase ^= 1u;
      }
    }
    tb_row += tb_step;
    float* tmp = cur; cur = nxt; nxt = tmp;
    FWD_CLOCK(4);
  }
#ifdef VITERBI_FWD_CLOCKS
  clk[7] = PHASE_CLOCK_TOTAL();
  if (b == 0 && (r & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) viterbi_fwd_clocks[(r >> 5) * 8 + k] = clk[k];
  }
#endif
  if (active)
    reinterpret_cast<float4*>(vfinal + (size_t)b * K)[r] =
        reinterpret_cast<const float4*>(cur)[r];
  cluster_sync();
}

// The general route: any nbase (codes up to nbase + nbase^2 - 1 fit int8)
// and K = nbase^klen, where the tuned kernels above take nbase 4 and
// klen 2..6 only (klen 7 over 4 bases, or 3 or 5 bases, as the Pallas
// kernel takes nbase and klen as parameters).
//
// What bounds it.  At klen 7 a step is 16,384 states of one row; one block
// a row ran it at 13,597 cycles a step, 8,565 of them its 16 logs, update
// and stores a thread (PERF.md §6, the general route's step 0): the
// per-state work of one SM, while a whole-read batch of 8 rows left 124 SMs
// idle.  The bytes (the posterior read, the codes written) would take 4.4
// ms at klen 7, T = 22,543, B = 8; the chain of T steps, each waiting on
// scores from the other blocks of its row, sets the pace long before that.
//
// What the design does about it.  Row b is a cluster of C blocks (ops/
// viterbi_kernel.py::viterbi_general_plan: C a power of two, at most
// nbase^2, that divides the skip groups into ranges of a multiple of 4).
// Block c owns contiguous ranges of the three index spaces: states
// [c KC, (c+1) KC) (KC = K / C), their step groups [c L1, (c+1) L1)
// (L1 = KC / nbase) and those groups' skip groups [c L2, (c+1) L2) (L2 =
// L1 / nbase).  Its thread r takes step groups r, r + nt, ...: the group's
// skip maximum over nbase^2 predecessors (computed by each of the skip
// group's nbase step groups, as the tuned step does), its step maximum
// over nbase predecessors, the decision and the update of its nbase
// states, with the frame's logs of those states, which it took itself.
// The predecessors of a block's groups lie in nbase step chunks (chunk g:
// states g K/nbase + c L1 .., L1 of them) and nbase^2 skip chunks
// (h K/nbase^2 + c L2 .., L2), which the block receives into `in` ([2]
// [step chunks | skip chunks], by parity of t).  A thread that updates
// state x stores its new score straight into its two consumers' inputs
// (x's step group's block and its skip group's block), 16 bytes a group
// where nbase is 4 (st.shared::cluster); after the step's block barrier,
// thread k < C makes one release arrival on block k's mbarrier of that
// parity, which completes when all C blocks have arrived.  So a step
// waits once for its inputs, on a local barrier, and has one block
// barrier, and the stores leave as the threads update (bulk copies after
// the barrier took ~2,300 cycles to land, and st.async stores one
// transaction update each on the consumer's barrier: PERF.md §6).  Every
// block receives from every block (C <= nbase^2), so a block that has step
// t's inputs knows that each consumer arrived with its step t - 1 scores
// after its block barrier, after its reads of the inputs that this block's
// step t + 1 stores overwrite.  Before its inputs arrive a thread takes
// the frame's logs of its states into the frame's ring slot (in place,
// then a proxy fence, since a bulk copy refills the slot), so the logs
// overlap the wait.  A block streams only its own slice of each posterior
// row (kmers 1 + c KC .., the aligned superset) and the 16-byte unit
// holding the stay, two bulk copies a frame on the slot's barrier; thread
// 0 refills frame t's slot with frame t + nslots after step t's block
// barrier.  The comparison order in each group is the single block's
// (first g and h win, a skip wins a tie with a step, a stay with the new
// score), so the codes and scores are the same bits at any C.  C = 1 is
// the single-block design: its scores, double-buffered, are its inputs (a
// state is its own step and skip predecessor at index x), and the block
// barrier orders them.  Where no C fits shared memory, C = 1 keeps them in
// `work`, a row's region of device memory (kShared false; a barrier orders
// device memory within the block as it does shared memory).  Divisions
// are a multiply-high by ceil(2^32 / d) (exact for i d < 2^32).
constexpr int kGeneralMaxSlots = 12;   // full[0..11]; 12: ping; 14-15: in
__device__ __forceinline__ unsigned div_by(unsigned i, unsigned magic) {
  return __umulhi(i, magic);
}

__device__ __forceinline__ unsigned magic_of(unsigned d) {
  return 0xffffffffu / d + 1u;
}

#ifdef VITERBI_FWD_CLOCKS
// a load of 4 bytes from a cluster address (the clocked build's chase)
__device__ __forceinline__ float ld_cluster(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}
#endif

// weak stores of 4 and 16 bytes to a cluster address
__device__ __forceinline__ void st_cluster(uint32_t a, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(a), "f"(v)
               : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t a, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   a),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// the first maximum (strict >) of p[0], p[stride], .., p[(n-1) stride] and
// its index, in order, eight loads at a time in flight
__device__ __forceinline__ float first_max(const float* p, int stride, int n,
                                           int& arg) {
  float m = p[0];
  arg = 0;
  for (int h0 = 1; h0 < n; h0 += 8) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = h0 + k < n ? p[(h0 + k) * stride] : 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (h0 + k < n && v[k] > m) { m = v[k]; arg = h0 + k; }
  }
  return m;
}

// The bytes of one ring slot: the stay's 16-byte unit, then the aligned
// superset of a block's KC kmers of `esize` bytes each
__host__ __device__ constexpr int general_slot_bytes(int KC, int esize) {
  return 16 + superset_bytes(KC, esize);
}

__host__ __device__ constexpr int general_round4(int n) {
  return (n + 3) & ~3;
}

// A block's arrays in shared memory (kShared), after the ring (KC4: KC
// rounded up to 16 bytes): C > 1, its scores [KC4], its inputs [2][2 KC4]
// and the cluster addresses of every block's inputs and barriers [2 C];
// C = 1, its scores, which are its inputs, [2][KC4]
__host__ __device__ constexpr size_t general_arrays(int K, int C) {
  return C > 1 ? 4 * (size_t)general_round4(K / C) * 5 +
                     4 * (size_t)general_round4(2 * C)
               : 4 * (size_t)general_round4(K / C) * 2;
}

// kNbase: 4, the bases of the JAX package's models, for which the loops
// over a group's predecessors and states unroll (4,136 cycles a step
// against 5,466 at klen 7, C = 8: PERF.md §6), or 0, any nbase_arg.  E:
// the posterior's element.  Where it is float the frame's logs are taken
// ahead of the update, in place in the slot, while the inputs arrive; a
// bf16 slice has no room for its f32 logs, so the update takes them from
// the slot (the same arithmetic: logf(upcast(p) + 1e-10)).
template <bool kShared, int kNbase, typename E>
__global__ void __launch_bounds__(1024, 1)
viterbi_fwd_general_kernel(const E* __restrict__ post,
                           int8_t* __restrict__ tb,
                           float* __restrict__ vfinal, float* work, int T,
                           int B, int K, int nbase_arg, float skip_pen, int C,
                           int nslots, int work_floats,
                           unsigned long long post_end) {
  constexpr bool kLogsAhead = std::is_same<E, float>::value;
  const int nbase = kNbase ? kNbase : nbase_arg;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);        // [nslots]
  uint64_t* inbar = full + 14;                               // [2]
  unsigned char* ring = smem + kBarBytes;   // [nslots][slot_bytes]
  const int c = (int)cluster_rank();
  const int b = blockIdx.x / C;
  const int r = threadIdx.x, nt = blockDim.x;
  const int nst = K + 1;
  const int nskip = nbase * nbase;
  const int nrs = K / nbase, nrk = K / nskip;
  const int KC = K / C, KC4 = general_round4(KC);
  const int L1 = KC / nbase, L2 = L1 / nbase;
  const int slot_bytes = general_slot_bytes(KC, (int)sizeof(E));
  const unsigned magic = magic_of((unsigned)nbase);
  float* sc = kShared
                  ? reinterpret_cast<float*>(ring + (size_t)nslots * slot_bytes)
                  : work + (size_t)b * work_floats;  // [KC4] scores
  float* in = C > 1 ? sc + KC4 : sc;         // [2][in_floats] inputs
  const int in_floats = C > 1 ? 2 * KC4 : KC4;
  uint32_t* remote = reinterpret_cast<uint32_t*>(in + 2 * in_floats);

  if (r == 0) {
    for (int k = 0; k < nslots; ++k) mbar_init(&full[k], 2);
    if (C > 1) {
      mbar_init(&full[12], 1);
      mbar_init(&inbar[0], C);   // an arrival from every block a step
      mbar_init(&inbar[1], C);
    }
    mbar_init_fence();
  }
  if (C > 1)
    for (int k = r; k < C; k += nt) {
      remote[k] = map_rank(in, (unsigned)k);
      remote[C + k] = map_rank(inbar, (unsigned)k);
    }
  if (C > 1)
    cluster_sync();  // every barrier set up before any store or arrival
  // frame t's stay unit and kmer slice into slot k
  auto refill = [&](int t, int k) {
    const E* row = post + ((size_t)t * B + b) * nst;
    unsigned char* slot = ring + (size_t)k * slot_bytes;
    fill(row, 1, post_end, slot, &full[k]);
    fill(row + 1 + c * KC, KC, post_end, slot + 16, &full[k]);
  };
  if (r == 0)
    for (int k = 0; k < nslots && 1 + k < T; ++k) refill(1 + k, k);
  // score v of state x (v4: states x .. x + 3) into the inputs of parity p
  // of its consumers: as a step predecessor, chunk g = x / nrs of block
  // (x mod nrs) / L1; as a skip predecessor, chunk h = x / nrk of block
  // (x mod nrk) / L2
  const unsigned m_rs = magic_of(nrs), m_rk = magic_of(nrk);
  const unsigned m_l1 = magic_of(L1), m_l2 = magic_of(L2);
  auto send = [&](unsigned x, auto v, int p) {
    const unsigned g = __umulhi(x, m_rs), js = x - g * nrs;
    const unsigned cs = L1 == 1 ? js : __umulhi(js, m_l1);
    const unsigned h = __umulhi(x, m_rk), jk = x - h * nrk;
    const unsigned ck = L2 == 1 ? jk : __umulhi(jk, m_l2);
    const uint32_t off = 4u * (uint32_t)(p * in_floats);
    st_cluster(remote[cs] + off + 4u * (g * L1 + js - cs * L1), v);
    st_cluster(remote[ck] + off + 4u * (KC4 + h * L2 + jk - ck * L2), v);
  };
  // after the block barrier: this block's scores of parity p are in every
  // consumer's inputs
  auto arrive = [&](int p) {
    if (r < C) mbar_arrive_cluster(remote[C + r] + 8u * p);
  };
  {
    // t = 0: the scores are the slice's kmer log-posteriors (each thread
    // its own groups' states)
    const E* row = post + (size_t)b * nst + 1 + c * KC;
    int8_t* tb0 = tb + (size_t)b * K + c * KC;
    for (int j = r; j < L1; j += nt) {
      const int i = nbase * j;
      for (int q = 0; q < nbase; ++q) {
        sc[i + q] = logf(upcast(row[i + q]) + kEta);
        tb0[i + q] = -1;
      }
      if (C == 1 || T < 2) continue;
      if constexpr (kNbase == 4)
        send((unsigned)(c * KC + i), reinterpret_cast<const float4*>(sc)[j],
             0);
      else
        for (int q = 0; q < nbase; ++q)
          send((unsigned)(c * KC + i + q), sc[i + q], 0);
    }
    __syncthreads();
    if (C > 1 && T > 1) arrive(0);
  }

  int slot = 0, par = 0;
  unsigned phase = 0, inphase = 0;   // inphase: bit p, inbar[p]'s parity
#ifdef VITERBI_FWD_CLOCKS
  PHASE_CLOCK_START();
#endif
  for (int t = 1; t < T; ++t) {
    // frame t's logs of this thread's states (f32: in place in its slot,
    // while the inputs arrive; lg), or the posterior that the update takes
    // them of (pr)
    const E* row = post + ((size_t)t * B + b) * nst;
    const E* kr = row + 1 + c * KC;
    const bool ahead = kLogsAhead && nslots > 0;
    float* lg = nullptr;
    const E* pr = kr;
    float stay;
    if (nslots > 0) {
      mbar_wait_tested(&full[slot], phase);
      unsigned char* sl = ring + (size_t)slot * slot_bytes;
      stay = upcast(in_storage(row, 1, post_end)
                        ? reinterpret_cast<const E*>(sl)[superset_offset(row)]
                        : row[0]);
      FWD_CLOCK(0);
      if (in_storage(kr, KC, post_end))
        pr = reinterpret_cast<const E*>(sl + 16) + superset_offset(kr);
      if constexpr (kLogsAhead) {
        lg = reinterpret_cast<float*>(sl + 16) + superset_offset(kr);
        for (int i = nbase * r; i < KC; i += nbase * nt)
          for (int q = 0; q < nbase; ++q) lg[i + q] = logf(pr[i + q] + kEta);
        fence_proxy_async();   // before a bulk copy refills the slot
      }
    } else {
      stay = upcast(row[0]);
    }
    const float lps = logf(stay + kEta);
    FWD_CLOCK(1);
    // the scores of step t - 1
    if (C > 1) {
      mbar_wait_cluster(&inbar[par], (inphase >> par) & 1u);
      inphase ^= 1u << par;
    }
    FWD_CLOCK(2);
    const float* sp = in + par * in_floats;   // [nbase][L1] step chunks
    const float* kp = C > 1 ? sp + KC4 : sp;  // [nbase^2][L2] skip chunks
    // this block's scores at t - 1, and at t: in place where C > 1 (its
    // thread alone reads and writes a state's score), else by parity
    const float* old = C > 1 ? sc : sc + par * KC4;
    float* nxt = C > 1 ? sc : sc + (par ^ 1) * KC4;
    const bool last = t + 1 == T;
    int8_t* tb_row = tb + ((size_t)t * B + b) * K + c * KC;
    for (int j = r; j < L1; j += nt) {
      const int u = (int)div_by((unsigned)j, magic);   // its skip group
      int ak, am;
      const float sk = first_max(kp + u, L2, nskip, ak) - skip_pen;
      const float mx = first_max(sp + j, L1, nbase, am);
      float m;
      int code;
      if (mx > sk) { m = mx; code = am; } else { m = sk; code = nbase + ak; }
#ifdef VITERBI_FWD_CLOCKS
      asm volatile("" ::"f"(m), "r"(code));
#endif
      FWD_CLOCK(3);
      if constexpr (kNbase == 4) {
        float l[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          l[q] = ahead ? lg[4 * j + q] : logf(upcast(pr[4 * j + q]) + kEta);
        const float4 o = reinterpret_cast<const float4*>(old)[j];
        float4 sv;
        char4 cd;
        float nw, st;
        nw = l[0] + m; st = o.x + lps;
        cd.x = (signed char)(nw > st ? code : -1); sv.x = nw > st ? nw : st;
        nw = l[1] + m; st = o.y + lps;
        cd.y = (signed char)(nw > st ? code : -1); sv.y = nw > st ? nw : st;
        nw = l[2] + m; st = o.z + lps;
        cd.z = (signed char)(nw > st ? code : -1); sv.z = nw > st ? nw : st;
        nw = l[3] + m; st = o.w + lps;
        cd.w = (signed char)(nw > st ? code : -1); sv.w = nw > st ? nw : st;
        reinterpret_cast<float4*>(nxt)[j] = sv;
        reinterpret_cast<char4*>(tb_row)[j] = cd;
        if (C > 1 && !last) send((unsigned)(c * KC + 4 * j), sv, par ^ 1);
      } else {
        for (int q = 0; q < nbase; ++q) {
          const int i = nbase * j + q;
          const float nw =
              (ahead ? lg[i] : logf(upcast(pr[i]) + kEta)) + m;
          const float st = old[i] + lps;
          tb_row[i] = nw > st ? (int8_t)code : (int8_t)-1;
          const float v = nw > st ? nw : st;
          nxt[i] = v;
          if (C > 1 && !last) send((unsigned)(c * KC + i), v, par ^ 1);
        }
      }
      FWD_CLOCK(4);
    }
    __syncthreads();
    // every thread has read frame t's logs: its slot takes t + nslots
    if (nslots > 0) {
      if (r == 0 && t + nslots < T) refill(t + nslots, slot);
      if (++slot == nslots) {
        slot = 0;
        phase ^= 1u;
      }
    }
    if (C > 1 && !last) arrive(par ^ 1);
    par ^= 1;
    FWD_CLOCK(5);
  }
#ifdef VITERBI_FWD_CLOCKS
  clk[7] = PHASE_CLOCK_TOTAL();
#endif
  const float* fin = C > 1 ? sc : sc + par * KC4;
  for (int i = r; i < KC; i += nt)
    vfinal[(size_t)b * K + (size_t)c * KC + i] = fin[i];
#ifdef VITERBI_FWD_CLOCKS
  // the design floors' parts, from block 0 of row 0's cluster: thread 0
  // times 16 cluster barriers, thread 32 a chase of 64 dependent loads
  // through the next block's shared memory, thread 64 32 round trips of a
  // store to the next block with its release arrival, and the answer
  // (rank 1's thread 64)
  if (C > 1) {
    cluster_sync();
    long long t0 = clock64();
    for (int k = 0; k < 16; ++k) cluster_sync();
    if (r == 0) clk[6] = clock64() - t0;
    uint32_t* chain = reinterpret_cast<uint32_t*>(in);
    const int links = KC < 64 ? KC : 64;
    for (int i = r; i < links; i += nt) chain[i] = (i + 1) % links;
    cluster_sync();
    if (r == 32 && kShared) {
      const uint32_t peer = map_rank(chain, (unsigned)((c + 1) % C));
      uint32_t idx = 0;
      t0 = clock64();
      for (int k = 0; k < 64; ++k)
        idx = __float_as_uint(ld_cluster(peer + 4u * idx));
      clk[6] = clock64() - t0 + (idx > 64u ? 1 : 0);
    }
    if (r == 64 && c < 2) {
      const uint32_t peer = map_rank(in + 64, (unsigned)(c ^ 1));
      const uint32_t peer_bar = map_rank(&full[12], (unsigned)(c ^ 1));
      t0 = clock64();
      for (int k = 0; k < 32; ++k) {
        if (c == 0) {
          st_cluster(peer, make_float4(k, k, k, k));
          mbar_arrive_cluster(peer_bar);
        }
        mbar_wait_cluster(&full[12], (unsigned)(k & 1));
        if (c == 1) {
          st_cluster(peer, make_float4(k, k, k, k));
          mbar_arrive_cluster(peer_bar);
        }
      }
      clk[6] = clock64() - t0;
    }
    if (b == 0 && c == 0 && (r & 31) == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        viterbi_fwd_clocks[(r >> 5) * 8 + k] = clk[k];
    }
  }
#endif
  if (C > 1) cluster_sync();   // no block leaves while another stores to it
}

template <int DPT, typename E>
int launch(const void* post, void* tb, void* vfinal, int T, int B, int K,
           float skip_pen, int nslots, int smem, int row_bytes,
           unsigned long long post_end, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        viterbi_fwd_kernel<DPT, E>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  viterbi_fwd_kernel<DPT, E><<<B, K / DPT, smem, stream>>>(
      (const E*)post, (int8_t*)tb, (float*)vfinal, T, B, K, skip_pen, nslots,
      row_bytes, post_end);
  return (int)cudaGetLastError();
}

// the tuned routes of viterbi_fwd for a posterior of E
template <typename E>
int launch_tuned(const void* post, void* tb, void* vfinal, int T, int B,
                 int K, float skip_pen, int dpt, int G, int nslots, int smem,
                 int row_bytes, unsigned long long post_end,
                 cudaStream_t s) {
  if (dpt == 4)
    return launch<4, E>(post, tb, vfinal, T, B, K, skip_pen, nslots, smem,
                        row_bytes, post_end, s);
  if (dpt == 8)
    return launch<8, E>(post, tb, vfinal, T, B, K, skip_pen, nslots, smem,
                        row_bytes, post_end, s);
  if (dpt == 0) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          viterbi_fwd_pair_kernel<E>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    viterbi_fwd_pair_kernel<E><<<2 * B, pair_threads(K), smem, s>>>(
        (const E*)post, (int8_t*)tb, (float*)vfinal, T, B, K, skip_pen, G,
        nslots, kPairPostSlots, row_bytes, post_end);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// the general kernel's instance: scores in shared memory or in `work`, 4
// bases unrolled or any, the posterior's element
template <typename E>
const void* general_kernel(bool shared, int nbase) {
  return !shared      ? (const void*)viterbi_fwd_general_kernel<false, 0, E>
         : nbase == 4 ? (const void*)viterbi_fwd_general_kernel<true, 4, E>
                      : (const void*)viterbi_fwd_general_kernel<true, 0, E>;
}

}  // namespace

// post (T, B, K+1) f32 (esize 4) or bf16 (esize 2); tb (T, B, K) int8;
// vfinal (B, K) f32.  K = 4^klen for klen 2..6.  The plan comes from the
// caller (ops/viterbi_kernel.py::viterbi_fwd_plan): dpt destinations a
// thread (4 or 8; K / dpt threads a block; 0: a cluster of two blocks of
// K / 4 threads a row, the logs taken by the second), the rings' nslots
// slots of G frames (G = 1 but for the pairs) and the dynamic shared
// memory smem.  post_end: the address one past the last byte of post's
// storage.  Returns the cudaError_t of the launch; cudaErrorInvalidValue
// (1) for a plan that does not fit.
extern "C" int viterbi_fwd(const void* post, void* tb, void* vfinal, int T,
                           int B, int K, float skip_pen, int dpt, int G,
                           int nslots, int smem, int esize,
                           unsigned long long post_end, void* stream) {
  const int row_bytes = superset_bytes(K + 1, esize);
  // the pair route: the DP block's log slots ([G][K + 4] floats) and the
  // log block's posterior slots (G rows each) beside them
  const size_t need =
      dpt ? kBarBytes + (size_t)nslots * row_bytes
          : kPairBarBytes + (size_t)G * ((size_t)nslots * 4 * (K + 4) +
                                         (size_t)kPairPostSlots * row_bytes);
  if (T < 1 || B < 1 || K < 16 || K > 4096 || (K & (K - 1)) ||
      (esize != 4 && esize != 2) || nslots < 2 || nslots > kMaxSlots ||
      (uintptr_t)post % esize || (dpt ? G != 1 : (G < 1 || G > 32)) ||
      (size_t)smem < need + 8 * (size_t)K)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return esize == 4
             ? launch_tuned<float>(post, tb, vfinal, T, B, K, skip_pen, dpt,
                                   G, nslots, smem, row_bytes, post_end, s)
             : launch_tuned<__nv_bfloat16>(post, tb, vfinal, T, B, K,
                                           skip_pen, dpt, G, nslots, smem,
                                           row_bytes, post_end, s);
}

// The general route (viterbi_fwd_general_kernel) for K = nbase^klen states
// over nbase bases, nbase + nbase^2 <= 128: a cluster of C blocks a row (C
// a power of two up to 16 and nbase^2 that divides the K / nbase^2 skip
// groups into ranges of a multiple of 4) of `threads` each, a ring of
// nslots (0 or 2-12) slots in smem bytes, and the scores in smem (work
// null) or in work, work_floats floats a row (C = 1 only); post f32
// (esize 4) or bf16 (esize 2).  The plan comes from ops/viterbi_kernel.py::
// viterbi_general_plan.  Returns the cudaError_t of the launch;
// cudaErrorInvalidValue (1) for a plan that does not fit.
extern "C" int viterbi_fwd_general(const void* post, void* tb, void* vfinal,
                                   void* work, int T, int B, int K,
                                   int nbase, float skip_pen, int C,
                                   int nslots, int threads, int smem,
                                   int work_floats, int esize,
                                   unsigned long long post_end,
                                   void* stream) {
  const int nskip = nbase * nbase;
  const int nrk = nbase > 1 && nbase + nskip <= 128 ? K / nskip : 0;
  const bool shared = work == nullptr;
  if (T < 1 || B < 1 || nbase < 2 || nbase + nskip > 128 || nrk < 1 ||
      nrk * nskip != K || C < 1 || C > 16 || C > nskip || (C & (C - 1)) ||
      nrk % C || (!shared && C != 1) || nslots < 0 || nslots == 1 ||
      nslots > kGeneralMaxSlots || threads < 32 || threads > 1024 ||
      threads % 32 || (C > 1 && (K / (nskip * C)) % 4) ||
      (esize != 4 && esize != 2) || (uintptr_t)post % esize ||
      (size_t)smem < kBarBytes +
                         (size_t)nslots * general_slot_bytes(K / C, esize) +
                         (shared ? general_arrays(K, C) : 0) ||
      (!shared && (size_t)work_floats < 2 * (size_t)general_round4(K)))
    return (int)cudaErrorInvalidValue;
  const void* kernel = esize == 4
                           ? general_kernel<float>(shared, nbase)
                           : general_kernel<__nv_bfloat16>(shared, nbase);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = C;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.gridDim = dim3(B * C, 1, 1);
  config.blockDim = dim3(threads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  config.attrs = cluster;
  config.numAttrs = 1;
  void* args[] = {(void*)&post,  &tb,     &vfinal, &work,   &T,
                  &B,            &K,      &nbase,  &skip_pen, &C,
                  &nslots,       &work_floats, &post_end};
  e = cudaLaunchKernelExC(&config, kernel, args);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The clusters of C blocks of the general kernel (`threads` and smem bytes
// a block, its arrays in shared memory) that the device runs at once, into
// *clusters.  Returns the cudaError_t.
extern "C" int viterbi_fwd_general_clusters(int C, int threads, int smem,
                                            int* clusters) {
  const auto kernel = viterbi_fwd_general_kernel<true, 4, float>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = C;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.gridDim = dim3(C, 1, 1);
  config.blockDim = dim3(threads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.attrs = cluster;
  config.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(clusters, (const void*)kernel,
                                             &config);
}

// The clusters of the pair kernel (K / 4 threads and smem bytes a block)
// that the device runs at once, into *clusters.  Returns the cudaError_t.
extern "C" int viterbi_fwd_pairs(int K, int smem, int* clusters) {
  cudaError_t e = cudaFuncSetAttribute(
      viterbi_fwd_pair_kernel<float>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(2, 1, 1);
  config.blockDim = dim3(pair_threads(K), 1, 1);
  config.dynamicSmemBytes = smem;
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, (const void*)viterbi_fwd_pair_kernel<float>, &config);
}

#ifdef VITERBI_FWD_CLOCKS
// copy the step-phase clocks of the last launch, [warp][8], to host memory
extern "C" int viterbi_fwd_clocks_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, viterbi_fwd_clocks,
                                   sizeof(viterbi_fwd_clocks));
}
#endif
