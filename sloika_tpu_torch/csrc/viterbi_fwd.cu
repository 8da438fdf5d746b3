// Transducer Viterbi forward pass for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels sloika_tpu/ops/pallas/viterbi.py::
// _fwd_kernel_sm (state-major, driven by viterbi_forward_sm) and its
// lane-major twin _fwd_kernel (viterbi_forward): one GPU layout serves both.
//
// Input: the forward's time-major posterior post (T, B, K+1) f32, column 0 =
// stay, in the probability domain.  Output: traceback codes tb (T, B, K)
// int8 and the final scores vfinal (B, K) f32.  nbase = 4, so a destination
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
// Per step a row reads K+1 floats of posterior and writes K bytes of
// traceback: 5 bytes a state, streamed once.  At the basecall paths'
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
// step.  A row is 4 (K+1) bytes at a stride of B 4 (K+1), 16-byte aligned
// for one row in four, so a copy takes the row's aligned superset and the
// reader starts at the row's offset into it; a superset that would run
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
#include "bulk_copy.cuh"

#ifdef VITERBI_FWD_CLOCKS
// Step-phase clocks (scripts/bench_viterbi.py --clocks builds this source
// with -DVITERBI_FWD_CLOCKS into a library of its own): lane 0 of each DP
// warp of row 0's block sums, over the steps, the SM clock cycles of the
// wait for the frame's slot and its reads (0), the logs (1: none on the
// pair route), the step and skip maxima (2), the update and the stores (3)
// and the barrier with the refill or the slot's release (4); slot 7 holds
// the loop's cycles.
__device__ long long viterbi_fwd_clocks[32 * 8];
#define FWD_CLOCK(k) PHASE_CLOCK(k)
#else
#define FWD_CLOCK(k) \
  do {               \
  } while (0)
#endif

namespace {

constexpr float kEta = 1e-10f;
constexpr int kMaxSlots = 16;
constexpr int kBarBytes = 128;     // the slots' full mbarriers
constexpr int kPairBarBytes = 384; // full, freed, logged: 16 each
constexpr int kPairPostSlots = 2;  // the log block's posterior slots

// One thread: copy frame t's posterior row `row` into a ring slot, on the
// slot's barrier (one arrival that expects the copy's bytes).  A row is
// 4 (K+1) bytes, 16-byte aligned for one row in four, so the copy takes
// the row's aligned superset; a superset that would run past `end`, the
// end of the tensor's storage (its last row), is not copied, and arrives
// with no bytes.
__device__ __forceinline__ void fill(const float* row, int nst,
                                     unsigned long long end, float* slot,
                                     uint64_t* bar) {
  const unsigned long long a = (unsigned long long)row;
  const unsigned long long a0 = a & ~15ull;
  const unsigned long long e = (a + 4ull * nst + 15ull) & ~15ull;
  if (e <= end) {
    mbar_expect_tx(bar, (unsigned)(e - a0));
    bulk_copy(slot, reinterpret_cast<const float*>(a0), (unsigned)(e - a0),
              bar);
  } else {
    mbar_expect_tx(bar, 0u);
  }
}

// The DP with DPT destinations a thread: thread r owns the step groups
// (DPT/4) r .. (DPT/4) r + DPT/4 - 1, i.e. destinations DPT r ..
// DPT r + DPT - 1, which share one skip group (DPT <= 16).
// With 4 destinations a thread a block has its SM alone (the plan), and
// may take up to 64 registers a thread; with 8, blocks share an SM.
template <int DPT>
__global__ void __launch_bounds__(DPT == 4 ? 1024 : 512, DPT == 4 ? 1 : 2)
viterbi_fwd_kernel(const float* __restrict__ post, int8_t* __restrict__ tb,
                   float* __restrict__ vfinal, int T, int B, int K,
                   float skip_pen, int nslots, int row_floats,
                   unsigned long long post_end) {
  constexpr int kGroups = DPT / 4;      // step groups a thread
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);        // [nslots]
  float* ring = reinterpret_cast<float*>(smem + kBarBytes);  // [nslots][row]
  float* cur = ring + (size_t)nslots * row_floats;  // [K] scores at t-1
  float* nxt = cur + K;                             // [K] scores at t
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
    const float* row = post + ((size_t)B + b) * nst;
    for (int k = 0; k < nslots && 1 + k < T; ++k, row += row_step)
      fill(row, nst, post_end, ring + (size_t)k * row_floats, &full[k]);
  }
  {
    // t = 0: the scores are the row's kmer log-posteriors
    const float* row = post + (size_t)b * nst + 1 + DPT * r;
#pragma unroll
    for (int i = 0; i < DPT; i += 4)
      reinterpret_cast<float4*>(cur + DPT * r)[i / 4] = make_float4(
          logf(row[i] + kEta), logf(row[i + 1] + kEta),
          logf(row[i + 2] + kEta), logf(row[i + 3] + kEta));
#pragma unroll
    for (int i = 0; i < DPT; i += 4)
      reinterpret_cast<char4*>(tb + (size_t)b * K + DPT * r)[i / 4] =
          make_char4(-1, -1, -1, -1);
  }
  // only the last row of the storage can be left out of the ring
  const float* last = post + ((size_t)(T - 1) * B + b) * nst;
  const bool last_copied =
      (((unsigned long long)last + 4ull * nst + 15ull) & ~15ull) <= post_end;
  __syncthreads();

  int slot = 0;
  unsigned phase = 0;
  const float* row_g = post + ((size_t)B + b) * nst;   // frame t's row
  const float* fill_row = row_g + nslots * row_step;   // frame t + nslots's
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
      const float* p = ring + slot * row_floats + (((uintptr_t)row_g >> 2) & 3);
      p0 = p[0];
#pragma unroll
      for (int i = 0; i < DPT; ++i) pk[i] = p[1 + DPT * r + i];
    } else {
      p0 = row_g[0];
#pragma unroll
      for (int i = 0; i < DPT; ++i) pk[i] = row_g[1 + DPT * r + i];
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
      fill(fill_row, nst, post_end, ring + slot * row_floats, &full[slot]);
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

// Distributed shared memory and cluster-scope mbarriers (sm_90): the
// address of `p` in the shared memory of the cluster's block `rank`
__device__ __forceinline__ uint32_t map_rank(const void* p, unsigned rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  return a;
}

// one arrival on a barrier in another block of the cluster, releasing this
// thread's earlier writes (and those a block barrier ordered before them)
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          bar)
      : "memory");
}

// wait on a local barrier whose arrivals come from the cluster: the test
// first, then the blocking try_wait
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
      "%2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// a bulk copy of `bytes` from this block's shared memory to a cluster
// address, completing on a barrier at a cluster address
__device__ __forceinline__ void bulk_copy_cluster(uint32_t dst, const void* src,
                                                  unsigned bytes,
                                                  uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
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
// each ring holds chunk c, frames 1 + cG .. (c + 1)G.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(1024, 1)
viterbi_fwd_pair_kernel(const float* __restrict__ post,
                        int8_t* __restrict__ tb, float* __restrict__ vfinal,
                        int T, int B, int K, float skip_pen, int G,
                        int nslots, int P, int row_floats,
                        unsigned long long post_end) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // log block: copied
  uint64_t* freed = full + kMaxSlots;                   // log block: read
  uint64_t* logged = freed + kMaxSlots;                 // DP block: logs in
  // the DP block: nslots log slots, then the scores; the log block: P
  // posterior slots, then nslots staging slots
  float* ring = reinterpret_cast<float*>(smem + kPairBarBytes);
  const int chunk_floats = G * row_floats;
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
      const unsigned long long e = (a + 4ull * nst + 15ull) & ~15ull;
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
            bulk_copy(ring + (size_t)(c % P) * chunk_floats +
                          (size_t)q * row_floats,
                      reinterpret_cast<const float*>(a0), bytes, bar);
        }
      }
    };
    for (int c = 0; c < P && c < nchunks; ++c) refill(c);
    // thread r takes kmers 4 kk .. 4 kk + 3 of frames q0, q0 + per, ...
    const int kk = r % nstep, q0 = r / nstep, per = blockDim.x / nstep;
    float* stage = ring + (size_t)P * chunk_floats;
    const uint32_t dp_ring = map_rank(ring, 0);
    const uint32_t dp_logged = map_rank(logged, 0);
    int pslot = 0, slot = 0;
    unsigned pphase = 0, phase = 0;
    for (int c = 0; c < nchunks; ++c) {
      mbar_wait_tested(&full[pslot], pphase);
      if (c >= nslots) mbar_wait_cluster(&freed[slot], phase ^ 1u);
      const float* src = ring + pslot * chunk_floats;
      float* dst = stage + slot * chunk_floats;
      if (q0 < per) {
        for (int q = q0; q < G && 1 + c * G + q < T; q += per) {
          const float* row = post + ((size_t)(1 + c * G + q) * B + b) * nst;
          const unsigned long long a = (unsigned long long)row;
          const bool copied =
              ((a + 4ull * nst + 15ull) & ~15ull) <= post_end;
          const float* p =
              copied ? src + q * row_floats + ((a >> 2) & 3) : row;
          float* d = dst + q * row_floats;
          reinterpret_cast<float4*>(d)[kk] = make_float4(
              logf(p[1 + 4 * kk] + kEta), logf(p[2 + 4 * kk] + kEta),
              logf(p[3 + 4 * kk] + kEta), logf(p[4 + 4 * kk] + kEta));
          if (kk == 0) d[K] = logf(p[0] + kEta);
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
  float* cur = ring + (size_t)nslots * chunk_floats;    // scores at t-1
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
    const float* row = post + (size_t)b * nst + 1 + 4 * r;
    reinterpret_cast<float4*>(cur)[r] =
        make_float4(logf(row[0] + kEta), logf(row[1] + kEta),
                    logf(row[2] + kEta), logf(row[3] + kEta));
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
      const float* lrow = ring + slot * chunk_floats + row * row_floats;
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
// kernel takes nbase and klen as parameters).  One block a row; a step in
// three phases, each over its own index so that consecutive threads read
// consecutive scores:
//   1. skip group s (K / nbase^2 of them): its first maximum and argmax
//      over its nbase^2 predecessors h K/nbase^2 + s, less skip_pen;
//   2. step group j (K / nbase): its first maximum over its nbase
//      predecessors g K/nbase + j, against its skip group j / nbase's,
//      into the group's max and code;
//   3. state i: the update against the stay, as in the tuned step.
// Phase 3 reads no score but its own, and phases 1-2 read all of them
// before the barrier that precedes it, so the scores are updated in place
// (one buffer: two ring slots fit beside it at K = 16,384).  Divisions by
// nbase are a multiply-high by ceil(2^32 / nbase) (exact for i < 2^32 /
// nbase).  The scores and the groups' maxima and codes lie in shared
// memory where they fit (kShared), else in `work`, a row's region of
// device memory (a block barrier orders device memory within the block as
// it does shared memory).  Frame t's posterior row comes through a ring of
// nslots shared-memory slots by one thread's bulk copies of its aligned
// superset, refilled after the step's last barrier (nslots = 0: read from
// device memory), and is waited for before phase 3.
__device__ __forceinline__ unsigned div_by(unsigned i, unsigned magic) {
  return __umulhi(i, magic);
}

// phase 3 of the general route over the frame's row p (stay, then kmers)
__device__ __forceinline__ void general_update(
    const float* p, float* cur, const float* stm, const int8_t* stc,
    int8_t* __restrict__ tb_row, int K, unsigned magic) {
  const float lps = logf(p[0] + kEta);
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const unsigned j = div_by((unsigned)i, magic);
    const float nw = logf(p[1 + i] + kEta) + stm[j];
    const float st = cur[i] + lps;
    tb_row[i] = nw > st ? stc[j] : (int8_t)-1;
    cur[i] = nw > st ? nw : st;
  }
}

template <bool kShared>
__global__ void __launch_bounds__(1024, 1)
viterbi_fwd_general_kernel(const float* __restrict__ post,
                           int8_t* __restrict__ tb,
                           float* __restrict__ vfinal, float* work, int T,
                           int B, int K, int nbase, float skip_pen,
                           int nslots, int row_floats, int work_floats,
                           unsigned long long post_end) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);        // [nslots]
  float* ring = reinterpret_cast<float*>(smem + kBarBytes);  // [nslots][row]
  const int b = blockIdx.x;
  const int r = threadIdx.x, nt = blockDim.x;
  const int nst = K + 1;
  const int nskip = nbase * nbase;
  const int nrs = K / nbase, nrk = K / nskip;
  const unsigned magic = 0xffffffffu / (unsigned)nbase + 1u;
  const size_t row_step = (size_t)B * nst;
  float* cur = kShared ? ring + (size_t)nslots * row_floats
                       : work + (size_t)b * work_floats;     // [K] scores
  float* stm = cur + K;             // [nrs] step groups' maxima
  float* skv = stm + nrs;           // [nrk] skip groups' maxima - skip_pen
  int8_t* stc = reinterpret_cast<int8_t*>(skv + nrk);   // [nrs] their codes
  int8_t* ska = stc + nrs;                              // [nrk] argmax h

  if (r == 0 && nslots > 0) {
    for (int k = 0; k < nslots; ++k) mbar_init(&full[k], 1);
    mbar_init_fence();
    const float* row = post + ((size_t)B + b) * nst;
    for (int k = 0; k < nslots && 1 + k < T; ++k, row += row_step)
      fill(row, nst, post_end, ring + (size_t)k * row_floats, &full[k]);
  }
  {
    // t = 0: the scores are the row's kmer log-posteriors
    const float* row = post + (size_t)b * nst + 1;
    int8_t* tb0 = tb + (size_t)b * K;
    for (int i = r; i < K; i += nt) {
      cur[i] = logf(row[i] + kEta);
      tb0[i] = -1;
    }
  }
  __syncthreads();

  int slot = 0;
  unsigned phase = 0;
  for (int t = 1; t < T; ++t) {
    for (int s = r; s < nrk; s += nt) {
      float mk = cur[s];
      int ak = 0;
      for (int h = 1; h < nskip; ++h) {
        const float c = cur[h * nrk + s];
        if (c > mk) { mk = c; ak = h; }
      }
      skv[s] = mk - skip_pen;
      ska[s] = (int8_t)ak;
    }
    __syncthreads();
    for (int j = r; j < nrs; j += nt) {
      float mx = cur[j];
      int am = 0;
      for (int g = 1; g < nbase; ++g) {
        const float c = cur[g * nrs + j];
        if (c > mx) { mx = c; am = g; }
      }
      const unsigned s = div_by((unsigned)j, magic);
      const float sk = skv[s];
      if (mx > sk) {
        stm[j] = mx;
        stc[j] = (int8_t)am;
      } else {
        stm[j] = sk;
        stc[j] = (int8_t)(nbase + ska[s]);
      }
    }
    // the frame's stay and kmers: from its slot, or from device memory
    const float* row_g = post + ((size_t)t * B + b) * nst;
    const unsigned long long a = (unsigned long long)row_g;
    const bool copied =
        nslots > 0 && ((a + 4ull * nst + 15ull) & ~15ull) <= post_end;
    if (copied) mbar_wait_tested(&full[slot], phase);
    __syncthreads();
    int8_t* tb_row = tb + ((size_t)t * B + b) * K;
    if (copied)
      general_update(ring + (size_t)slot * row_floats + ((a >> 2) & 3), cur,
                     stm, stc, tb_row, K, magic);
    else
      general_update(row_g, cur, stm, stc, tb_row, K, magic);
    __syncthreads();
    // every thread has read frame t: its slot takes frame t + nslots
    if (nslots > 0) {
      if (r == 0 && t + nslots < T)
        fill(post + ((size_t)(t + nslots) * B + b) * nst, nst, post_end,
             ring + (size_t)slot * row_floats, &full[slot]);
      if (++slot == nslots) {
        slot = 0;
        phase ^= 1u;
      }
    }
  }
  for (int i = r; i < K; i += nt) vfinal[(size_t)b * K + i] = cur[i];
}

template <int DPT>
int launch(const void* post, void* tb, void* vfinal, int T, int B, int K,
           float skip_pen, int nslots, int smem, int row_floats,
           unsigned long long post_end, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        viterbi_fwd_kernel<DPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  viterbi_fwd_kernel<DPT><<<B, K / DPT, smem, stream>>>(
      (const float*)post, (int8_t*)tb, (float*)vfinal, T, B, K, skip_pen,
      nslots, row_floats, post_end);
  return (int)cudaGetLastError();
}

}  // namespace

// post (T, B, K+1) f32; tb (T, B, K) int8; vfinal (B, K) f32.  K = 4^klen
// for klen 2..6.  The plan comes from the caller
// (ops/viterbi_kernel.py::viterbi_fwd_plan): dpt destinations a thread (4
// or 8; K / dpt threads a block; 0: a cluster of two blocks of K / 4
// threads a row, the logs taken by the second), the rings' nslots slots of
// G frames (G = 1 but for the pairs) and the dynamic shared memory smem.
// post_end: the address one past the last byte of post's storage.
// Returns the cudaError_t of the launch; cudaErrorInvalidValue (1) for a
// plan that does not fit.
extern "C" int viterbi_fwd(const void* post, void* tb, void* vfinal, int T,
                           int B, int K, float skip_pen, int dpt, int G,
                           int nslots, int smem, unsigned long long post_end,
                           void* stream) {
  const int row_bytes = (4 * (K + 1) + 12 + 15) & ~15;
  const size_t need =
      dpt ? kBarBytes + (size_t)nslots * row_bytes
          : kPairBarBytes +
                (size_t)(nslots + kPairPostSlots) * G * row_bytes;
  if (T < 1 || B < 1 || K < 16 || K > 4096 || (K & (K - 1)) ||
      nslots < 2 || nslots > kMaxSlots || (uintptr_t)post % 4 ||
      (dpt ? G != 1 : (G < 1 || G > 32)) ||
      (size_t)smem < need + 8 * (size_t)K)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dpt == 4)
    return launch<4>(post, tb, vfinal, T, B, K, skip_pen, nslots, smem,
                     row_bytes / 4, post_end, s);
  if (dpt == 8)
    return launch<8>(post, tb, vfinal, T, B, K, skip_pen, nslots, smem,
                     row_bytes / 4, post_end, s);
  if (dpt == 0) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          viterbi_fwd_pair_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    viterbi_fwd_pair_kernel<<<2 * B, pair_threads(K), smem, s>>>(
        (const float*)post, (int8_t*)tb, (float*)vfinal, T, B, K, skip_pen,
        G, nslots, kPairPostSlots, row_bytes / 4, post_end);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// The general route (viterbi_fwd_general_kernel) for K = nbase^klen states
// over nbase bases, nbase + nbase^2 <= 128: `threads` a block, a ring of
// nslots (0-16) one-frame slots in smem bytes, and the scores and groups'
// arrays in smem (work null) or in work, work_floats floats a row.  The
// plan comes from ops/viterbi_kernel.py::viterbi_general_plan.  Returns
// the cudaError_t of the launch; cudaErrorInvalidValue (1) for a plan that
// does not fit.
extern "C" int viterbi_fwd_general(const void* post, void* tb, void* vfinal,
                                   void* work, int T, int B, int K,
                                   int nbase, float skip_pen, int nslots,
                                   int threads, int smem, int work_floats,
                                   unsigned long long post_end,
                                   void* stream) {
  const int row_bytes = (4 * (K + 1) + 12 + 15) & ~15;
  const int nrs = nbase > 1 ? K / nbase : 0, nrk = nbase > 1 ? nrs / nbase : 0;
  const size_t arrays = 4 * ((size_t)K + nrs + nrk) + nrs + nrk;
  const size_t need = kBarBytes + (size_t)nslots * row_bytes +
                      (work == nullptr ? arrays : 0);
  if (T < 1 || B < 1 || nbase < 2 || nbase + nbase * nbase > 128 ||
      nrk < 1 || nrk * nbase * nbase != K || nslots < 0 ||
      nslots > kMaxSlots || threads < 32 || threads > 1024 || threads % 32 ||
      (uintptr_t)post % 4 || (size_t)smem < need ||
      (work != nullptr && (size_t)work_floats * 4 < arrays))
    return (int)cudaErrorInvalidValue;
  auto kernel = work == nullptr ? viterbi_fwd_general_kernel<true>
                                : viterbi_fwd_general_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)post, (int8_t*)tb, (float*)vfinal, (float*)work, T, B, K,
      nbase, skip_pen, nslots, row_bytes / 4, work_floats, post_end);
  return (int)cudaGetLastError();
}

// The clusters of the pair kernel (K / 4 threads and smem bytes a block)
// that the device runs at once, into *clusters.  Returns the cudaError_t.
extern "C" int viterbi_fwd_pairs(int K, int smem, int* clusters) {
  cudaError_t e = cudaFuncSetAttribute(
      viterbi_fwd_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(2, 1, 1);
  config.blockDim = dim3(pair_threads(K), 1, 1);
  config.dynamicSmemBytes = smem;
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, (const void*)viterbi_fwd_pair_kernel, &config);
}

#ifdef VITERBI_FWD_CLOCKS
// copy the step-phase clocks of the last launch, [warp][8], to host memory
extern "C" int viterbi_fwd_clocks_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, viterbi_fwd_clocks,
                                   sizeof(viterbi_fwd_clocks));
}
#endif
