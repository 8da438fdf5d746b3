// Peephole LSTM forward recurrence at S 257-384 (bonito's LSTMs of 384),
// inference only, for Hopper (sm_90a): a cluster of 16 blocks a group of
// rows.
//
// Replaces the Pallas TPU kernel sloika_tpu/nn/pallas_lstm.py::
// _fwd_kernel_nocout (through _fwd_step, driven by _pallas_scan) where S is
// too wide for csrc/lstm_fwd.cu, whose block holds every gate column of
// the rows it owns.  Same contract as there: over the hoisted input
// projection xp (T, B, 4S), f32 throughout, gate order 0 candidate,
// 1 input, 2 forget, 3 output,
//
//     sumW = xp_t + h . sWT                         sWT (S, 4S)
//     f    = sigmoid(g2 + c * p[1]);  i = sigmoid(g1 + c * p[0])
//     c'   = c * f + tanh(g0) * i
//     o    = sigmoid(g3 + c' * p[2]);  h' = tanh(c') * o
//
// a masked step keeps and emits the carried (h, c), `reverse` scans from
// t = T-1 down to 0, and h_out is (T, B, S) f32.  No cell or gate trace:
// the backward kernels stop at S = 256.
//
// What bounds it.  sWT (S x 4S, 2.36 MB at S = 384) fits no SM, and a step
// of a row is 4 S^2 FMAs that depend on the row's last step.  A block that
// owns rows and all 4S columns (csrc/lstm_fwd.cu) streams all of sWT from
// L2 every step for its few rows: 130.7 ms at T 2,000, B 512, one SM at
// ~1/3.5 of its FMA rate (PERF.md §6 row 5).
//
// Design.  A cluster of C = 16 blocks owns R rows (the plan, nn/
// fused_lstm.py::lstm_fwd_plan: R = ceil(B / clusters), the clusters the
// card runs at once, 7 of 16 on an H100, 74 rows at B 512) and splits the
// states: block c owns SC = 24 states (S padded to 384 with states whose
// weights and h stay zero), all four gate columns of each, 96 columns, so
// the cell update stays in the block.
//
// - Weights: the block's slice of sWT (384 x 96 floats, 147 KB) lives in
//   registers for all T steps, 96 floats a thread: warp w is k group w (k
//   32w to 32w + 31, 12 warps), lane l holds columns l, l + 32, l + 64
//   (block column 4s + q is column q S + 24c + s).  No step reads sWT.
// - h: every block keeps all of h_t for the cluster's rows in shared memory,
//   chunk-major ([chunk][k/4][row][4]: block c's states of a chunk are one
//   contiguous 768 bytes).  A product reads 16 bytes (4 k of a row) that
//   all 32 lanes of the warp share (one broadcast) and makes 12 FMAs a lane
//   of it: 3 columns a lane, since with one (4 FMAs a load) the loads, not
//   the FMAs, bounded the product (PERF.md §6 row 5).  A thread keeps 4
//   rows' sums; the 12 k groups' partial sums meet in shared memory (two
//   chunks' buffers) and are joined in a fixed order, ((p0 + p1) + (p2 +
//   p3)) + ... + xp: the same bits on every run.
// - A step walks the rows in chunks of 8.  Chunk i: wait until every
//   block's slice of h_t for these rows has landed (mbarrier full[i]); the
//   product; one block barrier; threads 0-191 (warps 0-5) then update the
//   cell of one (row, state) of the chunk each (xp copied in under the
//   product by cp.async, c in shared memory) and write h_{t+1} to a
//   staging buffer (two, by the step's parity) and h_out.
// - Exchange over distributed shared memory, by lanes 0-2 of warps 6-11,
//   which have no cell: after the block barrier that ends a chunk's product
//   (this block has read chunk i of h_t) each of 16 threads arrives on one
//   block's empty[i]; after the barrier that follows the chunk's cells it
//   copies the block's slice of the chunk's h_{t+1} into that block
//   (itself included) with a bulk copy (cp.async.bulk shared::cluster)
//   that completes on the block's full[i], once empty[i] has its 16
//   arrivals.  No cluster barrier a step: chunk i's exchange runs under the
//   product of the chunks after it.  A staging buffer is written again two
//   steps on; by then every copy from it has landed, since this block's
//   full[i] of step t+1 needs copies that waited on empty[i] of step t+1,
//   which needs every block to have passed its full[i] of step t.
//
// Budget (R = 74, rows padded to 80): registers, 96 floats of weights a
// thread (147 KB of the SM's 256 KB; 165 registers a thread, no spills);
// shared memory, h 16 x 80 x 24 floats (123 KB), the staging buffers 2 x 80
// x 24 (15 KB), c 80 x 24 (7.5 KB), a chunk's xp 8 x 96 (3 KB), the partial
// sums 2 x 12 x 8 x 96 (72 KB), barriers: 222,912 bytes of the 232,448 a
// block may take (so at most 80 rows a cluster, 560 a wave).  A step makes
// 74 x 96 x 384 FMAs an SM: ~21,300 cycles at 128 FMAs a cycle, ~11 us at
// 1.98 GHz, 22 ms at T 2,000 on 112 SMs.  Measured at T 2,000, B 512 on an
// H100 80GB HBM3 at 700 W: 56.6 ms, 28.3 us a step (PERF.md §6 row 5): the
// chunk's barrier, cells and exchange, not the product's FMAs, take half
// of a step.
//
// Sums are plain f32 FMA: no TF32 and no fast-math (expf/tanhf are the
// accurate versions).
#include "cluster.cuh"
#include "recurrence.cuh"

#ifdef LSTM_FWD_CLOCKS
// Step-phase clocks (scripts/bench_lstm.py --clocks builds this source with
// -DLSTM_FWD_CLOCKS into a library of its own): lane 0 of each warp of
// block 0 sums, over the T steps, the SM clock cycles of the product, the
// wait for the peers' h, the block barriers, the cell, and the stores (the
// exchange's arrivals and copies, h_out); then the whole loop.
__device__ long long lstm_fwd_wide_clocks[32 * 8];
#define WIDE_CLOCK(k) PHASE_CLOCK(k)
#else
#define WIDE_CLOCK(k) \
  do {                \
  } while (0)
#endif

namespace {

constexpr int kC = 16;            // blocks a cluster
constexpr int kSC = 24;           // states a block (S <= C SC)
constexpr int kNCol = 4 * kSC;    // gate columns a block, 3 a lane
constexpr int kKG = 32;           // k of a k group, a warp's
constexpr int kGroups = kC * kSC / kKG;           // 12 k groups
constexpr int kThreads = 32 * kGroups;
static_assert(kGroups == 12, "the cell joins three fours of k groups");
constexpr int kRows = 8;          // rows a chunk
constexpr int kSlab = 4 * kRows;  // floats of a k-quad of a chunk's rows
constexpr int kSlice = kSC / 4 * kSlab;   // a block's states of a chunk
constexpr int kChunk = kC * kSlice;       // h of a chunk: [k/4][row][4]
constexpr int kMaxChunks = 12;
constexpr int kBarBytes = 192;    // full[kMaxChunks], empty[kMaxChunks]

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// R: rows a cluster
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_kernel_cluster(const float* __restrict__ xp,
                        const uint8_t* __restrict__ mask,
                        const float* __restrict__ sWT,
                        const float* __restrict__ p,
                        float* __restrict__ h_out, int T, int B, int S,
                        int reverse, int R) {
  extern __shared__ float4 smem4[];
  const int S4 = 4 * S;
  const int nc = (R + kRows - 1) / kRows;            // chunks a step
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);
  uint64_t* empty = full + kMaxChunks;
  float* H = reinterpret_cast<float*>(smem4) + kBarBytes / 4;
  float* Hn = H + nc * kChunk;                       // [2][nc][kSlice]
  float* Cs = Hn + 2 * nc * kSlice;                  // [nc kRows][kSC]
  float* Xs = Cs + nc * kRows * kSC;                 // [kRows kSC][4]
  float* part = Xs + kRows * kSC * 4;        // [2][kGroups][kRows][kNCol]

  const int j = threadIdx.x;
  const int kg = j >> 5, lane = j & 31;              // k group: the warp
  const unsigned rank = cluster_rank();
  const int b0 = (int)(blockIdx.x / kC) * R;
  auto time_of = [&](int step) { return reverse ? T - 1 - step : step; };

  // the lane's columns jb = lane + 32 g (state jb / 4, gate jb % 4: column
  // q S + st) and their weights for k = 32 kg + i
  float w[3][kKG];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    const int jb = lane + 32 * g;
    const int st = (int)rank * kSC + (jb >> 2);
    const int col = (jb & 3) * S + st;
#pragma unroll
    for (int i = 0; i < kKG; ++i) {
      const int k = kKG * kg + i;
      w[g][i] = st < S && k < S ? __ldg(sWT + (size_t)k * S4 + col) : 0.0f;
    }
  }

  // the thread's (row, state) in each chunk's cells (threads 0-191, warps
  // 0-5): row j / SC of the chunk, state s
  const int s = j % kSC;
  const int ss = (int)rank * kSC + s;
  const bool cell = j < kRows * kSC;
  const bool real_s = cell && ss < S;
  float pe0 = 0.0f, pe1 = 0.0f, pe2 = 0.0f;
  if (real_s) {
    pe0 = p[ss];
    pe1 = p[S + ss];
    pe2 = p[2 * S + ss];
  }
  // the block whose barriers and h this thread serves in the exchange:
  // lanes 0-2 of warps 6-11, which have no cell
  const int peer = kg >= 6 && lane < 3 ? 6 * lane + kg - 6 : kC;

  // h_0 = c_0 = 0; padded rows and states stay zero
  for (int i = j; i < nc * (kChunk + 2 * kSlice + kRows * kSC);
       i += kThreads)
    H[i] = 0.0f;
  fence_proxy_async();        // the zeros come before the copies into H
  if (j == 0) {
    for (int i = 0; i < nc; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kC);
    }
    mbar_init_fence();
    if (T > 1)
      for (int i = 0; i < nc; ++i) mbar_expect_tx(&full[i], kC * kSlice * 4);
  }
  cluster_sync();             // every barrier set up before any arrival

  // the copy of the block's slice of chunk i's h_{t+1} into block `peer`
  // once that block has read chunk i of h_t
  auto exchange = [&](int i, int t) {
    if (peer < kC && t < T - 1) {
      mbar_wait_cluster(&empty[i], (unsigned)(t & 1));
      bulk_copy_cluster(map_rank(H + i * kChunk + rank * kSlice, peer),
                        Hn + ((t & 1) * nc + i) * kSlice, kSlice * 4,
                        map_rank(&full[i], peer));
    }
  };

  int pb = 0;                                        // partial-sum buffer
#ifdef LSTM_FWD_CLOCKS
  PHASE_CLOCK_START();
#endif
  for (int t = 0; t < T; ++t) {
    const int time = time_of(t);
    const int par = t & 1;
    for (int i = 0; i < nc; ++i) {
      const int r0 = kRows * i;
      const int rc = min(kRows, R - r0);
      if (t > 0) {
        mbar_wait_cluster(&full[i], (unsigned)((t - 1) & 1));
        if (j == 0 && t < T - 1) mbar_expect_tx(&full[i], kC * kSlice * 4);
      }
      WIDE_CLOCK(1);
      // this chunk's cell inputs, copied under the product
      const int rl = j / kSC;
      const int b = b0 + r0 + rl;
      const bool item = real_s && rl < rc && b < B;
      uint8_t valid = 0;
      if (item) {
        const float* xr = xp + ((size_t)time * B + b) * S4 + ss;
#pragma unroll
        for (int q = 0; q < 4; ++q) cp_async4(Xs + 4 * j + q, xr + q * S);
        cp_async_commit();
        valid = mask[(size_t)time * B + b];
      }

      // the product: 4 rows at a time, k over the warp's k group
      float* pw = part + (pb * kGroups + kg) * kRows * kNCol + lane;
      const int nq = (rc + 3) >> 2;
      for (int rq = 0; rq < nq; ++rq) {
        const float* hq = H + i * kChunk + 8 * kg * kSlab + 16 * rq;
        float acc[3][4];
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) acc[g][rr] = 0.0f;
#pragma unroll
        for (int m = 0; m < kKG / 4; ++m)
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const float4 hv =
                *reinterpret_cast<const float4*>(hq + m * kSlab + 4 * rr);
#pragma unroll
            for (int g = 0; g < 3; ++g) {
              acc[g][rr] = fmaf(hv.x, w[g][4 * m], acc[g][rr]);
              acc[g][rr] = fmaf(hv.y, w[g][4 * m + 1], acc[g][rr]);
              acc[g][rr] = fmaf(hv.z, w[g][4 * m + 2], acc[g][rr]);
              acc[g][rr] = fmaf(hv.w, w[g][4 * m + 3], acc[g][rr]);
            }
          }
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int g = 0; g < 3; ++g)
            pw[(4 * rq + rr) * kNCol + 32 * g] = acc[g][rr];
      }
      WIDE_CLOCK(0);
      __syncthreads();
      WIDE_CLOCK(2);
      // this block has read chunk i of h_t: every block may write it
      if (peer < kC && t < T - 1)
        mbar_arrive_cluster(map_rank(&empty[i], peer));
      if (i > 0) exchange(i - 1, t);
      WIDE_CLOCK(4);

      // the cell of (row r0 + rl, state s): the k groups' sums joined in a
      // fixed order, ((p0 + p1) + (p2 + p3)) + ((p4 + ...) + ...) + ...
      if (cell && rl < rc) {
        const float* pp = part + (pb * kGroups * kRows + rl) * kNCol + 4 * s;
        float4 gs = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 1
        for (int a = 0; a < kGroups / 4; ++a) {
          const float* pa = pp + 4 * a * kRows * kNCol;
          const float4 v0 = *reinterpret_cast<const float4*>(pa);
          const float4 v1 =
              *reinterpret_cast<const float4*>(pa + kRows * kNCol);
          const float4 v2 =
              *reinterpret_cast<const float4*>(pa + 2 * kRows * kNCol);
          const float4 v3 =
              *reinterpret_cast<const float4*>(pa + 3 * kRows * kNCol);
          const float4 four = add4(add4(v0, v1), add4(v2, v3));
          gs = a == 0 ? four : add4(gs, four);
        }
        if (item) {
          cp_async_wait_pending(0);
          gs = add4(gs, *reinterpret_cast<const float4*>(Xs + 4 * j));
        }
        const int ci = (r0 + rl) * kSC + s;
        const int hi = (s >> 2) * kSlab + 4 * rl + (s & 3);
        const float c = Cs[ci];
        const float u = tanhf(gs.x);
        const float ig = sigmoid_f32(gs.y + c * pe0);
        const float f = sigmoid_f32(gs.z + c * pe1);
        const float cn = c * f + u * ig;
        const float o = sigmoid_f32(gs.w + cn * pe2);
        const float hnew = tanhf(cn) * o;
        float h = Hn[((par ^ 1) * nc + i) * kSlice + hi];  // h_t
        if (valid) {
          h = hnew;
          Cs[ci] = cn;
        }
        Hn[(par * nc + i) * kSlice + hi] = h;
        fence_proxy_async();  // the staged h before the copies read it
        WIDE_CLOCK(3);
        if (item) h_out[((size_t)time * B + b) * S + ss] = h;
      }
      WIDE_CLOCK(4);
      pb ^= 1;
    }
    __syncthreads();
    WIDE_CLOCK(2);
    exchange(nc - 1, t);
    WIDE_CLOCK(4);
  }
#ifdef LSTM_FWD_CLOCKS
  clk[7] = PHASE_CLOCK_TOTAL();
  if (blockIdx.x == 0 && lane == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) lstm_fwd_wide_clocks[kg * 8 + k] = clk[k];
  }
#endif
  cluster_sync();   // no block leaves while a copy or arrival may reach it
}

// the shared-memory bytes of R rows a cluster
int smem_bytes(int R) {
  const int Rp = (R + kRows - 1) / kRows * kRows;
  return kBarBytes + 4 * (Rp * kSC * (kC + 3) + kRows * kSC * 4 +
                          2 * kGroups * kRows * kNCol);
}

cudaError_t configure(int smem, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* cluster) {
  const void* kernel = (const void*)lstm_fwd_kernel_cluster;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = kC;
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->attrs = cluster;
  cfg->numAttrs = 1;
  return e;
}

}  // namespace

// The launch plan comes from the caller (nn/fused_lstm.py::lstm_fwd_plan):
// rows a cluster, clusters, smem bytes.  Returns the cudaError_t of the
// launch.
extern "C" int lstm_fwd_wide(const void* xp, const void* mask,
                             const void* sWT, const void* p, void* h_out,
                             int T, int B, int S, int reverse, int rows,
                             int clusters, int smem, void* stream) {
  if (S < 1 || S > kC * kSC || T < 1 || B < 1 || rows < 1 ||
      rows > kMaxChunks * kRows || (long long)rows * clusters < B ||
      (long long)rows * (clusters - 1) >= B || smem < smem_bytes(rows))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cluster[1];
  cudaError_t e = configure(smem, &cfg, cluster);
  if (e != cudaSuccess) return (int)e;
  cfg.gridDim = dim3(clusters * kC, 1, 1);
  cfg.stream = (cudaStream_t)stream;
  void* args[] = {(void*)&xp, (void*)&mask, (void*)&sWT, (void*)&p,
                  &h_out,     &T,           &B,           &S,
                  &reverse,   &rows};
  e = cudaLaunchKernelExC(&cfg, (const void*)lstm_fwd_kernel_cluster, args);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The clusters of 16 blocks (smem bytes a block) that the device runs at
// once, into *clusters.  Returns the cudaError_t.
extern "C" int lstm_fwd_wide_clusters(int smem, int* clusters) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cluster[1];
  const cudaError_t e = configure(smem, &cfg, cluster);
  if (e != cudaSuccess) return (int)e;
  cfg.gridDim = dim3(kC, 1, 1);
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, (const void*)lstm_fwd_kernel_cluster, &cfg);
}

#ifdef LSTM_FWD_CLOCKS
// copy the step-phase clocks of the last launch, [warp][8], to host memory
extern "C" int lstm_fwd_wide_clocks_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, lstm_fwd_wide_clocks,
                                   sizeof(lstm_fwd_wide_clocks));
}
#endif
