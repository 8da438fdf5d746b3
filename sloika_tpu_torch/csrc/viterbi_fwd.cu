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
//
// Design.  One block per batch row, K/4 threads: thread r owns step group r,
// i.e. the 4 destinations 4r..4r+3, which share one step and one skip
// decision.  The K scores are double-buffered in shared memory (2 x 4 KB at
// K = 1024), so one __syncthreads() per step separates the reads of step t
// from the writes of step t+1.  The next row of the posterior is loaded into
// registers before the current step's reductions, so its latency hides
// behind them.
//
// What bounds it.  Per step a row reads K+1 floats of posterior and writes K
// bytes of traceback: 5 bytes per state, streamed once, against ~30
// instructions per thread (the 20 shared-memory reads of the reductions and
// 5 logf).  At the batch sizes of basecalling the rows run side by side and
// each block's per-step latency bounds the kernel: 2.4 ms for T = 3277 at
// B = 64 on an H100 is 0.7 us a step.  logf is the accurate one (no
// fast-math), the same PyTorch's torch.log calls on the GPU, so the plain
// twin agrees bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEta = 1e-10f;

__global__ void viterbi_fwd_kernel(const float* __restrict__ post,
                                   int8_t* __restrict__ tb,
                                   float* __restrict__ vfinal,
                                   int T, int B, int K, float skip_pen) {
  extern __shared__ float4 smem4[];
  float* cur = reinterpret_cast<float*>(smem4);   // [K] scores at t-1
  float* nxt = cur + K;                           // [K] scores at t
  const int b = blockIdx.x;
  const int r = threadIdx.x;           // step group; destinations 4r..4r+3
  const int nrem_step = K >> 2;
  const int nrem_skip = K >> 4;
  const int s = r >> 2;                // skip group
  const size_t nst = (size_t)K + 1;

  const float* row = post + (size_t)b * nst;              // t = 0
  float4 v0;
  v0.x = logf(row[1 + 4 * r] + kEta);
  v0.y = logf(row[2 + 4 * r] + kEta);
  v0.z = logf(row[3 + 4 * r] + kEta);
  v0.w = logf(row[4 + 4 * r] + kEta);
  reinterpret_cast<float4*>(cur)[r] = v0;
  reinterpret_cast<char4*>(tb + (size_t)b * K)[r] = make_char4(-1, -1, -1, -1);

  // raw posterior of the step to come: stay + the thread's 4 kmers
  float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f, p4 = 0.0f;
  if (T > 1) {
    row = post + ((size_t)B + b) * nst;
    p0 = row[0];
    p1 = row[1 + 4 * r];
    p2 = row[2 + 4 * r];
    p3 = row[3 + 4 * r];
    p4 = row[4 + 4 * r];
  }
  __syncthreads();

  for (int t = 1; t < T; ++t) {
    const float lps = logf(p0 + kEta);
    const float l1 = logf(p1 + kEta), l2 = logf(p2 + kEta);
    const float l3 = logf(p3 + kEta), l4 = logf(p4 + kEta);
    if (t + 1 < T) {                   // prefetch row t+1
      row = post + ((size_t)(t + 1) * B + b) * nst;
      p0 = row[0];
      p1 = row[1 + 4 * r];
      p2 = row[2 + 4 * r];
      p3 = row[3 + 4 * r];
      p4 = row[4 + 4 * r];
    }

    float mx = cur[r];
    int am = 0;
#pragma unroll
    for (int g = 1; g < 4; ++g) {
      const float c = cur[g * nrem_step + r];
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

    const float4 old = reinterpret_cast<const float4*>(cur)[r];
    float4 sc;
    char4 cd;
    float nw, st;
    nw = l1 + m; st = old.x + lps;
    cd.x = (signed char)(nw > st ? code : -1); sc.x = nw > st ? nw : st;
    nw = l2 + m; st = old.y + lps;
    cd.y = (signed char)(nw > st ? code : -1); sc.y = nw > st ? nw : st;
    nw = l3 + m; st = old.z + lps;
    cd.z = (signed char)(nw > st ? code : -1); sc.z = nw > st ? nw : st;
    nw = l4 + m; st = old.w + lps;
    cd.w = (signed char)(nw > st ? code : -1); sc.w = nw > st ? nw : st;
    reinterpret_cast<float4*>(nxt)[r] = sc;
    reinterpret_cast<char4*>(tb + ((size_t)t * B + b) * K)[r] = cd;

    __syncthreads();
    float* tmp = cur; cur = nxt; nxt = tmp;
  }
  reinterpret_cast<float4*>(vfinal + (size_t)b * K)[r] =
      reinterpret_cast<const float4*>(cur)[r];
}

}  // namespace

extern "C" int viterbi_fwd(const void* post, void* tb, void* vfinal, int T,
                           int B, int K, float skip_pen, void* stream) {
  const int threads = K / 4;
  const size_t smem = 2 * (size_t)K * sizeof(float);
  viterbi_fwd_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)post, (int8_t*)tb, (float*)vfinal, T, B, K, skip_pen);
  return (int)cudaGetLastError();
}
