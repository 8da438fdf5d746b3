// The transducer Viterbi step without skips, with parts of the DP removed:
// a probe of viterbi_fwd.cu for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of scripts/bench_viterbi_parts.py::
// run_variant (make_kernel :19-94, pl.pallas_call :107): eight variants of
// one step over a probability-domain posterior post (T, B, K) f32 and a stay
// probability stay (T, B, 1) f32, writing traceback codes tb (T, B, K) int8.
// At t = 0 every variant sets the scores to the raw post[0] (not its log) and
// tb[0] to 0.  At t > 0, with p the scores of t - 1, lk = logf(post + 1e-10)
// and ls = logf(stay + 1e-10):
//
//   noop      tb = 0; the posterior and stay rows are still read
//   nolog     scores = p + stay;        tb = (int8) post    (truncation)
//   f32store  scores = (p + ls) + lk;   tb = 0
//   copy      scores = p + ls;          tb = (int8) lk      (truncation)
//   maxstay   new = lk + p, stay = p + ls: tb = new > stay ? 1 : -1,
//             scores = max(new, stay)
//   reduce    as full, but destination k takes the group max of k mod K/4
//             (the TPU's "wrong math, same volume" broadcast)
//   full      destination k takes mx = max over g = 0..3 of p[g K/4 + k/4],
//             the first wins (strict >), code g; new = lk + mx;
//             tb = new > stay ? g : -1 (a stay wins a tie); scores = max
//
// The TPU's "expand" differs from "full" only by its exact one-hot matmul
// (a TPU workaround); on the card the expansion is the index k / 4, so
// "expand" runs this kernel's full variant.  The Pallas kernel never writes
// its final-score output; this one writes the final scores to vf (B, K).
//
// Design.  viterbi_fwd.cu's "single" route, which its plan takes at the
// probe's shape (B = 128 rows, more than the card's clusters of two blocks;
// scripts/bench_viterbi_parts.py::viterbi_parts_plan), so that the
// differences between variants price that kernel's parts: one block a batch
// row, K/4 threads, thread r owns destinations 4r..4r+3, whose step
// predecessors are g K/4 + r.  Frame t's posterior row (K floats, 16-byte
// aligned, no stay column) comes into a ring of nslots shared-memory slots
// by one thread's bulk copy on the slot's mbarrier (viterbi_ring.cuh's
// fill, as viterbi_fwd.cu's ring), and its stay as the 16-byte unit of the
// (T, B, 1) array that holds it, a second copy on the same barrier: every
// byte a step reads arrives by one protocol, where a stay loaded into a
// register a step ahead would hold the refilling thread's warp on a
// device-memory load, and one stored to shared memory would need a deeper
// ring for its store to be seen.  A unit past the array's storage (its last
// rows) is not copied: that stay is read from device memory.  A wait
// tests the slot's barrier first.  The K scores are double-buffered in
// shared memory with one __syncthreads() a step in every variant, after
// which thread 0 refills the frame's slot with frame t + nslots.  The
// variant is a template parameter, so each one compiles to its own loop.
//
// What bounds it.  Each step reads 4 K + 4 bytes of a row and writes K
// bytes: 2.15 GB at B = 128, T = 3,277, K = 1,024, 0.64 ms at 3.35 TB/s.
// At that batch the rows run side by side, one block an SM, so the latency
// of one block's step (the barrier, the logf and the shared-memory
// reductions, with the rows already in shared memory) sets the time; the
// variants split it.  logf is the accurate one (no fast-math), the one
// torch.log calls on the card, so the plain twin agrees bit for bit.
#include "viterbi_ring.cuh"

namespace {

constexpr int kBarBytes = 128;     // the slots' full mbarriers
constexpr int kMaxSlots = 16;

enum Variant { kNoop = 0, kNolog, kF32store, kCopy, kMaxstay, kReduce, kFull };

__device__ __forceinline__ signed char trunc8(float x) {
  return (signed char)__float2int_rz(x);
}

// code and score of one destination from its step candidate and its stay
__device__ __forceinline__ void choose(float nw, float st, int code,
                                       signed char& cd, float& sc) {
  cd = (signed char)(nw > st ? code : -1);
  sc = nw > st ? nw : st;
}

// the first-wins max over g = 0..3 of cur[g * nrem + i], and its g
__device__ __forceinline__ float group_max(const float* cur, int nrem, int i,
                                           int& am) {
  float mx = cur[i];
  am = 0;
#pragma unroll
  for (int g = 1; g < 4; ++g) {
    const float c = cur[g * nrem + i];
    if (c > mx) { mx = c; am = g; }
  }
  return mx;
}

template <int V>
__global__ void __launch_bounds__(1024, 1)
viterbi_parts_kernel(const float* __restrict__ post,
                     const float* __restrict__ stay, int8_t* __restrict__ tb,
                     float* __restrict__ vf, int T, int B, int K, int nslots,
                     unsigned long long stay_end) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);        // [nslots]
  float* ring = reinterpret_cast<float*>(smem + kBarBytes);  // [nslots][slot]
  const int slot_floats = 4 + K;        // the stay's unit, then the row
  float* cur = ring + (size_t)nslots * slot_floats;  // [K] scores at t-1
  float* nxt = cur + K;                              // [K] scores at t
  const int b = blockIdx.x;
  const int r = threadIdx.x;        // destinations 4r..4r+3
  const int nrem = K >> 2;
  // frame t's stay unit and row into slot k (the row is whole 16-byte
  // units, so its superset is itself)
  auto refill = [&](int t, int k) {
    float* slot = ring + (size_t)k * slot_floats;
    fill(stay + (size_t)t * B + b, 1, stay_end, slot, &full[k]);
    fill(post + ((size_t)t * B + b) * K, K, ~0ull, slot + 4, &full[k]);
  };
  if (r == 0) {
    for (int k = 0; k < nslots; ++k) mbar_init(&full[k], 2);
    mbar_init_fence();
    for (int k = 0; k < nslots && 1 + k < T; ++k) refill(1 + k, k);
  }
  reinterpret_cast<float4*>(cur)[r] =
      reinterpret_cast<const float4*>(post + (size_t)b * K)[r];
  reinterpret_cast<char4*>(tb + (size_t)b * K)[r] = make_char4(0, 0, 0, 0);
  float sink = 0.0f;                // keeps noop's reads
  __syncthreads();

  int slot = 0;
  unsigned phase = 0;
  for (int t = 1; t < T; ++t) {
    mbar_wait_tested(&full[slot], phase);
    const float* sl = ring + (size_t)slot * slot_floats;
    const float* sp = stay + (size_t)t * B + b;
    const float4 q = reinterpret_cast<const float4*>(sl + 4)[r];
    const float qs = in_storage(sp, 1, stay_end) ? sl[superset_offset(sp)]
                                                : *sp;
    char4 cd = make_char4(0, 0, 0, 0);
    float4 sc;
    const float4 old = reinterpret_cast<const float4*>(cur)[r];
    if constexpr (V == kNoop) {
      sink += q.x + q.y + q.z + q.w + qs;
    } else if constexpr (V == kNolog) {
      sc = make_float4(old.x + qs, old.y + qs, old.z + qs, old.w + qs);
      cd = make_char4(trunc8(q.x), trunc8(q.y), trunc8(q.z), trunc8(q.w));
    } else {
      const float ls = logf(qs + kEta);
      const float4 lk = make_float4(logf(q.x + kEta), logf(q.y + kEta),
                                    logf(q.z + kEta), logf(q.w + kEta));
      if constexpr (V == kF32store) {
        sc = make_float4((old.x + ls) + lk.x, (old.y + ls) + lk.y,
                         (old.z + ls) + lk.z, (old.w + ls) + lk.w);
      } else if constexpr (V == kCopy) {
        sc = make_float4(old.x + ls, old.y + ls, old.z + ls, old.w + ls);
        cd = make_char4(trunc8(lk.x), trunc8(lk.y), trunc8(lk.z),
                        trunc8(lk.w));
      } else if constexpr (V == kMaxstay) {
        choose(lk.x + old.x, old.x + ls, 1, cd.x, sc.x);
        choose(lk.y + old.y, old.y + ls, 1, cd.y, sc.y);
        choose(lk.z + old.z, old.z + ls, 1, cd.z, sc.z);
        choose(lk.w + old.w, old.w + ls, 1, cd.w, sc.w);
      } else if constexpr (V == kReduce) {
        int a0, a1, a2, a3;
        const float m0 = group_max(cur, nrem, (4 * r) % nrem, a0);
        const float m1 = group_max(cur, nrem, (4 * r + 1) % nrem, a1);
        const float m2 = group_max(cur, nrem, (4 * r + 2) % nrem, a2);
        const float m3 = group_max(cur, nrem, (4 * r + 3) % nrem, a3);
        choose(lk.x + m0, old.x + ls, a0, cd.x, sc.x);
        choose(lk.y + m1, old.y + ls, a1, cd.y, sc.y);
        choose(lk.z + m2, old.z + ls, a2, cd.z, sc.z);
        choose(lk.w + m3, old.w + ls, a3, cd.w, sc.w);
      } else {
        int am;
        const float mx = group_max(cur, nrem, r, am);
        choose(lk.x + mx, old.x + ls, am, cd.x, sc.x);
        choose(lk.y + mx, old.y + ls, am, cd.y, sc.y);
        choose(lk.z + mx, old.z + ls, am, cd.z, sc.z);
        choose(lk.w + mx, old.w + ls, am, cd.w, sc.w);
      }
    }
    if constexpr (V != kNoop) reinterpret_cast<float4*>(nxt)[r] = sc;
    reinterpret_cast<char4*>(tb + ((size_t)t * B + b) * K)[r] = cd;

    __syncthreads();
    // every thread has read frame t: its slot takes frame t + nslots
    if (r == 0 && t + nslots < T) refill(t + nslots, slot);
    if (++slot == nslots) {
      slot = 0;
      phase ^= 1u;
    }
    if constexpr (V != kNoop) {
      float* tmp = cur; cur = nxt; nxt = tmp;
    }
  }
  reinterpret_cast<float4*>(vf + (size_t)b * K)[r] =
      reinterpret_cast<const float4*>(cur)[r];
  // a NaN payload no sum of floats makes: never true, but the compiler
  // cannot drop noop's loads
  if (__float_as_uint(sink) == 0xffffffffu) vf[(size_t)b * K] = sink;
}

template <int V>
int launch(const void* post, const void* stay, void* tb, void* vf, int T,
           int B, int K, int nslots, int smem, unsigned long long stay_end,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        viterbi_parts_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  viterbi_parts_kernel<V><<<B, K / 4, smem, stream>>>(
      (const float*)post, (const float*)stay, (int8_t*)tb, (float*)vf, T, B,
      K, nslots, stay_end);
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 noop, 1 nolog, 2 f32store, 3 copy, 4 maxstay, 5 reduce, 6 full.
// post (T, B, K) f32, 16-byte aligned, K a multiple of 4 in 4..4096; stay
// (T, B, 1) f32, whose storage ends at stay_end; a ring of nslots (2-16)
// slots of 16 + 4 K bytes and the scores (8 K bytes) in smem bytes, from
// scripts/bench_viterbi_parts.py::viterbi_parts_plan.  Returns the
// cudaError_t of the launch; cudaErrorInvalidValue (1) for a plan that does
// not fit.
extern "C" int viterbi_parts(int variant, const void* post, const void* stay,
                             void* tb, void* vf, int T, int B, int K,
                             int nslots, int smem,
                             unsigned long long stay_end, void* stream) {
  if (T < 1 || B < 1 || K < 4 || K > 4096 || K % 4 || (uintptr_t)post % 16 ||
      nslots < 2 || nslots > kMaxSlots ||
      (size_t)smem < kBarBytes + (size_t)nslots * (16 + 4 * (size_t)K) +
                         8 * (size_t)K)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define PARTS_LAUNCH(V) \
  launch<V>(post, stay, tb, vf, T, B, K, nslots, smem, stay_end, s)
  switch (variant) {
    case kNoop: return PARTS_LAUNCH(kNoop);
    case kNolog: return PARTS_LAUNCH(kNolog);
    case kF32store: return PARTS_LAUNCH(kF32store);
    case kCopy: return PARTS_LAUNCH(kCopy);
    case kMaxstay: return PARTS_LAUNCH(kMaxstay);
    case kReduce: return PARTS_LAUNCH(kReduce);
    case kFull: return PARTS_LAUNCH(kFull);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PARTS_LAUNCH
}
