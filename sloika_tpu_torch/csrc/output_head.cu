// The basecaller's output head for Hopper (sm_90a): projection, softmax,
// min_prob floor, pad mask and cast in one kernel.
//
// It replaces no Pallas kernel: the JAX package leaves the head to XLA
// (sloika_tpu/basecall.py:274-289), and the port ran it as a cuBLAS
// product and ten elementwise passes over the posterior
// (nn/layers.py::Softmax.forward, then basecall.py::Basecaller._floor_mask).
// For each frame row n of the last hidden layer's output x (N = T * B rows
// of I floats) it writes, in the posterior's dtype,
//
//     p     = softmax(x[n] . W^T + b)            (max-shifted, over K states)
//     post  = (1 - min_prob) * p + min_prob      (two roundings, as PyTorch's)
//     post  = one-hot stay (1 at state 0)        (frames t >= out_lengths[b])
//
// into post (T, B, K) contiguous, once.  Nothing posterior-sized is read.
//
// What bounds it.  2 I K float32 operations a row against 4 K bytes written
// (2 K in bfloat16): at I = 112, K = 1,025 that is 56 flop a byte, above
// the card's 20 (67 TFLOP/s over 3.35 TB/s), so the product bounds it.
// The configuration is float32 with TF32 off, so the product runs as FMAs
// on the CUDA cores.  Two things stand between the FMAs and that bound
// (PERF.md §6 splits a block's cycles): every block streams all of W
// (459 KB at K = 1,025) through shared memory, and one block an SM runs
// its phases in turn, so the stream's waits and the softmax's exp and true
// divide (~30 instructions a state) add to the product's time.  The
// design:
//
// - A block owns R = 32 rows and every state.  Its rows of x sit in shared
//   memory, row-major with a stride of Ip + 4 floats (Ip: I rounded up to a
//   stage's depth), so a warp's four row groups read four distinct bank
//   quads.
// - W^T (Ip, Kp) streams through a ring of NSTG slots of BK rows by a
//   window of 512 states, filled by bulk copies that one producer warp
//   issues (a row segment a lane) and that complete on the slot's "full"
//   mbarrier; the consumer warps release a slot on its "empty" mbarrier.
//   So the eight consumer warps issue no load of W and never wait on the
//   memory system's queues, and a slot lands while they compute on the
//   other.
// - A consumer warp owns 64 states of a window: each thread 8 rows x 8
//   states (rows g, g + 4, ..., columns 4c..4c+3 and 32+4c..32+4c+3), 64
//   FMAs for 4 16-byte shared loads, each row's sum over k in order.  The
//   states past the last whole 64 (1 at K = 4^k + 1) are summed by one warp
//   a state, a lane a row, in the same order, from their columns of W^T,
//   which the block stages in shared memory with its rows of x.
// - "stash" route (R K floats fit in shared memory, K up to 1,152): the
//   logits of the 32 rows stay on chip; then each consumer warp takes two
//   rows at once, each row's states in registers (36 a lane): their max
//   and sum by halves, exp(l - max), and the floored quotient written
//   once, one coalesced row segment a store instruction.
// - "recompute" route (larger K: 3,126 at nbase 5, 4,097 at klen 6): the
//   product runs twice over windows of 512 states; the first sweep keeps a
//   running max and sum a row, the second recomputes each window and writes
//   it.  The route is chosen by K alone (the host plan,
//   ops/output_head.py::output_head_plan).
// - A block whose rows are all padding skips the product.
//
// The arithmetic is PyTorch's: FMAs in float32 (under bfloat16 compute, x
// and W rounded to bfloat16 first, their products exact), + b after the
// sum, accurate expf, a true float32 divide, __fmul_rn/__fadd_rn so that
// the floor's two roundings are not contracted into one FMA, and the cast
// to the posterior's dtype at the store.  Only the product's and the
// row sum's orders of summation differ from cuBLAS's and PyTorch's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int R = 32;           // rows a block (a lane a row in places)
constexpr int NCW = 8;          // consumer warps; warp NCW is the producer
constexpr int NC = 32 * NCW;    // consumer threads
constexpr int NT = NC + 32;     // threads a block
constexpr int WN = 64;          // states a consumer warp's tile
constexpr int BN = NCW * WN;    // states a window
constexpr int BK = 16;          // rows of W^T a slot
constexpr int NSTG = 2;         // slots of the ring (deeper rings of
                                // shallower slots measured slower)
constexpr int BAR_BYTES = 128;  // the ring's mbarriers, ahead of the rest
constexpr int VMAX = 36;        // a stash row's states a lane at most

struct Args {
  const float* x;      // (N, I)
  const float* wt;     // (Ip, Kp): W^T, zero past I and K
  const float* b;      // (K,)
  const long long* lengths;  // (B,) frames of each batch row
  void* out;           // (N, K)
  long long N;
  int B, I, Ip, K, Kp, Kmain, stash, round_bf16;
  float min_prob, keep;  // keep = float32(1 - min_prob)
};

__device__ __forceinline__ float rnd(float v, int round_bf16) {
  return round_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <typename OutT>
__device__ __forceinline__ OutT cast_out(float v);
template <>
__device__ __forceinline__ float cast_out<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the consumer warps' own barrier (the producer runs ahead)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
}

// the floored posterior of one softmax value
__device__ __forceinline__ float floor_of(float p, const Args& a) {
  return __fadd_rn(__fmul_rn(a.keep, p), a.min_prob);
}

// logits of states [Kmain, K) into L (column c at L + r Ls + c - cbase),
// from their columns of W^T staged in wr (a state's Ip rows together): a
// warp a state, a lane a row, the sum over k in order as in the tiles
__device__ void remainder_states(float* L, int Ls, int cbase, const float* xs,
                                 int Xs, const float* wr, const Args& a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = a.Kmain + warp; c < a.K; c += NCW) {
    float acc = 0.0f;
    const float* xr = xs + lane * Xs;
    const float* wc = wr + (c - a.Kmain) * a.Ip;
    for (int k = 0; k < a.I; ++k) acc = fmaf(xr[k], wc[k], acc);
    L[lane * Ls + c - cbase] = acc + __ldg(a.b + c);
  }
}

// the one-hot stay over states [c0, c1) of row n
template <typename OutT>
__device__ __forceinline__ void write_stay(OutT* out, long long n, int c0,
                                           int c1, int K) {
  OutT* o = out + (size_t)n * K;
  for (int c = c0 + (threadIdx.x & 31); c < c1; c += 32)
    o[c] = cast_out<OutT>(c == 0 ? 1.0f : 0.0f);
}

// the recompute route's sweep over one window's states [c0, c0 + width) of
// the block's rows, a warp a row: pass 0 folds them into the running max
// and sum, pass 1 writes them
template <typename OutT>
__device__ void window_rows(const float* L, int Ls, int c0, int width,
                            int pass, float* rmax, float* rsum,
                            const int* rvalid, OutT* out, long long r0,
                            int nrows, const Args& a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < nrows; r += NCW) {
    const float* lr = L + r * Ls;
    if (!rvalid[r]) {
      if (pass == 1) write_stay(out, r0 + r, c0, c0 + width, a.K);
      continue;
    }
    if (pass == 0) {
      float m = -INFINITY;
      for (int c = lane; c < width; c += 32) m = fmaxf(m, lr[c]);
      m = fmaxf(warp_max(m), rmax[r]);
      float e = 0.0f;
      for (int c = lane; c < width; c += 32) e += expf(lr[c] - m);
      e = warp_sum(e);
      if (lane == 0) {
        rsum[r] = rsum[r] * expf(rmax[r] - m) + e;
        rmax[r] = m;
      }
    } else {
      const float m = rmax[r], sum = rsum[r];
      OutT* o = out + (size_t)(r0 + r) * a.K + c0;
      for (int c = lane; c < width; c += 32)
        o[c] = cast_out<OutT>(floor_of(expf(lr[c] - m) / sum, a));
    }
  }
}

// the largest (sum) of v[0..n) by halves
template <int n>
__device__ __forceinline__ float tree_max(const float* v) {
  if constexpr (n == 1) {
    return v[0];
  } else {
    return fmaxf(tree_max<n / 2>(v), tree_max<n - n / 2>(v + n / 2));
  }
}
template <int n>
__device__ __forceinline__ float tree_sum(const float* v) {
  if constexpr (n == 1) {
    return v[0];
  } else {
    return tree_sum<n / 2>(v) + tree_sum<n - n / 2>(v + n / 2);
  }
}

// the stash route's last sweep over two rows' logits l0, l1 (valid 1, pad
// 0, absent -1) into o0, o1
template <typename OutT>
__device__ __forceinline__ void stash_rows(const float* l0, const float* l1,
                                           int v0, int v1, OutT* o0, OutT* o1,
                                           const Args& a) {
  const int lane = threadIdx.x & 31;
  float e0[VMAX], e1[VMAX];
#pragma unroll
  for (int q = 0; q < VMAX; ++q) {
    const int c = lane + 32 * q;
    const bool in = c < a.K;
    e0[q] = in ? l0[c] : -INFINITY;
    e1[q] = in ? l1[c] : -INFINITY;
  }
  const float m0 = warp_max(tree_max<VMAX>(e0));
  const float m1 = warp_max(tree_max<VMAX>(e1));
#pragma unroll
  for (int q = 0; q < VMAX; ++q) {
    e0[q] = expf(e0[q] - m0);
    e1[q] = expf(e1[q] - m1);
  }
  const float s0 = warp_sum(tree_sum<VMAX>(e0));
  const float s1 = warp_sum(tree_sum<VMAX>(e1));
#pragma unroll
  for (int q = 0; q < VMAX; ++q) {
    const int c = lane + 32 * q;
    if (c < a.K) {
      const float stay = c == 0 ? 1.0f : 0.0f;
      o0[c] = cast_out<OutT>(v0 ? floor_of(e0[q] / s0, a) : stay);
      if (v1 >= 0) o1[c] = cast_out<OutT>(v1 ? floor_of(e1[q] / s1, a) : stay);
    }
  }
}

template <typename OutT>
__global__ void __launch_bounds__(NT, 1) output_head_kernel(Args a) {
  extern __shared__ float4 smem4[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);
  uint64_t* empty = full + NSTG;
  float* sm = reinterpret_cast<float*>(smem4) + BAR_BYTES / 4;
  const int Xs = a.Ip + 4;
  const int Ls = a.stash ? a.K : BN + 1;
  float* xs = sm;                      // R x Xs
  float* ws = xs + R * Xs;             // NSTG x BK x BN
  float* L = ws + NSTG * BK * BN;      // R x Ls
  float* rmax = L + R * Ls;            // R
  float* rsum = rmax + R;              // R
  int* rvalid = reinterpret_cast<int*>(rsum + R);  // R
  float* wr = reinterpret_cast<float*>(rvalid + R);  // (K - Kmain) x Ip
  OutT* out = reinterpret_cast<OutT*>(a.out);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r0 = (long long)blockIdx.x * R;
  const int nrows = (int)min((long long)R, a.N - r0);

  int v = 0;
  if (tid < R) {
    if (tid < nrows) {
      const long long n = r0 + tid, t = n / a.B;
      v = t < a.lengths[n - t * a.B];
    }
    rvalid[tid] = v;
    rmax[tid] = -INFINITY;
    rsum[tid] = 0.0f;
  }
  if (tid == 0) {
    for (int s = 0; s < NSTG; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCW);
    }
    mbar_init_fence();
  }
  if (!__syncthreads_or(v)) {
    for (int r = warp; r < nrows; r += NCW + 1)
      write_stay(out, r0 + r, 0, a.K, a.K);
    return;
  }

  // x's rows, rounded where the product takes bfloat16; zeros past I and
  // past the last row
  if (a.I % 4 == 0 && (uintptr_t)a.x % 16 == 0) {
    const int q4 = Xs / 4;
    for (int q = tid; q < R * q4; q += NT) {
      const int r = q / q4, k = (q - r * q4) * 4;
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nrows && k < a.I) {
        f = *reinterpret_cast<const float4*>(a.x + (size_t)(r0 + r) * a.I + k);
        f.x = rnd(f.x, a.round_bf16);
        f.y = rnd(f.y, a.round_bf16);
        f.z = rnd(f.z, a.round_bf16);
        f.w = rnd(f.w, a.round_bf16);
      }
      *reinterpret_cast<float4*>(xs + r * Xs + k) = f;
    }
  } else {
    for (int q = tid; q < R * Xs; q += NT) {
      const int r = q / Xs, k = q - r * Xs;
      xs[q] = r < nrows && k < a.I
                  ? rnd(a.x[(size_t)(r0 + r) * a.I + k], a.round_bf16)
                  : 0.0f;
    }
  }
  // the columns of W^T past the whole tiles
  for (int q = tid; q < (a.K - a.Kmain) * a.Ip; q += NT) {
    const int c = q / a.Ip, k = q - c * a.Ip;
    wr[q] = __ldg(a.wt + (size_t)k * a.Kp + a.Kmain + c);
  }
  __syncthreads();

  const int nk = a.Ip / BK;
  const int nwin = (a.Kmain + BN - 1) / BN;
  const int S = nwin * nk;                  // stages a pass
  const int npass = a.stash ? 1 : 2;

  if (warp == NCW) {
    // the producer: stage i (of every pass in turn) into slot i % NSTG once
    // the consumers have released the slot's stage i - NSTG
    for (int i = 0; i < npass * S; ++i) {
      const int slot = i % NSTG, s = i % S;
      if (i >= NSTG) mbar_wait(&empty[slot], ((i / NSTG) - 1) & 1);
      const int w = s / nk, kc = s - w * nk;
      const int c0 = w * BN, width = min(BN, a.Kmain - c0);
      if (lane == 0) mbar_expect_tx(&full[slot], BK * width * 4);
      __syncwarp();
      if (lane < BK)
        bulk_copy(ws + (slot * BK + lane) * BN,
                  a.wt + (size_t)(kc * BK + lane) * a.Kp + c0, width * 4,
                  &full[slot]);
    }
    return;
  }

  const int rg = lane >> 3, cg = lane & 7;   // 4 row groups x 8 state groups
  int i = 0;                                 // stages consumed
  for (int pass = 0; pass < npass; ++pass) {
    float acc[8][8];
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[p][j] = 0.0f;

    for (int s = 0; s < S; ++s, ++i) {
      const int slot = i % NSTG;
      const int w = s / nk, kc = s - w * nk;
      const int c0 = w * BN, width = min(BN, a.Kmain - c0);
      const bool active = warp * WN < width;
      mbar_wait(&full[slot], (i / NSTG) & 1);
      if (active) {
        const float* xb = xs + rg * Xs + kc * BK;
        const float* wb = ws + slot * BK * BN + warp * WN + cg * 4;
#pragma unroll
        for (int k4 = 0; k4 < BK / 4; ++k4) {
          float4 xv[8];
#pragma unroll
          for (int p = 0; p < 8; ++p)
            xv[p] = *reinterpret_cast<const float4*>(xb + 4 * p * Xs + 4 * k4);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float* wk = wb + (4 * k4 + kk) * BN;
            const float4 w0 = *reinterpret_cast<const float4*>(wk);
            const float4 w1 = *reinterpret_cast<const float4*>(wk + 32);
            const float wv[8] = {w0.x, w0.y, w0.z, w0.w,
                                 w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int p = 0; p < 8; ++p) {
              const float xk = kk == 0   ? xv[p].x
                               : kk == 1 ? xv[p].y
                               : kk == 2 ? xv[p].z
                                         : xv[p].w;
#pragma unroll
              for (int j = 0; j < 8; ++j)
                acc[p][j] = fmaf(xk, wv[j], acc[p][j]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      if (kc == nk - 1) {
        // the window's logits (+ b) into L; its states keep their columns
        // in the stash route, and start at column 0 in the other
        if (active) {
          const int cw = c0 + warp * WN + cg * 4;
          const int cl = a.stash ? cw : cw - c0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int dc = (j & 3) + (j >> 2) * 32;
            const float bj = __ldg(a.b + cw + dc);
#pragma unroll
            for (int p = 0; p < 8; ++p) {
              L[(rg + 4 * p) * Ls + cl + dc] = acc[p][j] + bj;
              acc[p][j] = 0.0f;
            }
          }
        }
        if (!a.stash) {
          consumers_sync();
          window_rows(L, Ls, c0, width, pass, rmax, rsum, rvalid, out, r0,
                      nrows, a);
          consumers_sync();
        }
      }
    }

    if (a.Kmain < a.K) {
      // the states past the last whole tile
      if (a.stash) {
        remainder_states(L, Ls, 0, xs, Xs, wr, a);
      } else {
        remainder_states(L, Ls, a.Kmain, xs, Xs, wr, a);
        consumers_sync();
        window_rows(L, Ls, a.Kmain, a.K - a.Kmain, pass, rmax, rsum, rvalid,
                    out, r0, nrows, a);
        consumers_sync();
      }
    }
  }
  if (!a.stash) return;

  consumers_sync();
  // two rows a warp at once, each row's states in registers (VMAX a lane):
  // max, exp and sum, and the floored quotient written once
  for (int r = warp; r < nrows; r += 2 * NCW)
    stash_rows<OutT>(L + r * Ls, r + NCW < nrows ? L + (r + NCW) * Ls : L,
                     rvalid[r], r + NCW < nrows ? rvalid[r + NCW] : -1,
                     out + (size_t)(r0 + r) * a.K,
                     out + (size_t)(r0 + r + NCW) * a.K, a);
}

template <typename OutT>
int launch(const Args& a, int smem, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      output_head_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (a.N + R - 1) / R;
  output_head_kernel<OutT><<<(unsigned)blocks, NT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan comes from the caller (ops/output_head.py::output_head_plan):
// Ip, Kp (W^T's padded shape), Kmain (the states of whole warp tiles),
// stash (1: the logits stay in shared memory) and smem bytes.  out_bf16
// picks the posterior's dtype (0 float32, 1 bfloat16).
extern "C" int output_head(const void* x, const void* wt, const void* b,
                           const void* lengths, void* out, long long N, int B,
                           int I, int Ip, int K, int Kp, int Kmain, int stash,
                           int round_bf16, int out_bf16, float min_prob,
                           float keep, int smem, void* stream) {
  if (N <= 0) return 0;
  if (Ip % BK != 0 || Ip < I || Kp < K || Kp % 4 != 0 || Kmain % WN != 0 ||
      (stash && K > 32 * VMAX) ||
      Kmain > K || (N + R - 1) / R > 0x7fffffffLL || (uintptr_t)wt % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = (const float*)x;
  a.wt = (const float*)wt;
  a.b = (const float*)b;
  a.lengths = (const long long*)lengths;
  a.out = out;
  a.N = N;
  a.B = B;
  a.I = I;
  a.Ip = Ip;
  a.K = K;
  a.Kp = Kp;
  a.Kmain = Kmain;
  a.stash = stash;
  a.round_bf16 = round_bf16;
  a.min_prob = min_prob;
  a.keep = keep;
  const cudaStream_t s = (cudaStream_t)stream;
  return out_bf16 ? launch<__nv_bfloat16>(a, smem, s) : launch<float>(a, smem, s);
}
