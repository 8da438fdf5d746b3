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
//
// Design and bound.  One thread per batch row: each step is one dependent
// 1-byte load from the traceback, so a row costs T dependent global-memory
// latencies.  Rows are independent and run side by side; the traceback of a
// row is touched once, T bytes of it, so the walk is bound by load latency,
// not bandwidth.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void viterbi_back_kernel(const int8_t* __restrict__ tb,
                                    const int32_t* __restrict__ last_state,
                                    int32_t* __restrict__ path,
                                    uint8_t* __restrict__ moved,
                                    int T, int B, int K) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int state = last_state[b];
  int32_t* p = path + (size_t)b * T;
  uint8_t* m = moved + (size_t)b * T;
  for (int t = T - 1; t >= 1; --t) {
    const int c = tb[((size_t)t * B + b) * K + state];
    p[t] = state;
    m[t] = c >= 0;
    if (c >= 4) {
      state = (c - 4) * (K >> 4) + (state >> 4);
    } else if (c >= 0) {
      state = c * (K >> 2) + (state >> 2);
    }
  }
  p[0] = state;
  m[0] = 0;
}

}  // namespace

extern "C" int viterbi_back(const void* tb, const void* last_state,
                            void* path, void* moved, int T, int B, int K,
                            void* stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  viterbi_back_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)tb, (const int32_t*)last_state, (int32_t*)path,
      (uint8_t*)moved, T, B, K);
  return (int)cudaGetLastError();
}
