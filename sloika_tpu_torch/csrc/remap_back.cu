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
// What bounds it.  Each step is one 2-byte load whose address depends on
// the previous step's load: a row costs Tp dependent global-memory
// latencies (35,584 at the remap main path's shapes), whatever the card's
// bandwidth or arithmetic.  The bytes it must move (Tp*B*2 read, Tp*B*4
// written) are a few MB.
//
// What the design does about it.  One thread per row; rows run side by
// side.  The window start of the next step, which does not depend on pos,
// is loaded one step ahead, so only the delta load is on the chain.  And
// since a path moves by about one position a frame, the delta that step
// t-32 will read lies near the current one: the thread asks L2 for that
// row's 128-byte line at the current lane (and the line before it), so the
// dependent load mostly hits L2 instead of device memory.  The prefetch is
// a hint: it changes no result.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAhead = 32;

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__global__ void remap_back_kernel(const int16_t* __restrict__ tb,
                                  const int32_t* __restrict__ starts,
                                  const int32_t* __restrict__ last,
                                  int32_t* __restrict__ path, int Tp, int B,
                                  int W) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int pos = last[b];
  path[(size_t)(Tp - 1) * B + b] = pos;
  int s_next = starts[(size_t)(Tp - 1) * B + b];
  for (int t = Tp - 1; t >= 1; --t) {
    const int s = s_next;
    s_next = starts[(size_t)(t - 1) * B + b];
    const int rel = min(max(pos - s, 0), W - 1);
    if (t - kAhead >= 1) {
      const int16_t* ahead = tb + ((size_t)(t - kAhead) * B + b) * W;
      prefetch_l2(ahead + rel);
      prefetch_l2(ahead + max(rel - 64, 0));
    }
    pos -= tb[((size_t)t * B + b) * W + rel];
    path[(size_t)(t - 1) * B + b] = pos;
  }
}

}  // namespace

// tb (Tp, B, W) int16; starts (Tp, B) int32; last (B,) int32; path (Tp, B)
// int32.  Returns the cudaError_t of the launch.
extern "C" int remap_back(const void* tb, const void* starts, const void* last,
                          void* path, int Tp, int B, int W, void* stream) {
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  remap_back_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)tb, (const int32_t*)starts, (const int32_t*)last,
      (int32_t*)path, Tp, B, W);
  return (int)cudaGetLastError();
}
