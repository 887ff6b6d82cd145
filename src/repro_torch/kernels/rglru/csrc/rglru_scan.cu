// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/rglru/kernel.py:
//   rglru_scan_kernel (body _rglru_body) -> repro_rglru_scan
//
// What it computes: for a, b (B, S, W) float32, h (B, S, W) float32 with
// h_0 = b_0 and h_t = a_t * h_{t-1} + b_t along S, independently for every
// (batch, channel). An initial state is folded into b_0 by the wrapper, as
// repro's _lru_scan folds it.
//
// How: the recurrence is element-wise over W, so each thread owns one
// (b, w) channel and walks S in order; neighbouring threads own
// neighbouring channels, so every load and store of a time step is one
// coalesced row segment. The TPU kernel runs a log-depth scan inside each
// (S-tile x W-tile) block because its vector unit wants whole tiles; here a
// thread's sequential walk is the cheaper form of the same function. To
// keep loads in flight, a thread reads a chunk of 16 steps of a and b into
// registers before it runs them. The product and the sum are rounded
// separately (no fused multiply-add), so the result is bit for bit the
// plain sequential version's.
//
// Bound on the H100: bytes, 3 * B * S * W * 4 (read a and b, write h): at
// recurrentgemma's prefill (B=4, S=4096, W=4096) 805 MB, 0.24 ms at
// 3.35 TB/s. With one thread per channel only B * W threads run (16,384
// there, ~124 per SM), so latency, not bandwidth, limits this version; a
// chunked two-pass scan over S is the next step.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ h,
                  int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * W + w;
  float hv = 0.f;
  int t = 0;
  for (; t + kChunk <= S; t += kChunk) {
    float av[kChunk], bv[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const size_t at = base + static_cast<size_t>(t + i) * W;
      av[i] = __ldg(a + at);
      bv[i] = __ldg(b + at);
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      hv = __fadd_rn(__fmul_rn(av[i], hv), bv[i]);
      h[base + static_cast<size_t>(t + i) * W] = hv;
    }
  }
  for (; t < S; ++t) {
    const size_t at = base + static_cast<size_t>(t) * W;
    hv = __fadd_rn(__fmul_rn(__ldg(a + at), hv), __ldg(b + at));
    h[at] = hv;
  }
}

}  // namespace

extern "C" {

// a, b, h: (B, S, W) contiguous float32. Returns the CUDA error of the
// launch (0 = success); an empty input launches nothing.
int repro_rglru_scan(const float* a, const float* b, float* h, int B, int S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, b, h, S, W);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
