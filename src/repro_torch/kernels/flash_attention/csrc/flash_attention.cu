// Flash attention forward (causal and/or sliding window, GQA), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/flash_attention/kernel.py:
//   flash_attention_kernel (body _fa_body) -> repro_flash_attention
//
// What it computes: for q (B, H, Sq, hd) and k, v (B, K, Skv, hd) with
// K | H, out[b, h, i] = softmax_j(q_i . k_j / sqrt(hd), masked) v_j over the
// keys of kv head h / (H / K), where the mask keeps j < Skv, j <= i if
// causal, and i - j < window if a window is given. Scores that the mask
// drops are the finite -1e30, never -inf, so m_old - m_new is never NaN;
// the final divide is by max(l, 1e-30). Output in q's dtype.
//
// How: one CTA per (b*h, tile of 64 queries), 256 threads. The q tile sits
// in shared memory in float32 for the whole CTA; the CTA walks only the kv
// tiles of 64 keys that the causal and window band keeps live (the
// predicate of _fa_body: k_start < Skv, k_start <= q_end if causal,
// k_end > q_start - window), and skips the rest. Per tile: K and V in
// float32 in shared memory, S = Q K^T in registers (each thread 4 rows x 4
// keys), the online softmax (m, l) per row in float32 with the row's
// maximum and sum reduced over the 16 threads that hold the row, P through
// shared memory, and acc = acc * alpha + P V in registers (each thread 4
// rows x hd/16 columns). GQA is an index: the kv head is h / (H / K), and
// k, v are never repeated. Padding keys (Skv not a multiple of 64) are
// loaded as zeros and masked; padding queries are never stored.
//
// Bound on the H100: operations. Per live (query, key) pair it does
// 4 * hd flops (two products); recurrentgemma's prefill (B=4, H=16,
// S=4096, window 2048, hd=256) is ~0.4 TFLOP of live band, ~0.4 ms at the
// bf16 tensor-core peak, against ~0.2 GB of q, k, v and out. This first
// version does its products on the float32 FMA units from shared memory
// (no tensor cores, no TMA, one CTA per SM at hd=256 for its 211 KB of
// shared memory), so it sits far above that bound; wgmma with bf16 tiles
// and a TMA pipeline are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;          // queries per CTA
constexpr int kBK = 64;          // keys per kv tile
constexpr int kThreads = 256;    // 16 row groups x 16 column lanes
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  // Q and K tiles with rows padded to HD + 4 floats (16-byte aligned rows,
  // and float4 reads by 8 neighbouring rows hit 32 distinct banks), the V
  // tile, and P with rows of kBK + 4 floats
  return sizeof(float) *
         (static_cast<size_t>(kBQ) * (HD + 4) + static_cast<size_t>(kBK) * (HD + 4) +
          static_cast<size_t>(kBK) * HD + static_cast<size_t>(kBQ) * (kBK + 4));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int H, int K, int sq, int skv, int causal, int window,
                 float scale) {
  constexpr int LD = HD + 4;
  constexpr int PLD = kBK + 4;
  constexpr int CPT = HD / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * HD;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int kvh = (bh % H) / (H / K);
  const int q0 = blockIdx.y * kBQ;
  const T* qp = q + static_cast<size_t>(bh) * sq * HD;
  const T* kp = k + static_cast<size_t>(b * K + kvh) * skv * HD;
  const T* vp = v + static_cast<size_t>(b * K + kvh) * skv * HD;
  T* op = out + static_cast<size_t>(bh) * sq * HD;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // keys / columns tx + 16*j

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    const int qi = q0 + r;
    Qs[r * LD + c] = qi < sq ? to_f32(qp[static_cast<size_t>(qi) * HD + c]) : 0.f;
  }

  float acc[4][CPT];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // the live kv tiles of this q tile (the skip predicate of _fa_body)
  int kt_end = (skv + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, (q0 + kBQ - 1) / kBK + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window - kBK + 2;  // least live k_start
    kt_begin = lo <= 0 ? 0 : (lo + kBK - 1) / kBK;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      const int kj = k0 + r;
      const bool in = kj < skv;
      const size_t at = static_cast<size_t>(kj) * HD + c;
      Ks[r * LD + c] = in ? to_f32(kp[at]) : 0.f;
      Vs[r * HD + c] = in ? to_f32(vp[at]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(qa[i].x, kb[j].x, t);
          t = fmaf(qa[i].y, kb[j].y, t);
          t = fmaf(qa[i].z, kb[j].z, t);
          t = fmaf(qa[i].w, kb[j].w, t);
          s[i][j] = t;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        bool ok = kj < skv;
        if (causal) ok = ok && qi >= kj;
        if (window > 0) ok = ok && qi - kj < window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      float lt = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        lt += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + lt;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * PLD + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * PLD + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) vv[c] = Vs[(j + jj) * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj == 0 ? pa[i].x : jj == 1 ? pa[i].y : jj == 2 ? pa[i].z : pa[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      op[static_cast<size_t>(qi) * HD + tx + 16 * c] = from_f32<T>(acc[i][c] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int H, int K,
                   int sq, int skv, int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (sq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<T*>(out), H, K,
                                         sq, skv, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int B, int H, int K,
                     int sq, int skv, int hd, int causal, int window, float scale,
                     cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, B, H, K, sq, skv, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, B, H, K, sq, skv, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, H, K, sq, skv, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, H, K, sq, skv, causal, window, scale, stream);
    case 256: return launch<T, 256>(q, k, v, out, B, H, K, sq, skv, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, out: (B, H, Sq, hd); k, v: (B, K, Skv, hd); contiguous, all of one
// dtype: 0 = float32, 1 = bfloat16. hd in {16, 32, 64, 128, 256}, K | H.
// window <= 0: no window. Returns the CUDA error of the launch (0 =
// success); Sq == 0 or B * H == 0 launches nothing.
int repro_flash_attention(const void* q, const void* k, const void* v, void* out, int dtype, int B,
                          int H, int K, int sq, int skv, int hd, int causal, int window,
                          float scale, void* stream) {
  if (sq <= 0 || B <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (K <= 0 || H % K != 0 || skv < 0 || (sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, out, B, H, K, sq, skv, hd, causal, window, scale, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, out, B, H, K, sq, skv, hd, causal, window, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* repro_flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
