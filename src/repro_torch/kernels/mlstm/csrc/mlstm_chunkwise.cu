// Chunkwise mLSTM forward (matrix memory, exponential gating), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/mlstm/kernel.py:
//   mlstm_chunkwise_kernel (body _mlstm_body) -> repro_mlstm_chunkwise
//
// What it computes: for q, k, v (BH, S, hd) and the log gates log_i, log_f
// (BH, S) float32, the mLSTM's output h (BH, S, hd) float32 with the state
// C (hd x hd), n (hd) and the stabilizer m carried along S from zero, as
// repro/kernels/mlstm/ref.py's sequential recurrence defines it (q scaled
// by 1/sqrt(hd)). Each tile of kL timesteps is the chunkwise form of
// _mlstm_body: within the tile an attention-like product of q and k under
// the decay exp(F_t - F_j + log_i_j - m_t) (F the cumulative log forget
// gate), plus the carried state read through q; then the state is carried
// to the tile's end. The stabilizer at a tile's end equals the sequential
// one, so the function does not depend on the tile: the kernel takes kL =
// 64 timesteps where repro takes chunks of 256.
//
// How: the state does not fit one block at hd = 256 (C alone is 256 KB in
// float32). The output's columns are independent: column e of h reads only
// column e of C and of v. So one CTA owns (one b*h, a tile of kTV = 32
// value columns), walks the tiles of S in order, and carries C[:, tile]
// (hd x 32), n (hd) and m in shared memory. Every CTA of a b*h recomputes
// the quantities that all columns share (F, the stabilizer, q k^T, the
// decay, q . n, the denominator); this is redundant but deterministic, so
// the CTAs agree bit for bit. At the main shape (BH = 16, hd = 256) this
// gives 8 x 16 = 128 CTAs for the 132 SMs; kTV = 64 would give 64 CTAs and
// leave half the card idle. Per tile, with 256 threads as 16 x 16:
//   1. q (scaled), k and the v tile are loaded and cast to float32 once
//      (exact), the gates likewise; a ragged last tile is padded with
//      k = v = 0, log_i = -1e30 and log_f = 0, which leaves the state as
//      it is, and its padding rows are never stored;
//   2. one thread takes the cumulative sum F and the tile-end stabilizer
//      m1 = max(F_end + m, max_t(F_end - F_t + log_i_t)) in order; each
//      warp reduces q . n for 8 rows;
//   3. s = q k^T (each thread 4 rows x 4 keys, float4 reads), masked with
//      the finite -1e30 above the diagonal, the row maximum over the 16
//      threads of a row, the decay, s * decay into shared memory, and the
//      denominator max(|rowsum + (q . n) d_state|, exp(-m_new));
//   4. h = (s*decay) v + d_state * (q C), divided by the denominator
//      (each thread 4 rows x 2 columns);
//   5. C = C w_state + (k w_in)^T v (each thread hd/16 rows x 2 columns),
//      n = n w_state + (k w_in)^T 1, m = m1.
// Every product and sum is float32 on the FMA units: no TF32, which would
// change the results. Masked scores are -1e30, never -inf, and m is
// clamped at -1e30, so no step makes a NaN or an infinity.
//
// Shared memory at hd = 256 (float32): q and k tiles 2 x 64 x 260 (rows
// padded to hd + 4: 16-byte aligned, and float4 reads by 16 neighbouring
// rows spread over all banks) = 133,120 B; s*decay 64 x 68 = 17,408 B;
// the C tile 256 x 33 (padded against bank conflicts) = 33,792 B; the v
// tile 64 x 32 = 8,192 B; n 1,024 B; six per-row vectors 1,536 B and 4
// scalars: 195,088 B of the 232,448 B a block may have, so one CTA per SM.
// q and k are held in float32 whatever their input type, so the budget is
// the same for bf16 and float32 inputs.
//
// Bound on the H100: operations. Per step the state costs 4 hd^2 flops
// (q C and the update of C) whatever the tile, and a tile of L steps adds
// 2 hd (L + 1) per step for the masked products (q k^T and (s*decay) v
// over the lower triangle), least at L = 1: so the function needs at
// least 4 hd^2 + 4 hd flops per step. At xlstm-350m's prefill (BH = 16,
// S = 2048, hd = 256) that is 8.6 GFLOP, 0.129 ms at the float32 FMA peak
// of 67 TFLOP/s, against 84 MB of bf16 q, k, v in and float32 h out
// (0.025 ms). This first version does 9.7 GFLOP at L = 64, recomputes
// q k^T in each of the 8 column CTAs and loads each tile without overlap; tensor cores (the products in bf16 would change
// the results, TF32 too), a two-pass form (tile states in parallel, then a
// sequential combine) and TMA are later steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kL = 64;          // timesteps per tile
constexpr int kTV = 32;         // value columns per CTA
constexpr int kThreads = 256;   // 16 row groups x 16 column lanes
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * static_cast<size_t>(kL) * (HD + 4)  // q, k
                          + static_cast<size_t>(kL) * (kL + 4)    // s * decay
                          + static_cast<size_t>(HD) * (kTV + 1)   // C tile
                          + static_cast<size_t>(kL) * kTV         // v tile
                          + HD                                    // n
                          + 6 * kL                                // per-row vectors
                          + 4);                                   // scalars
}

// The first DPT floats at p (16-byte aligned when DPT % 4 == 0) into r.
template <int DPT>
__device__ __forceinline__ void load_row(const float* p, float* r) {
  if constexpr (DPT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < DPT; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      r[i] = x.x;
      r[i + 1] = x.y;
      r[i + 2] = x.z;
      r[i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < DPT; ++i) r[i] = p[i];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_chunkwise_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ log_i,
                       const float* __restrict__ log_f, float* __restrict__ h, int S,
                       float scale) {
  constexpr int LD = HD + 4;   // q, k rows
  constexpr int SLD = kL + 4;  // s * decay rows
  constexpr int CLD = kTV + 1; // C rows
  constexpr int DPT = HD / 16; // state rows per thread in the update of C
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kL * LD;
  float* Ss = Ks + kL * LD;
  float* Cs = Ss + kL * SLD;
  float* Vs = Cs + HD * CLD;
  float* Ns = Vs + kL * kTV;
  float* Li = Ns + HD;   // log_i of the tile
  float* Fc = Li + kL;   // log_f, then its cumulative sum F
  float* Qn = Fc + kL;   // q . n (the carried n)
  float* Ds = Qn + kL;   // d_state = exp(m_state - m_new)
  float* Den = Ds + kL;  // the denominator
  float* Wi = Den + kL;  // w_in = exp(F_end - F_t + log_i_t - m1)
  float* Sc = Wi + kL;   // [0] m carried, [1] m1, [2] w_state

  const int bh = blockIdx.y;
  const int e0 = blockIdx.x * kTV;
  const size_t base = static_cast<size_t>(bh) * S * HD;
  const T* qp = q + base;
  const T* kp = k + base;
  const T* vp = v + base + e0;
  const float* lip = log_i + static_cast<size_t>(bh) * S;
  const float* lfp = log_f + static_cast<size_t>(bh) * S;
  float* hp = h + base + e0;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int i = tid; i < HD * CLD; i += kThreads) Cs[i] = 0.f;
  for (int i = tid; i < HD; i += kThreads) Ns[i] = 0.f;
  if (tid == 0) Sc[0] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kL) {
    const int lv = min(kL, S - t0);
    __syncthreads();  // the previous tile is no longer read; the state is written

    // 1. the tile, cast to float32 once
    for (int i = tid; i < kL * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      const bool in = r < lv;
      const size_t at = static_cast<size_t>(t0 + r) * HD + c;
      Qs[r * LD + c] = in ? to_f32(qp[at]) * scale : 0.f;
      Ks[r * LD + c] = in ? to_f32(kp[at]) : 0.f;
    }
    for (int i = tid; i < kL * kTV; i += kThreads) {
      const int r = i / kTV, c = i % kTV;
      Vs[i] = r < lv ? to_f32(vp[static_cast<size_t>(t0 + r) * HD + c]) : 0.f;
    }
    if (tid < kL) {
      const bool in = tid < lv;
      Li[tid] = in ? lip[t0 + tid] : kNegInf;
      Fc[tid] = in ? lfp[t0 + tid] : 0.f;
    }
    __syncthreads();

    // 2. F and the tile-end stabilizer (in order, one thread); q . n
    if (tid == 0) {
      float f = 0.f;
      for (int t = 0; t < kL; ++t) {
        f += Fc[t];
        Fc[t] = f;
      }
      const float m0 = Sc[0];
      float m1 = f + m0;
      for (int t = 0; t < kL; ++t) m1 = fmaxf(m1, f - Fc[t] + Li[t]);
      Sc[1] = m1;
      Sc[2] = expf(f + m0 - m1);
    }
    for (int r = warp * (kL / 8); r < (warp + 1) * (kL / 8); ++r) {
      float p = 0.f;
      for (int d = lane; d < HD; d += 32) p = fmaf(Qs[r * LD + d], Ns[d], p);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0) Qn[r] = p;
    }
    __syncthreads();

    // 3. s = q k^T, the decay, the row stabilizer and the denominator
    {
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
          qa[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LD + d]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kb[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float a = s[i][j];
            a = fmaf(qa[i].x, kb[j].x, a);
            a = fmaf(qa[i].y, kb[j].y, a);
            a = fmaf(qa[i].z, kb[j].z, a);
            a = fmaf(qa[i].w, kb[j].w, a);
            s[i][j] = a;
          }
      }
      const float m0 = Sc[0];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        const float ft = Fc[t];
        float mi[4];
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          mi[j] = c <= t ? ft - Fc[c] + Li[c] : kNegInf;
          mx = fmaxf(mx, mi[j]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_state = ft + m0;
        const float m_new = fmaxf(fmaxf(mx, m_state), kNegInf);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float sd = c <= t ? s[i][j] * expf(mi[j] - m_new) : 0.f;
          Ss[t * SLD + c] = sd;
          rs += sd;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
        if (tx == 0) {
          const float ds = expf(m_state - m_new);
          Ds[t] = ds;
          Den[t] = fmaxf(fabsf(rs + Qn[t] * ds), expf(-m_new));
        }
      }
      if (tid < kL) Wi[tid] = expf(Fc[kL - 1] - Fc[tid] + Li[tid] - Sc[1]);
    }
    __syncthreads();

    // 4. h = ((s*decay) v + d_state (q C)) / den for this CTA's columns
    {
      float intra[4][2], inter[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) intra[i][c] = inter[i][c] = 0.f;
#pragma unroll 2
      for (int j = 0; j < kL; j += 4) {
        float4 pa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[i] = *reinterpret_cast<const float4*>(&Ss[(ty + 16 * i) * SLD + j]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float v0 = Vs[(j + jj) * kTV + tx];
          const float v1 = Vs[(j + jj) * kTV + tx + 16];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = jj == 0 ? pa[i].x : jj == 1 ? pa[i].y : jj == 2 ? pa[i].z : pa[i].w;
            intra[i][0] = fmaf(p, v0, intra[i][0]);
            intra[i][1] = fmaf(p, v1, intra[i][1]);
          }
        }
      }
#pragma unroll 2
      for (int d = 0; d < HD; d += 4) {
        float4 qa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qa[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LD + d]);
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) {
          const float c0 = Cs[(d + dd) * CLD + tx];
          const float c1 = Cs[(d + dd) * CLD + tx + 16];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = dd == 0 ? qa[i].x : dd == 1 ? qa[i].y : dd == 2 ? qa[i].z : qa[i].w;
            inter[i][0] = fmaf(a, c0, inter[i][0]);
            inter[i][1] = fmaf(a, c1, inter[i][1]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= lv) continue;
        const float ds = Ds[t], den = Den[t];
        float* row = hp + static_cast<size_t>(t0 + t) * HD;
        row[tx] = (intra[i][0] + inter[i][0] * ds) / den;
        row[tx + 16] = (intra[i][1] + inter[i][1] * ds) / den;
      }
    }
    __syncthreads();

    // 5. carry the state to the tile's end
    {
      const float w_state = Sc[2];
      float acc[DPT][2];
#pragma unroll
      for (int r = 0; r < DPT; ++r) acc[r][0] = acc[r][1] = 0.f;
      const int d0 = ty * DPT;
#pragma unroll 2
      for (int t = 0; t < kL; ++t) {
        float kw[DPT];
        load_row<DPT>(&Ks[t * LD + d0], kw);
        const float w = Wi[t];
        const float v0 = Vs[t * kTV + tx];
        const float v1 = Vs[t * kTV + tx + 16];
#pragma unroll
        for (int r = 0; r < DPT; ++r) {
          const float a = kw[r] * w;
          acc[r][0] = fmaf(a, v0, acc[r][0]);
          acc[r][1] = fmaf(a, v1, acc[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < DPT; ++r) {
        float* c = &Cs[(d0 + r) * CLD + tx];
        c[0] = fmaf(c[0], w_state, acc[r][0]);
        c[16] = fmaf(c[16], w_state, acc[r][1]);
      }
      if (tid < HD) {
        float a = 0.f;
        for (int t = 0; t < kL; ++t) a += Ks[t * LD + tid] * Wi[t];
        Ns[tid] = fmaf(Ns[tid], w_state, a);
      }
      if (tid == 0) Sc[0] = Sc[1];
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const float* log_i,
                   const float* log_f, float* h, int BH, int S, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static_assert(smem <= 232448, "shared memory over the H100's 227 KB per block");
  auto kern = mlstm_chunkwise_kernel<T, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(HD / kTV, BH);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), log_i, log_f, h, S, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const float* log_i,
                     const float* log_f, float* h, int BH, int S, int hd, float scale,
                     cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, log_i, log_f, h, BH, S, scale, stream);
    case 64: return launch<T, 64>(q, k, v, log_i, log_f, h, BH, S, scale, stream);
    case 256: return launch<T, 256>(q, k, v, log_i, log_f, h, BH, S, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v: (BH, S, hd) contiguous, one dtype: 0 = float32, 1 = bfloat16.
// log_i, log_f: (BH, S) contiguous float32. h: (BH, S, hd) float32. hd in
// {32, 64, 256}, BH <= 65535. Returns the CUDA error of the launch
// (0 = success); BH == 0 or S == 0 launches nothing.
int repro_mlstm_chunkwise(const void* q, const void* k, const void* v, const float* log_i,
                          const float* log_f, float* h, int dtype, int BH, int S, int hd,
                          float scale, void* stream) {
  if (BH <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (BH > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, log_i, log_f, h, BH, S, hd, scale, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, log_i, log_f, h, BH, S, hd, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* repro_mlstm_chunkwise_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
