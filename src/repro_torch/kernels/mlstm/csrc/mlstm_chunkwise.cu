// Chunkwise mLSTM forward (matrix memory, exponential gating), for Hopper
// (sm_90a), in the chunk-parallel two-pass form.
//
// Replaces the Pallas TPU kernel of repro/kernels/mlstm/kernel.py:
//   mlstm_chunkwise_kernel (body _mlstm_body) -> repro_mlstm_chunkwise
//
// What it computes: for q, k, v (BH, S, hd) and the log gates log_i, log_f
// (BH, S) float32, the mLSTM's output h (BH, S, hd) float32 with the state
// C (hd x hd), n (hd) and the stabilizer m carried along S from zero, as
// repro/kernels/mlstm/ref.py's sequential recurrence defines it (q scaled
// by 1/sqrt(hd)). Each chunk of kL = 64 timesteps is the chunkwise form of
// _mlstm_body: within the chunk an attention-like product of q and k under
// the decay exp(F_t - F_j + log_i_j - m_t) (F the chunk's cumulative log
// forget gate), plus the state at the chunk's start read through q. The
// stabilizer at a chunk's end equals the sequential one,
// max(F_end + m_start, max_t(F_end - F_t + log_i_t)), so the function does
// not depend on the chunk: the kernel takes 64 where repro takes 256.
//
// How: the TPU kernel walks the chunks in order and carries the state. Here
// the chunks run in parallel, in three launches:
//   1. state: one CTA per (b*h, chunk but the last, slab of 64 state
//      rows): the chunk's own contribution to the state, relative to its
//      own input stabilizer a = max_t(F_end - F_t + log_i_t):
//      C_loc = (k w)^T v and n_loc = (k w)^T 1 with w_t = exp(F_end - F_t
//      + log_i_t - a), and the chunk's F_end and a;
//   2. combine: one thread per element of (C, n) of a b*h walks the chunks
//      in order: the state at chunk c's start is written over C_loc[c],
//      then C <- C exp(F_end + m - m1) + C_loc exp(a - m1) with m1 =
//      max(F_end + m, a), the sequential stabilizer. hd^2 work per chunk,
//      not per step; every thread computes the same scalar m chain;
//   3. output: one CTA per (b*h, chunk) computes all hd columns of its 64
//      rows: q k^T, the row stabilizer m_t = max(max_j(F_t - F_j + log_i_j),
//      F_t + m_start), the decay and the denominator once per row;
//      then h = (d_state (q C_start) + (s*decay) v) / den.
// So the serial walk is 3 scalar ops and 2 exps per chunk and element of
// the state; the products (2 hd^2 a step in 1, 2 hd^2 + 4 hd kL/2 in 3)
// run on every SM at once. The states at the chunk starts take
// BH * (S/64) * (hd^2 + hd) * 4 bytes of scratch (134 MB at xlstm-350m's
// prefill), which the wrapper allocates; launch 1 writes them, 2 reads and
// writes them, 3 reads them. Every sum is in a fixed order and there are no
// atomics, so h is the same bits on every launch.
//
// The products are float32 on the FMA units: no TF32 or bf16, which would
// change the results. A CTA's tile of 64 rows x hd columns gives each of
// its 256 threads 4 rows x hd/16 columns, read as float4 (q, s*decay and
// k^T w broadcast along a row; v and C along the columns). Launch 3 reads
// C's slabs with cp.async into two buffers (the second is k's, free once
// q k^T is done), so the next slab arrives while this one is used. Masked scores
// are -1e30, never -inf, and m is clamped at -1e30, so no step makes a NaN
// or an infinity. A ragged last chunk is padded with q = k = v = 0,
// log_i = -1e30 and log_f = 0, and its padding rows are never stored.
//
// Shared memory at hd = 256: launch 3 holds q and k (2 x 64 x 260 floats,
// rows padded against bank conflicts), a 64 x 256 buffer for v and, before
// it, for C's slabs, s*decay (64 x 68), n and six per-row vectors: 218,624
// B of the 232,448 a block may have, one CTA per SM. Launch 1 holds
// (k w)^T (64 x 68) and v (64 x 256): 83,712 B, two CTAs per SM.
//
// Bound on the H100: operations. Per step the state costs 4 hd^2 flops
// (q C and the update of C) whatever the chunk, and a chunk of L steps adds
// 2 hd (L + 1) per step for the masked products, least at L = 1: so the
// function needs at least 4 hd^2 + 4 hd flops per step. At xlstm-350m's
// prefill (BH = 16, S = 2048, hd = 256) that is 8.6 GFLOP, 0.129 ms at the
// float32 FMA peak of 67 TFLOP/s, against 84 MB of bf16 q, k, v in and
// float32 h out (0.025 ms); this form does 10.7 GFLOP (the full 64 x 64
// q k^T and (s*decay) v of each chunk) and moves ~0.53 GB of states.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kL = 64;          // timesteps per chunk
constexpr int kThreads = 256;   // 16 row groups x 16 column lanes
constexpr float kNegInf = -1e30f;

// Four consecutive elements as float32 (16- or 8-byte aligned); bf16
// widens exactly, as its bits << 16.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u));
}

// ROWS x COLS of a row-major matrix in global memory (src_ld elements a
// row) into shared floats (ld a row), times scale; rows at or past `valid`
// are zero. Four elements a load, eight loads in flight a thread; NT
// threads.
template <int NT, int ROWS, int COLS, typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, size_t src_ld,
                                          int valid, float scale) {
  constexpr int kVecs = ROWS * COLS / 4;
  constexpr int kPer = (kVecs + NT - 1) / NT;
  constexpr int kBatch = kPer < 8 ? kPer : 8;
  static_assert(kPer % kBatch == 0, "whole batches");
#pragma unroll
  for (int b0 = 0; b0 < kPer; b0 += kBatch) {
    float4 x[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = (b0 + j) * NT + static_cast<int>(threadIdx.x);
      const int r = i / (COLS / 4), c = (i % (COLS / 4)) * 4;
      x[j] = i < kVecs && r < valid ? load4(src + r * src_ld + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = (b0 + j) * NT + static_cast<int>(threadIdx.x);
      const int r = i / (COLS / 4), c = (i % (COLS / 4)) * 4;
      if (i < kVecs)
        *reinterpret_cast<float4*>(&dst[r * ld + c]) =
            make_float4(x[j].x * scale, x[j].y * scale, x[j].z * scale, x[j].w * scale);
    }
  }
}

__device__ __forceinline__ float lane_of(const float4& a, int u) {
  return u == 0 ? a.x : u == 1 ? a.y : u == 2 ? a.z : a.w;
}

// acc[i][c] += sum_k A[row_i][k] * B[k][col_c] over k < KK, rows ty + RS i
// (A row-major, lda floats a row, 16-byte aligned), and the HD columns of
// B (row-major, ldb floats a row) in vectors of VW: column (tx + 16 j) *
// VW + w for j < NV. Each thread 4 * CPT fmas per 1 + NV shared loads.
template <int RPT, int RS, int HD, int KK>
__device__ __forceinline__ void tile_fma(float (&acc)[RPT][HD / 16], const float* A, int lda,
                                         const float* B, int ldb, int ty, int tx) {
  constexpr int CPT = HD / 16;
  constexpr int VW = CPT >= 4 ? 4 : CPT;
  constexpr int NV = CPT / VW;
#pragma unroll 2
  for (int k = 0; k < KK; k += 4) {
    float4 a[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) a[i] = *reinterpret_cast<const float4*>(&A[(ty + RS * i) * lda + k]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float b[CPT];
      const float* row = &B[(k + u) * ldb];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int col = (tx + 16 * j) * VW;
        if constexpr (VW == 4) {
          const float4 x = *reinterpret_cast<const float4*>(&row[col]);
          b[4 * j] = x.x;
          b[4 * j + 1] = x.y;
          b[4 * j + 2] = x.z;
          b[4 * j + 3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(&row[col]);
          b[2 * j] = x.x;
          b[2 * j + 1] = x.y;
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float av = lane_of(a[i], u);
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(av, b[c], acc[i][c]);
      }
    }
  }
}

// One row of tile_fma's accumulators, divided by div, to its columns of
// `row` in global memory, a vector of VW at a time.
template <int HD>
__device__ __forceinline__ void store_row(float* row, const float (&acc)[HD / 16], float div,
                                          int tx) {
  constexpr int CPT = HD / 16;
  constexpr int VW = CPT >= 4 ? 4 : CPT;
#pragma unroll
  for (int j = 0; j < CPT / VW; ++j) {
    float* at = row + (tx + 16 * j) * VW;
    if constexpr (VW == 4)
      *reinterpret_cast<float4*>(at) = make_float4(acc[4 * j] / div, acc[4 * j + 1] / div,
                                                   acc[4 * j + 2] / div, acc[4 * j + 3] / div);
    else
      *reinterpret_cast<float2*>(at) = make_float2(acc[2 * j] / div, acc[2 * j + 1] / div);
  }
}

// The chunk's log gates into Li and Fc (Fc then its cumulative sum F, in
// order, by one thread); padding past S: log_i = -1e30, log_f = 0.
__device__ __forceinline__ void load_gates(const float* lip, const float* lfp, int t0, int lv,
                                           float* Li, float* Fc) {
  const int tid = threadIdx.x;
  if (tid < kL) {
    const bool in = tid < lv;
    Li[tid] = in ? lip[t0 + tid] : kNegInf;
    Fc[tid] = in ? lfp[t0 + tid] : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    float f = 0.f;
    for (int t = 0; t < kL; ++t) {
      f += Fc[t];
      Fc[t] = f;
    }
  }
  __syncthreads();
}

template <int HD>
__host__ __device__ constexpr int slab_rows() {
  return HD < 64 ? HD : 64;
}

template <int HD>
constexpr size_t state_smem() {
  return sizeof(float) * (static_cast<size_t>(slab_rows<HD>()) * (kL + 4)  // (k w)^T
                          + static_cast<size_t>(kL) * HD                    // v
                          + 3 * kL + 2);                                    // Li, F, w; F_end, a
}

// Launch 1: the chunk's own state contribution, for one slab of state rows.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
mlstm_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ log_i, const float* __restrict__ log_f,
                   float* __restrict__ state, float* __restrict__ g_out,
                   float* __restrict__ a_out, int S, int NC) {
  constexpr int DS = slab_rows<HD>();
  constexpr int RPT = DS / 16;
  constexpr int ALD = kL + 4;
  constexpr size_t R = static_cast<size_t>(HD) * HD + HD;
  extern __shared__ __align__(16) float smem[];
  float* At = smem;               // [DS][ALD]: (k w)^T of the slab
  float* Vs = At + DS * ALD;      // [kL][HD]
  float* Li = Vs + kL * HD;
  float* Fc = Li + kL;
  float* W = Fc + kL;
  float* Sc = W + kL;             // [0] F_end, [1] a

  const int slab = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int d0 = slab * DS, t0 = c * kL;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = (static_cast<size_t>(bh) * S + t0) * HD;
  load_gates(log_i + static_cast<size_t>(bh) * S, log_f + static_cast<size_t>(bh) * S, t0, kL,
             Li, Fc);  // chunks before the last are full
  if (tid == 0) {
    const float f_end = Fc[kL - 1];
    float a = kNegInf;
    for (int t = 0; t < kL; ++t) a = fmaxf(a, f_end - Fc[t] + Li[t]);
    Sc[0] = f_end;
    Sc[1] = a;
    if (slab == 0) {
      g_out[static_cast<size_t>(bh) * NC + c] = f_end;
      a_out[static_cast<size_t>(bh) * NC + c] = a;
    }
  }
  __syncthreads();
  if (tid < kL) W[tid] = expf(Sc[0] - Fc[tid] + Li[tid] - Sc[1]);
  __syncthreads();
  {
    constexpr int kPer = kL * DS / 4 / kThreads;  // 4-element loads a thread, all in flight
    float4 x[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = j * kThreads + tid;
      x[j] = load4(k + base + static_cast<size_t>(i / (DS / 4)) * HD + d0 + (i % (DS / 4)) * 4);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = j * kThreads + tid;
      const int t = i / (DS / 4), d = (i % (DS / 4)) * 4;
      const float w = W[t];
      At[d * ALD + t] = x[j].x * w;
      At[(d + 1) * ALD + t] = x[j].y * w;
      At[(d + 2) * ALD + t] = x[j].z * w;
      At[(d + 3) * ALD + t] = x[j].w * w;
    }
  }
  load_tile<kThreads, kL, HD>(Vs, HD, v + base, HD, kL, 1.f);
  __syncthreads();

  float acc[RPT][HD / 16];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) acc[i][j] = 0.f;
  tile_fma<RPT, 16, HD, kL>(acc, At, ALD, Vs, HD, ty, tx);

  float* rec = state + (static_cast<size_t>(bh) * NC + c) * R;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    store_row<HD>(rec + static_cast<size_t>(d0 + ty + 16 * i) * HD, acc[i], 1.f, tx);
  }
  if (tid < DS) {
    float s = 0.f;
    for (int t = 0; t < kL; ++t) s += At[tid * ALD + t];
    rec[static_cast<size_t>(HD) * HD + d0 + tid] = s;
  }
}

// Launch 2: the states at the chunk starts, over each chunk's C_loc, and
// the stabilizer at each start into m_out. A block stages the weights of
// up to kStage chunks in shared memory (the scalar m chain, one thread, in
// order), then each thread streams four elements through them, eight
// chunks' loads in flight.
constexpr int kStage = 128;
constexpr int kAhead = 8;

__global__ void __launch_bounds__(kThreads)
mlstm_combine_kernel(float* __restrict__ state, const float* __restrict__ g,
                     const float* __restrict__ a, float* __restrict__ m_out, int NC,
                     long long R) {
  __shared__ float s_g[kStage], s_a[kStage], s_ws[kStage], s_wl[kStage];
  __shared__ float s_m;
  const long long e = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  const int bh = blockIdx.y;
  const bool mine = e < R;
  float* first = state + static_cast<size_t>(bh) * NC * R + e;
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x == 0) s_m = 0.f;
  for (int c0 = 0; c0 < NC; c0 += kStage) {
    const int nc = min(kStage, NC - c0);
    const size_t at0 = static_cast<size_t>(bh) * NC + c0;
    __syncthreads();  // the last stage's weights are read
    if (threadIdx.x < nc) {  // launch 1 leaves the last chunk's unset
      const bool set = c0 + static_cast<int>(threadIdx.x) + 1 < NC;
      s_g[threadIdx.x] = set ? g[at0 + threadIdx.x] : 0.f;
      s_a[threadIdx.x] = set ? a[at0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float m = s_m;
      for (int i = 0; i < nc; ++i) {
        if (blockIdx.x == 0) m_out[at0 + i] = m;
        const float m1 = fmaxf(s_g[i] + m, s_a[i]);
        s_ws[i] = expf(s_g[i] + m - m1);
        s_wl[i] = expf(s_a[i] - m1);
        m = m1;
      }
      s_m = m;
    }
    __syncthreads();
    if (!mine) continue;
    for (int i = 0; i < nc; i += kAhead) {
      float4 loc[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int c = c0 + i + u;
        loc[u] = i + u < nc && c + 1 < NC
                     ? *reinterpret_cast<const float4*>(first + static_cast<size_t>(c) * R)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (i + u >= nc) break;
        const int c = c0 + i + u;
        *reinterpret_cast<float4*>(first + static_cast<size_t>(c) * R) = x;
        const float ws = s_ws[i + u], wl = s_wl[i + u];
        x = make_float4(fmaf(x.x, ws, loc[u].x * wl), fmaf(x.y, ws, loc[u].y * wl),
                        fmaf(x.z, ws, loc[u].z * wl), fmaf(x.w, ws, loc[u].w * wl));
      }
    }
  }
}

template <int HD>
constexpr size_t output_smem() {
  return sizeof(float) * (2 * static_cast<size_t>(kL) * (HD + 4)  // q, k
                          + static_cast<size_t>(kL) * HD          // v, C slabs
                          + static_cast<size_t>(kL) * (kL + 4)    // s * decay
                          + HD                                    // n at the start
                          + 6 * kL);                              // per-row vectors
}

// Launch 3: the chunk's outputs, all hd columns.
// ROWS x COLS floats, contiguous in global memory, into shared memory
// (COLS a row) with cp.async, 16 bytes a copy; one commit group.
template <int ROWS, int COLS>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  constexpr int kChunks = ROWS * COLS / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < kChunks; i += kThreads) {
    const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst + 4 * i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(src + 4 * i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_output_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ log_i, const float* __restrict__ log_f,
                    const float* __restrict__ state, const float* __restrict__ m_in,
                    float* __restrict__ h, int S, int NC, float scale) {
  constexpr int LD = HD + 4;   // q, k rows
  constexpr int SLD = kL + 4;  // s * decay rows
  constexpr int SL = slab_rows<HD>();
  constexpr int CPT = HD / 16;
  constexpr int NT = kThreads;
  constexpr int RG = NT / 16;     // row groups: thread (ty, tx) has rows ty + RG i
  constexpr int RPT = kL / RG;
  constexpr int NS = HD / SL;     // C's slabs
  constexpr size_t R = static_cast<size_t>(HD) * HD + HD;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kL * LD;
  float* Vs = Ks + kL * LD;   // C's even slabs, then v; the odd ones in Ks
  float* Ss = Vs + kL * HD;
  float* Ns = Ss + kL * SLD;
  float* Li = Ns + HD;
  float* Fc = Li + kL;
  float* Mn = Fc + kL;        // the row stabilizer m_t
  float* Ds = Mn + kL;        // d_state = exp(F_t + m_start - m_t)
  float* Qn = Ds + kL;        // q . n_start
  float* Rs = Qn + kL;        // row sums of s * decay

  const int c = blockIdx.x, bh = blockIdx.y;
  const int t0 = c * kL, lv = min(kL, S - t0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t base = static_cast<size_t>(bh) * S * HD;
  const float* rec = state + (static_cast<size_t>(bh) * NC + c) * R;
  const float m0 = m_in[static_cast<size_t>(bh) * NC + c];

  // 1. C's first slab on its way; q (scaled), k, n and the gates, cast to
  // float32 once
  copy_async<SL, HD>(Vs, rec);
  const size_t row0 = base + static_cast<size_t>(t0) * HD;
  load_tile<NT, kL, HD>(Qs, LD, q + row0, HD, lv, scale);
  load_tile<NT, kL, HD>(Ks, LD, k + row0, HD, lv, 1.f);
  for (int i = tid; i < HD; i += NT) Ns[i] = rec[static_cast<size_t>(HD) * HD + i];
  load_gates(log_i + static_cast<size_t>(bh) * S, log_f + static_cast<size_t>(bh) * S, t0, lv,
             Li, Fc);

  // 2. each row's stabilizer and state decay (in order); q . n
  if (tid < kL) {
    const int t = tid;
    const float ft = Fc[t];
    float mx = kNegInf;
    for (int j = 0; j <= t; ++j) mx = fmaxf(mx, ft - Fc[j] + Li[j]);
    const float m_new = fmaxf(fmaxf(mx, ft + m0), kNegInf);
    Mn[t] = m_new;
    Ds[t] = expf(ft + m0 - m_new);
  }
  constexpr int kRowsPerWarp = kL / (NT / 32);
  for (int r = warp * kRowsPerWarp; r < (warp + 1) * kRowsPerWarp; ++r) {
    float p = 0.f;
    for (int d = lane; d < HD; d += 32) p = fmaf(Qs[r * LD + d], Ns[d], p);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
    if (lane == 0) Qn[r] = p;
  }
  __syncthreads();

  // 3. s = q k^T, masked and decayed, and its row sums
  {
    float s[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[RPT], kb[4];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&Qs[(ty + RG * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
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
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int t = ty + RG * i;
      const float ft = Fc[t], m_new = Mn[t];
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jj = tx + 16 * j;
        const float sd = jj <= t ? s[i][j] * expf(ft - Fc[jj] + Li[jj] - m_new) : 0.f;
        Ss[t * SLD + jj] = sd;
        rs += sd;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      if (tx == 0) Rs[t] = rs;
    }
  }

  // 4. d_state (q C_start), C read in slabs of SL rows through Vs
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  __syncthreads();  // k is read: its buffer takes the odd slabs
#pragma unroll 1
  for (int sl = 0; sl < NS; ++sl) {
    float* buf = sl % 2 ? Ks : Vs;
    if (sl + 1 < NS) {
      copy_async<SL, HD>(sl % 2 ? Vs : Ks, rec + static_cast<size_t>(sl + 1) * SL * HD);
      wait_async<1>();
    } else {
      wait_async<0>();
    }
    __syncthreads();  // slab sl has landed for every thread
    tile_fma<RPT, RG, HD, SL>(acc, Qs + sl * SL, LD, buf, HD, ty, tx);
    __syncthreads();  // its buffer is free
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const float ds = Ds[ty + RG * i];
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] *= ds;
  }

  // 5. + (s*decay) v
  load_tile<NT, kL, HD>(Vs, HD, v + row0, HD, lv, 1.f);
  __syncthreads();
  tile_fma<RPT, RG, HD, kL>(acc, Ss, SLD, Vs, HD, ty, tx);

  // 6. divided by the denominator, for the rows inside S
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int t = ty + RG * i;
    if (t >= lv) continue;
    const float den = fmaxf(fabsf(Rs[t] + Qn[t] * Ds[t]), expf(-Mn[t]));
    float* row = h + base + static_cast<size_t>(t0 + t) * HD;
    store_row<HD>(row, acc[i], den, tx);
  }
}

int chunks(int S) { return (S + kL - 1) / kL; }

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const float* log_i,
                   const float* log_f, float* h, int BH, int S, float scale, void* scratch,
                   cudaStream_t stream) {
  constexpr size_t smem1 = state_smem<HD>();
  constexpr size_t smem3 = output_smem<HD>();
  static_assert(smem3 <= 232448, "shared memory over the H100's 227 KB per block");
  constexpr long long R = static_cast<long long>(HD) * HD + HD;
  const int NC = chunks(S);
  float* state = static_cast<float*>(scratch);
  float* g = state + static_cast<size_t>(BH) * NC * R;
  float* a = g + static_cast<size_t>(BH) * NC;
  float* m = a + static_cast<size_t>(BH) * NC;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  cudaError_t err;
  if (NC > 1) {
    auto k1 = mlstm_state_kernel<T, HD>;
    err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem1));
    if (err != cudaSuccess) return err;
    k1<<<dim3(HD / slab_rows<HD>(), NC - 1, BH), kThreads, smem1, stream>>>(
        kt, vt, log_i, log_f, state, g, a, S, NC);
  }
  static_assert(R % 4 == 0, "the combine takes four elements a thread");
  mlstm_combine_kernel<<<dim3(static_cast<unsigned>((R / 4 + kThreads - 1) / kThreads), BH),
                         kThreads, 0, stream>>>(state, g, a, m, NC, R);
  auto k3 = mlstm_output_kernel<T, HD>;
  err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem3));
  if (err != cudaSuccess) return err;
  k3<<<dim3(NC, BH), kThreads, smem3, stream>>>(qt, kt, vt, log_i, log_f, state, m, h, S, NC,
                                                scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const float* log_i,
                     const float* log_f, float* h, int BH, int S, int hd, float scale,
                     void* scratch, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, log_i, log_f, h, BH, S, scale, scratch, stream);
    case 64: return launch<T, 64>(q, k, v, log_i, log_f, h, BH, S, scale, scratch, stream);
    case 256: return launch<T, 256>(q, k, v, log_i, log_f, h, BH, S, scale, scratch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Bytes of device scratch a call needs: the states at the chunk starts
// (hd^2 + hd floats each) and three floats a chunk (F_end, a, m).
long long repro_mlstm_scratch_bytes(int BH, int S, int hd) {
  const long long per_chunk = static_cast<long long>(hd) * hd + hd + 3;
  return static_cast<long long>(BH) * chunks(S) * per_chunk * static_cast<long long>(sizeof(float));
}

// q, k, v: (BH, S, hd) contiguous, one dtype: 0 = float32, 1 = bfloat16.
// log_i, log_f: (BH, S) contiguous float32. h: (BH, S, hd) float32. hd in
// {32, 64, 256}, BH <= 65535, S / 64 < 65536. scratch: the bytes
// repro_mlstm_scratch_bytes gives. Returns the CUDA error of the launches
// (0 = success); BH == 0 or S == 0 launches nothing.
int repro_mlstm_chunkwise(const void* q, const void* k, const void* v, const float* log_i,
                          const float* log_f, float* h, int dtype, int BH, int S, int hd,
                          float scale, void* scratch, void* stream) {
  if (BH <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (BH > 65535 || chunks(S) > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, log_i, log_f, h, BH, S, hd, scale, scratch, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, log_i, log_f, h, BH, S, hd, scale, scratch, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* repro_mlstm_chunkwise_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
