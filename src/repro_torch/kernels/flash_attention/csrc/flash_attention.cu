// Flash attention forward (causal and/or sliding window, GQA), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/flash_attention/kernel.py:
//   flash_attention_kernel (body _fa_body) -> repro_flash_attention_wgmma
//     (bf16 at hd 64, 128, 256: wgmma and TMA, below) and
//     repro_flash_attention (float32 at every hd, bf16 at hd 16, 32 and
//     96: the float32 FMA units, described first). kernel.py picks one
//     through an explicit table.
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
// shared memory), so it sits far above that bound: it serves float32 and
// the head dims where the wgmma kernel below does not apply (16, 32, and
// 96: phi3-vision's, CPT = 6 columns a thread, rows of 100 floats).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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

// float32 at every head dim; bf16 at 16, 32 and 96 only (the wgmma kernel
// takes bf16 at 64, 128 and 256; its TMA boxes are 64 columns wide, and 96
// is not a multiple of them)
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int B, int H, int K,
                     int sq, int skv, int hd, int causal, int window, float scale,
                     cudaStream_t stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, B, H, K, sq, skv, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, B, H, K, sq, skv, causal, window, scale, stream);
    case 96: return launch<T, 96>(q, k, v, out, B, H, K, sq, skv, causal, window, scale, stream);
    default: break;
  }
  if constexpr (f32) {
    switch (hd) {
      case 64: return launch<T, 64>(q, k, v, out, B, H, K, sq, skv, causal, window, scale, stream);
      case 128: return launch<T, 128>(q, k, v, out, B, H, K, sq, skv, causal, window, scale, stream);
      case 256: return launch<T, 256>(q, k, v, out, B, H, K, sq, skv, causal, window, scale, stream);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16 at hd 64, 128 and 256: the same function on the tensor cores,
// fed by TMA (flash_wgmma_kernel, repro_flash_attention_wgmma).
//
// One CTA per (b, tile of 128 queries, h), h fastest, so the H CTAs of
// one (b, query tile), which read the same kv head's K/V under GQA, run
// together and share K/V through L2. 384 threads in three warpgroups:
//   - warpgroup 0, the producer: one thread issues TMA loads
//     (cp.async.bulk.tensor, 128-byte swizzle, tensor maps encoded on the
//     host and passed as __grid_constant__) of the Q tile once, then of
//     each live kv tile's K and V into a ring of two stages, each stage
//     with its own "full" (K, V) and "empty" mbarriers;
//   - warpgroups 1 and 2, the consumers, each own 64 query rows. Per kv
//     tile of 64 keys: S = Q K^T on wgmma m64n64k16 (A and B from shared
//     memory, K-major) with float32 accumulators; the mask, only where
//     the diagonal, the window's edge or Skv cuts the tile; the online
//     softmax in float32 registers (the row's max and sum over the 4
//     threads that hold it); O = O * alpha + P V on wgmma m64n{hd}k16
//     with P from registers and V from shared memory (MN-major, the
//     transpose flag). O stays in registers; at the end O / max(l,
//     1e-30) is rounded to bf16 and stored.
// setmaxnreg moves registers from the producer (24) to the consumers
// (240): at hd 256 O alone is 128 float32 registers a thread.
//
// Numerics. Q K^T multiplies bf16 inputs exactly and sums in float32, as
// the plain version does. P is float32; it is fed to the bf16 wgmma as
// P = hi + lo, two bf16 parts (hi = bf16(P), lo = bf16(P - hi)), so P V
// is exact to ~2^-16 of P before the float32 sum, where one bf16 P would
// carry 2^-9 and fail the one-rounding gate (chip_smoke.py's control).
//
// Shared memory (hd 256): Q 128 x 256 (64 KB) + 2 stages x (K + V) 64 x
// 256 (128 KB) = 192 KB, plus 1 KB for the swizzle's alignment. A tile
// of 64 columns (128 bytes) per TMA box: Q is hd/64 boxes of 128 rows, K
// and V hd/64 boxes of 64 rows.
//
// Bound on the H100: operations, 4 hd flops per live (query, key) pair
// at the bf16 tensor-core peak (989 TFLOP/s); with the split P the
// kernel does 6 hd (P V twice).
// ---------------------------------------------------------------------------

constexpr int kWBQ = 128;          // queries per CTA (2 consumer warpgroups x 64)
constexpr int kWBK = 64;           // keys per kv tile
constexpr int kWThreads = 384;     // producer + 2 consumer warpgroups
constexpr int kBox = 64;           // columns per TMA box: 128 bytes of bf16
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct WSmem {
  static constexpr int kBoxes = HD / kBox;
  static constexpr int kQBox = kWBQ * kBox;           // elements per Q box
  static constexpr int kKVBox = kWBK * kBox;          // elements per K/V box
  static constexpr int kQ = kBoxes * kQBox;           // Q tile elements
  static constexpr int kKV = kBoxes * kKVBox;         // K (or V) tile elements
  static constexpr size_t kBytes = 2 * (static_cast<size_t>(kQ) + 4 * kKV) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// One TMA box (64 columns x rows) at (col, row, plane) into dst.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int row, int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row), "r"(plane)
      : "memory");
}

// A wgmma shared-memory descriptor of the 128-byte swizzle: start address,
// leading and stride byte offsets (in 16-byte units).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// D (64 x 64, float32) (+)= A (64 x 16, shared, K-major) B^T (B 64 x 16,
// shared, K-major), bf16 operands.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, float32) += A (64 x 16, registers) B (16 x 64, shared,
// MN-major: the transpose flag set), bf16 operands.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// D (64 x 128, float32) += A (64 x 16, registers) B (16 x 128, shared,
// MN-major: the transpose flag set), bf16 operands.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// D (64 x 256, float32) += A (64 x 16, registers) B (16 x 256, shared,
// MN-major: the transpose flag set), bf16 operands.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (HD == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n256(o, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kWThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out, int H,
                   int K, int sq, int skv, int causal, int window, float scale_log2) {
  using L = WSmem<HD>;
  extern __shared__ uint8_t w_raw[];
  __shared__ __align__(8) uint64_t q_full, k_full[2], v_full[2], kv_empty[2];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(w_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __nv_bfloat16* Ks = Qs + L::kQ;      // [stage][box][64 rows][64]
  __nv_bfloat16* Vs = Ks + 2 * L::kKV;

  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int n_qt = gridDim.y;
  // causal without a window: the last query tiles see the most keys; start them first
  const int qt = (causal && window <= 0) ? n_qt - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kWBQ;
  const int bh = b * H + h;
  const int kvp = b * K + h / (H / K);   // the kv head's plane

  // the live kv tiles of this query tile (the skip predicate of _fa_body)
  int kt_end = (skv + kWBK - 1) / kWBK;
  if (causal) kt_end = min(kt_end, (q0 + kWBQ - 1) / kWBK + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window - kWBK + 2;  // least live key tile start
    kt_begin = lo <= 0 ? 0 : (lo + kWBK - 1) / kWBK;
  }
  const int n_kt = max(0, kt_end - kt_begin);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(&q_full, L::kQ * 2);
      for (int bx = 0; bx < L::kBoxes; ++bx)
        tma_load(Qs + bx * L::kQBox, &tm_q, &q_full, bx * kBox, q0, bh);
      for (int i = 0; i < n_kt; ++i) {
        const int st = i & 1;
        mbar_wait(&kv_empty[st], ((i >> 1) & 1) ^ 1);
        const int k0 = (kt_begin + i) * kWBK;
        mbar_expect_tx(&k_full[st], L::kKV * 2);
        for (int bx = 0; bx < L::kBoxes; ++bx)
          tma_load(Ks + st * L::kKV + bx * L::kKVBox, &tm_k, &k_full[st], bx * kBox, k0, kvp);
        mbar_expect_tx(&v_full[st], L::kKV * 2);
        for (int bx = 0; bx < L::kBoxes; ++bx)
          tma_load(Vs + st * L::kKV + bx * L::kKVBox, &tm_v, &v_full[st], bx * kBox, k0, kvp);
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = (tid - 128) >> 7;   // 0 or 1: query rows wg*64 .. wg*64+63
    const int t = tid & 127;
    const int warp = t >> 5, lane = t & 31;
    const int r0 = 16 * warp + (lane >> 2);   // this thread's rows: r0 and r0 + 8
    const int c0 = 2 * (lane & 3);            // and columns c0, c0 + 1 of each 8
    const int qa = q0 + wg * 64;              // the warpgroup's first query
    const int qi0 = qa + r0, qi1 = qi0 + 8;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    const uint32_t q_base = smem_addr(Qs) + wg * 64 * 128;
    mbar_wait(&q_full, 0);

    for (int i = 0; i < n_kt; ++i) {
      const int st = i & 1;
      const int par = (i >> 1) & 1;
      const int k0 = (kt_begin + i) * kWBK;
      const uint32_t k_base = smem_addr(Ks + st * L::kKV);
      const uint32_t v_base = smem_addr(Vs + st * L::kKV);

      // S = Q K^T: hd/16 steps of k16; within a 64-column box a step
      // moves the start by 32 bytes, a box by its size
      float s[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = 0.f;
      mbar_wait(&k_full[st], par);
      wgmma_fence();
#pragma unroll
      for (int d = 0; d < HD / 16; ++d) {
        const uint32_t bx = d >> 2, kk = d & 3;
        wgmma_ss_n64(s, wgmma_desc(q_base + bx * (L::kQBox * 2) + kk * 32, 16, 1024),
                     wgmma_desc(k_base + bx * (L::kKVBox * 2) + kk * 32, 16, 1024), d > 0);
      }
      wgmma_commit();
      wgmma_wait_all();

      // the mask, only on a tile that the diagonal, the window's edge or
      // Skv cuts for this warpgroup's rows
      const bool cut = k0 + kWBK > skv || (causal && k0 + kWBK - 1 > qa) ||
                       (window > 0 && qa + 63 - k0 >= window);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e] * scale_log2;
          if (cut) {
            const int kj = k0 + 8 * j + c0 + (e & 1);
            const int qi = e < 2 ? qi0 : qi1;
            bool ok = kj < skv;
            if (causal) ok = ok && qi >= kj;
            if (window > 0) ok = ok && qi - kj < window;
            x = ok ? x : kNegInf;
          }
          s[4 * j + e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
      uint32_t ph[16], pl[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = exp2f(s[4 * j] - mn0), p1 = exp2f(s[4 * j + 1] - mn0);
        const float p2 = exp2f(s[4 * j + 2] - mn1), p3 = exp2f(s[4 * j + 3] - mn1);
        ls0 += p0 + p1;
        ls1 += p2 + p3;
        ph[2 * j] = pack_bf16(p0, p1);
        ph[2 * j + 1] = pack_bf16(p2, p3);
        const __nv_bfloat162 h01 = *reinterpret_cast<const __nv_bfloat162*>(&ph[2 * j]);
        const __nv_bfloat162 h23 = *reinterpret_cast<const __nv_bfloat162*>(&ph[2 * j + 1]);
        pl[2 * j] = pack_bf16(p0 - __bfloat162float(h01.x), p1 - __bfloat162float(h01.y));
        pl[2 * j + 1] = pack_bf16(p2 - __bfloat162float(h23.x), p3 - __bfloat162float(h23.y));
      }
      l0 = l0 * al0 + ls0;   // the row sums are reduced once, at the end
      l1 = l1 * al1 + ls1;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= al0;
        o[4 * j + 1] *= al0;
        o[4 * j + 2] *= al1;
        o[4 * j + 3] *= al1;
      }

      // O += P V: 4 steps of 16 keys; A = P from registers in the
      // accumulator's layout (keys 16 ks .. 16 ks + 15 are S's column
      // groups 2 ks and 2 ks + 1), B = V rows 16 ks .. (2 KB a step),
      // 64-column boxes 8 KB apart
      mbar_wait(&v_full[st], par);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t dv = wgmma_desc(v_base + ks * 2048, L::kKVBox * 2, 1024);
        const uint32_t ah[4] = {ph[4 * ks], ph[4 * ks + 1], ph[4 * ks + 2], ph[4 * ks + 3]};
        const uint32_t al[4] = {pl[4 * ks], pl[4 * ks + 1], pl[4 * ks + 2], pl[4 * ks + 3]};
        wgmma_pv<HD>(o, ah, dv);
        wgmma_pv<HD>(o, al, dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      mbar_arrive(&kv_empty[st]);
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    __nv_bfloat16* op = out + static_cast<size_t>(bh) * sq * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int c = 8 * j + c0;
      if (qi0 < sq)
        *reinterpret_cast<__nv_bfloat162*>(op + static_cast<size_t>(qi0) * HD + c) =
            __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (qi1 < sq)
        *reinterpret_cast<__nv_bfloat162*>(op + static_cast<size_t>(qi1) * HD + c) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

// cuTensorMapEncodeTiled, found through the runtime (no libcuda at link time)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (planes, rows, hd) bf16 tensor as a 3-D map of boxes (64 columns, box_rows, 1).
bool make_map(CUtensorMap* map, const void* base, int planes, int rows, int hd, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(rows) * hd * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kBox), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int H, int K,
                         int sq, int skv, int causal, int window, float scale,
                         cudaStream_t stream) {
  constexpr size_t smem = WSmem<HD>::kBytes;
  static_assert(smem <= 232448 - 64, "shared memory over the H100's 227 KB per block");
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B * H, sq, HD, kWBQ) || !make_map(&tk, k, B * K, skv, HD, kWBK) ||
      !make_map(&tv, v, B * K, skv, HD, kWBK))
    return cudaErrorInvalidValue;
  auto kern = flash_wgmma_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (sq + kWBQ - 1) / kWBQ, B);
  kern<<<grid, kWThreads, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(out), H, K, sq,
                                          skv, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t dispatch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int H,
                           int K, int sq, int skv, int hd, int causal, int window, float scale,
                           cudaStream_t st) {
  switch (hd) {
    case 64: return launch_wgmma<64>(q, k, v, out, B, H, K, sq, skv, causal, window, scale, st);
    case 128: return launch_wgmma<128>(q, k, v, out, B, H, K, sq, skv, causal, window, scale, st);
    case 256: return launch_wgmma<256>(q, k, v, out, B, H, K, sq, skv, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, out: (B, H, Sq, hd); k, v: (B, K, Skv, hd); contiguous, all of one
// dtype: 0 = float32 (hd in {16, 32, 64, 96, 128, 256}), 1 = bfloat16 (hd
// in {16, 32, 96}). K | H.
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

// The same for bfloat16 at hd in {64, 128, 256}, on wgmma and TMA.
int repro_flash_attention_wgmma(const void* q, const void* k, const void* v, void* out, int B,
                                int H, int K, int sq, int skv, int hd, int causal, int window,
                                float scale, void* stream) {
  if (sq <= 0 || B <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (K <= 0 || H % K != 0 || skv <= 0 || (sq + kWBQ - 1) / kWBQ > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_wgmma(q, k, v, out, B, H, K, sq, skv, hd, causal, window, scale,
                                         static_cast<cudaStream_t>(stream)));
}

const char* repro_flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
