// Decode attention: one query token of every (batch, kv head) against a
// bfloat16 ring KV cache, over its live slots only, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: repro's decode attention (models/layers.py,
// attention_decode) is plain jnp, and the port ran it as PyTorch ops that
// upcast the whole cache to float32 each step and masked the unwritten
// slots afterwards. This computes the same function over the live slots:
//
//   for q (B, K, g, hd) float32 or bf16, k, v (B, K, Smax, hd) bf16 and the live
//   slots [lo, lo + live) of the ring (the wrapper derives them from the
//   mask: written slots, and the local window),
//     s_t = (q . k_t) / sqrt(hd)                  float32 products and sums
//     p_t = bf16(exp(s_t - max s) / sum exp(s - max s))   softmax in float32,
//                                                  normalised, then rounded
//     out = sum_t p_t v_t                          float32 products and sums
//
// exactly the arithmetic of ops.py's plain version (ref.py): bf16 K/V (and
// a bf16 q) are widened exactly, nothing is rounded to TF32 or to
// bf16 but the normalised probabilities, and no slot outside the live range
// is read. Every product runs on the float32 FMA units.
//
// Bound on the H100: bytes. Per step and layer, 2 * live * hd * 2 bytes of
// K and V for each (b, kv head) and ~4 * g * hd flops a slot: ~1 flop a
// byte, against ~295 for the tensor cores. phi4-mini's 96 sessions at 3072
// live slots read 1.2 GB a layer, ~0.36 ms at 3.35 TB/s.
//
// How: the normalised probability is rounded before the weighted sum, so
// the softmax's maximum and sum have to be known before any p_t is formed,
// and the work is done in two passes over the slots, split into chunks
// (flash-decoding) so that enough blocks fill the card:
//   1. decode_scores_kernel, grid (B*K, splits, head groups of 4): each
//      block streams its chunk of K once for up to 4 query heads of its kv
//      head (GQA: a K row is read once for its group), writes the float32
//      scores to scratch (B*K, g, live), and the chunk's (max, sum of
//      exp(s - max)) for each head;
//   2. decode_weights_kernel, same grid: each block reduces the chunks'
//      pairs to the softmax's max and sum (in chunk order), forms each p_t
//      of its chunk into shared memory, streams its chunk of V once and
//      writes the float32 partial sum of p_t v_t; the p_t are already
//      normalised, so the partials only add;
//   3. decode_combine_kernel sums the partials in chunk order.
// Every reduction runs in a fixed order: a call's result is repeatable, with
// no float atomics. Rows are read as 16-byte vectors (8 bf16), hd / 8
// neighbouring threads to a row (16 at hd 96, whose upper 4 idle), each
// thread loading 4 rows before it uses them, with the streaming cache hint
// (K and V are read once; the scores stay in L2 for the second look). A
// thread's 16 dot products (4 rows, 4 heads) are summed over the row's
// threads by a butterfly that halves at each level the products a thread
// keeps: 15 shuffles for 4 rows at 16 threads a row, where one butterfly a
// product takes 48 at 3 heads (the scores kernel at phi4-mini's decode
// shape and 4096 live slots: 0.41 ms with the one, 0.34 with the other;
// H100 80GB HBM3, 700 W).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 4;       // query heads of one kv head a block takes
constexpr int kUnroll = 4;      // rows a thread loads before it uses them
constexpr int kTile = 512;      // slots whose probabilities a block holds
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

constexpr int kDots = kUnroll * kHeads;   // dot products a thread starts an iteration with

__host__ __device__ constexpr int log2i(int n) { return n <= 1 ? 0 : 1 + log2i(n / 2); }

template <int HD>
struct Rows {
  static constexpr int kLanes = HD / 8;        // 16-byte vectors in a row
  static constexpr int kTpr =                  // threads a row takes
      kLanes <= 2 ? 2 : kLanes <= 4 ? 4 : kLanes <= 8 ? 8 : kLanes <= 16 ? 16 : 32;
  static constexpr int kRows = kThreads / kTpr;   // rows a block takes at once
  // the butterfly over a row's lanes: its first kHalving levels halve the
  // dot products a lane holds, which ends with kKept whole ones
  static constexpr int kLevels = log2i(kTpr);
  static constexpr int kHalving = kLevels < log2i(kDots) ? kLevels : log2i(kDots);
  static constexpr int kKept = kDots >> kHalving;
  static_assert(HD % 8 == 0 && kLanes <= 32, "head dim");
};

// the 8 bf16 of a 16-byte vector, widened exactly to float32
__device__ __forceinline__ void widen(const uint4& w, float (&f)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// max (kMax) or sum over the block of each head's value, in a fixed order:
// a butterfly in each warp, then the warps in order. red holds
// kWarps * kHeads floats. Every thread gets the results.
template <bool kMax>
__device__ __forceinline__ void block_reduce(float (&x)[kHeads], float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < kHeads; ++h) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float y = __shfl_xor_sync(kFull, x[h], off);
      x[h] = kMax ? fmaxf(x[h], y) : x[h] + y;
    }
  }
  __syncthreads();   // red may still be read by an earlier reduction
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < kHeads; ++h) red[warp * kHeads + h] = x[h];
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < kHeads; ++h) {
    float r = red[h];
    for (int w = 1; w < kWarps; ++w) {
      r = kMax ? fmaxf(r, red[w * kHeads + h]) : r + red[w * kHeads + h];
    }
    x[h] = r;
  }
}

// Pass 1: scores of one chunk of slots for up to kHeads query heads, and
// the chunk's (max, sum of exp(s - max)) of each head.
template <int HD>
__global__ void __launch_bounds__(kThreads)
decode_scores_kernel(const void* __restrict__ q, int q_bf16, const __nv_bfloat16* __restrict__ k,
                     float* scores, float2* __restrict__ pairs, int g, int smax, int lo,
                     int live, int splits, int chunk, float scale) {
  using R = Rows<HD>;
  __shared__ float red[kWarps * kHeads];
  const int bk = blockIdx.x, split = blockIdx.y, h0 = blockIdx.z * kHeads;
  const int hn = min(kHeads, g - h0);
  const int lane = threadIdx.x % R::kTpr, row = threadIdx.x / R::kTpr;
  const bool active = lane < R::kLanes;
  const int t0 = split * chunk, t1 = min(live, t0 + chunk);

  float qr[kHeads][8];
#pragma unroll
  for (int h = 0; h < kHeads; ++h) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int64_t i = (static_cast<int64_t>(bk) * g + h0 + h) * HD + lane * 8 + e;
      qr[h][e] = !(active && h < hn) ? 0.f
                 : q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i])
                          : static_cast<const float*>(q)[i];
    }
  }
  const uint4* kr = reinterpret_cast<const uint4*>(
      k + (static_cast<int64_t>(bk) * smax + lo) * HD);
  float* sr = scores + (static_cast<int64_t>(bk) * g + h0) * live;

  // the dot products a lane keeps: kKept of them, from position `first`
  // of the (row u, head h) pairs u * kHeads + h; after a plain level
  // (kLevels > kHalving) two lanes hold each, and one of them writes it
  int first = 0;
#pragma unroll
  for (int level = 0; level < R::kHalving; ++level) {
    if (lane & (R::kTpr >> (level + 1))) first += (kDots >> level) / 2;
  }
  const bool writer = (lane & ((1 << (R::kLevels - R::kHalving)) - 1)) == 0;

  float mx[kHeads];
#pragma unroll
  for (int h = 0; h < kHeads; ++h) mx[h] = neg_inf();
  // the loop's bound is the same for every thread: the shuffles below need
  // every lane of the warp
  for (int base = t0; base < t1; base += R::kRows * kUnroll) {
    uint4 kv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * R::kRows + row;
      kv[u] = (active && t < t1) ? __ldcs(kr + static_cast<int64_t>(t) * R::kLanes + lane)
                                 : make_uint4(0, 0, 0, 0);
    }
    float d[kDots];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[8];
      widen(kv[u], kf);
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        float a = 0.f;
        if (h < hn) {                    // hn: the same in the whole block
#pragma unroll
          for (int e = 0; e < 8; ++e) a = fmaf(qr[h][e], kf[e], a);
        }
        d[u * kHeads + h] = a;
      }
    }
    // sum each dot product over the row's lanes: at each halving level a
    // lane keeps one half of its products, adds its partner's copy of that
    // half, and sends the other half to the partner
#pragma unroll
    for (int level = 0; level < R::kLevels; ++level) {
      const int off = R::kTpr >> (level + 1);
      if (level < R::kHalving) {
        const int half = (kDots >> level) / 2;
        const bool upper = lane & off;
#pragma unroll
        for (int i = 0; i < half; ++i) {
          const float keep = upper ? d[i + half] : d[i];
          const float send = upper ? d[i] : d[i + half];
          d[i] = keep + __shfl_xor_sync(kFull, send, off);
        }
      } else {
        d[0] += __shfl_xor_sync(kFull, d[0], off);
      }
    }
#pragma unroll
    for (int i = 0; i < R::kKept; ++i) {
      const int j = first + i, h = j % kHeads;
      const int t = base + (j / kHeads) * R::kRows + row;
      if (h < hn && t < t1) {
        const float s = d[i] / scale;
        if (writer) sr[static_cast<int64_t>(h) * live + t] = s;
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh) {
          if (hh == h) mx[hh] = fmaxf(mx[hh], s);
        }
      }
    }
  }
  block_reduce<true>(mx, red);     // its barrier also publishes the scores

  float l[kHeads];
#pragma unroll
  for (int h = 0; h < kHeads; ++h) l[h] = 0.f;
  for (int t = t0 + threadIdx.x; t < t1; t += kThreads) {
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      if (h < hn) l[h] += expf(sr[static_cast<int64_t>(h) * live + t] - mx[h]);
    }
  }
  block_reduce<false>(l, red);
  const int tid = threadIdx.x;
  if (tid < hn) {
    float m = mx[0], s = l[0];
#pragma unroll
    for (int h = 1; h < kHeads; ++h) {
      if (tid == h) m = mx[h], s = l[h];
    }
    pairs[(static_cast<int64_t>(bk) * splits + split) * g + h0 + tid] = make_float2(m, s);
  }
}

// Pass 2: the softmax's max and sum from every chunk's pair, the chunk's
// normalised probabilities rounded to bf16, and their float32 sum of p v.
// (4 blocks an SM: 64 registers, which this kernel takes without spilling;
// the scores kernel spills at 64, and runs 3 blocks an SM at ~72-80)
template <int HD>
__global__ void __launch_bounds__(kThreads, 4)
decode_weights_kernel(const __nv_bfloat16* __restrict__ v, const float* __restrict__ scores,
                      const float2* __restrict__ pairs, float* __restrict__ partials, int g,
                      int smax, int lo, int live, int splits, int chunk) {
  using R = Rows<HD>;
  __shared__ float ms[kHeads], ls[kHeads];
  __shared__ float4 ps[kTile];                      // a tile's p, one float4 a slot
  __shared__ float red[kWarps][kHeads][HD];
  const int bk = blockIdx.x, split = blockIdx.y, h0 = blockIdx.z * kHeads;
  const int hn = min(kHeads, g - h0);
  const int lane = threadIdx.x % R::kTpr, row = threadIdx.x / R::kTpr;
  const int warp = threadIdx.x / 32, wlane = threadIdx.x % 32;
  const bool active = lane < R::kLanes;
  const int t0 = split * chunk, t1 = min(live, t0 + chunk);

  const int tid = threadIdx.x;
  if (tid < hn) {
    const float2* pr = pairs + static_cast<int64_t>(bk) * splits * g + h0 + tid;
    float m = neg_inf(), s = 0.f;
    for (int c = 0; c < splits; ++c) m = fmaxf(m, pr[static_cast<int64_t>(c) * g].x);
    for (int c = 0; c < splits; ++c) {
      const float2 p = pr[static_cast<int64_t>(c) * g];
      s += p.y * expf(p.x - m);
    }
    ms[tid] = m;
    ls[tid] = s;
  }
  const uint4* vr = reinterpret_cast<const uint4*>(
      v + (static_cast<int64_t>(bk) * smax + lo) * HD);
  const float* sr = scores + (static_cast<int64_t>(bk) * g + h0) * live;

  float acc[kHeads][8];
#pragma unroll
  for (int h = 0; h < kHeads; ++h) {
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[h][e] = 0.f;
  }
  for (int tb = t0; tb < t1; tb += kTile) {
    const int tn = min(kTile, t1 - tb);
    __syncthreads();   // ms/ls written; the last tile's ps read
    for (int i = threadIdx.x; i < tn; i += kThreads) {
      float p[kHeads];
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        p[h] = h < hn ? __bfloat162float(__float2bfloat16_rn(
                            expf(sr[static_cast<int64_t>(h) * live + tb + i] - ms[h]) / ls[h]))
                      : 0.f;
      }
      ps[i] = make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();
    for (int base = 0; base < tn; base += R::kRows * kUnroll) {
      uint4 vv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = base + u * R::kRows + row;
        vv[u] = (active && r < tn)
                    ? __ldcs(vr + static_cast<int64_t>(tb + r) * R::kLanes + lane)
                    : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = base + u * R::kRows + row;
        if (r < tn) {
          float vf[8];
          widen(vv[u], vf);
          const float4 p4 = ps[r];
          const float p[kHeads] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int h = 0; h < kHeads; ++h) {
            if (h < hn) {
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[h][e] = fmaf(p[h], vf[e], acc[h][e]);
            }
          }
        }
      }
    }
  }
  // the warp's rows, then the warps in order
#pragma unroll
  for (int off = 16; off >= R::kTpr; off >>= 1) {
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[h][e] += __shfl_xor_sync(kFull, acc[h][e], off);
    }
  }
  if (wlane < R::kTpr && active) {
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
#pragma unroll
      for (int e = 0; e < 8; ++e) red[warp][h][lane * 8 + e] = acc[h][e];
    }
  }
  __syncthreads();
  float* out = partials + ((static_cast<int64_t>(bk) * splits + split) * g + h0) * HD;
  for (int i = threadIdx.x; i < hn * HD; i += kThreads) {
    const int h = i / HD, d = i % HD;
    float s = red[0][h][d];
    for (int w = 1; w < kWarps; ++w) s += red[w][h][d];
    out[i] = s;
  }
}

// Pass 3: out (B*K, g*hd) = the partials (B*K, splits, g*hd) summed in
// chunk order.
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ partials, float* __restrict__ out, int64_t n,
                      int ghd, int splits) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t bk = i / ghd, j = i % ghd;
    const float* p = partials + bk * splits * ghd + j;
    float s = 0.f;
    for (int c = 0; c < splits; ++c) s += p[static_cast<int64_t>(c) * ghd];
    out[i] = s;
  }
}

// One call's pointers and sizes (see repro_decode_attention).
struct Call {
  const void* q;
  int q_bf16;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  float* scores;
  float2* pairs;
  float* partials;
  float* out;
  int bk, g, smax, lo, live, splits, chunk;
  float scale;
  cudaStream_t stream;
};

template <int HD>
int launch(const Call& c) {
  const dim3 grid(c.bk, c.splits, (c.g + kHeads - 1) / kHeads);
  decode_scores_kernel<HD><<<grid, kThreads, 0, c.stream>>>(
      c.q, c.q_bf16, c.k, c.scores, c.pairs, c.g, c.smax, c.lo, c.live, c.splits, c.chunk,
      c.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_weights_kernel<HD><<<grid, kThreads, 0, c.stream>>>(
      c.v, c.scores, c.pairs, c.partials, c.g, c.smax, c.lo, c.live, c.splits, c.chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(c.bk) * c.g * HD;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  decode_combine_kernel<<<static_cast<unsigned>(blocks < 65535 ? blocks : 65535), kThreads, 0,
                          c.stream>>>(c.partials, c.out, n, c.g * HD, c.splits);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int resident_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_scores_kernel<HD>,
                                                        kThreads, 0);
  }
  *blocks = sms * per_sm;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// q (B*K, g, hd) float32, or bf16 when q_bf16; k, v (B*K, smax, hd)
// bf16, 16-byte aligned; the live slots [lo, lo + live); scratch: 16-byte
// aligned float32 for the scores (B*K, g, live), the pairs (B*K, splits, g)
// of float2 and the partials (B*K, splits, g, hd), one after the other; out
// (B*K, g, hd) float32. Chunk c takes slots [c * chunk, (c + 1) * chunk) of
// the live ones, and every chunk has at least one. Returns the CUDA error
// of the launches (0 = success).
int repro_decode_attention(const void* q, int q_bf16, const void* k, const void* v,
                           void* scratch, void* out, int bk, int g, int smax, int hd, int lo,
                           int live, int splits, int chunk, float scale, void* stream) {
  if (bk <= 0 || g <= 0 || lo < 0 || live <= 0 || lo + live > smax || splits <= 0 ||
      splits > 65535 || chunk <= 0 || (splits - 1) * static_cast<int64_t>(chunk) >= live ||
      splits * static_cast<int64_t>(chunk) < live || (g + kHeads - 1) / kHeads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the scratch's three parts, each from a 16-byte boundary
  const auto up16 = [](int64_t floats) { return (floats + 3) / 4 * 4; };
  float* scores = static_cast<float*>(scratch);
  const int64_t n_scores = up16(static_cast<int64_t>(bk) * g * live);
  const int64_t n_pairs = up16(static_cast<int64_t>(bk) * splits * g * 2);
  const Call c{q, q_bf16, static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v), scores,
               reinterpret_cast<float2*>(scores + n_scores), scores + n_scores + n_pairs,
               static_cast<float*>(out), bk, g, smax, lo, live, splits, chunk, scale,
               static_cast<cudaStream_t>(stream)};
  switch (hd) {
    case 16: return launch<16>(c);
    case 32: return launch<32>(c);
    case 64: return launch<64>(c);
    case 96: return launch<96>(c);
    case 128: return launch<128>(c);
    case 256: return launch<256>(c);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The blocks of the scores kernel at head dim hd that the current device
// holds at once (its SMs times the occupancy), into *blocks.
int repro_decode_attention_resident(int hd, int* blocks) {
  switch (hd) {
    case 16: return resident_blocks<16>(blocks);
    case 32: return resident_blocks<32>(blocks);
    case 64: return resident_blocks<64>(blocks);
    case 96: return resident_blocks<96>(blocks);
    case 128: return resident_blocks<128>(blocks);
    case 256: return resident_blocks<256>(blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
