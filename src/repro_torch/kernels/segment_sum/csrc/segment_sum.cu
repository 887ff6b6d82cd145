// Masked segment SUM and MIN/MAX, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of repro/kernels/segment_sum/kernel.py:
//   masked_segment_sum_kernel    (body _segsum_body)    -> repro_segment_sum_atomic
//                                                           (integers), repro_run_order +
//                                                           repro_segment_sum (floats)
//   masked_segment_reduce_kernel (body _segreduce_body) -> repro_segment_reduce_atomic
//
// What it computes (held against the `reference` backend, not carried
// over block by block): per segment, the SUM (or MIN/MAX) of the valid
// lanes and the int32 count of valid lanes. Lanes whose id lies outside
// [0, S) contribute nothing. Integer sums wrap like numpy's in the value
// dtype (accumulated in an unsigned type, truncated at the end). A NaN in
// a valid lane poisons its MIN/MAX; an empty segment holds the identity
// (MIN/MAX) or zero (SUM). On equal values the LATER row wins, as
// np.minimum(acc, v) does row by row: that decides the sign of a tied
// +-0.0, the only tie whose values differ in their bits.
//
// The TPU kernel one-hot-reduces (block_n x block_s) tiles because TPU
// Pallas has no scatter. Here integer SUMs and every MIN/MAX are exact in
// any order, so they take integer atomics (the sections below). Only a
// float SUM needs a fixed order, for bitwise-repeatable sums without float
// atomics: its rows come in run order from the stable radix partition
// (repro_run_order, last section), so each segment is a contiguous run:
//   1. init:  every output starts empty;
//   2. tile:  one block per tile of kTile rows. Each thread sums its
//             kItems rows in row order; a segment wholly inside a thread
//             is written at once. A segmented Hillis-Steele scan over the
//             threads' pieces (fixed order) finishes the segments that
//             cross threads. A segment crossing the tile's left or right
//             edge leaves its piece in lo[tile] / hi[tile];
//   3. carry: one warp per tile whose right-edge segment starts in it
//             combines hi[tile], lo[tile+1], ... in tile order: each lane
//             a contiguous range, then an ordered shuffle tree.
// Every combine takes the earlier piece on the left, and the tree shapes
// are fixed by n alone, so float sums are bitwise the same on every run
// (fingerprints and cache keys depend on this).
//
// Bound on the H100: bytes. Each kernel reads each row once, n*(itemsize
// + 4 + 1) bytes, and writes S*(itemsize + 4); at 3.35 TB/s that is
// about 24 us for n = 6M float64 rows. They do a handful of operations
// per byte, far below the card's rates.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;   // rows per block in the tile pass
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum Op { kMin = 1, kMax = 2 };

// Integer SUM accumulates in an unsigned type: wraparound is defined
// there, and truncating to the value dtype at the end gives numpy's sum.
template <typename T> struct AccOf { using type = T; };
template <> struct AccOf<int8_t> { using type = uint32_t; };
template <> struct AccOf<int16_t> { using type = uint32_t; };
template <> struct AccOf<int32_t> { using type = uint32_t; };
template <> struct AccOf<int64_t> { using type = uint64_t; };
template <> struct AccOf<uint8_t> { using type = uint32_t; };

template <typename A>
__device__ __forceinline__ A shfl_down(A x, int off) {
  if constexpr (sizeof(A) < 4) return static_cast<A>(__shfl_down_sync(kFull, static_cast<int>(x), off));
  else return __shfl_down_sync(kFull, x, off);
}

// ---------------------------------------------------------------------------
// Float SUM over run-ordered rows.
// ---------------------------------------------------------------------------

template <typename T>
struct Piece {
  T v;      // the partial sum; 0 when cnt == 0
  int cnt;  // valid lanes
};

template <typename T>
__device__ __forceinline__ Piece<T> lift(T v, uint8_t ok) {
  return ok ? Piece<T>{v, 1} : Piece<T>{T(0), 0};
}

// L holds earlier rows than R. An empty piece is the identity, so a sum
// starts from its first valid value, as the reference does.
template <typename T>
__device__ __forceinline__ Piece<T> combine(const Piece<T>& L, const Piece<T>& R) {
  if (R.cnt == 0) return L;
  if (L.cnt == 0) return R;
  return {L.v + R.v, L.cnt + R.cnt};
}

template <typename T>
__device__ __forceinline__ void store(T* out, int* counts, int s, const Piece<T>& p) {
  counts[s] = p.cnt;
  out[s] = p.v;
}

template <typename T>
__global__ void init_kernel(T* __restrict__ out, int* __restrict__ counts, int S) {
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < S; s += gridDim.x * blockDim.x) {
    out[s] = T(0);
    counts[s] = 0;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) tile_kernel(
    const T* __restrict__ values, const int* __restrict__ ids, const uint8_t* __restrict__ valid,
    long long n, int S, T* __restrict__ out, int* __restrict__ counts,
    Piece<T>* __restrict__ lo, Piece<T>* __restrict__ hi) {
  __shared__ Piece<T> s_val[kThreads];
  __shared__ int s_reset[kThreads];
  __shared__ int s_head[kThreads];
  __shared__ int s_tail[kThreads];

  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const long long end = min(n, base + kTile);
  const int t = threadIdx.x;
  const long long r0 = base + static_cast<long long>(t) * kItems;
  const int nr = r0 < end ? static_cast<int>(min(static_cast<long long>(kItems), end - r0)) : 0;
  const bool last_active = nr > 0 && r0 + nr == end;
  const int first_seg = ids[base];
  const int last_seg = ids[end - 1];
  const bool open_left = base > 0 && ids[base - 1] == first_seg;   // first segment began earlier
  const bool open_right = end < n && ids[end] == last_seg;         // last segment goes on

  // 1. this thread's rows, in row order
  Piece<T> head = lift<T>(T(0), 0);
  Piece<T> cur = head;
  int hseg = 0, tseg = 0;
  bool single = true;  // one segment across all of this thread's rows
  if (nr > 0) {
    hseg = tseg = ids[r0];
    cur = lift<T>(values[r0], valid[r0]);
    for (int i = 1; i < nr; ++i) {
      const int s = ids[r0 + i];
      const Piece<T> x = lift<T>(values[r0 + i], valid[r0 + i]);
      if (s == tseg) {
        cur = combine<T>(cur, x);
        continue;
      }
      if (single) {
        head = cur;
        single = false;
      } else if (tseg >= 0 && tseg < S) {
        store<T>(out, counts, tseg, cur);  // began and ended in this thread
      }
      tseg = s;
      cur = x;
    }
  }
  s_head[t] = hseg;
  s_tail[t] = tseg;
  __syncthreads();

  // 2. segmented inclusive scan of the tail pieces: after it, `a` holds
  // the tail segment's rows from its start in this tile to this thread's end.
  const bool cont_head = nr > 0 && t > 0 && s_tail[t - 1] == hseg;
  int reset = !(single && cont_head);
  Piece<T> a = cur;
  for (int d = 1; d < kThreads; d <<= 1) {
    s_val[t] = a;
    s_reset[t] = reset;
    __syncthreads();
    if (t >= d) {
      if (!reset) a = combine<T>(s_val[t - d], a);
      reset |= s_reset[t - d];
    }
    __syncthreads();
  }
  s_val[t] = a;
  __syncthreads();
  if (nr == 0) return;

  // 3. finish the segments that end in this thread
  const unsigned b = blockIdx.x;
  if (!single) {  // the head segment ends before this thread's last row
    const Piece<T> h = cont_head ? combine<T>(s_val[t - 1], head) : head;
    if (open_left && hseg == first_seg) lo[b] = h;
    else if (hseg >= 0 && hseg < S) store<T>(out, counts, hseg, h);
  }
  if (last_active || s_head[t + 1] != tseg) {  // the tail segment ends here
    const bool left = open_left && tseg == first_seg;
    const bool right = last_active && open_right;
    if (left) lo[b] = a;
    if (right) hi[b] = a;
    if (!left && !right && tseg >= 0 && tseg < S) store<T>(out, counts, tseg, a);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) carry_kernel(
    const int* __restrict__ ids, long long n, int S, int n_tiles,
    const Piece<T>* __restrict__ lo, const Piece<T>* __restrict__ hi,
    T* __restrict__ out, int* __restrict__ counts) {
  const int tile = static_cast<int>((static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (tile >= n_tiles) return;  // whole warps leave together
  const long long base = static_cast<long long>(tile) * kTile;
  const long long end = min(n, base + kTile);
  if (end >= n) return;
  const int s = ids[end - 1];
  if (ids[end] != s) return;                                  // nothing crosses the right edge
  if (base > 0 && ids[base] == s && ids[base - 1] == s) return;  // s began in an earlier tile
  if (s < 0 || s >= S) return;
  // tiles tile+1 .. last-1 begin with s; tile first ids never decrease
  int first = tile + 1, last = n_tiles;
  while (first < last) {
    const int mid = first + (last - first) / 2;
    if (ids[static_cast<long long>(mid) * kTile] == s) first = mid + 1;
    else last = mid;
  }
  const int m = first - tile;  // pieces: hi[tile], lo[tile+1 .. first-1]
  const int per = (m + 31) / 32;
  const int k0 = min(m, lane * per), k1 = min(m, k0 + per);
  Piece<T> acc = lift<T>(T(0), 0);
  for (int k = k0; k < k1; ++k) acc = combine<T>(acc, k == 0 ? hi[tile] : lo[tile + k]);
  // ordered tree: lane i combines with lane i+off, whose range is later
  for (int off = 1; off < 32; off <<= 1) {
    Piece<T> o;
    o.v = shfl_down(acc.v, off);
    o.cnt = __shfl_down_sync(kFull, acc.cnt, off);
    if (lane + off < 32) acc = combine<T>(acc, o);
  }
  if (lane == 0) store<T>(out, counts, s, acc);
}

template <typename T>
cudaError_t launch_sum_runs(const void* values, const int* ids, const uint8_t* valid, long long n,
                            int S, void* out, int* counts, void* scratch, cudaStream_t stream) {
  T* o = static_cast<T*>(out);
  if (S <= 0) return cudaGetLastError();
  const long long want = (static_cast<long long>(S) + kThreads - 1) / kThreads;
  const int init_blocks = static_cast<int>(want < 4096 ? want : 4096);
  init_kernel<T><<<init_blocks, kThreads, 0, stream>>>(o, counts, S);
  if (n > 0) {
    const int n_tiles = static_cast<int>((n + kTile - 1) / kTile);
    Piece<T>* lo = static_cast<Piece<T>*>(scratch);
    Piece<T>* hi = lo + n_tiles;
    tile_kernel<T><<<n_tiles, kThreads, 0, stream>>>(
        static_cast<const T*>(values), ids, valid, n, S, o, counts, lo, hi);
    carry_kernel<T><<<(n_tiles + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
        ids, n, S, n_tiles, lo, hi, o, counts);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Integer SUM without run order. Integer addition is associative and
// commutative in AccOf's unsigned type (the wrap is defined there), so
// integer atomics give the same bits in any order, and the truncation to
// the value dtype at the end is numpy's sum. Three shapes by S, with
// switch points from measurement (PERF.md):
//   S <= kRegSwitch:    each thread keeps S sums and counts in registers,
//                       a warp reduces them with shuffles, the warps add
//                       into shared bins, and each block issues one global
//                       atomic per bin (at Q1's S = 4, six million atomics
//                       on four words would serialize; int64 shared bins
//                       take twice its time there);
//   S <= kSharedSwitch: each block adds into S shared bins (at most 48 KB,
//                       four blocks an SM), then one global atomic per
//                       (block, non-empty bin): at TPC-H Q9's 175 groups,
//                       global atomics take 20 times as long;
//   otherwise:          global atomics straight away (Q18's 1.5M x 12 B of
//                       outputs sit in the 50 MB L2), one per run of equal
//                       ids within a warp's 32 rows: a group's rows that
//                       lie together in the table (Q18's orders) cost one
//                       atomic pair, scattered ids one pair per row.
// Bound: bytes, as the run-order kernels (one read of the rows, one
// write of the outputs).
// ---------------------------------------------------------------------------

constexpr int kRegBins = 16;
constexpr int kAtomicThreads = 256;
// The switch points. The one-off timing script
// src/repro_torch/examples/segment_switch.py rebuilds this file with -D
// to time each shape at one S; nothing else sets them.
#ifndef REPRO_SEGMENT_REG_SWITCH
#define REPRO_SEGMENT_REG_SWITCH 16
#endif
#ifndef REPRO_SEGMENT_SHARED_SWITCH
#define REPRO_SEGMENT_SHARED_SWITCH 4096
#endif
constexpr int kRegSwitch = REPRO_SEGMENT_REG_SWITCH;
constexpr int kSharedSwitch = REPRO_SEGMENT_SHARED_SWITCH;
static_assert(kRegSwitch <= kRegBins, "the register shape holds kRegBins bins");
static_assert(kSharedSwitch * (sizeof(uint64_t) + sizeof(int)) <= 48 * 1024,
              "the shared bins stay within the default 48 KB a block");

__device__ __forceinline__ uint32_t atomic_add(uint32_t* p, uint32_t v) {
  return atomicAdd(p, v);
}
__device__ __forceinline__ uint64_t atomic_add(uint64_t* p, uint64_t v) {
  return static_cast<uint64_t>(atomicAdd(reinterpret_cast<unsigned long long*>(p),
                                         static_cast<unsigned long long>(v)));
}

template <typename T>
__global__ void __launch_bounds__(kAtomicThreads) sum_reg_kernel(
    const T* __restrict__ values, const int* __restrict__ ids, const uint8_t* __restrict__ valid,
    long long n, int S, typename AccOf<T>::type* __restrict__ acc,
    int* __restrict__ counts) {
  using A = typename AccOf<T>::type;
  __shared__ A s_acc[kRegBins];
  __shared__ int s_cnt[kRegBins];
  if (threadIdx.x < kRegBins) {
    s_acc[threadIdx.x] = 0;
    s_cnt[threadIdx.x] = 0;
  }
  A a[kRegBins];
  int c[kRegBins];
#pragma unroll
  for (int b = 0; b < kRegBins; ++b) {
    a[b] = 0;
    c[b] = 0;
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int s = valid[r] ? ids[r] : -1;
    const A v = static_cast<A>(values[r]);
#pragma unroll
    for (int b = 0; b < kRegBins; ++b) {
      const bool hit = s == b;   // bins S .. kRegBins-1 catch ids >= S and are dropped
      a[b] += hit ? v : A(0);
      c[b] += hit;
    }
  }
  __syncthreads();  // the shared bins are zero
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < kRegBins; ++b) {
    if (b >= S) break;
    A x = a[b];
    int k = c[b];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x += shfl_down(x, off);
      k += __shfl_down_sync(kFull, k, off);
    }
    if (lane == 0 && k > 0) {
      atomic_add(&s_acc[b], x);
      atomicAdd(&s_cnt[b], k);
    }
  }
  __syncthreads();
  const int b = threadIdx.x;
  if (b < S && s_cnt[b] > 0) {
    atomic_add(&acc[b], s_acc[b]);
    atomicAdd(&counts[b], s_cnt[b]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kAtomicThreads) sum_shared_kernel(
    const T* __restrict__ values, const int* __restrict__ ids, const uint8_t* __restrict__ valid,
    long long n, int S, typename AccOf<T>::type* __restrict__ acc,
    int* __restrict__ counts) {
  using A = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char s_raw[];
  A* s_acc = reinterpret_cast<A*>(s_raw);
  int* s_cnt = reinterpret_cast<int*>(s_acc + S);
  for (int b = threadIdx.x; b < S; b += blockDim.x) {
    s_acc[b] = 0;
    s_cnt[b] = 0;
  }
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int s = ids[r];
    if (valid[r] && s >= 0 && s < S) {
      atomic_add(&s_acc[s], static_cast<A>(values[r]));
      atomicAdd(&s_cnt[s], 1);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < S; b += blockDim.x) {
    if (s_cnt[b] > 0) {
      atomic_add(&acc[b], s_acc[b]);
      atomicAdd(&counts[b], s_cnt[b]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kAtomicThreads) sum_global_kernel(
    const T* __restrict__ values, const int* __restrict__ ids, const uint8_t* __restrict__ valid,
    long long n, int S, typename AccOf<T>::type* __restrict__ acc,
    int* __restrict__ counts) {
  using A = typename AccOf<T>::type;
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // whole warps walk the rows together, lane i on row base + i
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long r0 = first - lane; r0 < n; r0 += stride) {
    const long long r = r0 + lane;
    int s = -1;
    A v = 0;
    if (r < n && valid[r]) {
      s = ids[r];
      v = static_cast<A>(values[r]);
    }
    if (s >= S) s = -1;
    // a run of lanes with one id (rows of a group lie together in the
    // table's order) adds up first, and its first lane alone goes to
    // device memory: each lane sums its run from itself to the run's end
    const int next = __shfl_down_sync(kFull, s, 1);
    const unsigned ends = __ballot_sync(kFull, lane == 31 || next != s);
    const int end = __ffs(ends & (kFull << lane)) - 1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const A y = shfl_down(v, off);
      if (lane + off <= end) v += y;
    }
    const int prev = __shfl_up_sync(kFull, s, 1);
    if (s >= 0 && (lane == 0 || prev != s)) {
      atomic_add(&acc[s], v);
      atomicAdd(&counts[s], end - lane + 1);
    }
  }
}

// out[s] = the low bits of acc[s] (numpy's wrap in the value dtype).
template <typename T>
__global__ void truncate_kernel(const typename AccOf<T>::type* __restrict__ acc,
                                T* __restrict__ out, int S) {
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < S; s += gridDim.x * blockDim.x)
    out[s] = static_cast<T>(acc[s]);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

template <typename T>
size_t atomic_shared_bytes(int S) {
  return static_cast<size_t>(S) * (sizeof(typename AccOf<T>::type) + sizeof(int));
}

// Which of the three shapes a launch takes: 0 registers, 1 shared, 2 global.
int atomic_path(int S) {
  if (S <= kRegSwitch) return 0;
  if (S <= kSharedSwitch) return 1;
  return 2;
}

template <typename T>
cudaError_t launch_atomic(const void* values, const int* ids, const uint8_t* valid, long long n,
                          int S, void* out, int* counts, void* scratch, cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  if (S <= 0) return cudaGetLastError();
  // same width: add into the output in place; narrower: into the scratch,
  // then truncate
  A* acc = sizeof(A) == sizeof(T) ? static_cast<A*>(out) : static_cast<A*>(scratch);
  cudaError_t err = cudaMemsetAsync(acc, 0, static_cast<size_t>(S) * sizeof(A), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(counts, 0, static_cast<size_t>(S) * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const T* v = static_cast<const T*>(values);
  const long long want = (n + kAtomicThreads - 1) / kAtomicThreads;
  if (n > 0) {
    switch (atomic_path(S)) {
      case 0: {
        const int blocks = static_cast<int>(want < 2 * sm_count() ? want : 2 * sm_count());
        sum_reg_kernel<T><<<blocks, kAtomicThreads, 0, stream>>>(v, ids, valid, n, S, acc, counts);
        break;
      }
      case 1: {
        const long long cap = 4LL * sm_count();
        const int blocks = static_cast<int>(want < cap ? want : cap);
        sum_shared_kernel<T><<<blocks, kAtomicThreads, atomic_shared_bytes<T>(S), stream>>>(
            v, ids, valid, n, S, acc, counts);
        break;
      }
      default: {
        const long long cap = 16LL * sm_count();
        const int blocks = static_cast<int>(want < cap ? want : cap);
        sum_global_kernel<T><<<blocks, kAtomicThreads, 0, stream>>>(v, ids, valid, n, S, acc,
                                                                    counts);
      }
    }
  }
  if (sizeof(A) != sizeof(T)) {
    const long long tb = (static_cast<long long>(S) + kAtomicThreads - 1) / kAtomicThreads;
    truncate_kernel<T><<<static_cast<int>(tb < 4096 ? tb : 4096), kAtomicThreads, 0, stream>>>(
        acc, static_cast<T*>(out), S);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// MIN/MAX without run order. Each valid value maps to an unsigned key that
// orders as the values do (floats: the sign bit flipped for positives, all
// bits for negatives, after -0.0 -> +0.0; signed integers: the sign bit
// flipped, int8/int16 first widened to 32 bits as AccOf does; uint8 as it
// is), so MIN/MAX is an integer atomicMin/atomicMax on the key, native for
// 32- and 64-bit keys. A NaN lane takes the key that wins every compare
// (0 for MIN, all ones for MAX), which no other value's key reaches: the
// NaN poisons its segment whatever the order. Counts are integer
// atomicAdds. The one tie whose values differ in their bits is +-0.0, and
// there the later row wins: each zero lane does atomicMax(last_zero[s],
// row), and when a segment's result is zero the finish pass takes it from
// values[last_zero[s]]. Every step is an integer and order-free, so the
// result is the plain version's bits on every launch.
//
// The same three shapes by S and switch points as the integer SUM:
// per-thread register bins up to kRegSwitch (a warp's atomics on four
// words would serialize), shared bins up to kSharedSwitch (key, count
// and, while they fit the default 48 KB, a float's last zero row: all but
// float64 past S = 3072, whose zero lanes go to global last_zero), global
// atomics above, one per run of equal ids within a warp's 32 rows.
// Then finish_kernel decodes each key in place.
// ---------------------------------------------------------------------------

template <typename T> struct KeyOf { using type = uint32_t; };
template <> struct KeyOf<int64_t> { using type = uint64_t; };
template <> struct KeyOf<double> { using type = uint64_t; };

template <typename T> struct Lim;
template <> struct Lim<int8_t> {
  __device__ static int8_t lo() { return INT8_MIN; }
  __device__ static int8_t hi() { return INT8_MAX; }
};
template <> struct Lim<int16_t> {
  __device__ static int16_t lo() { return INT16_MIN; }
  __device__ static int16_t hi() { return INT16_MAX; }
};
template <> struct Lim<int32_t> {
  __device__ static int32_t lo() { return INT32_MIN; }
  __device__ static int32_t hi() { return INT32_MAX; }
};
template <> struct Lim<int64_t> {
  __device__ static int64_t lo() { return INT64_MIN; }
  __device__ static int64_t hi() { return INT64_MAX; }
};
template <> struct Lim<uint8_t> {
  __device__ static uint8_t lo() { return 0; }
  __device__ static uint8_t hi() { return UINT8_MAX; }
};
template <> struct Lim<float> {
  __device__ static float lo() { return __int_as_float(static_cast<int>(0xff800000u)); }
  __device__ static float hi() { return __int_as_float(static_cast<int>(0x7f800000u)); }
  __device__ static float nan() { return __int_as_float(static_cast<int>(0x7fc00000u)); }
};
template <> struct Lim<double> {
  __device__ static double lo() {
    return __longlong_as_double(static_cast<long long>(0xfff0000000000000ULL));
  }
  __device__ static double hi() {
    return __longlong_as_double(static_cast<long long>(0x7ff0000000000000ULL));
  }
  __device__ static double nan() {
    return __longlong_as_double(static_cast<long long>(0x7ff8000000000000ULL));
  }
};

// The key an empty bin starts from, and a NaN lane's: the identity of the
// key reduction, and its opposite.
template <typename K, int OP>
__device__ __forceinline__ K empty_key() {
  return OP == kMin ? ~K(0) : K(0);
}
template <typename K, int OP>
__device__ __forceinline__ K nan_key() {
  return OP == kMin ? K(0) : ~K(0);
}

template <typename T, int OP>
__device__ __forceinline__ typename KeyOf<T>::type to_key(T v) {
  using K = typename KeyOf<T>::type;
  constexpr K sign = K(1) << (8 * sizeof(K) - 1);
  if constexpr (std::is_floating_point<T>::value) {
    if (v != v) return nan_key<K, OP>();
    K u;
    if constexpr (sizeof(T) == 4) u = __float_as_uint(v == 0.0f ? 0.0f : v);
    else u = static_cast<K>(__double_as_longlong(v == 0.0 ? 0.0 : v));
    return (u & sign) ? ~u : (u | sign);
  } else if constexpr (std::is_signed<T>::value) {
    using SK = typename std::make_signed<K>::type;
    return static_cast<K>(static_cast<SK>(v)) ^ sign;
  } else {
    return static_cast<K>(v);
  }
}

template <typename T>
__device__ __forceinline__ T from_key(typename KeyOf<T>::type k) {
  using K = typename KeyOf<T>::type;
  constexpr K sign = K(1) << (8 * sizeof(K) - 1);
  if constexpr (std::is_floating_point<T>::value) {
    const K u = (k & sign) ? (k & ~sign) : ~k;
    if constexpr (sizeof(T) == 4) return __uint_as_float(u);
    else return __longlong_as_double(static_cast<long long>(u));
  } else if constexpr (std::is_signed<T>::value) {
    using SK = typename std::make_signed<K>::type;
    return static_cast<T>(static_cast<SK>(k ^ sign));
  } else {
    return static_cast<T>(k);
  }
}

template <typename T>
__device__ __forceinline__ bool is_zero(T v) {
  if constexpr (std::is_floating_point<T>::value) return v == T(0);
  else return false;
}

template <typename K, int OP>
__device__ __forceinline__ K pick(K a, K b) {
  if constexpr (OP == kMin) return b < a ? b : a;
  else return b > a ? b : a;
}

template <int OP>
__device__ __forceinline__ void atomic_pick(uint32_t* p, uint32_t k) {
  if constexpr (OP == kMin) atomicMin(p, k);
  else atomicMax(p, k);
}
template <int OP>
__device__ __forceinline__ void atomic_pick(uint64_t* p, uint64_t k) {
  auto* q = reinterpret_cast<unsigned long long*>(p);
  if constexpr (OP == kMin) atomicMin(q, static_cast<unsigned long long>(k));
  else atomicMax(q, static_cast<unsigned long long>(k));
}

template <typename T, int OP>
__global__ void __launch_bounds__(kAtomicThreads) reduce_reg_kernel(
    const T* __restrict__ values, const int* __restrict__ ids, const uint8_t* __restrict__ valid,
    long long n, int S, typename KeyOf<T>::type* __restrict__ keys, int* __restrict__ counts,
    int* __restrict__ last_zero) {
  using K = typename KeyOf<T>::type;
  __shared__ K s_key[kRegBins];
  __shared__ int s_cnt[kRegBins];
  __shared__ int s_zero[kRegBins];
  if (threadIdx.x < kRegBins) {
    s_key[threadIdx.x] = empty_key<K, OP>();
    s_cnt[threadIdx.x] = 0;
    s_zero[threadIdx.x] = -1;
  }
  K a[kRegBins];
  int c[kRegBins], z[kRegBins];
#pragma unroll
  for (int b = 0; b < kRegBins; ++b) {
    a[b] = empty_key<K, OP>();
    c[b] = 0;
    z[b] = -1;
  }
  // kAhead rows' loads in flight a thread, then their bins in row order
  constexpr int kAhead = 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; r0 < n;
       r0 += kAhead * stride) {
    int sv[kAhead];
    T vv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const long long r = r0 + u * stride;
      const bool in = r < n;
      sv[u] = in && valid[r] ? ids[r] : -1;
      vv[u] = in ? values[r] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int s = sv[u];
      const K k = to_key<T, OP>(vv[u]);
      const bool zero = is_zero(vv[u]);
      const int row = static_cast<int>(r0 + u * stride);
#pragma unroll
      for (int b = 0; b < kRegBins; ++b) {
        if (b >= S) break;       // ids outside [0, S) meet no bin
        const bool hit = s == b;
        a[b] = hit ? pick<K, OP>(a[b], k) : a[b];
        c[b] += hit;
        z[b] = hit && zero ? row : z[b];  // this thread's rows rise
      }
    }
  }
  __syncthreads();  // the shared bins are set
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < kRegBins; ++b) {
    if (b >= S) break;
    K x = a[b];
    int k = c[b], zz = z[b];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x = pick<K, OP>(x, shfl_down(x, off));
      k += __shfl_down_sync(kFull, k, off);
      zz = max(zz, __shfl_down_sync(kFull, zz, off));
    }
    if (lane == 0 && k > 0) {
      atomic_pick<OP>(&s_key[b], x);
      atomicAdd(&s_cnt[b], k);
      if (zz >= 0) atomicMax(&s_zero[b], zz);
    }
  }
  __syncthreads();
  const int b = threadIdx.x;
  if (b < S && s_cnt[b] > 0) {
    atomic_pick<OP>(&keys[b], s_key[b]);
    atomicAdd(&counts[b], s_cnt[b]);
    if (s_zero[b] >= 0) atomicMax(&last_zero[b], s_zero[b]);
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kAtomicThreads) reduce_shared_kernel(
    const T* __restrict__ values, const int* __restrict__ ids, const uint8_t* __restrict__ valid,
    long long n, int S, typename KeyOf<T>::type* __restrict__ keys, int* __restrict__ counts,
    int* __restrict__ last_zero, int zero_bins) {
  using K = typename KeyOf<T>::type;
  extern __shared__ __align__(16) unsigned char r_raw[];
  K* s_key = reinterpret_cast<K*>(r_raw);
  int* s_cnt = reinterpret_cast<int*>(s_key + S);
  // a float's zero lanes: into shared bins when they fit, else straight
  // to last_zero
  int* s_zero = s_cnt + S;
  int* zeros = zero_bins ? s_zero : last_zero;
  for (int b = threadIdx.x; b < S; b += blockDim.x) {
    s_key[b] = empty_key<K, OP>();
    s_cnt[b] = 0;
    if (zero_bins) s_zero[b] = -1;
  }
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int s = ids[r];
    if (valid[r] && s >= 0 && s < S) {
      const T v = values[r];
      atomic_pick<OP>(&s_key[s], to_key<T, OP>(v));
      atomicAdd(&s_cnt[s], 1);
      if (is_zero(v)) atomicMax(&zeros[s], static_cast<int>(r));
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < S; b += blockDim.x) {
    if (s_cnt[b] > 0) {
      atomic_pick<OP>(&keys[b], s_key[b]);
      atomicAdd(&counts[b], s_cnt[b]);
      if (zero_bins && s_zero[b] >= 0) atomicMax(&last_zero[b], s_zero[b]);
    }
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kAtomicThreads) reduce_global_kernel(
    const T* __restrict__ values, const int* __restrict__ ids, const uint8_t* __restrict__ valid,
    long long n, int S, typename KeyOf<T>::type* __restrict__ keys, int* __restrict__ counts,
    int* __restrict__ last_zero) {
  using K = typename KeyOf<T>::type;
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // whole warps walk the rows together, lane i on row base + i
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long r0 = first - lane; r0 < n; r0 += stride) {
    const long long r = r0 + lane;
    int s = -1;
    K k = empty_key<K, OP>();
    int z = -1;
    if (r < n && valid[r]) {
      s = ids[r];
      const T v = values[r];
      k = to_key<T, OP>(v);
      if (is_zero(v)) z = static_cast<int>(r);
    }
    if (s >= S) s = -1;
    // a run of lanes with one id reduces first, and its first lane alone
    // goes to device memory: each lane reduces its run from itself to the
    // run's end
    const int next = __shfl_down_sync(kFull, s, 1);
    const unsigned ends = __ballot_sync(kFull, lane == 31 || next != s);
    const int end = __ffs(ends & (kFull << lane)) - 1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const K y = shfl_down(k, off);
      const int zy = __shfl_down_sync(kFull, z, off);
      if (lane + off <= end) {
        k = pick<K, OP>(k, y);
        z = max(z, zy);
      }
    }
    const int prev = __shfl_up_sync(kFull, s, 1);
    if (s >= 0 && (lane == 0 || prev != s)) {
      atomic_pick<OP>(&keys[s], k);
      atomicAdd(&counts[s], end - lane + 1);
      if (z >= 0) atomicMax(&last_zero[s], z);
    }
  }
}

// out[s] from keys[s] (which may alias out): the identity when empty, the
// canonical NaN when poisoned, a zero's sign from the last zero row.
template <typename T, int OP>
__global__ void finish_kernel(const T* __restrict__ values,
                              const typename KeyOf<T>::type* keys, const int* __restrict__ counts,
                              const int* __restrict__ last_zero, T* out, int S) {
  using K = typename KeyOf<T>::type;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < S; s += gridDim.x * blockDim.x) {
    T v;
    if (counts[s] == 0) {
      v = OP == kMin ? Lim<T>::hi() : Lim<T>::lo();
    } else {
      const K k = keys[s];
      v = from_key<T>(k);
      if constexpr (std::is_floating_point<T>::value) {
        if (k == nan_key<K, OP>()) v = Lim<T>::nan();
        else if (v == T(0)) v = values[last_zero[s]];
      }
    }
    out[s] = v;
  }
}



template <typename T>
constexpr bool keys_in_out() {
  return sizeof(typename KeyOf<T>::type) == sizeof(T);
}

template <typename T, int OP>
cudaError_t launch_reduce_atomic(const void* values, const int* ids, const uint8_t* valid,
                                 long long n, int S, void* out, int* counts, void* scratch,
                                 cudaStream_t stream) {
  using K = typename KeyOf<T>::type;
  if (S <= 0) return cudaGetLastError();
  // same width: the keys live in the output and decode in place; narrower
  // values: keys in the scratch. Floats keep last_zero in the scratch.
  K* keys = keys_in_out<T>() ? static_cast<K*>(out) : static_cast<K*>(scratch);
  int* last_zero = std::is_floating_point<T>::value ? static_cast<int*>(scratch) : nullptr;
  cudaError_t err = cudaMemsetAsync(keys, OP == kMin ? 0xff : 0,
                                    static_cast<size_t>(S) * sizeof(K), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(counts, 0, static_cast<size_t>(S) * sizeof(int), stream);
  if (err == cudaSuccess && last_zero != nullptr)
    err = cudaMemsetAsync(last_zero, 0xff, static_cast<size_t>(S) * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const T* v = static_cast<const T*>(values);
  const long long want = (n + kAtomicThreads - 1) / kAtomicThreads;
  if (n > 0) {
    switch (atomic_path(S)) {
      case 0: {
        const int blocks = static_cast<int>(want < 2 * sm_count() ? want : 2 * sm_count());
        reduce_reg_kernel<T, OP><<<blocks, kAtomicThreads, 0, stream>>>(v, ids, valid, n, S,
                                                                        keys, counts, last_zero);
        break;
      }
      case 1: {
        const long long cap = 4LL * sm_count();
        const int blocks = static_cast<int>(want < cap ? want : cap);
        // key and count a bin, and a float's last zero row while the
        // bins stay within the default 48 KB (float64 to S = 3072)
        size_t smem = static_cast<size_t>(S) * (sizeof(K) + sizeof(int));
        const int zero_bins = std::is_floating_point<T>::value &&
                              smem + static_cast<size_t>(S) * sizeof(int) <= 48 * 1024;
        if (zero_bins) smem += static_cast<size_t>(S) * sizeof(int);
        reduce_shared_kernel<T, OP><<<blocks, kAtomicThreads, smem, stream>>>(
            v, ids, valid, n, S, keys, counts, last_zero, zero_bins);
        break;
      }
      default: {
        const long long cap = 16LL * sm_count();
        const int blocks = static_cast<int>(want < cap ? want : cap);
        reduce_global_kernel<T, OP><<<blocks, kAtomicThreads, 0, stream>>>(
            v, ids, valid, n, S, keys, counts, last_zero);
      }
    }
  }
  const long long fb = (static_cast<long long>(S) + kAtomicThreads - 1) / kAtomicThreads;
  finish_kernel<T, OP><<<static_cast<int>(fb < 4096 ? fb : 4096), kAtomicThreads, 0, stream>>>(
      v, keys, counts, last_zero, static_cast<T*>(out), S);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Run order without a general sort: a stable LSD radix partition of the
// rows by key = (id in [0, S) ? id : S), over only the ceil(log2(S + 1))
// bits the keys need, in passes of at most 8 bits (1 pass at S = 4, 3 of
// 7 bits at S = 1.5M). Values and validity ride along as payload, copied
// as raw bits, so there is no int64 permutation and no gather. Each pass:
//   1. histogram: one block per tile of kPTile rows counts its digits
//      (shared atomics: a count does not depend on their order) into
//      hist[digit][tile];
//   2. scan:      one block per digit turns hist[digit][*] into the
//      exclusive prefix over tiles, in tile order, and writes the digit's
//      total;
//   3. scatter:   each block takes the exclusive prefix of the totals (the
//      digit's start), walks its tile warp by warp in row order, ranks
//      each row among the earlier rows of its digit (a ballot per digit
//      bit, and per-warp counters), reorders the tile by digit in shared
//      memory, and writes each digit's run out at start + prefix,
//      neighbouring threads on neighbouring rows, so the stores coalesce.
// Every step is integer and in a fixed order, so the output is the same
// on every launch, and stable: rows of one key keep their row order, so
// a float SUM adds each segment's rows in a fixed order. The output feeds
// tile_kernel / carry_kernel above unchanged; key S lies outside [0, S),
// so those rows contribute nothing there.
// ---------------------------------------------------------------------------

constexpr int kPThreads = 256;
constexpr int kPWarps = kPThreads / 32;
constexpr int kPChunks = 16;                        // 32-row chunks per warp
constexpr int kPWarpRows = 32 * kPChunks;           // rows per warp
constexpr int kPTile = kPWarps * kPWarpRows;        // rows per block: 4096
constexpr int kMaxDigits = 256;

struct PassPlan {
  int passes = 0;
  int bits = 0;  // digit bits per pass
};

PassPlan plan_passes(int S) {
  int need = 0;  // bits to hold keys 0 .. S
  while ((1LL << need) < static_cast<long long>(S) + 1) ++need;
  PassPlan p;
  p.passes = (need + 7) / 8;
  p.bits = p.passes ? (need + p.passes - 1) / p.passes : 0;
  return p;
}

__device__ __forceinline__ int key_of(const int* __restrict__ keys, long long r, int S, bool raw) {
  const int id = keys[r];
  return raw ? ((id >= 0 && id < S) ? id : S) : id;
}

__global__ void __launch_bounds__(kPThreads) radix_hist_kernel(
    const int* __restrict__ keys, long long n, int S, int raw, int shift, int digits,
    int n_tiles, int* __restrict__ hist) {
  __shared__ int h[kMaxDigits];
  for (int d = threadIdx.x; d < digits; d += kPThreads) h[d] = 0;
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kPTile;
  const long long end = min(n, base + kPTile);
  for (long long r = base + threadIdx.x; r < end; r += kPThreads) {
    const int d = (key_of(keys, r, S, raw) >> shift) & (digits - 1);
    atomicAdd(&h[d], 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < digits; d += kPThreads)
    hist[static_cast<long long>(d) * n_tiles + blockIdx.x] = h[d];
}

// Block-wide exclusive scan of one int per thread; returns the block's total.
__device__ __forceinline__ int block_exclusive_scan(int x, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    const int t = s_warp[w];
    if (w < warp) before += t;
    all += t;
  }
  __syncthreads();  // s_warp may be written again
  total = all;
  return before + inc - x;
}

__global__ void __launch_bounds__(kPThreads) radix_scan_kernel(int* __restrict__ hist,
                                                              int n_tiles,
                                                              int* __restrict__ totals) {
  __shared__ int s_warp[kPWarps];
  int* row = hist + static_cast<long long>(blockIdx.x) * n_tiles;
  int carry = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += kPThreads) {
    const int t = t0 + threadIdx.x;
    const int x = t < n_tiles ? row[t] : 0;
    int total;
    const int ex = block_exclusive_scan(x, s_warp, total);
    if (t < n_tiles) row[t] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// Dynamic shared memory of the scatter: per warp and digit a counter, the
// tile's digit starts (global and local), and the tile reordered by digit.
template <typename P>
constexpr size_t scatter_smem() {
  return sizeof(int) * (kPWarps * kMaxDigits + 2 * kMaxDigits + kPWarps) +
         static_cast<size_t>(kPTile) * (sizeof(P) + sizeof(int) + 1);
}

template <typename P>
__global__ void __launch_bounds__(kPThreads) radix_scatter_kernel(
    const int* __restrict__ keys, const P* __restrict__ vals, const uint8_t* __restrict__ valid,
    long long n, int S, int raw, int shift, int bits, int n_tiles,
    const int* __restrict__ hist, const int* __restrict__ totals, int* __restrict__ keys_out,
    P* __restrict__ vals_out, uint8_t* __restrict__ valid_out) {
  const int digits = 1 << bits;
  extern __shared__ __align__(16) unsigned char p_raw[];
  P* t_val = reinterpret_cast<P*>(p_raw);                        // [kPTile]
  int* cnt = reinterpret_cast<int*>(t_val + kPTile);             // [kPWarps][kMaxDigits]
  int* gstart = cnt + kPWarps * kMaxDigits;                      // [kMaxDigits]
  int* lstart = gstart + kMaxDigits;                             // [kMaxDigits]
  int* s_warp = lstart + kMaxDigits;                             // [kPWarps]
  int* t_key = s_warp + kPWarps;                                 // [kPTile]
  uint8_t* t_ok = reinterpret_cast<uint8_t*>(t_key + kPTile);    // [kPTile]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const long long base = static_cast<long long>(blockIdx.x) * kPTile;
  const int rows = static_cast<int>(min(static_cast<long long>(kPTile), n - base));

  // 1. each digit's first output row for this tile: the exclusive prefix
  // of the totals (digits <= kPThreads: one round), plus the earlier
  // tiles' rows of that digit
  {
    int total;
    const int ex = block_exclusive_scan(tid < digits ? totals[tid] : 0, s_warp, total);
    if (tid < digits) gstart[tid] = ex + hist[static_cast<long long>(tid) * n_tiles + blockIdx.x];
  }
  for (int i = tid; i < kPWarps * kMaxDigits; i += kPThreads) cnt[i] = 0;
  __syncthreads();

  // 2. each warp walks its 512 rows in order, 32 at a time, and ranks
  // each row among the warp's earlier rows of its digit
  const int w0 = warp * kPWarpRows;
  int key[kPChunks], rank[kPChunks];   // only the keys wait in registers
#pragma unroll
  for (int c = 0; c < kPChunks; ++c) {
    const int i = w0 + c * 32 + lane;
    key[c] = i < rows ? key_of(keys, base + i, S, raw) : 0;
  }
#pragma unroll
  for (int c = 0; c < kPChunks; ++c) {
    const bool in = w0 + c * 32 + lane < rows;
    const int d = (key[c] >> shift) & (digits - 1);
    // the lanes of this digit: one ballot per digit bit
    unsigned peers = __ballot_sync(kFull, in);
#pragma unroll
    for (int bit = 0; bit < 8; ++bit) {
      if (bit < bits) {
        const unsigned on = __ballot_sync(kFull, (d >> bit) & 1);
        peers &= ((d >> bit) & 1) ? on : ~on;
      }
    }
    int* slot = &cnt[warp * kMaxDigits + (in ? d : 0)];
    const int before = *slot;
    rank[c] = before + __popc(peers & lt);
    __syncwarp();
    if (in && lane == 31 - __clz(peers)) *slot = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // 3. per digit: the warps' runs follow one another, the digits too
  {
    int run = 0;
    if (tid < digits) {
      for (int w = 0; w < kPWarps; ++w) {
        const int k = cnt[w * kMaxDigits + tid];
        cnt[w * kMaxDigits + tid] = run;
        run += k;
      }
    }
    int total;
    const int ex = block_exclusive_scan(tid < digits ? run : 0, s_warp, total);
    if (tid < digits) {
      lstart[tid] = ex;
      for (int w = 0; w < kPWarps; ++w) cnt[w * kMaxDigits + tid] += ex;
    }
  }
  __syncthreads();

  // 4. the tile, reordered by digit in shared memory (stable); the
  // payload is read only now, in row order
#pragma unroll
  for (int c = 0; c < kPChunks; ++c) {
    const int i = w0 + c * 32 + lane;
    if (i < rows) {
      const int d = (key[c] >> shift) & (digits - 1);
      const int at = cnt[warp * kMaxDigits + d] + rank[c];
      t_key[at] = key[c];
      t_val[at] = vals[base + i];
      t_ok[at] = valid[base + i];
    }
  }
  __syncthreads();

  // 5. out to device memory: neighbouring threads write neighbouring rows
  // of each digit's run
  for (int i = tid; i < rows; i += kPThreads) {
    const int k = t_key[i];
    const int d = (k >> shift) & (digits - 1);
    const int at = gstart[d] + (i - lstart[d]);
    keys_out[at] = k;
    vals_out[at] = t_val[i];
    valid_out[at] = t_ok[i];
  }
}

size_t align256(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

long long run_order_scratch(int itemsize, long long n, int S) {
  const PassPlan p = plan_passes(S);
  const long long n_tiles = (n + kPTile - 1) / kPTile;
  const size_t digits = static_cast<size_t>(1) << p.bits;
  return static_cast<long long>(align256(n * sizeof(int)) + align256(n * itemsize) +
                                align256(n) + align256(digits * n_tiles * sizeof(int)) +
                                align256(digits * sizeof(int)));
}

template <typename P>
cudaError_t launch_run_order(const void* values, const int* ids, const uint8_t* valid,
                             long long n, int S, void* values_out, int* ids_out,
                             uint8_t* valid_out, void* scratch, cudaStream_t stream) {
  const PassPlan plan = plan_passes(S);
  if (n <= 0 || plan.passes == 0) return cudaGetLastError();
  const int n_tiles = static_cast<int>((n + kPTile - 1) / kPTile);
  const int digits = 1 << plan.bits;
  unsigned char* at = static_cast<unsigned char*>(scratch);
  int* tmp_keys = reinterpret_cast<int*>(at);
  at += align256(n * sizeof(int));
  P* tmp_vals = reinterpret_cast<P*>(at);
  at += align256(n * sizeof(P));
  uint8_t* tmp_valid = at;
  at += align256(n);
  int* hist = reinterpret_cast<int*>(at);
  at += align256(static_cast<size_t>(digits) * n_tiles * sizeof(int));
  int* totals = reinterpret_cast<int*>(at);

  constexpr size_t smem = scatter_smem<P>();
  cudaError_t err = cudaFuncSetAttribute(radix_scatter_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int* k_in = ids;
  const P* v_in = static_cast<const P*>(values);
  const uint8_t* m_in = valid;
  for (int pass = 0; pass < plan.passes; ++pass) {
    // the last pass writes the caller's outputs
    const bool to_out = (plan.passes - 1 - pass) % 2 == 0;
    int* k_out = to_out ? ids_out : tmp_keys;
    P* v_out = to_out ? static_cast<P*>(values_out) : tmp_vals;
    uint8_t* m_out = to_out ? valid_out : tmp_valid;
    const int raw = pass == 0;
    const int shift = pass * plan.bits;
    radix_hist_kernel<<<n_tiles, kPThreads, 0, stream>>>(k_in, n, S, raw, shift, digits, n_tiles,
                                                         hist);
    radix_scan_kernel<<<digits, kPThreads, 0, stream>>>(hist, n_tiles, totals);
    radix_scatter_kernel<P><<<n_tiles, kPThreads, smem, stream>>>(
        k_in, v_in, m_in, n, S, raw, shift, plan.bits, n_tiles, hist, totals, k_out, v_out, m_out);
    k_in = k_out;
    v_in = v_out;
    m_in = m_out;
  }
  return cudaGetLastError();
}

// dtype codes, shared with kernel.py
// dtype codes, shared with kernel.py
enum DType { kI8 = 0, kI16 = 1, kI32 = 2, kI64 = 3, kU8 = 4, kF32 = 5, kF64 = 6 };

template <int OP>
cudaError_t dispatch_reduce(int dtype, const void* values, const int* ids, const uint8_t* valid,
                            long long n, int S, void* out, int* counts, void* scratch,
                            cudaStream_t stream) {
  switch (dtype) {
    case kI8: return launch_reduce_atomic<int8_t, OP>(values, ids, valid, n, S, out, counts, scratch, stream);
    case kI16: return launch_reduce_atomic<int16_t, OP>(values, ids, valid, n, S, out, counts, scratch, stream);
    case kI32: return launch_reduce_atomic<int32_t, OP>(values, ids, valid, n, S, out, counts, scratch, stream);
    case kI64: return launch_reduce_atomic<int64_t, OP>(values, ids, valid, n, S, out, counts, scratch, stream);
    case kU8: return launch_reduce_atomic<uint8_t, OP>(values, ids, valid, n, S, out, counts, scratch, stream);
    case kF32: return launch_reduce_atomic<float, OP>(values, ids, valid, n, S, out, counts, scratch, stream);
    case kF64: return launch_reduce_atomic<double, OP>(values, ids, valid, n, S, out, counts, scratch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Bytes of device scratch the float SUM needs for n rows (the lo/hi pieces).
long long repro_segment_scratch_bytes(long long n) {
  const long long n_tiles = (n + kTile - 1) / kTile;
  return 2 * n_tiles * static_cast<long long>(sizeof(Piece<double>));
}

// Float SUM over run-ordered rows (kF32, kF64).
int repro_segment_sum(int dtype, const void* values, const int* ids, const uint8_t* valid,
                      long long n, int S, void* out, int* counts, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kF32: err = launch_sum_runs<float>(values, ids, valid, n, S, out, counts, scratch, st); break;
    case kF64: err = launch_sum_runs<double>(values, ids, valid, n, S, out, counts, scratch, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Bytes of device scratch of the atomic kernels for S segments: an
// integer SUM's wide accumulators, a MIN/MAX's 32-bit keys or last_zero.
long long repro_segment_atomic_scratch_bytes(long long S) {
  return S * static_cast<long long>(sizeof(uint64_t));
}

// Integer SUM with integer atomics, in any row order (kI8 .. kU8 only).
int repro_segment_sum_atomic(int dtype, const void* values, const int* ids, const uint8_t* valid,
                             long long n, int S, void* out, int* counts, void* scratch,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kI8: err = launch_atomic<int8_t>(values, ids, valid, n, S, out, counts, scratch, st); break;
    case kI16: err = launch_atomic<int16_t>(values, ids, valid, n, S, out, counts, scratch, st); break;
    case kI32: err = launch_atomic<int32_t>(values, ids, valid, n, S, out, counts, scratch, st); break;
    case kI64: err = launch_atomic<int64_t>(values, ids, valid, n, S, out, counts, scratch, st); break;
    case kU8: err = launch_atomic<uint8_t>(values, ids, valid, n, S, out, counts, scratch, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// MIN/MAX with integer atomics on order keys, in any row order.
// op: 1 = MIN, 2 = MAX. n < 2^31 (last_zero holds int32 rows).
int repro_segment_reduce_atomic(int dtype, int op, const void* values, const int* ids,
                                const uint8_t* valid, long long n, int S, void* out, int* counts,
                                void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (op == kMin) return static_cast<int>(dispatch_reduce<kMin>(dtype, values, ids, valid, n, S, out, counts, scratch, st));
  if (op == kMax) return static_cast<int>(dispatch_reduce<kMax>(dtype, values, ids, valid, n, S, out, counts, scratch, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Stable run order of (values, ids, valid) by key (id in [0, S) ? id : S);
// itemsize is the values' bytes (1, 2, 4 or 8). n < 2^31.
long long repro_run_order_scratch_bytes(int itemsize, long long n, int S) {
  return run_order_scratch(itemsize, n, S);
}

int repro_run_order(int itemsize, const void* values, const int* ids, const uint8_t* valid,
                    long long n, int S, void* values_out, int* ids_out, uint8_t* valid_out,
                    void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (itemsize) {
    case 1: err = launch_run_order<uint8_t>(values, ids, valid, n, S, values_out, ids_out, valid_out, scratch, st); break;
    case 2: err = launch_run_order<uint16_t>(values, ids, valid, n, S, values_out, ids_out, valid_out, scratch, st); break;
    case 4: err = launch_run_order<uint32_t>(values, ids, valid, n, S, values_out, ids_out, valid_out, scratch, st); break;
    case 8: err = launch_run_order<uint64_t>(values, ids, valid, n, S, values_out, ids_out, valid_out, scratch, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
