// Masked segment SUM and MIN/MAX over run-ordered rows, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of repro/kernels/segment_sum/kernel.py:
//   masked_segment_sum_kernel    (body _segsum_body)    -> repro_segment_sum
//   masked_segment_reduce_kernel (body _segreduce_body) -> repro_segment_reduce
//
// What it computes (held against the `reference` backend, not carried
// over block by block): per segment, the SUM (or MIN/MAX) of the valid
// lanes and the int32 count of valid lanes. Lanes whose id lies outside
// [0, S) contribute nothing. Integer sums wrap like numpy's in the value
// dtype (accumulated in an unsigned type, truncated at the end). MIN/MAX
// start from the identity, park NaN lanes and count them, and a counted
// NaN poisons the segment; an empty segment holds the identity (MIN/MAX)
// or zero (SUM). On equal values the LATER row wins, as np.minimum(acc, v)
// does row by row: that decides the sign of a tied +-0.0. So the combine is
// an explicit compare, never fminf/fmaxf, whose sign on a tied zero is
// unspecified.
//
// The TPU kernel one-hot-reduces (block_n x block_s) tiles because TPU
// Pallas has no scatter. Here the rows arrive in run order (the wrapper
// sorts the ids stably, keeping row order within a segment), so each
// segment is a contiguous run and no atomics are needed:
//   1. init:  every output starts empty;
//   2. tile:  one block per tile of kTile rows. Each thread reduces its
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
// (no float atomics; fingerprints and cache keys depend on this).
//
// Bound on the H100: bytes. The kernel reads each row once, n*(itemsize
// + 4 + 1) bytes, and writes S*(itemsize + 4); at 3.35 TB/s that is
// about 24 us for n = 6M float64 rows. It does a handful of operations
// per byte, far below the card's rates. Its design keeps to one read of
// the rows (the carry pass reads only 2 pieces per tile) and writes each
// output once, from the block or warp that finished the segment.
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

enum Op { kSum = 0, kMin = 1, kMax = 2 };

// Integer SUM accumulates in an unsigned type: wraparound is defined
// there, and truncating to the value dtype at the end gives numpy's sum.
template <typename T, int OP> struct AccOf { using type = T; };
template <> struct AccOf<int8_t, kSum> { using type = uint32_t; };
template <> struct AccOf<int16_t, kSum> { using type = uint32_t; };
template <> struct AccOf<int32_t, kSum> { using type = uint32_t; };
template <> struct AccOf<int64_t, kSum> { using type = uint64_t; };
template <> struct AccOf<uint8_t, kSum> { using type = uint32_t; };

template <typename A>
struct Piece {
  A v;      // the partial SUM / MIN / MAX; `empty` when cnt == 0
  int cnt;  // valid lanes
  int nan;  // valid NaN lanes (MIN/MAX only)
};

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

// The value of an empty piece: 0 for SUM, the identity for MIN/MAX.
template <typename T, int OP>
__device__ __forceinline__ typename AccOf<T, OP>::type empty_value() {
  if constexpr (OP == kSum) return 0;
  else if constexpr (OP == kMin) return Lim<T>::hi();
  else return Lim<T>::lo();
}

template <typename T, int OP>
__device__ __forceinline__ Piece<typename AccOf<T, OP>::type> empty_piece() {
  return {empty_value<T, OP>(), 0, 0};
}

template <typename T, int OP>
__device__ __forceinline__ Piece<typename AccOf<T, OP>::type> lift(T v, uint8_t ok) {
  using A = typename AccOf<T, OP>::type;
  if (!ok) return empty_piece<T, OP>();
  if constexpr (OP != kSum && std::is_floating_point<T>::value) {
    if (v != v) return {empty_value<T, OP>(), 1, 1};  // parked NaN lane
  }
  return {static_cast<A>(v), 1, 0};
}

// L holds earlier rows than R. An empty piece is the identity, so a SUM
// starts from its first valid value, as the reference does.
template <typename A, int OP>
__device__ __forceinline__ Piece<A> combine(const Piece<A>& L, const Piece<A>& R) {
  if (R.cnt == 0) return L;
  if (L.cnt == 0) return R;
  Piece<A> o;
  o.cnt = L.cnt + R.cnt;
  o.nan = L.nan + R.nan;
  if constexpr (OP == kSum) o.v = L.v + R.v;
  else if constexpr (OP == kMin) o.v = (R.v <= L.v) ? R.v : L.v;  // later row wins a tie
  else o.v = (R.v >= L.v) ? R.v : L.v;
  return o;
}

template <typename T, typename A, int OP>
__device__ __forceinline__ void store(T* out, int* counts, int s, const Piece<A>& p) {
  counts[s] = p.cnt;
  if constexpr (OP != kSum && std::is_floating_point<T>::value) {
    if (p.nan > 0) {
      out[s] = Lim<T>::nan();
      return;
    }
  }
  out[s] = static_cast<T>(p.v);
}

template <typename A>
__device__ __forceinline__ A shfl_down(A x, int off) {
  if constexpr (sizeof(A) < 4) return static_cast<A>(__shfl_down_sync(kFull, static_cast<int>(x), off));
  else return __shfl_down_sync(kFull, x, off);
}

template <typename T, int OP>
__global__ void init_kernel(T* __restrict__ out, int* __restrict__ counts, int S) {
  const T e = static_cast<T>(empty_value<T, OP>());
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < S; s += gridDim.x * blockDim.x) {
    out[s] = e;
    counts[s] = 0;
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads) tile_kernel(
    const T* __restrict__ values, const int* __restrict__ ids, const uint8_t* __restrict__ valid,
    long long n, int S, T* __restrict__ out, int* __restrict__ counts,
    Piece<typename AccOf<T, OP>::type>* __restrict__ lo,
    Piece<typename AccOf<T, OP>::type>* __restrict__ hi) {
  using A = typename AccOf<T, OP>::type;
  __shared__ Piece<A> s_val[kThreads];
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
  Piece<A> head = empty_piece<T, OP>();
  Piece<A> cur = empty_piece<T, OP>();
  int hseg = 0, tseg = 0;
  bool single = true;  // one segment across all of this thread's rows
  if (nr > 0) {
    hseg = tseg = ids[r0];
    cur = lift<T, OP>(values[r0], valid[r0]);
    for (int i = 1; i < nr; ++i) {
      const int s = ids[r0 + i];
      const Piece<A> x = lift<T, OP>(values[r0 + i], valid[r0 + i]);
      if (s == tseg) {
        cur = combine<A, OP>(cur, x);
        continue;
      }
      if (single) {
        head = cur;
        single = false;
      } else if (tseg >= 0 && tseg < S) {
        store<T, A, OP>(out, counts, tseg, cur);  // began and ended in this thread
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
  Piece<A> a = cur;
  for (int d = 1; d < kThreads; d <<= 1) {
    s_val[t] = a;
    s_reset[t] = reset;
    __syncthreads();
    if (t >= d) {
      if (!reset) a = combine<A, OP>(s_val[t - d], a);
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
    const Piece<A> h = cont_head ? combine<A, OP>(s_val[t - 1], head) : head;
    if (open_left && hseg == first_seg) lo[b] = h;
    else if (hseg >= 0 && hseg < S) store<T, A, OP>(out, counts, hseg, h);
  }
  if (last_active || s_head[t + 1] != tseg) {  // the tail segment ends here
    const bool left = open_left && tseg == first_seg;
    const bool right = last_active && open_right;
    if (left) lo[b] = a;
    if (right) hi[b] = a;
    if (!left && !right && tseg >= 0 && tseg < S) store<T, A, OP>(out, counts, tseg, a);
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads) carry_kernel(
    const int* __restrict__ ids, long long n, int S, int n_tiles,
    const Piece<typename AccOf<T, OP>::type>* __restrict__ lo,
    const Piece<typename AccOf<T, OP>::type>* __restrict__ hi,
    T* __restrict__ out, int* __restrict__ counts) {
  using A = typename AccOf<T, OP>::type;
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
  Piece<A> acc = empty_piece<T, OP>();
  for (int k = k0; k < k1; ++k) acc = combine<A, OP>(acc, k == 0 ? hi[tile] : lo[tile + k]);
  // ordered tree: lane i combines with lane i+off, whose range is later
  for (int off = 1; off < 32; off <<= 1) {
    Piece<A> o;
    o.v = shfl_down(acc.v, off);
    o.cnt = __shfl_down_sync(kFull, acc.cnt, off);
    o.nan = __shfl_down_sync(kFull, acc.nan, off);
    if (lane + off < 32) acc = combine<A, OP>(acc, o);
  }
  if (lane == 0) store<T, A, OP>(out, counts, s, acc);
}

template <typename T, int OP>
cudaError_t launch(const void* values, const int* ids, const uint8_t* valid, long long n, int S,
                   void* out, int* counts, void* scratch, cudaStream_t stream) {
  using A = typename AccOf<T, OP>::type;
  T* o = static_cast<T*>(out);
  if (S <= 0) return cudaGetLastError();
  const long long want = (static_cast<long long>(S) + kThreads - 1) / kThreads;
  const int init_blocks = static_cast<int>(want < 4096 ? want : 4096);
  init_kernel<T, OP><<<init_blocks, kThreads, 0, stream>>>(o, counts, S);
  if (n > 0) {
    const int n_tiles = static_cast<int>((n + kTile - 1) / kTile);
    Piece<A>* lo = static_cast<Piece<A>*>(scratch);
    Piece<A>* hi = lo + n_tiles;
    tile_kernel<T, OP><<<n_tiles, kThreads, 0, stream>>>(
        static_cast<const T*>(values), ids, valid, n, S, o, counts, lo, hi);
    carry_kernel<T, OP><<<(n_tiles + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
        ids, n, S, n_tiles, lo, hi, o, counts);
  }
  return cudaGetLastError();
}

// dtype codes, shared with kernel.py
enum DType { kI8 = 0, kI16 = 1, kI32 = 2, kI64 = 3, kU8 = 4, kF32 = 5, kF64 = 6 };

template <int OP>
cudaError_t dispatch(int dtype, const void* values, const int* ids, const uint8_t* valid,
                     long long n, int S, void* out, int* counts, void* scratch,
                     cudaStream_t stream) {
  switch (dtype) {
    case kI8: return launch<int8_t, OP>(values, ids, valid, n, S, out, counts, scratch, stream);
    case kI16: return launch<int16_t, OP>(values, ids, valid, n, S, out, counts, scratch, stream);
    case kI32: return launch<int32_t, OP>(values, ids, valid, n, S, out, counts, scratch, stream);
    case kI64: return launch<int64_t, OP>(values, ids, valid, n, S, out, counts, scratch, stream);
    case kU8: return launch<uint8_t, OP>(values, ids, valid, n, S, out, counts, scratch, stream);
    case kF32: return launch<float, OP>(values, ids, valid, n, S, out, counts, scratch, stream);
    case kF64: return launch<double, OP>(values, ids, valid, n, S, out, counts, scratch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Bytes of device scratch the launch needs for n rows (the lo/hi pieces).
long long repro_segment_scratch_bytes(long long n) {
  const long long n_tiles = (n + kTile - 1) / kTile;
  return 2 * n_tiles * static_cast<long long>(sizeof(Piece<uint64_t>));
}

int repro_segment_sum(int dtype, const void* values, const int* ids, const uint8_t* valid,
                      long long n, int S, void* out, int* counts, void* scratch, void* stream) {
  return static_cast<int>(dispatch<kSum>(dtype, values, ids, valid, n, S, out, counts, scratch,
                                         static_cast<cudaStream_t>(stream)));
}

// op: 1 = MIN, 2 = MAX
int repro_segment_reduce(int dtype, int op, const void* values, const int* ids,
                         const uint8_t* valid, long long n, int S, void* out, int* counts,
                         void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (op == kMin) return static_cast<int>(dispatch<kMin>(dtype, values, ids, valid, n, S, out, counts, scratch, st));
  if (op == kMax) return static_cast<int>(dispatch<kMax>(dtype, values, ids, valid, n, S, out, counts, scratch, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
