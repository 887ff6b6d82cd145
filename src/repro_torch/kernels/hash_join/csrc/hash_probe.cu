// Hash probe and filter-fused hash probe, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of repro/kernels/hash_join/kernel.py:
//   hash_probe_kernel        (body _probe_body)        -> repro_hash_probe
//   masked_hash_probe_kernel (body _masked_probe_body) -> repro_hash_probe
//                                                         with a mask
//
// What it computes: for each probe lane i, the (start, count) of its match
// run in a direct-address table, (table_start[slot], table_count[slot])
// for slot = slots[i] in [0, T), and (0, 0) for a slot outside the table:
// negative, >= T, or the int32-max sentinel that the partitioned join
// gives NULL/NaN keys and padding. The masked variant gives (0, 0) for a
// lane whose mask is false, and gathers nothing from the table for it.
//
// The TPU kernel one-hot-reduces each probe tile against every table tile
// because TPU Pallas has no gather from VMEM. That is not carried over:
// here the probe is the gather itself. The slots are dense codes, so the
// hash is perfect and one lookup ends the probe.
//
// Bound on the H100: bytes. A lane reads its 4-byte slot (and a 1-byte
// mask) and writes 8 bytes; the table adds 8 bytes per distinct slot it
// touches. At n = 6M lanes that is ~72 MB, ~22 us at 3.35 TB/s. But
// device memory moves 64-byte atoms (the L2's fetch granularity), one
// per table array and live lane unless the L2 still holds it, so the
// reachable floor lies between the lane stream plus each touched atom
// once (~41 us at 6M clustered lanes) and two atoms a live lane (~244 us
// at 6M random keys); examples/probe_tune.py computes both per case.
// What the design does about it:
//
// - Bytes in flight. Each slot load is followed by two dependent gathers,
//   so a thread that takes one lane at a time keeps ~4 bytes in flight.
//   Here a thread owns groups of 4 consecutive lanes: one 16-byte load of
//   4 slots (and one 32-bit load of 4 mask bytes), kGroups groups loaded
//   before any gather starts, so 4 * kGroups lanes of gathers are in
//   flight; starts and counts leave in 16-byte stores.
// - The L2. The lane stream (slots, mask, outputs) is touched once: it is
//   read and written with streaming, evict-first hints (__ldcs / __stcs),
//   so it does not push the table out of the 50 MB L2. The table gathers
//   go through the read-only path under an evict-last L2 policy on a
//   quarter of the table's lines (createpolicy.fractional, then
//   ld.global.nc.L2::cache_hint): of a 2^23-slot table's 64 MB, ~16 MB
//   then stay in L2 for the lanes that come back to them, which the
//   random-order probe does. On all the lines the policy measured no
//   faster than no policy at all.
// - Alignment. The 16-byte body needs slots, starts and counts 16-byte
//   aligned, and the mask 4-byte aligned, at the same lane. The wrapper
//   allocates the outputs at the slots' phase and passes ``head``: lanes
//   [0, head) and the n % 4 lanes after the last full group take a scalar
//   path; so does every lane when the mask's phase differs (head = n).
//
// Launch: no device query per launch; the wrapper passes the grid's cap,
// 4 blocks per SM from an SM count it reads once per device; it measured
// within 0.4% of, or faster than, a cap of 8 and a grid sized from n in
// every warm case.
#include <cuda_runtime.h>

#include <cstdint>

// The build switches that src/repro_torch/examples/probe_tune.py times
// against the defaults. REPRO_PROBE_EVICT_LAST 0: the table gathers carry
// no L2 policy. REPRO_PROBE_L2_FRACTION: the share of the table's lines
// the policy marks evict-last. REPRO_PROBE_GROUPS: kGroups.
#ifndef REPRO_PROBE_EVICT_LAST
#define REPRO_PROBE_EVICT_LAST 1
#endif
#ifndef REPRO_PROBE_L2_FRACTION
#define REPRO_PROBE_L2_FRACTION 0.25
#endif
#ifndef REPRO_PROBE_GROUPS
#define REPRO_PROBE_GROUPS 2
#endif
#define REPRO_STR_(x) #x
#define REPRO_STR(x) REPRO_STR_(x)

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = REPRO_PROBE_GROUPS;   // 4-lane groups a thread loads before it gathers

__device__ __forceinline__ uint64_t table_policy() {
  uint64_t policy = 0;
#if REPRO_PROBE_EVICT_LAST
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, " REPRO_STR(
                   REPRO_PROBE_L2_FRACTION) ";"
               : "=l"(policy));
#endif
  return policy;
}

// One table word through the read-only path, under the L2 policy
// (volatile: the gather must not be hoisted above its bounds check).
__device__ __forceinline__ int32_t table_load(const int32_t* p, uint64_t policy) {
#if REPRO_PROBE_EVICT_LAST
  int32_t v;
  asm volatile("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;"
               : "=r"(v)
               : "l"(p), "l"(policy));
  return v;
#else
  (void)policy;
  return __ldg(p);
#endif
}

// A dropped lane arrives with slot -1. One unsigned compare covers
// slot < 0 (wraps high) and slot >= T.
__device__ __forceinline__ void probe_lane(int32_t slot, const int32_t* __restrict__ table_start,
                                           const int32_t* __restrict__ table_count, int T,
                                           uint64_t policy, int32_t& s, int32_t& c) {
  s = 0;
  c = 0;
  if (static_cast<uint32_t>(slot) < static_cast<uint32_t>(T)) {
    s = table_load(table_start + slot, policy);
    c = table_load(table_count + slot, policy);
  }
}

template <bool MASKED>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const int32_t* __restrict__ slots, const uint8_t* __restrict__ mask,
             const int32_t* __restrict__ table_start,
             const int32_t* __restrict__ table_count, long long n, int T, long long head,
             long long groups, int32_t* __restrict__ starts, int32_t* __restrict__ counts) {
  const uint64_t policy = table_policy();
  const long long thread = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;

  // the scalar lanes: the head, then the tail after the last full group
  const long long body_end = head + 4 * groups;
  const long long scalar = head + (n - body_end);
  for (long long j = thread; j < scalar; j += stride) {
    const long long i = j < head ? j : body_end + (j - head);
    const int32_t slot = (!MASKED || mask[i] != 0) ? slots[i] : -1;
    int32_t s, c;
    probe_lane(slot, table_start, table_count, T, policy, s, c);
    starts[i] = s;
    counts[i] = c;
  }

  // the body: group g is lanes head + 4g .. head + 4g + 3
  const int4* __restrict__ vslots = reinterpret_cast<const int4*>(slots + head);
  const unsigned* __restrict__ vmask = reinterpret_cast<const unsigned*>(mask + head);
  int4* __restrict__ vstarts = reinterpret_cast<int4*>(starts + head);
  int4* __restrict__ vcounts = reinterpret_cast<int4*>(counts + head);
  for (long long g0 = thread; g0 < groups; g0 += stride * kGroups) {
    int32_t slot[kGroups][4];
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const long long g = g0 + u * stride;
      int4 v = make_int4(-1, -1, -1, -1);
      unsigned keep = ~0u;
      if (g < groups) {
        v = __ldcs(vslots + g);
        if (MASKED) keep = __ldcs(vmask + g);
      }
      slot[u][0] = v.x;
      slot[u][1] = v.y;
      slot[u][2] = v.z;
      slot[u][3] = v.w;
      if (MASKED) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (((keep >> (8 * j)) & 0xffu) == 0) slot[u][j] = -1;
      }
    }
    int32_t s[kGroups][4], c[kGroups][4];
#pragma unroll
    for (int u = 0; u < kGroups; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        probe_lane(slot[u][j], table_start, table_count, T, policy, s[u][j], c[u][j]);
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const long long g = g0 + u * stride;
      if (g < groups) {
        __stcs(vstarts + g, make_int4(s[u][0], s[u][1], s[u][2], s[u][3]));
        __stcs(vcounts + g, make_int4(c[u][0], c[u][1], c[u][2], c[u][3]));
      }
    }
  }
}

bool aligned(const void* p, long long offset, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) + offset) % bytes == 0;
}

}  // namespace

extern "C" {

// mask == nullptr: the plain probe; otherwise one byte per lane, 0 = drop.
// head: the scalar lanes before the 16-byte body (head = n: all scalar);
// slots, starts and counts must be 16-byte aligned, and the mask 4-byte
// aligned, at lane head when a full group follows it.
// max_blocks: the grid's cap, at least 1.
// Returns the CUDA error of the launch (0 = success). n == 0 launches
// nothing; T == 0 gives (0, 0) everywhere.
int repro_hash_probe(const int32_t* slots, const uint8_t* mask, const int32_t* table_start,
                     const int32_t* table_count, long long n, int T, long long head,
                     int max_blocks, int32_t* starts, int32_t* counts, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (T < 0 || head < 0 || head > n || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = (n - head) / 4;
  if (groups > 0 &&
      !(aligned(slots, 4 * head, 16) && aligned(starts, 4 * head, 16) &&
        aligned(counts, 4 * head, 16) && (mask == nullptr || aligned(mask, head, 4))))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long scalar = n - 4 * groups;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long body_threads = (groups + kGroups - 1) / kGroups;
  const long long threads = body_threads > scalar ? body_threads : scalar;
  long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (mask == nullptr) {
    probe_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        slots, nullptr, table_start, table_count, n, T, head, groups, starts, counts);
  } else {
    probe_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        slots, mask, table_start, table_count, n, T, head, groups, starts, counts);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* repro_hash_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
