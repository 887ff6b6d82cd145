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
// lane whose mask is false, and reads neither its slot nor the table.
//
// The TPU kernel one-hot-reduces each probe tile against every table tile
// because TPU Pallas has no gather from VMEM. That is not carried over:
// here the probe is the gather itself, one thread per lane with a
// grid-stride loop, the bounds check done in one unsigned compare, and the
// two table words read through the read-only path (__ldg). The slots are
// dense codes, so the hash is perfect and one lookup ends the probe.
//
// Bound on the H100: bytes. A lane reads its 4-byte slot (and a 1-byte
// mask) and writes 8 bytes; the table adds 8 bytes per distinct slot it
// touches. At n = 6M lanes that is ~72 MB, ~22 us at 3.35 TB/s. The
// lane-side traffic is coalesced (neighbouring threads, neighbouring
// lanes); the table reads are as local as the probe keys are sorted,
// which for a foreign-key join on a clustered key (TPC-H l_orderkey)
// they mostly are.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

template <bool MASKED>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const int32_t* __restrict__ slots, const uint8_t* __restrict__ mask,
             const int32_t* __restrict__ table_start,
             const int32_t* __restrict__ table_count, long long n, int T,
             int32_t* __restrict__ starts, int32_t* __restrict__ counts) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int32_t s = 0;
    int32_t c = 0;
    if (!MASKED || mask[i] != 0) {
      const int32_t slot = slots[i];
      // one compare covers slot < 0 (wraps high) and slot >= T
      if (static_cast<uint32_t>(slot) < static_cast<uint32_t>(T)) {
        s = __ldg(table_start + slot);
        c = __ldg(table_count + slot);
      }
    }
    starts[i] = s;
    counts[i] = c;
  }
}

}  // namespace

extern "C" {

// mask == nullptr: the plain probe; otherwise one byte per lane, 0 = drop.
// Returns the CUDA error of the launch (0 = success). n == 0 launches
// nothing; T == 0 gives (0, 0) everywhere.
int repro_hash_probe(const int32_t* slots, const uint8_t* mask, const int32_t* table_start,
                     const int32_t* table_count, long long n, int T, int32_t* starts,
                     int32_t* counts, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (T < 0) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (n + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mask == nullptr) {
    probe_kernel<false><<<blocks, kThreads, 0, st>>>(slots, nullptr, table_start, table_count,
                                                     n, T, starts, counts);
  } else {
    probe_kernel<true><<<blocks, kThreads, 0, st>>>(slots, mask, table_start, table_count, n,
                                                    T, starts, counts);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* repro_hash_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
