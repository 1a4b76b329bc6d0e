// Split-block bloom filter probe for Hopper (sm_90a), segmented: one launch
// probes many filters.
//
// Replaces the TPU kernel parquet_tpu/ops/pallas_kernels.py::bloom_check_blocks
// (body _bloom_check_kernel) together with the XLA gather that fed it
// (parquet_tpu/io/bloom.py::check_hashes_device).  Probe i belongs to the
// segment s whose [starts[s], starts[s+1]) holds i and is tested against
// filter s of zs[s] blocks, as SplitBlockFilter.check_hashes does on the host:
//   block = (uint32(h >> 32) * z) >> 32        (__umulhi)
//   low   = uint32(h)
//   hit   = all over i in 0..7 of  filter[block][i] & (1 << ((low * SALT[i]) >> 27))
// and writes hit as one byte (torch.bool).  On the TPU the block index was
// computed on the host and the blocks were gathered by a separate XLA op into
// HBM before the kernel tested them; here the index, the gather and the test
// are one pass, so the gathered blocks never reach memory.  The lookup probes
// every row group's filter in one launch, not one launch per row group.
//
// What bounds it on an H100 SXM: per probe it reads the 8-byte hash and one
// 32-byte block (one sector, a random access into its filter) and writes 1
// byte, with about 30 integer operations: memory-bound.  Counted once, the
// bytes are 9 per probe plus 32 per distinct (filter, block) pair touched;
// but every probe reads its sector from L1, L2 or HBM at random, so the
// kernel lives on memory latency, on the rate at which the caches serve
// random lines, and, at the lookup's sizes, on launch and ramp.  What the
// design does about that:
// - one launch for many filters: the lookup's row groups are segments of
//   one probe, so 8 launches of ~65,000 probes become one of ~524,000;
// - a pair of lanes takes each probe: each lane loads and tests one 16-byte
//   half of the block (a thread loads at most 16 bytes at once), so one
//   warp-wide load fetches 16 whole blocks, one random line per probe,
//   where a thread per probe loading both halves needs two warp-wide loads,
//   each over 32 random lines.  The pair ANDs its halves with a shuffle;
// - four consecutive probes per pair and iteration: their 32 bytes of
//   hashes come as two 16-byte loads (both lanes of a pair read the same
//   bytes, so a warp reads 512 contiguous bytes), then all four block
//   addresses are computed and all four of the lane's 16-byte filter loads
//   are issued before any bit is tested; the tests are combined with `&`,
//   never `&&`, so no branch sits between the loads; the four result bytes
//   go out as one 32-bit store.  Pairs of the first warp take the n mod 4
//   probes of the tail;
// - L2 priority by instruction, not by a stream access-policy window (that
//   is state on the stream every later kernel would inherit): the filter
//   loads are read-only (`ld.global.nc`) with an L2::evict_last policy, so
//   the filters stay in the 50 MB L2 across probes; the hashes are loaded
//   and the results stored streaming (`__ldcs`, `__stcs`, evict-first), so
//   they do not push filter lines out;
// - the segment table (filter base, block count, first probe; 20 bytes a
//   segment) is copied into dynamic shared memory sized to it when it has
//   at most kSharedSegs segments, and read there with shared-memory loads
//   (a template instantiation of its own); larger tables are read in global
//   memory.  Each group finds its first probe's segment by binary search
//   and keeps that segment's end, base and block count in registers; the
//   other three probes step over segment ends only where the group
//   straddles one (probes are ordered by segment, empty segments included);
// - a grid-stride loop over a grid of at most the CTAs that fit on the card
//   at once (the occupancy API's count, times the SMs), so no second wave
//   of CTAs runs after the first.
//
// The single-filter entry point pq_bloom_check launches the same kernel with
// no table: one segment, [0, n).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedSegs = 1024;

// The segment table as the wrapper lays it out, host and device alike:
// nseg filter base addresses (8 bytes each), nseg + 1 probe offsets (int64),
// nseg block counts (uint32).
struct Tables {
  const uint4* const* filters;
  const long long* starts;
  const uint32_t* zs;
};

__host__ __device__ inline size_t table_bytes(int nseg) {
  return 20 * (size_t)nseg + 8;
}

__host__ __device__ inline Tables tables_of(const void* base, int nseg) {
  const char* p = static_cast<const char*>(base);
  return {reinterpret_cast<const uint4* const*>(p),
          reinterpret_cast<const long long*>(p + 8 * (size_t)nseg),
          reinterpret_cast<const uint32_t*>(p + 8 * (2 * (size_t)nseg + 1))};
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// 16 read-only bytes of a filter, kept in L2 with the given policy.
__device__ __forceinline__ uint4 load_filter(const uint4* p, uint64_t policy) {
  uint4 v;
  asm volatile(
      "ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

// 1 where the 4 salted bits of ``low`` that fall in one half of a block (w,
// its words 4 * half .. 4 * half + 3) are set, else 0; ``salt`` holds that
// half's salts.
__device__ __forceinline__ uint32_t half_hit(uint4 w, uint32_t low,
                                             const uint32_t (&salt)[4]) {
  return (w.x >> ((low * salt[0]) >> 27)) & (w.y >> ((low * salt[1]) >> 27)) &
         (w.z >> ((low * salt[2]) >> 27)) & (w.w >> ((low * salt[3]) >> 27)) &
         1u;
}

// The segment of probe i: the largest s < nseg with starts[s] <= i.
__device__ __forceinline__ int segment_of(const long long* starts, int nseg,
                                          long long i) {
  int lo = 0, hi = nseg;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (starts[mid] <= i) lo = mid; else hi = mid;
  }
  return lo;
}

// table: the device segment table of nseg segments, or null for the single
// filter (filter0, z0).  hashes: n uint64, 16-byte aligned; out: n bytes,
// 4-byte aligned.
// kShared: the table is copied into dynamic shared memory of
// table_bytes(nseg) (nseg <= kSharedSegs, the single filter's table
// included) and read there; else it is read in global memory.  Two
// instantiations of one body, so that each reads its table with the loads
// of its own memory space.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
bloom_check_kernel(const void* __restrict__ table, int nseg,
                   const uint4* filter0, uint32_t z0,
                   const uint4* __restrict__ hashes, long long n,
                   unsigned char* __restrict__ out) {
  extern __shared__ __align__(8) unsigned char s_table[];
  const Tables t = tables_of(kShared ? s_table : table, nseg);
  if (kShared) {
    if (table == nullptr) {
      if (threadIdx.x == 0) {
        *reinterpret_cast<const uint4**>(s_table) = filter0;
        reinterpret_cast<long long*>(s_table + 8)[0] = 0;
        reinterpret_cast<long long*>(s_table + 8)[1] = n;
        *reinterpret_cast<uint32_t*>(s_table + 24) = z0;
      }
    } else {
      const uint32_t* from = static_cast<const uint32_t*>(table);
      uint32_t* to = reinterpret_cast<uint32_t*>(s_table);
      for (int j = threadIdx.x; j < (int)(table_bytes(nseg) / 4);
           j += kThreads)
        to[j] = from[j];
    }
    __syncthreads();
  }

  // Lanes 2j and 2j + 1 are a pair: they take the same 4 probes, and each
  // loads and tests one 16-byte half of every block.
  const uint64_t policy = evict_last_policy();
  const uint32_t half = threadIdx.x & 1;
  const unsigned pair = 3u << (threadIdx.x & 30);
  const uint32_t salt[4] = {half ? 0x705495C7u : 0x47B6137Bu,
                            half ? 0x2DF1424Bu : 0x44974D91u,
                            half ? 0x9EFC4947u : 0x8824AD5Bu,
                            half ? 0x5C6BFB31u : 0xA2B7289Du};
  const long long groups = n >> 2;
  const long long first = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 1;
  const long long stride = (long long)gridDim.x * (kThreads / 2);
  for (long long g = first; g < groups; g += stride) {
    const long long i = g << 2;
    const uint4 ha = __ldcs(hashes + 2 * g);
    const uint4 hb = __ldcs(hashes + 2 * g + 1);
    const uint32_t low[4] = {ha.x, ha.z, hb.x, hb.z};
    const uint32_t high[4] = {ha.y, ha.w, hb.y, hb.w};
    const uint4* blk[4];
    int s = segment_of(t.starts, nseg, i);
    long long end = t.starts[s + 1];
    const uint4* filter = t.filters[s];
    uint32_t z = t.zs[s];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (i + k >= end) {  // the group straddles a segment end
        do ++s; while (t.starts[s + 1] <= i + k);
        end = t.starts[s + 1];
        filter = t.filters[s];
        z = t.zs[s];
      }
      blk[k] = filter + 2 * (size_t)__umulhi(high[k], z) + half;
    }
    uint4 w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = load_filter(blk[k], policy);
    uint32_t hit = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) hit |= half_hit(w[k], low[k], salt) << (8 * k);
    hit &= __shfl_xor_sync(pair, hit, 1);
    if (!half) __stcs(reinterpret_cast<unsigned int*>(out) + g, hit);
  }
  // the tail, probes 4 * groups .. n - 1: pair j of the first warp takes
  // probe 4 * groups + j
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const long long i = (groups << 2) + (threadIdx.x >> 1);
    uint32_t hit = 0;
    if (i < n) {
      const unsigned long long h =
          __ldcs(reinterpret_cast<const unsigned long long*>(hashes) + i);
      const int s = segment_of(t.starts, nseg, i);
      const uint4* blk = t.filters[s] + half +
                         2 * (size_t)__umulhi((uint32_t)(h >> 32), t.zs[s]);
      hit = half_hit(load_filter(blk, policy), (uint32_t)h, salt);
    }
    hit &= __shfl_xor_sync(0xFFu, hit, 1);
    if (i < n && !half) out[i] = (unsigned char)hit;
  }
}

bool misaligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to != 0;
}

// CTAs of the kernel that fit on the current card at once, counted with
// the largest shared table; once per device.
long long resident_ctas() {
  static long long per_device[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (per_device[dev] == 0) {
    int sms = 0, per_sm = 0, per_sm_global = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, bloom_check_kernel<true>, kThreads,
            table_bytes(kSharedSegs)) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm_global, bloom_check_kernel<false>, kThreads, 0) !=
            cudaSuccess)
      return 132;
    if (per_sm_global < per_sm) per_sm = per_sm_global;
    if (sms * per_sm == 0) return 132;
    per_device[dev] = (long long)sms * per_sm;
  }
  return per_device[dev];
}

int launch(const void* table, int nseg, const void* filter0, uint32_t z0,
           const void* hashes, void* out, long long n, void* stream) {
  if (misaligned(hashes, 16) || misaligned(out, 4))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  // one group of 4 probes per lane pair
  long long blocks = ((n >> 2) + kThreads / 2 - 1) / (kThreads / 2);
  const long long resident = resident_ctas();
  if (blocks < 1) blocks = 1;
  if (blocks > resident) blocks = resident;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* f0 = static_cast<const uint4*>(filter0);
  const uint4* h = static_cast<const uint4*>(hashes);
  unsigned char* o = static_cast<unsigned char*>(out);
  if (nseg <= kSharedSegs)
    bloom_check_kernel<true><<<(unsigned)blocks, kThreads, table_bytes(nseg),
                               st>>>(table, nseg, f0, z0, h, n, o);
  else
    bloom_check_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(
        table, nseg, f0, z0, h, n, o);
  return (int)cudaGetLastError();
}

}  // namespace

// filter: z blocks of 8 uint32 words (32 bytes each, 16-byte aligned) on the
// device; hashes: n uint64 on the device, 16-byte aligned; out: n bytes,
// 4-byte aligned.  Returns cudaGetLastError() after the launch; z outside
// 1..2^31 or a misaligned operand returns cudaErrorInvalidValue without
// launching.
extern "C" int pq_bloom_check(const void* filter, long long z,
                              const void* hashes, void* out, long long n,
                              void* stream) {
  if (z < 1 || z > (1ll << 31) || misaligned(filter, 16))
    return (int)cudaErrorInvalidValue;
  return launch(nullptr, 1, filter, (uint32_t)z, hashes, out, n, stream);
}

// table: the segment table of nseg >= 1 segments on the device (filter base
// addresses, starts, block counts; see Tables), and host_table the same
// bytes on the host, read here to check them.  Probe i of hashes (n uint64,
// 16-byte aligned) is tested against the filter of the segment that holds
// it; out: n bytes, 4-byte aligned.  Returns cudaGetLastError() after the
// launch; a block count outside 1..2^31, starts that do not ascend from 0 to
// n, or a misaligned operand returns cudaErrorInvalidValue without
// launching.
extern "C" int pq_bloom_check_segments(const void* table,
                                       const void* host_table, int nseg,
                                       const void* hashes, void* out,
                                       long long n, void* stream) {
  if (nseg < 1 || table == nullptr || host_table == nullptr ||
      misaligned(table, 8))
    return (int)cudaErrorInvalidValue;
  const Tables t = tables_of(host_table, nseg);
  if (t.starts[0] != 0 || t.starts[nseg] != n)
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < nseg; ++s) {
    if (t.starts[s + 1] < t.starts[s] || t.zs[s] < 1u ||
        t.zs[s] > (1u << 31) || misaligned(t.filters[s], 16))
      return (int)cudaErrorInvalidValue;
  }
  return launch(table, nseg, nullptr, 0, hashes, out, n, stream);
}
