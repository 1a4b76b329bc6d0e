// Split-block bloom filter probe for Hopper (sm_90a).
//
// Replaces the TPU kernel parquet_tpu/ops/pallas_kernels.py::bloom_check_blocks
// (body _bloom_check_kernel) together with the XLA gather that fed it
// (parquet_tpu/io/bloom.py::check_hashes_device).  For each 64-bit xxhash h
// of a probe it computes what SplitBlockFilter.check_hashes does on the host:
//   block = (uint32(h >> 32) * z) >> 32        (__umulhi)
//   low   = uint32(h)
//   hit   = all over i in 0..7 of  filter[block][i] & (1 << ((low * SALT[i]) >> 27))
// and writes hit as one byte (torch.bool).  On the TPU the block index was
// computed on the host and the blocks were gathered by a separate XLA op into
// HBM before the kernel tested them; here the index, the gather and the test
// are one pass, so the gathered blocks never reach memory.
//
// Bound on an H100 SXM: per probe it reads the 8-byte hash and one 32-byte
// block (one sector, a random access into the filter) and writes 1 byte, with
// about 30 integer operations: memory-bound, 41 n bytes / 3.35 TB/s.  Design:
// one thread per probe loads its block as two 16-byte vector loads (a block
// is 32-byte aligned, so both fall in one sector), the 8 salts are
// compile-time constants, and a grid-stride loop keeps the grid at a few
// resident blocks per SM.  Filters of up to 2 MiB (the path's 65,536 blocks)
// sit in the 50 MB L2 after the first probes touch them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 8;  // 8 resident blocks per H100 SM

__device__ __forceinline__ bool bit_set(uint32_t word, uint32_t low,
                                        uint32_t salt) {
  return (word >> ((low * salt) >> 27)) & 1u;
}

__global__ void bloom_check_kernel(const uint4* __restrict__ filter,
                                   const unsigned long long* __restrict__ hashes,
                                   uint32_t z, bool* __restrict__ out,
                                   long long n) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const unsigned long long h = __ldg(hashes + i);
    const uint32_t block = __umulhi((uint32_t)(h >> 32), z);
    const uint32_t low = (uint32_t)h;
    const uint4 a = __ldg(filter + 2 * (size_t)block);
    const uint4 b = __ldg(filter + 2 * (size_t)block + 1);
    out[i] = bit_set(a.x, low, 0x47B6137Bu) && bit_set(a.y, low, 0x44974D91u) &&
             bit_set(a.z, low, 0x8824AD5Bu) && bit_set(a.w, low, 0xA2B7289Du) &&
             bit_set(b.x, low, 0x705495C7u) && bit_set(b.y, low, 0x2DF1424Bu) &&
             bit_set(b.z, low, 0x9EFC4947u) && bit_set(b.w, low, 0x5C6BFB31u);
  }
}

}  // namespace

// filter: z blocks of 8 uint32 words (32 bytes each, 16-byte aligned) on the
// device; hashes: n uint64 on the device; out: n bytes.  Returns
// cudaGetLastError() after the launch; z outside 1..2^31 returns
// cudaErrorInvalidValue without launching.
extern "C" int pq_bloom_check(const void* filter, long long z,
                              const void* hashes, void* out, long long n,
                              void* stream) {
  if (z < 1 || z > (1ll << 31)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  bloom_check_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(filter),
      static_cast<const unsigned long long*>(hashes), (uint32_t)z,
      static_cast<bool*>(out), n);
  return (int)cudaGetLastError();
}
