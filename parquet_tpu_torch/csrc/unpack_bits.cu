// Dense LSB-first bit unpack for Hopper (sm_90a).
//
// Replaces the TPU kernel parquet_tpu/ops/pallas_kernels.py::unpack_bits_dense
// (body _unpack_block_kernel).  It unpacks n w-bit integers (w in 1..32)
// stored LSB-first in a dense uint32 stream: each group of 32 values lives in
// w consecutive words, and value j of a group is word (j*w)>>5 at shift
// (j*w)&31, OR-ing in the next word when it straddles a boundary.  Words at
// or past the stream's end read as zero.
//
// Bound on an H100 SXM: the kernel reads n*w/8 bytes and writes 4n bytes and
// does a handful of integer operations per value, so it is memory-bound:
// (n*w/8 + 4n) / 3.35 TB/s.
//
// Design (unpack_tile.cuh): the first port gave each thread one value and
// each block 256 values, so a warp's load moved only 4*w new bytes and each
// thread had one dependent load in flight; at 1,048,576 values that is four
// waves of blocks, each waiting out one memory round trip, and the kernel was
// bound by latency, not bytes (2.04-2.15x its bound at w = 8..15).  Here a
// warp owns 512-value tiles, copies each with 16-byte cp.async two tiles
// ahead of the one it unpacks, and stores 16 bytes a lane; the grid is one
// wave from the occupancy API.  On an H100 80GB HBM3 at 700 W it takes
// 76-93 % of its bound at 8,388,608 values over w = 1..32, and at a row
// group's 1,048,576 values 0.0027 ms a launch at w = 15 and w = 10, 59-68 %
// of the bound, where the launch's ramp and drain are most of what is left
// (PERF.md).

#include "unpack_tile.cuh"

namespace {

using pq_tile::Stream;

struct Identity {
  __device__ __forceinline__ uint32_t operator()(uint32_t v) const {
    return v;
  }
};

struct NoPrologue {
  __device__ __forceinline__ void operator()() const {}
};

template <int W>
__global__ void __launch_bounds__(pq_tile::kThreads)
    unpack_bits_dense_kernel(Stream s, uint32_t* __restrict__ out,
                             long long n) {
  extern __shared__ uint4 smem[];
  pq_tile::run_tiles<W>(s, out, n, smem, Identity{}, NoPrologue{});
}

template <int W>
int launch(const Stream& s, uint32_t* out, long long n, cudaStream_t stream) {
  static pq_tile::Wave wave;
  const size_t smem = pq_tile::Shape<W>::kBlockBytes;
  int blocks = 0;
  cudaError_t e = pq_tile::launch_blocks(wave, unpack_bits_dense_kernel<W>,
                                         smem, smem, n, &blocks);
  if (e != cudaSuccess) return (int)e;
  unpack_bits_dense_kernel<W><<<blocks, pq_tile::kThreads, smem, stream>>>(
      s, out, n);
  return (int)cudaGetLastError();
}

}  // namespace

// words: nwords uint32 on the device, 4-byte aligned, words past the end read
// as zero; out: uint32[n], 16-byte aligned.  Returns cudaGetLastError() after
// the launch; an unsupported width or a misaligned pointer returns
// cudaErrorInvalidValue without launching.
extern "C" int pq_unpack_bits_dense(const void* words, long long nwords,
                                    void* out, long long n, int w,
                                    void* stream) {
  uint32_t* o = static_cast<uint32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Stream s;
  if (!pq_tile::make_stream(words, nwords, &s) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  switch (w) {
#define PQ_CASE(W) \
  case W:          \
    return launch<W>(s, o, n, st);
    PQ_CASE(1) PQ_CASE(2) PQ_CASE(3) PQ_CASE(4) PQ_CASE(5) PQ_CASE(6)
    PQ_CASE(7) PQ_CASE(8) PQ_CASE(9) PQ_CASE(10) PQ_CASE(11) PQ_CASE(12)
    PQ_CASE(13) PQ_CASE(14) PQ_CASE(15) PQ_CASE(16) PQ_CASE(17) PQ_CASE(18)
    PQ_CASE(19) PQ_CASE(20) PQ_CASE(21) PQ_CASE(22) PQ_CASE(23) PQ_CASE(24)
    PQ_CASE(25) PQ_CASE(26) PQ_CASE(27) PQ_CASE(28) PQ_CASE(29) PQ_CASE(30)
    PQ_CASE(31) PQ_CASE(32)
#undef PQ_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
