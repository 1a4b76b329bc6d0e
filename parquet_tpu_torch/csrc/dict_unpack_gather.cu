// Fused dictionary-index unpack + dictionary gather for Hopper (sm_90a).
//
// Replaces the TPU kernel parquet_tpu/ops/pallas_kernels.py::dict_unpack_gather
// (body _dict_unpack_gather_kernel).  It unpacks n LSB-first w-bit dictionary
// indexes from a dense uint32 stream (the layout of unpack_bits.cu; words at
// or past the stream's end read as zero) and writes dictionary[index] for
// each, so the index stream never reaches device memory.  An index past the
// dictionary's end yields 0, as the TPU kernel's one-hot product does.
//
// Bound on an H100 SXM: it reads n*w/8 bytes of indexes plus the dictionary
// and writes n*elem_bytes bytes, with a few integer operations per value:
// memory-bound, (n*w/8 + D*elem_bytes + n*elem_bytes) / 3.35 TB/s.
//
// Design: the tile unpack of unpack_tile.cuh with a dictionary lookup as its
// map.  Each block copies the dictionary (D <= 1024 entries of 4 or 8 raw
// bytes, at most 8 KB) into shared memory once, after its warps' first tile
// copies are in flight, so one kernel serves int32/float32/int64/float64
// dictionaries and the gather is a shared-memory load.  The first port gave
// each thread one value on a grid capped at a constant 132 * 8 blocks, with
// one dependent 4-byte load in flight a thread: bound by latency, not bytes.
// Here a warp owns 512-value tiles copied with 16-byte cp.async two tiles
// ahead, each lane stores 16 bytes (4 four-byte or 2 eight-byte values) at
// a time, and the grid is one wave from the occupancy API and the device's
// SM count.  On an H100 80GB HBM3 at 700 W it takes 84-93 % of its bound at
// 8,388,608 values (w = 8, every dictionary size and type), and at a row
// group's 943,520 values (w = 8, 200 int32 entries) 0.0031-0.0032 ms a
// launch, 43-45 % of the bound: the launch's ramp and drain and the
// dictionary's staging, a load and a block barrier before the first tile is
// unpacked, are what is left (PERF.md).

#include "unpack_tile.cuh"

namespace {

using pq_tile::Stream;

constexpr int kMaxDict = 1024;

template <typename T>
struct DictLookup {
  const T* dict;  // in shared memory
  uint32_t size;
  __device__ __forceinline__ T operator()(uint32_t idx) const {
    return idx < size ? dict[idx] : T(0);
  }
};

template <typename T>
struct StageDict {
  const T* src;
  T* dst;
  int size;
  __device__ __forceinline__ void operator()() const {
    for (int e = threadIdx.x; e < size; e += pq_tile::kThreads) dst[e] = src[e];
    __syncthreads();
  }
};

template <int W, typename T>
__global__ void __launch_bounds__(pq_tile::kThreads)
    dict_unpack_gather_kernel(Stream s, const T* __restrict__ dict, int dict_n,
                              T* __restrict__ out, long long n) {
  extern __shared__ uint4 smem[];
  T* sdict = reinterpret_cast<T*>(
      reinterpret_cast<char*>(smem) + pq_tile::Shape<W>::kBlockBytes);
  pq_tile::run_tiles<W>(s, out, n, smem,
                        DictLookup<T>{sdict, (uint32_t)dict_n},
                        StageDict<T>{dict, sdict, dict_n});
}

template <int W, typename T>
int launch(const Stream& s, const void* dict, int dict_n, void* out,
           long long n, cudaStream_t stream) {
  static pq_tile::Wave wave;
  const size_t smem = pq_tile::Shape<W>::kBlockBytes + dict_n * sizeof(T);
  int blocks = 0;
  cudaError_t e = pq_tile::launch_blocks(
      wave, dict_unpack_gather_kernel<W, T>, smem,
      pq_tile::Shape<W>::kBlockBytes + kMaxDict * sizeof(T), n, &blocks);
  if (e != cudaSuccess) return (int)e;
  dict_unpack_gather_kernel<W, T>
      <<<blocks, pq_tile::kThreads, smem, stream>>>(
          s, static_cast<const T*>(dict), dict_n, static_cast<T*>(out), n);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Stream& s, const void* dict, int dict_n, void* out,
             long long n, int w, cudaStream_t st) {
  switch (w) {
#define PQ_CASE(W) \
  case W:          \
    return launch<W, T>(s, dict, dict_n, out, n, st);
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

}  // namespace

// words: nwords uint32 on the device, 4-byte aligned, words past the end read
// as zero; dict: dict_n raw elements of elem_bytes (4 or 8) bytes; out: n
// elements of elem_bytes bytes, 16-byte aligned.  Returns cudaGetLastError()
// after the launch; an unsupported width, element size or dictionary size,
// or a misaligned pointer, returns cudaErrorInvalidValue without launching.
extern "C" int pq_dict_unpack_gather(const void* words, long long nwords,
                                     const void* dict, int dict_n,
                                     int elem_bytes, void* out, long long n,
                                     int w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Stream s;
  if (dict_n < 1 || dict_n > kMaxDict ||
      !pq_tile::make_stream(words, nwords, &s) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  if (elem_bytes == 4)
    return dispatch<uint32_t>(s, dict, dict_n, out, n, w, st);
  if (elem_bytes == 8)
    return dispatch<unsigned long long>(s, dict, dict_n, out, n, w, st);
  return (int)cudaErrorInvalidValue;
}
