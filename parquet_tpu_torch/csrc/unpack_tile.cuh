// The warp-tile unpack shared by unpack_bits.cu and dict_unpack_gather.cu.
//
// A dense LSB-first w-bit stream holds each group of 32 values in w uint32
// words.  Here a warp owns a tile of kGroups = 16 groups (512 values, 16*w
// words, 64*w bytes, so every tile of a 16-byte aligned stream starts on a
// 16-byte boundary) and runs over tiles tile, tile + step, ... of a grid
// sized from the occupancy API (one wave).  For each tile:
//   - the lanes copy its 16-byte vectors into the warp's shared buffer with
//     cp.async, kStages - 1 tiles ahead of the one being unpacked, so each
//     warp keeps up to 2 * 64 * w bytes of reads in flight while it works;
//   - words at or past the stream's end arrive as zeros (cp.async's
//     src-size zero fill), so the ragged last group needs no padded copy;
//   - a stream whose base is 4- but not 16-byte aligned (a view such as
//     words[1:]) is read from the 16-byte boundary below it, one vector
//     more a tile, and unpacked from `head` words into the buffer;
//   - each lane extracts 16 bytes of consecutive outputs at a time (a
//     funnel shift of two shared words per value, W a template parameter)
//     and stores them with one 16-byte store, so a warp's store is 512
//     contiguous bytes.
// A functor maps each w-bit value to its output: the identity for the
// unpack, the dictionary lookup for the fused gather.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pq_tile {

constexpr int kGroups = 16;                 // 32-value groups per tile
constexpr int kTileValues = 32 * kGroups;   // 512
constexpr int kWarps = 8;                   // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;                  // tile buffers per warp

template <int W>
struct Shape {
  // a tile is kGroups*W words; one vector more for a base 4-12 bytes past
  // a 16-byte boundary
  static constexpr int kTileVecs = kGroups * W / 4;
  static constexpr int kVecs = kTileVecs + 1;
  static constexpr int kBlockBytes = kWarps * kStages * kVecs * 16;
};

// The packed stream as the kernel reads it.
struct Stream {
  const uint4* vec;  // the stream's base rounded down to 16 bytes
  long long avail;   // words readable from vec (the stream's, plus head)
  int head;          // words between vec and the stream's first word (0..3)
};

// The stream of nwords words at `words` (4-byte aligned); false where the
// base is not.
inline bool make_stream(const void* words, long long nwords, Stream* s) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(words);
  if (p & 3) return false;
  if (nwords <= 0) {  // nothing to read: every word is zero
    *s = {reinterpret_cast<const uint4*>(p & ~uintptr_t(15)), 0, 0};
    return true;
  }
  const int head = (int)((p & 15) >> 2);
  *s = {reinterpret_cast<const uint4*>(p - 4 * head), nwords + head, head};
  return true;
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            int bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying tile `tile` into `dst` (kVecs vectors); words past the
// stream's end are zero-filled and not read.
template <int W>
__device__ __forceinline__ void issue_tile(uint4* dst, const Stream& s,
                                           long long tile, int lane) {
  constexpr int kTileVecs = Shape<W>::kTileVecs;
  const long long first = tile * kTileVecs;  // vector index in s.vec
  const int nv = s.head ? kTileVecs + 1 : kTileVecs;
  for (int v = lane; v < nv; v += 32) {
    const long long left = s.avail - 4 * (first + v);  // words from here on
    const int bytes = left >= 4 ? 16 : left > 0 ? 4 * (int)left : 0;
    cp_async_16(dst + v, bytes ? s.vec + first + v : s.vec, bytes);
  }
}

// Value v of a tile whose words start at `words` in shared memory.
template <int W>
__device__ __forceinline__ uint32_t tile_value(const uint32_t* words, int v) {
  const int bit = v * W;
  const uint32_t lo = words[bit >> 5];
  if (W == 32) return lo;
  const uint32_t hi = words[(bit >> 5) + 1];  // inside the buffer for W < 32
  return __funnelshift_r(lo, hi, bit & 31) & ((1u << (W & 31)) - 1u);
}

// Unpack n values of the stream, map each through `map` and store it in
// out (16-byte aligned).  `prologue` runs once per thread, after the first
// tiles' copies are issued and before any is unpacked (the dictionary's
// staging and its __syncthreads); every thread of the block reaches it.
// `smem` holds Shape<W>::kBlockBytes bytes.
template <int W, typename T, typename Map, typename Prologue>
__device__ __forceinline__ void run_tiles(const Stream& s, T* __restrict__ out,
                                          long long n, uint4* smem, Map map,
                                          Prologue prologue) {
  constexpr int kVecs = Shape<W>::kVecs;
  constexpr int kPer = 16 / (int)sizeof(T);  // values per 16-byte store
  constexpr int kChunks = kTileValues / (32 * kPer);
  const int lane = threadIdx.x & 31;
  uint4* buf = smem + (threadIdx.x >> 5) * (kStages * kVecs);
  const long long ntiles = (n + kTileValues - 1) / kTileValues;
  const long long step = (long long)gridDim.x * kWarps;
  long long tile = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (tile + st * step < ntiles)
      issue_tile<W>(buf + st * kVecs, s, tile + st * step, lane);
    cp_async_commit();
  }
  prologue();
  int stage = 0;
  for (; tile < ntiles; tile += step) {
    // refill the buffer the previous tile used, kStages - 1 tiles ahead
    const long long ahead = tile + (kStages - 1) * step;
    if (ahead < ntiles)
      issue_tile<W>(buf + ((stage + kStages - 1) % kStages) * kVecs, s, ahead,
                    lane);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this lane's copies of `tile` landed
    __syncwarp();                  // and every other lane's
    const uint32_t* words =
        reinterpret_cast<const uint32_t*>(buf + stage * kVecs) + s.head;
    const long long base = tile * kTileValues;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int v0 = (c * 32 + lane) * kPer;
      union {
        T v[kPer];
        uint4 q;
      } o;
#pragma unroll
      for (int j = 0; j < kPer; ++j) o.v[j] = map(tile_value<W>(words, v0 + j));
      if (base + v0 + kPer <= n) {
        *reinterpret_cast<uint4*>(out + base + v0) = o.q;
      } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          if (base + v0 + j < n) out[base + v0 + j] = o.v[j];
      }
    }
    __syncwarp();  // the buffer is free for the refill kStages - 1 tiles on
    stage = stage + 1 == kStages ? 0 : stage + 1;
  }
}

constexpr int kMaxDevices = 64;

// One kernel instantiation's wave on each device: the blocks that fit on
// all its SMs at once with `smem` bytes of dynamic shared memory a block.
// Each launch function keeps one as a static, so the occupancy API runs
// when a device or a shared-memory size is first seen, not every launch.
struct Wave {
  size_t smem[kMaxDevices];
  long long blocks[kMaxDevices];  // 0 until counted
};

// The launch of `kernel` for n values with smem bytes of dynamic shared
// memory (at most max_smem, the most any launch of it asks for): enough
// blocks for every warp to own a tile, at most one wave.  The kernel's
// shared-memory limit is raised to max_smem, where that is above the
// default 48 KB, before its occupancy is first counted on a device.
template <typename Kernel>
inline cudaError_t launch_blocks(Wave& wave, Kernel kernel, size_t smem,
                                 size_t max_smem, long long n, int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  // any count of blocks is correct (the tile loop strides over the grid),
  // so a count left by another host thread at another size is harmless
  long long most = wave.blocks[dev];
  if (most <= 0 || wave.smem[dev] != smem) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess && max_smem > 48 * 1024)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)max_smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (e != cudaSuccess) return e;
    most = (long long)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
    wave.smem[dev] = smem;
    wave.blocks[dev] = most;
  }
  const long long tiles = (n + kTileValues - 1) / kTileValues;
  const long long want = (tiles + kWarps - 1) / kWarps;
  *blocks = (int)(want < most ? want : most);
  return cudaSuccess;
}

}  // namespace pq_tile
