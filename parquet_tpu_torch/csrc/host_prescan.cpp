// The host prescan of the read path: the page-header table of a chunk,
// the batched decompression of its data pages, the run tables of its
// RLE/bit-packed hybrid streams (levels, dictionary indexes, RLE booleans)
// and the present count over them, the miniblock tables of its
// DELTA_BINARY_PACKED streams, and the decode of the delta length streams
// of DELTA_LENGTH_BYTE_ARRAY and DELTA_BYTE_ARRAY pages; all of them at
// once, a chunk's pages in one call, in the chunk planner (pq_chunk_plan,
// the JAX package's pq_dict_chunk_scan design for every page kind); the
// staging batch's fill (pq_fill_batch), the compaction of a chunk's
// host byte-array pages (pq_byte_array_parts), the scans' gather of
// byte-array survivors (pq_gather_ba) and the bloom hash of byte arrays
// (pq_xxh64_batch).
//
// Built with the system C++ compiler into a shared library with a plain C
// interface (ops/_build.py), loaded with ctypes; ops/host.py wraps each
// entry point with the return shape of the Python version it replaces
// (ops/ref.py, ops/device.py, io/reader.py's thrift walk).  The port's own
// copy of what the JAX package's native shim does in `pq_scan_rle_runs`,
// `pq_count_target_in_runs`, `pq_delta_prescan`, `pq_delta_decode`,
// `pq_scan_page_headers`, `pq_decompress_pages`, `pq_dict_chunk_scan` and
// `pq_gather_ba` and `pq_xxh64_batch` (its native.cpp), with its own C ABI.
//
// Every function checks its bounds itself.  A malformed stream returns a
// negative error code (PQ_E_* below), which the Python wrapper turns into
// the CorruptedError of the Python version; nothing reads or writes outside
// the buffers it was given.  No C++ exception leaves an entry point: an
// allocation that fails is a status (MemoryError in Python), and a thread
// the system refuses leaves its work to the threads it has.

#include <dlfcn.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <exception>
#include <initializer_list>
#include <memory>
#include <thread>
#include <vector>

#include "snappy_decode.h"

namespace {

enum {
  PQ_E_ZERO_RUN = -1,   // an RLE hybrid run of zero values
  PQ_E_TRUNCATED = -2,  // the stream ends inside a header or payload
  PQ_E_HEADER = -3,     // a delta header of impossible sizes
  PQ_E_WIDTH = -4,      // a bit width over 64
  PQ_E_CAPACITY = -5,   // more rows than the caller's arrays hold
};

// bytes [byte0, byte0 + 8) of buf, zeros past its end
inline uint64_t load8_clamped(const uint8_t* buf, int64_t len,
                              int64_t byte0) {
  uint64_t w = 0;
  if (byte0 + 8 <= len) {
    std::memcpy(&w, buf + byte0, 8);
  } else {
    for (int b = 0; b < 8 && byte0 + b < len; ++b)
      w |= (uint64_t)buf[byte0 + b] << (8 * b);
  }
  return w;
}

// w <= 64 bits at bit offset `bit`, zeros past the end
inline uint64_t load_bits(const uint8_t* buf, int64_t len, int64_t bit,
                          int w) {
  const int sh = (int)(bit & 7);
  uint64_t v = load8_clamped(buf, len, bit >> 3) >> sh;
  if (sh + w > 64) v |= load8_clamped(buf, len, (bit >> 3) + 8) << (64 - sh);
  return w >= 64 ? v : v & (((uint64_t)1 << w) - 1);
}

// ULEB128 below 2^64; false when the stream ends or the value overflows
inline bool uvarint(const uint8_t* d, int64_t size, int64_t& pos,
                    uint64_t& v) {
  v = 0;
  for (int sh = 0; sh < 64; sh += 7) {
    if (pos >= size) return false;
    const uint8_t b = d[pos++];
    if (sh == 63 && (b & 0x7E)) return false;
    v |= (uint64_t)(b & 0x7F) << sh;
    if (!(b & 0x80)) return true;
  }
  return false;
}

inline int64_t unzigzag(uint64_t r) {
  return (int64_t)(r >> 1) ^ -(int64_t)(r & 1);
}

// ---------------------------------------------------------------------------
// Compact-thrift reader for the page-header walk
// ---------------------------------------------------------------------------

enum { CT_STOP = 0, CT_TRUE = 1, CT_FALSE = 2, CT_I8 = 3, CT_I16 = 4,
       CT_I32 = 5, CT_I64 = 6, CT_DOUBLE = 7, CT_BINARY = 8, CT_LIST = 9,
       CT_SET = 10, CT_MAP = 11, CT_STRUCT = 12 };

struct Thrift {
  const uint8_t* p;
  int64_t pos, size;
  bool err;

  uint64_t uvar() {
    uint64_t v = 0;
    if (!err && !uvarint(p, size, pos, v)) err = true;
    return v;
  }
  int64_t zigzag() { return unzigzag(uvar()); }

  void skip(int wire, int depth) {
    if (err || depth > 16) { err = true; return; }
    switch (wire) {
      case CT_TRUE: case CT_FALSE:
        return;  // the value is the wire type
      case CT_I8:
        if (++pos > size) err = true;
        return;
      case CT_I16: case CT_I32: case CT_I64:
        uvar();
        return;
      case CT_DOUBLE:
        pos += 8;
        if (pos > size) err = true;
        return;
      case CT_BINARY: {
        const uint64_t n = uvar();
        if (err || n > (uint64_t)(size - pos)) { err = true; return; }
        pos += (int64_t)n;
        return;
      }
      case CT_LIST: case CT_SET: {
        if (pos >= size) { err = true; return; }
        const uint8_t h = p[pos++];
        uint64_t n = h >> 4;
        const int ew = h & 0x0F;
        if (n == 0xF) n = uvar();
        // every element takes at least a byte
        if (err || n > (uint64_t)(size - pos)) { err = true; return; }
        if (ew == CT_TRUE || ew == CT_FALSE) {  // a byte per element
          pos += (int64_t)n;
          return;
        }
        for (uint64_t i = 0; i < n && !err; ++i) skip(ew, depth + 1);
        return;
      }
      case CT_MAP: {
        const uint64_t n = uvar();
        if (err || n == 0) return;
        if (n > (uint64_t)(size - pos) || pos >= size) { err = true; return; }
        const uint8_t kv = p[pos++];
        for (uint64_t i = 0; i < n && !err; ++i) {
          skip(kv >> 4, depth + 1);
          skip(kv & 0x0F, depth + 1);
        }
        return;
      }
      case CT_STRUCT:
        fields([](int64_t, int) { return false; }, depth + 1);
        return;
      default:
        err = true;
    }
  }

  // Walk one struct's fields, handing (field id, wire type) to `fn`, which
  // reads the value and returns true, or returns false to skip it.
  template <typename F>
  void fields(F&& fn, int depth = 0) {
    int64_t fid = 0;
    while (!err) {
      if (pos >= size) { err = true; return; }
      const uint8_t h = p[pos++];
      if (h == CT_STOP) return;
      const int delta = h >> 4, wire = h & 0x0F;
      fid = delta ? fid + delta : zigzag();
      if (!fn(fid, wire)) skip(wire, depth);
    }
  }
};

// columns of a page-header row; ops/host.py names them PG_*
enum { PG_HEADER_POS = 0, PG_DATA_POS, PG_TYPE, PG_COMP, PG_UNCOMP, PG_CRC,
       PG_NVALS, PG_ENC, PG_DEF_ENC, PG_REP_ENC, PG_RL_BYTES, PG_DL_BYTES,
       PG_NNULLS, PG_IS_COMPRESSED, PG_DICT_NVALS, PG_NROWS, PG_NFIELDS };

// why a walk stopped early (err_out[0]); err_out[1] is the header's
// position, err_out[2] a detail
enum { STOP_NONE = 0, STOP_BAD_HEADER, STOP_SIZE_RANGE, STOP_TRUNCATED,
       STOP_CAPACITY };
// details of STOP_BAD_HEADER
enum { BAD_THRIFT = 1, BAD_NO_TYPE, BAD_NO_NVALS };

// Parse one PageHeader at r.pos into row (fields it lacks stay -1;
// statistics and unknown fields are skipped).
void parse_page_header(Thrift& r, int64_t* row) {
  const auto i32 = [&](int wire, int64_t& dst) {
    if (wire != CT_I32) return false;
    dst = r.zigzag();
    return true;
  };
  r.fields([&](int64_t fid, int wire) -> bool {
    switch (fid) {
      case 1: return i32(wire, row[PG_TYPE]);
      case 2: return i32(wire, row[PG_UNCOMP]);
      case 3: return i32(wire, row[PG_COMP]);
      case 4:
        if (!i32(wire, row[PG_CRC])) return false;
        row[PG_CRC] = (int64_t)(uint32_t)row[PG_CRC];  // the u32 checksum
        return true;
      case 5:  // data_page_header
        if (wire != CT_STRUCT) return false;
        r.fields([&](int64_t f, int w) -> bool {
          switch (f) {
            case 1: return i32(w, row[PG_NVALS]);
            case 2: return i32(w, row[PG_ENC]);
            case 3: return i32(w, row[PG_DEF_ENC]);
            case 4: return i32(w, row[PG_REP_ENC]);
            default: return false;  // statistics
          }
        }, 1);
        return true;
      case 7:  // dictionary_page_header
        if (wire != CT_STRUCT) return false;
        r.fields([&](int64_t f, int w) -> bool {
          switch (f) {
            case 1: return i32(w, row[PG_DICT_NVALS]);
            case 2: return i32(w, row[PG_ENC]);
            default: return false;
          }
        }, 1);
        return true;
      case 8:  // data_page_header_v2
        if (wire != CT_STRUCT) return false;
        r.fields([&](int64_t f, int w) -> bool {
          if (f == 7 && (w == CT_TRUE || w == CT_FALSE)) {
            row[PG_IS_COMPRESSED] = w == CT_TRUE;
            return true;
          }
          switch (f) {
            case 1: return i32(w, row[PG_NVALS]);
            case 2: return i32(w, row[PG_NNULLS]);
            case 3: return i32(w, row[PG_NROWS]);
            case 4: return i32(w, row[PG_ENC]);
            case 5: return i32(w, row[PG_DL_BYTES]);
            case 6: return i32(w, row[PG_RL_BYTES]);
            default: return false;  // statistics
          }
        }, 1);
        return true;
      default:
        return false;  // index page header, unknown fields
    }
  });
}

// ---------------------------------------------------------------------------
// Batched page decompression
// ---------------------------------------------------------------------------

typedef size_t (*zstd_decompress_fn)(void*, size_t, const void*, size_t);
typedef unsigned (*zstd_is_error_fn)(size_t);

struct Zstd {
  zstd_decompress_fn decompress = nullptr;
  zstd_is_error_fn is_error = nullptr;
};

// libzstd through dlopen, as codecs.py's LIBRARIES names it
const Zstd& zstd() {
  static const Zstd z = [] {
    Zstd out;
    void* h = dlopen("libzstd.so.1", RTLD_NOW);
    if (!h) h = dlopen("libzstd.so", RTLD_NOW);
    if (h) {
      out.decompress = (zstd_decompress_fn)dlsym(h, "ZSTD_decompress");
      out.is_error = (zstd_is_error_fn)dlsym(h, "ZSTD_isError");
    }
    return out;
  }();
  return z;
}

// codec ids are parquet's CompressionCodec: 0 UNCOMPRESSED, 1 SNAPPY,
// 6 ZSTD
bool page_decompress(int codec, const uint8_t* src, int64_t src_len,
                     uint8_t* dst, int64_t dst_len) {
  switch (codec) {
    case 0:
      if (src_len != dst_len) return false;
      if (dst_len) std::memcpy(dst, src, (size_t)dst_len);
      return true;
    case 1:
      return pq::snappy_uncompress(src, src_len, dst, dst_len) == 0;
    case 6: {
      const Zstd& z = zstd();
      if (!z.decompress || !z.is_error) return false;
      const size_t got = z.decompress(dst, (size_t)dst_len, src,
                                      (size_t)src_len);
      return !z.is_error(got) && (int64_t)got == dst_len;
    }
    default:
      return false;
  }
}

// worker() on the calling thread and up to T - 1 more; workers take their
// work from a shared counter, so a thread the system refuses leaves its
// share to the others
template <typename F>
void run_workers(int64_t T, F&& worker) {
  std::vector<std::thread> threads;
  try {
    for (int64_t t = 1; t < T; ++t) threads.emplace_back(worker);
  } catch (const std::exception&) {
  }
  worker();
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// The scans' cores: each run or miniblock goes to `emit`, which returns
// false when the caller has no room (PQ_E_CAPACITY)
// ---------------------------------------------------------------------------

// RLE/bit-packed hybrid runs of n values at bit_width bits: emit(kind,
// count, payload, byte offset); see pq_scan_rle_runs.  Returns 0, or an
// error code.
template <typename Emit>
int64_t scan_runs(const uint8_t* data, int64_t size, int64_t n,
                  int64_t bit_width, Emit&& emit, int64_t* end_pos) {
  if (bit_width < 0 || bit_width > 64) return PQ_E_WIDTH;
  const int64_t vbytes = (bit_width + 7) / 8;
  const uint64_t mask =
      bit_width >= 64 ? ~0ull : (((uint64_t)1 << bit_width) - 1);
  int64_t pos = 0, remaining = n;
  while (remaining > 0) {
    uint64_t header;
    if (!uvarint(data, size, pos, header)) return PQ_E_TRUNCATED;
    const uint64_t count = header >> 1;
    if (count == 0) return PQ_E_ZERO_RUN;
    int64_t take;
    if (header & 1) {
      // count groups of 8 values, bit_width bytes each
      if (bit_width && count > (uint64_t)(size - pos) / bit_width)
        return PQ_E_TRUNCATED;
      const uint64_t values = count > (uint64_t)remaining / 8 + 1
                                  ? (uint64_t)remaining + 8
                                  : count * 8;
      take = values < (uint64_t)remaining ? (int64_t)values : remaining;
      if (!emit(1, take, (int64_t)0, pos)) return PQ_E_CAPACITY;
      pos += (int64_t)count * bit_width;
    } else {
      if (vbytes > size - pos) return PQ_E_TRUNCATED;
      uint64_t value = 0;
      for (int64_t j = 0; j < vbytes; ++j)
        value |= (uint64_t)data[pos + j] << (8 * j);
      pos += vbytes;
      take = count < (uint64_t)remaining ? (int64_t)count : remaining;
      if (!emit(0, take, (int64_t)(value & mask), pos)) return PQ_E_CAPACITY;
    }
    remaining -= take;
  }
  end_pos[0] = pos;
  return 0;
}

// DELTA_BINARY_PACKED miniblocks of the stream at pos: emit(bit offset,
// width, min delta); header_out as pq_delta_prescan's.  Returns 0, or an
// error code.
template <typename Emit>
int64_t delta_scan(const uint8_t* data, int64_t size, int64_t pos,
                   int64_t* header_out, Emit&& emit) {
  uint64_t bs, nmb, total, first;
  if (!uvarint(data, size, pos, bs) || !uvarint(data, size, pos, nmb) ||
      !uvarint(data, size, pos, total) || !uvarint(data, size, pos, first))
    return PQ_E_TRUNCATED;
  header_out[4] = (int64_t)(bs & INT64_MAX);
  header_out[5] = (int64_t)(nmb & INT64_MAX);
  // untrusted sizes: keep every product far inside int64
  if (nmb == 0 || bs == 0 || bs % nmb || bs > (1u << 30) || total >> 62)
    return PQ_E_HEADER;
  const int64_t vpm = (int64_t)(bs / nmb);
  header_out[0] = unzigzag(first);
  header_out[1] = (int64_t)total;
  header_out[2] = vpm;
  int64_t got = 1;
  while (got < (int64_t)total) {
    uint64_t md;
    if (!uvarint(data, size, pos, md)) return PQ_E_TRUNCATED;
    const int64_t min_delta = unzigzag(md);
    if ((uint64_t)(size - pos) < nmb) return PQ_E_TRUNCATED;
    const uint8_t* wb = data + pos;
    pos += (int64_t)nmb;
    for (uint64_t m = 0; m < nmb && got < (int64_t)total; ++m) {
      const int64_t w = wb[m];
      if (w > 64) return PQ_E_WIDTH;
      const int64_t take = std::min<int64_t>(vpm, (int64_t)total - got);
      if (take * w > (size - pos) * 8) return PQ_E_TRUNCATED;
      if (!emit(pos * 8, w, min_delta)) return PQ_E_CAPACITY;
      pos += vpm * w / 8;
      got += take;
    }
  }
  header_out[3] = pos;
  return 0;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// RLE/bit-packed hybrid run scan: one row per run of `n` values at
// `bit_width` (0..64) bits.  kinds 0 = RLE (payload = its value, offset =
// the byte after the value), 1 = bit-packed (offset = its first payload
// byte); counts are clipped to the values left.  The arrays hold n rows
// (every run covers at least one value).  Returns the run count, and the
// byte after the last run in end_pos[0]; PQ_E_ZERO_RUN or PQ_E_TRUNCATED
// (a header, an RLE value or a bit-packed payload past the stream).
// ---------------------------------------------------------------------------
int64_t pq_scan_rle_runs(const uint8_t* data, int64_t size, int64_t n,
                         int64_t bit_width, uint8_t* kinds, int64_t* counts,
                         int64_t* payloads, int64_t* offsets,
                         int64_t* end_pos) {
  int64_t k = 0;
  const int64_t rc = scan_runs(
      data, size, n, bit_width,
      [&](int kind, int64_t count, int64_t payload, int64_t off) {
        if (k >= n) return false;
        kinds[k] = (uint8_t)kind;
        counts[k] = count;
        payloads[k] = payload;
        offsets[k] = off;
        ++k;
        return true;
      },
      end_pos);
  return rc < 0 ? rc : k;
}

// ---------------------------------------------------------------------------
// How many values of a scanned run table equal `target` (def == max_def:
// the present count of a page).  RLE runs compare their payload; packed
// runs walk their bits.  width 0..32; -1 for a packed run past the body.
// ---------------------------------------------------------------------------
int64_t pq_count_target_in_runs(const uint8_t* body, int64_t body_len,
                                const uint8_t* kinds, const int64_t* counts,
                                const int64_t* payloads,
                                const int64_t* offsets, int64_t k,
                                int64_t width, int64_t target) {
  if (width < 0 || width > 32) return -1;
  const uint64_t mask = ((uint64_t)1 << width) - 1;
  int64_t total = 0;
  for (int64_t r = 0; r < k; ++r) {
    if (kinds[r] == 0) {
      if (payloads[r] == target) total += counts[r];
      continue;
    }
    const int64_t n = counts[r];
    if (width == 0) {
      if (target == 0) total += n;
      continue;
    }
    int64_t bit = offsets[r] * 8;
    if (bit < 0 || bit + n * width > body_len * 8) return -1;
    for (int64_t i = 0; i < n; ++i, bit += width) {
      const uint64_t v = load8_clamped(body, body_len, bit >> 3) >> (bit & 7);
      total += (int64_t)((v & mask) == (uint64_t)target);
    }
  }
  return total;
}

// ---------------------------------------------------------------------------
// DELTA_BINARY_PACKED miniblock table of the stream at `pos`, O(miniblocks).
// header_out = {first value, total, values per miniblock, end position,
// block size, miniblocks per block} (the last two also on PQ_E_HEADER).
// Per miniblock: its payload's bit offset, width and min delta; `cap` rows.
// Returns the miniblock count, or PQ_E_TRUNCATED (a varint, the widths or
// the bits of counted values past the stream), PQ_E_HEADER, PQ_E_WIDTH,
// PQ_E_CAPACITY.  A writer may cut the last miniblock short after its last
// value: only bits of the `total` values must lie in the stream.
// ---------------------------------------------------------------------------
int64_t pq_delta_prescan(const uint8_t* data, int64_t size, int64_t pos,
                         int64_t cap, int64_t* header_out, int64_t* offsets,
                         int32_t* widths, int64_t* mins) {
  int64_t k = 0;
  const int64_t rc = delta_scan(
      data, size, pos, header_out,
      [&](int64_t off, int64_t w, int64_t min_delta) {
        if (k >= cap) return false;
        offsets[k] = off;
        widths[k] = (int32_t)w;
        mins[k] = min_delta;
        ++k;
        return true;
      });
  return rc < 0 ? rc : k;
}

// ---------------------------------------------------------------------------
// Decode one DELTA_BINARY_PACKED stream from its miniblock table (from
// pq_delta_prescan) to `total` int64 values, mod-2^64 prefix sums.
// Returns 0, or PQ_E_TRUNCATED for bits past the stream.
// ---------------------------------------------------------------------------
int64_t pq_delta_decode(const uint8_t* data, int64_t size, int64_t first,
                        int64_t total, int64_t vpm, const int64_t* offsets,
                        const int32_t* widths, const int64_t* mins,
                        int64_t k, int64_t* out) {
  if (total <= 0) return 0;
  uint64_t v = (uint64_t)first;
  out[0] = first;
  int64_t got = 1;
  for (int64_t m = 0; m < k && got < total; ++m) {
    const int w = widths[m];
    const uint64_t mn = (uint64_t)mins[m];
    const int64_t take = std::min(vpm, total - got);
    int64_t bit = offsets[m];
    if (w < 0 || w > 64 || bit < 0 || bit + (int64_t)w * take > size * 8)
      return PQ_E_TRUNCATED;
    for (int64_t j = 0; j < take; ++j, bit += w) {
      v += (w ? load_bits(data, size, bit, w) : 0) + mn;
      out[got + j] = (int64_t)v;
    }
    got += take;
  }
  return got >= total ? 0 : PQ_E_TRUNCATED;
}

// ---------------------------------------------------------------------------
// Page-header table of a chunk's page stream: one PG_NFIELDS row a page
// (-1 where the header lacks the field), walking while fewer than
// `total_values` data values were seen (a negative total: no limit) and
// bytes remain.  Stops early at a malformed header (err_out = {STOP_*,
// header position, detail}), a compressed size outside 0..max_page_size
// (detail: the size, INT64_MIN when absent), a payload past the buffer, or
// after `cap` rows while pages remain (STOP_CAPACITY).  Returns the rows
// parsed.
// ---------------------------------------------------------------------------
int64_t pq_scan_page_headers(const uint8_t* buf, int64_t size,
                             int64_t total_values, int64_t max_page_size,
                             int64_t* out, int64_t cap, int64_t* err_out) {
  int64_t pos = 0, seen = 0, k = 0;
  err_out[0] = STOP_NONE;
  const auto stop = [&](int64_t why, int64_t detail) {
    err_out[0] = why;
    err_out[1] = pos;
    err_out[2] = detail;
    return k;
  };
  while ((total_values < 0 || seen < total_values) && pos < size) {
    if (k >= cap) return stop(STOP_CAPACITY, 0);
    int64_t* row = out + k * PG_NFIELDS;
    for (int i = 0; i < PG_NFIELDS; ++i) row[i] = -1;
    row[PG_HEADER_POS] = pos;
    row[PG_COMP] = INT64_MIN;  // absent, as against a written -1
    Thrift r{buf, pos, size, false};
    parse_page_header(r, row);
    if (r.err) return stop(STOP_BAD_HEADER, BAD_THRIFT);
    if (row[PG_TYPE] < 0) return stop(STOP_BAD_HEADER, BAD_NO_TYPE);
    const int64_t clen = row[PG_COMP];
    if (clen < 0 || clen > max_page_size) return stop(STOP_SIZE_RANGE, clen);
    if (clen > size - r.pos) return stop(STOP_TRUNCATED, 0);
    row[PG_DATA_POS] = r.pos;
    if (row[PG_TYPE] == 0 || row[PG_TYPE] == 3) {  // DATA_PAGE, _V2
      if (row[PG_NVALS] < 0) return stop(STOP_BAD_HEADER, BAD_NO_NVALS);
      seen += row[PG_NVALS];
    }
    pos = r.pos + clen;
    ++k;
  }
  return k;
}

// 1 when libzstd loaded (dlopen), else 0
int64_t pq_zstd_available() {
  const Zstd& z = zstd();
  return z.decompress && z.is_error ? 1 : 0;
}

// ---------------------------------------------------------------------------
// Decompress n_pages payloads (one source pointer and length each) into
// one buffer, page i at out[out_offs[i], out_offs[i + 1]), on `nthreads`
// threads (each takes the next page).  codec: 0 UNCOMPRESSED, 1 SNAPPY (the
// port's decoder), 6 ZSTD (dlopen).  Returns 0, or -(i + 1) for the
// lowest-numbered page that failed.
// ---------------------------------------------------------------------------
int64_t pq_decompress_pages(const int64_t* src_ptrs, const int64_t* src_lens,
                            int64_t n_pages, int64_t codec, uint8_t* out,
                            const int64_t* out_offs, int64_t nthreads) {
  std::atomic<int64_t> first_bad{n_pages}, next{0};
  const auto run = [&] {
    int64_t i;
    while ((i = next.fetch_add(1)) < n_pages) {
      const auto* src = (const uint8_t*)(uintptr_t)src_ptrs[i];
      if (!page_decompress((int)codec, src, src_lens[i], out + out_offs[i],
                           out_offs[i + 1] - out_offs[i])) {
        int64_t cur = first_bad.load();
        while (i < cur && !first_bad.compare_exchange_weak(cur, i)) {
        }
      }
    }
  };
  run_workers(std::max<int64_t>(1, std::min(nthreads, n_pages)), run);
  const int64_t bad = first_bad.load();
  return bad < n_pages ? -(bad + 1) : 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// The chunk planner: every data page of a column chunk (or of a span of
// its pages) decompressed and prescanned in one call, into the chunk-level
// tables of device_reader._Plan, as device_reader._build_plan_python
// builds them page by page.  The JAX package's pq_dict_chunk_scan design
// for every page kind: a layout pass (each page's decompressed body has
// its own slice of the caller's buffer), a threaded page pass (pages
// write only their own PageOut), and a merge in page order (the tables
// compacted, counts turned into ends, bases added, errors raised in the
// order the page walk raises them).
// ---------------------------------------------------------------------------

namespace {

// the _Plan's value kinds (device_reader.VALUE_KINDS)
enum { K_PLAIN_FIXED = 0, K_PLAIN_FLBA, K_BOOL, K_DICT, K_DELTA, K_BSS,
       K_DBA, K_HOST_BA };
// a plan's status (INFO_STATUS)
// (ST_MEMORY: an allocation failed; ST_ENUM: an encoding the format does
// not define, a0 its value; ST_NOT_READ: an encoding the read does not
// decode for the column, a0 the encoding, a1 the physical type)
enum { ST_OK = 0, ST_CORRUPT, ST_UNSUPPORTED, ST_OUTSIDE, ST_DECOMPRESS,
       ST_MEMORY, ST_ENUM, ST_NOT_READ };
// CorruptedError codes (args in INFO_A0..A2; ops/host.py words them)
enum { C_RLE_ZERO = 1, C_RLE_TRUNCATED, C_RLE_WIDTH, C_LEN_TRUNCATED,
       C_LEN_OVERRUN, C_SHORT, C_DELTA_TYPE, C_BSS_TYPE, C_DELTA_HEADER,
       C_DELTA_WIDTH, C_DELTA_TRUNCATED, C_DLBA, C_DBA_COUNT, C_DBA_PREFIX,
       C_LEVEL_BYTES, C_COUNTS, C_TYPE_LENGTH, C_LEN_COUNT };
// _Unsupported reasons
enum { U_MIXED_KINDS = 1, U_BIT_PACKED_REPEATED, U_BSS_INT96,
       U_DBA_FIRST_PREFIX };
// the shape the planner leaves to the Python walk
enum { O_BIT_PACKED_LEVELS = 1 };
// where in a page's walk an error arises: before or after its value kind
// is set (a kind that differs from the chunk's raises in between)
enum { AT_LEVELS = 0, AT_VALUES };
// physical types
enum { T_BOOLEAN = 0, T_INT32, T_INT64, T_INT96, T_FLOAT, T_DOUBLE,
       T_BYTE_ARRAY, T_FLBA };
// per-page source columns (ops/host.py's SRC_*)
enum { S_PAYLOAD = 0, S_PAYLOAD_LEN, S_BODY, S_BODY_LEN, S_CODEC, S_SIZE,
       S_OUT_OFF, S_NFIELDS };

struct RunList {
  std::vector<uint8_t> kinds;
  std::vector<int64_t> counts, payloads, offs;  // offs: bytes into stream
  int64_t width = 0, n = 0;
};

struct PageOut {
  bool data = false, decompress_failed = false;
  int status = ST_OK, code = 0, at = AT_LEVELS;
  int64_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  int kind = -1;
  int64_t n = 0, present = 0;
  bool expanded = false;
  const uint8_t* rep = nullptr;
  int64_t rep_len = 0;
  bool has_rep = false;
  RunList rep_runs;
  const uint8_t* def = nullptr;
  int64_t def_len = 0;
  bool has_def = false;
  RunList def_runs;
  bool has_host_def = false;
  std::vector<int32_t> host_def;
  const uint8_t* val = nullptr;  // the page's part of the values stream
  int64_t val_len = 0;
  bool has_vruns = false;
  RunList vruns;
  int64_t dict_w = -1;
  int64_t d_first = 0, d_count = 0, d_vpm = 0;
  std::vector<int64_t> mb_offs, mb_widths, mb_mins;  // offs: bits into val
  int64_t bss_n = 0;
  std::vector<int64_t> plens, slens;
  int64_t hb_kind = -1, hb_count = 0;
  const uint8_t* hb = nullptr;
  int64_t hb_len = 0;
  std::vector<int64_t> hb_lens;
};

struct ChunkIn {
  const int64_t* rows;
  const int64_t* srcs;
  int64_t max_def, max_rep, physical, type_length;
  uint8_t* bodies;
  int64_t bodies_cap;
};

inline const uint8_t* as_ptr(int64_t p) {
  return (const uint8_t*)(uintptr_t)p;
}

inline bool valid_encoding(int64_t e) {
  return e == 0 || (e >= 2 && e <= 9);
}

inline int bit_width_of(int64_t max_level) {
  int w = 0;
  while (max_level >> w) ++w;
  return w;
}

bool fail(PageOut& p, int status, int code, int at, int64_t a0 = 0,
          int64_t a1 = 0, int64_t a2 = 0, int64_t a3 = 0) {
  p.status = status;
  p.code = code;
  p.at = at;
  p.a0 = a0;
  p.a1 = a1;
  p.a2 = a2;
  p.a3 = a3;
  return false;
}

bool run_error(PageOut& p, int64_t rc, int at, int64_t w) {
  if (rc == PQ_E_ZERO_RUN) return fail(p, ST_CORRUPT, C_RLE_ZERO, at);
  if (rc == PQ_E_WIDTH) return fail(p, ST_CORRUPT, C_RLE_WIDTH, at, w);
  return fail(p, ST_CORRUPT, C_RLE_TRUNCATED, at);
}

// the hybrid stream's run table, as host.scan_rle_runs gives it
bool scan_into(PageOut& p, const uint8_t* d, int64_t size, int64_t n,
               int64_t w, RunList& out, int at) {
  out.width = w;
  out.n = n;
  int64_t end;
  const int64_t rc = scan_runs(
      d, size, n, w,
      [&](int kind, int64_t count, int64_t payload, int64_t off) {
        out.kinds.push_back((uint8_t)kind);
        out.counts.push_back(count);
        out.payloads.push_back(payload);
        out.offs.push_back(off);
        return true;
      },
      &end);
  return rc < 0 ? run_error(p, rc, at, w) : true;
}

// the values of a scanned run table (w <= 32), as ref.decode_rle does
void expand_runs(const uint8_t* d, int64_t size, const RunList& r,
                 std::vector<int32_t>& out) {
  const uint64_t mask = ((uint64_t)1 << r.width) - 1;
  for (size_t k = 0; k < r.kinds.size(); ++k) {
    const int64_t c = r.counts[k];
    if (r.kinds[k] == 0) {
      out.insert(out.end(), (size_t)c, (int32_t)r.payloads[k]);
      continue;
    }
    int64_t bit = r.offs[k] * 8;
    for (int64_t i = 0; i < c; ++i, bit += r.width) {
      const uint64_t v =
          r.width ? load8_clamped(d, size, bit >> 3) >> (bit & 7) : 0;
      out.push_back((int32_t)(v & mask));
    }
  }
}

// a 4-byte length and the stream behind it, inside raw
bool len_prefixed(PageOut& p, const uint8_t* raw, int64_t len, int64_t pos,
                  int64_t what, const uint8_t*& body, int64_t& body_len,
                  int at) {
  if (pos + 4 > len) return fail(p, ST_CORRUPT, C_LEN_TRUNCATED, at, what);
  uint32_t l;
  std::memcpy(&l, raw + pos, 4);
  if (pos + 4 + (int64_t)l > len)
    return fail(p, ST_CORRUPT, C_LEN_OVERRUN, at, what, l);
  body = raw + pos + 4;
  body_len = l;
  return true;
}

bool delta_error(PageOut& p, int64_t rc, const int64_t* header) {
  if (rc == PQ_E_HEADER)
    return fail(p, ST_CORRUPT, C_DELTA_HEADER, AT_VALUES, header[4],
                header[5]);
  if (rc == PQ_E_WIDTH) return fail(p, ST_CORRUPT, C_DELTA_WIDTH, AT_VALUES);
  return fail(p, ST_CORRUPT, C_DELTA_TRUNCATED, AT_VALUES);
}

// the miniblock rows delta_scan emits for the stream at pos: one a counted
// miniblock, each with a width byte in the stream (0 for a header it
// refuses)
size_t delta_rows(const uint8_t* raw, int64_t len, int64_t pos) {
  uint64_t bs, nmb, total;
  if (!uvarint(raw, len, pos, bs) || !uvarint(raw, len, pos, nmb) ||
      !uvarint(raw, len, pos, total) || nmb == 0 || bs < nmb ||
      bs > (1u << 30) || total >> 62)
    return 0;
  const uint64_t vpm = bs / nmb;
  const uint64_t counted = total ? (total - 1 + vpm - 1) / vpm : 0;
  return (size_t)std::min<uint64_t>(counted, (uint64_t)(len - pos));
}

// a DELTA_BINARY_PACKED length stream at pos, of at most max_count values
// (the page's), to its values and end, as host.decode_delta_binary_packed
bool delta_values(PageOut& p, const uint8_t* raw, int64_t len, int64_t pos,
                  int64_t max_count, std::vector<int64_t>& out,
                  int64_t& end) {
  int64_t header[6] = {0, 0, 0, 0, 0, 0};
  std::vector<int64_t> offs, mins;
  std::vector<int32_t> widths;
  const size_t rows = delta_rows(raw, len, pos);
  offs.reserve(rows);
  mins.reserve(rows);
  widths.reserve(rows);
  const int64_t rc = delta_scan(raw, len, pos, header,
                                [&](int64_t off, int64_t w, int64_t mn) {
                                  offs.push_back(off);
                                  widths.push_back((int32_t)w);
                                  mins.push_back(mn);
                                  return true;
                                });
  if (rc < 0) return delta_error(p, rc, header);
  // the header's count is the file's: checked before it sizes anything
  if (header[1] > max_count)
    return fail(p, ST_CORRUPT, C_LEN_COUNT, AT_VALUES, header[1], max_count);
  out.resize((size_t)std::max<int64_t>(header[1], 1));
  if (pq_delta_decode(raw, len, header[0], header[1], header[2], offs.data(),
                      widths.data(), mins.data(), (int64_t)offs.size(),
                      out.data()))
    return fail(p, ST_CORRUPT, C_DELTA_TRUNCATED, AT_VALUES);
  out.resize((size_t)header[1]);
  end = header[3];
  return true;
}

// DELTA_LENGTH_BYTE_ARRAY lengths at pos: their bytes follow at `end`
bool length_stream(PageOut& p, const uint8_t* raw, int64_t len, int64_t pos,
                   int64_t max_count, std::vector<int64_t>& lens,
                   int64_t& end, int64_t& total) {
  if (!delta_values(p, raw, len, pos, max_count, lens, end)) return false;
  uint64_t sum = 0;
  bool negative = false;
  for (int64_t l : lens) {
    sum += (uint64_t)l;
    negative |= l < 0;
  }
  total = (int64_t)sum;
  if (negative || end + total > len)
    return fail(p, ST_CORRUPT, C_DLBA, AT_VALUES, (int64_t)lens.size(),
                total, len - end);
  return true;
}

bool check_length(PageOut& p, int64_t len, int64_t pos, int64_t nbytes,
                  int64_t nvals, int64_t what) {
  if (len - pos < nbytes)
    return fail(p, ST_CORRUPT, C_SHORT, AT_VALUES, what, len - pos, nvals,
                nbytes);
  return true;
}

int64_t fixed_width(int64_t physical) {
  switch (physical) {
    case T_INT32: case T_FLOAT: return 4;
    case T_INT64: case T_DOUBLE: return 8;
    case T_INT96: return 12;
    default: return -1;
  }
}

// device_reader._stage_values of one page: nvals values at raw[pos:]
bool page_values(PageOut& p, const ChunkIn& in, const uint8_t* raw,
                 int64_t len, int64_t pos, int64_t nvals, int64_t enc) {
  const int64_t phys = in.physical;
  switch (enc) {
    case 2: case 8: {  // PLAIN_DICTIONARY, RLE_DICTIONARY
      p.kind = K_DICT;
      const int64_t w = pos < len ? raw[pos] : 0;
      p.val = raw + std::min(pos + 1, len);
      p.val_len = std::max<int64_t>(len - pos - 1, 0);
      p.dict_w = w;
      p.has_vruns = true;
      if (w == 0) {  // single-entry dictionary: one RLE run of index 0
        p.vruns = RunList();
        p.vruns.kinds.push_back(0);
        p.vruns.counts.push_back(nvals);
        p.vruns.payloads.push_back(0);
        p.vruns.offs.push_back(0);
        p.vruns.width = 1;
        p.vruns.n = nvals;
        return true;
      }
      return scan_into(p, p.val, p.val_len, nvals, w, p.vruns, AT_VALUES);
    }
    case 0: {  // PLAIN
      if (phys == T_BOOLEAN) {
        p.kind = K_BOOL;
        const int64_t nbytes = (nvals + 7) / 8;
        if (!check_length(p, len, pos, nbytes, nvals, 0)) return false;
        p.val = raw + pos;
        p.val_len = nbytes;
        p.has_vruns = true;
        p.vruns.kinds.push_back(1);
        p.vruns.counts.push_back(nvals);
        p.vruns.payloads.push_back(0);
        p.vruns.offs.push_back(0);
        p.vruns.width = 1;
        p.vruns.n = nvals;
        return true;
      }
      if (phys == T_BYTE_ARRAY) {  // offsets scanned at staging
        p.kind = K_HOST_BA;
        p.hb_kind = 0;
        p.hb = raw + pos;
        p.hb_len = len - pos;
        p.hb_count = nvals;
        return true;
      }
      int64_t w;
      if (phys == T_FLBA) {
        p.kind = K_PLAIN_FLBA;
        if (in.type_length < 0)
          return fail(p, ST_CORRUPT, C_TYPE_LENGTH, AT_VALUES);
        w = in.type_length;
      } else {
        p.kind = K_PLAIN_FIXED;
        w = fixed_width(phys);
      }
      if (!check_length(p, len, pos, nvals * w, nvals, 0)) return false;
      p.val = raw + pos;
      p.val_len = nvals * w;
      return true;
    }
    case 5: {  // DELTA_BINARY_PACKED
      if (phys != T_INT32 && phys != T_INT64)
        return fail(p, ST_CORRUPT, C_DELTA_TYPE, AT_LEVELS, phys);
      p.kind = K_DELTA;
      p.val = raw + pos;
      p.val_len = len - pos;
      int64_t header[6] = {0, 0, 0, 0, 0, 0};
      const size_t rows = delta_rows(raw, len, pos);
      for (auto* v : {&p.mb_offs, &p.mb_widths, &p.mb_mins}) v->reserve(rows);
      const int64_t rc = delta_scan(raw, len, pos, header,
                                    [&](int64_t off, int64_t w, int64_t mn) {
                                      p.mb_offs.push_back(off - pos * 8);
                                      p.mb_widths.push_back(w);
                                      p.mb_mins.push_back(mn);
                                      return true;
                                    });
      if (rc < 0) return delta_error(p, rc, header);
      p.d_first = header[0];
      p.d_count = header[1];
      p.d_vpm = header[2];
      return true;
    }
    case 9: {  // BYTE_STREAM_SPLIT
      if (phys == T_INT96)
        return fail(p, ST_UNSUPPORTED, U_BSS_INT96, AT_LEVELS);
      const int64_t w = phys == T_FLBA ? in.type_length
                        : phys == T_INT96 || phys == T_BOOLEAN ||
                                  phys == T_BYTE_ARRAY
                            ? 0
                            : fixed_width(phys);
      if (w <= 0) return fail(p, ST_CORRUPT, C_BSS_TYPE, AT_LEVELS, phys);
      p.kind = K_BSS;
      if (!check_length(p, len, pos, nvals * w, nvals, 1)) return false;
      p.val = raw + pos;
      p.val_len = nvals * w;
      p.bss_n = nvals;
      return true;
    }
    case 3: {  // RLE booleans
      if (phys != T_BOOLEAN)
        return fail(p, ST_NOT_READ, 0, AT_LEVELS, enc, phys);
      p.kind = K_BOOL;
      if (!len_prefixed(p, raw, len, pos, 1, p.val, p.val_len, AT_VALUES))
        return false;
      p.has_vruns = true;
      return scan_into(p, p.val, p.val_len, nvals, 1, p.vruns, AT_VALUES);
    }
    case 6: {  // DELTA_LENGTH_BYTE_ARRAY
      if (phys != T_BYTE_ARRAY)
        return fail(p, ST_NOT_READ, 0, AT_LEVELS, enc, phys);
      p.kind = K_HOST_BA;
      int64_t end, total;
      if (!length_stream(p, raw, len, pos, nvals, p.hb_lens, end, total))
        return false;
      p.hb_kind = 1;
      p.hb = raw + end;
      p.hb_len = total;
      p.hb_count = (int64_t)p.hb_lens.size();
      return true;
    }
    case 7: {  // DELTA_BYTE_ARRAY: prefix lengths, then the suffixes
      if (phys != T_BYTE_ARRAY && phys != T_FLBA)
        return fail(p, ST_NOT_READ, 0, AT_LEVELS, enc, phys);
      p.kind = K_DBA;
      int64_t end, end2, total;
      if (!delta_values(p, raw, len, pos, nvals, p.plens, end)) return false;
      if (!length_stream(p, raw, len, end, nvals, p.slens, end2, total))
        return false;
      const int64_t n = (int64_t)p.plens.size();
      if (n != (int64_t)p.slens.size())
        return fail(p, ST_CORRUPT, C_DBA_COUNT, AT_VALUES, n,
                    (int64_t)p.slens.size());
      // front coding restarts on every page: a nonzero first prefix
      // would chase a value of another page
      if (n && p.plens[0] != 0)
        return fail(p, ST_UNSUPPORTED, U_DBA_FIRST_PREFIX, AT_VALUES);
      for (int64_t i = 0; i < n; ++i) {
        if (p.plens[i] < 0 ||
            (i && p.plens[i] > p.slens[i - 1] + p.plens[i - 1]))
          return fail(p, ST_CORRUPT, C_DBA_PREFIX, AT_VALUES);
      }
      p.val = raw + end2;
      p.val_len = total;
      return true;
    }
    default:
      return fail(p, ST_NOT_READ, 0, AT_LEVELS, enc, phys);
  }
}

// the def levels of a struct chain, expanded on the host
bool host_levels(PageOut& p, const uint8_t* d, int64_t size, int64_t n,
                 int64_t w) {
  RunList r;
  if (!scan_into(p, d, size, n, w, r, AT_LEVELS)) return false;
  p.has_host_def = true;
  p.host_def.reserve((size_t)n);
  expand_runs(d, size, r, p.host_def);
  return true;
}

// device_reader._build_plan_python's walk of one data page
bool plan_page(const ChunkIn& in, int64_t i, PageOut& p) {
  const int64_t* row = in.rows + i * PG_NFIELDS;
  const int64_t* src = in.srcs + i * S_NFIELDS;
  const int64_t pt = row[PG_TYPE];
  if (pt != 0 && pt != 3) return true;  // dictionary, index pages
  p.data = true;
  const uint8_t* raw;
  int64_t len;
  if (src[S_CODEC] == 0) {  // the body as it lies (zero copy)
    raw = as_ptr(src[S_BODY]);
    len = src[S_BODY_LEN];
  } else {
    const int64_t size = src[S_SIZE], off = src[S_OUT_OFF];
    if (size < 0 || off < 0 || off > in.bodies_cap - size ||
        !page_decompress((int)src[S_CODEC], as_ptr(src[S_BODY]),
                         src[S_BODY_LEN], in.bodies + off, size)) {
      p.decompress_failed = true;
      return false;
    }
    raw = in.bodies + off;
    len = size;
  }
  const int64_t max_def = in.max_def, max_rep = in.max_rep;
  const int dw = bit_width_of(max_def), rw = bit_width_of(max_rep);
  const bool struct_chain = max_rep == 0 && max_def > 1;
  const int64_t n = row[PG_NVALS];
  p.n = n;
  int64_t pos = 0;
  if (pt == 0) {  // DATA_PAGE: levels behind 4-byte lengths
    if (n < 0) return fail(p, ST_CORRUPT, C_COUNTS, AT_LEVELS, n, 0);
    const int64_t def_enc = row[PG_DEF_ENC];
    if (!valid_encoding(def_enc))
      return fail(p, ST_ENUM, 0, AT_LEVELS, def_enc);
    const bool rle_def = def_enc == 3;
    p.present = n;
    if (max_rep > 0) {
      const int64_t rep_enc = row[PG_REP_ENC];
      if (!valid_encoding(rep_enc))
        return fail(p, ST_ENUM, 0, AT_LEVELS, rep_enc);
      if (rep_enc != 3 || !rle_def)
        return fail(p, ST_UNSUPPORTED, U_BIT_PACKED_REPEATED, AT_LEVELS);
      if (!len_prefixed(p, raw, len, pos, 0, p.rep, p.rep_len, AT_LEVELS))
        return false;
      p.has_rep = true;
      if (!scan_into(p, p.rep, p.rep_len, n, rw, p.rep_runs, AT_LEVELS))
        return false;
      pos += 4 + p.rep_len;
    }
    if (max_def > 0) {
      if (!rle_def)  // legacy BIT_PACKED levels
        return fail(p, ST_OUTSIDE, O_BIT_PACKED_LEVELS, AT_LEVELS);
      const uint8_t* body;
      int64_t body_len;
      if (!len_prefixed(p, raw, len, pos, 0, body, body_len, AT_LEVELS))
        return false;
      pos += 4 + body_len;
      if (struct_chain) {
        if (!host_levels(p, body, body_len, n, dw)) return false;
        int64_t present = 0;
        for (int32_t v : p.host_def) present += v == max_def;
        p.present = present;
        p.expanded = present != n;
      } else {
        p.def = body;
        p.def_len = body_len;
        p.has_def = true;
        RunList& r = p.def_runs;
        if (!scan_into(p, body, body_len, n, dw, r, AT_LEVELS)) return false;
        p.present = pq_count_target_in_runs(
            body, body_len, r.kinds.data(), r.counts.data(),
            r.payloads.data(), r.offs.data(), (int64_t)r.kinds.size(), dw,
            max_def);
        if (p.present < 0)
          return fail(p, ST_CORRUPT, C_RLE_TRUNCATED, AT_LEVELS);
        const bool all_present = r.kinds.size() == 1 && r.kinds[0] == 0 &&
                                 r.payloads[0] == max_def;
        p.expanded = n && !all_present;
      }
    }
  } else {  // DATA_PAGE_V2: levels uncompressed ahead of the body
    const int64_t nulls = row[PG_NNULLS] < 0 ? 0 : row[PG_NNULLS];
    if (n < 0 || nulls > n)
      return fail(p, ST_CORRUPT, C_COUNTS, AT_LEVELS, n, nulls);
    const int64_t rl = row[PG_RL_BYTES] == -1 ? 0 : row[PG_RL_BYTES];
    const int64_t dl = row[PG_DL_BYTES] == -1 ? 0 : row[PG_DL_BYTES];
    const uint8_t* payload = as_ptr(src[S_PAYLOAD]);
    if (rl < 0 || dl < 0 || rl + dl > src[S_PAYLOAD_LEN])
      return fail(p, ST_CORRUPT, C_LEVEL_BYTES, AT_LEVELS, rl, dl,
                  src[S_PAYLOAD_LEN]);
    if (max_rep > 0) {
      p.rep = payload;
      p.rep_len = rl;
      p.has_rep = true;
      if (!scan_into(p, p.rep, rl, n, rw, p.rep_runs, AT_LEVELS))
        return false;
    }
    if (max_def > 0) {
      if (struct_chain) {
        if (!host_levels(p, payload + rl, dl, n, dw)) return false;
      } else {
        p.def = payload + rl;
        p.def_len = dl;
        p.has_def = true;
        if (!scan_into(p, p.def, dl, n, dw, p.def_runs, AT_LEVELS))
          return false;
      }
      p.expanded = nulls != 0;
    }
    p.present = n - nulls;
  }
  const int64_t enc = row[PG_ENC];
  if (!valid_encoding(enc)) return fail(p, ST_ENUM, 0, AT_LEVELS, enc);
  return page_values(p, in, raw, len, pos, p.present, enc);
}

struct Seg {
  int64_t ptr, len;
};

// one part of an exported array: n elements written from src
enum { P_COPY = 0,  // int64 src[i] + add
       P_BITS,      // (int64 src[i] + add) * 8: byte offsets to bits
       P_CUMSUM,    // add + src[0] + ... + src[i]: counts to ends
       P_EXCLUSIVE, // add + src[0] + ... + src[i - 1]: lengths to starts
       P_WIDEN,     // uint8 src[i]
       P_FILL,      // add
       P_COPY32 };  // int32 src[i], into an int32 array

struct Piece {
  int kind;
  const void* src;
  int64_t n, add;
};

// the pieces of an exported array, and its length
struct Parts {
  std::vector<Piece> pieces;
  int64_t n = 0;

  void add(int kind, const void* src, int64_t n_, int64_t a = 0) {
    if (n_ <= 0) return;
    pieces.push_back({kind, src, n_, a});
    n += n_;
  }
  void vec(const std::vector<int64_t>& v) {
    add(P_COPY, v.data(), (int64_t)v.size());
  }
};

struct Runs {
  Parts ends, kinds, payloads, bit_offs, widths;
  int64_t total = 0;

  void add(const RunList& r, int64_t base_byte) {
    const int64_t n = (int64_t)r.kinds.size();
    ends.add(P_CUMSUM, r.counts.data(), n, total);
    kinds.add(P_WIDEN, r.kinds.data(), n);
    payloads.add(P_COPY, r.payloads.data(), n);
    bit_offs.add(P_BITS, r.offs.data(), n, base_byte);
    widths.add(P_FILL, nullptr, n, r.width);
    total += r.n;
  }
};

// the merged plan, until pq_plan_export writes it out: the chunk-level
// tables as pieces of the pages' own tables (no copy until the export)
struct ChunkPlan {
  std::vector<PageOut> pages;
  std::vector<Seg> levels, values, dense;
  int64_t levels_len = 0, values_len = 0, dense_len = 0;
  Runs def_runs, rep_runs, vruns;
  std::vector<int64_t> dense_pages;  // (first value, values) a page
  std::vector<int64_t> d_firsts, d_counts, d_vpms, d_mb_counts;
  Parts mb_offs, mb_widths, mb_mins;
  std::vector<int64_t> bss_pages;  // (base, values) a page
  Parts dba_plens, dba_soffs, dba_slens;
  std::vector<int64_t> hb_parts;  // (kind, pointer, bytes, values) a page
  Parts hb_lens, host_def;
  int kind = -1;
  int64_t total_slots = 0, total_values = 0, dense_w = -1, d_vpm = 32;
  bool expanded = false, dense_ok = true, has_host_def = false;
};

void add_seg(std::vector<Seg>& segs, int64_t& len, const uint8_t* p,
             int64_t n) {
  if (n > 0) {
    segs.push_back({(int64_t)(uintptr_t)p, n});
    len += n;
  }
}

// device_reader._add_dense_page: a dict page's bit-packed index runs
// compacted into the chunk's dense w-bit stream, pages padded to 32
// values
void add_dense_page(ChunkPlan& c, const PageOut& p) {
  const RunList& r = p.vruns;
  bool packed = !r.kinds.empty();
  for (uint8_t k : r.kinds) packed &= k == 1;
  if (!c.dense_ok || !packed) {
    c.dense_ok = false;
    return;
  }
  const int64_t w = p.dict_w;
  if (c.dense_w < 0) {
    c.dense_w = w;
  } else if (c.dense_w != w) {
    c.dense_ok = false;
    return;
  }
  const int64_t group_bytes = 4 * w;
  const int64_t pad = (group_bytes - c.dense_len % group_bytes) % group_bytes;
  if (pad) {
    c.dense.push_back({0, pad});  // zeros
    c.dense_len += pad;
  }
  c.dense_pages.push_back(c.dense_len * 8 / w);
  c.dense_pages.push_back(p.present);
  for (size_t k = 0; k < r.kinds.size(); ++k)
    add_seg(c.dense, c.dense_len, p.val + r.offs[k],
            (r.counts[k] + 7) / 8 * w);
}

void merge_page(ChunkPlan& c, const PageOut& p) {
  if (p.has_rep) {
    c.rep_runs.add(p.rep_runs, c.levels_len);
    add_seg(c.levels, c.levels_len, p.rep, p.rep_len);
  }
  if (p.has_def) {
    c.def_runs.add(p.def_runs, c.levels_len);
    add_seg(c.levels, c.levels_len, p.def, p.def_len);
  }
  if (p.has_host_def) {
    c.has_host_def = true;
    c.host_def.add(P_COPY32, p.host_def.data(), (int64_t)p.host_def.size());
  }
  const int64_t base = c.values_len;
  switch (p.kind) {
    case K_DICT:
      if (p.dict_w == 0) c.dense_ok = false;
      else add_dense_page(c, p);
      break;
    case K_DELTA: {
      const int64_t n = (int64_t)p.mb_offs.size();
      c.d_firsts.push_back(p.d_first);
      c.d_counts.push_back(p.d_count);
      c.d_vpms.push_back(p.d_vpm);
      c.d_mb_counts.push_back(n);
      c.mb_offs.add(P_COPY, p.mb_offs.data(), n, base * 8);
      c.mb_widths.vec(p.mb_widths);
      c.mb_mins.vec(p.mb_mins);
      c.d_vpm = p.d_vpm;
      break;
    }
    case K_BSS:
      c.bss_pages.push_back(base);
      c.bss_pages.push_back(p.bss_n);
      break;
    case K_DBA: {
      const int64_t n = (int64_t)p.plens.size();
      c.dba_plens.vec(p.plens);
      c.dba_soffs.add(P_EXCLUSIVE, p.slens.data(), n, base);
      c.dba_slens.vec(p.slens);
      break;
    }
    case K_HOST_BA:
      c.hb_parts.push_back(p.hb_kind);
      c.hb_parts.push_back((int64_t)(uintptr_t)p.hb);
      c.hb_parts.push_back(p.hb_len);
      c.hb_parts.push_back(p.hb_count);
      c.hb_lens.vec(p.hb_lens);
      break;
    default:
      break;
  }
  if (p.has_vruns) c.vruns.add(p.vruns, base);
  add_seg(c.values, c.values_len, p.val, p.val_len);
  c.total_slots += p.n;
  c.total_values += p.present;
  c.expanded |= p.expanded;
}

// the INFO_* slots of pq_chunk_plan's info array (ops/host.py's names)
enum { INFO_STATUS = 0, INFO_PAGE, INFO_CODE, INFO_A0, INFO_A1, INFO_A2,
       INFO_A3, INFO_KIND, INFO_SLOTS, INFO_VALUES, INFO_EXPANDED,
       INFO_DENSE_OK, INFO_DENSE_W, INFO_D_VPM, INFO_HOST_DEF,
       INFO_LEVELS_LEN, INFO_VALUES_LEN, INFO_DENSE_LEN, INFO_DEF_TOTAL,
       INFO_REP_TOTAL, INFO_V_TOTAL, INFO_SIZES };
constexpr int kArrays = 33;  // the arrays pq_plan_export writes, in order

// the exported arrays, in order (ops/host.py's PLAN_ARRAYS)
void plan_arrays(ChunkPlan& c, Parts* out) {
  int i = 0;
  const auto small = [&](const void* d, int64_t n) {
    out[i] = Parts();
    out[i++].add(P_COPY, d, n);
  };
  for (auto* s : {&c.levels, &c.values, &c.dense})
    small(s->data(), (int64_t)s->size() * 2);
  for (Runs* r : {&c.def_runs, &c.rep_runs, &c.vruns})
    for (Parts* p : {&r->ends, &r->kinds, &r->payloads, &r->bit_offs,
                     &r->widths})
      out[i++] = *p;
  small(c.dense_pages.data(), (int64_t)c.dense_pages.size());
  for (auto* v : {&c.d_firsts, &c.d_counts, &c.d_vpms, &c.d_mb_counts})
    small(v->data(), (int64_t)v->size());
  for (Parts* p : {&c.mb_offs, &c.mb_widths, &c.mb_mins}) out[i++] = *p;
  small(c.bss_pages.data(), (int64_t)c.bss_pages.size());
  for (Parts* p : {&c.dba_plens, &c.dba_soffs, &c.dba_slens}) out[i++] = *p;
  small(c.hb_parts.data(), (int64_t)c.hb_parts.size());
  out[i++] = c.hb_lens;
  out[i++] = c.host_def;
}

void write_piece(const Piece& p, void* dst) {
  const auto* s = (const int64_t*)p.src;
  auto* o = (int64_t*)dst;
  int64_t acc = p.add;
  switch (p.kind) {
    case P_COPY:
      if (!p.add) {
        std::memcpy(o, s, (size_t)p.n * 8);
        return;
      }
      for (int64_t i = 0; i < p.n; ++i) o[i] = s[i] + p.add;
      return;
    case P_BITS:
      for (int64_t i = 0; i < p.n; ++i) o[i] = (s[i] + p.add) * 8;
      return;
    case P_CUMSUM:
      for (int64_t i = 0; i < p.n; ++i) o[i] = acc += s[i];
      return;
    case P_EXCLUSIVE:
      for (int64_t i = 0; i < p.n; ++i) {
        o[i] = acc;
        acc += s[i];
      }
      return;
    case P_WIDEN:
      for (int64_t i = 0; i < p.n; ++i) o[i] = ((const uint8_t*)p.src)[i];
      return;
    case P_FILL:
      for (int64_t i = 0; i < p.n; ++i) o[i] = p.add;
      return;
    case P_COPY32:
      std::memcpy(dst, p.src, (size_t)p.n * 4);
      return;
  }
}

// pq_chunk_plan's walk and merge; throws only when an allocation fails
ChunkPlan* plan_chunk(const ChunkIn& in, int64_t n_pages, int64_t nthreads,
                      int64_t* info) {
  std::unique_ptr<ChunkPlan> c(new ChunkPlan());
  std::vector<PageOut>& pages = c->pages;
  pages.resize((size_t)n_pages);
  // pages dealt one at a time: pages differ in size
  std::atomic<int64_t> next{0};
  const auto worker = [&] {
    int64_t i;
    while ((i = next.fetch_add(1)) < n_pages) {
      PageOut& p = pages[i];
      try {
        plan_page(in, i, p);
      } catch (const std::exception&) {  // where the walk would run out
        fail(p, ST_MEMORY, 0, p.kind >= 0 ? AT_VALUES : AT_LEVELS);
      }
    }
  };
  run_workers(std::max<int64_t>(1, std::min(nthreads, n_pages)), worker);

  const auto stop = [&](int status, int64_t page, const PageOut* p) {
    info[INFO_STATUS] = status;
    info[INFO_PAGE] = page;
    if (p) {
      info[INFO_CODE] = p->code;
      info[INFO_A0] = p->a0;
      info[INFO_A1] = p->a1;
      info[INFO_A2] = p->a2;
      info[INFO_A3] = p->a3;
    }
    return nullptr;
  };
  // the walk decompresses every page before it looks at one, and leaves
  // a chunk with a shape outside this planner to the Python walk
  for (int64_t i = 0; i < n_pages; ++i)
    if (pages[i].decompress_failed) return stop(ST_DECOMPRESS, i, nullptr);
  for (int64_t i = 0; i < n_pages; ++i)
    if (pages[i].status == ST_OUTSIDE) return stop(ST_OUTSIDE, i, &pages[i]);

  for (int64_t i = 0; i < n_pages; ++i) {
    const PageOut& p = pages[i];
    if (!p.data) continue;
    if (p.status != ST_OK && p.at == AT_LEVELS) return stop(p.status, i, &p);
    if (p.kind >= 0) {
      if (c->kind < 0) {
        c->kind = p.kind;
      } else if (c->kind != p.kind) {
        PageOut mixed;
        mixed.code = U_MIXED_KINDS;
        mixed.a0 = c->kind;
        mixed.a1 = p.kind;
        return stop(ST_UNSUPPORTED, i, &mixed);
      }
    }
    if (p.status != ST_OK) return stop(p.status, i, &p);
    merge_page(*c, p);
  }
  if (!c->dense_ok) {  // the dense stream is only staged when whole
    c->dense.clear();
    c->dense_len = 0;
    c->dense_pages.clear();
    c->dense_w = -1;
  }
  info[INFO_KIND] = c->kind;
  info[INFO_SLOTS] = c->total_slots;
  info[INFO_VALUES] = c->total_values;
  info[INFO_EXPANDED] = c->expanded;
  info[INFO_DENSE_OK] = c->dense_ok;
  info[INFO_DENSE_W] = c->dense_w;
  info[INFO_D_VPM] = c->d_vpm;
  info[INFO_HOST_DEF] = c->has_host_def;
  info[INFO_LEVELS_LEN] = c->levels_len;
  info[INFO_VALUES_LEN] = c->values_len;
  info[INFO_DENSE_LEN] = c->dense_len;
  info[INFO_DEF_TOTAL] = c->def_runs.total;
  info[INFO_REP_TOTAL] = c->rep_runs.total;
  info[INFO_V_TOTAL] = c->vruns.total;
  Parts arrays[kArrays];
  plan_arrays(*c, arrays);
  for (int i = 0; i < kArrays; ++i) info[INFO_SIZES + i] = arrays[i].n;
  return c.release();
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Plan one chunk's pages.  rows: n_pages page-header rows (PG_* columns);
// srcs: per page S_NFIELDS columns, its payload (a v2 page's levels lie
// there), the body to decompress (v1: the payload; v2: what follows its
// levels), the codec (0: the body is used as it lies; 1 SNAPPY, 6 ZSTD),
// the decompressed size and its offset in `bodies` (bodies_cap bytes).
// Pages are walked on nthreads threads.  info (INFO_SIZES + kArrays
// slots) gets the status, the error's page (-1: none), code and
// arguments, the plan's scalars and the length of each array
// pq_plan_export writes.  Returns the plan (free it with pq_plan_export
// or pq_plan_free), or 0 when the status is not ST_OK.
// ---------------------------------------------------------------------------
void* pq_chunk_plan(const int64_t* rows, const int64_t* srcs, int64_t n_pages,
                    int64_t max_def, int64_t max_rep, int64_t physical,
                    int64_t type_length, uint8_t* bodies, int64_t bodies_cap,
                    int64_t nthreads, int64_t* info) {
  for (int i = 0; i < INFO_SIZES + kArrays; ++i) info[i] = 0;
  const ChunkIn in{rows, srcs, max_def, max_rep, physical, type_length,
                   bodies, bodies_cap};
  try {
    return plan_chunk(in, n_pages, nthreads, info);
  } catch (const std::exception&) {
    info[INFO_STATUS] = ST_MEMORY;
    info[INFO_PAGE] = -1;
    return nullptr;
  }
}

// Write a plan's arrays into outs[kArrays] (each at least the length
// pq_chunk_plan reported; 0 for an empty one) on nthreads threads, and
// free the plan.  Returns 0, or -1 when an allocation failed (nothing
// written then).
int64_t pq_plan_export(void* plan, const int64_t* outs, int64_t nthreads) {
  std::unique_ptr<ChunkPlan> c((ChunkPlan*)plan);
  struct Job {
    const Piece* piece;
    char* dst;
  };
  Parts arrays[kArrays];
  std::vector<Job> jobs;
  try {
    plan_arrays(*c, arrays);
    for (int a = 0; a < kArrays; ++a) {
      const int64_t elem = a == kArrays - 1 ? 4 : 8;  // host_def: int32
      char* dst = (char*)(uintptr_t)outs[a];
      for (const Piece& p : arrays[a].pieces) {
        jobs.push_back({&p, dst});
        dst += p.n * elem;
      }
    }
  } catch (const std::exception&) {
    return -1;
  }
  std::atomic<size_t> next{0};
  const auto worker = [&] {
    size_t j;
    while ((j = next.fetch_add(1)) < jobs.size())
      write_piece(*jobs[j].piece, jobs[j].dst);
  };
  run_workers(std::max<int64_t>(
      1, std::min<int64_t>(nthreads, (int64_t)jobs.size())), worker);
  return 0;
}

void pq_plan_free(void* plan) { delete (ChunkPlan*)plan; }

// ---------------------------------------------------------------------------
// The staging batch's fill: copies rows (dst offset, source pointer or 0
// for zeros, bytes) and gathers rows (dst offset, source pointer, source
// bytes, pointer to int64 starts, rows, bytes a row: each row the bytes
// from its start, a row past the source repeating its last byte) into
// dst, on nthreads threads that split the bytes evenly.  Returns 0, -1
// when an entry lies outside dst, or -2 when an allocation failed
// (nothing written then).
// ---------------------------------------------------------------------------
int64_t pq_fill_batch(uint8_t* dst, int64_t dst_len, const int64_t* copies,
                      int64_t n_copies, const int64_t* gathers,
                      int64_t n_gathers, int64_t nthreads) {
  // every entry as a span of the virtual concatenation of their outputs
  std::vector<int64_t> starts;
  try {
    starts.assign((size_t)(n_copies + n_gathers) + 1, 0);
  } catch (const std::exception&) {
    return -2;
  }
  for (int64_t e = 0; e < n_copies; ++e) {
    const int64_t* c = copies + 3 * e;
    if (c[0] < 0 || c[2] < 0 || c[0] > dst_len - c[2]) return -1;
    starts[e + 1] = starts[e] + c[2];
  }
  for (int64_t g = 0; g < n_gathers; ++g) {
    const int64_t* r = gathers + 6 * g;
    const int64_t bytes = r[4] * r[5];
    if (r[0] < 0 || r[4] < 0 || r[5] < 0 || r[0] > dst_len - bytes)
      return -1;
    starts[n_copies + g + 1] = starts[n_copies + g] + bytes;
  }
  const int64_t total = starts.back();
  const auto fill = [&](int64_t lo, int64_t hi) {  // bytes [lo, hi)
    int64_t e = std::upper_bound(starts.begin(), starts.end(), lo) -
                starts.begin() - 1;
    for (; e < n_copies + n_gathers && starts[e] < hi; ++e) {
      const int64_t a = std::max(lo, starts[e]) - starts[e];
      const int64_t b = std::min(hi, starts[e + 1]) - starts[e];
      if (b <= a) continue;
      if (e < n_copies) {
        const int64_t* c = copies + 3 * e;
        uint8_t* out = dst + c[0] + a;
        if (c[1]) std::memcpy(out, as_ptr(c[1]) + a, (size_t)(b - a));
        else std::memset(out, 0, (size_t)(b - a));
        continue;
      }
      const int64_t* r = gathers + 6 * (e - n_copies);
      const uint8_t* src = as_ptr(r[1]);
      const int64_t src_len = r[2], nb = r[5];
      const int64_t* rs = (const int64_t*)(uintptr_t)r[3];
      for (int64_t j = a / nb; j * nb < b; ++j) {
        const int64_t x0 = std::max(a, j * nb) - j * nb;
        const int64_t x1 = std::min(b, (j + 1) * nb) - j * nb;
        uint8_t* out = dst + r[0] + j * nb + x0;
        const int64_t s = rs[j] + x0, n = x1 - x0;
        const int64_t have = std::max<int64_t>(
            0, std::min(n, src_len - s));
        if (have) std::memcpy(out, src + s, (size_t)have);
        if (have < n)
          std::memset(out + have, src_len ? src[src_len - 1] : 0,
                      (size_t)(n - have));
      }
    }
  };
  // T even shares of the bytes, each taken by the next free thread
  const int64_t T = std::max<int64_t>(1, std::min<int64_t>(nthreads, 64));
  std::atomic<int64_t> next{0};
  run_workers(T, [&] {
    int64_t k;
    while ((k = next.fetch_add(1)) < T)
      fill(total * k / T, total * (k + 1) / T);
  });
  return 0;
}

// ---------------------------------------------------------------------------
// The host byte-array pages of a chunk to one (values, offsets) pair:
// parts rows (kind 0 PLAIN: length-prefixed values, kind 1
// DELTA_LENGTH_BYTE_ARRAY: the value bytes whose lengths follow in
// `lens`; pointer, bytes, values).  offsets_out holds every value + 1,
// values_out the bytes of every part.  Returns the value bytes, or
// -(part + 1) for the first truncated PLAIN part.
// ---------------------------------------------------------------------------
int64_t pq_byte_array_parts(const int64_t* parts, int64_t n_parts,
                            const int64_t* lens, int64_t* offsets_out,
                            uint8_t* values_out) {
  int64_t base = 0, oi = 0, li = 0;
  offsets_out[oi++] = 0;
  for (int64_t p = 0; p < n_parts; ++p) {
    const int64_t* r = parts + 4 * p;
    const uint8_t* src = as_ptr(r[1]);
    const int64_t len = r[2], count = r[3];
    if (r[0] == 1) {
      if (len) std::memcpy(values_out + base, src, (size_t)len);
      for (int64_t i = 0; i < count; ++i) {
        base += lens[li++];
        offsets_out[oi++] = base;
      }
      continue;
    }
    int64_t pos = 0;
    for (int64_t i = 0; i < count; ++i) {
      if (pos + 4 > len) return -(p + 1);
      uint32_t l;
      std::memcpy(&l, src + pos, 4);
      pos += 4;
      if ((int64_t)l > len - pos) return -(p + 1);
      std::memcpy(values_out + base, src + pos, l);
      base += l;
      pos += l;
      offsets_out[oi++] = base;
    }
  }
  return base;
}

// ---------------------------------------------------------------------------
// The byte-array gather of the scans' survivors: values `indices` of a
// (values, offsets) column.  With out_vals null, the sizing pass: checks
// every index against [0, n_offs - 1) and its offsets against the
// values, writes out_offs (n + 1) and returns the bytes to gather, or -1
// for an index out of range, -2 for offsets out of order or past the
// values.  With out_vals, copies each value's bytes to out_offs[i] on
// nthreads threads that split the indexes evenly, and returns the bytes.
// ---------------------------------------------------------------------------
int64_t pq_gather_ba(const uint8_t* values, int64_t n_values,
                     const int64_t* offs, int64_t n_offs,
                     const int64_t* indices, int64_t n, int64_t* out_offs,
                     uint8_t* out_vals, int64_t nthreads) {
  if (!out_vals) {
    int64_t total = 0;
    out_offs[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
      const int64_t d = indices[i];
      if (d < 0 || d >= n_offs - 1) return -1;
      const int64_t a = offs[d], b = offs[d + 1];
      if (a < 0 || b < a || b > n_values) return -2;
      total += b - a;
      out_offs[i + 1] = total;
    }
    return total;
  }
  const int64_t T = std::max<int64_t>(1, std::min<int64_t>(nthreads, 64));
  std::atomic<int64_t> next{0};
  run_workers(T, [&] {
    int64_t k;
    while ((k = next.fetch_add(1)) < T) {
      for (int64_t i = n * k / T; i < n * (k + 1) / T; ++i) {
        const int64_t d = indices[i];
        const int64_t len = out_offs[i + 1] - out_offs[i];
        if (len) std::memcpy(out_vals + out_offs[i], values + offs[d],
                             (size_t)len);
      }
    }
  });
  return out_offs[n];
}


// ---------------------------------------------------------------------------
// xxhash64 of byte arrays (pq_xxh64_batch): the hash Parquet's bloom filters
// take, XXH64 with seed 0 over each value's PLAIN bytes without their length
// prefix.  The JAX package's native shim has the same function; this is the
// port's own copy.  `offsets` must rise within `n_data`: -1 otherwise.
// ---------------------------------------------------------------------------

static inline uint64_t xxh_rotl(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

static const uint64_t XP1 = 11400714785074694791ULL;
static const uint64_t XP2 = 14029467366897019727ULL;
static const uint64_t XP3 = 1609587929392839161ULL;
static const uint64_t XP4 = 9650029242287828579ULL;
static const uint64_t XP5 = 2870177450012600261ULL;

static inline uint64_t xxh_round(uint64_t acc, uint64_t lane) {
  return xxh_rotl(acc + lane * XP2, 31) * XP1;
}

static uint64_t xxh64(const uint8_t* p, int64_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = XP1 + XP2, v2 = XP2, v3 = 0, v4 = 0 - XP1;
    do {
      uint64_t k[4];
      std::memcpy(k, p, 32);
      v1 = xxh_round(v1, k[0]);
      v2 = xxh_round(v2, k[1]);
      v3 = xxh_round(v3, k[2]);
      v4 = xxh_round(v4, k[3]);
      p += 32;
    } while (p + 32 <= end);
    h = xxh_rotl(v1, 1) + xxh_rotl(v2, 7) + xxh_rotl(v3, 12) +
        xxh_rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ xxh_round(0, v)) * XP1 + XP4;
  } else {
    h = XP5;
  }
  h += (uint64_t)len;
  for (; p + 8 <= end; p += 8) {  // 8-byte lanes of the tail
    uint64_t k;
    std::memcpy(&k, p, 8);
    h = xxh_rotl(h ^ xxh_round(0, k), 27) * XP1 + XP4;
  }
  if (p + 4 <= end) {  // one 4-byte lane
    uint32_t k;
    std::memcpy(&k, p, 4);
    h = xxh_rotl(h ^ ((uint64_t)k * XP1), 23) * XP2 + XP3;
    p += 4;
  }
  for (; p < end; ++p) h = xxh_rotl(h ^ ((uint64_t)*p * XP5), 11) * XP1;
  h ^= h >> 33;
  h *= XP2;
  h ^= h >> 29;
  h *= XP3;
  h ^= h >> 32;
  return h;
}

int64_t pq_xxh64_batch(const uint8_t* data, int64_t n_data,
                       const int64_t* offsets, int64_t n, uint64_t* out) {
  if (n < 0) return -1;
  for (int64_t i = 0; i < n; ++i)
    if (offsets[i] < 0 || offsets[i] > offsets[i + 1] ||
        offsets[i + 1] > n_data)
      return -1;
  for (int64_t i = 0; i < n; ++i)
    out[i] = xxh64(data + offsets[i], offsets[i + 1] - offsets[i]);
  return 0;
}

}  // extern "C"
