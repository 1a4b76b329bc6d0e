// The host prescan of the read path: the page-header table of a chunk,
// the batched decompression of its data pages, the run tables of its
// RLE/bit-packed hybrid streams (levels, dictionary indexes, RLE booleans)
// and the present count over them, the miniblock tables of its
// DELTA_BINARY_PACKED streams, and the decode of the delta length streams
// of DELTA_LENGTH_BYTE_ARRAY and DELTA_BYTE_ARRAY pages.
//
// Built with the system C++ compiler into a shared library with a plain C
// interface (ops/_build.py), loaded with ctypes; ops/host.py wraps each
// entry point with the return shape of the Python version it replaces
// (ops/ref.py, ops/device.py, io/reader.py's thrift walk).  The port's own
// copy of what the JAX package's native shim does in `pq_scan_rle_runs`,
// `pq_count_target_in_runs`, `pq_delta_prescan`, `pq_delta_decode`,
// `pq_scan_page_headers` and `pq_decompress_pages`
// (its native.cpp), with its own C ABI.
//
// Every function checks its bounds itself.  A malformed stream returns a
// negative error code (PQ_E_* below), which the Python wrapper turns into
// the CorruptedError of the Python version; nothing reads or writes outside
// the buffers it was given.

#include <dlfcn.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
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
  if (bit_width < 0 || bit_width > 64) return PQ_E_WIDTH;
  const int64_t vbytes = (bit_width + 7) / 8;
  const uint64_t mask =
      bit_width >= 64 ? ~0ull : (((uint64_t)1 << bit_width) - 1);
  int64_t pos = 0, remaining = n, k = 0;
  while (remaining > 0) {
    uint64_t header;
    if (!uvarint(data, size, pos, header)) return PQ_E_TRUNCATED;
    const uint64_t count = header >> 1;
    if (count == 0) return PQ_E_ZERO_RUN;
    if (k >= n) return PQ_E_CAPACITY;
    if (header & 1) {
      // count groups of 8 values, bit_width bytes each
      if (bit_width && count > (uint64_t)(size - pos) / bit_width)
        return PQ_E_TRUNCATED;
      kinds[k] = 1;
      payloads[k] = 0;
      offsets[k] = pos;
      pos += (int64_t)count * bit_width;
      const uint64_t values = count > (uint64_t)remaining / 8 + 1
                                  ? (uint64_t)remaining + 8
                                  : count * 8;
      counts[k] = values < (uint64_t)remaining ? (int64_t)values : remaining;
      remaining -= counts[k];
    } else {
      if (vbytes > size - pos) return PQ_E_TRUNCATED;
      uint64_t value = 0;
      for (int64_t j = 0; j < vbytes; ++j)
        value |= (uint64_t)data[pos + j] << (8 * j);
      pos += vbytes;
      kinds[k] = 0;
      payloads[k] = (int64_t)(value & mask);
      offsets[k] = pos;
      counts[k] = count < (uint64_t)remaining ? (int64_t)count : remaining;
      remaining -= counts[k];
    }
    ++k;
  }
  end_pos[0] = pos;
  return k;
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
  int64_t got = 1, k = 0;
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
      if (k >= cap) return PQ_E_CAPACITY;
      const int64_t take = std::min<int64_t>(vpm, (int64_t)total - got);
      if (take * w > (size - pos) * 8) return PQ_E_TRUNCATED;
      offsets[k] = pos * 8;
      widths[k] = (int32_t)w;
      mins[k] = min_delta;
      pos += vpm * w / 8;
      got += take;
      ++k;
    }
  }
  header_out[3] = pos;
  return k;
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
// threads (pages dealt round-robin).  codec: 0 UNCOMPRESSED, 1 SNAPPY (the
// port's decoder), 6 ZSTD (dlopen).  Returns 0, or -(i + 1) for the
// lowest-numbered page that failed.
// ---------------------------------------------------------------------------
int64_t pq_decompress_pages(const int64_t* src_ptrs, const int64_t* src_lens,
                            int64_t n_pages, int64_t codec, uint8_t* out,
                            const int64_t* out_offs, int64_t nthreads) {
  std::atomic<int64_t> first_bad{n_pages};
  const auto run = [&](int64_t t, int64_t T) {
    for (int64_t i = t; i < n_pages; i += T) {
      const auto* src = (const uint8_t*)(uintptr_t)src_ptrs[i];
      if (!page_decompress((int)codec, src, src_lens[i], out + out_offs[i],
                           out_offs[i + 1] - out_offs[i])) {
        int64_t cur = first_bad.load();
        while (i < cur && !first_bad.compare_exchange_weak(cur, i)) {
        }
        return;
      }
    }
  };
  const int64_t T = std::max<int64_t>(1, std::min(nthreads, n_pages));
  std::vector<std::thread> threads;
  for (int64_t t = 1; t < T; ++t) threads.emplace_back(run, t, T);
  run(0, T);
  for (auto& th : threads) th.join();
  const int64_t bad = first_bad.load();
  return bad < n_pages ? -(bad + 1) : 0;
}

}  // extern "C"
