// Host-side C++ of the port: the Snappy raw format both ways, the
// RLE/bit-packed hybrid encoder and the byte-array scans of the read and
// write paths.
//
// Built with the system C++ compiler into a shared library with a plain C
// interface (ops/_build.py), loaded with ctypes.  The port's own copy of
// what it needs from the JAX package's native shim
// (its native.cpp): the Snappy decoder
// `snappy_fast_uncompress`, the batched PLAIN BYTE_ARRAY scan
// `pq_plain_ba_batch` and the byte-array min/max `pq_minmax_ba`; beside
// them a greedy Snappy encoder (the public format: one hash table per
// 64 KiB block, literal, copy-1 and copy-2 tags), the PLAIN BYTE_ARRAY
// encoder, the hybrid encoder of the writer's levels and dictionary
// indexes (ops/ref.py's algorithm), first-seen dictionary building of
// byte arrays and of fixed-width values (as int64 keys), and the common
// prefixes of front coding.
//
// Every function checks its bounds itself: a malformed stream returns an
// error code, never reads or writes outside the buffers it was given.

#include <cstdint>
#include <cstring>
#include <vector>

#include "snappy_decode.h"

namespace {

// ---------------------------------------------------------------------------
// Snappy encode: greedy matching, one 2^14-entry hash table per block
// ---------------------------------------------------------------------------

constexpr int64_t kBlock = 1 << 16;  // copy offsets stay below 65,536
constexpr int kHashBits = 14;

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

inline uint32_t hash32(uint32_t v) {
  return (v * 0x1E35A7BDu) >> (32 - kHashBits);
}

uint8_t* emit_literal(uint8_t* op, const uint8_t* lit, int64_t len) {
  const int64_t n = len - 1;
  if (n < 60) {
    *op++ = (uint8_t)(n << 2);
  } else {
    int nb = n < (1 << 8) ? 1 : n < (1 << 16) ? 2 : n < (1 << 24) ? 3 : 4;
    *op++ = (uint8_t)((59 + nb) << 2);
    uint32_t v = (uint32_t)n;
    memcpy(op, &v, (size_t)nb);  // little-endian length, nb bytes
    op += nb;
  }
  memcpy(op, lit, (size_t)len);
  return op + len;
}

uint8_t* emit_copy_upto64(uint8_t* op, int64_t off, int64_t len) {
  if (len >= 4 && len <= 11 && off < 2048) {
    *op++ = (uint8_t)(1 | ((len - 4) << 2) | ((off >> 8) << 5));
    *op++ = (uint8_t)(off & 0xFF);
  } else {
    *op++ = (uint8_t)(2 | ((len - 1) << 2));
    *op++ = (uint8_t)(off & 0xFF);
    *op++ = (uint8_t)(off >> 8);
  }
  return op;
}

uint8_t* emit_copy(uint8_t* op, int64_t off, int64_t len) {
  while (len >= 68) {  // keep the remainder >= 4 for a copy-1 tag
    op = emit_copy_upto64(op, off, 64);
    len -= 64;
  }
  if (len > 64) {
    op = emit_copy_upto64(op, off, 60);
    len -= 60;
  }
  return emit_copy_upto64(op, off, len);
}

uint8_t* compress_block(const uint8_t* base, int64_t n, uint8_t* op,
                        uint16_t* table) {
  const uint8_t* ip = base;
  const uint8_t* end = base + n;
  const uint8_t* anchor = base;
  if (n >= 15) {
    memset(table, 0, sizeof(uint16_t) << kHashBits);
    const uint8_t* limit = end - 4;  // the last position a load32 may read
    uint32_t skip = 32;
    while (ip <= limit) {
      const uint32_t cur = load32(ip);
      const uint32_t h = hash32(cur);
      const uint8_t* cand = base + table[h];
      table[h] = (uint16_t)(ip - base);
      if (cand < ip && load32(cand) == cur) {
        if (ip > anchor) op = emit_literal(op, anchor, ip - anchor);
        int64_t len = 4;
        while (ip + len < end && cand[len] == ip[len]) ++len;
        op = emit_copy(op, ip - cand, len);
        ip += len;
        anchor = ip;
        skip = 32;
      } else {
        ip += skip++ >> 5;  // strides grow through incompressible input
      }
    }
  }
  if (end > anchor) op = emit_literal(op, anchor, end - anchor);
  return op;
}

uint8_t* put_uvarint(uint8_t* op, uint64_t v) {
  while (v >= 0x80) {
    *op++ = (uint8_t)(v | 0x80);
    v >>= 7;
  }
  *op++ = (uint8_t)v;
  return op;
}

// One bit-packed run of values [0, cnt), zero-padded to whole groups of 8.
uint8_t* put_packed(uint8_t* op, const int64_t* v, int64_t cnt, int w) {
  if (cnt == 0) return op;
  const int64_t ngroups = (cnt + 7) / 8;
  op = put_uvarint(op, ((uint64_t)ngroups << 1) | 1);
  const uint64_t mask = w >= 64 ? ~0ull : (1ull << w) - 1;
  const int64_t nbytes = ngroups * w;
  memset(op, 0, (size_t)nbytes);
  for (int64_t i = 0; i < cnt; ++i) {
    const uint64_t x = (uint64_t)v[i] & mask;
    int64_t bit = i * w;
    for (int b = 0; b < w;) {  // up to 8 bits a step, byte by byte
      const int64_t byte = bit >> 3;
      const int sh = (int)(bit & 7);
      const int take = 8 - sh < w - b ? 8 - sh : w - b;
      op[byte] |= (uint8_t)(((x >> b) & ((1u << take) - 1)) << sh);
      b += take;
      bit += take;
    }
  }
  return op + nbytes;
}

}  // namespace

extern "C" {

// The RLE/bit-packed hybrid of n values at bit_width bits (no length
// prefix), exactly as ops/ref.py's encode_rle builds it: runs of at least
// max(min_repeat, 8) equal values become RLE runs after giving their first
// values to the packed span before them, so that every packed span but the
// last holds whole groups of 8.  out holds n * (bit_width + 24) / 8 + 64
// bytes; returns the bytes written.
int64_t pq_encode_rle(const int64_t* v, int64_t n, int bit_width,
                      int64_t min_repeat, uint8_t* out) {
  uint8_t* op = out;
  if (n == 0 || bit_width == 0) return 0;
  const int vbytes = (bit_width + 7) / 8;
  const int64_t thresh = min_repeat > 8 ? min_repeat : 8;
  int64_t pos = 0;
  int64_t s = 0;
  while (s < n) {
    int64_t e = s + 1;
    while (e < n && v[e] == v[s]) ++e;
    const int64_t length = e - s;
    if (length >= thresh) {
      const int64_t pad = ((pos - s) % 8 + 8) % 8;
      if (length - pad >= min_repeat) {
        op = put_packed(op, v + pos, s + pad - pos, bit_width);
        op = put_uvarint(op, (uint64_t)(length - pad) << 1);
        const uint64_t x = (uint64_t)v[s];
        for (int b = 0; b < vbytes; ++b) *op++ = (uint8_t)(x >> (8 * b));
        pos = e;
      }
    }
    s = e;
  }
  op = put_packed(op, v + pos, n - pos, bit_width);
  return op - out;
}

int64_t pq_snappy_max_compressed_length(int64_t n) { return 32 + n + n / 6; }

// Returns the compressed length written to dst (capacity
// pq_snappy_max_compressed_length(n)).
int64_t pq_snappy_compress(const uint8_t* src, int64_t n, uint8_t* dst) {
  uint8_t* op = put_uvarint(dst, (uint64_t)n);
  std::vector<uint16_t> table((size_t)1 << kHashBits);
  for (int64_t b = 0; b < n; b += kBlock) {
    const int64_t len = n - b < kBlock ? n - b : kBlock;
    op = compress_block(src + b, len, op, table.data());
  }
  return op - dst;
}

int pq_snappy_uncompress(const uint8_t* src, int64_t src_len, uint8_t* dst,
                         int64_t dst_len) {
  return pq::snappy_uncompress(src, src_len, dst, dst_len);
}

// ---------------------------------------------------------------------------
// PLAIN BYTE_ARRAY: many pages' 4-byte-length-prefixed values to one
// (values, offsets) pair.  offsets_out holds sum(counts) + 1 entries,
// values_out at least sum(src_lens) bytes.  Returns the value bytes
// written, or -(page + 1) for the first truncated page.
// ---------------------------------------------------------------------------
int64_t pq_plain_ba_batch(const int64_t* src_ptrs, const int64_t* src_lens,
                          const int64_t* counts, int64_t n_pages,
                          int64_t* offsets_out, uint8_t* values_out) {
  int64_t base = 0;
  int64_t oi = 0;
  offsets_out[oi++] = 0;
  for (int64_t p = 0; p < n_pages; ++p) {
    const uint8_t* src = (const uint8_t*)(uintptr_t)src_ptrs[p];
    const int64_t len = src_lens[p];
    int64_t pos = 0;
    for (int64_t i = 0; i < counts[p]; ++i) {
      if (pos + 4 > len) return -(p + 1);
      uint32_t l;
      memcpy(&l, src + pos, 4);
      pos += 4;
      if ((int64_t)l > len - pos) return -(p + 1);
      memcpy(values_out + base, src + pos, l);
      base += l;
      pos += l;
      offsets_out[oi++] = base;
    }
  }
  return base;
}

// The inverse: n values (data, offsets[n + 1]) to length-prefixed PLAIN
// bytes; out holds offsets[n] - offsets[0] + 4 n bytes.
void pq_encode_plain_ba(const uint8_t* data, const int64_t* offsets,
                        int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t l = (uint32_t)(offsets[i + 1] - offsets[i]);
    memcpy(out, &l, 4);
    memcpy(out + 4, data + offsets[i], l);
    out += 4 + l;
  }
}

// Unsigned lexicographic min and max of values [v0, v1) (the BYTE_ARRAY
// and FIXED_LEN_BYTE_ARRAY order): writes the indexes of the first
// minimum and the first maximum.
void pq_minmax_ba(const uint8_t* data, const int64_t* offsets, int64_t v0,
                  int64_t v1, int64_t* out_min, int64_t* out_max) {
  int64_t mi = v0, ma = v0;
  for (int64_t i = v0 + 1; i < v1; i++) {
    const uint8_t* a = data + offsets[i];
    const int64_t alen = offsets[i + 1] - offsets[i];
    const int64_t mlen = offsets[mi + 1] - offsets[mi];
    int cmp = memcmp(a, data + offsets[mi], alen < mlen ? alen : mlen);
    if (cmp < 0 || (cmp == 0 && alen < mlen)) mi = i;
    const int64_t xlen = offsets[ma + 1] - offsets[ma];
    cmp = memcmp(a, data + offsets[ma], alen < xlen ? alen : xlen);
    if (cmp > 0 || (cmp == 0 && alen > xlen)) ma = i;
  }
  *out_min = mi;
  *out_max = ma;
}

// First-seen dictionary of n byte strings: indices[i] is the id of value
// i, first_rows[id] the row of its first occurrence.  Returns the number
// of distinct values, or -1 once it would exceed max_unique.
int64_t pq_dict_build_ba(const uint8_t* data, const int64_t* offsets,
                         int64_t n, int64_t max_unique, int64_t* indices,
                         int64_t* first_rows) {
  int64_t cap = 16;
  while (cap < 2 * (max_unique < n ? max_unique : n) + 2) cap <<= 1;
  std::vector<int64_t> slots((size_t)cap, -1);
  std::vector<uint64_t> hashes;
  int64_t n_unique = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = data + offsets[i];
    const int64_t len = offsets[i + 1] - offsets[i];
    uint64_t h = 1469598103934665603ull ^ (uint64_t)len;  // FNV-1a
    for (int64_t k = 0; k < len; ++k) h = (h ^ p[k]) * 1099511628211ull;
    h ^= h >> 31;
    int64_t s = (int64_t)(h & (uint64_t)(cap - 1));
    while (true) {
      const int64_t id = slots[(size_t)s];
      if (id < 0) {
        if (n_unique == max_unique) return -1;
        slots[(size_t)s] = n_unique;
        hashes.push_back(h);
        first_rows[n_unique] = i;
        indices[i] = n_unique++;
        break;
      }
      const int64_t r = first_rows[id];
      if (hashes[(size_t)id] == h && offsets[r + 1] - offsets[r] == len &&
          memcmp(data + offsets[r], p, (size_t)len) == 0) {
        indices[i] = id;
        break;
      }
      s = (s + 1) & (cap - 1);
    }
  }
  return n_unique;
}

// First-seen dictionary of n int64 keys (a fixed-width column's bit
// patterns): indices[i] is the id of key i, uniques[id] the key.  The
// table starts small and doubles at half load, so a long column of few
// values never allocates for max_unique.  Returns the number of distinct
// keys, or -1 once it would exceed max_unique.
int64_t pq_dict_build_i64(const int64_t* keys, int64_t n, int64_t max_unique,
                          int64_t* indices, int64_t* uniques) {
  int64_t cap = 256;
  std::vector<int64_t> slots((size_t)cap, -1);
  const auto slot_of = [&](int64_t v) {
    uint64_t h = (uint64_t)v * 0x9E3779B97F4A7C15ull;  // Fibonacci hash
    h ^= h >> 29;
    return (int64_t)(h & (uint64_t)(cap - 1));
  };
  int64_t n_unique = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t v = keys[i];
    int64_t s = slot_of(v);
    while (true) {
      const int64_t id = slots[(size_t)s];
      if (id < 0) {
        if (n_unique == max_unique) return -1;
        if (2 * (n_unique + 1) > cap) {  // rehash the ids into a larger table
          cap <<= 1;
          slots.assign((size_t)cap, -1);
          for (int64_t u = 0; u < n_unique; ++u) {
            int64_t t = slot_of(uniques[u]);
            while (slots[(size_t)t] >= 0) t = (t + 1) & (cap - 1);
            slots[(size_t)t] = u;
          }
          s = slot_of(v);
          continue;
        }
        slots[(size_t)s] = n_unique;
        uniques[n_unique] = v;
        indices[i] = n_unique++;
        break;
      }
      if (uniques[id] == v) {
        indices[i] = id;
        break;
      }
      s = (s + 1) & (cap - 1);
    }
  }
  return n_unique;
}

// Front coding: out[i] is the length of the prefix value i shares with
// value i - 1 (0 for the first value).
void pq_common_prefix_lens(const uint8_t* data, const int64_t* offsets,
                           int64_t n, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    if (i == 0) {
      out[0] = 0;
      continue;
    }
    const uint8_t* a = data + offsets[i - 1];
    const uint8_t* b = data + offsets[i];
    const int64_t la = offsets[i] - offsets[i - 1];
    const int64_t lb = offsets[i + 1] - offsets[i];
    const int64_t m = la < lb ? la : lb;
    int64_t k = 0;
    while (k < m && a[k] == b[k]) ++k;
    out[i] = k;
  }
}

}  // extern "C"
