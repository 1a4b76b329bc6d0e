// The batched lookup's row-group work on the host: the match of every key
// against the rows of a row group's fetched pages (pq_lookup_match), and the
// gather of the output columns' values at the matched rows across those
// pages (pq_lookup_gather for fixed-width values, pq_lookup_gather_ba for
// byte arrays).  io/lookup.py calls them once a row group and column, so a
// batch of keys costs no Python work a key or a candidate row; ctypes
// releases the GIL for each call, so the key shards of one lookup run them
// side by side on the pool's workers.
//
// Built with the system C++ compiler into a shared library with a plain C
// interface (ops/_build.py), loaded with ctypes; ops/host.py wraps each
// entry point, and its numpy twins (host.lookup_match_numpy,
// host.lookup_gather_numpy) are the tests' oracles.
//
// Every function checks the indexes it follows (a row's page, a page's row,
// a byte row's offsets) against the sizes it was given, and returns a
// negative code instead of reading outside a buffer.  No C++ exception
// leaves an entry point: a failed allocation is PQ_E_NOMEM.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <new>
#include <utility>
#include <vector>

namespace {

enum {
  PQ_E_RANGE = -1,  // an index outside the table it indexes
  PQ_E_BYTES = -2,  // byte-array offsets out of order or past the data
  PQ_E_KIND = -3,   // an unknown key kind
  PQ_E_NOMEM = -6,  // an allocation failed
};

// the key domains of pq_lookup_match: 8-byte keys compared as
enum { K_I64 = 0, K_U64 = 1, K_F64 = 2, K_HASH = 3 };

// the bytes of row `local` of page `p`: a byte-array page (offsets given)
// or fixed-width rows of `width` bytes; false when they leave the page
inline bool row_bytes(const int64_t* page_data, const int64_t* page_offs,
                      const int64_t* page_width, const int64_t* page_nbytes,
                      int64_t p, int64_t local, const uint8_t** at,
                      int64_t* len) {
  const uint8_t* data = reinterpret_cast<const uint8_t*>(page_data[p]);
  int64_t a, b;
  if (page_offs[p]) {
    const int64_t* offs = reinterpret_cast<const int64_t*>(page_offs[p]);
    a = offs[local];
    b = offs[local + 1];
  } else {
    a = local * page_width[p];
    b = a + page_width[p];
  }
  if (a < 0 || b < a || b > page_nbytes[p]) return false;
  *at = data + a;
  *len = b - a;
  return true;
}

template <typename T>
int64_t match(const T* keys, int64_t n_rows, const int64_t* row_page,
              const int64_t* row_local, const int64_t* page_first,
              const int64_t* page_rows, int64_t n_pages, const T* needles,
              const int64_t* needle_ids, int64_t n_needles,
              const int64_t* run_lo, const int64_t* run_hi,
              const int64_t* list_offs, const int64_t* list_pages,
              int64_t n_list, bool hashed, const int64_t* page_data,
              const int64_t* page_offs, const int64_t* page_width,
              const int64_t* page_nbytes, const uint8_t* key_bytes,
              const int64_t* key_offs, int64_t n_key_ids,
              int64_t n_key_bytes, int64_t* out_offs, int64_t* out_rows,
              int64_t cap) {
  for (int64_t i = 0; i < n_rows; ++i) {
    const int64_t p = row_page[i];
    if (p < 0 || p >= n_pages || row_local[i] < 0 ||
        row_local[i] >= page_rows[p])
      return PQ_E_RANGE;
  }
  // the table: (key, row index) ascending; NaN rows equal nothing
  std::vector<std::pair<T, int64_t>> table;
  table.reserve((size_t)n_rows);
  for (int64_t i = 0; i < n_rows; ++i) {
    if (keys[i] != keys[i]) continue;
    table.emplace_back(keys[i], i);
  }
  std::sort(table.begin(), table.end());
  auto key_lt = [](const std::pair<T, int64_t>& e, T v) { return e.first < v; };
  auto val_lt = [](T v, const std::pair<T, int64_t>& e) { return v < e.first; };
  int64_t total = 0;
  out_offs[0] = 0;
  for (int64_t k = 0; k < n_needles; ++k) {
    const T v = needles[k];
    int64_t lp = 0, hp = 0;  // the needle's explicit page list, if any
    if (list_offs) {
      lp = list_offs[k];
      hp = list_offs[k + 1];
      if (lp < 0 || hp < lp || hp > n_list) return PQ_E_RANGE;
    }
    const uint8_t* nb = nullptr;
    int64_t nlen = 0;
    if (hashed) {
      const int64_t id = needle_ids[k];
      if (id < 0 || id >= n_key_ids) return PQ_E_RANGE;
      const int64_t a = key_offs[id], b = key_offs[id + 1];
      if (a < 0 || b < a || b > n_key_bytes) return PQ_E_BYTES;
      nb = key_bytes + a;
      nlen = b - a;
    }
    if (v == v) {
      auto lo = std::lower_bound(table.begin(), table.end(), v, key_lt);
      auto hi = std::upper_bound(lo, table.end(), v, val_lt);
      for (auto it = lo; it != hi; ++it) {
        const int64_t i = it->second;
        const int64_t p = row_page[i];
        if (p < run_lo[k] || p >= run_hi[k]) continue;
        if (hp > lp &&
            !std::binary_search(list_pages + lp, list_pages + hp, p))
          continue;
        if (hashed) {
          const uint8_t* rb;
          int64_t rlen;
          if (!row_bytes(page_data, page_offs, page_width, page_nbytes, p,
                         row_local[i], &rb, &rlen))
            return PQ_E_BYTES;
          if (rlen != nlen || (nlen && std::memcmp(rb, nb, (size_t)nlen)))
            continue;
        }
        if (total < cap) out_rows[total] = page_first[p] + row_local[i];
        ++total;
      }
    }
    out_offs[k + 1] = total;
  }
  return total;
}

// the page of row-group row `row`: the last page whose first row is at most
// `row`, if the row lies inside it; -1 otherwise
inline int64_t page_of(const int64_t* page_first, const int64_t* page_rows,
                       int64_t n_pages, int64_t row) {
  const int64_t* at =
      std::upper_bound(page_first, page_first + n_pages, row) - 1;
  if (at < page_first) return -1;
  const int64_t p = at - page_first;
  return row - page_first[p] < page_rows[p] ? p : -1;
}

}  // namespace

extern "C" {

// Every row of a row group's fetched pages whose key equals each needle.
//
// The rows: n_rows present rows, each with an 8-byte key (`kind`: int64,
// uint64, float64, or the xxh64 of its bytes), its page ordinal
// (`row_page`, < n_pages) and its row within the page (`row_local`);
// `page_first[p]` and `page_rows[p]` are page p's first row in the row
// group and its row count.  The rows are sorted here, by key and then by
// position, so rows given in ascending page and row order come out
// ascending.  A NaN row equals nothing.
//
// The needles: n_needles keys of the same kind, each with the pages its
// bounds allow: the run [run_lo, run_hi), and where `list_offs` is given
// and the needle's list [list_offs[k], list_offs[k + 1]) of `list_pages`
// is not empty, only the pages of that ascending list.  A NaN needle
// matches nothing.  With kind K_HASH a candidate's bytes must equal the
// needle's: needle k's bytes are key `needle_ids[k]` of the (key_bytes,
// key_offs) table, a row's are row `row_local` of page p (byte-array
// offsets at page_offs[p], else rows of page_width[p] bytes, inside
// page_nbytes[p] bytes at page_data[p]).
//
// Out: out_offs[k]..out_offs[k + 1] are needle k's rows (row-group rows,
// ascending) in out_rows.  Returns the total; where it passes `cap` only
// the offsets are complete, and the caller calls again with room.
int64_t pq_lookup_match(int kind, const void* keys, int64_t n_rows,
                        const int64_t* row_page, const int64_t* row_local,
                        const int64_t* page_first, const int64_t* page_rows,
                        int64_t n_pages, const void* needles,
                        const int64_t* needle_ids, int64_t n_needles,
                        const int64_t* run_lo, const int64_t* run_hi,
                        const int64_t* list_offs, const int64_t* list_pages,
                        int64_t n_list, const int64_t* page_data,
                        const int64_t* page_offs, const int64_t* page_width,
                        const int64_t* page_nbytes, const uint8_t* key_bytes,
                        const int64_t* key_offs, int64_t n_key_ids,
                        int64_t n_key_bytes, int64_t* out_offs,
                        int64_t* out_rows, int64_t cap) {
  try {
    switch (kind) {
      case K_I64:
        return match(static_cast<const int64_t*>(keys), n_rows, row_page,
                     row_local, page_first, page_rows, n_pages,
                     static_cast<const int64_t*>(needles), needle_ids,
                     n_needles, run_lo, run_hi, list_offs, list_pages,
                     n_list, false, page_data, page_offs, page_width,
                     page_nbytes, key_bytes, key_offs, n_key_ids,
                     n_key_bytes, out_offs, out_rows, cap);
      case K_U64:
      case K_HASH:
        return match(static_cast<const uint64_t*>(keys), n_rows, row_page,
                     row_local, page_first, page_rows, n_pages,
                     static_cast<const uint64_t*>(needles), needle_ids,
                     n_needles, run_lo, run_hi, list_offs, list_pages,
                     n_list, kind == K_HASH, page_data, page_offs,
                     page_width, page_nbytes, key_bytes, key_offs,
                     n_key_ids, n_key_bytes, out_offs, out_rows, cap);
      case K_F64:
        return match(static_cast<const double*>(keys), n_rows, row_page,
                     row_local, page_first, page_rows, n_pages,
                     static_cast<const double*>(needles), needle_ids,
                     n_needles, run_lo, run_hi, list_offs, list_pages,
                     n_list, false, page_data, page_offs, page_width,
                     page_nbytes, key_bytes, key_offs, n_key_ids,
                     n_key_bytes, out_offs, out_rows, cap);
      default:
        return PQ_E_KIND;
    }
  } catch (const std::bad_alloc&) {
    return PQ_E_NOMEM;
  }
}

// Fixed-width values at row-group rows `rows` across pages sorted by first
// row: page p holds page_rows[p] rows of `elem` bytes at page_vals[p], and
// a validity byte a row at page_valid[p] (0: no validity, every row
// valid).  Out: n values in out_vals, each row's validity in out_valid,
// and in out_row_valid whether its page carried a validity.  Returns 0, or
// PQ_E_RANGE for a row that lies on no page.
int64_t pq_lookup_gather(const int64_t* page_first, const int64_t* page_rows,
                         const int64_t* page_vals, const int64_t* page_valid,
                         int64_t n_pages, int64_t elem, const int64_t* rows,
                         int64_t n, uint8_t* out_vals, uint8_t* out_valid,
                         uint8_t* out_row_valid) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t p = page_of(page_first, page_rows, n_pages, rows[i]);
    if (p < 0) return PQ_E_RANGE;
    const int64_t local = rows[i] - page_first[p];
    std::memcpy(out_vals + i * elem,
                reinterpret_cast<const uint8_t*>(page_vals[p]) + local * elem,
                (size_t)elem);
    const uint8_t* valid = reinterpret_cast<const uint8_t*>(page_valid[p]);
    out_valid[i] = valid ? valid[local] : 1;
    out_row_valid[i] = valid ? 1 : 0;
  }
  return 0;
}

// Byte-array values at row-group rows `rows` across pages sorted by first
// row: page p's rows are its (page_data, page_offs) pair, page_offs[p]
// holding page_rows[p] + 1 offsets into page_nbytes[p] bytes, a null row
// empty.  With out_data NULL a sizing pass: out_offs (n + 1) and the total
// bytes; then the copy, with the validity as in pq_lookup_gather.  Returns
// the total, PQ_E_RANGE for a row on no page, PQ_E_BYTES for offsets out
// of order or past the data.
int64_t pq_lookup_gather_ba(const int64_t* page_first,
                            const int64_t* page_rows,
                            const int64_t* page_data,
                            const int64_t* page_offs,
                            const int64_t* page_valid,
                            const int64_t* page_nbytes, int64_t n_pages,
                            const int64_t* rows, int64_t n,
                            int64_t* out_offs, uint8_t* out_data,
                            uint8_t* out_valid, uint8_t* out_row_valid) {
  if (!out_data) {
    int64_t total = 0;
    out_offs[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
      const int64_t p = page_of(page_first, page_rows, n_pages, rows[i]);
      if (p < 0) return PQ_E_RANGE;
      const int64_t* offs = reinterpret_cast<const int64_t*>(page_offs[p]);
      const int64_t local = rows[i] - page_first[p];
      const int64_t a = offs[local], b = offs[local + 1];
      if (a < 0 || b < a || b > page_nbytes[p]) return PQ_E_BYTES;
      total += b - a;
      out_offs[i + 1] = total;
    }
    return total;
  }
  for (int64_t i = 0; i < n; ++i) {
    const int64_t p = page_of(page_first, page_rows, n_pages, rows[i]);
    const int64_t* offs = reinterpret_cast<const int64_t*>(page_offs[p]);
    const int64_t local = rows[i] - page_first[p];
    const int64_t len = out_offs[i + 1] - out_offs[i];
    if (len)
      std::memcpy(out_data + out_offs[i],
                  reinterpret_cast<const uint8_t*>(page_data[p]) +
                      offs[local],
                  (size_t)len);
    const uint8_t* valid = reinterpret_cast<const uint8_t*>(page_valid[p]);
    out_valid[i] = valid ? valid[local] : 1;
    out_row_valid[i] = valid ? 1 : 0;
  }
  return out_offs[n];
}

}  // extern "C"
