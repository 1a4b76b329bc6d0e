// The Snappy raw-format decoder, shared by the host sources of the port:
// host_codec.cpp (one page) and host_prescan.cpp (a chunk's pages in one
// call).  A port of the JAX package's `snappy_fast_uncompress`
// (its native.cpp).  Checks every bound itself.

#pragma once

#include <cstdint>
#include <cstring>

namespace pq {

// ---------------------------------------------------------------------------
// Snappy decode (the public raw format: varint length, then tags)
// ---------------------------------------------------------------------------

// 0 on success, 1 for a malformed stream or one whose declared length is
// not dst_len.  Short-offset copies replicate their pattern (offsets 1..15
// overlap the bytes they write); 16-byte blind copies run only where both
// buffers have 16 bytes of slack.
inline int snappy_uncompress(const uint8_t* src, int64_t src_len,
                             uint8_t* dst, int64_t dst_len) {
  const uint8_t* sp = src;
  const uint8_t* send = src + src_len;
  uint64_t ulen = 0;
  int shift = 0;
  while (true) {
    if (sp >= send || shift > 28) return 1;
    const uint8_t b = *sp++;
    ulen |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  if ((int64_t)ulen != dst_len) return 1;
  uint8_t* dp = dst;
  uint8_t* dend = dst + dst_len;
  while (sp < send) {
    const uint8_t tag = *sp++;
    if ((tag & 3) == 0) {  // literal
      int64_t len = (tag >> 2) + 1;
      if (len > 60) {
        const int nb = (int)len - 60;  // 1..4 length bytes
        if (send - sp < nb) return 1;
        uint32_t l = 0;
        memcpy(&l, sp, (size_t)nb);
        sp += nb;
        len = (int64_t)l + 1;
      }
      if (len > send - sp || len > dend - dp) return 1;
      if (len <= 16 && send - sp >= 16 && dend - dp >= 16) {
        memcpy(dp, sp, 16);  // blind wide copy, bounds checked above
      } else {
        memcpy(dp, sp, (size_t)len);
      }
      sp += len;
      dp += len;
      continue;
    }
    int64_t len, off;
    if ((tag & 3) == 1) {  // copy-1: 4..11 bytes, 11-bit offset
      if (sp >= send) return 1;
      len = ((tag >> 2) & 7) + 4;
      off = ((int64_t)(tag & 0xE0) << 3) | *sp++;
    } else if ((tag & 3) == 2) {  // copy-2: 16-bit offset
      if (send - sp < 2) return 1;
      uint16_t o;
      memcpy(&o, sp, 2);
      sp += 2;
      len = (tag >> 2) + 1;
      off = o;
    } else {  // copy-4: 32-bit offset
      if (send - sp < 4) return 1;
      uint32_t o;
      memcpy(&o, sp, 4);
      sp += 4;
      len = (tag >> 2) + 1;
      off = o;
    }
    if (off <= 0 || off > dp - dst || len > dend - dp) return 1;
    const uint8_t* cp = dp - off;
    if (off >= 16) {
      if (dend - dp >= len + 16) {
        for (int64_t l = 0; l < len; l += 16) memcpy(dp + l, cp + l, 16);
      } else {
        // chunks of `off` bytes: each source lies wholly behind its
        // destination, and later chunks see what earlier ones wrote
        int64_t done = 0;
        while (done < len) {
          const int64_t n = off < len - done ? off : len - done;
          memcpy(dp + done, cp + done, (size_t)n);
          done += n;
        }
      }
    } else if (dend - dp >= len + 16) {
      // the pattern doubled up to 16 bytes, stored with a stride that is
      // a multiple of the offset so its phase stays aligned
      uint8_t pat[32];
      for (int i = 0; i < (int)off; ++i) pat[i] = cp[i];
      int plen = (int)off;
      while (plen < 16) {
        memcpy(pat + plen, pat, (size_t)plen);
        plen <<= 1;
      }
      const int stride = (16 / (int)off) * (int)off;
      for (int64_t w = 0; w < len; w += stride) memcpy(dp + w, pat, 16);
    } else {
      for (int64_t i = 0; i < len; ++i) dp[i] = cp[i];  // overlap-safe
    }
    dp += len;
  }
  return dp == dend ? 0 : 1;
}

}  // namespace pq
