// Zstandard frames as libzstd 1.5.4 decodes them (RFC 8878): the frame
// header (single-segment frames, the window descriptor, the content size,
// the dictionary ID), skippable frames, raw, RLE and compressed blocks,
// literals raw, RLE or Huffman-coded (one or four streams, FSE-compressed
// or direct weights, treeless reuse), sequences with predefined, RLE, FSE
// and repeat tables, the three repeat offsets, and the content checksum
// (XXH64). Its refusals are libzstd's, each where libzstd makes it: a
// dictionary ID with no dictionary, a window over ZSTD_WINDOWLOG_LIMIT_DEFAULT
// (27), reserved bits, a corrupted block, a checksum that differs. The
// backward bitstreams are zstd's BIT_DStream_t, reads past their start
// included, so that a damaged stream fails, or decodes, where libzstd's
// does.

#include "zstd_decode.h"

#include <algorithm>
#include <cstring>
#include <vector>

namespace aq {
namespace {

constexpr size_t kBlockMax = 128 * 1024;  // ZSTD_BLOCKSIZE_MAX
constexpr uint32_t kMagic = 0xFD2FB528u, kSkipMagic = 0x184D2A50u;
constexpr uint64_t kMaxWindow = (uint64_t(1) << 27) + 1;  // ZSTD_MAXWINDOWSIZE_DEFAULT
constexpr uint64_t kUnknown = ~uint64_t(0);               // ZSTD_CONTENTSIZE_UNKNOWN

inline uint32_t le32(const uint8_t* p) { return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24; }
inline uint64_t le64(const uint8_t* p) { return uint64_t(le32(p)) | uint64_t(le32(p + 4)) << 32; }
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------- XXH64

struct Xxh64 {
  static constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL, P3 = 1609587929392839161ULL,
                            P4 = 9650029242287828579ULL, P5 = 2870177450012600261ULL;
  static uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
  static uint64_t round(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
  static uint64_t merge(uint64_t acc, uint64_t v) { return (acc ^ round(0, v)) * P1 + P4; }

  static uint64_t hash(const uint8_t* p, size_t n) {
    const uint8_t* end = p + n;
    uint64_t h;
    if (n >= 32) {
      uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = uint64_t(0) - P1;
      while (end - p >= 32) {
        v1 = round(v1, le64(p));
        v2 = round(v2, le64(p + 8));
        v3 = round(v3, le64(p + 16));
        v4 = round(v4, le64(p + 24));
        p += 32;
      }
      h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
      h = merge(merge(merge(merge(h, v1), v2), v3), v4);
    } else {
      h = P5;
    }
    h += uint64_t(n);
    while (end - p >= 8) {
      h ^= round(0, le64(p));
      h = rotl(h, 27) * P1 + P4;
      p += 8;
    }
    if (end - p >= 4) {
      h ^= uint64_t(le32(p)) * P1;
      h = rotl(h, 23) * P2 + P3;
      p += 4;
    }
    while (p < end) {
      h ^= uint64_t(*p++) * P5;
      h = rotl(h, 11) * P1;
    }
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
  }
};

// ---------------------------------------------------------------- bitstreams

// BIT_DStream_t on a 64-bit host: read backwards from the end, the last
// byte's highest set bit the end mark.
struct BitD {
  enum Status { UNFINISHED = 0, END_OF_BUFFER = 1, COMPLETED = 2, OVERFLOW_ = 3 };
  uint64_t c = 0;
  unsigned consumed = 0;
  const uint8_t *ptr = nullptr, *start = nullptr, *limit = nullptr;

  bool init(const uint8_t* src, size_t n) {
    if (n < 1) return false;
    start = src;
    limit = src + 8;
    const uint8_t last = src[n - 1];
    if (n >= 8) {
      ptr = src + n - 8;
      c = le64(ptr);
      consumed = last ? 8 - highbit(last) : 0;
      return last != 0;
    }
    ptr = src;
    c = src[0];
    for (size_t i = 1; i < n; ++i) c += uint64_t(src[i]) << (8 * i);
    consumed = last ? 8 - highbit(last) : 0;
    if (last == 0) return false;
    consumed += unsigned(8 - n) * 8;
    return true;
  }
  uint64_t look(unsigned nb) const {  // BIT_lookBits: BIT_getMiddleBits, the start taken mod 64
    const uint64_t v = c >> ((64u - consumed - nb) & 63);
    return nb >= 64 ? v : v & ((uint64_t(1) << nb) - 1);
  }
  uint64_t look_fast(unsigned nb) const { return (c << (consumed & 63)) >> ((64 - nb) & 63); }  // nb >= 1
  void skip(unsigned nb) { consumed += nb; }
  uint64_t read(unsigned nb) {
    const uint64_t v = look(nb);
    skip(nb);
    return v;
  }
  uint64_t read_fast(unsigned nb) {
    const uint64_t v = look_fast(nb);
    skip(nb);
    return v;
  }
  Status reload() {
    if (consumed > 64) return OVERFLOW_;
    if (ptr >= limit) {  // BIT_reloadDStreamFast
      ptr -= consumed >> 3;
      consumed &= 7;
      c = le64(ptr);
      return UNFINISHED;
    }
    if (ptr == start) return consumed < 64 ? END_OF_BUFFER : COMPLETED;
    unsigned nb = consumed >> 3;
    Status r = UNFINISHED;
    if (ptr - nb < start) {
      nb = unsigned(ptr - start);
      r = END_OF_BUFFER;
    }
    ptr -= nb;
    consumed -= nb * 8;
    c = le64(ptr);
    return r;
  }
  bool end() const { return ptr == start && consumed == 64; }
};

// ---------------------------------------------------------------- FSE

// FSE_readNCount over n bytes at src (a header shorter than 8 bytes read
// from a zero-padded copy): the normalized counts, *max_sv in and out,
// *table_log; the header's size, or 0 for an error.
size_t read_ncount(int16_t* norm, unsigned* max_sv, unsigned* table_log, const uint8_t* src, size_t n) {
  if (n < 8) {
    uint8_t buf[8] = {};
    std::memcpy(buf, src, n);
    const size_t r = read_ncount(norm, max_sv, table_log, buf, 8);
    return r == 0 || r > n ? 0 : r;
  }
  const uint8_t* const istart = src;
  const uint8_t* const iend = src + n;
  const uint8_t* ip = istart;
  const unsigned max_sv1 = *max_sv + 1;
  std::fill(norm, norm + max_sv1, int16_t(0));
  uint32_t bits = le32(ip);
  int nb = int(bits & 0xF) + 5;
  if (nb > 15) return 0;
  bits >>= 4;
  int bitcount = 4;
  *table_log = unsigned(nb);
  int remaining = (1 << nb) + 1;
  int threshold = 1 << nb;
  nb++;
  unsigned charnum = 0;
  bool previous0 = false;
  auto advance = [&]() {
    if (ip <= iend - 7 || ip + (bitcount >> 3) <= iend - 4) {
      ip += bitcount >> 3;
      bitcount &= 7;
    } else {
      bitcount -= int(8 * (iend - 4 - ip));
      bitcount &= 31;
      ip = iend - 4;
    }
    bits = le32(ip) >> bitcount;
  };
  for (;;) {
    if (previous0) {
      int repeats = __builtin_ctz(~bits | 0x80000000u) >> 1;
      while (repeats >= 12) {
        charnum += 3 * 12;
        if (ip <= iend - 7) {
          ip += 3;
        } else {
          bitcount -= int(8 * (iend - 7 - ip));
          bitcount &= 31;
          ip = iend - 4;
        }
        bits = le32(ip) >> bitcount;
        repeats = __builtin_ctz(~bits | 0x80000000u) >> 1;
      }
      charnum += unsigned(3 * repeats);
      bits >>= 2 * repeats;
      bitcount += 2 * repeats;
      charnum += bits & 3;
      bitcount += 2;
      if (charnum >= max_sv1) break;
      advance();
    }
    {
      const int mx = (2 * threshold - 1) - remaining;
      int count;
      if (int(bits & uint32_t(threshold - 1)) < mx) {
        count = int(bits & uint32_t(threshold - 1));
        bitcount += nb - 1;
      } else {
        count = int(bits & uint32_t(2 * threshold - 1));
        if (count >= threshold) count -= mx;
        bitcount += nb;
      }
      count--;
      if (count >= 0) remaining -= count;
      else remaining += count;
      norm[charnum++] = int16_t(count);
      previous0 = count == 0;
      if (remaining < threshold) {
        if (remaining <= 1) break;
        nb = highbit(uint32_t(remaining)) + 1;
        threshold = 1 << (nb - 1);
      }
      if (charnum >= max_sv1) break;
      advance();
    }
  }
  if (remaining != 1 || charnum > max_sv1 || bitcount > 32) return 0;
  *max_sv = charnum - 1;
  ip += (bitcount + 7) >> 3;
  return size_t(ip - istart);
}

// The decode table of FSE_buildDTable / ZSTD_buildFSETable: each cell's
// symbol, bits to read and base of the next state.
struct FseCell {
  uint16_t next;
  uint8_t nbits;
  uint8_t symbol;
};
std::vector<FseCell> build_fse(const int16_t* norm, unsigned max_sv, unsigned table_log) {
  const uint32_t size = 1u << table_log, mask = size - 1, step = (size >> 1) + (size >> 3) + 3;
  std::vector<FseCell> t(size);
  std::vector<uint16_t> next(max_sv + 1);
  uint32_t high = size - 1;
  for (unsigned s = 0; s <= max_sv; ++s) {
    if (norm[s] == -1) {
      t[high--].symbol = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s]);
    }
  }
  uint32_t pos = 0;
  for (unsigned s = 0; s <= max_sv; ++s)
    for (int i = 0; i < norm[s]; ++i) {
      t[pos].symbol = uint8_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  for (uint32_t u = 0; u < size; ++u) {
    const uint32_t ns = next[t[u].symbol]++;
    t[u].nbits = uint8_t(table_log - highbit(ns));
    t[u].next = uint16_t((ns << t[u].nbits) - size);
  }
  return t;
}

// FSE_decompress_wksp (two interleaved states) of a Huffman tree's
// weights: the weights out, or -1.
int fse_weights(const uint8_t* src, size_t n, uint8_t* out, size_t cap) {
  int16_t norm[256];
  unsigned max_sv = 255, table_log;
  const size_t h = read_ncount(norm, &max_sv, &table_log, src, n);
  if (h == 0 || table_log > 6 || h > n) return -1;  // tableLog_tooLarge
  const std::vector<FseCell> t = build_fse(norm, max_sv, table_log);
  BitD bd;
  if (!bd.init(src + h, n - h)) return -1;
  uint32_t s1 = uint32_t(bd.read(table_log));
  bd.reload();
  uint32_t s2 = uint32_t(bd.read(table_log));
  bd.reload();
  auto sym = [&](uint32_t* s) {
    const FseCell& e = t[*s];
    *s = e.next + uint32_t(bd.read(e.nbits));
    return e.symbol;
  };
  size_t op = 0;
  for (; (bd.reload() == BitD::UNFINISHED) & (op + 3 < cap); op += 4) {
    out[op] = sym(&s1);
    out[op + 1] = sym(&s2);
    out[op + 2] = sym(&s1);
    out[op + 3] = sym(&s2);
  }
  while (true) {
    if (op + 2 > cap) return -1;
    out[op++] = sym(&s1);
    if (bd.reload() == BitD::OVERFLOW_) {
      out[op++] = sym(&s2);
      break;
    }
    if (op + 2 > cap) return -1;
    out[op++] = sym(&s2);
    if (bd.reload() == BitD::OVERFLOW_) {
      out[op++] = sym(&s1);
      break;
    }
  }
  return int(op);
}

// ---------------------------------------------------------------- Huffman

struct Huf {
  int table_log = 0;
  std::vector<uint8_t> sym, nbits;  // 1 << table_log cells

  // HUF_readStats and the X1 table: the description's size, or 0.
  size_t read(const uint8_t* src, size_t n) {
    if (n == 0) return 0;
    uint8_t w[256];
    size_t isize = src[0], osize;
    if (isize >= 128) {
      osize = isize - 127;
      isize = (osize + 1) / 2;
      if (isize + 1 > n || osize >= 256) return 0;
      for (size_t k = 0; k < osize; k += 2) {
        w[k] = src[1 + k / 2] >> 4;
        w[k + 1] = src[1 + k / 2] & 15;
      }
    } else {
      if (isize + 1 > n) return 0;
      const int got = fse_weights(src + 1, isize, w, 255);
      if (got < 0) return 0;
      osize = size_t(got);
    }
    uint32_t rank[13] = {}, total = 0;
    for (size_t k = 0; k < osize; ++k) {
      if (w[k] > 12) return 0;
      rank[w[k]]++;
      total += (1u << w[k]) >> 1;
    }
    if (total == 0) return 0;
    const int log = highbit(total) + 1;
    if (log > 12) return 0;
    const uint32_t rest = (1u << log) - total;
    if ((1u << highbit(rest)) != rest) return 0;
    const int lastw = highbit(rest) + 1;
    w[osize] = uint8_t(lastw);
    rank[lastw]++;
    if (rank[1] < 2 || (rank[1] & 1)) return 0;
    const size_t nsym = osize + 1;
    table_log = log;
    sym.assign(size_t(1) << log, 0);
    nbits.assign(size_t(1) << log, 0);
    uint32_t start[13] = {}, next = 0;
    for (int r = 1; r <= log; ++r) {
      start[r] = next;
      next += rank[r] << (r - 1);
    }
    for (size_t s = 0; s < nsym; ++s) {
      const int wt = w[s];
      if (!wt) continue;
      const uint32_t len = (1u << wt) >> 1;
      for (uint32_t k = 0; k < len; ++k) {
        sym[start[wt] + k] = uint8_t(s);
        nbits[start[wt] + k] = uint8_t(log + 1 - wt);
      }
      start[wt] += len;
    }
    return isize + 1;
  }

  uint8_t decode(BitD* bd) const {
    const uint64_t v = bd->look_fast(unsigned(table_log));
    bd->skip(nbits[v]);
    return sym[v];
  }

  // HUF_decodeStreamX1 into p[0, n)
  void stream(uint8_t* p, size_t n, BitD* bd) const {
    size_t i = 0;
    if (n > 3) {
      while ((bd->reload() == BitD::UNFINISHED) & (i + 3 < n))
        for (int k = 0; k < 4; ++k) p[i++] = decode(bd);
    } else {
      bd->reload();
    }
    while (i < n) p[i++] = decode(bd);
  }

  bool one(const uint8_t* src, size_t n, uint8_t* out, size_t count) const {
    BitD bd;
    if (!bd.init(src, n)) return false;
    stream(out, count, &bd);
    return bd.end();
  }

  bool four(const uint8_t* src, size_t n, uint8_t* out, size_t count) const {
    if (n < 10 || count < 6) return false;
    const size_t l1 = src[0] | src[1] << 8, l2 = src[2] | src[3] << 8, l3 = src[4] | src[5] << 8;
    if (l1 + l2 + l3 + 6 > n) return false;
    const size_t l4 = n - (l1 + l2 + l3 + 6), seg = (count + 3) / 4;
    if (3 * seg > count) return false;
    BitD b[4];
    const uint8_t* at = src + 6;
    const size_t lens[4] = {l1, l2, l3, l4};
    for (int k = 0; k < 4; ++k) {
      if (!b[k].init(at, lens[k])) return false;
      at += lens[k];
    }
    for (int k = 0; k < 4; ++k) stream(out + k * seg, k < 3 ? seg : count - 3 * seg, &b[k]);
    return b[0].end() && b[1].end() && b[2].end() && b[3].end();
  }
};

// ---------------------------------------------------------------- sequences

struct SeqCell {
  uint16_t next;
  uint8_t nbits, extra;
  uint32_t base;
};

const uint32_t kLLBase[36] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18, 20, 22, 24, 28, 32, 40,
                              48, 64, 0x80, 0x100, 0x200, 0x400, 0x800, 0x1000, 0x2000, 0x4000, 0x8000, 0x10000};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
                              21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37,
                              39, 41, 43, 47, 51, 59, 67, 83, 99, 0x83, 0x103, 0x203, 0x403, 0x803,
                              0x1003, 0x2003, 0x4003, 0x8003, 0x10003};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1,
                             1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kOFBase[32] = {0, 1, 1, 5, 0xD, 0x1D, 0x3D, 0x7D, 0xFD, 0x1FD, 0x3FD, 0x7FD, 0xFFD, 0x1FFD, 0x3FFD,
                              0x7FFD, 0xFFFD, 0x1FFFD, 0x3FFFD, 0x7FFFD, 0xFFFFD, 0x1FFFFD, 0x3FFFFD, 0x7FFFFD,
                              0xFFFFFD, 0x1FFFFFD, 0x3FFFFFD, 0x7FFFFFD, 0xFFFFFFD, 0x1FFFFFFD, 0x3FFFFFFD, 0x7FFFFFFD};
const uint8_t kOFBits[32] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                             16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31};

struct SeqTable {
  int log = 0;
  std::vector<SeqCell> cells;
};

SeqTable seq_table(const int16_t* norm, unsigned max_sv, unsigned log, const uint32_t* base, const uint8_t* extra) {
  const std::vector<FseCell> f = build_fse(norm, max_sv, log);
  SeqTable t;
  t.log = int(log);
  t.cells.resize(f.size());
  for (size_t u = 0; u < f.size(); ++u) t.cells[u] = {f[u].next, f[u].nbits, extra[f[u].symbol], base[f[u].symbol]};
  return t;
}

// The predefined tables (LL_defaultDTable, ML_defaultDTable, OF_defaultDTable)
struct Defaults {
  SeqTable ll = seq_table(kLLNorm, 35, 6, kLLBase, kLLBits), ml = seq_table(kMLNorm, 52, 6, kMLBase, kMLBits),
           of = seq_table(kOFNorm, 28, 5, kOFBase, kOFBits);
};
const Defaults& defaults() {
  static const Defaults d;
  return d;
}

// ---------------------------------------------------------------- frames

struct Frame {
  uint64_t content = kUnknown, window = 0;
  uint32_t dict = 0;
  bool checksum = false, single = false, skippable = false;
  size_t header = 0, block_max = 0;
};

// ZSTD_getFrameHeader: true where src holds a whole, valid header.
bool frame_header(const uint8_t* src, size_t n, Frame* f) {
  if (n < 4) return false;
  const uint32_t magic = le32(src);
  if ((magic & 0xFFFFFFF0u) == kSkipMagic) {
    if (n < 8) return false;
    f->skippable = true;
    f->header = 8;
    f->content = le32(src + 4);
    return true;
  }
  if (magic != kMagic || n < 5) return false;
  const uint8_t fhd = src[4];
  const int dict_code = fhd & 3, fcs_code = fhd >> 6;
  f->single = (fhd >> 5) & 1;
  f->checksum = (fhd >> 2) & 1;
  static const int kDictBytes[4] = {0, 1, 2, 4}, kFcsBytes[4] = {0, 2, 4, 8};
  const size_t hs = 5 + !f->single + kDictBytes[dict_code] + kFcsBytes[fcs_code] + (f->single && !fcs_code);
  if (n < hs) return false;
  if (fhd & 0x08) return false;  // reserved bit: frameParameter_unsupported
  size_t p = 5;
  uint64_t window = 0;
  if (!f->single) {
    const uint8_t wd = src[p++];
    const int wlog = (wd >> 3) + 10;
    if (wlog > 31) return false;  // ZSTD_WINDOWLOG_MAX
    window = uint64_t(1) << wlog;
    window += (window >> 3) * (wd & 7);
  }
  switch (dict_code) {
    case 1: f->dict = src[p]; p += 1; break;
    case 2: f->dict = uint32_t(src[p] | src[p + 1] << 8); p += 2; break;
    case 3: f->dict = le32(src + p); p += 4; break;
    default: break;
  }
  switch (fcs_code) {
    case 0: if (f->single) f->content = src[p]; break;
    case 1: f->content = uint64_t(src[p] | src[p + 1] << 8) + 256; break;
    case 2: f->content = le32(src + p); break;
    default: f->content = le64(src + p); break;
  }
  if (f->single) window = f->content;
  f->window = window;
  f->block_max = size_t(std::min<uint64_t>(window, kBlockMax));
  f->header = hs;
  return true;
}

// ZSTD_findFrameCompressedSize: the frame's bytes, or 0 where it does not
// lie whole in src.
size_t frame_size(const uint8_t* src, size_t n, const Frame& f) {
  size_t p = f.header;
  while (true) {
    if (n - p < 3) return 0;
    const uint32_t bh = uint32_t(src[p] | src[p + 1] << 8 | src[p + 2] << 16);
    const int type = (bh >> 1) & 3;
    if (type == 3) return 0;
    const size_t size = type == 1 ? 1 : bh >> 3;
    if (3 + size > n - p) return 0;
    p += 3 + size;
    if (bh & 1) break;
  }
  if (f.checksum) {
    if (n - p < 4) return 0;
    p += 4;
  }
  return p;
}

// One frame's decoding state: what decompressBegin resets.
struct Decoder {
  std::vector<uint8_t> out;  // the frame's output so far: the whole history
  uint32_t rep[3] = {1, 4, 8};
  bool lit_entropy = false, fse_entropy = false;
  Huf huf;
  SeqTable ll, ml, of, ll_rle, ml_rle, of_rle;  // the tables built in this frame
  const SeqTable *llp = &defaults().ll, *mlp = &defaults().ml, *ofp = &defaults().of;  // the ones in use
  std::vector<uint8_t> lits;

  // ZSTD_buildSeqTable: bytes read, or -1
  long build(int type, const uint8_t* p, size_t n, unsigned max, unsigned maxlog, const uint32_t* base,
             const uint8_t* extra, SeqTable* space, SeqTable* rle, const SeqTable* def, const SeqTable** cur) {
    switch (type) {
      case 1: {  // RLE
        if (n == 0 || p[0] > max) return -1;
        rle->log = 0;
        rle->cells.assign(1, {0, 0, extra[p[0]], base[p[0]]});
        *cur = rle;
        return 1;
      }
      case 0:
        *cur = def;
        return 0;
      case 3:
        return fse_entropy ? 0 : -1;
      default: {
        int16_t norm[53];
        unsigned mx = max, log;
        const size_t h = read_ncount(norm, &mx, &log, p, n);
        if (h == 0 || log > maxlog) return -1;
        *space = seq_table(norm, mx, log, base, extra);
        *cur = space;
        return long(h);
      }
    }
  }

  // ZSTD_decompressBlock_internal into the history, at most cap bytes:
  // false on an error (the history then holds what the block wrote).
  bool block(const uint8_t* src, size_t n, size_t cap) {
    if (n > kBlockMax || n < 2) return false;
    // literals
    const int ltype = src[0] & 3, lcode = (src[0] >> 2) & 3;
    size_t lit_size, used;
    const size_t expected = std::min(kBlockMax, cap);
    const uint8_t* lit_src = nullptr;
    if (ltype == 2 || ltype == 3) {  // compressed, treeless
      if (ltype == 3 && !lit_entropy) return false;
      if (n < 5) return false;
      const uint32_t lhc = le32(src);
      size_t lh, csize;
      bool single = false;
      if (lcode < 2) {
        single = lcode == 0;
        lh = 3;
        lit_size = (lhc >> 4) & 0x3FF;
        csize = (lhc >> 14) & 0x3FF;
      } else if (lcode == 2) {
        lh = 4;
        lit_size = (lhc >> 4) & 0x3FFF;
        csize = lhc >> 18;
      } else {
        lh = 5;
        lit_size = (lhc >> 4) & 0x3FFFF;
        csize = (lhc >> 22) + (size_t(src[4]) << 10);
      }
      if (lit_size > kBlockMax) return false;
      if (!single && lit_size < 6) return false;  // MIN_LITERALS_FOR_4_STREAMS
      if (csize + lh > n || expected < lit_size) return false;
      lits.assign(lit_size, 0);
      const uint8_t* hp = src + lh;
      size_t hn = csize;
      if (ltype == 2) {
        Huf h;
        const size_t hs = h.read(hp, hn);
        if (hs == 0 || hs >= hn) return false;
        huf = std::move(h);
        hp += hs;
        hn -= hs;
      }
      if (lit_size == 0) return false;  // HUF_decompress: dstSize_tooSmall
      if (!(single ? huf.one(hp, hn, lits.data(), lit_size) : huf.four(hp, hn, lits.data(), lit_size))) return false;
      lit_entropy = true;
      used = csize + lh;
    } else {
      size_t lh;
      if (lcode == 0 || lcode == 2) {
        lh = 1;
        lit_size = src[0] >> 3;
      } else if (lcode == 1) {
        lh = 2;
        if (ltype == 1 && n < 3) return false;
        lit_size = size_t(src[0] | src[1] << 8) >> 4;
      } else {
        lh = 3;
        if (n < (ltype == 1 ? 4u : 3u)) return false;
        lit_size = size_t(src[0] | src[1] << 8 | src[2] << 16) >> 4;
      }
      if (ltype == 1 && lit_size > kBlockMax) return false;
      if (expected < lit_size) return false;
      if (ltype == 0) {
        if (lh + lit_size > n) return false;
        lit_src = src + lh;
        used = lh + lit_size;
      } else {
        lits.assign(lit_size, src[lh]);
        used = lh + 1;
      }
    }
    if (lit_src) lits.assign(lit_src, lit_src + lit_size);
    const uint8_t* ip = src + used;
    const uint8_t* const iend = src + n;
    // sequences header
    if (ip >= iend) return false;  // MIN_SEQUENCES_SIZE
    size_t nseq = *ip++;
    if (nseq == 0) {
      if (ip != iend) return false;
    } else {
      if (nseq > 0x7F) {
        if (nseq == 0xFF) {
          if (ip + 2 > iend) return false;
          nseq = size_t(ip[0] | ip[1] << 8) + 0x7F00;
          ip += 2;
        } else {
          if (ip >= iend) return false;
          nseq = ((nseq - 0x80) << 8) + *ip++;
        }
      }
      if (ip + 1 > iend || (*ip & 3)) return false;
      const int llt = *ip >> 6, oft = (*ip >> 4) & 3, mlt = (*ip >> 2) & 3;
      ++ip;
      long r = build(llt, ip, size_t(iend - ip), 35, 9, kLLBase, kLLBits, &ll, &ll_rle, &defaults().ll, &llp);
      if (r < 0) return false;
      ip += r;
      r = build(oft, ip, size_t(iend - ip), 31, 8, kOFBase, kOFBits, &of, &of_rle, &defaults().of, &ofp);
      if (r < 0) return false;
      ip += r;
      r = build(mlt, ip, size_t(iend - ip), 52, 9, kMLBase, kMLBits, &ml, &ml_rle, &defaults().ml, &mlp);
      if (r < 0) return false;
      ip += r;
    }
    const size_t start = out.size();
    size_t lit_at = 0;
    if (nseq) {
      fse_entropy = true;
      uint64_t prev[3] = {rep[0], rep[1], rep[2]};
      BitD bd;
      if (!bd.init(ip, size_t(iend - ip))) return false;
      uint32_t sl = uint32_t(bd.read(unsigned(llp->log)));
      bd.reload();
      uint32_t so = uint32_t(bd.read(unsigned(ofp->log)));
      bd.reload();
      uint32_t sm = uint32_t(bd.read(unsigned(mlp->log)));
      bd.reload();
      for (;;) {
        const SeqCell& L = llp->cells[sl];
        const SeqCell& M = mlp->cells[sm];
        const SeqCell& O = ofp->cells[so];
        size_t ml_len = M.base, ll_len = L.base;
        uint64_t offset;
        if (O.extra > 1) {
          offset = O.base + bd.read_fast(O.extra);
          prev[2] = prev[1];
          prev[1] = prev[0];
          prev[0] = offset;
        } else {
          const int ll0 = L.base == 0;
          if (O.extra == 0) {
            offset = prev[ll0];
            prev[1] = prev[!ll0];
            prev[0] = offset;
          } else {
            offset = O.base + ll0 + bd.read_fast(1);
            uint64_t temp = offset == 3 ? prev[0] - 1 : prev[offset];
            temp += !temp;
            if (offset != 1) prev[2] = prev[1];
            prev[1] = prev[0];
            prev[0] = offset = temp;
          }
        }
        if (M.extra > 0) ml_len += bd.read_fast(M.extra);
        if (L.extra + M.extra + O.extra >= 57 - (9 + 9 + 8)) bd.reload();
        if (L.extra > 0) ll_len += bd.read_fast(L.extra);
        sl = L.next + uint32_t(bd.read(L.nbits));
        sm = M.next + uint32_t(bd.read(M.nbits));
        so = O.next + uint32_t(bd.read(O.nbits));
        // ZSTD_execSequence
        const size_t op = out.size() - start;
        if (ll_len + ml_len > cap - op) return false;
        if (ll_len > lits.size() - lit_at) return false;
        out.insert(out.end(), lits.begin() + long(lit_at), lits.begin() + long(lit_at + ll_len));
        lit_at += ll_len;
        if (offset > out.size()) return false;
        const size_t at = out.size();
        out.resize(at + ml_len);
        uint8_t* o = out.data() + at;
        const uint8_t* from = o - offset;
        for (size_t k = 0; k < ml_len; ++k) o[k] = from[k];  // byte by byte: the match may overlap itself
        if (!--nseq) break;
        bd.reload();
      }
      if (bd.reload() < BitD::COMPLETED) return false;
      for (int k = 0; k < 3; ++k) rep[k] = uint32_t(prev[k]);
    }
    const size_t last = lits.size() - lit_at;
    if (last > cap - (out.size() - start)) return false;
    out.insert(out.end(), lits.begin() + long(lit_at), lits.end());
    return true;
  }
};

}  // namespace

bool zstd_tiff_decode(const uint8_t* src, size_t cc, uint8_t* dst, size_t occ) {
  Frame f;
  if (!frame_header(src, cc, &f) || f.skippable) return false;  // nothing out: short of occ
  if (f.content != kUnknown && occ >= f.content) {
    // the single-pass shortcut: a whole frame of known size that fits
    const size_t whole = frame_size(src, cc, f);
    if (whole) {
      const int64_t got = zstd_decompress(src, whole, dst, occ);
      return got >= 0 && uint64_t(got) == occ;
    }
  }
  if (f.dict != 0) return false;  // dictionary_wrong
  const uint64_t window = std::max<uint64_t>(f.window, 1024);
  if (window > kMaxWindow) return false;
  // the stream's buffer (ZSTD_decodingBufferSize_internal): where each
  // block is decoded, and from where it is flushed to dst
  const uint64_t ring = std::min<uint64_t>(f.content, window + 2 * uint64_t(f.block_max) + 64);
  Decoder d;
  size_t pos = f.header, written = 0, ring_at = 0;
  while (true) {
    if (cc - pos < 3) return written == occ;  // the input ends: libtiff needs all of occ
    const uint32_t bh = uint32_t(src[pos] | src[pos + 1] << 8 | src[pos + 2] << 16);
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t csize = type == 1 ? 1 : bh >> 3, rle = bh >> 3;
    if (type == 3 || csize > f.block_max) return false;
    pos += 3;
    const size_t before = d.out.size();
    if (type == 0 && csize > 0) {  // raw: streamed as far as the input goes
      const size_t take = std::min(csize, cc - pos);
      d.out.insert(d.out.end(), src + pos, src + pos + take);
      pos += take;
      if (take < csize) {
        const size_t put = std::min(take, occ - written);
        std::memcpy(dst + written, d.out.data() + before, put);
        return written + put == occ;
      }
    } else if (csize > 0) {
      if (cc - pos < csize) return written == occ;  // the block not all there
      const size_t cap = size_t(ring - ring_at);
      if (type == 1) {
        if (rle > cap) return false;
        d.out.insert(d.out.end(), rle, src[pos]);
      } else if (!d.block(src + pos, csize, cap)) {
        return false;
      }
      pos += csize;
    }
    const size_t r = d.out.size() - before;
    if (r > f.block_max) return false;
    if (last && f.content != kUnknown && d.out.size() != f.content) return false;
    const size_t put = std::min(r, occ - written);
    std::memcpy(dst + written, d.out.data() + before, put);
    written += put;
    if (put < r) return true;  // dst full mid-block: the stream stops there
    ring_at += r;
    if (ring < f.content && ring_at + f.block_max > ring) ring_at = 0;
    if (last) break;
  }
  if (f.checksum && cc - pos >= 4 &&
      uint32_t(Xxh64::hash(d.out.data(), d.out.size())) != le32(src + pos))
    return false;
  return written == occ;
}

int64_t zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  size_t total = 0;
  while (n >= 5) {
    const uint32_t magic = le32(src);
    if ((magic & 0xFFFFFFF0u) == kSkipMagic) {
      if (n < 8) return -1;
      const uint64_t size = uint64_t(le32(src + 4)) + 8;
      if (size > n) return -1;
      src += size;
      n -= size_t(size);
      continue;
    }
    Frame f;
    if (n < 9 || !frame_header(src, n, &f) || f.dict != 0) return -1;
    if (n < f.header + 3) return -1;
    Decoder d;
    size_t pos = f.header;
    while (true) {
      if (n - pos < 3) return -1;
      const uint32_t bh = uint32_t(src[pos] | src[pos + 1] << 8 | src[pos + 2] << 16);
      const int type = (bh >> 1) & 3;
      const size_t csize = type == 1 ? 1 : bh >> 3;
      if (type == 3) return -1;
      pos += 3;
      if (csize > n - pos) return -1;
      const size_t room = cap - total, before = d.out.size();
      if (type == 0) {
        if (csize > room) return -1;
        d.out.insert(d.out.end(), src + pos, src + pos + csize);
      } else if (type == 1) {
        if ((bh >> 3) > room) return -1;
        d.out.insert(d.out.end(), bh >> 3, src[pos]);
      } else if (!d.block(src + pos, csize, room)) {
        return -1;
      }
      // written as decoded: a later error leaves the blocks before it
      std::memcpy(dst + total, d.out.data() + before, d.out.size() - before);
      total += d.out.size() - before;
      pos += csize;
      if (bh & 1) break;
    }
    if (f.content != kUnknown && d.out.size() != f.content) return -1;
    if (f.checksum) {
      if (n - pos < 4 || uint32_t(Xxh64::hash(d.out.data(), d.out.size())) != le32(src + pos)) return -1;
      pos += 4;
    }
    src += pos;
    n -= pos;
  }
  return n ? -1 : int64_t(total);
}

}  // namespace aq

extern "C" {

// ZSTD_decompress alone (tests): the bytes out, or -1.
long aq_zstd_decompress(const uint8_t* src, long n, uint8_t* dst, long cap) {
  return long(aq::zstd_decompress(src, size_t(n), dst, size_t(cap)));
}

}  // extern "C"
