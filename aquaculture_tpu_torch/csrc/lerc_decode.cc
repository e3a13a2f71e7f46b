// Lerc2 blobs as libLerc 4.0 decodes them (Lerc2::Decode): every header
// version it reads (1-6: the Fletcher-32 checksum from 3, nDepth and
// per-depth ranges from 4, block flags with depth differences from 5, the
// noData fields from 6), the validity mask (RLE), constant images, raw
// binary data, tiled blocks (micro blocks with their offset, zero and
// constant blocks, BitStuffer2 with and without its lookup table, before and
// from version 3), and Huffman coding of 8-bit types with and without
// delta. The integer types tif_getimage.c can put (8 and 16 bits, signed or
// not) decode here; the others fail, as the RGBA interface refuses them
// before any decode.

#include "lerc_decode.h"

#include <algorithm>
#include <cstring>
#include <memory>
#include <vector>

namespace aq {
namespace {

enum DataType { DT_CHAR = 0, DT_BYTE, DT_SHORT, DT_USHORT, DT_INT, DT_UINT, DT_FLOAT, DT_DOUBLE, DT_UNDEFINED };
enum EncodeMode { IEM_TILING = 0, IEM_DELTA_HUFFMAN = 1, IEM_HUFFMAN = 2 };
constexpr int kCurrVersion = 6;

inline int32_t rd32(const uint8_t* p) {
  int32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint32_t ru32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline double rdd(const uint8_t* p) {
  double v;
  std::memcpy(&v, p, 8);
  return v;
}

// A double to an integer type as x86-64 converts it: truncated to int32
// (cvttsd2si, 0x80000000 where it does not fit), then narrowed.
template <class T>
T to_int(double z) {
  const int32_t i = (z >= -2147483648.0 && z < 2147483648.0) ? int32_t(z) : INT32_MIN;
  return T(i);
}

struct Header {
  int version = 0;
  uint32_t checksum = 0;
  int rows = 0, cols = 0, depth = 1, valid = 0, mb_size = 0, blob_size = 0, dt = 0;
  uint8_t pass_nodata = 0;
  double max_z_error = 0, z_min = 0, z_max = 0;
};

// Lerc2::ReadHeader: the header's bytes, or 0.
size_t read_header(const uint8_t* p, size_t n, Header* h) {
  if (n < 6 || std::memcmp(p, "Lerc2 ", 6)) return 0;
  size_t at = 6;
  if (n - at < 4) return 0;
  h->version = rd32(p + at);
  at += 4;
  if (h->version > kCurrVersion) return 0;
  if (h->version >= 3) {
    if (n - at < 4) return 0;
    h->checksum = ru32(p + at);
    at += 4;
  }
  const int nints = h->version >= 6 ? 8 : h->version >= 4 ? 7 : 6;
  const int ndbl = h->version >= 6 ? 5 : 3;
  if (n - at < size_t(4 * nints)) return 0;
  int v[8];
  for (int i = 0; i < nints; ++i) v[i] = rd32(p + at + 4 * i);
  at += size_t(4 * nints);
  if (h->version >= 6) {
    if (n - at < 4) return 0;
    h->pass_nodata = p[at];
    at += 4;
  }
  if (n - at < size_t(8 * ndbl)) return 0;
  double d[5];
  for (int i = 0; i < ndbl; ++i) d[i] = rdd(p + at + 8 * i);
  at += size_t(8 * ndbl);
  int i = 0;
  h->rows = v[i++];
  h->cols = v[i++];
  h->depth = h->version >= 4 ? v[i++] : 1;
  h->valid = v[i++];
  h->mb_size = v[i++];
  h->blob_size = v[i++];
  h->dt = v[i];  // version 6 then nBlobsMore, not read here
  if (h->dt < DT_CHAR || h->dt > DT_UNDEFINED) return 0;
  h->max_z_error = d[0];
  h->z_min = d[1];
  h->z_max = d[2];
  if (h->rows <= 0 || h->cols <= 0 || h->depth <= 0 || h->valid < 0 || h->mb_size <= 0 || h->blob_size <= 0 ||
      h->valid > int32_t(uint32_t(h->rows) * uint32_t(h->cols)))  // nRows * nCols as libLerc's int
    return 0;
  return at;
}

uint32_t fletcher32(const uint8_t* p, size_t len) {
  uint32_t sum1 = 0xffff, sum2 = 0xffff;
  size_t words = len / 2;
  while (words) {
    size_t tlen = words >= 359 ? 359 : words;
    words -= tlen;
    do {
      sum1 += uint32_t(*p++) << 8;
      sum2 += sum1 += *p++;
    } while (--tlen);
    sum1 = (sum1 & 0xffff) + (sum1 >> 16);
    sum2 = (sum2 & 0xffff) + (sum2 >> 16);
  }
  if (len & 1) sum2 += sum1 += uint32_t(*p) << 8;
  sum1 = (sum1 & 0xffff) + (sum1 >> 16);
  sum2 = (sum2 & 0xffff) + (sum2 >> 16);
  return sum2 << 16 | sum1;
}

// A cursor over the blob: each read checks the bytes left, as libLerc's do.
struct Cursor {
  const uint8_t* p;
  size_t left;
  bool take(size_t n) {
    if (left < n) return false;
    p += n;
    left -= n;
    return true;
  }
};

// BitStuffer2: unsigned values of numBits each, LSB-first in little-endian
// 32-bit words from version 3, MSB-first (the last word's bytes shifted up)
// before it.
bool bit_unstuff(Cursor* c, std::vector<uint32_t>* out, uint32_t count, int bits, int version) {
  if (count == 0 || bits >= 32) return false;
  const uint64_t nuints = (uint64_t(count) * uint64_t(bits) + 31) >> 5, nbytes = nuints * 4;
  const int tail_bits = int((uint64_t(count) * uint64_t(bits)) & 31);
  const int tail_bytes = (tail_bits + 7) >> 3;
  const uint32_t ntbnn = tail_bytes > 0 ? uint32_t(4 - tail_bytes) : 0;
  std::vector<uint32_t> w(size_t(nuints), 0);
  out->assign(count, 0);
  if (version >= 3) {
    const size_t used = size_t(nbytes) - ntbnn;
    if (c->left < used) return false;
    std::memcpy(w.data(), c->p, used);
    const int nb = 32 - bits;
    int pos = 0;
    size_t s = 0;
    for (uint32_t i = 0; i < count; ++i) {
      if (nb - pos >= 0) {
        (*out)[i] = (w[s] << (nb - pos)) >> nb;
        pos += bits;
        if (pos == 32) {
          pos = 0;
          s++;
        }
      } else {
        (*out)[i] = w[s++] >> pos;
        (*out)[i] |= (w[s] << (64 - bits - pos)) >> nb;
        pos -= nb;
      }
    }
    c->take(used);
    return true;
  }
  if (c->left + ntbnn < nbytes) return false;
  const size_t copy = (uint64_t(count) * uint64_t(bits) + 7) / 8;
  std::memcpy(w.data(), c->p, copy);
  for (uint32_t k = ntbnn; k > 0; --k) w[size_t(nuints) - 1] <<= 8;
  int pos = 0;
  size_t s = 0;
  for (uint32_t i = 0; i < count; ++i) {
    if (32 - pos >= bits) {
      (*out)[i] = (w[s] << pos) >> (32 - bits);
      pos += bits;
      if (pos == 32) {
        pos = 0;
        s++;
      }
    } else {
      (*out)[i] = (w[s++] << pos) >> (32 - bits);
      pos -= 32 - bits;
      (*out)[i] |= w[s] >> (32 - pos);
    }
  }
  c->p += copy;
  c->left -= std::min(c->left, copy);
  return true;
}

// BitStuffer2::Decode
bool bit_stuffer_decode(Cursor* c, std::vector<uint32_t>* out, size_t max_count, int version) {
  if (c->left < 1) return false;
  uint8_t head = *c->p;
  c->take(1);
  const int bits67 = head >> 6, nb = bits67 == 0 ? 4 : 3 - bits67;
  const bool lut = head & 0x20;
  const int bits = head & 31;
  if (c->left < size_t(nb)) return false;
  uint32_t count = 0;
  for (int i = 0; i < nb; ++i) count |= uint32_t(c->p[i]) << (8 * i);
  c->take(size_t(nb));
  if (count > max_count) return false;
  if (!lut) {
    if (bits > 0) return bit_unstuff(c, out, count, bits, version);
    out->assign(count, 0);
    return true;
  }
  if (bits == 0 || c->left < 1) return false;
  const int nlut = int(*c->p) - 1;
  c->take(1);
  std::vector<uint32_t> table;
  if (!bit_unstuff(c, &table, uint32_t(nlut), bits, version)) return false;
  int lut_bits = 0;
  while (nlut >> lut_bits) lut_bits++;
  if (lut_bits == 0) return false;
  if (!bit_unstuff(c, out, count, lut_bits, version)) return false;
  table.insert(table.begin(), 0);
  for (uint32_t i = 0; i < count; ++i) {
    if ((*out)[i] >= table.size()) return false;
    (*out)[i] = table[(*out)[i]];
  }
  return true;
}

// Lerc's Huffman: code lengths bit-stuffed, codes MSB-first in 32-bit
// words, a decode table of up to 12 bits and a tree for longer codes.
struct Huffman {
  std::vector<std::pair<uint16_t, uint32_t>> codes;  // (length, code) per symbol
  std::vector<std::pair<int16_t, int16_t>> lut;      // (length, symbol), -1 where absent
  int lut_bits = 0, skip = 0;
  struct Node {
    int16_t value = -1;
    std::unique_ptr<Node> child[2];
  };
  std::unique_ptr<Node> root;

  static int wrap(int i, int size) { return i - (i < size ? 0 : size); }

  bool read_table(Cursor* c, int version) {
    if (c->left < 16) return false;
    const int hver = rd32(c->p), size = rd32(c->p + 4), i0 = rd32(c->p + 8), i1 = rd32(c->p + 12);
    c->take(16);
    if (hver < 2 || i0 >= i1 || i0 < 0 || size < 0 || size > (1 << 15)) return false;
    if (wrap(i0, size) >= size || wrap(i1 - 1, size) >= size) return false;
    std::vector<uint32_t> lens;
    if (!bit_stuffer_decode(c, &lens, size_t(i1 - i0), version) || lens.size() != size_t(i1 - i0)) return false;
    codes.assign(size_t(size), {0, 0});
    for (int i = i0; i < i1; ++i) codes[size_t(wrap(i, size))].first = uint16_t(lens[size_t(i - i0)]);
    // BitUnStuffCodes
    const uint8_t* arr = c->p;
    size_t left = c->left, s = 0;
    int pos = 0;
    for (int i = i0; i < i1; ++i) {
      const int k = wrap(i, size), len = codes[size_t(k)].first;
      if (len == 0) continue;
      if (left < 4 || len > 32) return false;
      uint32_t w = ru32(arr + 4 * s);
      codes[size_t(k)].second = (w << pos) >> (32 - len);
      if (32 - pos >= len) {
        pos += len;
        if (pos == 32) {
          pos = 0;
          s++;
          left -= 4;
        }
      } else {
        pos += len - 32;
        s++;
        left -= 4;
        if (left < 4) return false;
        codes[size_t(k)].second |= ru32(arr + 4 * s) >> (32 - pos);
      }
    }
    size_t len = s * 4 + (pos > 0 ? 4 : 0);
    return c->take(len);
  }

  bool range(int* i0, int* i1, int* max_len) const {
    const int size = int(codes.size());
    if (codes.empty() || size >= (1 << 15)) return false;
    int i = 0;
    while (i < size && codes[size_t(i)].first == 0) i++;
    *i0 = i;
    i = size - 1;
    while (i >= 0 && codes[size_t(i)].first == 0) i--;
    *i1 = i + 1;
    if (*i1 <= *i0) return false;
    int seg_at = 0, seg_len = 0, j = 0;
    while (j < size) {
      while (j < size && codes[size_t(j)].first > 0) j++;
      const int k0 = j;
      while (j < size && codes[size_t(j)].first == 0) j++;
      if (j - k0 > seg_len) {
        seg_at = k0;
        seg_len = j - k0;
      }
    }
    if (size - seg_len < *i1 - *i0) {
      *i0 = seg_at + seg_len;
      *i1 = seg_at + size;
    }
    if (*i1 <= *i0) return false;
    int mx = 0;
    for (int k = *i0; k < *i1; ++k) mx = std::max(mx, int(codes[size_t(wrap(k, size))].first));
    if (mx <= 0 || mx > 32) return false;
    *max_len = mx;
    return true;
  }

  bool build() {
    int i0, i1, max_len;
    if (!range(&i0, &i1, &max_len)) return false;
    const int size = int(codes.size());
    int min_zero = 32;
    const bool tree = max_len > 12;
    lut_bits = std::min(max_len, 12);
    lut.assign(size_t(1) << lut_bits, {-1, -1});
    for (int i = i0; i < i1; ++i) {
      const int k = wrap(i, size), len = codes[size_t(k)].first;
      if (len == 0) continue;
      uint32_t code = codes[size_t(k)].second;
      if (len <= lut_bits) {
        code <<= (lut_bits - len);
        const uint32_t entries = 1u << (lut_bits - len);
        for (uint32_t j = 0; j < entries; ++j) lut[code | j] = {int16_t(len), int16_t(k)};
      } else {
        int shift = 1;
        while (code >>= 1) shift++;
        min_zero = std::min(min_zero, len - shift);
      }
    }
    skip = tree ? min_zero : 0;
    if (!tree) return true;
    root.reset(new Node);
    for (int i = i0; i < i1; ++i) {
      const int k = wrap(i, size), len = codes[size_t(k)].first;
      if (len > 0 && len > lut_bits) {
        const uint32_t code = codes[size_t(k)].second;
        Node* node = root.get();
        int j = len - skip;
        while (--j >= 0) {
          std::unique_ptr<Node>& next = node->child[(code >> j) & 1];
          if (!next) next.reset(new Node);
          node = next.get();
          if (j == 0) node->value = int16_t(k);
        }
      }
    }
    return true;
  }

  // Huffman::DecodeOneValue over 32-bit words at *src
  bool decode(const uint8_t** src, size_t* left, int* pos, int* value) const {
    if (*pos < 0 || *pos > 32 || *left < 4) return false;
    uint32_t w = ru32(*src);
    int v = int((uint64_t(w) << *pos & 0xFFFFFFFFu) >> (32 - lut_bits));
    if (32 - *pos < lut_bits) {
      if (*left < 8) return false;
      v |= int(ru32(*src + 4) >> (64 - *pos - lut_bits));
    }
    if (lut[size_t(v)].first >= 0) {
      *pos += lut[size_t(v)].first;
      *value = lut[size_t(v)].second;
      if (*pos >= 32) {
        *pos -= 32;
        *src += 4;
        *left -= 4;
      }
      return true;
    }
    if (!root) return false;
    *pos += skip;
    if (*pos >= 32) {
      *pos -= 32;
      *src += 4;
      *left -= 4;
    }
    const Node* node = root.get();
    *value = -1;
    while (*value < 0 && *left >= 4) {
      const int bit = int((ru32(*src) << *pos) >> 31);
      if (++*pos == 32) {
        *pos = 0;
        *src += 4;
        *left -= 4;
      }
      node = node->child[bit].get();
      if (!node) return false;
      if (node->value >= 0) *value = node->value;
    }
    return *value >= 0;
  }
};

struct Mask {
  int cols = 0, rows = 0;
  std::vector<uint8_t> bits;
  bool valid(int k) const { return bits[size_t(k) >> 3] & (128 >> (k & 7)); }
};

// Lerc's RLE over the mask's bytes
bool rle_decode(const uint8_t* p, size_t n, uint8_t* out, size_t size) {
  if (n < 2) return false;
  size_t left = n - 2, at = 0;
  auto count = [&]() {
    int16_t c;
    std::memcpy(&c, p, 2);
    p += 2;
    return c;
  };
  int16_t cnt = count();
  while (cnt != -32768) {
    const int i = cnt <= 0 ? -cnt : cnt;
    const size_t m = cnt <= 0 ? 1 : size_t(i);
    if (left < m + 2 || at + size_t(i) > size) return false;
    left -= m + 2;
    if (cnt > 0) {
      std::memcpy(out + at, p, size_t(i));
      p += i;
    } else {
      std::memset(out + at, *p++, size_t(i));
    }
    at += size_t(i);
    cnt = count();
  }
  return true;
}

double read_variable(const uint8_t* p, int dt) {
  switch (dt) {
    case DT_CHAR: return double(int8_t(p[0]));
    case DT_BYTE: return double(p[0]);
    case DT_SHORT: { int16_t v; std::memcpy(&v, p, 2); return v; }
    case DT_USHORT: { uint16_t v; std::memcpy(&v, p, 2); return v; }
    case DT_INT: { int32_t v; std::memcpy(&v, p, 4); return v; }
    case DT_UINT: { uint32_t v; std::memcpy(&v, p, 4); return v; }
    case DT_FLOAT: { float v; std::memcpy(&v, p, 4); return v; }
    case DT_DOUBLE: return rdd(p);
    default: return 0;
  }
}
int type_size(int dt) {
  return dt == DT_BYTE || dt == DT_CHAR ? 1 : dt == DT_SHORT || dt == DT_USHORT ? 2
         : dt == DT_INT || dt == DT_UINT || dt == DT_FLOAT ? 4 : dt == DT_DOUBLE ? 8 : 0;
}

struct Decoder {
  Header h;
  Mask mask;
  std::vector<double> zmin, zmax;
  int mode = IEM_TILING;

  // GetDataTypeUsed: the type of a block's offset
  static int type_used(int dt, int tc) {
    switch (dt) {
      case DT_SHORT: case DT_INT: return dt - tc;
      case DT_USHORT: case DT_UINT: return dt - 2 * tc;
      case DT_FLOAT: return tc == 0 ? dt : tc == 1 ? DT_SHORT : DT_BYTE;
      case DT_DOUBLE: return tc == 0 ? dt : dt - 2 * tc + 1;
      default: return dt;
    }
  }

  template <class T>
  bool fill_const(T* data) const {
    const T z0 = to_int<T>(h.z_min);
    std::vector<T> buf(size_t(h.depth), z0);
    if (h.depth > 1 && h.z_min != h.z_max) {
      if (int(zmin.size()) != h.depth) return false;
      for (int m = 0; m < h.depth; ++m) buf[size_t(m)] = to_int<T>(zmin[size_t(m)]);
    }
    for (int k = 0; k < h.rows * h.cols; ++k)
      if (mask.valid(k)) std::memcpy(data + size_t(k) * size_t(h.depth), buf.data(), sizeof(T) * size_t(h.depth));
    return true;
  }

  template <class T>
  bool read_tile(Cursor* c, T* data, int i0, int i1, int j0, int j1, int idepth, std::vector<uint32_t>* buf) const {
    if (c->left < 1) return false;
    uint8_t flag = *c->p;
    c->take(1);
    const int bits67 = flag >> 6;
    bool diff = false;
    if (h.version >= 5) {  // bit 2 the difference to the depth before, bits 3-5 the check
      diff = (flag >> 2) & 1;
      if (((flag >> 3) & 7) != ((j0 >> 4) & 7)) return false;
      if (diff && idepth == 0) return false;
    } else if (((flag >> 2) & 15) != ((j0 >> 3) & 15)) {
      return false;
    }
    flag &= 3;
    const int nc = h.cols, nd = h.depth;
    if (flag == 2) {  // constant 0 (the depth before, for differences)
      for (int i = i0; i < i1; ++i)
        for (int j = j0, k = i * nc + j0; j < j1; ++j, ++k)
          if (mask.valid(k)) {
            const size_t m = size_t(k) * size_t(nd) + size_t(idepth);
            data[m] = diff ? data[m - 1] : T(0);
          }
      return true;
    }
    if (flag == 0) {  // raw binary
      if (diff) return false;
      for (int i = i0; i < i1; ++i)
        for (int j = j0, k = i * nc + j0; j < j1; ++j, ++k)
          if (mask.valid(k)) {
            if (c->left < sizeof(T)) return false;
            std::memcpy(&data[size_t(k) * size_t(nd) + size_t(idepth)], c->p, sizeof(T));
            c->take(sizeof(T));
          }
      return true;
    }
    const int dt_used = type_used(diff && h.dt < DT_INT ? int(DT_INT) : h.dt, bits67);  // differences are signed
    if (dt_used == DT_UNDEFINED) return false;
    const size_t n = size_t(type_size(dt_used));
    if (c->left < n) return false;
    const double offset = read_variable(c->p, dt_used);
    c->take(n);
    if (flag == 3) {  // constant offset
      for (int i = i0; i < i1; ++i)
        for (int j = j0, k = i * nc + j0; j < j1; ++j, ++k)
          if (mask.valid(k)) {
            const size_t m = size_t(k) * size_t(nd) + size_t(idepth);
            data[m] = diff ? to_int<T>(offset + double(data[m - 1])) : to_int<T>(offset);
          }
      return true;
    }
    const size_t max_count = size_t(i1 - i0) * size_t(j1 - j0);
    if (!bit_stuffer_decode(c, buf, max_count, h.version)) return false;
    const double inv_scale = 2 * h.max_z_error;
    const double zmx = (h.depth > 1 && idepth < int(zmax.size())) ? zmax[size_t(idepth)] : h.z_max;
    size_t at = 0;
    if (buf->size() != max_count) {
      if (h.version > 2) {
        size_t valid = 0;
        for (int i = i0; i < i1; ++i)
          for (int j = j0, k = i * nc + j0; j < j1; ++j, ++k) valid += mask.valid(k);
        if (valid != buf->size()) return false;
      }
    }
    const bool all = buf->size() == max_count;
    for (int i = i0; i < i1; ++i)
      for (int j = j0, k = i * nc + j0; j < j1; ++j, ++k) {
        if (!all && !mask.valid(k)) continue;
        if (at >= buf->size()) return false;
        const size_t m = size_t(k) * size_t(nd) + size_t(idepth);
        double z = offset + double((*buf)[at++]) * inv_scale;
        if (diff) z += double(data[m - 1]);
        data[m] = to_int<T>(std::min(z, zmx));
      }
    return true;
  }

  template <class T>
  bool read_tiles(Cursor* c, T* data) const {
    const int mb = h.mb_size;
    if (mb > 32) return false;
    const int tiles_v = (h.rows + mb - 1) / mb, tiles_h = (h.cols + mb - 1) / mb;
    std::vector<uint32_t> buf;
    for (int it = 0; it < tiles_v; ++it) {
      const int i0 = it * mb, th = it == tiles_v - 1 ? h.rows - i0 : mb;
      for (int jt = 0; jt < tiles_h; ++jt) {
        const int j0 = jt * mb, tw = jt == tiles_h - 1 ? h.cols - j0 : mb;
        for (int d = 0; d < h.depth; ++d)
          if (!read_tile(c, data, i0, i0 + th, j0, j0 + tw, d, &buf)) return false;
      }
    }
    return true;
  }

  template <class T>
  bool decode_huffman(Cursor* c, T* data) const {
    Huffman hf;
    if (!hf.read_table(c, h.version) || !hf.build()) return false;
    const int offset = h.dt == DT_CHAR ? 128 : 0;
    const int w = h.cols, ht = h.rows, nd = h.depth;
    const uint8_t* arr = c->p;
    const uint8_t* arr0 = arr;
    size_t left = c->left;
    int pos = 0;
    const bool all = h.valid == w * ht;
    if (mode == IEM_HUFFMAN) {  // the values as they lie, depths interleaved
      for (int k = 0; k < w * ht; ++k) {
        if (!all && !mask.valid(k)) continue;
        for (int d = 0; d < nd; ++d) {
          int val = 0;
          if (!hf.decode(&arr, &left, &pos, &val)) return false;
          data[size_t(k) * size_t(nd) + size_t(d)] = T(val - offset);
        }
      }
    } else {  // each depth in turn, from its left (or upper) neighbour
      for (int d = 0; d < nd; ++d) {
        T prev = 0;
        for (int i = 0, k = 0; i < ht; ++i)
          for (int j = 0; j < w; ++j, ++k) {
            if (!all && !mask.valid(k)) continue;
            const size_t m = size_t(k) * size_t(nd) + size_t(d);
            int val = 0;
            if (!hf.decode(&arr, &left, &pos, &val)) return false;
            T delta = T(val - offset);
            if (j > 0 && (all || mask.valid(k - 1))) delta = T(delta + prev);
            else if (i > 0 && (all || mask.valid(k - w))) delta = T(delta + data[m - size_t(w) * size_t(nd)]);
            else delta = T(delta + prev);
            data[m] = prev = delta;
          }
      }
    }
    const size_t len = size_t(arr - arr0) + 4 * size_t((pos > 0 ? 1 : 0) + 1);
    return c->take(len);
  }

  template <class T>
  bool decode(const uint8_t* blob, size_t n, T* data, uint8_t* mask_out) {
    Cursor c{blob, n};
    const size_t hs = read_header(blob, n, &h);
    if (!hs || n < size_t(h.blob_size)) return false;
    if (h.version >= 3) {
      const int skip = 14;  // the key, the version and the checksum
      if (h.blob_size < skip || fletcher32(blob + skip, size_t(h.blob_size - skip)) != h.checksum) return false;
    }
    c.take(hs);
    // Lerc2::ReadMask
    if (c.left < 4) return false;
    const int mask_bytes = rd32(c.p);
    c.take(4);
    const int64_t pixels = int64_t(h.cols) * h.rows;
    if ((h.valid == 0 || h.valid == pixels) && mask_bytes != 0) return false;
    mask.cols = h.cols;
    mask.rows = h.rows;
    mask.bits.assign(size_t((pixels + 7) / 8), 0);
    if (h.valid == pixels) {
      std::fill(mask.bits.begin(), mask.bits.end(), 0xFF);
    } else if (h.valid != 0) {
      if (mask_bytes <= 0) return false;  // "use the previous mask": none in a fresh decoder
      if (c.left < size_t(mask_bytes) || !rle_decode(c.p, c.left, mask.bits.data(), mask.bits.size())) return false;
      c.take(size_t(mask_bytes));
    }
    if (mask_out)
      for (int64_t k = 0; k < pixels; ++k) mask_out[k] = mask.valid(int(k)) ? 1 : 0;
    std::memset(data, 0, size_t(pixels) * size_t(h.depth) * sizeof(T));
    if (h.valid == 0) return true;
    if (h.z_min == h.z_max) return fill_const(data);
    if (h.version >= 4) {  // ReadMinMaxRanges
      const size_t len = size_t(h.depth) * sizeof(T);
      if (c.left < 2 * len) return false;
      zmin.resize(size_t(h.depth));
      zmax.resize(size_t(h.depth));
      for (int d = 0; d < h.depth; ++d) {
        T a, b;
        std::memcpy(&a, c.p + size_t(d) * sizeof(T), sizeof(T));
        std::memcpy(&b, c.p + len + size_t(d) * sizeof(T), sizeof(T));
        zmin[size_t(d)] = double(a);
        zmax[size_t(d)] = double(b);
      }
      c.take(2 * len);
      bool same = true;
      for (int d = 0; d < h.depth; ++d) same &= zmin[size_t(d)] == zmax[size_t(d)];
      if (same) return fill_const(data);
    }
    if (c.left < 1) return false;
    const uint8_t one_sweep = *c.p;
    c.take(1);
    if (one_sweep) {  // ReadDataOneSweep: the valid pixels' values, raw
      size_t valid = 0;
      for (int64_t k = 0; k < pixels; ++k) valid += mask.valid(int(k));
      const size_t len = size_t(h.depth) * sizeof(T);
      if (c.left < valid * len) return false;
      const uint8_t* p = c.p;
      for (int64_t k = 0; k < pixels; ++k)
        if (mask.valid(int(k))) {
          std::memcpy(data + size_t(k) * size_t(h.depth), p, len);
          p += len;
        }
      return true;
    }
    if (h.version >= 2 && (h.dt == DT_CHAR || h.dt == DT_BYTE) && h.max_z_error == 0.5) {
      if (c.left < 1) return false;
      mode = *c.p;
      c.take(1);
      if (mode > IEM_HUFFMAN) return false;
      if (mode == IEM_DELTA_HUFFMAN || (h.version >= 4 && mode == IEM_HUFFMAN)) return decode_huffman(&c, data);
    }
    return read_tiles(&c, data);
  }
};

}  // namespace

bool lerc_info(const uint8_t* src, size_t n, LercInfo* info) {
  Header h;
  if (!read_header(src, n, &h) || size_t(h.blob_size) > n) return false;
  info->version = h.version;
  info->data_type = h.dt;
  info->depth = h.depth;
  info->cols = h.cols;
  info->rows = h.rows;
  info->valid = h.valid;
  info->bands = 1;
  info->blob_size = uint32_t(h.blob_size);
  // further bands: another blob of the same shape right after this one
  size_t at = size_t(h.blob_size);
  while (at < n) {
    Header next;
    if (!read_header(src + at, n - at, &next)) break;
    if (next.cols != h.cols || next.rows != h.rows || next.depth != h.depth || next.dt != h.dt) return false;
    if (size_t(next.blob_size) > n - at) return false;
    info->bands++;
    info->blob_size += uint32_t(next.blob_size);
    at += size_t(next.blob_size);
  }
  return true;
}

bool lerc_decode(const uint8_t* src, size_t n, int depth, int cols, int rows, int data_type, uint8_t* out,
                 uint8_t* mask) {
  Header h;
  if (!read_header(src, n, &h) || h.depth != depth || h.cols != cols || h.rows != rows || h.dt != data_type ||
      h.pass_nodata)
    return false;
  if (!mask && int64_t(h.valid) != int64_t(h.cols) * h.rows) return false;  // invalid pixels need a mask
  Decoder d;
  switch (data_type) {
    case DT_CHAR: return d.decode(src, n, reinterpret_cast<int8_t*>(out), mask);
    case DT_BYTE: return d.decode(src, n, out, mask);
    case DT_SHORT: return d.decode(src, n, reinterpret_cast<int16_t*>(out), mask);
    case DT_USHORT: return d.decode(src, n, reinterpret_cast<uint16_t*>(out), mask);
    default: return false;
  }
}

}  // namespace aq

extern "C" {

// lerc_getBlobInfo's first eight values and lerc_decode alone (tests): 1
// where libLerc's calls succeed.
int aq_lerc_info(const uint8_t* src, long n, uint32_t* info) {
  aq::LercInfo i;
  if (!aq::lerc_info(src, size_t(n), &i)) return 0;
  const uint32_t v[8] = {uint32_t(i.version), uint32_t(i.data_type), uint32_t(i.depth), uint32_t(i.cols),
                         uint32_t(i.rows), uint32_t(i.bands), uint32_t(i.valid), i.blob_size};
  std::memcpy(info, v, sizeof(v));
  return 1;
}

int aq_lerc_decode(const uint8_t* src, long n, int depth, int cols, int rows, int data_type, uint8_t* out,
                   uint8_t* mask) {
  return aq::lerc_decode(src, size_t(n), depth, cols, rows, data_type, out, mask) ? 1 : 0;
}

}  // extern "C"
