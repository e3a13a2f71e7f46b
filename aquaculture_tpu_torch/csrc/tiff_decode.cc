// The device loader's TIFF reader, without libtiff: the pixels that
// libtiff 4.5.0's TIFFReadRGBAImageOriented(..., ORIENTATION_TOPLEFT, 0)
// gives (the JAX package's tileloader.cc), byte for byte, as RGB.
//
// - The container: II and MM, classic (42) and BigTIFF (43); the first IFD
//   only, as the RGBA interface reads it; strips and tiles, PlanarConfig 1
//   and 2, FillOrder 2 (the raw bytes bit-reversed before decoding, as
//   TIFFFillStrip does).
// - The codecs, here and linking nothing: none, PackBits (tif_packbits.c),
//   LZW (tif_lzw.c, with the old-style bit-reversed codes of LZW_COMPAT),
//   Deflate 8 and 32946 (an RFC 1950/1951 inflate, tif_zip.c's framing,
//   libdeflate 1.14's stopping point and fast-loop overrun), WebP 50001
//   (webp_decode.cc, tif_webp.c's framing), NeXT 32766, ThunderScan 32809,
//   PixarLog 32909 (the same inflate at zlib's stopping point) and SGILog
//   34676/34677 (tiff_legacy.cc), JBIG 34661 (jbig_decode.cc: jbigkit's
//   decoder, one layer and one plane), ZSTD 50000 (zstd_decode.cc,
//   tif_zstd.c's loop), LERC 34887 (lerc_decode.cc, tif_lerc.c's checks,
//   bare or in its Deflate or ZSTD wrapper); Predictor 2 at 8 and 16 bits
//   (tif_predict.c); 16-bit samples in the host's order after decoding
//   (_TIFFSwab16BitData).
// - TIFFReadDirectory's StripByteCounts rules: missing, they are estimated
//   or the file refused (estimate_counts); short ones repaired, one
//   uncompressed strip chopped (repair_strips, chop_strip).
// - tif_getimage.c's checks (TIFFRGBAImageOK, TIFFRGBAImageBegin,
//   PickContigCase, PickSeparateCase) and its put routines: min-is-black
//   and min-is-white at 1, 2, 4, 8 and 16 bits, palette at 1, 2, 4 and 8
//   (checkcmap's 8- or 16-bit colormaps), RGB at 8 and 16 bits with
//   associated, unassociated or unspecified alpha, separated CMYK at 8,
//   YCbCr at 8 with sampling 1, 2 or 4 through TIFFYCbCrToRGBInit's tables,
//   CIELab at 8 and 16 through TIFFCIELabToRGBInit's, contiguous or planar
//   as libtiff takes each; the strip and tile walks of gtStripContig,
//   gtTileContig, gtStripSeparate and gtTileSeparate, with their error
//   handling at stop_on_error 0 (a first segment that cannot be read fails
//   the image; a later one leaves the buffer as it was); setorientation's
//   flips, which never transpose (5-8 read as 1-4).
// - JPEG (compression 7): each strip or tile an abbreviated JPEG stream with
//   the tables of JPEGTables (tif_jpeg.c), entropy-decoded here by
//   jpeg_entropy.cc and reconstructed by the decode kernel: libtiff decodes
//   YCbCr through libjpeg's colour conversion (JPEGCOLORMODE_RGB), and RGB
//   and grey as the components are (JCS_UNKNOWN).
// Routing is by the tags and the data: what the RGBA interface refuses is
// TIFF_SKIP; what libtiff decodes with a codec this reader does not have
// (CCITT, old JPEG, LZMA, and JBIG of several resolution layers or bit
// planes), or a JPEG layout the kernel does not take (planar, CMYK, alpha,
// min-is-white), is TIFF_PIL.

#include "tiff_decode.h"
#include "jbig_decode.h"
#include "lerc_decode.h"
#include "tiff_legacy.h"
#include "webp_decode.h"
#include "zstd_decode.h"

#include <algorithm>
#include <cmath>
#include <cstring>
#include <map>

namespace aq {
namespace {

enum Tag : uint16_t {
  TAG_WIDTH = 256, TAG_LENGTH = 257, TAG_BPS = 258, TAG_COMPRESSION = 259, TAG_PHOTOMETRIC = 262,
  TAG_FILLORDER = 266, TAG_STRIP_OFFSETS = 273, TAG_ORIENTATION = 274, TAG_SPP = 277, TAG_RPS = 278,
  TAG_STRIP_COUNTS = 279, TAG_PLANAR = 284, TAG_PREDICTOR = 317, TAG_WHITEPOINT = 318,
  TAG_COLORMAP = 320, TAG_TILE_W = 322, TAG_TILE_H = 323, TAG_TILE_OFFSETS = 324, TAG_TILE_COUNTS = 325,
  TAG_INKSET = 332, TAG_EXTRASAMPLES = 338, TAG_SAMPLEFORMAT = 339, TAG_JPEGTABLES = 347,
  TAG_YCC_COEFS = 529, TAG_YCC_SUB = 530, TAG_REFBW = 532, TAG_LERC_PARAMETERS = 50674,
};
enum Photometric {
  PH_MINISWHITE = 0, PH_MINISBLACK = 1, PH_RGB = 2, PH_PALETTE = 3, PH_SEPARATED = 5, PH_YCBCR = 6,
  PH_CIELAB = 8, PH_LOGL = 32844, PH_LOGLUV = 32845,
};
enum Compression {
  CMP_NONE = 1, CMP_LZW = 5, CMP_JPEG = 7, CMP_DEFLATE = 8, CMP_DEFLATE_OLD = 32946, CMP_PACKBITS = 32773,
  CMP_NEXT = 32766, CMP_THUNDER = 32809, CMP_PIXARLOG = 32909, CMP_SGILOG = 34676, CMP_SGILOG24 = 34677,
  CMP_JBIG = 34661, CMP_WEBP = 50001, CMP_LERC = 34887, CMP_LZMA = 34925, CMP_ZSTD = 50000,
};
enum Alpha { ALPHA_NONE = 0, ALPHA_ASSOC = 1, ALPHA_UNASSOC = 2 };

// Compressions libtiff 4.5.0 decodes that this reader does not: CCITT
// (2, 3, 4, RLE-W), old JPEG, LZMA.
bool pil_compression(int c) {
  switch (c) {
    case 2: case 3: case 4: case 32771: case 6: case 34925:
      return true;
    default:
      return false;
  }
}

int type_size(int type) {
  static const int sizes[19] = {0, 1, 1, 2, 4, 8, 1, 1, 2, 4, 8, 4, 8, 4, 0, 0, 8, 8, 8};
  return type >= 0 && type < 19 ? sizes[type] : 0;
}

constexpr uint64_t kBad = ~uint64_t(0);

// The first IFD's entries over the file's bytes.
struct Ifd {
  const uint8_t* d = nullptr;
  size_t n = 0;
  bool le = true, big = false;
  struct Entry {
    int type = 0;
    uint64_t count = 0, at = kBad;  // at: where the values lie, kBad outside the file
  };
  std::map<int, Entry> tags;
  uint64_t entries = 0;       // the IFD's entry count
  uint64_t out_of_line = 0;   // the bytes of the values that do not fit in their entries
  bool unknown_type = false;  // an entry of a type libtiff has no width for

  uint64_t rd(uint64_t o, int size) const {
    uint64_t v = 0;
    for (int i = 0; i < size; ++i) v |= uint64_t(d[o + (le ? i : size - 1 - i)]) << (8 * i);
    return v;
  }

  bool parse() {
    if (n < 8 || !((d[0] == 'I' && d[1] == 'I') || (d[0] == 'M' && d[1] == 'M'))) return false;
    le = d[0] == 'I';
    const uint64_t magic = rd(2, 2);
    uint64_t off;
    if (magic == 42) {
      off = rd(4, 4);
    } else if (magic == 43) {  // BigTIFF: offset size 8, a zero, an 8-byte offset
      if (n < 16 || rd(4, 2) != 8 || rd(6, 2) != 0) return false;
      big = true;
      off = rd(8, 8);
    } else {
      return false;
    }
    const uint64_t head = big ? 8 : 2, ent = big ? 20 : 12, inl = big ? 8 : 4;
    if (off < 8 || off > n || n - off < head) return false;
    const uint64_t count = rd(off, int(head));
    if (count == 0 || count > 4096 || (n - off - head) / ent < count) return false;  // tif_dirread.c's sanity limit
    entries = count;
    for (uint64_t i = 0; i < count; ++i) {
      const uint64_t p = off + head + i * ent;
      const int tag = int(rd(p, 2));
      Entry e;
      e.type = int(rd(p + 2, 2));
      e.count = rd(p + 4, big ? 8 : 4);
      const int sz = type_size(e.type);
      unknown_type |= sz == 0;
      if (sz && e.count > inl / uint64_t(sz)) out_of_line += std::min<uint64_t>(e.count, uint64_t(1) << 48) * uint64_t(sz);
      if (sz == 0 || e.count > (uint64_t(1) << 40)) continue;  // an unknown type: the tag is ignored
      const uint64_t bytes = e.count * uint64_t(sz), vp = p + (big ? 12 : 8);
      const uint64_t at = bytes <= inl ? vp : rd(vp, int(inl));
      e.at = at <= n && bytes <= n - at ? at : kBad;
      tags.emplace(tag, e);  // the first of duplicates
    }
    return true;
  }

  const Entry* find(int tag) const {
    auto it = tags.find(tag);
    return it == tags.end() || it->second.at == kBad || it->second.count == 0 ? nullptr : &it->second;
  }

  // Integer values (BYTE .. LONG8, signed read as stored).
  bool uints(int tag, std::vector<uint64_t>* v) const {
    const Entry* e = find(tag);
    if (!e) return false;
    switch (e->type) {
      case 1: case 3: case 4: case 6: case 7: case 8: case 9: case 13: case 16: case 17: case 18: break;
      default: return false;
    }
    const int sz = type_size(e->type);
    v->resize(size_t(e->count));
    for (uint64_t i = 0; i < e->count; ++i) (*v)[i] = rd(e->at + i * uint64_t(sz), sz);
    return true;
  }

  uint64_t uint1(int tag, uint64_t dflt) const {
    std::vector<uint64_t> v;
    return uints(tag, &v) ? v[0] : dflt;
  }

  // Values as libtiff's float fields take them (TIFFReadDirEntryFloatArray).
  bool floats(int tag, std::vector<float>* v) const {
    const Entry* e = find(tag);
    if (!e) return false;
    const int sz = type_size(e->type);
    v->resize(size_t(e->count));
    for (uint64_t i = 0; i < e->count; ++i) {
      const uint64_t o = e->at + i * uint64_t(sz);
      float f;
      switch (e->type) {
        case 5: {
          const uint32_t a = uint32_t(rd(o, 4)), b = uint32_t(rd(o + 4, 4));
          f = b == 0 ? 0.0f : float(double(a) / double(b));
          break;
        }
        case 10: {
          const int32_t a = int32_t(rd(o, 4)), b = int32_t(rd(o + 4, 4));
          f = b == 0 ? 0.0f : float(double(a) / double(b));
          break;
        }
        case 11: {
          const uint32_t bits = uint32_t(rd(o, 4));
          std::memcpy(&f, &bits, 4);
          break;
        }
        case 12: {
          const uint64_t bits = rd(o, 8);
          double x;
          std::memcpy(&x, &bits, 8);
          f = x > 3.4028234663852886e38 ? 3.4028234663852886e38f
              : x < -3.4028234663852886e38 ? -3.4028234663852886e38f : float(x);
          break;
        }
        case 1: case 3: case 4: case 16: f = float(rd(o, sz)); break;
        case 6: f = float(int8_t(rd(o, 1))); break;
        case 8: f = float(int16_t(rd(o, 2))); break;
        case 9: f = float(int32_t(rd(o, 4))); break;
        case 17: f = float(int64_t(rd(o, 8))); break;
        default: return false;
      }
      (*v)[i] = f;
    }
    return true;
  }
};

// ---------------------------------------------------------------- codecs

// tif_packbits.c's PackBitsDecode: true when occ bytes came out.
bool unpack_bits(const uint8_t* bp, size_t cc, uint8_t* op, size_t occ) {
  while (cc > 0 && occ > 0) {
    long n = long(int8_t(*bp++));
    cc--;
    if (n < 0) {
      if (n == -128) continue;
      n = -n + 1;
      if (size_t(n) > occ) n = long(occ);
      if (cc == 0) break;
      occ -= size_t(n);
      const uint8_t b = *bp++;
      cc--;
      std::memset(op, b, size_t(n));
      op += n;
    } else {
      if (occ < size_t(n + 1)) n = long(occ) - 1;
      if (cc < size_t(n + 1)) break;
      ++n;
      std::memcpy(op, bp, size_t(n));
      op += n;
      occ -= size_t(n);
      bp += n;
      cc -= size_t(n);
    }
  }
  return occ == 0;
}

// tif_lzw.c's decoders: MSB-first codes whose width grows one code early
// (LZWDecode), or the old-style LSB-first ones that grow on time
// (LZWDecodeCompat), picked by the first strip's first two bytes.
enum LzwMode { LZW_UNSET = 0, LZW_NEW, LZW_COMPAT };
constexpr int kLzwCodes = 4095 + 1024;  // CSIZE: libtiff's table tolerates codes past 4095

bool lzw_decode(const uint8_t* bp, size_t cc, uint8_t* op, size_t occ, bool compat) {
  struct Code {
    int prev;  // -1: none
    uint16_t length;
    uint8_t value, first;
  };
  std::vector<Code> tab(kLzwCodes);
  for (int i = 0; i < 256; ++i) tab[i] = {-1, 1, uint8_t(i), uint8_t(i)};
  auto reset = [&]() {
    for (int i = 256; i < kLzwCodes; ++i) tab[i] = {-1, 0, 0, 0};
  };
  reset();
  int nbits = 9, free_ent = 258, maxcode = compat ? 511 : 510, old = -1;
  uint64_t bitsleft = uint64_t(cc) * 8;
  uint64_t nextdata = 0;
  int nextbits = 0;
  auto next = [&](int* code) {
    if (bitsleft < uint64_t(nbits)) return false;  // the strip's end reads as EOI
    if (compat) {
      while (nextbits < nbits) {
        nextdata |= uint64_t(*bp++) << nextbits;
        nextbits += 8;
      }
      *code = int(nextdata & ((1u << nbits) - 1));
      nextdata >>= nbits;
    } else {
      while (nextbits < nbits) {
        nextdata = (nextdata << 8) | *bp++;
        nextbits += 8;
      }
      *code = int((nextdata >> (nextbits - nbits)) & ((1u << nbits) - 1));
    }
    nextbits -= nbits;
    bitsleft -= uint64_t(nbits);
    return true;
  };
  while (occ > 0) {
    int code;
    if (!next(&code) || code == 257) break;
    if (code == 256) {
      do {
        reset();
        free_ent = 258;
        nbits = 9;
        maxcode = compat ? 511 : 510;
        if (!next(&code)) code = 257;
      } while (!compat && code == 256);
      if (code == 257) break;
      if (code > 256) return false;  // "Corrupted LZW table"
      *op++ = uint8_t(code);
      occ--;
      old = code;
      continue;
    }
    if (free_ent >= kLzwCodes || old < 0) return false;
    Code& e = tab[free_ent];
    e.prev = old;
    e.first = tab[old].first;
    e.length = uint16_t(tab[old].length + 1);
    e.value = code < free_ent ? tab[code].first : e.first;
    if (++free_ent > maxcode) {
      if (++nbits > 12) nbits = 12;
      maxcode = compat ? (1 << nbits) - 1 : (1 << nbits) - 2;
    }
    old = code;
    if (code >= 256) {
      const Code& c = tab[code];
      if (c.length == 0) return false;  // "Wrong length of decoded string"
      // written back to front; a string longer than the room left is cut to
      // its first occ bytes
      const size_t len = c.length;
      int at = code;
      size_t skip = len > occ ? len - occ : 0;
      const size_t put = len - skip;
      uint8_t* end = op + put;
      for (size_t i = 0; i < len; ++i) {
        const Code& k = tab[at];
        if (i >= skip) *--end = k.value;
        at = k.prev;
        if (at < 0 && i + 1 < len) return false;
      }
      op += put;
      occ -= put;
    } else {
      *op++ = uint8_t(code);
      occ--;
    }
  }
  return occ == 0;
}

// The bits of a deflate stream: past the end of its input, zero bytes (as
// libdeflate reads them; Libdeflate below counts them against its limit),
// or strict, as zlib reads them: a read past the end stalls the stream.
struct Inflate {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t bitbuf = 0;
  int bitcnt = 0;
  uint64_t used = 0;  // bits consumed
  bool strict = false, stalled = false;

  int bits(int need) {
    if (strict && (stalled || uint64_t(bitcnt) + 8 * uint64_t(end - p) < uint64_t(need))) {
      stalled = true;
      return 0;
    }
    while (bitcnt < need) {
      bitbuf |= uint64_t(p < end ? *p++ : 0) << bitcnt;
      bitcnt += 8;
    }
    const int v = int(bitbuf & ((uint64_t(1) << need) - 1));
    bitbuf >>= need;
    bitcnt -= need;
    used += uint64_t(need);
    return v;
  }

  struct Huffman {
    int16_t count[16];
    int16_t symbol[320];
    int maxlen = 15;     // the longest code
    bool empty = false;  // no codes at all
  };

  // Canonical codes from lengths; false for an over-subscribed set, or an
  // incomplete one but for a single code (as zlib refuses them). zlib_codes:
  // the code-length code as zlib's inflate_table(CODES) takes it, where no
  // codes at all pass and an incomplete set does not.
  static bool build(Huffman* h, const uint8_t* length, int n, bool lit, bool zlib_codes = false) {
    std::fill(h->count, h->count + 16, 0);
    for (int s = 0; s < n; ++s) h->count[length[s]]++;
    h->empty = h->count[0] == n;
    h->maxlen = 0;
    for (int len = 1; len < 16; ++len)
      if (h->count[len]) h->maxlen = len;
    if (h->empty) return !lit || zlib_codes;  // no codes: fine for distances alone
    int left = 1;
    for (int len = 1; len < 16; ++len) {
      left <<= 1;
      left -= h->count[len];
      if (left < 0) return false;
    }
    int16_t offs[16];
    offs[1] = 0;
    for (int len = 1; len < 15; ++len) offs[len + 1] = int16_t(offs[len] + h->count[len]);
    for (int s = 0; s < n; ++s)
      if (length[s] != 0) h->symbol[offs[length[s]]++] = int16_t(s);
    if (left > 0) {
      int codes = 0;
      for (int len = 1; len < 16; ++len) codes += h->count[len];
      if (zlib_codes || !(codes == 1 && h->count[1] == 1)) return false;
    }
    return true;
  }

  // A symbol, or -2 for a code outside the set, found as zlib finds it:
  // after the longest code's bits; a set of no codes takes one bit.
  int decode(const Huffman& h) {
    if (h.empty) {
      bits(1);
      return -2;
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= h.maxlen; ++len) {
      code |= bits(1);
      const int count = h.count[len];
      if (code - count < first) return h.symbol[index + (code - first)];
      index += count;
      first += count;
      first <<= 1;
      code <<= 1;
    }
    return -2;
  }
};

// libdeflate 1.14's libdeflate_zlib_decompress(_ex) on x86-64, as tif_zip.c
// and tif_lerc.c call it. Its bit reader and the points where it refills
// (REFILL_BITS: past the data it reads zero bytes, and fails on the ninth),
// its decode tables' rules (an empty code reads as symbol 0, one code of
// length 1 takes both codewords, any other incomplete code fails; no
// end-of-block code is required; litlen 286-287 and offsets 30-31 read as
// their neighbours), and its fast loop: while the input is 25 bytes from
// its end and the output 299, it decodes in iterations of up to three
// literals or two and a match, and copies a match by whole words past its
// end (libdeflate's intentional overrun). Where the stream then fails,
// those bytes stay in the output as libtiff's buffer keeps them.
enum LdResult { LD_SUCCESS = 0, LD_BAD_DATA = 1, LD_SHORT_OUTPUT = 2, LD_INSUFFICIENT_SPACE = 3 };

struct Libdeflate {
  Inflate s;
  uint64_t kd = 0, L = 0, ovr = 0;  // the data's bytes; bytes loaded into the bit buffer; zero bytes past the data

  uint64_t bitsleft() const { return 8 * (L + ovr) - s.used; }
  // REFILL_BITS: whole words while 8 bytes remain, else a byte at a time
  bool refill() {
    if (kd - L >= 8) {
      L = (s.used + 7) / 8 + 7;
      return true;
    }
    while (bitsleft() < 56) {
      if (L < kd) ++L;
      else if (++ovr > 8) return false;
    }
    return true;
  }

  struct Code {
    Inflate::Huffman h;
    int single = -1;  // an empty code (symbol 0) or one code of length 1: every codeword its symbol
  };
  static bool build(Code* c, const uint8_t* len, int n) {
    Inflate::Huffman& h = c->h;
    std::fill(h.count, h.count + 16, 0);
    for (int i = 0; i < n; ++i) h.count[len[i]]++;
    int left = 1, used = 0;
    for (int l = 1; l < 16; ++l) {
      left <<= 1;
      left -= h.count[l];
      if (left < 0) return false;
      used += h.count[l];
    }
    c->single = -1;
    if (left > 0) {
      if (used == 0) {
        c->single = 0;
        return true;
      }
      if (used != 1 || h.count[1] != 1) return false;
      for (int i = 0; i < n; ++i)
        if (len[i]) c->single = i;
      return true;
    }
    int16_t offs[16];
    offs[1] = 0;
    for (int l = 1; l < 15; ++l) offs[l + 1] = int16_t(offs[l] + h.count[l]);
    for (int i = 0; i < n; ++i)
      if (len[i]) h.symbol[offs[len[i]]++] = int16_t(i);
    return true;
  }
  // a symbol of a built code; *bits its codeword's length
  int decode(const Code& c, int* bits) {
    if (c.single >= 0) {
      s.bits(1);
      *bits = 1;
      return c.single;
    }
    int code = 0, first = 0, index = 0;
    for (int l = 1; l < 16; ++l) {
      code |= s.bits(1);
      const int count = c.h.count[l];
      if (code - count < first) {
        *bits = l;
        return c.h.symbol[index + (code - first)];
      }
      index += count;
      first += count;
      first <<= 1;
      code <<= 1;
    }
    return -1;  // not reached: a complete code decodes every codeword
  }

  // The deflate data of kd bytes at data into out[0, occ): *got the bytes
  // written by sequential output (the overrun aside).
  int run(const uint8_t* data, uint64_t n, uint8_t* out, size_t occ, size_t* got_ret) {
    static const uint16_t kLenBase[31] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
                                          35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258, 258, 258};
    static const uint8_t kLenExtra[31] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
                                          3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0, 0, 0};
    static const uint16_t kDistBase[32] = {1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
                                           257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145,
                                           8193, 12289, 16385, 24577, 24577, 24577};
    static const uint8_t kDistExtra[32] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6,
                                           7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 13, 13};
    s = Inflate{data, data + n};
    kd = n;
    L = ovr = 0;
    const uint64_t in_fast_end = kd - std::min<uint64_t>(kd, 25);  // FASTLOOP_MAX_BYTES_READ
    const size_t out_fast_end = occ - std::min<size_t>(occ, 299);   // FASTLOOP_MAX_BYTES_WRITTEN
    size_t got = 0;
    Code lit, dist;
    bool last = false;
    auto word = [&](size_t dst, size_t src) {
      uint64_t w;
      std::memcpy(&w, out + src, 8);
      std::memcpy(out + dst, &w, 8);
    };
    while (!last) {
      if (!refill()) return LD_BAD_DATA;
      last = s.bits(1) != 0;
      const int type = s.bits(2);
      if (type == 0) {  // stored: realigned to the byte after the header
        const uint64_t at = (s.used + 7) / 8;
        if (at > kd || kd - at < 4) return LD_BAD_DATA;
        const unsigned len = data[at] | data[at + 1] << 8, nlen = data[at + 2] | data[at + 3] << 8;
        if (len != (~nlen & 0xFFFF)) return LD_BAD_DATA;
        if (len > occ - got) return LD_INSUFFICIENT_SPACE;
        if (len > kd - at - 4) return LD_BAD_DATA;
        std::memcpy(out + got, data + at + 4, len);
        got += len;
        L = at + 4 + len;
        ovr = 0;
        s.p = data + L;
        s.bitbuf = 0;
        s.bitcnt = 0;
        s.used = 8 * L;
        continue;
      }
      if (type == 3) return LD_BAD_DATA;
      uint8_t lens[320 + 138] = {};
      int nlen = 288, ndist = 32;
      if (type == 1) {
        int i = 0;
        for (; i < 144; ++i) lens[i] = 8;
        for (; i < 256; ++i) lens[i] = 9;
        for (; i < 280; ++i) lens[i] = 7;
        for (; i < 288; ++i) lens[i] = 8;
        for (i = 0; i < 32; ++i) lens[288 + i] = 5;
      } else {
        nlen = s.bits(5) + 257;
        ndist = s.bits(5) + 1;
        const int ncode = s.bits(4) + 4;
        static const uint8_t kOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};
        uint8_t pre[19] = {};
        pre[kOrder[0]] = uint8_t(s.bits(3));
        if (!refill()) return LD_BAD_DATA;
        for (int i = 1; i < ncode; ++i) pre[kOrder[i]] = uint8_t(s.bits(3));
        Code precode;
        if (!build(&precode, pre, 19)) return LD_BAD_DATA;
        int i = 0;
        while (i < nlen + ndist) {
          if (bitsleft() < 14 && !refill()) return LD_BAD_DATA;
          int bits;
          const int sym = decode(precode, &bits);
          if (sym < 16) {
            lens[i++] = uint8_t(sym);
            continue;
          }
          if (sym == 16 && i == 0) return LD_BAD_DATA;
          const int rep = sym == 16 ? 3 + s.bits(2) : sym == 17 ? 3 + s.bits(3) : 11 + s.bits(7);
          const uint8_t v = sym == 16 ? lens[i - 1] : 0;
          for (int k = 0; k < rep; ++k) lens[i++] = v;  // a run past the last length is ignored
        }
        std::memmove(lens + 288, lens + nlen, size_t(ndist));
      }
      if (!build(&dist, lens + 288, ndist) || !build(&lit, lens, nlen)) return LD_BAD_DATA;
      // the fast loop
      bool block_done = false;
      if (L < in_fast_end && got < out_fast_end) {
        L = (s.used + 7) / 8 + 7;
        do {
          int bits, sym = decode(lit, &bits);
          if (sym < 0) return LD_BAD_DATA;
          for (int k = 0; k < 3 && sym < 256 && bits <= 11; ++k) {  // up to three fast literals
            out[got++] = uint8_t(sym);
            if (k == 2) {
              sym = -1;
              break;
            }
            sym = decode(lit, &bits);
          }
          if (sym >= 0) {
            if (sym < 256) {  // a literal through a subtable
              out[got++] = uint8_t(sym);
            } else if (sym == 256) {
              block_done = true;
              break;
            } else {
              sym -= 257;
              const size_t len = size_t(kLenBase[sym] + s.bits(kLenExtra[sym]));
              const int ds = decode(dist, &bits);
              const size_t d = size_t(kDistBase[ds] + s.bits(kDistExtra[ds]));
              if (d > got) return LD_BAD_DATA;
              size_t dst = got, src = got - d;
              const size_t end = got + len;
              if (d >= 8) {
                do {
                  for (int k = 0; k < 5; ++k, dst += 8, src += 8) word(dst, src);
                } while (dst < end);
              } else if (d == 1) {
                const uint8_t v = out[src];
                do {
                  std::memset(out + dst, v, 32);
                  dst += 32;
                } while (dst < end);
              } else {
                word(dst, src);
                dst += d, src += d;
                word(dst, src);
                dst += d, src += d;
                do {
                  word(dst, src);
                  dst += d, src += d;
                  word(dst, src);
                  dst += d, src += d;
                } while (dst < end);
              }
              got = end;
            }
          }
          L = (s.used + 7) / 8 + 7;
        } while (L < in_fast_end && got < out_fast_end);
      }
      // the generic loop
      while (!block_done) {
        if (!refill()) return LD_BAD_DATA;
        int bits, sym = decode(lit, &bits);
        if (sym < 256) {
          if (got == occ) return LD_INSUFFICIENT_SPACE;
          out[got++] = uint8_t(sym);
          continue;
        }
        if (sym == 256) break;
        sym -= 257;
        const size_t len = size_t(kLenBase[sym] + s.bits(kLenExtra[sym]));
        if (len > occ - got) return LD_INSUFFICIENT_SPACE;
        const int ds = decode(dist, &bits);
        const size_t d = size_t(kDistBase[ds] + s.bits(kDistExtra[ds]));
        if (d > got) return LD_BAD_DATA;
        for (size_t k = 0; k < len; ++k, ++got) out[got] = out[got - d];
      }
    }
    if ((s.used + 7) / 8 > kd) return LD_BAD_DATA;  // a zero byte past the data consumed
    *got_ret = got;
    return LD_SUCCESS;
  }
};

// libdeflate_zlib_decompress_ex(d, src, cc, out, occ, NULL, produced): with
// produced null, all of occ must come out (tif_zip.c); else up to occ may
// (tif_lerc.c), *produced the bytes.
int libdeflate_zlib(const uint8_t* src, size_t cc, uint8_t* out, size_t occ, size_t* produced) {
  if (cc < 6) return LD_BAD_DATA;
  const int cmf = src[0], flg = src[1];
  if ((cmf * 256 + flg) % 31 != 0 || (cmf & 15) != 8 || (cmf >> 4) > 7 || (flg & 0x20)) return LD_BAD_DATA;
  Libdeflate ld;
  size_t got = 0;
  const int r = ld.run(src + 2, cc - 6, out, occ, &got);
  if (r != LD_SUCCESS) return r;
  if (!produced && got != occ) return LD_SHORT_OUTPUT;
  uint32_t a = 1, b = 0;
  for (size_t i = 0; i < got; ++i) {
    a = (a + out[i]) % 65521;
    b = (b + a) % 65521;
  }
  const uint8_t* q = src + 2 + (ld.s.used + 7) / 8;
  const uint32_t want = uint32_t(q[0]) << 24 | uint32_t(q[1]) << 16 | uint32_t(q[2]) << 8 | q[3];
  if ((b << 16 | a) != want) return LD_BAD_DATA;
  if (produced) *produced = got;
  return LD_SUCCESS;
}

}  // namespace

// tif_zip.c 4.5.0 decodes a whole strip or tile through
// libdeflate_zlib_decompress_ex (INFLATE_LIBDEFLATE): true when the stream
// fills occ bytes, either ending there with its checksum right or going on
// past them (LIBDEFLATE_INSUFFICIENT_SPACE, which libtiff accepts; the
// literal, match or stored block that does not fit is not written); else
// false, what came out staying in out, the fast loop's overrun included
// (Libdeflate above).
//
// tif_pixarlog.c calls zlib's inflate() until occ bytes are out
// (INFLATE_ZLIB): the data are all cc bytes; a stream whose data end, that
// ends early or that is refused fails; once occ bytes are out, decoding goes
// on only up to the next byte it would write, so that a refusal before it
// (an invalid code or distance, a block header, a wrong Adler-32 at the
// stream's end) still fails it, and nothing past it is read.
bool inflate_zlib(const uint8_t* src, size_t cc, uint8_t* out, size_t occ, int as) {
  if (as == INFLATE_LIBDEFLATE) {
    const int r = libdeflate_zlib(src, cc, out, occ, nullptr);
    return r == LD_SUCCESS || r == LD_INSUFFICIENT_SPACE;
  }
  if (cc < 2) return false;
  const int cmf = src[0], flg = src[1];
  if ((cmf & 15) != 8 || (cmf >> 4) > 7 || (cmf * 256 + flg) % 31 != 0 || (flg & 0x20)) return false;
  const size_t kd = cc - 2;
  Inflate s{src + 2, src + 2 + kd};
  s.strict = true;
  size_t got = 0;
  static const int16_t kLenBase[29] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
                                       35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
  static const int16_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
                                        3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
  static const int16_t kDistBase[30] = {1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129,
                                        193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097,
                                        6145, 8193, 12289, 16385, 24577};
  static const int16_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6,
                                         6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
  Inflate::Huffman lit, dist;
  bool last = false;
  while (!last) {
    last = s.bits(1) != 0;
    const int type = s.bits(2);
    if (s.stalled) return got == occ;
    if (type == 0) {  // stored: aligned to a byte of the input
      const uint64_t at = (s.used + 7) / 8;
      if (at > kd || kd - at < 4) return got == occ;
      const uint8_t* q = src + 2 + at;
      const unsigned len = q[0] | q[1] << 8, nlen = q[2] | q[3] << 8;
      if (len != (~nlen & 0xFFFF)) return false;
      // copied as far as the data and the room go
      const size_t n = std::min<size_t>({len, size_t(kd - at - 4), occ - got});
      std::memcpy(out + got, q + 4, n);
      got += n;
      if (n < len) return got == occ;
      s.p = q + 4 + len;
      s.bitbuf = 0;
      s.bitcnt = 0;
      s.used = 8 * (at + 4 + len);
      continue;
    }
    if (type == 3) return false;
    if (type == 1) {  // fixed
      uint8_t lengths[320];
      int i = 0;
      for (; i < 144; ++i) lengths[i] = 8;
      for (; i < 256; ++i) lengths[i] = 9;
      for (; i < 280; ++i) lengths[i] = 7;
      for (; i < 288; ++i) lengths[i] = 8;
      Inflate::build(&lit, lengths, 288, true);
      for (i = 0; i < 30; ++i) lengths[i] = 5;
      Inflate::build(&dist, lengths, 30, false);
    } else {  // dynamic
      const int nlen = s.bits(5) + 257, ndist = s.bits(5) + 1, ncode = s.bits(4) + 4;
      if (s.stalled) return got == occ;
      if (nlen > 286 || ndist > 30) return false;
      static const uint8_t kOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};
      uint8_t lengths[320] = {};
      for (int i = 0; i < ncode; ++i) lengths[kOrder[i]] = uint8_t(s.bits(3));
      if (s.stalled) return got == occ;
      Inflate::Huffman lencode;
      if (!Inflate::build(&lencode, lengths, 19, true, true)) return false;
      int index = 0;
      uint8_t all[320] = {};
      while (index < nlen + ndist) {
        int sym = s.decode(lencode);
        if (lencode.empty) sym = 0;  // zlib's table of no codes reads as lengths of 0
        if (s.stalled) return got == occ;
        if (sym < 0) return false;
        if (sym < 16) {
          all[index++] = uint8_t(sym);
          continue;
        }
        const int rep = sym == 16 ? 3 + s.bits(2) : sym == 17 ? 3 + s.bits(3) : 11 + s.bits(7);
        if (s.stalled) return got == occ;
        if (sym == 16 && index == 0) return false;  // zlib reads the count first
        const int len = sym == 16 ? all[index - 1] : 0;
        if (index + rep > nlen + ndist) return false;
        for (int k = 0; k < rep; ++k) all[index++] = uint8_t(len);
      }
      if (all[256] == 0) return false;  // no end-of-block code
      if (!Inflate::build(&lit, all, nlen, true) || !Inflate::build(&dist, all + nlen, ndist, false))
        return false;
    }
    while (true) {
      int sym = s.decode(lit);
      if (s.stalled) return got == occ;
      if (sym < 0) return false;
      if (sym < 256) {
        if (got == occ) return true;  // the next byte it would write
        out[got++] = uint8_t(sym);
        continue;
      }
      if (sym == 256) break;
      sym -= 257;
      if (sym >= 29) return false;
      const size_t len = size_t(kLenBase[sym] + s.bits(kLenExtra[sym]));
      if (s.stalled) return got == occ;
      const int ds = s.decode(dist);
      if (s.stalled) return got == occ;
      if (ds < 0 || ds >= 30) return false;
      const size_t d = size_t(kDistBase[ds] + s.bits(kDistExtra[ds]));
      if (s.stalled) return got == occ;
      if (d > got) return false;
      const size_t n = std::min(len, occ - got);  // zlib writes what fits
      for (size_t k = 0; k < n; ++k, ++got) out[got] = out[got - d];
      if (n < len) return true;
    }
  }
  // the Adler-32 of the output, big-endian, from the next whole byte, where
  // all four bytes are there
  const uint64_t at = (s.used + 7) / 8;
  if (at > kd || kd - at < 4) return got == occ;
  uint32_t a = 1, b = 0;
  for (size_t i = 0; i < got; ++i) {
    a = (a + out[i]) % 65521;
    b = (b + a) % 65521;
  }
  const uint8_t* q = src + 2 + at;
  const uint32_t want = uint32_t(q[0]) << 24 | uint32_t(q[1]) << 16 | uint32_t(q[2]) << 8 | q[3];
  return (b << 16 | a) == want && got == occ;
}

namespace {

// tif_webp.c 4.5.0's TWebPDecode of one strip or tile of seg_w x seg_h
// pixels and spp samples (3 or 4) into out[0, occ). libwebp's incremental
// decoder takes the stream in MODE_RGB for 3 samples and MODE_RGBA for 4
// (4.5.0 checks neither the stream's size nor its alpha against the
// tags), into out itself when occ is the whole segment, rows seg_w * spp
// apart, else into a buffer of the codec's that lives across segments (buf)
// and is copied out only when it holds occ bytes. A stream wider or taller
// than the segment writes nothing; a narrower one leaves the rest of each
// row as it was; one that fails or ends early leaves the rows libwebp had
// let out. True where libtiff's decode succeeds: the rows let out (a
// decoder that ran out of data counts too) hold occ bytes, and a whole
// segment's are all of its rows.
bool webp_segment(const uint8_t* src, size_t cc, uint8_t* out, uint64_t occ, uint32_t seg_w, uint32_t seg_h, int spp,
                  std::vector<uint8_t>* buf) {
  const uint64_t stride = uint64_t(seg_w) * uint64_t(spp), size = stride * seg_h;
  const bool whole = occ == size;
  if (!whole && buf->size() < size) buf->resize(size_t(size), 0);
  if (occ % stride) return false;  // "Fractional scanlines cannot be read"
  int rows = 0;  // WebPIDecGetRGB's current_y: the rows let out
  uint8_t* dst = whole ? out : buf->data();
  if (webp_decode(src, cc, spp, dst, size_t(stride), size_t(size), &rows) == WEBP_ERROR ||
      occ > stride * uint64_t(rows) || (whole && uint64_t(rows) != occ / stride))
    return false;
  if (!whole) std::memcpy(out, dst, size_t(occ));
  return true;
}

// ---------------------------------------------------------------- the image

struct Image {
  const Ifd* ifd = nullptr;
  uint32_t width = 0, height = 0;
  int bps = 1, spp = 1, compression = 1, photometric = -1, fillorder = 1, orientation = 1, planar = 1;
  int predictor = 1, inkset = 1, sampleformat = 1;
  int extras = 0, sampleinfo0 = 0, sampleinfo_last = 0;
  uint64_t rps = 0xFFFFFFFFu;
  bool tiled = false;
  uint32_t tw = 0, th = 0;
  std::vector<uint64_t> offsets, counts;
  int alpha = ALPHA_NONE;
  bool contig = true;
  int ycc_h = 2, ycc_v = 2;
  bool ycc_sub_tag = false;
  std::vector<uint16_t> cmap;  // 3 x (1 << bps): red, green, blue
  LzwMode lzw = LZW_UNSET;
  std::vector<uint8_t> webp_buf;  // tif_webp.c's buffer for segments not read whole
  std::vector<uint16_t> pixar_buf;  // tif_pixarlog.c's buffer of 11-bit words
  int sgilog = SGILOG_L16;          // the SGILog row decoder (LogLuvSetupDecode)
  int lerc_add = 0, lerc_dt = 0;    // LercParameters' additional compression; GetLercDataType
  uint64_t lerc_alloc = 0;          // tif_lerc.c's compressed_size: it only grows
  bool fill_failed = false;         // the last decode failed in TIFFFillStrip: its buffer untouched

  // libtiff's sizes (tif_strip.c, tif_tile.c)
  bool ycc_blocks() const { return photometric == PH_YCBCR && spp == 3 && contig_layout(); }
  bool contig_layout() const { return planar != 2; }
  uint64_t scanline() const {
    if (contig_layout()) {
      if (photometric == PH_YCBCR && spp == 3) {
        const uint64_t row = (uint64_t((width + ycc_h - 1) / ycc_h) * (ycc_h * ycc_v + 2) * bps + 7) / 8;
        return row / ycc_v;
      }
      return (uint64_t(width) * bps * spp + 7) / 8;
    }
    return (uint64_t(width) * bps + 7) / 8;
  }
  uint64_t strip_bytes(uint64_t rows) const {
    if (ycc_blocks()) {
      const uint64_t row = (uint64_t((width + ycc_h - 1) / ycc_h) * (ycc_h * ycc_v + 2) * bps + 7) / 8;
      return row * ((rows + ycc_v - 1) / ycc_v);
    }
    return rows * scanline();
  }
  uint64_t tile_row() const { return (uint64_t(tw) * bps * (contig_layout() ? spp : 1) + 7) / 8; }
  uint64_t tile_bytes() const {
    if (ycc_blocks()) {
      const uint64_t row = (uint64_t((tw + ycc_h - 1) / ycc_h) * (ycc_h * ycc_v + 2) * bps + 7) / 8;
      return row * ((uint64_t(th) + ycc_v - 1) / ycc_v);
    }
    return uint64_t(th) * tile_row();
  }
  uint64_t rows_per_strip() const { return std::min<uint64_t>(rps, height); }
  uint64_t strips_per_plane() const { return (height + rows_per_strip() - 1) / rows_per_strip(); }
  uint32_t across() const { return (width + tw - 1) / tw; }
  uint32_t down() const { return (height + th - 1) / th; }

  // TIFFFillStrip's check on a mapped file: data present and not empty.
  bool readable(size_t seg) const {
    if (seg >= offsets.size()) return false;
    const uint64_t off = offsets[seg], cnt = counts[seg];
    return cnt != 0 && cnt <= ifd->n && off <= ifd->n - cnt;
  }

  // Whether segment seg's occ bytes are its samples as they lie in the
  // file (uncompressed, in the host's order, all there): read in place.
  bool stored(size_t seg, uint64_t occ) const {
    return compression == CMP_NONE && fillorder == 1 && !(bps == 16 && !ifd->le) && counts[seg] >= occ;
  }

  // tif_lerc.c 4.5.0's LERCPreDecode and LERCDecode of segment seg: the
  // blob (after its Deflate or Zstandard wrapper, into a buffer of
  // tif_lerc.c's size) held to the segment (lerc_getBlobInfo: type, depth,
  // columns, rows, one band, its size), decoded, and where one 8-bit
  // unassociated alpha sample ends a contiguous pixel and the blob's depth
  // leaves it out, rebuilt from Lerc's mask as 255 * valid. A failure there
  // is TIFFFillStrip's (fill_failed); occ past the segment, LERCDecode's.
  bool lerc(size_t seg, const uint8_t* raw, size_t cc, uint8_t* out, uint64_t occ) {
    fill_failed = true;
    const uint64_t row0 = tiled ? 0 : (seg % strips_per_plane()) * rows_per_strip();
    const uint32_t sw = tiled ? tw : width;
    const uint32_t sh = tiled ? th : uint32_t(std::min<uint64_t>(rows_per_strip(), height - row0));
    const bool contig = planar == 1;
    const uint64_t size = uint64_t(sw) * sh * uint64_t(bps / 8) * (contig ? uint64_t(spp) : 1);
    const uint64_t zstd_bound = size + (size >> 8) + (size < (128u << 10) ? ((128u << 10) - size) >> 11 : 0);
    const uint64_t alloc = std::max<uint64_t>(256 + size + size / 3, zstd_bound);
    if (alloc > 0xFFFFFFFFu) return false;  // "Too large uncompressed strip/tile"
    const uint8_t* blob = raw;
    size_t blen = cc;
    std::vector<uint8_t> unwrapped;
    if (lerc_add != 0) {
      lerc_alloc = std::max(lerc_alloc, alloc);
      unwrapped.resize(size_t(lerc_alloc));
      if (lerc_add == 1) {  // libdeflate_zlib_decompress, its actual size asked for
        if (libdeflate_zlib(raw, cc, unwrapped.data(), unwrapped.size(), &blen) != LD_SUCCESS) return false;
      } else {  // ZSTD_decompress
        const int64_t got = zstd_decompress(raw, cc, unwrapped.data(), unwrapped.size());
        if (got < 0) return false;
        blen = size_t(got);
      }
      blob = unwrapped.data();
    }
    LercInfo info;
    if (!lerc_info(blob, blen, &info)) return false;
    const bool use_mask = contig && extras > 0 && sampleinfo_last == ALPHA_UNASSOC && lerc_dt == 1 &&
                          info.depth == spp - 1;
    const int ndims = contig ? spp - (use_mask ? 1 : 0) : 1;
    if (info.data_type != lerc_dt || info.depth != ndims || uint32_t(info.cols) != sw || uint32_t(info.rows) != sh ||
        info.bands != 1 || info.blob_size != blen)
      return false;
    std::vector<uint8_t> px(static_cast<size_t>(size)), mask(use_mask ? size_t(sw) * sh : 0);
    if (!lerc_decode(blob, blen, ndims, int(sw), int(sh), lerc_dt, px.data(), use_mask ? mask.data() : nullptr))
      return false;
    fill_failed = false;
    if (use_mask)  // the samples moved up, from the last pixel down
      for (size_t i = size_t(sw) * sh; i-- > 0;) {
        std::memmove(px.data() + i * size_t(spp), px.data() + i * size_t(spp - 1), size_t(spp - 1));
        px[i * size_t(spp) + size_t(spp) - 1] = uint8_t(255 * mask[i]);
      }
    if (occ > size) return false;  // "Too many bytes read"
    std::memcpy(out, px.data(), size_t(occ));
    return true;
  }

  // Decode segment seg into out[0, occ) (rowbytes a row, for the
  // predictor). False where libtiff's decode fails: what was written stays.
  bool decode(size_t seg, uint8_t* out, uint64_t occ, uint64_t rowbytes) {
    fill_failed = false;
    const uint8_t* raw = ifd->d + offsets[seg];
    const size_t cc = size_t(counts[seg]);
    std::vector<uint8_t> flipped;
    if (fillorder == 2 && compression != CMP_JBIG) {  // JBIG sets TIFF_NOBITREV: its decode reverses
      flipped.assign(raw, raw + cc);
      for (auto& b : flipped) {
        b = uint8_t((b * 0x0202020202ULL & 0x010884422010ULL) % 1023);
      }
      raw = flipped.data();
    }
    bool ok;
    switch (compression) {
      case CMP_NONE:
        if (cc < occ) return false;
        std::memcpy(out, raw, size_t(occ));
        ok = true;
        break;
      case CMP_PACKBITS:
        ok = unpack_bits(raw, cc, out, size_t(occ));
        break;
      case CMP_LZW:
        if (lzw == LZW_UNSET) lzw = cc >= 2 && raw[0] == 0 && (raw[1] & 1) ? LZW_COMPAT : LZW_NEW;
        ok = lzw_decode(raw, cc, out, size_t(occ), lzw == LZW_COMPAT);
        break;
      case CMP_DEFLATE:
      case CMP_DEFLATE_OLD:
        ok = inflate_zlib(raw, cc, out, size_t(occ), INFLATE_LIBDEFLATE);
        break;
      case CMP_ZSTD:
        ok = zstd_tiff_decode(raw, cc, out, size_t(occ));
        break;
      case CMP_LERC:
        ok = lerc(seg, raw, cc, out, occ);
        break;
      case CMP_WEBP: {  // TWebPPreDecode's segment size: a last strip's rows
        const uint64_t row0 = tiled ? 0 : (seg % strips_per_plane()) * rows_per_strip();
        const uint32_t seg_w = tiled ? tw : width;
        const uint32_t seg_h = tiled ? th : uint32_t(std::min<uint64_t>(rows_per_strip(), height - row0));
        ok = webp_segment(raw, cc, out, occ, seg_w, seg_h, spp, &webp_buf);
        break;
      }
      case CMP_NEXT:  // rows of the image's scanline, runs of the segment's width
        ok = next_decode(raw, cc, out, occ, scanline(), tiled ? tw : width);
        break;
      case CMP_THUNDER:  // no tile decoder: _TIFFNoTileDecode fails every tile
        ok = !tiled && thunder_decode(raw, cc, out, occ, scanline(), width);
        break;
      case CMP_PIXARLOG: {  // PixarLogSetupDecode's stride and buffer (rows of a strip, in a tile too)
        PixarLogShape shape;
        shape.stride = contig_layout() ? spp : 1;
        shape.width = width;
        shape.sixteen = bps == 16;
        shape.swab = !ifd->le;
        shape.tbuf_size = 2 * uint64_t(shape.stride) * width * rows_per_strip() + 2 * uint64_t(shape.stride);
        ok = pixarlog_decode(raw, cc, out, occ, shape, &pixar_buf);
        break;
      }
      case CMP_SGILOG:
      case CMP_SGILOG24:  // LogLuvInitState's buffer: a tile's pixels, or a strip's
        ok = sgilog_decode(raw, cc, out, occ, rowbytes, sgilog,
                           tiled ? uint64_t(tw) * th : uint64_t(width) * rows_per_strip());
        break;
      case CMP_JBIG:  // JBIGDecode reverses the bits at FillOrder 1 (isFillOrder on the host's flags); no
                      // tile decoder: _TIFFNoTileDecode fails every tile
        ok = !tiled && jbig_decode(raw, cc, fillorder == 1, out, occ);
        break;
      default:  // a scheme libtiff has no codec for: _TIFFNoStripDecode fails every segment
        ok = false;
        break;
    }
    if (!ok) return false;
    const bool swab = bps == 16 && !ifd->le;
    if (predictor == 2) {  // tif_predict.c: per row, 16-bit rows swabbed first
      const uint64_t stride = contig_layout() ? uint64_t(spp) : 1;
      if (rowbytes == 0 || occ % rowbytes) return false;
      for (uint64_t r = 0; r < occ; r += rowbytes) {
        uint8_t* row = out + r;
        if (bps == 8) {
          if (rowbytes % stride) return false;
          for (uint64_t i = stride; i < rowbytes; ++i) row[i] = uint8_t(row[i] + row[i - stride]);
        } else {
          if (swab)
            for (uint64_t i = 0; i + 1 < rowbytes; i += 2) std::swap(row[i], row[i + 1]);
          if (rowbytes % (2 * stride)) return false;
          const uint64_t wc = rowbytes / 2;
          for (uint64_t i = stride; i < wc; ++i) {
            uint16_t a, b;
            std::memcpy(&a, row + 2 * (i - stride), 2);
            std::memcpy(&b, row + 2 * i, 2);
            b = uint16_t(a + b);
            std::memcpy(row + 2 * i, &b, 2);
          }
        }
      }
    } else if (swab && compression != CMP_PIXARLOG) {  // PixarLog's words are the host's already
      for (uint64_t i = 0; i + 1 < occ; i += 2) std::swap(out[i], out[i + 1]);
    }
    return true;
  }
};

// ---------------------------------------------------------------- colour

// tif_color.c's TIFFYCbCrToRGBInit and TIFFYCbCrtoRGB, in its float and
// fixed-point arithmetic.
struct YCbCr {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256], y[256];

  static float code2v(int c, float rb, float rw, float cr) {
    return (float(c - int32_t(rb)) * cr) / ((rw - rb) != 0 ? (rw - rb) : 1.0f);
  }
  static float clampf(float f, float lo, float hi) { return !(f >= lo) ? lo : f > hi ? hi : f; }
  static int32_t fix(float x) { return int32_t(double(x * float(1L << 16)) + 0.5); }

  void init(const float* luma, const float* ref) {
    const float f1 = 2 - 2 * luma[0];
    const int32_t d1 = fix(clampf(f1, 0.0f, 2.0f));
    const float f2 = luma[0] * f1 / luma[1];
    const int32_t d2 = -fix(clampf(f2, 0.0f, 2.0f));
    const float f3 = 2 - 2 * luma[2];
    const int32_t d3 = fix(clampf(f3, 0.0f, 2.0f));
    const float f4 = luma[2] * f3 / luma[1];
    const int32_t d4 = -fix(clampf(f4, 0.0f, 2.0f));
    for (int i = 0, x = -128; i < 256; i++, x++) {
      const int32_t cr = int32_t(clampf(code2v(x, ref[4] - 128.0f, ref[5] - 128.0f, 127), -128.0f * 32, 128.0f * 32));
      const int32_t cb = int32_t(clampf(code2v(x, ref[2] - 128.0f, ref[3] - 128.0f, 127), -128.0f * 32, 128.0f * 32));
      cr_r[i] = int32_t((d1 * cr + (1 << 15)) >> 16);
      cb_b[i] = int32_t((d3 * cb + (1 << 15)) >> 16);
      cr_g[i] = d2 * cr;
      cb_g[i] = d4 * cb + (1 << 15);
      y[i] = int32_t(clampf(code2v(x + 128, ref[0], ref[1], 255), -128.0f * 32, 128.0f * 32));
    }
  }

  void rgb(uint32_t yv, int32_t cb, int32_t cr, uint8_t* out) const {
    yv = std::min<uint32_t>(yv, 255);
    cb = std::min(std::max(cb, 0), 255);
    cr = std::min(std::max(cr, 0), 255);
    int32_t i = y[yv] + cr_r[cr];
    out[0] = uint8_t(std::min(std::max(i, 0), 255));
    i = y[yv] + int32_t((cb_g[cb] + cr_g[cr]) >> 16);
    out[1] = uint8_t(std::min(std::max(i, 0), 255));
    i = y[yv] + cb_b[cb];
    out[2] = uint8_t(std::min(std::max(i, 0), 255));
  }
};

// tif_color.c's TIFFCIELabToRGBInit (tif_getimage.c's display_sRGB),
// TIFFCIELab16ToXYZ and TIFFXYZToRGB.
struct CieLab {
  static constexpr int kRange = 1500;  // CIELABTORGB_TABLE_RANGE
  float x0 = 0, y0 = 0, z0 = 0, rstep = 0;
  float yr2r[kRange + 1];
  const float mat[9] = {3.2410f, -1.5374f, -0.4986f, -0.9692f, 1.8760f, 0.0416f, 0.0556f, -0.2040f, 1.0570f};
  const float yc = 100.0f, y0c = 1.0f;

  void init(const float* white) {
    float ref[3];
    ref[1] = 100.0f;
    ref[0] = white[0] / white[1] * ref[1];
    ref[2] = (1.0f - white[0] - white[1]) / white[1] * ref[1];
    const double gamma = 1.0 / 2.4f;
    rstep = (yc - y0c) / float(kRange);
    for (int i = 0; i <= kRange; i++) yr2r[i] = 255u * float(std::pow(double(i) / kRange, gamma));
    x0 = ref[0];
    y0 = ref[1];
    z0 = ref[2];
  }

  void xyz(uint32_t l, int32_t a, int32_t b, float* X, float* Y, float* Z) const {
    const float L = float(l) * 100.0f / 65535.0f;
    float cby, tmp;
    if (L < 8.856f) {
      *Y = (L * y0) / 903.292f;
      cby = 7.787f * (*Y / y0) + 16.0f / 116.0f;
    } else {
      cby = (L + 16.0f) / 116.0f;
      *Y = y0 * cby * cby * cby;
    }
    tmp = float(a) / 256.0f / 500.0f + cby;
    if (tmp < 0.2069f) *X = x0 * (tmp - 0.13793f) / 7.787f;
    else *X = x0 * tmp * tmp * tmp;
    tmp = cby - float(b) / 256.0f / 200.0f;
    if (tmp < 0.2069f) *Z = z0 * (tmp - 0.13793f) / 7.787f;
    else *Z = z0 * tmp * tmp * tmp;
  }

  uint8_t channel(float v) const {
    v = std::max(v, y0c);
    v = std::min(v, yc);
    int i = int((v - y0c) / rstep);
    i = std::min(kRange, i);
    const float r = yr2r[i];
    uint32_t c = uint32_t(r > 0 ? (r + 0.5) : (r - 0.5));
    return uint8_t(std::min<uint32_t>(c, 255));
  }

  void rgb(uint32_t l16, int32_t a16, int32_t b16, uint8_t* out) const {
    float X, Y, Z;
    xyz(l16, a16, b16, &X, &Y, &Z);
    const float yr = mat[0] * X + mat[1] * Y + mat[2] * Z;
    const float yg = mat[3] * X + mat[4] * Y + mat[5] * Z;
    const float yb = mat[6] * X + mat[7] * Y + mat[8] * Z;
    out[0] = channel(yr);
    out[1] = channel(yg);
    out[2] = channel(yb);
  }
};

inline uint8_t b16to8(uint16_t v) { return uint8_t((uint32_t(v) + 128) / 257); }   // Bitdepth16To8
inline uint8_t ua_to_aa(uint32_t v, uint32_t a) { return uint8_t((v * a + 127) / 255); }  // UaToAa
inline uint16_t u16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}

// The put routine's kind (PickContigCase / PickSeparateCase).
enum Put {
  PUT_NONE, PUT_BW_BITS, PUT_GREY8, PUT_GREY16, PUT_CMAP_BITS, PUT_CMAP8, PUT_RGB8,
  PUT_RGBUA8, PUT_RGB16, PUT_RGBUA16, PUT_CMYK8, PUT_YCBCR, PUT_LAB8, PUT_LAB16,
  SEP_RGB8, SEP_RGBUA8, SEP_RGB16, SEP_RGBUA16, SEP_CMYK8, SEP_YCBCR11,
};

struct Converter {
  Image* im;
  Put put = PUT_NONE;
  uint8_t map[256];          // setupMap (grey)
  uint8_t pal[256][3];       // makecmap (palette), after checkcmap/cvtcmap
  YCbCr ycc;
  CieLab lab;

  // One segment's pixels (w x h from pp, fromskew pixels past each row in
  // the segment) into cp (rows cstride bytes apart): the put routines.
  void contig(uint8_t* cp, size_t cstride, uint32_t w, uint32_t h, int32_t fromskew, const uint8_t* pp) const {
    const int spp = im->spp, bps = im->bps;
    for (uint32_t r = 0; put != PUT_YCBCR && r < h; ++r, cp += cstride) {
      uint8_t* o = cp;
      switch (put) {
        case PUT_BW_BITS:
        case PUT_CMAP_BITS: {
          const int per = 8 / bps, mask = (1 << bps) - 1;
          for (uint32_t x = 0; x < w; ++x, o += 3) {
            const int v = (pp[x / per] >> (8 - bps * (1 + int(x % per)))) & mask;
            if (put == PUT_BW_BITS) o[0] = o[1] = o[2] = map[v];
            else std::memcpy(o, pal[v], 3);
          }
          pp += (w + per - 1) / per + fromskew / per;
          break;
        }
        case PUT_GREY8:  // putgreytile and putagreytile: the grey's map, alpha aside
        case PUT_CMAP8:
          for (uint32_t x = 0; x < w; ++x, o += 3, pp += spp) {
            if (put == PUT_CMAP8) std::memcpy(o, pal[*pp], 3);
            else o[0] = o[1] = o[2] = map[*pp];
          }
          pp += fromskew;
          break;
        case PUT_GREY16:
          for (uint32_t x = 0; x < w; ++x, o += 3, pp += 2 * spp) o[0] = o[1] = o[2] = map[u16(pp) >> 8];
          pp += fromskew;
          break;
        case PUT_RGB8:
          if (spp == 3) {
            std::memcpy(o, pp, size_t(w) * 3);
            pp += size_t(w) * 3;
          } else {
            for (uint32_t x = 0; x < w; ++x, o += 3, pp += spp) std::memcpy(o, pp, 3);
          }
          pp += fromskew * spp;
          break;
        case PUT_RGBUA8:
          for (uint32_t x = 0; x < w; ++x, o += 3, pp += spp)
            for (int c = 0; c < 3; ++c) o[c] = ua_to_aa(pp[c], pp[3]);
          pp += fromskew * spp;
          break;
        case PUT_RGB16:
          for (uint32_t x = 0; x < w; ++x, o += 3, pp += 2 * spp)
            for (int c = 0; c < 3; ++c) o[c] = b16to8(u16(pp + 2 * c));
          pp += 2 * fromskew * spp;
          break;
        case PUT_RGBUA16:
          for (uint32_t x = 0; x < w; ++x, o += 3, pp += 2 * spp) {
            const uint32_t a = b16to8(u16(pp + 6));
            for (int c = 0; c < 3; ++c) o[c] = ua_to_aa(b16to8(u16(pp + 2 * c)), a);
          }
          pp += 2 * fromskew * spp;
          break;
        case PUT_CMYK8:
          for (uint32_t x = 0; x < w; ++x, o += 3, pp += spp) {
            const uint32_t k = 255u - pp[3];
            for (int c = 0; c < 3; ++c) o[c] = uint8_t((k * (255u - pp[c])) / 255);
          }
          pp += fromskew * spp;
          break;
        case PUT_LAB8:
          for (uint32_t x = 0; x < w; ++x, o += 3, pp += 3)
            lab.rgb(uint32_t(pp[0]) * 257, int32_t(int8_t(pp[1])) * 256, int32_t(int8_t(pp[2])) * 256, o);
          pp += fromskew * 3;
          break;
        case PUT_LAB16:
          for (uint32_t x = 0; x < w; ++x, o += 3, pp += 6)
            lab.rgb(u16(pp), int16_t(u16(pp + 2)), int16_t(u16(pp + 4)), o);
          pp += 2 * fromskew * 3;
          break;
        default:
          break;
      }
    }
    if (put == PUT_YCBCR) {  // putcontig8bitYCbCrXYtile: Y's h x v, then Cb, Cr per block
      const int hs = im->ycc_h, vs = im->ycc_v, bsz = hs * vs + 2;
      // a tile's skew in blocks; the 4x4 routine counts them at the 4x2's size
      const int32_t skew = (fromskew / hs) * (hs == 4 && vs == 4 ? 4 * 2 + 2 : bsz);
      for (uint32_t by = 0; by < h; by += uint32_t(vs)) {
        for (uint32_t bx = 0; bx < w; bx += uint32_t(hs), pp += bsz) {
          for (int r = 0; r < vs && by + r < h; ++r)
            for (int c = 0; c < hs && bx + c < w; ++c)
              ycc.rgb(pp[r * hs + c], pp[hs * vs], pp[hs * vs + 1], cp + (by + r) * cstride + (bx + c) * 3);
        }
        pp += skew;
      }
    }
  }

  void separate(uint8_t* cp, size_t cstride, uint32_t w, uint32_t h, int32_t fromskew, const uint8_t* r,
                const uint8_t* g, const uint8_t* b, const uint8_t* a) const {
    const int wide = put == SEP_RGB16 || put == SEP_RGBUA16 ? 2 : 1;
    const size_t row = size_t(w + fromskew) * wide;
    for (uint32_t y = 0; y < h; ++y, cp += cstride, r += row, g += row, b += row, a += a ? row : 0) {
      uint8_t* o = cp;
      for (uint32_t x = 0; x < w; ++x, o += 3) {
        switch (put) {
          case SEP_RGB8: o[0] = r[x]; o[1] = g[x]; o[2] = b[x]; break;
          case SEP_RGBUA8:
            o[0] = ua_to_aa(r[x], a[x]);
            o[1] = ua_to_aa(g[x], a[x]);
            o[2] = ua_to_aa(b[x], a[x]);
            break;
          case SEP_RGB16:
            o[0] = b16to8(u16(r + 2 * x));
            o[1] = b16to8(u16(g + 2 * x));
            o[2] = b16to8(u16(b + 2 * x));
            break;
          case SEP_RGBUA16: {
            const uint32_t av = b16to8(u16(a + 2 * x));
            o[0] = ua_to_aa(b16to8(u16(r + 2 * x)), av);
            o[1] = ua_to_aa(b16to8(u16(g + 2 * x)), av);
            o[2] = ua_to_aa(b16to8(u16(b + 2 * x)), av);
            break;
          }
          case SEP_CMYK8: {
            const uint32_t k = 255u - a[x];
            o[0] = uint8_t((k * (255u - r[x])) / 255);
            o[1] = uint8_t((k * (255u - g[x])) / 255);
            o[2] = uint8_t((k * (255u - b[x])) / 255);
            break;
          }
          case SEP_YCBCR11: ycc.rgb(r[x], g[x], b[x], o); break;
          default: break;
        }
      }
    }
  }
};

// ---------------------------------------------------------------- reading

// TIFFRGBAImageOK and TIFFRGBAImageBegin on the tags; picks the put
// routine. Returns a TiffRoute.
int choose(Image* im, Converter* cv) {
  const Ifd& f = *im->ifd;
  if (im->bps != 1 && im->bps != 2 && im->bps != 4 && im->bps != 8 && im->bps != 16) return TIFF_SKIP;
  if (im->sampleformat == 3) return TIFF_SKIP;  // IEEE floating point
  const int cc_ok = im->spp - im->extras;
  int ph = im->photometric;
  if (ph < 0) {
    if (cc_ok == 1) ph = PH_MINISBLACK;
    else if (cc_ok == 3) ph = PH_RGB;
    else return TIFF_SKIP;
  }
  switch (ph) {
    case PH_MINISWHITE: case PH_MINISBLACK: case PH_PALETTE:
      if (im->planar == 1 && im->spp != 1 && im->bps < 8) return TIFF_SKIP;
      break;
    case PH_YCBCR: break;
    case PH_RGB:
      if (cc_ok < 3) return TIFF_SKIP;
      break;
    case PH_SEPARATED:
      if (im->inkset != 1 || im->spp < 4) return TIFF_SKIP;
      break;
    case PH_LOGL:
      if (im->compression != CMP_SGILOG) return TIFF_SKIP;
      break;
    case PH_LOGLUV:
      if ((im->compression != CMP_SGILOG && im->compression != CMP_SGILOG24) || im->planar != 1 ||
          im->spp != 3 || cc_ok != 3)
        return TIFF_SKIP;
      break;
    case PH_CIELAB:
      if (im->spp != 3 || cc_ok != 3 || (im->bps != 8 && im->bps != 16)) return TIFF_SKIP;
      break;
    default:
      return TIFF_SKIP;
  }
  // TIFFRGBAImageBegin: the alpha, the photometric it decodes by
  im->alpha = ALPHA_NONE;
  int extras = im->extras;
  if (extras >= 1) {
    if (im->sampleinfo0 == 0) { if (im->spp > 3) im->alpha = ALPHA_ASSOC; }
    else if (im->sampleinfo0 == 1 || im->sampleinfo0 == 2) im->alpha = im->sampleinfo0;
  }
  if (extras == 0 && im->spp == 4 && (im->photometric < 0 ? PH_MINISWHITE : im->photometric) == PH_RGB) {
    im->alpha = ALPHA_ASSOC;  // DEFAULT_EXTRASAMPLE_AS_ALPHA
    extras = 1;
  }
  const int cc = im->spp - extras;
  if (im->photometric < 0) {
    if (cc == 1) ph = PH_MINISBLACK;
    else if (cc == 3) ph = PH_RGB;
    else return TIFF_SKIP;
  }
  if (ph == PH_PALETTE && im->cmap.empty()) return TIFF_SKIP;
  if (ph == PH_RGB && cc < 3) return TIFF_SKIP;
  if (ph == PH_YCBCR && im->planar == 1 && im->compression == CMP_JPEG) ph = PH_RGB;  // JPEGCOLORMODE_RGB
  if (im->compression == CMP_JPEG) return TIFF_JPEG;  // the segments decide (read_jpeg)
  // a compression left to PIL still takes libtiff's refusals: its put
  // routine and its predictor
  const bool pil = pil_compression(im->compression);
  // setup and pre-decode refusals fail every segment's TIFFFillStrip, the
  // first one's failing the image
  switch (im->compression) {
    case CMP_NEXT:  // NeXTPreDecode: 2-bit samples only
      if (im->bps != 2) return TIFF_SKIP;
      break;
    case CMP_THUNDER:  // ThunderSetupDecode: 4-bit samples only
      if (im->bps != 4) return TIFF_SKIP;
      break;
    case CMP_PIXARLOG:  // PixarLogGuessDataFmt: 8 or 16 unsigned (or untyped) bits
      if ((im->bps != 8 && im->bps != 16) || (im->sampleformat != 1 && im->sampleformat != 4)) return TIFF_SKIP;
      break;
    case CMP_SGILOG:
    case CMP_SGILOG24:  // LogLuvSetupDecode; TIFFRGBAImageBegin's SGILOGDATAFMT_8BIT: 8-bit grey or RGB
      if (im->photometric == PH_LOGL) {
        if (im->spp != 1) return TIFF_SKIP;  // LogL16InitState
        im->sgilog = SGILOG_L16;
        ph = PH_MINISBLACK;
      } else if (im->photometric == PH_LOGLUV) {
        im->sgilog = im->compression == CMP_SGILOG24 ? SGILOG_LUV24 : SGILOG_LUV32;
        ph = PH_RGB;
      } else {
        return TIFF_SKIP;  // "Inappropriate photometric interpretation"
      }
      im->bps = 8;
      break;
    case CMP_JBIG:  // JBIGSetupDecode: TIFFNumberOfStrips (from RowsPerStrip, in a tiled file too) is 1
      if (im->strips_per_plane() * (im->planar == 2 ? uint64_t(im->spp) : 1) != 1) return TIFF_SKIP;
      if (!im->tiled && !im->counts.empty() && im->readable(0) &&  // BIEs of several layers or planes
          jbig_layered(f.d + im->offsets[0], size_t(im->counts[0]), im->fillorder == 1))
        return TIFF_PIL;
      break;
    default:
      break;
  }
  if (im->compression == CMP_LERC) {
    // GetLercDataType (8 or 16 bits, unsigned or signed) and an additional
    // compression tif_lerc.c handles: else every segment's pre-decode fails
    const int sf = im->sampleformat;
    if ((sf != 1 && sf != 2) || (im->bps != 8 && im->bps != 16) || im->lerc_add < 0 || im->lerc_add > 2)
      return TIFF_SKIP;
    im->lerc_dt = (im->bps == 8 ? 0 : 2) + (sf == 1 ? 1 : 0);
  }
  if (im->compression == CMP_WEBP) {
    // TWebPSetupDecode (3 or 4 samples; 8 bits, or unsigned samples of any
    // size) and TWebPPreDecode (segments of at most 16383 x 16383) fail
    // every segment's TIFFFillStrip, the first one's failing the image
    const uint64_t seg_w = im->tiled ? im->tw : im->width, seg_h = im->tiled ? im->th : im->rows_per_strip();
    if ((im->spp != 3 && im->spp != 4) || (im->bps != 8 && im->sampleformat != 1) || seg_w > 16383 || seg_h > 16383)
      return TIFF_SKIP;
  }
  // a scheme outside libtiff's codec table gets its default state: the
  // image reads, every segment's decode fails (a zeroed buffer put)
  const int c = im->compression;
  const bool predicting = c == CMP_LZW || c == CMP_DEFLATE || c == CMP_DEFLATE_OLD || c == CMP_PIXARLOG ||
                          c == CMP_LZMA || c == CMP_ZSTD;
  if (predicting && im->predictor != 1 && !(im->predictor == 2 && (im->bps == 8 || im->bps == 16)))
    return TIFF_SKIP;  // PredictorSetup refuses: every segment fails
  if (!predicting) im->predictor = 1;  // no predictor on the other codecs
  im->contig = !(im->planar == 2 && im->spp > 1);
  const int bps = im->bps;
  Put put = PUT_NONE;
  // buildMap
  auto setup_map = [&]() {
    const int range = bps == 16 ? 255 : (1 << bps) - 1;
    for (int x = 0; x <= range; ++x)
      cv->map[x] = uint8_t(ph == PH_MINISWHITE ? ((range - x) * 255) / range : (x * 255) / range);
  };
  auto setup_cmap = [&]() {
    const size_t n = size_t(1) << bps;
    bool wide = false;
    for (size_t i = 0; i < 3 * n; ++i) wide |= im->cmap[i] >= 256;
    std::vector<uint16_t> m = im->cmap;
    if (wide)
      for (auto& v : m) v = uint16_t(v >> 8);
    for (int i = 0; i < 256; ++i) {
      const size_t ci = size_t(i) < n ? size_t(i) : 0;  // makecmap reads indices below 1 << bps
      for (int k = 0; k < 3; ++k) cv->pal[i][k] = uint8_t(m[k * n + ci] & 0xff);
    }
  };
  if (im->contig) {
    switch (ph) {
      case PH_RGB:
        if (bps == 8) {
          if (im->alpha == ALPHA_ASSOC && im->spp >= 4) put = PUT_RGB8;
          else if (im->alpha == ALPHA_UNASSOC && im->spp >= 4) put = PUT_RGBUA8;
          else if (im->spp >= 3) put = PUT_RGB8;
        } else if (bps == 16) {
          if (im->alpha == ALPHA_ASSOC && im->spp >= 4) put = PUT_RGB16;
          else if (im->alpha == ALPHA_UNASSOC && im->spp >= 4) put = PUT_RGBUA16;
          else if (im->spp >= 3) put = PUT_RGB16;
        }
        break;
      case PH_SEPARATED:
        if (im->spp >= 4 && bps == 8) put = PUT_CMYK8;
        break;
      case PH_PALETTE:
        setup_cmap();
        if (bps == 8) put = PUT_CMAP8;
        else if (bps < 8) put = PUT_CMAP_BITS;
        break;
      case PH_MINISWHITE: case PH_MINISBLACK:
        setup_map();
        if (bps == 16) put = PUT_GREY16;
        else if (bps == 8) put = PUT_GREY8;
        else put = PUT_BW_BITS;
        break;
      case PH_YCBCR:
        if (bps == 8 && im->spp == 3) {
          const int hv = im->ycc_h << 4 | im->ycc_v;
          if (hv == 0x44 || hv == 0x42 || hv == 0x41 || hv == 0x22 || hv == 0x21 || hv == 0x12 || hv == 0x11)
            put = PUT_YCBCR;
        }
        break;
      case PH_CIELAB:
        if (im->spp == 3) put = bps == 8 ? PUT_LAB8 : bps == 16 ? PUT_LAB16 : PUT_NONE;
        break;
      default:
        break;
    }
  } else {
    switch (ph) {
      case PH_MINISWHITE: case PH_MINISBLACK: case PH_RGB:
        if (bps == 8) put = im->alpha == ALPHA_UNASSOC ? SEP_RGBUA8 : SEP_RGB8;
        else if (bps == 16) put = im->alpha == ALPHA_UNASSOC ? SEP_RGBUA16 : SEP_RGB16;
        break;
      case PH_SEPARATED:
        if (bps == 8 && im->spp == 4) {
          im->alpha = 1;  // tif_getimage.c: the only way to the fourth plane
          put = SEP_CMYK8;
        }
        break;
      case PH_YCBCR:
        if (bps == 8 && im->spp == 3 && im->ycc_h == 1 && im->ycc_v == 1) put = SEP_YCBCR11;
        break;
      default:
        break;
    }
  }
  if (put == PUT_YCBCR || put == SEP_YCBCR11) {
    std::vector<float> luma = {0.299f, 0.587f, 0.114f}, ref;
    std::vector<float> tag;
    if (f.floats(TAG_YCC_COEFS, &tag) && tag.size() >= 3) luma.assign(tag.begin(), tag.begin() + 3);
    if (f.floats(TAG_REFBW, &tag) && tag.size() >= 6) ref.assign(tag.begin(), tag.begin() + 6);
    else ref = {0.0f, 255.0f, 128.0f, 255.0f, 128.0f, 255.0f};  // TIFFDefaultRefBlackWhite for YCbCr
    if (std::isnan(luma[0]) || std::isnan(luma[1]) || luma[1] == 0.0f || std::isnan(luma[2])) return TIFF_SKIP;
    for (float v : ref)
      if (std::isnan(v)) return TIFF_SKIP;
    cv->ycc.init(luma.data(), ref.data());
  }
  if (put == PUT_LAB8 || put == PUT_LAB16) {
    // WhitePoint, CIE D50 by default (tif_aux.c)
    std::vector<float> white = {96.4250f / (96.4250f + 100.0f + 82.4680f), 100.0f / (96.4250f + 100.0f + 82.4680f)};
    std::vector<float> tag;
    if (f.floats(TAG_WHITEPOINT, &tag) && tag.size() >= 2) white.assign(tag.begin(), tag.begin() + 2);
    if (white[1] == 0.0f) return TIFF_SKIP;
    cv->lab.init(white.data());
  }
  cv->put = put;
  return put == PUT_NONE ? TIFF_SKIP : pil ? TIFF_PIL : TIFF_RASTER;
}

// gtStripContig / gtTileContig / gtStripSeparate / gtTileSeparate into
// rgb (height x width x 3, every pixel written), as stored: the
// orientation's flips (T_FLIP) are left to the caller. False where libtiff's read fails (the first
// segment unreadable).
bool get_image(Image* im, const Converter& cv, uint8_t* rgb) {
  const size_t W = im->width, cstride = W * 3;
  std::vector<uint8_t> buf;
  bool have = false;
  const uint8_t* src = nullptr;  // the last segment's samples: buf, or an uncompressed one in place
  const bool alpha = im->alpha != ALPHA_NONE;
  // the segments of one band (strip row or tile row) and their planes
  auto segment_index = [&](uint32_t sx, uint32_t sy, int plane) -> size_t {
    if (im->tiled) return size_t(plane) * im->across() * im->down() + size_t(sy) * im->across() + sx;
    return size_t(plane) * im->strips_per_plane() + sy;
  };
  const uint64_t seg_bytes = im->tiled ? im->tile_bytes() : im->strip_bytes(im->rows_per_strip());
  if (seg_bytes > (uint64_t(1) << 31)) return false;  // as the raster's own bound in read_tiff
  const uint64_t rowbytes = im->tiled ? im->tile_row() : im->scanline();
  const uint32_t seg_w = im->tiled ? im->tw : im->width;
  const uint32_t seg_h = im->tiled ? im->th : uint32_t(im->rows_per_strip());
  const uint32_t bands = im->tiled ? im->down() : uint32_t(im->strips_per_plane());
  const uint32_t cols = im->tiled ? im->across() : 1;
  const int colorchannels = im->photometric == PH_MINISWHITE || im->photometric == PH_MINISBLACK ||
                                    im->photometric == PH_PALETTE ? 1 : 3;
  for (uint32_t band = 0; band < bands; ++band) {
    const uint32_t y0 = band * seg_h;
    const uint32_t nrow = std::min<uint32_t>(seg_h, im->height - y0);
    const uint64_t occ = im->tiled ? seg_bytes : im->strip_bytes(nrow);
    for (uint32_t col = 0; col < cols; ++col) {
      const uint32_t x0 = col * seg_w;
      const uint32_t npix = std::min<uint32_t>(seg_w, im->width - x0);
      const int32_t fromskew = int32_t(seg_w - npix);
      uint8_t* cp = rgb + size_t(y0) * cstride + size_t(x0) * 3;
      if (im->contig) {
        const size_t s = segment_index(col, band, 0);
        if (!have) {
          if (!im->readable(s)) return false;
          buf.assign(size_t(seg_bytes), 0);
          src = buf.data();
        }
        if (im->readable(s)) {
          if (im->stored(s, occ)) src = im->ifd->d + im->offsets[s];  // as decoded, read in place
          // an uncompressed segment that fails writes nothing: the last one stays
          else if (im->decode(s, buf.data(), occ, rowbytes) || im->compression != CMP_NONE) src = buf.data();
          if (!have && im->fill_failed) return false;  // no buffer yet: the image fails
        }
        have = true;
        cv.contig(cp, cstride, npix, nrow, fromskew, src);
      } else {
        // planes 0 .. colorchannels - 1, then the alpha (or K) plane at 3 x size
        const uint64_t size = seg_bytes;
        const size_t s0 = segment_index(col, band, 0);
        if (!have) {
          if (!im->readable(s0)) return false;
          buf.assign(size_t((alpha ? 4 : 3) * size), 0);
          have = true;
          if (!im->decode(s0, buf.data(), occ, rowbytes) && im->fill_failed) return false;
        } else if (im->readable(s0)) {
          im->decode(s0, buf.data(), occ, rowbytes);
        }
        uint8_t* p0 = buf.data();
        uint8_t* p1 = colorchannels == 1 ? p0 : p0 + size;
        uint8_t* p2 = colorchannels == 1 ? p0 : p0 + 2 * size;
        uint8_t* pa = alpha ? p0 + 3 * size : nullptr;
        for (int p = 1; p < colorchannels; ++p) {
          const size_t s = segment_index(col, band, p);
          if (im->readable(s)) im->decode(s, p == 1 ? p1 : p2, occ, rowbytes);
        }
        if (alpha) {
          const size_t s = segment_index(col, band, colorchannels);
          if (im->readable(s)) im->decode(s, pa, occ, rowbytes);
        }
        cv.separate(cp, cstride, npix, nrow, fromskew, p0, p1, p2, pa);
      }
    }
  }
  return true;
}

// ChopUpSingleUncompressedStrip: one contiguous uncompressed strip read as
// strips of about 8 KiB.
void chop_strip(Image* im) {
  auto& counts = im->counts;
  auto& offsets = im->offsets;
  if (counts.size() != 1 || im->planar != 1) return;
  const uint32_t block = im->ycc_blocks() ? uint32_t(im->ycc_v) : 1;
  const uint64_t block_bytes = im->strip_bytes(block);
  if (block_bytes == 0) return;
  constexpr uint64_t kStripSize = 8192;  // STRIP_SIZE_DEFAULT
  const uint64_t blocks = block_bytes > kStripSize ? 1 : kStripSize / block_bytes;
  const uint64_t rows = blocks * block;
  if (rows >= im->rps) return;
  const uint64_t nstrips = (im->height + rows - 1) / rows;
  uint64_t off = offsets[0], left = counts[0], bytes = blocks * block_bytes;
  offsets.assign(size_t(nstrips), 0);
  counts.assign(size_t(nstrips), 0);
  for (uint64_t i = 0; i < nstrips; ++i) {
    bytes = std::min(bytes, left);
    counts[i] = bytes;
    offsets[i] = bytes ? off : 0;
    off += bytes;
    left -= bytes;
  }
  im->rps = rows;
}

// tif_dirread.c on uncompressed strips, which changes only what a short or
// mislabelled file reads: byte counts it takes for wrong recomputed from
// the image's size (ByteCountLooksBad for one strip; differing first two
// counts for several), then one strip chopped into strips of about 8 KiB
// (ChopUpSingleUncompressedStrip), each read on its own.
void repair_strips(Image* im) {
  auto& counts = im->counts;
  auto& offsets = im->offsets;
  const uint64_t n = im->ifd->n, line = im->scanline();
  if (counts.size() == 1) {
    const uint64_t off = offsets[0], cnt = counts[0];
    const bool bad = off != 0 && (cnt == 0 || (off <= n && cnt > n - off) || cnt < line * im->height);
    if (bad) counts[0] = line * im->height;
  } else if (im->planar == 1 && counts.size() > 2 && counts[0] != counts[1] && counts[0] != 0 && counts[1] != 0) {
    const uint64_t rows = im->height / im->strips_per_plane();
    for (auto& c : counts) c = line * rows;
  }
  chop_strip(im);
}

// TIFFReadDirectory without StripByteCounts (TileByteCounts): a
// contiguous image of several segments (compressed or not), or planes whose
// segments are not one a sample, is MissingRequired (false: the file does
// not open); else EstimateStripByteCounts: a compressed image's segments
// each the file less its header and directory (a plane's share of it),
// the last clipped to the file; an uncompressed one's a tile, or its rows.
// One uncompressed strip is then chopped as a counted one is.
bool estimate_counts(Image* im) {
  const Ifd& f = *im->ifd;
  const uint64_t segs = im->offsets.size();
  if ((im->planar == 1 && segs > 1) || (im->planar == 2 && segs != uint64_t(im->spp)))
    return false;
  uint64_t each;
  if (im->compression != CMP_NONE) {
    if (f.unknown_type) return false;  // "Cannot determine size of unknown tag type"
    const uint64_t space = (f.big ? 16 + 8 + f.entries * 20 + 8 : 8 + 2 + f.entries * 12 + 4) + f.out_of_line;
    each = f.n < space ? f.n : f.n - space;
    if (im->planar == 2) each /= uint64_t(im->spp);
  } else if (im->tiled) {
    each = im->tile_bytes();
  } else {
    each = im->scanline() * (im->height / im->strips_per_plane());
  }
  im->counts.assign(size_t(segs), each);
  if (im->compression != CMP_NONE) {
    const uint64_t last = im->offsets.back();
    if (last > f.n || each > f.n - last) im->counts.back() = last >= f.n ? 0 : f.n - last;
  }
  if (!im->tiled && im->compression == CMP_NONE) chop_strip(im);
  return true;
}

// Read the tags libtiff's RGBA interface reads. False where TIFFOpen
// fails (no usable first directory).
bool read_fields(const Ifd& f, Image* im) {
  im->ifd = &f;
  std::vector<uint64_t> v;
  if (!f.uints(TAG_WIDTH, &v)) return false;
  im->width = uint32_t(v[0]);
  if (!f.uints(TAG_LENGTH, &v)) return false;
  im->height = uint32_t(v[0]);
  if (f.uints(TAG_SPP, &v)) {
    if (v[0] == 0) return false;  // read before the rest: a bad value fails the directory
    im->spp = int(v[0]);
  }
  if (f.uints(TAG_BPS, &v)) {
    for (uint64_t b : v)
      if (b != v[0]) return false;  // "Cannot handle different values per sample"
    im->bps = int(v[0]);
  }
  im->compression = int(f.uint1(TAG_COMPRESSION, 1));
  if (f.uints(TAG_PHOTOMETRIC, &v)) im->photometric = int(v[0]);
  const uint64_t fo = f.uint1(TAG_FILLORDER, 1);
  im->fillorder = fo == 2 ? 2 : 1;
  const uint64_t orient = f.uint1(TAG_ORIENTATION, 1);
  im->orientation = orient >= 1 && orient <= 8 ? int(orient) : 1;
  const uint64_t pc = f.uint1(TAG_PLANAR, 1);
  if (pc != 1 && pc != 2) return false;  // read in the directory's first pass: fatal
  im->planar = int(pc);
  im->predictor = int(f.uint1(TAG_PREDICTOR, 1));
  im->inkset = int(f.uint1(TAG_INKSET, 1));
  im->sampleformat = int(f.uint1(TAG_SAMPLEFORMAT, 1));
  im->rps = f.uint1(TAG_RPS, 0xFFFFFFFFu);
  if (im->rps == 0) return false;  // first pass: fatal
  if (f.uints(TAG_EXTRASAMPLES, &v)) {  // setExtraSamples, first pass: a bad value is fatal
    if (v.size() > size_t(im->spp)) return false;
    for (auto& x : v) {
      if (x == 999) x = 2;  // Corel Draw's unassociated alpha
      else if (x > 2) return false;
    }
    im->extras = int(v.size());
    im->sampleinfo0 = int(v[0]);
    im->sampleinfo_last = int(v.back());
  }
  // tif_dirread.c: channels past the photometric's colours are extra samples
  static const std::map<int, int> kColours = {{PH_MINISWHITE, 1}, {PH_MINISBLACK, 1}, {PH_PALETTE, 1},
                                              {PH_RGB, 3}, {PH_CIELAB, 3}, {PH_YCBCR, 3},
                                              {PH_SEPARATED, 4}, {PH_LOGL, 1}, {PH_LOGLUV, 3}};
  {  // an unset Photometric reads as 0, min-is-white: one colour channel
    auto it = kColours.find(im->photometric >= 0 ? im->photometric : PH_MINISWHITE);
    if (it != kColours.end() && im->spp - im->extras > it->second) {
      if (im->extras == 0) im->sampleinfo0 = 0;
      im->sampleinfo_last = 0;  // the samples added are unspecified
      im->extras = im->spp - it->second;
    }
  }
  if (im->compression == CMP_LERC && f.uints(TAG_LERC_PARAMETERS, &v) && v.size() >= 2)  // version, compression
    im->lerc_add = v[1] > 2 ? -1 : int(v[1]);
  if (f.uints(TAG_YCC_SUB, &v) && v.size() >= 2) {
    im->ycc_h = int(v[0]);
    im->ycc_v = int(v[1]);
    im->ycc_sub_tag = true;
  }
  if (f.uints(TAG_COLORMAP, &v) && im->bps <= 24 && v.size() == 3 * (size_t(1) << im->bps))
    im->cmap.assign(v.begin(), v.end());
  if (im->photometric == PH_PALETTE && im->cmap.empty()) {  // tif_dirread.c's fix-up
    if (im->bps >= 8 && im->spp == 3) im->photometric = PH_RGB;
    else if (im->bps >= 8) im->photometric = PH_MINISBLACK;
    else return false;
  }
  const bool has_tw = f.find(TAG_TILE_W) != nullptr, has_th = f.find(TAG_TILE_H) != nullptr;
  if (has_tw || has_th) {
    im->tiled = true;
    im->tw = uint32_t(f.uint1(TAG_TILE_W, 0));
    im->th = uint32_t(f.uint1(TAG_TILE_H, 0));
    if (im->tw == 0 || im->th == 0) return false;
  }
  if (im->width == 0 || im->height == 0) return false;
  const int offs_tag = im->tiled ? TAG_TILE_OFFSETS : TAG_STRIP_OFFSETS;
  const int cnts_tag = im->tiled ? TAG_TILE_COUNTS : TAG_STRIP_COUNTS;
  if (!f.uints(offs_tag, &im->offsets) && !f.uints(im->tiled ? TAG_STRIP_OFFSETS : TAG_TILE_OFFSETS, &im->offsets))
    return false;
  const bool have_counts =
      f.uints(cnts_tag, &im->counts) || f.uints(im->tiled ? TAG_STRIP_COUNTS : TAG_TILE_COUNTS, &im->counts);
  const uint64_t planes = im->planar == 2 ? uint64_t(im->spp) : 1;
  const uint64_t segs = planes * (im->tiled ? uint64_t(im->across()) * im->down() : im->strips_per_plane());
  im->offsets.resize(size_t(segs), 0);  // missing entries read as 0 (TIFFFetchStripThing)
  if (have_counts) {
    im->counts.resize(size_t(segs), 0);
    if (!im->tiled && im->compression == CMP_NONE) repair_strips(im);
  } else if (!estimate_counts(im)) {
    return false;
  }
  return true;
}

// JPEG strips or tiles, each taken as gtStripContig and gtTileContig take
// it at stop_on_error 0 into their segment buffer. A segment that
// TIFFFillStrip fails (unreadable, or refused by libjpeg's header read or by
// JPEGPreDecode, which it calls) fails the image while no segment has been
// decoded (TIFF_SKIP), and after that leaves the buffer as it was: M_SOURCE
// the last segment decoded. One that passes is decoded into the buffer (with
// pixels, its coefficients appended), over part of it only where its stream
// is narrower or shorter than the segment (the caller keeps the rest as it
// was). Markers after a one-scan segment's scan are not read: where
// jpeg_finish_decompress refuses them, libtiff keeps the rows it decoded.
// Returns a route.
int read_jpeg(const Image& im, bool pixels, TiffImage* out) {
  const Ifd& f = *im.ifd;
  if (im.planar == 2 && im.spp > 1) return TIFF_PIL;
  int color;
  if (im.photometric == PH_YCBCR && im.spp == 3) color = COLOR_YCC;
  else if (im.photometric == PH_RGB && im.spp == 3) color = COLOR_RGB;
  else if (im.photometric == PH_MINISBLACK && im.spp == 1) color = COLOR_GREY;
  else return TIFF_PIL;
  if (im.bps != 8 || im.extras != 0) return TIFF_PIL;
  const Ifd::Entry* t = f.find(TAG_JPEGTABLES);
  const uint8_t* tables = t ? f.d + t->at : nullptr;
  const size_t tlen = t ? size_t(t->count * uint64_t(type_size(t->type))) : 0;
  if (tables && (tlen < 4 || tables[0] != 0xFF || tables[1] != 0xD8)) return TIFF_SKIP;  // "Bogus JPEGTables"
  const size_t nseg = im.offsets.size();
  const uint32_t seg_w = im.tiled ? im.tw : im.width;
  const uint32_t seg_h = im.tiled ? im.th : uint32_t(im.rows_per_strip());
  int hs = 1, vs = 1;
  if (color == COLOR_YCC) {
    hs = im.ycc_h;
    vs = im.ycc_v;
  }
  out->metas.assign(nseg * META_INTS, 0);
  out->coef.clear();
  std::vector<uint8_t> flipped;
  int32_t last = -1;  // the segment whose decode the buffer holds
  uint64_t coefs = 0;
  for (size_t s = 0; s < nseg; ++s) {
    int32_t* meta = out->metas.data() + s * META_INTS;
    const uint8_t* raw = nullptr;
    size_t cc = 0;
    int kind = KIND_UNREADABLE;
    if (im.readable(s)) {
      raw = f.d + im.offsets[s];
      cc = size_t(im.counts[s]);
      if (im.fillorder == 2) {
        flipped.assign(raw, raw + cc);
        for (auto& b : flipped) b = uint8_t((b * 0x0202020202ULL & 0x010884422010ULL) % 1023);
        raw = flipped.data();
      }
      kind = decode_jpeg_segment(tables, tlen, raw, cc, meta, nullptr);
    }
    bool ok = kind == KIND_BASELINE;
    if (ok && s == 0 && color == COLOR_YCC && !im.ycc_sub_tag && meta[M_NCOMP] == im.spp) {
      // JPEGFixupTagsSubsampling: the first segment's luma sampling
      hs = meta[COMP_BASE + C_H];
      vs = meta[COMP_BASE + C_V];
    }
    // JPEGPreDecode's refusals, in its order
    const uint32_t rows = im.tiled ? seg_h : std::min<uint32_t>(seg_h, im.height - uint32_t(s) * seg_h);
    const uint32_t jw = uint32_t(meta[M_WIDTH]), jh = uint32_t(meta[M_HEIGHT]);
    if (ok) {  // a last strip's stream may run taller than its rows
      const bool taller_last = !im.tiled && s + 1 == nseg && jw == seg_w && jh > rows;
      ok = taller_last || (jw <= seg_w && jh <= rows);
    }
    ok = ok && meta[M_NCOMP] == im.spp;
    for (int c = 0; ok && c < meta[M_NCOMP]; ++c) {
      const int32_t* m = meta + COMP_BASE + COMP_INTS * c;
      ok = c == 0 ? m[C_H] == hs && m[C_V] == vs : m[C_H] == 1 && m[C_V] == 1;
    }
    if (!ok) {
      if (last < 0) return TIFF_SKIP;
      std::memset(meta, 0, sizeof(int32_t) * META_INTS);
      meta[M_KIND] = KIND_REFUSED;
      meta[M_SOURCE] = last;
      continue;
    }
    if (pixels && decode_jpeg_segment(tables, tlen, raw, cc, meta, &out->coef) != KIND_BASELINE) return TIFF_SKIP;
    meta[M_COLOR] = color;
    meta[M_SOURCE] = last = int32_t(s);
    coefs += uint64_t(meta[M_COEFS]);
  }
  if (coefs > 0x7FFFFFFF) return TIFF_SKIP;
  out->meta[M_COEFS] = int32_t(coefs);
  out->meta[T_SEGMENTS] = int32_t(nseg);
  out->meta[T_SEG_W] = int32_t(seg_w);
  out->meta[T_SEG_H] = int32_t(seg_h);
  out->meta[T_ACROSS] = int32_t(im.tiled ? im.across() : 1);
  out->meta[T_TILED] = im.tiled ? 1 : 0;
  return TIFF_JPEG;
}

}  // namespace

void read_tiff(const uint8_t* d, size_t n, bool pixels, TiffImage* out) {
  std::memset(out->meta, 0, sizeof(out->meta));
  out->rgb.resize(0);
  out->metas.clear();
  out->coef.clear();
  out->meta[M_KIND] = KIND_TIFF;
  out->meta[T_ROUTE] = TIFF_SKIP;
  Ifd f;
  f.d = d;
  f.n = n;
  Image im;
  Converter cv;
  cv.im = &im;
  if (!f.parse() || !read_fields(f, &im)) return;
  int route = choose(&im, &cv);
  if (route == TIFF_JPEG) route = read_jpeg(im, pixels, out);
  if (route == TIFF_RASTER && uint64_t(im.width) * im.height > (uint64_t(1) << 31) / 3) route = TIFF_SKIP;
  out->meta[M_WIDTH] = out->meta[M_OUT_W] = int32_t(im.width);
  out->meta[M_HEIGHT] = out->meta[M_OUT_H] = int32_t(im.height);
  // setorientation at ORIENTATION_TOPLEFT: 2 and 6 mirrored, 3 and 7 turned
  // half round, 4 and 8 upside down
  static const int kFlip[9] = {0, 0, 1, 3, 2, 0, 1, 3, 2};
  out->meta[T_FLIP] = kFlip[im.orientation];
  if (route == TIFF_RASTER && pixels) {  // the flips are the caller's, on the raster's device
    out->rgb.resize(size_t(im.width) * im.height * 3);
    if (!get_image(&im, cv, out->rgb.data.get())) {
      out->rgb.resize(0);
      route = TIFF_SKIP;
    }
  }
  if (route != TIFF_JPEG) {
    out->metas.clear();
    out->coef.clear();
  }
  out->meta[T_ROUTE] = route;
}

}  // namespace aq

extern "C" {

// One strip's codec alone (tests): compression 1, 5, 8/32946, 32773, 50000,
// 50001 (a segment of the stream's own size, 3 or 4 samples by occ), 32909
// (PixarLog's zlib stream inflated, its words not yet accumulated) or
// 34661 (a BIE in jbigkit's bit order) of n bytes at src into occ bytes at
// out. Returns 1 where libtiff's decode succeeds.
int aq_tiff_codec(int compression, const uint8_t* src, long n, uint8_t* out, long occ) {
  switch (compression) {
    case aq::CMP_NONE:
      if (n < occ) return 0;
      std::memcpy(out, src, size_t(occ));
      return 1;
    case aq::CMP_PACKBITS: return aq::unpack_bits(src, size_t(n), out, size_t(occ)) ? 1 : 0;
    case aq::CMP_LZW: return aq::lzw_decode(src, size_t(n), out, size_t(occ), n >= 2 && src[0] == 0 && (src[1] & 1)) ? 1 : 0;
    case aq::CMP_DEFLATE: case aq::CMP_DEFLATE_OLD: return aq::inflate_zlib(src, size_t(n), out, size_t(occ), aq::INFLATE_LIBDEFLATE) ? 1 : 0;
    case aq::CMP_WEBP: {
      aq::WebpFeatures f;
      if (!aq::webp_features(src, size_t(n), &f)) return 0;
      const long px = long(f.width) * f.height;
      const int spp = px > 0 && occ % px == 0 ? int(occ / px) : 0;
      if (spp != 3 && spp != 4) return 0;
      std::vector<uint8_t> buf;
      return aq::webp_segment(src, size_t(n), out, uint64_t(occ), uint32_t(f.width), uint32_t(f.height), spp, &buf) ? 1 : 0;
    }
    case aq::CMP_PIXARLOG: return aq::inflate_zlib(src, size_t(n), out, size_t(occ), aq::INFLATE_ZLIB) ? 1 : 0;
    case aq::CMP_JBIG: return aq::jbig_decode(src, size_t(n), false, out, uint64_t(occ)) ? 1 : 0;
    case aq::CMP_ZSTD: return aq::zstd_tiff_decode(src, size_t(n), out, size_t(occ)) ? 1 : 0;
    default: return 0;
  }
}

}  // extern "C"
