// The WebP codec of the device loader's TIFF reader: libwebp 1.2.4's
// decoder as tif_webp.c 4.5.0 drives it (WebPGetInfo, WebPGetFeatures,
// then WebPINewDecoder on the caller's buffer and one WebPIAppend of the
// whole strip or tile), byte for byte, written from the format
// (RFC 6386 for VP8, RFC 9649 for VP8L and the container) and libwebp's
// own choices where the format leaves them open:
// - the container: RIFF, VP8X, ALPH and the VP8 / VP8L chunk, with
//   ParseHeadersInternal's size checks;
// - VP8L (src/dec/vp8l_dec.c, utils/huffman_utils.c, dsp/lossless.c): the
//   bit reader with its end-of-stream rule, simple and normal Huffman codes,
//   the meta-Huffman image, the colour cache, LZ77 through the 120 plane
//   codes, the predictor (modes 0-13; 14 and 15 black), cross-colour,
//   subtract-green and colour-indexing transforms with pixel bundling;
// - ALPH (alpha_dec.c, dsp/filters.c): raw or VP8L-coded, horizontal,
//   vertical and gradient unfiltering, no dithering;
// - VP8 (vp8_dec.c, tree_dec.c, quant_dec.c, frame_dec.c, dsp/dec.c): the
//   boolean decoder, the frame, segment and filter headers, 1-8 token
//   partitions, the coefficient probabilities, i16 / i4 / chroma
//   prediction with libwebp's 127 / 129 borders, dequantisation, the
//   inverse WHT and DCT, the simple and normal loop filters with
//   PrecomputeFilterStrengths' levels;
// - the output (io_dec.c, dsp/upsampling.c, dsp/yuv.h): fancy upsampling
//   (EmitFancyRGB) through the 14-bit VP8YuvToRgb, alpha straight,
//   VP8L's ARGB as VP8LConvertFromBGRA gives it.
// The incremental decoder's behaviour on a stream that fails or ends early
// is part of the result: what it had written into the caller's buffer
// stays there (webp_decode.h).

#include "webp_decode.h"

#include <algorithm>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <vector>

namespace aq {
namespace {

inline uint32_t le16(const uint8_t* p) { return uint32_t(p[0]) | uint32_t(p[1]) << 8; }
inline uint32_t le24(const uint8_t* p) { return le16(p) | uint32_t(p[2]) << 16; }
inline uint32_t le32(const uint8_t* p) { return le24(p) | uint32_t(p[3]) << 24; }

constexpr size_t kChunkHeader = 8, kRiffHeader = 12, kVp8xChunk = 10;
constexpr size_t kVp8FrameHeader = 10, kVp8lFrameHeader = 5;
constexpr uint32_t kMaxChunkPayload = ~0u - uint32_t(kChunkHeader) - 1;
constexpr uint32_t kAnimationFlag = 0x02;

// ================================================================ VP8L

// VP8LBitReader: 64 bits prefetched, little-endian; reading past the end
// gives zeros and sets eos once more bits were used than the data holds
// (or than the 64 the reader holds, on data shorter than 8 bytes).
struct LBits {
  const uint8_t* buf = nullptr;
  size_t len = 0, pos = 0;
  uint64_t val = 0;
  int bit_pos = 0;
  bool eos = false;

  void init(const uint8_t* s, size_t n) {
    len = n;
    val = 0;
    bit_pos = 0;
    eos = false;
    const size_t k = std::min<size_t>(n, 8);
    for (size_t i = 0; i < k; ++i) val |= uint64_t(s[i]) << (8 * i);
    pos = k;
    buf = s;
  }
  bool at_end() const { return eos || (pos == len && bit_pos > 64); }
  void set_eos() {
    eos = true;
    bit_pos = 0;
  }
  uint32_t prefetch() const { return uint32_t(val >> (bit_pos & 63)); }
  void shift_bytes() {
    while (bit_pos >= 8 && pos < len) {
      val >>= 8;
      val |= uint64_t(buf[pos]) << 56;
      ++pos;
      bit_pos -= 8;
    }
    if (at_end()) set_eos();
  }
  void fill() {
    if (bit_pos < 32) return;
    if (pos + 8 < len) {
      val >>= 32;
      bit_pos -= 32;
      uint32_t w;
      std::memcpy(&w, buf + pos, 4);
      val |= uint64_t(w) << 32;
      pos += 4;
      return;
    }
    shift_bytes();
  }
  uint32_t read(int n) {
    if (!eos && n <= 24) {
      const uint32_t v = prefetch() & ((1u << n) - 1);
      bit_pos += n;
      shift_bytes();
      return v;
    }
    set_eos();
    return 0;
  }
};

struct HuffmanCode {
  uint8_t bits;
  uint16_t value;
};

constexpr int kHuffmanTableBits = 8;
constexpr int kMaxCodeLength = 15;

int next_key(int key, int len) {
  int step = 1 << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

void replicate(HuffmanCode* table, int step, int end, HuffmanCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

// BuildHuffmanTable: the table's size, 0 for a code libwebp refuses; with
// root null only the size (and the checks).
int build_table(HuffmanCode* root, int root_bits, const int* lengths, int n) {
  int count[kMaxCodeLength + 1] = {};
  int offset[kMaxCodeLength + 1];
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > kMaxCodeLength) return 0;
    ++count[lengths[s]];
  }
  if (count[0] == n) return 0;
  offset[1] = 0;
  for (int len = 1; len < kMaxCodeLength; ++len) {
    if (count[len] > (1 << len)) return 0;
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<uint16_t> sorted(static_cast<size_t>(n));
  for (int s = 0; s < n; ++s)
    if (lengths[s] > 0) sorted[size_t(offset[lengths[s]]++)] = uint16_t(s);
  int total = 1 << root_bits;
  if (offset[kMaxCodeLength] == 1) {  // one symbol: a code of no bits
    if (root) replicate(root, 1, total, HuffmanCode{0, sorted[0]});
    return total;
  }
  HuffmanCode* table = root;
  int key = 0, num_nodes = 1, num_open = 1, table_bits = root_bits, table_size = 1 << root_bits, symbol = 0;
  const int mask = total - 1;
  int low = -1;
  for (int len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    if (!root) continue;
    for (; count[len] > 0; --count[len]) {
      replicate(&table[key], step, table_size, HuffmanCode{uint8_t(len), sorted[size_t(symbol++)]});
      key = next_key(key, len);
    }
  }
  for (int len = root_bits + 1, step = 2; len <= kMaxCodeLength; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        if (root) table += table_size;
        // NextTableBitSize
        int l = len, left = 1 << (len - root_bits);
        while (l < kMaxCodeLength) {
          left -= count[l];
          if (left <= 0) break;
          ++l;
          left <<= 1;
        }
        table_bits = l - root_bits;
        table_size = 1 << table_bits;
        total += table_size;
        low = key & mask;
        if (root) {
          root[low].bits = uint8_t(table_bits + root_bits);
          root[low].value = uint16_t((table - root) - low);
        }
      }
      if (root)
        replicate(&table[key >> root_bits], step, table_size,
                  HuffmanCode{uint8_t(len - root_bits), sorted[size_t(symbol++)]});
      key = next_key(key, len);
    }
  }
  if (num_nodes != 2 * offset[kMaxCodeLength] - 1) return 0;
  return total;
}

int read_symbol(const HuffmanCode* table, LBits* br) {
  uint32_t val = br->prefetch();
  table += val & ((1u << kHuffmanTableBits) - 1);
  const int nbits = table->bits - kHuffmanTableBits;
  if (nbits > 0) {
    br->bit_pos += kHuffmanTableBits;
    val = br->prefetch();
    table += table->value;
    table += val & ((1u << nbits) - 1);
  }
  br->bit_pos += table->bits;
  return table->value;
}

enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
constexpr int kNumLiteralCodes = 256, kNumLengthCodes = 24, kNumDistanceCodes = 40;
constexpr int kAlphabetSize[5] = {kNumLiteralCodes + kNumLengthCodes, 256, 256, 256, kNumDistanceCodes};
constexpr int kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

struct HTreeGroup {
  const HuffmanCode* htrees[5];
  bool trivial_literal = false, trivial_code = false;
  uint32_t literal_arb = 0;
};

// The 120 short distance codes (x, y): a distance of x + y * xsize.
constexpr int8_t kPlaneCodes[120][2] = {
    {0, 1}, {1, 0}, {1, 1}, {-1, 1}, {0, 2}, {2, 0}, {1, 2}, {-1, 2}, {2, 1}, {-2, 1}, {2, 2}, {-2, 2},
    {0, 3}, {3, 0}, {1, 3}, {-1, 3}, {3, 1}, {-3, 1}, {2, 3}, {-2, 3}, {3, 2}, {-3, 2}, {0, 4}, {4, 0},
    {1, 4}, {-1, 4}, {4, 1}, {-4, 1}, {3, 3}, {-3, 3}, {2, 4}, {-2, 4}, {4, 2}, {-4, 2}, {0, 5}, {3, 4},
    {-3, 4}, {4, 3}, {-4, 3}, {5, 0}, {1, 5}, {-1, 5}, {5, 1}, {-5, 1}, {2, 5}, {-2, 5}, {5, 2}, {-5, 2},
    {4, 4}, {-4, 4}, {3, 5}, {-3, 5}, {5, 3}, {-5, 3}, {0, 6}, {6, 0}, {1, 6}, {-1, 6}, {6, 1}, {-6, 1},
    {2, 6}, {-2, 6}, {6, 2}, {-6, 2}, {4, 5}, {-4, 5}, {5, 4}, {-5, 4}, {3, 6}, {-3, 6}, {6, 3}, {-6, 3},
    {0, 7}, {7, 0}, {1, 7}, {-1, 7}, {5, 5}, {-5, 5}, {7, 1}, {-7, 1}, {4, 6}, {-4, 6}, {6, 4}, {-6, 4},
    {2, 7}, {-2, 7}, {7, 2}, {-7, 2}, {3, 7}, {-3, 7}, {7, 3}, {-7, 3}, {5, 6}, {-5, 6}, {6, 5}, {-6, 5},
    {8, 0}, {4, 7}, {-4, 7}, {7, 4}, {-7, 4}, {8, 1}, {8, 2}, {6, 6}, {-6, 6}, {8, 3}, {5, 7}, {-5, 7},
    {7, 5}, {-7, 5}, {8, 4}, {6, 7}, {-6, 7}, {7, 6}, {-7, 6}, {8, 5}, {7, 7}, {-7, 7}, {8, 6}, {8, 7},
};

int plane_code_to_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  const int dist = kPlaneCodes[code - 1][0] + kPlaneCodes[code - 1][1] * xsize;
  return dist >= 1 ? dist : 1;
}

int copy_length(int sym, LBits* br) {  // GetCopyDistance / GetCopyLength
  if (sym < 4) return sym + 1;
  const int extra = (sym - 2) >> 1;
  const int offset = (2 + (sym & 1)) << extra;
  return offset + int(br->read(extra)) + 1;
}

inline int sub_sample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

enum TransformType { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

// A level's codes (VP8LMetadata): the colour cache, the meta-Huffman image
// and the groups of five codes.
struct Meta {
  int cache_bits = 0;
  std::vector<uint32_t> cache;
  int huffman_bits = 0, huffman_xsize = 0, huffman_mask = ~0;
  std::vector<uint32_t> huffman_image;
  std::vector<HTreeGroup> groups;
  std::vector<HuffmanCode> tables;

  const HTreeGroup* group_at(int x, int y) const {
    if (huffman_bits == 0) return &groups[0];
    return &groups[huffman_image[size_t(huffman_xsize) * size_t(y >> huffman_bits) + size_t(x >> huffman_bits)]];
  }
  void cache_insert(uint32_t argb) { cache[(0x1e35a7bdu * argb) >> (32 - cache_bits)] = argb; }
};

// How DecodeImageData's loop ended.
enum DecodeEnd { REACHED = 0, EOS = 1, BAD = 2 };

struct Vp8l {
  LBits br;
  Transform transforms[4];
  int ntransforms = 0;
  uint32_t seen = 0;
  Meta hdr;  // the level being read (level 0 once the header is done)
  int width = 0, height = 0;

  bool read_code(int alphabet, std::vector<int>& lengths, std::vector<HuffmanCode>* tables, size_t* at, int* root_bits0) {
    std::fill(lengths.begin(), lengths.begin() + alphabet, 0);
    bool ok;
    if (br.read(1)) {  // simple
      const int nsym = int(br.read(1)) + 1;
      const int first8 = int(br.read(1));
      int sym = int(br.read(first8 == 0 ? 1 : 8));
      lengths[size_t(sym)] = 1;
      if (nsym == 2) {
        sym = int(br.read(8));
        lengths[size_t(sym)] = 1;
      }
      ok = true;
    } else {
      int cl[19] = {};
      const int ncodes = int(br.read(4)) + 4;
      for (int i = 0; i < ncodes; ++i) cl[kCodeLengthCodeOrder[i]] = int(br.read(3));
      ok = read_code_lengths(cl, alphabet, lengths);
    }
    ok = ok && !br.eos;
    if (!ok) return false;
    const int size = build_table(nullptr, kHuffmanTableBits, lengths.data(), alphabet);
    if (size == 0) return false;
    if (tables) {
      if (tables->size() < *at + size_t(size)) tables->resize(*at + size_t(size));
      build_table(tables->data() + *at, kHuffmanTableBits, lengths.data(), alphabet);
      *root_bits0 = (*tables)[*at].bits;
      *at += size_t(size);
    }
    return true;
  }

  bool read_code_lengths(const int* cl, int nsym, std::vector<int>& lengths) {
    HuffmanCode table[1 << 7];
    if (!build_table(nullptr, 7, cl, 19)) return false;
    build_table(table, 7, cl, 19);
    int max_symbol;
    if (br.read(1)) {
      const int nbits = 2 + 2 * int(br.read(3));
      max_symbol = 2 + int(br.read(nbits));
      if (max_symbol > nsym) return false;
    } else {
      max_symbol = nsym;
    }
    int prev = 8, symbol = 0;
    while (symbol < nsym) {
      if (max_symbol-- == 0) break;
      br.fill();
      const HuffmanCode& p = table[br.prefetch() & 127];
      br.bit_pos += p.bits;
      const int len = p.value;
      if (len < 16) {
        lengths[size_t(symbol++)] = len;
        if (len != 0) prev = len;
      } else {
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        const int slot = len - 16;
        int repeat = int(br.read(kExtra[slot])) + kOffset[slot];
        if (symbol + repeat > nsym) return false;
        const int v = len == 16 ? prev : 0;
        while (repeat-- > 0) lengths[size_t(symbol++)] = v;
      }
    }
    return true;
  }

  // ReadHuffmanCodes into hdr (its cache_bits set by the caller).
  bool read_codes(int xsize, int ysize, bool level0) {
    int ngroups = 1;
    hdr.huffman_bits = 0;
    hdr.huffman_mask = ~0;
    hdr.huffman_image.clear();
    if (level0 && br.read(1)) {
      const int bits = int(br.read(3)) + 2;
      const int hx = sub_sample(xsize, bits), hy = sub_sample(ysize, bits);
      std::vector<uint32_t> image;
      const int cache_bits = hdr.cache_bits;
      if (!decode_image_stream(hx, hy, false, &image)) return false;
      hdr.cache_bits = cache_bits;
      hdr.huffman_bits = bits;
      hdr.huffman_xsize = hx;
      hdr.huffman_mask = (1 << bits) - 1;
      for (auto& v : image) {
        v = (v >> 8) & 0xffff;
        ngroups = std::max(ngroups, int(v) + 1);
      }
      hdr.huffman_image = std::move(image);
    }
    const int cache_size = hdr.cache_bits > 0 ? 1 << hdr.cache_bits : 0;
    std::vector<int> lengths(size_t(kAlphabetSize[0] + cache_size), 0);
    hdr.groups.assign(size_t(ngroups), HTreeGroup{});
    hdr.tables.clear();
    std::vector<size_t> starts(size_t(ngroups) * 5);
    std::vector<int> root_bits(size_t(ngroups) * 5);
    size_t at = 0;
    std::vector<bool> used(size_t(ngroups), hdr.huffman_bits == 0);
    for (uint32_t v : hdr.huffman_image) used[v] = true;
    for (int g = 0; g < ngroups; ++g) {
      for (int j = 0; j < 5; ++j) {
        const int alphabet = kAlphabetSize[j] + (j == 0 ? cache_size : 0);
        starts[size_t(g) * 5 + size_t(j)] = at;
        int rb = 0;
        if (!read_code(alphabet, lengths, used[size_t(g)] ? &hdr.tables : nullptr, &at, &rb)) return false;
        root_bits[size_t(g) * 5 + size_t(j)] = rb;
      }
    }
    for (int g = 0; g < ngroups; ++g) {
      if (!used[size_t(g)]) continue;
      HTreeGroup& h = hdr.groups[size_t(g)];
      int total = 0;
      bool trivial = true;
      for (int j = 0; j < 5; ++j) {
        h.htrees[j] = hdr.tables.data() + starts[size_t(g) * 5 + size_t(j)];
        const int rb = root_bits[size_t(g) * 5 + size_t(j)];
        if (j == RED || j == BLUE || j == ALPHA) trivial = trivial && rb == 0;
        total += rb;
      }
      h.trivial_literal = trivial;
      h.trivial_code = false;
      if (trivial) {
        h.literal_arb = uint32_t(h.htrees[ALPHA][0].value) << 24 | uint32_t(h.htrees[RED][0].value) << 16 |
                        h.htrees[BLUE][0].value;
        if (total == 0 && h.htrees[GREEN][0].value < kNumLiteralCodes) {
          h.trivial_code = true;
          h.literal_arb |= uint32_t(h.htrees[GREEN][0].value) << 8;
        }
      }
    }
    return true;
  }

  bool read_transform(int* xsize, int ysize) {
    const int type = int(br.read(2));
    if (seen & (1u << type)) return false;
    seen |= 1u << type;
    Transform& t = transforms[ntransforms++];
    t.type = type;
    t.xsize = *xsize;
    t.ysize = ysize;
    t.data.clear();
    switch (type) {
      case PREDICTOR:
      case CROSS_COLOR:
        t.bits = int(br.read(3)) + 2;
        return decode_image_stream(sub_sample(t.xsize, t.bits), sub_sample(t.ysize, t.bits), false, &t.data);
      case COLOR_INDEXING: {
        const int ncolors = int(br.read(8)) + 1;
        const int bits = ncolors > 16 ? 0 : ncolors > 4 ? 1 : ncolors > 2 ? 2 : 3;
        *xsize = sub_sample(t.xsize, bits);
        t.bits = bits;
        if (!decode_image_stream(ncolors, 1, false, &t.data)) return false;
        // ExpandColorMap: the palette's deltas summed bytewise, padded black
        // transparent to the bundling's 2, 4, 16 or 256 entries
        const int final_n = 1 << (8 >> bits);
        std::vector<uint32_t> map(size_t(final_n), 0);
        uint8_t* nd = reinterpret_cast<uint8_t*>(map.data());
        const uint8_t* od = reinterpret_cast<const uint8_t*>(t.data.data());
        std::memcpy(nd, od, 4);
        for (int i = 4; i < 4 * ncolors; ++i) nd[i] = uint8_t(od[i] + nd[i - 4]);
        t.data = std::move(map);
        return true;
      }
      default:
        return true;
    }
  }

  // DecodeImageStream: a level-0 image's header (transforms, cache, codes)
  // into hdr, or a sub-image decoded whole into out.
  bool decode_image_stream(int xsize, int ysize, bool level0, std::vector<uint32_t>* out) {
    int txs = xsize;
    if (level0) {
      while (br.read(1)) {
        if (!read_transform(&txs, ysize)) return false;
      }
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = int(br.read(4));
      if (cache_bits < 1 || cache_bits > 11) return false;
    }
    Meta saved;
    if (!level0) saved = std::move(hdr);
    hdr = Meta{};
    hdr.cache_bits = cache_bits;
    bool ok = read_codes(txs, ysize, level0);
    if (ok && cache_bits > 0) hdr.cache.assign(size_t(1) << cache_bits, 0);
    if (ok && level0) {
      width = txs;
      return true;
    }
    if (ok) {
      out->assign(size_t(txs) * size_t(ysize), 0);
      int pos = 0;
      const int end = decode_pixels(out->data(), txs, ysize, ysize, false, &pos);
      ok = end == REACHED && !br.eos;
    }
    hdr = std::move(saved);
    return ok;
  }

  // DecodeImageData over data (xs x ys), from *pos up to row last_row:
  // how its loop ended, *pos the pixels written. A failed decode of the
  // main image has let out its rows in whole groups of 16 (ProcessRows).
  int decode_pixels(uint32_t* data, int xs, int ys, int last_row, bool incremental, int* pos_io) {
    int pos = *pos_io;
    int row = pos / xs, col = pos % xs;
    const int end = xs * ys, last = xs * last_row;
    const int len_limit = kNumLiteralCodes + kNumLengthCodes;
    const int cache_limit = len_limit + (hdr.cache_bits > 0 ? 1 << hdr.cache_bits : 0);
    const int mask = hdr.huffman_mask;
    int last_cached = pos;
    const HTreeGroup* g = pos < last ? hdr.group_at(col, row) : nullptr;
    const bool cache = hdr.cache_bits > 0;
    int result = REACHED;
    while (pos < last) {
      if ((col & mask) == 0) g = hdr.group_at(col, row);
      int code;
      if (g->trivial_code) {
        data[pos] = g->literal_arb;
        goto advance_one;
      }
      br.fill();
      code = read_symbol(g->htrees[GREEN], &br);
      if (br.at_end()) {
        result = EOS;
        break;
      }
      if (code < kNumLiteralCodes) {
        if (g->trivial_literal) {
          data[pos] = g->literal_arb | uint32_t(code) << 8;
        } else {
          const int red = read_symbol(g->htrees[RED], &br);
          br.fill();
          const int blue = read_symbol(g->htrees[BLUE], &br);
          const int alpha = read_symbol(g->htrees[ALPHA], &br);
          if (br.at_end()) {
            result = EOS;
            break;
          }
          data[pos] = uint32_t(alpha) << 24 | uint32_t(red) << 16 | uint32_t(code) << 8 | uint32_t(blue);
        }
      advance_one:
        ++pos;
        ++col;
        if (col >= xs) {
          col = 0;
          ++row;
          if (cache)
            while (last_cached < pos) hdr.cache_insert(data[last_cached++]);
        }
      } else if (code < len_limit) {
        const int length = copy_length(code - kNumLiteralCodes, &br);
        const int dist_sym = read_symbol(g->htrees[DIST], &br);
        br.fill();
        const int dist = plane_code_to_distance(xs, copy_length(dist_sym, &br));
        if (br.at_end()) {
          result = EOS;
          break;
        }
        if (pos < dist || end - pos < length) {
          result = BAD;
          break;
        }
        for (int k = 0; k < length; ++k) data[pos + k] = data[pos + k - dist];
        pos += length;
        col += length;
        while (col >= xs) {
          col -= xs;
          ++row;
        }
        if (col & mask) g = hdr.group_at(col, row);
        if (cache)
          while (last_cached < pos) hdr.cache_insert(data[last_cached++]);
      } else if (code < cache_limit) {
        while (last_cached < pos) hdr.cache_insert(data[last_cached++]);
        data[pos] = hdr.cache[size_t(code - len_limit)];
        goto advance_one;
      } else {
        result = BAD;
        break;
      }
    }
    br.eos = br.at_end();
    *pos_io = pos;
    if (result == BAD) return BAD;
    if (incremental && br.eos && pos < last) return EOS;
    if ((incremental && pos >= last) || !br.eos) return REACHED;
    return BAD;
  }
};

inline uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }
inline uint32_t select(uint32_t a, uint32_t b, uint32_t c) {
  const int d = sub3(int(a >> 24), int(b >> 24), int(c >> 24)) +
                sub3(int((a >> 16) & 0xff), int((b >> 16) & 0xff), int((c >> 16) & 0xff)) +
                sub3(int((a >> 8) & 0xff), int((b >> 8) & 0xff), int((c >> 8) & 0xff)) +
                sub3(int(a & 0xff), int(b & 0xff), int(c & 0xff));
  return d <= 0 ? a : b;
}
inline uint32_t add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= clip255(uint32_t(int((c0 >> s) & 0xff) + int((c1 >> s) & 0xff) - int((c2 >> s) & 0xff))) << s;
  return out;
}
inline uint32_t add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = int((ave >> s) & 0xff), b = int((c2 >> s) & 0xff);
    out |= clip255(uint32_t(a + (a - b) / 2)) << s;
  }
  return out;
}
inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) | (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}

uint32_t predict(int mode, const uint32_t* out, int x, int width) {
  const uint32_t* up = out - width;
  const uint32_t L = out[x - 1];
  switch (mode) {
    case 1: return L;
    case 2: return up[x];
    case 3: return up[x + 1];
    case 4: return up[x - 1];
    case 5: return average2(average2(L, up[x + 1]), up[x]);
    case 6: return average2(L, up[x - 1]);
    case 7: return average2(L, up[x]);
    case 8: return average2(up[x - 1], up[x]);
    case 9: return average2(up[x], up[x + 1]);
    case 10: return average2(average2(L, up[x - 1]), average2(up[x], up[x + 1]));
    case 11: return select(up[x], L, up[x - 1]);
    case 12: return add_sub_full(L, up[x], up[x - 1]);
    case 13: return add_sub_half(L, up[x], up[x - 1]);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp pads them
  }
}

// VP8LInverseTransform over rows [y0, y1) of an image held whole (rows
// before y0 already final): in and out may be the same rows.
void inverse_transform(const Transform& t, int y0, int y1, const uint32_t* in, uint32_t* out) {
  const int width = t.xsize;
  switch (t.type) {
    case SUBTRACT_GREEN:
      for (size_t i = 0, n = size_t(y1 - y0) * size_t(width); i < n; ++i) {
        const uint32_t argb = in[i], green = (argb >> 8) & 0xff;
        uint32_t rb = argb & 0x00ff00ffu;
        rb += (green << 16) | green;
        out[i] = (argb & 0xff00ff00u) | (rb & 0x00ff00ffu);
      }
      break;
    case PREDICTOR: {
      int y = y0;
      if (y == 0) {
        out[0] = add_pixels(in[0], 0xff000000u);
        for (int x = 1; x < width; ++x) out[x] = add_pixels(in[x], out[x - 1]);
        in += width;
        out += width;
        ++y;
      }
      const int tiles = sub_sample(width, t.bits);
      for (; y < y1; ++y, in += width, out += width) {
        const uint32_t* modes = t.data.data() + size_t(y >> t.bits) * size_t(tiles);
        out[0] = add_pixels(in[0], out[-width]);
        for (int x = 1; x < width; ++x) {
          const int mode = int((modes[x >> t.bits] >> 8) & 0xf);
          out[x] = add_pixels(in[x], predict(mode, out, x, width));
        }
      }
      break;
    }
    case CROSS_COLOR: {
      const int tiles = sub_sample(width, t.bits);
      for (int y = y0; y < y1; ++y, in += width, out += width) {
        const uint32_t* codes = t.data.data() + size_t(y >> t.bits) * size_t(tiles);
        for (int x = 0; x < width; ++x) {
          const uint32_t code = codes[x >> t.bits];
          const int8_t g2r = int8_t(code & 0xff), g2b = int8_t((code >> 8) & 0xff), r2b = int8_t((code >> 16) & 0xff);
          const uint32_t argb = in[x];
          const int8_t green = int8_t(argb >> 8);
          int new_red = int((argb >> 16) & 0xff);
          int new_blue = int(argb & 0xff);
          new_red += (int(g2r) * green) >> 5;
          new_red &= 0xff;
          new_blue += (int(g2b) * green) >> 5;
          new_blue += (int(r2b) * int8_t(new_red)) >> 5;
          new_blue &= 0xff;
          out[x] = (argb & 0xff00ff00u) | uint32_t(new_red) << 16 | uint32_t(new_blue);
        }
      }
      break;
    }
    case COLOR_INDEXING: {
      // bottom up, so that out may hold in's packed rows at their start
      const int bpp = 8 >> t.bits, count_mask = (1 << t.bits) - 1, bit_mask = (1 << bpp) - 1;
      const int packed_w = sub_sample(width, t.bits);
      std::vector<uint32_t> row(static_cast<size_t>(packed_w));
      for (int y = y1 - 1; y >= y0; --y) {
        std::memcpy(row.data(), in + size_t(y - y0) * size_t(packed_w), size_t(packed_w) * 4);
        uint32_t* o = out + size_t(y - y0) * size_t(width);
        const uint32_t* src = row.data();
        uint32_t packed = 0;
        for (int x = 0; x < width; ++x) {
          if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
          o[x] = t.data[packed & uint32_t(bit_mask)];
          packed >>= bpp;
        }
      }
      break;
    }
  }
}

// The level-0 image's final ARGB rows [0, rows) from its decoded pixels
// (pw wide): the transforms undone in reverse order of reading.
void apply_transforms(const Vp8l& d, const uint32_t* pixels, int pw, int xsize, int rows, std::vector<uint32_t>* argb) {
  argb->resize(size_t(std::max(pw, xsize)) * size_t(rows));
  std::memcpy(argb->data(), pixels, size_t(pw) * size_t(rows) * 4);
  for (int n = d.ntransforms - 1; n >= 0; --n) {
    if (rows > 0) inverse_transform(d.transforms[n], 0, rows, argb->data(), argb->data());
  }
}

// ================================================================ ALPH

// The alpha plane of a lossy image (ALPHInit / ALPHDecode), decoded whole;
// good_rows(r): whether libwebp's request for rows [0, r) succeeds
// (VP8DecompressAlphaRows), which decides how far a lossy decode gets.
struct Alpha {
  bool init_ok = false;
  int width = 0, height = 0;
  bool whole = false;   // pre-processing: everything decoded at the first request
  int64_t fail_at = -1; // a request for rows up to r fails when fail_at < r * width
  std::vector<uint8_t> plane;

  void decode(const uint8_t* data, size_t size, int w, int h) {
    width = w;
    height = h;
    plane.assign(size_t(w) * size_t(h), 0);
    if (size <= 1) return;
    const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3, rsrv = data[0] >> 6;
    if (method > 1 || pre > 1 || rsrv != 0) return;
    whole = pre == 1;
    const uint8_t* src = data + 1;
    const size_t n = size - 1;
    std::vector<uint8_t> raw(size_t(w) * size_t(h));
    if (method == 0) {
      if (n < raw.size()) return;
      std::memcpy(raw.data(), src, raw.size());
      fail_at = int64_t(1) << 62;
    } else {
      Vp8l d;
      d.br.init(src, n);
      if (!d.decode_image_stream(w, h, true, nullptr)) return;
      const int pw = d.width;
      // DecodeAlphaData (one colour-indexing transform, no cache, one-symbol
      // red, blue and alpha) or DecodeImageData: the same pixels, different
      // rules at the end of the data
      bool eightbit = d.ntransforms == 1 && d.transforms[0].type == COLOR_INDEXING && d.hdr.cache_bits == 0;
      for (const auto& g : d.hdr.groups)
        eightbit = eightbit && g.htrees[RED][0].bits == 0 && g.htrees[BLUE][0].bits == 0 && g.htrees[ALPHA][0].bits == 0;
      std::vector<uint32_t> px(size_t(pw) * size_t(h), 0);
      int pos = 0;
      if (eightbit) {
        fail_at = decode_alpha_8b(&d, px.data(), pw, h);
        pos = int(std::min<int64_t>(fail_at, int64_t(pw) * h));
      } else {
        const int end = d.decode_pixels(px.data(), pw, h, h, false, &pos);
        fail_at = end == REACHED ? int64_t(1) << 62 : pos;
      }
      std::vector<uint32_t> argb;
      const int rows = std::min(h, pos / pw + 1);
      apply_transforms(d, px.data(), pw, w, rows, &argb);
      for (size_t i = 0, k = size_t(w) * size_t(rows); i < k; ++i) raw[i] = uint8_t(argb[i] >> 8);
      // the requests are in pixels of the full width
      if (fail_at < (int64_t(1) << 62)) fail_at = (fail_at / pw) * w + (fail_at % pw);
    }
    // WebPUnfilters: horizontal, vertical, gradient
    for (int y = 0; y < h; ++y) {
      const uint8_t* in = raw.data() + size_t(y) * size_t(w);
      uint8_t* out = plane.data() + size_t(y) * size_t(w);
      const uint8_t* prev = y > 0 ? out - w : nullptr;
      if (filter == 0) {
        std::memcpy(out, in, size_t(w));
      } else if (filter == 1 || prev == nullptr) {
        uint8_t pred = prev == nullptr ? 0 : prev[0];
        for (int i = 0; i < w; ++i) out[i] = pred = uint8_t(pred + in[i]);
      } else if (filter == 2) {
        for (int i = 0; i < w; ++i) out[i] = uint8_t(prev[i] + in[i]);
      } else {
        uint8_t top = prev[0], top_left = top, left = top;
        for (int i = 0; i < w; ++i) {
          top = prev[i];
          const int g = left + top - top_left;
          left = uint8_t(in[i] + ((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255));
          top_left = top;
          out[i] = left;
        }
      }
    }
    init_ok = true;
  }

  // DecodeAlphaData: literals written before the end-of-stream test, which
  // fails a request only short of the last pixel. Returns fail_at (in
  // pixels of the packed width).
  static int64_t decode_alpha_8b(Vp8l* d, uint32_t* data, int xs, int ys) {
    LBits& br = d->br;
    const Meta& hdr = d->hdr;
    int pos = 0, row = 0, col = 0;
    const int end = xs * ys;
    const int mask = hdr.huffman_mask;
    const HTreeGroup* g = hdr.group_at(0, 0);
    int64_t fail = int64_t(1) << 62;
    while (!br.eos && pos < end) {
      const int start = pos;
      if ((col & mask) == 0) g = hdr.group_at(col, row);
      br.fill();
      const int code = read_symbol(g->htrees[GREEN], &br);
      if (code < kNumLiteralCodes) {
        data[pos] = uint32_t(code) << 8;
        ++pos;
        ++col;
        if (col >= xs) {
          col = 0;
          ++row;
        }
      } else if (code < kNumLiteralCodes + kNumLengthCodes) {
        const int length = copy_length(code - kNumLiteralCodes, &br);
        const int dist_sym = read_symbol(g->htrees[DIST], &br);
        br.fill();
        const int dist = plane_code_to_distance(xs, copy_length(dist_sym, &br));
        if (pos >= dist && end - pos >= length) {
          for (int k = 0; k < length; ++k) data[pos + k] = data[pos + k - dist];
        } else {
          return start;
        }
        pos += length;
        col += length;
        while (col >= xs) {
          col -= xs;
          ++row;
        }
        if (pos < end && (col & mask)) g = hdr.group_at(col, row);
      } else {
        return start;
      }
      br.eos = br.at_end();
      if (br.eos && pos < end) fail = start;
    }
    return fail;
  }

  bool good_rows(int r) const { return init_ok && fail_at >= int64_t(whole ? height : r) * width; }
};

// ================================================================ VP8

// RFC 6386's tables: the quantiser steps, the default and update
// probabilities of the coefficients, and the key-frame probabilities of the
// 4 x 4 modes in libwebp's order of the modes (B_DC .. B_HU below).
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

// [type][band][context][proba]
const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

// [above][left][node], in libwebp's order of the 4x4 modes
const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
};

constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

// VP8BitReader: the boolean decoder, loading 7 bytes at a time while 8
// remain (as on a 64-bit host), then byte by byte; past the end, one zero
// byte and eof, then nothing more.
struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  uint32_t range = 254;
  int bits = -8;
  bool eof = false;

  void init(const uint8_t* s, size_t n) {
    range = 254;
    value = 0;
    bits = -8;
    eof = false;
    buf = s;
    end = s + n;
    load();
  }
  void load() {
    if (end - buf >= 8) {
      uint64_t v = 0;
      for (int i = 0; i < 7; ++i) v = (v << 8) | buf[i];
      buf += 7;
      value = (value << 56) | v;
      bits += 56;
    } else if (buf < end) {
      bits += 8;
      value = (value << 8) | *buf++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int get_bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * uint32_t(prob)) >> 8;
    const uint32_t v = uint32_t(value >> pos);
    int bit;
    if (v > split) {
      r -= split;
      value -= uint64_t(split + 1) << pos;
      bit = 1;
    } else {
      r = split + 1;
      bit = 0;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  int get_signed(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = uint32_t(value >> pos);
    const int32_t mask = int32_t(split - val) >> 31;
    bits -= 1;
    range += uint32_t(mask);
    range |= 1;
    value -= uint64_t((split + 1) & uint32_t(mask)) << pos;
    return (v ^ mask) - mask;
  }
  uint32_t get_value(int nbits) {
    uint32_t v = 0;
    while (nbits-- > 0) v |= uint32_t(get_bit(0x80)) << nbits;
    return v;
  }
  int get_signed_value(int nbits) {
    const int v = int(get_value(nbits));
    return get_value(1) ? -v : v;
  }
};

struct FInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev = 0;
};

struct MBData {
  int16_t coeffs[384];
  bool i4x4 = false;
  uint8_t imodes[16];
  uint8_t uvmode = 0, segment = 0, skip = 0;
  uint32_t nz_y = 0, nz_uv = 0;
};

enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU, DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6 };
constexpr int BPS = 32;
constexpr int Y_OFF = BPS * 1 + 8, U_OFF = Y_OFF + BPS * 16 + BPS, V_OFF = U_OFF + 16;

inline uint8_t clip8(int v) { return (v & ~0xff) == 0 ? uint8_t(v) : v < 0 ? 0 : 255; }
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// The inverse DCT of one 4 x 4 block added into dst: Transform (libwebp's
// SSE2 version, in 16-bit lanes), TransformAC3 and TransformDC (its C
// versions); the three agree wherever the coefficients are in range.
void transform_full(const int16_t* in, uint8_t* dst) {
  auto w = [](int v) { return int(int16_t(v)); };
  auto hi = [](int x, int k) { return (x * k) >> 16; };  // _mm_mulhi_epi16
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int i0 = in[i], i1 = in[4 + i], i2 = in[8 + i], i3 = in[12 + i];
    const int a = w(i0 + i2), b = w(i0 - i2);
    const int c = w(w(i1 - i3) + w(hi(i1, -30068) - hi(i3, 20091)));
    const int d = w(w(i1 + i3) + w(hi(i1, 20091) + hi(i3, -30068)));
    tmp[4 * i + 0] = w(a + d);
    tmp[4 * i + 1] = w(b + c);
    tmp[4 * i + 2] = w(b - c);
    tmp[4 * i + 3] = w(a - d);
  }
  for (int i = 0; i < 4; ++i) {
    const int t0 = tmp[i], t1 = tmp[4 + i], t2 = tmp[8 + i], t3 = tmp[12 + i];
    const int dc = w(t0 + 4);
    const int a = w(dc + t2), b = w(dc - t2);
    const int c = w(w(t1 - t3) + w(hi(t1, -30068) - hi(t3, 20091)));
    const int d = w(w(t1 + t3) + w(hi(t1, 20091) + hi(t3, -30068)));
    const int v[4] = {w(a + d) >> 3, w(b + c) >> 3, w(b - c) >> 3, w(a - d) >> 3};
    for (int x = 0; x < 4; ++x) dst[x + i * BPS] = clip8(dst[x + i * BPS] + v[x]);
  }
}

void transform_ac3(const int16_t* in, uint8_t* dst) {
  const int a = in[0] + 4;
  const int c4 = mul2(in[4]), d4 = mul1(in[4]), c1 = mul2(in[1]), d1 = mul1(in[1]);
  const int rows[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; ++y) {
    const int v[4] = {rows[y] + d1, rows[y] + c1, rows[y] - c1, rows[y] - d1};
    for (int x = 0; x < 4; ++x) dst[x + y * BPS] = clip8(dst[x + y * BPS] + (v[x] >> 3));
  }
}

void transform_dc(const int16_t* in, uint8_t* dst) {
  const int dc = in[0] + 4;
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) dst[x + y * BPS] = clip8(dst[x + y * BPS] + (dc >> 3));
}

// DoTransform: by the block's code (3 full, 2 the first three
// coefficients, 1 the DC alone).
void do_transform(uint32_t bits, const int16_t* in, uint8_t* dst) {
  switch (bits >> 30) {
    case 3: transform_full(in, dst); break;
    case 2: transform_ac3(in, dst); break;
    case 1: transform_dc(in, dst); break;
    default: break;
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
    out += 64;
  }
}

inline uint8_t avg3(int a, int b, int c) { return uint8_t((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y, dst += BPS)
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - top[-1]);
}

void pred_luma4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  auto D = [&](int x, int y) -> uint8_t& { return dst[x + y * BPS]; };
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS], X = top[-1];
  const int A = top[0], B = top[1], C = top[2], Dd = top[3], E = top[4], F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      dc >>= 3;
      for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, int(dc), 4);
      break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, Dd), avg3(C, Dd, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, v, 4);
      break;
    }
    case B_HE:
      std::memset(dst, avg3(X, I, J), 4);
      std::memset(dst + BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD:
      D(0, 3) = avg3(J, K, L);
      D(1, 3) = D(0, 2) = avg3(I, J, K);
      D(2, 3) = D(1, 2) = D(0, 1) = avg3(X, I, J);
      D(3, 3) = D(2, 2) = D(1, 1) = D(0, 0) = avg3(A, X, I);
      D(3, 2) = D(2, 1) = D(1, 0) = avg3(B, A, X);
      D(3, 1) = D(2, 0) = avg3(C, B, A);
      D(3, 0) = avg3(Dd, C, B);
      break;
    case B_VR:
      D(0, 0) = D(1, 2) = avg2(X, A);
      D(1, 0) = D(2, 2) = avg2(A, B);
      D(2, 0) = D(3, 2) = avg2(B, C);
      D(3, 0) = avg2(C, Dd);
      D(0, 3) = avg3(K, J, I);
      D(0, 2) = avg3(J, I, X);
      D(0, 1) = D(1, 3) = avg3(I, X, A);
      D(1, 1) = D(2, 3) = avg3(X, A, B);
      D(2, 1) = D(3, 3) = avg3(A, B, C);
      D(3, 1) = avg3(B, C, Dd);
      break;
    case B_LD:
      D(0, 0) = avg3(A, B, C);
      D(1, 0) = D(0, 1) = avg3(B, C, Dd);
      D(2, 0) = D(1, 1) = D(0, 2) = avg3(C, Dd, E);
      D(3, 0) = D(2, 1) = D(1, 2) = D(0, 3) = avg3(Dd, E, F);
      D(3, 1) = D(2, 2) = D(1, 3) = avg3(E, F, G);
      D(3, 2) = D(2, 3) = avg3(F, G, H);
      D(3, 3) = avg3(G, H, H);
      break;
    case B_VL:
      D(0, 0) = avg2(A, B);
      D(1, 0) = D(0, 2) = avg2(B, C);
      D(2, 0) = D(1, 2) = avg2(C, Dd);
      D(3, 0) = D(2, 2) = avg2(Dd, E);
      D(0, 1) = avg3(A, B, C);
      D(1, 1) = D(0, 3) = avg3(B, C, Dd);
      D(2, 1) = D(1, 3) = avg3(C, Dd, E);
      D(3, 1) = D(2, 3) = avg3(Dd, E, F);
      D(3, 2) = avg3(E, F, G);
      D(3, 3) = avg3(F, G, H);
      break;
    case B_HD:
      D(0, 0) = D(2, 1) = avg2(I, X);
      D(0, 1) = D(2, 2) = avg2(J, I);
      D(0, 2) = D(2, 3) = avg2(K, J);
      D(0, 3) = avg2(L, K);
      D(3, 0) = avg3(A, B, C);
      D(2, 0) = avg3(X, A, B);
      D(1, 0) = D(3, 1) = avg3(I, X, A);
      D(1, 1) = D(3, 2) = avg3(J, I, X);
      D(1, 2) = D(3, 3) = avg3(K, J, I);
      D(1, 3) = avg3(L, K, J);
      break;
    case B_HU:
      D(0, 0) = avg2(I, J);
      D(2, 0) = D(0, 1) = avg2(J, K);
      D(2, 1) = D(0, 2) = avg2(K, L);
      D(1, 0) = avg3(I, J, K);
      D(3, 0) = D(1, 1) = avg3(J, K, L);
      D(3, 1) = D(1, 2) = avg3(K, L, L);
      D(3, 2) = D(2, 2) = D(0, 3) = D(1, 3) = D(2, 3) = D(3, 3) = uint8_t(L);
      break;
  }
}

// 16 x 16 luma and 8 x 8 chroma: DC (and its edge variants), TM, V, H.
void pred_square(int mode, uint8_t* dst, int size) {
  const int sh = size == 16 ? 4 : 3;
  auto put = [&](int v) {
    for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size_t(size));
  };
  switch (mode) {
    case B_DC: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      put(dc >> (sh + 1));
      break;
    }
    case B_TM: true_motion(dst, size); break;
    case B_VE:
      for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size_t(size));
      break;
    case B_HE:
      for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], size_t(size));
      break;
    case DC_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      put(dc >> sh);
      break;
    }
    case DC_NOLEFT: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      put(dc >> sh);
      break;
    }
    default: put(0x80); break;
  }
}

inline int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC) {
    if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mb_y == 0 ? DC_NOTOP : B_DC;
  }
  return mode;
}

// The loop filters (dsp/dec.c's C versions).
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}
inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}
inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}
inline bool hev(const uint8_t* p, int step, int thresh) {
  return std::abs(p[-2 * step] - p[-step]) > thresh || std::abs(p[step] - p[0]) > thresh;
}
inline bool needs_filter(const uint8_t* p, int step, int t) {
  return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step]) <= t;
}
inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
}
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_t, bool edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t)) do_filter2(p, hstride);
    else if (edge) do_filter6(p, hstride);
    else do_filter4(p, hstride);
  }
}

struct Vp8 {
  BoolReader br;         // partition 0
  BoolReader parts[8];
  int nparts = 1;
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  // segment header
  bool use_segment = false, update_map = false, absolute_delta = true;
  int8_t quantizer[4] = {}, filter_strength[4] = {};
  uint8_t segment_probs[3] = {255, 255, 255};
  // filter header
  bool simple = false, use_lf_delta = false;
  int level = 0, sharpness = 0;
  int ref_lf_delta[4] = {}, mode_lf_delta[4] = {};
  int filter_type = 0;
  // quantisation, per segment: y1, y2, uv as {dc, ac}
  int y1[4][2], y2[4][2], uv[4][2];
  uint8_t proba[4][8][3][11];
  bool use_skip = false;
  int skip_p = 0;
  FInfo fstrengths[4][2];
  // per row / column state
  std::vector<uint8_t> intra_t;
  uint8_t intra_l[4];
  std::vector<uint8_t> nz, nz_dc;  // mb_w + 1: [0] is the left
  std::vector<MBData> mbs;
  std::vector<FInfo> finfo;
  // reconstruction
  uint8_t yuv_b[BPS * 17 + BPS * 9];
  std::vector<uint8_t> top_y, top_u, top_v;
  std::vector<uint8_t> Y, U, V;  // the frame, mb_w * 16 (8) wide
  int ystride = 0, uvstride = 0;

  int headers(const uint8_t* data, size_t size);
  void parse_intra_row();
  bool parse_residuals(int mb_x, BoolReader* tb);
  int get_coeffs(BoolReader* tb, int type, int ctx, const int* dq, int n, int16_t* out);
  void reconstruct_row(int mb_y);
  void filter_row(int mb_y);
};

// VP8GetHeaders, with DecodePartition0's reading of its status: what is
// short of data suspends the decoder.
int Vp8::headers(const uint8_t* data, size_t size) {
  if (size < 4) return WEBP_SUSPENDED;
  const uint32_t bits = le24(data);
  const bool key = !(bits & 1);
  const int profile = int((bits >> 1) & 7);
  const bool show = (bits >> 4) & 1;
  const uint32_t part_len = bits >> 5;
  if (profile > 3 || !show) return WEBP_ERROR;
  data += 3;
  size -= 3;
  if (!key) return WEBP_ERROR;
  if (size < 7) return WEBP_SUSPENDED;
  if (data[0] != 0x9d || data[1] != 0x01 || data[2] != 0x2a) return WEBP_ERROR;
  width = int(le16(data + 3) & 0x3fff);
  height = int(le16(data + 5) & 0x3fff);
  data += 7;
  size -= 7;
  mb_w = (width + 15) >> 4;
  mb_h = (height + 15) >> 4;
  if (part_len > size) return WEBP_SUSPENDED;
  br.init(data, part_len);
  data += part_len;
  size -= part_len;
  br.get_value(1);  // colour space
  br.get_value(1);  // clamping type
  // ParseSegmentHeader
  use_segment = br.get_value(1);
  if (use_segment) {
    update_map = br.get_value(1);
    if (br.get_value(1)) {
      absolute_delta = br.get_value(1);
      for (int s = 0; s < 4; ++s) quantizer[s] = int8_t(br.get_value(1) ? br.get_signed_value(7) : 0);
      for (int s = 0; s < 4; ++s) filter_strength[s] = int8_t(br.get_value(1) ? br.get_signed_value(6) : 0);
    }
    if (update_map)
      for (int s = 0; s < 3; ++s) segment_probs[s] = uint8_t(br.get_value(1) ? br.get_value(8) : 255);
  } else {
    update_map = false;
  }
  if (br.eof) return WEBP_ERROR;
  // ParseFilterHeader
  simple = br.get_value(1);
  level = int(br.get_value(6));
  sharpness = int(br.get_value(3));
  use_lf_delta = br.get_value(1);
  if (use_lf_delta && br.get_value(1)) {
    for (int i = 0; i < 4; ++i)
      if (br.get_value(1)) ref_lf_delta[i] = br.get_signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br.get_value(1)) mode_lf_delta[i] = br.get_signed_value(6);
  }
  filter_type = level == 0 ? 0 : simple ? 1 : 2;
  if (br.eof) return WEBP_ERROR;
  // ParsePartitions: the last partition takes the rest, the sizes clipped
  nparts = 1 << br.get_value(2);
  const size_t last = size_t(nparts - 1);
  if (size < 3 * last) return WEBP_SUSPENDED;
  const uint8_t* sz = data;
  const uint8_t* part = data + 3 * last;
  size_t left = size - 3 * last;
  for (size_t p = 0; p < last; ++p) {
    size_t psize = le24(sz);
    if (psize > left) psize = left;
    parts[p].init(part, psize);
    part += psize;
    left -= psize;
    sz += 3;
  }
  parts[last].init(part, left);
  if (part >= data + size) return WEBP_SUSPENDED;  // no data for the last partition
  // VP8ParseQuant
  const int base_q0 = int(br.get_value(7));
  int dq[5];
  for (int i = 0; i < 5; ++i) dq[i] = br.get_value(1) ? br.get_signed_value(4) : 0;
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int i = 0; i < 4; ++i) {
    int q;
    if (use_segment) {
      q = quantizer[i];
      if (!absolute_delta) q += base_q0;
    } else if (i > 0) {
      std::memcpy(y1[i], y1[0], sizeof(y1[0]));
      std::memcpy(y2[i], y2[0], sizeof(y2[0]));
      std::memcpy(uv[i], uv[0], sizeof(uv[0]));
      continue;
    } else {
      q = base_q0;
    }
    y1[i][0] = kDcTable[clip(q + dq[0], 127)];
    y1[i][1] = kAcTable[clip(q, 127)];
    y2[i][0] = kDcTable[clip(q + dq[1], 127)] * 2;
    y2[i][1] = (kAcTable[clip(q + dq[2], 127)] * 101581) >> 16;
    if (y2[i][1] < 8) y2[i][1] = 8;
    uv[i][0] = kDcTable[clip(q + dq[3], 117)];
    uv[i][1] = kAcTable[clip(q + dq[4], 127)];
  }
  br.get_value(1);  // update_proba, ignored
  // VP8ParseProba
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          proba[t][b][c][p] = uint8_t(br.get_bit(kCoeffsUpdateProba[t][b][c][p]) ? br.get_value(8) : kCoeffsProba0[t][b][c][p]);
  use_skip = br.get_value(1);
  if (use_skip) skip_p = int(br.get_value(8));
  // PrecomputeFilterStrengths
  if (filter_type > 0) {
    for (int s = 0; s < 4; ++s) {
      int base = level;
      if (use_segment) {
        base = filter_strength[s];
        if (!absolute_delta) base += level;
      }
      for (int i4 = 0; i4 <= 1; ++i4) {
        FInfo& f = fstrengths[s][i4];
        int lvl = base;
        if (use_lf_delta) {
          lvl += ref_lf_delta[0];
          if (i4) lvl += mode_lf_delta[0];
        }
        lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
        if (lvl > 0) {
          int il = lvl;
          if (sharpness > 0) {
            il >>= sharpness > 4 ? 2 : 1;
            if (il > 9 - sharpness) il = 9 - sharpness;
          }
          if (il < 1) il = 1;
          f.ilevel = uint8_t(il);
          f.limit = uint8_t(2 * lvl + il);
          f.hev = uint8_t(lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0);
        } else {
          f.limit = 0;
        }
        f.inner = uint8_t(i4);
      }
    }
  }
  intra_t.assign(size_t(4 * mb_w), B_DC);
  nz.assign(size_t(mb_w + 1), 0);
  nz_dc.assign(size_t(mb_w + 1), 0);
  mbs.assign(size_t(mb_w), MBData{});
  finfo.assign(size_t(mb_w), FInfo{});
  top_y.assign(size_t(16 * mb_w), 0);
  top_u.assign(size_t(8 * mb_w), 0);
  top_v.assign(size_t(8 * mb_w), 0);
  ystride = 16 * mb_w;
  uvstride = 8 * mb_w;
  Y.assign(size_t(ystride) * size_t(16 * mb_h), 0);
  U.assign(size_t(uvstride) * size_t(8 * mb_h), 0);
  V.assign(size_t(uvstride) * size_t(8 * mb_h), 0);
  std::memset(intra_l, B_DC, 4);
  return WEBP_OK;
}

void Vp8::parse_intra_row() {
  for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
    uint8_t* top = intra_t.data() + 4 * mb_x;
    MBData& b = mbs[size_t(mb_x)];
    b.segment = update_map ? uint8_t(!br.get_bit(segment_probs[0]) ? br.get_bit(segment_probs[1])
                                                                  : br.get_bit(segment_probs[2]) + 2)
                           : 0;
    if (use_skip) b.skip = uint8_t(br.get_bit(skip_p));
    b.i4x4 = !br.get_bit(145);
    if (!b.i4x4) {
      const int ymode = br.get_bit(156) ? (br.get_bit(128) ? B_TM : B_HE) : (br.get_bit(163) ? B_VE : B_DC);
      b.imodes[0] = uint8_t(ymode);
      std::memset(top, ymode, 4);
      std::memset(intra_l, ymode, 4);
    } else {
      uint8_t* modes = b.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = intra_l[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* p = kBModesProba[top[x]][ymode];
          ymode = !br.get_bit(p[0])   ? B_DC
                  : !br.get_bit(p[1]) ? B_TM
                  : !br.get_bit(p[2]) ? B_VE
                  : !br.get_bit(p[3]) ? (!br.get_bit(p[4]) ? B_HE : (!br.get_bit(p[5]) ? B_RD : B_VR))
                                      : (!br.get_bit(p[6])   ? B_LD
                                         : !br.get_bit(p[7]) ? B_VL
                                         : !br.get_bit(p[8]) ? B_HD
                                                             : B_HU);
          top[x] = uint8_t(ymode);
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        intra_l[y] = uint8_t(ymode);
      }
    }
    b.uvmode = uint8_t(!br.get_bit(142) ? B_DC : !br.get_bit(114) ? B_VE : br.get_bit(183) ? B_TM : B_HE);
  }
}

int Vp8::get_coeffs(BoolReader* tb, int type, int ctx, const int* dq, int n, int16_t* out) {
  const uint8_t* p = proba[type][kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!tb->get_bit(p[0])) return n;
    while (!tb->get_bit(p[1])) {
      p = proba[type][kBands[++n]][0];
      if (n == 16) return 16;
    }
    const uint8_t(*p_ctx)[11] = proba[type][kBands[n + 1]];
    int v;
    if (!tb->get_bit(p[2])) {
      v = 1;
      p = p_ctx[1];
    } else {
      if (!tb->get_bit(p[3])) {
        v = !tb->get_bit(p[4]) ? 2 : 3 + tb->get_bit(p[5]);
      } else if (!tb->get_bit(p[6])) {
        if (!tb->get_bit(p[7])) {
          v = 5 + tb->get_bit(159);
        } else {
          v = 7 + 2 * tb->get_bit(165);
          v += tb->get_bit(145);
        }
      } else {
        const int bit1 = tb->get_bit(p[8]);
        const int bit0 = tb->get_bit(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + tb->get_bit(*tab);
        v += 3 + (8 << cat);
      }
      p = p_ctx[2];
    }
    out[kZigzag[n]] = int16_t(tb->get_signed(v) * dq[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= uint32_t(nz > 3 ? 3 : nz > 1 ? 2 : dc_nz);
  return nz_coeffs;
}

// VP8DecodeMB's residuals (ParseResiduals) and filter info; false at the
// token partition's end.
bool Vp8::parse_residuals(int mb_x, BoolReader* tb) {
  MBData& block = mbs[size_t(mb_x)];
  uint8_t& mb_nz = nz[size_t(mb_x + 1)];
  uint8_t& mb_nz_dc = nz_dc[size_t(mb_x + 1)];
  uint8_t& left_nz = nz[0];
  uint8_t& left_nz_dc = nz_dc[0];
  int skip = use_skip ? block.skip : 0;
  if (!skip) {
    const int seg = block.segment;
    int16_t* dst = block.coeffs;
    std::memset(dst, 0, sizeof(block.coeffs));
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    int first, ac_type;
    if (!block.i4x4) {
      int16_t dc[16] = {};
      const int ctx = mb_nz_dc + left_nz_dc;
      const int nzv = get_coeffs(tb, 1, ctx, y2[seg], 0, dc);
      mb_nz_dc = left_nz_dc = uint8_t(nzv > 0);
      if (nzv > 1) {
        transform_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 256; i += 16) dst[i] = int16_t(dc0);
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint8_t tnz = mb_nz & 0x0f, lnz = left_nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nzv = get_coeffs(tb, ac_type, ctx, y1[seg], first, dst);
        l = nzv > first;
        tnz = uint8_t((tnz >> 1) | (l << 7));
        nz_coeffs = nz_code_bits(nz_coeffs, nzv, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = uint8_t((lnz >> 1) | (l << 7));
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz, out_l_nz = uint32_t(lnz >> 4);
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = uint8_t(mb_nz >> (4 + ch));
      lnz = uint8_t(left_nz >> (4 + ch));
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nzv = get_coeffs(tb, 2, ctx, uv[seg], 0, dst);
          l = nzv > 0;
          tnz = uint8_t((tnz >> 1) | (l << 3));
          nz_coeffs = nz_code_bits(nz_coeffs, nzv, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = uint8_t((lnz >> 1) | (l << 5));
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= uint32_t(tnz << 4) << ch;
      out_l_nz |= uint32_t(lnz & 0xf0) << ch;
    }
    mb_nz = uint8_t(out_t_nz);
    left_nz = uint8_t(out_l_nz);
    block.nz_y = non_zero_y;
    block.nz_uv = non_zero_uv;
    skip = !(non_zero_y | non_zero_uv);
  } else {
    left_nz = mb_nz = 0;
    if (!block.i4x4) left_nz_dc = mb_nz_dc = 0;
    block.nz_y = 0;
    block.nz_uv = 0;
  }
  if (filter_type > 0) {
    FInfo& f = finfo[size_t(mb_x)];
    f = fstrengths[block.segment][block.i4x4 ? 1 : 0];
    f.inner |= uint8_t(!skip);
  }
  return !tb->eof;
}

// ReconstructRow: prediction from the unfiltered samples around each
// macroblock, the residuals added, into the frame.
void Vp8::reconstruct_row(int mb_y) {
  uint8_t* const y_dst = yuv_b + Y_OFF;
  uint8_t* const u_dst = yuv_b + U_OFF;
  uint8_t* const v_dst = yuv_b + V_OFF;
  for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
  for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
  if (mb_y > 0) {
    y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
  } else {
    std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
    std::memset(u_dst - BPS - 1, 127, 8 + 1);
    std::memset(v_dst - BPS - 1, 127, 8 + 1);
  }
  for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
    const MBData& block = mbs[size_t(mb_x)];
    if (mb_x > 0) {
      for (int j = -1; j < 16; ++j) std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
      for (int j = -1; j < 8; ++j) {
        std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
        std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
      }
    }
    uint8_t* ty = top_y.data() + 16 * mb_x;
    uint8_t* tu = top_u.data() + 8 * mb_x;
    uint8_t* tv = top_v.data() + 8 * mb_x;
    const int16_t* coeffs = block.coeffs;
    uint32_t bits = block.nz_y;
    if (mb_y > 0) {
      std::memcpy(y_dst - BPS, ty, 16);
      std::memcpy(u_dst - BPS, tu, 8);
      std::memcpy(v_dst - BPS, tv, 8);
    }
    if (block.i4x4) {
      uint8_t* top_right = y_dst - BPS + 16;
      if (mb_y > 0) {
        if (mb_x >= mb_w - 1) std::memset(top_right, ty[15], 4);
        else std::memcpy(top_right, ty + 16, 4);
      }
      for (int r = 1; r <= 3; ++r) std::memcpy(top_right + r * 4 * BPS, top_right, 4);
      for (int n = 0; n < 16; ++n, bits <<= 2) {
        uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
        pred_luma4(block.imodes[n], dst);
        do_transform(bits, coeffs + n * 16, dst);
      }
    } else {
      pred_square(check_mode(mb_x, mb_y, block.imodes[0]), y_dst, 16);
      for (int n = 0; n < 16; ++n, bits <<= 2)
        do_transform(bits, coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
    }
    const int uvmode = check_mode(mb_x, mb_y, block.uvmode);
    pred_square(uvmode, u_dst, 8);
    pred_square(uvmode, v_dst, 8);
    for (int c = 0; c < 2; ++c) {
      const uint32_t b = block.nz_uv >> (8 * c);
      uint8_t* dst = c == 0 ? u_dst : v_dst;
      const int16_t* in = coeffs + (16 + 4 * c) * 16;
      if (b & 0xaa) {  // DoUVTransform: any AC, all four blocks whole
        for (int k = 0; k < 4; ++k) transform_full(in + 16 * k, dst + (k & 1) * 4 + (k >> 1) * 4 * BPS);
      } else if (b & 0xff) {
        for (int k = 0; k < 4; ++k)
          if (in[16 * k]) transform_dc(in + 16 * k, dst + (k & 1) * 4 + (k >> 1) * 4 * BPS);
      }
    }
    if (mb_y < mb_h - 1) {
      std::memcpy(ty, y_dst + 15 * BPS, 16);
      std::memcpy(tu, u_dst + 7 * BPS, 8);
      std::memcpy(tv, v_dst + 7 * BPS, 8);
    }
    for (int j = 0; j < 16; ++j)
      std::memcpy(Y.data() + size_t(mb_y * 16 + j) * size_t(ystride) + size_t(mb_x * 16), y_dst + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
      std::memcpy(U.data() + size_t(mb_y * 8 + j) * size_t(uvstride) + size_t(mb_x * 8), u_dst + j * BPS, 8);
      std::memcpy(V.data() + size_t(mb_y * 8 + j) * size_t(uvstride) + size_t(mb_x * 8), v_dst + j * BPS, 8);
    }
  }
}

// FilterRow / DoFilter on the frame.
void Vp8::filter_row(int mb_y) {
  if (filter_type == 0) return;
  for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
    const FInfo& f = finfo[size_t(mb_x)];
    const int limit = f.limit;
    if (limit == 0) continue;
    uint8_t* y = Y.data() + size_t(mb_y * 16) * size_t(ystride) + size_t(mb_x * 16);
    const int ys = ystride;
    if (filter_type == 1) {
      if (mb_x > 0) simple_filter(y, 1, ys, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_filter(y + 4 * k, 1, ys, limit);
      if (mb_y > 0) simple_filter(y, ys, 1, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_filter(y + 4 * k * ys, ys, 1, limit);
    } else {
      const int uvs = uvstride, il = f.ilevel, hv = f.hev;
      uint8_t* u = U.data() + size_t(mb_y * 8) * size_t(uvs) + size_t(mb_x * 8);
      uint8_t* v = V.data() + size_t(mb_y * 8) * size_t(uvs) + size_t(mb_x * 8);
      if (mb_x > 0) {
        filter_loop(y, 1, ys, 16, limit + 4, il, hv, true);
        filter_loop(u, 1, uvs, 8, limit + 4, il, hv, true);
        filter_loop(v, 1, uvs, 8, limit + 4, il, hv, true);
      }
      if (f.inner) {
        for (int k = 1; k <= 3; ++k) filter_loop(y + 4 * k, 1, ys, 16, limit, il, hv, false);
        filter_loop(u + 4, 1, uvs, 8, limit, il, hv, false);
        filter_loop(v + 4, 1, uvs, 8, limit, il, hv, false);
      }
      if (mb_y > 0) {
        filter_loop(y, ys, 1, 16, limit + 4, il, hv, true);
        filter_loop(u, uvs, 1, 8, limit + 4, il, hv, true);
        filter_loop(v, uvs, 1, 8, limit + 4, il, hv, true);
      }
      if (f.inner) {
        for (int k = 1; k <= 3; ++k) filter_loop(y + 4 * k * ys, ys, 1, 16, limit, il, hv, false);
        filter_loop(u + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
        filter_loop(v + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
      }
    }
  }
}

// ================================================================ output

// dsp/yuv.h: 14-bit fixed point.
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) { return (v & ~16383) == 0 ? uint8_t(v >> 6) : v < 0 ? 0 : 255; }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// One output row of UpsampleRgbLinePair: the top row of a pair (chroma
// three parts top_uv, one part cur_uv) or the bottom (the other way).
void upsample_row(const uint8_t* y, const uint8_t* top_u, const uint8_t* top_v, const uint8_t* cur_u,
                  const uint8_t* cur_v, bool bottom, uint8_t* dst, int len, int ch) {
  auto load = [](uint8_t u, uint8_t v) { return uint32_t(u) | uint32_t(v) << 16; };
  auto put = [&](int x, uint32_t uv) {
    uint8_t* o = dst + x * ch;
    yuv_to_rgb(y[x], int(uv & 0xff), int(uv >> 16), o);
    if (ch == 4) o[3] = 0xff;
  };
  const int last_pair = (len - 1) >> 1;
  uint32_t tl = load(top_u[0], top_v[0]), l = load(cur_u[0], cur_v[0]);
  put(0, bottom ? (3 * l + tl + 0x00020002u) >> 2 : (3 * tl + l + 0x00020002u) >> 2);
  for (int x = 1; x <= last_pair; ++x) {
    const uint32_t t = load(top_u[x], top_v[x]), uv = load(cur_u[x], cur_v[x]);
    const uint32_t avg = tl + t + l + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t + l)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl + uv)) >> 3;
    if (!bottom) {
      put(2 * x - 1, (diag_12 + tl) >> 1);
      put(2 * x, (diag_03 + t) >> 1);
    } else {
      put(2 * x - 1, (diag_03 + l) >> 1);
      put(2 * x, (diag_12 + uv) >> 1);
    }
    tl = t;
    l = uv;
  }
  if (!(len & 1)) put(len - 1, bottom ? (3 * l + tl + 0x00020002u) >> 2 : (3 * tl + l + 0x00020002u) >> 2);
}

// EmitFancyRGB over the whole frame, rows [0, rows): row 0 and an even
// height's last row take their chroma row twice.
void emit_fancy(const Vp8& d, int rows, int ch, uint8_t* out, size_t stride) {
  const int w = d.width, h = d.height, uvh = (h + 1) / 2;
  for (int r = 0; r < rows; ++r) {
    const uint8_t* y = d.Y.data() + size_t(r) * size_t(d.ystride);
    int top, cur;
    bool bottom;
    if (r == 0) {
      top = cur = 0;
      bottom = false;
    } else if (r & 1) {
      top = (r - 1) / 2;
      cur = std::min((r + 1) / 2, uvh - 1);
      if (r == h - 1 && !(h & 1)) cur = top;
      bottom = false;
    } else {
      top = r / 2 - 1;
      cur = r / 2;
      bottom = true;
    }
    const size_t to = size_t(top) * size_t(d.uvstride), co = size_t(cur) * size_t(d.uvstride);
    upsample_row(y, d.U.data() + to, d.V.data() + to, d.U.data() + co, d.V.data() + co, bottom, out + size_t(r) * stride, w, ch);
  }
}

// ================================================================ the decoders

// Whether the caller's buffer takes a w x h image (CheckDecBuffer, as
// WebPAllocateDecBuffer checks an external buffer for the stream's size).
bool fits(int w, int h, int ch, size_t stride, size_t size) {
  const size_t row = size_t(w) * size_t(ch);
  return stride >= row && stride * size_t(h - 1) + row <= size;
}

// The lossy path of the incremental decoder (DecodeVP8FrameHeader,
// DecodePartition0, DecodeRemaining, FinishRow, CustomPut).
int decode_vp8(const uint8_t* data, size_t avail, size_t chunk_size, const uint8_t* alpha, size_t alpha_size, int ch,
               uint8_t* out, size_t stride, size_t size, int* rows) {
  *rows = 0;
  if (avail < kVp8FrameHeader) return WEBP_SUSPENDED;
  {  // VP8GetInfo
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return WEBP_ERROR;
    const uint32_t bits = le24(data);
    const int w = int(le16(data + 6) & 0x3fff), h = int(le16(data + 8) & 0x3fff);
    if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= chunk_size) return WEBP_ERROR;
    if (w == 0 || h == 0) return WEBP_ERROR;
    if (avail < (bits >> 5) + kVp8FrameHeader) return WEBP_SUSPENDED;  // partition 0 not all there
  }
  std::unique_ptr<Vp8> dp(new Vp8);
  Vp8& d = *dp;
  const int st = d.headers(data, avail);
  if (st != WEBP_OK) return st;
  if (!fits(d.width, d.height, ch, stride, size)) return WEBP_ERROR;
  Alpha a;
  if (alpha) a.decode(alpha, alpha_size, d.width, d.height);
  const int extra = d.filter_type == 0 ? 0 : d.filter_type == 1 ? 2 : 8;  // kFilterExtraRows
  int emitted = 0;
  // the rows let out so far, as the output holds them
  auto finish = [&](int status) {
    emit_fancy(d, emitted, ch, out, stride);
    if (ch == 4 && alpha)
      for (int y = 0; y < emitted; ++y)
        for (int x = 0; x < d.width; ++x) out[size_t(y) * stride + 4 * size_t(x) + 3] = a.plane[size_t(y) * size_t(d.width) + size_t(x)];
    *rows = emitted;
    return status;
  };
  // MemDataSize at a macroblock that runs out of data: from the frame's
  // start, then (one partition) from where the last macroblock left its
  // reader; more than MAX_MB_SIZE left there is an error, not a suspension
  size_t start = 0;
  for (int mb_y = 0; mb_y < d.mb_h; ++mb_y) {
    d.parse_intra_row();
    if (d.br.eof) return finish(WEBP_ERROR);
    d.nz[0] = d.nz_dc[0] = 0;
    std::memset(d.intra_l, B_DC, 4);
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
      BoolReader* tb = &d.parts[mb_y & (d.nparts - 1)];
      if (!d.parse_residuals(mb_x, tb)) return finish(d.nparts == 1 && avail - start > 4096 ? WEBP_ERROR : WEBP_SUSPENDED);
      if (d.nparts == 1) start = size_t(tb->buf - data);
    }
    d.reconstruct_row(mb_y);
    d.filter_row(mb_y);
    const bool last = mb_y >= d.mb_h - 1;
    const int y_start = mb_y == 0 ? 0 : 16 * mb_y - extra;
    const int y_end = last ? d.height : std::min(16 * (mb_y + 1) - extra, d.height);
    if (alpha && y_start < y_end && !a.good_rows(y_end)) return finish(WEBP_ERROR);
    if (y_start < y_end) emitted = last ? d.height : y_end - 1;
  }
  return finish(WEBP_OK);
}

// The lossless path (DecodeVP8LHeader, DecodeVP8LData).
int decode_vp8l(const uint8_t* data, size_t avail, size_t chunk_size, int ch, uint8_t* out, size_t stride, size_t size,
                int* rows) {
  *rows = 0;
  if (avail < (chunk_size >> 3)) return WEBP_SUSPENDED;
  const int short_data = avail < chunk_size ? WEBP_SUSPENDED : WEBP_ERROR;  // a header short of data
  std::unique_ptr<Vp8l> dp(new Vp8l);
  Vp8l& d = *dp;
  d.br.init(data, avail);
  // ReadImageInfo
  if (d.br.read(8) != 0x2f) return short_data;
  const int w = int(d.br.read(14)) + 1, h = int(d.br.read(14)) + 1;
  d.br.read(1);
  if (d.br.read(3) != 0 || d.br.eos) return short_data;
  if (!d.decode_image_stream(w, h, true, nullptr)) return short_data;
  if (!fits(w, h, ch, stride, size)) return WEBP_ERROR;
  const int pw = d.width;
  const bool incremental = avail < chunk_size;
  std::vector<uint32_t> px(size_t(pw) * size_t(h), 0);
  int pos = 0;
  const int end = d.decode_pixels(px.data(), pw, h, h, incremental, &pos);
  const int n = end == REACHED ? h : (pos / pw) & ~15;  // ProcessRows' groups of 16
  std::vector<uint32_t> argb;
  apply_transforms(d, px.data(), pw, w, n, &argb);
  for (int y = 0; y < n; ++y) {  // VP8LConvertFromBGRA
    const uint32_t* in = argb.data() + size_t(y) * size_t(w);
    uint8_t* o = out + size_t(y) * stride;
    for (int x = 0; x < w; ++x, o += ch) {
      o[0] = uint8_t(in[x] >> 16);
      o[1] = uint8_t(in[x] >> 8);
      o[2] = uint8_t(in[x]);
      if (ch == 4) o[3] = uint8_t(in[x] >> 24);
    }
  }
  *rows = n;
  return end == REACHED ? WEBP_OK : end == EOS ? WEBP_SUSPENDED : WEBP_ERROR;
}

// ParseHeadersInternal. features: as WebPGetFeatures asks (an animation,
// or a VP8X without its image yet, is fine); else as the incremental
// decoder's WebPParseHeaders asks.
enum HeaderStatus { H_OK, H_NOT_ENOUGH, H_BAD };
struct Headers {
  size_t offset = 0, compressed_size = 0;
  bool lossless = false, animation = false;
  const uint8_t* alpha = nullptr;
  size_t alpha_size = 0;
  WebpFeatures f;
};

HeaderStatus parse_headers(const uint8_t* data, size_t size, bool features, Headers* out) {
  const uint8_t* const start = data;
  if (size < kRiffHeader) return H_NOT_ENOUGH;
  size_t riff_size = 0;
  if (!std::memcmp(data, "RIFF", 4)) {  // ParseRIFF
    if (std::memcmp(data + 8, "WEBP", 4)) return H_BAD;
    const uint32_t sz = le32(data + 4);
    if (sz < 4 + kChunkHeader || sz > kMaxChunkPayload) return H_BAD;
    riff_size = sz;
    data += kRiffHeader;
    size -= kRiffHeader;
  }
  const bool found_riff = riff_size > 0;
  bool found_vp8x = false;
  uint32_t flags = 0;
  int canvas_w = 0, canvas_h = 0;
  if (size < kChunkHeader) return H_NOT_ENOUGH;  // ParseVP8X
  if (!std::memcmp(data, "VP8X", 4)) {
    if (le32(data + 4) != kVp8xChunk) return H_BAD;
    if (size < kChunkHeader + kVp8xChunk) return H_NOT_ENOUGH;
    flags = le32(data + 8);
    canvas_w = 1 + int(le24(data + 12));
    canvas_h = 1 + int(le24(data + 15));
    if (uint64_t(canvas_w) * uint64_t(canvas_h) >= (uint64_t(1) << 32)) return H_BAD;
    data += kChunkHeader + kVp8xChunk;
    size -= kChunkHeader + kVp8xChunk;
    found_vp8x = true;
  }
  if (!found_riff && found_vp8x) return H_BAD;
  Headers h;
  h.animation = flags & kAnimationFlag;
  h.f.width = canvas_w;
  h.f.height = canvas_h;
  auto done = [&](HeaderStatus st) {
    if (st == H_OK || (st == H_NOT_ENOUGH && found_vp8x && features)) {
      h.offset = size_t(data - start);
      *out = h;
      return H_OK;
    }
    return st;
  };
  if (found_vp8x && h.animation && features) return done(H_OK);
  if (size < 4) return done(H_NOT_ENOUGH);
  if ((found_riff && found_vp8x) || (!found_riff && !found_vp8x && !std::memcmp(data, "ALPH", 4))) {
    // ParseOptionalChunks: up to the VP8 / VP8L chunk, the last ALPH kept
    uint32_t total = 4 + kChunkHeader + kVp8xChunk;
    while (true) {
      if (size < kChunkHeader) return done(H_NOT_ENOUGH);
      const uint32_t chunk = le32(data + 4);
      if (chunk > kMaxChunkPayload) return done(H_BAD);
      const uint32_t disk = (uint32_t(kChunkHeader) + chunk + 1) & ~1u;
      total += disk;
      if (riff_size > 0 && total > riff_size) return done(H_BAD);
      if (!std::memcmp(data, "VP8 ", 4) || !std::memcmp(data, "VP8L", 4)) break;
      if (size < disk) return done(H_NOT_ENOUGH);
      if (!std::memcmp(data, "ALPH", 4)) {
        h.alpha = data + kChunkHeader;
        h.alpha_size = chunk;
      }
      data += disk;
      size -= disk;
    }
  }
  {  // ParseVP8Header
    if (size < kChunkHeader) return done(H_NOT_ENOUGH);
    const bool vp8 = !std::memcmp(data, "VP8 ", 4), vp8l = !std::memcmp(data, "VP8L", 4);
    if (vp8 || vp8l) {
      const uint32_t sz = le32(data + 4);
      if (riff_size >= 4 + kChunkHeader && sz > riff_size - (4 + kChunkHeader)) return done(H_BAD);
      h.compressed_size = sz;
      h.lossless = vp8l;
      data += kChunkHeader;
      size -= kChunkHeader;
    } else {
      h.lossless = size >= kVp8lFrameHeader && data[0] == 0x2f && (data[4] >> 5) == 0;
      h.compressed_size = size;
    }
  }
  if (h.compressed_size > kMaxChunkPayload) return H_BAD;
  int iw = 0, ih = 0;
  if (!h.lossless) {
    if (size < kVp8FrameHeader) return done(H_NOT_ENOUGH);
    // VP8GetInfo
    const uint32_t bits = le24(data);
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return H_BAD;
    iw = int(le16(data + 6) & 0x3fff);
    ih = int(le16(data + 8) & 0x3fff);
    if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= h.compressed_size) return H_BAD;
    if (iw == 0 || ih == 0) return H_BAD;
  } else {
    if (size < kVp8lFrameHeader) return done(H_NOT_ENOUGH);
    if (!(data[0] == 0x2f && (data[4] >> 5) == 0)) return H_BAD;
    LBits br;
    br.init(data, size);
    br.read(8);
    iw = int(br.read(14)) + 1;
    ih = int(br.read(14)) + 1;
    br.read(1);  // the alpha hint
    if (br.read(3) != 0 || br.eos) return H_BAD;
  }
  if (found_vp8x && (canvas_w != iw || canvas_h != ih)) return H_BAD;
  h.f.width = iw;
  h.f.height = ih;
  return done(H_OK);
}

}  // namespace

bool webp_features(const uint8_t* d, size_t n, WebpFeatures* f) {
  Headers h;
  if (parse_headers(d, n, true, &h) != H_OK) return false;
  *f = h.f;
  return true;
}

int webp_decode(const uint8_t* d, size_t n, int channels, uint8_t* out, size_t stride, size_t size, int* rows) {
  *rows = 0;
  Headers h;
  const HeaderStatus st = parse_headers(d, n, false, &h);
  if (st == H_NOT_ENOUGH) return WEBP_SUSPENDED;
  if (st != H_OK || h.animation) return WEBP_ERROR;
  const uint8_t* payload = d + h.offset;
  const size_t avail = n - h.offset;
  if (h.lossless) return decode_vp8l(payload, avail, h.compressed_size, channels, out, stride, size, rows);
  return decode_vp8(payload, avail, h.compressed_size, h.alpha, h.alpha_size, channels, out, stride, size, rows);
}

}  // namespace aq
